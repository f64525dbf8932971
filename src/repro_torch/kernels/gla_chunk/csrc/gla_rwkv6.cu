// The RWKV6 regime of the chunked gated linear recurrence on Hopper's
// tensor cores (sm_90a), in chunk-parallel form: chunk states, state
// passing, chunk scan — gla_ssd.cu's skeleton, generalised to per-head q
// and k, a per-channel decay, the lag-1 read and the bonus u.
//
// Replaces gla_chunk_kernel (body _gla_kernel) in
// src/repro/kernels/gla_chunk/gla_chunk.py in the regime rwkv6 runs:
// bf16 q (RWKV6's r), k and v, an f32 log-decay per (token, head,
// channel), the lag-1 read o_t = q_t·S_{t-1} + (q_t·u·k_t) v_t with an
// optional bonus u [H, dk]. f32 inputs stay on gla_chunk.cu. The contract
// is that kernel's: out [B, S, H, dv] in bf16, the f32 final state, an
// optional f32 initial state, any S (the ragged tail padded with k = v =
// 0, log_w = 0 and not stored), inputs read through strides.
//
// Per chunk c of C = 64 tokens and head h, with L the inclusive cumulative
// log-decay inside the chunk (per channel d), Lq = L − log_w and S_{c-1}
// the state at the chunk's start:
//   out_t = (q_t∘exp(Lq_t))·S_{c-1}
//         + Σ_{i<t} Σ_d q_td k_id exp(Lq_td − L_id) v_i + (q_t·u·k_t) v_t
//   S_c   = exp(L_C)∘S_{c-1} + (k∘exp(L_C − L))ᵀ v
// Three launches:
//   1. chunk states, one CTA per (batch, chunk, head): ΔS = (k∘exp(L_C −
//      L))ᵀ·v on the tensor cores, and L_C per channel;
//   2. state passing, one thread per (batch, head, state element): 32
//      f32 FMAs along the chunks with row d's decay exp(L_C,d), writing
//      each chunk's start state over its ΔS, and the final state;
//   3. chunk scan, one CTA per (batch, chunk, head), warp a owning the
//      16-token sub-chunk a of the queries:
//      - inter: (q∘exp(Lq))·S_{c-1};
//      - intra, off-diagonal (query sub-chunk a after key sub-chunk b):
//        exp(Lq_t − L_i) = exp(Lq_t − Λ)·exp(Λ − L_i) with the anchor
//        Λ = Lq at a's first token, so both exponents are <= 0 (L does
//        not increase, and every key of b comes before a):
//        (q∘exp(Lq − Λ))·(k∘exp(Λ − L))ᵀ on the tensor cores. Without the
//        anchor, exp(−L) overflows: rwkv6's decays reach −e⁴ per token,
//        a chunk's cumulative decay ~−3,500;
//      - intra, diagonal blocks (i < t inside one sub-chunk): exact, one
//        exp per (t, i, d), masked before the exp, as gla_chunk.cu and
//        the TPU kernel — 4 × 120 × dk exps per chunk and head instead of
//        ~C²·dk/2. Lane (group, quarter) of the warp takes rows g and
//        15 − g (15 pairs) over a quarter of the channels, so the work is
//        even; the bonus q_t·u·k_t goes on the diagonal;
//      - then A·v on the tensor cores.
// Products: mma.sync m16n8k16 bf16 with f32 accumulators. q, k and v are
// bf16 already and enter as they are; every f32 operand (the decayed k of
// ΔS, the scaled q and k of the scores, the start state, the score tile
// A) is split into bf16 hi + lo, and a product of two split operands
// takes three MMAs (hi·hi, hi·lo, lo·hi), so each product keeps ~2^-16
// relative accuracy: f32 accuracy for the state and every product that
// builds or reads it.
//
// Bound on this card: bytes. Per chunk and head ~1.5 MFLOP of tensor-core
// work and ~30k exps on 64·(3·2·64 + 4·64) input bytes; the f32
// chunk-state scratch [B, H, n_chunks, dk, dv] (written by 1, read and
// rewritten by 2, read by 3) is the largest traffic and is not part of
// the function's bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gla_mma.cuh"

namespace {

constexpr int SUB = 16;        // sub-chunk: one warp's query rows
constexpr int NT = 128;        // 4 warps, one per sub-chunk

// bits of the launch's ``vec``: the view is read 16 bytes at a time
constexpr int VEC_Q = 1, VEC_K = 2, VEC_V = 4, VEC_LW = 8;

// (hi, lo) products of two split operands: hi·hi + hi·lo + lo·hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma(d, ah, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, al, bh0, bh1);
}

// two f32 (neighbouring elements of a fragment) as packed hi and lo
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat16 h0, l0, h1, l1;
  split(x0, h0, l0);
  split(x1, h1, l1);
  hi = pack(h0, h1);
  lo = pack(l0, l1);
}

__device__ __forceinline__ float bf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// exp(x) for x <= 0 on the SFU (ex2.approx of x·log2 e): relative error
// under 2^-20 for |x| < 16, below the 2^-16 of a split operand, and
// beyond that what it scales is negligible. The output's factors use it;
// the state's decays keep the accurate expf.
__device__ __forceinline__ float exp_out(float x) { return __expf(x); }

// The thread's share of the [C, D] tile (tokens c0.., zero past S) of a
// [B, S, H, D] view of T at (batch b, head h): U units of 16 bytes (V
// consecutive channels of one token) per thread, every load issued before
// any is stored. With ``vec`` (channel stride 1, 16-byte aligned rows)
// each unit is one 16-byte load, else V element loads through the
// strides.
template <typename T, int D>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int PER_ROW = D / V;
  static constexpr int U = C * PER_ROW / NT;
  using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, T>::type;
  uint4 x[U];

  __device__ __forceinline__ void load(const T* __restrict__ p, Strides st,
                                       int b, int h, int c0, int S,
                                       bool vec) {
    const T* base = p + b * st.b + h * st.h;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int s = c0 + row(r), d0 = col(r);
      union { uint4 u; Raw e[V]; } w;
      w.u = make_uint4(0u, 0u, 0u, 0u);
      if (s < S) {
        const T* src = base + s * st.s;
        if (vec) {
          w.u = *reinterpret_cast<const uint4*>(src + d0);
        } else {
          const Raw* e = reinterpret_cast<const Raw*>(src);
#pragma unroll
          for (int j = 0; j < V; ++j) w.e[j] = e[(d0 + j) * st.d];
        }
      }
      x[r] = w.u;
    }
  }
  __device__ __forceinline__ int row(int r) const {
    return (threadIdx.x + r * NT) / PER_ROW;
  }
  __device__ __forceinline__ int col(int r) const {
    return (threadIdx.x + r * NT) % PER_ROW * V;
  }
  // unit r into row row(r) of a [C][ld] shared array (16-byte aligned rows)
  __device__ __forceinline__ void store(T* dst, int ld, int r) const {
    *reinterpret_cast<uint4*>(dst + row(r) * ld + col(r)) = x[r];
  }
};

// v's tile transposed into vt[j][token]
template <int DV>
__device__ __forceinline__ void store_vt(const Tile<__nv_bfloat16, DV>& tv,
                                         __nv_bfloat16 (*vt)[LC_]) {
#pragma unroll
  for (int r = 0; r < tv.U; ++r) {
    union { uint4 u; uint16_t e[8]; } w;
    w.u = tv.x[r];
    const int t = tv.row(r), j0 = tv.col(r);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      vt[j0 + j][t] = __ushort_as_bfloat16(w.e[j]);
  }
}

// Thread d < DK: the inclusive cumulative log-decay L of channel d over
// the chunk, summed in token order (the order of torch.cumsum on the card
// and of gla_chunk.cu), in place of the chunk's log_w: in L, or, where Lq
// is given, in Lq, which then gets Lq = L − log_w. Returns L_C.
template <int LD>
__device__ __forceinline__ float column_cumsum(float (*L)[LD],
                                               float (*Lq)[LD], int d) {
  float run = 0.0f;
#pragma unroll
  for (int t = 0; t < C; ++t) {
    const float w = Lq ? Lq[t][d] : L[t][d];
    run += w;
    L[t][d] = run;
    if (Lq) Lq[t][d] = run - w;
  }
  return run;
}

// ------------------------------------------------------------ 1. states
template <int DK, int DV>
struct StateSmem {
  float L[C][DK + 4];                      // log_w, then L
  __nv_bfloat16 k[C][DK + PAD];            // [token][d]
  __nv_bfloat16 kh[DK][LC_], kl[DK][LC_];  // (k∘exp(L_C − L))ᵀ, hi / lo
  __nv_bfloat16 vt[DV][LC_];               // v transposed
  float lc[DK];
};

template <int DK, int DV>
__global__ void __launch_bounds__(NT)
rwkv6_state_kernel(const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ lw, float* __restrict__ states,
                   float* __restrict__ lc, int H, int S, int n_chunks,
                   Strides ks, Strides vs, Strides ls, int vec) {
  extern __shared__ __align__(16) uint8_t raw[];
  StateSmem<DK, DV>& sm = *reinterpret_cast<StateSmem<DK, DV>*>(raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * C;
  const long long bhc = ((long long)b * H + h) * n_chunks + c;

  {
    Tile<float, DK> tl;
    Tile<__nv_bfloat16, DK> tk;
    Tile<__nv_bfloat16, DV> tv;
    tl.load(lw, ls, b, h, c0, S, vec & VEC_LW);
    tk.load(k, ks, b, h, c0, S, vec & VEC_K);
    tv.load(v, vs, b, h, c0, S, vec & VEC_V);
#pragma unroll
    for (int r = 0; r < tl.U; ++r) tl.store(&sm.L[0][0], DK + 4, r);
#pragma unroll
    for (int r = 0; r < tk.U; ++r) tk.store(&sm.k[0][0], DK + PAD, r);
    store_vt(tv, sm.vt);
  }
  __syncthreads();
  if (tid < DK) {
    const float run = column_cumsum<DK + 4>(sm.L, nullptr, tid);
    sm.lc[tid] = run;
    lc[bhc * DK + tid] = run;
  }
  __syncthreads();
  // (k∘exp(L_C − L))ᵀ, two tokens per element; exponents <= 0: safe
  for (int e = tid; e < C / 2 * DK; e += NT) {
    const int d = e % DK, t = 2 * (e / DK);
    uint32_t hi, lo;
    split2(bf(&sm.k[t][d]) * expf(sm.lc[d] - sm.L[t][d]),
           bf(&sm.k[t + 1][d]) * expf(sm.lc[d] - sm.L[t + 1][d]), hi, lo);
    *reinterpret_cast<uint32_t*>(&sm.kh[d][t]) = hi;
    *reinterpret_cast<uint32_t*>(&sm.kl[d][t]) = lo;
  }
  __syncthreads();

  // ΔS [DK, DV] = (k∘exp(L_C − L))ᵀ [DK, C] · v [C, DV]
  constexpr int NTILE = (DK / 16) * (DV / 8);
  float* out = states + bhc * DK * DV;
  for (int tile = warp; tile < NTILE; tile += NT / 32) {
    const int rb = tile / (DV / 8), nt = tile % (DV / 8);
    const int r = rb * 16 + g, n = nt * 8 + g;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const int i0 = kk * 16 + 2 * q4;
      const uint32_t ah[4] = {ld2(&sm.kh[r][i0]), ld2(&sm.kh[r + 8][i0]),
                              ld2(&sm.kh[r][i0 + 8]),
                              ld2(&sm.kh[r + 8][i0 + 8])};
      const uint32_t al[4] = {ld2(&sm.kl[r][i0]), ld2(&sm.kl[r + 8][i0]),
                              ld2(&sm.kl[r][i0 + 8]),
                              ld2(&sm.kl[r + 8][i0 + 8])};
      const uint32_t b0 = ld2(&sm.vt[n][i0]), b1 = ld2(&sm.vt[n][i0 + 8]);
      mma(acc, ah, b0, b1);
      mma(acc, al, b0, b1);
    }
    const int col = nt * 8 + 2 * q4;
    *reinterpret_cast<float2*>(&out[r * DV + col]) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(&out[(r + 8) * DV + col]) =
        make_float2(acc[2], acc[3]);
  }
}

// ------------------------------------------------------------ 2. passing
// states[b, h, c] holds ΔS_c on entry and the state at chunk c's start on
// exit; final[b, h] gets the state after the last chunk. Row d of the
// state decays by exp(lc[b, h, c, d]).
__global__ void __launch_bounds__(256)
rwkv6_pass_kernel(float* __restrict__ states, const float* __restrict__ lc,
                  const float* __restrict__ s0,
                  float* __restrict__ final_state, int H, int n_chunks,
                  int dk, int dv) {
  const int dkdv = dk * dv;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= dkdv) return;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float st = s0 ? s0[bh * dkdv + e] : 0.0f;
  float* p = states + bh * n_chunks * dkdv + e;
  const float* decay = lc + bh * n_chunks * dk + e / dv;
  constexpr int BATCH = 16;          // chunk states loaded ahead of use
  for (int c0 = 0; c0 < n_chunks; c0 += BATCH) {
    float ds[BATCH], w[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c0 + u < n_chunks) {
        ds[u] = p[(long long)(c0 + u) * dkdv];
        w[u] = decay[(long long)(c0 + u) * dk];
      }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c0 + u < n_chunks) {
        p[(long long)(c0 + u) * dkdv] = st;
        st = expf(w[u]) * st + ds[u];
      }
  }
  final_state[bh * dkdv + e] = st;
}

// ------------------------------------------------------------- 3. scan
template <int DK, int DV>
struct ScanSmem {
  __nv_bfloat16 q[C][DK + PAD], k[C][DK + PAD];   // [token][d]
  __nv_bfloat16 vt[DV][LC_];                      // v transposed
  float L[C][DK + 4], Lq[C][DK + 4];              // cumulative log-decay
  float ad[C / SUB][SUB][SUB + 1];                // diagonal score blocks
  float u[DK];
};

template <int DK, int DV>
__global__ void __launch_bounds__(NT)
rwkv6_scan_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ lw, const float* __restrict__ u,
                  const float* __restrict__ states,
                  __nv_bfloat16* __restrict__ out, int H, int S,
                  int n_chunks, Strides qs, Strides ks, Strides vs,
                  Strides ls, int vec) {
  extern __shared__ __align__(16) uint8_t raw[];
  ScanSmem<DK, DV>& sm = *reinterpret_cast<ScanSmem<DK, DV>*>(raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * C;
  const int a = warp;                  // this warp's query sub-chunk

  {
    Tile<float, DK> tl;
    Tile<__nv_bfloat16, DK> tq, tk;
    Tile<__nv_bfloat16, DV> tv;
    tl.load(lw, ls, b, h, c0, S, vec & VEC_LW);
    tq.load(q, qs, b, h, c0, S, vec & VEC_Q);
    tk.load(k, ks, b, h, c0, S, vec & VEC_K);
    tv.load(v, vs, b, h, c0, S, vec & VEC_V);
#pragma unroll
    for (int r = 0; r < tl.U; ++r) tl.store(&sm.Lq[0][0], DK + 4, r);
#pragma unroll
    for (int r = 0; r < tq.U; ++r) {
      tq.store(&sm.q[0][0], DK + PAD, r);
      tk.store(&sm.k[0][0], DK + PAD, r);
    }
    store_vt(tv, sm.vt);
    if (tid < DK) sm.u[tid] = u ? u[(long long)h * DK + tid] : 0.0f;
  }
  float(*ad)[SUB + 1] = sm.ad[a];
  for (int e = lane; e < SUB * SUB; e += 32) ad[e / SUB][e % SUB] = 0.0f;
  __syncthreads();
  if (tid < DK) column_cumsum<DK + 4>(sm.L, sm.Lq, tid);  // L, Lq
  __syncthreads();

  // ---- diagonal block: A[t, i] for i < t inside sub-chunk a, exact;
  // lane (gq, p) takes rows gq and 15 − gq (15 pairs in all) over the
  // channels 16m + 4p + x, and the bonus of both rows on the diagonal.
  // A quarter-warp is the eight groups at one p: the key rows they read
  // at a step are one row apart or the same, so its loads hit distinct
  // banks.
  {
    constexpr int M = DK / 16;
    const int gq = lane % 8, p = lane / 8;
    const int t1 = gq, t2 = SUB - 1 - gq;
    const int base = a * SUB;
    float q1[M][4], l1[M][4], q2[M][4], l2[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = 16 * m + 4 * p + x;
        q1[m][x] = bf(&sm.q[base + t1][d]);
        l1[m][x] = sm.Lq[base + t1][d];
        q2[m][x] = bf(&sm.q[base + t2][d]);
        l2[m][x] = sm.Lq[base + t2][d];
      }
#pragma unroll
    for (int j = 0; j < SUB - 1; ++j) {
      const bool first = j < t1;
      const int t = first ? t1 : t2, i = first ? j : j - t1;
      float part = 0.0f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int d = 16 * m + 4 * p;
        const float4 Li =
            *reinterpret_cast<const float4*>(&sm.L[base + i][d]);
        const uint2 Ki = *reinterpret_cast<const uint2*>(&sm.k[base + i][d]);
        const float lv[4] = {Li.x, Li.y, Li.z, Li.w};
        const float kv[4] = {__uint_as_float(Ki.x << 16),
                             __uint_as_float(Ki.x & 0xffff0000u),
                             __uint_as_float(Ki.y << 16),
                             __uint_as_float(Ki.y & 0xffff0000u)};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float qv = first ? q1[m][x] : q2[m][x];
          const float lq = first ? l1[m][x] : l2[m][x];
          part += qv * kv[x] * exp_out(lq - lv[x]);  // i < t: <= 0
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 8);
      part += __shfl_xor_sync(0xffffffffu, part, 16);
      if (p == 0) ad[t][i] = part;
    }
    if (u) {                           // the bonus q_t·u·k_t on the diagonal
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? t2 : t1;
        float part = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int d = 16 * m + 4 * p + x;
            part += (r ? q2[m][x] : q1[m][x]) * sm.u[d] *
                    bf(&sm.k[base + t][d]);
          }
        part += __shfl_xor_sync(0xffffffffu, part, 8);
        part += __shfl_xor_sync(0xffffffffu, part, 16);
        if (p == 0) ad[t][t] = part;
      }
    }
  }
  __syncwarp();

  const int t0 = a * SUB + g, t1 = t0 + 8;       // this thread's rows
  float acc[DV / 8][4];
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;

  // ---- inter: (q∘exp(Lq))·S_{c-1}, Lq <= 0; the start state's B
  // fragments straight from the scratch (rows d0, d0 + 1, d0 + 8, d0 + 9
  // of column n), split into hi / lo in registers
  const float* st =
      states + (((long long)b * H + h) * n_chunks + c) * DK * DV;
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {
    const int d0 = kk * 16 + 2 * q4;
    float sv[DV / 8][4];               // every load in flight before use
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        sv[nt][f] = st[(d0 + (f & 1) + (f & 2 ? 8 : 0)) * DV + nt * 8 + g];
    uint32_t ah[4], al[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {      // fragment f: row t0/t1, col +0/+8
      const int t = f & 1 ? t1 : t0, d = d0 + (f & 2 ? 8 : 0);
      split2(bf(&sm.q[t][d]) * exp_out(sm.Lq[t][d]),
             bf(&sm.q[t][d + 1]) * exp_out(sm.Lq[t][d + 1]), ah[f],
             al[f]);
    }
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      split2(sv[nt][0], sv[nt][1], bh0, bl0);
      split2(sv[nt][2], sv[nt][3], bh1, bl1);
      mma3(acc[nt], ah, al, bh0, bh1, bl0, bl1);
    }
  }

  // ---- intra, off-diagonal key sub-chunks kb < a, through the anchor
  // Λ = Lq[a·16]: (q∘exp(Lq − Λ))·(k∘exp(Λ − L))ᵀ, both exponents <= 0
  if (a > 0) {
    const float* lam = sm.Lq[a * SUB];
    uint32_t qh[DK / 16][4], ql[DK / 16][4];
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const int d0 = kk * 16 + 2 * q4;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int t = f & 1 ? t1 : t0, d = d0 + (f & 2 ? 8 : 0);
        split2(bf(&sm.q[t][d]) * exp_out(sm.Lq[t][d] - lam[d]),
               bf(&sm.q[t][d + 1]) * exp_out(sm.Lq[t][d + 1] - lam[d + 1]),
               qh[kk][f], ql[kk][f]);
      }
    }
    for (int kb = 0; kb < a; ++kb) {
      float sc[2][4];
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {           // keys +0 / +8
        sc[hk][0] = sc[hk][1] = sc[hk][2] = sc[hk][3] = 0.0f;
        const int key = kb * SUB + hk * 8 + g;
        const float* Lk = sm.L[key];
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk) {
          const int d0 = kk * 16 + 2 * q4;
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int d = d0 + 8 * f;
            split2(bf(&sm.k[key][d]) * exp_out(lam[d] - Lk[d]),
                   bf(&sm.k[key][d + 1]) * exp_out(lam[d + 1] - Lk[d + 1]),
                   bh[f], bl[f]);
          }
          mma3(sc[hk], qh[kk], ql[kk], bh[0], bh[1], bl[0], bl[1]);
        }
      }
      // the two 16 x 8 score tiles are this key block's A fragment
      uint32_t ah[4], al[4];
      split2(sc[0][0], sc[0][1], ah[0], al[0]);
      split2(sc[0][2], sc[0][3], ah[1], al[1]);
      split2(sc[1][0], sc[1][1], ah[2], al[2]);
      split2(sc[1][2], sc[1][3], ah[3], al[3]);
      const int i0 = kb * SUB + 2 * q4;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        const uint32_t b0 = ld2(&sm.vt[nt * 8 + g][i0]);
        const uint32_t b1 = ld2(&sm.vt[nt * 8 + g][i0 + 8]);
        mma(acc[nt], ah, b0, b1);
        mma(acc[nt], al, b0, b1);
      }
    }
  }

  // ---- intra, the diagonal block (with the bonus) times v
  {
    uint32_t ah[4], al[4];
    split2(ad[g][2 * q4], ad[g][2 * q4 + 1], ah[0], al[0]);
    split2(ad[g + 8][2 * q4], ad[g + 8][2 * q4 + 1], ah[1], al[1]);
    split2(ad[g][2 * q4 + 8], ad[g][2 * q4 + 9], ah[2], al[2]);
    split2(ad[g + 8][2 * q4 + 8], ad[g + 8][2 * q4 + 9], ah[3], al[3]);
    const int i0 = a * SUB + 2 * q4;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      const uint32_t b0 = ld2(&sm.vt[nt * 8 + g][i0]);
      const uint32_t b1 = ld2(&sm.vt[nt * 8 + g][i0 + 8]);
      mma(acc[nt], ah, b0, b1);
      mma(acc[nt], al, b0, b1);
    }
  }

  // out [B, S, H, DV], contiguous
  const int s0_ = c0 + t0, s1_ = c0 + t1;
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt) {
    const int j = nt * 8 + 2 * q4;
    if (s0_ < S)
      *reinterpret_cast<__nv_bfloat162*>(
          &out[(((long long)b * S + s0_) * H + h) * DV + j]) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (s1_ < S)
      *reinterpret_cast<__nv_bfloat162*>(
          &out[(((long long)b * S + s1_) * H + h) * DV + j]) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// Whether a view can be read 16 bytes (``per`` elements) at a time: unit
// channel stride, every row start 16-byte aligned.
bool vec_ok(const void* p, Strides st, int per) {
  return st.d == 1 && st.s % per == 0 && st.h % per == 0 &&
         st.b % per == 0 && (uintptr_t)p % 16 == 0;
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* out, void* s_out,
           void* states, void* lc, int B, int S, int H, Strides qs,
           Strides ks, Strides vs, Strides ls, cudaStream_t stream) {
  // set once, outside any graph capture
  static bool state_attr = false, scan_attr = false;
  const size_t state_bytes = sizeof(StateSmem<DK, DV>);
  const size_t scan_bytes = sizeof(ScanSmem<DK, DV>);
  int err = opt_in(rwkv6_state_kernel<DK, DV>, state_bytes, state_attr);
  if (!err) err = opt_in(rwkv6_scan_kernel<DK, DV>, scan_bytes, scan_attr);
  if (err) return err;
  const int n = (S + C - 1) / C;
  const dim3 grid(H, n, B);
  const int vec = (vec_ok(q, qs, 8) ? VEC_Q : 0) |
                  (vec_ok(k, ks, 8) ? VEC_K : 0) |
                  (vec_ok(v, vs, 8) ? VEC_V : 0) |
                  (vec_ok(lw, ls, 4) ? VEC_LW : 0);
  if (n > 0) {                 // S = 0 only passes the initial state on
    rwkv6_state_kernel<DK, DV><<<grid, NT, state_bytes, stream>>>(
        (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, (const float*)lw,
        (float*)states, (float*)lc, H, S, n, ks, vs, ls, vec);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  rwkv6_pass_kernel<<<dim3((DK * DV + 255) / 256, H, B), 256, 0, stream>>>(
      (float*)states, (const float*)lc, (const float*)s0, (float*)s_out, H,
      n, DK, DV);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (n == 0) return 0;
  rwkv6_scan_kernel<DK, DV><<<grid, NT, scan_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)lw, (const float*)u,
      (const float*)states, (__nv_bfloat16*)out, H, S, n, qs, ks, vs, ls,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k [B, S, H, dk] and v [B, S, H, dv], f32 log_w [B, S, H, dk], as
// element strides (b, s, h, d); u [H, dk] f32 contiguous or null (no
// bonus); s0 [B, H, dk, dv] f32 contiguous or null (zero state). Writes out
// [B, S, H, dv] bf16 contiguous and s_out [B, H, dk, dv] f32, through the
// scratch states [B, H, ceil(S / 64), dk, dv] f32 and lc [B, H,
// ceil(S / 64), dk] f32. dk in {16, 32, 64}, dv in {16, 32, 64, 128}.
// Returns the first failed launch's cudaError_t (-1 for an unsupported
// width).
extern "C" int gla_rwkv6_launch(
    const void* q, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* out, void* s_out, void* states,
    void* lc, int B, int S, int H, int dk, int dv, long long q_sb,
    long long q_ss, long long q_sh, long long q_sd, long long k_sb,
    long long k_ss, long long k_sh, long long k_sd, long long v_sb,
    long long v_ss, long long v_sh, long long v_sd, long long l_sb,
    long long l_ss, long long l_sh, long long l_sd, void* stream) {
  if (B == 0 || H == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh, q_sd}, ks{k_sb, k_ss, k_sh, k_sd},
      vs{v_sb, v_ss, v_sh, v_sd}, ls{l_sb, l_ss, l_sh, l_sd};
  const cudaStream_t st = (cudaStream_t)stream;
#define RWKV6_CASE(DK, DV)                                                   \
  if (dk == DK && dv == DV)                                                  \
    return launch<DK, DV>(q, k, v, lw, u, s0, out, s_out, states, lc, B, S, \
                          H, qs, ks, vs, ls, st);
  RWKV6_CASE(16, 16) RWKV6_CASE(16, 32) RWKV6_CASE(16, 64)
  RWKV6_CASE(16, 128) RWKV6_CASE(32, 16) RWKV6_CASE(32, 32)
  RWKV6_CASE(32, 64) RWKV6_CASE(32, 128) RWKV6_CASE(64, 16)
  RWKV6_CASE(64, 32) RWKV6_CASE(64, 64) RWKV6_CASE(64, 128)
#undef RWKV6_CASE
  return -1;
}
