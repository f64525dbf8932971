// The Mamba2/SSD regime of the chunked gated linear recurrence on Hopper's
// tensor cores (sm_90a), in chunk-parallel form (Mamba2's own SSD
// algorithm: chunk states, state passing, chunk scan).
//
// Replaces gla_chunk_kernel (body _gla_kernel) in
// src/repro/kernels/gla_chunk/gla_chunk.py in the regime zamba2 runs:
// inclusive read (o_t = q_t · S_t), no bonus, bf16 q, k and v, one log-
// decay per (token, head) broadcast over dk, q and k shared by every head
// (models/blocks.py passes zero-stride views). RWKV6's lag-1 + bonus regime
// runs on gla_rwkv6.cu in bf16; f32 inputs stay on gla_chunk.cu. The
// contract is that kernel's: out [B, S, H, dv] in bf16, the f32 final
// state, an optional f32 initial state, any S (the ragged tail padded with
// k = v = 0, log_w = 0 and not stored), inputs read through strides.
//
// Per chunk c of C = 64 tokens and head h, with L_t the inclusive
// cumulative log-decay inside the chunk and S_{c-1} the state at its start:
//   out_t = exp(L_t)·q_t·S_{c-1} + Σ_{i<=t} (q_t·k_i) exp(L_t − L_i) v_i
//   S_c   = exp(L_C)·S_{c-1} + Σ_i k_i exp(L_C − L_i) v_iᵀ
// Three launches:
//   1. chunk states, one CTA per (batch, chunk, group of heads): the
//      chunk's ΔS_h = kᵀ·(exp(L_C − L)·v_h) and L_C per head;
//   2. state passing, one thread per (batch, head, state element): 32
//      f32 FMAs along the chunks, writing each chunk's start state over
//      its ΔS and the final state;
//   3. chunk scan, one CTA per (batch, chunk, group of heads): G = q·kᵀ
//      once for all heads of the CTA (q and k are shared; kept in shared
//      memory), then per head
//      exp(L_t)·(q·S_{c-1}) + (G ∘ exp(L_t − L_i) ∘ [i <= t])·v_h.
// Products: mma.sync m16n8k16 bf16 with f32 accumulators. q, k and v are
// bf16 already and enter as they are; every f32 operand (the decayed v of
// ΔS, the start state of q·S, the decayed scores of the intra term) is
// split into bf16 hi + lo and multiplied twice, so each product keeps
// ~2^-16 relative accuracy — f32 accuracy for the state and every product
// that builds or reads it.
//
// Bound on this card: bytes. Per chunk and head ~0.5 MFLOP of tensor-core
// work on 64·(2dk/H + 2dv + 1) input bytes and 64·dv output bytes; the
// f32 chunk-state scratch [B, H, n_chunks, dk, dv] (written by 1, read and
// rewritten by 2, read by 3) is the largest traffic and is not part of
// the function's bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gla_mma.cuh"

namespace {

constexpr int NT = 128;        // 4 warps; warp w owns chunk rows 16w..+15
constexpr int MAX_HG = 8;      // heads per CTA

// One warp: the inclusive cumulative log-decay of head h over the chunk's
// tokens (0 past S), L[t] for t < 64; lane l owns tokens 2l and 2l + 1.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ lw,
                                             Strides ls, int b, int h,
                                             int c0, int S, float* L) {
  const int lane = threadIdx.x % 32;
  const float* p = lw + b * ls.b + h * ls.h;
  const int s0 = c0 + 2 * lane;
  const float a0 = s0 < S ? p[s0 * ls.s] : 0.0f;
  const float a1 = s0 + 1 < S ? p[(s0 + 1) * ls.s] : 0.0f;
  float run = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += up;
  }
  const float before = run - (a0 + a1);
  L[2 * lane] = before + a0;
  L[2 * lane + 1] = before + a0 + a1;
}

// This thread's share of a head's v chunk [C, DV]: column j = tid % DV,
// rows tid / DV + u·(NT / DV) (0 past S), all loads issued before any is
// used; the pointer walks the rows, so no per-load 64-bit offsets are kept.
template <int DV>
__device__ __forceinline__ void load_v_column(const __nv_bfloat16* vb,
                                              Strides vs, int c0, int S,
                                              float (&x)[C * DV / NT]) {
  const int tid = threadIdx.x, i0 = tid / DV;
  const __nv_bfloat16* p = vb + (tid % DV) * vs.d + (c0 + i0) * vs.s;
  const long long step = (NT / DV) * vs.s;
#pragma unroll
  for (int u = 0; u < C * DV / NT; ++u, p += step)
    x[u] = c0 + i0 + u * (NT / DV) < S ? __bfloat162float(*p) : 0.0f;
}

// ------------------------------------------------------------ 1. states
template <int DK, int DV>
struct StateSmem {
  __nv_bfloat16 kt[DK][LC_];           // k transposed: [d][token]
  __nv_bfloat16 wh[DV][LC_], wl[DV][LC_];  // exp(L_C − L_i)·v, hi / lo
  float L[MAX_HG][C];
};

template <int DK, int DV>
__global__ void __launch_bounds__(NT)
ssd_state_kernel(const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ lw, float* __restrict__ states,
                 float* __restrict__ lc, int H, int S, int n_chunks, int hg,
                 Strides ks, Strides vs, Strides ls) {
  extern __shared__ __align__(16) uint8_t raw[];
  StateSmem<DK, DV>& sm = *reinterpret_cast<StateSmem<DK, DV>*>(raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int h0 = blockIdx.x * hg, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * C;

  for (int e = tid; e < C * DK; e += NT) {       // k is shared by heads
    const int i = e / DK, d = e % DK, s = c0 + i;
    sm.kt[d][i] = s < S ? k[b * ks.b + s * ks.s + d * ks.d]
                        : __float2bfloat16_rn(0.0f);
  }
  for (int hh = warp; hh < hg; hh += NT / 32)
    chunk_cumsum(lw, ls, b, h0 + hh, c0, S, sm.L[hh]);
  __syncthreads();

  constexpr int NTILE = (DK / 16) * (DV / 8);
  constexpr int V_PER_THREAD = C * DV / NT;
  for (int hh = 0; hh < hg; ++hh) {
    const int h = h0 + hh;
    const float Lc = sm.L[hh][C - 1];
    float x[V_PER_THREAD];           // every load in flight before any use
    load_v_column<DV>(v + b * vs.b + h * vs.h, vs, c0, S, x);
    const int j = tid % DV;
#pragma unroll
    for (int u = 0; u < V_PER_THREAD; ++u) {
      const int i = tid / DV + u * (NT / DV);
      split(expf(Lc - sm.L[hh][i]) * x[u], sm.wh[j][i], sm.wl[j][i]);
    }
    __syncthreads();
    float* out = states + (((long long)b * H + h) * n_chunks + c) * DK * DV;
    for (int tile = warp; tile < NTILE; tile += NT / 32) {
      const int rb = tile / (DV / 8), nt = tile % (DV / 8);
      const int r = rb * 16 + g, n = nt * 8 + g;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks_ = 0; ks_ < C / 16; ++ks_) {
        const int i0 = ks_ * 16 + 2 * q4;
        const uint32_t a[4] = {ld2(&sm.kt[r][i0]), ld2(&sm.kt[r + 8][i0]),
                               ld2(&sm.kt[r][i0 + 8]),
                               ld2(&sm.kt[r + 8][i0 + 8])};
        mma(acc, a, ld2(&sm.wh[n][i0]), ld2(&sm.wh[n][i0 + 8]));
        mma(acc, a, ld2(&sm.wl[n][i0]), ld2(&sm.wl[n][i0 + 8]));
      }
      const int col = nt * 8 + 2 * q4;
      *reinterpret_cast<float2*>(&out[r * DV + col]) =
          make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(&out[(r + 8) * DV + col]) =
          make_float2(acc[2], acc[3]);
    }
    if (tid == 0) lc[((long long)b * H + h) * n_chunks + c] = Lc;
    __syncthreads();                   // wh / wl are rewritten next head
  }
}

// ------------------------------------------------------------ 2. passing
// states[b, h, c] holds ΔS_c on entry and the state at chunk c's start on
// exit; final[b, h] gets the state after the last chunk.
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ lc,
                const float* __restrict__ s0, float* __restrict__ final_state,
                int H, int n_chunks, int dkdv) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= dkdv) return;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float st = s0 ? s0[bh * dkdv + e] : 0.0f;
  float* p = states + bh * n_chunks * dkdv + e;
  const float* decay = lc + bh * n_chunks;
  constexpr int BATCH = 16;          // chunk states loaded ahead of use
  for (int c0 = 0; c0 < n_chunks; c0 += BATCH) {
    float ds[BATCH], w[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (c0 + u < n_chunks) {
        ds[u] = p[(long long)(c0 + u) * dkdv];
        w[u] = decay[c0 + u];
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
  __nv_bfloat16 sh[DV][DK + PAD], sl[DV][DK + PAD];  // start state, hi/lo
  float g[C][C + 4];                              // q·kᵀ, for every head
  float L[MAX_HG][C];
};

template <int DK, int DV>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ lw,
                const float* __restrict__ states,
                __nv_bfloat16* __restrict__ out, int H, int S, int n_chunks,
                int hg, Strides qs, Strides ks, Strides vs, Strides ls) {
  extern __shared__ __align__(16) uint8_t raw[];
  ScanSmem<DK, DV>& sm = *reinterpret_cast<ScanSmem<DK, DV>*>(raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int h0 = blockIdx.x * hg, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * C;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  constexpr int V_PER_THREAD = C * DV / NT;

  for (int e = tid; e < C * DK; e += NT) {       // q, k shared by heads
    const int t = e / DK, d = e % DK, s = c0 + t;
    const bool ok = s < S;
    sm.q[t][d] = ok ? q[b * qs.b + s * qs.s + d * qs.d] : zero;
    sm.k[t][d] = ok ? k[b * ks.b + s * ks.s + d * ks.d] : zero;
  }
  for (int hh = warp; hh < hg; hh += NT / 32)
    chunk_cumsum(lw, ls, b, h0 + hh, c0, S, sm.L[hh]);
  __syncthreads();

  // this warp's rows of q as A fragments, and its rows of G = q·kᵀ
  const int t0 = 16 * warp + g, t1 = t0 + 8;
  uint32_t qa[DK / 16][4];
#pragma unroll
  for (int ks_ = 0; ks_ < DK / 16; ++ks_) {
    const int d0 = ks_ * 16 + 2 * q4;
    qa[ks_][0] = ld2(&sm.q[t0][d0]);
    qa[ks_][1] = ld2(&sm.q[t1][d0]);
    qa[ks_][2] = ld2(&sm.q[t0][d0 + 8]);
    qa[ks_][3] = ld2(&sm.q[t1][d0 + 8]);
  }
  // this warp's rows of G, kept in shared memory (read by this warp only)
  // rather than in registers across the head loop
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    float G[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks_ = 0; ks_ < DK / 16; ++ks_) {
      const int d0 = ks_ * 16 + 2 * q4;
      mma(G, qa[ks_], ld2(&sm.k[nt * 8 + g][d0]),
          ld2(&sm.k[nt * 8 + g][d0 + 8]));
    }
    *reinterpret_cast<float2*>(&sm.g[t0][nt * 8 + 2 * q4]) =
        make_float2(G[0], G[1]);
    *reinterpret_cast<float2*>(&sm.g[t1][nt * 8 + 2 * q4]) =
        make_float2(G[2], G[3]);
  }
  __syncwarp();

  for (int hh = 0; hh < hg; ++hh) {
    const int h = h0 + hh;
    const float* st =
        states + (((long long)b * H + h) * n_chunks + c) * DK * DV;
    float xv[V_PER_THREAD];          // every load in flight before any use
    float xs[DK * DV / NT];
    load_v_column<DV>(v + b * vs.b + h * vs.h, vs, c0, S, xv);
#pragma unroll
    for (int u = 0; u < DK * DV / NT; ++u) xs[u] = st[tid + u * NT];
#pragma unroll
    for (int u = 0; u < V_PER_THREAD; ++u)
      sm.vt[tid % DV][tid / DV + u * (NT / DV)] = __float2bfloat16_rn(xv[u]);
#pragma unroll
    for (int u = 0; u < DK * DV / NT; ++u) {
      const int e = tid + u * NT;
      split(xs[u], sm.sh[e % DV][e / DV], sm.sl[e % DV][e / DV]);
    }
    __syncthreads();

    const float* L = sm.L[hh];
    float acc[DV / 8][4];
    // inter: exp(L_t) · (q · S_start)
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      const int n = nt * 8 + g;
#pragma unroll
      for (int ks_ = 0; ks_ < DK / 16; ++ks_) {
        const int d0 = ks_ * 16 + 2 * q4;
        mma(acc[nt], qa[ks_], ld2(&sm.sh[n][d0]), ld2(&sm.sh[n][d0 + 8]));
        mma(acc[nt], qa[ks_], ld2(&sm.sl[n][d0]), ld2(&sm.sl[n][d0 + 8]));
      }
    }
    const float Lt0 = L[t0], Lt1 = L[t1];
    const float e0 = expf(Lt0), e1 = expf(Lt1);      // L <= 0: safe
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
    // intra: (G ∘ exp(L_t − L_i) ∘ [i <= t]) · v, key blocks up to the
    // diagonal; masked pairs are never exponentiated
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      if (kk > warp) continue;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {       // key columns +0 / +8
        const int i = (2 * kk + half) * 8 + 2 * q4;
        const float2 g0 = *reinterpret_cast<const float2*>(&sm.g[t0][i]);
        const float2 g1 = *reinterpret_cast<const float2*>(&sm.g[t1][i]);
        __nv_bfloat16 h00, l00, h01, l01, h10, l10, h11, l11;
        split(i <= t0 ? g0.x * expf(Lt0 - L[i]) : 0.0f, h00, l00);
        split(i + 1 <= t0 ? g0.y * expf(Lt0 - L[i + 1]) : 0.0f, h01, l01);
        split(i <= t1 ? g1.x * expf(Lt1 - L[i]) : 0.0f, h10, l10);
        split(i + 1 <= t1 ? g1.y * expf(Lt1 - L[i + 1]) : 0.0f, h11, l11);
        ah[2 * half] = pack(h00, h01);
        ah[2 * half + 1] = pack(h10, h11);
        al[2 * half] = pack(l00, l01);
        al[2 * half + 1] = pack(l10, l11);
      }
      const int i0 = kk * 16 + 2 * q4;
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
    __syncthreads();                   // vt / sh / sl are rewritten next
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* lw,
           const void* s0, void* out, void* s_out, void* states, void* lc,
           int B, int S, int H, Strides qs, Strides ks, Strides vs,
           Strides ls, cudaStream_t stream) {
  // set once, outside any graph capture
  static bool state_attr = false, scan_attr = false;
  const size_t state_bytes = sizeof(StateSmem<DK, DV>);
  const size_t scan_bytes = sizeof(ScanSmem<DK, DV>);
  int err = opt_in(ssd_state_kernel<DK, DV>, state_bytes, state_attr);
  if (!err) err = opt_in(ssd_scan_kernel<DK, DV>, scan_bytes, scan_attr);
  if (err) return err;
  // heads per CTA: the scan shares q·kᵀ among 8; the state kernel, which
  // shares only the k tile, takes 2 for more CTAs in flight
  const int hg = H % 8 == 0 ? 8 : H % 4 == 0 ? 4 : H % 2 == 0 ? 2 : 1;
  const int hg_state = H % 2 == 0 ? 2 : 1;
  const int n = (S + C - 1) / C;
  const dim3 grid(H / hg, n, B);
  if (n > 0) {                 // S = 0 only passes the initial state on
    ssd_state_kernel<DK, DV>
        <<<dim3(H / hg_state, n, B), NT, state_bytes, stream>>>(
            (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
            (const float*)lw, (float*)states, (float*)lc, H, S, n, hg_state,
            ks, vs, ls);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  ssd_pass_kernel<<<dim3((DK * DV + 255) / 256, H, B), 256, 0, stream>>>(
      (float*)states, (const float*)lc, (const float*)s0, (float*)s_out, H,
      n, DK * DV);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  if (n == 0) return 0;
  ssd_scan_kernel<DK, DV><<<grid, NT, scan_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)lw, (const float*)states,
      (__nv_bfloat16*)out, H, S, n, hg, qs, ks, vs, ls);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k [B, S, H, dk] (the head stride ignored: q and k are shared by
// every head) and v [B, S, H, dv], f32 log_w [B, S, H, ·] (one decay per
// token and head: its d stride ignored), as element strides (b, s, h, d);
// s0 [B, H, dk, dv] f32 contiguous or null (zero state). Writes out
// [B, S, H, dv] bf16 contiguous and s_out [B, H, dk, dv] f32, through the
// scratch states [B, H, ceil(S / 64), dk, dv] f32 and lc [B, H,
// ceil(S / 64)] f32. dk in {16, 32, 64}, dv in {16, 32, 64, 128}. Returns
// the first failed launch's cudaError_t (-1 for an unsupported width).
extern "C" int gla_ssd_launch(
    const void* q, const void* k, const void* v, const void* lw,
    const void* s0, void* out, void* s_out, void* states, void* lc, int B,
    int S, int H, int dk, int dv, long long q_sb, long long q_ss,
    long long q_sh, long long q_sd, long long k_sb, long long k_ss,
    long long k_sh, long long k_sd, long long v_sb, long long v_ss,
    long long v_sh, long long v_sd, long long l_sb, long long l_ss,
    long long l_sh, long long l_sd, void* stream) {
  if (B == 0 || H == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh, q_sd}, ks{k_sb, k_ss, k_sh, k_sd},
      vs{v_sb, v_ss, v_sh, v_sd}, ls{l_sb, l_ss, l_sh, l_sd};
  const cudaStream_t st = (cudaStream_t)stream;
#define SSD_CASE(DK, DV)                                                     \
  if (dk == DK && dv == DV)                                                  \
    return launch<DK, DV>(q, k, v, lw, s0, out, s_out, states, lc, B, S, H, \
                          qs, ks, vs, ls, st);
  SSD_CASE(16, 16) SSD_CASE(16, 32) SSD_CASE(16, 64) SSD_CASE(16, 128)
  SSD_CASE(32, 16) SSD_CASE(32, 32) SSD_CASE(32, 64) SSD_CASE(32, 128)
  SSD_CASE(64, 16) SSD_CASE(64, 32) SSD_CASE(64, 64) SSD_CASE(64, 128)
#undef SSD_CASE
  return -1;
}
