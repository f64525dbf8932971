// Chunked gated linear recurrence, written by hand for Hopper (sm_90a).
//
// Replaces gla_chunk_kernel (body _gla_kernel) in
// src/repro/kernels/gla_chunk/gla_chunk.py, in both of its regimes:
//   inclusive (Mamba2/SSD):  o_t = q_t · S_t
//   lag-1 with bonus u (RWKV6): o_t = q_t · S_{t-1} + (q_t·u·k_t) v_t
// for f32 inputs and the bf16 calls no tensor-core design takes: bf16
// Mamba2 runs on gla_ssd.cu, bf16 RWKV6 (the lag-1 read) on gla_rwkv6.cu.
// with S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_tᵀ, an f32 [dk, dv] state
// per (batch, head). Per chunk of C = 64 tokens, all in f32 as the TPU
// kernel: the cumulative log-decay L; the inter-chunk read
// (q·exp(Lq)) @ S; the intra-chunk term A[t,i] = Σ_d q_td k_id
// exp(Lq_td − L_id) over pairs i <= t − lag, the mask applied before the
// exp (a masked pair is never exponentiated), times v; the bonus; then
// S <- exp(L_C)·S + (k·exp(L_C − L))ᵀ v.
//
// Two additions the model path needs and the TPU kernel lacks: an
// optional initial state in and the final state out (the decode cache),
// and any sequence length — the ragged tail of the last chunk is padded
// here with k = 0, v = 0 and log_w = 0 (no state contribution, state
// frozen), as models/gla.py pads, and not stored. q, k, v and log_w are
// read through element strides (b, s, h, d), so Mamba2's q and k
// broadcast over heads and its per-head log-decay broadcast over dk are
// read with zero strides and never materialized.
//
// Bound on this card: operations. A chunk does ~C²·dk/2 exps of the
// intra term plus ~4·C·dk·dv flops of the inter term, the intra product
// and the state update, on 4·C·(2dk + dv) bytes of input — hundreds of
// flops per byte at dk = dv = 64, so the exps on the SFUs and the f32
// FMAs set the time, not HBM.
//
// Design: one 256-thread CTA per (batch, head) walks the chunks in order
// (the TPU grid's sequential axis becomes this loop). Shared memory holds
// the chunk's q, k, L and Lq (rows padded to dk + 1 floats, so sixteen
// threads reading sixteen rows hit sixteen banks), v, the state S and the
// [C, C] score tile: 114 KB at dk = dv = 64, two CTAs per SM. Thread
// (ty, tx) of a 16 x 16 grid owns rows ty + 16r and columns tx + 16c of
// each tile it writes (A, the output, the state).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C = 64;          // chunk length (the model's)
constexpr int NT = 256;
constexpr int MAX_DK = 64;
constexpr int MAX_DV = 128;
constexpr float NEG_INF = -1e30f;

struct Strides {               // element strides of a [B, S, H, d] view
  long long b, s, h, d;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int dk, int dv) {
  const int ldk = dk + 1;
  return sizeof(float) *
         (size_t)(4 * C * ldk + C * dv + dk * dv + C * (C + 1) + C + dk);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gla_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ out, float* __restrict__ s_out, int H,
                 int S, int dk, int dv, int inclusive, Strides qs,
                 Strides ks, Strides vs, Strides ls) {
  const int ldk = dk + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [C][ldk] q, then q·exp(Lq)
  float* Ks = Qs + C * ldk;            // [C][ldk] k, then k·exp(L_C − L)
  float* Ls = Ks + C * ldk;            // [C][ldk] log_w, then L
  float* LQs = Ls + C * ldk;           // [C][ldk] Lq
  float* Vs = LQs + C * ldk;           // [C][dv]
  float* Ss = Vs + C * dv;             // [dk][dv] the state
  float* As = Ss + dk * dv;            // [C][C + 1]
  float* bonus = As + C * (C + 1);     // [C]
  float* Lc = bonus + C;               // [dk] L at the chunk's end

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lag = inclusive ? 0 : 1;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* lb = lw + b * ls.b + h * ls.h;
  const float* ub = u ? u + (long long)h * dk : nullptr;
  float* st = s_out + (long long)bh * dk * dv;

  for (int e = tid; e < dk * dv; e += NT)
    Ss[e] = s0 ? s0[(long long)bh * dk * dv + e] : 0.0f;

  for (int c0 = 0; c0 < S; c0 += C) {
    __syncthreads();            // the previous chunk's readers are done
    for (int e = tid; e < C * dk; e += NT) {
      const int t = e / dk, d = e % dk, s = c0 + t;
      const bool ok = s < S;
      Qs[t * ldk + d] = ok ? to_f32(qb[s * qs.s + d * qs.d]) : 0.0f;
      Ks[t * ldk + d] = ok ? to_f32(kb[s * ks.s + d * ks.d]) : 0.0f;
      Ls[t * ldk + d] = ok ? lb[s * ls.s + d * ls.d] : 0.0f;
    }
    for (int e = tid; e < C * dv; e += NT) {
      const int t = e / dv, j = e % dv, s = c0 + t;
      Vs[t * dv + j] = s < S ? to_f32(vb[s * vs.s + j * vs.d]) : 0.0f;
    }
    __syncthreads();

    // cumulative log-decay, one column per thread
    if (tid < dk) {
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float w = Ls[t * ldk + tid];
        run += w;
        Ls[t * ldk + tid] = run;
        LQs[t * ldk + tid] = inclusive ? run : run - w;
      }
      Lc[tid] = run;
    }
    __syncthreads();

    // intra-chunk scores, masked before the exp
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
      for (int cc = 0; cc < 4; ++cc) {
        const int i = tx + 16 * cc;
        float a = 0.0f;
        if (t >= i + lag) {
          const float* qr = Qs + t * ldk;
          const float* lqr = LQs + t * ldk;
          const float* kr = Ks + i * ldk;
          const float* lr = Ls + i * ldk;
          for (int d = 0; d < dk; ++d)
            a += qr[d] * kr[d] * expf(lqr[d] - lr[d]);
        }
        As[t * (C + 1) + i] = a;
      }
    }
    if (ub && tid < C) {         // RWKV6 bonus: q_t · u · k_t
      float dot = 0.0f;
      for (int d = 0; d < dk; ++d)
        dot += Qs[tid * ldk + d] * ub[d] * Ks[tid * ldk + d];
      bonus[tid] = dot;
    }
    __syncthreads();

    for (int e = tid; e < C * dk; e += NT) {
      const int t = e / dk, d = e % dk;
      Qs[t * ldk + d] *= expf(LQs[t * ldk + d]);       // Lq <= 0: safe
    }
    __syncthreads();

    // out = (q·exp(Lq)) @ S + A @ v (+ bonus·v)
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r, s = c0 + t;
      for (int j = tx; j < dv; j += 16) {
        float inter = 0.0f, intra = 0.0f;
        for (int d = 0; d < dk; ++d) inter += Qs[t * ldk + d] * Ss[d * dv + j];
        for (int i = 0; i < C; ++i) intra += As[t * (C + 1) + i] * Vs[i * dv + j];
        float o = inter + intra;
        if (ub) o += bonus[t] * Vs[t * dv + j];
        if (s < S)
          out[(((long long)b * S + s) * H + h) * dv + j] = from_f32<T>(o);
      }
    }
    __syncthreads();

    for (int e = tid; e < C * dk; e += NT) {
      const int t = e / dk, d = e % dk;
      Ks[t * ldk + d] *= expf(Lc[d] - Ls[t * ldk + d]);  // <= 0: safe
    }
    __syncthreads();

    // S <- exp(L_C)·S + (k·exp(L_C − L))ᵀ v
    for (int d = ty; d < dk; d += 16) {
      const float decay = expf(Lc[d]);
      for (int j = tx; j < dv; j += 16) {
        float add = 0.0f;
        for (int i = 0; i < C; ++i) add += Ks[i * ldk + d] * Vs[i * dv + j];
        Ss[d * dv + j] = decay * Ss[d * dv + j] + add;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * dv; e += NT) st[e] = Ss[e];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* out, void* s_out, int B,
           int H, int S, int dk, int dv, int inclusive, Strides qs,
           Strides ks, Strides vs, Strides ls, cudaStream_t stream) {
  const size_t bytes = smem_bytes(dk, dv);
  static bool attr_set = false;       // set once, outside any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gla_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(MAX_DK, MAX_DV));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  gla_chunk_kernel<T><<<B * H, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)lw,
      (const float*)u, (const float*)s0, (T*)out, (float*)s_out, H, S, dk,
      dv, inclusive, qs, ks, vs, ls);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, log_w [B, S, H, dk] and v [B, S, H, dv] as element strides
// (b, s, h, d) — zero strides allowed; q, k, v of dtype 0 = f32 or
// 1 = bf16, log_w f32; u [H, dk] f32 or null (no bonus); s0 [B, H, dk, dv]
// f32 contiguous or null (zero state). Writes out [B, S, H, dv]
// contiguous in q's dtype and s_out [B, H, dk, dv] f32. dk <= 64,
// dv <= 128. Returns the launch's cudaError_t (-1 for an unsupported
// dtype or width).
extern "C" int gla_chunk_launch(
    const void* q, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* out, void* s_out, int dtype, int B,
    int S, int H, int dk, int dv, int inclusive, long long q_sb,
    long long q_ss, long long q_sh, long long q_sd, long long k_sb,
    long long k_ss, long long k_sh, long long k_sd, long long v_sb,
    long long v_ss, long long v_sh, long long v_sd, long long l_sb,
    long long l_ss, long long l_sh, long long l_sd, void* stream) {
  if (dk < 1 || dk > MAX_DK || dv < 1 || dv > MAX_DV) return -1;
  if (B == 0 || H == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh, q_sd}, ks{k_sb, k_ss, k_sh, k_sd},
      vs{v_sb, v_ss, v_sh, v_sd}, ls{l_sb, l_ss, l_sh, l_sd};
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, lw, u, s0, out, s_out, B, H, S, dk, dv,
                         inclusive, qs, ks, vs, ls, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, lw, u, s0, out, s_out, B, H, S,
                                 dk, dv, inclusive, qs, ks, vs, ls, st);
  return -1;
}
