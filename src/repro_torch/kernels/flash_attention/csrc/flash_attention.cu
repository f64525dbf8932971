// Causal or full GQA attention with a streaming (online) softmax, written
// by hand for Hopper (sm_90a).
//
// Replaces flash_attention (body _flash_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py: scores in f32,
// running (m, l, acc) in f32, NEG_INF = -1e30 for masked scores, l floored
// at 1e-30, output in the input dtype, and no work on key tiles that
// causality masks for the whole query tile.
//
// Differences from the TPU kernel, all on the caller's side of the
// contract: any sequence length (the query and key tails are masked here,
// where the TPU kernel asserts S % 128 == 0), and any element strides for
// the batch, head and sequence axes of q, k, v and o (the head_dim axis
// contiguous), so the model's [B, S, H, D] activations are read and
// written in place with no transpose.
//
// Bound on this card: operations. Causal prefill does 2·B·Hq·S²·D flops
// on ~4·B·S·(Hq + Hkv)·D bytes: at the main path's S = 2048 that is over
// 500 flops per byte, far above the H100's ridge. This first version does
// its math in f32 on the CUDA cores (67 TFLOP/s peak, against 989 for the
// bf16 tensor cores), so it sits well above the bf16 bound; wgmma and TMA
// are the later redesign.
//
// Design: one 256-thread CTA per (64-query tile, q head, batch), the
// heaviest causal tiles scheduled first. The CTA holds its Q tile, one K
// and one V tile of 64 keys and the 64 x 64 probability tile in shared
// memory, all f32 (119 KB at D = 128, so the launch opts in to dynamic
// shared memory). Thread (ty, tx) of a 16 x 16 grid owns score rows
// ty + 16i and columns tx + 16j (i, j < 4) — rows of one half-warp, so the
// row max and row sum reduce with four shuffles — and the output rows
// ty + 16i, columns 4tx + 64c .. +3 (at D < 64 the threads past D idle
// in the PV product). Rows are padded by 4 floats, so the
// float4 reads of K rows by eight neighbouring threads hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per CTA
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per CTA
constexpr float NEG_INF = -1e30f;

struct Strides {              // element strides of a [B, H, S, D] view
  long long b, h, s;
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

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return 3 * 64 * (D + 4) + 64 * (BK + 4);
}

// Copy rows [s0, s0 + 64) of one head into a padded f32 tile; rows past
// n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int s0,
                                          int n_rows) {
  constexpr int LD = D + 4;
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, c = e % D, s = s0 + r;
    dst[r * LD + c] = s < n_rows ? to_f32(src[(long long)s * row_stride + c])
                                 : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int Sq, int Skv, int n_qt, float scale, int causal,
                 Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int LD = D + 4;
  constexpr int LP = BK + 4;
  constexpr int DC = (D + 63) / 64;   // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = n_qt - 1 - blockIdx.x;          // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * BQ;

  load_tile<T, D>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  float m[4], l[4], acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.0f;
  }

  const int n_kt = (Skv + BK - 1) / BK;
  // causal skip: a key tile runs only if the last valid query of this
  // tile can see its first key
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int kt_end = causal ? min(n_kt, last_q / BK + 1) : n_kt;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();            // the previous tile's readers are done
    load_tile<T, D>(Ks, kb, ks.s, k0, Skv);
    load_tile<T, D>(Vs, vb, vs.s, k0, Skv);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                      qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Skv && (!causal || row >= col);
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();            // the P tile is complete

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) {
          if (4 * tx + 64 * cc >= D) continue;     // D < 64: idle columns
          const float4 vv = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * LD + 4 * tx + 64 * cc]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? p4[i].x
                          : jj == 1 ? p4[i].y
                          : jj == 2 ? p4[i].z : p4[i].w;
            acc[i][4 * cc + 0] += p * vv.x;
            acc[i][4 * cc + 1] += p * vv.y;
            acc[i][4 * cc + 2] += p * vv.z;
            acc[i][4 * cc + 3] += p * vv.w;
          }
        }
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * tx + 64 * cc < D)
          ob[(long long)row * os.s + 4 * tx + 64 * cc + e] =
              from_f32<T>(acc[i][4 * cc + e] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
           Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * 4;
  static bool attr_set = false;      // set once, outside any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_qt = (Sq + BQ - 1) / BQ;
  const dim3 grid(n_qt, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq / Hkv, Sq, Skv, n_qt,
      scale, causal, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], o [B, Hq, Sq, D] as element
// strides (b, h, s) with D contiguous; dtype 0 = f32, 1 = bf16; D in
// {16, 32, 64, 128} (the models' 64 and 128; the smoke configs' 16);
// Hq a multiple of Hkv. Returns the launch's cudaError_t (-1
// for a dtype or head_dim this file was not built for).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, float scale, int causal,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(T, DT, HD)                                              \
  if (dtype == DT && D == HD)                                              \
    return launch<T, HD>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, qs, \
                         ks, vs, os, s);
  FLASH_CASE(float, 0, 16)
  FLASH_CASE(float, 0, 32)
  FLASH_CASE(float, 0, 64)
  FLASH_CASE(float, 0, 128)
  FLASH_CASE(__nv_bfloat16, 1, 16)
  FLASH_CASE(__nv_bfloat16, 1, 32)
  FLASH_CASE(__nv_bfloat16, 1, 64)
  FLASH_CASE(__nv_bfloat16, 1, 128)
#undef FLASH_CASE
  return -1;
}
