// Causal or full GQA attention in bf16 on Hopper's tensor cores (sm_90a):
// wgmma products fed by TMA, with a streaming (online) softmax.
//
// Replaces flash_attention (body _flash_kernel) in
// src/repro/kernels/flash_attention/flash_attention.py for the models'
// dtype, bf16, at head_dim 64 and 128; f32 and head_dim 16/32 stay on
// flash_attention.cu (the wrapper routes by dtype, head_dim and TMA
// alignment). The contract is that kernel's: scores and the running
// (m, l, acc) in f32, NEG_INF = -1e30 for masked scores, l floored at
// 1e-30, any Sq and Skv, the [B, S, H, D] activations read and written
// through strides, the heaviest causal tiles first. What it rounds beyond
// that: the probabilities P go to bf16 before the PV product, as the
// reference's prefill (models/attention.py:attend_full) rounds them.
//
// Bound on this card: operations. Causal prefill does 2·B·Hq·S²·D flops
// on ~4·B·S·(Hq + Hkv)·D bytes, over 500 flops per byte at S = 2048, far
// above the H100's ridge, so the bf16 tensor cores (989 TFLOP/s dense)
// set the bound.
//
// Design: one CTA per (128-query tile, q head, batch), 384 threads:
//   warpgroups 0 and 1 consume, 64 query rows each; warpgroup 2 produces.
//   One producer thread loads the Q tile once and then K/V tiles of 64
//   keys into a 2-stage ring in shared memory with TMA (4-D tensor maps
//   over the strided [B, S, H, D] views, the head picked by coordinate,
//   128-byte swizzle, rows past Skv zero-filled), each stage under a
//   "full" mbarrier (transaction bytes) and an "empty" one (the 256
//   consumer threads arrive when their wgmma reads are done).
//   Consumers: S = Q·Kᵀ by wgmma m64n64k16 from shared memory (f32
//   accumulators in registers), the scores scaled into the exp2 domain,
//   masked only on tiles that cross the diagonal or Skv, the online
//   softmax on the accumulator fragments (a row lives in one quad of
//   threads: two shuffles), P packed to bf16 in registers as the A operand
//   of O += P·V (wgmma with A in registers; V, [keys, D], read as the
//   MN-major B operand). The producer gives up registers (setmaxnreg) to
//   the consumers. Causal: a warpgroup skips the key tiles its own rows
//   cannot see (it still waits and releases each stage).
// Shared memory: Q 16 KB per 64 columns of D, two stages of K and V of
// 8 KB per 64 columns each: 96 KB at D = 128, 48 KB at D = 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;       // queries per CTA (two consumer warpgroups)
// keys per tile. 128 at D = 64 ran ~9% faster on the H100, but its other
// running maxima round P differently, and that moved zamba2's bf16
// prefill/decode consistency check (chip_smoke.py) past its bound.
constexpr int BN = 64;
constexpr int NSTAGE = 2;
constexpr int NT = 384;
constexpr int N_CONSUMER = 256;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {                 // every tile 1024-byte aligned (swizzle atom)
  __nv_bfloat16 q[D / 64][BM * 64];
  __nv_bfloat16 k[NSTAGE][D / 64][BN * 64];
  __nv_bfloat16 v[NSTAGE][D / 64][BN * 64];
  uint64_t q_full;
  uint64_t kv_full[NSTAGE];
  uint64_t kv_empty[NSTAGE];
};

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<D>) + 1024;     // + alignment slack
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, int group, int Sq, int Skv,
                int n_qt, float scale_log2, int causal, long long o_sb,
                long long o_sh, long long o_ss) {
  constexpr int NC = D / 64;          // 64-column boxes of D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + pad);

  const int qt = n_qt - 1 - blockIdx.x;          // heavy tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * BM;
  const int n_kt = (Skv + BN - 1) / BN;
  // causal skip: a key tile runs only if the last valid query of this
  // tile can see its first key
  const int last_q = min(q0 + BM, Sq) - 1;
  const int kt_end = causal ? min(n_kt, last_q / BN + 1) : n_kt;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], N_CONSUMER);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(&sm.q_full, BM * D * 2);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_4d(sm.q[c], &qmap, &sm.q_full, 64 * c, q0, h, b);
      for (int kt = 0; kt < kt_end; ++kt) {
        const int s = kt % NSTAGE, round = kt / NSTAGE;
        if (round > 0) mbar_wait(&sm.kv_empty[s], (round - 1) & 1);
        mbar_expect_tx(&sm.kv_full[s], 2 * BN * D * 2);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_4d(sm.k[s][c], &kmap, &sm.kv_full[s], 64 * c, kt * BN,
                      hk, b);
          tma_load_4d(sm.v[s][c], &vmap, &sm.kv_full[s], 64 * c, kt * BN,
                      hk, b);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, q4 = lane % 4;
    const int wq0 = q0 + 64 * wg;                 // this warpgroup's rows
    const int wlast = min(wq0 + 64, Sq) - 1;
    const int w_end = wlast < wq0 ? 0
                      : causal ? min(n_kt, wlast / BN + 1) : n_kt;
    const int row0 = wq0 + 16 * warp + g, row1 = row0 + 8;

    float oacc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[c][i] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(&sm.q_full, 0);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int s = kt % NSTAGE, round = kt / NSTAGE;
      mbar_wait(&sm.kv_full[s], round & 1);
      if (kt < w_end) {
        // S = Q · Kᵀ, 16 columns of D per wgmma
        float sacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, off = (kk % 4) * 16;
          wgmma_m64n64k16_ss(sacc, desc_sw128(&sm.q[c][wg * 64 * 64 + off]),
                             desc_sw128(&sm.k[s][c][off]), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sacc);

        // scale into the exp2 domain; mask only where the tile needs it
        const int k0 = kt * BN;
        const bool need_mask = k0 + BN > Skv || (causal && k0 + BN - 1 > wq0);
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = sacc[i] * scale_log2;
          if (need_mask) {
            const int col = k0 + 8 * (i >> 2) + 2 * q4 + (i & 1);
            const int row = (i & 2) ? row1 : row0;
            if (col >= Skv || (causal && col > row)) x = NEG_INF;
          }
          sacc[i] = x;
          if (i & 2) mx1 = fmaxf(mx1, x);
          else mx0 = fmaxf(mx0, x);
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = exp2f(sacc[i] - ((i & 2) ? mn1 : mn0));
          sacc[i] = p;
          if (i & 2) ps1 += p;
          else ps0 += p;
        }
        l0 = l0 * corr0 + ps0;        // per-thread partial; quad-summed last
        l1 = l1 * corr1 + ps1;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i) oacc[c][i] *= (i & 2) ? corr1 : corr0;

        // P as bf16 A fragments: key block kk is accumulator columns
        // 16kk .. 16kk + 15
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        }
        // O += P · V, 16 keys per wgmma, one per 64 columns of D
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            wgmma_m64n64k16_rs(oacc[c], pa[kk],
                               desc_sw128(&sm.v[s][c][kk * 16 * 64]));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) fence_regs(oacc[c]);
      }
      mbar_arrive(&sm.kv_empty[s]);       // this thread is done with stage s
    }

    // epilogue: normalise and store the valid rows
    const float li0 = fmaxf(quad_sum(l0), 1e-30f);
    const float li1 = fmaxf(quad_sum(l1), 1e-30f);
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * q4;
        if (row0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + row0 * o_ss + col) = pack_bf16(
              oacc[c][4 * j] / li0, oacc[c][4 * j + 1] / li0);
        if (row1 < Sq)
          *reinterpret_cast<uint32_t*>(ob + row1 * o_ss + col) = pack_bf16(
              oacc[c][4 * j + 2] / li1, oacc[c][4 * j + 3] / li1);
      }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: it is looked up through
// the runtime, so the library links no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a bf16 [B, S, H, D] tensor given by element strides
// (b, h, s) with D contiguous: dims innermost first (D, S, H, B), boxes of
// 64 columns x `rows` positions of one head, 128-byte swizzle.
int make_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
             long long sb, long long sh, long long ss, int rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, float scale, int causal,
           const long long* st, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool attr_set = false;      // set once, outside any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  CUtensorMap qm, km, vm;
  int err = make_map(&qm, q, B, Sq, Hq, D, st[0], st[1], st[2], BM);
  if (!err) err = make_map(&km, k, B, Skv, Hkv, D, st[3], st[4], st[5], BN);
  if (!err) err = make_map(&vm, v, B, Skv, Hkv, D, st[6], st[7], st[8], BN);
  if (err) return err;
  const int n_qt = (Sq + BM - 1) / BM;
  const dim3 grid(n_qt, Hq, B);
  flash_tc_kernel<D><<<grid, NT, bytes, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, Hq / Hkv, Sq, Skv, n_qt,
      scale * 1.4426950408889634f, causal, st[9], st[10], st[11]);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], o [B, Hq, Sq, D] as
// element strides (b, h, s) with D contiguous; D in {64, 128}; Hq a
// multiple of Hkv. q, k and v 16-byte aligned with strides that are
// multiples of 8 elements (TMA's 16 bytes). Returns the launch's
// cudaError_t; -1 for an unsupported head_dim, -2 when the driver's
// cuTensorMapEncodeTiled cannot be found, -3 when it refuses a map.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, float scale, int causal,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, st, s);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale, causal, st,
                       s);
  return -1;
}
