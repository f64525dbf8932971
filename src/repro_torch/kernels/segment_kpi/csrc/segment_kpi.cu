// The Data Transformer's numeric core and the serving layer's two read /
// write ops, written by hand for Hopper (sm_90a). Three kernel families,
// one per TPU kernel they replace (all in
// src/repro/kernels/segment_kpi/segment_kpi.py):
//
// 1. segment_kpi_launch  <- segment_kpi_kernel (body _kpi_kernel).
//    Fact-grain split + OEE KPIs per row, and the per-unit KPI rollup.
//    Bound: bytes, and at the main path's ~1k-row micro-batches, launch
//    latency. A row reads 3 x 32 B and writes 40 B; 1k rows are ~130 KB,
//    ~40 ns of HBM time, far below a launch. Design: one thread per row
//    computes the ten fact lanes in the reference's op order (IEEE
//    division, no FMA contraction: the build passes -fmad=false), so the
//    facts are bitwise the numpy oracle's. The TPU kernel rolls up with a
//    one-hot MXU product; here each 256-row block reduces its valid rows
//    into [n_units, 5] in row order from shared memory, and a second
//    launch adds the block partials in block order. No float atomics, so
//    two runs give the same bits.
//
// 2. fold_segments_launch <- fold_segments_kernel (body _fold_kernel).
//    Serving-view delta fold: per segment, count + sum/min/max of every
//    value lane. Bound: launch latency at the main path's shapes (B <=
//    2048 rows, S <= 60 compacted segments, L <= 4 lanes: < 50 KB moved).
//    Design: one block per (segment, lane) runs the shared-memory
//    stride-halving tree s[i] = s[i] (+) s[i + h], h = B/2 ... 1 — operand
//    for operand the reference's x[:h] (+) x[h:], so the result is
//    BITWISE the numpy halving tree (the TPU kernel's matmul order is
//    only ~1e-5). Sums are one-hot * v as a float multiply (0 * -3 is
//    -0.0, as in numpy), min/max lanes are hit ? v : +-inf.
//
// 3. gather_stats_launch  <- gather_stats_kernel (body _gather_kernel).
//    Batched point read: row idx of the packed [S, 1 + 3L] table plus
//    means = sums / count (NaN at count 0). Bound: bytes / launch latency
//    (a 4096-query batch moves ~280 KB). Design: one thread per output
//    element, a direct gather and one IEEE divide — bitwise the numpy
//    oracle (the TPU kernel's one-hot matmul and 0 * inf workaround have
//    no reason to exist here).
//
// Min/max follow numpy exactly: np.minimum(a, b) is (a < b || isnan(a)) ?
// a : b — it returns the SECOND operand on ties (so +-0 order matters) and
// propagates NaN. fminf/fmaxf do neither, so they are not used.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KPI_LANES 5
#define N_FACT 10
#define PAYLOAD 8
#define KPI_BLOCK 256
#define FOLD_THREADS 256

__device__ __forceinline__ float np_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float np_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float np_clip01(float x) {
  return np_min(np_max(x, 0.0f), 1.0f);
}

// ------------------------------------------------------------------ KPI
__global__ void kpi_facts_kernel(const float* __restrict__ prod,
                                 const float* __restrict__ eq,
                                 const float* __restrict__ qr, int n,
                                 int n_units, float* __restrict__ facts,
                                 float* __restrict__ partials) {
  __shared__ int s_unit[KPI_BLOCK];
  __shared__ float s_kpi[KPI_BLOCK][KPI_LANES];
  const float EPS = 1e-6f;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * KPI_BLOCK + tid;
  int unit = -1;
  if (i < n) {
    const float* p = prod + (int64_t)i * PAYLOAD;
    const float* e = eq + (int64_t)i * PAYLOAD;
    const float* q = qr + (int64_t)i * PAYLOAD;
    const float t_start = p[3], t_end = p[4], qty = p[5];
    const float e_start = e[3], e_end = e[4], status = e[5];
    const float max_speed = e[6], planned = e[7];
    const float defects = q[4], scrap = q[6];

    const float inter_lo = np_max(t_start, e_start);
    const float inter_hi = np_min(t_end, e_end);
    const float overlap = np_max(__fsub_rn(inter_hi, inter_lo), 0.0f);
    const float duration = np_max(__fsub_rn(t_end, t_start), EPS);
    const float seg_on = status > 0.5f ? overlap : 0.0f;
    const float seg_off = __fsub_rn(duration, seg_on);
    const float availability =
        np_clip01(__fdiv_rn(seg_on, np_max(planned, EPS)));
    const float performance = np_clip01(
        __fdiv_rn(qty, np_max(__fmul_rn(max_speed, duration), EPS)));
    const float good =
        np_max(__fsub_rn(__fsub_rn(qty, defects), scrap), 0.0f);
    const float quality = np_clip01(__fdiv_rn(good, np_max(qty, EPS)));
    const float oee =
        __fmul_rn(__fmul_rn(availability, performance), quality);
    const bool valid = (e[1] >= 0.0f) && (q[1] >= 0.0f);

    float* f = facts + (int64_t)i * N_FACT;
    f[0] = p[1];
    f[1] = t_start;
    f[2] = t_end;
    f[3] = availability;
    f[4] = performance;
    f[5] = quality;
    f[6] = oee;
    f[7] = seg_on;
    f[8] = seg_off;
    f[9] = valid ? 1.0f : 0.0f;

    const int u = (int)p[1];
    if (valid && u >= 0 && u < n_units) unit = u;
    s_kpi[tid][0] = availability;
    s_kpi[tid][1] = performance;
    s_kpi[tid][2] = quality;
    s_kpi[tid][3] = oee;
    s_kpi[tid][4] = 1.0f;
  }
  s_unit[tid] = unit;
  __syncthreads();
  // deterministic per-block rollup: output (u, c) sums its block's rows
  // in row order
  const int n_out = n_units * KPI_LANES;
  float* part = partials + (int64_t)blockIdx.x * n_out;
  for (int o = tid; o < n_out; o += KPI_BLOCK) {
    const int u = o / KPI_LANES, c = o % KPI_LANES;
    float acc = 0.0f;
    for (int r = 0; r < KPI_BLOCK; ++r)
      if (s_unit[r] == u) acc = __fadd_rn(acc, s_kpi[r][c]);
    part[o] = acc;
  }
}

__global__ void kpi_block_sum_kernel(const float* __restrict__ partials,
                                     int n_blocks, int n_out,
                                     float* __restrict__ agg) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float acc = 0.0f;
  for (int b = 0; b < n_blocks; ++b)
    acc = __fadd_rn(acc, partials[(int64_t)b * n_out + o]);
  agg[o] = acc;
}

// prod/eq/qr [n, 8] f32 (a joined row with col 1 < 0 marks a join miss)
// -> facts [n, 10] f32, agg [n_units, 5] f32; partials is caller-allocated
// scratch of ceil(n / 256) * n_units * 5 floats.
extern "C" int segment_kpi_launch(const void* prod, const void* eq,
                                  const void* qr, int n, int n_units,
                                  void* facts, void* partials, void* agg,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_out = n_units * KPI_LANES;
  const int n_blocks = (n + KPI_BLOCK - 1) / KPI_BLOCK;
  if (n_blocks > 0) {
    kpi_facts_kernel<<<n_blocks, KPI_BLOCK, 0, s>>>(
        (const float*)prod, (const float*)eq, (const float*)qr, n, n_units,
        (float*)facts, (float*)partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  kpi_block_sum_kernel<<<(n_out + 127) / 128, 128, 0, s>>>(
      (const float*)partials, n_blocks, n_out, (float*)agg);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- fold
__global__ void fold_kernel(const int64_t* __restrict__ seg,
                            const float* __restrict__ vals, int B, int L,
                            float* __restrict__ out) {
  extern __shared__ float sm[];
  float* s_sum = sm;
  float* s_min = sm + B;
  float* s_max = sm + 2 * B;
  float* s_cnt = sm + 3 * B;           // used by the lane-0 block only
  const int64_t s = blockIdx.x;
  const int j = blockIdx.y;
  const bool counts = (j == 0);
  const int tid = threadIdx.x;
  for (int i = tid; i < B; i += blockDim.x) {
    const bool hit = seg[i] == s;
    const float oh = hit ? 1.0f : 0.0f;
    const float v = vals[(int64_t)i * L + j];
    s_sum[i] = __fmul_rn(oh, v);
    s_min[i] = hit ? v : __int_as_float(0x7f800000);   // +inf
    s_max[i] = hit ? v : __int_as_float(0xff800000);  // -inf
    if (counts) s_cnt[i] = oh;
  }
  __syncthreads();
  for (int h = B >> 1; h >= 1; h >>= 1) {
    for (int i = tid; i < h; i += blockDim.x) {
      s_sum[i] = __fadd_rn(s_sum[i], s_sum[i + h]);
      s_min[i] = np_min(s_min[i], s_min[i + h]);
      s_max[i] = np_max(s_max[i], s_max[i + h]);
      if (counts) s_cnt[i] = __fadd_rn(s_cnt[i], s_cnt[i + h]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    float* row = out + s * (1 + 3 * L);
    row[1 + j] = s_sum[0];
    row[1 + L + j] = s_min[0];
    row[1 + 2 * L + j] = s_max[0];
    if (counts) row[0] = s_cnt[0];
  }
}

// seg [B] i64 (B a power of two, <= 2048; ids outside [0, S) are the
// identity), vals [B, L] f32 -> out [S, 1 + 3L] f32:
// [count | sums(L) | mins(L) | maxs(L)].
extern "C" int fold_segments_launch(const void* seg, const void* vals,
                                    int B, int L, int S, void* out,
                                    void* stream) {
  if (S == 0 || L == 0) return 0;
  const dim3 grid(S, L);
  const int threads = B < FOLD_THREADS ? B : FOLD_THREADS;
  const size_t smem = 4 * (size_t)B * sizeof(float);
  fold_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)seg, (const float*)vals, B, L, (float*)out);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- gather
__global__ void gather_kernel(const float* __restrict__ table, int L,
                              const int64_t* __restrict__ idx, int64_t total,
                              float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int W = 1 + 3 * L, WO = 1 + 4 * L;
  const int64_t r = e / WO;
  const int c = (int)(e % WO);
  const float* t = table + idx[r] * W;
  float v;
  if (c < W) {
    v = t[c];
  } else {
    const float cnt = t[0];
    // numpy's np.nan bit pattern, so empty segments match byte for byte
    v = cnt > 0.0f ? __fdiv_rn(t[1 + (c - W)], cnt)
                   : __int_as_float(0x7fc00000);
  }
  out[e] = v;
}

// table [S, 1 + 3L] f32, idx [n] i64 in [0, S) -> out [n, 1 + 4L] f32:
// [count | sums | mins | maxs | means].
extern "C" int gather_stats_launch(const void* table, int L, const void* idx,
                                   int n, void* out, void* stream) {
  const int64_t total = (int64_t)n * (1 + 4 * L);
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, L, (const int64_t*)idx, total, (float*)out);
  return (int)cudaGetLastError();
}
