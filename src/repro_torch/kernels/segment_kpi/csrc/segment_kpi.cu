// The Data Transformer's numeric core and the serving layer's two read /
// write ops, written by hand for Hopper (sm_90a). Four kernel families,
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
// 2. segment_rollup_launch <- segment_rollup_kernel (body _rollup_kernel).
//    The per-unit KPI rollup of already-built fact rows: the warehouse's
//    full rescan (Warehouse.kpi_rollup), O(history) rows per call. Bound:
//    bytes — every 40 B fact row is read once (2^20 rows: 40 MiB, ~12.5 us
//    of HBM time). Design: the KPI kernel's rollup without its fact build,
//    so the sums come out bitwise the plain version's: one block per
//    256-row block stages the rows' units and KPI lanes in shared memory
//    and one thread per (unit, lane) adds them in row order into a
//    partials buffer; kpi_block_sum_kernel adds the partials in block
//    order. Any N, no padding; row offsets are 64-bit. The unit is col 0
//    truncated toward zero (numpy's astype); a NaN unit is dropped
//    explicitly, because the conversion would make it unit 0.
//
// 3. fold_segments_many_launch <- fold_segments_kernel (body _fold_kernel).
//    Serving-view delta fold of a whole fold cycle in one launch: every
//    (delta, view) item's count + sum/min/max per segment per value lane,
//    each item's <= 2048-row blocks combined in block order. Bound: launch
//    latency and the host round trip around it — a steelworks cycle (4
//    views x one ~1k-row delta) moves ~70 KB, ~20 ns of HBM time — so the
//    design puts the cycle's every item and block into ONE launch fed by
//    one staged buffer (descriptors, compacted segment ids, lane-major
//    values), where slice 1 made one launch and one blocking copy per
//    (delta, view, block). A CTA covers (item, segment chunk; 2 segments
//    at 4 lanes, so that its tasks fill its 8 warps once): it stages a
//    block's ids and values in shared memory once with cp.async, then each
//    warp reduces one (segment, lane) halving tree — count, sum, min and
//    max at once — in registers: lane t holds rows t + 32k, the levels
//    h >= 32 pair two of the thread's own registers, the last five are
//    __shfl_down_sync, so the tree has no __syncthreads. Those are the
//    operand pairs, in the same order, of x[:h] (+) x[h:] (s[i] is the
//    first operand of every combine), so the result is BITWISE the numpy
//    halving tree (the TPU kernel's matmul order is only ~1e-5). Sums are
//    one-hot * v as a float multiply (0 * -3 is -0.0, 0 * inf is NaN, as
//    in numpy), min/max lanes are hit ? v : +-inf. Block partials combine
//    into the output in block order from the identity (0 + -0 = +0, as
//    combine_fold does).
//
// 4. gather_stats_launch  <- gather_stats_kernel (body _gather_kernel).
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
#define FOLD_THREADS 256       // 8 warps, one (segment, lane) tree each
#define FOLD_WARPS (FOLD_THREADS / 32)      // ops.FOLD_WARPS
#define FOLD_LANES_STAGED 4     // value lanes in shared memory at once
#define MAX_FOLD_ROWS 2048      // rows of one block (ops.MAX_FOLD_ROWS)
#define FOLD_ITEM_WORDS 8       // int32 words of one item descriptor

__device__ __forceinline__ float np_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float np_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float np_clip01(float x) {
  return np_min(np_max(x, 0.0f), 1.0f);
}

// The unit a fact row adds to, or -1: col 0 truncated toward zero
// (saturating, like numpy's astype), NaN and out-of-range units dropped.
__device__ __forceinline__ int rollup_unit(float unit, bool valid,
                                           int n_units) {
  const int u = __float2int_rz(unit);
  return (valid && !isnan(unit) && u >= 0 && u < n_units) ? u : -1;
}

// Deterministic per-block rollup: output (u, c) sums the block's rows of
// unit u in row order into part[u * KPI_LANES + c].
__device__ __forceinline__ void block_rollup(const int* s_unit,
                                             const float (*s_kpi)[KPI_LANES],
                                             int n_units, float* part) {
  const int n_out = n_units * KPI_LANES;
  for (int o = threadIdx.x; o < n_out; o += KPI_BLOCK) {
    const int u = o / KPI_LANES, c = o % KPI_LANES;
    float acc = 0.0f;
    for (int r = 0; r < KPI_BLOCK; ++r)
      if (s_unit[r] == u) acc = __fadd_rn(acc, s_kpi[r][c]);
    part[o] = acc;
  }
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

    unit = rollup_unit(p[1], valid, n_units);
    s_kpi[tid][0] = availability;
    s_kpi[tid][1] = performance;
    s_kpi[tid][2] = quality;
    s_kpi[tid][3] = oee;
    s_kpi[tid][4] = 1.0f;
  }
  s_unit[tid] = unit;
  __syncthreads();
  block_rollup(s_unit, s_kpi, n_units,
               partials + (int64_t)blockIdx.x * n_units * KPI_LANES);
}

#define SUM_UNROLL 32

// agg[o] = (((0 + partials[0][o]) + partials[1][o]) + ...) in block order.
// The adds form one dependent chain; the loads of SUM_UNROLL blocks are
// issued together ahead of their adds, so a long chain (a full rescan has
// thousands of blocks) waits on memory once per SUM_UNROLL blocks.
__global__ void kpi_block_sum_kernel(const float* __restrict__ partials,
                                     int n_blocks, int n_out,
                                     float* __restrict__ agg) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  float acc = 0.0f;
  int b = 0;
  for (; b + SUM_UNROLL <= n_blocks; b += SUM_UNROLL) {
    float v[SUM_UNROLL];
#pragma unroll
    for (int k = 0; k < SUM_UNROLL; ++k)
      v[k] = partials[(int64_t)(b + k) * n_out + o];
#pragma unroll
    for (int k = 0; k < SUM_UNROLL; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; b < n_blocks; ++b)
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

// --------------------------------------------------------------- rollup
__global__ void rollup_rows_kernel(const float* __restrict__ facts,
                                   int64_t n, int n_units,
                                   float* __restrict__ partials) {
  __shared__ int s_unit[KPI_BLOCK];
  __shared__ float s_kpi[KPI_BLOCK][KPI_LANES];
  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * KPI_BLOCK + tid;
  int unit = -1;
  if (i < n) {
    const float* f = facts + i * N_FACT;
    unit = rollup_unit(f[0], f[9] > 0.5f, n_units);
    s_kpi[tid][0] = f[3];
    s_kpi[tid][1] = f[4];
    s_kpi[tid][2] = f[5];
    s_kpi[tid][3] = f[6];
    s_kpi[tid][4] = 1.0f;
  }
  s_unit[tid] = unit;
  __syncthreads();
  block_rollup(s_unit, s_kpi, n_units,
               partials + (int64_t)blockIdx.x * n_units * KPI_LANES);
}

// facts [n, 10] f32 -> agg [n_units, 5] f32 (sums of cols 3-6 and a count
// over valid rows of each unit); partials is caller-allocated scratch of
// ceil(n / 256) * n_units * 5 floats.
extern "C" int segment_rollup_launch(const void* facts, int64_t n,
                                     int n_units, void* partials, void* agg,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_out = n_units * KPI_LANES;
  const int64_t n_blocks = (n + KPI_BLOCK - 1) / KPI_BLOCK;
  if (n_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (n_blocks > 0) {
    rollup_rows_kernel<<<(unsigned)n_blocks, KPI_BLOCK, 0, s>>>(
        (const float*)facts, n, n_units, (float*)partials);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  kpi_block_sum_kernel<<<(n_out + 127) / 128, 128, 0, s>>>(
      (const float*)partials, (int)n_blocks, n_out, (float*)agg);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- fold
#define FULL_MASK 0xffffffffu
#define POS_INF __int_as_float(0x7f800000)
#define NEG_INF __int_as_float(0xff800000)

// One segment's four statistics over a run of rows: count, sum, min, max.
struct Fold4 {
  float c, s, mn, mx;
};

// One row's contribution to segment s: ids outside the item's segments,
// and the -1 pad rows, give 0, 0 * v, +inf and -inf.
__device__ __forceinline__ Fold4 fold_leaf(int seg, float v, int s) {
  const bool hit = seg == s;
  const float oh = hit ? 1.0f : 0.0f;
  return {oh, __fmul_rn(oh, v), hit ? v : POS_INF, hit ? v : NEG_INF};
}

// a (+) b, a the first operand of every op (numpy's min/max return the
// second operand on ties, so the order fixes the bits of +-0).
__device__ __forceinline__ Fold4 fold_op(Fold4 a, Fold4 b) {
  return {__fadd_rn(a.c, b.c), __fadd_rn(a.s, b.s), np_min(a.mn, b.mn),
          np_max(a.mx, b.mx)};
}

__device__ __forceinline__ Fold4 shfl_down(Fold4 a, int h) {
  return {__shfl_down_sync(FULL_MASK, a.c, h),
          __shfl_down_sync(FULL_MASK, a.s, h),
          __shfl_down_sync(FULL_MASK, a.mn, h),
          __shfl_down_sync(FULL_MASK, a.mx, h)};
}

// The register levels of warp_tree: r[k] = r[k] (+) r[k + H] for k < H,
// then H/2 ... 1, unrolled at compile time so r stays in registers.
template <int H>
__device__ __forceinline__ void register_levels(Fold4* r) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int k = 0; k < H; ++k) r[k] = fold_op(r[k], r[k + H]);
    register_levels<H / 2>(r);
  }
}

// The halving tree s[i] = s[i] (+) s[i + h], h = B/2 ... 1, of one
// segment over one block of B = 32K rows (K >= 2), or B in {8, 16, 32}
// (K == 1), reduced by one warp, all four statistics at once; the result
// lands in lane 0. Lane t holds rows t + 32k: the first level (h = 16K)
// is fused into the loads, the levels down to h = 32 pair registers k and
// k + h/32, the last five pair lanes t and t + h.
template <int K>
__device__ __forceinline__ Fold4 warp_tree(const int* s_seg,
                                           const float* s_val, int s, int B,
                                           int t) {
  Fold4 v;
  int h;
  if constexpr (K == 1) {
    v = fold_leaf(t < B ? s_seg[t] : -1, t < B ? s_val[t] : 0.0f, s);
    h = B >> 1;
  } else {
    Fold4 r[K / 2];
#pragma unroll
    for (int k = 0; k < K / 2; ++k) {
      const int i = t + 32 * k, j = i + 16 * K;
      r[k] = fold_op(fold_leaf(s_seg[i], s_val[i], s),
                     fold_leaf(s_seg[j], s_val[j], s));
    }
    register_levels<K / 4>(r);
    v = r[0];
    h = 16;
  }
  for (; h >= 1; h >>= 1) v = fold_op(v, shfl_down(v, h));
  return v;
}

__device__ Fold4 block_tree(const int* s_seg, const float* s_val, int s,
                            int B, int t) {
  switch (B) {
    case 64: return warp_tree<2>(s_seg, s_val, s, B, t);
    case 128: return warp_tree<4>(s_seg, s_val, s, B, t);
    case 256: return warp_tree<8>(s_seg, s_val, s, B, t);
    case 512: return warp_tree<16>(s_seg, s_val, s, B, t);
    case 1024: return warp_tree<32>(s_seg, s_val, s, B, t);
    case 2048: return warp_tree<64>(s_seg, s_val, s, B, t);
    default: return warp_tree<1>(s_seg, s_val, s, B, t);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// buf: the staged int32 words (ops.stage_fold): from word 0, per CTA
// (item, first segment); at item_off, per item [seg_off, val_off, lane_stride, n_rows, n_lanes,
// n_fold, out_off, seg_chunk]; per item its padded blocks' compacted
// segment ids (-1 = identity) and its values lane-major, each lane
// lane_stride words. Block b of an item starts at row b * block and holds
// B = max(8, pow2(rows)) rows. A CTA folds seg_chunk segments (chosen so
// that its (segment, lane) tasks fill its warps once) into out: every
// item's packed [n_fold, 1 + 3L] table at out_off. The lane-0 task of a
// segment writes its count too.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_many_kernel(const int32_t* __restrict__ buf, int item_off, int block,
                 float* __restrict__ out) {
  __shared__ __align__(16) int s_seg[MAX_FOLD_ROWS];
  __shared__ __align__(16) float s_val[FOLD_LANES_STAGED][MAX_FOLD_ROWS];
  const int item = buf[2 * blockIdx.x];
  const int seg_lo = buf[2 * blockIdx.x + 1];
  const int32_t* d = buf + item_off + FOLD_ITEM_WORDS * item;
  const int seg_off = d[0], val_off = d[1], lane_stride = d[2];
  const int n_rows = d[3], L = d[4], n_fold = d[5], out_off = d[6];
  const int W = 1 + 3 * L;
  const int n_seg = min(d[7], n_fold - seg_lo);
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const float* vals = reinterpret_cast<const float*>(buf) + val_off;
  for (int lo = 0; lo < n_rows; lo += block) {
    const bool first = lo == 0;
    const int m = min(block, n_rows - lo);
    int B = 8;
    while (B < m) B <<= 1;
    for (int j0 = 0; j0 < L; j0 += FOLD_LANES_STAGED) {
      const int nl = min(FOLD_LANES_STAGED, L - j0);
      __syncthreads();                 // the last pass is done with smem
      if (j0 == 0)
        for (int c = threadIdx.x; c < B / 4; c += FOLD_THREADS)
          cp_async16(&s_seg[4 * c], buf + seg_off + lo + 4 * c);
      for (int c = threadIdx.x; c < nl * (B / 4); c += FOLD_THREADS) {
        const int jj = c / (B / 4), r = 4 * (c % (B / 4));
        cp_async16(&s_val[jj][r],
                   vals + (int64_t)(j0 + jj) * lane_stride + lo + r);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int task = warp; task < n_seg * nl; task += FOLD_WARPS) {
        const int s = seg_lo + task / nl, jj = task % nl, j = j0 + jj;
        const Fold4 f = block_tree(s_seg, s_val[jj], s, B, t);
        if (t == 0) {
          // out = first ? identity (+) f : out (+) f, the identity first
          // as in combine_fold(empty_fold_state, ...): 0 + -0 is +0
          float* row = out + out_off + s * W;
          if (j == 0) row[0] = __fadd_rn(first ? 0.0f : row[0], f.c);
          row[1 + j] = __fadd_rn(first ? 0.0f : row[1 + j], f.s);
          row[1 + L + j] = np_min(first ? POS_INF : row[1 + L + j], f.mn);
          row[1 + 2 * L + j] =
              np_max(first ? NEG_INF : row[1 + 2 * L + j], f.mx);
        }
      }
    }
  }
}

// buf [n_words] i32 staged on the device (see fold_many_kernel): n_ctas
// CTA descriptors from word 0, item descriptors at item_off; block a power
// of two in [8, 2048] -> out [n_out] f32, every item's packed table.
extern "C" int fold_segments_many_launch(const void* buf, int n_ctas,
                                         int item_off, int block, void* out,
                                         void* stream) {
  if (n_ctas == 0) return 0;
  if (block < 8 || block > MAX_FOLD_ROWS || (block & (block - 1)))
    return (int)cudaErrorInvalidValue;
  fold_many_kernel<<<n_ctas, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)buf, item_off, block, (float*)out);
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
