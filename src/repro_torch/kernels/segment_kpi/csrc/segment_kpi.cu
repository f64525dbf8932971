// The warehouse's full-rescan rollup and the serving layer's two read /
// write ops, written by hand for Hopper (sm_90a). Three kernel families,
// one per TPU kernel they replace (all in
// src/repro/kernels/segment_kpi/segment_kpi.py); the fused transform and
// the KPI kernel (segment_kpi_kernel) live in transform_kpi.cu, and the
// device functions both files use in kpi.cuh.
//
// 1. fold_segments_many_launch <- fold_segments_kernel (body _fold_kernel).
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
// 2. segment_rollup_launch <- segment_rollup_kernel (body _rollup_kernel).
//    The per-unit KPI rollup of already-built fact rows: the warehouse's
//    full rescan (Warehouse.kpi_rollup), O(history) rows per call. Bound:
//    bytes — every 40 B fact row is read once (2^20 rows: 40 MiB, ~12.5 us
//    of HBM time). Design: a persistent grid (as many CTAs as fit on the
//    SMs) whose CTAs walk the 256-row blocks, each block's rows staged in
//    shared memory by cp.async ROLLUP_STAGES - 1 blocks ahead of the one
//    the CTA rolls up, so the stream stays in flight; the per-block
//    rollup of transform_kpi.cu (block_rollup: the rows sorted by unit,
//    then added in row order), partials written transposed, [n_out,
//    stride]; then the partials added in block order by a second launch
//    (combine_long: a warp per output reads its chain coalesced into
//    shared memory, one lane adds it), which measured faster than adding
//    them in the CTA that finishes last at every size from 8 blocks to
//    4096. Bitwise ref.segment_rollup_ref. Any N, 64-bit row offsets; a
//    NaN or out-of-range unit counts nowhere (rollup_unit).
//
// 3. gather_stats_many_launch <- gather_stats_kernel (body _gather_kernel).
//    Batched point read of a whole query batch in one launch: for every
//    (table, ids) item — one per (point-query view, owning shard), tables
//    of any S and L — rows ids of the packed [S, 1 + 3L] table plus
//    means = sums / count (NaN at count 0). Bound: launch latency and the
//    host round trip around it — a 4096-query batch moves ~280 KB, ~0.1
//    us of HBM time — so the design answers the batch's every item in ONE
//    launch fed by one staged buffer (CTA descriptors, each item's table
//    and ids), where slice 1 made one launch, two uploads and one
//    blocking copy per item. A CTA covers (item, GATHER_ROWS ids): it
//    stages the item's table in shared memory when it fits (a steelworks
//    table is <= 60 x 13 f32) and reads it through L1/L2 otherwise, stages
//    its ids, then its threads walk the CTA's output words in order, so
//    neighbouring threads store neighbouring words. count | sums | mins |
//    maxs are copies, means one IEEE divide (__fdiv_rn) or numpy's NaN bit
//    pattern — bitwise the numpy oracle (the TPU kernel's one-hot matmul
//    and 0 * inf workaround have no reason to exist here).
#include "kpi.cuh"

#define FOLD_THREADS 256       // 8 warps, one (segment, lane) tree each
#define FOLD_WARPS (FOLD_THREADS / 32)      // ops.FOLD_WARPS
#define FOLD_LANES_STAGED 4     // value lanes in shared memory at once
#define MAX_FOLD_ROWS 2048      // rows of one block (ops.MAX_FOLD_ROWS)
#define FOLD_ITEM_WORDS 8       // int32 words of one item descriptor

// ----------------------------------------------------------------- fold
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
      cp_async_commit();
      cp_async_wait<0>();
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

// --------------------------------------------------------------- rollup
#define ROLLUP_STAGES 3                     // blocks staged per CTA at once
#define ROLLUP_WORDS (KPI_BLOCK * N_FACT)   // floats of one staged block

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Issue the copies of block b's rows into dst (none when b is past the
// end) and commit them as one group: 16-byte pieces when the fact table
// is 16-byte aligned (a block starts at b * 10,240 bytes), else 4-byte
// ones.
__device__ __forceinline__ void stage_rows(const float* facts, int64_t n,
                                           int64_t b, int64_t n_blocks,
                                           float* dst, bool vec16) {
  if (b < n_blocks) {
    const int64_t r0 = b * KPI_BLOCK;
    const int words =
        (int)(n - r0 < KPI_BLOCK ? n - r0 : KPI_BLOCK) * N_FACT;
    const float* src = facts + r0 * N_FACT;
    int done = 0;
    if (vec16) {
      for (int c = threadIdx.x; c < words / 4; c += KPI_BLOCK)
        cp_async16(dst + 4 * c, src + 4 * c);
      done = words / 4 * 4;
    }
    for (int w = done + threadIdx.x; w < words; w += KPI_BLOCK)
      cp_async4(dst + w, src + w);
  }
  cp_async_commit();
}

// Dynamic shared memory: ROLLUP_STAGES staged blocks, the unit masks
// (chunk * KPI_WARPS words), the units' row offsets (chunk + 1 words;
// chunk = min(n_units, UNIT_CHUNK)) and the sorted row list (KPI_BLOCK + ROLLUP_UNROLL bytes). A
// CTA walks blocks blockIdx.x, + gridDim.x, ...; while it rolls up one,
// the next ROLLUP_STAGES - 1 are in flight.
__global__ void __launch_bounds__(KPI_BLOCK)
rollup_kernel(const float* __restrict__ facts, int64_t n, int n_units,
              int64_t n_blocks, int64_t stride, bool vec16,
              float* __restrict__ partT) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = min(n_units, UNIT_CHUNK);
  unsigned* s_mask = reinterpret_cast<unsigned*>(
      smem + ROLLUP_STAGES * ROLLUP_WORDS);
  int* s_off = reinterpret_cast<int*>(s_mask + chunk * KPI_WARPS);
  unsigned char* s_list = reinterpret_cast<unsigned char*>(s_off + chunk + 1);
  const int tid = threadIdx.x;
  const int64_t G = gridDim.x;
  for (int w = tid; w < chunk * KPI_WARPS; w += KPI_BLOCK) s_mask[w] = 0;
#pragma unroll
  for (int k = 0; k < ROLLUP_STAGES - 1; ++k)
    stage_rows(facts, n, blockIdx.x + k * G, n_blocks,
               smem + k * ROLLUP_WORDS, vec16);
  int stage = 0;
  for (int64_t b = blockIdx.x; b < n_blocks; b += G) {
    // the stage read in the last pass takes block b + (STAGES - 1) G
    const int ahead = (stage + ROLLUP_STAGES - 1) % ROLLUP_STAGES;
    stage_rows(facts, n, b + (ROLLUP_STAGES - 1) * G, n_blocks,
               smem + ahead * ROLLUP_WORDS, vec16);
    cp_async_wait<ROLLUP_STAGES - 1>();
    __syncthreads();                  // block b landed
    const float* rows = smem + stage * ROLLUP_WORDS;
    const int unit =
        b * KPI_BLOCK + tid < n
            ? rollup_unit(rows[tid * N_FACT], rows[tid * N_FACT + 9] > 0.5f,
                          n_units)
            : -1;
    block_rollup(unit, n_units, s_mask, s_off, s_list,
                 [&](int r, int c) {
                   return c < 4 ? rows[r * N_FACT + 3 + c] : 1.0f;
                 },
                 partT, stride, b);
    __syncthreads();                  // rows, offsets and list read
    stage = (stage + 1) % ROLLUP_STAGES;
  }
  cp_async_wait<0>();                 // no copy outlives the CTA
}

#define COMBINE_WARPS 2                     // warps of a combine CTA

__global__ void __launch_bounds__(32 * COMBINE_WARPS)
combine_kernel(const float* __restrict__ partT, int64_t stride,
               int64_t n_blocks, int n_out, float* __restrict__ agg) {
  __shared__ float4 s_buf[COMBINE_WARPS][32];
  combine_long(partT, stride, n_blocks, n_out, agg,
               blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5),
               gridDim.x * COMBINE_WARPS, s_buf[threadIdx.x >> 5]);
}

// facts [n, 10] f32 (n >= 1) -> agg [n_units, 5] f32 (sums of cols 3-6
// and a count over valid rows of each unit), n_units >= 1.
// partT: scratch of n_units * 5 rows of ``stride`` floats, stride >=
// ceil(n / 256) and a multiple of 4. Two launches: the per-block rollup,
// then the combine.
extern "C" int segment_rollup_launch(const void* facts, int64_t n,
                                     int n_units, void* partT,
                                     int64_t stride, void* agg,
                                     void* stream) {
  const int64_t n_blocks = (n + KPI_BLOCK - 1) / KPI_BLOCK;
  if (n <= 0 || n_units < 1 || stride < n_blocks || stride % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_out = n_units * KPI_LANES;
  const int chunk = n_units < UNIT_CHUNK ? n_units : UNIT_CHUNK;
  const size_t smem = (size_t)ROLLUP_STAGES * ROLLUP_WORDS * sizeof(float) +
                      (size_t)chunk * KPI_WARPS * sizeof(unsigned) +
                      (size_t)(chunk + 1) * sizeof(int) + KPI_BLOCK +
                      ROLLUP_UNROLL;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rollup_kernel, KPI_BLOCK, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t cap = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = n_blocks < cap ? n_blocks : cap;
  rollup_kernel<<<(unsigned)grid, KPI_BLOCK, smem, s>>>(
      (const float*)facts, n, n_units, n_blocks, stride,
      ((uintptr_t)facts % 16) == 0, (float*)partT);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(n_out + COMBINE_WARPS - 1) / COMBINE_WARPS,
                   32 * COMBINE_WARPS, 0, s>>>((const float*)partT, stride,
                                               n_blocks, n_out, (float*)agg);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- gather
#define GATHER_THREADS 256
// 32 ids a CTA: about two output words a thread. 128 ids a CTA (eight
// words a thread, one CTA per 128 ids) measured 0.0046 ms a launch at 400
// and at 4096 ids, 32 ids 0.0031-0.0032 ms (H100 80GB HBM3, 700 W).
#define GATHER_ROWS 32                // ids of one CTA (ops.GATHER_ROWS)
#define GATHER_SMEM_FLOATS 8192       // 32 KB: tables up to this are staged

// buf: the staged int32 words (ops.stage_gather): from word 0, one
// 8-word descriptor per CTA, [table_off, S, L, ids_off, rows, out_off, 0,
// 0] (read as two int4, so a CTA's first load is its last dependent one
// before the table and ids); then each item's packed [S, 1 + 3L] table
// (f32 bits) and its ids in [0, S). A CTA answers its rows ids into out +
// out_off: [rows, 1 + 4L] = count | sums | mins | maxs | means.
__global__ void __launch_bounds__(GATHER_THREADS)
gather_many_kernel(const int32_t* __restrict__ buf, float* __restrict__ out) {
  __shared__ __align__(16) float s_table[GATHER_SMEM_FLOATS];
  __shared__ int s_ids[GATHER_ROWS];
  const int4* desc = reinterpret_cast<const int4*>(buf) + 2 * blockIdx.x;
  const int4 d0 = desc[0], d1 = desc[1];
  const int table_off = d0.x, S = d0.y, L = d0.z, ids_off = d0.w;
  const int rows = d1.x, out_off = d1.y;
  const int W = 1 + 3 * L, WO = 1 + 4 * L;
  const float* table = reinterpret_cast<const float*>(buf) + table_off;
  const bool staged = (int64_t)S * W <= GATHER_SMEM_FLOATS;
  if (staged)
    for (int w = threadIdx.x; w < S * W; w += GATHER_THREADS)
      s_table[w] = table[w];
  for (int r = threadIdx.x; r < rows; r += GATHER_THREADS)
    s_ids[r] = buf[ids_off + r];
  __syncthreads();
  const float* t = staged ? s_table : table;
  float* o = out + out_off;
  for (int e = threadIdx.x; e < rows * WO; e += GATHER_THREADS) {
    const int r = e / WO, c = e - r * WO;
    const float* row = t + (int64_t)s_ids[r] * W;
    float v;
    if (c < W) {
      v = row[c];
    } else {
      const float cnt = row[0];
      // numpy's np.nan bit pattern, so empty segments match byte for byte
      v = cnt > 0.0f ? __fdiv_rn(row[1 + (c - W)], cnt)
                     : __int_as_float(0x7fc00000);
    }
    o[e] = v;
  }
}

// buf [n_words] i32 staged on the device, 16-byte aligned (see
// gather_many_kernel): n_ctas CTA descriptors from word 0 -> out [n_out]
// f32, every item's answers.
extern "C" int gather_stats_many_launch(const void* buf, int n_ctas,
                                        void* out, void* stream) {
  if (n_ctas == 0) return 0;
  gather_many_kernel<<<n_ctas, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)buf, (float*)out);
  return (int)cudaGetLastError();
}
