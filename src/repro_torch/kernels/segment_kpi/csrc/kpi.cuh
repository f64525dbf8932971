// Device functions shared by the KPI kernels of this package: numpy's
// min/max, the OEE fact row, the per-unit rollup of one 256-row block
// (its rows sorted by unit in shared memory), the last-CTA ticket, the
// two combines of the block partials in block order, and cp.async.
// Included by segment_kpi.cu (rollup, fold) and transform_kpi.cu (the
// fused transform and the KPI kernel).
//
// Min/max follow numpy exactly: np.minimum(a, b) is (a < b || isnan(a)) ?
// a : b — it returns the SECOND operand on ties (so +-0 order matters) and
// propagates NaN. fminf/fmaxf do neither, so they are not used.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define KPI_LANES 5
#define N_FACT 10
#define PAYLOAD 8
#define KPI_BLOCK 256                       // ref.KPI_BLOCK
#define KPI_WARPS (KPI_BLOCK / 32)
#define UNIT_CHUNK 256                      // units of one rollup pass
#define FULL_MASK 0xffffffffu

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
// (saturating, like numpy's astype), NaN and out-of-range units dropped
// (the conversion alone would make a NaN unit 0).
__device__ __forceinline__ int rollup_unit(float unit, bool valid,
                                           int n_units) {
  const int u = __float2int_rz(unit);
  return (valid && !isnan(unit) && u >= 0 && u < n_units) ? u : -1;
}

// One fact row from a production row p and its joined equipment and
// quality rows e, q (8 floats each; a joined row with col 1 < 0 is a join
// miss), in _kpi_facts_np's op order: IEEE division, every multiply and
// add rounded on its own (the build passes -fmad=false), numpy's min/max.
// Writes the ten fact lanes to f; returns the valid flag (f[9]).
__device__ __forceinline__ bool kpi_fact_row(const float* p, const float* e,
                                             const float* q, float* f) {
  const float EPS = 1e-6f;
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
  const float good = np_max(__fsub_rn(__fsub_rn(qty, defects), scrap), 0.0f);
  const float quality = np_clip01(__fdiv_rn(good, np_max(qty, EPS)));
  const float oee = __fmul_rn(__fmul_rn(availability, performance), quality);
  const bool valid = (e[1] >= 0.0f) && (q[1] >= 0.0f);
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
  return valid;
}

// The per-unit partials of one 256-row block, bitwise the plain
// version's order: output (u, c) adds lane c of unit u's rows, in row
// order, from 0.0f — the same float adds as a scan of all 256 rows that
// skips the other units' rows. Every thread of the CTA calls this with its
// row's unit (-1: none); s_list holds KPI_BLOCK + ROLLUP_UNROLL bytes.
// The units are taken UNIT_CHUNK at a time (any n_units: s_mask holds
// UNIT_CHUNK * KPI_WARPS words, s_off UNIT_CHUNK + 1), and in each chunk
// the block's rows of the chunk's units are sorted by unit first (a
// counting sort in shared memory):
// 1. one __match_any_sync per warp groups its lanes by unit; the lowest
//    lane of each group writes the group's row mask, s_mask[u * KPI_WARPS
//    + w] (u relative to the chunk; bit j: row 32w + j);
// 2. warp 0 counts each unit's rows (popc of its masks) and scans the
//    counts into s_off[u] (s_off[units in the chunk]: the total);
// 3. each row writes its index at s_off[u] + (its unit's rows in earlier
//    warps) + (in its warp, lower lanes) into s_list: unit-major, row
//    order within a unit.
// Then a thread per output walks its unit's slice of s_list, loading
// ROLLUP_UNROLL rows' values ahead of the adds (unconditionally: s_list
// has ROLLUP_UNROLL bytes of slack, and every index in it names a row of
// the block), so the adds — one per row of the unit, the chain the order
// demands — wait on nothing else,
// whether the units are spread over the block or fill it (the
// warehouse's facts come clustered by unit). val(r, c) is lane c of row
// r. s_mask must be zero on entry; it is zero again on return. Writes
// partT[o * stride + b], o = u * 5 + c (the partials transposed: each
// output's chain lies contiguous for the combine). Returns whether this
// thread wrote a partial. Contains __syncthreads: every thread calls it.
#define ROLLUP_UNROLL 8
template <class Val>
__device__ __forceinline__ bool block_rollup(int unit, int n_units,
                                             unsigned* s_mask, int* s_off,
                                             unsigned char* s_list, Val val,
                                             float* partT, int64_t stride,
                                             int64_t b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool wrote = false;
  for (int u0 = 0; u0 < n_units; u0 += UNIT_CHUNK) {
    const int nu = min(UNIT_CHUNK, n_units - u0);
    const int cu = unit >= u0 && unit < u0 + nu ? unit - u0 : -1;
    if (u0 > 0) __syncthreads();      // the last chunk's offsets, list read
    const unsigned same = __match_any_sync(FULL_MASK, cu);
    if (cu >= 0 && __ffs(same) - 1 == lane)
      s_mask[cu * KPI_WARPS + warp] = same;
    __syncthreads();
    if (warp == 0) {
      int carry = 0;
      for (int v0 = 0; v0 < nu; v0 += 32) {
        const int u = v0 + lane;
        int cnt = 0;
        if (u < nu)
#pragma unroll
          for (int w = 0; w < KPI_WARPS; ++w)
            cnt += __popc(s_mask[u * KPI_WARPS + w]);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int x = __shfl_up_sync(FULL_MASK, incl, d);
          if (lane >= d) incl += x;
        }
        if (u < nu) s_off[u] = carry + incl - cnt;
        carry += __shfl_sync(FULL_MASK, incl, 31);
      }
      if (lane == 0) s_off[nu] = carry;
    }
    __syncthreads();
    if (cu >= 0) {
      int pos = s_off[cu] + __popc(same & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w)
        pos += __popc(s_mask[cu * KPI_WARPS + w]);
      s_list[pos] = (unsigned char)tid;
    }
    __syncthreads();
    for (int w = tid; w < nu * KPI_WARPS; w += blockDim.x) s_mask[w] = 0;
    const int n_out = nu * KPI_LANES;
    for (int o = tid; o < n_out; o += blockDim.x) {
      const int u = o / KPI_LANES, c = o % KPI_LANES;
      const int hi = s_off[u + 1];
      float acc = 0.0f;
      for (int k = s_off[u]; k < hi; k += ROLLUP_UNROLL) {
        float x[ROLLUP_UNROLL];
#pragma unroll
        for (int t = 0; t < ROLLUP_UNROLL; ++t) x[t] = val(s_list[k + t], c);
#pragma unroll
        for (int t = 0; t < ROLLUP_UNROLL; ++t)
          if (k + t < hi) acc = __fadd_rn(acc, x[t]);
      }
      partT[(int64_t)(u0 * KPI_LANES + o) * stride + b] = acc;
    }
    wrote |= tid < n_out;
  }
  return wrote;
}

// True in every thread of the CTA that finishes last among the grid's
// CTAs. A thread that wrote partials (``wrote``) fences them before the
// CTA takes its ticket, so the last CTA sees every CTA's partials (it
// reads them with ld.global.cg, past its own L1). The last CTA sets the
// counter back to 0, so the next launch on the same stream (or the next
// replay of a captured graph) starts from 0 without a memset.
__device__ __forceinline__ bool last_cta(unsigned* counter, bool wrote) {
  __shared__ bool is_last;
  if (wrote) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
    if (is_last) atomicExch(counter, 0u);
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// agg[o] = ((0 + partT[o][0]) + partT[o][1]) + ... in block order, a
// thread per output (o = threadIdx.x, + blockDim.x, ...): the loads of
// COMBINE_SHORT blocks are issued together, then added in order — one
// L2 round trip per COMBINE_SHORT blocks. For the short chains of a
// transform (a few blocks) in the CTA that finishes last.
#define COMBINE_SHORT 16
__device__ __forceinline__ void combine_short(const float* partT,
                                              int64_t stride,
                                              int64_t n_blocks, int n_out,
                                              float* agg) {
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    const float* row = partT + (int64_t)o * stride;
    float acc = 0.0f;
    for (int64_t k = 0; k < n_blocks; k += COMBINE_SHORT) {
      float v[COMBINE_SHORT];
#pragma unroll
      for (int t = 0; t < COMBINE_SHORT; ++t)   // in bounds, unconditional
        v[t] = __ldcg(row + (k + t < n_blocks ? k + t : n_blocks - 1));
#pragma unroll
      for (int t = 0; t < COMBINE_SHORT; ++t)
        if (k + t < n_blocks) acc = __fadd_rn(acc, v[t]);
    }
    agg[o] = acc;
  }
}

// The same sums for long chains (a full rescan's thousands of blocks), a
// warp per output (o = warp, + n_warps, ...): lane j loads blocks k + 4j
// .. k + 4j + 3 as one float4 (rows are 16-byte aligned: stride % 4 ==
// 0), 128 blocks per warp load, into the warp's 512-byte buffer s_buf
// (the next 128 are loaded before these are added); lane 0 adds them in
// block order from the buffer, its 16-byte shared loads issued ahead of
// the adds, so its chain — one add per block, the floor of an ordered
// sum — waits neither on memory nor on the other lanes.
__device__ __forceinline__ void combine_long(const float* partT,
                                             int64_t stride,
                                             int64_t n_blocks, int n_out,
                                             float* agg, int warp,
                                             int n_warps, float4* s_buf) {
  const int lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int o = warp; o < n_out; o += n_warps) {
    const float4* row = reinterpret_cast<const float4*>(
        partT + (int64_t)o * stride);
    const int64_t n4 = (n_blocks + 3) / 4;     // float4s of the chain
    float acc = 0.0f;
    float4 v = lane < n4 ? __ldcg(row + lane) : zero;
    for (int64_t k = 0; k < n_blocks; k += 128) {
      const int64_t nk = k / 4 + 32 + lane;
      const float4 next = nk < n4 ? __ldcg(row + nk) : zero;
      s_buf[lane] = v;
      __syncwarp();
      if (lane == 0) {
        if (n_blocks - k >= 128) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float4 x = s_buf[j];
            acc = __fadd_rn(acc, x.x);
            acc = __fadd_rn(acc, x.y);
            acc = __fadd_rn(acc, x.z);
            acc = __fadd_rn(acc, x.w);
          }
        } else {
          const float* f = reinterpret_cast<const float*>(s_buf);
          for (int j = 0; j < n_blocks - k; ++j) acc = __fadd_rn(acc, f[j]);
        }
      }
      __syncwarp();                    // the buffer read before refilled
      v = next;
    }
    if (lane == 0) agg[o] = acc;
  }
}

// cp.async of 16 bytes, global to shared (bypassing L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
