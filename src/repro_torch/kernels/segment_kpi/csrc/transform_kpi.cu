// The Data Transformer's whole transform in one launch, written by hand
// for Hopper (sm_90a): both master-cache probes, the fact-grain split
// with the OEE KPIs, and the per-unit KPI rollup (transform_kpi_launch);
// and the same kernel without the probes, fed joined rows
// (segment_kpi_launch).
//
// Replaces: src/repro/kernels/segment_kpi/segment_kpi.py,
// segment_kpi_kernel (body _kpi_kernel), and, fused in front of it,
// src/repro/kernels/hash_join/hash_join.py, hash_join_kernel (one call per
// cache). The TPU runs the two probes and the KPI kernel as three calls
// and rolls up with a one-hot MXU product.
//
// What bounds it on an H100: launch latency and the host's issue time.
// At the main path's 1024-row blocks the function moves ~90 KB (prod rows
// in, facts and found out, the key slots and hit rows the probes touch),
// ~30 ns of HBM time. So the design is one launch per transform, where
// the port made two calls and three kernels (pair probe, facts, block
// sum): a CTA per 256-row block (KPI_BLOCK), a thread per row.
//
// The probe keeps the contract of every reference probe: lowbias32 hash
// of the int32 key as uint32, up to 16 linear probes from hash % n_slots,
// a hit tested before the empty test (a pad row's key -1 hits an empty
// slot), a slot holding -1 ends the chain as a miss. A missed row reads
// as zeros with col 1 = -1.0, the KPI's miss mark. Keys are the prod
// row's col 1 (equipment) and col 0 (quality) cast by __float2int_rz,
// which is PTX cvt.rzi.s32.f32: NaN gives 0, values outside int32
// saturate, the rest truncate toward zero — the cast of the JAX
// reference's device backends (astype(jnp.int32)) and of the plain
// version (hash_join.ref.key_to_int32). A thread walks its row's two
// chains: at the caches' load a hit takes 1-2 dependent key loads. (A
// warp per row, hash_join_pair's design, measured 4.5x slower on an H100:
// a 256-row CTA of 8 warps takes 32 dependent probe rounds per warp.)
//
// Facts: kpi_fact_row, bitwise the numpy oracle. Rollup: bitwise the
// plain version (ref.unit_rollup_ref): within a block, rows in row order
// (block_rollup: the rows sorted by unit in shared memory, then a thread
// per (unit, lane) adds its unit's rows, their loads issued ahead of the
// adds); the block
// partials in block order, added by the CTA that finishes last (last_cta:
// a ticket taken after a fence, the counter reset by that CTA, so the
// launch is safe in a CUDA graph; combine_short: a thread per output, its
// chain's loads issued together). No float atomics: two runs give the
// same bits.
#include "kpi.cuh"

#define MAX_PROBES 16

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

struct Table {
  const int32_t* keys;
  const float4* vals;     // [n_slots, w4] float4
  uint32_t n_slots;
  int w4;
};

struct KpiArgs {
  const float4* prod;     // [n, 2] float4: the production rows
  const float4* eq;       // !PROBE: the joined rows, [n, 2] float4
  const float4* qr;
  Table eq_t, q_t;        // PROBE: the two caches
  int n, n_units;
  int64_t n_blocks;
  float* facts;           // [n, 10]
  uint8_t* found;         // [n] (PROBE)
  float* partT;           // [n_units * 5, n_blocks] scratch
  unsigned* counter;      // the stream's ticket counter, 0 between launches
  float* agg;             // [n_units, 5]
};

// A thread's probe of one cache: the hit slot, or -1.
__device__ __forceinline__ int64_t probe_thread(int32_t key, Table t) {
  const uint32_t h = lowbias32((uint32_t)key) % t.n_slots;
  for (uint32_t p = 0; p < MAX_PROBES; ++p) {
    const uint32_t cand = (h + p) % t.n_slots;
    const int32_t k = t.keys[cand];
    if (k == key) return cand;
    if (k == -1) break;
  }
  return -1;
}

// The joined row (first 8 lanes) of a probe's slot, or the miss row.
__device__ __forceinline__ void joined_row(Table t, int64_t slot,
                                           float4* r) {
  if (slot >= 0) {
    r[0] = t.vals[slot * t.w4];
    r[1] = t.vals[slot * t.w4 + 1];
  } else {
    r[0] = make_float4(0.f, -1.0f, 0.f, 0.f);
    r[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// PROBE: probe both caches with the prod row's keys; else read the
// joined rows eq, qr.
template <bool PROBE>
__global__ void __launch_bounds__(KPI_BLOCK) kpi_kernel(KpiArgs a) {
  __shared__ float s_kpi[KPI_BLOCK][KPI_LANES];
  __shared__ unsigned s_mask[UNIT_CHUNK * KPI_WARPS];
  __shared__ int s_off[UNIT_CHUNK + 1];
  __shared__ unsigned char s_list[KPI_BLOCK + ROLLUP_UNROLL];
  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * KPI_BLOCK + tid;
  for (int w = tid; w < min(a.n_units, UNIT_CHUNK) * KPI_WARPS;
       w += KPI_BLOCK)
    s_mask[w] = 0;

  int unit = -1;
  if (i < a.n) {
    __align__(16) float p[PAYLOAD];
    __align__(16) float e[PAYLOAD];
    __align__(16) float q[PAYLOAD];
    reinterpret_cast<float4*>(p)[0] = a.prod[2 * i];
    reinterpret_cast<float4*>(p)[1] = a.prod[2 * i + 1];
    bool found = false;
    if constexpr (PROBE) {
      const int64_t es = probe_thread(__float2int_rz(p[1]), a.eq_t);
      const int64_t qs = probe_thread(__float2int_rz(p[0]), a.q_t);
      joined_row(a.eq_t, es, reinterpret_cast<float4*>(e));
      joined_row(a.q_t, qs, reinterpret_cast<float4*>(q));
      found = es >= 0 && qs >= 0;
    } else {
      reinterpret_cast<float4*>(e)[0] = a.eq[2 * i];
      reinterpret_cast<float4*>(e)[1] = a.eq[2 * i + 1];
      reinterpret_cast<float4*>(q)[0] = a.qr[2 * i];
      reinterpret_cast<float4*>(q)[1] = a.qr[2 * i + 1];
    }
    float f[N_FACT];
    const bool valid = kpi_fact_row(p, e, q, f);
    float* out = a.facts + i * N_FACT;
#pragma unroll
    for (int c = 0; c < N_FACT; ++c) out[c] = f[c];
    if constexpr (PROBE) a.found[i] = found;
    unit = rollup_unit(p[1], valid, a.n_units);
    s_kpi[tid][0] = f[3];
    s_kpi[tid][1] = f[4];
    s_kpi[tid][2] = f[5];
    s_kpi[tid][3] = f[6];
    s_kpi[tid][4] = 1.0f;
  }
  __syncthreads();                            // masks zeroed
  const bool wrote = block_rollup(
      unit, a.n_units, s_mask, s_off, s_list,
      [&](int r, int c) { return s_kpi[r][c]; }, a.partT, a.n_blocks,
      blockIdx.x);
  if (last_cta(a.counter, wrote))
    combine_short(a.partT, a.n_blocks, a.n_blocks, a.n_units * KPI_LANES,
                  a.agg);
}

template <bool PROBE>
static int launch(const KpiArgs& a, cudaStream_t s) {
  kpi_kernel<PROBE><<<(unsigned)a.n_blocks, KPI_BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// prod [n, 8] f32 (16-byte aligned; keys in cols 1 and 0), the equipment
// and quality caches' keys [S] i32 and vals [S, W] f32 (W % 4 == 0,
// W >= 8, 16-byte aligned; the first 8 lanes are read), n_units >= 1 ->
// facts [n, 10] f32, found [n] u8 (torch.bool), agg [n_units, 5] f32.
// partT: scratch of n_units * 5 * ceil(n / 256) floats; counter: a u32 that is 0 and that no launch
// on another stream uses. Returns the launch's cudaError_t.
extern "C" int transform_kpi_launch(
    const void* prod, int n, const void* eq_keys, const void* eq_vals,
    int eq_slots, int eq_width, const void* q_keys, const void* q_vals,
    int q_slots, int q_width, int n_units, void* facts,
    void* found, void* partT, void* counter, void* agg, void* stream) {
  if (n <= 0 || n_units < 1) return (int)cudaErrorInvalidValue;
  KpiArgs a{};
  a.prod = (const float4*)prod;
  a.eq_t = {(const int32_t*)eq_keys, (const float4*)eq_vals,
            (uint32_t)eq_slots, eq_width / 4};
  a.q_t = {(const int32_t*)q_keys, (const float4*)q_vals, (uint32_t)q_slots,
           q_width / 4};
  a.n = n;
  a.n_units = n_units;
  a.n_blocks = (n + KPI_BLOCK - 1) / KPI_BLOCK;
  a.facts = (float*)facts;
  a.found = (uint8_t*)found;
  a.partT = (float*)partT;
  a.counter = (unsigned*)counter;
  a.agg = (float*)agg;
  return launch<true>(a, (cudaStream_t)stream);
}

// prod/eq/qr [n, 8] f32 (16-byte aligned; a joined row with col 1 < 0
// marks a join miss) -> facts [n, 10] f32, agg [n_units, 5] f32; partT
// and counter as transform_kpi_launch's.
extern "C" int segment_kpi_launch(const void* prod, const void* eq,
                                  const void* qr, int n, int n_units,
                                  void* facts, void* partT, void* counter,
                                  void* agg, void* stream) {
  if (n <= 0 || n_units < 1) return (int)cudaErrorInvalidValue;
  KpiArgs a{};
  a.prod = (const float4*)prod;
  a.eq = (const float4*)eq;
  a.qr = (const float4*)qr;
  a.n = n;
  a.n_units = n_units;
  a.n_blocks = (n + KPI_BLOCK - 1) / KPI_BLOCK;
  a.facts = (float*)facts;
  a.partT = (float*)partT;
  a.counter = (unsigned*)counter;
  a.agg = (float*)agg;
  return launch<false>(a, (cudaStream_t)stream);
}
