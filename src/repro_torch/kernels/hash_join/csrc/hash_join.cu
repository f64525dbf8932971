// Open-addressing probes of a worker's master caches (the streaming join
// of DOD-ETL's Data Transformer), written by hand for Hopper (sm_90a): the
// single-table probe (hash_join_launch: the cache lookup and the
// flattened hop probe of join_depth > 1) and the transform's probe of
// both caches at once (hash_join_pair_launch, at the end).
//
// Replaces: src/repro/kernels/hash_join/hash_join.py, hash_join_kernel
// (body _hash_join_kernel), which turns each of the 16 linear-probe steps
// into a one-hot matrix product against the whole table held in VMEM.
//
// What bounds it on an H100: memory latency, not bandwidth or arithmetic.
// A query reads its key (4 B), then up to 16 dependent 4 B key loads at
// scattered slots, then one 32 B row and its txn on a hit; the function as
// a whole moves (4 + 32 + 1 + 4) B per query for the query and its outputs,
// plus 4 B per distinct key slot its chains visit and 36 B per distinct
// hit row: under 100 KB at the main path's sizes, not the whole table.
// The design is one thread per query with direct gathers: the key lane of
// a 4096-slot table is 16 KB and stays in L1/L2, the probe chain is short
// (the cache grows before a chain passes 16), and the hit row moves as
// float4 copies. At ~1k queries per
// launch the kernel is launch-bound; the transform's probes now run fused
// with the KPI kernel (segment_kpi/csrc/transform_kpi.cu), so no path
// launches hash_join_pair_launch.
//
// Contract (identical to the reference's numpy, jnp and Pallas probes):
// lowbias32 hash of the int32 key as uint32, h = hash % n_slots, then
// cand = (h + p) % n_slots for p < 16; a slot whose key equals the query
// is a hit (tested BEFORE the empty test, so a query key of -1 hits an
// empty slot), a slot holding -1 ends the chain as a miss. Misses return
// zeros, found = 0, txn = 0.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_PROBES 16
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__global__ void hash_join_kernel(const int32_t* __restrict__ q, int n,
                                 const int32_t* __restrict__ keys,
                                 const float4* __restrict__ vals,
                                 const int32_t* __restrict__ txn,
                                 uint32_t n_slots, int w4,
                                 float4* __restrict__ out_vals,
                                 uint8_t* __restrict__ out_found,
                                 int32_t* __restrict__ out_txn) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t key = q[i];
  const uint32_t h = lowbias32((uint32_t)key) % n_slots;
  int64_t slot = -1;
  for (uint32_t p = 0; p < MAX_PROBES; ++p) {
    const uint32_t cand = (h + p) % n_slots;
    const int32_t k = keys[cand];
    if (k == key) { slot = cand; break; }
    if (k == -1) break;
  }
  float4* dst = out_vals + (int64_t)i * w4;
  if (slot >= 0) {
    const float4* src = vals + slot * w4;
    for (int j = 0; j < w4; ++j) dst[j] = src[j];
    out_found[i] = 1;
    out_txn[i] = txn[slot];
  } else {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < w4; ++j) dst[j] = zero;
    out_found[i] = 0;
    out_txn[i] = 0;
  }
}

// q [n] i32, keys [n_slots] i32, vals [n_slots, width] f32 (width % 4 == 0,
// 16-byte aligned), txn [n_slots] i32 -> out_vals [n, width] f32,
// out_found [n] u8 (torch.bool), out_txn [n] i32. Returns the launch's
// cudaError_t.
extern "C" int hash_join_launch(const void* q, int n, const void* keys,
                                const void* vals, const void* txn,
                                int n_slots, int width, void* out_vals,
                                void* out_found, void* out_txn,
                                void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  hash_join_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)q, n, (const int32_t*)keys, (const float4*)vals,
      (const int32_t*)txn, (uint32_t)n_slots, width / 4, (float4*)out_vals,
      (uint8_t*)out_found, (int32_t*)out_txn);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ pair
// hash_join_pair_launch: both probes of one transform in one launch.
// Replaces the same TPU kernel (hash_join_kernel, called once per cache)
// and, around it, the seven device ops the transform issued per block: two
// float -> int32 key casts, two probe launches, two masked_fill_ of the
// joined rows' key lane and the found mask's &.
//
// Bound: launch latency at the main path's ~1k-row blocks (the function
// moves ~70 KB: two key floats per row in, two 32 B rows and a flag out,
// plus the key slots and rows the probes touch). The single-table
// kernel's thread walks up to 16 DEPENDENT key loads; here a warp takes
// one production row: lanes 0-15 probe the equipment cache with col 1,
// lanes 16-31 the quality cache with col 0, each key cast by
// __float2int_rz: PTX cvt.rzi.s32.f32 gives 0 for NaN, saturates values
// outside int32 and truncates the rest toward zero, which is the JAX
// reference's astype(jnp.int32) and ref.key_to_int32 (a CPU
// .to(torch.int32) is not: it gives -2^31 for NaN, +-inf and every value
// out of range). Lane p of a half loads slot
// (h + p) % n_slots, all 16 in one transaction; a ballot of (k == key ||
// k == -1) gives the first deciding probe p, and the probe hits iff
// keys[slot_p] == key. That is the contract above exactly: the hit test
// comes before the empty test (a pad row's key -1 hits an empty slot),
// n_slots < 16 wraps the same way, a chain with no decision in 16 probes
// misses. Then lanes copy the hit row as float4s — or zeros with the key
// lane (col 1) set to -1.0 on a miss, the KPI kernel's miss mark — and
// lane 0 writes found = eq_found & q_found.
__device__ __forceinline__ void probe_half(int32_t key,
                                           const int32_t* __restrict__ keys,
                                           uint32_t n_slots, int p,
                                           unsigned shift, bool* hit,
                                           uint32_t* slot) {
  const uint32_t h = lowbias32((uint32_t)key) % n_slots;
  const int32_t k = keys[(h + (uint32_t)p) % n_slots];
  const unsigned hits =
      (__ballot_sync(FULL_MASK, k == key) >> shift) & 0xffffu;
  const unsigned stops =
      (__ballot_sync(FULL_MASK, k == key || k == -1) >> shift) & 0xffffu;
  const int first = __ffs(stops) - 1;        // -1: undecided, a miss
  *hit = first >= 0 && ((hits >> first) & 1u);
  *slot = (h + (uint32_t)(first < 0 ? 0 : first)) % n_slots;
}

__global__ void hash_join_pair_kernel(
    const float* __restrict__ prod, int n, int prod_w,
    const int32_t* __restrict__ eq_keys, const float4* __restrict__ eq_vals,
    uint32_t eq_slots, int eq_w4, const int32_t* __restrict__ q_keys,
    const float4* __restrict__ q_vals, uint32_t q_slots, int q_w4,
    float4* __restrict__ eq_out, float4* __restrict__ q_out,
    uint8_t* __restrict__ found) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= n) return;                      // whole warps leave together
  const int lane = threadIdx.x & 31, half = lane >> 4, p = lane & 15;
  const float* r = prod + row * prod_w;
  const int32_t key = __float2int_rz(half ? r[0] : r[1]);
  bool hit;
  uint32_t slot;
  probe_half(key, half ? q_keys : eq_keys, half ? q_slots : eq_slots, p,
             16u * half, &hit, &slot);
  const int w4 = half ? q_w4 : eq_w4;
  if (p < w4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (hit)
      v = (half ? q_vals : eq_vals)[(int64_t)slot * w4 + p];
    else if (p == 0)
      v.y = -1.0f;                           // col 1: the miss mark
    (half ? q_out : eq_out)[row * w4 + p] = v;
  }
  const unsigned both = __ballot_sync(FULL_MASK, hit);
  if (lane == 0) found[row] = (both & 1u) && ((both >> 16) & 1u);
}

// prod [n, prod_w] f32 (keys in cols 0 and 1), the equipment and quality
// caches' keys [S] i32 and vals [S, W] f32 (W % 4 == 0, W <= 64, 16-byte
// aligned) -> eq_out [n, W_eq] f32, q_out [n, W_q] f32, found [n] u8
// (torch.bool). Returns the launch's cudaError_t.
extern "C" int hash_join_pair_launch(const void* prod, int n, int prod_w,
                                     const void* eq_keys, const void* eq_vals,
                                     int eq_slots, int eq_width,
                                     const void* q_keys, const void* q_vals,
                                     int q_slots, int q_width, void* eq_out,
                                     void* q_out, void* found, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;                   // 8 rows per CTA
  const int64_t blocks = ((int64_t)n * 32 + threads - 1) / threads;
  hash_join_pair_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)prod, n, prod_w, (const int32_t*)eq_keys,
      (const float4*)eq_vals, (uint32_t)eq_slots, eq_width / 4,
      (const int32_t*)q_keys, (const float4*)q_vals, (uint32_t)q_slots,
      q_width / 4, (float4*)eq_out, (float4*)q_out, (uint8_t*)found);
  return (int)cudaGetLastError();
}
