// Open-addressing probe of a worker's master cache (the streaming join of
// DOD-ETL's Data Transformer), written by hand for Hopper (sm_90a).
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
// launch the kernel is launch-bound; fusing it with the KPI kernel is
// later work (ROADMAP).
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
