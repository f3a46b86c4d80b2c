// K2 + K3: the hash-join probe, for both table layouts.
//
// Replaces presto_tpu/ops/pallas_join.py::_dim_kernel (driven by
// _probe_dim; builds of <= 2048 rows) and ::_radix_kernel (driven by
// _probe_radix; builds of <= 2^20 rows). Both return, per probe hash,
// the (start, count) of the equal-hash valid segment of the hash-sorted
// build, or (-1, 0). The tables come from build_index (ops/cuda_join.py,
// a torch port of the reference's _insert): one entry per unique build
// hash, linear probing inside a span:
//   dim:   base = ((h >> 7) & (T - 1)) * 128,     width = 128
//   radix: base = (h >> (32 - log2b)) * 16384,    width = 16384
// with h = fmix32 over the hash's (lo, hi) words (_mix32). A probe walks
// from base + (h & (width - 1)), wrapping inside the span, for at most
// max_probes (65) steps, stopping at its hash or at an empty slot.
//
// The TPU machinery has no counterpart here. A whole table stays in
// device memory, mostly in the 50 MB L2, so there is no VMEM tiling: no
// radix partition pass, no block -> bucket scalar-prefetch map
// (pallas_join.py:437-514) and no 8x sublane replication of the dim
// tables (:220-223).
//
// What bounds it on the card: bytes, and the latency of dependent table
// loads. Each probe row reads its 8 B hash and writes 8 B of results;
// each probe step reads one table slot, at random. The wrapper splits
// the reference's (lo, hi, start, count) entry into two arrays once per
// build: the slot's 64-bit hash (all ones when empty; build_index never
// stores that hash) and its (start, count) payload. A step reads only
// the 8 B key, so a 32-byte L2 sector holds four consecutive slots of a
// linear-probe chain instead of two, a 2^21-slot radix table's keys take
// 16 MB of L2 instead of 32, and a miss reads no payload; the payload is
// read once, on a hit. The probe hashes are read and the results written
// with streaming cache hints (__ldcs / __stcs, evict first), so the
// page streaming through does not push the table out of L2. One thread
// per probe row keeps the most warps resident to hide the table's
// latency: two or four rows per thread, their chains in lock-step, read
// 20-60% slower at every table size on an H100.
//
// C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kDimWidth = 128;
constexpr uint32_t kBucketCap = 1u << 14;
constexpr unsigned long long kEmpty = ~0ull;

__device__ __forceinline__ uint32_t mix32(uint32_t lo, uint32_t hi) {
  uint32_t h = lo ^ (hi * 0x85EBCA6Bu);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

template <bool kDim>
__device__ __forceinline__ void probe_row(
    const unsigned long long* __restrict__ hashes, long long n,
    const unsigned long long* __restrict__ keys,
    const int2* __restrict__ payload, int layout_param, int max_probes,
    int* __restrict__ out_start, int* __restrict__ out_count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long h64 = __ldcs(hashes + i);
  const uint32_t h = mix32((uint32_t)h64, (uint32_t)(h64 >> 32));
  uint32_t base, width;
  if (kDim) {
    const uint32_t tiles = (uint32_t)layout_param;
    width = kDimWidth;
    base = tiles > 1 ? ((h >> 7) & (tiles - 1)) * kDimWidth : 0u;
  } else {
    const int log2b = layout_param;
    width = kBucketCap;
    base = log2b ? (h >> (32 - log2b)) * kBucketCap : 0u;
  }
  uint32_t slot = h & (width - 1);
  int start = -1, count = 0;
  for (int p = 0; p < max_probes; ++p) {
    const unsigned long long k = __ldg(keys + (size_t)base + slot);
    if (k == kEmpty) break;  // an empty slot ends the chain: a miss
    if (k == h64) {
      const int2 e = __ldg(payload + (size_t)base + slot);
      start = e.x;
      count = e.y;
      break;
    }
    slot = (slot + 1) & (width - 1);
  }
  __stcs(out_start + i, start);
  __stcs(out_count + i, count);
}

// one symbol per layout, so a profile tells K2 from K3
__global__ void probe_dim_kernel(
    const unsigned long long* __restrict__ hashes, long long n,
    const unsigned long long* __restrict__ keys,
    const int2* __restrict__ payload, int tiles, int max_probes,
    int* __restrict__ out_start, int* __restrict__ out_count) {
  probe_row<true>(hashes, n, keys, payload, tiles, max_probes, out_start,
                  out_count);
}

__global__ void probe_radix_kernel(
    const unsigned long long* __restrict__ hashes, long long n,
    const unsigned long long* __restrict__ keys,
    const int2* __restrict__ payload, int log2b, int max_probes,
    int* __restrict__ out_start, int* __restrict__ out_count) {
  probe_row<false>(hashes, n, keys, payload, log2b, max_probes, out_start,
                   out_count);
}

}  // namespace

// hashes: u64[n]; keys: u64[slots] (all ones = empty); payload:
// int32[slots, 2] (start, count); out_start/out_count: int32[n].
// dim_layout != 0: layout_param = tiles; else layout_param = log2(buckets).
extern "C" int presto_hash_probe(int device, const void* hashes,
                                 long long n, const void* keys,
                                 const void* payload, int dim_layout,
                                 int layout_param, int max_probes,
                                 void* out_start, void* out_count,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    auto kernel = dim_layout ? probe_dim_kernel : probe_radix_kernel;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)hashes, n,
        (const unsigned long long*)keys, (const int2*)payload, layout_param,
        max_probes, (int*)out_start, (int*)out_count);
  }
  return (int)cudaGetLastError();
}
