// K4: one exchange partition id per row.
//
// Replaces presto_tpu/dist/spool.py::_pallas_part_ids (its inner
// `kernel`, driven by device_partition_pages). The TPU kernel receives
// each key column's u64 value encoding split into lo/hi int32 words,
// because Mosaic has no 64-bit lanes; Hopper threads have native 64-bit
// loads, so the kernel reads the int64 encodings [C, n] as they are and
// splits them in registers. Per row:
//
//   acc = 0
//   for c in 0..C-1:  acc = acc * 31 + fmix32(lo_c ^ hi_c * 0x85EBCA6B)
//   acc = fmix32(acc)
//   out = acc % nparts            (all in uint32)
//
// which is the reference's _mix32 fold bit for bit (the final mix is
// _mix32(acc, 0), and 0 * 0x85EBCA6B contributes nothing). NULL keys
// arrive already replaced by the sentinel encoding, as in the reference.
//
// What bounds it on the card: bytes. Each row reads C x 8 B of encodings
// and writes a 4 B id: at n = 2^20, C = 1 that is 12.6 MB, ~3.8 us at
// 3.35 TB/s. The arithmetic (a few integer multiplies per key) is far
// below the integer rate. One thread per row over a grid-stride loop,
// neighbouring threads on neighbouring rows, so every load and the
// store coalesce; the simple version, nothing staged through shared
// memory.
//
// C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ uint32_t fmix32(uint32_t lo, uint32_t hi) {
  uint32_t h = lo ^ (hi * 0x85EBCA6Bu);
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void part_ids_kernel(const unsigned long long* __restrict__ enc,
                                int cols, long long n, uint32_t nparts,
                                int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t acc = 0u;
    for (int c = 0; c < cols; ++c) {
      const unsigned long long v = enc[(long long)c * n + i];
      acc = acc * 31u + fmix32((uint32_t)v, (uint32_t)(v >> 32));
    }
    out[i] = (int32_t)(fmix32(acc, 0u) % nparts);
  }
}

}  // namespace

// enc: int64[cols, n] row-major; out: int32[n]; 1 <= nparts.
extern "C" int presto_part_ids(int device, const void* enc, int cols,
                               long long n, int nparts, void* out,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    part_ids_kernel<<<(unsigned)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const unsigned long long*)enc, cols, n, (uint32_t)nparts,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}
