// K1: exact int64 per-group sums and counts over group ids, in one pass.
//
// Replaces presto_tpu/ops/pallas_agg.py::_limb_kernel (driven by
// _segmented_limb_sums; API segmented_sum_i64 / segmented_count /
// aggregate). The TPU kernel splits every int64 into 16 four-bit limbs
// and multiplies them by an int8 one-hot on the MXU, because TPU lanes
// are 32-bit and the MXU accumulates in int32. Hopper adds 64-bit words
// natively, so none of that carries over. Unsigned wrapping addition IS
// two's-complement int64 addition, so every sum here is bit-exact and
// independent of the order in which partial sums meet.
//
// The function: row i contributes iff mask[i] is set (every row when
// mask is NULL) and 0 <= ids[i] < G (group 0 when ids is NULL, the
// ungrouped aggregate). Out: the wrapping sum of values[i] per group
// and/or the count of contributing rows per group. Taking the mask and
// the raw int64 (or int32) ids into the kernel, and both outputs from
// one pass, replaces the four device operations per call of the first
// version (a torch.where folding the mask into the ids, an int32 cast,
// the memset, the kernel) and the second launch that counted.
//
// What bounds it on the card: bytes. A row reads 8 B of id, 1 B of mask
// and 8 B of value, 17 B, so 2^20 rows need 5.3 us at 3.35 TB/s. The
// first version issued one shared-memory atomic per row, and at one or
// a few groups (TPC-H Q6: 1, Q1: 6) every lane of a warp hit the same
// few addresses and serialized. This one has two tiers:
//  - G <= 8 (a template parameter: 1 slot, or 8 for G = 2..8): every
//    thread keeps its sums and counts in registers (fully unrolled, so nothing spills)
//    over a grid-stride loop, then the warp folds them with
//    __shfl_down_sync on 64-bit words, the block folds its warps through
//    shared memory, and one global atomic per block and group remains.
//  - G > 8: one 1,024-thread block per SM, with shared accumulators
//    (replicated as far as 48 KB holds, so warps spread over copies),
//    warp-aggregated: a warp whose lanes hold one id (long runs of
//    sorted ids) reduces first and adds once; a warp of runs of equal
//    ids adds once per run; a warp of distinct neighbours (random ids)
//    adds per lane. 64-bit sums across lanes come from __reduce_add_sync
//    over 21/21/22-bit pieces, or from 64-bit shuffles. Above 64 groups
//    each block then stores its G partials to a scratch row, and a
//    second kernel adds the rows into the output: adding up to 4,096
//    groups from every block with global atomics took 2.7x the first
//    version's time on an H100 (0.066 ms at 2^20 rows), the flush
//    outweighing the rows. Up to 64 groups the blocks add atomically.
// Both tiers read two rows per thread per load: a 16-byte longlong2 for
// ids and values (8 bytes for int32 ids, 2 for the mask), and the grid
// covers the 132 SMs (four 256-thread blocks per SM, or one 1,024-thread
// block for the shared tier) instead of one block per 2,048 rows.
//
// C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing, returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegThreads = 256;     // register tier: 4 blocks per SM
constexpr int kRegBlocksPerSm = 4;
constexpr int kSharedThreads = 1024;  // shared tier: one block per SM
constexpr int kSharedSmem = 48 * 1024;  // its accumulators' budget
// up to this many groups the shared tier's blocks add their totals into
// the output with global atomics (132 blocks x 64 groups), above it they
// store partials for a second kernel
constexpr int kAtomicFlushGroups = 64;
constexpr int kMaxDevices = 64;

struct Args {
  const void* ids;  // int32 or int64 [n], or NULL: every row in group 0
  const uint8_t* mask;  // bool [n] or NULL: every row
  const long long* values;  // int64 [n] (sum kernels only)
  long long n;
  int groups;
  bool vec;  // every pointer aligned for the two-row loads
  unsigned long long* out_sum;
  unsigned long long* out_count;
  // shared tier above kAtomicFlushGroups: per-block partials, [blocks x
  // G] each, added up by a second kernel (else blocks add atomically)
  bool partials;
  unsigned long long* part_sum;
  unsigned* part_count;
};

// Two consecutive rows, 2p and 2p + 1. g < 0 marks a row that does not
// contribute (masked out, id outside [0, G), or past the end).
struct Pair {
  int g0, g1;
  unsigned long long v0, v1;
};

template <bool kIds64>
__device__ __forceinline__ long long load_id(const void* ids, long long r) {
  if (kIds64) return __ldcs(static_cast<const long long*>(ids) + r);
  return __ldcs(static_cast<const int*>(ids) + r);
}

template <bool kIds64, bool kSum>
__device__ __forceinline__ Pair load_pair(const Args& a, long long p) {
  const long long r = 2 * p;
  long long id0 = 0, id1 = 0;
  bool m0 = true, m1 = r + 1 < a.n;
  unsigned long long v0 = 0ull, v1 = 0ull;
  if (a.vec && r + 1 < a.n) {
    if (a.ids != nullptr) {
      if (kIds64) {
        const longlong2 x = __ldcs(static_cast<const longlong2*>(a.ids) + p);
        id0 = x.x;
        id1 = x.y;
      } else {
        const int2 x = __ldcs(static_cast<const int2*>(a.ids) + p);
        id0 = x.x;
        id1 = x.y;
      }
    }
    if (a.mask != nullptr) {
      const unsigned short m =
          __ldcs(reinterpret_cast<const unsigned short*>(a.mask) + p);
      m0 = (m & 0xffu) != 0u;
      m1 = (m >> 8) != 0u;
    }
    if (kSum) {
      const longlong2 v =
          __ldcs(reinterpret_cast<const longlong2*>(a.values) + p);
      v0 = (unsigned long long)v.x;
      v1 = (unsigned long long)v.y;
    }
  } else {  // unaligned inputs, or the last row of an odd n
    if (a.ids != nullptr) {
      id0 = load_id<kIds64>(a.ids, r);
      if (m1) id1 = load_id<kIds64>(a.ids, r + 1);
    }
    if (a.mask != nullptr) {
      m0 = __ldcs(a.mask + r) != 0;
      if (m1) m1 = __ldcs(a.mask + r + 1) != 0;
    }
    if (kSum) {
      v0 = (unsigned long long)__ldcs(a.values + r);
      if (m1) v1 = (unsigned long long)__ldcs(a.values + r + 1);
    }
  }
  Pair out;
  out.g0 = (m0 && id0 >= 0 && id0 < a.groups) ? (int)id0 : -1;
  out.g1 = (m1 && id1 >= 0 && id1 < a.groups) ? (int)id1 : -1;
  out.v0 = v0;
  out.v1 = v1;
  return out;
}

// ---------------------------------------------------------------- G <= 8

template <int kSlots, bool kSum, bool kCount>
__device__ __forceinline__ void add_row(int g, unsigned long long v,
                                        unsigned long long (&sum)[kSlots],
                                        unsigned (&cnt)[kSlots]) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const bool hit = g == k;
    if (kSum) sum[k] += hit ? v : 0ull;
    if (kCount) cnt[k] += hit ? 1u : 0u;
  }
}

template <int kSlots, bool kIds64, bool kSum, bool kCount>
__global__ void __launch_bounds__(kRegThreads, kRegBlocksPerSm)
    segsum_regs_kernel(Args a) {
  unsigned long long sum[kSlots];
  unsigned cnt[kSlots];  // rows per thread < 2^31 (the wrapper's limit)
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    sum[k] = 0ull;
    cnt[k] = 0u;
  }
  const long long pairs = (a.n + 1) >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // two pairs per iteration, both loaded before either is added, so
  // four rows' loads are in flight per thread
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < pairs; p += 2 * stride) {
    const Pair x = load_pair<kIds64, kSum>(a, p);
    Pair y;
    y.g0 = y.g1 = -1;
    y.v0 = y.v1 = 0ull;
    if (p + stride < pairs) y = load_pair<kIds64, kSum>(a, p + stride);
    add_row<kSlots, kSum, kCount>(x.g0, x.v0, sum, cnt);
    add_row<kSlots, kSum, kCount>(x.g1, x.v1, sum, cnt);
    add_row<kSlots, kSum, kCount>(y.g0, y.v0, sum, cnt);
    add_row<kSlots, kSum, kCount>(y.g1, y.v1, sum, cnt);
  }
  // fold the warp, then the block's warps, then one atomic per group
  __shared__ unsigned long long warp_sum[kRegThreads / 32][kSlots];
  __shared__ unsigned warp_cnt[kRegThreads / 32][kSlots];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    for (int off = 16; off > 0; off >>= 1) {
      if (kSum) sum[k] += __shfl_down_sync(kFull, sum[k], off);
      if (kCount) cnt[k] += __shfl_down_sync(kFull, cnt[k], off);
    }
    if (lane == 0) {
      warp_sum[warp][k] = sum[k];
      warp_cnt[warp][k] = cnt[k];
    }
  }
  __syncthreads();
  if (threadIdx.x < a.groups) {  // groups <= kSlots
    const int k = threadIdx.x;
    unsigned long long s = 0ull, c = 0ull;
    for (int w = 0; w < kRegThreads / 32; ++w) {
      s += warp_sum[w][k];
      c += warp_cnt[w][k];
    }
    if (kSum && s != 0ull) atomicAdd(a.out_sum + k, s);
    if (kCount && c != 0ull) atomicAdd(a.out_count + k, c);
  }
}

// ----------------------------------------------------------------- G > 8

template <bool kSum, bool kCount>
__device__ __forceinline__ void add_lane(int g, unsigned long long v,
                                         unsigned rows,
                                         unsigned long long* ssum,
                                         unsigned* scnt) {
  if (g >= 0) {
    if (kSum && v != 0ull) atomicAdd(ssum + g, v);
    if (kCount && rows != 0u) atomicAdd(scnt + g, rows);
  }
}

// the wrapping 64-bit sum over the lanes of `mask`, from 32-bit warp
// reductions of 21/21/22-bit pieces (32 pieces < 2^22 add exactly)
__device__ __forceinline__ unsigned long long reduce_u64(
    unsigned mask, unsigned long long v) {
  return (unsigned long long)__reduce_add_sync(mask,
                                               (unsigned)(v & 0x1FFFFFull)) +
         ((unsigned long long)__reduce_add_sync(
              mask, (unsigned)((v >> 21) & 0x1FFFFFull))
          << 21) +
         ((unsigned long long)__reduce_add_sync(mask, (unsigned)(v >> 42))
          << 42);
}

// One row per lane into the warp's accumulators (g < 0: no row). Three
// shapes of a warp's ids, from cheapest test to dearest work:
//  - one id on every lane (a long run of sorted ids): the warp reduces
//    and one lane adds;
//  - most lanes' ids unequal to their left neighbour's (random ids):
//    each lane adds its own row, no reduction;
//  - otherwise runs of equal ids in consecutive lanes: a segmented
//    suffix sum over shuffles, and each run's first lane adds the run.
// (__match_any_sync, which groups equal ids wherever they sit, read
// 2-3.6x slower than these on an H100.)
template <bool kSum, bool kCount>
__device__ __forceinline__ void add_warp(int g, unsigned long long v,
                                         unsigned rows,
                                         unsigned long long* ssum,
                                         unsigned* scnt) {
  const int lane = threadIdx.x & 31;
  if (__all_sync(kFull, g == __shfl_sync(kFull, g, 0))) {
    unsigned long long total = 0ull;
    if (kSum) total = reduce_u64(kFull, v);
    unsigned n = 0u;
    if (kCount) n = __reduce_add_sync(kFull, rows);
    if (lane == 0) add_lane<kSum, kCount>(g, total, n, ssum, scnt);
    return;
  }
  // every lane takes part in the shuffle (lane 0 reads its own id)
  const int left = __shfl_up_sync(kFull, g, 1);
  const bool head = lane == 0 || left != g;
  const unsigned heads = __ballot_sync(kFull, head);
  if (__popc(heads) > 16) {  // runs shorter than two lanes on average
    add_lane<kSum, kCount>(g, v, rows, ssum, scnt);
    return;
  }
  const unsigned later = heads & ~((2u << lane) - 1u);
  const int end = later ? __ffs(later) - 1 : 32;  // this lane's run ends
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    unsigned long long vo = 0ull;
    unsigned ro = 0u;
    if (kSum) vo = __shfl_down_sync(kFull, v, off);
    if (kCount) ro = __shfl_down_sync(kFull, rows, off);
    if (lane + off < end) {
      v += vo;
      rows += ro;
    }
  }
  if (head) add_lane<kSum, kCount>(g, v, rows, ssum, scnt);
}

// Pass 1: each block accumulates its rows in shared memory, then adds
// its G totals into the output with global atomics (up to 64 groups) or
// stores them, every group, to its row of the scratch (plain coalesced
// stores: at up to 4,096 groups, the atomics cost more than the rows
// themselves). The block keeps `copies` replicas of its
// accumulators, as many as 48 KB holds up to one per warp, and warp w
// adds into replica w % copies: at a few dozen groups and random ids,
// one replica shared by 32 warps serialized on its addresses.
template <bool kIds64, bool kSum, bool kCount>
__global__ void __launch_bounds__(kSharedThreads)
    segsum_shared_kernel(Args a, int copies) {
  extern __shared__ unsigned long long smem[];
  const int slots = copies * a.groups;
  unsigned long long* ssum = smem;  // [copies][G] when kSum
  unsigned* scnt = reinterpret_cast<unsigned*>(smem + (kSum ? slots : 0));
  for (int i = threadIdx.x; i < slots; i += blockDim.x) {
    if (kSum) ssum[i] = 0ull;
    if (kCount) scnt[i] = 0u;
  }
  __syncthreads();
  const int replica = ((threadIdx.x >> 5) % copies) * a.groups;
  unsigned long long* wsum = ssum + replica;
  unsigned* wcnt = scnt + replica;
  const long long pairs = (a.n + 1) >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  // the loop runs the same number of times on every lane of a warp, as
  // the warp-wide intrinsics need: lanes past the end carry no row
  for (long long p0 = (long long)blockIdx.x * blockDim.x + threadIdx.x - lane;
       p0 < pairs; p0 += stride) {
    const long long p = p0 + lane;
    Pair x;
    x.g0 = x.g1 = -1;
    x.v0 = x.v1 = 0ull;
    if (p < pairs) x = load_pair<kIds64, kSum>(a, p);
    // a pair in one group (runs of sorted ids) goes in as one entry
    unsigned rows0 = x.g0 >= 0 ? 1u : 0u;
    if (x.g1 >= 0 && x.g1 == x.g0) {
      x.v0 += x.v1;
      rows0 = 2u;
      x.g1 = -1;
    }
    add_warp<kSum, kCount>(x.g0, x.v0, rows0, wsum, wcnt);
    if (__any_sync(kFull, x.g1 >= 0))
      add_warp<kSum, kCount>(x.g1, x.v1, x.g1 >= 0 ? 1u : 0u, wsum, wcnt);
  }
  __syncthreads();
  const size_t row = (size_t)blockIdx.x * a.groups;
  for (int g = threadIdx.x; g < a.groups; g += blockDim.x) {
    unsigned long long s = 0ull;
    unsigned c = 0u;
    for (int r = 0; r < slots; r += a.groups) {
      if (kSum) s += ssum[r + g];
      if (kCount) c += scnt[r + g];
    }
    if (a.partials) {
      if (kSum) a.part_sum[row + g] = s;
      if (kCount) a.part_count[row + g] = c;
    } else {
      if (kSum && s != 0ull) atomicAdd(a.out_sum + g, s);
      if (kCount && c != 0u)
        atomicAdd(a.out_count + g, (unsigned long long)c);
    }
  }
}

// Pass 2: out[g] = the sum over the P blocks' partials of group g. A
// block takes 32 groups; its 8 rows of 32 threads each add every 8th
// partial (coalesced across the 32 groups), then fold through shared
// memory. Every output is written, so this path needs no memset.
template <bool kSum, bool kCount>
__global__ void __launch_bounds__(256) segsum_finalize_kernel(Args a,
                                                               int parts) {
  __shared__ unsigned long long fold_sum[8][32];
  __shared__ unsigned long long fold_cnt[8][32];
  const int g = blockIdx.x * 32 + threadIdx.x;
  unsigned long long s = 0ull, c = 0ull;
  if (g < a.groups) {
    for (int p = threadIdx.y; p < parts; p += 8) {
      const size_t i = (size_t)p * a.groups + g;
      if (kSum) s += a.part_sum[i];
      if (kCount) c += a.part_count[i];
    }
  }
  fold_sum[threadIdx.y][threadIdx.x] = s;
  fold_cnt[threadIdx.y][threadIdx.x] = c;
  __syncthreads();
  if (threadIdx.y == 0 && g < a.groups) {
#pragma unroll
    for (int y = 1; y < 8; ++y) {
      s += fold_sum[y][threadIdx.x];
      c += fold_cnt[y][threadIdx.x];
    }
    if (kSum) a.out_sum[g] = s;
    if (kCount) a.out_count[g] = c;
  }
}

// ------------------------------------------------------------- dispatch

int sm_count(int device) {
  static int counts[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 132;
  if (counts[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || sms <= 0)
      sms = 132;
    counts[device] = sms;
  }
  return counts[device];
}

long long grid_size(long long pairs, int threads, int cap) {
  const long long blocks = (pairs + threads - 1) / threads;
  return blocks < cap ? blocks : cap;
}

template <int kSlots, bool kIds64, bool kSum, bool kCount>
void launch(const Args& a, int blocks_cap, cudaStream_t s) {
  const long long pairs = (a.n + 1) >> 1;
  if constexpr (kSlots > 0) {
    const long long blocks =
        grid_size(pairs, kRegThreads, blocks_cap * kRegBlocksPerSm);
    segsum_regs_kernel<kSlots, kIds64, kSum, kCount>
        <<<(unsigned)blocks, kRegThreads, 0, s>>>(a);
  } else {
    // replicas of the accumulators within the default 48 KB of dynamic
    // shared memory (one at 4,096 groups), at most one per warp
    const int entry = (kSum ? 8 : 0) + (kCount ? 4 : 0);
    int copies = kSharedSmem / (a.groups * entry);
    if (copies > kSharedThreads / 32) copies = kSharedThreads / 32;
    const long long blocks = grid_size(pairs, kSharedThreads, blocks_cap);
    segsum_shared_kernel<kIds64, kSum, kCount>
        <<<(unsigned)blocks, kSharedThreads,
           (size_t)copies * a.groups * entry, s>>>(a, copies);
    if (a.partials)
      segsum_finalize_kernel<kSum, kCount>
          <<<(unsigned)((a.groups + 31) / 32), dim3(32, 8), 0, s>>>(
              a, (int)blocks);
  }
}

template <int kSlots, bool kIds64>
void launch_outputs(const Args& a, int blocks_cap, cudaStream_t s) {
  if (a.out_sum != nullptr && a.out_count != nullptr)
    launch<kSlots, kIds64, true, true>(a, blocks_cap, s);
  else if (a.out_sum != nullptr)
    launch<kSlots, kIds64, true, false>(a, blocks_cap, s);
  else
    launch<kSlots, kIds64, false, true>(a, blocks_cap, s);
}

template <int kSlots>
void launch_ids(const Args& a, bool ids64, int blocks_cap, cudaStream_t s) {
  if (ids64)
    launch_outputs<kSlots, true>(a, blocks_cap, s);
  else
    launch_outputs<kSlots, false>(a, blocks_cap, s);
}

}  // namespace

// The bytes of scratch presto_segsum_i64 needs for `groups` on `device`:
// above kAtomicFlushGroups a sum and a count per group for each block of
// the first pass (one block per SM), else 0 (no scratch).
extern "C" int presto_segsum_scratch_bytes(int device, int groups) {
  if (groups <= kAtomicFlushGroups) return 0;
  return sm_count(device) * groups * 12;
}

// ids: int32 or int64 [n] (ids_bytes 4 or 8), or NULL (ids_bytes 0): all
// rows in group 0. mask: bool [n] or NULL. values: int64 [n] or NULL.
// out: int64 [(with_sum + with_count) * groups], the sums first; with_sum
// needs values. 1 <= groups <= 4096, 0 <= n < 2^31. scratch: 8-byte
// aligned, of presto_segsum_scratch_bytes(device, groups) bytes, or NULL
// where that is 0.
extern "C" int presto_segsum_i64(int device, const void* ids, int ids_bytes,
                                 const void* mask, const void* values,
                                 long long n, int groups, int with_sum,
                                 int with_count, void* out, void* scratch,
                                 void* stream) {
  const bool partials = groups > kAtomicFlushGroups;
  if (groups < 1 || groups > 4096 || n < 0 || n >= (1LL << 31) ||
      (!with_sum && !with_count) || (with_sum && values == nullptr) ||
      (ids != nullptr && ids_bytes != 4 && ids_bytes != 8) ||
      (ids == nullptr && groups != 1) || (partials && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int sms = sm_count(device);
  cudaStream_t s = (cudaStream_t)stream;
  if (!partials || n == 0) {  // the second kernel writes every output
    const size_t words = (size_t)(with_sum ? 1 : 0) + (with_count ? 1 : 0);
    err = cudaMemsetAsync(out, 0,
                          sizeof(unsigned long long) * words * groups, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n == 0) return (int)cudaGetLastError();
  Args a;
  a.ids = ids;
  a.mask = static_cast<const uint8_t*>(mask);
  a.values = static_cast<const long long*>(values);
  a.n = n;
  a.groups = groups;
  a.out_sum = with_sum ? static_cast<unsigned long long*>(out) : nullptr;
  a.out_count = with_count ? static_cast<unsigned long long*>(out) +
                                 (with_sum ? groups : 0)
                           : nullptr;
  a.partials = partials;
  a.part_sum = partials ? static_cast<unsigned long long*>(scratch) : nullptr;
  a.part_count = partials ? reinterpret_cast<unsigned*>(
                                a.part_sum + (size_t)sms * groups)
                          : nullptr;
  const bool ids64 = ids != nullptr && ids_bytes == 8;
  const uintptr_t id_align = ids64 ? 15u : 7u;
  a.vec = ((uintptr_t)ids & id_align) == 0 && ((uintptr_t)mask & 1u) == 0 &&
          ((uintptr_t)values & 15u) == 0;
  if (groups == 1)
    launch_ids<1>(a, ids64, sms, s);
  else if (groups <= 8)
    launch_ids<8>(a, ids64, sms, s);
  else
    launch_ids<0>(a, ids64, sms, s);
  return (int)cudaGetLastError();
}
