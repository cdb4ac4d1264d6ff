// psort.cu — the sparse engine's key sort-dedup and compaction on Hopper.
//
// Replaces four TPU kernels of jepsen_tpu/lin/psort.py:
//
//   dedup_keys    (pallas_call in _dedup_call, body _dedup_body, sort
//                  _bitonic_sort, where the TPU pads to a power of two up
//                  to 2^19): u32 keys with their invalid flag folded into
//                  bit 31 -> the distinct valid keys ascending in
//                  out[0 .. cap), KEY_FILL after them, and
//                  flags = {min(total, cap), total > cap};
//   compact_keys  (pallas_call in _compact_call, body _compact_body): the
//                  keys sorted ascending, out = sorted[0 .. cap), and
//                  count = min(number of non-KEY_FILL keys, cap). No dedup.
//   dedup_keys2   (_dedup2_call, _dedup2_body, _bitonic_sort2) and
//   compact_keys2 (_compact2_call, _compact2_body): the same on (hi, lo)
//                  u32 pairs in lexicographic order, the invalid flag in
//                  hi's bit 31 and the dead entry (KEY_FILL, KEY_FILL);
//   dedup_keys_dom  (_dedup_dom_call, body _dedup_dom_body) and
//   dedup_keys2_dom (_dedup2_dom_call, body _dedup2_dom_body, sort
//                  _bitonic_sort4): the crash-dom bands' dedup with
//                  dominance pruning, on (group, word) pairs of single keys
//                  (one uint64_t: a << 32 | w) or of pair keys (a 128-bit
//                  key: group pair, then word pair). See "Dominance" below.
//
// A pair is packed as one uint64_t (hi << 32) | lo, so the lexicographic
// order is one unsigned compare, the flag is bit 63 and the dead entry is
// ~0. Every kernel below is a template on the key type (uint32_t or
// uint64_t); only loading from and storing to the word arrays differ. In
// the pair band lo's bit 31 is payload (at window 29 with 3 state bits it
// is slot 28's key bit), which the 64-bit key keeps below the flag.
//
// The dedup path (dedup_keys, dedup_keys2) sorts only the live keys, by
// an LSD radix sort with 8-bit digits, and never pads. Per call, after one
// cudaMemsetAsync of the look-back status words, histograms and tickets:
//
//   dedup_load    folds ~valid into the flag, writes the live keys (flag
//                 clear) to the front of a scratch buffer (each block's
//                 offset from one atomicAdd on the device-side live count:
//                 the order of the live keys does not matter, as the
//                 output is their sorted set), adds every digit's
//                 histogram, and fills out[0 .. cap) with the fill key.
//                 Its last block (a done counter) plans the passes on the
//                 device: each digit's bucket bases, and the ping-pong
//                 buffer each pass reads, or -1 where every live key falls
//                 in one bucket (the pass would be the identity);
//   radix_pass    one per digit (4 for u32 keys, 8 for pairs): blocks take
//                 tiles in ticket order and exit past the live count or on
//                 a planned skip; each ranks its tile by warp multisplit
//                 (__match_any_sync) in shared memory, stably, takes its
//                 buckets' global offsets by decoupled look-back (a status
//                 word per tile and digit), and writes the tile out in
//                 digit order;
//   dedup_finish  keeps the first key of each run, ranks the survivors by
//                 a warp-ballot scan and a look-back over tiles, writes
//                 out[rank] for rank < cap and the flags
//                 {min(total, cap), total > cap}.
//
// That is 6 launches a call for single keys and 10 for pairs at every n
// up to kDedupMaxN = 2^21, the engine's gate psort.DEDUP_MAX_N (24 and 31
// for the bitonic path it replaced at n_pad = 2^18). A skipped
// digit costs a launch whose blocks exit at once: the band's unused high
// bits move no data. Nothing synchronises with the host. What bounds it
// on this card: launch latency and the dependent look-back chain at the
// engine's sizes (the bytes, the live keys read and written once per
// digit pass, take microseconds at 3.35 TB/s at n = 2^21 pairs).
//
// Both compactions run in one launch up to their gates
// (psort.COMPACT_ONE_MAX_N, psort.COMPACT2_ONE_MAX_N, both set on the
// card) and sort by a bitonic network over n_pad keys above them. The
// network's strides below a tile of 32 KiB (8192 single keys, 4096 pairs)
// run inside one block in shared memory, many stages per launch; larger
// strides are one launch each of global-memory compare-exchanges, one
// pair per thread across the whole card (n_pad up to 2^19 keys, resident
// in the 50 MB L2). The network's output is the sorted array whatever its
// stage order, so the result equals the TPU kernel's bit for bit. count
// stays on the device. At n_pad = 2^19 the single-key sort is 1 tile
// launch + 21 global stages + 6 tile merges (pairs: 1 + 28 + 7), each
// moving the array through L2: launches and L2 traffic bound it.
//
// The compaction in one launch, compact_one_kernel<K>: one template on the
// key type, instantiated for single keys (uint32_t) and pairs (uint64_t).
// The engine's return filters clear one bit that every survivor holds,
// from a frontier that is ascending, so their live keys (those other than
// the fill key) arrive ascending with fill holes, and an order-keeping
// compaction is the sorted result. One block of 1024 threads sweeps the
// keys once, each warp over a contiguous range, eight keys a lane in
// flight: it counts the live keys per warp by ballots, takes their OR and
// AND, and notes whether any live key is smaller (unsigned) than the live
// key before it (within a warp by a shuffle from the previous live lane,
// across warps by a scan of the warps' first and last keys). A scan of the
// warps' counts gives each warp its offset. With no descent a second
// sweep writes the first cap live keys to out in order (a warp whose
// offset is past cap skips it) and the fill key after them. With a
// descent it places the live keys in order into a buffer and sorts them
// with the dominance dedup's block-local LSD radix sort over their
// varying 8-bit windows (below; at most 4 for single keys, 8 for pairs):
// in shared memory up to 24,576 single keys or 12,288 pairs, else in a
// device-memory scratch of 2 n keys that the wrapper sizes from n. The
// path (ordered, sorted in shared memory, sorted in device memory) is
// chosen inside the launch and written beside the count. Bound on the
// ordered path by one SM's share of the memory traffic (two reads of the
// keys, one write of the output) and the launch; arbitrary input adds a
// pass per varying 8-bit window, on one SM.
//
// Dominance. The TPU kernels, and the engine's forced lax path that the
// crash-dom bands really run (jepsen_tpu/lin/bfs.py _dedup_keys_dom and
// _dedup_keys2_dom with dom_force), sort the (group, word) entries, then
// for `rounds` rounds drop each entry that is invalid, a duplicate of its
// predecessor, or dominated (its group's first entry, or a predecessor at
// distance 1..chain in its group, has a word that is a strict subset of
// its own), and compact the survivors in order between rounds; last they
// sort the survivors' recombined full keys. Two paths, chosen on the host
// from n_pad (psort.DOM_ONE_MAX_N for pairs, psort.DOM1_ONE_MAX_N for
// single keys, both set on the card).
//
// One launch (n_pad up to the gate: the in-chunk tiers 256 .. 4,096, at
// M 32 for pairs and M 16 for single keys; one template on the entry
// type, 8-byte entries and 32-bit full keys for single keys, 16-byte
// entries and 64-bit full keys for pairs). One block of 1024 threads does
// the whole call. It loads
// only the valid entries (an invalid one, or the padding, never
// survives), placed in any order by a warp ballot and one shared atomic
// per warp, taking the OR and AND of their bits; sorts them by the
// 128-bit key with a block-local LSD radix sort over 8-bit windows that
// cover only the bits that vary (each window starts at the lowest
// varying bit not yet covered; stable by warp multisplit, as in
// psort_fused.cu), or by rank when there are at most 128; runs the prune
// rounds on the sorted array (a binary search for the group's first
// entry, the walk back over the chain), each round's keep bits by warp
// ballots and its order-preserving compaction by a scan of the warps'
// counts; writes the survivors' full keys, sorts them the same way, and
// writes out[cap], the count and the overflow flag. Entries live in two
// 96 KiB buffers of dynamic shared memory while the valid ones fit
// (6,144 pairs or 12,288 single-key entries; the keep bits, at most 384
// words, in the histogram space), else in two
// device-memory buffers of n entries plus n / 32 + 1 keep words that the
// wrapper sizes from n: the path is chosen inside the launch, with no
// host sync, and written in a third word beside the flags. The pair
// crash-dom headline's fullest calls hold 168, 600 and 1,809 valid
// entries at tiers 256, 1,024 and 4,096 (chip_smoke.py phase 19; the
// rest of the n = 33 * tier candidates is fill), so the load's sweep of
// the n entries and the few barriers of each radix window bound it, on
// one SM. With many valid entries (dense random keys) the one block
// loses to the multi-launch chain's 132 SMs, which sets the gate.
//
// Multi-launch (the calls past the gates: the upper in-chunk tiers of
// the pair band and the host-row executor's caps up to 2^25). One sort of
// the entries (the tile and global-stage kernels above on the wider
// key), then per round one thread per entry finds its group's first
// entry by a binary search and walks back over its predecessors while
// they are in its group, and a block-count / scan / scatter compacts the
// survivors, the rest becoming the fill key. The full keys are scattered
// to their ranks with the fill after them and sorted; the sort of the
// full keys and every later round stop at the padded survivor count,
// read on the device, so nothing synchronises with the host. 14 or more
// dependent launches a call (dom_kernel_launches counts them); bound by
// launch latency at small n_pad and by the initial sort (log2(n_pad)^2 /
// 2 stages through L2 or device memory, 16 bytes a pair key) at large.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see jepsen_tpu_torch/_build.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
// Bytes of shared memory per sort tile: every stride below the tile runs
// in one launch. 32 KiB stays under the 48 KiB of static shared memory.
constexpr int kTileBytes = 32768;
// Entries per block in the dominance dedups' counts and compactions: one
// per thread.
constexpr int kSeg = kThreads;
constexpr int kMinN = 1024;
constexpr int kMaxN = 1 << 19;
// The dominance dedups take every size the engine gives them.
constexpr int kDomMaxN = 1 << 26;

// A 128-bit key in lexicographic order: the dominance dedup of pair keys
// sorts (group pair, word pair) entries as (hi, lo) = (group, word).
struct U128 {
  uint64_t hi, lo;
};
__device__ __forceinline__ bool operator>(const U128& a, const U128& b) {
  return a.hi > b.hi || (a.hi == b.hi && a.lo > b.lo);
}
__device__ __forceinline__ bool operator==(const U128& a, const U128& b) {
  return a.hi == b.hi && a.lo == b.lo;
}

template <typename K>
struct KeyOf {
  static constexpr K kFill = ~K(0);
  static constexpr K kInvalid = K(1) << (8 * sizeof(K) - 1);
  static constexpr int kTile = kTileBytes / static_cast<int>(sizeof(K));
};
template <>
struct KeyOf<U128> {
  static constexpr int kTile = kTileBytes / static_cast<int>(sizeof(U128));
};

// The padded prefix [0, P) a sort must order: every key when `total` is
// null, else the next power of two at least *total (at least kMinN, at
// most n_pad). Keys past *total are the fill key, so sorting the prefix
// sorts the array.
__device__ __forceinline__ int sort_prefix(const int32_t* total, int n_pad) {
  if (total == nullptr) return n_pad;
  const int t = *total;
  int p = kMinN;
  while (p < t && p < n_pad) p <<= 1;
  return p < n_pad ? p : n_pad;
}

// Key g of the word arrays: lo alone for single keys, (hi, lo) for pairs.
template <typename K>
__device__ __forceinline__ K load_key(const uint32_t* hi, const uint32_t* lo,
                                      int g);
template <>
__device__ __forceinline__ uint32_t load_key<uint32_t>(const uint32_t*,
                                                       const uint32_t* lo,
                                                       int g) {
  return lo[g];
}
template <>
__device__ __forceinline__ uint64_t load_key<uint64_t>(const uint32_t* hi,
                                                       const uint32_t* lo,
                                                       int g) {
  return (static_cast<uint64_t>(hi[g]) << 32) | lo[g];
}

template <typename K>
__device__ __forceinline__ void store_key(uint32_t* hi, uint32_t* lo, int i,
                                          K v) {
  lo[i] = static_cast<uint32_t>(v);
  if constexpr (sizeof(K) == 8) hi[i] = static_cast<uint32_t>(v >> 32);
}

// Compare-exchange of keys i and i + j in a bitonic block of size k:
// ascending where bit log2(k) of the global index is clear.
template <typename K>
__device__ __forceinline__ void cmpx(K* s, int i, int j, bool ascending) {
  const K a = s[i];
  const K b = s[i + j];
  if ((a > b) == ascending) {
    s[i] = b;
    s[i + j] = a;
  }
}

// Index of the lower key of pair p at stride j (a power of two): insert a
// zero at bit log2(j) of p.
__device__ __forceinline__ int pair_lo(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// Stages of size k at strides j0, j0/2, ..., 1 on a tile in shared memory
// whose first key has global index base.
template <typename K>
__device__ void tile_stages(K* s, int tile, int base, int k, int j0) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int i = pair_lo(p, j);
      cmpx(s, i, j, ((base + i) & k) == 0);
    }
    __syncthreads();
  }
}

// Loads a tile (padding with the fill key), sorts it in alternating
// directions (bitonic sizes 2 .. tile), and stores it to work.
template <typename K>
__global__ void sort_tiles(const uint32_t* hi, const uint32_t* lo, int n,
                           int tile, K* work) {
  __shared__ K s[KeyOf<K>::kTile];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int g = base + i;
    s[i] = g < n ? load_key<K>(hi, lo, g) : KeyOf<K>::kFill;
  }
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) tile_stages(s, tile, base, k, k >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) work[base + i] = s[i];
}

// One global stage: size k, stride j >= tile; one pair per thread. With
// `total`, stages and pairs past the sorted prefix (sort_prefix) do
// nothing.
template <typename K>
__global__ void merge_global(K* work, int n_pad, int k, int j,
                             const int32_t* total) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pad / 2) return;
  const int i = pair_lo(p, j);
  const int prefix = sort_prefix(total, n_pad);
  if (k > prefix || i >= prefix) return;
  cmpx(work, i, j, (i & k) == 0);
}

// The strides below the tile of a size-k merge, in shared memory.
template <typename K>
__global__ void merge_tile(K* work, int n_pad, int tile, int k,
                           const int32_t* total) {
  __shared__ K s[KeyOf<K>::kTile];
  const int base = blockIdx.x * tile;
  const int prefix = sort_prefix(total, n_pad);
  if (k > prefix || base >= prefix) return;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = work[base + i];
  __syncthreads();
  tile_stages(s, tile, base, k, tile >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) work[base + i] = s[i];
}

// The merges of a bitonic sort whose tiles are sorted in alternating
// directions: sizes 2 * tile .. n_pad.
// Returns the kernels it launched.
template <typename K>
int merge_all(K* work, int n_pad, int tile, const int32_t* total,
              cudaStream_t st) {
  const int tiles = n_pad / tile;
  const int pair_blocks = (n_pad / 2 + kThreads - 1) / kThreads;
  int launched = 0;
  for (int k = 2 * tile; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      merge_global<K><<<pair_blocks, kThreads, 0, st>>>(work, n_pad, k, j,
                                                        total);
      ++launched;
    }
    merge_tile<K><<<tiles, kThreads, 0, st>>>(work, n_pad, tile, k, total);
    ++launched;
  }
  return launched;
}

// Sorts work[0 .. n_pad) ascending, loading it from (hi,) lo.
template <typename K>
void bitonic_sort(const uint32_t* hi, const uint32_t* lo, int n, int n_pad,
                  K* work, cudaStream_t st) {
  const int tile = n_pad < KeyOf<K>::kTile ? n_pad : KeyOf<K>::kTile;
  sort_tiles<K><<<n_pad / tile, kThreads, 0, st>>>(hi, lo, n, tile, work);
  merge_all<K>(work, n_pad, tile, nullptr, st);
}

// Sorts the tiles of work in place, in alternating directions; with
// `total`, only the tiles of the sorted prefix.
template <typename K>
__global__ void sort_tiles_work(K* work, int n_pad, int tile,
                                const int32_t* total) {
  __shared__ K s[KeyOf<K>::kTile];
  const int base = blockIdx.x * tile;
  if (base >= sort_prefix(total, n_pad)) return;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = work[base + i];
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) tile_stages(s, tile, base, k, k >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) work[base + i] = s[i];
}

// Sorts work[0 .. n_pad) in place (with `total`: its padded prefix).
// Returns the kernels it launched.
template <typename K>
int bitonic_sort_work(K* work, int n_pad, const int32_t* total,
                      cudaStream_t st) {
  const int tile = n_pad < KeyOf<K>::kTile ? n_pad : KeyOf<K>::kTile;
  sort_tiles_work<K><<<n_pad / tile, kThreads, 0, st>>>(work, n_pad, tile,
                                                        total);
  return 1 + merge_all<K>(work, n_pad, tile, total, st);
}

// N inclusive scans over the block at once, of v[0 .. N) (blockDim.x a
// multiple of 32, at most 1024); `sums` is N x 32 ints of shared memory.
// Ends synchronised.
template <int N>
__device__ void block_inclusive_scans(int (&v)[N], int (*sums)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, v[k], d);
      if (lane >= d) v[k] += u;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int k = 0; k < N; ++k) sums[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int w[N];
#pragma unroll
    for (int k = 0; k < N; ++k) w[k] = lane < n_warps ? sums[k][lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, w[k], d);
        if (lane >= d) w[k] += u;
      }
    }
    if (lane < n_warps) {
#pragma unroll
      for (int k = 0; k < N; ++k) sums[k][lane] = w[k];
    }
  }
  __syncthreads();
  if (warp > 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += sums[k][warp - 1];
  }
  __syncthreads();
}

// One inclusive scan over the block; `warp_sums` is 32 ints of shared
// memory. Ends synchronised.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  int a[1] = {v};
  block_inclusive_scans<1>(a, reinterpret_cast<int(*)[32]>(warp_sums));
  return a[0];
}

// One block: blocks[0 .. n_blocks) -> exclusive offsets; blocks[n_blocks]
// = total; flags = {min(total, cap), total > cap}.
__global__ void count_scan(int32_t* blocks, int n_blocks, int cap,
                           int32_t* flags) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int b0 = 0; b0 < n_blocks; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int v = b < n_blocks ? blocks[b] : 0;
    const int inc = block_inclusive_scan(v, warp_sums);
    const int c = carry;
    if (b < n_blocks) blocks[b] = c + inc - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = c + inc;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    blocks[n_blocks] = carry;
    flags[0] = carry < cap ? carry : cap;
    flags[1] = carry > cap ? 1 : 0;
  }
}

// out = s[0 .. cap); count = min(keys other than the fill key, cap). The
// keys are sorted and the fill key is the largest, so the other keys are a
// prefix and exactly one thread sees its end.
template <typename K>
__global__ void compact_finish(const K* s, int n_pad, int cap,
                               uint32_t* out_hi, uint32_t* out_lo,
                               int32_t* count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  if (i < cap) store_key(out_hi, out_lo, i, s[i]);
  const bool live = s[i] != KeyOf<K>::kFill;
  int total = -1;
  if (live && (i + 1 == n_pad || s[i + 1] == KeyOf<K>::kFill)) total = i + 1;
  if (i == 0 && !live) total = 0;
  if (total >= 0) *count = total < cap ? total : cap;
}

// --- the dedup path: live keys, LSD radix sort, fused dedup ------------

constexpr int kDigits = 256;            // 8-bit digits
constexpr int kRThreads = 256;          // one thread per digit in a pass
constexpr int kRPer = 8;                // keys per thread
constexpr int kRTile = kRThreads * kRPer;
constexpr int kRWarps = kRThreads / 32;
constexpr int kDedupMaxN = 1 << 21;     // psort.DEDUP_MAX_N
// A look-back status word: the writer's epoch in bits 28..31 (the digit
// passes share one array, zeroed once per call, so a word of an earlier
// pass reads as not yet published), a flag in bits 26..27 (the tile's own
// count, or the inclusive prefix through it) and the count below.
constexpr uint32_t kEpochMask = 0xF0000000u;
constexpr uint32_t kAggregate = 1u << 26;
constexpr uint32_t kPrefix = 2u << 26;
constexpr uint32_t kCountMask = (1u << 26) - 1;

// The dedup's int32 scratch: a part zeroed per call (the live count, the
// load's done counter, one tile ticket per launch after the load, every
// digit's histogram, the passes' and the finish's status words), then the
// plan that the load's last block writes (each digit's bucket bases, the
// buffer each pass reads or -1 for a skipped pass, the buffer the finish
// reads, the live count).
struct Layout {
  int passes, tiles;
  static constexpr int kLive = 0, kDone = 1, kTicket = 2;
  __host__ __device__ Layout(int key_bytes, int n)
      : passes(key_bytes), tiles((n + kRTile - 1) / kRTile) {}
  __host__ __device__ int hist() const { return kTicket + 16; }
  __host__ __device__ int status() const { return hist() + passes * kDigits; }
  __host__ __device__ int status_finish() const {
    return status() + tiles * kDigits;
  }
  __host__ __device__ int zeroed() const { return status_finish() + tiles; }
  __host__ __device__ int base() const { return zeroed(); }
  __host__ __device__ int src() const { return base() + passes * kDigits; }
  __host__ __device__ int live() const { return src() + passes + 1; }
  __host__ __device__ int words() const { return live() + 1; }
};

__device__ __forceinline__ uint32_t ld_relaxed(const void* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(void* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Decoupled look-back of tile `tile`'s count c in column `col` of a status
// array with `cols` columns: publishes c, adds the earlier tiles' counts
// back to the first published prefix, publishes the inclusive prefix and
// returns the exclusive one. It reads kLook earlier tiles' words at once
// and resumes at the first one not yet published. Tiles are taken in
// ticket order, so every earlier tile is running and publishes without
// waiting on this one.
constexpr int kLook = 8;
__device__ int lookback(uint32_t* status, int cols, int col, int tile,
                        uint32_t epoch, int c) {
  uint32_t* mine = status + static_cast<size_t>(tile) * cols + col;
  if (tile == 0) {
    st_relaxed(mine, epoch | kPrefix | static_cast<uint32_t>(c));
    return 0;
  }
  st_relaxed(mine, epoch | kAggregate | static_cast<uint32_t>(c));
  int excl = 0;
  int b = tile - 1;
  for (;;) {
    uint32_t w[kLook];
#pragma unroll
    for (int i = 0; i < kLook; ++i) {
      w[i] = b - i >= 0
                 ? ld_relaxed(status + static_cast<size_t>(b - i) * cols + col)
                 : 0u;
    }
    bool done = false;
    int i = 0;
    for (; i < kLook && !done; ++i) {
      if ((w[i] & kEpochMask) != epoch) break;  // reread from here
      excl += static_cast<int>(w[i] & kCountMask);
      done = (w[i] & kPrefix) != 0;
    }
    if (done) break;
    b -= i;
  }
  st_relaxed(mine, epoch | kPrefix | static_cast<uint32_t>(excl + c));
  return excl;
}

// Digit p of a key.
template <typename K>
__device__ __forceinline__ int digit(K v, int p) {
  return static_cast<int>((v >> (8 * p)) & 0xFF);
}

// Launch 1. Folds ~valid into the flag, writes the live keys to live[0 ..
// total) in any order, adds every digit's histogram of them, fills
// out[0 .. cap) with the fill key; the last block to finish plans the
// passes. The grid covers max(n, cap) keys.
template <typename K>
__global__ void __launch_bounds__(kRThreads)
    dedup_load(const uint32_t* hi, const uint32_t* lo, const uint8_t* valid,
               int n, int cap, Layout L, int32_t* scr, K* live,
               uint32_t* out_hi, uint32_t* out_lo, int32_t* flags) {
  constexpr int P = sizeof(K);
  __shared__ int hist[P * kDigits];
  __shared__ int sums[P][32];
  __shared__ int base;
  __shared__ bool last;
  __shared__ unsigned one_bucket;  // bit p: digit p has one bucket
  for (int i = threadIdx.x; i < P * kDigits; i += kRThreads) hist[i] = 0;
  if (threadIdx.x == 0) one_bucket = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // All loads first, so that they are in flight together.
  K v[kRPer];
  bool live_j[kRPer];
#pragma unroll
  for (int j = 0; j < kRPer; ++j) {
    const int g = blockIdx.x * kRTile + j * kRThreads + threadIdx.x;
    v[j] = K(0);
    live_j[j] = false;
    if (g < n) {
      v[j] = load_key<K>(hi, lo, g);
      live_j[j] = valid[g] != 0;
    }
    if (g < cap) store_key(out_hi, out_lo, g, KeyOf<K>::kFill);
  }
  unsigned mine = 0;  // bit j: key j is live
#pragma unroll
  for (int j = 0; j < kRPer; ++j) {
    const bool ok = live_j[j] && (v[j] & KeyOf<K>::kInvalid) == 0;
    const unsigned act = __ballot_sync(0xFFFFFFFFu, ok);
    if (ok) {
      mine |= 1u << j;
      // One shared atomic per distinct digit of the warp: the high digits
      // of a band's keys are mostly equal.
      for (int p = 0; p < P; ++p) {
        const int d = digit(v[j], p);
        const unsigned peers = __match_any_sync(act, d);
        if (lane == __ffs(peers) - 1) {
          atomicAdd(&hist[p * kDigits + d], __popc(peers));
        }
      }
    }
  }
  const int c = __popc(mine);
  const int inc = block_inclusive_scan(c, sums[0]);
  if (threadIdx.x == kRThreads - 1) {
    base = atomicAdd(&scr[Layout::kLive], inc);
  }
  __syncthreads();
  int o = base + inc - c;
  for (int j = 0; j < kRPer; ++j) {
    if ((mine >> j) & 1u) live[o++] = v[j];
  }
  for (int i = threadIdx.x; i < P * kDigits; i += kRThreads) {
    if (hist[i] != 0) atomicAdd(&scr[L.hist() + i], hist[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&scr[Layout::kDone], 1) ==
           static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Every block's counts are in. Thread t is bucket t of every digit.
  const int total = static_cast<int>(ld_relaxed(&scr[Layout::kLive]));
  int h[P], e[P];
  unsigned one = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    h[p] = static_cast<int>(
        ld_relaxed(&scr[L.hist() + p * kDigits + threadIdx.x]));
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    e[p] = h[p];
    if (h[p] == total) one |= 1u << p;
  }
  if (one != 0) atomicOr(&one_bucket, one);
  block_inclusive_scans<P>(e, sums);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    scr[L.base() + p * kDigits + threadIdx.x] = e[p] - h[p];
  }
  if (threadIdx.x == 0) {
    int src = 0;
    for (int p = 0; p < P; ++p) {
      const bool skip = (one_bucket >> p) & 1u;
      scr[L.src() + p] = skip ? -1 : src;
      if (!skip) src ^= 1;
    }
    scr[L.src() + P] = src;
    scr[L.live()] = total;
    flags[0] = 0;  // the finish overwrites them when a key is live
    flags[1] = 0;
  }
}

// One LSD pass over digit p: buf[src] -> buf[src ^ 1], stable.
template <typename K>
__global__ void __launch_bounds__(kRThreads)
    radix_pass(K* buf0, K* buf1, int p, Layout L, int32_t* scr) {
  static_assert(kRThreads == kDigits, "one thread per digit");
  __shared__ int whist[kRWarps][kDigits];
  __shared__ K keys[kRTile];
  __shared__ int loc[kDigits];
  __shared__ int glob[kDigits];
  __shared__ int warp_sums[32];
  __shared__ int ticket;
  const int src = scr[L.src() + p];
  if (src < 0) return;  // every live key has one digit here
  if (threadIdx.x == 0) ticket = atomicAdd(&scr[Layout::kTicket + p], 1);
  const int total = scr[L.live()];
  const int bucket_base = scr[L.base() + p * kDigits + threadIdx.x];
  for (int i = threadIdx.x; i < kRWarps * kDigits; i += kRThreads) {
    (&whist[0][0])[i] = 0;
  }
  __syncthreads();
  const int tile = ticket;
  const int t0 = tile * kRTile;
  if (t0 >= total) return;
  const K* in = src ? buf1 : buf0;
  K* out = src ? buf0 : buf1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  // Warp w ranks keys t0 + [w * 32 * kRPer, (w + 1) * 32 * kRPer), 32 at a
  // time in index order: a key's rank among its warp's keys of its digit
  // is the digit's running count plus its peers in lower lanes.
  K v[kRPer];
  int d[kRPer], r[kRPer];
#pragma unroll
  for (int j = 0; j < kRPer; ++j) {
    const int g = t0 + (warp * kRPer + j) * 32 + lane;
    v[j] = g < total ? in[g] : K(0);
  }
#pragma unroll
  for (int j = 0; j < kRPer; ++j) {
    const int g = t0 + (warp * kRPer + j) * 32 + lane;
    const bool ok = g < total;
    d[j] = ok ? digit(v[j], p) : -1;
    r[j] = 0;
    const unsigned act = __ballot_sync(0xFFFFFFFFu, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(act, d[j]);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader) {
        before = whist[warp][d[j]];
        whist[warp][d[j]] = before + __popc(peers);
      }
      r[j] = __shfl_sync(peers, before, leader) + __popc(peers & below);
    }
    __syncwarp();
  }
  __syncthreads();
  // Thread t owns digit t: the warps' exclusive offsets, the tile's count,
  // its offset in the tile and, by look-back, among the earlier tiles.
  const int t = threadIdx.x;
  int count = 0;
  for (int w = 0; w < kRWarps; ++w) {
    const int c = whist[w][t];
    whist[w][t] = count;
    count += c;
  }
  const int inc = block_inclusive_scan(count, warp_sums);
  loc[t] = inc - count;
  const int before = lookback(reinterpret_cast<uint32_t*>(scr + L.status()),
                              kDigits, t, tile,
                              static_cast<uint32_t>(p + 1) << 28, count);
  glob[t] = bucket_base + before - loc[t];
  __syncthreads();
  for (int j = 0; j < kRPer; ++j) {
    if (d[j] >= 0) keys[loc[d[j]] + whist[warp][d[j]] + r[j]] = v[j];
  }
  __syncthreads();
  // The tile in digit order: runs of one digit go to consecutive places.
  const int m = min(kRTile, total - t0);
  for (int i = threadIdx.x; i < m; i += kRThreads) {
    const K k = keys[i];
    out[glob[digit(k, p)] + i] = k;
  }
}

// The last launch: first-of-run survivors of the sorted live keys to
// out[rank] for rank < cap, and the flags.
template <typename K>
__global__ void __launch_bounds__(kRThreads)
    dedup_finish(const K* buf0, const K* buf1, int cap, Layout L,
                 int32_t* scr, uint32_t* out_hi, uint32_t* out_lo,
                 int32_t* flags) {
  constexpr int P = sizeof(K);
  __shared__ K keys[kRTile + 1];
  __shared__ int wsum[kRWarps];
  __shared__ int ticket;
  __shared__ int prefix;
  if (threadIdx.x == 0) ticket = atomicAdd(&scr[Layout::kTicket + P], 1);
  const int total = scr[L.live()];
  const K* s = scr[L.src() + P] ? buf1 : buf0;
  __syncthreads();
  const int tile = ticket;
  const int t0 = tile * kRTile;
  if (t0 >= total) return;
  const int m = min(kRTile, total - t0);
  // keys[i + 1] = s[t0 + i]; keys[0] is its predecessor, or the fill key
  // (which no live key equals) before the first.
#pragma unroll
  for (int j = 0; j <= kRPer; ++j) {
    const int i = j * kRThreads + threadIdx.x;
    if (i <= m) {
      keys[i] = (tile == 0 && i == 0) ? KeyOf<K>::kFill : s[t0 + i - 1];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  unsigned kept[kRPer];
  int wc = 0;
  for (int j = 0; j < kRPer; ++j) {
    const int i = (warp * kRPer + j) * 32 + lane;
    kept[j] = __ballot_sync(0xFFFFFFFFu, i < m && keys[i + 1] != keys[i]);
    wc += __popc(kept[j]);
  }
  if (lane == 0) wsum[warp] = wc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kRWarps; ++w) {
      const int c = wsum[w];
      wsum[w] = sum;
      sum += c;
    }
    prefix = lookback(reinterpret_cast<uint32_t*>(scr + L.status_finish()),
                      1, 0, tile, 1u << 28, sum);
    if (t0 + m == total) {
      const int all = prefix + sum;
      flags[0] = all < cap ? all : cap;
      flags[1] = all > cap ? 1 : 0;
    }
  }
  __syncthreads();
  int rank = prefix + wsum[warp];
  for (int j = 0; j < kRPer; ++j) {
    const int i = (warp * kRPer + j) * 32 + lane;
    if ((kept[j] >> lane) & 1u) {
      const int k = rank + __popc(kept[j] & below);
      if (k < cap) store_key(out_hi, out_lo, k, keys[i + 1]);
    }
    rank += __popc(kept[j]);
  }
}

// Kernels the dedup path has launched since the library was loaded.
long long dedup_kernel_launches = 0;

template <typename K>
int dedup_launch(const void* hi, const void* lo, const void* valid, int n,
                 int cap, void* work, void* scratch, void* out_hi,
                 void* out_lo, void* flags, void* stream) {
  if (n < 1 || n > kDedupMaxN || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L(sizeof(K), n);
  int32_t* scr = static_cast<int32_t*>(scratch);
  K* b0 = static_cast<K*>(work);
  K* b1 = b0 + n;
  const cudaError_t e = cudaMemsetAsync(
      scr, 0, static_cast<size_t>(L.zeroed()) * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int load_blocks = ((n > cap ? n : cap) + kRTile - 1) / kRTile;
  dedup_load<K><<<load_blocks, kRThreads, 0, st>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const uint8_t*>(valid), n, cap, L, scr, b0,
      static_cast<uint32_t*>(out_hi), static_cast<uint32_t*>(out_lo),
      static_cast<int32_t*>(flags));
  ++dedup_kernel_launches;
  for (int p = 0; p < static_cast<int>(sizeof(K)); ++p) {
    radix_pass<K><<<L.tiles, kRThreads, 0, st>>>(b0, b1, p, L, scr);
    ++dedup_kernel_launches;
  }
  dedup_finish<K><<<L.tiles, kRThreads, 0, st>>>(
      b0, b1, cap, L, scr, static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo), static_cast<int32_t*>(flags));
  ++dedup_kernel_launches;
  return static_cast<int>(cudaGetLastError());
}

// --- dominance dedups ---------------------------------------------------
//
// The entry type E is uint64_t for single keys (group a in the high word,
// dominance word w in the low one) and U128 for pair keys (group pair in
// hi, word pair in lo). Full keys F are uint32_t and uint64_t.

template <typename E>
struct Dom;
template <>
struct Dom<uint64_t> {
  using G = uint32_t;  // group part, its bit 31 the invalid flag
  using W = uint32_t;  // dominance word
  using F = uint32_t;  // full key
  // Entry i of the word arrays (a in a_lo, w in w_lo).
  __device__ static uint64_t load(const uint32_t*, const uint32_t* a,
                                  const uint32_t*, const uint32_t* w, int i) {
    return (static_cast<uint64_t>(a[i]) << 32) | w[i];
  }
  __device__ static G group(uint64_t e) { return static_cast<G>(e >> 32); }
  __device__ static W word(uint64_t e) { return static_cast<W>(e); }
  __device__ static uint64_t fill() { return ~uint64_t(0); }
  __device__ static bool invalid(uint64_t e) { return (e >> 63) != 0; }
  __device__ static F full(uint64_t e, uint64_t cmask, uint64_t rmask) {
    const uint32_t a = group(e), w = word(e);
    return (a & 0x7FFFFFFFu) | (w & static_cast<uint32_t>(cmask)) |
           (~w & static_cast<uint32_t>(rmask));
  }
};
template <>
struct Dom<U128> {
  using G = uint64_t;
  using W = uint64_t;
  using F = uint64_t;
  __device__ static U128 load(const uint32_t* a_hi, const uint32_t* a_lo,
                              const uint32_t* w_hi, const uint32_t* w_lo,
                              int i) {
    return U128{(static_cast<uint64_t>(a_hi[i]) << 32) | a_lo[i],
                (static_cast<uint64_t>(w_hi[i]) << 32) | w_lo[i]};
  }
  __device__ static G group(const U128& e) { return e.hi; }
  __device__ static W word(const U128& e) { return e.lo; }
  __device__ static U128 fill() { return U128{~uint64_t(0), ~uint64_t(0)}; }
  __device__ static bool invalid(const U128& e) { return (e.hi >> 63) != 0; }
  __device__ static F full(const U128& e, uint64_t cmask, uint64_t rmask) {
    return (e.hi & 0x7FFFFFFFFFFFFFFFull) | (e.lo & cmask) | (~e.lo & rmask);
  }
};

// The sort's input: entry i of the word arrays, (KEY_FILL group, zero word)
// past n (the TPU kernels' padding).
__global__ void dom_load1(const uint32_t* a, const uint32_t* w, int n,
                          int n_pad, uint64_t* e) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  e[i] = i < n ? (static_cast<uint64_t>(a[i]) << 32) | w[i]
               : static_cast<uint64_t>(0xFFFFFFFFu) << 32;
}

__global__ void dom_load2(const uint32_t* a_hi, const uint32_t* a_lo,
                          const uint32_t* w_hi, const uint32_t* w_lo, int n,
                          int n_pad, U128* e) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  if (i < n) {
    e[i] = U128{(static_cast<uint64_t>(a_hi[i]) << 32) | a_lo[i],
                (static_cast<uint64_t>(w_hi[i]) << 32) | w_lo[i]};
  } else {
    e[i] = U128{~uint64_t(0), 0};
  }
}

// One prune round over the sorted entries s (with `live`: entries past
// *live are the fill): keep[i] = valid, not a duplicate of s[i - 1], and
// not dominated by its group's first entry nor by a predecessor at
// distance 1..chain in its group.
template <typename E>
__global__ void dom_prune(const E* s, int n_pad, int chain,
                          const int32_t* live, uint8_t* keep) {
  using D = Dom<E>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  const int lim = live == nullptr ? n_pad : *live;
  const E v = s[i];
  if (i >= lim || D::invalid(v) || (i > 0 && s[i - 1] == v)) {
    keep[i] = 0;
    return;
  }
  const typename D::G g = D::group(v);
  const typename D::W w = D::word(v);
  // The group's first index: the lower bound of g in s[0 .. i].
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (D::group(s[mid]) < g) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const typename D::W f = D::word(s[lo]);
  bool dom = (f & ~w) == 0 && f != w;
  for (int d = 1; d <= chain && !dom && i - d >= lo; ++d) {
    const typename D::W x = D::word(s[i - d]);
    dom = (x & ~w) == 0 && x != w;
  }
  keep[i] = dom ? 0 : 1;
}

// blocks[b] = kept entries among [b * kSeg, (b + 1) * kSeg).
__global__ void flag_count(const uint8_t* keep, int32_t* blocks) {
  const int i = blockIdx.x * kSeg + threadIdx.x;
  const int c = __syncthreads_count(keep[i] != 0);
  if (threadIdx.x == 0) blocks[blockIdx.x] = c;
}

// Order-preserving compaction: kept entries to their ranks in dst, the
// fill entry at every index past the kept count.
template <typename E>
__global__ void dom_compact(const E* s, const uint8_t* keep,
                            const int32_t* blocks, int n_blocks, E* dst) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * kSeg + threadIdx.x;
  const bool k = keep[i] != 0;
  const int rank = blocks[blockIdx.x] +
                   block_inclusive_scan(k ? 1 : 0, warp_sums) - (k ? 1 : 0);
  if (k) dst[rank] = s[i];
  if (i >= blocks[n_blocks]) dst[i] = Dom<E>::fill();
}

// The kept entries' full keys to their ranks, the fill key past them.
template <typename E>
__global__ void dom_full(const E* s, const uint8_t* keep,
                         const int32_t* blocks, int n_blocks, uint64_t cmask,
                         uint64_t rmask, typename Dom<E>::F* full) {
  using F = typename Dom<E>::F;
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * kSeg + threadIdx.x;
  const bool k = keep[i] != 0;
  const int rank = blocks[blockIdx.x] +
                   block_inclusive_scan(k ? 1 : 0, warp_sums) - (k ? 1 : 0);
  if (k) full[rank] = Dom<E>::full(s[i], cmask, rmask);
  if (i >= blocks[n_blocks]) full[i] = ~F(0);
}

// out = full[0 .. cap) as (hi,) lo words.
template <typename F>
__global__ void dom_out(const F* full, int cap, uint32_t* out_hi,
                        uint32_t* out_lo) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cap) store_key(out_hi, out_lo, i, full[i]);
}

bool bad_dom_sizes(int n, int n_pad, int cap, int chain, int rounds) {
  return n < 1 || n_pad < kMinN || n_pad > kDomMaxN ||
         (n_pad & (n_pad - 1)) || n > n_pad || cap < 1 || cap > n_pad ||
         chain < 0 || rounds < 1;
}

// Kernels launched by the dominance dedups since the library was loaded.
long long dom_kernel_launches = 0;

// The prune rounds, the full keys and their sort, after the entries are
// loaded into e0. e1 is the compaction's second buffer.
template <typename E>
int dom_finish(E* e0, E* e1, int n_pad, int cap, int chain, int rounds,
               uint64_t cmask, uint64_t rmask, uint8_t* keep, int32_t* blocks,
               typename Dom<E>::F* full, uint32_t* out_hi, uint32_t* out_lo,
               int32_t* flags, cudaStream_t st) {
  using F = typename Dom<E>::F;
  const int n_blocks = n_pad / kSeg;
  const int grid = (n_pad + kThreads - 1) / kThreads;
  const int32_t* total = blocks + n_blocks;
  dom_kernel_launches += bitonic_sort_work<E>(e0, n_pad, nullptr, st);
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) {
      dom_compact<E><<<n_blocks, kSeg, 0, st>>>(e0, keep, blocks, n_blocks,
                                                e1);
      ++dom_kernel_launches;
      E* t = e0;
      e0 = e1;
      e1 = t;
    }
    // After a compaction, the entries past the last round's count are fill.
    dom_prune<E><<<grid, kThreads, 0, st>>>(e0, n_pad, chain,
                                            r > 0 ? total : nullptr, keep);
    flag_count<<<n_blocks, kSeg, 0, st>>>(keep, blocks);
    count_scan<<<1, kThreads, 0, st>>>(blocks, n_blocks, cap, flags);
    dom_kernel_launches += 3;
  }
  dom_full<E><<<n_blocks, kSeg, 0, st>>>(e0, keep, blocks, n_blocks, cmask,
                                         rmask, full);
  dom_kernel_launches += 1 + bitonic_sort_work<F>(full, n_pad, total, st);
  dom_out<F><<<(cap + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      full, cap, out_hi, out_lo);
  ++dom_kernel_launches;
  return static_cast<int>(cudaGetLastError());
}

// --- the one-launch dominance dedup --------------------------------------
//
// One block of 1024 threads does the whole call: load the valid entries,
// sort them, run the prune rounds with an order-preserving compaction
// between them, build and sort the survivors' full keys, write the
// output and the flags. Entries and full keys live in two ping-pong
// buffers of kOneSharedBytes / 2 each in dynamic shared memory while the
// valid entries fit (kOneSharedN of them), else in two device-memory
// buffers of n entries that the wrapper sizes from n (with n / 32 keep
// words after them); the load writes entries past kOneSharedN there and
// the block copies the rest over, so the path is chosen inside the
// launch, with no host sync, and recorded in a word beside the flags.

constexpr int kOneWarps = kThreads / 32;
constexpr int kOneSharedBytes = 192 * 1024;
// Keys a block ranks by comparing each with all the others (one step),
// rather than by radix passes (7 barriers a digit).
constexpr int kRankMaxN = 128;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
// Bits of the path word.
constexpr int kOnePathShared = 1;
constexpr int kOnePathDevice = 2;

template <typename E>
struct OneOf {
  static constexpr int kSharedN =
      kOneSharedBytes / 2 / static_cast<int>(sizeof(E));
};

// The bits of a key as (hi, lo) words: entries, and u64 full keys.
struct Bits {
  uint64_t hi, lo;
};
__device__ __forceinline__ Bits bits_of(const U128& v) { return {v.hi, v.lo}; }
__device__ __forceinline__ Bits bits_of(uint64_t v) { return {0, v}; }
__device__ __forceinline__ Bits bits_of(uint32_t v) { return {0, v}; }
__device__ __forceinline__ bool operator<(const U128& a, const U128& b) {
  return b > a;
}

// The 8 key bits from bit `off` up (bits past the key read as zero).
template <typename K>
__device__ __forceinline__ int bits_digit(const K& v, int off) {
  const Bits b = bits_of(v);
  uint64_t x;
  if (off >= 64) {
    x = b.hi >> (off - 64);
  } else {
    x = b.lo >> off;
    if (off > 56) x |= b.hi << (64 - off);
  }
  return static_cast<int>(x & 0xFF);
}

// The lowest set bit of `vary` at or above bit `from`, or -1.
__device__ __forceinline__ int next_bit(Bits vary, int from) {
  if (from < 64) {
    const uint64_t lo = vary.lo >> from << from;
    if (lo) return __ffsll(static_cast<long long>(lo)) - 1;
    from = 64;
  }
  if (from >= 128) return -1;
  const uint64_t hi = vary.hi >> (from - 64) << (from - 64);
  return hi ? 63 + __ffsll(static_cast<long long>(hi)) : -1;
}

// Keys per warp when n keys are split into 32 contiguous warp ranges of
// whole 32-key steps.
__device__ __forceinline__ int one_span(int n) {
  return ((n + kThreads - 1) / kThreads) * 32;
}

// One stable LSD pass of the block over the 8-bit digit at bit `off`:
// src[0 .. n) -> dst, as psort_fused.cu's radix_pass (warp multisplit by
// __match_any_sync, warp counts scanned digit-major). Ends synchronised.
template <typename K>
__device__ void one_radix_pass(const K* src, K* dst, int n, int off,
                               int (*hist)[kDigits + 1], int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int span = one_span(n);
  const int lo = min(n, warp * span);
  const int hi = min(n, lo + span);
  for (int i = threadIdx.x; i < kOneWarps * (kDigits + 1); i += kThreads) {
    (&hist[0][0])[i] = 0;
  }
  __syncthreads();
  for (int g = lo; g < hi; g += 32) {
    const int i = g + lane;
    const bool ok = i < hi;
    const int d = ok ? bits_digit(src[i], off) : -1;
    const unsigned act = __ballot_sync(kFullMask, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(act, d);
      if (lane == __ffs(peers) - 1) hist[warp][d] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  {
    // Thread t owns entries 8t .. 8t + 7 of the digit-major order
    // e = d * 32 + w: digit t / 4, warps (t % 4) * 8 .. + 7.
    const int d = threadIdx.x >> 2;
    const int w0 = (threadIdx.x & 3) * 8;
    int c[8];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[k] = hist[w0 + k][d];
      sum += c[k];
    }
    int at = block_inclusive_scan(sum, warp_sums) - sum;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      hist[w0 + k][d] = at;
      at += c[k];
    }
  }
  __syncthreads();
  for (int g = lo; g < hi; g += 32) {
    const int i = g + lane;
    const bool ok = i < hi;
    const K v = ok ? src[i] : K{};
    const int d = ok ? bits_digit(v, off) : -1;
    const unsigned act = __ballot_sync(kFullMask, ok);
    if (ok) {
      const unsigned peers = __match_any_sync(act, d);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader) {
        before = hist[warp][d];
        hist[warp][d] = before + __popc(peers);
      }
      dst[__shfl_sync(peers, before, leader) + __popc(peers & below)] = v;
    }
    __syncwarp();
  }
  __syncthreads();
}

// The block's OR and AND of its threads' (hi, lo) words into s_or/s_and
// (set to 0 and ~0 before a barrier that precedes this). Ends
// synchronised.
__device__ __forceinline__ void block_or_and(Bits o, Bits a,
                                             unsigned long long* s_or,
                                             unsigned long long* s_and) {
  const uint64_t ow[2] = {o.hi, o.lo}, aw[2] = {a.hi, a.lo};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t o0 =
        __reduce_or_sync(kFullMask, static_cast<uint32_t>(ow[k]));
    const uint32_t o1 =
        __reduce_or_sync(kFullMask, static_cast<uint32_t>(ow[k] >> 32));
    const uint32_t a0 =
        __reduce_and_sync(kFullMask, static_cast<uint32_t>(aw[k]));
    const uint32_t a1 =
        __reduce_and_sync(kFullMask, static_cast<uint32_t>(aw[k] >> 32));
    if ((threadIdx.x & 31) == 0) {
      atomicOr(&s_or[k], (static_cast<unsigned long long>(o1) << 32) | o0);
      atomicAnd(&s_and[k], (static_cast<unsigned long long>(a1) << 32) | a0);
    }
  }
  __syncthreads();
}

// Sorts src[0 .. n) ascending, the bits that differ among the keys
// being `vary`: by rank for a few keys, else by LSD passes over the 8-bit
// windows that cover the varying bits (each window starts at the lowest
// varying bit not yet covered). Returns the buffer holding the result
// (src or dst). Ends synchronised.
template <typename K>
__device__ K* one_sort(K* src, K* dst, int n, Bits vary,
                       int (*hist)[kDigits + 1], int* warp_sums) {
  if (n <= 1) return src;
  if (n <= kRankMaxN) {
    // A key's rank: the keys below it, and its equals at lower indices.
    const int i = threadIdx.x;
    if (i < n) {
      const K v = src[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) {
        const K u = src[j];
        rank += (u < v) || (j < i && u == v);
      }
      dst[rank] = v;
    }
    __syncthreads();
    return dst;
  }
  for (int off = next_bit(vary, 0); off >= 0; off = next_bit(vary, off + 8)) {
    one_radix_pass(src, dst, n, off, hist, warp_sums);
    K* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Keep-or-drop of sorted entry i (all valid): a duplicate of its
// predecessor, or dominated by its group's first entry (binary search)
// or by a predecessor at distance 1..chain in its group, is dropped.
template <typename E>
__device__ __forceinline__ bool one_keep(const E* s, int i, int chain) {
  using D = Dom<E>;
  const E v = s[i];
  if (i > 0 && s[i - 1] == v) return false;
  const typename D::G g = D::group(v);
  const typename D::W w = D::word(v);
  int lo = 0, hi = i;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (D::group(s[mid]) < g) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const typename D::W f = D::word(s[lo]);
  bool dom = (f & ~w) == 0 && f != w;
  for (int d = 1; d <= chain && !dom && i - d >= lo; ++d) {
    const typename D::W x = D::word(s[i - d]);
    dom = (x & ~w) == 0 && x != w;
  }
  return !dom;
}

template <typename E>
__device__ __forceinline__ void one_put(E* shared, E* spill, int i, E v) {
  if (i < OneOf<E>::kSharedN) {
    shared[i] = v;
  } else {
    spill[i] = v;
  }
}

// One block per SM: every thread may take 64 registers. scratch: two
// buffers of n entries and n / 32 + 1 keep words when n exceeds
// OneOf<E>::kSharedN, else unused.
template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
    dom_one_kernel(const uint32_t* a_hi, const uint32_t* a_lo,
                   const uint32_t* w_hi, const uint32_t* w_lo, int n,
                   int cap, int chain, int rounds, uint64_t cmask,
                   uint64_t rmask, uint32_t* out_hi, uint32_t* out_lo,
                   int32_t* flags, E* scratch) {
  using D = Dom<E>;
  using F = typename D::F;
  constexpr int S = OneOf<E>::kSharedN;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  __shared__ int hist[kOneWarps][kDigits + 1];
  __shared__ int warp_sums[32];
  __shared__ int s_live;
  __shared__ unsigned long long s_or[2], s_and[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  E* A = reinterpret_cast<E*>(dyn_raw);
  E* B = A + S;
  E* GA = scratch;
  E* GB = scratch + n;
  if (tid == 0) {
    s_live = 0;
    s_or[0] = s_or[1] = 0ull;
    s_and[0] = s_and[1] = ~0ull;
  }
  __syncthreads();

  // 1. the valid entries, in any order (the sort orders them), placed by
  // a warp ballot and one shared atomicAdd per warp.
  Bits o{0, 0}, a{~0ull, ~0ull};
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    E v{};
    bool on = false;
    if (i < n) {
      v = D::load(a_hi, a_lo, w_hi, w_lo, i);
      on = !D::invalid(v);
    }
    const unsigned m = __ballot_sync(kFullMask, on);
    if (m == 0u) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(&s_live, __popc(m));
    at = __shfl_sync(kFullMask, at, 0) + __popc(m & below);
    if (on) {
      one_put(A, GA, at, v);
      const Bits b = bits_of(v);
      o.hi |= b.hi;
      o.lo |= b.lo;
      a.hi &= b.hi;
      a.lo &= b.lo;
    }
  }
  block_or_and(o, a, s_or, s_and);
  int live = s_live;
  E* src = A;
  E* dst = B;
  // Keep words: the histograms while the entries fit in shared memory.
  uint32_t* kw = reinterpret_cast<uint32_t*>(&hist[0][0]);
  int path = kOnePathShared;
  if (live > S) {
    for (int i = tid; i < S; i += kThreads) GA[i] = A[i];
    src = GA;
    dst = GB;
    kw = reinterpret_cast<uint32_t*>(GB + n);
    path = kOnePathDevice;
    __syncthreads();
  }

  // 2. the sort of the entries.
  {
    const Bits vary{s_or[0] ^ s_and[0], s_or[1] ^ s_and[1]};
    E* out = one_sort(src, dst, live, vary, hist, warp_sums);
    if (out != src) {
      dst = src;
      src = out;
    }
  }

  // 3. the prune rounds; the last writes the survivors' full keys.
  F* full = reinterpret_cast<F*>(dst);
  int total = 0;
  Bits fo{0, 0}, fa{~0ull, ~0ull};
  for (int r = 0; r < rounds; ++r) {
    const int span = one_span(live);
    const int lo = min(live, warp * span);
    const int hi = min(live, lo + span);
    int wc = 0;
    for (int g = lo; g < hi; g += 32) {
      const int i = g + lane;
      const unsigned m =
          __ballot_sync(kFullMask, i < hi && one_keep(src, i, chain));
      if (lane == 0) kw[g >> 5] = m;
      wc += __popc(m);
    }
    if (lane == 0) warp_sums[warp] = wc;
    __syncthreads();
    if (warp == 0) {
      int v = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFullMask, v, d);
        if (lane >= d) v += u;
      }
      warp_sums[lane] = v;
    }
    if (r + 1 == rounds && tid == 0) {
      s_or[0] = s_or[1] = 0ull;
      s_and[0] = s_and[1] = ~0ull;
    }
    __syncthreads();
    total = warp_sums[31];
    int rank = warp > 0 ? warp_sums[warp - 1] : 0;
    for (int g = lo; g < hi; g += 32) {
      const int i = g + lane;
      const unsigned m = kw[g >> 5];
      if ((m >> lane) & 1u) {
        const int k = rank + __popc(m & below);
        if (r + 1 < rounds) {
          dst[k] = src[i];
        } else {
          const F f = D::full(src[i], cmask, rmask);
          full[k] = f;
          const Bits b = bits_of(f);
          fo.lo |= b.lo;
          fa.lo &= b.lo;
        }
      }
      rank += __popc(m);
    }
    if (r + 1 < rounds) {
      __syncthreads();
      E* t = src;
      src = dst;
      dst = t;
      full = reinterpret_cast<F*>(dst);
      live = total;
    }
  }
  fa.hi = 0;
  block_or_and(fo, fa, s_or, s_and);

  // 4. the full keys' sort and the output.
  const Bits fvary{0, s_or[1] ^ s_and[1]};
  const F* sorted =
      one_sort(full, reinterpret_cast<F*>(src), total, fvary, hist, warp_sums);
  for (int i = tid; i < cap; i += kThreads) {
    store_key(out_hi, out_lo, i, i < total ? sorted[i] : ~F(0));
  }
  if (tid == 0) {
    flags[0] = total < cap ? total : cap;
    flags[1] = total > cap ? 1 : 0;
    flags[2] = path;
  }
}

template <typename E>
int dom_one_launch(const uint32_t* a_hi, const uint32_t* a_lo,
                   const uint32_t* w_hi, const uint32_t* w_lo, int n, int cap,
                   int chain, int rounds, uint64_t cmask, uint64_t rmask,
                   uint32_t* out_hi, uint32_t* out_lo, int32_t* flags,
                   void* scratch, cudaStream_t st) {
  if (n > OneOf<E>::kSharedN && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      dom_one_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOneSharedBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dom_one_kernel<E><<<1, kThreads, kOneSharedBytes, st>>>(
      a_hi, a_lo, w_hi, w_lo, n, cap, chain, rounds, cmask, rmask, out_hi,
      out_lo, flags, static_cast<E*>(scratch));
  ++dom_kernel_launches;
  return static_cast<int>(cudaGetLastError());
}

// --- the one-launch order-keeping compaction -----------------------------

// Keys a lane loads at once in the compaction's sweeps.
constexpr int kCompactPer = 8;
// The largest n the one-launch compaction takes (psort.DEDUP_MAX_N, past
// the engine's spike compactions of 2^20 pairs).
constexpr int kCompactOneMaxN = 1 << 21;
// The path word's value on the order-keeping path (beside
// kOnePathShared and kOnePathDevice for a sort).
constexpr int kOnePathOrdered = 4;

// A key of lane `src` (of the lane d below, for shfl_up_key): one 32-bit
// shuffle for single keys, the 64-bit shuffle (two) for pairs.
template <typename K>
__device__ __forceinline__ K shfl_key(K v, int src) {
  if constexpr (sizeof(K) == 4) {
    return __shfl_sync(kFullMask, v, src);
  } else {
    return static_cast<K>(
        __shfl_sync(kFullMask, static_cast<unsigned long long>(v), src));
  }
}
template <typename K>
__device__ __forceinline__ K shfl_up_key(K v, int d) {
  if constexpr (sizeof(K) == 4) {
    return __shfl_up_sync(kFullMask, v, d);
  } else {
    return static_cast<K>(
        __shfl_up_sync(kFullMask, static_cast<unsigned long long>(v), d));
  }
}

// The largest of the keys of lanes at or below this one.
template <typename K>
__device__ __forceinline__ K warp_inclusive_max(K v) {
  const int lane = threadIdx.x & 31;
  for (int d = 1; d < 32; d <<= 1) {
    const K u = shfl_up_key(v, d);
    if (lane >= d && v < u) v = u;
  }
  return v;
}

// A warp's step of the compaction's sweeps: lane l's key u is key g + 32 u
// + l, the fill key at or past `end`.
template <typename K>
__device__ __forceinline__ void compact_step(const uint32_t* key_hi,
                                             const uint32_t* key_lo, int g,
                                             int end, K (&v)[kCompactPer]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kCompactPer; ++u) {
    const int i = g + u * 32 + lane;
    v[u] = i < end ? load_key<K>(key_hi, key_lo, i) : KeyOf<K>::kFill;
  }
}

// out[0 .. cap) = the keys sorted (the fill key last), words = {min(live,
// cap), path}, where live counts the keys other than the fill key. One
// block; scratch: 2 n keys when n exceeds OneOf<K>::kSharedN, else unused.
template <typename K>
__global__ void __launch_bounds__(kThreads, 1)
    compact_one_kernel(const uint32_t* key_hi, const uint32_t* key_lo, int n,
                       int cap, uint32_t* out_hi, uint32_t* out_lo,
                       int32_t* words, K* scratch) {
  constexpr int S = OneOf<K>::kSharedN;
  constexpr int kStep = 32 * kCompactPer;
  constexpr K kFill = KeyOf<K>::kFill;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  __shared__ int hist[kOneWarps][kDigits + 1];
  __shared__ int warp_sums[32];
  __shared__ K s_first[kOneWarps], s_last[kOneWarps];
  __shared__ int s_total, s_down;
  __shared__ unsigned long long s_or[2], s_and[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (tid == 0) {
    s_down = 0;
    s_or[0] = s_or[1] = 0ull;
    s_and[0] = s_and[1] = ~0ull;
  }
  // Warp w sweeps [lo, hi) in steps of kStep keys, kCompactPer a lane.
  const int span = (n + kOneWarps * kStep - 1) / (kOneWarps * kStep) * kStep;
  const int lo = min(n, warp * span);
  const int hi = min(n, lo + span);
  __syncthreads();

  // 1. live counts, first and last live keys, descents, OR and AND.
  int cnt = 0;
  K first = K(0), last = K(0);
  bool down = false;
  Bits o{0, 0}, a{~0ull, ~0ull};
  for (int g = lo; g < hi; g += kStep) {
    K v[kCompactPer];
    compact_step(key_hi, key_lo, g, hi, v);
#pragma unroll
    for (int u = 0; u < kCompactPer; ++u) {
      const bool live = v[u] != kFill;
      const unsigned m = __ballot_sync(kFullMask, live);
      if (m == 0u) continue;
      // The live key before this lane's: the nearest live lower lane's,
      // else the warp's last live key so far.
      const unsigned lower = m & below;
      const K prev = shfl_key(v[u], lower ? 31 - __clz(lower) : lane);
      if (live) {
        if (lower) {
          down |= v[u] < prev;
        } else if (cnt > 0) {
          down |= v[u] < last;
        }
        const Bits b = bits_of(v[u]);
        o.hi |= b.hi;
        o.lo |= b.lo;
        a.hi &= b.hi;
        a.lo &= b.lo;
      }
      if (cnt == 0) first = shfl_key(v[u], __ffs(m) - 1);
      last = shfl_key(v[u], 31 - __clz(m));
      cnt += __popc(m);
    }
  }
  if (__any_sync(kFullMask, down) && lane == 0) s_down = 1;
  if (lane == 0) {
    warp_sums[warp] = cnt;
    s_first[warp] = first;
    s_last[warp] = last;
  }
  block_or_and(o, a, s_or, s_and);
  // The warps' offsets, the total, and the descents between warps: a
  // warp's first live key below the largest last live key of the warps
  // before it.
  if (warp == 0) {
    const int c = warp_sums[lane];
    int inc = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFullMask, inc, d);
      if (lane >= d) inc += u;
    }
    const K upto = warp_inclusive_max(c > 0 ? s_last[lane] : K(0));
    const K before = shfl_up_key(upto, 1);
    const bool cross = lane > 0 && c > 0 && s_first[lane] < before;
    warp_sums[lane] = inc - c;
    if (lane == 31) s_total = inc;
    if (__any_sync(kFullMask, cross) && lane == 0) s_down = 1;
  }
  __syncthreads();
  const int total = s_total;
  const int count = total < cap ? total : cap;

  // 2. the live keys in order: with no descent the first cap of them to
  // out, the fill key after them; else every one into a buffer to sort.
  const bool ordered = s_down == 0;
  const bool fits = total <= S;
  K* src = fits ? reinterpret_cast<K*>(dyn_raw) : scratch;
  K* dst = fits ? src + S : scratch + n;
  const int limit = ordered ? cap : total;
  int at = warp_sums[warp];
  for (int g = lo; g < hi && at < limit; g += kStep) {
    K v[kCompactPer];
    compact_step(key_hi, key_lo, g, hi, v);
#pragma unroll
    for (int u = 0; u < kCompactPer; ++u) {
      const bool live = v[u] != kFill;
      const unsigned m = __ballot_sync(kFullMask, live);
      const int k = at + __popc(m & below);
      if (live && k < limit) {
        if (ordered) {
          store_key(out_hi, out_lo, k, v[u]);
        } else {
          src[k] = v[u];
        }
      }
      at += __popc(m);
    }
  }
  if (ordered) {
    for (int i = total + tid; i < cap; i += kThreads) {
      store_key(out_hi, out_lo, i, kFill);
    }
    if (tid == 0) {
      words[0] = count;
      words[1] = kOnePathOrdered;
    }
    return;
  }

  // 3. a descent: the buffer's sort.
  __syncthreads();
  const Bits vary{s_or[0] ^ s_and[0], s_or[1] ^ s_and[1]};
  const K* sorted = one_sort(src, dst, total, vary, hist, warp_sums);
  for (int i = tid; i < cap; i += kThreads) {
    store_key(out_hi, out_lo, i, i < total ? sorted[i] : kFill);
  }
  if (tid == 0) {
    words[0] = count;
    words[1] = fits ? kOnePathShared : kOnePathDevice;
  }
}

template <typename K>
int compact_one_launch(const void* hi, const void* lo, int n, int cap,
                       void* scratch, void* out_hi, void* out_lo, void* words,
                       void* stream) {
  if (n < 1 || n > kCompactOneMaxN || cap < 1 ||
      (n > OneOf<K>::kSharedN && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      compact_one_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kOneSharedBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  compact_one_kernel<K><<<1, kThreads, kOneSharedBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo), n,
      cap, static_cast<uint32_t*>(out_hi), static_cast<uint32_t*>(out_lo),
      static_cast<int32_t*>(words), static_cast<K*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int n, int n_pad, int cap) {
  return n < 1 || n_pad < kMinN || n_pad > kMaxN || (n_pad & (n_pad - 1)) ||
         n > n_pad || cap < 1 || cap > n_pad;
}

template <typename K>
int compact_launch(const void* hi, const void* lo, int n, int n_pad, int cap,
                   void* work, void* out_hi, void* out_lo, void* count,
                   void* stream) {
  if (bad_sizes(n, n_pad, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K* w = static_cast<K*>(work);
  bitonic_sort<K>(static_cast<const uint32_t*>(hi),
                  static_cast<const uint32_t*>(lo), n, n_pad, w, st);
  compact_finish<K><<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      w, n_pad, cap, static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo), static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Single keys. Device pointers: a, w u32[n], e0, e1 u64[n_pad], keep
// u8[n_pad], blocks i32[n_pad / 1024 + 1], full u32[n_pad], out u32[cap],
// flags i32[2] = {min(total, cap), total > cap}. chain: the predecessor
// distances 1..chain tested; rounds: prune-and-compact rounds.
int psort_dedup_dom_launch(const void* a, const void* w, uint32_t cmask,
                           uint32_t rmask, int n, int n_pad, int cap,
                           int chain, int rounds, void* e0, void* e1,
                           void* keep, void* blocks, void* full, void* out,
                           void* flags, void* stream) {
  if (bad_dom_sizes(n, n_pad, cap, chain, rounds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint64_t* e = static_cast<uint64_t*>(e0);
  ++dom_kernel_launches;
  dom_load1<<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w), n,
      n_pad, e);
  return dom_finish<uint64_t>(
      e, static_cast<uint64_t*>(e1), n_pad, cap, chain, rounds, cmask, rmask,
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(blocks),
      static_cast<uint32_t*>(full), nullptr, static_cast<uint32_t*>(out),
      static_cast<int32_t*>(flags), st);
}

// Single keys in one launch (n up to kDomMaxN, any n_pad). Device
// pointers: a, w u32[n], scratch of 2 n 8-byte entries and n / 32 + 1
// keep words when n exceeds psort_dom_one_shared_max_n(0), else unused
// and may be null, out u32[cap], flags i32[3] = {min(total, cap), total >
// cap, path} (as psort_dedup2_dom_one_launch's).
int psort_dedup_dom_one_launch(const void* a, const void* w, uint32_t cmask,
                               uint32_t rmask, int n, int cap, int chain,
                               int rounds, void* scratch, void* out,
                               void* flags, void* stream) {
  if (n < 1 || n > kDomMaxN || cap < 1 || chain < 0 || rounds < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dom_one_launch<uint64_t>(
      nullptr, static_cast<const uint32_t*>(a), nullptr,
      static_cast<const uint32_t*>(w), n, cap, chain, rounds, cmask, rmask,
      nullptr, static_cast<uint32_t*>(out), static_cast<int32_t*>(flags),
      scratch, static_cast<cudaStream_t>(stream));
}

// Pair keys. Device pointers: a_hi, a_lo, w_hi, w_lo u32[n], e0, e1
// 16-byte entries [n_pad], keep u8[n_pad], blocks i32[n_pad / 1024 + 1],
// full u64[n_pad], out_hi, out_lo u32[cap], flags i32[2].
int psort_dedup2_dom_launch(const void* a_hi, const void* a_lo,
                            const void* w_hi, const void* w_lo,
                            uint32_t cmask_hi, uint32_t cmask_lo,
                            uint32_t rmask_hi, uint32_t rmask_lo, int n,
                            int n_pad, int cap, int chain, int rounds,
                            void* e0, void* e1, void* keep, void* blocks,
                            void* full, void* out_hi, void* out_lo,
                            void* flags, void* stream) {
  if (bad_dom_sizes(n, n_pad, cap, chain, rounds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  U128* e = static_cast<U128*>(e0);
  ++dom_kernel_launches;
  dom_load2<<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
      static_cast<const uint32_t*>(w_hi), static_cast<const uint32_t*>(w_lo),
      n, n_pad, e);
  const uint64_t cmask = (static_cast<uint64_t>(cmask_hi) << 32) | cmask_lo;
  const uint64_t rmask = (static_cast<uint64_t>(rmask_hi) << 32) | rmask_lo;
  return dom_finish<U128>(
      e, static_cast<U128*>(e1), n_pad, cap, chain, rounds, cmask, rmask,
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(blocks),
      static_cast<uint64_t*>(full), static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo), static_cast<int32_t*>(flags), st);
}

// Pair keys in one launch (n up to kDomMaxN, any n_pad). Device
// pointers: a_hi, a_lo, w_hi, w_lo u32[n], scratch of 2 n 16-byte
// entries and n / 32 + 1 keep words when n exceeds
// psort_dom_one_shared_max_n(1), else unused and may be null,
// out_hi, out_lo u32[cap], flags i32[3] = {min(total, cap), total > cap,
// path} (path bit 0: the entries were sorted in shared memory, bit 1: in
// the device-memory scratch).
int psort_dedup2_dom_one_launch(const void* a_hi, const void* a_lo,
                                const void* w_hi, const void* w_lo,
                                uint32_t cmask_hi, uint32_t cmask_lo,
                                uint32_t rmask_hi, uint32_t rmask_lo, int n,
                                int cap, int chain, int rounds, void* scratch,
                                void* out_hi, void* out_lo, void* flags,
                                void* stream) {
  if (n < 1 || n > kDomMaxN || cap < 1 || chain < 0 || rounds < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t cmask = (static_cast<uint64_t>(cmask_hi) << 32) | cmask_lo;
  const uint64_t rmask = (static_cast<uint64_t>(rmask_hi) << 32) | rmask_lo;
  return dom_one_launch<U128>(
      static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
      static_cast<const uint32_t*>(w_hi), static_cast<const uint32_t*>(w_lo),
      n, cap, chain, rounds, cmask, rmask, static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo), static_cast<int32_t*>(flags), scratch,
      static_cast<cudaStream_t>(stream));
}

// Valid entries the one-launch dominance dedup sorts in shared memory
// (pair = 1: 16-byte entries; pair = 0: 8-byte ones).
int psort_dom_one_shared_max_n(int pair) {
  return pair ? OneOf<U128>::kSharedN : OneOf<uint64_t>::kSharedN;
}

// Kernels launched by the dominance dedups since the library was loaded:
// one a call on the one-launch path.
long long psort_dom_kernel_launches() { return dom_kernel_launches; }

// int32 words of the dedup's scratch for n keys of key_bytes (4 or 8).
int psort_dedup_scratch_words(int n, int key_bytes) {
  return Layout(key_bytes, n).words();
}

// Kernels launched by psort_dedup_launch and psort_dedup2_launch since
// the library was loaded: 2 + key bytes a call.
long long psort_dedup_kernel_launches() { return dedup_kernel_launches; }

// Device pointers: key u32[n], valid u8[n] (torch bool), work u32[2 n],
// scratch i32[psort_dedup_scratch_words(n, 4)], out u32[cap], flags
// i32[2]. Returns the cudaError_t of the launches (0 on success).
int psort_dedup_launch(const void* key, const void* valid, int n, int cap,
                       void* work, void* scratch, void* out, void* flags,
                       void* stream) {
  return dedup_launch<uint32_t>(nullptr, key, valid, n, cap, work, scratch,
                                nullptr, out, flags, stream);
}

// The bitonic network. Device pointers: keys u32[n], work u32[n_pad],
// out u32[cap], count i32[1].
int psort_compact_launch(const void* keys, int n, int n_pad, int cap,
                         void* work, void* out, void* count, void* stream) {
  return compact_launch<uint32_t>(nullptr, keys, n, n_pad, cap, work, nullptr,
                                  out, count, stream);
}

// In one launch (n up to 2^21, cap any). Device pointers: keys u32[n],
// scratch u32[2 n] when n exceeds psort_compact_one_shared_max_n(), else
// unused and may be null, out u32[cap], words i32[2] = {min(live, cap),
// path} (as psort_compact2_one_launch's).
int psort_compact_one_launch(const void* keys, int n, int cap,
                             void* scratch, void* out, void* words,
                             void* stream) {
  return compact_one_launch<uint32_t>(nullptr, keys, n, cap, scratch,
                                      nullptr, out, words, stream);
}

// Live keys the one-launch compaction sorts in shared memory.
int psort_compact_one_shared_max_n() { return OneOf<uint32_t>::kSharedN; }

// Pairs. Device pointers: hi, lo u32[n], valid u8[n], work u64[2 n],
// scratch i32[psort_dedup_scratch_words(n, 8)], out_hi, out_lo u32[cap],
// flags i32[2].
int psort_dedup2_launch(const void* hi, const void* lo, const void* valid,
                        int n, int cap, void* work, void* scratch,
                        void* out_hi, void* out_lo, void* flags,
                        void* stream) {
  return dedup_launch<uint64_t>(hi, lo, valid, n, cap, work, scratch, out_hi,
                                out_lo, flags, stream);
}

// Pairs. Device pointers: hi, lo u32[n], work u64[n_pad], out_hi, out_lo
// u32[cap], count i32[1].
int psort_compact2_launch(const void* hi, const void* lo, int n, int n_pad,
                          int cap, void* work, void* out_hi, void* out_lo,
                          void* count, void* stream) {
  return compact_launch<uint64_t>(hi, lo, n, n_pad, cap, work, out_hi, out_lo,
                                  count, stream);
}

// Pairs in one launch (n up to 2^21, cap any). Device pointers: hi, lo
// u32[n], scratch u64[2 n] when n exceeds psort_compact2_one_shared_max_n(),
// else unused and may be null, out_hi, out_lo u32[cap], words i32[2] =
// {min(live, cap), path} (path 4: in order, no sort; 1: sorted in shared
// memory; 2: sorted in the device-memory scratch).
int psort_compact2_one_launch(const void* hi, const void* lo, int n, int cap,
                              void* scratch, void* out_hi, void* out_lo,
                              void* words, void* stream) {
  return compact_one_launch<uint64_t>(hi, lo, n, cap, scratch, out_hi, out_lo,
                                      words, stream);
}

// Live pairs the one-launch compaction sorts in shared memory.
int psort_compact2_one_shared_max_n() { return OneOf<uint64_t>::kSharedN; }

}  // extern "C"
