// psort.cu — the sparse engine's key sort-dedup and compaction on Hopper.
//
// Replaces four TPU kernels of jepsen_tpu/lin/psort.py:
//
//   dedup_keys    (pallas_call in _dedup_call, body _dedup_body, sort
//                  _bitonic_sort): u32 keys with their invalid flag folded
//                  into bit 31, padded with KEY_FILL to n_pad (a power of
//                  two, 2^10..2^19) -> the distinct valid keys ascending in
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
// Design. The sort is a bitonic network over n_pad keys. Strides below a
// tile of 32 KiB (8192 single keys, 4096 pairs) run inside one block in
// shared memory, many stages per launch; larger strides are one launch
// each of global-memory compare-exchanges, one pair per thread across the
// whole card (n_pad up to 2^19 keys, 2 or 4 MiB, resident in the 50 MB
// L2). The network's output is the sorted array whatever its stage order,
// so the result equals the TPU kernel's bit for bit. After the sort, dedup
// keeps the first key of each run with the flag clear. Where the TPU
// kernel re-sorts to pack the survivors, this one counts them per
// 1024-key block, scans the block counts in one block, and scatters each
// survivor to its rank: the survivors are already in order, so the prefix
// is the same. count and overflow stay on the device; nothing here
// synchronises with the host.
//
// What bounds it on this card: launches and L2 traffic. At n_pad = 2^19
// the single-key sort is 1 tile launch + 21 global stages + 6 tile merges
// (pairs: 1 + 28 + 7), each moving the array through L2; the bytes the
// function must move (keys in, keys out) take about a microsecond at
// 3.35 TB/s. A later change can keep more strides on chip (a thread-block
// cluster sorting in distributed shared memory) or fuse dedup into the
// last merge.
//
// Dominance. The TPU kernels, and the engine's forced lax path that the
// crash-dom bands really run (jepsen_tpu/lin/bfs.py _dedup_keys_dom and
// _dedup_keys2_dom with dom_force), sort the (group, word) entries, then
// for `rounds` rounds drop each entry that is invalid, a duplicate of its
// predecessor, or dominated (its group's first entry, or a predecessor at
// distance 1..chain in its group, has a word that is a strict subset of
// its own), and compact the survivors in order between rounds; last they
// sort the survivors' recombined full keys. Here: one sort of the pairs
// (the same tile and global-stage kernels on the wider key), then per
// round one thread per entry finds its group's first entry by a binary
// search for its group in the sorted array (the reference's segmented
// scan) and walks back over its predecessors while they are in its group
// (a predecessor outside the group ends the walk: groups are contiguous),
// and a block-count / scan / scatter compacts the survivors, the rest
// becoming the fill key. The full keys are scattered to their ranks with
// the fill after them and sorted; the sort of the full keys and every
// later round stop at the padded survivor count, read on the device, so
// nothing synchronises with the host. Bound on this card: the initial sort
// (log2(n_pad)^2 / 2 stages through L2 or device memory, 16 bytes a pair
// key) at every size the engine gives (up to 2^25 candidates at the last
// host cap); the chain walks are short where groups are small.
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
// Keys per block in the dedup count and scatter: one per thread.
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

// Loads a tile (folding ~valid into the flag bit and padding with the
// fill key when `valid` is given, padding only otherwise), sorts it in
// alternating directions (bitonic sizes 2 .. tile), and stores it to work.
template <typename K>
__global__ void sort_tiles(const uint32_t* hi, const uint32_t* lo,
                           const uint8_t* valid, int n, int tile, K* work) {
  __shared__ K s[KeyOf<K>::kTile];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int g = base + i;
    K v = KeyOf<K>::kFill;
    if (g < n) {
      v = load_key<K>(hi, lo, g);
      if (valid != nullptr && !valid[g]) v |= KeyOf<K>::kInvalid;
    }
    s[i] = v;
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
template <typename K>
void merge_all(K* work, int n_pad, int tile, const int32_t* total,
               cudaStream_t st) {
  const int tiles = n_pad / tile;
  const int pair_blocks = (n_pad / 2 + kThreads - 1) / kThreads;
  for (int k = 2 * tile; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      merge_global<K><<<pair_blocks, kThreads, 0, st>>>(work, n_pad, k, j,
                                                        total);
    }
    merge_tile<K><<<tiles, kThreads, 0, st>>>(work, n_pad, tile, k, total);
  }
}

// Sorts work[0 .. n_pad) ascending, loading it from (hi,) lo (and valid).
template <typename K>
void bitonic_sort(const uint32_t* hi, const uint32_t* lo,
                  const uint8_t* valid, int n, int n_pad, K* work,
                  cudaStream_t st) {
  const int tile = n_pad < KeyOf<K>::kTile ? n_pad : KeyOf<K>::kTile;
  sort_tiles<K><<<n_pad / tile, kThreads, 0, st>>>(hi, lo, valid, n, tile,
                                                   work);
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
template <typename K>
void bitonic_sort_work(K* work, int n_pad, const int32_t* total,
                       cudaStream_t st) {
  const int tile = n_pad < KeyOf<K>::kTile ? n_pad : KeyOf<K>::kTile;
  sort_tiles_work<K><<<n_pad / tile, kThreads, 0, st>>>(work, n_pad, tile,
                                                        total);
  merge_all<K>(work, n_pad, tile, total, st);
}

// Survivor test on the sorted keys: valid and first of its run.
template <typename K>
__device__ __forceinline__ bool survives(const K* s, int i) {
  const K v = s[i];
  return (v & KeyOf<K>::kInvalid) == 0 && (i == 0 || v != s[i - 1]);
}

// blocks[b] = survivors among keys [b * kSeg, (b + 1) * kSeg).
template <typename K>
__global__ void dedup_count(const K* s, int32_t* blocks) {
  const int i = blockIdx.x * kSeg + threadIdx.x;
  const int c = __syncthreads_count(survives(s, i));
  if (threadIdx.x == 0) blocks[blockIdx.x] = c;
}

// Inclusive scan of v over the block (blockDim.x a multiple of 32, at
// most 1024); `warp_sums` is 32 ints of shared memory. Ends synchronised.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int w = lane < n_warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < n_warps) warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return out;
}

// One block: blocks[0 .. n_blocks) -> exclusive offsets; blocks[n_blocks]
// = total; flags = {min(total, cap), total > cap}.
__global__ void dedup_scan(int32_t* blocks, int n_blocks, int cap,
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

// Each survivor goes to out[rank] when rank < cap; out[total .. cap) is
// the fill key. n_pad >= cap, so the grid covers every output index.
template <typename K>
__global__ void dedup_scatter(const K* s, const int32_t* blocks,
                              int n_blocks, int cap, uint32_t* out_hi,
                              uint32_t* out_lo) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * kSeg + threadIdx.x;
  const bool keep = survives(s, i);
  const int rank = blocks[blockIdx.x] +
                   block_inclusive_scan(keep ? 1 : 0, warp_sums) -
                   (keep ? 1 : 0);
  if (keep && rank < cap) store_key(out_hi, out_lo, rank, s[i]);
  const int total = blocks[n_blocks];
  if (i < cap && i >= total) store_key(out_hi, out_lo, i, KeyOf<K>::kFill);
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
  bitonic_sort_work<E>(e0, n_pad, nullptr, st);
  for (int r = 0; r < rounds; ++r) {
    if (r > 0) {
      dom_compact<E><<<n_blocks, kSeg, 0, st>>>(e0, keep, blocks, n_blocks,
                                                e1);
      E* t = e0;
      e0 = e1;
      e1 = t;
    }
    // After a compaction, the entries past the last round's count are fill.
    dom_prune<E><<<grid, kThreads, 0, st>>>(e0, n_pad, chain,
                                            r > 0 ? total : nullptr, keep);
    flag_count<<<n_blocks, kSeg, 0, st>>>(keep, blocks);
    dedup_scan<<<1, kThreads, 0, st>>>(blocks, n_blocks, cap, flags);
  }
  dom_full<E><<<n_blocks, kSeg, 0, st>>>(e0, keep, blocks, n_blocks, cmask,
                                         rmask, full);
  bitonic_sort_work<F>(full, n_pad, total, st);
  dom_out<F><<<(cap + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      full, cap, out_hi, out_lo);
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int n, int n_pad, int cap) {
  return n < 1 || n_pad < kMinN || n_pad > kMaxN || (n_pad & (n_pad - 1)) ||
         n > n_pad || cap < 1 || cap > n_pad;
}

template <typename K>
int dedup_launch(const void* hi, const void* lo, const void* valid, int n,
                 int n_pad, int cap, void* work, void* blocks, void* out_hi,
                 void* out_lo, void* flags, void* stream) {
  if (bad_sizes(n, n_pad, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K* w = static_cast<K*>(work);
  int32_t* bl = static_cast<int32_t*>(blocks);
  const int n_blocks = n_pad / kSeg;
  bitonic_sort<K>(static_cast<const uint32_t*>(hi),
                  static_cast<const uint32_t*>(lo),
                  static_cast<const uint8_t*>(valid), n, n_pad, w, st);
  dedup_count<K><<<n_blocks, kSeg, 0, st>>>(w, bl);
  dedup_scan<<<1, kThreads, 0, st>>>(bl, n_blocks, cap,
                                     static_cast<int32_t*>(flags));
  dedup_scatter<K><<<n_blocks, kSeg, 0, st>>>(
      w, bl, n_blocks, cap, static_cast<uint32_t*>(out_hi),
      static_cast<uint32_t*>(out_lo));
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int compact_launch(const void* hi, const void* lo, int n, int n_pad, int cap,
                   void* work, void* out_hi, void* out_lo, void* count,
                   void* stream) {
  if (bad_sizes(n, n_pad, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K* w = static_cast<K*>(work);
  bitonic_sort<K>(static_cast<const uint32_t*>(hi),
                  static_cast<const uint32_t*>(lo), nullptr, n, n_pad, w, st);
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
  dom_load1<<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(w), n,
      n_pad, e);
  return dom_finish<uint64_t>(
      e, static_cast<uint64_t*>(e1), n_pad, cap, chain, rounds, cmask, rmask,
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(blocks),
      static_cast<uint32_t*>(full), nullptr, static_cast<uint32_t*>(out),
      static_cast<int32_t*>(flags), st);
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

// Device pointers: key u32[n], valid u8[n] (torch bool), work u32[n_pad],
// blocks i32[n_pad / 1024 + 1], out u32[cap], flags i32[2]. Returns the
// cudaError_t of the launches (0 on success).
int psort_dedup_launch(const void* key, const void* valid, int n, int n_pad,
                       int cap, void* work, void* blocks, void* out,
                       void* flags, void* stream) {
  return dedup_launch<uint32_t>(nullptr, key, valid, n, n_pad, cap, work,
                                blocks, nullptr, out, flags, stream);
}

// Device pointers: keys u32[n], work u32[n_pad], out u32[cap],
// count i32[1].
int psort_compact_launch(const void* keys, int n, int n_pad, int cap,
                         void* work, void* out, void* count, void* stream) {
  return compact_launch<uint32_t>(nullptr, keys, n, n_pad, cap, work, nullptr,
                                  out, count, stream);
}

// Pairs. Device pointers: hi, lo u32[n], valid u8[n], work u64[n_pad],
// blocks i32[n_pad / 1024 + 1], out_hi, out_lo u32[cap], flags i32[2].
int psort_dedup2_launch(const void* hi, const void* lo, const void* valid,
                        int n, int n_pad, int cap, void* work, void* blocks,
                        void* out_hi, void* out_lo, void* flags,
                        void* stream) {
  return dedup_launch<uint64_t>(hi, lo, valid, n, n_pad, cap, work, blocks,
                                out_hi, out_lo, flags, stream);
}

// Pairs. Device pointers: hi, lo u32[n], work u64[n_pad], out_hi, out_lo
// u32[cap], count i32[1].
int psort_compact2_launch(const void* hi, const void* lo, int n, int n_pad,
                          int cap, void* work, void* out_hi, void* out_lo,
                          void* count, void* stream) {
  return compact_launch<uint64_t>(hi, lo, n, n_pad, cap, work, out_hi, out_lo,
                                  count, stream);
}

}  // extern "C"
