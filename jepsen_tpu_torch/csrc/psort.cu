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
//                  hi's bit 31 and the dead entry (KEY_FILL, KEY_FILL).
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

template <typename K>
struct KeyOf {
  static constexpr K kFill = ~K(0);
  static constexpr K kInvalid = K(1) << (8 * sizeof(K) - 1);
  static constexpr int kTile = kTileBytes / static_cast<int>(sizeof(K));
};

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

// One global stage: size k, stride j >= tile; one pair per thread.
template <typename K>
__global__ void merge_global(K* work, int n_pad, int k, int j) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pad / 2) return;
  const int i = pair_lo(p, j);
  cmpx(work, i, j, (i & k) == 0);
}

// The strides below the tile of a size-k merge, in shared memory.
template <typename K>
__global__ void merge_tile(K* work, int tile, int k) {
  __shared__ K s[KeyOf<K>::kTile];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = work[base + i];
  __syncthreads();
  tile_stages(s, tile, base, k, tile >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) work[base + i] = s[i];
}

// Sorts work[0 .. n_pad) ascending, loading it from (hi,) lo (and valid).
template <typename K>
void bitonic_sort(const uint32_t* hi, const uint32_t* lo,
                  const uint8_t* valid, int n, int n_pad, K* work,
                  cudaStream_t st) {
  const int tile = n_pad < KeyOf<K>::kTile ? n_pad : KeyOf<K>::kTile;
  const int tiles = n_pad / tile;
  sort_tiles<K><<<tiles, kThreads, 0, st>>>(hi, lo, valid, n, tile, work);
  const int pair_blocks = (n_pad / 2 + kThreads - 1) / kThreads;
  for (int k = 2 * tile; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      merge_global<K><<<pair_blocks, kThreads, 0, st>>>(work, n_pad, k, j);
    }
    merge_tile<K><<<tiles, kThreads, 0, st>>>(work, tile, k);
  }
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
