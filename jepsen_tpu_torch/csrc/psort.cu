// psort.cu — the sparse engine's key sort-dedup and compaction on Hopper.
//
// Replaces two TPU kernels of jepsen_tpu/lin/psort.py:
//
//   dedup_keys   (pallas_call in _dedup_call, body _dedup_body, sort
//                 _bitonic_sort): u32 keys with their invalid flag folded
//                 into bit 31, padded with KEY_FILL to n_pad (a power of
//                 two, 2^10..2^19) -> the distinct valid keys ascending in
//                 out[0 .. cap), KEY_FILL after them, and
//                 flags = {min(total, cap), total > cap};
//   compact_keys (pallas_call in _compact_call, body _compact_body): the
//                 keys sorted ascending, out = sorted[0 .. cap), and
//                 count = min(number of non-KEY_FILL keys, cap). No dedup.
//
// Keys compare as uint32_t: KEY_FILL = 0xFFFFFFFF and the bit-31 invalid
// flag sort last.
//
// Design. The sort is a bitonic network over n_pad keys. Strides below
// kTile (8192 keys, 32 KiB) run inside one block in shared memory, many
// stages per launch; larger strides are one launch each of global-memory
// compare-exchanges, one pair per thread across the whole card (n_pad up
// to 2^19 = 2 MiB, resident in the 50 MB L2). The network's output is
// the sorted array whatever its stage order, so the result equals the
// TPU kernel's bit for bit. After the sort, dedup keeps the first key of
// each run with bit 31 clear. Where the TPU kernel re-sorts to pack the
// survivors, this one counts them per 1024-key block, scans the block
// counts in one block, and scatters each survivor to its rank: the
// survivors are already in order, so the prefix is the same. count and
// overflow stay on the device; nothing here synchronises with the host.
//
// What bounds it on this card: launches and L2 traffic. At n_pad = 2^19
// the sort is 1 tile launch + 21 global stages + 6 tile merges, each
// moving the 2 MiB array through L2; the bytes the function must move
// (keys in, keys out) take well under a microsecond at 3.35 TB/s. A later
// change can keep more strides on chip (a thread-block cluster sorting
// 2^19 keys in distributed shared memory) or fuse dedup into the last
// merge.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see jepsen_tpu_torch/_build.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFill = 0xFFFFFFFFu;
constexpr uint32_t kInvalid = 0x80000000u;
constexpr int kThreads = 1024;
// Keys per shared-memory tile: every stride below it runs in one launch.
constexpr int kTile = 8192;
// Keys per block in the dedup count and scatter: one per thread.
constexpr int kSeg = kThreads;
constexpr int kMinN = 1024;
constexpr int kMaxN = 1 << 19;

// Compare-exchange of keys i and i + j in a bitonic block of size k:
// ascending where bit log2(k) of the global index is clear.
__device__ __forceinline__ void cmpx(uint32_t* s, int i, int j,
                                     bool ascending) {
  const uint32_t a = s[i];
  const uint32_t b = s[i + j];
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
__device__ void tile_stages(uint32_t* s, int tile, int base, int k, int j0) {
  for (int j = j0; j > 0; j >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      const int i = pair_lo(p, j);
      cmpx(s, i, j, ((base + i) & k) == 0);
    }
    __syncthreads();
  }
}

// Loads a tile (folding ~valid into bit 31 and padding with KEY_FILL when
// `valid` is given, padding only otherwise), sorts it in alternating
// directions (bitonic sizes 2 .. tile), and stores it to work.
__global__ void sort_tiles(const uint32_t* key, const uint8_t* valid, int n,
                           int tile, uint32_t* work) {
  __shared__ uint32_t s[kTile];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int g = base + i;
    uint32_t v = kFill;
    if (g < n) {
      v = key[g];
      if (valid != nullptr && !valid[g]) v |= kInvalid;
    }
    s[i] = v;
  }
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) tile_stages(s, tile, base, k, k >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) work[base + i] = s[i];
}

// One global stage: size k, stride j >= tile; one pair per thread.
__global__ void merge_global(uint32_t* work, int n_pad, int k, int j) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pad / 2) return;
  const int i = pair_lo(p, j);
  cmpx(work, i, j, (i & k) == 0);
}

// The strides below the tile of a size-k merge, in shared memory.
__global__ void merge_tile(uint32_t* work, int tile, int k) {
  __shared__ uint32_t s[kTile];
  const int base = blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s[i] = work[base + i];
  __syncthreads();
  tile_stages(s, tile, base, k, tile >> 1);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) work[base + i] = s[i];
}

// Sorts work[0 .. n_pad) ascending, loading it from key (and valid).
void bitonic_sort(const uint32_t* key, const uint8_t* valid, int n,
                  int n_pad, uint32_t* work, cudaStream_t st) {
  const int tile = n_pad < kTile ? n_pad : kTile;
  const int tiles = n_pad / tile;
  sort_tiles<<<tiles, kThreads, 0, st>>>(key, valid, n, tile, work);
  const int pair_blocks = (n_pad / 2 + kThreads - 1) / kThreads;
  for (int k = 2 * tile; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      merge_global<<<pair_blocks, kThreads, 0, st>>>(work, n_pad, k, j);
    }
    merge_tile<<<tiles, kThreads, 0, st>>>(work, tile, k);
  }
}

// Survivor test on the sorted keys: valid and first of its run.
__device__ __forceinline__ bool survives(const uint32_t* s, int i) {
  const uint32_t v = s[i];
  return (v & kInvalid) == 0 && (i == 0 || v != s[i - 1]);
}

// blocks[b] = survivors among keys [b * kSeg, (b + 1) * kSeg).
__global__ void dedup_count(const uint32_t* s, int32_t* blocks) {
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
// KEY_FILL. n_pad >= cap, so the grid covers every output index.
__global__ void dedup_scatter(const uint32_t* s, const int32_t* blocks,
                              int n_blocks, int cap, uint32_t* out) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * kSeg + threadIdx.x;
  const bool keep = survives(s, i);
  const int rank = blocks[blockIdx.x] +
                   block_inclusive_scan(keep ? 1 : 0, warp_sums) -
                   (keep ? 1 : 0);
  if (keep && rank < cap) out[rank] = s[i];
  const int total = blocks[n_blocks];
  if (i < cap && i >= total) out[i] = kFill;
}

// out = s[0 .. cap); count = min(non-KEY_FILL keys, cap). The keys are
// sorted and KEY_FILL is the largest u32, so the non-FILL keys are a
// prefix and exactly one thread sees its end.
__global__ void compact_finish(const uint32_t* s, int n_pad, int cap,
                               uint32_t* out, int32_t* count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  if (i < cap) out[i] = s[i];
  const bool live = s[i] != kFill;
  int total = -1;
  if (live && (i + 1 == n_pad || s[i + 1] == kFill)) total = i + 1;
  if (i == 0 && !live) total = 0;
  if (total >= 0) *count = total < cap ? total : cap;
}

bool bad_sizes(int n, int n_pad, int cap) {
  return n < 1 || n_pad < kMinN || n_pad > kMaxN || (n_pad & (n_pad - 1)) ||
         n > n_pad || cap < 1 || cap > n_pad;
}

}  // namespace

extern "C" {

// Device pointers: key u32[n], valid u8[n] (torch bool), work u32[n_pad],
// blocks i32[n_pad / 1024 + 1], out u32[cap], flags i32[2]. Returns the
// cudaError_t of the launches (0 on success).
int psort_dedup_launch(const void* key, const void* valid, int n, int n_pad,
                       int cap, void* work, void* blocks, void* out,
                       void* flags, void* stream) {
  if (bad_sizes(n, n_pad, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(work);
  int32_t* bl = static_cast<int32_t*>(blocks);
  const int n_blocks = n_pad / kSeg;
  bitonic_sort(static_cast<const uint32_t*>(key),
               static_cast<const uint8_t*>(valid), n, n_pad, w, st);
  dedup_count<<<n_blocks, kSeg, 0, st>>>(w, bl);
  dedup_scan<<<1, kThreads, 0, st>>>(bl, n_blocks, cap,
                                     static_cast<int32_t*>(flags));
  dedup_scatter<<<n_blocks, kSeg, 0, st>>>(w, bl, n_blocks, cap,
                                           static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Device pointers: keys u32[n], work u32[n_pad], out u32[cap],
// count i32[1].
int psort_compact_launch(const void* keys, int n, int n_pad, int cap,
                         void* work, void* out, void* count, void* stream) {
  if (bad_sizes(n, n_pad, cap)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(work);
  bitonic_sort(static_cast<const uint32_t*>(keys), nullptr, n, n_pad, w, st);
  compact_finish<<<(n_pad + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      w, n_pad, cap, static_cast<uint32_t*>(out),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
