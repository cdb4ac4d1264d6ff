// dense_chunk.cu — one chunk of the dense linearizability engine on Hopper.
//
// Replaces the TPU kernel jepsen_tpu/lin/dense_pallas.py:_row_kernel /
// pallas_chunk. It computes what jepsen_tpu/lin/dense.py:_dense_chunk
// computes: the frontier bitmap F (u32[2^w], bit s of word B = config
// "linearized-slot set B, model state s" reachable) advanced through up to
// n_rows return events. Per row:
//
//   1. closure to fixpoint: for each slot j, every word B with bit j clear
//      contributes contrib(F[B]) to F[B | 2^j], where contrib maps each
//      source state s to the target states of the slot's op (the row's
//      transition masks, mask[j][s'] = source states that go to s');
//   2. return filter for slot s: F'[B] = (B & 2^s) ? 0 : F[B | 2^s];
//   3. dead when F' is all zero (the history is not linearizable).
//
// Outputs: F, and state = {rows_done, dead, trunc, passes, sweeps}:
// rows_done counts the dead row itself; passes counts closure passes and
// sweeps the (pass, slot-with-transitions) pairs, the work the data
// needed. trunc is the honest-overflow channel of
// dense.py:175-178: a closure still changing after w + 2 passes stops the
// chunk (a monotone closure needs at most w + 1).
//
// Design. One thread block of 1024 threads runs the whole chunk; the loop
// over rows takes the place of Pallas's sequential grid, and nothing
// carries between blocks. For w <= 15 (4 * 2^w <= 128 KiB) the bitmap
// lives in dynamic shared memory; for 16 <= w <= 20 the block works on the
// output buffer in device memory, which stays resident in the 50 MB L2.
// Slot j's update reads the bit-j-clear half and writes the bit-j-set
// half, so it runs in place; the filter moves each (B, B | 2^s) pair
// within one thread. The closure is a least fixpoint, so the result is
// bit-identical to the plain version's whatever the order of updates
// inside a slot. Per-row work skips slots with no transitions and zero
// words, and walks only the set bits of a word.
//
// What bounds it on this card: integer ops and barriers on ONE SM. Rows
// are strictly sequential and each slot of each pass ends in a block-wide
// barrier, so 131 of the 132 SMs idle. What a later change can do about
// it: split the bitmap over a thread-block cluster with distributed shared
// memory (more SMs per row), or batch independent keys, one block each,
// across the SMs.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see jepsen_tpu_torch/_build.py).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxW = 20;
constexpr int kMaxNs = 32;
// Widest bitmap kept in shared memory: 4 * 2^15 bytes = 128 KiB.
constexpr int kSharedMaxW = 15;

// The p-th word index with bit j clear: insert a 0 at bit j of p.
__device__ __forceinline__ uint32_t spread(uint32_t p, int j) {
  const uint32_t lo = p & ((1u << j) - 1u);
  return ((p ^ lo) << 1) | lo;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
dense_chunk_kernel(const uint32_t* __restrict__ f_in, uint32_t* f_out,
                   const uint32_t* __restrict__ masks,
                   const int32_t* __restrict__ ret_slot, int n_rows, int w,
                   int ns, int32_t* __restrict__ state) {
  extern __shared__ uint32_t f_shared[];
  // succ[j][s]: target states of slot j's op from source state s. All
  // 32 source bits get an entry, so a word bit at or above ns acts
  // exactly as the masks say (no transitions for real tables).
  __shared__ uint32_t succ[kMaxW][32];
  __shared__ uint32_t live_slots;

  uint32_t* F = kShared ? f_shared : f_out;
  const int tid = threadIdx.x;
  const uint32_t n_words = 1u << w;
  const uint32_t half = n_words >> 1;

  // Each thread copies the words it later writes back, so no barrier is
  // needed before the write-back when n_rows == 0; the first row's
  // barriers order these copies before any other thread reads them.
  for (uint32_t i = tid; i < n_words; i += kThreads) F[i] = f_in[i];

  int rows_done = 0, dead = 0, trunc = 0, passes = 0, sweeps = 0;
  for (int r = 0; r < n_rows; ++r) {
    if (tid == 0) live_slots = 0u;
    __syncthreads();
    const uint32_t* m = masks + static_cast<size_t>(r) * w * ns;
    for (int t = tid; t < w * 32; t += kThreads) {
      const int j = t >> 5;
      const int s = t & 31;
      uint32_t out = 0u;
      for (int sp = 0; sp < ns; ++sp) out |= ((m[j * ns + sp] >> s) & 1u) << sp;
      succ[j][s] = out;
      if (out) atomicOr(&live_slots, 1u << j);
    }
    __syncthreads();
    const uint32_t live = live_slots;

    int pass = 0;
    int changed;
    do {
      int ch = 0;
      for (int j = 0; j < w; ++j) {
        if (!((live >> j) & 1u)) continue;  // block-uniform
        const uint32_t bit = 1u << j;
        for (uint32_t p = tid; p < half; p += kThreads) {
          const uint32_t b = spread(p, j);
          uint32_t x = F[b];
          if (!x) continue;
          uint32_t contrib = 0u;
          do {
            contrib |= succ[j][__ffs(x) - 1];
            x &= x - 1u;
          } while (x);
          const uint32_t hi = F[b | bit];
          if (contrib & ~hi) {
            F[b | bit] = hi | contrib;
            ch = 1;
          }
        }
        __syncthreads();
      }
      ++pass;
      changed = __syncthreads_or(ch);
    } while (changed && pass < w + 2);
    passes += pass;
    sweeps += pass * __popc(live);
    if (changed) trunc = 1;

    // Return filter. A slot outside [0, w) keeps nothing, as the XLA
    // formulation's (iota >> s) & 1 test does.
    const int s = ret_slot[r];
    int nz = 0;
    if (s >= 0 && s < w) {
      const uint32_t sbit = 1u << s;
      for (uint32_t p = tid; p < half; p += kThreads) {
        const uint32_t b = spread(p, s);
        const uint32_t v = F[b | sbit];
        F[b] = v;
        F[b | sbit] = 0u;
        nz |= v != 0u;
      }
    } else {
      for (uint32_t i = tid; i < n_words; i += kThreads) F[i] = 0u;
    }
    rows_done = r + 1;
    dead = !__syncthreads_or(nz);
    if (dead || trunc) break;
  }

  if (kShared) {
    for (uint32_t i = tid; i < n_words; i += kThreads) f_out[i] = F[i];
  }
  if (tid == 0) {
    state[0] = rows_done;
    state[1] = dead;
    state[2] = trunc;
    state[3] = passes;
    state[4] = sweeps;
  }
}

}  // namespace

extern "C" {

int dense_chunk_shared_max_w() { return kSharedMaxW; }

// Launches one chunk on `stream`. Pointers are device pointers: f_in and
// f_out u32[2^w], masks u32[n_rows(+), w, ns], ret_slot i32[n_rows(+)],
// state i32[5]. Returns the cudaError_t of the launch (0 on success).
int dense_chunk_launch(const void* f_in, void* f_out, const void* masks,
                       const void* ret_slot, int n_rows, int w, int ns,
                       void* state, void* stream) {
  if (w < 1 || w > kMaxW || ns < 1 || ns > kMaxNs || n_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* fi = static_cast<const uint32_t*>(f_in);
  uint32_t* fo = static_cast<uint32_t*>(f_out);
  const uint32_t* mk = static_cast<const uint32_t*>(masks);
  const int32_t* rs = static_cast<const int32_t*>(ret_slot);
  int32_t* sv = static_cast<int32_t*>(state);
  if (w <= kSharedMaxW) {
    // Over 48 KiB of dynamic shared memory needs the opt-in; a refused
    // launch never runs, so the error is returned, not ignored.
    cudaError_t e = cudaFuncSetAttribute(
        dense_chunk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(uint32_t) << kSharedMaxW));
    if (e != cudaSuccess) return static_cast<int>(e);
    dense_chunk_kernel<true><<<1, kThreads, sizeof(uint32_t) << w, st>>>(
        fi, fo, mk, rs, n_rows, w, ns, sv);
  } else {
    dense_chunk_kernel<false><<<1, kThreads, 0, st>>>(fi, fo, mk, rs, n_rows,
                                                       w, ns, sv);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
