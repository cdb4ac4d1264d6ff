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
// Two kernels, chosen on the host from w.
//
// Bit-sliced, for w <= 15 (the dense headline runs at w 14). The
// bitmap is transposed once per launch into 32 slices of 2^(w - 5)
// words in shared memory (bit i of slice t's word at position p: config
// 32 p + i holds state t; 4 * 2^w bytes, as the bitmap), by warp
// ballots, and back at the end. A slot's update then moves whole words
// of 32 configs: for each target state t with a nonzero mask m (the
// source states that go to t), the OR of the source slices in m, masked
// to the configs whose index has the slot's bit clear, is ORed into
// slice t at their partners. Slots 0-4 are bits inside a word (a shift
// by 2^j), slots 5 .. w - 1 bits of the position. One block of
// max(32, 2^(w - 5)) threads, a position each (at most 512 below w 15,
// which leaves a thread the 128 registers 32 slices need; w 15 takes
// 1024 and spills at 32 slices): a pass loads a thread's
// slices into registers in layout 1 (position bits 0-4 are lane bits),
// runs slots 0-4 inside the thread and 5-9 across lanes with
// __shfl_xor_sync, stores, and after one barrier reloads in layout 2
// (position bits 5 .. w - 6 are lane bits) for slots 10 .. w - 1: 2
// block barriers a pass where a word-by-word sweep takes one per live
// slot (about 40 a row at w 14). Shared memory is swizzled (position p at
// p ^ ((p >> 5) & 31)) so both layouts' warps hit distinct banks. The
// closure carries 8 slices when ns <= 8 and the bitmap holds no higher
// state, else 32; the filter moves every slice that may hold a bit.
//
// At the dense headline's ns 8 the 8 slices of 512 words carry the
// 16,384-word bitmap in a quarter of the shared-memory traffic of a
// word-per-config sweep, and a slot costs a few ORs of whole slice
// words per position instead of a table lookup or a set-bit loop per
// config word; a slot's work no longer depends on how many words are
// nonzero (chip_smoke.py logs the headline's count per chunk). Slots
// still apply in the order 0 .. w - 1, each finished before the next,
// so every pass equals the plain version's Gauss-Seidel pass and
// `passes` and `sweeps` match it.
//
// What bounds it now: per row the block's barriers (row setup, 2 a
// pass, the filter) and per slot the chain of shuffles and ORs over the
// source slices, on ONE SM; rows are strictly sequential, so a single
// history leaves 131 of the 132 SMs idle. Independent keys
// (jepsen_tpu_torch/lin/batched.py) fill them: dense_chunk_batch_launch
// runs the same kernels over a grid of K blocks, one key each, each with
// its own bitmap, tables, row count and state row, each stopping at its
// own dead row or pass ceiling. That is the XLA twin's
// jax.vmap(dense._dense_chunk) over keys (jepsen_tpu/lin/batched.py:153),
// which has no Pallas kernel. At the small widths of per-key histories
// (w 6-12: 32-128 threads, 256 B-16 KiB of slices) several blocks share
// an SM; at w 15 one block fills one. A wider bitmap could still be split
// over a thread-block cluster.
//
// Device-memory placement, for 16 <= w <= 20 (a bitmap of 256 KiB to
// 4 MiB does not fit a block's shared memory): the word-by-word sweep. One
// block of 1024 threads works on the output buffer in device memory,
// which stays in the 50 MB L2; per row it builds succ by a loop over ns,
// and per pass and live slot sweeps the 2^(w-1) bit-clear words with a
// set-bit loop, each slot ending in a block-wide barrier; the filter
// moves each (B, B | 2^s) pair within one thread. Bound by those
// barriers and L2 latency on one SM.
//
// Both compute the least fixpoint of the same Gauss-Seidel passes, so
// the result is bit-identical to the plain version's.
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
constexpr unsigned kFull = 0xFFFFFFFFu;

// The p-th word index with bit j clear: insert a 0 at bit j of p.
__device__ __forceinline__ uint32_t spread(uint32_t p, int j) {
  const uint32_t lo = p & ((1u << j) - 1u);
  return ((p ^ lo) << 1) | lo;
}

// Block k of a launch over K keys works on key k alone: its bitmap (in
// and out) at k * 2^w words, its masks at k * r_stride * w * ns words,
// its return slots at k * r_stride and its state row at 5 * k (each
// kernel moves its pointers so at entry; nothing is shared between
// blocks). Its row count is key_rows[k]; a launch of one chunk
// (key_rows null, one block) keeps n_rows. A count outside [0, r_stride]
// gives -1: the block then runs no row, passes its bitmap through and
// writes rows_done = -1 (kBadRows), which the host rejects, so no block
// reads past its key's tables and none answers for a bad count.
constexpr int kBadRows = -1;

__device__ __forceinline__ int key_row_count(int n_rows,
                                             const int32_t* key_rows,
                                             int r_stride) {
  if (key_rows == nullptr) return n_rows;
  const int n = key_rows[blockIdx.x];
  return n < 0 || n > r_stride ? kBadRows : n;
}

// --- bit-sliced kernel (w <= kSharedMaxW) --------------------------------

// Word bits of the configs with bit j of their index clear, j < 5.
__constant__ uint32_t kClearBits[5] = {0x55555555u, 0x33333333u, 0x0F0F0F0Fu,
                                       0x00FF00FFu, 0x0000FFFFu};

// Where position p of a slice lives: bits 0-4 XORed with bits 5-9, so
// that both layouts' warps hit 32 distinct banks.
__device__ __forceinline__ uint32_t swz(uint32_t p) {
  return p ^ ((p >> 5) & 31u);
}

// One slot of the closure on a thread's NS slices R (bit i of slice t
// is config 32 p + i in state t, p the thread's position): each target
// t with a nonzero mask m (the source states that go to t) adds the OR
// of the source slices. A slot below 5 (lane_mask 0) moves bits inside
// the word, to the configs whose index has the slot's bit set; a higher
// one sends the sum to the partner lane (lane_mask), whose position has
// the bit set (`recv`). Sources are the configs with the bit clear, so
// no update of this slot changes a source.
template <int NS>
__device__ __forceinline__ void slice_slot(uint32_t (&R)[NS],
                                           const uint32_t* msk, int j,
                                           int lane_mask, bool recv,
                                           uint32_t& acc) {
  // The slot's masks in 16-byte loads, issued together.
  uint32_t mm[NS];
#pragma unroll
  for (int q = 0; q < NS / 4; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(msk)[q];
    mm[4 * q] = v.x;
    mm[4 * q + 1] = v.y;
    mm[4 * q + 2] = v.z;
    mm[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int t = 0; t < NS; ++t) {
    const uint32_t m = mm[t];
    if (!m) continue;  // block-uniform
    uint32_t x = 0u;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if ((m >> s) & 1u) x |= R[s];
    }
    if (lane_mask == 0) {
      x = (x & kClearBits[j]) << (1 << j);
    } else {
      x = __shfl_xor_sync(kFull, x, lane_mask);
      if (!recv) x = 0u;
    }
    acc |= x & ~R[t];
    R[t] |= x;
  }
}

// The rows of a chunk on the slices G (32 slices of P words in shared
// memory, slice t at G + t * P, position p at swz(p)), of which only the
// first NS may hold bits. Returns the state words.
template <int NS>
__device__ __forceinline__ void slice_rows(uint32_t* G, int P, int mbits,
                                           uint32_t present,
                                           const uint32_t* masks,
                                           const int32_t* ret_slot,
                                           int n_rows, int w, int ns,
                                           uint32_t (*msk)[32], uint32_t* tgt,
                                           int (&st)[5]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  // This thread's position in each layout: in layout 1 position bits 0-4
  // are lane bits (slots 5-9 run inside a warp); in layout 2 (w > 10)
  // position bits mbits - 5 .. mbits - 1 are (slots 10 .. w - 1).
  const uint32_t p1 = static_cast<uint32_t>(tid);
  const uint32_t p2 =
      mbits > 5 ? (static_cast<uint32_t>(lane) << (mbits - 5)) |
                      static_cast<uint32_t>(warp)
                : p1;
  const bool own = p1 < static_cast<uint32_t>(P);
  const uint32_t a1 = swz(p1), a2 = swz(p2);

  int rows_done = 0, dead = 0, trunc = 0, passes = 0, sweeps = 0;
  for (int r = 0; r < n_rows; ++r) {
    // The next row's masks into L1 while this row runs.
    const uint32_t* m = masks + static_cast<size_t>(r) * w * ns;
    if (r + 1 < n_rows && tid * 32 < w * ns) {
      asm volatile("prefetch.global.L1 [%0];" ::"l"(m + w * ns + tid * 32));
    }
    // Row setup: warp j stores slot j's masks (lane t: mask[j][t], the
    // source states that go to state t) and the set of its targets.
    for (int j = warp; j < w; j += n_warps) {
      const uint32_t mt = lane < ns ? m[j * ns + lane] : 0u;
      msk[j][lane] = mt;
      const uint32_t on = __ballot_sync(kFull, mt != 0u);
      if (lane == 0) tgt[j] = on;
    }
    const int s = ret_slot[r];
    __syncthreads();
    uint32_t live = 0u;
    for (int j = 0; j < w; ++j) {
      const uint32_t on = tgt[j];
      present |= on;
      live |= static_cast<uint32_t>(on != 0u) << j;
    }

    int pass = 0;
    int changed;
    do {
      uint32_t acc = 0u;
      uint32_t R[NS];
      // Layout 1: slots 0-4 inside a thread's words, 5-9 across its warp.
#pragma unroll
      for (int t = 0; t < NS; ++t) R[t] = own ? G[t * P + a1] : 0u;
      for (int j = 0; j < w && j < 10; ++j) {
        if (!((live >> j) & 1u)) continue;  // block-uniform
        const int lm = j < 5 ? 0 : 1 << (j - 5);
        slice_slot<NS>(R, msk[j], j, lm, (lane & lm) != 0, acc);
      }
      if (own) {
#pragma unroll
        for (int t = 0; t < NS; ++t) G[t * P + a1] = R[t];
      }
      if (w > 10) {
        __syncthreads();
        // Layout 2: slots 10 .. w - 1 across the warp.
#pragma unroll
        for (int t = 0; t < NS; ++t) R[t] = G[t * P + a2];
        for (int j = 10; j < w; ++j) {
          if (!((live >> j) & 1u)) continue;  // block-uniform
          const int lm = 1 << (j - mbits);
          slice_slot<NS>(R, msk[j], j, lm, (lane & lm) != 0, acc);
        }
#pragma unroll
        for (int t = 0; t < NS; ++t) G[t * P + a2] = R[t];
      }
      ++pass;
      changed = __syncthreads_or(acc != 0u);
    } while (changed && pass < w + 2);
    passes += pass;
    sweeps += pass * __popc(live);
    if (changed) trunc = 1;

    // Return filter for slot s, on every slice that may hold a bit. A
    // slot outside [0, w) keeps nothing, as the XLA formulation's
    // (iota >> s) & 1 test does.
    uint32_t nz = 0u;
    if (own) {
      if (s < 0 || s >= w) {
        for (uint32_t todo = present; todo; todo &= todo - 1u) {
          G[(__ffs(todo) - 1) * P + a1] = 0u;
        }
      } else if (s < 5) {
        const uint32_t clear = kClearBits[s];
        for (uint32_t todo = present; todo; todo &= todo - 1u) {
          uint32_t* g = G + (__ffs(todo) - 1) * P + a1;
          const uint32_t v = (*g >> (1 << s)) & clear;
          *g = v;
          nz |= v;
        }
      } else if (!(p1 & (1u << (s - 5)))) {
        const uint32_t a_hi = swz(p1 | (1u << (s - 5)));
        for (uint32_t todo = present; todo; todo &= todo - 1u) {
          uint32_t* g = G + (__ffs(todo) - 1) * P;
          const uint32_t v = g[a_hi];
          g[a1] = v;
          g[a_hi] = 0u;
          nz |= v;
        }
      }
    }
    rows_done = r + 1;
    dead = !__syncthreads_or(nz != 0u);
    if (dead || trunc) break;
  }
  st[0] = rows_done;
  st[1] = dead;
  st[2] = trunc;
  st[3] = passes;
  st[4] = sweeps;
}

// Threads: max(32, P) with P = 2^(w - 5) positions (one for w <= 5), at
// most MAXT (512 leaves a thread 128 registers, which 32 slices need).
// NS: slices the closure carries, 8 where ns <= 8, else 32; a chunk
// whose bitmap holds a state at or above NS runs with 32.
template <int NS, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
dense_slice_kernel(const uint32_t* __restrict__ f_in, uint32_t* f_out,
                   const uint32_t* __restrict__ masks,
                   const int32_t* __restrict__ ret_slot, int n_rows,
                   const int32_t* __restrict__ key_rows, int r_stride, int w,
                   int ns, int32_t* __restrict__ state) {
  const size_t key = blockIdx.x;
  f_in += key << w;
  f_out += key << w;
  masks += key * r_stride * w * ns;
  ret_slot += key * r_stride;
  state += 5 * key;
  n_rows = key_row_count(n_rows, key_rows, r_stride);
  const bool bad_rows = n_rows == kBadRows;
  if (bad_rows) n_rows = 0;
  // The slices: G[t * P + swz(p)].
  extern __shared__ uint32_t G[];
  // Per slot of the row: its masks (msk[j][t] = source states that go to
  // state t) and the set of its targets.
  __shared__ __align__(16) uint32_t msk[kSharedMaxW][32];
  __shared__ uint32_t tgt[kSharedMaxW];
  __shared__ uint32_t s_present;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int mbits = w > 5 ? w - 5 : 0;
  const int P = 1 << mbits;
  const uint32_t n_words = 1u << w;

  // In: a warp per 32 words; ballot t gives slice t's word, which lane t
  // keeps and stores.
  if (tid == 0) s_present = 0u;
  __syncthreads();
  uint32_t present = 0u;
  for (int p = warp; p < P; p += n_warps) {
    const uint32_t i = static_cast<uint32_t>(p) * 32u + lane;
    const uint32_t f = i < n_words ? f_in[i] : 0u;
    present |= f;
    uint32_t mine = 0u;
    for (int t = 0; t < 32; ++t) {
      const uint32_t bits = __ballot_sync(kFull, (f >> t) & 1u);
      if (lane == t) mine = bits;
    }
    G[lane * P + swz(p)] = mine;
  }
  present = __reduce_or_sync(kFull, present);
  if (lane == 0 && present) atomicOr(&s_present, present);
  __syncthreads();
  present = s_present;

  int st[5];
  if (NS < 32 && (present >> (NS < 32 ? NS : 0)) != 0u) {
    slice_rows<32>(G, P, mbits, present, masks, ret_slot, n_rows, w, ns, msk,
                   tgt, st);
  } else {
    slice_rows<NS>(G, P, mbits, present, masks, ret_slot, n_rows, w, ns, msk,
                   tgt, st);
  }

  // Out: lane t loads slice t's word of position p; ballot i gives word
  // 32 p + i, which lane i keeps and stores.
  for (int p = warp; p < P; p += n_warps) {
    const uint32_t g = G[lane * P + swz(p)];
    uint32_t mine = 0u;
    for (int i = 0; i < 32; ++i) {
      const uint32_t bits = __ballot_sync(kFull, (g >> i) & 1u);
      if (lane == i) mine = bits;
    }
    const uint32_t i = static_cast<uint32_t>(p) * 32u + lane;
    if (i < n_words) f_out[i] = mine;
  }
  if (tid == 0) {
    for (int q = 0; q < 5; ++q) state[q] = st[q];
    if (bad_rows) state[0] = kBadRows;
  }
}

template <int NS, int MAXT>
int launch_slices(const uint32_t* fi, uint32_t* fo, const uint32_t* mk,
                  const int32_t* rs, int n_rows, const int32_t* kr,
                  int r_stride, int keys, int w, int ns, int32_t* sv,
                  cudaStream_t st) {
  // 32 slices of 2^(w - 5) words: 4 * 2^w bytes, at least 32 words.
  // Over 48 KiB of dynamic shared memory needs the opt-in; a refused
  // launch never runs, so the error is returned, not ignored.
  const int positions = w > 5 ? 1 << (w - 5) : 1;
  const int bytes = 32 * positions * static_cast<int>(sizeof(uint32_t));
  const cudaError_t e = cudaFuncSetAttribute(
      dense_slice_kernel<NS, MAXT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(uint32_t)) << kSharedMaxW);
  if (e != cudaSuccess) return static_cast<int>(e);
  dense_slice_kernel<NS, MAXT>
      <<<keys, positions > 32 ? positions : 32, bytes, st>>>(
      fi, fo, mk, rs, n_rows, kr, r_stride, w, ns, sv);
  return static_cast<int>(cudaGetLastError());
}

// --- device-memory kernel (kSharedMaxW < w <= kMaxW) -----------------------

__global__ void __launch_bounds__(kThreads, 1)
dense_device_kernel(const uint32_t* __restrict__ f_in, uint32_t* F,
                    const uint32_t* __restrict__ masks,
                    const int32_t* __restrict__ ret_slot, int n_rows,
                    const int32_t* __restrict__ key_rows, int r_stride, int w,
                    int ns, int32_t* __restrict__ state) {
  const size_t key = blockIdx.x;
  f_in += key << w;
  F += key << w;
  masks += key * r_stride * w * ns;
  ret_slot += key * r_stride;
  state += 5 * key;
  n_rows = key_row_count(n_rows, key_rows, r_stride);
  const bool bad_rows = n_rows == kBadRows;
  if (bad_rows) n_rows = 0;
  // succ[j][s]: target states of slot j's op from source state s. All
  // 32 source bits get an entry, so a word bit at or above ns acts
  // exactly as the masks say (no transitions for real tables).
  __shared__ uint32_t succ[kMaxW][32];
  __shared__ uint32_t live_slots;

  const int tid = threadIdx.x;
  const uint32_t n_words = 1u << w;
  const uint32_t half = n_words >> 1;

  // Each thread copies the words it later reads first, so the first
  // row's barriers order these copies before any other thread reads them.
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

  if (tid == 0) {
    state[0] = bad_rows ? kBadRows : rows_done;
    state[1] = dead;
    state[2] = trunc;
    state[3] = passes;
    state[4] = sweeps;
  }
}

// Launches `keys` blocks, one key each (see key_row_count), on `stream`.
int launch(const void* f_in, void* f_out, const void* masks,
           const void* ret_slot, int n_rows, const void* key_rows,
           int r_stride, int keys, int w, int ns, void* state, void* stream) {
  if (w < 1 || w > kMaxW || ns < 1 || ns > kMaxNs || n_rows < 0 ||
      r_stride < 0 || keys < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* fi = static_cast<const uint32_t*>(f_in);
  uint32_t* fo = static_cast<uint32_t*>(f_out);
  const uint32_t* mk = static_cast<const uint32_t*>(masks);
  const int32_t* rs = static_cast<const int32_t*>(ret_slot);
  const int32_t* kr = static_cast<const int32_t*>(key_rows);
  int32_t* sv = static_cast<int32_t*>(state);
  if (w <= kSharedMaxW) {
    // w = 15 takes 1024 threads (64 registers each); below, at most 512.
    if (w == kSharedMaxW) {
      return ns <= 8 ? launch_slices<8, 1024>(fi, fo, mk, rs, n_rows, kr,
                                              r_stride, keys, w, ns, sv, st)
                     : launch_slices<32, 1024>(fi, fo, mk, rs, n_rows, kr,
                                               r_stride, keys, w, ns, sv, st);
    }
    return ns <= 8 ? launch_slices<8, 512>(fi, fo, mk, rs, n_rows, kr,
                                           r_stride, keys, w, ns, sv, st)
                   : launch_slices<32, 512>(fi, fo, mk, rs, n_rows, kr,
                                            r_stride, keys, w, ns, sv, st);
  }
  dense_device_kernel<<<keys, kThreads, 0, st>>>(fi, fo, mk, rs, n_rows, kr,
                                                 r_stride, w, ns, sv);
  return static_cast<int>(cudaGetLastError());
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
  return launch(f_in, f_out, masks, ret_slot, n_rows, nullptr, n_rows, 1, w,
                ns, state, stream);
}

// Launches one chunk for each of `keys` independent keys on `stream`, one
// block a key, all in one grid: f_in and f_out u32[keys, 2^w], masks
// u32[keys, r_pad, w, ns], ret_slot i32[keys, r_pad], n_rows i32[keys]
// (key k runs its first n_rows[k] rows; a count outside [0, r_pad] runs
// none and reads rows_done = -1) and state i32[keys, 5]. Each key stops
// at its own dead row or pass ceiling. Returns the cudaError_t of
// the launch (0 on success).
int dense_chunk_batch_launch(const void* f_in, void* f_out, const void* masks,
                             const void* ret_slot, const void* n_rows,
                             int keys, int r_pad, int w, int ns, void* state,
                             void* stream) {
  if (n_rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(f_in, f_out, masks, ret_slot, 0, n_rows, r_pad, keys, w, ns,
                state, stream);
}

}  // extern "C"
