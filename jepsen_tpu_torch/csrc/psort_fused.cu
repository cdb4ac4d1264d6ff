// psort_fused.cu — the compact register band's whole closure fixpoint in
// one launch on Hopper, single-key and pair mode.
//
// Replaces the TPU kernel jepsen_tpu/lin/psort_fused.py:fixpoint
// (pallas_call in _fixpoint_call, body _fixpoint_body, saturation
// _sat_select). A key is one u32 (key = linearized-slot bits << b |
// state id) or, in pair mode, the u64 (hi << 32) | lo of a (hi, lo) u32
// pair; the dead entry is all ones (KEY_FILL, or the (KEY_FILL, KEY_FILL)
// pair) and the invalid flag the top bit (bit 31, or hi's bit 31). Per
// pass, over the carried keys x[0 .. cap):
//
//   1. saturate each carried key: x1 = x | sats[x & (2^b - 1)] when x is
//      live (x != KEY_FILL; in pair mode hi != KEY_FILL, as the reference
//      reads liveness from hi alone), with plane 0 of sats ORed into lo
//      and, in pair mode, plane 1 into hi;
//   2. expand x1 by each mutator column c whose test passes: the column
//      is active, its precondition holds (a write, or the state id equals
//      `pre`), its key bit is not already set, its chain predecessor's bit
//      is set, and it is just-in-time useful (flag, or its read mask meets
//      an unheld read); the new key is (x1 & ~state) | or, with or's hi
//      word ORed into hi in pair mode;
//   3. sort the candidates (by (hi, lo) in pair mode), keep the first of
//      each run with the flag clear, compact;
//   4. changed = the first cap keys differ (either word) from the carried
//      ones, or the survivor count differs from the carried count;
//
// until !changed, an overflow (survivors > cap) or it_max passes.
// Outputs: lo[cap] (and hi[cap]; the first cap survivors of the last
// pass) and flags = {converged, overflow, passes, count}; on overflow
// count is the unclamped survivor total, as on the TPU. A fifth word
// beside the flags records the sort paths the passes took (bit 0 shared
// memory, bit 1 device memory).
//
// What bounds it on this card: ONE SM's barriers and shared-memory
// throughput. The reference (and this kernel before) sorted the whole
// candidate space of n_pad = pad(cap * (1 + M)) slots each pass, nearly
// all of them KEY_FILL: 136 barriered bitonic stages at n_pad 2^16, run
// through L2 above 2^15 keys. The live work is a few thousand keys: rows
// run at the smallest tier holding 4x their count, and a key has a few
// legal columns. The bytes the function must move (keys in and out, the
// tables) take well under a microsecond.
//
// Design: work on the live candidates only. A fill slot, and any
// candidate with the flag set, never survives, so the expansion writes
// only the saturated live carried keys and their legal expansions, in any
// order (the output is their sorted set): each thread takes one carried
// key, tests the M columns into a bit mask, and a warp scan of the
// thread's counts plus one shared-memory atomicAdd per warp places them
// densely. The same sweep ORs and ANDs the live keys, so the sort knows
// which 8-bit digits vary. The sort is a block-local LSD radix sort over
// the varying digits only, stable by a warp multisplit (__match_any_sync)
// as in psort.cu's dedup: per digit one counting sweep into per-warp
// histograms, one scan of them in digit-major order, one scatter sweep.
// Radix, not a bitonic network over next_pow2(n_live): at 2,048 keys the
// network is 66 barriered stages of 1,024 compare-exchanges, the radix
// sort of a 27-bit band key 4 digit passes of 7 barriers and two sweeps
// of 2 keys a thread. The first of each run is kept by a warp ballot,
// ranked by a scan of the warps' counts, and compared with the carried
// key at its rank before overwriting it, which gives `changed` without a
// second copy.
//
// Two paths, chosen inside the launch from the live count, with no host
// sync: while n_live <= kSharedN (24,576 single keys or 12,288 pairs) the
// radix ping-pong runs in dynamic shared memory (2 x 96 KiB). Above it
// (at most cap * (1 + M) keys, 2^21 at the launcher's limit) it runs on
// two device-memory buffers of cap * (1 + M) keys that the wrapper sizes
// for that worst case: the expansion already writes candidates past
// kSharedN there, and the first kSharedN are copied over. The same code
// sorts in both (generic pointers; __syncthreads orders the block's
// global-memory accesses too). The carried keys live in the output
// arrays, in device memory (L2): each pass reads them once and writes the
// survivors once. The whole it_max loop stays in one launch of one
// 1024-thread block.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see jepsen_tpu_torch/_build.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 32;
constexpr int kMaxB = 6;
constexpr int kMinN = 1024;
// The reference's clamp, 2^FUSED_MAX_EXP (jepsen_tpu/lin/psort_fused.py).
constexpr int kMaxN = 1 << 21;
constexpr int kMaxLogCap = 20;
constexpr int kDigits = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Dynamic shared memory of the shared path: two radix buffers of 96 KiB.
// With the static tables and histograms (about 34 KiB) it stays below
// the 227 KiB opt-in.
constexpr int kSharedBytes = 192 * 1024;

template <typename K>
struct KeyOf {
  static constexpr K kFill = ~K(0);
  static constexpr K kInvalid = K(1) << (8 * sizeof(K) - 1);
  // Live candidates the shared path sorts: one radix buffer's keys.
  static constexpr int kSharedN =
      kSharedBytes / 2 / static_cast<int>(sizeof(K));
};

// Column-table rows (jepsen_tpu_torch/lin/psort_fused.py COL_*): each
// mask has its lo row and its hi row just after it.
constexpr int kColExp = 0;
constexpr int kColPred = 2;
constexpr int kColRv = 4;
constexpr int kColOr = 6;
constexpr int kColPre = 8;
constexpr int kColFlags = 9;
constexpr uint32_t kFlagAct = 1;
constexpr uint32_t kFlagWrite = 2;
constexpr uint32_t kFlagJit = 4;
// Bits of the path word.
constexpr int kPathShared = 1;
constexpr int kPathDevice = 2;

// Word i of a (hi, lo) pair of u32 arrays as a key: lo alone for single
// keys, (hi << 32) | lo for pairs.
template <typename K>
__device__ __forceinline__ K join(const uint32_t* hi, const uint32_t* lo,
                                  int i) {
  if constexpr (sizeof(K) == 8) {
    return (static_cast<uint64_t>(hi[i]) << 32) | lo[i];
  } else {
    return lo[i];
  }
}

template <typename K>
__device__ __forceinline__ void split(uint32_t* hi, uint32_t* lo, int i,
                                      K v) {
  lo[i] = static_cast<uint32_t>(v);
  if constexpr (sizeof(K) == 8) hi[i] = static_cast<uint32_t>(v >> 32);
}

// Liveness: a single key is live unless it is KEY_FILL; a pair unless its
// hi word is.
template <typename K>
__device__ __forceinline__ bool live(K x) {
  if constexpr (sizeof(K) == 8) {
    return static_cast<uint32_t>(x >> 32) != 0xFFFFFFFFu;
  } else {
    return x != KeyOf<K>::kFill;
  }
}

template <typename K>
__device__ __forceinline__ int digit(K v, int p) {
  return static_cast<int>((v >> (8 * p)) & 0xFF);
}

// Inclusive block scan (1024 threads) with 32 ints of shared scratch.
// Ends synchronised.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return out;
}

// Keys per warp when n keys are split into 32 contiguous warp ranges of
// whole 32-key steps.
__device__ __forceinline__ int warp_span(int n) {
  return ((n + kThreads - 1) / kThreads) * 32;
}

// One stable LSD pass of the block over digit p: src[0 .. n) -> dst.
// Warp w ranks the keys of its range 32 at a time in index order (a key's
// rank among its warp's keys of its digit is the digit's running count
// plus its peers in lower lanes); the warps' counts are scanned in
// digit-major, warp-minor order, so the pass is stable. Ends
// synchronised.
template <typename K>
__device__ void radix_pass(const K* src, K* dst, int n, int p,
                           int (*hist)[kDigits + 1], int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int span = warp_span(n);
  const int lo = min(n, warp * span);
  const int hi = min(n, lo + span);
  for (int i = threadIdx.x; i < kWarps * (kDigits + 1); i += kThreads) {
    (&hist[0][0])[i] = 0;
  }
  __syncthreads();
  for (int g = lo; g < hi; g += 32) {
    const int i = g + lane;
    const bool ok = i < hi;
    const int d = ok ? digit(src[i], p) : -1;
    const unsigned act = __ballot_sync(kFull, ok);
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
    const K v = ok ? src[i] : K(0);
    const int d = ok ? digit(v, p) : -1;
    const unsigned act = __ballot_sync(kFull, ok);
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

template <typename K>
__device__ __forceinline__ void put(K* shared, K* spill, int i, K v) {
  if (i < KeyOf<K>::kSharedN) {
    shared[i] = v;
  } else {
    spill[i] = v;
  }
}

// One block per SM: every thread may take 64 registers.
template <typename K>
__global__ void __launch_bounds__(kThreads, 1)
    fixpoint_kernel(const uint32_t* lo_in, const uint32_t* hi_in,
                    const int32_t* count_in, const uint32_t* cols,
                    const uint32_t* sats, int M, int b, int log_cap,
                    int it_max, uint32_t* lo_out, uint32_t* hi_out,
                    int32_t* flags, int32_t* path, K* scratch) {
  constexpr int S = KeyOf<K>::kSharedN;
  constexpr K kInvalid = KeyOf<K>::kInvalid;
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  __shared__ K c_exp[kMaxM], c_pred[kMaxM], c_rv[kMaxM], c_or[kMaxM];
  __shared__ uint32_t c_pre[kMaxM], c_flg[kMaxM];
  __shared__ K sat[1 << kMaxB];
  __shared__ int hist[kWarps][kDigits + 1];
  __shared__ int warp_sums[32];
  __shared__ int s_live;
  __shared__ uint32_t s_or[2], s_and[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int cap = 1 << log_cap;
  const int n_sid = 1 << b;
  const K smask = static_cast<K>(n_sid - 1);
  K* A = reinterpret_cast<K*>(dyn_raw);              // shared path [S]
  K* B = A + S;
  // Device path: two buffers of the worst case, cap * (1 + M) keys each
  // (only allocated when that exceeds S).
  K* GA = scratch;
  K* GB = scratch + (static_cast<size_t>(M + 1) << log_cap);

  if (tid < M) {
    c_exp[tid] = join<K>(cols + (kColExp + 1) * M, cols + kColExp * M, tid);
    c_pred[tid] =
        join<K>(cols + (kColPred + 1) * M, cols + kColPred * M, tid);
    c_rv[tid] = join<K>(cols + (kColRv + 1) * M, cols + kColRv * M, tid);
    c_or[tid] = join<K>(cols + (kColOr + 1) * M, cols + kColOr * M, tid);
    c_pre[tid] = cols[kColPre * M + tid];
    c_flg[tid] = cols[kColFlags * M + tid];
  }
  // sats is [2, 2^b]: plane 0 for lo, plane 1 for hi.
  if (tid < n_sid) sat[tid] = join<K>(sats + n_sid, sats, tid);
  // The carried keys live in the outputs.
  for (int i = tid; i < cap; i += kThreads) {
    lo_out[i] = lo_in[i];
    if constexpr (sizeof(K) == 8) hi_out[i] = hi_in[i];
  }
  __syncthreads();

  int cnt = *count_in;
  int it = 0;
  int paths = 0;
  bool changed = true;
  bool ovf = false;
  while (changed && !ovf && it < it_max) {
    if (tid == 0) {
      s_live = 0;
      s_or[0] = s_or[1] = 0u;
      s_and[0] = s_and[1] = kFull;
    }
    __syncthreads();

    // 1-2. the live candidates: each saturated carried key whose flag is
    // clear, and its legal expansions whose flag is clear (a key with the
    // flag set, and anything expanded from it, never survives).
    K k_or = K(0);
    K k_and = ~K(0);
    for (int i0 = 0; i0 < cap; i0 += kThreads) {
      const int i = i0 + tid;
      K x = KeyOf<K>::kFill;
      if (i < cap) {
        x = join<K>(hi_out, lo_out, i);
        if (live(x)) x |= sat[static_cast<int>(x & smask)];
      }
      const bool on = (x & kInvalid) == 0;
      if (__ballot_sync(kFull, on) == 0) continue;
      uint32_t legal = 0;
      if (on) {
        const uint32_t sid = static_cast<uint32_t>(x & smask);
        const K base = x & ~smask;
        for (int c = 0; c < M; ++c) {
          const uint32_t flg = c_flg[c];
          const bool ok = (flg & kFlagAct) != 0 &&
                          ((flg & kFlagWrite) != 0 || sid == c_pre[c]) &&
                          (x & c_exp[c]) == 0 &&
                          (x & c_pred[c]) == c_pred[c] &&
                          ((flg & kFlagJit) != 0 || (c_rv[c] & ~x) != 0) &&
                          ((base | c_or[c]) & kInvalid) == 0;
          legal |= static_cast<uint32_t>(ok) << c;
        }
      }
      const int mine = on ? 1 + __popc(legal) : 0;
      int inc = mine;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, inc, d);
        if (lane >= d) inc += u;
      }
      int at = 0;
      if (lane == 31) at = atomicAdd(&s_live, inc);
      at = __shfl_sync(kFull, at, 31) + inc - mine;
      if (on) {
        put(A, GA, at++, x);
        k_or |= x;
        k_and &= x;
        const K base = x & ~smask;
        for (uint32_t m = legal; m != 0; m &= m - 1) {
          const K v = base | c_or[__ffs(m) - 1];
          put(A, GA, at++, v);
          k_or |= v;
          k_and &= v;
        }
      }
    }
    {
      const uint32_t o0 = __reduce_or_sync(kFull, static_cast<uint32_t>(k_or));
      const uint32_t a0 =
          __reduce_and_sync(kFull, static_cast<uint32_t>(k_and));
      uint32_t o1 = 0u, a1 = kFull;
      if constexpr (sizeof(K) == 8) {
        o1 = __reduce_or_sync(kFull, static_cast<uint32_t>(k_or >> 32));
        a1 = __reduce_and_sync(kFull, static_cast<uint32_t>(k_and >> 32));
      }
      if (lane == 0) {
        atomicOr(&s_or[0], o0);
        atomicAnd(&s_and[0], a0);
        if constexpr (sizeof(K) == 8) {
          atomicOr(&s_or[1], o1);
          atomicAnd(&s_and[1], a1);
        }
      }
    }
    __syncthreads();
    const int n = s_live;
    // Bits that differ between two live keys.
    K vary = static_cast<K>(s_or[0] ^ s_and[0]);
    if constexpr (sizeof(K) == 8) {
      vary |= static_cast<K>(s_or[1] ^ s_and[1]) << 32;
    }

    // 3a. the sort, in shared memory or in the device buffers.
    K* src = A;
    K* dst = B;
    if (n > S) {
      for (int i = tid; i < S; i += kThreads) GA[i] = A[i];
      src = GA;
      dst = GB;
      paths |= kPathDevice;
      __syncthreads();
    } else {
      paths |= kPathShared;
    }
    if (n > 1) {
      for (int p = 0; p < static_cast<int>(sizeof(K)); ++p) {
        if (((vary >> (8 * p)) & 0xFF) == 0) continue;
        radix_pass(src, dst, n, p, hist, warp_sums);
        K* t = src;
        src = dst;
        dst = t;
      }
    }

    // 3b. the first of each run, ranked: warp w's range counts its
    // survivors, a warp scan of the counts gives each range's first rank.
    const int span = warp_span(n);
    const int lo = min(n, warp * span);
    const int hi = min(n, lo + span);
    int wc = 0;
    for (int g = lo; g < hi; g += 32) {
      const int i = g + lane;
      const bool keep = i < hi && (i == 0 || src[i] != src[i - 1]);
      wc += __popc(__ballot_sync(kFull, keep));
    }
    if (lane == 0) warp_sums[warp] = wc;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += u;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int total = warp_sums[31];

    // 3c-4. write the survivors of rank < cap over the carried keys,
    // noting any difference; KEY_FILL past the survivors.
    bool diff = false;
    int rank = warp > 0 ? warp_sums[warp - 1] : 0;
    for (int g = lo; g < hi && rank < cap; g += 32) {
      const int i = g + lane;
      const K v = i < hi ? src[i] : K(0);
      const bool keep = i < hi && (i == 0 || v != src[i - 1]);
      const unsigned m = __ballot_sync(kFull, keep);
      const int k = rank + __popc(m & below);
      if (keep && k < cap) {
        diff |= join<K>(hi_out, lo_out, k) != v;
        split<K>(hi_out, lo_out, k, v);
      }
      rank += __popc(m);
    }
    for (int i = total + tid; i < cap; i += kThreads) {
      diff |= join<K>(hi_out, lo_out, i) != KeyOf<K>::kFill;
      split<K>(hi_out, lo_out, i, KeyOf<K>::kFill);
    }
    changed = __syncthreads_or(diff) != 0 || total != cnt;
    cnt = total;
    ovf = total > cap;
    ++it;
  }

  if (tid == 0) {
    flags[0] = (!changed && !ovf) ? 1 : 0;
    flags[1] = ovf ? 1 : 0;
    flags[2] = it;
    flags[3] = cnt;
    *path = paths;
  }
}

template <typename K>
int launch(const uint32_t* li, const uint32_t* hi, const int32_t* ci,
           const uint32_t* co, const uint32_t* sa, int M, int b, int log_cap,
           int it_max, uint32_t* lout, uint32_t* hout, int32_t* fl,
           int32_t* path, void* scratch, cudaStream_t st) {
  if ((static_cast<long long>(M + 1) << log_cap) > KeyOf<K>::kSharedN &&
      scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t e = cudaFuncSetAttribute(
      fixpoint_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSharedBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fixpoint_kernel<K><<<1, kThreads, kSharedBytes, st>>>(
      li, hi, ci, co, sa, M, b, log_cap, it_max, lout, hout, fl, path,
      static_cast<K*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Live candidates the shared-memory path sorts, for single keys (pair =
// 0) or pairs (pair = 1); a pass with more runs in device memory.
int psort_fused_shared_max_n(int pair) {
  return pair ? KeyOf<uint64_t>::kSharedN : KeyOf<uint32_t>::kSharedN;
}

// Device pointers: lo_in u32[cap], hi_in u32[cap] (pairs; null for single
// keys), count_in i32[1], cols u32[10, M], sats u32[2, 2^b], lo_out
// u32[cap], hi_out u32[cap] (pairs; null for single keys), flags i32[4],
// path i32[1], scratch of 2 * cap * (1 + M) keys (4 bytes each, 8 for
// pairs) when cap * (1 + M) exceeds psort_fused_shared_max_n, else
// unused and may be null. cap = 2^log_cap; n_pad = pad(cap * (1 + M)) is
// validated, as the engine's size gate. Returns the cudaError_t of the
// launch (0 on success).
int psort_fused_launch(const void* lo_in, const void* hi_in,
                       const void* count_in, const void* cols,
                       const void* sats, int M, int b, int log_cap, int n_pad,
                       int it_max, void* lo_out, void* hi_out, void* flags,
                       void* path, void* scratch, void* stream) {
  const bool pair = hi_in != nullptr;
  if (M < 1 || M > kMaxM || b < 1 || b > kMaxB || log_cap < 0 ||
      log_cap > kMaxLogCap || n_pad < kMinN || n_pad > kMaxN ||
      (n_pad & (n_pad - 1)) ||
      (static_cast<long long>(M + 1) << log_cap) > n_pad || it_max < 0 ||
      pair != (hi_out != nullptr) || path == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* li = static_cast<const uint32_t*>(lo_in);
  const uint32_t* hi = static_cast<const uint32_t*>(hi_in);
  const int32_t* ci = static_cast<const int32_t*>(count_in);
  const uint32_t* co = static_cast<const uint32_t*>(cols);
  const uint32_t* sa = static_cast<const uint32_t*>(sats);
  uint32_t* lout = static_cast<uint32_t*>(lo_out);
  uint32_t* hout = static_cast<uint32_t*>(hi_out);
  int32_t* fl = static_cast<int32_t*>(flags);
  int32_t* pa = static_cast<int32_t*>(path);
  if (pair) {
    return launch<uint64_t>(li, hi, ci, co, sa, M, b, log_cap, it_max, lout,
                            hout, fl, pa, scratch, st);
  }
  return launch<uint32_t>(li, hi, ci, co, sa, M, b, log_cap, it_max, lout,
                          hout, fl, pa, scratch, st);
}

}  // extern "C"
