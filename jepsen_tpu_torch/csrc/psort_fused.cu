// psort_fused.cu — the compact register band's whole closure fixpoint in
// one launch on Hopper, single-key and pair mode.
//
// Replaces the TPU kernel jepsen_tpu/lin/psort_fused.py:fixpoint
// (pallas_call in _fixpoint_call, body _fixpoint_body, saturation
// _sat_select). A key is one u32 (key = linearized-slot bits << b |
// state id) or, in pair mode, the u64 (hi << 32) | lo of a (hi, lo) u32
// pair; the dead entry is all ones (KEY_FILL, or the (KEY_FILL, KEY_FILL)
// pair) and the invalid flag the top bit (bit 31, or hi's bit 31). Per
// pass, over a candidate space of n_pad = pad(cap * (1 + M)) keys:
//
//   1. saturate each carried key: x1 = x | sats[x & (2^b - 1)] when x is
//      live (x != KEY_FILL; in pair mode hi != KEY_FILL, as the reference
//      reads liveness from hi alone), with plane 0 of sats ORed into lo
//      and, in pair mode, plane 1 into hi;
//   2. block 0 (indices 0 .. cap) is the carried keys x1; block k
//      (1 <= k <= M) is the expansion of the carried key at i - k*cap by
//      mutator column k-1, KEY_FILL unless the column is active, its
//      precondition holds (a write, or the state id equals `pre`), its
//      key bit is not already set, its chain predecessor's bit is set,
//      and it is just-in-time useful (flag, or its read mask meets an
//      unheld read); the new key is (x1 & ~state) | or, with or's hi word
//      ORed into hi in pair mode; the column masks (key bit, chain, read
//      mask) combine both words; indices past (1 + M) * cap are KEY_FILL;
//   3. sort (by (hi, lo) in pair mode), keep the first of each run with
//      the flag clear, compact;
//   4. changed = the first cap keys differ (either word) from the carried
//      ones, or the survivor count differs from the carried count;
//
// until !changed, an overflow (survivors > cap) or it_max passes.
// Outputs: lo[cap] (and hi[cap]; the first cap survivors of the last
// pass) and flags = {converged, overflow, passes, count}; on overflow
// count is the unclamped survivor total, as on the TPU.
//
// Design. One block of 1024 threads runs the whole loop, as the Pallas
// kernel does on its one core. The kernel is a template on the key type
// (uint32_t, or uint64_t for pairs, which turns the lexicographic pair
// compare into one unsigned compare and every column test into one 64-bit
// mask test). In the pair band lo's bit 31 is payload, never a flag: the
// flag of a u64 key is bit 63. The candidate array and the carried keys
// live in dynamic shared memory when n_pad is at most 2^15 single keys or
// 2^14 pairs (size * (n_pad + cap) <= 192 KiB of the 227 KiB opt-in);
// above that they live in device memory (a scratch buffer of n_pad + cap
// keys, at most 4.5 MiB, resident in the 50 MB L2) and the same code runs
// on them: __syncthreads orders the block's global-memory accesses too.
// The sort is a bitonic network (its output is the sorted array, so the
// result equals the TPU kernel's); compaction is a block-wide scan of
// per-thread survivor counts over contiguous segments, and each
// survivor's thread compares it with the carried key at its rank before
// overwriting it, which gives `changed` without a second copy of the
// frontier.
//
// What bounds it on this card: barriers and instruction throughput on
// ONE SM. A pass over n_pad keys is log2(n_pad) * (log2(n_pad) + 1) / 2
// barriered sort stages; the other 131 SMs idle. The bytes the function
// must move (the keys in and out, the tables) take well under a
// microsecond. A later change can spread the sort over a thread-block
// cluster or batch rows.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see jepsen_tpu_torch/_build.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxM = 32;
constexpr int kMaxB = 6;
constexpr int kMinN = 1024;
constexpr int kMaxN = 1 << 19;
// Shared memory for the candidates and the carried keys: 2^15 single keys
// (128 KiB) or 2^14 pairs, plus the carried keys (cap <= n_pad / (1 + M),
// so at most half as many), 192 KiB in both modes, below the 227 KiB
// opt-in.
constexpr int kSharedBytes = 4 * ((1 << 15) + (1 << 14));

template <typename K>
struct KeyOf {
  static constexpr K kFill = ~K(0);
  static constexpr K kInvalid = K(1) << (8 * sizeof(K) - 1);
  // Largest candidate space kept in shared memory.
  static constexpr int kSharedMaxN =
      (1 << 15) / (static_cast<int>(sizeof(K)) / 4);
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

__device__ __forceinline__ int pair_lo(int p, int j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// Inclusive block scan (1024 threads) with 32 ints of shared scratch.
// Ends synchronised.
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
    int w = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += u;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return out;
}

template <bool kShared, typename K>
__global__ void __launch_bounds__(kThreads)
    fixpoint_kernel(const uint32_t* lo_in, const uint32_t* hi_in,
                    const int32_t* count_in, const uint32_t* cols,
                    const uint32_t* sats, int M, int b, int log_cap,
                    int n_pad, int it_max, uint32_t* lo_out,
                    uint32_t* hi_out, int32_t* flags, K* scratch) {
  extern __shared__ __align__(16) unsigned char dyn_raw[];
  __shared__ K c_exp[kMaxM], c_pred[kMaxM], c_rv[kMaxM], c_or[kMaxM];
  __shared__ uint32_t c_pre[kMaxM], c_flg[kMaxM];
  __shared__ K sat[1 << kMaxB];
  __shared__ int warp_sums[32];
  __shared__ int s_total;

  const int tid = threadIdx.x;
  const int cap = 1 << log_cap;
  const int n_sid = 1 << b;
  const K smask = static_cast<K>(n_sid - 1);
  K* base = kShared ? reinterpret_cast<K*>(dyn_raw) : scratch;
  K* C = base;                                       // candidates [n_pad]
  K* X = base + n_pad;                               // carried keys [cap]

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
  for (int i = tid; i < cap; i += kThreads) X[i] = join<K>(hi_in, lo_in, i);
  __syncthreads();

  const int seg = n_pad / kThreads;                  // n_pad >= 1024
  const int span = (M + 1) << log_cap;
  int cnt = *count_in;
  int it = 0;
  bool changed = true;
  bool ovf = false;
  while (changed && !ovf && it < it_max) {
    // 1-2. saturated carried keys and their expansions.
    for (int i = tid; i < n_pad; i += kThreads) {
      K v = KeyOf<K>::kFill;
      if (i < span) {
        const int kb = i >> log_cap;
        K x = X[i - (kb << log_cap)];
        const bool on = live(x);
        if (on) x |= sat[static_cast<int>(x & smask)];
        if (kb == 0) {
          v = x;
        } else if (on) {
          const int c = kb - 1;
          const uint32_t flg = c_flg[c];
          const bool okc = (flg & kFlagWrite) != 0 ||
                           static_cast<uint32_t>(x & smask) == c_pre[c];
          const bool already = (x & c_exp[c]) != 0;
          const bool chain = (x & c_pred[c]) == c_pred[c];
          const bool jit = (flg & kFlagJit) != 0 || (c_rv[c] & ~x) != 0;
          if ((flg & kFlagAct) && okc && !already && chain && jit) {
            v = (x & ~smask) | c_or[c];
          }
        }
      }
      C[i] = v;
    }
    __syncthreads();

    // 3a. bitonic sort of C, ascending as unsigned keys.
    for (int k = 2; k <= n_pad; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = tid; p < n_pad / 2; p += kThreads) {
          const int i = pair_lo(p, j);
          const K a = C[i];
          const K c = C[i + j];
          if ((a > c) == ((i & k) == 0)) {
            C[i] = c;
            C[i + j] = a;
          }
        }
        __syncthreads();
      }
    }

    // 3b. survivors per contiguous segment, then their ranks.
    const int seg_lo = tid * seg;
    int mine = 0;
    for (int i = seg_lo; i < seg_lo + seg; ++i) {
      const K v = C[i];
      mine += ((v & KeyOf<K>::kInvalid) == 0 && (i == 0 || v != C[i - 1]))
                  ? 1 : 0;
    }
    const int incl = block_inclusive_scan(mine, warp_sums);
    if (tid == kThreads - 1) s_total = incl;
    __syncthreads();
    const int total = s_total;

    // 3c-4. write the survivors of rank < cap over the carried keys,
    // noting any difference; KEY_FILL past the survivors.
    bool diff = false;
    int rank = incl - mine;
    for (int i = seg_lo; i < seg_lo + seg && rank < cap; ++i) {
      const K v = C[i];
      if ((v & KeyOf<K>::kInvalid) == 0 && (i == 0 || v != C[i - 1])) {
        diff |= X[rank] != v;
        X[rank] = v;
        ++rank;
      }
    }
    for (int i = total + tid; i < cap; i += kThreads) {
      diff |= X[i] != KeyOf<K>::kFill;
      X[i] = KeyOf<K>::kFill;
    }
    changed = __syncthreads_or(diff) != 0 || total != cnt;
    cnt = total;
    ovf = total > cap;
    ++it;
  }

  for (int i = tid; i < cap; i += kThreads) split<K>(hi_out, lo_out, i, X[i]);
  if (tid == 0) {
    flags[0] = (!changed && !ovf) ? 1 : 0;
    flags[1] = ovf ? 1 : 0;
    flags[2] = it;
    flags[3] = cnt;
  }
}

template <typename K>
int launch(const uint32_t* li, const uint32_t* hi, const int32_t* ci,
           const uint32_t* co, const uint32_t* sa, int M, int b, int log_cap,
           int n_pad, int it_max, uint32_t* lout, uint32_t* hout,
           int32_t* fl, void* scratch, cudaStream_t st) {
  const int keys = n_pad + (1 << log_cap);
  if (n_pad <= KeyOf<K>::kSharedMaxN) {
    cudaError_t e = cudaFuncSetAttribute(
        fixpoint_kernel<true, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSharedBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    fixpoint_kernel<true, K><<<1, kThreads, sizeof(K) * keys, st>>>(
        li, hi, ci, co, sa, M, b, log_cap, n_pad, it_max, lout, hout, fl,
        nullptr);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fixpoint_kernel<false, K><<<1, kThreads, 0, st>>>(
        li, hi, ci, co, sa, M, b, log_cap, n_pad, it_max, lout, hout, fl,
        static_cast<K*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest candidate space kept in shared memory, for single keys
// (pair = 0) or pairs (pair = 1); larger ones live in device memory.
int psort_fused_shared_max_n(int pair) {
  return pair ? KeyOf<uint64_t>::kSharedMaxN : KeyOf<uint32_t>::kSharedMaxN;
}

// Device pointers: lo_in u32[cap], hi_in u32[cap] (pairs; null for single
// keys), count_in i32[1], cols u32[10, M], sats u32[2, 2^b], lo_out
// u32[cap], hi_out u32[cap] (pairs; null for single keys), flags i32[4],
// scratch of n_pad + cap keys (4 bytes each, 8 for pairs; used above the
// shared-memory bound, may be null below). cap = 2^log_cap. Returns the
// cudaError_t of the launch (0 on success).
int psort_fused_launch(const void* lo_in, const void* hi_in,
                       const void* count_in, const void* cols,
                       const void* sats, int M, int b, int log_cap, int n_pad,
                       int it_max, void* lo_out, void* hi_out, void* flags,
                       void* scratch, void* stream) {
  const bool pair = hi_in != nullptr;
  if (M < 1 || M > kMaxM || b < 1 || b > kMaxB || log_cap < 0 ||
      log_cap > 19 || n_pad < kMinN || n_pad > kMaxN ||
      (n_pad & (n_pad - 1)) || ((M + 1) << log_cap) > n_pad || it_max < 0 ||
      pair != (hi_out != nullptr)) {
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
  if (pair) {
    return launch<uint64_t>(li, hi, ci, co, sa, M, b, log_cap, n_pad, it_max,
                            lout, hout, fl, scratch, st);
  }
  return launch<uint32_t>(li, hi, ci, co, sa, M, b, log_cap, n_pad, it_max,
                          lout, hout, fl, scratch, st);
}

}  // extern "C"
