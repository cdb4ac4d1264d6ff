// psort_fused.cu — the compact register band's whole closure fixpoint in
// one launch on Hopper, single-key mode.
//
// Replaces the TPU kernel jepsen_tpu/lin/psort_fused.py:fixpoint
// (pallas_call in _fixpoint_call, body _fixpoint_body, saturation
// _sat_select) for single-u32 keys (key = linearized-slot bits << b |
// state id, KEY_FILL = 0xFFFFFFFF for a dead entry). Per pass, over a
// candidate space of n_pad = pad(cap * (1 + M)) keys:
//
//   1. saturate each carried key: x1 = x | sats[0][x & (2^b - 1)] when
//      x is live (x != KEY_FILL);
//   2. block 0 (indices 0 .. cap) is the carried keys x1; block k
//      (1 <= k <= M) is the expansion of the carried key at i - k*cap by
//      mutator column k-1, KEY_FILL unless the column is active, its
//      precondition holds (a write, or the state id equals `pre`), its
//      key bit is not already set, its chain predecessor's bit is set,
//      and it is just-in-time useful (flag, or its read mask meets an
//      unheld read); the new key is (x1 & ~state) | or_lo; indices past
//      (1 + M) * cap are KEY_FILL;
//   3. sort, keep the first of each run with bit 31 clear, compact;
//   4. changed = the first cap keys differ from the carried ones, or the
//      survivor count differs from the carried count;
//
// until !changed, an overflow (survivors > cap) or it_max passes.
// Outputs: lo[cap] (the first cap survivors of the last pass) and
// flags = {converged, overflow, passes, count}; on overflow count is the
// unclamped survivor total, as on the TPU.
//
// Design. One block of 1024 threads runs the whole loop, as the Pallas
// kernel does on its one core. The candidate array and the carried keys
// live in dynamic shared memory when n_pad <= 2^15 (4 * (n_pad + cap) <=
// 160 KiB of the 227 KiB opt-in); above that they live in device memory
// (a scratch buffer and the output, at most 2.5 MiB, resident in the
// 50 MB L2) and the same code runs on them: __syncthreads orders the
// block's global-memory accesses too. The sort is a bitonic network (its
// output is the sorted array, so the result equals the TPU kernel's);
// compaction is a block-wide scan of per-thread survivor counts over
// contiguous segments, and each survivor's thread compares it with the
// carried key at its rank before overwriting it, which gives `changed`
// without a second copy of the frontier.
//
// What bounds it on this card: barriers and instruction throughput on
// ONE SM. A pass over n_pad keys is log2(n_pad) * (log2(n_pad) + 1) / 2
// barriered sort stages; the other 131 SMs idle. The bytes the function must move (lo
// in and out, the tables) take well under a microsecond. A later change
// can spread the sort over a thread-block cluster or batch rows.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (see jepsen_tpu_torch/_build.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFill = 0xFFFFFFFFu;
constexpr uint32_t kInvalid = 0x80000000u;
constexpr int kThreads = 1024;
constexpr int kMaxM = 32;
constexpr int kMaxB = 6;
constexpr int kMinN = 1024;
constexpr int kMaxN = 1 << 19;
// Largest candidate space kept in shared memory: 2^15 keys = 128 KiB,
// plus the carried keys (cap <= n_pad / (1 + M), so at most 64 KiB),
// below the 227 KiB opt-in.
constexpr int kSharedMaxN = 1 << 15;

// Column-table rows (jepsen_tpu_torch/lin/psort_fused.py COL_*).
constexpr int kColExpLo = 0;
constexpr int kColPredLo = 2;
constexpr int kColRvLo = 4;
constexpr int kColOrLo = 6;
constexpr int kColPre = 8;
constexpr int kColFlags = 9;
constexpr uint32_t kFlagAct = 1;
constexpr uint32_t kFlagWrite = 2;
constexpr uint32_t kFlagJit = 4;

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

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    fixpoint_kernel(const uint32_t* lo_in, const int32_t* count_in,
                    const uint32_t* cols, const uint32_t* sats, int M, int b,
                    int log_cap, int n_pad, int it_max, uint32_t* lo_out,
                    int32_t* flags, uint32_t* scratch) {
  extern __shared__ uint32_t dyn[];
  __shared__ uint32_t c_exp[kMaxM], c_pred[kMaxM], c_rv[kMaxM], c_or[kMaxM],
      c_pre[kMaxM], c_flg[kMaxM];
  __shared__ uint32_t sat[1 << kMaxB];
  __shared__ int warp_sums[32];

  const int tid = threadIdx.x;
  const int cap = 1 << log_cap;
  const uint32_t smask = (1u << b) - 1u;
  uint32_t* C = kShared ? dyn : scratch;             // candidates [n_pad]
  uint32_t* X = kShared ? dyn + n_pad : lo_out;      // carried keys [cap]

  if (tid < M) {
    c_exp[tid] = cols[kColExpLo * M + tid];
    c_pred[tid] = cols[kColPredLo * M + tid];
    c_rv[tid] = cols[kColRvLo * M + tid];
    c_or[tid] = cols[kColOrLo * M + tid];
    c_pre[tid] = cols[kColPre * M + tid];
    c_flg[tid] = cols[kColFlags * M + tid];
  }
  if (tid < (1 << b)) sat[tid] = sats[tid];
  for (int i = tid; i < cap; i += kThreads) X[i] = lo_in[i];
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
      uint32_t v = kFill;
      if (i < span) {
        const int kb = i >> log_cap;
        uint32_t x = X[i - (kb << log_cap)];
        if (x != kFill) x |= sat[x & smask];
        if (kb == 0) {
          v = x;
        } else if (x != kFill) {
          const int c = kb - 1;
          const uint32_t flg = c_flg[c];
          const bool okc = (flg & kFlagWrite) != 0 || (x & smask) == c_pre[c];
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

    // 3a. bitonic sort of C, ascending as u32.
    for (int k = 2; k <= n_pad; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = tid; p < n_pad / 2; p += kThreads) {
          const int i = pair_lo(p, j);
          const uint32_t a = C[i];
          const uint32_t c = C[i + j];
          if ((a > c) == ((i & k) == 0)) {
            C[i] = c;
            C[i + j] = a;
          }
        }
        __syncthreads();
      }
    }

    // 3b. survivors per contiguous segment, then their ranks.
    const int lo = tid * seg;
    int mine = 0;
    for (int i = lo; i < lo + seg; ++i) {
      const uint32_t v = C[i];
      mine += ((v & kInvalid) == 0 && (i == 0 || v != C[i - 1])) ? 1 : 0;
    }
    const int incl = block_inclusive_scan(mine, warp_sums);
    __shared__ int s_total;
    if (tid == kThreads - 1) s_total = incl;
    __syncthreads();
    const int total = s_total;

    // 3c-4. write the survivors of rank < cap over the carried keys,
    // noting any difference; KEY_FILL past the survivors.
    bool diff = false;
    int rank = incl - mine;
    for (int i = lo; i < lo + seg && rank < cap; ++i) {
      const uint32_t v = C[i];
      if ((v & kInvalid) == 0 && (i == 0 || v != C[i - 1])) {
        diff |= X[rank] != v;
        X[rank] = v;
        ++rank;
      }
    }
    for (int i = total + tid; i < cap; i += kThreads) {
      diff |= X[i] != kFill;
      X[i] = kFill;
    }
    changed = __syncthreads_or(diff) != 0 || total != cnt;
    cnt = total;
    ovf = total > cap;
    ++it;
  }

  if (kShared) {
    for (int i = tid; i < cap; i += kThreads) lo_out[i] = X[i];
  }
  if (tid == 0) {
    flags[0] = (!changed && !ovf) ? 1 : 0;
    flags[1] = ovf ? 1 : 0;
    flags[2] = it;
    flags[3] = cnt;
  }
}

}  // namespace

extern "C" {

int psort_fused_shared_max_n() { return kSharedMaxN; }

// Device pointers: lo_in u32[cap], count_in i32[1], cols u32[10, M],
// sats u32[2, 2^b] (plane 0 read), lo_out u32[cap], flags i32[4],
// scratch u32[n_pad] (used when n_pad > shared max; may be null below).
// cap = 2^log_cap. Returns the cudaError_t of the launch (0 on success).
int psort_fused_launch(const void* lo_in, const void* count_in,
                       const void* cols, const void* sats, int M, int b,
                       int log_cap, int n_pad, int it_max, void* lo_out,
                       void* flags, void* scratch, void* stream) {
  if (M < 1 || M > kMaxM || b < 1 || b > kMaxB || log_cap < 0 ||
      log_cap > 19 || n_pad < kMinN || n_pad > kMaxN ||
      (n_pad & (n_pad - 1)) || ((M + 1) << log_cap) > n_pad || it_max < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* li = static_cast<const uint32_t*>(lo_in);
  const int32_t* ci = static_cast<const int32_t*>(count_in);
  const uint32_t* co = static_cast<const uint32_t*>(cols);
  const uint32_t* sa = static_cast<const uint32_t*>(sats);
  uint32_t* lout = static_cast<uint32_t*>(lo_out);
  int32_t* fl = static_cast<int32_t*>(flags);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  if (n_pad <= kSharedMaxN) {
    const int bytes = static_cast<int>(sizeof(uint32_t)) *
                      (n_pad + (1 << log_cap));
    cudaError_t e = cudaFuncSetAttribute(
        fixpoint_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(uint32_t)) * (kSharedMaxN + kSharedMaxN / 2));
    if (e != cudaSuccess) return static_cast<int>(e);
    fixpoint_kernel<true><<<1, kThreads, bytes, st>>>(
        li, ci, co, sa, M, b, log_cap, n_pad, it_max, lout, fl, sc);
  } else {
    if (sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fixpoint_kernel<false><<<1, kThreads, 0, st>>>(
        li, ci, co, sa, M, b, log_cap, n_pad, it_max, lout, fl, sc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
