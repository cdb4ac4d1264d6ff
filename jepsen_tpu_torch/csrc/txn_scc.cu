// txn_scc.cu — the transaction checker's SCC program (trim, forward
// min-label, backward flag) in one cooperative launch on Hopper.
//
// Replaces jepsen_tpu/txn/device.py:_scc_program, a jitted XLA program
// of three lax.while_loops (not a pallas_call site). Over a window of the
// dependency graph, flat edge arrays src/dst/live (padded edges point at
// node 0 with live = 0) and n live nodes of n_pad:
//
//   1. trim: a node stays alive while it has an in-edge and an out-edge
//      among live edges whose two ends are alive; the fixpoint is the
//      cycle core;
//   2. forward min-label over the core's edges: lab[dst] = min(lab[dst],
//      lab[src]), from lab[v] = v on the core and n_pad elsewhere;
//   3. backward flag over core edges within one label: flag[src] |=
//      flag[dst], seeded where lab[v] == v.
//
// Each loop runs while its last round changed something and fewer than
// it_max rounds ran (the reference's `changed & (it < it_max)`), and
// reports its rounds in iters[3] and its last round's changed flag in
// overflow[3]: a round at it == it_max that changed nothing is no
// overflow.
//
// Rounds are Jacobi, as the reference's: a round reads the previous
// round's arrays only. Each round is an edge pass, a grid barrier, a
// node pass and a grid barrier. The edge pass reads the node state and
// writes a second array (in/out marks, the next labels or flags); the
// node pass folds that array into the state, notes whether any node
// changed, and leaves both arrays equal for the next round. An in-place
// update would reach the same fixpoint in fewer rounds, and so report
// other iteration counts and other overflows than the reference.
//
// What bounds it on this card: the grid barriers. On the main path's
// largest shape (a 32,768-node window of ~91k edges, 2,734 trim rounds
// then 2 + 2) a round moves about 1 MB, which L2 holds, so each round is
// two barriers across the grid plus a pass of a few microseconds. One
// launch instead of one host-driven round trip per round is the design:
// grid-wide synchronisation (cooperative groups' grid.sync) between
// rounds, the changed flag in a ring of three device words so that
// clearing the next round's word never races a read of this one. The
// grid is one block a multiprocessor, capped at one thread per edge or
// node so a small window syncs a small grid: a barrier's cost grows
// with the blocks it waits for (on an H100 at 700 W the main path's
// shape took 13.7-13.8 ms a launch at 132 blocks, 15.3-15.4 ms at the
// co-resident maximum of 512), and grid-stride loops cover any size, so
// no size gate is needed. Degrees
// are only tested for > 0, so the edge pass stores 1 into in/out marks
// (a benign race of equal values) instead of counting; labels take
// atomicMin. Words other blocks write during the launch are read with
// __ldcg (L2, not the SM's L1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int ld(const int* p) { return __ldcg(p); }

// The end of a round: publish whether this block changed a node into
// chg[g % 3], clear the word round g + 1 will use, sync, and read the
// verdict. Every thread of the grid returns the same value.
__device__ __forceinline__ bool round_end(cg::grid_group& grid, int* chg,
                                          int g, bool mine, bool lead) {
  if (__syncthreads_or(mine) && threadIdx.x == 0) {
    chg[g % 3] = 1;
  }
  if (lead) {
    chg[(g + 1) % 3] = 0;
  }
  grid.sync();
  return *reinterpret_cast<volatile int*>(chg + g % 3) != 0;
}

__global__ void __launch_bounds__(kThreads)
    txn_scc_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                   const uint8_t* __restrict__ live, int e_pad, int n,
                   int n_pad, int it_max, int* out, int* scratch,
                   uint8_t* em) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  int* alive = out;
  int* lab = out + n_pad;
  int* flag = out + 2 * n_pad;
  int* iters = out + 3 * n_pad;
  int* overflow = iters + 3;
  int* has_in = scratch;
  int* has_out = scratch + n_pad;
  int* nxt = scratch + 2 * n_pad;
  int* chg = scratch + 3 * n_pad;

  for (int v = tid; v < n_pad; v += stride) {
    alive[v] = v < n;
  }
  grid.sync();
  int g = 0;

  // 1. Trim to the cycle core.
  int it = 0;
  bool ch = true;
  while (ch && it < it_max) {
    for (int e = tid; e < e_pad; e += stride) {
      if (live[e]) {
        const int s = __ldg(src + e), d = __ldg(dst + e);
        if (ld(alive + s) && ld(alive + d)) {
          has_out[s] = 1;
          has_in[d] = 1;
        }
      }
    }
    grid.sync();
    bool mine = false;
    for (int v = tid; v < n_pad; v += stride) {
      const int hi = ld(has_in + v), ho = ld(has_out + v);
      if (ld(alive + v) && !(hi && ho)) {
        alive[v] = 0;
        mine = true;
      }
      if (hi) has_in[v] = 0;
      if (ho) has_out[v] = 0;
    }
    ch = round_end(grid, chg, g++, mine, lead);
    ++it;
  }
  if (lead) {
    iters[0] = it;
    overflow[0] = ch;
  }

  // The core's edges, and labels v on the core, n_pad elsewhere.
  for (int e = tid; e < e_pad; e += stride) {
    em[e] = live[e] && ld(alive + __ldg(src + e)) &&
            ld(alive + __ldg(dst + e));
  }
  for (int v = tid; v < n_pad; v += stride) {
    const int l = ld(alive + v) ? v : n_pad;
    lab[v] = l;
    nxt[v] = l;
  }
  grid.sync();

  // 2. Forward min-label.
  it = 0;
  ch = true;
  while (ch && it < it_max) {
    for (int e = tid; e < e_pad; e += stride) {
      if (em[e]) {
        const int l = ld(lab + __ldg(src + e));
        int* t = nxt + __ldg(dst + e);
        if (l < ld(t)) atomicMin(t, l);
      }
    }
    grid.sync();
    bool mine = false;
    for (int v = tid; v < n_pad; v += stride) {
      const int l = ld(nxt + v);
      if (l != ld(lab + v)) {
        lab[v] = l;
        mine = true;
      }
    }
    ch = round_end(grid, chg, g++, mine, lead);
    ++it;
  }
  if (lead) {
    iters[1] = it;
    overflow[1] = ch;
  }

  // Core edges within one label; flags seeded at each label's root.
  for (int e = tid; e < e_pad; e += stride) {
    if (em[e]) {
      em[e] = ld(lab + __ldg(src + e)) == ld(lab + __ldg(dst + e));
    }
  }
  for (int v = tid; v < n_pad; v += stride) {
    const int f = ld(alive + v) && ld(lab + v) == v;
    flag[v] = f;
    nxt[v] = f;
  }
  grid.sync();

  // 3. Backward flag within each label region.
  it = 0;
  ch = true;
  while (ch && it < it_max) {
    for (int e = tid; e < e_pad; e += stride) {
      if (em[e] && ld(flag + __ldg(dst + e))) {
        nxt[__ldg(src + e)] = 1;
      }
    }
    grid.sync();
    bool mine = false;
    for (int v = tid; v < n_pad; v += stride) {
      const int f = ld(nxt + v);
      if (f != ld(flag + v)) {
        flag[v] = f;
        mine = true;
      }
    }
    ch = round_end(grid, chg, g++, mine, lead);
    ++it;
  }
  if (lead) {
    iters[2] = it;
    overflow[2] = ch;
  }
}

int grid_for(int e_pad, int n_pad, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = e_pad > n_pad ? e_pad : n_pad;
  const int want = (most + kThreads - 1) / kThreads;
  const int g = want < sms ? want : sms;
  *grid = g < 1 ? 1 : g;
  return 0;
}

}  // namespace

extern "C" {

// Threads a block of the launch runs.
int txn_scc_threads() { return kThreads; }

// The grid a launch at (e_pad, n_pad) takes on the current device.
// Returns the grid, or minus the cudaError_t of the query.
int txn_scc_grid(int e_pad, int n_pad) {
  int grid = 0;
  const int err = grid_for(e_pad, n_pad, &grid);
  return err ? -err : grid;
}

// Device pointers: src, dst int32[e_pad], live uint8[e_pad] (0 or 1),
// out int32[3 * n_pad + 6] = alive[n_pad] | lab[n_pad] | flag[n_pad] |
// iters[3] | overflow[3], scratch int32[3 * n_pad + 4] zeroed by the
// caller, em uint8[e_pad]. Launches on `stream` without synchronising.
// Returns the cudaError_t of the launch (0 on success); a grid the card
// cannot hold co-resident is refused by the launch, not shrunk.
int txn_scc_launch(const void* src, const void* dst, const void* live,
                   int e_pad, int n, int n_pad, int it_max, void* out,
                   void* scratch, void* em, void* stream) {
  if (e_pad < 1 || n_pad < 1 || n < 0 || n > n_pad || src == nullptr ||
      dst == nullptr || live == nullptr || out == nullptr ||
      scratch == nullptr || em == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int grid = 0;
  const int err = grid_for(e_pad, n_pad, &grid);
  if (err) return err;
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* l = static_cast<const uint8_t*>(live);
  int* o = static_cast<int*>(out);
  int* sc = static_cast<int*>(scratch);
  uint8_t* m = static_cast<uint8_t*>(em);
  void* args[] = {&s, &d, &l, &e_pad, &n, &n_pad, &it_max, &o, &sc, &m};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(txn_scc_kernel), dim3(grid), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // extern "C"
