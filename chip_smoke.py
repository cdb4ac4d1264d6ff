#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and hold each CUDA
kernel against its plain torch version.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the kernels are built from
``jepsen_tpu_torch/csrc`` first, one ``nvcc`` per source, in parallel)
and this repository; imports nothing of JAX. Phases, each of which
raises on a failure:

1. the card's name and power limit; the kernel builds;
2. kernel vs plain version on the card: seeded bitmaps, masks and return
   slots at w in {4, 10, 14, 15, 16, 18} and ns in {4, 8, 16, 32}, both
   kernels (bit-sliced, bitmap in shared memory, for w <= 15; the
   device-memory kernel above), with a case that dies, cases where
   every slot is live on every row and cases where each row changes
   one slot's masks; outputs must be bit-identical;
3. the headline: a 100k-op CAS-register history with crashed ops
   through ``checker.linearizable(algorithm="gpu", device=dev)``, which must say
   valid and must have launched the kernel; then check times and the
   kernel's time per launch (CUDA events) over the headline's chunks;
4. a window-16 history (the device-memory placement end to end);
5. a corrupted history through ``algorithm="gpu"`` and ``"cpu"``: both
   invalid, on the same op, with final paths from the GPU;
6. the plain version's time beside the kernel's at the headline's shapes;
7. the sparse kernels vs their plain versions on the card, bit-exact:
   ``dedup_keys`` at n = 2^10 ... 2^21 and the unpadded 1,500, 262,151
   and 1,048,573 (overflowing, all valid, all invalid, every key equal,
   exactly cap and cap + 1 survivors, one key apart in bit 30),
   ``compact_keys`` at n = 2^10 ... 2^19 and 1,500 through both of its
   routes (one launch, bitonic network; ascending with holes, arbitrary,
   more live keys than cap, a descent in the last live key, ascending
   across bit 31, a bit-31 key before a smaller one, every key
   KEY_FILL), which must run the one launch's ordered path and both of
   its sorted paths (shared, device memory), and ``fixpoint``
   on the sparse headline's own rows and frontiers at every row tier its
   gate admits, converged, at ``it_max=1`` and overflowing, and on an
   entry whose every column is legal for every key (the worst case), an
   empty entry and keys one bit apart in bit 30; each of its sort paths
   (shared memory, device memory) must run;
8. the sparse headline: a 20k-op, concurrency-24 CAS-register history
   (window 24) through ``checker.linearizable(algorithm="gpu")``, which
   must say valid by ``gpu-bfs`` with every sparse kernel launched and
   its known launch and fetch counts, counting ``compact_keys``'s calls
   by route, path and size (every call inside the gate
   ``psort.COMPACT_ONE_MAX_N`` must run the ordered path); then a device
   check (at 2.5k ops, to keep the script inside its time limit) with
   each kernel call's device time taken by CUDA events behind a spin
   gate (``CallTimer``);
9. a corrupted window-24 history through ``"gpu"`` and ``"cpu"``: both
   invalid on the same op and dead row, with final paths from the GPU;
10. each sparse kernel's time, its plain version's and one PyTorch
    call's (``torch.unique``, ``torch.sort``) at the headline's most
    frequent shapes, with its bound; ``fixpoint`` also at every fused
    tier, and at tier 16,384 (past its gate ``psort_fused.fits``, through
    the binding) bit-exact and beside the unfused pass chain on the
    headline's own rows; ``compact_keys`` through each route beside
    ``torch.sort`` and its plain version at every size of phase 7 on
    ascending-with-holes and arbitrary input, and at every size (row
    tier or chunk cap) the headline compacted at, on its first recorded
    input there (the measurements behind ``psort.COMPACT_ONE_MAX_N``);
    and ``dedup_keys`` at the spike tiers' sizes n = 2^19, 2^20 and
    2^21 beside the engine's torch.sort
    twin (``bfs._dedup_keys_sort``) and ``torch.unique``, on the
    headline shape's candidates tiled to each size, with its launches
    per call (the launcher's count, which must be 2 + key bytes) and
    each kernel's device µs a launch (``torch.profiler``): the
    measurements behind the dedup gate ``psort.DEDUP_MAX_N``, which
    must hold in the run;
11. the pair-key kernels vs their plain versions on the card,
    bit-exact: ``dedup_keys2`` at the sizes of phase 7 and
    ``compact_keys2`` at n = 2^10 ... 2^19 and 1,500 through both of its
    routes (one launch, bitonic network; ascending with holes, arbitrary,
    more live pairs than cap, a descent in the last live pair, a live
    pair whose hi word is KEY_FILL), which must run the one launch's
    ordered path and both of its sorted paths (shared, device memory)
    (dedup inputs: equal hi with
    different lo, lo's bit 31 as payload, holes, duplicates, all valid,
    all invalid, every pair equal, exactly cap and cap + 1 survivors, one
    pair apart in hi's bit 30 or in lo's bit 31, overflowing caps), and
    ``fixpoint`` in pair
    mode on the pair headline's own rows at every tier its gate admits,
    converged, at ``it_max=1``, overflowing, the worst case, empty, and
    keys one bit apart in hi's bit 30 or lo's bit 31, with both sort
    paths run;
12. the pair headline: a 5k-op, concurrency-30 CAS-register history
    (window 29, past one u32 key) through ``checker.linearizable``,
    valid by ``gpu-bfs`` with every pair kernel launched and its known
    launch and fetch counts, counting ``compact_keys2``'s calls by path
    (inside the gate all ordered) and recording the inputs of a few
    spike compactions (past the compaction gate); then a timed device
    check at 3.5k ops (window 29, still the pair band, which the script
    asserts), as in phase 8;
13. a corrupted window-37 history (two-word bitsets) through ``"gpu"``
    and ``"cpu"``, invalid on the same op and dead row, with final
    paths;
14. each pair kernel's time beside its plain version, one PyTorch call
    and its bound, at the pair headline's most frequent shapes, the pair
    ``fixpoint`` at every fused tier and at tier 16,384 beside the unfused
    chain, ``dedup_keys2`` at the spike sizes as in phase 10, and
    ``compact_keys2`` through each route at every size of phase 11 on
    ascending-with-holes and arbitrary input, and in one launch against
    the engine's torch.sort on the recorded spike compactions (the
    measurements behind ``psort.COMPACT2_ONE_MAX_N``);
15. the dominance dedups of the crash-dom bands vs their plain versions
    on the card, bit-exact: ``dedup_keys_dom`` and ``dedup_keys2_dom`` in
    forced mode at 2 and 6 rounds and unforced, at padded sizes 2^10 ...
    2^22, 2^24 and 2^25 (the host caps 262,144 and 524,288 x 33
    candidates), on mixed, all-invalid and long-chain inputs and on
    candidates expanded from the crash-dom headlines' own rows, and on
    valid counts just below, at and just above each one-launch path's
    shared capacity (6,144 pairs, 12,288 single-key entries), one group
    whose entries are dominated only at distance 128, and every entry
    equal, through both routes; each dedup's paths (one launch sorting
    in shared or device memory, the multi-launch chain) must all run;
16. the single-key crash-dom headline: a 5k-op partition-nemesis history
    at config 5's pacing (window 25, crashed mutators) through
    ``checker.linearizable(algorithm="gpu")``, valid by ``gpu-bfs`` with
    ``dedup_keys_dom`` launched and ``compact_keys``'s calls counted by
    route, path and size (inside the gate all ordered), then a
    clean device check and one timed per kernel call;
17. the pair-key crash-dom headline: the same at 12k ops (window 35,
    two-word bitsets), valid by
    ``gpu-bfs`` with ``dedup_keys2_dom`` launched (its run through the
    entry point is its clean run: a second would not fit the script's
    time limit);
18. the host-row executor on the card: the window-34 partition history at
    chunk cap 8 and host caps (64, 4096), valid with host rows run, and
    corrupted, invalid on the same op and dead row as the CPU oracle with
    final paths;
19. each dominance dedup's time per call at every in-chunk tier of its
    headline, through its route and each route forced, beside its plain
    version's and its bound, every candidate valid through both routes,
    and both routes on random keys at the gate (the measurements behind
    ``psort.DOM1_ONE_MAX_N`` and ``psort.DOM_ONE_MAX_N``), with its
    launches per call;
20. independent keys (``[batch-*]``): etcd's per-key register workload
    (500 keys x 300 ops, concurrency 10, four keys corrupted) and
    BASELINE config 4's shape cut to 500 keys x 100 ops, wrapped in ``KV``
    into one history each and checked through
    ``independent.checker(checker.linearizable(algorithm="gpu"))``:
    every key by ``gpu-dense-batch`` (one launch of the dense kernel
    over a grid of keys, ``dense_chunk_batch``), the failures the CPU
    oracle's, each key's verdict, dead row and op the per-key
    ``checker.linearizable`` check's, every key's bitmap and state row
    the single-key kernel's, the kernel against its plain version on 8
    keys; the batch's time with and without packing beside the per-key
    loop's and the kernel's beside its bound. Then a group that leaves
    the dense bounds (64 keys x 100 ops, the window-24 CAS-chain key and
    2 corrupted keys) through the multiword sparse batch
    (``gpu-bfs-batch``): verdicts and dead rows the CPU oracle's, final
    frontiers the CPU run's, bit for bit.
21. the generic packed and multiword bands (``[bands-*]``), each shape
    through ``checker.linearizable(algorithm="gpu")`` and held to the CPU
    oracle, with the JAX package's max cap and final frontier size as
    constants: a mutex of 100k ops at concurrency 10 with up to 16
    crashes (window 22, the generic band on single keys; config 3's
    probe shape in ``bench.py``, 5k ops at concurrency 30 with up to 4
    crashes, has 31 return rows at window 6 and plans dense), with the
    host's work over its run (CPU time, context switches, GC, load,
    allocator segments), which must launch ``dedup_keys`` and
    ``compact_keys`` once a closure pass and once a compacting return
    filter, counted by size, route and path, then both kernels held
    against their plain versions on the mutex's own inputs at its most
    frequent tier and timed there beside one PyTorch call and their
    bound; a one-word set (40 ops, generic band); a 600-op set of 16 words
    (the multiword band); a 900-op unique-value unordered queue (15
    words) and a 100-op FIFO queue (15 words). The mutex, both sets and
    the unordered queue have a corrupted twin: invalid through ``"gpu"``
    and ``"cpu"`` on the same op and dead row, with final paths. The
    multiword shapes report their rows, closure passes and fetches.

22. the pack layer (``[pack-*]``; no kernel, no ``pallas_call`` site):
    on the dense headline's history and config 5's (100k ops, window
    49) ``prepare`` plus ``reduction_tables`` by default (the native
    walk) and with ``JEPSEN_TPU_FAST_PACK=0`` (the py walk), and the
    native and vec walks alone on the same columns, best of 3
    interleaved, on the host's clock, which must give the same tables;
    ``pack_dev.materialize`` on the card of those two and phase 21's
    100k mutex, bit-exact to the host pack (every table, ``pure`` and
    ``pred``), its first call and best later call, with the host's
    prepack beside the host pack, bucket and peak device memory; then
    ``pack_dev.materialize_batch`` over ``[batch-etcd]``'s 500 keys
    (``MIN_BATCH_K`` 1), every lane bit-exact to the host pack, with the
    host's prepack beside the host pack of the same keys.
    ``dev_stats()`` must show device calls and no eligible lane on the
    host path; the phase must take under 60 s. The device packer is not
    on the main path: it does not beat the host pack (PERF.md).

23. the transaction checker (``[txn-*]``): the SCC kernel bit-exact
    against its plain version on seeded graphs, ``txn_c30`` through
    ``txn.check(algorithm="gpu")`` (one launch), a healthy history (no
    launch), a strict-serializable case, and the kernel's time;
24. the supervised runtime (``[supervise-*]``; no kernel): the pair
    crash-dom headline checked with a checkpoint written at every
    committed row (the checkpoint's overhead: its write time), resumed
    from a copy of its first host-kind checkpoint (the same verdict, max
    cap and final frontier, ``resumed-from-row`` the saved row); the
    single-key crash-dom headline the same way from a chunk-kind
    checkpoint past half its rows; the corrupted window-34 history
    resumed from its first host-kind checkpoint with a dispatch deadline
    of 0.1 ms, every real attempt of both host-row rungs overrunning and
    abandoned, the search ending in an honest ``overflow: wedge`` that
    keeps the checkpoint, and a re-run resuming from it to the
    uninterrupted dead row and op; wedges and faults injected at
    ``chunk``, ``spike``, ``host-fixpoint``, ``host-pass``, ``txn-scc``
    and ``pack-dev``, each routing as on the CPU under the card's rule
    (no rung moves work to the host); and a real, sticky CUDA fault in a
    child process (every sparse-engine launch reads address 16), which
    the check raises after recording the chunk's shape. Every earlier
    phase from 3 on runs inside ``supervised_clean``, which fails on any
    watchdog trip, fault or quarantine skip and logs the phase's
    supervised dispatches and their hand-off seconds (the watchdog's
    overhead); the run's quarantine ledger is a fresh temporary file.
25. the streaming checker (``[stream-*]``; no new kernel: its increments
    run the sparse engine's kernels through the incremental entry):
    ``[stream-clean]`` the JAX stream smoke's soak shape (a CAS register
    at concurrency 8 with up to 8 crashes, cut to 16,000 ops) through
    ``StreamChecker`` 2,000 events an append, a line an increment
    (settled rows, settle, paint and device-check seconds, band,
    frontier), valid with no degrade and the one-shot verdict, its
    late/early settle walls under 1.8; ``[stream-abort]`` the corrupted
    40,000-op crash-free twin, latched within one increment of the
    offending completion at the one-shot dead row and op, with ops left
    unfed; ``[stream-paint]`` every settle painted on the card against
    numpy's, both the one-shot pack bit for bit, and the two paints'
    times at settles of about 44 to 5,800 rows (the measurement behind
    ``pack_dev.STREAM_MIN_ROWS``); ``[stream-resume]`` a checkpointed
    session dropped after half its appends and resumed at its row by a
    fresh one, foreign events rejected; ``[stream-live]`` a
    ``LiveChecker`` fed op by op from a producer thread, latched; and
    ``[stream-wedge]`` a wedge injected at ``stream-incr`` degrading to
    the post-hoc check on the card, which a device analyzer must decide.
    ``[stream-launches]`` gives each kernel's launches by band over the
    streams (the band the sparse engine reports for each increment, the
    counts set to 0 just before it and read just after), which must launch
    ``compact_keys``, ``fixpoint`` and ``dedup_keys_dom``; the kernels
    line carries them as ``stream_launches``. Under 120 s.

``python3 chip_smoke.py --bands`` runs the build and phase 21 alone,
printing its kernels' entries and the card, and no contract line;
``--pack`` the build and phase 22 alone, ``--txn`` phase 23,
``--supervise`` phase 24 and ``--stream`` phase 25.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# Published H100 SXM HBM bandwidth (NVIDIA data sheet).
PEAK_BYTES_PER_S = 3.35e12
# The kernels' work is 32-bit integer ops. A Hopper SM issues 64 of them
# per clock (four sub-partitions of 16 INT32 lanes, NVIDIA's H100
# whitepaper); the card's peak integer rate is that times its SM count
# and its maximum SM clock, both read from the card (int32_ops_per_s).
INT32_LANES_PER_SM = 64
# Integer ops per bit-j-clear word per sweep (load, test, combine, store
# check) and per word of the return filter (move, zero); a floor on what
# the closure and filter must do.
OPS_PER_PAIR = 4
OPS_PER_FILTER_WORD = 2

HEADLINE = dict(n_ops=100_000, concurrency=5, seed=42, value_range=5,
                crash_prob=0.001, max_crashes=10)
WIDE = dict(n_ops=20_000, concurrency=5, seed=42, value_range=5,
            crash_prob=0.002, max_crashes=14)
CORRUPT = dict(n_ops=2_000, concurrency=5, seed=42, value_range=5,
               crash_prob=0.001)
CASE_WIDTHS = (4, 10, 14, 15, 16, 18)
CASE_STATES = (4, 8, 16, 32)
# (w, ns, mode) of the cases with every slot live on every row, or one
# slot's masks changed a row.
CASE_MODES = ((10, 8, "all-live"), (14, 8, "all-live"), (15, 16, "all-live"),
              (10, 8, "one-change"), (14, 8, "one-change"),
              (15, 32, "one-change"))
# Rows a case: the plain version's rows are this phase's cost, and the
# script's time limit must hold every phase.
CASE_ROWS = 120
PLAIN_ROWS = 256


T0 = time.perf_counter()


def log(*a):
    """A result line, stamped with the seconds since the script started."""
    print(f"{time.perf_counter() - T0:7.1f}s", *a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_case(rng, w, ns, rows, die_at=None, mode=None):
    """Seeded kernel inputs: a sparse entry bitmap, per-row masks from
    random partial transition functions over 70% of the slots, and return
    slots among each row's active slots. With ``die_at``, slot w-1 never
    has transitions and no entry config holds it, and it returns at row
    ``die_at``: the frontier must die exactly there. ``mode``
    "all-live": every slot has transitions on every row; "one-change":
    each row after the first keeps the previous row's masks but one
    slot's."""
    import numpy as np

    F = np.zeros(1 << w, np.uint32)
    hi = w - 1 if die_at is not None else w
    for B in rng.integers(0, 1 << hi, size=8):
        F[B] |= np.uint32(rng.integers(1, 1 << min(ns, 31)))
    F[0] |= np.uint32(1)
    masks = np.zeros((rows, w, ns), np.uint64)
    active = rng.random((rows, w)) < (1.0 if mode == "all-live" else 0.7)
    if die_at is not None:
        active[:, w - 1] = False
    legal = rng.random((rows, w, ns)) < 0.85
    target = rng.integers(0, ns, size=(rows, w, ns))
    for r, j, s in zip(*np.nonzero(active[:, :, None] & legal)):
        masks[r, j, target[r, j, s]] |= np.uint64(1) << np.uint64(s)
    if mode == "one-change":
        for r in range(1, rows):
            j = rng.integers(w)
            keep = np.arange(w) != j
            masks[r, keep] = masks[r - 1, keep]
            active[r, keep] = active[r - 1, keep]
    ret = np.zeros(rows, np.int32)
    for r in range(rows):
        cand = np.flatnonzero(active[r])
        ret[r] = rng.choice(cand) if len(cand) else 0
    if die_at is not None:
        ret[die_at] = w - 1
    return F, masks.astype(np.uint32), ret


def same_result(a, b):
    """(bit-identical, max |a - b| over the u32 words) of two chunk
    results."""
    import torch

    from jepsen_tpu_torch import _u32

    err = int((_u32.widen(a.F) - _u32.widen(b.F)).abs().max())
    same = bool(torch.equal(a.F, b.F)) and \
        a.state.tolist() == b.state.tolist()
    return same, err


def max_sm_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# Set by main() from the card before anything is timed or bounded: the
# maximum SM clock (spin kernels run at most this many cycles a second)
# and the peak 32-bit integer rate, INT32 lanes per SM times SMs times
# that clock.
SM_HZ = None
PEAK_OPS_PER_S = None


def time_chunk(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, by CUDA events, after one
    warm-up run. A spin kernel holds the stream while the host enqueues
    the runs, so the events time the device's work and not the host's
    enqueueing; a function that waits for the device inside (a plain
    version's host loop) is timed whole all the same."""
    import torch

    fn()
    if not torch.cuda.is_available():      # a CPU rehearsal: host clock
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(reps * host * 1.5 + 2e-4, 0.1) * SM_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(w, ns, rows, sweeps):
    """Least time the card could take for one chunk's work: the larger of
    its bytes (bitmap in and out, masks and return slots read once) over
    the memory rate and its integer ops over the peak rate."""
    nbytes = 2 * 4 * (1 << w) + 4 * rows * w * ns + 4 * rows
    ops = sweeps * (1 << (w - 1)) * OPS_PER_PAIR \
        + rows * (1 << w) * OPS_PER_FILTER_WORD
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


# --- the sparse engine (phases 7-14) ---------------------------------------

SPARSE = dict(n_ops=20_000, concurrency=24, seed=42, value_range=5)
# The single-key headline's per-kernel timing pass runs at this depth
# (window 23; its clean run, through the user's entry point, stays at the
# full 20k ops), to keep the script inside its time limit.
SPARSE_TIMED = dict(SPARSE, n_ops=2_500)
# The headline history with one read corrupted early (dead row 19), so
# the CPU oracle and the counterexample replay decide in seconds.
SPARSE_CORRUPT_SEED = 147
# The single-key headline's launch and fetch counts: the engine is
# deterministic, so any change to them is a change of the engine's path.
SPARSE_LAUNCHES = {"dedup_keys": 46_986, "compact_keys": 9_948,
                   "fixpoint": 12_376}
SPARSE_FETCHES = 61_995
# The pair-key headline: CockroachDB's 30 processes, window 29 (29 + 3
# state bits > 31). At 20k (and 10k) ops the frontier outgrows the last
# spike cap (overflow: capacity); 5k ops decides. Halving again gives
# window 28, which is the single-key band.
PAIR = dict(n_ops=5_000, concurrency=30, seed=42, value_range=5)
# Phase 12's timed check runs at 3,500 ops (window 29, the pair band;
# 3,200 ops is window 28, single keys), to keep the script inside its
# time limit with phase 21.
PAIR_TIMED = dict(PAIR, n_ops=3_500)
# Its launch and fetch counts. Its dedups at the spike tiers 524,288 and
# 1,048,576 (3,932 and 5,428 grouped passes) are inside the dedup gate
# and launch the kernel: 53,036 + 9,360 dedup_keys2 launches. Its 72
# compactions past the compaction gate take torch.sort.
PAIR_LAUNCHES = {"dedup_keys2": 62_396, "compact_keys2": 2_412,
                 "fixpoint_pair": 1_481}
PAIR_FETCHES = 66_143
# A pair history past 32 bitset bits (window 37), corrupted so that it
# dies at row 3: the GPU against the CPU oracle, with final paths. (The
# explain replay runs the unreduced CPU search from the chunk's entry, so
# a later death, such as seed 7's at row 15, takes minutes to explain.)
WIDE_PAIR = dict(n_ops=2_000, concurrency=40, seed=42, value_range=5)
WIDE_PAIR_CORRUPT_SEED = 42
# The compaction kernels' sizes (their gate, psort.PSORT_MAX_N, is 2^19)
# and the dedups': every padded size up to the spike tiers' 2^21 and
# three sizes that are not powers of two.
SORT_SIZES = tuple(1 << k for k in range(10, 20))
COMPACT_SIZES = SORT_SIZES + (1500,)
DEDUP_SIZES = tuple(1 << k for k in range(10, 22)) + (1500, 262_151,
                                                     1_048_573)
# The spike tiers' dedup sizes (tier x 2 candidates at tiers 262,144,
# 524,288 and 1,048,576), where phases 10 and 14 time the dedups beside
# the engine's torch.sort twins to set psort.DEDUP_MAX_N.
SPIKE_SIZES = (1 << 19, 1 << 20, 1 << 21)
# Rows of a sparse headline whose entry frontiers feed the fixpoint
# checks (the first chunk).
FIXPOINT_ROWS = 512
# Integer ops per compare-exchange of a comparison sort (compare,
# select), per key of a dedup or compaction scan, and per key and digit
# of a radix sort (extract, rank, scatter); a floor on the work.
OPS_PER_COMPARE = 2
OPS_PER_SCAN_KEY = 2
OPS_PER_RADIX_DIGIT = 3
FILL = 0xFFFFFFFF


def u32_err(a, b) -> int:
    """Max |a - b| over u32 words of two raw int32 tensors."""
    from jepsen_tpu_torch import _u32

    if a.numel() == 0:
        return 0
    return int((_u32.widen(a) - _u32.widen(b)).abs().max())


def same_outputs(kern, plain) -> tuple[bool, int]:
    """(identical, max word error) of two kernel results, tuples of
    tensors and None."""
    import torch

    same, err = True, 0
    for a, b in zip(kern, plain):
        if a is None or b is None:
            same &= a is None and b is None
            continue
        if a.dtype == torch.int32 and a.dim() == 1 and a.numel() > 4:
            err = max(err, u32_err(a, b))
        same &= bool(torch.equal(a.cpu(), b.cpu()))
    return same, err


def sort_inputs(rng, n):
    """Seeded inputs at size n: dedup (keys, valid, cap) cases with heavy
    duplication, distinct keys past cap, and all invalid; compact (keys,
    cap) cases sorted-with-holes and arbitrary."""
    import numpy as np

    dup = rng.integers(0, 1 << 12, n).astype(np.uint32)
    wide = rng.permutation(1 << 22)[:n].astype(np.uint32)
    dedup = [(dup, rng.random(n) < 0.6, max(n // 8, 1)),
             (wide, rng.random(n) < 0.9, max(n // 4, 1)),
             (dup, np.zeros(n, bool), n)]
    holes = np.sort(rng.permutation(1 << 22)[:n]).astype(np.uint32)
    holes[rng.random(n) < 0.4] = FILL
    arb = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    arb[rng.random(n) < 0.3] = FILL
    arb[:n // 8] = arb[n // 8:2 * (n // 8)]
    compact = [(holes, n), (arb, max(n // 2, 1))]
    # All valid; every key equal; exactly cap and cap + 1 survivors; one
    # key apart from the rest in bit 30 (so that its digit pass must run).
    c = n // 4
    u = np.unique(rng.integers(0, 1 << 30, 2 * c + 16, dtype=np.uint64))
    rng.shuffle(u)
    exact = np.concatenate([u[:c], rng.choice(u[:c], n - c)]) \
        .astype(np.uint32)
    rng.shuffle(exact)
    apart = rng.integers(0, 1 << 24, n).astype(np.uint32)
    apart[rng.integers(n)] |= np.uint32(1 << 30)
    ones = np.ones(n, bool)
    dedup += [(wide, ones, max(n // 4, 1)),
              (np.full(n, (1 << 30) | 5, np.uint32), rng.random(n) < 0.5,
               max(n // 8, 1)),
              (exact, ones, c), (exact, ones, c - 1), (apart, ones, n)]
    return dedup, compact


def pair_inputs(rng, n):
    """Seeded pair inputs at size n: dedup (hi, lo, valid, cap) cases with
    equal hi and different lo, lo's bit 31 set as payload, duplicates,
    FILL holes and mixed validity past cap; distinct pairs past cap; all
    invalid; compact (hi, lo, cap) cases sorted-with-holes and arbitrary
    (hi's bit 31 set, duplicates, holes)."""
    import numpy as np

    hi = rng.integers(0, 4, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo[::3] |= np.uint32(1 << 31)
    q = n // 4
    hi[:q], lo[:q] = hi[q:2 * q], lo[q:2 * q]
    hole = rng.random(n) < 0.1
    hi[hole], lo[hole] = FILL, FILL
    u = np.unique(rng.integers(0, 1 << 50, 2 * n, dtype=np.uint64))[:n]
    rng.shuffle(u)
    whi, wlo = (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)
    dedup = [(hi, lo, rng.random(n) < 0.7, max(n // 8, 1)),
             (whi, wlo, rng.random(n) < 0.9, max(n // 4, 1)),
             (hi, lo, np.zeros(n, bool), n)]
    s = np.sort(u)
    shi, slo = (s >> np.uint64(32)).astype(np.uint32), s.astype(np.uint32)
    gone = rng.random(n) < 0.4
    shi[gone], slo[gone] = FILL, FILL
    ahi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    alo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    ahi[:n // 8], alo[:n // 8] = ahi[n // 8:2 * (n // 8)], \
        alo[n // 8:2 * (n // 8)]
    gone = rng.random(n) < 0.3
    ahi[gone], alo[gone] = FILL, FILL
    compact = [(shi, slo, n), (ahi, alo, max(n // 2, 1))]
    # All valid; every pair equal; exactly cap and cap + 1 survivors; one
    # pair apart from the rest in hi's bit 30, and one in lo's bit 31.
    c = n // 4
    u = np.unique(rng.integers(0, 1 << 62, 2 * c + 16, dtype=np.uint64))
    rng.shuffle(u)
    exact = np.concatenate([u[:c], rng.choice(u[:c], n - c)])
    rng.shuffle(exact)
    ehi, elo = (exact >> np.uint64(32)).astype(np.uint32), \
        exact.astype(np.uint32)
    bhi = rng.integers(0, 2, n).astype(np.uint32)
    blo = rng.integers(0, 1 << 24, n).astype(np.uint32)
    bhi[rng.integers(n)] |= np.uint32(1 << 30)
    chi = np.zeros(n, np.uint32)
    clo = rng.integers(0, 1 << 24, n).astype(np.uint32)
    clo[rng.integers(n)] |= np.uint32(1 << 31)
    ones = np.ones(n, bool)
    dedup += [(whi, wlo, ones, max(n // 4, 1)),
              (np.full(n, 1 << 30, np.uint32),
               np.full(n, (1 << 31) | 1, np.uint32), rng.random(n) < 0.5,
               max(n // 8, 1)),
              (ehi, elo, ones, c), (ehi, elo, ones, c - 1),
              (bhi, blo, ones, n), (chi, clo, ones, n)]
    return dedup, compact


def compact2_cases(rng, n):
    """Seeded (label, hi, lo, cap) cases of the pair compaction at size n
    that the one launch must tell apart: ascending with holes and more
    live pairs than cap; ascending but for a descent in the last live
    pair (so the whole input must be sorted); ascending with the last
    live pair's hi word KEY_FILL (live, as its lo is not)."""
    import numpy as np

    def holes():
        k = np.unique(rng.integers(0, 1 << 61, 2 * n, dtype=np.uint64))
        k = k[:n] * np.uint64(2)                       # sorted, even
        gone = rng.random(n) < 0.3
        gone[0] = False                                # a live pair
        k[gone] = (1 << 64) - 1
        return k

    def split(k):
        return (k >> np.uint64(32)).astype(np.uint32), \
            (k & np.uint64(FILL)).astype(np.uint32)

    more = holes()
    live = int((more != np.uint64((1 << 64) - 1)).sum())
    down = holes()
    at = np.flatnonzero(down != np.uint64((1 << 64) - 1))
    down[at[-1]] = down[at[-2]] - np.uint64(1)         # odd: distinct
    top = holes()
    top[np.flatnonzero(top != np.uint64((1 << 64) - 1))[-1]] = \
        np.uint64((FILL << 32) | 5)
    return [("ascending, live > cap", *split(more), max(live // 2, 1)),
            ("descent in the last live pair", *split(down), n),
            ("live pair with hi KEY_FILL", *split(top), n)]


def compact_cases(rng, n):
    """Seeded (label, keys, cap) cases of the single-key compaction at
    size n that the one launch must tell apart, its live keys spread over
    all 32 bits: ascending with holes and more live keys than cap;
    ascending but for a descent in the last live key (so the whole input
    must be sorted); ascending across bit 31 (0x80000000 ... 0xFFFFFFFE
    sort after every key below them and before KEY_FILL); the first live
    key with bit 31 set moved before the live key below it (a descent in
    unsigned order only); every key KEY_FILL."""
    import numpy as np

    def holes():
        u = np.unique(rng.integers(0, 1 << 31, 2 * n, dtype=np.uint64))
        k = np.sort(rng.permutation(u)[:n]) * np.uint64(2)  # even, < FILL
        gone = rng.random(n) < 0.3
        gone[0] = False                                # a live key
        k[gone] = FILL
        return k.astype(np.uint32)

    more = holes()
    live = int((more != FILL).sum())
    down = holes()
    at = np.flatnonzero(down != FILL)
    down[at[-1]] = down[at[-2]] - np.uint32(1)         # odd: distinct
    top = holes()
    swap = holes()
    at = np.flatnonzero(swap != FILL)
    high = at[swap[at] >= np.uint32(1 << 31)][0]
    below = at[at < high][-1]
    swap[[below, high]] = swap[[high, below]]
    return [("ascending, live > cap", more, max(live // 2, 1)),
            ("descent in the last live key", down, n),
            ("ascending across bit 31", top, n),
            ("a bit-31 key before a smaller one", swap, n),
            ("every key KEY_FILL", np.full(n, FILL, np.uint32), n)]


def compact_path(width: int) -> str:
    """The path of the latest compaction of ``width``-byte keys on the
    card (4: ``compact_keys``, 8: ``compact_keys2``): "bitonic" (the
    network), or the one launch's "ordered" (no sort), "shared" or
    "device" (sorted in shared or device memory) from its path word."""
    from jepsen_tpu_torch.lin import psort_cuda

    if psort_cuda.last_compact_route[width] != "one":
        return "bitonic"
    return {psort_cuda.PATH_ORDERED: "ordered",
            psort_cuda.PATH_SHARED: "shared",
            psort_cuda.PATH_DEVICE: "device"}[
                int(psort_cuda.last_compact_path[width])]


@contextlib.contextmanager
def compact_route(width: int, route: str):
    """The route of the compaction of ``width``-byte keys while inside:
    "gate" (by ``psort.COMPACT_ONE_MAX_N``, pairs
    ``psort.COMPACT2_ONE_MAX_N``), "one" (one launch up to its limit) or
    "bitonic" (the network)."""
    from jepsen_tpu_torch.lin import psort

    name = "COMPACT_ONE_MAX_N" if width == 4 else "COMPACT2_ONE_MAX_N"
    saved = getattr(psort, name)
    setattr(psort, name, {"gate": saved, "one": psort.COMPACT_ONE_LIMIT,
                          "bitonic": 0}[route])
    try:
        yield
    finally:
        setattr(psort, name, saved)


def check_sort_kernels(dev, pair: bool) -> int:
    """Phase 7a / 11a: dedup_keys (``pair``: dedup_keys2) against its
    plain version at every size of DEDUP_SIZES, compact_keys (or
    compact_keys2) through both of its routes, also on
    :func:`compact_cases` (:func:`compact2_cases`), at every size of
    COMPACT_SIZES. On the card the compaction must run its one launch's
    ordered path and both sorted paths, and the network. Returns the max
    word error (0, or it raises)."""
    import numpy as np
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import psort

    def t(a):
        return _u32.bitmap_from_numpy(a, dev)

    rng = np.random.default_rng(79 if pair else 77)
    tag = "2" if pair else ""
    width = 8 if pair else 4
    max_err = 0
    paths = {}
    for n in DEDUP_SIZES:
        flags = []
        if pair:
            dedup, compact = pair_inputs(rng, n)
            runs = [("dedup_keys2", psort.dedup_keys2,
                     psort.dedup_keys2_plain,
                     (t(h), t(lo), torch.from_numpy(v).to(dev), cap), None)
                    for h, lo, v, cap in dedup]
            if n in COMPACT_SIZES:
                compact += [c[1:] for c in compact2_cases(rng, n)]
                runs += [("compact_keys2", psort.compact_keys2,
                          psort.compact_keys2_plain, (t(h), t(lo), cap),
                          route)
                         for h, lo, cap in compact
                         for route in ("one", "bitonic")]
        else:
            dedup, compact = sort_inputs(rng, n)
            runs = [("dedup_keys", psort.dedup_keys, psort.dedup_keys_plain,
                     (t(k), torch.from_numpy(v).to(dev), cap), None)
                    for k, v, cap in dedup]
            if n in COMPACT_SIZES:
                compact += [c[1:] for c in compact_cases(rng, n)]
                runs += [("compact_keys", psort.compact_keys,
                          psort.compact_keys_plain, (t(k), cap), route)
                         for k, cap in compact
                         for route in ("one", "bitonic")]
        for name, kern_fn, plain_fn, args, route in runs:
            with compact_route(width, route or "gate"):
                kern = kern_fn(*args)
            if route and dev.type == "cuda":
                p = compact_path(width)
                paths[p] = paths.get(p, 0) + 1
                flags.append(f"{route}:{p}")
            plain = plain_fn(*args)
            torch.cuda.synchronize()
            same, err = same_outputs(kern, plain)
            max_err = max(max_err, err)
            if not same:
                raise AssertionError(f"{name} != plain at n={n} cap="
                                     f"{args[-1]} (route {route}), error "
                                     f"{err}")
            dedup_run = name.startswith("dedup")
            cnt = int(kern[-2] if dedup_run else kern[-1])
            flags.append(f"{cnt}{'+' if dedup_run and bool(kern[-1]) else ''}")
        log(f"[sort{tag}-vs-plain] n={n:7d} bit_exact=True counts (dedup+ = "
            f"overflow; then compact, after its route:path) "
            f"{' '.join(flags)}")
    if dev.type == "cuda":
        log(f"[compact_keys{tag}-paths] runs by path: {paths}")
        if not {"ordered", "shared", "device", "bitonic"} <= paths.keys():
            raise AssertionError(f"compact_keys{tag} paths run: {paths}, "
                                 "want ordered, shared, device and bitonic")
    return max_err


def row_frontiers(eng, rows: int):
    """The entry frontier (row, lo, hi, count) of each of the first
    ``rows`` rows of ``eng``'s history, through the engine's own row loop
    at the top chunk cap."""
    from jepsen_tpu_torch.lin import bfs

    lo, hi = eng.init_keys(bfs.PACKED_CAP_SCHEDULE[-1])
    count = 1
    out = []
    for r in range(min(rows, eng.p.R)):
        base = r - r % bfs.CHUNK
        eng.load_chunk(base, bfs.CHUNK)
        out.append((r, lo, hi, count))
        lo, hi, count, dead, ovf = eng.run_row(r - base, lo, hi, count, True)
        if dead or ovf:
            raise AssertionError(f"row {r}: dead={dead} overflow={ovf}")
    return out


def fixpoint_inputs(eng, r: int, lo, hi, count: int, tier: int):
    """The fused fixpoint's inputs for absolute row r at ``tier``:
    (lo[:tier], hi[:tier] or None, count, cols, sats, it_max) on the
    engine's device."""
    import numpy as np

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import bfs

    p = eng.p
    exp_r = tuple(t[r] for t in eng.exp_h)
    cols, sats = bfs._fused_row_tables(exp_r, np.asarray(p.active)[r],
                                       np.asarray(p.slot_v)[r],
                                       eng.pure_h[r], W=eng.W, b=eng.b,
                                       nil_id=eng.nil_id)
    Mg = max(1, bfs._GROUP_BOUND // tier - 1)
    G = -(-eng.M // Mg) if Mg < eng.M else 1
    it_max = G * (eng.W + 4) + 8
    lo_t, hi_t = bfs._resize(lo, hi, tier)
    return (lo_t.contiguous(), None if hi_t is None else hi_t.contiguous(),
            count, _u32.bitmap_from_numpy(cols, eng.dev),
            _u32.bitmap_from_numpy(sats, eng.dev), it_max)


def overfull_frontier(eng, rng, tier: int):
    """A frontier of ``tier`` distinct random configs (nil state), raw
    (lo, hi or None) words: a full tier, whose closure overflows."""
    import numpy as np

    from jepsen_tpu_torch import _u32

    bits = eng.W + eng.b - 1
    k = np.unique(rng.integers(0, 1 << bits, 2 * tier, dtype=np.uint64)
                  & ~np.uint64((1 << eng.b) - 1) | np.uint64(eng.nil_id))
    rng.shuffle(k)
    k = np.sort(k[:tier])
    lo = _u32.bitmap_from_numpy(k.astype(np.uint32), eng.dev)
    hi = _u32.bitmap_from_numpy((k >> np.uint64(32)).astype(np.uint32),
                                eng.dev) if eng.pair else None
    return lo, hi, k.size


def worst_case_entry(eng, rng, tier: int):
    """A full tier of distinct live keys and column tables under which
    every column is legal for every key, so that the first pass has
    ``tier * (1 + M)`` live candidates, the kernel's worst case: keys in
    the low ``kbits`` bits; column c active, a write, statically useful,
    with no chain predecessor, its key bit above the keys' bits. Returns
    (lo, hi or None, count, cols, sats) on the engine's device."""
    import numpy as np

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import psort_fused as pf

    M, b = eng.M, eng.b
    kbits = b + tier.bit_length() + 1
    free = (63 if eng.pair else 31) - kbits
    k = np.sort(rng.choice(1 << kbits, tier, replace=False)
                ).astype(np.uint64)
    cols = np.zeros((pf.N_COL_ROWS, M), np.uint64)
    for c in range(M):
        bit = np.uint64(1) << np.uint64(kbits + c % free)
        for r_lo in (pf.COL_EXP_LO, pf.COL_OR_LO):
            cols[r_lo, c] = bit & np.uint64(FILL)
            cols[r_lo + 1, c] = bit >> np.uint64(32)
        cols[pf.COL_FLAGS, c] = pf.FLAG_ACT | pf.FLAG_WRITE | pf.FLAG_JIT
    lo = _u32.bitmap_from_numpy(k.astype(np.uint32), eng.dev)
    hi = _u32.bitmap_from_numpy((k >> np.uint64(32)).astype(np.uint32),
                                eng.dev) if eng.pair else None
    sats = np.zeros((2, 1 << b), np.uint32)
    return (lo, hi, tier, _u32.bitmap_from_numpy(cols.astype(np.uint32),
                                                  eng.dev),
            _u32.bitmap_from_numpy(sats, eng.dev))


def bits_apart_entry(eng, lo, hi, count: int, tier: int):
    """The live keys of an entry frontier with copies one bit apart in the
    top key bits: pairs with hi's bit 30 flipped and with lo's bit 31
    flipped (a payload bit), single keys with bit 30 flipped. Returns
    (lo, hi or None, count) at ``tier``, sorted, KEY_FILL after."""
    import numpy as np

    from jepsen_tpu_torch import _u32

    k = _u32.bitmap_to_numpy(lo[:count]).astype(np.uint64)
    if eng.pair:
        k |= _u32.bitmap_to_numpy(hi[:count]).astype(np.uint64) << \
            np.uint64(32)
        flips = (np.uint64(1) << np.uint64(62), np.uint64(1) << np.uint64(31))
    else:
        flips = (np.uint64(1) << np.uint64(30),)
    k = np.unique(np.concatenate([k] + [k ^ f for f in flips]))[:tier]
    full = np.full(tier, (1 << 64) - 1 if eng.pair else FILL, np.uint64)
    full[:k.size] = k
    lo_t = _u32.bitmap_from_numpy((full & np.uint64(FILL)).astype(np.uint32),
                                  eng.dev)
    hi_t = _u32.bitmap_from_numpy((full >> np.uint64(32)).astype(np.uint32),
                                  eng.dev) if eng.pair else None
    return lo_t, hi_t, int(k.size)


def fixpoint_path(a) -> str:
    """The sort paths the latest fixpoint launch took, from the word the
    kernel writes beside its flags ("plain" in a CPU rehearsal)."""
    from jepsen_tpu_torch.lin import psort_fused_cuda as pfc

    if not a.is_cuda:
        return "plain"
    word = int(pfc.last_path)
    return "+".join(n for n, bit in (("shared", pfc.PATH_SHARED),
                                     ("device", pfc.PATH_DEVICE))
                    if word & bit) or "none"


def check_fixpoint(eng, fronts) -> tuple[int, list, dict]:
    """Phase 7b / 11b: fixpoint vs plain at every tier ``fits`` admits:
    on real rows converged and at it_max=1; a full-tier entry that
    overflows; an entry whose every column is legal for every key
    (n_live = tier * (1 + M), the worst case); an empty entry (count 0);
    keys one bit apart in the top key bits (pairs: hi's bit 30, lo's bit
    31). On the card each of the kernel's sort paths (shared memory,
    device memory) must run, the worst case in device memory exactly
    where tier * (1 + M) exceeds the shared path's capacity. Returns (max
    word error, tiers checked, {path: runs})."""
    import numpy as np
    import torch

    from jepsen_tpu_torch.lin import bfs, psort, psort_fused, psort_fused_cuda

    rng = np.random.default_rng(80 if eng.pair else 78)
    tag = "2" if eng.pair else ""
    max_err = 0
    tiers = [t for t in bfs.ROW_TIERS + bfs.PACKED_CAP_SCHEDULE[-1:]
             if psort_fused.fits(t, eng.M, eng.b)]
    on_card = eng.dev.type == "cuda"
    shared = psort_fused_cuda.shared_max_n(eng.pair) if on_card else None
    # Passes each recorded row's closure needs, from its smallest tier;
    # each tier takes the row needing most passes among those it holds.
    need = []
    for r, lo, hi, count in fronts:
        t = next((t for t in tiers if count * 4 <= t), None)
        if t is None:
            need.append(-1)
            continue
        x, xh, cnt, cols, sats, it_max = fixpoint_inputs(eng, r, lo, hi,
                                                         count, t)
        need.append(int(psort_fused.fixpoint_flags(
            x, xh, cnt, cols, sats, cap=t, b=eng.b, it_max=it_max)[2][2]))
    paths = {}
    for tier in tiers:
        i = max((i for i, f in enumerate(fronts) if f[3] * 4 <= tier),
                key=lambda i: (need[i], fronts[i][3]))
        r, lo, hi, count = fronts[i]
        x, xh, cnt, cols, sats, it_max = fixpoint_inputs(eng, r, lo, hi,
                                                         count, tier)
        blo, bhi, n_big = overfull_frontier(eng, rng, tier)
        wlo, whi, wcnt, wcols, wsats = worst_case_entry(eng, rng, tier)
        elo = torch.full_like(x, psort.KEY_FILL_RAW)
        ehi = None if xh is None else elo.clone()
        plo, phi, pcnt = bits_apart_entry(eng, x, xh, cnt, tier)
        runs = [("converged", x, xh, cnt, it_max, cols, sats),
                ("it_max=1", x, xh, cnt, 1, cols, sats),
                ("overflow", blo, bhi, n_big, it_max, cols, sats),
                ("worst", wlo, whi, wcnt, it_max, wcols, wsats),
                ("empty", elo, ehi, 0, it_max, cols, sats),
                ("bits", plo, phi, pcnt, it_max, cols, sats)]
        n_pad = psort.pad_size(tier * (1 + eng.M))
        for what, a, ah, c, itm, cl, st in runs:
            kern = psort_fused.fixpoint_flags(a, ah, c, cl, st, cap=tier,
                                              b=eng.b, it_max=itm)
            path = fixpoint_path(a)
            plain = psort_fused.fixpoint_flags_plain(a, ah, c, cl, st,
                                                     cap=tier, b=eng.b,
                                                     it_max=itm)
            if on_card:
                torch.cuda.synchronize()
            same, err = same_outputs(kern, plain)
            max_err = max(max_err, err)
            conv, ovf, passes, out_cnt = kern[2].tolist()
            log(f"[fixpoint{tag}-vs-plain] tier={tier:6d} n_pad={n_pad:7d} "
                f"row={r} {what:9s} count {c}->{out_cnt} passes={passes} "
                f"converged={conv} overflow={ovf} path={path} "
                f"bit_exact={same}")
            if not same:
                raise AssertionError(f"fixpoint{tag} != plain at tier {tier}"
                                     f" ({what}): flags {kern[2].tolist()} vs"
                                     f" {plain[2].tolist()}, error {err}")
            for p in path.split("+"):
                paths[p] = paths.get(p, 0) + 1
            if on_card and what == "worst":
                want = "device" if tier * (1 + eng.M) > shared else "shared"
                if path != want:
                    raise AssertionError(f"fixpoint{tag}: the worst case at "
                                         f"tier {tier} took the {path} path,"
                                         f" not {want}")
    if on_card and not {"shared", "device"} <= paths.keys():
        raise AssertionError(f"fixpoint{tag}: a sort path never ran: "
                             f"{paths}")
    return max_err, tiers, paths


# Seconds a spin kernel holds the stream before each timed call: the host
# enqueues the call's launches meanwhile (tens to a few hundred us), so
# the events around the call time the device's work alone.
GATE_S = 5e-4


class CallTimer:
    """Each call of a wrapper while installed: counted by its first
    argument's size (``sizes``), the arguments (cloned) of every
    ``every``-th call at a size kept in ``samples``, up to ``keep`` of
    them, and timed by ``mode``. "events" (the default), its device time:
    before a call a spin kernel (``torch.cuda._sleep``) holds the stream,
    and events around the call start when it ends, so the wrapper's host
    work (allocations, the ctypes call, every launch it enqueues) is done
    by then and the events bracket the device's work alone; a call whose
    host time outlasted its spin is counted in ``unheld``. "wall", its
    host time up to a synchronise; "count", no time (the run keeps its
    pace)."""

    def __init__(self, module, name, mode: str = "events", keep: int = 0,
                 every: int = 1):
        self.module, self.name = module, name
        self.mode, self.keep, self.every = mode, keep, every
        self.orig = getattr(module, name)
        self.calls, self.sizes, self.samples = [], {}, {}

    def __enter__(self):
        import torch

        def timed(*a, **k):
            n = a[0].numel() if isinstance(a[0], torch.Tensor) else None
            i = self.sizes.get(n, 0)
            self.sizes[n] = i + 1
            got = self.samples.setdefault(n, [])
            if len(got) < self.keep and i % self.every == 0:
                got.append(tuple(x.clone() if isinstance(x, torch.Tensor)
                                 else x for x in a))
            if self.mode == "count":
                return self.orig(*a, **k)
            t0 = time.perf_counter()
            if self.mode == "wall":
                out = self.orig(*a, **k)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                self.calls.append(time.perf_counter() - t0)
                return out
            g, s, e = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
            g.record()
            torch.cuda._sleep(int(GATE_S * SM_HZ))
            s.record()
            out = self.orig(*a, **k)
            e.record()
            self.calls.append((time.perf_counter() - t0, g, s, e))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def n_calls(self) -> int:
        return sum(self.sizes.values())

    def total_ms(self) -> float:
        if self.mode == "wall":
            return sum(self.calls) * 1e3
        return sum(s.elapsed_time(e) for _, _, s, e in self.calls)

    def unheld(self) -> int:
        return sum(host * 1e3 >= g.elapsed_time(s)
                   for host, g, s, _ in self.calls)


def sort_bound(n: int, out_n: int, in_bytes_per_key: int,
               out_bytes_per_key: int = 4):
    """Least time for a sort-based dedup or compaction of n keys (the
    unpadded input): the bytes (keys in, keys out) over the memory rate,
    or n log2 n compares plus a scan over the integer rate."""
    import math

    nbytes = n * in_bytes_per_key + out_bytes_per_key * out_n + 8
    ops = n * math.log2(n) * OPS_PER_COMPARE + n * OPS_PER_SCAN_KEY
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b > t_o else "operations"


def radix_dedup_bound(n: int, live: int, digits: int, out_n: int,
                      in_bytes_per_key: int, out_bytes_per_key: int):
    """Least time for a radix sort-dedup of n integer keys of which
    ``live`` are valid and differ in ``digits`` 8-bit digits: the bytes
    (keys and flags in, keys out) over the memory rate, or a scan of the
    n keys plus, per live key, a digit's extract, rank and scatter for
    each varying digit and a first-of-run test, over the integer rate."""
    nbytes = n * in_bytes_per_key + out_bytes_per_key * out_n + 8
    ops = n * OPS_PER_SCAN_KEY \
        + live * (digits * OPS_PER_RADIX_DIGIT + OPS_PER_SCAN_KEY)
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b > t_o else "operations"


def fixpoint_bound(cap: int, M: int, b: int, counts, words: int = 1):
    """Least time for one fused fixpoint: the keys (``words`` u32 words
    each) in and out and the tables, or per pass, for the c carried keys
    entering it (``counts``), the expansion and a sort of their
    c * (1 + M) candidates."""
    import math

    nbytes = 4 * (2 * words * cap + 10 * M + 2 * (1 << b) + 5)
    ops = 0.0
    for c in counts:
        n = max(c * (1 + M), 2)
        ops += n * math.log2(n) * OPS_PER_COMPARE \
            + n * (8 + OPS_PER_SCAN_KEY)
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b > t_o else "operations"


def reset_launches():
    from jepsen_tpu_torch.lin import psort, psort_fused

    for d in (psort.LAUNCHES, psort_fused.LAUNCHES):
        for k in d:
            d[k] = 0


def headline(dev, model, h, kernels: dict, tag: str, timed_h=None,
             clean_check: bool = True, spies=(), run_spies=()):
    """A sparse headline through ``checker.linearizable(algorithm="gpu")``
    with the launch counts of ``kernels`` (name -> (module, wrapper)) set
    to 0 just before and read just after, and ``run_spies`` (context
    managers) installed; then (``clean_check``) a clean device check, and
    a device check of ``timed_h`` (default: the same history) with each
    kernel call timed by CUDA events behind a spin gate, and ``spies``
    installed. Returns (result, launches, per-kernel summed ms of the
    timed check)."""
    import torch

    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch.lin import bfs, prepare, psort, psort_fused

    counters = {"psort": psort.LAUNCHES, "psort_fused": psort_fused.LAUNCHES}
    t0 = time.perf_counter()
    p = prepare.prepare(model, h)
    t_prep = time.perf_counter() - t0
    walk = prepare.pack_stats()["mode"]
    with contextlib.ExitStack() as stack:
        for spy in run_spies:
            stack.enter_context(spy)
        reset_launches()
        t0 = time.perf_counter()
        r = checker.linearizable(algorithm="gpu", device=dev).check(
            None, model, h)
        t_e2e = time.perf_counter() - t0
    launches = {k: counters[mod][k] for k, (mod, _) in kernels.items()}
    stats = r.get("engine-stats") or {}
    n = len(h) // 2
    log(f"[{tag}-headline] ops={n} window={p.window} R={p.R} "
        f"verdict={r['valid?']} analyzer={r.get('analyzer')} backend="
        f"{r.get('backend')} max-cap={r.get('max-cap')} "
        f"final-frontier-size={r.get('final-frontier-size')} "
        f"launches={launches}")
    log(f"[{tag}-headline] stats={stats}")
    log(f"[{tag}-headline] prepare={t_prep:.3f}s walk={walk} "
        f"e2e={t_e2e:.3f}s ({n / t_e2e:.0f} ops/s); fetches/row="
        f"{stats['fetches'] / max(stats['rows'], 1):.3f}")
    if r["valid?"] is not True or r.get("analyzer") != "gpu-bfs":
        raise AssertionError(f"headline: {r}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the headline never launched {missing}")
    if clean_check:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rr = bfs.check_packed(p, device=dev)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        if rr["valid?"] is not True:
            raise AssertionError(f"headline re-check said {rr['valid?']!r}")
        log(f"[{tag}-headline] clean device check {t_dev:.3f}s "
            f"({n / t_dev:.0f} ops/s)")
    timed_h = h if timed_h is None else timed_h
    pt = prepare.prepare(model, timed_h)
    # The timed history must run the headline's band: its kernels' times
    # stand under their names.
    if bfs.key_band(pt) != bfs.key_band(p) or \
            bfs._Engine(pt, dev).pair != bfs._Engine(p, dev).pair:
        raise AssertionError(f"[{tag}-headline] the timed history (window "
                             f"{pt.window}) left the headline's band")
    mods = {"psort": psort, "psort_fused": psort_fused}
    timers = [CallTimer(mods[mod], fn) for mod, fn in kernels.values()]
    for t in (*timers, *spies):
        t.__enter__()
    try:
        t0 = time.perf_counter()
        rt = bfs.check_packed(pt, device=dev)
        torch.cuda.synchronize()
        t_timed = time.perf_counter() - t0
    finally:
        for t in (*timers, *spies):
            t.__exit__()
    if rt["valid?"] is not True:
        raise AssertionError(f"headline timed re-check said {rt['valid?']!r}")
    idle = [k for k, t in zip(kernels, timers) if not t.calls]
    if idle:
        raise AssertionError(f"[{tag}-headline] the timed check never "
                             f"called {idle}")
    per_kernel = dict(zip(kernels, (t.total_ms() for t in timers)))
    log(f"[{tag}-headline] timed run at "
        f"{len(timed_h) // 2} ops (R={pt.R}, "
        f"{t_timed:.3f}s): kernel device ms (CUDA events after a spin gate,"
        " summed per call): "
        + ", ".join(f"{k}={v:.1f} ({len(t.calls)} calls, {t.unheld()} "
                    f"ungated)" for (k, v), t in zip(per_kernel.items(),
                                                     timers))
        + f"; kernels {sum(per_kernel.values()) / (t_timed * 1e3):.1%} of "
        "the timed check")
    return r, launches, per_kernel


# Spike compactions (past the compaction gate, which take torch.sort)
# whose inputs phase 12 records for phase 14.
SPIKE_COMPACTIONS = 3


def dropped_pairs(lo, hi, count: int, s: int, b: int):
    """The pair return filter's input to its compaction, as the engine
    builds it (``bfs._filter_pass_keys2``): the survivors with the
    returner's key bit b + s cleared, KEY_FILL in both words elsewhere.
    Returns (hi, lo, survivors)."""
    import torch

    from jepsen_tpu_torch.lin import bfs, psort

    bit_lo, bit_hi = bfs._key_bit(b + s)
    live = torch.arange(lo.numel(), device=lo.device) < count
    keep = live & (((lo & bit_lo) | (hi & bit_hi)) != 0)
    d_hi = torch.where(keep, hi & ~bit_hi, psort.KEY_FILL_RAW).contiguous()
    d_lo = torch.where(keep, lo & ~bit_lo, psort.KEY_FILL_RAW).contiguous()
    return d_hi, d_lo, int(keep.sum())


class CompactSpy:
    """While installed: the route, path and size of every compaction of
    ``width``-byte keys on the card (4: ``compact_keys``, 8:
    ``compact_keys2``; the one launch's path word, or "bitonic"), and
    inputs to time again: for single keys the first call's at each size
    (the return filter compacts cap keys, so one a row tier or chunk
    cap), for pairs the first SPIKE_COMPACTIONS compactions past the
    compaction gate (the engine's torch.sort), recorded from the return
    filter."""

    def __init__(self, width: int):
        self.width = width
        self.calls, self.firsts, self.spikes = [], {}, []

    def __enter__(self):
        from jepsen_tpu_torch.lin import bfs, psort, psort_cuda

        suffix = "" if self.width == 4 else "2"
        one, net = self.saved = (getattr(psort_cuda, f"compact{suffix}_one"),
                                 getattr(psort_cuda, f"compact{suffix}"))
        filt = self.saved_filter = bfs._filter_pass_keys2

        def record(args, cap, path):
            n = args[-1].numel()
            self.calls.append((n, path))
            if self.width == 4 and n not in self.firsts:
                self.firsts[n] = (args[0].clone(), cap)

        def one_spy(*args):
            out = one(*args)
            record(args[:-1], args[-1],
                   psort_cuda.last_compact_path[self.width])
            return out

        def net_spy(*args):
            record(args[:-2], args[-2], None)
            return net(*args)

        def filt_spy(lo, hi, count, s, *, cap, b, n_keep=None):
            if not psort.available(cap) and \
                    len(self.spikes) < SPIKE_COMPACTIONS:
                d_hi, d_lo, kept = dropped_pairs(lo, hi, count, s, b)
                if kept != count:
                    self.spikes.append((d_hi, d_lo, cap))
            return filt(lo, hi, count, s, cap=cap, b=b, n_keep=n_keep)

        setattr(psort_cuda, f"compact{suffix}_one", one_spy)
        setattr(psort_cuda, f"compact{suffix}", net_spy)
        if self.width == 8:
            bfs._filter_pass_keys2 = filt_spy
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.lin import bfs, psort_cuda

        suffix = "" if self.width == 4 else "2"
        setattr(psort_cuda, f"compact{suffix}_one", self.saved[0])
        setattr(psort_cuda, f"compact{suffix}", self.saved[1])
        bfs._filter_pass_keys2 = self.saved_filter

    def paths(self) -> dict:
        """Calls by path, and by size and path."""
        import torch

        from jepsen_tpu_torch.lin import psort_cuda

        names = {psort_cuda.PATH_ORDERED: "ordered",
                 psort_cuda.PATH_SHARED: "shared",
                 psort_cuda.PATH_DEVICE: "device"}
        words = [w for _, w in self.calls if w is not None]
        it = iter(torch.cat(words).tolist() if words else [])
        out = {"ordered": 0, "shared": 0, "device": 0, "bitonic": 0}
        sizes = {}
        for n, w in self.calls:
            path = "bitonic" if w is None else names[next(it)]
            out[path] += 1
            size = sizes.setdefault(n, {})
            size[path] = size.get(path, 0) + 1
        out["by_n"] = dict(sorted(sizes.items()))
        return out

    def check_ordered(self, tag: str, gate: int) -> dict:
        """Logs the calls by path and size, and fails unless every call
        whose padded size is at most ``gate`` ran the one launch's ordered
        path: the return filter hands the compaction its live keys
        ascending. Returns :meth:`paths`."""
        from jepsen_tpu_torch.lin import psort

        paths = self.paths()
        log(f"[{tag}] compact_keys{'' if self.width == 4 else '2'} calls "
            f"by path: { {k: v for k, v in paths.items() if k != 'by_n'} }"
            f"; by n: {paths['by_n']}")
        off = {n: p for n, p in paths["by_n"].items()
               if psort.pad_size(n) <= gate and set(p) != {"ordered"}}
        if off:
            raise AssertionError(f"{tag}: compactions up to the gate {gate} "
                                 f"off the ordered path: {off}")
        return paths


def counterexample(dev, model, h, seed: int, tag: str):
    """A corrupted history through ``"gpu"`` and ``"cpu"``: both invalid
    on the same op and dead row, final paths from the GPU."""
    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch.lin import prepare, synth

    hc = synth.corrupt_history(h, seed=seed)
    pc = prepare.prepare(model, hc)
    t0 = time.perf_counter()
    rg = checker.linearizable(algorithm="gpu", device=dev).check(None, model,
                                                                 hc)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = checker.linearizable(algorithm="cpu").check(None, model, hc)
    t_c = time.perf_counter() - t0
    log(f"[{tag}-counterexample] window={pc.window} R={pc.R} gpu="
        f"{rg['valid?']} ({rg.get('analyzer')}, {t_g:.2f}s) cpu="
        f"{rc['valid?']} ({t_c:.2f}s) dead-row gpu={rg.get('dead-row')} "
        f"cpu={rc.get('dead-row')} op={rg.get('op')} final-paths="
        f"{len(rg.get('final-paths', []))}")
    if pc.window <= 20 or rg.get("analyzer") != "gpu-bfs":
        raise AssertionError(f"the {tag} counterexample missed the sparse "
                             "engine")
    if rg["valid?"] is not False or rc["valid?"] is not False:
        raise AssertionError(f"corrupted history: gpu {rg['valid?']!r} "
                             f"cpu {rc['valid?']!r}")
    if rg.get("op") != rc.get("op") or rg.get("dead-row") != \
            rc.get("dead-row"):
        raise AssertionError(f"gpu {rg.get('op')} at {rg.get('dead-row')}, "
                             f"cpu {rc.get('op')} at {rc.get('dead-row')}")
    if not rg.get("final-paths"):
        raise AssertionError("the GPU counterexample has no final paths")
    return pc


RADIX_KERNELS = ("dedup_load", "radix_pass", "dedup_finish")


def launch_profile(fn, key_bytes: int):
    """The kernels one call of ``fn`` (a radix dedup of keys of
    ``key_bytes``) launches, by the launcher's own count, which must be
    the design's 2 + key_bytes (the load, a pass per 8-bit digit, the
    finish), and each kernel's mean device µs a launch as
    ``torch.profiler`` traces five calls ({} where the trace holds no
    device event of it: a trace can miss some)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch.lin import psort_cuda

    fn()
    torch.cuda.synchronize()
    before = psort_cuda.dedup_kernel_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    launches = (psort_cuda.dedup_kernel_launches() - before) / 5
    if launches != 2 + key_bytes:
        raise AssertionError(f"the radix dedup launched {launches:g} "
                             f"kernels a call, not {2 + key_bytes}")
    us = {}
    for k in RADIX_KERNELS:
        ts = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type.name == "CUDA" and k in e.name]
        if ts:
            us[k] = sum(ts) / len(ts)
    return launches, us


def profile_note(launches, us) -> str:
    each = ", ".join(f"{k} {us[k]:.1f}" if k in us else f"{k} not measured"
                     for k in RADIX_KERNELS)
    return f"{launches:g} launches a call; mean device us a launch: {each}"


def spike_times(eng, cand, cand_hi, valid, pair: bool) -> list:
    """Phase 10b / 14b: the dedup kernel at the spike sizes beside the
    engine's torch.sort twin and torch.unique, on the headline shape's
    candidates tiled to each size, copy i moved by i in key bits above
    the band's (so that the copies are distinct, as a wider frontier's
    configs are), with cap = n / 2 (the spike tier). Raises where the
    kernel loses to the twin inside the dedup gate (on the card; a CPU
    rehearsal times the plain versions)."""
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import bfs, psort

    tag = "pair" if pair else "sparse"
    shift = eng.W + eng.b - (32 if pair else 0)
    out = []
    for n in SPIKE_SIZES:
        reps = -(-n // cand.numel())
        if max(shift, 0) + reps.bit_length() > 31:
            raise AssertionError(f"no free key bits to tile to n={n}")
        moved = torch.arange(reps, device=cand.device, dtype=torch.int32) \
            .repeat_interleave(cand.numel()) << max(shift, 0)
        v = valid.repeat(reps)[:n].contiguous()
        if pair:
            lo = cand.repeat(reps)[:n].contiguous()
            hi = (cand_hi.repeat(reps) | moved)[:n].contiguous()
            args = (hi, lo, v, n // 2)
            kern, twin = psort.dedup_keys2, bfs._dedup_keys2_sort
            flagged = torch.where(v, hi, hi | torch.iinfo(torch.int32).min)
            key = _u32.pair_key(flagged, lo)
        else:
            k = (cand.repeat(reps) | moved)[:n].contiguous()
            args = (k, v, n // 2)
            kern, twin = psort.dedup_keys, bfs._dedup_keys_sort
            key = _u32.widen(k) | ((~v).to(torch.int64) << 31)
        got, want = kern(*args), twin(*args)
        same, err = same_outputs(got, want)
        if not same:
            raise AssertionError(f"{kern.__name__} != its sort twin at "
                                 f"n={n}, error {err}")
        ms = time_chunk(lambda: kern(*args), 20)
        twin_ms = time_chunk(lambda: twin(*args), 10)
        lib = time_chunk(lambda: torch.unique(key, sorted=True), 20)
        launches, us = launch_profile(lambda: kern(*args), 8 if pair else 4)
        gated = psort.dedup_available(n)
        log(f"[{tag}-time] {kern.__name__} n={n} cap={n // 2} live="
            f"{int(v.sum())} count={int(got[-2])}: kernel {ms:.4f} ms "
            f"({profile_note(launches, us)}), sort twin {twin_ms:.4f} ms, "
            f"torch.unique {lib:.4f} ms; inside the dedup gate: {gated}")
        if gated and ms >= twin_ms and cand.is_cuda:
            raise AssertionError(f"dedup gate: the kernel ({ms:.4f} ms) "
                                 f"loses to the sort twin ({twin_ms:.4f} "
                                 f"ms) at n={n}")
        out.append({"n": n, "cap": n // 2, "ms": ms, "sort_twin_ms": twin_ms,
                    "library_ms": lib, "launches_per_call": launches,
                    "launch_us": us,
                    "inside_gate": gated})
    return out


# The tier past the fused gate (psort_fused.fits admits n_pad <= 2^19; at
# M 32 tier 16,384 is n_pad 2^20), where phases 10 and 14 time the kernel
# beside the unfused pass chain on the headline's own rows; and how many
# of those rows.
GATE_TIER = 16384
GATE_ROWS = 8


def fixpoint_row(eng, fronts, tier: int):
    """The fused fixpoint at ``tier`` on the fullest recorded row it
    holds: (row, entry count, inputs, passes, carried count entering each
    pass, n_pad)."""
    from jepsen_tpu_torch.lin import psort, psort_fused

    fr = max((f for f in fronts if f[3] * 4 <= tier),
             key=lambda f: (f[3], f[0]))
    x, xh, cnt, cols, sats, it_max = fixpoint_inputs(eng, *fr, tier)
    passes = int(psort_fused.fixpoint_flags(
        x, xh, cnt, cols, sats, cap=tier, b=eng.b, it_max=it_max)[2][2])
    # The carried count entering each pass, one plain pass at a time.
    counts, a, ah, c = [], x, xh, cnt
    for _ in range(passes):
        counts.append(int(c))
        a, ah, fl = psort_fused.fixpoint_flags_plain(a, ah, c, cols, sats,
                                                     cap=tier, b=eng.b,
                                                     it_max=1)
        c = fl[3]
    return (fr[0], fr[3], (x, xh, cnt, cols, sats, it_max), passes, counts,
            psort.pad_size(tier * (1 + eng.M)))


def fixpoint_times(eng, fronts, tiers: dict, pair: bool):
    """Phase 10a / 14a: the fused fixpoint's time at every tier ``fits``
    admits, on the fullest recorded row each holds, with its bound; at
    the headline's most frequent fused tier (the shape of the kernel
    table's row 6) also its plain version's; then the gate
    (:func:`fixpoint_gate`). Returns ((ms, plain_ms, library_ms,
    bound_ms, bound_by, shape) at that tier, extra entries)."""
    from jepsen_tpu_torch.lin import bfs, psort_fused

    tag = "pair" if pair else "sparse"
    name = "fixpoint_pair" if pair else "fixpoint"
    words = 2 if pair else 1
    fused_tiers = {t: n for t, n in tiers.items()
                   if psort_fused.fits(t, eng.M, eng.b)}
    f_tier = max(fused_tiers, key=fused_tiers.get)
    entry, per_tier = None, []
    for tier in sorted({t for t in bfs.ROW_TIERS
                        if psort_fused.fits(t, eng.M, eng.b)} | {f_tier}):
        r, count, args, passes, counts, n_pad = fixpoint_row(eng, fronts,
                                                             tier)
        kw = dict(cap=tier, b=eng.b, it_max=args[-1])
        ms = time_chunk(
            lambda: psort_fused.fixpoint_flags(*args[:-1], **kw), 20)
        path = fixpoint_path(args[0])
        bound, by = fixpoint_bound(tier, eng.M, eng.b, counts, words)
        per_tier.append({"tier": tier, "row": r, "count": count,
                         "passes": passes, "ms": ms, "bound_ms": bound,
                         "rows_on_headline": tiers.get(tier, 0),
                         "path": path})
        line = (f"[{tag}-time] {name} tier={tier} ({tiers.get(tier, 0)} "
                f"rows) row={r} count={count} passes={passes} n_pad={n_pad} "
                f"carried counts {counts}: kernel {ms:.4f} ms ({path})")
        if tier == f_tier:
            plain = time_chunk(
                lambda: psort_fused.fixpoint_flags_plain(*args[:-1], **kw),
                2)
            entry = (ms, plain, None, bound, by,
                     {"cap": tier, "M": eng.M, "b": eng.b, "n_pad": n_pad,
                      "passes": passes})
            line += f", plain {plain:.3f} ms"
        log(f"{line}, bound {bound:.6f} ms ({by})"
            + ("; no PyTorch call computes it" if tier == f_tier else ""))
    return entry, {"tiers_ms": per_tier,
                   "gate": fixpoint_gate(eng, fronts, pair)}


def fixpoint_gate(eng, fronts, pair: bool) -> dict:
    """Phase 10b / 14b: the kernel at :data:`GATE_TIER`, past the engine's
    gate ``psort_fused.fits`` (launched through the binding, whose limit
    is n_pad 2^21), bit-exact against its plain version, and its time
    beside the engine's unfused pass chain (``_closure_unfused``, grouped
    as ``row_at_tier`` groups it there, one fetch a pass) on the same
    entry frontiers: up to :data:`GATE_ROWS` of the recorded rows that
    the engine runs at that tier, spread over their counts. A CPU
    rehearsal times the plain version."""
    import torch

    from jepsen_tpu_torch.lin import bfs, psort, psort_fused, psort_fused_cuda

    tag = "pair" if pair else "sparse"
    tier = GATE_TIER
    band = sorted((f for f in fronts if tier // 4 < f[3] * 4 <= tier),
                  key=lambda f: (f[3], f[0]))
    if not band:
        log(f"[{tag}-gate] no recorded row runs at tier {tier}")
        return {"tier": tier, "rows": 0}
    rows = [band[i * len(band) // min(GATE_ROWS, len(band))]
            for i in range(min(GATE_ROWS, len(band)))]
    M = eng.M
    n_pad = psort.pad_size(tier * (1 + M))
    Mg = max(1, bfs._GROUP_BOUND // tier - 1)
    G = -(-M // Mg) if Mg < M else 1
    Mg = min(Mg, M)
    on_card = eng.dev.type == "cuda"
    fused_ms = unfused_ms = 0.0
    same_counts = 0
    for r, lo, hi, count in rows:
        x, xh, cnt, cols, sats, it_max = fixpoint_inputs(eng, r, lo, hi,
                                                         count, tier)
        cnt_t = torch.full((1,), cnt, dtype=torch.int32, device=eng.dev)

        def fused(x=x, xh=xh, cnt=cnt, cnt_t=cnt_t, cols=cols, sats=sats,
                  it_max=it_max):
            if on_card:
                return psort_fused_cuda.fixpoint(x, xh, cnt_t, cols, sats,
                                                 tier, eng.b, n_pad, it_max)
            return psort_fused._plain(x, xh, cnt, cols, sats, tier, eng.b,
                                      it_max)

        kern = fused()
        path = fixpoint_path(x)
        plain = psort_fused._plain(x, xh, cnt, cols, sats, tier, eng.b,
                                   it_max)
        same, err = same_outputs(kern, plain)
        if not same:
            raise AssertionError(f"fixpoint at tier {tier} != plain on row "
                                 f"{r}: flags {kern[2].tolist()} vs "
                                 f"{plain[2].tolist()}, error {err}")
        f_ms = time_chunk(fused, 5)
        r0 = r - r % bfs.CHUNK
        eng.load_chunk(r0, bfs.CHUNK)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, u_cnt, u_ovf = eng._closure_unfused(x, xh, count, r - r0,
                                                  tier, G, Mg, it_max)
        if on_card:
            torch.cuda.synchronize()
        u_ms = (time.perf_counter() - t0) * 1e3
        conv, ovf, passes, f_cnt = kern[2].tolist()
        same_counts += (not ovf and not u_ovf and f_cnt == u_cnt)
        fused_ms += f_ms
        unfused_ms += u_ms
        log(f"[{tag}-gate] tier={tier} n_pad={n_pad} row={r} count={count}"
            f": fused {f_ms:.4f} ms ({passes} passes, {path}, count "
            f"{f_cnt}, overflow={ovf}, bit_exact=True) vs unfused chain "
            f"{u_ms:.3f} ms (G={G}, count {u_cnt}, overflow={u_ovf})")
    log(f"[{tag}-gate] tier={tier}: fused {fused_ms:.3f} ms vs unfused "
        f"{unfused_ms:.3f} ms over {len(rows)} rows ({same_counts} with the "
        "same closure count)")
    return {"tier": tier, "rows": len(rows), "fused_ms": fused_ms,
            "unfused_ms": unfused_ms, "same_counts": same_counts}


def shape_times(eng, fronts, stats, pair: bool):
    """Phase 10 / 14: each sparse kernel's time at the headline's most
    frequent shape, its plain version's, one PyTorch call's and its
    bound; the fixpoint's at every tier and the gate
    (:func:`fixpoint_times`), the dedup's at the spike sizes
    (:func:`spike_times`). Returns ({name: (ms, plain_ms, library_ms,
    bound_ms, bound_by, shape)}, the fixpoint's and the dedup's extra
    entries)."""
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import bfs, psort, psort_fused

    dev = eng.dev
    tag = "pair" if pair else "sparse"
    words = 2 if pair else 1
    out = {}
    tiers = stats["tiers"]
    name = "fixpoint_pair" if pair else "fixpoint"
    out[name], fix_extra = fixpoint_times(eng, fronts, tiers, pair)

    # compact at the most frequent tier: the row's dropped keys.
    c_tier = max(tiers, key=tiers.get)
    fr = max((f for f in fronts if f[3] * 4 <= c_tier),
             key=lambda f: (f[3], f[0]))
    r, lo, hi, count = fr
    s = int(eng.p.ret_slot[r])
    lo, hi = bfs._resize(lo, hi, c_tier)
    live = torch.arange(c_tier, device=dev) < count
    bit_lo, bit_hi = bfs._key_bit(eng.b + s)
    held = (lo & bit_lo) if hi is None else (lo & bit_lo) | (hi & bit_hi)
    keep = live & (held != 0)
    d_lo = torch.where(keep, lo & ~bit_lo, psort.KEY_FILL_RAW).contiguous()
    if pair:
        d_hi = torch.where(keep, hi & ~bit_hi,
                           psort.KEY_FILL_RAW).contiguous()
        name, args = "compact_keys2", (d_hi, d_lo, c_tier)
        key = _u32.pair_key(d_hi, d_lo)
    else:
        name, args = "compact_keys", (d_lo, c_tier)
        key = _u32.widen(d_lo)
    kern, plain_fn = getattr(psort, name), getattr(psort, name + "_plain")
    ms = time_chunk(lambda: kern(*args), 50)
    plain = time_chunk(lambda: plain_fn(*args), 20)
    lib = time_chunk(lambda: torch.sort(key), 50)
    bound, by = sort_bound(c_tier, c_tier, 4 * words, 4 * words)
    out[name] = (ms, plain, lib, bound, by, {"n": c_tier, "cap": c_tier})
    kern(*args)
    path = compact_path(4 * words) if dev.type == "cuda" else "plain"
    for route in ("one", "bitonic"):
        with compact_route(4 * words, route):
            out[name][-1][f"{route}_ms"] = time_chunk(
                lambda: kern(*args), 50)
    out[name][-1]["path"] = path
    routes = (f" ({path}; one launch {out[name][-1]['one_ms']:.4f} ms, "
              f"bitonic {out[name][-1]['bitonic_ms']:.4f} ms)")
    log(f"[{tag}-time] {name} n={c_tier} (pad {psort.pad_size(c_tier)}, "
        f"{int(count)} entering, {int((d_lo != psort.KEY_FILL_RAW).sum())} "
        f"kept): kernel {ms:.4f} ms{routes}, plain {plain:.4f} ms, "
        f"torch.sort {lib:.4f} ms, bound {bound:.6f} ms ({by})")

    # dedup at the most frequent unfused tier: real candidates.
    unfused = dict(stats.get("unfused_tiers", {}))
    d_tier = max(unfused, key=unfused.get) if unfused else \
        bfs.PACKED_CAP_SCHEDULE[0]
    Mg = min(max(1, bfs._GROUP_BOUND // d_tier - 1), eng.M)
    r, lo, hi, count = max(fronts, key=lambda f: (f[3], f[0]))
    r0 = r - r % bfs.CHUNK
    eng.load_chunk(r0, bfs.CHUNK)
    tbl = eng.row_tables(r - r0).columns(0, Mg)
    lo, hi = bfs._resize(lo, hi, d_tier)
    cand, cand_hi, valid = bfs._expand_keys_compact(
        lo, hi, count, tbl, cap=d_tier, b=eng.b, nil_id=eng.nil_id,
        step_fn=eng.step_fn)
    n_d = cand.numel()
    if pair:
        name, args = "dedup_keys2", (cand_hi, cand, valid, d_tier)
        flagged = torch.where(valid, cand_hi,
                              cand_hi | torch.iinfo(torch.int32).min)
        key = _u32.pair_key(flagged, cand)
    else:
        name, args = "dedup_keys", (cand, valid, d_tier)
        key = _u32.widen(cand) | ((~valid).to(torch.int64) << 31)
    kern, plain_fn = getattr(psort, name), getattr(psort, name + "_plain")
    ms = time_chunk(lambda: kern(*args), 50)
    plain = time_chunk(lambda: plain_fn(*args), 20)
    lib = time_chunk(lambda: torch.unique(key, sorted=True), 50)
    live = key[valid]
    digits = sum(int(d.amin() != d.amax()) for d in
                 ((live >> (8 * i)) & 0xFF for i in range(4 * words)))
    bound, by = radix_dedup_bound(n_d, int(valid.sum()), digits, d_tier,
                                  4 * words + 1, 4 * words)
    out[name] = (ms, plain, lib, bound, by,
                 {"n": n_d, "cap": d_tier, "digits": digits})
    launches, us = launch_profile(lambda: kern(*args), 4 * words)
    log(f"[{tag}-time] {name} n={n_d} cap={d_tier} ({unfused.get(d_tier, 0)}"
        f" passes at this tier, {int(valid.sum())} candidates valid): "
        f"kernel {ms:.4f} ms ({profile_note(launches, us)}), plain "
        f"{plain:.4f} ms, torch.unique {lib:.4f} ms, bound {bound:.6f} ms "
        f"({by}; {digits} digits vary)")
    extra = {"launches_per_call": launches, "launch_us": us,
             "spike": spike_times(eng, cand, cand_hi, valid, pair)}
    return out, {name: extra,
                 "fixpoint_pair" if pair else "fixpoint": fix_extra}


SRC = "jepsen_tpu_torch/csrc/"
REPLACES = {"dedup_keys": "jepsen_tpu/lin/psort.py:741",
            "compact_keys": "jepsen_tpu/lin/psort.py:679",
            "fixpoint": "jepsen_tpu/lin/psort_fused.py:316",
            "dedup_keys2": "jepsen_tpu/lin/psort.py:306",
            "compact_keys2": "jepsen_tpu/lin/psort.py:726",
            "fixpoint_pair": "jepsen_tpu/lin/psort_fused.py:316",
            "dedup_keys_dom": "jepsen_tpu/lin/psort.py:448",
            "dedup_keys2_dom": "jepsen_tpu/lin/psort.py:616"}


def compact_times(dev, spy) -> dict:
    """Phase 10b / 14b: the compaction of ``spy.width``-byte keys through
    each route at every size of COMPACT_SIZES on the engine's input
    (ascending with holes) and on arbitrary input (phase 7's / 11's
    cases), with the one launch's path, beside ``torch.sort`` and the
    plain version; then for single keys each route at every size the
    headline compacted at, on the first input :class:`CompactSpy`
    recorded there, and for pairs the one launch against the engine's
    torch.sort on the recorded spike compactions, both bit-exact. The
    measurements behind ``psort.COMPACT_ONE_MAX_N`` and
    ``psort.COMPACT2_ONE_MAX_N``."""
    import numpy as np
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import psort

    width = spy.width
    pair = width == 8
    on_card = dev.type == "cuda"
    suffix = "2" if pair else ""
    kern = getattr(psort, f"compact_keys{suffix}")
    plain = getattr(psort, f"compact_keys{suffix}_plain")
    gate = psort.compact2_one_launch if pair else psort.compact_one_launch

    def t(a):
        return _u32.bitmap_from_numpy(a, dev)

    def sort_key(args):
        return _u32.pair_key(*args[:2]) if pair else _u32.widen(args[0])

    def routes(args, reps):
        key = sort_key(args)
        with compact_route(width, "one"):
            kern(*args)
            path = compact_path(width) if on_card else "plain"
            one = time_chunk(lambda: kern(*args), reps)
        with compact_route(width, "bitonic"):
            net = time_chunk(lambda: kern(*args), reps)
        return {"path": path, "one_ms": one, "bitonic_ms": net,
                "torch_sort_ms": time_chunk(lambda: torch.sort(key), reps),
                "plain_ms": time_chunk(lambda: plain(*args), reps)}

    def note(r):
        return (f"({r['path']}) one launch {r['one_ms']:.4f} ms, bitonic "
                f"{r['bitonic_ms']:.4f} ms, torch.sort "
                f"{r['torch_sort_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")

    rng = np.random.default_rng(81 if pair else 80)
    sizes, paths = [], set()
    for n in COMPACT_SIZES:
        if pair:
            _, compact = pair_inputs(rng, n)
            compact = [(t(h), t(lo), cap) for h, lo, cap in compact]
        else:
            _, compact = sort_inputs(rng, n)
            compact = [(t(k), cap) for k, cap in compact]
        row = {"n": n}
        for label, args in zip(("ascending", "arbitrary"), compact):
            row[label] = routes(args, 20 if n < 1 << 18 else 5)
            paths.add(row[label]["path"])
        sizes.append(row)
        log(f"[compact{suffix}-route-time] n={n:6d}: ascending with holes "
            f"{note(row['ascending'])}; arbitrary {note(row['arbitrary'])};"
            f" gate routes it to the "
            f"{'one launch' if gate(n) else 'bitonic'}")
    if on_card and paths != {"ordered", "shared", "device"}:
        raise AssertionError(f"compact_keys{suffix} timing runs took "
                             f"{paths}")
    out = {"route_times": sizes, "gate": psort.COMPACT2_ONE_MAX_N if pair
           else psort.COMPACT_ONE_MAX_N}
    if not pair:
        tiers = []
        for n, (keys, cap) in sorted(spy.firsts.items()):
            args = (keys, cap)
            with compact_route(width, "one"):
                same, err = same_outputs(kern(*args), plain(*args))
            if not same:
                raise AssertionError(f"compact_keys at n {n}: the one "
                                     f"launch != plain, error {err}")
            r = routes(args, 50 if n < 1 << 16 else 10)
            live = int((keys != psort.KEY_FILL_RAW).sum())
            bound, by = sort_bound(n, cap, 4, 4)
            tiers.append({"n": n, "n_pad": psort.pad_size(n), "cap": cap,
                          "live": live, "bound_ms": bound, "bound_by": by,
                          **r})
            log(f"[compact-tier-time] n={n} n_pad={psort.pad_size(n)} "
                f"cap={cap} live={live} (bit-exact): {note(r)}; bound "
                f"{bound:.6f} ms ({by}); gate routes it to the "
                f"{'one launch' if gate(n) else 'bitonic'}")
        out["tiers"] = tiers
        return out
    spike = []
    for d_hi, d_lo, cap in spy.spikes:
        def sort():
            return _u32.pair_split(torch.sort(_u32.pair_key(d_hi, d_lo))[0])

        with compact_route(width, "one"):
            got = psort.compact_keys2(d_hi, d_lo, cap)
            path = compact_path(width) if on_card else "plain"
            want = sort()
            same, err = same_outputs(got[:2], want)
            if not same or int(got[2]) != int((d_lo != -1).logical_or(
                    d_hi != -1).sum()):
                raise AssertionError(f"spike compaction at cap {cap}: the "
                                     f"one launch != torch.sort, error {err}")
            one = time_chunk(lambda: psort.compact_keys2(d_hi, d_lo, cap), 10)
        srt = time_chunk(sort, 10)
        spike.append({"n": d_lo.numel(), "cap": cap, "live": int(got[2]),
                      "path": path, "one_ms": one, "torch_sort_ms": srt})
        log(f"[compact2-spike] n={d_lo.numel()} cap={cap} live="
            f"{int(got[2])}: one launch ({path}, bit-exact) {one:.4f} ms, "
            f"the engine's torch.sort {srt:.4f} ms")
    out["spike"] = spike
    return out


def kernel_entries(times, launches, errs, per_kernel, extra) -> list:
    """The kernels line's entries of one band's three kernels."""
    out = []
    for name, (ms, plain, lib, bound, by, shape) in times.items():
        src = "psort_fused.cu" if name.startswith("fixpoint") else "psort.cu"
        out.append({
            "name": name, "route": "cuda", "source": SRC + src,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib,
            "bit_exact": True, "shape": shape,
            "headline_ms": per_kernel[name], **extra.get(name, {})})
    return out


def sparse_phases(dev) -> list:
    """Phases 7-10, the single-key band. Returns its kernels' entries of
    the kernels line."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import bfs, prepare, psort, synth

    model = m.cas_register()
    h = synth.generate_register_history(**SPARSE)
    p = prepare.prepare(model, h)
    eng = bfs._Engine(p, dev)
    log(f"[sparse] ops={SPARSE['n_ops']} window={p.window} R={p.R} "
        f"b={eng.b} M={eng.M} pair={eng.pair}")
    if eng.pair or bfs.key_band(p) != "compact":
        raise AssertionError("the sparse headline left the single-key band")

    # 7. kernels vs plain versions on the card
    sort_err = check_sort_kernels(dev, pair=False)
    t0 = time.perf_counter()
    fronts = row_frontiers(eng, FIXPOINT_ROWS)
    log(f"[fixpoint-vs-plain] frontiers of rows 0..{len(fronts) - 1} in "
        f"{time.perf_counter() - t0:.2f}s, counts up to "
        f"{max(f[3] for f in fronts)}")
    fix_err, fix_tiers, fix_paths = check_fixpoint(eng, fronts)

    # 8. the single-key headline through the user's entry point
    kernels = {"dedup_keys": ("psort", "dedup_keys"),
               "compact_keys": ("psort", "compact_keys"),
               "fixpoint": ("psort_fused", "fixpoint_flags")}
    # Its run through the entry point is its clean run (a separate clean
    # device check would not fit the script's time limit); it counts
    # compact_keys's calls by route, path and size, and records the first
    # input at each size for phase 10.
    spy = CompactSpy(4)
    r, launches, per_kernel = headline(
        dev, model, h, kernels, "sparse",
        timed_h=synth.generate_register_history(**SPARSE_TIMED),
        clean_check=False, run_spies=(spy,))
    fetches = r["engine-stats"]["fetches"]
    if launches != SPARSE_LAUNCHES or fetches != SPARSE_FETCHES:
        raise AssertionError(f"single-key headline: launches {launches} "
                             f"fetches {fetches}, expected "
                             f"{SPARSE_LAUNCHES} and {SPARSE_FETCHES}")
    compact_paths = spy.check_ordered("sparse-headline",
                                      psort.COMPACT_ONE_MAX_N)

    # 9. a single-key counterexample, GPU against the CPU oracle
    counterexample(dev, model, h, SPARSE_CORRUPT_SEED, "sparse")

    # 10. times at the headline's most frequent shapes
    times, dedup_extra = shape_times(eng, fronts, r["engine-stats"],
                                     pair=False)
    errs = {"dedup_keys": sort_err, "compact_keys": sort_err,
            "fixpoint": fix_err}
    extra = {"dedup_keys": {"sizes": list(DEDUP_SIZES),
                            **dedup_extra["dedup_keys"]},
             "compact_keys": {"sizes": list(COMPACT_SIZES),
                              "headline_paths": compact_paths,
                              **compact_times(dev, spy)},
             "fixpoint": {"tiers": fix_tiers, "paths": fix_paths,
                          **dedup_extra["fixpoint"]}}
    return kernel_entries(times, launches, errs, per_kernel, extra)


def pair_phases(dev) -> list:
    """Phases 11-14, the pair-key band. Returns its kernels' entries of
    the kernels line."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import bfs, prepare, psort, synth

    model = m.cas_register()
    h = synth.generate_register_history(**PAIR)
    p = prepare.prepare(model, h)
    eng = bfs._Engine(p, dev)
    log(f"[pair] ops={PAIR['n_ops']} concurrency={PAIR['concurrency']} "
        f"window={p.window} R={p.R} b={eng.b} M={eng.M} pair={eng.pair}")
    if not eng.pair or bfs.key_band(p) != "compact":
        raise AssertionError("the pair headline left the pair-key band")

    # 11. the pair kernels vs their plain versions on the card
    sort_err = check_sort_kernels(dev, pair=True)
    t0 = time.perf_counter()
    fronts = row_frontiers(eng, FIXPOINT_ROWS)
    log(f"[fixpoint2-vs-plain] frontiers of rows 0..{len(fronts) - 1} in "
        f"{time.perf_counter() - t0:.2f}s, counts up to "
        f"{max(f[3] for f in fronts)}")
    fix_err, fix_tiers, fix_paths = check_fixpoint(eng, fronts)

    # 12. the pair headline through the user's entry point
    kernels = {"dedup_keys2": ("psort", "dedup_keys2"),
               "compact_keys2": ("psort", "compact_keys2"),
               "fixpoint_pair": ("psort_fused", "fixpoint_flags")}
    # Its run through the entry point is its clean run, as in phase 8; it
    # counts compact_keys2's calls by path and records spike compactions
    # for phase 14.
    spy = CompactSpy(8)
    r, launches, per_kernel = headline(
        dev, model, h, kernels, "pair",
        timed_h=synth.generate_register_history(**PAIR_TIMED),
        clean_check=False, run_spies=(spy,))
    fetches = r["engine-stats"]["fetches"]
    if launches != PAIR_LAUNCHES or fetches != PAIR_FETCHES:
        raise AssertionError(f"pair headline: launches {launches} fetches "
                             f"{fetches}, expected {PAIR_LAUNCHES} and "
                             f"{PAIR_FETCHES}")
    compact_paths = spy.check_ordered("pair-headline",
                                      psort.COMPACT2_ONE_MAX_N)
    log(f"[pair-headline] {len(spy.spikes)} spike compactions recorded")

    # 13. a wide pair history (window > 32, two-word bitsets): a
    # counterexample against the CPU oracle
    hw = synth.generate_register_history(**WIDE_PAIR)
    pc = counterexample(dev, model, hw, WIDE_PAIR_CORRUPT_SEED, "wide-pair")
    if pc.window <= 32 or bfs.key_band(pc) != "compact":
        raise AssertionError(f"the wide pair history has window "
                             f"{pc.window}, not a pair window past 32")

    # 14. times at the headline's most frequent shapes
    times, dedup_extra = shape_times(eng, fronts, r["engine-stats"],
                                     pair=True)
    errs = {"dedup_keys2": sort_err, "compact_keys2": sort_err,
            "fixpoint_pair": fix_err}
    extra = {"dedup_keys2": {"sizes": list(DEDUP_SIZES),
                             **dedup_extra["dedup_keys2"]},
             "compact_keys2": {"sizes": list(COMPACT_SIZES),
                               "headline_paths": compact_paths,
                               **compact_times(dev, spy)},
             "fixpoint_pair": {"tiers": fix_tiers, "paths": fix_paths,
                               **dedup_extra["fixpoint_pair"]}}
    return kernel_entries(times, launches, errs, per_kernel, extra)


# --- the crash-dom bands (phases 15-19) --------------------------------------

# Partition-nemesis histories (BASELINE config 5's class) at config 5's
# staggered pacing (seed 7, invoke bias 0.45, 30 processes, 5 nodes, as
# bench.py's partitioned probe): 5k ops is the single-key crash-dom band
# (window 25, 3 state bits, M 16), 12k ops the pair-key band with
# two-word bitsets (window 35), the shortest that keeps them (10k ops is
# window 29, one-word bitsets), to keep the script inside its time limit.
DOM_SINGLE = dict(n_ops=5_000, seed=7, invoke_bias=0.45)
DOM_PAIR = dict(n_ops=12_000, seed=7, invoke_bias=0.45)
# The host-row executor's own test shape: the window-34 partition history
# with the chunk cap forced to 8, so that rows run in the executor.
HOSTROW = dict(n_ops=140, concurrency=40, seed=0, partition_every=60,
               partition_len=20, max_crashes=10)
HOSTROW_CAPS = dict(cap_schedule=(8,), host_caps=(64, 4096))
HOSTROW_CORRUPT_SEED = 3
DOM_SIZES = tuple(1 << k for k in range(10, 23))
# The host caps 262,144 and 524,288 at M = 32: 262,144 x 33 and
# 524,288 x 33 candidates, padded 2^24 and 2^25 (the largest the band
# gives the kernels).
DOM_BIG = (262_144 * 33, 524_288 * 33)
DOM_MODES = ((True, 2), (True, 6), (False, 1))     # (force, rounds)
# Rows of a crash-dom headline whose frontiers give real candidates.
DOM_ROWS = 1024
# Key bits of the random inputs: state 0-2, crashed 3-18, read 19-24
# (pairs: crashed 22-41 across both words, read 42-47, lo's bit 31 a
# group bit).
DOM_MASKS = {False: (sum(1 << j for j in range(3, 19)),
                     sum(1 << j for j in range(19, 25))),
             True: (sum(1 << j for j in range(22, 42)),
                    sum(1 << j for j in range(42, 48)))}


def dom_mask_words(pair: bool, cmask: int, rmask: int) -> tuple:
    """The mask arguments of a dominance dedup: (cmask, rmask), or their
    (hi, lo) halves for pairs."""
    if not pair:
        return cmask, rmask
    return cmask >> 32, cmask & FILL, rmask >> 32, rmask & FILL


def dom_random_keys(rng, n: int, pair: bool):
    """Seeded (label, key u64, valid, cap) cases: mixed keys with
    duplicates past cap, every key invalid, and one group of long
    dominance chains."""
    import numpy as np

    cmask, rmask = DOM_MASKS[pair]
    top = 52 if pair else 28
    key = rng.integers(0, 1 << top, n, dtype=np.uint64)
    dom_bits = np.uint64(cmask | rmask)
    grp = np.uint64(5 | (1 << 31) | (3 << 48)) if pair \
        else np.uint64(5 | (3 << 25))
    mixed = key.copy()
    g = rng.random(n) < 0.4
    mixed[g] = (mixed[g] & dom_bits) | grp
    mixed[:n // 10] = mixed[n // 10:2 * (n // 10)]
    chain = np.full(n, grp) | (key & np.uint64(rmask))
    for b in range(top):
        if (cmask >> b) & 1:
            chain |= (rng.random(n) < 0.8).astype(np.uint64) << np.uint64(b)
    chain[:n // 20] = chain[n // 20:2 * (n // 20)]
    return [("mixed", mixed, rng.random(n) < 0.85, max(n // 4, 1)),
            ("all-invalid", mixed, np.zeros(n, bool), n),
            ("chain", chain, rng.random(n) < 0.95, n)]


def dom_words(dev, pair: bool, key, valid, cmask: int, rmask: int):
    """Device (group, word) arrays of u64 keys, as the engine splits its
    candidates (``bfs._dom_split``)."""
    import numpy as np
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import bfs

    v = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)
    lo = _u32.bitmap_from_numpy(key.astype(np.uint32), dev)
    if not pair:
        return bfs._dom_split(lo, v, cmask, rmask)
    hi = _u32.bitmap_from_numpy((key >> np.uint64(32)).astype(np.uint32), dev)
    return bfs._dom_split2(hi, lo, v, *dom_mask_words(True, cmask, rmask))


def dom_run(pair: bool, words, masks, cap: int, force: bool, rounds: int,
            plain: bool = False):
    """One dominance dedup (its plain version when ``plain``)."""
    from jepsen_tpu_torch.lin import psort

    name = "dedup_keys2_dom" if pair else "dedup_keys_dom"
    if plain:
        return getattr(psort, name + "_plain")(*words, *masks, cap,
                                               force=force, iters=rounds)
    return getattr(psort, name)(*words, *masks, cap, force=force,
                                iters=rounds)


def dom_predecessor_tests(run) -> tuple:
    """``run()`` (a plain dominance dedup) with each prune round's sorted
    (group, word) entries read on the way in. Returns (its result, the
    predecessor tests per round: for each valid entry, its distance to
    its group's first entry, at most the chain)."""
    import torch

    from jepsen_tpu_torch.lin import psort

    prune, tests = psort._dom_prune, []

    def spy(ga, gw, keys, invalid, chain):
        idx = torch.arange(ga.numel(), device=ga.device)
        start = torch.ones_like(invalid)
        start[1:] = ga[1:] != ga[:-1]
        gfirst = torch.cummax(torch.where(start, idx, 0), 0)[0]
        dist = (idx - gfirst).clamp(max=chain)
        tests.append(int(dist[~invalid].sum()))
        return prune(ga, gw, keys, invalid, chain)

    psort._dom_prune = spy
    try:
        return run(), tests
    finally:
        psort._dom_prune = prune


def dom_path() -> str:
    """The path of the latest dominance dedup (either band) on the card:
    "multi" (the multi-launch chain), or the one launch's "shared" or
    "device" from its path word."""
    from jepsen_tpu_torch.lin import psort_cuda

    if psort_cuda.last_dom_route != "one":
        return "multi"
    return {psort_cuda.PATH_SHARED: "shared",
            psort_cuda.PATH_DEVICE: "device"}[int(psort_cuda.last_dom_path)]


@contextlib.contextmanager
def dom_route(route: str):
    """Both dominance dedups' route while inside: "gate" (by
    ``psort.DOM_ONE_MAX_N`` and ``psort.DOM1_ONE_MAX_N``), "one" (one
    launch at every size) or "multi" (the multi-launch chain at every
    size)."""
    from jepsen_tpu_torch.lin import psort

    saved = psort.DOM_ONE_MAX_N, psort.DOM1_ONE_MAX_N
    if route != "gate":
        psort.DOM_ONE_MAX_N = psort.DOM1_ONE_MAX_N = \
            {"one": psort.DOM_MAX_N, "multi": 0}[route]
    try:
        yield
    finally:
        psort.DOM_ONE_MAX_N, psort.DOM1_ONE_MAX_N = saved


def dom_check(tag: str, pair: bool, words, masks, cap: int,
              routes=("gate",)) -> tuple:
    """Kernel vs plain in every mode on one input, through each of
    ``routes`` (:func:`dom_route`); raises on a difference. Returns (the
    max word error, the counts of each route's runs, the paths the
    kernel took)."""
    import torch

    err = 0
    counts, paths = {}, []
    for route in routes:
        flags = []
        with dom_route(route):
            for force, rounds in DOM_MODES:
                kern = dom_run(pair, words, masks, cap, force, rounds)
                paths.append(dom_path())
                plain = dom_run(pair, words, masks, cap, force, rounds,
                                plain=True)
                torch.cuda.synchronize()
                same, e = same_outputs(kern, plain)
                err = max(err, e)
                if not same:
                    raise AssertionError(
                        f"{tag}: kernel != plain (route {route}, force="
                        f"{force}, rounds={rounds}), error {e}")
                flags.append(int(kern[-2]))
                if bool(kern[-1]):
                    flags[-1] = f"{flags[-1]}+"
        counts[route] = flags
    shown = " ".join(f"{r}: {' '.join(map(str, c))}"
                     for r, c in counts.items())
    log(f"{tag} cap={cap} bit_exact=True counts (forced 2, forced 6, "
        f"unforced; + = overflow) {shown}"
        + (f" paths {'/'.join(paths)}" if paths else ""))
    return err, counts, set(paths)


# Each dedup's own inputs: the padded size of the capacity cases (pairs,
# single keys: past each one-launch path's shared capacity, 6,144 and
# 12,288 entries), the entries of the one group whose dominators sit at
# distance 128, and the size of the every-entry-equal case.
DOM_CAP_N = {True: 8192, False: 16384}
DOM_CHAIN_GROUP = 256
DOM_EQUAL_N = 4096


def dom_chain_group(cmask: int, rmask: int, pair: bool):
    """Keys (pairs, or single keys) of one group of 2 x 128 entries whose
    dominance words are, sorted, A_0 < ... < A_127 (distinct 5-of-10 bit
    patterns of the low crashed bits, so no one is a subset of another)
    and then each A_i with the top crashed bit added: entry 128 + i is
    dominated by entry i alone, at distance 128, and entry 128 also by
    the group's first entry. Forced (chain 128) 128 survive; unforced
    (chain 2) 255."""
    import itertools

    import numpy as np

    low = [b for b in range(64) if (cmask >> b) & 1]
    pats = [sum(1 << low[b] for b in c)
            for c in itertools.combinations(range(10), 5)][:128]
    top = 1 << max(low)
    grp = 5 | (3 << 48) if pair else 5 | (3 << 25)
    keys = [grp | rmask | a for a in pats] + \
        [grp | rmask | a | top for a in pats]
    return np.array(keys, np.uint64)


def dom_cases(rng, shared_n: int, pair: bool):
    """Seeded (label, key u64, valid, cap, routes, want) cases of a
    dominance dedup (``pair``: the pair band's): valid counts just below,
    at and just above its one-launch shared capacity ``shared_n`` (want:
    that path), the distance-128 group and every entry equal (want: the
    counts in forced-2, forced-6 and unforced mode)."""
    import numpy as np

    cmask, rmask = DOM_MASKS[pair]
    top = 52 if pair else 28
    n = DOM_CAP_N[pair]
    out = []
    for live, path in ((shared_n - 1, "shared"), (shared_n, "shared"),
                       (shared_n + 1, "device")):
        key = rng.integers(0, 1 << top, n, dtype=np.uint64)
        valid = np.zeros(n, bool)
        valid[rng.choice(n, live, replace=False)] = True
        out.append((f"live={live}", key, valid, n // 4, ("gate", "multi"),
                    path))
    chain = dom_chain_group(cmask, rmask, pair)
    out.append(("chain-128", chain, np.ones(chain.size, bool),
                chain.size, ("gate", "multi"), [128, 128, 255]))
    key = np.full(DOM_EQUAL_N, rng.integers(0, 1 << top), np.uint64)
    out.append(("every-entry-equal", key, np.ones(DOM_EQUAL_N, bool),
                DOM_EQUAL_N // 4, ("gate", "multi"), [1, 1, 1]))
    return out


def dom_fronts(eng, rows: int):
    """Entry frontiers (row, lo, hi, count) of the first ``rows`` rows of a
    crash-dom history through the engine's in-chunk row loop, up to the
    first row that overflows it."""
    from jepsen_tpu_torch.lin import bfs

    lo, hi = eng.init_keys(bfs.TIER_MARGIN * bfs.CHUNK_TIER_CAP)
    count = 1
    out = []
    for r in range(min(rows, eng.p.R)):
        base = r - r % bfs.CHUNK
        eng.load_chunk(base, bfs.CHUNK)
        out.append((r, lo, hi, count))
        lo, hi, count, dead, ovf = eng.run_row(r - base, lo, hi, count, True)
        if dead or ovf:
            break
    return out


def dom_candidates(eng, front, tier: int):
    """The first closure pass's candidates of a recorded row at ``tier``:
    (key u64 numpy, valid numpy, cmask, rmask) in key space."""
    import numpy as np

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import bfs

    r, lo, hi, count = front
    r0 = r - r % bfs.CHUNK
    eng.load_chunk(r0, bfs.CHUNK)
    tbl = eng.row_tables(r - r0)
    cl, ch, rl, rh = eng.row_dom(r - r0)
    lo, hi = bfs._resize(lo, hi, tier)
    cand, cand_hi, valid = bfs._expand_keys_compact(
        lo, hi, count, tbl, cap=tier, b=eng.b, nil_id=eng.nil_id,
        step_fn=eng.step_fn)
    key = _u32.bitmap_to_numpy(cand).astype(np.uint64)
    if cand_hi is not None:
        key |= _u32.bitmap_to_numpy(cand_hi).astype(np.uint64) << \
            np.uint64(32)
    return key, valid.cpu().numpy(), (ch << 32) | cl, (rh << 32) | rl


def check_dom_kernels(dev, engines) -> dict:
    """Phase 15: both dominance dedups vs their plain versions in every
    mode, at every padded size 2^10 ... 2^22, 2^24 and 2^25, on random
    inputs, on :func:`dom_cases` through both routes, and on real
    candidates of each crash-dom headline (``engines``: pair flag ->
    (engine, recorded frontiers)) through both routes; each must run its
    shared, device and multi paths. Returns {name: max word error}."""
    import numpy as np

    from jepsen_tpu_torch.lin import bfs, psort_cuda

    errs = {}
    for pair in (False, True):
        name = "dedup_keys2_dom" if pair else "dedup_keys_dom"
        rng = np.random.default_rng(91 if pair else 90)
        err = 0
        seen = set()
        cmask, rmask = DOM_MASKS[pair]
        for n in DOM_SIZES + DOM_BIG:
            for label, key, valid, cap in dom_random_keys(rng, n, pair):
                words = dom_words(dev, pair, key, valid, cmask, rmask)
                e, _, paths = dom_check(
                    f"[{name}-vs-plain] n={n} {label}", pair, words,
                    dom_mask_words(pair, cmask, rmask), cap)
                err = max(err, e)
                seen |= paths
        shared_n = psort_cuda.dom_one_shared_max_n(pair)
        for label, key, valid, cap, routes, want in \
                dom_cases(rng, shared_n, pair):
            words = dom_words(dev, pair, key, valid, cmask, rmask)
            e, counts, paths = dom_check(
                f"[{name}-vs-plain] n={key.size} {label}", pair, words,
                dom_mask_words(pair, cmask, rmask), cap, routes)
            err = max(err, e)
            seen |= paths
            if isinstance(want, str) and paths != {want, "multi"}:
                raise AssertionError(f"{label}: paths {paths}, the one "
                                     f"launch should sort in {want} "
                                     "memory")
            if isinstance(want, list) and any(c != want
                                              for c in counts.values()):
                raise AssertionError(f"{label}: counts {counts}, want "
                                     f"{want}")
        eng, fronts = engines[pair]
        for front in sorted(fronts, key=lambda f: -f[3])[:3]:
            count = front[3]
            tier = next(t for t in bfs.ROW_TIERS + (bfs.CHUNK_TIER_CAP,)
                        if count * bfs.TIER_MARGIN <= t)
            key, valid, cmask, rmask = dom_candidates(eng, front, tier)
            words = dom_words(dev, pair, key, valid, cmask, rmask)
            e, _, paths = dom_check(
                f"[{name}-vs-plain] headline row {front[0]} count {count} "
                f"tier {tier} n={key.size}", pair, words,
                dom_mask_words(pair, cmask, rmask), tier, ("gate", "multi"))
            err = max(err, e)
            seen |= paths
        errs[name] = err
        log(f"[{name}-paths] runs took {sorted(seen)}")
        if seen != {"shared", "device", "multi"}:
            raise AssertionError(f"{name} paths run: {sorted(seen)}, want "
                                 "shared, device and multi")
    return errs


def dom_bound(n: int, out_n: int, words: int, rounds_work, survivors: int):
    """Least time for one dominance dedup of n entries of ``words`` u32
    words each (group and word): the bytes (entries in, ``out_n`` full
    keys of words/2 words out) over the memory rate, or the work this
    input needs over the integer rate: an n log2 n sort, per round one
    binary search and the predecessor tests it needs (``rounds_work``,
    from :func:`dom_predecessor_tests`), and the sort of the survivors' full
    keys."""
    import math

    nbytes = 4 * words * n + 2 * words * out_n + 8
    w2 = words // 2
    ops = n * math.log2(max(n, 2)) * OPS_PER_COMPARE * w2
    for tests in rounds_work:
        ops += (n * math.log2(max(n, 2)) + tests) * OPS_PER_COMPARE * w2
    ops += survivors * math.log2(max(survivors, 2)) * OPS_PER_COMPARE * w2
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b > t_o else "operations"


# A directory of the run's own (the quarantine ledger and phase 24's
# checkpoints), made and removed by ``main``.
SCRATCH: Path | None = None


def dom_headline(dev, model, h, pair: bool, rechecks: bool, spies=()):
    """Phases 16 / 17: a crash-dom headline through
    ``checker.linearizable(algorithm="gpu")`` with the launch counts set to
    0 just before and read just after, and ``spies`` (context managers)
    installed; then (``rechecks``) a clean device
    check, and one more with each dominance dedup call timed behind the
    spin gate. Returns (result, launches, summed kernel ms of the gated
    check, clean device check seconds (None without ``rechecks``), end
    to end seconds)."""
    import torch

    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch.lin import bfs, prepare, psort

    name = "dedup_keys2_dom" if pair else "dedup_keys_dom"
    tag = "pair-dom" if pair else "single-dom"
    t0 = time.perf_counter()
    p = prepare.prepare(model, h)
    t_prep = time.perf_counter() - t0
    walk = prepare.pack_stats()["mode"]
    with contextlib.ExitStack() as stack:
        for spy in spies:
            stack.enter_context(spy)
        reset_launches()
        t0 = time.perf_counter()
        r = checker.linearizable(algorithm="gpu", device=dev).check(
            None, model, h)
        t_e2e = time.perf_counter() - t0
    launches = {k: v for k, v in psort.LAUNCHES.items() if v}
    n = len(h) // 2
    log(f"[{tag}-headline] ops={n} window={p.window} R={p.R} crashed="
        f"{len(p.crashed_ops)} verdict={r['valid?']} analyzer="
        f"{r.get('analyzer')} backend={r.get('backend')} max-cap="
        f"{r.get('max-cap')} final-frontier-size="
        f"{r.get('final-frontier-size')} launches={launches}")
    log(f"[{tag}-headline] engine-stats={r.get('engine-stats')}")
    log(f"[{tag}-headline] host-stats={r.get('host-stats')}")
    log(f"[{tag}-headline] prepare={t_prep:.3f}s walk={walk} "
        f"e2e={t_e2e:.3f}s ({n / t_e2e:.1f} ops/s)")
    if r["valid?"] is not True or r.get("analyzer") != "gpu-bfs":
        raise AssertionError(f"{tag} headline: {r}")
    if launches.get(name, 0) <= 0:
        raise AssertionError(f"the {tag} headline never launched {name}")
    if not rechecks:
        return r, launches, None, None, t_e2e
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rr = bfs.check_packed(p, device=dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    if rr["valid?"] is not True:
        raise AssertionError(f"{tag} re-check said {rr['valid?']!r}")
    log(f"[{tag}-headline] clean device check {t_dev:.3f}s "
        f"({n / t_dev:.1f} ops/s)")
    timer = CallTimer(psort, name)
    with timer:
        t0 = time.perf_counter()
        rt = bfs.check_packed(p, device=dev)
        torch.cuda.synchronize()
        t_gated = time.perf_counter() - t0
    if rt["valid?"] is not True:
        raise AssertionError(f"{tag} timed check said {rt['valid?']!r}")
    per_call = timer.total_ms()
    log(f"[{tag}-headline] gated device check {t_gated:.3f}s: {name} "
        f"{per_call:.1f} ms over {len(timer.calls)} calls "
        f"({timer.unheld()} ungated) = {per_call / (t_gated * 1e3):.1%}"
        " of the check (CUDA events after a spin gate)")
    return r, launches, per_call, t_dev, t_e2e


def hostrow_phase(dev, model):
    """Phase 18: the host-row executor on the card, clean and against the
    CPU oracle on a counterexample."""
    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch.lin import prepare, synth

    h = synth.generate_partitioned_register_history(**HOSTROW)
    p = prepare.prepare(model, h)
    t0 = time.perf_counter()
    r = checker.linearizable(algorithm="gpu", device=dev,
                             **HOSTROW_CAPS).check(None, model, h)
    t_r = time.perf_counter() - t0
    hs = r.get("host-stats") or {}
    log(f"[host-rows] window={p.window} R={p.R} crashed="
        f"{len(p.crashed_ops)} caps={HOSTROW_CAPS} verdict={r['valid?']} "
        f"max-cap={r.get('max-cap')} host-stats={hs} ({t_r:.2f}s)")
    if r["valid?"] is not True or hs.get("rows", 0) < 1:
        raise AssertionError(f"host-row executor run: {r}")
    hc = synth.corrupt_history(h, seed=HOSTROW_CORRUPT_SEED)
    t0 = time.perf_counter()
    rg = checker.linearizable(algorithm="gpu", device=dev,
                              **HOSTROW_CAPS).check(None, model, hc)
    t_g = time.perf_counter() - t0
    rc = checker.linearizable(algorithm="cpu").check(None, model, hc)
    log(f"[host-rows-counterexample] gpu={rg['valid?']} ({t_g:.2f}s, "
        f"host-stats {rg.get('host-stats')}) cpu={rc['valid?']} dead-row "
        f"gpu={rg.get('dead-row')} cpu={rc.get('dead-row')} op="
        f"{rg.get('op')} final-paths={len(rg.get('final-paths', []))}")
    if rg["valid?"] is not False or rc["valid?"] is not False:
        raise AssertionError(f"corrupted: gpu {rg['valid?']!r} cpu "
                             f"{rc['valid?']!r}")
    if rg.get("op") != rc.get("op") or rg.get("dead-row") != \
            rc.get("dead-row"):
        raise AssertionError(f"gpu {rg.get('op')} at {rg.get('dead-row')}, "
                             f"cpu {rc.get('op')} at {rc.get('dead-row')}")
    if not rg.get("final-paths") or not (rg.get("host-stats") or {}).get(
            "rows"):
        raise AssertionError("the counterexample ran no host row or has no "
                             "final paths")


def dom_tier_times(eng, fronts, stats) -> list:
    """Phase 19: a dominance dedup's time per call at every in-chunk tier
    its crash-dom headline met (real candidates of the fullest recorded
    row the tier holds, 2 rounds) through its route (its band's gate,
    ``psort.DOM_ONE_MAX_N`` or ``psort.DOM1_ONE_MAX_N``) and through each
    route forced, with its kernel launches per call (the library's
    count), beside its plain version's time and its bound; and both
    routes on the tier's worst case, every candidate valid. Returns one
    dict a tier."""
    import numpy as np

    from jepsen_tpu_torch.lin import bfs, psort, psort_cuda

    pair = eng.pair
    name = "dedup_keys2_dom" if pair else "dedup_keys_dom"
    gate = psort.DOM_ONE_MAX_N if pair else psort.DOM1_ONE_MAX_N
    unfused = dict(stats.get("unfused_tiers", {}))
    rows = []
    for tier in sorted(unfused):
        fit = [f for f in fronts if f[3] * bfs.TIER_MARGIN <= tier]
        if not fit:
            continue
        front = max(fit, key=lambda f: (f[3], f[0]))
        key, valid, cmask, rmask = dom_candidates(eng, front, tier)
        words = dom_words(eng.dev, pair, key, valid, cmask, rmask)
        masks = dom_mask_words(pair, cmask, rmask)
        rounds = bfs.DOM_ITERS_CHUNK

        def run(plain=False):
            return dom_run(pair, words, masks, tier, True, rounds,
                           plain=plain)

        out, work = dom_predecessor_tests(lambda: run(plain=True))
        before = psort_cuda.dom_kernel_launches()
        run()
        per_call = psort_cuda.dom_kernel_launches() - before
        path = dom_path()
        ms = time_chunk(run, 50)
        with dom_route("one"):
            one_ms = time_chunk(run, 50)
        with dom_route("multi"):
            multi_ms = time_chunk(run, 20)
        plain = time_chunk(lambda: run(plain=True), 3)
        n = key.size
        # The worst case of the tier, every candidate valid, up to four
        # times the one launch's gate (one block sorts all of them).
        worst = None
        if psort.pad_size(n) <= 4 * gate:
            full = dom_words(eng.dev, pair, key, np.ones_like(valid), cmask,
                             rmask)

            def run_full():
                return dom_run(pair, full, masks, tier, True, rounds)

            with dom_route("one"):
                run_full()
                worst = {"path": dom_path(), "one_ms": time_chunk(run_full, 3)}
            with dom_route("multi"):
                worst["multi_ms"] = time_chunk(run_full, 3)
        bound, by = dom_bound(n, tier, 4 if pair else 2, work, int(out[-2]))
        row = {"tier": tier, "passes": unfused[tier], "row": front[0],
               "count": front[3], "n": n, "n_pad": psort.pad_size(n),
               "valid": int(valid.sum()), "survivors": int(out[-2]),
               "path": path, "launches_per_call": per_call, "ms": ms,
               "one_ms": one_ms, "multi_ms": multi_ms, "plain_ms": plain,
               "bound_ms": bound, "bound_by": by,
               "predecessor_tests": work, "all_valid": worst}
        log(f"[dom-tier-time] {name} tier={tier} "
            f"({unfused[tier]} passes) row={front[0]} count={front[3]} "
            f"n={n} (pad {row['n_pad']}) valid={row['valid']} survivors="
            f"{row['survivors']}: {path}, {per_call} launches a call, "
            f"{ms:.4f} ms (one launch {one_ms:.4f} ms, multi-launch "
            f"{multi_ms:.4f} ms), plain {plain:.4f} ms, bound "
            f"{bound:.6f} ms ({by})"
            + (f"; every candidate valid: one launch ({worst['path']}) "
               f"{worst['one_ms']:.4f} ms, multi-launch "
               f"{worst['multi_ms']:.4f} ms" if worst else ""))
        rows.append(row)
    return rows


def dom_gate_worst(dev, pair: bool) -> dict:
    """Phase 19: both routes of a dominance dedup at its one launch's
    gate, n = ``psort.DOM_ONE_MAX_N`` (``pair``) or
    ``psort.DOM1_ONE_MAX_N``, on phase 15's mixed random keys (85% valid,
    so the one launch sorts in device memory): the worst case the gate
    admits."""
    import numpy as np

    from jepsen_tpu_torch.lin import psort

    name = "dedup_keys2_dom" if pair else "dedup_keys_dom"
    n = psort.DOM_ONE_MAX_N if pair else psort.DOM1_ONE_MAX_N
    rng = np.random.default_rng(92 if pair else 93)
    _, key, valid, cap = dom_random_keys(rng, n, pair)[0]
    cmask, rmask = DOM_MASKS[pair]
    words = dom_words(dev, pair, key, valid, cmask, rmask)
    masks = dom_mask_words(pair, cmask, rmask)

    def run():
        return dom_run(pair, words, masks, cap, True, 2)

    out = {"n": n, "valid": int(valid.sum())}
    with dom_route("one"):
        run()
        out["path"] = dom_path()
        out["one_ms"] = time_chunk(run, 3)
    with dom_route("multi"):
        out["multi_ms"] = time_chunk(run, 3)
    log(f"[dom-gate-worst] {name} n={n} mixed random keys, "
        f"{out['valid']} valid, 2 rounds: one launch ({out['path']}) "
        f"{out['one_ms']:.4f} ms, multi-launch {out['multi_ms']:.4f} ms")
    return out


def crashdom_phases(dev) -> tuple:
    """Phases 15-19, the crash-dom bands. Returns the kernels line's
    entries of the two dominance dedups, and the single-key crash-dom
    headline's compact_keys calls by path."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import bfs, prepare, psort, synth

    model = m.cas_register()
    hists, engines = {}, {}
    for pair, kw in ((False, DOM_SINGLE), (True, DOM_PAIR)):
        t0 = time.perf_counter()
        h = synth.generate_partitioned_register_history(**kw)
        p = prepare.prepare(model, h)
        eng = bfs._Engine(p, dev)
        fronts = dom_fronts(eng, DOM_ROWS)
        log(f"[{'pair' if pair else 'single'}-dom] ops={kw['n_ops']} window="
            f"{p.window} R={p.R} crashed={len(p.crashed_ops)} b={eng.b} "
            f"M={eng.M} pair={eng.pair} crash_dom={eng.crash_dom}; "
            f"frontiers of rows 0..{len(fronts) - 1} (counts up to "
            f"{max(f[3] for f in fronts)}) in {time.perf_counter() - t0:.2f}s")
        if eng.pair != pair or not eng.crash_dom or \
                bfs.key_band(p) != "compact":
            raise AssertionError("a crash-dom headline left its band")
        hists[pair], engines[pair] = h, (eng, fronts)

    # 15. the dominance dedups vs their plain versions
    errs = check_dom_kernels(dev, engines)
    entries = []
    results = {}
    # 16, 17. the headlines through the user's entry point; the pair
    # headline's per-call timing is left to phase 19 (a gated check would
    # add two minutes). The single-key one counts compact_keys's calls by
    # route, path and size.
    spy = CompactSpy(4)
    for pair in (False, True):
        results[pair] = dom_headline(dev, model, hists[pair], pair,
                                     rechecks=not pair,
                                     spies=() if pair else (spy,))
    compact_paths = spy.check_ordered("single-dom-headline",
                                      psort.COMPACT_ONE_MAX_N)
    # 18. the host-row executor
    hostrow_phase(dev, model)
    # 19. per-call times at every in-chunk tier
    for pair in (False, True):
        name = "dedup_keys2_dom" if pair else "dedup_keys_dom"
        r, launches, per_call, t_dev, t_e2e = results[pair]
        eng, fronts = engines[pair]
        tiers = dom_tier_times(eng, fronts, r["engine-stats"])
        unfused = r["engine-stats"]["unfused_tiers"]
        top = max(unfused, key=unfused.get)
        t = next(x for x in tiers if x["tier"] == top)
        ms, plain, bound, by = (t["ms"], t["plain_ms"], t["bound_ms"],
                                t["bound_by"])
        shape = {"n": t["n"], "n_pad": t["n_pad"], "cap": top,
                 "rounds": 2, "M": eng.M,
                 "predecessor_tests": t["predecessor_tests"]}
        extra = {"path": t["path"],
                 "launches_per_call": t["launches_per_call"],
                 "tiers": tiers, "gate_worst": dom_gate_worst(dev, pair)}
        entries.append({
            "name": name, "route": "cuda", "source": SRC + "psort.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bit_exact": True, "shape": shape, "headline_ms": per_call,
            "headline_check_s": t_dev, "headline_e2e_s": t_e2e,
            "sizes": list(DOM_SIZES + DOM_BIG), **extra})
    return entries, compact_paths


# --- independent keys (phase 20) ---------------------------------------------

# etcd's per-key register workload (jepsen_tpu/suites/workloads.py:56-74:
# 300 ops a key, 10 threads a key) and BASELINE config 4's probe
# (bench.py:357-374), each key's history from its own seed. Both are cut
# from 1,000 keys to 500 to hold the script's time limit.
BATCH_ETCD = dict(n_keys=500, seed0=2000, n_ops=300, concurrency=10,
                  value_range=5, crash_prob=0.002, max_crashes=2)
BATCH_ETCD_CORRUPT = (0, 125, 250, 375)
BATCH_CONFIG4 = dict(n_keys=500, seed0=1000, n_ops=100, concurrency=5,
                     value_range=5, crash_prob=0.002, max_crashes=2)
# The sparse group: crash-free keys, the window-24 CAS chain of
# tests/test_independent.py:236-242 and two corrupted keys.
BATCH_SPARSE = dict(n_keys=64, seed0=3000, n_ops=100, concurrency=5,
                    value_range=5)
BATCH_SPARSE_CORRUPT = (3064, 3065)
BATCH_PLAIN_KEYS = 8
ORACLE_WORKERS = 6


def batch_key_specs(cfg: dict, corrupt=()) -> list:
    """(key, seed, corrupted, generator kwargs) of each key of a batch
    configuration."""
    kw = {k: v for k, v in cfg.items() if k not in ("n_keys", "seed0")}
    return [(k, cfg["seed0"] + k, k in corrupt, kw)
            for k in range(cfg["n_keys"])]


def batch_key_history(spec):
    """One key's history from its spec (see :func:`batch_key_specs`)."""
    from jepsen_tpu_torch.lin import synth

    _, seed, corrupted, kw = spec
    h = synth.generate_register_history(seed=seed, **kw)
    return synth.corrupt_history(h, seed=seed) if corrupted else h


def oracle_verdicts(specs) -> list:
    """(key, valid?, dead-row) of each key by the port's CPU oracle. Runs
    in a worker process, which makes the histories from their specs."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import cpu, prepare

    out = []
    for spec in specs:
        p = prepare.prepare(m.cas_register(), batch_key_history(spec))
        r = cpu.check_packed(p)
        out.append((spec[0], r["valid?"], r.get("dead-row")))
    return out


def start_oracle(pool, specs) -> list:
    """The CPU oracle's verdicts on ``specs``, submitted in chunks to
    ``pool``; read them with :func:`oracle_results`."""
    step = max(1, len(specs) // (4 * ORACLE_WORKERS))
    return [pool.submit(oracle_verdicts, specs[i:i + step])
            for i in range(0, len(specs), step)]


def oracle_results(futures) -> dict:
    return {k: (v, d) for f in futures for k, v, d in f.result()}


def kv_history(subs: dict):
    """Every key's ops wrapped in ``KV(key, value)``, in one history."""
    from jepsen_tpu_torch import independent

    return [o.replace(value=independent.KV(k, o.value))
            for k, h in subs.items() for o in h]


def batch_bound_ms(widths, w: int, ns: int, state) -> tuple:
    """Least time for one batched launch, summed over its keys from each
    key's own needs: its bitmap (at the launch's 2^w words) in and out,
    the masks and return slots of the rows it ran, its row count and
    state row, over the memory rate; and the ops its data needed, its
    sweeps and rows over the 2^w_k words of its own width w_k (a key's
    configs never leave them), as :func:`bound_ms`, over the peak integer
    rate. ``widths`` gives each key's own width, ``state`` the launch's
    state rows."""
    import torch

    rows = state[:, 0].long()
    sweeps = state[:, 4].long()
    nbytes = int((2 * 4 * (1 << w) + 4 * rows * w * ns + 4 * rows
                  + 4 + 4 * 5).sum())
    words = torch.tensor([1 << wk for wk in widths], dtype=torch.int64)
    ops = int((sweeps * (words // 2) * OPS_PER_PAIR
               + rows * words * OPS_PER_FILTER_WORD).sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def dense_batch_phase(dev, pool, tag: str, cfg: dict, corrupt, smi: str):
    """One dense key set through the lifted checker on the card, held
    against the CPU oracle, the per-key checks and the single-key kernel.
    Returns the numbers of the kernels line's ``dense_chunk_batch``
    entry."""
    import torch

    from jepsen_tpu_torch import _u32, checker, independent
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import batched, dense_cuda, prepare

    model = m.cas_register()
    specs = batch_key_specs(cfg, corrupt)
    oracle = start_oracle(pool, specs)
    t0 = time.perf_counter()
    subs = {spec[0]: batch_key_history(spec) for spec in specs}
    h = kv_history(subs)
    t_synth = time.perf_counter() - t0

    # The main path: the lifted checker, counts set to 0 just before.
    ck = independent.checker(checker.linearizable(algorithm="gpu",
                                                  device=dev))
    dense_cuda.BATCH_LAUNCHES = 0
    dense_cuda.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ck.check(None, model, h, {})
    t_e2e = time.perf_counter() - t0
    launches = dense_cuda.BATCH_LAUNCHES
    single = dense_cuda.LAUNCHES
    analyzers = {v.get("analyzer") for v in r["results"].values()}
    log(f"[{tag}] keys={r['n-keys']} ops={len(h)} valid?={r['valid?']} "
        f"failures={r['failures']} batch-engaged={r['batch-engaged']} "
        f"batch-keys={r['batch-keys']} analyzers={sorted(analyzers)} "
        f"dense_chunk_batch launches={launches} single-key launches="
        f"{single}")
    if not (r["batch-engaged"] and r["batch-keys"] == cfg["n_keys"]
            and r["n-keys"] == cfg["n_keys"]
            and analyzers == {"gpu-dense-batch"}):
        raise AssertionError(f"[{tag}] the batch did not decide every key "
                             f"by gpu-dense-batch")
    if launches < 1 or single != 0:
        raise AssertionError(f"[{tag}] dense_chunk_batch launched "
                             f"{launches} times, the single-key kernel "
                             f"{single}")

    # The batch alone, with and without packing.
    t0 = time.perf_counter()
    rb = batched.try_check_batch(model, subs, device=dev)
    t_batch = time.perf_counter() - t0
    packed = {k: prepare.prepare(model, sub) for k, sub in subs.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rp = batched.try_check_batch(model, packed, device=dev)
    t_device = time.perf_counter() - t0
    if rb != r["results"] or rp != r["results"]:
        raise AssertionError(f"[{tag}] a second batch run differs")

    # The per-key loop through the single-key checker.
    one = checker.linearizable(algorithm="gpu", device=dev)
    t0 = time.perf_counter()
    per_key = {k: one.check(None, model, sub) for k, sub in subs.items()}
    t_loop = time.perf_counter() - t0
    for k, want in per_key.items():
        got = r["results"][k]
        for key in ("valid?", "dead-row", "op"):
            if got.get(key) != want.get(key):
                raise AssertionError(f"[{tag}] key {k}: batch {key} "
                                     f"{got.get(key)!r}, per-key check "
                                     f"{want.get(key)!r}")

    # Every key's bitmap and state row against the single-key kernel, on
    # the batch the main path launched.
    b = batched.dense_batch(packed, dev)
    if isinstance(b, batched.Decline):
        raise AssertionError(f"[{tag}] dense_batch declined: {b}")
    ks, plans, w, ns, r_pad, inp = (b.keys, b.plans, b.w, b.ns, b.r_pad,
                                    b.inp)
    res = dense_cuda.dense_chunk_batch(inp.F, inp.n_rows, inp.masks,
                                       inp.ret_slot, w=w, ns=ns)
    n_rows = inp.n_rows.tolist()
    singles = [dense_cuda.dense_chunk(inp.F[i], n_rows[i], inp.masks[i],
                                      inp.ret_slot[i], w=w, ns=ns)
               for i in range(len(ks))]
    F1 = torch.stack([o.F for o in singles])
    S1 = torch.stack([o.state for o in singles])
    torch.cuda.synchronize()
    if not (torch.equal(F1, res.F) and torch.equal(S1, res.state)):
        bad = [ks[i] for i in range(len(ks))
               if not (torch.equal(F1[i], res.F[i])
                       and torch.equal(S1[i], res.state[i]))]
        raise AssertionError(f"[{tag}] batched kernel != single-key "
                             f"kernel on keys {bad[:8]}")
    width_keys = {wk: sum(pl[0] == wk for pl in plans)
                  for wk in sorted({pl[0] for pl in plans})}
    log(f"[{tag}] every key's bitmap and state row equal the single-key "
        f"kernel's: w={w} ({dense_cuda.kernel_path(w)}) ns={ns} r_pad="
        f"{r_pad} keys at each width {width_keys} rows {min(n_rows)}..{max(n_rows)} "
        f"passes {int(res.state[:, 3].sum())} sweeps "
        f"{int(res.state[:, 4].sum())}")

    # The kernel against its plain version on the card, on 8 keys.
    # The corrupted keys first, then the others in the batch's order.
    first = list(corrupt) + [k for k in ks if k not in corrupt]
    sel = torch.tensor([ks.index(k) for k in first[:BATCH_PLAIN_KEYS]],
                       device=dev)
    sub = (inp.F[sel].contiguous(), inp.n_rows[sel].contiguous(),
           inp.masks[sel].contiguous(), inp.ret_slot[sel].contiguous())
    kern = dense_cuda.dense_chunk_batch(*sub, w=w, ns=ns)
    # The plain version waits for the device inside (its host loop), so
    # this one run, on the host clock, is its time.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = dense_cuda.dense_chunk_batch_plain(*sub, w=w, ns=ns)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((_u32.widen(kern.F) - _u32.widen(plain.F)).abs().max())
    if not (torch.equal(kern.F, plain.F)
            and torch.equal(kern.state, plain.state)):
        raise AssertionError(f"[{tag}] dense_chunk_batch != its plain "
                             f"version on keys {sel.tolist()}")
    # A row count past the tables: both run no row for that key, flag it
    # alike, and the host check rejects it.
    bad_rows = sub[1].clone()
    bad_rows[0] = r_pad + 1
    kb = dense_cuda.dense_chunk_batch(sub[0], bad_rows, *sub[2:], w=w, ns=ns)
    pb = dense_cuda.dense_chunk_batch_plain(sub[0], bad_rows, *sub[2:], w=w,
                                            ns=ns)
    if not (torch.equal(kb.F, pb.F) and torch.equal(kb.state, pb.state)
            and int(kb.state[0, 0]) == dense_cuda.BAD_ROWS
            and torch.equal(kb.F[0], sub[0][0])):
        raise AssertionError(f"[{tag}] a bad row count: kernel state "
                             f"{kb.state[0].tolist()}, plain "
                             f"{pb.state[0].tolist()}")
    try:
        dense_cuda.check_batch_state(kb.state.cpu())
    except ValueError:
        pass
    else:
        raise AssertionError(f"[{tag}] check_batch_state passed a bad row "
                             f"count")

    # Times.
    def launch(*a):
        return lambda: dense_cuda.dense_chunk_batch(*a, w=w, ns=ns)

    ms = time_chunk(launch(inp.F, inp.n_rows, inp.masks, inp.ret_slot),
                    reps=5)
    ms_sel = time_chunk(launch(*sub), reps=5)
    widths = [pl[0] for pl in plans]
    b_ms, b_by = batch_bound_ms(widths, w, ns, res.state.cpu())
    pad_ms, _ = batch_bound_ms([w] * len(ks), w, ns, res.state.cpu())

    verdicts = oracle_results(oracle)
    want_fail = sorted((k for k, (v, _) in verdicts.items()
                        if v is not True), key=repr)
    if r["failures"] != want_fail:
        raise AssertionError(f"[{tag}] failures {r['failures']}, the CPU "
                             f"oracle's {want_fail}")
    for k in want_fail:
        if r["results"][k].get("dead-row") != verdicts[k][1]:
            raise AssertionError(f"[{tag}] key {k}: dead row "
                                 f"{r['results'][k].get('dead-row')}, the "
                                 f"oracle's {verdicts[k][1]}")
    log(f"[{tag}] failures {r['failures']} = the CPU oracle's; every "
        f"key's verdict, dead row and op = the per-key check's; kernel = "
        f"plain on keys {sel.tolist()} (bit-exact), and on a row count "
        f"past the tables (both flag it, the host check raises)")
    log(f"[{tag}] {smi} | synth+wrap {t_synth:.3f}s; lifted checker e2e "
        f"{t_e2e:.3f}s; batch with packing {t_batch:.3f}s, without "
        f"{t_device:.3f}s; per-key loop (checker.linearizable gpu) "
        f"{t_loop:.3f}s")
    log(f"[{tag}] {smi} | dense_chunk_batch {ms:.4f} ms a launch over "
        f"{len(ks)} keys ({ms / len(ks) * 1e3:.2f} us a key), bound "
        f"{b_ms:.6f} ms ({b_by}; each key at its own width; "
        f"{ms / b_ms:.1f}x it), padded bound (every key at w={w}) "
        f"{pad_ms:.6f} ms; on {len(sel)} keys {ms_sel:.4f} ms, "
        f"plain {plain_ms:.2f} ms; launches on the main path {launches}; "
        f"no single PyTorch call computes this function")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "padded_bound_ms": pad_ms,
            "shape": {"keys": len(ks), "w": w, "ns": ns, "r_pad": r_pad,
                      "keys_at_width": width_keys},
            "plain_keys": len(sel), "ms_plain_keys": ms_sel,
            "batch_s": t_batch, "batch_device_s": t_device,
            "per_key_loop_s": t_loop, "lifted_e2e_s": t_e2e}


def sparse_batch_phase(dev, pool, smi: str):
    """The group that leaves the dense bounds through the multiword
    sparse batch, held against the CPU oracle and the same batch on the
    CPU."""
    import torch

    from jepsen_tpu_torch import checker, independent
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.history import History, invoke_op, ok_op
    from jepsen_tpu_torch.lin import batched, bfs, cpu, prepare

    model = m.cas_register()
    specs = batch_key_specs(BATCH_SPARSE)
    specs += [(seed, seed, True, specs[0][3]) for seed in
              BATCH_SPARSE_CORRUPT]
    oracle = start_oracle(pool, specs)
    subs = {spec[0]: batch_key_history(spec) for spec in specs}
    chain = [invoke_op(0, "write", 0), ok_op(0, "write", 0)]
    chain += [invoke_op(i + 1, "cas", [i, i + 1]) for i in range(24)]
    chain += [ok_op(i + 1, "cas", [i, i + 1]) for i in range(24)]
    subs["chain"] = History.of(*chain)
    ck = independent.checker(checker.linearizable(algorithm="gpu",
                                                  device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = ck.check(None, model, kv_history(subs), {})
    t_e2e = time.perf_counter() - t0
    analyzers = {v.get("analyzer") for v in r["results"].values()}
    if not (r["batch-keys"] == len(subs) == r["n-keys"]
            and analyzers == {"gpu-bfs-batch"}):
        raise AssertionError(f"[batch-sparse] batch-keys {r['batch-keys']} "
                             f"of {len(subs)}, analyzers {analyzers}")
    verdicts = oracle_results(oracle)
    verdicts["chain"] = (lambda o: (o["valid?"], o.get("dead-row")))(
        cpu.check_packed(prepare.prepare(model, subs["chain"])))
    for k, (v, d) in verdicts.items():
        got = r["results"][k]
        if (got["valid?"], got.get("dead-row")) != (v, d):
            raise AssertionError(f"[batch-sparse] key {k!r}: batch "
                                 f"{got['valid?']} row {got.get('dead-row')}"
                                 f", CPU oracle {v} row {d}")

    # The same search on the card and on the CPU, bit for bit, at each
    # capacity of the batch's schedule up to the one that decided.
    packed = {k: prepare.prepare(model, sub) for k, sub in subs.items()}
    ks, w_pad, nw, r_pad = batched.sparse_batch_shape(packed)
    ps = [packed[k] for k in ks]
    cpu_dev = torch.device("cpu")
    for cap in batched.BATCH_CAP_SCHEDULE:
        outs, secs = {}, {}
        for d in (dev, cpu_dev):
            tables = batched.sparse_batch_tables(ps, r_pad, w_pad, nw, d)
            entry = batched.sparse_batch_entry(ps, cap, nw, d)
            t0 = time.perf_counter()
            outs[d] = [x.cpu() for x in bfs._search_chunk(
                r_pad, *tables, *entry, cap=cap, step_fn=ps[0].kernel.step)]
            secs[d] = time.perf_counter() - t0
        if not all(torch.equal(a, b) for a, b in zip(outs[dev],
                                                     outs[cpu_dev])):
            raise AssertionError(f"[batch-sparse] the card's frontiers at "
                                 f"cap {cap} differ from the CPU run's")
        ovf = [k for k, o in zip(ks, outs[dev][5].tolist()) if o]
        log(f"[batch-sparse] {smi} | search at cap {cap}: card "
            f"{secs[dev]:.3f}s, CPU {secs[cpu_dev]:.3f}s; frontiers (counts "
            f"{int(outs[dev][2].min())}..{int(outs[dev][2].max())}) equal "
            f"bit for bit; overflowed keys {ovf}")
        if not ovf:
            break
    if ovf:
        raise AssertionError(f"[batch-sparse] keys {ovf} overflow the "
                             f"last capacity")
    log(f"[batch-sparse] keys={len(ks)} window {w_pad} (+1 pad slot) "
        f"r_pad={r_pad} valid?={r['valid?']} failures={r['failures']} "
        f"analyzers={sorted(analyzers)}; verdicts and dead rows = the CPU "
        f"oracle's")
    log(f"[batch-sparse] {smi} | lifted checker e2e {t_e2e:.3f}s")


def batch_phases(dev, smi: str) -> list:
    """Phase 20, independent keys. Returns the kernels line's
    ``dense_chunk_batch`` entry."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            max_workers=ORACLE_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        etcd = dense_batch_phase(dev, pool, "batch-etcd", BATCH_ETCD,
                                 BATCH_ETCD_CORRUPT, smi)
        config4 = dense_batch_phase(dev, pool, "batch-config4",
                                    BATCH_CONFIG4, (), smi)
        sparse_batch_phase(dev, pool, smi)
    log(f"[batch] phase 20 in {time.perf_counter() - t0:.1f}s")
    return [{"name": "dense_chunk_batch", "route": "cuda",
             "source": "jepsen_tpu_torch/csrc/dense_chunk.cu",
             "replaces": "jepsen_tpu/lin/batched.py:153",
             "bit_exact": True, **etcd,
             "config4": {k: config4[k] for k in (
                 "launches", "ms", "bound_ms", "bound_by",
                 "padded_bound_ms", "shape",
                 "batch_s", "batch_device_s", "per_key_loop_s",
                 "lifted_e2e_s")}}]


# --- the generic packed and multiword bands (phase 21) ----------------------
#
# name: (synth generator, its arguments, model, band, (max-cap,
# final-frontier-size)). The last pair is what the JAX package's
# bfs.check_packed gives on the same history (on the CPU;
# tests/test_torch_bands.py's slow cases hold the port to it).
BANDS = {
    "mutex": ("generate_mutex_history",
              dict(n_ops=100_000, concurrency=10, seed=7, crash_prob=0.01,
                   max_crashes=16), "mutex", "generic", (256, 5)),
    "set-word": ("generate_set_history",
                 dict(n_ops=40, concurrency=3, seed=7), "set_model",
                 "generic", (256, 1)),
    "set-wide": ("generate_set_history",
                 dict(n_ops=600, concurrency=10, seed=7), "set_model",
                 "multiword", (2048, 1)),
    "queue": ("generate_queue_history",
              dict(n_ops=900, concurrency=10, seed=7, fifo=False),
              "unordered_queue", "multiword", (2048, 1)),
    "fifo": ("generate_queue_history", dict(n_ops=100, concurrency=3, seed=7),
             "fifo_queue", "multiword", (16384, 3)),
}
# The shapes with a corrupted twin (band_twin), corrupted in their first
# events so that the explain replay spans few rows.
BANDS_CORRUPT = ("mutex", "set-word", "set-wide", "queue")
BANDS_CORRUPT_EVENTS = 60
# Dedup inputs recorded at the mutex's most frequent tier (every
# BANDS_SAMPLE_EVERY-th call at a size, up to BANDS_SAMPLES), each held
# against the plain version on the card.
BANDS_SAMPLES = 8
BANDS_SAMPLE_EVERY = 4001


def band_twin(name: str, h):
    """The corrupted twin of a phase-21 history, invalid for certain and
    early: for the mutex, a new process acquires the lock right after the
    first ok acquire that precedes every crash (the lock is held until
    its holder's release is invoked, later); for a set, an ok read in the
    first events misses its last element; for the queue, an ok dequeue in
    the first events of a value never enqueued."""
    import random

    from jepsen_tpu_torch.history import History, index_history, invoke_op, \
        ok_op

    h = list(h)
    lim = max(len(h) // 20, BANDS_CORRUPT_EVENTS)
    if name == "mutex":
        crash = next((i for i, o in enumerate(h) if o.type == "info"), len(h))
        i = next(i for i, o in enumerate(h[:crash])
                 if o.type == "ok" and o.f == "acquire")
        h[i + 1:i + 1] = [invoke_op(10 ** 6, "acquire", None),
                          ok_op(10 ** 6, "acquire", None)]
        return index_history(History(h))
    if name.startswith("set"):
        pos = [i for i, o in enumerate(h[:lim])
               if o.type == "ok" and o.f == "read" and o.value]
        change = None
    else:
        pos = [i for i, o in enumerate(h[:lim])
               if o.type == "ok" and o.f == "dequeue"]
        change = {"value": 10 ** 6}
    i = random.Random(11).choice(pos)
    h[i] = h[i].replace(**(change or {"value": list(h[i].value)[:-1]}))
    return index_history(History(h))


@contextlib.contextmanager
def host_meter():
    """What the host did over a block, for telling a slow host from more
    work: wall and process CPU seconds, involuntary context switches, the
    garbage collector's runs and seconds, and before the block the load
    average, the live Python objects and the CUDA allocator's segments
    and reserved bytes. Yields the dict it fills at the block's end."""
    import gc
    import resource

    import torch

    out = {"load_1min": round(os.getloadavg()[0], 2),
           "py_objects": len(gc.get_objects())}
    if torch.cuda.is_available():
        ms = torch.cuda.memory_stats()
        out["cuda_segments"] = ms.get("segment.all.current", 0)
        out["cuda_reserved_mib"] = round(
            torch.cuda.memory_reserved() / 2**20, 1)
    gc_t = {"runs": [0, 0, 0], "s": 0.0, "t0": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            gc_t["t0"] = time.perf_counter()
        else:
            gc_t["s"] += time.perf_counter() - gc_t["t0"]
            gc_t["runs"][info["generation"]] += 1

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    w0, c0 = time.perf_counter(), time.process_time()
    gc.callbacks.append(on_gc)
    try:
        yield out
    finally:
        gc.callbacks.remove(on_gc)
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        out.update(wall_s=round(time.perf_counter() - w0, 3),
                   cpu_s=round(time.process_time() - c0, 3),
                   invol_ctx=ru1.ru_nivcsw - ru0.ru_nivcsw,
                   gc_runs=gc_t["runs"], gc_s=round(gc_t["s"], 3))


def bands_mutex_kernels(dedup_spy, compact_spy, launches) -> dict:
    """Phase 21's kernels on the mutex's own inputs: every recorded dedup
    input at the most frequent candidate size and the first compaction at
    the most frequent cap, kernel against plain version bit for bit; then
    each one's time beside its plain version's, one PyTorch call's and its
    bound. Returns the two kernels' entries for the kernels line."""
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import psort

    n_d = max((n for n in dedup_spy.sizes if n is not None),
              key=dedup_spy.sizes.get)
    err, out = 0, {}
    for cand, valid, cap in dedup_spy.samples[n_d]:
        same, e = same_outputs(psort.dedup_keys(cand, valid, cap),
                               psort.dedup_keys_plain(cand, valid, cap))
        err = max(err, e)
        if not same:
            raise AssertionError(f"[bands] dedup_keys != plain on the "
                                 f"mutex's candidates (n={n_d}, cap={cap})")
    cand, valid, cap = dedup_spy.samples[n_d][-1]
    key = _u32.widen(cand) | ((~valid).to(torch.int64) << 31)
    live = key[valid]
    digits = sum(int(d.amin() != d.amax()) for d in
                 ((live >> (8 * i)) & 0xFF for i in range(4))) \
        if live.numel() else 0
    bound, by = radix_dedup_bound(n_d, int(valid.sum()), digits, cap, 5, 4)
    ms = time_chunk(lambda: psort.dedup_keys(cand, valid, cap), 50)
    plain = time_chunk(lambda: psort.dedup_keys_plain(cand, valid, cap), 20)
    lib = time_chunk(lambda: torch.unique(key, sorted=True), 50)
    out["dedup_keys"] = {
        "launches": launches["dedup_keys"], "n": n_d, "cap": cap,
        "calls_by_n": dict(sorted(dedup_spy.sizes.items())),
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
        "bound_ms": bound, "bound_by": by, "digits": digits,
        "inputs_checked": len(dedup_spy.samples[n_d])}
    log(f"[bands-mutex-time] dedup_keys n={n_d} cap={cap} "
        f"({dedup_spy.sizes[n_d]} calls at this size, {int(valid.sum())} "
        f"candidates valid, {len(dedup_spy.samples[n_d])} inputs bit-exact "
        f"vs plain): kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.unique "
        f"{lib:.4f} ms, bound {bound:.6f} ms ({by}; {digits} digits vary)")

    by_n = compact_spy.paths()["by_n"]
    c_n = max(by_n, key=lambda n: sum(by_n[n].values()))
    keys, c_cap = compact_spy.firsts[c_n]
    same, e = same_outputs(psort.compact_keys(keys, c_cap),
                           psort.compact_keys_plain(keys, c_cap))
    if not same:
        raise AssertionError(f"[bands] compact_keys != plain on the mutex's "
                             f"return filter (n={c_n})")
    bound, by = sort_bound(c_n, c_cap, 4, 4)
    ms = time_chunk(lambda: psort.compact_keys(keys, c_cap), 50)
    plain = time_chunk(lambda: psort.compact_keys_plain(keys, c_cap), 20)
    lib = time_chunk(lambda: torch.sort(_u32.widen(keys)), 50)
    out["compact_keys"] = {
        "launches": launches["compact_keys"], "n": c_n, "cap": c_cap,
        "calls_by_n": by_n, "max_abs_err": e, "ms": ms, "plain_ms": plain,
        "library_ms": lib, "bound_ms": bound, "bound_by": by,
        "kept": int((keys != psort.KEY_FILL_RAW).sum())}
    log(f"[bands-mutex-time] compact_keys n={c_n} ({sum(by_n[c_n].values())}"
        f" calls at this size, {out['compact_keys']['kept']} kept, bit-exact "
        f"vs plain): kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.sort "
        f"{lib:.4f} ms, bound {bound:.6f} ms ({by})")
    return out


def bands_phases(dev) -> dict:
    """Phase 21, the generic packed and multiword bands. Returns the mutex
    shape's entries for the dedup_keys and compact_keys kernels."""
    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import bfs, dense, prepare, psort, synth

    t_phase = time.perf_counter()
    mutex_out = None
    for name, (gen, kw, model_name, band, want) in BANDS.items():
        model = getattr(m, model_name)()
        h = getattr(synth, gen)(**kw)
        t0 = time.perf_counter()
        p = prepare.prepare(model, h)
        t_prep = time.perf_counter() - t0
        walk = prepare.pack_stats()["mode"]
        if bfs.key_band(p) != band or dense.plan(p) is not None:
            raise AssertionError(f"[bands-{name}] routed to the "
                                 f"{bfs.key_band(p)} band (dense plan "
                                 f"{dense.plan(p)}), not the {band} band")
        spies = [CallTimer(bfs, "check_packed", mode="wall")]
        if name == "mutex":
            spies += [CallTimer(psort, "dedup_keys", mode="count",
                                keep=BANDS_SAMPLES,
                                every=BANDS_SAMPLE_EVERY),
                      CallTimer(bfs, "_dedup_keys_sort", mode="count"),
                      CompactSpy(4)]
        with contextlib.ExitStack() as stack:
            for spy in spies:
                stack.enter_context(spy)
            host = stack.enter_context(host_meter())
            reset_launches()
            t0 = time.perf_counter()
            r = checker.linearizable(algorithm="gpu", device=dev).check(
                None, model, h)
            t_e2e = time.perf_counter() - t0
            launches = {k: psort.LAUNCHES[k]
                        for k in ("dedup_keys", "compact_keys")}
        t0 = time.perf_counter()
        rc = checker.linearizable(algorithm="cpu").check(None, model, h)
        t_cpu = time.perf_counter() - t0
        stats = r.get("engine-stats") or {}
        log(f"[bands-{name}] {band} band: ops={kw['n_ops']} window="
            f"{p.window} R={p.R} S={p.state_width} kernel={p.kernel.name} "
            f"verdict={r['valid?']} analyzer={r.get('analyzer')} backend="
            f"{r.get('backend')} max-cap={r.get('max-cap')} "
            f"final-frontier-size={r.get('final-frontier-size')} "
            f"launches={launches}")
        t_dev = spies[0].total_ms() / 1e3
        passes = stats.get("unfused_passes", stats.get("passes", 0))
        log(f"[bands-{name}] prepare={t_prep:.3f}s walk={walk} "
            f"e2e={t_e2e:.3f}s device "
            f"check={t_dev:.3f}s ({t_dev / max(passes, 1) * 1e3:.4f} ms a "
            f"closure pass) cpu oracle={t_cpu:.3f}s ({rc['valid?']}, "
            f"{rc.get('analyzer')}) stats={stats}")
        log(f"[bands-{name}] host during the entry point's run: {host}")
        if r["valid?"] is not True or r.get("analyzer") != "gpu-bfs" \
                or rc["valid?"] is not True:
            raise AssertionError(f"[bands-{name}] gpu {r} cpu "
                                 f"{rc['valid?']!r}")
        got = (r.get("max-cap"), r.get("final-frontier-size"))
        if got != want:
            raise AssertionError(f"[bands-{name}] (max-cap, final frontier) "
                                 f"{got}, the JAX package's {want}")
        if name == "mutex":
            _, dedup_spy, sort_spy, compact_spy = spies
            if min(launches.values()) <= 0:
                raise AssertionError(f"[bands-mutex] launches {launches}")
            if dev.type == "cuda" and (
                    launches["dedup_keys"] != stats["unfused_passes"]
                    - sort_spy.n_calls()
                    or launches["compact_keys"] != stats["compactions"]):
                raise AssertionError(
                    f"[bands-mutex] launches {launches} against "
                    f"{stats['unfused_passes']} passes "
                    f"({sort_spy.n_calls()} on the torch.sort "
                    f"twin) and {stats['compactions']} compactions")
            log(f"[bands-mutex] dedup_keys calls by n (route kernel): "
                f"{dict(sorted(dedup_spy.sizes.items()))}; torch.sort twin "
                f"(past psort.DEDUP_MAX_N): "
                f"{dict(sorted(sort_spy.sizes.items()))}")
            compact_spy.check_ordered("bands-mutex", psort.COMPACT_ONE_MAX_N)
            mutex_out = bands_mutex_kernels(dedup_spy, compact_spy,
                                            launches)
        if name in BANDS_CORRUPT:
            band_counterexample(dev, name, model, h)
    took = time.perf_counter() - t_phase
    log(f"[bands] phase 21 in {took:.1f}s")
    return mutex_out


def band_counterexample(dev, name: str, model, h):
    """A phase-21 shape's corrupted twin through ``"gpu"`` and ``"cpu"``:
    both invalid on the same op and dead row, final paths from the GPU
    that the CPU oracle's replay holds."""
    from jepsen_tpu_torch import checker
    from jepsen_tpu_torch.lin import prepare

    hc = band_twin(name, h)
    pc = prepare.prepare(model, hc)
    t0 = time.perf_counter()
    rg = checker.linearizable(algorithm="gpu", device=dev).check(
        None, model, hc)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = checker.linearizable(algorithm="cpu").check(None, model, hc)
    t_c = time.perf_counter() - t0
    log(f"[bands-{name}-counterexample] window={pc.window} R={pc.R} gpu="
        f"{rg['valid?']} ({rg.get('analyzer')}, {t_g:.2f}s) cpu="
        f"{rc['valid?']} ({t_c:.2f}s) dead-row gpu={rg.get('dead-row')} "
        f"cpu={rc.get('dead-row')} op={rg.get('op')} final-paths="
        f"{len(rg.get('final-paths', []))}")
    if rg["valid?"] is not False or rc["valid?"] is not False \
            or rg.get("analyzer") != "gpu-bfs":
        raise AssertionError(f"[bands-{name}] corrupted twin: gpu "
                             f"{rg['valid?']!r} ({rg.get('analyzer')}) cpu "
                             f"{rc['valid?']!r}")
    if (rg.get("op"), rg.get("dead-row")) != (rc.get("op"),
                                               rc.get("dead-row")):
        raise AssertionError(f"[bands-{name}] gpu {rg.get('op')} at "
                             f"{rg.get('dead-row')}, cpu {rc.get('op')} at "
                             f"{rc.get('dead-row')}")
    if not rg.get("final-paths") or "error" in rg:
        raise AssertionError(f"[bands-{name}] the GPU counterexample has no "
                             f"final paths: {rg.get('error')}")


# --- the pack layer (phase 22) -----------------------------------------------

# BASELINE config 5's history (jepsen_tpu_torch/config5.py: window 49, 24
# crashed mutators), packed here only.
PACK_CONFIG5 = dict(n_ops=100_000, seed=7, invoke_bias=0.45)
PACK_REPS = 3
PACK_FIELDS = ("ret_slot", "ret_op", "active", "slot_f", "slot_v",
               "slot_op", "crashed", "init_state")


@contextlib.contextmanager
def fast_pack(on: bool):
    """``JEPSEN_TPU_FAST_PACK`` set (``=0`` when not ``on``) inside, and
    put back as it was after."""
    saved = os.environ.get("JEPSEN_TPU_FAST_PACK")
    os.environ["JEPSEN_TPU_FAST_PACK"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("JEPSEN_TPU_FAST_PACK", None)
        else:
            os.environ["JEPSEN_TPU_FAST_PACK"] = saved


def same_pack(a, b, tag: str) -> None:
    """Raise unless two packs of one history are the same: every
    PackedHistory field, the interns, the ops and the reduction tables."""
    import numpy as np

    from jepsen_tpu_torch.lin import prepare

    if (a.window, a.R) != (b.window, b.R):
        raise AssertionError(f"{tag}: window/R {(a.window, a.R)} against "
                             f"{(b.window, b.R)}")
    ra, rb = prepare.reduction_tables(a), prepare.reduction_tables(b)
    pairs = [(name, getattr(a, name), getattr(b, name))
             for name in PACK_FIELDS]
    pairs += [("pure", ra[0], rb[0]), ("pred", ra[1], rb[1])]
    for name, x, y in pairs:
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{tag}: {name} differs ({x.dtype} "
                                 f"{x.shape} against {y.dtype} {y.shape})")
    if a.intern != b.intern or a.unintern != b.unintern \
            or a.ops != b.ops or a.crashed_ops != b.crashed_ops \
            or (a.kernel and a.kernel.name) != (b.kernel and b.kernel.name):
        raise AssertionError(f"{tag}: interns, ops or kernel differ")


def host_pack(model, h):
    """``prepare`` plus ``reduction_tables`` of ``h``: the pack and the
    host's wall seconds."""
    from jepsen_tpu_torch.lin import prepare

    t0 = time.perf_counter()
    p = prepare.prepare(model, h)
    prepare.reduction_tables(p)
    return p, time.perf_counter() - t0


def pack_walks(name: str, model, h, smi: str) -> tuple:
    """The host packer on ``h``, ``PACK_REPS`` rounds interleaved: the
    default ``prepare`` plus ``reduction_tables`` (it must take the native
    walk: two value words) beside the spec path
    (``JEPSEN_TPU_FAST_PACK=0``, the py walk), and the two walks the
    history could take, native and vec, alone on its columns. Every walk
    must give the same tables. Returns the default pack and its best
    time."""
    import numpy as np

    from jepsen_tpu_torch.lin import prepare

    times = {w: [] for w in ("default", "py", "native walk", "vec walk")}
    packs = {}
    cols = prepare._columns(model, list(h))
    (_, kernel, _, op_f, op_v, _, invoke_pos, return_pos, R, _, _) = cols
    args = (invoke_pos, return_pos, op_f, op_v, prepare.MAX_WINDOW,
            kernel is not None, R)
    walks = {}
    for _ in range(PACK_REPS):
        for fast, leg in ((True, "default"), (False, "py")):
            with fast_pack(fast):
                p, dt = host_pack(model, h)
                ran = prepare.pack_stats()["mode"]
            times[leg].append(dt)
            want = "native" if fast else "py"
            if ran != want:
                raise AssertionError(f"[pack-{name}] the {leg} pack ran "
                                     f"the {ran} walk, not {want}")
            packs.setdefault(leg, p)
        for walk, fn in (("native walk", prepare._pack_events_native),
                         ("vec walk", prepare._pack_events_vec)):
            t0 = time.perf_counter()
            out = fn(*args)
            times[walk].append(time.perf_counter() - t0)
            walks.setdefault(walk, out)
    same_pack(packs["default"], packs["py"], f"[pack-{name}] py walk")
    W = packs["default"].window
    for walk, out in walks.items():
        got = [np.asarray(x)[:, :W] if np.ndim(x) >= 2 else np.asarray(x)
               for x in out[:6]]
        want = [packs["default"].ret_slot, packs["default"].ret_op,
                packs["default"].active, packs["default"].slot_f,
                packs["default"].slot_v, packs["default"].slot_op]
        if out[6] != W or any(x.dtype != y.dtype or not np.array_equal(x, y)
                              for x, y in zip(got, want)):
            raise AssertionError(f"[pack-{name}] the {walk}'s tables "
                                 "differ from the default pack's")
    best = {w: min(t) for w, t in times.items()}
    log(f"[pack-{name}] host packer (host's wall seconds, best of "
        f"{PACK_REPS} interleaved): prepare + reduction_tables default "
        f"(native walk) {best['default']:.3f}s "
        f"{[round(x, 3) for x in times['default']]}, "
        f"JEPSEN_TPU_FAST_PACK=0 (py walk) {best['py']:.3f}s "
        f"{[round(x, 3) for x in times['py']]}, py over default "
        f"{best['py'] / best['default']:.2f}x; the slot walk alone on the "
        f"same columns: native {best['native walk'] * 1e3:.1f} ms "
        f"{[round(x * 1e3, 1) for x in times['native walk']]}, vec "
        f"{best['vec walk'] * 1e3:.1f} ms "
        f"{[round(x * 1e3, 1) for x in times['vec walk']]}, vec over "
        f"native {best['vec walk'] / best['native walk']:.2f}x; tables "
        f"identical | {smi}")
    return packs["default"], best["default"]


def pack_dev_one(dev, name: str, model, h, host, t_host: float,
                 smi: str) -> None:
    """``pack_dev.materialize`` of ``h`` on the card: the host's prepack,
    the first call and the best of three after it, their sum beside the
    host pack's ``t_host``, the shape bucket and the peak device memory;
    its tables and reduction tables must be ``host``'s."""
    import torch

    from jepsen_tpu_torch.lin import pack_dev

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    pre = pack_dev.prepack(model, h)
    t_pre = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(4):
        before = pack_dev.dev_stats()["dev_packs"]
        t0 = time.perf_counter()
        got = pack_dev.materialize(pre, device=dev)
        runs.append(time.perf_counter() - t0)
        if pack_dev.dev_stats()["dev_packs"] != before + 1:
            raise AssertionError(f"[pack-dev-{name}] materialize did not "
                                 "run on the device")
        same_pack(host, got, f"[pack-dev-{name}]")
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0
    shape = pack_dev.pad_shape(pre.n, pre.R, pre.window,
                               pre.op_v.shape[1])
    total = t_pre + min(runs[1:])
    log(f"[pack-dev-{name}] window={pre.window} R={pre.R} n={pre.n} "
        f"bucket (n_pad, r_pad, w_pad, vw)={shape}: prepack "
        f"{t_pre:.3f}s (host), materialize first call {runs[0]:.4f}s, "
        f"then best {min(runs[1:]):.4f}s "
        f"{[round(x, 4) for x in runs[1:]]} (wall to the host's tables); "
        f"prepack + best materialize {total:.3f}s against the host pack's "
        f"{t_host:.3f}s ({t_host / total:.2f}x); peak device memory "
        f"{peak:.1f} MiB; bit-exact to the host pack, pure/pred included "
        f"| {smi}")


def pack_dev_batch(dev, smi: str) -> None:
    """``pack_dev.materialize_batch`` over ``[batch-etcd]``'s 500 keys
    with ``pack_dev.MIN_BATCH_K`` set to 1 for the call, so that every
    eligible lane must ride the device, every lane held to the host pack,
    its time with the host's prepack beside the host pack's time for the
    same keys."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import pack_dev

    hs = [batch_key_history(s)
          for s in batch_key_specs(BATCH_ETCD, BATCH_ETCD_CORRUPT)]
    model = m.cas_register()
    t0 = time.perf_counter()
    hosts = [host_pack(model, h)[0] for h in hs]
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    pres = [pack_dev.prepack(model, h) for h in hs]
    t_pre = time.perf_counter() - t0
    eligible = sum(pack_dev._device_eligible(p) for p in pres)
    buckets: dict = {}
    for p in pres:
        if pack_dev._device_eligible(p):
            shape = pack_dev.pad_shape(p.n, p.R, p.window, p.op_v.shape[1])
            buckets[shape] = buckets.get(shape, 0) + 1
    before = pack_dev.dev_stats()
    min_k, pack_dev.MIN_BATCH_K = pack_dev.MIN_BATCH_K, 1
    try:
        t0 = time.perf_counter()
        got = pack_dev.materialize_batch(pres, device=dev)
        t_mat = time.perf_counter() - t0
    finally:
        pack_dev.MIN_BATCH_K = min_k
    st = {k: v - before[k] for k, v in pack_dev.dev_stats().items()}
    for i, (a, b) in enumerate(zip(hosts, got)):
        same_pack(a, b, f"[pack-dev-batch] key {i}")
    if st["dev_lanes"] != eligible or st["host_eligible"] != 0 \
            or st["host_lanes"] != len(pres) - eligible \
            or st["dev_packs"] != len(buckets):
        raise AssertionError(f"[pack-dev-batch] {eligible} eligible lanes "
                             f"in {len(buckets)} buckets, dev_stats {st}")
    small = sum(k for k in buckets.values() if k < pack_dev.MIN_BATCH_K)
    log(f"[pack-dev-batch] {len(pres)} keys, {eligible} eligible: "
        f"{st['dev_packs']} waves, {st['dev_lanes']} lanes on the device, "
        f"{st['host_lanes']} on the host; buckets {buckets} ({small} lanes "
        f"in waves below MIN_BATCH_K {pack_dev.MIN_BATCH_K}); "
        f"materialize_batch {t_mat:.3f}s (wall) after the host's prepack "
        f"{t_pre:.3f}s, {t_pre + t_mat:.3f}s in all, against the host pack "
        f"of the same keys (prepare + reduction_tables) {t_host:.3f}s "
        f"({t_host / (t_pre + t_mat):.2f}x); every lane bit-exact to it "
        f"| {smi}")


def pack_phases(dev, smi: str) -> None:
    """Phase 22: the host walks on the dense headline and config 5's
    history, and the device packer on those, the 100k mutex and
    ``[batch-etcd]``'s keys. It makes its histories anew, so that the
    phases before it run on the heap they had without it."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import pack_dev, synth

    t_phase = time.perf_counter()
    pack_dev.reset_dev_stats()
    model = m.cas_register()
    shapes = [("headline", model,
               synth.generate_register_history(**HEADLINE)),
              ("config5", model,
               synth.generate_partitioned_register_history(**PACK_CONFIG5))]
    gen, kw, model_name, _, _ = BANDS["mutex"]
    with fast_pack(True):
        for name, model, h in shapes:
            host, t_host = pack_walks(name, model, h, smi)
            pack_dev_one(dev, name, model, h, host, t_host, smi)
        mutex = getattr(m, model_name)()
        h = getattr(synth, gen)(**kw)
        host, t_host = host_pack(mutex, h)
        pack_dev_one(dev, "mutex", mutex, h, host, t_host, smi)
        pack_dev_batch(dev, smi)
    st = pack_dev.dev_stats()
    log(f"[pack] dev_stats over phase 22: {st}")
    if st["dev_packs"] <= 0 or st["host_eligible"] != 0:
        raise AssertionError(f"[pack] device packer stats {st}")
    took = time.perf_counter() - t_phase
    log(f"[pack] phase 22 in {took:.1f}s")
    if took > 60:
        raise AssertionError(f"[pack] phase 22 took {took:.1f}s (> 60 s)")


# Phase 23: the transaction checker (txn).
# txn_c30's seeded shape (the JAX package's bench probe): 50,000 list-append
# transactions at concurrency 30 over 32 keys with crashes, two G2-item
# splices (seed 3) and one G-single (seed 5); and what its full tier must
# show, the JAX package's numbers on the CPU (tests/test_torch_txn.py's
# slow case holds them).
TXN_C30 = dict(n_txns=50_000, concurrency=30, keys=32, seed=7,
               crash_prob=0.0005)
TXN_C30_EXPECT = dict(window=[15613, 40845], window_edges=91_370, core=6,
                      device_sccs=3, residue=0, residue_sccs=0,
                      iterations=[2734, 2, 2], n_pad=32_768,
                      e_pad=131_072, device=True)
TXN_C30_COUNTS = {"G-single": 1, "G2-item": 2}
TXN_HEALTHY = dict(n_txns=5_000, concurrency=30, keys=32, seed=11)
TXN_STRICT = dict(n_txns=300, seed=9)
# (kind, n, n_pad, edges, e_pad, it_max or None for auto) of the kernel's
# bit-exact cases: the sizes of a window from 256 nodes to 2^20, edges
# 512 to 2^22.
TXN_GRAPHS = (("random", 200, 256, 400, 512, None),
              ("random", 200, 256, 400, 512, 1),
              ("empty", 200, 256, 0, 512, None),
              ("dense-cyclic", 1000, 1024, 3000, 4096, None),
              ("chain", 4000, 4096, 4000, 4096, None),
              ("one-cycle", 8192, 8192, 8192, 8192, None),
              ("random", 60_000, 1 << 16, 250_000, 1 << 18, None),
              ("dense-cyclic", 250_000, 1 << 18, 750_000, 1 << 20, None),
              ("chain", 1 << 20, 1 << 20, 1 << 20, 1 << 21, 1),
              ("random", 1 << 20, 1 << 20, 4_000_000, 1 << 22, None),
              ("random", 1 << 20, 1 << 20, 4_000_000, 1 << 22, 1),
              ("empty", 1 << 20, 1 << 20, 0, 1 << 22, None))
TXN_REPS = 10
TXN_PHASE_S = 90


def txn_graph(rng, kind: str, n: int, e: int, e_pad: int):
    """Seeded numpy (src, dst, live) of one SCC-program input: random
    edges; a ring with random chords; a chain whose one back edge, from
    3n/4 to n/4, closes a cycle in its middle (its tails trim one node a
    round from each end, its labels and flags walk the cycle); every node
    in one cycle; no edge."""
    import numpy as np

    if kind == "random":
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
    elif kind == "dense-cyclic":
        ring = np.arange(n)
        src = np.concatenate([ring, rng.integers(0, n, e - n)])
        dst = np.concatenate([(ring + 1) % n, rng.integers(0, n, e - n)])
    elif kind == "chain":
        src = np.append(np.arange(n - 1), 3 * n // 4)
        dst = np.append(np.arange(1, n), n // 4)
    elif kind == "one-cycle":
        src = np.arange(n)
        dst = (src + 1) % n
    else:
        src = dst = np.zeros(0, np.int64)
    e = len(src)
    live = np.arange(e_pad) < e
    return (np.pad(src.astype(np.int32), (0, e_pad - e)),
            np.pad(dst.astype(np.int32), (0, e_pad - e)), live)


def txn_kernel_vs_plain(src, dst, live, n: int, it_max: int,
                        n_pad: int) -> tuple:
    """The kernel (through its binding: no launch counted) and the plain
    version on the same inputs on the card: (bit-identical, max |error|
    over the packed outputs, the kernel's iters, overflow)."""
    import torch

    from jepsen_tpu_torch.txn import device, scc_cuda

    k = scc_cuda.scc(src, dst, live, n, it_max, n_pad)
    p = torch.cat([x.to(torch.int32) for x in device.scc_program_plain(
        src, dst, live, n, it_max, n_pad=n_pad)])
    err = int((k.long() - p.long()).abs().max())
    iters = k[3 * n_pad:3 * n_pad + 3].tolist()
    overflow = k[3 * n_pad + 3:].tolist()
    return bool(torch.equal(k, p)), err, iters, overflow


def l2_bytes_per_s(dev) -> float:
    """The L2 rate this run measured: bytes a second (read plus written)
    of copies whose source and destination together stay in the card's
    50 MB L2 (int32 buffers of 2, 4, 8 and 12 MiB, 400 copies each, CUDA
    events), as the least-squares slope of a copy's time over its bytes,
    so that each launch's fixed cost drops out. A copy's rate is a lower
    estimate of L2's peak, so a bound charged at it errs long."""
    import numpy as np
    import torch

    nbytes, ms = [], []
    for mib in (2, 4, 8, 12):
        a = torch.ones(mib << 18, dtype=torch.int32, device=dev)
        b = torch.empty_like(a)
        ms.append(time_chunk(lambda: b.copy_(a), reps=400))
        nbytes.append(2 * a.numel() * 4)
    slope = float(np.polyfit(nbytes, ms, 1)[0])
    if slope <= 0:
        raise AssertionError(f"[txn-time] L2 copy times {ms} ms for "
                             f"{nbytes} bytes give no rate")
    return 1e3 / slope


def txn_bound_ms(iters, e: int, n: int, n_pad: int, l2_bps: float) -> float:
    """Least time the card could take for the program, by bytes at the
    width the function needs. From memory, at its rate: each window
    edge's src, dst (int32) and live (bool) read once, 9 B an edge, and
    the outputs written once (alive and flag bool, lab int32, a node of
    n_pad each; iters int32[3], overflow bool[3]). From L2, at
    ``l2_bps``: every round reads the edges again (but the first, which
    is the memory read) and reads and writes the window's node state
    (alive or flag 1 B a node each way, lab 4 B), about 0.9 MB a round
    on the main path's shape, which L2 holds. A round's grid barriers are
    latency, not bytes, and are not counted; they bound the program."""
    hbm = 9 * e + 6 * n_pad + 15
    l2 = sum(k * (9 * e + b) for k, b in zip(iters, (2 * n, 8 * n, 2 * n)))
    return (hbm / PEAK_BYTES_PER_S + max(0, l2 - 9 * e) / l2_bps) * 1e3


def txn_same(a: dict, b: dict) -> bool:
    """Two check results equal but for their wall seconds."""
    a = json.loads(json.dumps(a, default=str))
    b = json.loads(json.dumps(b, default=str))
    for r in (a, b):
        r.get("device-stats", {}).pop("seconds", None)
    return a == b


def txn_phases(dev, smi: str) -> dict:
    """Phase 23: the SCC kernel bit-exact against its plain version on
    seeded graphs, txn_c30's shape through ``txn.check(algorithm="gpu")``
    (one launch, the JAX package's tier stats) and its packed graph
    through the plain version, a healthy history (no launch), a small
    strict-serializable case against its CPU run, and the kernel's time
    on the full tier's inputs. Returns the kernels line's entry."""
    import numpy as np
    import torch

    from jepsen_tpu_torch import txn
    from jepsen_tpu_torch.txn import device, pack, scc_cuda, synth

    t_phase = time.perf_counter()
    rng = np.random.default_rng(2024)
    max_err = 0
    for kind, n, n_pad, e, e_pad, it_max in TXN_GRAPHS:
        src, dst, live = (torch.from_numpy(x).to(dev) for x in
                          txn_graph(rng, kind, n, e, e_pad))
        it = it_max or device.it_max_for(n)
        t0 = time.perf_counter()
        same, err, iters, overflow = txn_kernel_vs_plain(
            src, dst, live, n, it, n_pad)
        max_err = max(max_err, err)
        log(f"[txn-vs-plain] {kind:12s} n={n} n_pad={n_pad} edges="
            f"{int(live.sum())} e_pad={e_pad} it_max={it} "
            f"grid={scc_cuda.grid(e_pad, n_pad)} iters={iters} "
            f"overflow={overflow} bit_exact={same} "
            f"({time.perf_counter() - t0:.2f}s)")
        if not same:
            raise AssertionError(f"[txn-vs-plain] kernel != plain on "
                                 f"{kind} n_pad={n_pad} (max error {err})")

    # txn_c30 through the user's entry point; pack.pack is watched so
    # that the same packed graph goes through the plain version after.
    t0 = time.perf_counter()
    h = synth.generate_list_append_history(TXN_C30["n_txns"], **{
        k: v for k, v in TXN_C30.items() if k != "n_txns"})
    h = synth.splice_anomaly(h, "G2-item", seed=3, n=2)
    h = synth.splice_anomaly(h, "G-single", seed=5)
    t_synth = time.perf_counter() - t0
    packed = []
    real_pack = pack.pack

    def watched(*a, **kw):
        packed.append(real_pack(*a, **kw))
        return packed[-1]

    pack.reset_pack_stats()
    pack.pack = watched
    try:
        device.LAUNCHES = 0
        t0 = time.perf_counter()
        r = txn.check(h, consistency="serializable", algorithm="gpu",
                      device=dev)
        t_e2e = time.perf_counter() - t0
        launches = device.LAUNCHES
    finally:
        pack.pack = real_pack
    t_pack = pack.pack_stats()["pack_s"]
    st = r["device-stats"]
    full = st["tiers"].get("full", {})
    counts = {k: len(v) for k, v in r.get("anomalies", {}).items()}
    log(f"[txn-c30] {len(h)} ops, {st['txns']} txns, {st['edges']} edges: "
        f"valid?={r['valid?']} anomaly-types={r.get('anomaly-types')} "
        f"counts={counts} analyzer={r['analyzer']} launches={launches} "
        f"fallbacks={r.get('fallbacks')}")
    log(f"[txn-c30] tiers {json.dumps(st['tiers'], sort_keys=True)}")
    log(f"[txn-c30] synth {t_synth:.3f}s, pack {t_pack:.3f}s, device "
        f"check {st['seconds']:.3f}s, txn.check end to end {t_e2e:.3f}s "
        f"(host's wall clock) | {smi}")
    short = all(st["tiers"][t].get("short_circuit") == "forward-order"
                for t in ("ww", "wwr"))
    want = {k: full.get(k) for k in TXN_C30_EXPECT}
    if r["valid?"] is not False or r.get("anomaly-types") != \
            sorted(TXN_C30_COUNTS) or counts != TXN_C30_COUNTS \
            or not short or want != TXN_C30_EXPECT or launches != 1 \
            or "fallbacks" in r or len(packed) != 1:
        raise AssertionError(f"[txn-c30] expected an invalid verdict with "
                             f"{TXN_C30_COUNTS}, ww and wwr short-circuited, "
                             f"the full tier {TXN_C30_EXPECT}, one launch and "
                             f"no fallback; got {want}, launches {launches}")
    pt = packed[0]
    t0 = time.perf_counter()
    rc = device.check_packed(pt, consistency="serializable",
                             device="cpu")
    t_cpu = time.perf_counter() - t0
    log(f"[txn-c30-plain] the same packed graph through check_packed("
        f"device='cpu') (the plain version on the host) in {t_cpu:.3f}s: "
        f"equal={txn_same(r, rc)}")
    if not txn_same(r, rc):
        raise AssertionError("[txn-c30-plain] the CPU run differs from the "
                             "card's")

    # A healthy history: every tier forward-order, no launch.
    hh = synth.generate_list_append_history(TXN_HEALTHY["n_txns"], **{
        k: v for k, v in TXN_HEALTHY.items() if k != "n_txns"})
    device.LAUNCHES = 0
    t0 = time.perf_counter()
    rh = txn.check(hh, algorithm="gpu", device=dev)
    t_h = time.perf_counter() - t0
    tiers = rh["device-stats"]["tiers"]
    forward = all(t.get("short_circuit") == "forward-order"
                  for t in tiers.values())
    log(f"[txn-healthy] {TXN_HEALTHY['n_txns']} txns: valid?="
        f"{rh['valid?']} tiers {sorted(tiers)} all forward-order="
        f"{forward} launches={device.LAUNCHES} in {t_h:.3f}s")
    if rh["valid?"] is not True or device.LAUNCHES != 0 or \
            sorted(tiers) != ["full", "ww", "wwr"] or not forward:
        raise AssertionError(f"[txn-healthy] {rh['valid?']!r}, tiers "
                             f"{tiers}, launches {device.LAUNCHES}")

    # A small strict-serializable case: the card against its CPU runs.
    hs = synth.splice_anomaly(synth.generate_list_append_history(
        TXN_STRICT["n_txns"], seed=TXN_STRICT["seed"]), "G2-item",
        seed=TXN_STRICT["seed"], n=2)
    device.LAUNCHES = 0
    rs = txn.check(hs, consistency="strict-serializable", algorithm="gpu",
                   device=dev)
    strict_launches = device.LAUNCHES
    rsc = txn.check(hs, consistency="strict-serializable", algorithm="gpu",
                    device="cpu")
    ro = txn.check(hs, consistency="strict-serializable", algorithm="cpu")
    on_card = [t for t, s in rs["device-stats"]["tiers"].items()
               if s.get("device")]
    as_oracle = (rs["valid?"], rs["anomalies"]) == (ro["valid?"],
                                                    ro["anomalies"])
    log(f"[txn-strict] {TXN_STRICT['n_txns']} txns + 2 G2-item, "
        f"strict-serializable: valid?={rs['valid?']} anomaly-types="
        f"{rs.get('anomaly-types')} launches={strict_launches}, tiers on "
        f"the card {on_card}; equal to the plain version's="
        f"{txn_same(rs, rsc)}, to the oracle's verdict and witnesses="
        f"{as_oracle}")
    if not txn_same(rs, rsc) or strict_launches < 1 or not as_oracle:
        raise AssertionError("[txn-strict] the card's result differs")

    # The kernel's time on the full tier's inputs.
    src_h, dst_h, n, lo, _ = device.tier_window(pt, "full", False)
    src, dst, live, n_pad = device.window_inputs(src_h, dst_h, n, dev)
    it = device.it_max_for(n)
    same, err, iters, _ = txn_kernel_vs_plain(src, dst, live, n, it, n_pad)
    max_err = max(max_err, err)
    if not same:
        raise AssertionError("[txn-time] kernel != plain on the full tier")
    ms = time_chunk(lambda: scc_cuda.scc(src, dst, live, n, it, n_pad),
                    reps=TXN_REPS)
    plain_ms = time_chunk(lambda: device.scc_program_plain(
        src, dst, live, n, it, n_pad=n_pad), reps=1)
    e = len(src_h)
    l2_bps = l2_bytes_per_s(dev)
    b_ms = txn_bound_ms(iters, e, n, n_pad, l2_bps)
    rounds = sum(iters)
    grid = scc_cuda.grid(int(src.shape[0]), n_pad)
    log(f"[txn-time] full tier: n={n} n_pad={n_pad} edges={e} e_pad="
        f"{int(src.shape[0])} iters={iters} ({rounds} rounds, 2 grid "
        f"barriers each): kernel {ms:.4f} ms a launch ({ms / rounds * 1e3:.3f}"
        f" us a round; grid {grid} blocks of {scc_cuda.threads()}); plain "
        f"on the card {plain_ms:.2f} ms; bound {b_ms:.6f} ms, the kernel "
        f"{ms / b_ms:.1f}x it (bytes: the edges (9 B each) and the outputs "
        f"once at 3.35 TB/s, then each later round's edges and node state "
        f"(1 B a node each way for alive and flag, 4 B for lab) from L2 at "
        f"the measured copy slope {l2_bps / 1e12:.3f} TB/s; the barriers "
        f"make it latency-bound); no single PyTorch call computes this "
        f"function "
        f"| {smi}")
    took = time.perf_counter() - t_phase
    log(f"[txn] phase 23 in {took:.1f}s")
    if took > TXN_PHASE_S:
        raise AssertionError(f"[txn] phase 23 took {took:.1f}s "
                             f"(> {TXN_PHASE_S} s)")
    return {
        "name": "txn_scc", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/txn_scc.cu",
        "replaces": "jepsen_tpu/txn/device.py:113", "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": "bytes", "library_ms": None,
        "bit_exact": True, "l2_bytes_per_s": l2_bps,
        "shape": {"n": n, "n_pad": n_pad, "edges": e,
                  "e_pad": int(src.shape[0]), "iters": iters, "grid": grid},
        "txn_c30": {"pack_s": t_pack, "device_check_s": st["seconds"],
                    "e2e_s": t_e2e, "plain_check_s": t_cpu}}


# --- the supervised runtime (phase 24) ----------------------------------------

# The sites that route around a wedge or fault, each driven on the card and
# on the CPU under the same injection; the small histories of the CPU tests
# (tests/test_torch_supervise.py).
INJECT_BAND = dict(n_ops=60, concurrency=6, seed=1, crash_prob=0.25)
INJECT_BAND_CAPS = dict(cap_schedule=(12,), host_caps=(8, 64, 512))
INJECT_SPIKE = dict(n_ops=60, concurrency=16, seed=7, value_range=5)
INJECT_SPIKE_CAPS = dict(cap_schedule=(256,), spike_caps=(2048,))
INJECT_MUTEX = dict(n_ops=400, concurrency=5, seed=2, crash_prob=0.02,
                    max_crashes=6)
# The deadline of the real trip: far below one host-row dispatch.
TRIP_DEADLINE_S = 1e-4
# The options of phase 24's checkpointed headlines, host kind and chunk
# kind: the defaults on the card. A CPU rehearsal of the phase sets small
# caps and chunks here (the verify skill's notes).
HOST_RESUME_KW: dict = {}
CHUNK_RESUME_KW: dict = {}


@contextlib.contextmanager
def supervised_clean(tag: str):
    """A phase that must see no watchdog trip, fault or quarantine skip;
    logs its supervised dispatches and their hand-off seconds."""
    from jepsen_tpu_torch.lin import supervise

    supervise.reset_totals()
    t0 = time.perf_counter()
    yield
    tot = supervise.totals()
    wall = time.perf_counter() - t0
    log(f"[supervise-clean] {tag}: {tot['calls']} supervised dispatches, "
        f"hand-off {tot['handoff_s']:.4f}s of {wall:.1f}s "
        f"({tot['handoff_s'] / max(wall, 1e-9):.4%}); trips "
        f"{tot['watchdog_trips']} faults {tot['faults']} quarantine skips "
        f"{tot['quarantine_skips']}; sites "
        + ", ".join(f"{k} {v['calls']} ({v['s']:.2f}s, max {v['max_s']:.4f}s)"
                    for k, v in sorted(supervise.site_times().items())))
    if tot["watchdog_trips"] or tot["faults"] or tot["quarantine_skips"]:
        raise AssertionError(f"{tag}: supervision tripped outside phase 24: "
                             f"{tot}")


@contextlib.contextmanager
def env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def fresh_ledger(tmp: Path, name: str) -> str:
    path = str(tmp / f"{name}.json")
    os.environ["JEPSEN_TPU_QUARANTINE"] = path
    return path


def timed_check(p, dev, **kw):
    import torch

    from jepsen_tpu_torch.lin import bfs, supervise

    supervise.reset_totals()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = bfs.check_packed(p, device=dev, **kw)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, supervise.totals()


def resume_checkpoint(p, tmp: Path, tag: str, kind: str):
    """A Checkpointer writing at every committed row into ``tmp``, whose
    hook copies aside its first ``kind`` checkpoint (a chunk-kind one
    only past half the rows). Returns (the Checkpointer, {"path": the
    copy, "row": [its row]})."""
    import shutil

    from jepsen_tpu_torch.lin import supervise

    path = str(tmp / f"{tag}.ckpt.npz")
    aside = {"path": str(tmp / f"{tag}.aside.npz"), "row": []}
    ckpt = supervise.Checkpointer(path, supervise.history_fingerprint(p),
                                  every_s=0)

    def on_save(k, row):
        if k == kind and not aside["row"] and \
                (kind == "host" or row >= p.R // 2):
            shutil.copy(path, aside["path"])
            aside["row"].append(row)

    ckpt.on_save = on_save
    return ckpt, aside


def resume_phase(dev, tmp: Path, tag: str, kind: str, hist: dict,
                 kw: dict) -> dict:
    """A crash-dom headline checked once with a checkpoint written at
    every committed row, then resumed from a copy of its first ``kind``
    checkpoint: the same verdict, max cap and final frontier, and
    ``resumed-from-row`` the saved row. The checkpoint's overhead is the
    time the checked run spent writing (``Checkpointer.seconds``)."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import prepare, synth

    p = prepare.prepare(m.cas_register(),
                        synth.generate_partitioned_register_history(**hist))
    ckpt, aside = resume_checkpoint(p, tmp, tag, kind)
    first, t_first, tot = timed_check(p, dev, checkpoint=ckpt, **kw)
    if not aside["row"] or os.path.exists(ckpt.path):
        raise AssertionError(f"[{tag}] no {kind} checkpoint was copied, or "
                             f"the definite verdict kept its own "
                             f"({ckpt.writes} writes)")
    r, t, rtot = timed_check(p, dev, resume=aside["path"], **kw)
    keys = ("valid?", "max-cap", "final-frontier-size")
    if {k: r.get(k) for k in keys} != {k: first.get(k) for k in keys} or \
            r.get("resumed-from-row") != aside["row"][0]:
        raise AssertionError(f"[{tag}] the resume differs: {r} against "
                             f"{first}")
    hs = first.get("host-stats") or {}
    log(f"[{tag}] R={p.R} window={p.window}: the checkpointed run "
        f"{t_first:.3f}s, {ckpt.writes} writes in {ckpt.seconds:.4f}s "
        f"({ckpt.seconds / t_first:.4%} of the run, "
        f"{ckpt.seconds / max(ckpt.writes, 1) * 1e3:.2f} ms a write), "
        f"{tot['calls']} supervised dispatches, hand-off "
        f"{tot['handoff_s']:.4f}s, "
        f"{ {k: first.get(k) for k in keys} }, host rows {hs.get('rows')}; "
        f"resumed from the {kind} checkpoint at row {aside['row'][0]} in "
        f"{t:.3f}s ({rtot['calls']} dispatches)")
    return {"t_ckpt_run_s": t_first, "writes": ckpt.writes,
            "ckpt_write_s": ckpt.seconds, "calls": tot["calls"],
            "handoff_s": tot["handoff_s"], "row": aside["row"][0],
            "resume_s": t, "host_stats": hs}


def deadline_trip_phase(dev, tmp: Path, model) -> dict:
    """The corrupted window-34 history killed at its first host-kind
    checkpoint and resumed with every dispatch's deadline far below its
    time: each real attempt of both host-row rungs overruns and is
    abandoned, retried, and abandoned again (a per-pass dispatch that
    beats the deadline carries its row on). On the card the search then
    ends in an honest wedge that keeps its newest checkpoint (on the CPU
    the CPU oracle takes the rows); a re-run with the default deadline
    resumes from it to the uninterrupted run's dead row and op."""
    import threading

    from jepsen_tpu_torch.lin import bfs, prepare, supervise, synth

    fresh_ledger(tmp, "trip")
    h = synth.corrupt_history(synth.generate_partitioned_register_history(
        **HOSTROW), seed=HOSTROW_CORRUPT_SEED)
    p = prepare.prepare(model, h)
    kw = dict(HOSTROW_CAPS, explain=True, device=dev)
    full = bfs.check_packed(p, **kw)
    path = str(tmp / "trip.ckpt.npz")
    ckpt = supervise.Checkpointer(path, supervise.history_fingerprint(p),
                                  every_s=0)
    cancel = threading.Event()
    saved = []

    def on_save(kind, row):
        if kind == "host" and not saved:
            saved.append(row)
            cancel.set()

    ckpt.on_save = on_save
    bfs.check_packed(p, cancel=cancel, checkpoint=ckpt, **kw)
    supervise.reset_totals()
    t0 = time.perf_counter()
    with env(JEPSEN_TPU_DISPATCH_DEADLINE_S=TRIP_DEADLINE_S):
        r = bfs.check_packed(p, checkpoint=path, **kw)
    t = time.perf_counter() - t0
    tot = supervise.totals()
    # The tripped run keeps its newest checkpoint: a host-pass that beat
    # the deadline may have committed rows past the first one.
    kept = supervise.load_checkpoint(path, ckpt.fingerprint)
    # Every abandoned attempt ends at its next pass boundary.
    if not supervise.join_abandoned(60.0):
        raise AssertionError("[supervise-deadline] an abandoned attempt "
                             "did not stop")
    hs = r.get("host-stats") or {}
    on_card = not supervise.host_rungs(dev)
    r2 = bfs.check_packed(p, checkpoint=path, **kw) if on_card else r
    log(f"[supervise-deadline] window={p.window}: killed at row "
        f"{saved[0]}; resumed with a {TRIP_DEADLINE_S}s deadline in "
        f"{t:.3f}s: valid?={r['valid?']} overflow={r.get('overflow')} "
        f"trips={tot['watchdog_trips']} host-stats={hs} ledger="
        f"{sorted(supervise.load_ledger())}; re-run: valid?="
        f"{r2['valid?']} dead-row={r2.get('dead-row')} (uninterrupted "
        f"{full.get('dead-row')}), resumed-from-row "
        f"{r2.get('resumed-from-row')}")
    if r.get("resumed-from-row") != saved[0] or tot["watchdog_trips"] < 4 \
            or {e["site"] for e in hs.get("supervise_events", [])} != \
            {"host-fixpoint", "host-pass"}:
        raise AssertionError(f"[supervise-deadline] no real trip at both "
                             f"host-row rungs: {r} {tot}")
    if on_card and ((r["valid?"], r.get("overflow"), hs.get("cpu_rows", 0))
                    != ("unknown", "wedge", 0) or kept is None):
        raise AssertionError(f"[supervise-deadline] not an honest wedge "
                             f"that keeps its checkpoint: {r}")
    if (r2["valid?"], r2.get("dead-row"), r2.get("op")) != \
            (False, full.get("dead-row"), full.get("op")) or \
            r2.get("resumed-from-row") != (kept or {"row": saved[0]})["row"] \
            or os.path.exists(path):
        raise AssertionError(f"[supervise-deadline] {r2} vs {full}")
    return {"trips": tot["watchdog_trips"], "tripped_s": t,
            "row": saved[0], "dead_row": r2.get("dead-row")}


# A child process that makes every launch of the sparse engine's kernels
# read from address 16: the first chunk's fetch meets a real, sticky CUDA
# fault (an illegal address). It prints what the check did.
FAULT_CHILD = r"""
import json, sys
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch.lin import bfs, prepare, psort_cuda, psort_fused_cuda
from jepsen_tpu_torch.lin import supervise, synth

class BadInput:
    def __init__(self, lib):
        self._lib = lib
    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.endswith("_launch"):
            return fn
        return lambda first, *rest: fn(16, *rest)

p = prepare.prepare(m.cas_register(),
                    synth.generate_register_history(**json.loads(sys.argv[1])))
for mod in (psort_cuda, psort_fused_cuda):
    mod._lib = BadInput(mod._load())
try:
    r = bfs.check_packed(p, device="cuda")
    out = {"raised": None, "valid?": r.get("valid?"),
           "overflow": r.get("overflow")}
except Exception as e:
    out = {"raised": type(e).__name__, "error": str(e)[:300]}
out["ledger"] = supervise.load_ledger()
print(json.dumps(out), flush=True)
"""
FAULT_HIST = dict(n_ops=400, concurrency=24, seed=3)


def real_fault_phase(tmp: Path) -> dict:
    """A real CUDA fault, in a child process (it poisons the process's
    context): the check raises the CUDA error, after recording the
    faulted chunk's shape in the ledger."""
    import subprocess

    root = Path(__file__).resolve().parent
    ledger = str(tmp / "fault.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", FAULT_CHILD, json.dumps(FAULT_HIST)],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root),
                 JEPSEN_TPU_QUARANTINE=ledger))
    t = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1]) if lines else {}
    log(f"[supervise-fault] child exit {proc.returncode} in {t:.1f}s: "
        f"{got}" + (f" | stderr {proc.stderr[-600:]}" if not got else ""))
    led = got.get("ledger") or {}
    # The fault shows at the fetch (torch's "illegal memory access") or at
    # the next launch (its error code, 700).
    err = got.get("error", "")
    if not got.get("raised") or \
            ("illegal memory access" not in err and "error 700" not in err) \
            or not any(k.startswith("chunk|") and e.get("faulted")
                       for k, e in led.items()):
        raise AssertionError(f"[supervise-fault] a real fault did not "
                             f"raise after its shape was recorded: {got}")
    return {"raised": got["raised"], "error": got["error"],
            "ledger": sorted(led), "child_s": t}


def injected_phase(dev, tmp: Path) -> dict:
    """Injected wedges and faults at every site, on the card and on the
    CPU under the card's routing (no rung moves work to the host): each
    routes the same way (verdict, honest unknown or raise, trips, ledger
    keys)."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch import txn
    from jepsen_tpu_torch.lin import bfs, pack_dev, prepare, supervise, synth
    from jepsen_tpu_torch.txn import synth as tsynth

    band = prepare.prepare(m.cas_register(),
                           synth.generate_register_history(**INJECT_BAND))
    spike = prepare.prepare(m.cas_register(),
                            synth.generate_register_history(**INJECT_SPIKE))
    th = tsynth.seeded_anomaly_history("G-single")
    mutex = pack_dev.prepack(m.mutex(),
                             synth.generate_mutex_history(**INJECT_MUTEX))

    def sparse(p, caps):
        return lambda d: bfs.check_packed(p, device=d, explain=True, **caps)

    def run_txn(d):
        return txn.check(th, algorithm="gpu", device=d)

    def run_pack(d):
        pack_dev.reset_dev_stats()
        try:
            packed = pack_dev.materialize(mutex, device=d)
        except (RuntimeError, supervise.WedgedDispatch) as e:
            return {"raised": type(e).__name__,
                    "dev_stats": pack_dev.dev_stats()}
        return {"tables": [getattr(packed, f).tobytes() for f in
                           ("ret_slot", "active", "slot_f", "slot_v",
                            "slot_op", "crashed")],
                "dev_stats": pack_dev.dev_stats()}

    cases = [("chunk", "fault", sparse(band, INJECT_BAND_CAPS)),
             ("chunk", "wedge", sparse(band, INJECT_BAND_CAPS)),
             ("spike", "fault", sparse(spike, INJECT_SPIKE_CAPS)),
             ("spike", "wedge", sparse(spike, INJECT_SPIKE_CAPS)),
             ("host-fixpoint", "wedge", sparse(band, INJECT_BAND_CAPS)),
             ("host-fixpoint", "fault", sparse(band, INJECT_BAND_CAPS)),
             ("host-pass", "wedge", sparse(band, INJECT_BAND_CAPS)),
             ("host-pass", "fault", sparse(band, INJECT_BAND_CAPS)),
             ("txn-scc", "wedge", run_txn), ("txn-scc", "fault", run_txn),
             ("pack-dev", "wedge", run_pack),
             ("pack-dev", "fault", run_pack)]

    def outcome(r):
        if "dev_stats" in r:
            return {**r, "dev_stats": {k: v for k, v in r["dev_stats"].items()
                                       if not k.endswith("_s")}}
        keep = ("valid?", "dead-row", "op", "final-frontier-size",
                "max-cap", "overflow", "fallbacks", "anomaly-types")
        out = {k: r.get(k) for k in keep}
        st = r.get("host-stats") or r.get("device-stats") or \
            r.get("stats") or {}
        out.update({k: st.get(k, 0) for k in (
            "watchdog_trips", "faults", "quarantine_skips", "cpu_rows")})
        return out

    host_rungs = supervise.host_rungs
    summary = {}
    for i, (site, kind, run) in enumerate(cases):
        got = {}
        for where, d in (("card", dev), ("cpu", "cpu")):
            path = fresh_ledger(tmp, f"inject{i}-{where}")
            supervise.reset_injections()
            if site == "host-pass":
                # The fused rung quarantined at every host cap: the rows
                # run on the per-pass rung, where the injection lands.
                for cap in INJECT_BAND_CAPS["host_caps"]:
                    supervise.record_fault(supervise.shape_key(
                        "host-fixpoint", cap=cap, window=band.window,
                        kernel="cas-register"), "fault")
            if kind == "fault":
                supervise.inject_fault(site, 1)
            else:
                # Every attempt of the first dispatch at the site (the
                # wedge is a fake thunk that never touches the device).
                supervise.inject_wedge(site, 2, deadline_s=0.05)
            supervise.host_rungs = lambda device: False
            try:
                got[where] = (outcome(run(d)),
                              sorted(supervise.load_ledger(path)))
            finally:
                supervise.host_rungs = host_rungs
                supervise.reset_injections()
        card, host = got["card"], got["cpu"]
        log(f"[supervise-inject] {site} {kind}: card "
            f"{ {k: v for k, v in card[0].items() if k != 'tables'} } "
            f"ledger {card[1]}")
        if card != host:
            raise AssertionError(f"[supervise-inject] {site} {kind}: card "
                                 f"{card} != cpu {host}")
        if not any(k.startswith(site + "|") for k in card[1]):
            raise AssertionError(f"[supervise-inject] {site} {kind}: the "
                                 "injection recorded nothing")
        summary[f"{site}/{kind}"] = card[1]
    return summary


def supervise_phases(dev, smi: str) -> dict:
    """Phase 24: the supervised runtime on the card (see the module
    docstring). Returns its measurements."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import supervise

    t_phase = time.perf_counter()
    tmp = SCRATCH / "supervise"
    tmp.mkdir()
    ledger0 = os.environ.get("JEPSEN_TPU_QUARANTINE")
    out = {"card": smi}
    try:
        # Host-kind resume at full width (the pair crash-dom headline) and
        # chunk-kind (the single-key one).
        fresh_ledger(tmp, "resume")
        out["pair_dom"] = resume_phase(dev, tmp, "pair-dom", "host",
                                       DOM_PAIR, HOST_RESUME_KW)
        out["single_dom"] = resume_phase(dev, tmp, "single-dom", "chunk",
                                         DOM_SINGLE, CHUNK_RESUME_KW)
        out["deadline"] = deadline_trip_phase(dev, tmp, m.cas_register())
        out["inject"] = injected_phase(dev, tmp)
        if dev.type == "cuda":
            out["real_fault"] = real_fault_phase(tmp)
    finally:
        supervise.reset_injections()
        os.environ["JEPSEN_TPU_QUARANTINE"] = ledger0
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[supervise] phase 24 in {out['phase_s']:.1f}s | {smi} | "
        + json.dumps(out, default=str))
    return out


# --- the streaming checker (phase 25) -----------------------------------------
# The JAX package's stream smoke's soak shape: a CAS register at concurrency
# 8 with up to 8 crashed ops (40,000 ops there, cut to 16,000 here to hold
# the phase's 120 s: at 40,000 the stream's increments took 67.2 s on the
# H100, at 24,000 51.2 s), and its crash-free corrupted twin at the full
# 40,000 ops, fed 2,000 events an append (about 730 settled rows a settle).

STREAM_CLEAN = dict(n_ops=16_000, concurrency=8, seed=7, crash_prob=0.005,
                    max_crashes=8)
STREAM_BAD = dict(n_ops=40_000, concurrency=8, seed=7)
STREAM_BAD_SEED = 3
STREAM_APPEND = 2_000
# The resume leg's history (the clean shape, cut in length) and the
# foreign events its checkpoint must reject.
STREAM_RESUME = dict(STREAM_CLEAN, n_ops=4_000)
STREAM_FOREIGN = dict(n_ops=1_000, concurrency=8, seed=8)
# Settle sizes of the paint measurement behind pack_dev.STREAM_MIN_ROWS,
# and the settles timed at each.
STREAM_PAINT_ROWS = tuple(1 << k for k in range(6, 14))
STREAM_PAINT_SETTLES = 12
# The live producer offers ops in blocks, each once the checker thread
# has taken the last; the thread takes what is queued, so its session
# waits for 1,024 settled rows an increment (at the default 256 the live
# leg ran about 100 increments, 23.4 s).
STREAM_LIVE_BLOCK = 1_000
STREAM_LIVE_MIN_ROWS = 1_024
# The JAX stream smoke's gate on late over early settle walls.
STREAM_RATIO_MAX = 1.8
STREAM_PHASE_S = 120
# The kernels each band of the stream path routes to.
STREAM_ROUTES = {"compact": ("fixpoint", "compact_keys"),
                 "crash-dom": ("dedup_keys_dom", "compact_keys"),
                 "pair-compact": ("fixpoint_pair", "compact_keys2"),
                 "pair-crash-dom": ("dedup_keys2_dom", "compact_keys2"),
                 "generic": ("dedup_keys", "compact_keys")}


def kernel_counts() -> dict:
    """Every kernel's launch counter (each wrapper adds one where it
    launches its kernel)."""
    from jepsen_tpu_torch.lin import dense_cuda, psort, psort_fused
    from jepsen_tpu_torch.txn import device as txn_device

    return {"dense_chunk": dense_cuda.LAUNCHES,
            "dense_chunk_batch": dense_cuda.BATCH_LAUNCHES,
            **psort.LAUNCHES, **psort_fused.LAUNCHES,
            "txn_scc": txn_device.LAUNCHES}


def reset_kernel_counts() -> None:
    """Every kernel's launch counter set to 0."""
    from jepsen_tpu_torch.lin import dense_cuda
    from jepsen_tpu_torch.txn import device as txn_device

    reset_launches()
    dense_cuda.LAUNCHES = dense_cuda.BATCH_LAUNCHES = 0
    txn_device.LAUNCHES = 0


def add_counts(acc: dict) -> None:
    for k, v in kernel_counts().items():
        acc[k] = acc.get(k, 0) + v


def band_launches(sc, bands: dict) -> list:
    """Files each increment of session ``sc`` under the band the sparse
    engine reports for it (its result's ``band``): every launch count is
    set to 0 just before the increment and read just after, into
    ``bands[band]``. Returns the list of the increments' bands, in
    order."""
    inc, commit = sc._increment, sc.commit_increment
    order: list = []
    last: list = []

    def commit_spy(r, **kw):
        last.append(r.get("band", "-"))
        return commit(r, **kw)

    def increment_spy():
        last.clear()
        reset_kernel_counts()
        inc()
        band = last[0] if last else "-"
        add_counts(bands.setdefault(band, {}))
        order.append(band)

    sc._increment, sc.commit_increment = increment_spy, commit_spy
    return order


def brief(r: dict) -> dict:
    """A result without its configs and final paths, for a message."""
    return {k: v for k, v in r.items() if k not in ("configs",
                                                     "final-paths")}


def stream_chunks(h) -> list:
    return [h[i:i + STREAM_APPEND] for i in range(0, len(h), STREAM_APPEND)]


def one_shot(dev, model, h) -> tuple:
    from jepsen_tpu_torch import checker

    t0 = time.perf_counter()
    r = checker.linearizable(algorithm="gpu", device=dev).check(None, model,
                                                                h)
    return r, time.perf_counter() - t0


def stream_clean(dev, model, h, one, t_one: float, bands: dict) -> dict:
    """[stream-clean]: the soak history through ``StreamChecker``, a line
    an increment; valid with no degrade, the one-shot verdict, every
    routed kernel launched, the settle walls flat."""
    from jepsen_tpu_torch.lin import prepare
    from jepsen_tpu_torch.stream import StreamChecker

    sc = StreamChecker(model, device=dev)
    seen = band_launches(sc, bands)
    st, ps = prepare._pack_stats, sc.packer.paint_stats
    walls = []
    max_lag = 0

    def step(fn, tag):
        nonlocal max_lag
        b = (st["incr_s"], ps["dev_paint_s"], ps["host_paint_s"],
             sc.stats["increment_s"], sc.stats["increments"],
             sc.stats["rows_checked"], len(seen))
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        settle = st["incr_s"] - b[0]
        walls.append(settle)
        incs = sc.stats["increments"] - b[4]
        max_lag = max(max_lag, sc.stats["lag_rows"])
        band = "/".join(dict.fromkeys(seen[b[6]:])) or "-"
        log(f"[stream-clean] {tag}: rows {sc.stats['rows_checked'] - b[5]} "
            f"(settled {sc.packer.R}) settle {settle:.4f}s paint card "
            f"{ps['dev_paint_s'] - b[1]:.4f}s numpy "
            f"{ps['host_paint_s'] - b[2]:.4f}s device check "
            f"{sc.stats['increment_s'] - b[3]:.4f}s increments {incs} band "
            f"{band} frontier {sc.stats.get('frontier')} append {wall:.4f}s")
        return out

    t0 = time.perf_counter()
    for j, c in enumerate(stream_chunks(h)):
        step(lambda c=c: sc.append(c), f"append {j}")
    r = step(sc.finalize, "finalize")
    t_stream = time.perf_counter() - t0
    s = r["stream"]
    q = len(walls) // 4
    early = sum(walls[q:2 * q]) / q
    late = sum(walls[-q - 1:-1]) / q
    ratio = late / early
    log(f"[stream-clean] ops={len(h) // 2} verdict={r['valid?']} analyzer="
        f"{r.get('analyzer')} final-frontier-size="
        f"{r.get('final-frontier-size')} increments={s['increments']} "
        f"rows={s['rows_checked']} max lag {max_lag} rows, final lag "
        f"{s['lag_rows']}; stream {t_stream:.3f}s, increments "
        f"{s['increment_s']:.3f}s, settles {sum(walls):.3f}s, paints card "
        f"{ps['dev_paint_s']:.3f}s ({ps['dev_paints']}) numpy "
        f"{ps['host_paint_s']:.3f}s ({ps['host_paints']}); one-shot "
        f"checker.linearizable(algorithm='gpu') {t_one:.3f}s "
        f"({one.get('analyzer')}); late/early settle {late * 1e3:.3f} / "
        f"{early * 1e3:.3f} ms = {ratio:.3f} (gate {STREAM_RATIO_MAX})")
    if r["valid?"] is not True or one["valid?"] is not True \
            or s.get("degraded") or s["rows_checked"] != s["rows_settled"]:
        raise AssertionError(f"[stream-clean] {brief(r)} (one-shot "
                             f"{brief(one)})")
    if ratio >= STREAM_RATIO_MAX:
        raise AssertionError(f"[stream-clean] late/early settle {ratio:.3f}")
    return {"increments": s["increments"], "increment_s": s["increment_s"],
            "stream_s": t_stream, "one_shot_s": t_one, "ratio": ratio,
            "paint": dict(ps), "max_lag": max_lag}


def stream_abort(dev, model, bad, good, one_bad, bands: dict) -> dict:
    """[stream-abort]: the corrupted twin aborts within one increment of
    the offending completion, at the one-shot dead row and op."""
    from jepsen_tpu_torch.stream import StreamChecker

    bad_at = next(i for i, (a, b) in enumerate(zip(good, bad))
                  if a.value != b.value or a.type != b.type)
    latched = []
    sc = StreamChecker(model, device=dev,
                       on_abort=lambda v: latched.append(time.perf_counter()))
    band_launches(sc, bands)
    fed, t_hold = None, None
    for j, c in enumerate(stream_chunks(bad)):
        i = j * STREAM_APPEND
        if i <= bad_at < i + STREAM_APPEND:
            t_hold = time.perf_counter()
        sc.append(c)
        if sc.aborted:
            fed = i + len(c)
            break
    r = sc.finalize()
    lat = latched[0] - t_hold if latched and t_hold else None
    log(f"[stream-abort] offending completion at event {bad_at}; latched "
        f"after {fed} events fed, {len(bad) - (fed or 0)} unfed, "
        f"{lat if lat is None else round(lat, 4)}s from the append holding "
        f"it; dead-row {r.get('dead-row')} op {r.get('op')} (one-shot "
        f"{one_bad.get('dead-row')} {one_bad.get('op')}, "
        f"{one_bad.get('analyzer')}); increments {r['stream']['increments']}")
    if fed is None or fed - bad_at > 2 * STREAM_APPEND or fed >= len(bad) \
            or r["valid?"] is not False or one_bad["valid?"] is not False \
            or (r.get("dead-row"), r.get("op")) != \
            (one_bad.get("dead-row"), one_bad.get("op")):
        raise AssertionError(f"[stream-abort] fed {fed} bad_at {bad_at}: "
                             f"{brief(r)} (one-shot {brief(one_bad)})")
    return {"bad_at": bad_at, "fed": fed, "unfed": len(bad) - fed,
            "latency_s": lat, "dead_row": r.get("dead-row")}


def stream_paint(dev, model, h, smi: str) -> dict:
    """[stream-paint]: every settle painted on the card against numpy's,
    both the one-shot pack bit for bit; then the card's paint time
    against numpy's at each settle size of STREAM_PAINT_ROWS."""
    import statistics

    from jepsen_tpu_torch.lin import pack_dev, prepare
    from jepsen_tpu_torch.stream import IncrementalPacker

    def packer(min_rows, step, n_events=None):
        pk = IncrementalPacker(model, device=dev, paint_min_rows=min_rows)
        per = []
        ev = h if n_events is None else h[:n_events]
        for i in range(0, len(ev), step):
            pk.feed_many(ev[i:i + step])
            b = dict(pk.paint_stats)
            n = pk.settle()
            if n:
                where = "dev" if pk.paint_stats["dev_paints"] > \
                    b["dev_paints"] else "host"
                per.append((n, pk.paint_stats[f"{where}_paint_s"]
                            - b[f"{where}_paint_s"]))
        if n_events is None:
            pk.settle(final=True)
        return pk, per

    pack_dev.reset_dev_stats()
    card, _ = packer(0, STREAM_APPEND)
    host, _ = packer(1 << 30, STREAM_APPEND)
    if card.paint_stats["host_paints"] or host.paint_stats["dev_paints"] \
            or pack_dev.dev_stats()["dev_packs"] != \
            card.paint_stats["dev_paints"]:
        raise AssertionError(f"[stream-paint] routes: {card.paint_stats} "
                             f"{host.paint_stats} {pack_dev.dev_stats()}")
    one = prepare.prepare(model, h)
    same_pack(card.packed(), host.packed(), "[stream-paint] card/numpy")
    same_pack(card.packed(), one, "[stream-paint] card/one-shot")
    if card.prefix_fingerprint(card.R) != host.prefix_fingerprint(host.R):
        raise AssertionError("[stream-paint] fingerprints differ")
    log(f"[stream-paint] {card.paint_stats['dev_paints']} settles painted "
        f"on the card and {host.paint_stats['host_paints']} with numpy: "
        f"every table, pure, pred and packed() bit-identical to each other "
        f"and to prepare.prepare (R={one.R}, window={one.window})")
    sizes = {}
    for rows in STREAM_PAINT_ROWS:
        n_ev = min(len(h), 2 * rows * STREAM_PAINT_SETTLES)
        ms = {}
        for where, min_rows in (("card", 0), ("numpy", 1 << 30)):
            _, per = packer(min_rows, 2 * rows, n_ev)
            ms[where] = [t * 1e3 for _, t in per[1:]]
            got = [n for n, _ in per[1:]]
        med = {k: statistics.median(v) for k, v in ms.items()}
        sizes[rows] = {**med, "settled_rows": statistics.median(got),
                       "settles": len(got)}
        log(f"[stream-paint] appends of {2 * rows} events, settles of "
            f"{statistics.median(got):.0f} rows (median of {len(got)}): "
            f"card {med['card']:.4f} ms, numpy {med['numpy']:.4f} ms, "
            f"card/numpy {med['card'] / med['numpy']:.3f} | {smi}")
    wins = [m["settled_rows"] for m in sizes.values()
            if m["card"] <= m["numpy"]]
    log(f"[stream-paint] the card's paint at or below numpy's at settles "
        f"of {wins or 'no measured size'} rows; pack_dev.STREAM_MIN_ROWS = "
        f"{pack_dev.STREAM_MIN_ROWS}")
    return {"sizes": sizes, "card_wins": wins}


def stream_resume(dev, model, tmp: Path, h, one, hf, one_f) -> dict:
    """[stream-resume]: a checkpointed session over ``h`` dropped after
    half its appends; a fresh one re-fed the same events resumes at that
    row with the one-shot verdict ``one``; the foreign events ``hf``
    reject the checkpoint and are checked from row 0 (verdict
    ``one_f``)."""
    import shutil

    from jepsen_tpu_torch.stream import StreamChecker

    chunks = stream_chunks(h)
    ck = str(tmp / "stream.npz")
    sc1 = StreamChecker(model, device=dev, checkpoint=ck)
    for c in chunks[:len(chunks) // 2]:
        sc1.append(c)
    row = sc1._row
    if not row or not os.path.exists(ck):
        raise AssertionError(f"[stream-resume] no checkpoint at row {row}")
    shutil.copy(ck, tmp / "stream-kept.npz")
    del sc1
    t0 = time.perf_counter()
    sc2 = StreamChecker(model, device=dev, checkpoint=ck)
    for c in chunks:
        sc2.append(c)
    r = sc2.finalize()
    t_resume = time.perf_counter() - t0
    sc3 = StreamChecker(model, device=dev,
                        checkpoint=str(tmp / "stream-kept.npz"))
    for c in stream_chunks(hf):
        sc3.append(c)
    rf = sc3.finalize()
    log(f"[stream-resume] killed at row {row} of {len(h) // 2} ops; the "
        f"re-fed session resumed_from_row="
        f"{r['stream'].get('resumed_from_row')} verdict {r['valid?']} "
        f"(one-shot {one['valid?']}) increments {r['stream']['increments']} "
        f"in {t_resume:.3f}s; foreign events: resumed_from_row="
        f"{rf['stream'].get('resumed_from_row')} rows checked "
        f"{rf['stream']['rows_checked']} of {rf['stream']['rows_settled']} "
        f"verdict {rf['valid?']} (one-shot {one_f['valid?']})")
    if r["stream"].get("resumed_from_row") != row \
            or r["valid?"] != one["valid?"] \
            or "resumed_from_row" in rf["stream"] \
            or rf["stream"]["rows_checked"] != rf["stream"]["rows_settled"] \
            or rf["valid?"] != one_f["valid?"]:
        raise AssertionError(f"[stream-resume] {r['stream']} {rf['stream']}")
    return {"row": row, "resume_s": t_resume}


def stream_live(dev, model, bad, one_bad) -> dict:
    """[stream-live]: a LiveChecker fed op by op from a producer thread on
    the corrupted twin latches ``should_abort()``; ``finish()`` returns
    the abort verdict."""
    import threading

    from jepsen_tpu_torch.stream import LiveChecker

    lc = LiveChecker(model, device=dev, min_rows=STREAM_LIVE_MIN_ROWS)
    offered = [0]

    def producer():
        for op in bad:
            if lc.should_abort():
                return
            lc.offer(op)
            offered[0] += 1
            if offered[0] % STREAM_LIVE_BLOCK == 0:
                while lc._q and not lc.should_abort():
                    time.sleep(0.0005)

    t0 = time.perf_counter()
    th = threading.Thread(target=producer, name="stream-live-producer")
    th.start()
    th.join()
    latched = lc.should_abort()
    r = lc.finish()
    took = time.perf_counter() - t0
    log(f"[stream-live] producer offered {offered[0]} of {len(bad)} ops; "
        f"should_abort {latched}; finish(): {r['valid?']} dead-row "
        f"{r.get('dead-row')} op {r.get('op')} in {took:.3f}s")
    if not latched or offered[0] >= len(bad) or r["valid?"] is not False \
            or (r.get("dead-row"), r.get("op")) != \
            (one_bad.get("dead-row"), one_bad.get("op")):
        raise AssertionError(f"[stream-live] {brief(r)}")
    return {"offered": offered[0], "s": took}


def stream_wedge(dev, model, bad, one_bad) -> dict:
    """[stream-wedge]: a wedge injected at ``stream-incr`` degrades the
    session to one post-hoc check on the card, the device search alone:
    the one-shot verdict, op and analyzer, and ``stream-fallback`` set."""
    from jepsen_tpu_torch.lin import supervise
    from jepsen_tpu_torch.stream import StreamChecker

    supervise.reset_injections()
    supervise.inject_wedge("stream-incr", 2, deadline_s=0.05)
    try:
        t0 = time.perf_counter()
        sc = StreamChecker(model, device=dev)
        for c in stream_chunks(bad):
            sc.append(c)
        r = sc.finalize()
        took = time.perf_counter() - t0
    finally:
        supervise.reset_injections()
    log(f"[stream-wedge] degraded: {r['stream'].get('degraded')!r}; "
        f"stream-fallback set: {bool(r.get('stream-fallback'))}; verdict "
        f"{r['valid?']} op {r.get('op')} (one-shot {one_bad.get('op')}); "
        f"decided by analyzer {r.get('analyzer')}; trips "
        f"{r['stream'].get('watchdog_trips')}; {took:.3f}s")
    if not str(r["stream"].get("degraded", "")).startswith(
            "increment wedge") or not r.get("stream-fallback") \
            or r["valid?"] is not False or r.get("op") != one_bad.get("op") \
            or not str(r.get("analyzer")).startswith("gpu-") \
            or r.get("analyzer") != one_bad.get("analyzer"):
        raise AssertionError(f"[stream-wedge] {brief(r)}")
    return {"analyzer": r.get("analyzer"), "s": took}


def stream_phases(dev, smi: str) -> dict:
    """Phase 25: the streaming checker on the card (see the module
    docstring). Returns its measurements, the launches of every kernel
    over its streams among them."""
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import synth

    t_phase = time.perf_counter()
    tmp = SCRATCH / "stream"
    tmp.mkdir()
    model = m.cas_register()
    out = {"card": smi}
    bands: dict = {}
    with supervised_clean("phase 25"):
        h = synth.generate_register_history(**STREAM_CLEAN)
        good = synth.generate_register_history(**STREAM_BAD)
        bad = synth.corrupt_history(good, seed=STREAM_BAD_SEED)
        hr = synth.generate_register_history(**STREAM_RESUME)
        hf = synth.generate_register_history(**STREAM_FOREIGN)
        # The one-shot checks' launches are not the streams'.
        one, t_one = one_shot(dev, model, h)
        one_bad, _ = one_shot(dev, model, bad)
        one_r, _ = one_shot(dev, model, hr)
        one_f, _ = one_shot(dev, model, hf)
        out["clean"] = stream_clean(dev, model, h, one, t_one, bands)
        out["abort"] = stream_abort(dev, model, bad, good, one_bad, bands)
        out["paint"] = stream_paint(dev, model, h, smi)
        reset_kernel_counts()
        out["resume"] = stream_resume(dev, model, tmp, hr, one_r, hf,
                                      one_f)
        out["live"] = stream_live(dev, model, bad, one_bad)
        out["later_launches"] = kernel_counts()
    out["wedge"] = stream_wedge(dev, model, bad, one_bad)
    total = {}
    for d in (*bands.values(), out["later_launches"]):
        for k, v in d.items():
            total[k] = total.get(k, 0) + v
    bands.pop("-", None)
    for band, d in sorted(bands.items()):
        idle = [k for k in STREAM_ROUTES.get(band, ()) if not d.get(k)]
        log(f"[stream-launches] band {band}: "
            + ", ".join(f"{k} {v}" for k, v in sorted(d.items())))
        if idle:
            raise AssertionError(f"[stream-launches] band {band} never "
                                 f"launched {idle}")
    log("[stream-launches] every stream of phase 25 (clean, abort, resume, "
        "live): " + ", ".join(f"{k} {v}" for k, v in sorted(total.items())))
    missing = [k for k in ("compact_keys", "fixpoint", "dedup_keys_dom")
               if not total.get(k)]
    if missing:
        raise AssertionError(f"[stream-launches] never launched {missing}")
    out["bands"] = bands
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[stream] phase 25 in {out['phase_s']:.1f}s | {smi}")
    if out["phase_s"] > STREAM_PHASE_S:
        raise AssertionError(f"[stream] phase 25 took {out['phase_s']:.1f}s "
                             f"(> {STREAM_PHASE_S} s)")
    return out


def main(device: str = "cuda", bands_only: bool = False,
         pack_only: bool = False, txn_only: bool = False,
         supervise_only: bool = False, stream_only: bool = False) -> int:
    """Run every phase on ``device`` ("cpu" only rehearses the control
    flow with the plain versions in place of the kernels), or with
    ``bands_only`` the build and phase 21 alone, with ``pack_only`` the
    build and phase 22 alone, with ``txn_only`` the build and phase 23
    alone, with ``supervise_only`` the build and phase 24 alone, or with
    ``stream_only`` the build and phase 25 alone."""
    import tempfile

    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # The run's quarantine ledger is a fresh file of its own: a shape an
    # earlier run recorded must not route this run past a kernel.
    global SCRATCH
    ledger_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    SCRATCH = Path(ledger_dir)
    os.environ["JEPSEN_TPU_QUARANTINE"] = os.path.join(ledger_dir,
                                                       "quarantine.json")
    try:
        return _main(device, bands_only, pack_only, txn_only,
                     supervise_only, stream_only)
    finally:
        import shutil

        shutil.rmtree(ledger_dir, ignore_errors=True)


def _main(device: str, bands_only: bool, pack_only: bool, txn_only: bool,
          supervise_only: bool, stream_only: bool) -> int:
    import numpy as np
    import torch

    from jepsen_tpu_torch import _build, _u32, checker
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import dense, dense_cuda, prepare, synth

    global SM_HZ, PEAK_OPS_PER_S
    dev = torch.device(device)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    SM_HZ = max_sm_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    PEAK_OPS_PER_S = INT32_LANES_PER_SM * sms * SM_HZ
    log(f"[card] {smi} | {sms} SMs, max SM clock {SM_HZ / 1e6:.0f} MHz, "
        f"peak int32 {PEAK_OPS_PER_S:.4g} op/s | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    # 1. build, every kernel at once
    t0 = time.perf_counter()
    _build.build(["dense_chunk", "psort", "psort_fused", "txn_scc"])
    smem_w = dense_cuda.shared_max_w()
    log(f"[build] dense_chunk, psort, psort_fused, txn_scc built and "
        f"loaded in {time.perf_counter() - t0:.2f}s (dense: bit-sliced "
        f"kernel up to w={smem_w}, device-memory kernel above)")
    if smem_w != dense_cuda.SHARED_MAX_W:
        raise AssertionError(f"the library's sliced limit w={smem_w} is "
                             "not dense_cuda.SHARED_MAX_W")
    if bands_only:
        print(json.dumps({"bands": bands_phases(dev)}), flush=True)
        print(smi, flush=True)
        return 0
    if pack_only:
        pack_phases(dev, smi)
        print(smi, flush=True)
        return 0
    if txn_only:
        print(json.dumps({"kernels": [txn_phases(dev, smi)]}), flush=True)
        print(smi, flush=True)
        return 0
    if supervise_only:
        print(json.dumps({"supervise": supervise_phases(dev, smi)}),
              flush=True)
        print(smi, flush=True)
        return 0
    if stream_only:
        print(json.dumps({"stream": stream_phases(dev, smi)}, default=str),
              flush=True)
        print(smi, flush=True)
        return 0
    for name in ("dense_chunk", "psort", "psort_fused", "txn_scc"):
        for line in _build.BUILD_LOG.get(name, {}).get(
                "ptxas", "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line \
                    or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")
    # 2. kernel vs plain on the card
    rng = np.random.default_rng(1234)
    max_err = 0
    widths = []
    cases = [(w, ns, None, None) for w in CASE_WIDTHS for ns in CASE_STATES]
    cases += [(14, 8, 100, None), (16, 8, 100, None)]
    cases += [(w, ns, None, mode) for w, ns, mode in CASE_MODES]
    for w, ns, die_at, mode in cases:
        Fh, mh, rh = random_case(rng, w, ns, CASE_ROWS, die_at, mode)
        F = _u32.bitmap_from_numpy(Fh, dev)
        masks = _u32.bitmap_from_numpy(mh, dev)
        ret = torch.from_numpy(rh).to(dev)
        k = dense_cuda.dense_chunk(F, CASE_ROWS, masks, ret, w=w, ns=ns)
        pl = dense_cuda.dense_chunk_plain(F, CASE_ROWS, masks, ret, w=w,
                                          ns=ns)
        torch.cuda.synchronize()
        same, err = same_result(k, pl)
        max_err = max(max_err, err)
        rows_done, dead, trunc, passes, sweeps = k.state.tolist()
        log(f"[kernel-vs-plain] w={w:2d} ns={ns:2d} "
            f"{dense_cuda.kernel_path(w):6s} {mode or 'random':10s} "
            f"rows_done={rows_done} dead={dead} trunc={trunc} "
            f"passes={passes} sweeps={sweeps} bit_exact={same}")
        if not same:
            raise AssertionError(
                f"kernel != plain at w={w} ns={ns}: kernel state "
                f"{k.state.tolist()} plain {pl.state.tolist()}, max "
                f"word error {err}")
        if die_at is not None and (dead, rows_done) != (1, die_at + 1):
            raise AssertionError(f"the dying case at w={w} died at "
                                 f"rows_done={rows_done} dead={dead}")
        if w not in widths:
            widths.append(w)

    # 3. the headline through the user's entry point
    dense_clean = supervised_clean("phases 3-6")
    dense_clean.__enter__()
    t0 = time.perf_counter()
    h = synth.generate_register_history(**HEADLINE)
    t_synth = time.perf_counter() - t0
    model = m.cas_register()
    ck = checker.linearizable(algorithm="gpu", device=dev)
    dense_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    r = ck.check(None, model, h)
    t_e2e = time.perf_counter() - t0
    launches = dense_cuda.LAUNCHES
    if r["valid?"] is not True:
        raise AssertionError(f"headline verdict {r['valid?']!r}: {r}")
    if launches <= 0:
        raise AssertionError("the headline never launched the kernel")
    t0 = time.perf_counter()
    p = prepare.prepare(model, h)
    t_prep = time.perf_counter() - t0
    walk = prepare.pack_stats()["mode"]
    w, ns, nil_id, _ = dense.plan(p)
    runs = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rr = dense.check_packed(p, device=dev)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if rr["valid?"] is not True:
            raise AssertionError(f"headline re-check said {rr['valid?']!r}")
    best = min(runs[1:])
    log(f"[headline] ops={HEADLINE['n_ops']} window={p.window} R={p.R} "
        f"plan(w={w}, ns={ns}) crashed={len(p.crashed_ops)} "
        f"verdict={r['valid?']} analyzer={r.get('analyzer')} "
        f"backend={r.get('backend')}")
    log(f"[headline] synth={t_synth:.3f}s prepare={t_prep:.3f}s "
        f"walk={walk} "
        f"checker.linearizable e2e={t_e2e:.3f}s "
        f"({HEADLINE['n_ops'] / t_e2e:.0f} ops/s)")
    log(f"[headline] device check warm={runs[0]:.4f}s "
        f"runs={[round(x, 4) for x in runs[1:]]} best={best:.4f}s "
        f"({HEADLINE['n_ops'] / best:.0f} ops/s device check, "
        f"{HEADLINE['n_ops'] / (t_prep + best):.0f} ops/s prepare+check)")

    # Per-launch kernel time and bound over the headline's own chunks.
    snaps = []
    dense.check_packed(p, device=dev, snapshots=snaps)
    chunk_ms, chunk_bound = [], []
    for i, (base, F) in enumerate(snaps):
        n = min(dense.CHUNK, p.R - base)
        wc = int(F.numel()).bit_length() - 1
        masks, ret = dense.chunk_inputs(p, base, n, wc, ns, nil_id, dev)
        res = dense_cuda.dense_chunk(F, n, masks, ret, w=wc, ns=ns)
        b_ms, b_by = bound_ms(wc, ns, n, int(res.sweeps))
        chunk_bound.append(b_ms)
        chunk_ms.append(time_chunk(
            lambda: dense_cuda.dense_chunk(F, n, masks, ret, w=wc, ns=ns),
            reps=2))
        log(f"[headline] chunk {i}: rows {base}..{base + n - 1} w={wc} "
            f"({dense_cuda.kernel_path(wc)}) entry bitmap "
            f"{int((F != 0).sum())} of {F.numel()} words nonzero, "
            f"{_u32.popcount(F)} configs; "
            f"passes={int(res.passes)} sweeps={int(res.sweeps)} kernel "
            f"{chunk_ms[-1]:.3f} ms ({chunk_ms[-1] / n * 1e3:.2f} us/row), "
            f"bound {b_ms:.4f} ms ({b_by})")
    launch_ms = sum(chunk_ms) / len(chunk_ms)
    log(f"[headline] launches={launches} mean ms/launch="
        f"{launch_ms:.3f} (CUDA events); kernels "
        f"{sum(chunk_ms):.1f} ms = {sum(chunk_ms) / (best * 1e3):.1%} of "
        f"the best device check; bound {sum(chunk_bound):.4f} ms")

    # 4. the device-memory placement end to end
    hw = synth.generate_register_history(**WIDE)
    pw = prepare.prepare(model, hw)
    t0c = time.perf_counter()
    rw = checker.linearizable(algorithm="gpu", device=dev).check(None, model, hw)
    t_w = time.perf_counter() - t0c
    pw_plan = dense.plan(pw)
    log(f"[wide] ops={WIDE['n_ops']} window={pw.window} R={pw.R} "
        f"plan={pw_plan} verdict={rw['valid?']} check={t_w:.3f}s")
    if rw["valid?"] is not True:
        raise AssertionError(f"window-16 verdict {rw['valid?']!r}: {rw}")
    if pw_plan[0] <= smem_w:
        raise AssertionError(f"the wide history planned w={pw_plan[0]}, "
                             "inside the shared-memory placement")

    # 5. a counterexample, GPU against the CPU oracle
    hc = synth.corrupt_history(synth.generate_register_history(**CORRUPT),
                               seed=3)
    rg = checker.linearizable(algorithm="gpu", device=dev).check(None, model, hc)
    rc = checker.linearizable(algorithm="cpu").check(None, model, hc)
    log(f"[counterexample] gpu={rg['valid?']} cpu={rc['valid?']} "
        f"dead-row={rg.get('dead-row')} op={rg.get('op')} "
        f"final-paths={len(rg.get('final-paths', []))}")
    if rg["valid?"] is not False or rc["valid?"] is not False:
        raise AssertionError(f"corrupted history: gpu {rg['valid?']!r} "
                             f"cpu {rc['valid?']!r}")
    if rg.get("op") != rc.get("op"):
        raise AssertionError(f"ops differ: gpu {rg.get('op')} cpu "
                             f"{rc.get('op')}")
    if not rg.get("final-paths"):
        raise AssertionError("the GPU counterexample has no final paths")

    # 6. plain version vs kernel at the headline's shapes
    base, F = next((b, f) for b, f in reversed(snaps)
                   if f.numel() == 1 << w)
    masks, ret = dense.chunk_inputs(p, base, PLAIN_ROWS, w, ns, nil_id,
                                    dev)
    k = dense_cuda.dense_chunk(F, PLAIN_ROWS, masks, ret, w=w, ns=ns)
    pl = dense_cuda.dense_chunk_plain(F, PLAIN_ROWS, masks, ret, w=w, ns=ns)
    same, err = same_result(k, pl)
    max_err = max(max_err, err)
    if not same:
        raise AssertionError("kernel != plain on the headline's rows")
    sweeps = int(k.sweeps)
    ms = time_chunk(lambda: dense_cuda.dense_chunk(
        F, PLAIN_ROWS, masks, ret, w=w, ns=ns), reps=10)
    plain_ms = time_chunk(lambda: dense_cuda.dense_chunk_plain(
        F, PLAIN_ROWS, masks, ret, w=w, ns=ns), reps=1)
    b_ms, b_by = bound_ms(w, ns, PLAIN_ROWS, sweeps)
    log(f"[plain] headline rows {base}..{base + PLAIN_ROWS - 1} w={w} "
        f"ns={ns} passes={int(k.passes)} sweeps={sweeps}: kernel {ms:.4f} "
        f"ms ({ms / PLAIN_ROWS * 1e3:.3f} us/row), plain {plain_ms:.2f} ms "
        f"({plain_ms / PLAIN_ROWS * 1e3:.1f} us/row), bound {b_ms:.6f} ms "
        f"({b_by}); no single PyTorch call computes this function")

    dense_clean.__exit__(None, None, None)
    kernels = [{
        "name": "dense_chunk", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/dense_chunk.cu",
        "replaces": "jepsen_tpu/lin/dense_pallas.py:145",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "bit_exact": True, "widths": widths, "path": dense_cuda.kernel_path(w),
        "launch_ms": launch_ms, "launch_bound_ms": sum(chunk_bound) /
        len(chunk_bound), "shape": {"w": w, "ns": ns, "rows": PLAIN_ROWS}}]
    with supervised_clean("phases 7-10"):
        kernels += sparse_phases(dev)
    with supervised_clean("phases 11-14"):
        kernels += pair_phases(dev)
    with supervised_clean("phases 15-19"):
        dom_entries, dom_compact_paths = crashdom_phases(dev)
    kernels += dom_entries
    next(k for k in kernels if k["name"] == "compact_keys")[
        "crashdom_headline_paths"] = dom_compact_paths
    with supervised_clean("phase 20"):
        kernels += batch_phases(dev, smi)
    with supervised_clean("phase 21"):
        bands = bands_phases(dev)
    for k in kernels:
        if k["name"] in bands:
            k["bands_mutex"] = bands[k["name"]]
    with supervised_clean("phase 22"):
        pack_phases(dev, smi)
    with supervised_clean("phase 23"):
        kernels.append(txn_phases(dev, smi))
    supervise_phases(dev, smi)
    stream = stream_phases(dev, smi)
    for k in kernels:
        k["stream_launches"] = stream["launches"].get(k["name"], 0)
    return finish(kernels, smi, kind)


def finish(kernels, smi: str, kind: str) -> int:
    """The result lines: kernels, the card, and the contract line last."""
    import torch

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--bands"], ["--pack"], ["--txn"],
                            ["--supervise"], ["--stream"]):
        sys.exit("usage: chip_smoke.py [--bands | --pack | --txn | "
                 "--supervise | --stream]")
    sys.exit(main(bands_only=sys.argv[1:] == ["--bands"],
                  pack_only=sys.argv[1:] == ["--pack"],
                  txn_only=sys.argv[1:] == ["--txn"],
                  supervise_only=sys.argv[1:] == ["--supervise"],
                  stream_only=sys.argv[1:] == ["--stream"]))
