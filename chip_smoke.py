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
   slots at w in {4, 10, 14, 15, 16, 18} and ns in {4, 8, 32}, both
   bitmap placements (shared memory for w <= 15, device memory above),
   with a case that dies; outputs must be bit-identical;
3. the headline: a 100k-op CAS-register history with crashed ops
   through ``checker.linearizable(algorithm="gpu", device=dev)``, which must say
   valid and must have launched the kernel; then check times and the
   kernel's time per launch (CUDA events) over the headline's chunks;
4. a window-16 history (the device-memory placement end to end);
5. a corrupted history through ``algorithm="gpu"`` and ``"cpu"``: both
   invalid, on the same op, with final paths from the GPU;
6. the plain version's time beside the kernel's at the headline's shapes;
7. the sparse kernels vs their plain versions on the card, bit-exact:
   ``dedup_keys`` and ``compact_keys`` at n = 2^10 ... 2^19 (overflowing,
   all-invalid, sorted-with-holes and arbitrary inputs), and ``fixpoint``
   on the sparse headline's own rows and frontiers at every row tier its
   gate admits, converged, at ``it_max=1`` and overflowing;
8. the sparse headline: a 20k-op, concurrency-24 CAS-register history
   (window 24) through ``checker.linearizable(algorithm="gpu")``, which
   must say valid by ``gpu-bfs`` with every sparse kernel launched; then
   a timed device check, and one more with each kernel call's device
   time taken by CUDA events behind a spin gate (``CallTimer``);
9. a corrupted window-24 history through ``"gpu"`` and ``"cpu"``: both
   invalid on the same op, with final paths from the GPU;
10. each sparse kernel's time, its plain version's and one PyTorch
    call's (``torch.unique``, ``torch.sort``) at the headline's most
    frequent shapes, with its bound.

Then a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
without a CUDA card.
"""

from __future__ import annotations

import json
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
CASE_STATES = (4, 8, 32)
CASE_ROWS = 300
PLAIN_ROWS = 256


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_case(rng, w, ns, rows, die_at=None):
    """Seeded kernel inputs: a sparse entry bitmap, per-row masks from
    random partial transition functions over 70% of the slots, and return
    slots among each row's active slots. With ``die_at``, slot w-1 never
    has transitions and no entry config holds it, and it returns at row
    ``die_at``: the frontier must die exactly there."""
    import numpy as np

    F = np.zeros(1 << w, np.uint32)
    hi = w - 1 if die_at is not None else w
    for B in rng.integers(0, 1 << hi, size=8):
        F[B] |= np.uint32(rng.integers(1, 1 << min(ns, 31)))
    F[0] |= np.uint32(1)
    masks = np.zeros((rows, w, ns), np.uint64)
    active = rng.random((rows, w)) < 0.7
    if die_at is not None:
        active[:, w - 1] = False
    legal = rng.random((rows, w, ns)) < 0.85
    target = rng.integers(0, ns, size=(rows, w, ns))
    for r, j, s in zip(*np.nonzero(active[:, :, None] & legal)):
        masks[r, j, target[r, j, s]] |= np.uint64(1) << np.uint64(s)
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


# --- the sparse engine (phases 7-10) ---------------------------------------

SPARSE = dict(n_ops=20_000, concurrency=24, seed=42, value_range=5)
# The headline history with one read corrupted early (dead row 19), so
# the CPU oracle and the counterexample replay decide in seconds.
SPARSE_CORRUPT_SEED = 147
SORT_SIZES = tuple(1 << k for k in range(10, 20))
# Rows of the sparse headline whose entry frontiers feed the fixpoint
# checks (the first chunk).
FIXPOINT_ROWS = 512
# Integer ops per compare-exchange of a comparison sort (compare,
# select) and per key of a dedup or compaction scan; a floor on the work.
OPS_PER_COMPARE = 2
OPS_PER_SCAN_KEY = 2


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
    holes[rng.random(n) < 0.4] = 0xFFFFFFFF
    arb = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    arb[rng.random(n) < 0.3] = 0xFFFFFFFF
    arb[:n // 8] = arb[n // 8:2 * (n // 8)]
    compact = [(holes, n), (arb, max(n // 2, 1))]
    return dedup, compact


def check_sort_kernels(dev) -> int:
    """Phase 7a: dedup_keys and compact_keys against their plain versions
    at every size 2^10 ... 2^19 and one unpadded size. Returns the max
    word error (0, or it raises)."""
    import numpy as np
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import psort

    rng = np.random.default_rng(77)
    max_err = 0
    for n in SORT_SIZES + (1500,):
        dedup, compact = sort_inputs(rng, n)
        flags = []
        for keys, valid, cap in dedup:
            k = _u32.bitmap_from_numpy(keys, dev)
            v = torch.from_numpy(valid).to(dev)
            kern = psort.dedup_keys(k, v, cap)
            plain = psort.dedup_keys_plain(k, v, cap)
            torch.cuda.synchronize()
            same, err = same_outputs(kern, plain)
            max_err = max(max_err, err)
            if not same:
                raise AssertionError(f"dedup_keys != plain at n={n} "
                                     f"cap={cap}: count {int(kern[1])} vs "
                                     f"{int(plain[1])}, error {err}")
            flags.append(f"{int(kern[1])}{'+' if bool(kern[2]) else ''}")
        for keys, cap in compact:
            k = _u32.bitmap_from_numpy(keys, dev)
            kern = psort.compact_keys(k, cap)
            plain = psort.compact_keys_plain(k, cap)
            torch.cuda.synchronize()
            same, err = same_outputs(kern, plain)
            max_err = max(max_err, err)
            if not same:
                raise AssertionError(f"compact_keys != plain at n={n} "
                                     f"cap={cap}, error {err}")
            flags.append(str(int(kern[1])))
        log(f"[sort-vs-plain] n={n:6d} bit_exact=True counts (dedup+ = "
            f"overflow; then compact) {' '.join(flags)}")
    return max_err


def row_frontiers(eng, rows: int):
    """The entry frontier (row, lo, count) of each of the first ``rows``
    rows of ``eng``'s history, through the engine's own row loop at the
    top chunk cap."""
    from jepsen_tpu_torch.lin import bfs

    lo = eng.init_keys(bfs.PACKED_CAP_SCHEDULE[-1])
    count = 1
    out = []
    for r in range(min(rows, eng.p.R)):
        base = r - r % bfs.CHUNK
        eng.load_chunk(base, bfs.CHUNK)
        out.append((r, lo, count))
        lo, count, dead, ovf = eng.run_row(r - base, lo, count, True)
        if dead or ovf:
            raise AssertionError(f"row {r} of the sparse headline: dead="
                                 f"{dead} overflow={ovf}")
    return out


def fixpoint_inputs(eng, r: int, lo, count: int, tier: int):
    """The fused fixpoint's inputs for absolute row r at ``tier``:
    (lo[:tier], count, cols, sats, it_max) on the engine's device."""
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
    return (lo[:tier].contiguous(), count,
            _u32.bitmap_from_numpy(cols, eng.dev),
            _u32.bitmap_from_numpy(sats, eng.dev), it_max)


def check_fixpoint(eng, fronts) -> tuple[int, list]:
    """Phase 7b: fixpoint vs plain on real rows at every tier ``fits``
    admits: converged, it_max=1, and a full-tier entry that overflows.
    Returns (max word error, tiers checked)."""
    import numpy as np
    import torch

    from jepsen_tpu_torch import _u32
    from jepsen_tpu_torch.lin import bfs, psort, psort_fused, psort_fused_cuda

    rng = np.random.default_rng(78)
    max_err = 0
    tiers = [t for t in bfs.ROW_TIERS + bfs.PACKED_CAP_SCHEDULE[-1:]
             if psort_fused.fits(t, eng.M, eng.b)]
    shared = psort_fused_cuda.shared_max_n()
    # Passes each recorded row's closure needs, from its smallest tier;
    # each tier takes the row needing most passes among those it holds.
    need = []
    for r, lo, count in fronts:
        t = next((t for t in tiers if count * 4 <= t), None)
        if t is None:
            need.append(-1)
            continue
        l_t, cnt, cols, sats, it_max = fixpoint_inputs(eng, r, lo, count, t)
        need.append(int(psort_fused.fixpoint_flags(
            l_t, cnt, cols, sats, cap=t, b=eng.b, it_max=it_max)[1][2]))
    for tier in tiers:
        i = max((i for i, f in enumerate(fronts) if f[2] * 4 <= tier),
                key=lambda i: (need[i], fronts[i][2]))
        r, lo, count = fronts[i]
        l_t, cnt, cols, sats, it_max = fixpoint_inputs(eng, r, lo, count,
                                                       tier)
        big = np.unique(rng.choice(1 << (eng.W + eng.b - 1), tier,
                                   replace=False).astype(np.uint32)
                        & ~np.uint32((1 << eng.b) - 1) | np.uint32(eng.nil_id))
        full = np.full(tier, 0xFFFFFFFF, np.uint32)
        full[:big.size] = big
        runs = [("converged", l_t, cnt, it_max), ("it_max=1", l_t, cnt, 1),
                ("overflow", _u32.bitmap_from_numpy(full, eng.dev),
                 big.size, it_max)]
        n_pad = psort.pad_size(tier * (1 + eng.M))
        for what, x, c, itm in runs:
            kern = psort_fused.fixpoint_flags(x, c, cols, sats, cap=tier,
                                              b=eng.b, it_max=itm)
            plain = psort_fused.fixpoint_flags_plain(x, c, cols, sats,
                                                     cap=tier, b=eng.b,
                                                     it_max=itm)
            torch.cuda.synchronize()
            same, err = same_outputs(kern, plain)
            max_err = max(max_err, err)
            conv, ovf, passes, cnt = kern[1].tolist()
            log(f"[fixpoint-vs-plain] tier={tier:6d} n_pad={n_pad:7d} "
                f"({'shared' if n_pad <= shared else 'device'}) row={r} "
                f"{what:9s} count {c}->{cnt} passes={passes} converged="
                f"{conv} overflow={ovf} bit_exact={same}")
            if not same:
                raise AssertionError(f"fixpoint != plain at tier {tier} "
                                     f"({what}): flags {kern[1].tolist()} "
                                     f"vs {plain[1].tolist()}, error {err}")
    return max_err, tiers


# Seconds a spin kernel holds the stream before each timed call: the host
# enqueues the call's launches meanwhile (tens to a few hundred us), so
# the events around the call time the device's work alone.
GATE_S = 5e-4


class CallTimer:
    """Device time of each call of a wrapper while installed. Before a
    call a spin kernel (``torch.cuda._sleep``) holds the stream, and
    events around the call start when it ends: the wrapper's host work
    (allocations, the ctypes call, every launch it enqueues) is done by
    then, so the events bracket the device's work alone. A call whose
    host time outlasted its spin is counted in ``unheld``."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        import torch

        def timed(*a, **k):
            g, s, e = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
            t0 = time.perf_counter()
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

    def total_ms(self) -> float:
        return sum(s.elapsed_time(e) for _, _, s, e in self.calls)

    def unheld(self) -> int:
        return sum(host * 1e3 >= g.elapsed_time(s)
                   for host, g, s, _ in self.calls)


def sort_bound(n: int, out_n: int, in_bytes_per_key: int):
    """Least time for a sort-based dedup or compaction of n keys (the
    unpadded input): the bytes (keys in, keys out) over the memory rate,
    or n log2 n compares plus a scan over the integer rate."""
    import math

    nbytes = n * in_bytes_per_key + 4 * out_n + 8
    ops = n * math.log2(n) * OPS_PER_COMPARE + n * OPS_PER_SCAN_KEY
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b > t_o else "operations"


def fixpoint_bound(cap: int, M: int, b: int, counts):
    """Least time for one fused fixpoint: lo in and out and the tables,
    or per pass, for the c carried keys entering it (``counts``), the
    expansion and a sort of their c * (1 + M) candidates."""
    import math

    nbytes = 4 * (2 * cap + 10 * M + 2 * (1 << b) + 5)
    ops = 0.0
    for c in counts:
        n = max(c * (1 + M), 2)
        ops += n * math.log2(n) * OPS_PER_COMPARE \
            + n * (8 + OPS_PER_SCAN_KEY)
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = ops / PEAK_OPS_PER_S * 1e3
    return max(t_b, t_o), "bytes" if t_b > t_o else "operations"


def sparse_phases(dev) -> list:
    """Phases 7-10. Returns the sparse kernels' entries of the kernels
    line."""
    import torch

    from jepsen_tpu_torch import _u32, checker
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import bfs, prepare, psort, psort_fused, synth

    model = m.cas_register()
    h = synth.generate_register_history(**SPARSE)
    t0 = time.perf_counter()
    p = prepare.prepare(model, h)
    t_prep = time.perf_counter() - t0
    eng = bfs._Engine(p, dev)
    log(f"[sparse] ops={SPARSE['n_ops']} window={p.window} R={p.R} "
        f"b={eng.b} M={eng.M} band={bfs.band_error(p) or 'single-key'}")

    # 7. kernels vs plain versions on the card
    sort_err = check_sort_kernels(dev)
    t0 = time.perf_counter()
    fronts = row_frontiers(eng, FIXPOINT_ROWS)
    log(f"[fixpoint-vs-plain] frontiers of rows 0..{len(fronts) - 1} in "
        f"{time.perf_counter() - t0:.2f}s, counts up to "
        f"{max(f[2] for f in fronts)}")
    fix_err, fix_tiers = check_fixpoint(eng, fronts)

    # 8. the sparse headline through the user's entry point
    psort.LAUNCHES.update(dedup_keys=0, compact_keys=0)
    psort_fused.LAUNCHES = 0
    t0 = time.perf_counter()
    r = checker.linearizable(algorithm="gpu", device=dev).check(None, model,
                                                                h)
    t_e2e = time.perf_counter() - t0
    launches = {"dedup_keys": psort.LAUNCHES["dedup_keys"],
                "compact_keys": psort.LAUNCHES["compact_keys"],
                "fixpoint": psort_fused.LAUNCHES}
    log(f"[sparse-headline] verdict={r['valid?']} analyzer="
        f"{r.get('analyzer')} backend={r.get('backend')} max-cap="
        f"{r.get('max-cap')} final-frontier-size="
        f"{r.get('final-frontier-size')} launches={launches}")
    log(f"[sparse-headline] stats={r.get('engine-stats')}")
    if r["valid?"] is not True or r.get("analyzer") != "gpu-bfs":
        raise AssertionError(f"sparse headline: {r}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the sparse headline never launched {missing}")
    # The device check alone, then again with each kernel call timed.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rr = bfs.check_packed(p, device=dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    if rr["valid?"] is not True:
        raise AssertionError(f"sparse re-check said {rr['valid?']!r}")
    stats = rr["engine-stats"]
    log(f"[sparse-headline] prepare={t_prep:.3f}s device-check="
        f"{t_dev:.3f}s e2e={t_e2e:.3f}s ({SPARSE['n_ops'] / t_e2e:.0f} "
        f"ops/s e2e, {SPARSE['n_ops'] / t_dev:.0f} ops/s device check); "
        f"fetches/row={stats['fetches'] / max(stats['rows'], 1):.3f}")
    timers = [CallTimer(psort, "dedup_keys"),
              CallTimer(psort, "compact_keys"),
              CallTimer(psort_fused, "fixpoint_flags")]
    with timers[0], timers[1], timers[2]:
        rt = bfs.check_packed(p, device=dev)
        torch.cuda.synchronize()
    if rt["valid?"] is not True:
        raise AssertionError(f"sparse timed re-check said {rt['valid?']!r}")
    per_kernel = dict(zip(("dedup_keys", "compact_keys", "fixpoint"),
                          (t.total_ms() for t in timers)))
    log("[sparse-headline] kernel device ms (CUDA events after a spin "
        "gate, summed per call): "
        + ", ".join(f"{k}={v:.1f} ({len(t.calls)} calls, "
                    f"{t.unheld()} ungated)"
                    for (k, v), t in zip(per_kernel.items(), timers))
        + f"; kernels {sum(per_kernel.values()) / (t_dev * 1e3):.1%} of "
        f"the device check")

    # 9. a sparse counterexample, GPU against the CPU oracle
    hc = synth.corrupt_history(h, seed=SPARSE_CORRUPT_SEED)
    pc = prepare.prepare(model, hc)
    t0 = time.perf_counter()
    rg = checker.linearizable(algorithm="gpu", device=dev).check(None, model,
                                                                 hc)
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = checker.linearizable(algorithm="cpu").check(None, model, hc)
    t_c = time.perf_counter() - t0
    log(f"[sparse-counterexample] window={pc.window} R={pc.R} gpu="
        f"{rg['valid?']} ({rg.get('analyzer')}, {t_g:.2f}s) cpu="
        f"{rc['valid?']} ({t_c:.2f}s) dead-row={rg.get('dead-row')} "
        f"op={rg.get('op')} final-paths={len(rg.get('final-paths', []))}")
    if pc.window <= 20 or rg.get("analyzer") != "gpu-bfs":
        raise AssertionError("the sparse counterexample missed the sparse "
                             "engine")
    if rg["valid?"] is not False or rc["valid?"] is not False:
        raise AssertionError(f"corrupted history: gpu {rg['valid?']!r} "
                             f"cpu {rc['valid?']!r}")
    if rg.get("op") != rc.get("op"):
        raise AssertionError(f"ops differ: gpu {rg.get('op')} cpu "
                             f"{rc.get('op')}")
    if not rg.get("final-paths"):
        raise AssertionError("the GPU counterexample has no final paths")

    # 10. times at the headline's most frequent shapes
    tiers = stats["tiers"]
    fused_tiers = {t: n for t, n in tiers.items()
                   if psort_fused.fits(t, eng.M, eng.b)}
    f_tier = max(fused_tiers, key=fused_tiers.get)
    fr = max((f for f in fronts if f[2] * 4 <= f_tier),
             key=lambda f: (f[2], f[0]))
    l_t, cnt, cols, sats, it_max = fixpoint_inputs(eng, *fr, f_tier)
    n_pad = psort.pad_size(f_tier * (1 + eng.M))
    fx_passes = int(psort_fused.fixpoint_flags(
        l_t, cnt, cols, sats, cap=f_tier, b=eng.b, it_max=it_max)[1][2])
    # The carried count entering each pass, one plain pass at a time.
    counts, x, c = [], l_t, cnt
    for _ in range(fx_passes):
        counts.append(int(c))
        x, fl = psort_fused.fixpoint_flags_plain(x, c, cols, sats,
                                                 cap=f_tier, b=eng.b,
                                                 it_max=1)
        c = fl[3]
    fx_ms = time_chunk(lambda: psort_fused.fixpoint_flags(
        l_t, cnt, cols, sats, cap=f_tier, b=eng.b, it_max=it_max), 20)
    fx_plain = time_chunk(lambda: psort_fused.fixpoint_flags_plain(
        l_t, cnt, cols, sats, cap=f_tier, b=eng.b, it_max=it_max), 2)
    fx_bound, fx_by = fixpoint_bound(f_tier, eng.M, eng.b, counts)
    log(f"[sparse-time] fixpoint tier={f_tier} ({fused_tiers[f_tier]} rows)"
        f" row={fr[0]} count={fr[2]} passes={fx_passes} n_pad={n_pad} "
        f"carried counts {counts}: "
        f"kernel {fx_ms:.4f} ms, plain {fx_plain:.3f} ms, bound "
        f"{fx_bound:.6f} ms ({fx_by}); no PyTorch call computes it")

    # compact_keys at the most frequent tier: the row's dropped keys.
    c_tier = max(tiers, key=tiers.get)
    fr = max((f for f in fronts if f[2] * 4 <= c_tier),
             key=lambda f: (f[2], f[0]))
    s = int(p.ret_slot[fr[0]])
    bit = _u32.raw_word(1 << (eng.b + s))
    x = fr[1][:c_tier]
    live = torch.arange(c_tier, device=dev) < fr[2]
    dropped = torch.where(live & ((x & bit) != 0), x & ~bit,
                          psort.KEY_FILL_RAW).contiguous()
    ck_ms = time_chunk(lambda: psort.compact_keys(dropped, c_tier), 50)
    ck_plain = time_chunk(lambda: psort.compact_keys_plain(dropped, c_tier),
                          20)
    wide = _u32.widen(dropped)
    ck_lib = time_chunk(lambda: torch.sort(wide), 50)
    n_pad_c = psort.pad_size(c_tier)
    ck_bound, ck_by = sort_bound(c_tier, c_tier, 4)
    log(f"[sparse-time] compact_keys n={c_tier} (pad {n_pad_c}): kernel "
        f"{ck_ms:.4f} ms, plain {ck_plain:.4f} ms, torch.sort "
        f"{ck_lib:.4f} ms, bound {ck_bound:.6f} ms ({ck_by})")

    # dedup_keys at the most frequent unfused tier: real candidates.
    unfused = {t: n for t, n in stats.get("unfused_tiers", {}).items()}
    d_tier = max(unfused, key=unfused.get) if unfused else \
        bfs.PACKED_CAP_SCHEDULE[0]
    Mg = min(max(1, bfs._GROUP_BOUND // d_tier - 1), eng.M)
    fr = max(fronts, key=lambda f: (f[2], f[0]))
    r0 = fr[0] - fr[0] % bfs.CHUNK
    eng.load_chunk(r0, bfs.CHUNK)
    tbl = eng.row_tables(fr[0] - r0).columns(0, Mg)
    cand, valid = bfs._expand_keys_compact(
        bfs._resize(fr[1], d_tier), fr[2], tbl, cap=d_tier, b=eng.b,
        nil_id=eng.nil_id, step_fn=eng.step_fn)
    n_d = cand.numel()
    dk_ms = time_chunk(lambda: psort.dedup_keys(cand, valid, d_tier), 50)
    dk_plain = time_chunk(lambda: psort.dedup_keys_plain(cand, valid,
                                                         d_tier), 20)
    folded = _u32.widen(cand) | ((~valid).to(torch.int64) << 31)
    dk_lib = time_chunk(lambda: torch.unique(folded, sorted=True), 50)
    dk_bound, dk_by = sort_bound(n_d, d_tier, 5)
    log(f"[sparse-time] dedup_keys n={n_d} cap={d_tier} "
        f"({unfused.get(d_tier, 0)} passes at this tier): kernel "
        f"{dk_ms:.4f} ms, plain {dk_plain:.4f} ms, torch.unique "
        f"{dk_lib:.4f} ms, bound {dk_bound:.6f} ms ({dk_by})")

    src = "jepsen_tpu_torch/csrc/"
    return [
        {"name": "dedup_keys", "route": "cuda", "source": src + "psort.cu",
         "replaces": "jepsen_tpu/lin/psort.py:741",
         "launches": launches["dedup_keys"], "max_abs_err": sort_err,
         "ms": dk_ms, "plain_ms": dk_plain, "bound_ms": dk_bound,
         "bound_by": dk_by, "library_ms": dk_lib, "bit_exact": True,
         "sizes": list(SORT_SIZES) + [1500],
         "shape": {"n": n_d, "cap": d_tier},
         "headline_ms": per_kernel["dedup_keys"]},
        {"name": "compact_keys", "route": "cuda",
         "source": src + "psort.cu",
         "replaces": "jepsen_tpu/lin/psort.py:679",
         "launches": launches["compact_keys"], "max_abs_err": sort_err,
         "ms": ck_ms, "plain_ms": ck_plain, "bound_ms": ck_bound,
         "bound_by": ck_by, "library_ms": ck_lib, "bit_exact": True,
         "sizes": list(SORT_SIZES) + [1500],
         "shape": {"n": c_tier, "cap": c_tier},
         "headline_ms": per_kernel["compact_keys"]},
        {"name": "fixpoint", "route": "cuda",
         "source": src + "psort_fused.cu",
         "replaces": "jepsen_tpu/lin/psort_fused.py:316",
         "launches": launches["fixpoint"], "max_abs_err": fix_err,
         "ms": fx_ms, "plain_ms": fx_plain, "bound_ms": fx_bound,
         "bound_by": fx_by, "library_ms": None, "bit_exact": True,
         "tiers": fix_tiers,
         "shape": {"cap": f_tier, "M": eng.M, "b": eng.b, "n_pad": n_pad,
                   "passes": fx_passes},
         "headline_ms": per_kernel["fixpoint"]},
    ]


def main(device: str = "cuda") -> int:
    """Run every phase on ``device`` ("cpu" only rehearses the control
    flow with the plain versions in place of the kernels)."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

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
    _build.build(["dense_chunk", "psort", "psort_fused"])
    smem_w = dense_cuda.shared_max_w()
    log(f"[build] dense_chunk, psort, psort_fused built and loaded in "
        f"{time.perf_counter() - t0:.2f}s (dense shared-memory bitmap up "
        f"to w={smem_w})")
    for name in ("dense_chunk", "psort", "psort_fused"):
        for line in _build.BUILD_LOG.get(name, {}).get(
                "ptxas", "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line \
                    or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")
    # 2. kernel vs plain on the card
    rng = np.random.default_rng(1234)
    max_err = 0
    widths = []
    cases = [(w, ns, None) for w in CASE_WIDTHS for ns in CASE_STATES]
    cases += [(14, 8, 150), (16, 8, 150)]
    for w, ns, die_at in cases:
        Fh, mh, rh = random_case(rng, w, ns, CASE_ROWS, die_at)
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
        place = "shared" if w <= smem_w else "device"
        log(f"[kernel-vs-plain] w={w:2d} ns={ns:2d} {place:6s} "
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
            f"passes={int(res.passes)} sweeps={int(res.sweeps)} kernel "
            f"{chunk_ms[-1]:.3f} ms ({chunk_ms[-1] / n * 1e3:.2f} us/row), "
            f"bound {b_ms:.4f} ms ({b_by})")
    log(f"[headline] launches={launches} mean ms/launch="
        f"{sum(chunk_ms) / len(chunk_ms):.3f} (CUDA events); kernels "
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

    kernels = [{
        "name": "dense_chunk", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/dense_chunk.cu",
        "replaces": "jepsen_tpu/lin/dense_pallas.py:145",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "bit_exact": True, "widths": widths,
        "shape": {"w": w, "ns": ns, "rows": PLAIN_ROWS}}]
    kernels += sparse_phases(dev)
    return finish(kernels, smi, kind)


def finish(kernels, smi: str, kind: str) -> int:
    """The result lines: kernels, the card, and the contract line last."""
    import torch

    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
