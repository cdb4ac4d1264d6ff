#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its CUDA
kernel against its plain torch version.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (the kernel is built from
``jepsen_tpu_torch/csrc`` first) and this repository; imports nothing of
JAX. Phases, each of which raises on a failure:

1. the card's name and power limit; the kernel build;
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
6. the plain version's time beside the kernel's at the headline's shapes.

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

# Published H100 SXM peaks (NVIDIA data sheet; dense rates): HBM bandwidth,
# and the only non-tensor 32-bit rate the data sheet gives (float32, an
# FMA counted as two). The kernel's work is 32-bit integer ops, which
# issue at no more than that rate, so the bound below is a least time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
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


def time_chunk(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, by CUDA events, after one
    warm-up run."""
    import torch

    fn()
    if not torch.cuda.is_available():      # a CPU rehearsal: host clock
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def main(device: str = "cuda") -> int:
    """Run every phase on ``device`` ("cpu" only rehearses the control
    flow with the plain version in place of the kernel)."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np

    from jepsen_tpu_torch import _build, _u32, checker
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import dense, dense_cuda, prepare, synth

    dev = torch.device(device)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    _build.build(["dense_chunk"])
    smem_w = dense_cuda.shared_max_w()
    log(f"[build] dense_chunk built and loaded in "
        f"{time.perf_counter() - t0:.2f}s (shared-memory bitmap up to "
        f"w={smem_w})")
    for line in _build.BUILD_LOG.get("dense_chunk", {}).get(
            "ptxas", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"[build] {line.strip()}")

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

    log(json.dumps({"kernels": [{
        "name": "dense_chunk", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/dense_chunk.cu",
        "replaces": "jepsen_tpu/lin/dense_pallas.py:145",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "bit_exact": True, "widths": widths,
        "shape": {"w": w, "ns": ns, "rows": PLAIN_ROWS}}]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
