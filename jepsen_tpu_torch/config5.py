"""Check BASELINE config 5 once on the card through the port.

    python3 -m jepsen_tpu_torch.config5

from the repository's root. Config 5 is the 100k-op partition-nemesis register history at
CockroachDB's 30 processes (``generate_partitioned_register_history(
100_000, seed=7, invoke_bias=0.45)``: window 49, 24 crashed mutators, the
crash-dom pair-key band). The script prints the card's name and power
limit, builds the kernels, times the host pack alone (and names its
walk, ``native`` for this history), then runs the
history through ``checker.linearizable(algorithm="gpu")`` with a time
budget of 2100 s, printing the launch counts once a minute while
it runs. The result line carries the verdict (or the honest unknown and
its reason), the end-to-end time, the device check time (end to end less
the separately timed pack), ``engine-stats`` and ``host-stats``, as the
last line of standard output (JSON). Needs one CUDA card and ``nvcc``.
Exits 2 without a card.

With ``JEPSEN_TPU_CKPT=<path>`` the sparse engine checkpoints its
frontier at committed row boundaries (every ``JEPSEN_TPU_CKPT_EVERY_S``
seconds, 60 by default) and, when the file exists, resumes from it: a
killed run re-run with the same setting continues mid-history, with the
same verdict, and the result line carries ``resumed-from-row``. The file
is deleted on a definite verdict.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

T0 = time.perf_counter()
OPS = 100_000
BUDGET_S = 2100.0


def log(*a):
    print(f"{time.perf_counter() - T0:7.1f}s", *a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("config5: no CUDA device is available", file=sys.stderr)
        return 2
    from jepsen_tpu_torch import _build, checker
    from jepsen_tpu_torch import models as m
    from jepsen_tpu_torch.lin import prepare, psort, supervise, synth

    smi = nvidia_smi_line()
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build(["dense_chunk", "psort", "psort_fused"])
    model = m.cas_register()
    t0 = time.perf_counter()
    h = synth.generate_partitioned_register_history(OPS, seed=7,
                                                    invoke_bias=0.45)
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = prepare.prepare(model, h)
    t_prep = time.perf_counter() - t0
    walk = prepare.pack_stats()["mode"]
    log(f"[config5] ops={OPS} window={p.window} R={p.R} crashed="
        f"{len(p.crashed_ops)} synth={t_synth:.3f}s prepare={t_prep:.3f}s "
        f"walk={walk} budget={BUDGET_S:.0f}s checkpoint="
        f"{supervise.ckpt_path()}")
    for k in psort.LAUNCHES:
        psort.LAUNCHES[k] = 0
    done = threading.Event()
    t0 = time.perf_counter()

    def beat():
        while not done.wait(60):
            log(f"[config5] running {time.perf_counter() - t0:.0f}s, "
                f"launches {dict(psort.LAUNCHES)}")

    threading.Thread(target=beat, daemon=True).start()
    try:
        r = checker.linearizable(algorithm="gpu", device=torch.device("cuda"),
                                 time_budget=BUDGET_S).check(None, model,
                                                                h)
    finally:
        done.set()
    t_e2e = time.perf_counter() - t0
    out = {"ops": OPS, "window": p.window, "R": p.R,
           "crashed": len(p.crashed_ops), "valid?": r["valid?"],
           "analyzer": r.get("analyzer"), "error": r.get("error"),
           "overflow": r.get("overflow"), "max-cap": r.get("max-cap"),
           "final-frontier-size": r.get("final-frontier-size"),
           "e2e_s": t_e2e, "prepare_s": t_prep, "walk": walk,
           "device_check_s": t_e2e - t_prep,
           "engine-stats": r.get("engine-stats"),
           "host-stats": r.get("host-stats"),
           "launches": dict(psort.LAUNCHES), "card": smi}
    if "resumed-from-row" in r:
        out["resumed-from-row"] = r["resumed-from-row"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
