"""Device SCC engine for the transaction dependency-graph checker.

The port of the JAX package's ``txn/device.py``. It decides the cycle
structure of a packed dependency graph (:mod:`jepsen_tpu_torch.txn.pack`)
on the card, as three fixpoint loops over the flat edge arrays in ONE
launch of a CUDA kernel (:func:`scc_program`, ``csrc/txn_scc.cu``), per
edge *tier* (``ww`` for G0, ``ww+wr`` for G1c, the full graph for
G-single/G2-item):

1. **Trim**: repeatedly drop nodes with zero in- or out-degree among
   live edges. The fixpoint (the *core*) is nonempty iff a cycle
   exists — a DAG always trims to nothing — so the tier's cycle
   verdict is decided entirely on device.
2. **Forward min-label**: ``lab[v]`` converges to the smallest core
   ancestor of ``v`` (including itself) — min-scatter over the edge
   adjacency to fixpoint (Orzan-style coloring).
3. **Backward flag**: within each label region, flag the nodes that
   reach the region's root. Flagged nodes of region ``r`` are EXACTLY
   the SCC containing ``r`` (mutual reachability: ``lab[v] == r``
   means r reaches v, the flag means v reaches r, and any such path
   stays inside the region — a smaller-id detour would have relabeled
   the root).

The host then groups flagged nodes by label into SCCs and runs the
oracle's Tarjan only on the *residue* (core nodes whose region root
lies outside their SCC — typically empty); classification and the
canonical witness cycle are shared with :mod:`jepsen_tpu_torch.txn.oracle`
(:func:`oracle.check_graph`), so verdict and witness equal the CPU
spec's wherever the SCC decompositions agree.

Fault discipline:

- Every loop carries an iteration ceiling inside the launch
  (``JEPSEN_TPU_TXN_IT_MAX``, auto ``n + 8``): a nonterminating orbit
  becomes an honest ``overflow: budget``, which sends the tier to the
  host Tarjan (bounded by ``JEPSEN_TPU_TXN_CPU_MAX`` edges; past it the
  result is an honest ``valid? "unknown"``), recorded in ``fallbacks``.
- Every tier's launch runs under the dispatch watchdog
  (:func:`jepsen_tpu_torch.lin.supervise.run_guarded`, site ``txn-scc``),
  its fetch inside the supervised thunk. A quarantined shape, a wedge or
  a fault (a refused or faulting launch raises ``_build.LaunchError``)
  is recorded in ``fallbacks``, the stats and the quarantine ledger. On
  the card the check then reports an honest ``valid? "unknown"`` with the
  reason as its ``overflow``; on the CPU the tier goes to the host
  Tarjan, as in the JAX package. Nothing falls back to the plain
  version; a failed kernel build and a sticky CUDA fault raise.

On a CUDA tensor :func:`scc_program` launches the kernel; on a CPU
tensor it runs :func:`scc_program_plain`, the same loops as torch ops.
Entry points take ``device=``: the card by default (raising without
one), ``"cpu"`` for the plain version.

Array shapes are bucketed to powers of two (nodes >= 256, edges >= 512),
as the reference's, so a tier's stats name the same ``n_pad``/``e_pad``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from jepsen_tpu_torch import resolve_device, util
from jepsen_tpu_torch.lin import supervise
from jepsen_tpu_torch.txn import oracle
from jepsen_tpu_torch.txn.pack import PackedTxnHistory

MIN_NODE_PAD = 256
MIN_EDGE_PAD = 512

# Edge tiers, in classification order. Each anomaly needs the tiers
# listed (classify's coverage sets need wwr whenever full runs).
TIER_TYPES = {"ww": (oracle.WW,),
              "wwr": (oracle.WW, oracle.WR),
              "full": (oracle.WW, oracle.WR, oracle.RW)}
# G-single/G2-item need only the full tier: the classifier consumes a
# wwr decomposition solely for G1c's own loop, so running wwr for an
# rw-classes-only request is dead device work.
ANOMALY_TIERS = {"G0": ("ww",), "G1c": ("wwr",),
                 "G-single": ("full",), "G2-item": ("full",)}

ANALYZER = "txn-gpu"

# Kernel launches since import (or since a caller reset it): one per
# launch of the CUDA kernel, none for the plain version.
LAUNCHES = 0


def it_max_for(n: int) -> int:
    """Iteration ceiling inside the launch, read per call. Every phase
    converges in at most n+1 rounds (each trim round kills a node or
    stops; a label/flag round extends the fixed set or stops), so the
    auto ceiling is a true upper bound, not a tuning knob; override for
    triage only."""
    env = util.env_int("JEPSEN_TPU_TXN_IT_MAX", 0)
    return env if env > 0 else n + 8


def cpu_max_edges() -> int:
    """Largest graph the host-Tarjan fallback rung accepts; past it an
    overflowed tier reports an honest unknown."""
    return util.env_int("JEPSEN_TPU_TXN_CPU_MAX", 2_000_000)


def stats_path() -> str | None:
    """Snapshot file of the last check (the JAX package's web anomaly
    panel reads the same keys)."""
    return os.environ.get("JEPSEN_TPU_TXN_STATS",
                          os.path.join(".jax_cache", "txn_stats.json"))


def _bucket(n: int, floor: int) -> int:
    return max(floor, 1 << max(0, (max(1, n) - 1).bit_length()))


def _check_args(src, dst, live, n: int, n_pad: int) -> None:
    e_pad = src.shape[0] if src.dim() == 1 else -1
    for name, t, dt in (("src", src, torch.int32), ("dst", dst, torch.int32),
                        ("live", live, torch.bool)):
        if t.dtype != dt or t.dim() != 1 or t.shape[0] != e_pad \
                or t.device != src.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt}[e_pad] on "
                             f"src's device, got {t.dtype}{list(t.shape)} "
                             f"on {t.device}")
    if e_pad < 1 or n_pad < 1 or not 0 <= n <= n_pad:
        raise ValueError(f"need e_pad >= 1 and 0 <= n <= n_pad, got "
                         f"e_pad={e_pad} n={n} n_pad={n_pad}")


def scc_program_plain(src, dst, live, n: int, it_max: int, *, n_pad: int):
    """Trim -> forward min-label -> backward flag as torch ops: the plain
    version of the kernel, Jacobi rounds driven from the host.

    src/dst: int32[e_pad] (padded edges point at node 0 with
    live=False; every index in [0, n_pad)); live: bool[e_pad]; n: live
    node count; it_max: ceiling. Returns (alive bool[n_pad], lab
    int32[n_pad], flag bool[n_pad], iters int32[3], overflow bool[3]).
    """
    _check_args(src, dst, live, n, n_pad)
    dev = src.device
    s, d = src.long(), dst.long()
    iota = torch.arange(n_pad, dtype=torch.int32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    iters, overflow = [], []

    def loop(body, x):
        it, ch = 0, True
        while ch and it < it_max:
            new = body(x)
            ch = bool((new != x).any())
            x, it = new, it + 1
        iters.append(it)
        overflow.append(ch)
        return x

    # Phase 1: trim to the cycle core.
    def trim(alive):
        ea = (live & alive[s] & alive[d]).to(torch.int32)
        indeg = torch.zeros(n_pad, **i32).index_add_(0, d, ea)
        outdeg = torch.zeros(n_pad, **i32).index_add_(0, s, ea)
        return alive & (indeg > 0) & (outdeg > 0)

    alive = loop(trim, iota < n)
    ea = live & alive[s] & alive[d]

    # Phase 2: forward min-label fixpoint over the core.
    def label(lab):
        contrib = torch.full((n_pad,), n_pad, **i32).scatter_reduce_(
            0, d, torch.where(ea, lab[s], n_pad), "amin", include_self=True)
        return torch.where(alive, torch.minimum(lab, contrib), n_pad)

    lab = loop(label, torch.where(alive, iota, n_pad))

    # Phase 3: backward reach-the-root flags within label regions.
    same = ea & (lab[s] == lab[d])

    def flags(flag):
        prop = torch.zeros(n_pad, **i32).scatter_reduce_(
            0, s, torch.where(same, flag[d], 0), "amax", include_self=True)
        return torch.maximum(flag, torch.where(alive, prop, 0))

    flag = loop(flags, (alive & (lab == iota)).to(torch.int32))
    return (alive, lab, flag.bool(), torch.tensor(iters, **i32),
            torch.tensor(overflow, dtype=torch.bool, device=dev))


def _split(buf, n_pad: int):
    alive, lab, flag = (buf[i * n_pad:(i + 1) * n_pad] for i in range(3))
    rest = buf[3 * n_pad:]
    return alive != 0, lab, flag != 0, rest[:3], rest[3:6] != 0


def scc_program(src, dst, live, n: int, it_max: int, *, n_pad: int):
    """The three loops on ``src``'s device: the CUDA kernel for CUDA
    tensors (one launch), :func:`scc_program_plain` for CPU ones. Same
    signature and outputs as :func:`scc_program_plain`."""
    global LAUNCHES
    if not src.is_cuda:
        return scc_program_plain(src, dst, live, n, it_max, n_pad=n_pad)
    from jepsen_tpu_torch.txn import scc_cuda

    _check_args(src, dst, live, n, n_pad)
    out = scc_cuda.scc(src, dst, live, n, it_max, n_pad)
    LAUNCHES += 1
    return _split(out, n_pad)


class _TierFallback(Exception):
    def __init__(self, tier: str, reason: str):
        self.tier, self.reason = tier, reason
        super().__init__(f"tier {tier}: {reason}")


def _tier_edges(pt: PackedTxnHistory, tier: str, rt: bool):
    types = set(TIER_TYPES[tier]) | ({oracle.RT} if rt else set())
    mask = np.isin(pt.edge_typ, list(types))
    return pt.edge_src[mask], pt.edge_dst[mask]


def tier_window(pt: PackedTxnHistory, tier: str, rt: bool):
    """The window of one tier that the device program runs on: (src,
    dst, n, lo, e_all), its edges in window coordinates (int32 numpy), or
    the tier's stats dict when no cycle can exist (no edges, or every
    edge forward).

    Backward-edge window (exact): node ids follow invocation order, so a
    healthy serializable history's edges all point FORWARD (src < dst) —
    a topological order exists and the tier is trivially acyclic. Any
    cycle must contain a backward edge, and every node of every cycle
    lies inside [min backward dst, max backward src] (the forward
    sub-paths between a cycle's backward edges ascend monotonically, so
    they never leave the span). Restricting the program to that window
    makes healthy histories a host-side no-op and keeps the trim's
    layer-peeling local to the anomalous region.
    """
    src_h, dst_h = _tier_edges(pt, tier, rt)
    e_all = len(src_h)
    if e_all == 0 or pt.n == 0:
        return {"edges": 0, "core": 0, "device": False}
    bw = src_h > dst_h
    if not bw.any():
        return {"edges": int(e_all), "core": 0, "device": False,
                "short_circuit": "forward-order"}
    lo = int(dst_h[bw].min())
    hi = int(src_h[bw].max())
    inwin = (src_h >= lo) & (src_h <= hi) & (dst_h >= lo) & (dst_h <= hi)
    return ((src_h[inwin] - lo).astype(np.int32),
            (dst_h[inwin] - lo).astype(np.int32), hi - lo + 1, lo, e_all)


def window_inputs(src_h, dst_h, n: int, dev: torch.device):
    """The program's padded inputs on ``dev``: (src, dst, live, n_pad)."""
    e = len(src_h)
    n_pad = _bucket(n, MIN_NODE_PAD)
    e_pad = _bucket(e, MIN_EDGE_PAD)
    src_d = torch.from_numpy(np.pad(src_h, (0, e_pad - e))).to(dev)
    dst_d = torch.from_numpy(np.pad(dst_h, (0, e_pad - e))).to(dev)
    live_d = torch.from_numpy(np.arange(e_pad) < e).to(dev)
    return src_d, dst_d, live_d, n_pad


def _tier_device_sccs(pt: PackedTxnHistory, tier: str, stats: dict,
                      rt: bool, dev: torch.device):
    """One tier on the device: launch the SCC program, fetch its outputs
    once (both inside one supervised dispatch, site ``txn-scc``), decode
    SCCs from (alive, lab, flag), Tarjan the residue on the host. Returns
    (sccs, tier_stats) or raises _TierFallback on an overflow, a
    quarantined shape, a wedge or a fault.

    ``rt`` is the REQUESTED realtime flag, not ``pt.realtime`` (whether
    rt edges were packed): a realtime-packed history checked as plain
    serializable must exclude rt edges from every tier or its SCC
    decompositions diverge from the shared classifier's cycle types.
    """
    win = tier_window(pt, tier, rt)
    if isinstance(win, dict):
        return [], win
    src_h, dst_h, n, lo, e_all = win
    e = len(src_h)
    n_pad = _bucket(n, MIN_NODE_PAD)
    e_pad = _bucket(e, MIN_EDGE_PAD)
    key = supervise.shape_key("txn-scc", cap=e_pad, window=0,
                              kernel=f"txn-{tier}", rows=n_pad)
    if supervise.quarantined(key) is not None:
        supervise.note_skip(stats)
        raise _TierFallback(tier, "quarantined")

    def thunk():
        # The inputs, the launch and one device-to-host copy of the five
        # outputs, inside the supervised worker: a stuck fetch is a
        # wedged dispatch, not a wedged caller.
        src_d, dst_d, live_d, _ = window_inputs(src_h, dst_h, n, dev)
        outs = scc_program(src_d, dst_d, live_d, n, it_max_for(n),
                           n_pad=n_pad)
        return _split(torch.cat([x.to(torch.int32) for x in outs])
                      .cpu().numpy(), n_pad)

    outcome, value = supervise.run_guarded("txn-scc", key, thunk,
                                           stats=stats)
    if outcome != "ok":
        raise _TierFallback(tier, outcome)
    alive, lab, flag, iters, overflow = value
    if bool(overflow.any()):
        # The ceiling fired with changes pending: an honest budget
        # overflow, never a silently-partial decomposition.
        util.stat_bump(stats, "overflows")
        raise _TierFallback(tier, "overflow: budget")

    alive = alive[:n]
    lab = lab[:n]
    flag = flag[:n]
    core_idx = np.nonzero(alive)[0]
    # Flagged nodes of region r form exactly the SCC containing r
    # (window coordinates; +lo restores graph node ids).
    sccs: dict[int, list[int]] = {}
    for v in np.nonzero(alive & flag)[0]:
        sccs.setdefault(int(lab[v]), []).append(int(v) + lo)
    device_sccs = [sorted(c) for c in sccs.values() if len(c) > 1]
    # Residue: core nodes whose region root lies outside their SCC —
    # the peel Tarjan, restricted to residue-internal edges.
    residue = alive & ~flag
    res_sccs: list[list[int]] = []
    if residue.any():
        rset = np.nonzero(residue)[0]
        remap = -np.ones(n, np.int64)
        remap[rset] = np.arange(len(rset))
        em = residue[src_h] & residue[dst_h]
        res = oracle.tarjan(len(rset), remap[src_h[em]], remap[dst_h[em]])
        res_sccs = [sorted(int(rset[v]) + lo for v in c) for c in res]
    all_sccs = sorted(device_sccs + res_sccs, key=lambda c: c[0])
    tier_stats = {"edges": int(e_all), "window": [lo, lo + n - 1],
                  "window_edges": int(e), "core": int(len(core_idx)),
                  "device_sccs": len(device_sccs),
                  "residue": int(residue.sum()),
                  "residue_sccs": len(res_sccs),
                  "iterations": [int(x) for x in iters],
                  "n_pad": n_pad, "e_pad": e_pad, "device": True}
    return all_sccs, tier_stats


def _tier_host_sccs(pt: PackedTxnHistory, tier: str, rt: bool):
    return oracle.tarjan(pt.n, *_tier_edges(pt, tier, rt))


def _write_snapshot(snap: dict) -> None:
    path = stats_path()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(snap, fh, indent=1, sort_keys=True, default=str)
        os.replace(tmp, path)
    except Exception:  # noqa: BLE001 - snapshots are observability
        pass


def check_packed(pt: PackedTxnHistory, anomalies=None,
                 consistency: str = "serializable",
                 realtime: bool | None = None,
                 snapshot: bool = True, device=None) -> dict:
    """Decide transactional consistency of a packed history on
    ``device`` (the card by default; ``"cpu"`` runs the plain version).

    Runs the SCC program once per needed edge tier, hands the
    decompositions to the oracle's shared classifier, and reports the
    oracle-identical verdict + witness. A tier whose ceiling fires goes
    to the host Tarjan (``fallbacks``); only a graph past the host bound
    reports unknown. A tier whose launch wedged, faulted or is
    quarantined goes there too on the CPU, and on the card reports
    unknown.
    """
    dev = resolve_device(device)
    requested, rt = oracle.resolve_anomalies(anomalies, consistency,
                                             realtime)
    if rt and not pt.realtime:
        return {"valid?": "unknown", "analyzer": ANALYZER,
                "error": "history packed without realtime edges; "
                         "re-pack with realtime=True"}
    tiers: list[str] = []
    for a in requested:
        for t in ANOMALY_TIERS.get(a, ()):
            if t not in tiers:
                tiers.append(t)

    stats: dict = {"tiers": {}}
    t0 = time.time()
    sccs_by_tier: dict = {}
    fallbacks: dict = {}
    for tier in tiers:
        try:
            sccs, ts = _tier_device_sccs(pt, tier, stats, rt, dev)
            sccs_by_tier[tier] = sccs
            stats["tiers"][tier] = ts
        except _TierFallback as f:
            fallbacks[tier] = f.reason
            stuck = f.reason in ("quarantined", "wedge", "fault") \
                and not supervise.host_rungs(dev)
            if stuck or pt.n_edges > cpu_max_edges():
                # On the card a tier whose launch failed does not move to
                # the host; past the host bound no tier does.
                error = f"tier {tier}: the SCC launch gave {f.reason}" \
                    if stuck else \
                    f"tier {tier} {f.reason} and graph ({pt.n_edges} " \
                    f"edges) exceeds the host fallback bound " \
                    f"(JEPSEN_TPU_TXN_CPU_MAX)"
                out = {"valid?": "unknown", "analyzer": ANALYZER,
                       "error": error, "overflow": f.reason,
                       "stats": stats}
                if stuck:
                    out["fallbacks"] = fallbacks
                if snapshot:
                    _write_snapshot({"verdict": "unknown",
                                     "error": out["error"],
                                     "stats": stats})
                return out
            util.stat_bump(stats, "cpu_tiers")
            sccs_by_tier[tier] = _tier_host_sccs(pt, tier, rt)
            stats["tiers"][tier] = {"edges": None, "device": False,
                                    "fallback": f.reason}

    out = oracle.check_graph(pt.graph, requested, realtime=rt,
                             sccs_by_tier=sccs_by_tier)
    out["analyzer"] = ANALYZER
    out["consistency"] = consistency
    if fallbacks:
        out["fallbacks"] = fallbacks
    stats["seconds"] = round(time.time() - t0, 3)
    stats["edges"] = pt.n_edges
    stats["txns"] = pt.n
    out["device-stats"] = stats
    if snapshot:
        _write_snapshot({
            "verdict": out["valid?"],
            "consistency": consistency,
            "anomaly_types": out.get("anomaly-types", []),
            "anomaly_counts": {k: len(v) for k, v in
                               out.get("anomalies", {}).items()},
            "edge_counts": pt.graph.stats.get("edge_counts", {}),
            "graph": pt.graph.stats,
            "device": stats,
            "fallbacks": fallbacks,
            "updated": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                     time.gmtime())})
    return out
