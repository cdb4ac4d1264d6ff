"""Host reference implementation of the transaction anomaly checker.

The port's copy of the JAX package's ``txn/oracle.py``, unchanged but
for its imports. The executable semantic spec of
:mod:`jepsen_tpu_torch.txn` (the `lin/cpu.py` role): Elle's list-append
analysis (Kingsbury & Alvaro, VLDB 2020) in Adya's formalization (*Weak
Consistency*, MIT 1999) —

1. **Edge inference** (:func:`infer`): a history of transactions over
   list-append registers (micro-ops ``["append", k, v]`` /
   ``["r", k, observed-list]``) determines a per-key *version order*
   from the observed read prefixes (each appended value is unique per
   key, so every read traces its writers — Elle's recoverable-write
   rule), from which flow the dependency edges:

   - ``wr`` — T2 read the version T1 wrote (last element of the list).
   - ``ww`` — T2 appended the version immediately after T1's.
   - ``rw`` — T1 read a prefix and T2 appended the next version
     (anti-dependency; an empty read anti-depends on the key's first
     writer).
   - ``rt`` — realtime: T1 completed before T2 invoked (transitively
     reduced to the completion frontier; only built for
     strict-serializable checks).

   Indeterminate (``:info``) transactions follow the packed-history
   conventions of :mod:`jepsen_tpu_torch.lin.prepare`: their appends count
   only when *observed* by some read (a write that may not have
   happened must not constrain the order); ``:fail`` appends are
   tracked solely to convict aborted reads (G1a).

2. **Cycle search** (:func:`tarjan`): strongly connected components,
   iteratively (100k-node histories blow the recursion limit).

3. **Classification** (:func:`classify`): each nontrivial SCC is
   explained by the strongest anomaly class its cycles witness —
   ``G0`` (write cycle: ww only), ``G1c`` (circular information flow:
   ww/wr with at least one wr), ``G-single`` (exactly one
   anti-dependency), ``G2-item`` (two or more) — with a canonical
   minimal witness cycle (:func:`witness_cycle`; BFS by ascending node
   id, so the device checker reproduces it bit-for-bit). Non-cycle
   anomalies from inference ride along: ``G1a`` (aborted read),
   ``garbage-read`` (a read observed a value no transaction ever
   appended — store corruption, not a dependency), ``duplicate-elements``,
   ``incompatible-order``.

:func:`check` is the public verdict entry point; the device engine
(:mod:`jepsen_tpu_torch.txn.device`) must agree with it on verdict AND
witness (held against the JAX package in tests/test_torch_txn.py).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any

import numpy as np

# Edge type ids, shared host<->device (pack.py edges, device.py masks).
WR, WW, RW, RT = 0, 1, 2, 3
EDGE_NAMES = {WR: "wr", WW: "ww", RW: "rw", RT: "rt"}

CYCLE_ANOMALIES = ("G0", "G1c", "G-single", "G2-item")
DIRECT_ANOMALIES = ("G1a", "garbage-read", "duplicate-elements",
                    "incompatible-order")

# Consistency model -> anomalies proscribed (Adya's hierarchy). SI
# admits G2-item (write skew lives there by design); serializability
# admits nothing cyclic; strict serializability additionally orders by
# realtime (rt edges join every cycle search).
CONSISTENCY_MODELS = {
    "serializable": CYCLE_ANOMALIES + DIRECT_ANOMALIES,
    "strict-serializable": CYCLE_ANOMALIES + DIRECT_ANOMALIES,
    "snapshot-isolation": ("G0", "G1c", "G-single") + DIRECT_ANOMALIES,
    "read-committed": ("G0", "G1c") + DIRECT_ANOMALIES,
}

MAX_WITNESSES = 8          # reported witnesses per anomaly type


@dataclass
class TxnNode:
    """One logical transaction (invocation + optional completion)."""

    idx: int                 # node id in the dependency graph
    op_index: int            # index of the invocation in the history
    process: Any
    mops: list               # micro-ops; completion's for ok, invoke's else
    ok: bool                 # True if completed ok; False if crashed (info)
    invoke_pos: int
    return_pos: int | None


@dataclass
class TxnGraph:
    """The inferred dependency graph + inference-level anomalies."""

    n: int
    src: np.ndarray          # i32[E]
    dst: np.ndarray          # i32[E]
    typ: np.ndarray          # i8[E]  (WR/WW/RW/RT)
    txns: list = field(default_factory=list)
    anomalies: dict = field(default_factory=dict)   # inference-level
    stats: dict = field(default_factory=dict)

    def edges_of(self, types: frozenset) -> tuple:
        m = np.isin(self.typ, list(types))
        return self.src[m], self.dst[m], self.typ[m]


class UnsupportedTxnHistory(Exception):
    """A history that is not list-append shaped (unknown micro-op f,
    non-unique appends are NOT this — those are anomalies)."""


def _mops_of(op) -> list:
    v = op.value
    if v is None:
        return []
    if not isinstance(v, (list, tuple)):
        raise UnsupportedTxnHistory(
            f"txn op value must be a micro-op list, got {type(v).__name__}")
    out = []
    for m in v:
        if not isinstance(m, (list, tuple)) or len(m) != 3 \
                or m[0] not in ("append", "r"):
            raise UnsupportedTxnHistory(f"bad micro-op {m!r}")
        out.append((m[0], m[1], m[2]))
    return out


def pair_txns(history) -> tuple[list[TxnNode], dict]:
    """Match txn invocations with completions. ``fail`` txns definitely
    did not commit — dropped from the graph, but their appends are kept
    (``failed_appends``: (k, v) -> op_index) so a read observing one is
    convicted as G1a. ``info`` txns may have committed: they stay, with
    the invocation's micro-ops (observed reads unknown)."""
    nodes: list[TxnNode] = []
    failed: dict = {}
    pending: dict[Any, tuple[int, Any]] = {}
    for pos, op in enumerate(history):
        if op.process == "nemesis" or op.f not in ("txn", "append-txn"):
            continue
        if op.is_invoke:
            pending[op.process] = (pos, op)
        elif op.process in pending:
            ipos, inv = pending.pop(op.process)
            if op.is_fail:
                for f, k, v in _mops_of(inv):
                    if f == "append":
                        failed[(k, v)] = inv.index if inv.index is not None \
                            else ipos
                continue
            ok = op.is_ok
            nodes.append(TxnNode(
                idx=len(nodes),
                op_index=inv.index if inv.index is not None else ipos,
                process=op.process,
                mops=_mops_of(op if ok else inv),
                ok=ok, invoke_pos=ipos,
                return_pos=pos if ok else None))
    for proc, (ipos, inv) in pending.items():   # dangling = crashed
        nodes.append(TxnNode(
            idx=len(nodes),
            op_index=inv.index if inv.index is not None else ipos,
            process=proc, mops=_mops_of(inv), ok=False,
            invoke_pos=ipos, return_pos=None))
    nodes.sort(key=lambda t: t.invoke_pos)
    for i, t in enumerate(nodes):
        t.idx = i
    return nodes, failed


def _realtime_edges(nodes: list[TxnNode]) -> list[tuple[int, int]]:
    """Transitively-reduced realtime order: each txn gets rt edges from
    the *frontier* of maximal completed txns at its invocation (a
    completed txn dominated by a later-invoked, earlier-completed one is
    dropped from the frontier — its edge is implied transitively)."""
    events = []   # (time, kind, node)  kind 0=return first at equal times
    for t in nodes:
        events.append((t.invoke_pos, 1, t))
        if t.return_pos is not None:
            events.append((t.return_pos, 0, t))
    events.sort(key=lambda e: (e[0], e[1]))
    frontier: list[TxnNode] = []
    edges = []
    for _pos, kind, t in events:
        if kind == 0:    # t completed: it dominates frontier members
            frontier[:] = [x for x in frontier
                           if x.return_pos >= t.invoke_pos]
            frontier.append(t)
        else:            # t invoked: edge from every frontier member
            for x in frontier:
                edges.append((x.idx, t.idx))
    return edges


def infer(history=None, nodes=None, failed=None,
          realtime: bool = False) -> TxnGraph:
    """Infer the wr/ww/rw(/rt) dependency graph from a list-append
    history (module docstring). Either a raw ``history`` or pre-paired
    ``(nodes, failed)`` may be supplied."""
    if nodes is None:
        nodes, failed = pair_txns(history)
    failed = failed or {}
    n = len(nodes)

    writer: dict = {}               # (k, v) -> node idx
    dupes: list = []
    appends_per_key: dict = defaultdict(int)
    for t in nodes:
        for f, k, v in t.mops:
            if f != "append":
                continue
            appends_per_key[k] += 1
            if (k, v) in writer and writer[(k, v)] != t.idx:
                dupes.append({"key": k, "value": v,
                              "txns": [writer[(k, v)], t.idx]})
            else:
                writer[(k, v)] = t.idx

    # Version order per key: the longest observed list; every other
    # read must be a prefix of it (list-append semantics).
    longest: dict = {}
    reads: list = []                # (node idx, k, observed tuple)
    for t in nodes:
        if not t.ok:
            continue                # info reads carry no observation
        for f, k, v in t.mops:
            if f != "r" or v is None:
                continue
            obs = tuple(v)
            reads.append((t.idx, k, obs))
            if len(obs) > len(longest.get(k, ())):
                longest[k] = obs

    incompatible: list = []
    g1a: list = []
    never: list = []
    for i, k, obs in reads:
        if obs != longest.get(k, ())[:len(obs)]:
            incompatible.append({"key": k, "txn": i, "observed": list(obs),
                                 "longest": list(longest.get(k, ()))})
        seen = set()
        for v in obs:
            if v in seen:
                dupes.append({"key": k, "value": v, "txns": [i],
                              "kind": "read-duplicate"})
            seen.add(v)
            if (k, v) not in writer:
                if (k, v) in failed:
                    g1a.append({"key": k, "value": v, "txn": i,
                                "failed-op-index": failed[(k, v)]})
                else:
                    never.append({"key": k, "value": v, "txn": i})

    es, ed, et = [], [], []

    def edge(a, b, ty):
        if a != b:
            es.append(a)
            ed.append(b)
            et.append(ty)

    # Unobserved COMMITTED appends: lists are append-only and a read
    # observes the whole list, so an ok append absent from the longest
    # read must order AFTER every observed version. It anchors a ww
    # tail edge from the last observed writer, and an rw
    # anti-dependency from every read that saw the full observed order
    # (the read provably missed it). Order among several unobserved
    # appends stays unknown — no edges between them. (:info appends
    # get neither: they may not have happened.)
    unobserved: dict = defaultdict(list)
    ok_txn = {t.idx for t in nodes if t.ok}
    observed_vals = {k: set(order) for k, order in longest.items()}
    for (k, v), w in writer.items():
        if w in ok_txn and v not in observed_vals.get(k, ()):
            unobserved[k].append(w)

    # ww: consecutive observed versions chain their writers.
    observed = 0
    for k, order in longest.items():
        prev = None
        for v in order:
            w = writer.get((k, v))
            if w is not None:
                observed += 1
                if prev is not None:
                    edge(prev, w, WW)
                prev = w
        if prev is not None:
            for w in unobserved.get(k, ()):
                edge(prev, w, WW)
    # wr / rw per read.
    for i, k, obs in reads:
        order = longest.get(k, ())
        if obs:
            w = writer.get((k, obs[-1]))
            if w is not None:
                edge(w, i, WR)
        if len(obs) < len(order):
            nxt = writer.get((k, order[len(obs)]))
            if nxt is not None:
                edge(i, nxt, RW)
        elif obs == order:
            for w in unobserved.get(k, ()):
                edge(i, w, RW)
    if realtime:
        for a, b in _realtime_edges(nodes):
            edge(a, b, RT)

    if es:
        e = np.unique(np.stack([np.asarray(es, np.int64),
                                np.asarray(ed, np.int64),
                                np.asarray(et, np.int64)], axis=1), axis=0)
        src, dst, typ = (e[:, 0].astype(np.int32),
                         e[:, 1].astype(np.int32),
                         e[:, 2].astype(np.int8))
    else:
        src = np.zeros(0, np.int32)
        dst = np.zeros(0, np.int32)
        typ = np.zeros(0, np.int8)

    anomalies = {}
    if g1a:
        anomalies["G1a"] = g1a[:MAX_WITNESSES]
    if never:
        # A value neither appended by any ok/info txn nor by a failed
        # one (which would be G1a): the store fabricated it. It maps to
        # no writer, so it forms no edges and no cycle — report it
        # directly or the corruption passes as valid.
        anomalies["garbage-read"] = never[:MAX_WITNESSES]
    if dupes:
        anomalies["duplicate-elements"] = dupes[:MAX_WITNESSES]
    if incompatible:
        anomalies["incompatible-order"] = incompatible[:MAX_WITNESSES]
    counts = {EDGE_NAMES[t]: int((typ == t).sum()) for t in (WR, WW, RW, RT)}
    stats = {"txns": n, "ok_txns": sum(1 for t in nodes if t.ok),
             "info_txns": sum(1 for t in nodes if not t.ok),
             "keys": len(appends_per_key), "reads": len(reads),
             "appends": sum(appends_per_key.values()),
             "observed_appends": observed,
             "edges": int(len(src)), "edge_counts": counts,
             "g1a": len(g1a), "garbage": len(never),
             "duplicates": len(dupes),
             "incompatible": len(incompatible)}
    return TxnGraph(n=n, src=src, dst=dst, typ=typ, txns=nodes,
                    anomalies=anomalies, stats=stats)


# --- SCC (iterative Tarjan) --------------------------------------------------


def _adjacency(n, src, dst) -> list[list[int]]:
    adj: list[list[int]] = [[] for _ in range(n)]
    order = np.lexsort((dst, src))
    for e in order:
        adj[int(src[e])].append(int(dst[e]))
    return adj


def tarjan(n: int, src, dst) -> list[list[int]]:
    """Nontrivial (size >= 2) SCCs, each sorted ascending, in ascending
    order of their minimum node — the canonical order classification
    and the device checker both use."""
    adj = _adjacency(n, src, dst)
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = [0]

    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for i in range(pi, len(adj[v])):
                w = adj[v][i]
                if index[w] == -1:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))
    sccs.sort(key=lambda c: c[0])
    return sccs


# --- classification ----------------------------------------------------------


def _scc_subgraph(scc: list[int], src, dst, typ, types: frozenset):
    in_scc = set(scc)
    adj: dict[int, list[tuple[int, int]]] = {v: [] for v in scc}
    for e in range(len(src)):
        a, b, t = int(src[e]), int(dst[e]), int(typ[e])
        if t in types and a in in_scc and b in in_scc:
            adj[a].append((b, t))
    for v in adj:
        adj[v].sort()
    return adj


def _bfs_path(adj, start: int, goal: int) -> list[tuple[int, int]] | None:
    """Shortest path start -> goal over ``adj`` (neighbors pre-sorted
    ascending, so the path is canonical); returns [(node, edge-type
    taken INTO node), ...] excluding start, or None."""
    from collections import deque

    parent: dict[int, tuple[int, int]] = {}
    q = deque([start])
    seen = {start}
    while q:
        v = q.popleft()
        for w, t in adj.get(v, ()):
            if w == goal:
                path = [(w, t)]
                x = v
                while x != start:
                    px, pt = parent[x]
                    path.append((x, pt))
                    x = px
                path.reverse()
                return path
            if w not in seen:
                seen.add(w)
                parent[w] = (v, t)
                q.append(w)
    return None


def witness_cycle(scc: list[int], src, dst, typ,
                  types: frozenset) -> dict | None:
    """Canonical minimal witness cycle through the SCC's smallest node:
    BFS (ascending neighbor order) from min(scc) back to itself within
    the SCC, restricted to ``types``. Deterministic, so oracle and
    device report byte-identical witnesses."""
    r = scc[0]
    adj = _scc_subgraph(scc, src, dst, typ, types)
    path = _bfs_path(adj, r, r)
    if path is None:
        return None
    nodes = [r] + [v for v, _t in path[:-1]]
    edges = [EDGE_NAMES[t] for _v, t in path]
    return {"nodes": nodes, "edges": edges,
            "rw-count": sum(1 for e in edges if e == "rw")}


def _has_internal_edge(scc: list[int], src, dst, typ, t: int) -> bool:
    """Does an edge of type ``t`` connect two nodes of this SCC?"""
    in_scc = set(scc)
    return any(int(typ[e]) == t and int(src[e]) in in_scc
               and int(dst[e]) in in_scc for e in range(len(src)))


def _closing_cycle(scc: list[int], src, dst, typ, edge_type: int,
                   path_types: frozenset) -> dict | None:
    """Canonical cycle through an ``edge_type`` edge of this SCC: for
    each such internal edge (u, v) ascending, the shortest
    ``path_types`` path v -> u closes it; the first closure wins. One
    search serves G1c's wr cycle (wr closed over ww/wr), G-single (rw
    closed over ww/wr — exactly one anti-dependency) and G2-item (rw
    closed over the full graph) so witness construction cannot drift
    between classes."""
    in_scc = set(scc)
    adj = _scc_subgraph(scc, src, dst, typ, path_types)
    pairs = sorted((int(src[e]), int(dst[e])) for e in range(len(src))
                   if int(typ[e]) == edge_type and int(src[e]) in in_scc
                   and int(dst[e]) in in_scc)
    for u, v in pairs:
        path = _bfs_path(adj, v, u)
        if path is not None:
            nodes = [u, v] + [w for w, _t in path[:-1]]
            edges = [EDGE_NAMES[edge_type]] + [EDGE_NAMES[t]
                                               for _w, t in path]
            return {"nodes": nodes, "edges": edges,
                    "rw-count": sum(1 for e in edges if e == "rw")}
    return None


def classify(graph: TxnGraph, requested, realtime: bool = False,
             sccs_by_tier: dict | None = None) -> dict:
    """Explain every nontrivial SCC with the strongest requested
    anomaly class its cycles witness (module docstring). ``sccs_by_tier``
    lets the device engine supply its own SCC decompositions per edge
    tier ({"ww": [...], "wwr": [...], "full": [...]}); absent tiers are
    computed here with :func:`tarjan`. Returns {anomaly: [witnesses]}."""
    requested = tuple(requested)
    src, dst, typ = graph.src, graph.dst, graph.typ
    rt_types = {RT} if realtime else set()
    sccs_by_tier = dict(sccs_by_tier or {})

    def tier_sccs(name, types):
        if name not in sccs_by_tier:
            m = np.isin(typ, list(types))
            sccs_by_tier[name] = tarjan(graph.n, src[m], dst[m])
        return sccs_by_tier[name]

    out: dict[str, list] = {}

    def add(kind, w):
        if w is not None and len(out.setdefault(kind, [])) < MAX_WITNESSES:
            out[kind].append(w)

    def saturated(kind):
        return len(out.get(kind, ())) >= MAX_WITNESSES

    ww_types = frozenset({WW} | rt_types)
    wwr_types = frozenset({WW, WR} | rt_types)
    full_types = frozenset({WW, WR, RW} | rt_types)

    # SCC node sets actually EXPLAINED under G0/G1c. The
    # strongest-explanation skip below is sound only for these: a
    # covering ww/wwr SCC whose class was not requested — or whose
    # cycles turned out ww-only under G1c — was never reported, so its
    # rw-bearing cycles must still be searched or a requested
    # G-single/G2-item (and the invalid verdict) would vanish.
    explained: set[tuple] = set()

    if "G0" in requested:
        for scc in tier_sccs("ww", ww_types):
            if saturated("G0"):
                # A ww-tier SCC is strongly connected via ww edges, so
                # its ww witness always exists — explained, just not
                # worth the O(E) search past the witness cap.
                explained.add(tuple(scc))
                continue
            w = witness_cycle(scc, src, dst, typ, ww_types)
            add("G0", w)
            if w is not None:
                explained.add(tuple(scc))
    if "G1c" in requested:
        for scc in tier_sccs("wwr", wwr_types):
            if saturated("G1c"):
                # Explained iff a wr edge cycles here (the witness
                # condition below) — an internal wr edge suffices, as
                # strong connectivity closes it.
                if _has_internal_edge(scc, src, dst, typ, WR):
                    explained.add(tuple(scc))
                continue
            w = witness_cycle(scc, src, dst, typ, wwr_types)
            # A ww-only minimal cycle in a wwr SCC is (possibly also)
            # a G0; it is G1c only when information flows — a wr edge
            # participates in some cycle of this SCC.
            if w is not None and "wr" not in w["edges"]:
                w = _closing_cycle(scc, src, dst, typ, WR, wwr_types)
            add("G1c", w)
            if w is not None:
                explained.add(tuple(scc))
    if "G-single" in requested or "G2-item" in requested:
        for scc in tier_sccs("full", full_types):
            if not (("G-single" in requested and not saturated("G-single"))
                    or ("G2-item" in requested
                        and not saturated("G2-item"))):
                break              # every requested rw class is capped
            # Strongest-explanation skip: an SCC whose node set is
            # exactly a ww/wwr SCC already reported under G0/G1c. A
            # bigger full-graph SCC may still add rw-bearing cycles,
            # so only skip exact matches.
            if tuple(scc) in explained:
                continue
            # A cycle with exactly ONE anti-dependency: the smallest
            # rw edge closed through ww/wr(/rt) only.
            single = _closing_cycle(scc, src, dst, typ, RW, wwr_types) \
                if "G-single" in requested else None
            if single is not None:
                add("G-single", single)
            elif "G2-item" in requested:
                # No single-rw cycle here, so any rw-closing cycle
                # carries >= 2 anti-dependencies (a 1-rw closure would
                # have been caught above) — the canonical G2 witness
                # closes the smallest rw edge through the full graph.
                add("G2-item", _closing_cycle(scc, src, dst, typ, RW,
                                              full_types))
    return out


def _witness_ops(graph: TxnGraph, anomalies: dict) -> None:
    """Attach op summaries to cycle witnesses in place (reporting)."""
    for kind, ws in anomalies.items():
        for w in ws:
            if isinstance(w, dict) and "nodes" in w and graph.txns:
                w["ops"] = [
                    {"index": graph.txns[i].op_index,
                     "process": graph.txns[i].process,
                     "ok": graph.txns[i].ok,
                     "mops": [list(m) for m in graph.txns[i].mops[:8]]}
                    for i in w["nodes"][:8]]


def resolve_anomalies(anomalies=None, consistency: str = "serializable",
                      realtime: bool | None = None):
    """(requested anomaly tuple, realtime flag) from checker options."""
    if anomalies is None:
        if consistency not in CONSISTENCY_MODELS:
            raise ValueError(
                f"unknown consistency model {consistency!r}; one of "
                f"{sorted(CONSISTENCY_MODELS)}")
        anomalies = CONSISTENCY_MODELS[consistency]
    if realtime is None:
        realtime = consistency == "strict-serializable"
    return tuple(anomalies), bool(realtime)


def check_graph(graph: TxnGraph, requested, realtime: bool = False,
                sccs_by_tier: dict | None = None) -> dict:
    """Verdict over an inferred graph: cycle classification + the
    inference-level direct anomalies, merged and filtered to the
    requested set."""
    found = classify(graph, requested, realtime=realtime,
                     sccs_by_tier=sccs_by_tier)
    for kind, ws in graph.anomalies.items():
        if kind in requested:
            found.setdefault(kind, ws)
    _witness_ops(graph, found)
    return {"valid?": not found,
            "analyzer": "txn-oracle",
            "anomaly-types": sorted(found),
            "anomalies": found,
            "stats": graph.stats}


def check(history, anomalies=None, consistency: str = "serializable",
          realtime: bool | None = None) -> dict:
    """Decide transactional consistency of a list-append history on the
    host — the semantic spec the device checker is parity-fuzzed
    against."""
    requested, rt = resolve_anomalies(anomalies, consistency, realtime)
    try:
        graph = infer(history, realtime=rt)
    except UnsupportedTxnHistory as e:
        return {"valid?": "unknown", "analyzer": "txn-oracle",
                "error": str(e)}
    out = check_graph(graph, requested, realtime=rt)
    out["consistency"] = consistency
    return out
