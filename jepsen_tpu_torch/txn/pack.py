"""Host-side packing for the transaction dependency-graph checker.

The port's copy of the JAX package's ``txn/pack.py``: the same edge
order, dtypes and fingerprint; its ``pack-txn`` trace span is not
carried over (the port has no tracer yet). Converts a list-append
history (vector of ``txn`` ops whose values are micro-op lists,
:mod:`jepsen_tpu_torch.txn.oracle`) into the dense int-array form the
device SCC engine consumes — the :mod:`jepsen_tpu_torch.lin.prepare` role
for the transactional workload family, following its conventions:

- **Pairing / indeterminacy**: ``fail`` txns are dropped (their appends
  kept only to convict G1a reads); ``info`` txns stay with their
  invocation micro-ops and contribute writes only when observed
  (recoverable-write rule) — the ``:info``-completion contract of the
  wire suites (an op that may have applied must constrain, not be
  assumed away).
- ``edge_src/edge_dst/edge_typ`` — the inferred dependency edges
  (``oracle.WR/WW/RW/RT``), deduplicated, sorted by (src, dst, typ):
  the flat arrays the device SCC program's scatter formulation consumes
  directly (it builds no CSR — degree counts and label propagation are
  ``at[].add/min/max`` scatters over these).

**Fast edge inference** (:func:`infer_fast`): the
device path's wall clock at the 100k-op scale is INFERENCE-bound —
``oracle.infer``'s per-read per-ELEMENT Python loop is
O(total observed elements), quadratic-ish in history length for
list-append reads that observe their key's whole growing list
(~1 s per 1k txns measured). :func:`infer_fast` replaces exactly that
loop with numpy over the per-key version-order columns: each read's
prefix check is one vectorized compare against the key's longest
observed order, and the per-element anomaly/writer lookups collapse
to per-key precomputed position arrays + ``searchsorted`` counts.
Reads that fail the prefix check (the ``incompatible-order`` anomaly,
rare by construction) and non-numeric value domains take the oracle's
literal per-element path, so the output — edge set, anomaly
witnesses (order included), and stats — is BYTE-IDENTICAL to
``oracle.infer``, which stays the parity spec (``algorithm="cpu"``
runs it end to end; equality with the JAX package's inference is held
in tests/test_torch_txn.py).

The graph inference semantics live in :mod:`jepsen_tpu_torch.txn.oracle` —
pack is a codec plus a faithful vectorization of the oracle's
inference, never a second set of rules.
"""

from __future__ import annotations

import hashlib
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from jepsen_tpu_torch.txn import oracle
from jepsen_tpu_torch.txn.oracle import RT, RW, WR, WW

# Pack-wall accounting (cumulative seconds and calls this process),
# the lin/prepare _pack_stats convention.
_pack_stats = {"pack_s": 0.0, "pack_calls": 0}


def pack_stats() -> dict:
    """Snapshot of cumulative txn packing wall this process (seconds)."""
    return dict(_pack_stats)


def reset_pack_stats() -> None:
    for k in _pack_stats:
        _pack_stats[k] = 0.0 if k.endswith("_s") else 0


@dataclass
class PackedTxnHistory:
    """Dense arrays driving the device SCC search; module docstring."""

    graph: oracle.TxnGraph
    n: int                       # transactions (graph nodes)
    edge_src: np.ndarray         # i32[E]
    edge_dst: np.ndarray         # i32[E]
    edge_typ: np.ndarray         # i8[E]
    realtime: bool = False

    @property
    def n_edges(self) -> int:
        return int(len(self.edge_src))

    def fingerprint(self) -> str:
        """Identity of the packed graph (the supervise checkpoint /
        ledger convention: same shape+content -> same key)."""
        h = hashlib.sha256()
        h.update(f"txn|{self.n}|{self.n_edges}|{self.realtime}".encode())
        for a in (self.edge_src, self.edge_dst, self.edge_typ):
            arr = np.ascontiguousarray(np.asarray(a))
            h.update(str(arr.shape).encode())
            h.update(arr.tobytes())
        return h.hexdigest()


class _KeyInfo:
    """Per-key precomputation over the longest observed order (module
    docstring): writer per position, anomaly positions/entries, and
    duplicate positions — everything the oracle's per-element read
    loop looks up, hoisted so a prefix-verified read costs
    O(log) searchsorted counts instead of O(len(obs)) Python.

    When the key's order, written values, and failed values are all
    lossless ints (the dtype gate below), the construction itself is
    vectorized: the per-position writer lookup
    becomes one searchsorted join against the key's write column, the
    duplicate scan one stable sort, and the G1a/garbage split one more
    join against the failed column — the last linear-Python pass over
    version orders. Witness entries still carry the ORIGINAL history
    objects (JSON-safe over the wire), materialized per anomaly entry
    only."""

    __slots__ = ("arr", "fast", "warr", "warr_a", "g1a_pos", "g1a_ent",
                 "never_pos", "never_ent", "dup_pos", "dup_ent")

    def __init__(self, k, order, writer, failed, kw=None, kf=None):
        # Lossless-int gate: np.asarray infers the dtype, so a float
        # (1.5), bool, mixed, or bignum order comes back non-"iu" and
        # the key's reads take the oracle's literal path — fromiter
        # with a forced int64 would silently TRUNCATE 1.5 -> 1 and
        # mask exactly the corrupt reads the checker exists to catch.
        arr = np.asarray(order)
        if arr.dtype.kind in "iu" and kw is not None and kf is not None:
            wv = kw[0] if kw else ()
            fv = kf[0] if kf else ()
            va = np.asarray(wv) if len(wv) else np.zeros(0, np.int64)
            fa = np.asarray(fv) if len(fv) else np.zeros(0, np.int64)
            # The dict paths compare with Python ==, so the write and
            # failed columns must be lossless ints too (True == 1,
            # 1.0 == 1: a "b"/"f"/"O" column falls back to the spec
            # loop rather than risk a dtype-coerced false join).
            if va.dtype.kind in "iu" and fa.dtype.kind in "iu":
                self._init_vec(k, order, arr, kw, kf, failed)
                return
        if arr.dtype.kind in "iu":
            self.arr = arr.astype(np.int64)
            self.fast = True
        else:
            self.arr = None
            self.fast = False
        self.warr = [writer.get((k, v)) for v in order]
        self.warr_a = None
        g1a_pos: list = []
        g1a_ent: list = []
        never_pos: list = []
        never_ent: list = []
        dup_pos: list = []
        dup_ent: list = []
        seen: set = set()
        for p, v in enumerate(order):
            if v in seen:
                dup_pos.append(p)
                dup_ent.append(v)
            seen.add(v)
            if (k, v) not in writer:
                if (k, v) in failed:
                    g1a_pos.append(p)
                    g1a_ent.append((v, failed[(k, v)]))
                else:
                    never_pos.append(p)
                    never_ent.append(v)
        self.g1a_pos = np.asarray(g1a_pos, np.int64)
        self.g1a_ent = g1a_ent
        self.never_pos = np.asarray(never_pos, np.int64)
        self.never_ent = never_ent
        self.dup_pos = np.asarray(dup_pos, np.int64)
        self.dup_ent = dup_ent

    def _init_vec(self, k, order, arr, kw, kf, failed):
        self.fast = True
        oa = arr.astype(np.int64)
        self.arr = oa
        self.warr = None
        m = len(oa)
        wid = np.full(m, -1, np.int64)
        if kw[0]:
            va = np.asarray(kw[0]).astype(np.int64)
            ia = np.asarray(kw[1], np.int64)
            sv = np.argsort(va, kind="stable")
            svals = va[sv]
            sids = ia[sv]
            pos = np.searchsorted(svals, oa)
            inb = pos < len(svals)
            hit = np.zeros(m, bool)
            hit[inb] = svals[pos[inb]] == oa[inb]
            wid[hit] = sids[pos[hit]]
        self.warr_a = wid
        # Duplicates: for equal values the stable sort keeps position
        # order, so all but the first of each run are the dups.
        so = np.argsort(oa, kind="stable")
        svo = oa[so]
        dm = np.zeros(m, bool)
        dm[1:] = svo[1:] == svo[:-1]
        dup_p = np.sort(so[dm])
        # Unwritten positions split into failed (G1a) vs never-written.
        miss = np.flatnonzero(wid < 0)
        g1a_m = np.zeros(len(miss), bool)
        if kf[0] and len(miss):
            fva = np.asarray(kf[0]).astype(np.int64)
            sfv = np.sort(fva)
            ov = oa[miss]
            fpos = np.searchsorted(sfv, ov)
            finb = fpos < len(sfv)
            g1a_m[finb] = sfv[fpos[finb]] == ov[finb]
        g1a_p = miss[g1a_m]
        never_p = miss[~g1a_m]
        self.g1a_pos = g1a_p
        self.never_pos = never_p
        self.dup_pos = dup_p
        self.g1a_ent = [(order[p], failed[(k, order[p])])
                        for p in g1a_p.tolist()]
        self.never_ent = [order[p] for p in never_p.tolist()]
        self.dup_ent = [order[p] for p in dup_p.tolist()]

    def wid(self, p):
        """Writer txn id at order position p, or None (the oracle's
        ``writer.get`` contract), from whichever column form exists."""
        if self.warr_a is not None:
            w = int(self.warr_a[p])
            return None if w < 0 else w
        return self.warr[p]


def infer_fast(history=None, nodes=None, failed=None,
               realtime: bool = False) -> oracle.TxnGraph:
    """Numpy-vectorized twin of :func:`oracle.infer` (module
    docstring): identical edge set, anomaly witnesses, and stats —
    held in tests/test_torch_txn.py — with the per-read
    per-element Python loop replaced by one vectorized prefix compare
    plus per-key precomputed anomaly columns. Reads that are not a
    prefix of their key's longest order (or whose values defeat the
    int columns) run the oracle's literal per-element path, so exotic
    histories degrade to spec behaviour, never to different
    answers."""
    from jepsen_tpu_torch.txn.oracle import EDGE_NAMES, MAX_WITNESSES

    if nodes is None:
        nodes, failed = oracle.pair_txns(history)
    failed = failed or {}
    n = len(nodes)

    # --- append pass (verbatim oracle.infer) ----------------------
    writer: dict = {}
    dupes_w: list = []          # append-duplicate witnesses (full —
    dup_count = 0               # bounded by the append count)
    appends_per_key: dict = defaultdict(int)
    per_key_w: dict = defaultdict(lambda: ([], []))  # k -> (vals, ids)
    for t in nodes:
        for f, k, v in t.mops:
            if f != "append":
                continue
            appends_per_key[k] += 1
            if (k, v) in writer and writer[(k, v)] != t.idx:
                dupes_w.append({"key": k, "value": v,
                                "txns": [writer[(k, v)], t.idx]})
                dup_count += 1
            else:
                if (k, v) not in writer:       # first-occurrence column
                    kw = per_key_w[k]
                    kw[0].append(v)
                    kw[1].append(t.idx)
                writer[(k, v)] = t.idx
    failed_by_key: dict = defaultdict(lambda: ([], []))
    for (fk, fv), fidx in failed.items():
        kf = failed_by_key[fk]
        kf[0].append(fv)
        kf[1].append(fidx)

    longest: dict = {}
    reads: list = []
    for t in nodes:
        if not t.ok:
            continue
        for f, k, v in t.mops:
            if f != "r" or v is None:
                continue
            obs = tuple(v)
            reads.append((t.idx, k, obs))
            if len(obs) > len(longest.get(k, ())):
                longest[k] = obs

    es: list = []
    ed: list = []
    et: list = []

    def edge(a, b, ty):
        if a != b:
            es.append(a)
            ed.append(b)
            et.append(ty)

    # --- unobserved committed appends + ww (verbatim) -------------
    unobserved: dict = defaultdict(list)
    ok_txn = {t.idx for t in nodes if t.ok}
    observed_vals = {k: set(order) for k, order in longest.items()}
    for (k, v), w in writer.items():
        if w in ok_txn and v not in observed_vals.get(k, ()):
            unobserved[k].append(w)

    # The version-order WW join, vectorized: per key the
    # writer lookups are one searchsorted join (_KeyInfo.warr_a) and
    # the chain edges one pairwise pass over the present writers —
    # identical to the per-element loop, which non-int keys still run.
    observed = 0
    keyinfo: dict = {}
    for k, order in longest.items():
        ki = keyinfo[k] = _KeyInfo(k, order, writer, failed,
                                   per_key_w.get(k, ((), ())),
                                   failed_by_key.get(k, ((), ())))
        if ki.warr_a is not None:
            idx = np.flatnonzero(ki.warr_a >= 0)
            observed += len(idx)
            if len(idx):
                a = ki.warr_a[idx]
                keep = a[:-1] != a[1:]
                es.extend(a[:-1][keep].tolist())
                ed.extend(a[1:][keep].tolist())
                et.extend([WW] * int(keep.sum()))
                prev = int(a[-1])
                for w in unobserved.get(k, ()):
                    edge(prev, w, WW)
            continue
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

    # --- per-read pass: vectorized prefix path --------------------
    incompatible: list = []
    g1a_w: list = []
    never_w: list = []
    g1a_count = never_count = 0

    def take_witnesses(out, pos, ent, limit, make):
        if len(out) >= MAX_WITNESSES:
            return
        for p, e in zip(pos, ent):
            if p >= limit or len(out) >= MAX_WITNESSES:
                break
            out.append(make(e))

    for i, k, obs in reads:
        order = longest.get(k, ())
        L = len(obs)
        ki = keyinfo.get(k)
        if ki is None:
            ki = keyinfo[k] = _KeyInfo(k, order, writer, failed,
                                       per_key_w.get(k, ((), ())),
                                       failed_by_key.get(k, ((), ())))
        fast = False
        if L == 0:
            fast = True
        elif ki.fast:
            # Same lossless-int gate as _KeyInfo: dtype inference,
            # never a forced cast (a float/bool/bignum element must
            # fail to the literal path, not truncate into a false
            # prefix match).
            obs_arr = np.asarray(obs)
            fast = obs_arr.dtype.kind in "iu" \
                and bool(np.array_equal(obs_arr.astype(np.int64),
                                        ki.arr[:L]))
        if fast:
            # obs is a verified prefix of the longest order: every
            # element-level lookup collapses to the precomputed
            # per-key columns.
            c = int(np.searchsorted(ki.g1a_pos, L))
            if c:
                g1a_count += c
                take_witnesses(
                    g1a_w, ki.g1a_pos, ki.g1a_ent, L,
                    lambda e, k=k, i=i: {
                        "key": k, "value": e[0], "txn": i,
                        "failed-op-index": e[1]})
            c = int(np.searchsorted(ki.never_pos, L))
            if c:
                never_count += c
                take_witnesses(
                    never_w, ki.never_pos, ki.never_ent, L,
                    lambda e, k=k, i=i: {"key": k, "value": e,
                                         "txn": i})
            c = int(np.searchsorted(ki.dup_pos, L))
            if c:
                dup_count += c
                take_witnesses(
                    dupes_w, ki.dup_pos, ki.dup_ent, L,
                    lambda e, k=k, i=i: {"key": k, "value": e,
                                         "txns": [i],
                                         "kind": "read-duplicate"})
            if L:
                w = ki.wid(L - 1)
                if w is not None:
                    edge(w, i, WR)
            if L < len(order):
                nxt = ki.wid(L)
                if nxt is not None:
                    edge(i, nxt, RW)
            else:               # obs == order (verified prefix, full)
                for w in unobserved.get(k, ()):
                    edge(i, w, RW)
            continue
        # --- the oracle's literal per-element path (mismatching or
        # non-numeric reads — the incompatible-order anomaly class).
        if obs != order[:L]:
            incompatible.append(
                {"key": k, "txn": i, "observed": list(obs),
                 "longest": list(order)})
        seen: set = set()
        for v in obs:
            if v in seen:
                dup_count += 1
                if len(dupes_w) < MAX_WITNESSES:
                    dupes_w.append({"key": k, "value": v, "txns": [i],
                                    "kind": "read-duplicate"})
            seen.add(v)
            if (k, v) not in writer:
                if (k, v) in failed:
                    g1a_count += 1
                    if len(g1a_w) < MAX_WITNESSES:
                        g1a_w.append(
                            {"key": k, "value": v, "txn": i,
                             "failed-op-index": failed[(k, v)]})
                else:
                    never_count += 1
                    if len(never_w) < MAX_WITNESSES:
                        never_w.append({"key": k, "value": v,
                                        "txn": i})
        if obs:
            w = writer.get((k, obs[-1]))
            if w is not None:
                edge(w, i, WR)
        if L < len(order):
            nxt = writer.get((k, order[L]))
            if nxt is not None:
                edge(i, nxt, RW)
        elif obs == order:
            for w in unobserved.get(k, ()):
                edge(i, w, RW)

    if realtime:
        for a, b in oracle._realtime_edges(nodes):
            edge(a, b, RT)

    if es:
        e = np.unique(np.stack([np.asarray(es, np.int64),
                                np.asarray(ed, np.int64),
                                np.asarray(et, np.int64)], axis=1),
                      axis=0)
        src, dst, typ = (e[:, 0].astype(np.int32),
                         e[:, 1].astype(np.int32),
                         e[:, 2].astype(np.int8))
    else:
        src = np.zeros(0, np.int32)
        dst = np.zeros(0, np.int32)
        typ = np.zeros(0, np.int8)

    anomalies = {}
    if g1a_count:
        anomalies["G1a"] = g1a_w[:MAX_WITNESSES]
    if never_count:
        anomalies["garbage-read"] = never_w[:MAX_WITNESSES]
    if dup_count:
        anomalies["duplicate-elements"] = dupes_w[:MAX_WITNESSES]
    if incompatible:
        anomalies["incompatible-order"] = incompatible[:MAX_WITNESSES]
    counts = {EDGE_NAMES[t]: int((typ == t).sum())
              for t in (WR, WW, RW, RT)}
    stats = {"txns": n, "ok_txns": sum(1 for t in nodes if t.ok),
             "info_txns": sum(1 for t in nodes if not t.ok),
             "keys": len(appends_per_key), "reads": len(reads),
             "appends": sum(appends_per_key.values()),
             "observed_appends": observed,
             "edges": int(len(src)), "edge_counts": counts,
             "g1a": g1a_count, "garbage": never_count,
             "duplicates": dup_count,
             "incompatible": len(incompatible)}
    return oracle.TxnGraph(n=n, src=src, dst=dst, typ=typ, txns=nodes,
                           anomalies=anomalies, stats=stats)


def pack(history=None, graph: oracle.TxnGraph | None = None,
         realtime: bool = False) -> PackedTxnHistory:
    """Pack a list-append history (or a pre-inferred graph) for the
    device checker. Inference runs through :func:`infer_fast` (the
    oracle-identical vectorization); ``algorithm="cpu"`` checks keep
    running ``oracle.infer`` end to end, so the parity leg never
    shares this code."""
    t0 = time.perf_counter()
    if graph is None:
        graph = infer_fast(history, realtime=realtime)

    src, dst, typ = graph.src, graph.dst, graph.typ
    order = np.lexsort((typ, dst, src)) if len(src) else \
        np.zeros(0, np.int64)
    out = PackedTxnHistory(
        graph=graph, n=graph.n,
        edge_src=src[order].astype(np.int32),
        edge_dst=dst[order].astype(np.int32),
        edge_typ=typ[order].astype(np.int8),
        realtime=realtime)
    _pack_stats["pack_s"] += time.perf_counter() - t0
    _pack_stats["pack_calls"] += 1
    return out
