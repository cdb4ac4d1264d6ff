"""The transaction checker's port (``jepsen_tpu_torch.txn``) against the
JAX package's ``jepsen_tpu.txn``, on the CPU.

Both packages get the same inputs: histories from each package's own
synth with the same seeds (asserted equal first), and graphs made with
numpy. Each module is held against its counterpart bit for bit — the
oracle's inference, Tarjan and verdicts, pack's edge arrays and
fingerprint, and ``scc_program_plain`` against the reference's jitted
``_scc_program`` — and the whole slice, ``txn.check(algorithm="gpu",
device="cpu")``, against the reference's ``"tpu"`` and ``"cpu"`` checks:
verdict, anomaly types, witness cycles, fallbacks and every tier's stats.
The CUDA kernel itself runs only on the card (``chip_smoke.py --txn``).
"""

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import txn as jtxn
from jepsen_tpu.txn import device as jdevice
from jepsen_tpu.txn import oracle as joracle
from jepsen_tpu.txn import pack as jpack
from jepsen_tpu.txn import synth as jsynth
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import txn as ttxn
from jepsen_tpu_torch.history import Op as TOp
from jepsen_tpu_torch.txn import device as tdevice
from jepsen_tpu_torch.txn import oracle as toracle
from jepsen_tpu_torch.txn import pack as tpack
from jepsen_tpu_torch.txn import synth as tsynth

KINDS = ("G0", "G1c", "G-single", "G2-item", "G1a")
MODELS = tuple(sorted(toracle.CONSISTENCY_MODELS))
ALL = toracle.CYCLE_ANOMALIES


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    # The reference's quarantine ledger and both packages' snapshots go
    # to this test's own directory; torch's CPU pool spins at its
    # barriers on a loaded machine, so the plain loops run on one thread.
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    monkeypatch.setenv("JEPSEN_TPU_TXN_STATS", str(tmp_path / "stats.json"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dicts(h):
    return [op.to_dict() for op in h]


def _both(make):
    """The same history from each package's synth (asserted equal)."""
    jh, th = make(jsynth), make(tsynth)
    assert _dicts(jh) == _dicts(th)
    return jh, th


def _spliced(s, n_txns=2500):
    # txn_c30's shape (the reference's bench probe and its
    # test_5k_txn_parity) at n_txns transactions.
    h = s.generate_list_append_history(n_txns, concurrency=30, keys=32,
                                       seed=7, crash_prob=0.0005)
    h = s.splice_anomaly(h, "G2-item", seed=3, n=2)
    return s.splice_anomaly(h, "G-single", seed=5)


HISTORIES = {
    **{k: (lambda s, k=k: s.seeded_anomaly_history(k)) for k in KINDS},
    "healthy": lambda s: s.generate_list_append_history(120, seed=1),
    "crashed": lambda s: s.generate_list_append_history(
        200, concurrency=6, keys=4, seed=3, crash_prob=0.05),
    "spliced-300": lambda s: s.splice_anomaly(
        s.generate_list_append_history(300, seed=9), "G2-item", seed=9,
        n=2),
}


def _same_graph(a, b):
    assert a.n == b.n
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.typ, b.typ)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert a.anomalies == b.anomalies
    assert a.stats == b.stats


def _comparable(r):
    """A check result without what differs by design: the analyzer's
    name and the wall seconds."""
    r = json.loads(json.dumps(r, default=str))
    r.pop("analyzer", None)
    r.get("device-stats", {}).pop("seconds", None)
    return r


# --- synth ------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_synth_makes_the_same_histories(name):
    _both(HISTORIES[name])


def test_splice_makes_the_same_history_at_scale():
    jh, th = _both(_spliced)
    assert isinstance(th[0], TOp) and len(th) == len(jh)


# --- oracle -----------------------------------------------------------------

@pytest.mark.parametrize("realtime", [False, True])
@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_oracle_infer_matches(name, realtime):
    jh, th = _both(HISTORIES[name])
    _same_graph(joracle.infer(jh, realtime=realtime),
                toracle.infer(th, realtime=realtime))


def test_oracle_pairing_and_realtime_edges_match():
    jh, th = _both(HISTORIES["crashed"])
    jn, jf = joracle.pair_txns(jh)
    tn, tf = toracle.pair_txns(th)
    assert jf == tf
    assert [(t.idx, t.op_index, t.process, t.mops, t.ok, t.invoke_pos,
             t.return_pos) for t in jn] == \
        [(t.idx, t.op_index, t.process, t.mops, t.ok, t.invoke_pos,
          t.return_pos) for t in tn]
    assert joracle._realtime_edges(jn) == toracle._realtime_edges(tn)


def _random_edges(rng, n, e):
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_tarjan_matches(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 60))
    src, dst = _random_edges(rng, n, int(rng.integers(1, 3 * n)))
    assert toracle.tarjan(n, src, dst) == joracle.tarjan(n, src, dst)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kind", KINDS)
def test_oracle_check_matches(kind, model):
    jh, th = _both(HISTORIES[kind])
    want = joracle.check(jh, consistency=model)
    got = toracle.check(th, consistency=model)
    assert got == want
    assert ttxn.check(th, consistency=model, algorithm="cpu") == \
        jtxn.check(jh, consistency=model, algorithm="cpu")


def test_oracle_unsupported_history_and_unknown_model():
    bad = [TOp("invoke", "txn", [["inc", "x", 1]], 0)]
    assert toracle.check(bad)["valid?"] == "unknown"
    with pytest.raises(ValueError, match="unknown consistency model"):
        toracle.resolve_anomalies(None, "linearizable")


# --- pack -------------------------------------------------------------------

@pytest.mark.parametrize("realtime", [False, True])
@pytest.mark.parametrize("name", sorted(HISTORIES) + ["spliced-2500"])
def test_pack_matches(name, realtime):
    make = _spliced if name == "spliced-2500" else HISTORIES[name]
    jh, th = _both(make)
    want = jpack.pack(jh, realtime=realtime)
    got = tpack.pack(th, realtime=realtime)
    for a in ("edge_src", "edge_dst", "edge_typ"):
        x, y = getattr(want, a), getattr(got, a)
        assert x.dtype == y.dtype and np.array_equal(x, y), a
    assert (got.n, got.n_edges, got.realtime) == \
        (want.n, want.n_edges, want.realtime)
    assert got.fingerprint() == want.fingerprint()
    _same_graph(want.graph, got.graph)
    # infer_fast is the oracle's inference, vectorised.
    _same_graph(got.graph, toracle.infer(th, realtime=realtime))


def test_pack_from_graph_and_stats():
    _, th = _both(HISTORIES["G0"])
    g = toracle.infer(th)
    tpack.reset_pack_stats()
    pt = tpack.pack(graph=g)
    assert pt.graph is g and pt.n_edges == len(g.src)
    st = tpack.pack_stats()
    assert st["pack_calls"] == 1 and st["pack_s"] >= 0
    tpack.reset_pack_stats()
    assert tpack.pack_stats() == {"pack_s": 0.0, "pack_calls": 0}


# --- the SCC program --------------------------------------------------------

def _graph_case(kind, seed):
    """(src, dst, live, n, n_pad) of one SCC-program input, numpy."""
    rng = np.random.default_rng(seed)
    n_pad, e_pad = 256, 512
    if kind == "random":
        n = int(rng.integers(2, 200))
        e = int(rng.integers(1, e_pad))
        src, dst = _random_edges(rng, n, e)
    elif kind == "dense-cyclic":
        n = int(rng.integers(4, 120))
        ring = np.arange(n, dtype=np.int32)
        cs, cd = _random_edges(rng, n, 2 * n)
        src = np.concatenate([ring, cs])
        dst = np.concatenate([(ring + 1) % n, cd]).astype(np.int32)
    elif kind == "chain-back-edge":
        # A forward chain whose one back edge closes a cycle in the
        # middle: the tails trim one node a round from each end, and the
        # labels and flags walk the cycle.
        n_pad, e_pad = 1024, 1024
        n = int(rng.integers(600, 1000))
        src = np.arange(n - 1, dtype=np.int32)
        dst = src + 1
        a = int(rng.integers(1, n // 3))
        b = int(rng.integers(2 * n // 3, n - 1))
        src, dst = np.append(src, b), np.append(dst, a)
    elif kind == "one-cycle":
        n = 256
        src = np.arange(n, dtype=np.int32)
        dst = (src + 1) % n
    elif kind == "empty":
        n, src, dst = int(rng.integers(0, 50)), np.zeros(0, np.int32), \
            np.zeros(0, np.int32)
    else:
        raise ValueError(kind)
    e = len(src)
    pad = e_pad - e
    live = np.arange(e_pad) < e
    return (np.pad(src.astype(np.int32), (0, pad)),
            np.pad(dst.astype(np.int32), (0, pad)), live, n, n_pad)


GRAPHS = [("random", s) for s in range(4)] + \
    [("dense-cyclic", s) for s in range(3)] + \
    [("chain-back-edge", 0), ("chain-back-edge", 1), ("one-cycle", 0),
     ("empty", 0)]


@pytest.mark.parametrize("it_max", [1, 2, "auto"])
@pytest.mark.parametrize("kind,seed", GRAPHS)
def test_scc_program_plain_matches_jax(kind, seed, it_max):
    src, dst, live, n, n_pad = _graph_case(kind, seed)
    it = n + 8 if it_max == "auto" else it_max
    want = jdevice._scc_program(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(live), jnp.int32(n),
                                jnp.int32(it), n_pad=n_pad)
    got = tdevice.scc_program_plain(torch.from_numpy(src),
                                    torch.from_numpy(dst),
                                    torch.from_numpy(live), n, it,
                                    n_pad=n_pad)
    names = ("alive", "lab", "flag", "iters", "overflow")
    for name, w, g in zip(names, want, got):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    # The CPU route of scc_program is the plain version, and the int32
    # buffer a tier fetches in one copy decodes to the same five outputs.
    via = tdevice.scc_program(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(live), n, it, n_pad=n_pad)
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    buf = torch.cat([x.to(torch.int32) for x in via]).numpy()
    assert len(buf) == 3 * n_pad + 6
    for name, w, g in zip(names, want, tdevice._split(buf, n_pad)):
        assert np.array_equal(g, np.asarray(w)), name


def test_scc_program_cases_reach_their_regimes():
    # The chain trims for hundreds of rounds; a ceiling of 1 or 2
    # overflows it; the empty graph trims everything in one round.
    src, dst, live, n, n_pad = _graph_case("chain-back-edge", 0)
    args = (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(live))
    *_, iters, overflow = tdevice.scc_program_plain(*args, n, n + 8,
                                                    n_pad=n_pad)
    assert iters[0] > 100 and iters[1] > 100 and not overflow.any()
    *_, iters, overflow = tdevice.scc_program_plain(*args, n, 2,
                                                    n_pad=n_pad)
    assert iters[0] == 2 and overflow[0] and max(iters.tolist()) <= 2
    src, dst, live, n, n_pad = _graph_case("empty", 0)
    alive, *_, iters, overflow = tdevice.scc_program_plain(
        torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(live), n, 1, n_pad=n_pad)
    assert not alive.any() and iters[0] == 1


def test_scc_program_checks_its_arguments():
    src = torch.zeros(512, dtype=torch.int32)
    live = torch.zeros(512, dtype=torch.bool)
    with pytest.raises(ValueError, match="src must be"):
        tdevice.scc_program(src.long(), src, live, 1, 9, n_pad=256)
    with pytest.raises(ValueError, match="live must be"):
        tdevice.scc_program(src, src, live.int(), 1, 9, n_pad=256)
    with pytest.raises(ValueError, match="0 <= n <= n_pad"):
        tdevice.scc_program(src, src, live, 300, 9, n_pad=256)


def test_module_constants_match():
    assert (tdevice.MIN_NODE_PAD, tdevice.MIN_EDGE_PAD) == \
        (jdevice.MIN_NODE_PAD, jdevice.MIN_EDGE_PAD)
    assert tdevice.TIER_TYPES == jdevice.TIER_TYPES
    assert tdevice.ANOMALY_TIERS == jdevice.ANOMALY_TIERS
    assert toracle.CONSISTENCY_MODELS == joracle.CONSISTENCY_MODELS
    for n in (0, 1, 255, 256, 257, 5000):
        assert tdevice._bucket(n, 256) == jdevice._bucket(n, 256)
        assert tdevice.it_max_for(n) == jdevice.it_max_for(n)
    assert tdevice.cpu_max_edges() == jdevice.cpu_max_edges()


def test_knobs_are_read_per_call(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_TXN_IT_MAX", "3")
    monkeypatch.setenv("JEPSEN_TPU_TXN_CPU_MAX", "7")
    assert tdevice.it_max_for(100) == jdevice.it_max_for(100) == 3
    assert tdevice.cpu_max_edges() == jdevice.cpu_max_edges() == 7
    monkeypatch.delenv("JEPSEN_TPU_TXN_STATS")
    assert tdevice.stats_path() == jdevice.stats_path()


# --- the whole slice --------------------------------------------------------

def _check_both(make, **kw):
    jh, th = _both(make)
    want = jtxn.check(jh, algorithm="tpu", **kw)
    got = ttxn.check(th, algorithm="gpu", device="cpu", **kw)
    assert got["analyzer"] == "txn-gpu" and want["analyzer"] == "txn-tpu"
    assert _comparable(got) == _comparable(want)
    oracle = jtxn.check(jh, algorithm="cpu", **kw)
    assert got["valid?"] == oracle["valid?"]
    assert got["anomaly-types"] == oracle["anomaly-types"]
    assert json.loads(json.dumps(got["anomalies"], default=str)) == \
        json.loads(json.dumps(oracle["anomalies"], default=str))
    return got


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("kind", KINDS)
def test_check_matches_jax_on_seeded_corpora(kind, model):
    got = _check_both(HISTORIES[kind], consistency=model)
    proscribed = toracle.CONSISTENCY_MODELS[model]
    assert (got["valid?"] is False) == (kind in proscribed)


@pytest.mark.parametrize("name", ["healthy", "crashed", "spliced-300"])
def test_check_matches_jax_on_generated_histories(name):
    got = _check_both(HISTORIES[name])
    if name == "healthy":
        assert got["valid?"] is True
        assert all(t.get("short_circuit") == "forward-order"
                   for t in got["device-stats"]["tiers"].values())


def test_check_matches_jax_on_spliced_2500():
    got = _check_both(_spliced, consistency="serializable")
    assert got["valid?"] is False
    assert got["anomaly-types"] == ["G-single", "G2-item"]
    full = got["device-stats"]["tiers"]["full"]
    assert full["device"] and full["iterations"][0] > 100
    assert "fallbacks" not in got
    for tier in ("ww", "wwr"):
        assert got["device-stats"]["tiers"][tier]["short_circuit"] == \
            "forward-order"


def _sequential(h, proc, mops, obs=None):
    h.append(TOp("invoke", "txn", [list(m) for m in mops], proc))
    h.append(TOp("ok", "txn", [list(m) for m in (obs or mops)], proc))


def _rt_polluted_g0():
    # Sequential txns (an rt chain T0->T1->T2->T3) whose reads pin a G0
    # cycle T1<->T2 and a ww back edge T2->T0: with rt edges in the
    # tiers the SCC grows past the ww cycle (the reference's regression
    # history for realtime-packed serializable checks).
    h = []
    _sequential(h, 0, [["append", "c", 30]])
    _sequential(h, 1, [["append", "a", 10], ["append", "b", 11]])
    _sequential(h, 2, [["append", "a", 20], ["append", "b", 21],
                       ["append", "c", 31]])
    _sequential(h, 3, [["r", "a", None], ["r", "b", None],
                       ["r", "c", None]],
                [["r", "a", [10, 20]], ["r", "b", [21, 11]],
                 ["r", "c", [31, 30]]])
    return h


def _to_jax_ops(h):
    from jepsen_tpu.history import Op

    return [Op.from_dict(o.to_dict()) for o in h]


def test_realtime_packed_checked_serializable_matches_jax():
    th = _rt_polluted_g0()
    jh = _to_jax_ops(th)
    tpt = tpack.pack(th, realtime=True)
    jpt = jpack.pack(jh, realtime=True)
    for model in ("serializable", "strict-serializable"):
        got = tdevice.check_packed(tpt, consistency=model, snapshot=False,
                                   device="cpu")
        want = jdevice.check_packed(jpt, consistency=model, snapshot=False)
        assert _comparable(got) == _comparable(want)
    got = tdevice.check_packed(tpt, consistency="serializable",
                               snapshot=False, device="cpu")
    assert got["valid?"] is False and "G0" in got["anomaly-types"]
    # Realtime requested of a history packed without rt edges: unknown.
    plain = tpack.pack(th)
    r = tdevice.check_packed(plain, consistency="strict-serializable",
                             snapshot=False, device="cpu")
    assert r["valid?"] == "unknown" and r["analyzer"] == "txn-gpu"


def _cyclic_graph(lib):
    return lib.TxnGraph(n=6, src=np.asarray([0, 3, 1, 4], np.int32),
                        dst=np.asarray([3, 0, 4, 1], np.int32),
                        typ=np.asarray([lib.WW] * 4, np.int8))


@pytest.mark.parametrize("source", ["cyclic-graph", "spliced-300"])
def test_iteration_ceiling_falls_back_to_host_tarjan(monkeypatch, source):
    monkeypatch.setenv("JEPSEN_TPU_TXN_IT_MAX", "1")
    if source == "cyclic-graph":
        want = jdevice.check_packed(jpack.pack(graph=_cyclic_graph(joracle)),
                                    anomalies=ALL, snapshot=False)
        got = tdevice.check_packed(tpack.pack(graph=_cyclic_graph(toracle)),
                                   anomalies=ALL, snapshot=False,
                                   device="cpu")
    else:
        jh, th = _both(HISTORIES[source])
        want = jtxn.check(jh, algorithm="tpu")
        got = ttxn.check(th, algorithm="gpu", device="cpu")
    assert _comparable(got) == _comparable(want)
    assert got["valid?"] is False
    assert got["fallbacks"] and all(v == "overflow: budget"
                                    for v in got["fallbacks"].values())
    assert got["device-stats"]["overflows"] == len(got["fallbacks"])
    assert got["device-stats"]["cpu_tiers"] == len(got["fallbacks"])


def test_cpu_bound_reports_honest_unknown(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_TXN_IT_MAX", "1")
    monkeypatch.setenv("JEPSEN_TPU_TXN_CPU_MAX", "0")
    want = jdevice.check_packed(jpack.pack(graph=_cyclic_graph(joracle)),
                                anomalies=ALL, snapshot=False)
    got = tdevice.check_packed(tpack.pack(graph=_cyclic_graph(toracle)),
                               anomalies=ALL, snapshot=False, device="cpu")
    assert got["valid?"] == "unknown" == want["valid?"]
    assert "JEPSEN_TPU_TXN_CPU_MAX" in got["error"]
    assert _comparable(got) == _comparable(want)


def test_random_graphs_match_jax_device_check():
    rng = random.Random(42)
    for i in range(12):
        n = rng.randrange(2, 40)
        es = [(rng.randrange(n), rng.randrange(n),
               rng.choice((toracle.WR, toracle.WW, toracle.RW)))
              for _ in range(rng.randrange(1, 120))]
        es = [e for e in es if e[0] != e[1]]

        def graph(lib):
            return lib.TxnGraph(
                n=n, src=np.asarray([e[0] for e in es], np.int32),
                dst=np.asarray([e[1] for e in es], np.int32),
                typ=np.asarray([e[2] for e in es], np.int8))

        want = jdevice.check_packed(jpack.pack(graph=graph(joracle)),
                                    anomalies=ALL, snapshot=False)
        got = tdevice.check_packed(tpack.pack(graph=graph(toracle)),
                                   anomalies=ALL, snapshot=False,
                                   device="cpu")
        assert _comparable(got) == _comparable(want), i
        assert got["anomalies"] == toracle.check_graph(graph(toracle),
                                                       ALL)["anomalies"]


def test_snapshot_written_like_the_reference(monkeypatch, tmp_path):
    jh, th = _both(HISTORIES["G0"])
    monkeypatch.setenv("JEPSEN_TPU_TXN_STATS", str(tmp_path / "j.json"))
    jtxn.check(jh, algorithm="tpu")
    monkeypatch.setenv("JEPSEN_TPU_TXN_STATS", str(tmp_path / "t.json"))
    r = ttxn.check(th, algorithm="gpu", device="cpu")
    assert r["valid?"] is False
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert sorted(got) == sorted(want)
    for snap in (want, got):
        snap.pop("updated")
        snap["device"].pop("seconds")
    assert got == want
    assert got["anomaly_counts"] == {"G0": 1}
    # No snapshot when the path is empty, nor with snapshot=False.
    (tmp_path / "t.json").unlink()
    monkeypatch.setenv("JEPSEN_TPU_TXN_STATS", "")
    ttxn.check(th, algorithm="gpu", device="cpu")
    monkeypatch.setenv("JEPSEN_TPU_TXN_STATS", str(tmp_path / "t.json"))
    tdevice.check_packed(tpack.pack(th), snapshot=False, device="cpu")
    assert not (tmp_path / "t.json").exists()


# --- entry points -----------------------------------------------------------

def test_txn_cycles_checker_wiring():
    jh, th = _both(HISTORIES["G2-item"])
    for model in ("serializable", "snapshot-isolation"):
        ck = tchecker.txn_cycles(consistency=model, device="cpu")
        assert ck.is_txn_cycles and ck.algorithm == "gpu"
        got = ck.check(None, None, th)
        from jepsen_tpu import checker as jchecker

        want = jchecker.txn_cycles(consistency=model).check(None, None, jh)
        assert _comparable(got) == _comparable(want)
    cpu = tchecker.txn_cycles(algorithm="cpu")
    assert cpu.check(None, None, th) == joracle.check(jh)
    ck = tchecker.txn_cycles(anomalies=("G0",), device="cpu")
    assert ck.check(None, None, th)["valid?"] is True


def test_no_card_means_the_card_and_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, th = _both(HISTORIES["healthy"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttxn.check(th)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tchecker.txn_cycles().check(None, None, th)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.check_packed(tpack.pack(th))
    with pytest.raises(ValueError, match="unknown txn algorithm"):
        ttxn.check(th, algorithm="tpu", device="cpu")


def test_unsupported_history_is_unknown_on_both_routes():
    bad = [TOp("invoke", "txn", [["inc", "x", 1]], 0)]
    r = ttxn.check(bad, device="cpu")
    assert r["valid?"] == "unknown" and r["analyzer"] == "txn-pack"
    assert jtxn.check(_to_jax_ops(bad))["analyzer"] == "txn-pack"


def test_the_kernel_counts_launches_only_on_the_card():
    _, th = _both(HISTORIES["G0"])
    before = tdevice.LAUNCHES
    ttxn.check(th, device="cpu")
    assert tdevice.LAUNCHES == before


def test_a_failed_kernel_build_raises(monkeypatch, tmp_path):
    # No fallback: a build that fails raises with the compiler's exit, and
    # nothing is loaded.
    import shutil

    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.txn import scc_cuda

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: shutil.which("false"))
    monkeypatch.setattr(scc_cuda, "_lib", None)
    with pytest.raises(RuntimeError, match="txn_scc: false exit 1"):
        scc_cuda.grid(512, 256)
    assert scc_cuda._lib is None and "txn_scc" not in _build._libs


def test_isolation_test_covers_the_txn_package():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).with_name("test_torch_isolation.py")
    spec = importlib.util.spec_from_file_location("_isolation", path)
    iso = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(iso)
    mods = set(iso._port_modules())
    assert {"jepsen_tpu_torch.txn", "jepsen_tpu_torch.txn.oracle",
            "jepsen_tpu_torch.txn.pack", "jepsen_tpu_torch.txn.synth",
            "jepsen_tpu_torch.txn.device",
            "jepsen_tpu_torch.txn.scc_cuda"} <= mods


@pytest.mark.slow
def test_txn_c30_matches_jax():
    # The reference's bench probe txn_c30 at its full size: 50,000
    # transactions, the full tier on the device.
    got = _check_both(lambda s: _spliced(s, 50_000),
                      consistency="serializable")
    assert got["anomaly-types"] == ["G-single", "G2-item"]
    assert {k: len(v) for k, v in got["anomalies"].items()} == \
        {"G-single": 1, "G2-item": 2}
    full = got["device-stats"]["tiers"]["full"]
    assert full["window"] == [15613, 40845]
    assert (full["window_edges"], full["core"], full["device_sccs"],
            full["residue"], full["iterations"], full["n_pad"],
            full["e_pad"]) == (91370, 6, 3, 0, [2734, 2, 2], 32768, 131072)
