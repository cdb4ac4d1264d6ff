"""The port's device packer on the CPU (``device="cpu"``) against the JAX
package's ``pack_dev`` (JAX on the CPU) and against the port's host pack:
the same tables, reduction tables, fingerprints, errors and routing, on
the shapes of the JAX package's device-packer parity, batch and error
cases (at smaller sizes)."""

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.lin import pack_dev as jpd
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import dense as tdense
from jepsen_tpu_torch.lin import pack_dev as tpd
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth

JAX = (jh, jm, jsynth)
PORT = (th, tm, tsynth)
TABLES = ("ret_slot", "ret_op", "active", "slot_f", "slot_v", "slot_op",
          "crashed", "init_state")
OP_KEYS = ("op_index", "process", "f", "value", "ok", "invoke_pos",
           "return_pos")


@pytest.fixture(autouse=True)
def _knobs(monkeypatch, tmp_path):
    # The test settings turn the JAX package's device packer off; these
    # tests compare it, so its knob is on. Its supervision keeps its
    # quarantine file here.
    monkeypatch.setenv("JEPSEN_TPU_PACK_DEV", "1")
    monkeypatch.setenv("JEPSEN_TPU_QUARANTINE", str(tmp_path / "q.json"))
    for k in ("JEPSEN_TPU_FAST_PACK", "JEPSEN_TPU_NATIVE_PACK",
              "JEPSEN_TPU_PACK_DEV_MIN_K"):
        monkeypatch.delenv(k, raising=False)
    torch.set_num_threads(1)
    jpd.reset_dev_stats()
    tpd.reset_dev_stats()


def _set_without_kernel(H):
    # A nil add leaves the set model without a packed formulation.
    return H.History.of(H.invoke_op(0, "add", None), H.ok_op(0, "add", None),
                        H.invoke_op(1, "read", None),
                        H.ok_op(1, "read", []))


def _mix(P, s):
    return P[2].generate_register_history(
        600, concurrency=7, seed=s, crash_prob=0.02, max_crashes=9)


# name -> (model name, history builder over (history, models, synth)).
# Each JAX shape bucket compiles once (a few seconds on one core), so the
# seeds are chosen to share buckets: the partitioned pair (1024, 512, 64),
# the crash mixes (1024, 512, 16), the mutexes (256, 128, 16).
SINGLE = {
    **{f"partitioned-cas-{s}": ("cas_register", lambda P, s=s:
        P[2].generate_partitioned_register_history(
            700, seed=s, partition_every=250, partition_len=120,
            max_crashes=12, invoke_bias=0.5))
       for s in range(2)},
    **{f"register-crash-mix-{s}": ("cas_register",
                                   lambda P, s=s: _mix(P, s))
       for s in range(2)},
    **{f"mutex-{s}": ("mutex", lambda P, s=s:
        P[2].generate_mutex_history(
            400, concurrency=5, seed=s, crash_prob=0.02, max_crashes=6))
       for s in (2, 3)},
    "single-op": ("cas_register", lambda P: P[0].History.of(
        P[0].invoke_op(0, "write", 5), P[0].ok_op(0, "write", 5))),
    "empty": ("cas_register", lambda P: P[0].History.of()),
    "all-crashed": ("cas_register", lambda P: P[0].History.of(
        P[0].invoke_op(0, "write", 1), P[0].invoke_op(1, "write", 2))),
    "set-kernel-less": ("set_model", lambda P: _set_without_kernel(P[0])),
    "set": ("set_model", lambda P:
            P[2].generate_set_history(200, concurrency=3, seed=0)),
}


def _assert_tables_equal(a, b, what):
    assert (a.window, a.R) == (b.window, b.R), what
    for name in TABLES:
        va, vb = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert va.dtype == vb.dtype, (what, name)
        np.testing.assert_array_equal(va, vb, err_msg=f"{what} {name}")
    assert (a.kernel.name if a.kernel else None) == \
        (b.kernel.name if b.kernel else None), what
    assert a.intern == b.intern and a.unintern == b.unintern, what
    for ops_a, ops_b in ((a.ops, b.ops), (a.crashed_ops, b.crashed_ops)):
        assert [[getattr(o, k) for k in OP_KEYS] for o in ops_a] == \
            [[getattr(o, k) for k in OP_KEYS] for o in ops_b], what


def _assert_reductions_equal(a, ra, b, rb, what):
    for x, y, name in zip(ra, rb, ("pure", "pred")):
        assert x.dtype == y.dtype, (what, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")


def _packs(model_name, builder):
    """(JAX package's materialize, port's materialize on the CPU, port's
    host pack) of one history, each with its reduction tables."""
    jpre = jpd.prepack(getattr(jm, model_name)(), builder(JAX))
    jgot = jpd.materialize(jpre)
    tpre = tpd.prepack(getattr(tm, model_name)(), builder(PORT))
    tgot = tpd.materialize(tpre, device="cpu")
    host = tprep.prepare(getattr(tm, model_name)(), builder(PORT))
    return ((jgot, jprep.reduction_tables(jgot)),
            (tgot, tprep.reduction_tables(tgot)),
            (host, tprep.reduction_tables(host)), tpre)


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_materialize_is_the_jax_package_and_the_host_pack(case):
    j, t, host, tpre = _packs(*SINGLE[case])
    eligible = tpd._device_eligible(tpre)
    assert tpd.dev_stats()["dev_packs"] == int(eligible)
    assert jpd.dev_stats()["dev_packs"] == int(eligible)
    if eligible:
        # The device program's own reduction tables, not recomputed.
        assert t[0]._reduction_tables is t[1]
    for other, what in ((j, "jax"), (host, "host")):
        _assert_tables_equal(other[0], t[0], what)
        _assert_reductions_equal(other[0], other[1], t[0], t[1], what)
    if case.startswith("partitioned"):
        assert len(t[0].crashed_ops) > 0
    if case == "set-kernel-less":
        assert t[0].kernel is None


def _batch(model_name, builders, min_k, monkeypatch):
    # The JAX package reads its wave minimum from its knob; the port's is
    # a constant.
    monkeypatch.setenv("JEPSEN_TPU_PACK_DEV_MIN_K", str(min_k))
    monkeypatch.setattr(tpd, "MIN_BATCH_K", min_k)
    jpres = [jpd.prepack(getattr(jm, model_name)(), b(JAX))
             for b in builders]
    tpres = [tpd.prepack(getattr(tm, model_name)(), b(PORT))
             for b in builders]
    jgot = jpd.materialize_batch(jpres)
    tgot = tpd.materialize_batch(tpres, device="cpu")
    for i, (a, b) in enumerate(zip(jgot, tgot)):
        _assert_tables_equal(a, b, f"lane {i}")
        _assert_reductions_equal(a, jprep.reduction_tables(a), b,
                                 tprep.reduction_tables(b), f"lane {i}")
        host = tprep.prepare(getattr(tm, model_name)(), builders[i](PORT))
        _assert_tables_equal(host, b, f"host lane {i}")
        _assert_reductions_equal(host, tprep.reduction_tables(host), b,
                                 tprep.reduction_tables(b), f"host lane {i}")
    js, ts = jpd.dev_stats(), tpd.dev_stats()
    assert (js["dev_packs"], js["dev_lanes"]) == \
        (ts["dev_packs"], ts["dev_lanes"])
    return ts


def test_batch_same_bucket_rides_one_call(monkeypatch):
    builders = [lambda P, s=s: _mix(P, s) for s in range(4)]
    st = _batch("cas_register", builders, 1, monkeypatch)
    assert (st["dev_packs"], st["dev_lanes"], st["host_lanes"]) == (1, 4, 0)


def test_batch_mixed_eligibility_keeps_order(monkeypatch):
    builders = [
        lambda P: P[2].generate_register_history(300, concurrency=4, seed=0),
        lambda P: P[0].History.of(),                      # host (R == 0)
        lambda P: P[2].generate_register_history(300, concurrency=4, seed=1),
        lambda P: P[2].generate_partitioned_register_history(
            900, seed=2, max_crashes=5, invoke_bias=0.5),
    ]
    st = _batch("cas_register", builders, 2, monkeypatch)
    # The empty history has no row; the partitioned one is alone in its
    # bucket, below MIN_K; the two 300-op histories share a bucket.
    assert (st["dev_packs"], st["dev_lanes"]) == (1, 2)
    assert (st["host_lanes"], st["host_eligible"]) == (2, 1)


def test_batch_below_min_k_packs_on_the_host(monkeypatch):
    builders = [lambda P, s=s: P[2].generate_register_history(
        300, concurrency=4, seed=s) for s in range(2)]
    st = _batch("cas_register", builders, 64, monkeypatch)
    assert st["dev_packs"] == 0
    assert st["host_lanes"] == st["host_eligible"] == 2


@pytest.mark.parametrize("case", ["window-overflow", "double-invoke"])
def test_prepack_errors_are_the_jax_package(case):
    def build(H):
        if case == "double-invoke":
            return H.History.of(H.invoke_op(0, "write", 1),
                                H.invoke_op(0, "write", 2),
                                H.ok_op(0, "write", 2))
        ops = [H.invoke_op(i, "write", i) for i in range(70)]
        return H.History.of(*ops, *[H.ok_op(i, "write", i)
                                    for i in range(70)])

    with pytest.raises(jprep.UnsupportedHistory) as je:
        jpd.prepack(jm.cas_register(), build(jh))
    with pytest.raises(tprep.UnsupportedHistory) as te:
        tpd.prepack(tm.cas_register(), build(th))
    with pytest.raises(tprep.UnsupportedHistory) as he:
        tprep.prepare(tm.cas_register(), build(th))
    for e in (te, he):
        assert type(e.value).__name__ == type(je.value).__name__
        assert (str(e.value), e.value.kind) == \
            (str(je.value), je.value.kind)
    if case == "window-overflow":
        assert te.value.kind == "window"


@pytest.mark.parametrize("fast", ["1", "0"])
def test_prepack_fingerprint_is_the_jax_package(fast, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FAST_PACK", fast)
    prints = []
    for s in (3, 4):
        kw = dict(n_ops=800, seed=s, max_crashes=6, invoke_bias=0.5)
        j = jpd.prepack_fingerprint(jpd.prepack(
            jm.cas_register(),
            jsynth.generate_partitioned_register_history(**kw)))
        t = tpd.prepack_fingerprint(tpd.prepack(
            tm.cas_register(),
            tsynth.generate_partitioned_register_history(**kw)))
        assert t == j
        prints.append(t)
    assert prints[0] != prints[1]


def test_prepack_carries_what_the_planner_reads():
    h = tsynth.generate_register_history(400, concurrency=5, seed=1)
    pre = tpd.prepack(tm.cas_register(), list(h))
    p = tprep.prepare(tm.cas_register(), list(h))
    assert pre.kernel.name == p.kernel.name
    assert (pre.window, pre.R, pre.state_width) == \
        (p.window, p.R, p.state_width)
    assert pre.unintern == p.unintern
    np.testing.assert_array_equal(pre.init_state, p.init_state)
    assert tdense.plan(pre) == tdense.plan(p)


@pytest.mark.parametrize("k", [3, 4])
def test_batch_default_min_k_is_four(k):
    # A same-bucket wave packs on the device from MIN_BATCH_K lanes up,
    # on the host below, with the same tables either way.
    assert tpd.MIN_BATCH_K == 4
    hs = [tsynth.generate_register_history(300, concurrency=4, seed=s)
          for s in range(k)]
    pres = [tpd.prepack(tm.cas_register(), h) for h in hs]
    assert len({tpd.pad_shape(p.n, p.R, p.window, p.op_v.shape[1])
                for p in pres}) == 1
    got = tpd.materialize_batch(pres, device="cpu")
    st = tpd.dev_stats()
    on_device = k >= 4
    assert (st["dev_packs"], st["dev_lanes"]) == \
        ((1, k) if on_device else (0, 0))
    assert st["host_eligible"] == (0 if on_device else k)
    for h, b in zip(hs, got):
        host = tprep.prepare(tm.cas_register(), h)
        _assert_tables_equal(host, b, "lane")
        _assert_reductions_equal(host, tprep.reduction_tables(host), b,
                                 tprep.reduction_tables(b), "lane")


def test_no_device_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pre = tpd.prepack(tm.cas_register(), th.History.of(
        th.invoke_op(0, "write", 5), th.ok_op(0, "write", 5)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpd.materialize(pre)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpd.materialize_batch([pre])
