"""The port's host packer against the JAX package's, bit for bit: the
port's ``prepare`` under each of its walks (the default, native for two
value words and vec for others; vec forced; py with
``JEPSEN_TPU_FAST_PACK=0``) and the JAX package's under both of its legs
(``JEPSEN_TPU_FAST_PACK`` on and off) give the same tables, interns, ops,
reduction tables, or the same error, on the corpora of the JAX package's
fast-pack and native-pack tests (at smaller sizes)."""

import numpy as np
import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import _build, native_ext
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth

JAX = (jh, jm, jsynth)
PORT = (th, tm, tsynth)

TABLES = ("ret_slot", "ret_op", "active", "slot_f", "slot_v", "slot_op",
          "crashed", "init_state")
OP_KEYS = ("op_index", "process", "f", "value", "ok", "invoke_pos",
           "return_pos")

# Each leg: (package, environment). The JAX package's FAST_PACK=0 leg
# takes its native walk where that builds, else its Python walk.
JAX_LEGS = {"jax-vec": {"JEPSEN_TPU_FAST_PACK": "1"},
            "jax-spec": {"JEPSEN_TPU_FAST_PACK": "0"}}
# Each port leg: (environment, the slot walk forced in place of the
# routed one, or None).
PORT_LEGS = {"default": ({"JEPSEN_TPU_FAST_PACK": "1"}, None),
             "vec": ({"JEPSEN_TPU_FAST_PACK": "1"}, "vec"),
             "py": ({"JEPSEN_TPU_FAST_PACK": "0"}, None)}


def _hand(H, *ops):
    return H.History.of(*ops)


def _info_fail_nemesis(H):
    return _hand(
        H,
        H.invoke_op("nemesis", "start", None),
        H.invoke_op(0, "write", 1),
        H.invoke_op(1, "read", None),
        H.ok_op(0, "write", 1),
        H.info_op(1, "read", None),          # crashed read: elided
        H.invoke_op(2, "cas", [1, 2]),
        H.invoke_op(3, "write", 7),
        H.fail_op(3, "write", 7),            # failed: dropped
        H.ok_op(2, "cas", [1, 2]),
        H.invoke_op(0, "read", None),
        H.ok_op(0, "read", 2),
        H.invoke_op(1, "write", 9),          # dangling: crashed
        H.invoke_op("nemesis", "stop", None))


def _tail_invokes(H):
    return _hand(
        H,
        H.invoke_op(0, "write", 1), H.invoke_op(1, "read", None),
        H.ok_op(0, "write", 1), H.invoke_op(2, "cas", [1, 2]),
        H.info_op(1, "read", None), H.ok_op(2, "cas", [1, 2]),
        H.invoke_op(3, "write", 9))


def _values(vals):
    def build(H):
        return _hand(
            H,
            H.invoke_op(0, "write", vals[0]), H.ok_op(0, "write", vals[0]),
            H.invoke_op(1, "write", vals[1]), H.ok_op(1, "write", vals[1]),
            H.invoke_op(0, "read", None), H.ok_op(0, "read", vals[2]))
    return build


def _dequeue(H):
    return _hand(
        H,
        H.invoke_op(0, "enqueue", 4), H.ok_op(0, "enqueue", 4),
        H.invoke_op(1, "dequeue", None), H.ok_op(1, "dequeue", 4),
        H.invoke_op(0, "enqueue", 5), H.ok_op(0, "enqueue", 5),
        H.invoke_op(1, "dequeue", None), H.info_op(1, "dequeue", None))


def _wide(returns):
    def build(H):
        ops = [H.invoke_op(i, "write", i) for i in range(70)]
        if returns:
            ops += [H.ok_op(i, "write", i) for i in range(70)]
        return _hand(H, *ops)
    return build


# name -> (model name, history builder over (history, models, synth)).
CORPUS = {
    **{f"register-crash-mix-{s}": ("cas_register", lambda P, s=s:
        P[2].generate_register_history(
            600, concurrency=7, seed=s, crash_prob=0.02, max_crashes=9))
       for s in range(3)},
    **{f"partitioned-cas-{s}": ("cas_register", lambda P, s=s:
        P[2].generate_partitioned_register_history(
            2000, seed=s, max_crashes=12, invoke_bias=0.5))
       for s in range(2)},
    "register-model": ("register", lambda P:
        P[2].generate_register_history(
            400, concurrency=5, seed=1, crash_prob=0.01, max_crashes=4)),
    **{f"mutex-{s}": ("mutex", lambda P, s=s:
        P[2].generate_mutex_history(
            400, concurrency=5, seed=s, crash_prob=0.02, max_crashes=6))
       for s in range(2)},
    **{f"set-{s}": ("set_model", lambda P, s=s:
        P[2].generate_set_history(200, concurrency=3, seed=s))
       for s in range(2)},
    **{f"queue-{s}": ("fifo_queue", lambda P, s=s:
        P[2].generate_queue_history(
            300, concurrency=3, seed=s, crash_prob=0.02, max_crashes=4))
       for s in range(2)},
    "native-random": ("cas_register", lambda P:
        P[2].generate_register_history(
            800, concurrency=7, seed=3, crash_prob=0.01, max_crashes=6)),
    "empty": ("cas_register", lambda P: P[0].History.of()),
    "trivial": ("cas_register", lambda P: _hand(
        P[0], P[0].invoke_op(0, "write", 5), P[0].ok_op(0, "write", 5))),
    "info-fail-nemesis": ("cas_register",
                          lambda P: _info_fail_nemesis(P[0])),
    "crashes-tail-invokes": ("cas_register", lambda P: _tail_invokes(P[0])),
    "values-strings": ("cas_register", lambda P: _values(
        ("a", "b", "c"))(P[0])),
    "values-bools": ("cas_register", lambda P: _values(
        (True, False, 1))(P[0])),
    "values-past-int-gate": ("cas_register", lambda P: _values(
        (1 << 62, -(1 << 62) - 1, 3))(P[0])),
    "values-floats": ("cas_register", lambda P: _values(
        (1.5, 2.5, 1.5))(P[0])),
    "dequeue-values": ("fifo_queue", lambda P: _dequeue(P[0])),
    "error-double-invoke": ("cas_register", lambda P: _hand(
        P[0], P[0].invoke_op(0, "write", 1), P[0].invoke_op(0, "write", 2),
        P[0].ok_op(0, "write", 2))),
    "error-window-overflow": ("cas_register", lambda P: _wide(True)(P[0])),
    "error-window-no-returns": ("cas_register",
                                lambda P: _wide(False)(P[0])),
    "error-bad-cas-pair": ("cas_register", lambda P: _hand(
        P[0], P[0].invoke_op(0, "cas", 7), P[0].ok_op(0, "cas", 7))),
    "error-unknown-f": ("cas_register", lambda P: _hand(
        P[0], P[0].invoke_op(0, "frob", 1), P[0].ok_op(0, "frob", 1))),
}


def _pack(pkg, prep, model_name, builder, env, monkeypatch, walk=None):
    """One leg's pack and reduction tables under ``env`` (with the port's
    slot walk ``walk`` forced), or its error as (class name, kind,
    message)."""
    monkeypatch.delenv("JEPSEN_TPU_FAST_PACK", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if walk is not None:
        fn = getattr(prep, f"_pack_events_{walk}")
        monkeypatch.setattr(prep, "pack_events",
                            lambda *a: (fn(*a), walk))
    model = getattr(pkg[1], model_name)()
    h = builder(pkg)
    try:
        p = prep.prepare(model, h)
    except prep.UnsupportedHistory as e:
        return ("error", type(e).__name__, e.kind, str(e))
    return ("ok", p, prep.reduction_tables(p))


def _assert_same(ref, got, leg):
    assert ref[0] == got[0], (leg, ref, got)
    if ref[0] == "error":
        assert ref[1:] == got[1:], leg
        return
    a, ra = ref[1], ref[2]
    b, rb = got[1], got[2]
    assert (a.window, a.R) == (b.window, b.R), leg
    for name in TABLES:
        va, vb = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert va.dtype == vb.dtype, (leg, name)
        np.testing.assert_array_equal(va, vb, err_msg=f"{leg} {name}")
    assert (a.kernel.name if a.kernel else None) == \
        (b.kernel.name if b.kernel else None), leg
    assert a.intern == b.intern and a.unintern == b.unintern, leg
    for ops_a, ops_b in ((a.ops, b.ops), (a.crashed_ops, b.crashed_ops)):
        assert [[getattr(o, k) for k in OP_KEYS] for o in ops_a] == \
            [[getattr(o, k) for k in OP_KEYS] for o in ops_b], leg
    for x, y, what in zip(ra, rb, ("pure", "pred")):
        assert x.dtype == y.dtype, (leg, what)
        np.testing.assert_array_equal(x, y, err_msg=f"{leg} {what}")


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_every_walk_packs_as_the_jax_package(case, monkeypatch):
    model_name, builder = CORPUS[case]
    ref = _pack(JAX, jprep, model_name, builder, JAX_LEGS["jax-vec"],
                monkeypatch)
    got = _pack(JAX, jprep, model_name, builder, JAX_LEGS["jax-spec"],
                monkeypatch)
    _assert_same(ref, got, "jax-spec")
    for leg, (env, forced) in PORT_LEGS.items():
        got = _pack(PORT, tprep, model_name, builder, env, monkeypatch,
                    forced)
        monkeypatch.undo()
        _assert_same(ref, got, leg)
        if got[0] == "error":
            continue
        vw = got[1].slot_v.shape[2]
        walk = {"default": "native" if vw == 2 else "vec", "vec": "vec",
                "py": "py"}[leg]
        assert tprep.pack_stats()["mode"] == walk, leg
        op_f, op_v, inv = got[1]._op_fv
        assert len(op_f) == len(op_v) == len(inv) == len(got[1].ops)
    if case.startswith("partitioned"):
        assert len(ref[1].crashed_ops) > 0
    if case.startswith("error-window"):
        assert ref[2] == "window"


@pytest.mark.parametrize("case", ["register-crash-mix-0",
                                  "partitioned-cas-1", "mutex-0",
                                  "set-0", "queue-1"])
def test_chain_tables_vec_is_the_spec_reduction(case, monkeypatch):
    model_name, builder = CORPUS[case]
    monkeypatch.setenv("JEPSEN_TPU_FAST_PACK", "0")
    p = tprep.prepare(getattr(tm, model_name)(), builder(PORT))
    spec = tprep.reduction_tables(p)
    if p.kernel is None or p.R == 0:
        return
    R = p.R
    ret_row = np.full(len(p.ops), -1, np.int64)
    ret_row[p.ret_op] = np.arange(R)
    inv = np.array([o.invoke_pos for o in p.ops], np.int64)
    crashed = ret_row < 0
    ordkey = np.where(crashed, np.int64(R + 2) + inv, ret_row)
    op_f, op_v, _ = p._op_fv
    for fv in ((op_f, op_v), (None, None)):   # given, and recovered
        got = tprep._chain_tables_vec(p.active, p.slot_f, p.slot_v,
                                      p.slot_op, ordkey, crashed, *fv)
        for x, y in zip(got, spec):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_pack_meter_and_default_walk(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_FAST_PACK", raising=False)
    tprep.reset_pack_stats()
    h = tsynth.generate_register_history(300, concurrency=4, seed=0)
    p = tprep.prepare(tm.cas_register(), h)
    tprep.reduction_tables(p)
    st = tprep.pack_stats()
    assert st["mode"] == "native"
    assert st["prepare_calls"] == 1 and st["reduction_calls"] == 1
    assert st["prepare_s"] > 0.0 and st["reduction_s"] >= 0.0
    tprep.reset_pack_stats()
    assert tprep.pack_stats() == {"prepare_s": 0.0, "prepare_calls": 0,
                                  "reduction_s": 0.0, "reduction_calls": 0,
                                  "incr_s": 0.0, "incr_calls": 0,
                                  "mode": ""}


def test_native_walk_raises_when_its_build_fails(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "history_pack.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native_ext, "_lib", None)
    monkeypatch.delenv("JEPSEN_TPU_FAST_PACK", raising=False)
    h = tsynth.generate_register_history(50, concurrency=3, seed=0)
    with pytest.raises(RuntimeError, match="history_pack: g\\+\\+ exit"):
        tprep.prepare(tm.cas_register(), h)
    # The spec path stays selectable by the JAX package's knob.
    monkeypatch.setenv("JEPSEN_TPU_FAST_PACK", "0")
    assert tprep.prepare(tm.cas_register(), h).R > 0
    assert tprep.pack_stats()["mode"] == "py"


def test_native_walk_refuses_a_wrong_row_count():
    inv = np.array([0, 1], np.int32)
    ret = np.array([2, 3], np.int32)
    z = np.zeros(2, np.int32)
    with pytest.raises(ValueError, match="refused"):
        native_ext.pack_events(inv, ret, z, z, z, nil_value=-1,
                               max_window=4, fill_fv=True, R=1)
    out = native_ext.pack_events(inv, ret, z, z, z, nil_value=-1,
                                 max_window=4, fill_fv=True, R=2)
    assert out[-1] == 2 and out[2].dtype == bool
