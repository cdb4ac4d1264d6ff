"""The port's history, synth and packing against the JAX package's: the
same seeds give the same op lines, and the same histories pack to the
same tables, field by field."""

import numpy as np
import pytest

from jepsen_tpu import history as jh
from jepsen_tpu import models as jm
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth

# (kind, kwargs) pairs, each generated identically by both packages.
CASES = [
    ("register", dict(n_ops=300, concurrency=4, seed=1, value_range=3,
                      crash_prob=0.1, max_crashes=6)),
    ("register", dict(n_ops=400, concurrency=6, seed=7, value_range=5,
                      crash_prob=0.05, max_crashes=10)),
    ("corrupt", dict(n_ops=300, concurrency=4, seed=2, value_range=3,
                     crash_prob=0.05)),
    ("mutex", dict(n_ops=300, concurrency=4, seed=3, crash_prob=0.1)),
]


def _pair(kind, kw):
    if kind == "mutex":
        return (jsynth.generate_mutex_history(**kw),
                tsynth.generate_mutex_history(**kw),
                jm.mutex(), tm.mutex())
    hj = jsynth.generate_register_history(**kw)
    ht = tsynth.generate_register_history(**kw)
    if kind == "corrupt":
        hj = jsynth.corrupt_history(hj, seed=kw["seed"])
        ht = tsynth.corrupt_history(ht, seed=kw["seed"])
    return hj, ht, jm.cas_register(), tm.cas_register()


def _mixed_history(H):
    """A hand-built history over value types synth never makes: strings,
    tuples, unhashable lists, None, a failed op, a nemesis op and a
    dangling invocation."""
    return H.History.of(
        H.invoke_op(0, "write", "a"), H.ok_op(0, "write", "a"),
        H.invoke_op("nemesis", "start", None),
        H.invoke_op(1, "cas", ["a", (1, 2)]),
        H.invoke_op(2, "read", None), H.ok_op(2, "read", "a"),
        H.ok_op(1, "cas", ["a", (1, 2)]),
        H.invoke_op(3, "write", [5, 6]), H.fail_op(3, "write", [5, 6]),
        H.invoke_op(3, "write", [7]), H.info_op(3, "write", [7]),
        H.invoke_op(4, "read", None), H.ok_op(4, "read", (1, 2)),
        H.invoke_op(5, "cas", [[7], None]))


TABLES = ("ret_slot", "ret_op", "active", "slot_f", "slot_v", "slot_op",
          "crashed", "init_state")


def _assert_same_packing(pj, pt):
    assert (pt.window, pt.R) == (pj.window, pj.R)
    for name in TABLES:
        a, b = getattr(pj, name), getattr(pt, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert pt.unintern == pj.unintern
    assert pt.intern == pj.intern
    assert pt.kernel.name == pj.kernel.name
    keys = ("op_index", "process", "f", "value", "ok", "invoke_pos",
            "return_pos")
    assert [[getattr(o, k) for k in keys] for o in pt.ops] == \
        [[getattr(o, k) for k in keys] for o in pj.ops]
    assert [o.op_index for o in pt.crashed_ops] == \
        [o.op_index for o in pj.crashed_ops]


@pytest.mark.parametrize("kind,kw", CASES)
def test_synth_gives_the_same_op_lines(kind, kw):
    hj, ht, _, _ = _pair(kind, kw)
    assert [th.dumps_op(o) for o in ht] == [jh.dumps_op(o) for o in hj]
    o = ht[5]
    assert th.loads_op(th.dumps_op(o)) == o


@pytest.mark.parametrize("kind,kw", CASES)
def test_prepare_and_reduction_tables_match_jax(kind, kw):
    hj, ht, mj, mt = _pair(kind, kw)
    pj = jprep.prepare(mj, hj)
    pt = tprep.prepare(mt, ht)
    _assert_same_packing(pj, pt)
    for a, b in zip(jprep.reduction_tables(pj), tprep.reduction_tables(pt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["cas-register", "register"])
def test_prepare_mixed_values_match_jax(model):
    mj = jm.cas_register("a") if model == "cas-register" else jm.register()
    mt = tm.cas_register("a") if model == "cas-register" else tm.register()
    pj = jprep.prepare(mj, _mixed_history(jh))
    pt = tprep.prepare(mt, _mixed_history(th))
    _assert_same_packing(pj, pt)
    for a, b in zip(jprep.reduction_tables(pj), tprep.reduction_tables(pt)):
        np.testing.assert_array_equal(a, b)


def test_prepare_refusals_match_jax():
    def dbl(H):
        return H.History.of(H.invoke_op(0, "read", None),
                            H.invoke_op(0, "read", None))

    with pytest.raises(tprep.UnsupportedHistory):
        tprep.prepare(tm.cas_register(), dbl(th))
    with pytest.raises(jprep.UnsupportedHistory):
        jprep.prepare(jm.cas_register(), dbl(jh))
    wide_kw = dict(n_ops=200, concurrency=12, seed=4)
    with pytest.raises(tprep.UnsupportedHistory) as e:
        tprep.prepare(tm.cas_register(),
                      tsynth.generate_register_history(**wide_kw),
                      max_window=8)
    assert e.value.kind == "window"


def test_packed_from_arrays_round_trips():
    kind, kw = CASES[1]
    hj, ht, mj, mt = _pair(kind, kw)
    pt = tprep.prepare(mt, ht)
    pj = jprep.prepare(mj, hj)
    for src in (pt, pj):          # the port's own tables, and JAX's
        fields = {k: getattr(src, k) for k in tprep.PACKED_FIELDS}
        q = tprep.packed_from_arrays(fields, pt.ops, mt)
        _assert_same_packing(pt, q)
        assert q.kernel.name == pt.kernel.name
    with pytest.raises(ValueError):
        tprep.packed_from_arrays({"R": 0}, [], mt)
