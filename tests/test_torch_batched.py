"""Independent keys: the port's batch and lifted checker against the JAX
package, on the CPU. The dense batch's plain version against the
reference's vmapped XLA chunk, the multiword search with a key axis
against the reference's vmapped ``bfs._search_chunk`` and its ``_dedup``
(bits, state, counts and flags bit for bit), ``try_check_batch``'s
verdicts and ``Decline`` axes, and ``independent.checker``'s result map.
Histories come from each package's own ``synth`` with the same seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import checker as jc
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jm
from jepsen_tpu.history import History as JHistory
from jepsen_tpu.history import invoke_op as j_invoke
from jepsen_tpu.history import ok_op as j_ok
from jepsen_tpu.lin import batched as jb
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import dense as jdense
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import _u32
from jepsen_tpu_torch import checker as tc
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.history import History as THistory
from jepsen_tpu_torch.history import invoke_op as t_invoke
from jepsen_tpu_torch.history import ok_op as t_ok
from jepsen_tpu_torch.lin import batched as tb
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import dense as tdense
from jepsen_tpu_torch.lin import dense_cuda
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many small torch ops; on a loaded machine
    the barrier waits of torch's CPU thread pool dominate them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the key sets, made by each package's synth from the same seeds ---------

def _register(pkg, *, corrupt=False, **kw):
    h = pkg.generate_register_history(**kw)
    return pkg.corrupt_history(h, seed=kw["seed"]) if corrupt else h


def _cas_chain(invoke, ok, history_cls):
    """Window 24, deterministically: 24 concurrent CAS ops in one chain."""
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    h += [invoke(i + 1, "cas", [i, i + 1]) for i in range(24)]
    h += [ok(i + 1, "cas", [i, i + 1]) for i in range(24)]
    return history_cls.of(*h)


def _keys(kind, pkg):
    """{key: history} of one key set in package ``pkg`` ("j" or "t")."""
    synth = jsynth if pkg == "j" else tsynth
    if kind == "dense6":       # tests/test_independent.py:197-212
        return {k: _register(synth, n_ops=40, concurrency=3, seed=k,
                             value_range=3, crash_prob=0.1, max_crashes=4,
                             corrupt=k == 3) for k in range(6)}
    if kind == "lengths":      # tests/test_independent.py:214-229
        return {"a": _register(synth, n_ops=10, concurrency=2, seed=1),
                "b": _register(synth, n_ops=120, concurrency=4, seed=2,
                               crash_prob=0.1)}
    if kind == "sparse3":
        chain = _cas_chain(j_invoke, j_ok, JHistory) if pkg == "j" \
            else _cas_chain(t_invoke, t_ok, THistory)
        return {"chain": chain,
                "corrupt": _register(synth, n_ops=40, concurrency=3, seed=0,
                                     value_range=3, corrupt=True),
                "crashed": _register(synth, n_ops=30, concurrency=4, seed=9,
                                     value_range=3, crash_prob=0.1,
                                     max_crashes=3)}
    raise ValueError(kind)


def _packed(kind):
    pj = {k: jprep.prepare(jm.cas_register(), h)
          for k, h in _keys(kind, "j").items()}
    pt = {k: tprep.prepare(tm.cas_register(), h)
          for k, h in _keys(kind, "t").items()}
    return pj, pt


# --- the dense batch ---------------------------------------------------------

def _reference_dense_batch(pj: dict):
    """The reference's vmapped XLA chunk over keys, with its inputs built
    as jepsen_tpu/lin/batched.py:_try_dense_batch builds them."""
    plans = {k: jdense.plan(p) for k, p in pj.items()}
    w = max(pl[0] for pl in plans.values())
    ns = max(pl[1] for pl in plans.values())
    r_max = max(p.R for p in pj.values())
    r_pad = 1 << max(4, (r_max - 1).bit_length())
    ks = sorted(pj, key=repr)
    K = len(ks)
    F0 = np.zeros((K, 1 << w), np.uint32)
    n_rows = np.zeros(K, np.int32)
    nil_ids = np.zeros(K, np.int32)
    ret_slot = np.zeros((K, r_pad), np.int32)
    active = np.zeros((K, r_pad, w), bool)
    slot_f = np.zeros((K, r_pad, w), np.int32)
    slot_v = np.zeros((K, r_pad, w, pj[ks[0]].slot_v.shape[2]), np.int32)
    for i, k in enumerate(ks):
        p = pj[k]
        _, _, nil_id, init_id = plans[k]
        F0[i, 0] = np.uint32(1) << init_id
        n_rows[i] = p.R
        nil_ids[i] = nil_id
        R, W = p.active.shape
        ret_slot[i, :R] = p.ret_slot
        active[i, :R, :W] = p.active
        slot_f[i, :R, :W] = p.slot_f
        slot_v[i, :R, :W] = p.slot_v
    step_fn = pj[ks[0]].kernel.step
    out = jax.vmap(
        lambda f, n, nid, rs, ac, sf, sv: jdense._dense_chunk(
            f, n, nid, rs, ac, sf, sv, w=w, ns=ns, step_fn=step_fn))(
        jnp.asarray(F0), jnp.asarray(n_rows), jnp.asarray(nil_ids),
        jnp.asarray(ret_slot), jnp.asarray(active), jnp.asarray(slot_f),
        jnp.asarray(slot_v))
    return [np.asarray(x) for x in out], (w, ns, r_pad, ks)


@pytest.mark.parametrize("kind", ["dense6", "lengths"])
def test_dense_batch_plain_matches_vmapped_reference(kind):
    pj, pt = _packed(kind)
    (Fj, rd_j, dead_j, trunc_j), (w, ns, r_pad, ks) = \
        _reference_dense_batch(pj)
    b = tb.dense_batch(pt, "cpu")     # the batch the main path launches
    assert (b.w, b.ns, b.r_pad, b.keys) == (w, ns, r_pad, ks)
    assert b.plans == [jdense.plan(pj[k]) for k in ks]
    inp = b.inp
    assert tuple(inp.masks.shape) == (len(ks), r_pad, w, ns)
    res = dense_cuda.dense_chunk_batch(inp.F, inp.n_rows, inp.masks,
                                       inp.ret_slot, w=w, ns=ns)
    np.testing.assert_array_equal(_u32.bitmap_to_numpy(res.F), Fj)
    np.testing.assert_array_equal(res.state[:, 0].numpy(), rd_j)
    np.testing.assert_array_equal(res.state[:, 1].numpy() != 0, dead_j)
    np.testing.assert_array_equal(res.state[:, 2].numpy() != 0, trunc_j)
    if kind == "dense6":
        assert dead_j.tolist() == [k == 3 for k in ks]
    # Each key's row of the batch is its own single-key chunk.
    for i, k in enumerate(ks):
        one = dense_cuda.dense_chunk(inp.F[i], int(inp.n_rows[i]),
                                     inp.masks[i], inp.ret_slot[i], w=w,
                                     ns=ns)
        assert torch.equal(one.F, res.F[i])
        assert torch.equal(one.state, res.state[i])


def test_batch_masks_take_each_keys_nil_id():
    # Keys of 2 and 4 interned values: nil_id 2 and 4 in one batch.
    pt = {k: tprep.prepare(tm.cas_register(), tsynth.generate_register_history(
        30, concurrency=3, seed=k, value_range=v))
        for k, v in ((0, 2), (1, 4))}
    b = tb.dense_batch(pt, "cpu")
    plans, inp = b.plans, b.inp
    assert b.keys == [0, 1] and [pl[2] for pl in plans] == [2, 4]
    for k in (0, 1):
        R = pt[k].R
        want, ret = tdense.chunk_inputs(pt[k], 0, R, b.w, b.ns, plans[k][2],
                                        "cpu")
        assert torch.equal(inp.masks[k, :R], want)
        assert torch.equal(inp.ret_slot[k, :R], ret)
        assert not inp.masks[k, R:].any()
        assert int(inp.n_rows[k]) == R
        assert _u32.bitmap_to_numpy(inp.F[k]).tolist()[:2] == \
            [1 << plans[k][3], 0]


def test_batch_wrapper_checks_its_arguments():
    F = torch.zeros(2, 16, dtype=torch.int32)
    n = torch.tensor([3, 4], dtype=torch.int32)
    masks = torch.zeros(2, 4, 4, 4, dtype=torch.int32)
    ret = torch.zeros(2, 4, dtype=torch.int32)
    for bad in (dict(F=F[:, :8]), dict(n_rows=n.to(torch.int64)),
                dict(n_rows=n[:1]), dict(masks=masks[:1]),
                dict(ret_slot=ret[:, :3])):
        a = dict(F=F, n_rows=n, masks=masks, ret_slot=ret) | bad
        with pytest.raises(ValueError):
            dense_cuda.dense_chunk_batch(a["F"], a["n_rows"], a["masks"],
                                         a["ret_slot"], w=4, ns=4)
    # A row count outside the tables: that key runs no row, its bitmap
    # passes through and its state row reads BAD_ROWS (as on the card);
    # the host check on the state rejects it.
    F[:, 0] = 1
    good = dense_cuda.dense_chunk_batch(F, n, masks, ret, w=4, ns=4)
    dense_cuda.check_batch_state(good.state)
    for bad_n in (5, -1):
        res = dense_cuda.dense_chunk_batch(
            F, torch.tensor([3, bad_n], dtype=torch.int32), masks, ret, w=4,
            ns=4)
        assert res.state[1].tolist() == [dense_cuda.BAD_ROWS, 0, 0, 0, 0]
        assert torch.equal(res.F[1], F[1])
        assert torch.equal(res.F[0], good.F[0])
        assert torch.equal(res.state[0], good.state[0])
        with pytest.raises(ValueError, match=r"keys \[1\]"):
            dense_cuda.check_batch_state(res.state)


# --- the multiword search with a key axis -------------------------------------

def _sparse_tables(pj, pt, ks):
    r_pad = 1 << max(4, (max(p.R for p in pj.values()) - 1).bit_length())
    w_pad = max(p.window for p in pj.values())
    nw = (w_pad + 1 + 31) // 32
    assert tb.sparse_batch_shape(pt) == (ks, w_pad, nw, r_pad)
    rows_j = [jb._pad_to(pj[k], r_pad, w_pad, nw) for k in ks]
    tab_t = tb.sparse_batch_tables([pt[k] for k in ks], r_pad, w_pad, nw,
                                   "cpu")
    tab_j = tuple(np.stack([r[i] for r in rows_j]) for i in range(6))
    for a, b in zip(tab_j, tab_t):    # the padded tables, bit for bit
        np.testing.assert_array_equal(b.numpy(), a.astype(b.numpy().dtype))
    return tab_j, tab_t, r_pad, nw


def _reference_search(tab_j, init, r_pad, nw, cap, step_fn):
    """jepsen_tpu/lin/batched.py:_check_group's vmapped multiword search at
    one capacity."""
    K, S = init.shape
    bits0 = jnp.zeros((K, cap, nw), jnp.uint32)
    state0 = jnp.zeros((K, cap, S), jnp.int32).at[:, 0, :].set(init)
    count0 = jnp.ones(K, jnp.int32)

    def one(rs, ac, sf, sv, pu, pb, b0, s0, c0):
        return jbfs._search_chunk(jnp.int32(r_pad), rs, ac, sf, sv, pu, pb,
                                  b0, s0, c0, cap=cap, step_fn=step_fn)

    out = jax.vmap(one)(*(jnp.asarray(a) for a in tab_j), bits0, state0,
                        count0)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("cap", [64, 1024])
def test_search_chunk_matches_vmapped_reference(cap):
    pj, pt = _packed("sparse3")
    ks = sorted(pj, key=repr)
    assert pj["chain"].window == 24 > tdense.MAX_DENSE_WINDOW
    tab_j, tab_t, r_pad, nw = _sparse_tables(pj, pt, ks)
    init = np.stack([pj[k].init_state for k in ks])
    want = _reference_search(tab_j, init, r_pad, nw, cap,
                             pj[ks[0]].kernel.step)
    bits, state, count = tb.sparse_batch_entry([pt[k] for k in ks], cap, nw,
                                               "cpu")
    got = tbfs._search_chunk(r_pad, *tab_t, bits, state, count, cap=cap,
                             step_fn=pt[ks[0]].kernel.step)
    np.testing.assert_array_equal(got[0].numpy(), want[0].astype(np.int64))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    dead = dict(zip(ks, want[4].tolist()))
    assert dead == {"chain": False, "corrupt": True, "crashed": False}
    assert int(want[3][ks.index("corrupt")]) - 1 == 18   # the dead row


def _dedup_inputs(rng, K, n, nw, S):
    """Bit words with bit 31 set, negative states, duplicates, and one key
    whose rows are all invalid."""
    bits = rng.integers(0, 4, size=(K, n, nw)).astype(np.uint32)
    bits |= (rng.random((K, n, nw)) < 0.5).astype(np.uint32) << np.uint32(31)
    state = rng.integers(-3, 3, size=(K, n, S)).astype(np.int32)
    state[:, ::5] = np.int32(-(2 ** 31))
    bits[:, 1::4] = bits[:, ::4][:, :bits[:, 1::4].shape[1]]
    state[:, 1::4] = state[:, ::4][:, :state[:, 1::4].shape[1]]
    valid = rng.random((K, n)) < 0.8
    valid[K - 1] = False
    return bits, state, valid


@pytest.mark.parametrize("nw,S,cap", [(1, 1, 8), (2, 1, 64), (2, 2, 16)])
def test_dedup_matches_reference(nw, S, cap):
    rng = np.random.default_rng(nw * 10 + S)
    K, n = 3, 96
    bits, state, valid = _dedup_inputs(rng, K, n, nw, S)
    got = tbfs._dedup(torch.from_numpy(bits.astype(np.int64)),
                      torch.from_numpy(state.astype(np.int64)),
                      torch.from_numpy(valid), cap)
    for k in range(K):
        want = [np.asarray(x) for x in jbfs._dedup(
            jnp.asarray(bits[k]), jnp.asarray(state[k]),
            jnp.asarray(valid[k]), cap)]
        np.testing.assert_array_equal(got[0][k].numpy(),
                                      want[0].astype(np.int64))
        np.testing.assert_array_equal(got[1][k].numpy(), want[1])
        assert int(got[2][k]) == int(want[2])
        assert bool(got[3][k]) == bool(want[3])
    assert int(got[2][K - 1]) == 0 and not got[0][K - 1].any()


# --- try_check_batch and its declines -------------------------------------------

def _same_results(rj: dict, rt: dict):
    assert set(rj) == set(rt)
    for k in rj:
        for key in ("valid?", "dead-row", "op"):
            assert rt[k].get(key) == rj[k].get(key), (k, key)
        assert rt[k]["analyzer"] == \
            rj[k]["analyzer"].replace("tpu-", "gpu-"), k


@pytest.mark.parametrize("kind,analyzer", [("dense6", "gpu-dense-batch"),
                                           ("lengths", "gpu-dense-batch"),
                                           ("sparse3", "gpu-bfs-batch")])
def test_try_check_batch_matches_reference(kind, analyzer):
    rj = jb.try_check_batch(jm.cas_register(), _keys(kind, "j"))
    rt = tb.try_check_batch(tm.cas_register(), _keys(kind, "t"),
                            device="cpu")
    _same_results(rj, rt)
    assert {r["analyzer"] for r in rt.values()} == {analyzer}


def _declines(monkeypatch, kind, **ceilings):
    for name, value in ceilings.items():
        for mod in (jb, tb) if name != "MAX_DEVICE_WINDOW" else (jbfs, tbfs):
            monkeypatch.setattr(mod, name, value)
    dj, dt = [], []
    rj = jb.try_check_batch(jm.cas_register(), _keys(kind, "j"),
                            declines=dj)
    rt = tb.try_check_batch(tm.cas_register(), _keys(kind, "t"),
                            declines=dt, device="cpu")
    assert (rj is None) == (rt is None)
    if rj is not None:
        _same_results(rj, rt)
    assert [d.as_dict() for d in dt] == [d.as_dict() for d in dj]
    return rt, dt


@pytest.mark.parametrize("kind,ceilings,axis", [
    ("dense6", dict(MAX_BATCH_BITMAP_WORDS=1 << 5), "bitmap-words"),
    ("lengths", dict(MAX_BATCH_ROWS=16), "rows"),
    ("dense6", dict(MAX_BATCH_TABLE_CELLS=1 << 10), "table-cells"),
    ("sparse3", {}, "dense-plan"),
])
def test_dense_decline_axes_match_reference(monkeypatch, kind, ceilings,
                                            axis):
    for name, value in ceilings.items():
        monkeypatch.setattr(jb, name, value)
        monkeypatch.setattr(tb, name, value)
    pj, pt = _packed(kind)
    dj = jb._try_dense_batch(pj)
    dt = tb._try_dense_batch(pt, "cpu")
    assert isinstance(dt, tb.Decline) and not dt
    assert dt.axis == axis
    assert dt.as_dict() == dj.as_dict()
    if axis in ("bitmap-words", "dense-plan"):
        # The group then runs the sparse batch, as the reference's does.
        rt, declines = _declines(monkeypatch, kind)
        assert declines == []
        assert {r["analyzer"] for r in rt.values()} == {"gpu-bfs-batch"}


@pytest.mark.parametrize("kind,ceilings,axis", [
    ("sparse3", dict(BATCH_CAP_SCHEDULE=(4,)), "frontier-overflow"),
    ("sparse3", dict(MAX_DEVICE_WINDOW=20), "window"),
])
def test_group_decline_axes_match_reference(monkeypatch, kind, ceilings,
                                            axis):
    rt, declines = _declines(monkeypatch, kind, **ceilings)
    assert rt is None
    assert [d.axis for d in declines] == [axis]


def test_try_check_batch_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.try_check_batch(tm.cas_register(), _keys("lengths", "t"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tind.checker(tc.linearizable("gpu")).check(
            None, tm.cas_register(), _kv_register_history("t"), {})


# --- the lifted checker ---------------------------------------------------------

def _kv_register_history(pkg, corrupt_key=None):
    """tests/test_independent.py:105-114's three keys."""
    ind, invoke, ok, hist = (jind, j_invoke, j_ok, JHistory) if pkg == "j" \
        else (tind, t_invoke, t_ok, THistory)
    h = []
    for k in ("a", "b", "c"):
        h += [invoke(0, "write", ind.KV(k, 7)), ok(0, "write", ind.KV(k, 7)),
              invoke(0, "read", ind.KV(k, None)),
              ok(0, "read", ind.KV(k, 8 if k == corrupt_key else 7))]
    return hist.of(*h)


def _lifted(pkg, history, inner=None):
    if pkg == "j":
        ck = jind.checker(inner or jc.linearizable("tpu"))
        return ck.check(None, jm.cas_register(), history, {})
    ck = tind.checker(inner or tc.linearizable("gpu", device="cpu"))
    return ck.check(None, tm.cas_register(), history, {})


def _same_lifted(rj, rt):
    for key in ("valid?", "failures", "batch-engaged", "batch-keys",
                "n-keys"):
        assert rt[key] == rj[key], key
    assert set(rt["results"]) == set(rj["results"])
    _same_results(rj["results"], rt["results"])


@pytest.mark.parametrize("corrupt_key", [None, "b"])
def test_independent_checker_matches_reference(corrupt_key):
    rj = _lifted("j", _kv_register_history("j", corrupt_key))
    rt = _lifted("t", _kv_register_history("t", corrupt_key))
    _same_lifted(rj, rt)
    assert rt["batch-engaged"] is True and rt["batch-keys"] == 3
    assert rt["failures"] == ([] if corrupt_key is None else ["b"])


def test_independent_checker_batches_a_synth_key_set():
    def kv(pkg, ind):
        h = []
        for k, sub in _keys("dense6", pkg).items():
            h += [o.replace(value=ind.KV(k, o.value)) for o in sub]
        return h

    rj = _lifted("j", kv("j", jind))
    rt = _lifted("t", kv("t", tind))
    _same_lifted(rj, rt)
    assert rt["failures"] == [3] and rt["valid?"] is False


def test_non_linearizable_inner_does_not_engage_the_batch():
    hj = JHistory.of(j_invoke(0, "write", jind.KV("k", 1)),
                     j_ok(0, "write", jind.KV("k", 1)))
    ht = THistory.of(t_invoke(0, "write", tind.KV("k", 1)),
                     t_ok(0, "write", tind.KV("k", 1)))
    _same_lifted(_lifted("j", hj), _lifted("t", ht))
    rj = _lifted("j", hj, jc.unbridled_optimism())
    rt = _lifted("t", ht, tc.unbridled_optimism())
    assert rt == rj
    assert rt["batch-engaged"] is False and rt["batch-keys"] == 0
    # The CPU oracle is linearizability too, but not the device's.
    rt = _lifted("t", ht, tc.linearizable("cpu"))
    assert rt["batch-engaged"] is False
    assert rt["results"]["k"]["valid?"] is True


def test_independent_checker_on_the_empty_history():
    rt = _lifted("t", [])
    assert rt == _lifted("j", [])
    assert rt["valid?"] is True and rt["n-keys"] == 0


def test_subhistories_and_keys_match_reference():
    def h(pkg):
        ind, invoke, ok, hist = (jind, j_invoke, j_ok, JHistory) \
            if pkg == "j" else (tind, t_invoke, t_ok, THistory)
        return hist.of(invoke(0, "w", ind.KV("a", 1)),
                       invoke(1, "w", ind.KV("b", 2)),
                       invoke("nemesis", "start", None),
                       ok(0, "w", ind.KV("a", 1)), ok(1, "w", ind.KV("b", 2)))

    hj, ht = h("j"), h("t")
    assert tind.history_keys(ht) == jind.history_keys(hj) == {"a", "b"}
    for k in ("a", "b"):
        assert [o.to_dict() for o in tind.subhistory(k, ht)] == \
            [o.to_dict() for o in jind.subhistory(k, hj)]
    assert {k: [o.to_dict() for o in v]
            for k, v in tind._subhistories(["a", "b"], ht).items()} == \
        {k: [o.to_dict() for o in jind.subhistory(k, hj)] for k in "ab"}
    assert tind._subdir({"subdirectory": "x"}, 3) == \
        jind._subdir({"subdirectory": "x"}, 3)
    assert tind.is_tuple(tind.tuple_(1, 2)) and not tind.is_tuple((1, 2))


def test_merge_valid_matches_reference():
    cases = [[], [True], [True, "unknown"], ["unknown", False, True],
             [True, True, False]]
    for vs in cases:
        assert tc.merge_valid(vs) == jc.merge_valid(vs)
    for bad in ([None], [True, "maybe"]):
        with pytest.raises(ValueError):
            jc.merge_valid(bad)
        with pytest.raises(ValueError):
            tc.merge_valid(bad)


def test_linearizable_keeps_its_device():
    ck = tc.linearizable("gpu", device="cpu")
    assert (ck.is_linearizable, ck.algorithm, ck.device) == \
        (True, "gpu", "cpu")
    assert tc.linearizable().device is None
