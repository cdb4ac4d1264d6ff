"""The dense engine's pieces against the JAX package, bit for bit: the
transition masks, and the chunk step's plain torch version against both
the Pallas kernel (interpret mode) and the XLA formulation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.lin import dense as jdense
from jepsen_tpu.lin import dense_pallas as jdp
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import _u32
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import dense as tdense
from jepsen_tpu_torch.lin import dense_cuda
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import synth as tsynth

CH = jdense.CHUNK      # the JAX engine's static chunk shape: one compile


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many tiny torch ops; on a loaded machine the
    barrier waits of torch's CPU thread pool dominate them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _histories(kind, kw):
    if kind == "mutex":
        return (jsynth.generate_mutex_history(**kw),
                tsynth.generate_mutex_history(**kw), jm.mutex(), tm.mutex())
    hj = jsynth.generate_register_history(**kw)
    ht = tsynth.generate_register_history(**kw)
    if kind == "corrupt":
        hj = jsynth.corrupt_history(hj, seed=kw["seed"])
        ht = tsynth.corrupt_history(ht, seed=kw["seed"])
    return hj, ht, jm.cas_register(), tm.cas_register()


def _packed(kind, kw):
    hj, ht, mj, mt = _histories(kind, kw)
    return jprep.prepare(mj, hj), tprep.prepare(mt, ht)


def _pad(a, w):
    return tdense._pad_w(a, w)


def _slice(a, base, n):
    """Rows [base, base + n) zero-padded to the JAX engine's chunk shape."""
    part = a[base:base + n]
    pad = np.zeros((CH - part.shape[0],) + a.shape[1:], a.dtype)
    return np.concatenate([part, pad])


def _init_bitmap(w, init_id):
    F = np.zeros(1 << w, np.uint32)
    F[0] = np.uint32(1) << np.uint32(init_id)
    return F


@pytest.mark.parametrize("kind,kw", [
    ("register", dict(n_ops=120, concurrency=4, seed=1, value_range=3,
                      crash_prob=0.1, max_crashes=6)),
    ("mutex", dict(n_ops=120, concurrency=4, seed=2, crash_prob=0.1)),
])
def test_transition_masks_match_pallas(kind, kw):
    pj, pt = _packed(kind, kw)
    w, ns, nil_id, _ = jdense.plan(pj)
    n = min(64, pj.R)
    want = jdp.transition_masks(
        jnp.asarray(_pad(pj.slot_f[:n], w)),
        jnp.asarray(_pad(pj.slot_v[:n], w)),
        jnp.asarray(_pad(pj.active[:n], w)), jnp.int32(nil_id), ns=ns,
        step_fn=pj.kernel.step)
    got, ret = tdense.chunk_inputs(pt, 0, n, w, ns, nil_id, "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, w, ns)
    np.testing.assert_array_equal(_u32.bitmap_to_numpy(got),
                                  np.asarray(want))
    np.testing.assert_array_equal(ret.numpy(), pj.ret_slot[:n])


def _random_masks(rng, rows, w, ns):
    """Seeded masks from random partial transition functions over ~70% of
    the slots, and return slots among each row's active ones."""
    masks = np.zeros((rows, w, ns), np.uint64)
    active = rng.random((rows, w)) < 0.7
    legal = rng.random((rows, w, ns)) < 0.85
    target = rng.integers(0, ns, size=(rows, w, ns))
    for r, j, s in zip(*np.nonzero(active[:, :, None] & legal)):
        masks[r, j, target[r, j, s]] |= np.uint64(1) << np.uint64(s)
    ret = np.array([rng.choice(np.flatnonzero(a)) if a.any() else 0
                    for a in active], np.int32)
    return masks.astype(np.uint32), ret


@pytest.mark.parametrize("w,ns,seed", [(10, 8, 0), (10, 4, 1), (12, 8, 2)])
def test_plain_chunk_matches_pallas_interpret(w, ns, seed):
    rng = np.random.default_rng(seed)
    rows, n_rows = 24, 20           # rows past n_rows must be ignored
    masks, ret = _random_masks(rng, rows, w, ns)
    F = np.zeros(1 << w, np.uint32)
    F[rng.integers(0, 1 << w, size=6)] = rng.integers(
        1, 1 << ns, size=6).astype(np.uint32)
    Fj, rd_j, dead_j = jdp.pallas_chunk(
        jnp.asarray(F), jnp.int32(n_rows), jnp.asarray(masks),
        jnp.asarray(ret), w=w, ns=ns, chunk=rows, interpret=True)
    res = dense_cuda.dense_chunk(
        _u32.bitmap_from_numpy(F), n_rows, _u32.bitmap_from_numpy(masks),
        torch.from_numpy(ret), w=w, ns=ns)
    np.testing.assert_array_equal(_u32.bitmap_to_numpy(res.F),
                                  np.asarray(Fj))
    assert int(res.rows_done) == int(rd_j)
    assert bool(res.dead) == bool(dead_j)
    assert not bool(res.trunc)


def _xla_chunk(pj, F, base, n, w, ns, nil_id):
    out = jdense._dense_chunk(
        jnp.asarray(F), jnp.int32(n), jnp.int32(nil_id),
        jnp.asarray(_slice(pj.ret_slot, base, n)),
        jnp.asarray(_pad(_slice(pj.active, base, n), w)),
        jnp.asarray(_pad(_slice(pj.slot_f, base, n), w)),
        jnp.asarray(_pad(_slice(pj.slot_v, base, n), w)),
        w=w, ns=ns, step_fn=pj.kernel.step)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("w,kind,kw", [
    (4, "register", dict(n_ops=150, concurrency=3, seed=3, value_range=3)),
    (8, "register", dict(n_ops=150, concurrency=4, seed=4, value_range=3,
                         crash_prob=0.1, max_crashes=4)),
    (8, "corrupt", dict(n_ops=150, concurrency=4, seed=5, value_range=3,
                        crash_prob=0.05, max_crashes=4)),
    (12, "corrupt", dict(n_ops=150, concurrency=4, seed=7, value_range=3,
                         crash_prob=0.1, max_crashes=6)),
])
def test_plain_chunk_matches_xla_across_a_chunk_boundary(w, kind, kw):
    pj, pt = _packed(kind, kw)
    assert pj.window <= w
    _, ns, nil_id, init_id = jdense.plan(pj)
    cut = pj.R // 2                 # two chunks, the bitmap carried across
    Fj = _init_bitmap(w, init_id)
    Ft = _u32.bitmap_from_numpy(Fj)
    for base, n in ((0, cut), (cut, pj.R - cut)):
        Fj, rd_j, dead_j, trunc_j = _xla_chunk(pj, Fj, base, n, w, ns,
                                               nil_id)
        masks, ret = tdense.chunk_inputs(pt, base, n, w, ns, nil_id,
                                         "cpu")
        res = dense_cuda.dense_chunk(Ft, n, masks, ret, w=w, ns=ns)
        np.testing.assert_array_equal(_u32.bitmap_to_numpy(res.F), Fj)
        assert res.state[:3].tolist() == [int(rd_j), int(dead_j),
                                          int(trunc_j)]
        Ft = res.F
        if bool(dead_j):
            break
    if kind == "corrupt":
        # The dead row is where the oracle dies.
        want = jdense.check_packed(pj, backend="xla")
        got = tdense.check_packed(pt, device="cpu")
        assert got["valid?"] is want["valid?"] is False
        assert got.get("dead-row") == want.get("dead-row")


def test_plain_chunk_stops_at_the_dead_row_and_counts_it():
    # Slot 0's op keeps every state, so its returns keep the frontier;
    # slot 3 never linearizes and no entry config holds it, so its return
    # at row 5 empties the frontier.
    w, ns = 4, 4
    masks = np.zeros((8, w, ns), np.uint32)
    for s in range(ns):
        masks[:, 0, s] = 1 << s
    ret = np.zeros(8, np.int32)
    ret[5] = 3
    F = _init_bitmap(w, 0)
    res = dense_cuda.dense_chunk(
        _u32.bitmap_from_numpy(F), 8, _u32.bitmap_from_numpy(masks),
        torch.from_numpy(ret), w=w, ns=ns)
    assert res.state[:3].tolist() == [6, 1, 0]
    assert not _u32.bitmap_to_numpy(res.F).any()


def test_chunk_wrapper_checks_its_arguments():
    F = torch.zeros(16, dtype=torch.int32)
    masks = torch.zeros(4, 4, 4, dtype=torch.int32)
    ret = torch.zeros(4, dtype=torch.int32)
    for bad in (dict(F=F.to(torch.int64)), dict(masks=masks[:, :3]),
                dict(ret_slot=ret.to(torch.int64)), dict(n_rows=5)):
        args = dict(F=F, n_rows=4, masks=masks, ret_slot=ret) | bad
        with pytest.raises(ValueError):
            dense_cuda.dense_chunk(args["F"], args["n_rows"], args["masks"],
                                   args["ret_slot"], w=4, ns=4)
    with pytest.raises(ValueError):
        dense_cuda.dense_chunk(F, 4, masks, ret, w=21, ns=4)


def test_u32_helpers_keep_bit_31():
    a = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    raw = _u32.bitmap_from_numpy(a)
    assert raw.dtype == torch.int32
    np.testing.assert_array_equal(_u32.bitmap_to_numpy(raw), a)
    wide = _u32.widen(raw)
    assert wide.tolist() == [int(x) for x in a]
    assert torch.equal(_u32.narrow(wide), raw)
    assert _u32.raw_word(1 << 31) == -(1 << 31)
    assert _u32.popcount(raw) == 0 + 1 + 31 + 1 + 32
    cfgs = tdense.decode_bitmap(raw, nil_id=31)
    assert cfgs[0] == (1, (0,))
    assert (3, (int(tm.kernels.NIL),)) in cfgs and (4, (30,)) in cfgs
