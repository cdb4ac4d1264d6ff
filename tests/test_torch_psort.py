"""The sparse engine's key kernels against the JAX package, bit for bit:
the plain torch versions of ``dedup_keys``, ``compact_keys`` and the fused
``fixpoint`` against the Pallas kernels (interpret mode) and the lax /
unfused formulations they replace. Keys are integers, so every
comparison is exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import models as jm
from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import prepare as jprep
from jepsen_tpu.lin import psort as jpsort
from jepsen_tpu.lin import psort_fused as jfused
from jepsen_tpu.lin import synth as jsynth
from jepsen_tpu_torch import _u32
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import prepare as tprep
from jepsen_tpu_torch.lin import psort as tpsort
from jepsen_tpu_torch.lin import psort_fused as tfused
from jepsen_tpu_torch.lin import psort_fused_cuda as tfused_cuda
from jepsen_tpu_torch.lin import synth as tsynth

FILL = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions run many tiny torch ops; on a loaded machine the
    barrier waits of torch's CPU thread pool dominate them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    """A numpy u32 array as the raw int32 tensor the port carries."""
    return _u32.bitmap_from_numpy(np.asarray(a, np.uint32), "cpu")


def _np(t):
    return _u32.bitmap_to_numpy(t)


# (n, cap): padded sizes 1024, 2048, 4096; each case overflows its cap
# in at least one of its inputs.
DEDUP_SHAPES = [(1024, 256), (1500, 512), (4096, 1000)]


def _dedup_inputs(n, cap):
    """Seeded inputs: heavy duplication with mixed validity, a set of
    distinct keys past cap, and all-invalid keys."""
    rng = np.random.default_rng(n * 31 + cap)
    dup = rng.integers(0, 1 << 10, n).astype(np.uint32)
    wide = rng.permutation(1 << 20)[:n].astype(np.uint32)
    return [(dup, rng.random(n) < 0.6),
            (wide, rng.random(n) < 0.9),
            (dup, np.zeros(n, bool))]


@pytest.fixture(scope="module")
def jax_dedups():
    """Every dedup input with the Pallas kernel's (interpret mode) and the
    lax formulation's outputs, computed once."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_PSORT", "interpret")
        for n, cap in DEDUP_SHAPES:
            for i, (keys, valid) in enumerate(_dedup_inputs(n, cap)):
                k, v = jnp.asarray(keys), jnp.asarray(valid)
                pk = jpsort.dedup_keys(k, v, cap)
                lk = jbfs._dedup_keys(k, v, cap, use_psort=False)
                out[(n, cap, i)] = (keys, valid,
                                    [tuple(np.asarray(x) for x in r)
                                     for r in (pk, lk)])
    return out


@pytest.mark.parametrize("n,cap", DEDUP_SHAPES)
def test_dedup_keys_plain_matches_pallas_and_lax(jax_dedups, n, cap):
    overflowed = False
    for i in range(3):
        keys, valid, refs = jax_dedups[(n, cap, i)]
        k, c, o = tpsort.dedup_keys_plain(_t(keys), torch.from_numpy(valid),
                                          cap)
        for rk, rc, ro in refs:
            # The lax twin returns keys[:min(n, cap)]; past n the kernel's
            # padded output is KEY_FILL.
            got = _np(k)
            assert np.array_equal(got[:rk.size], rk.astype(np.uint32))
            assert (got[rk.size:] == FILL).all()
            assert int(c) == int(rc)
            assert bool(o) == bool(ro)
        overflowed |= bool(o)
    assert overflowed


@pytest.mark.parametrize("n,cap", DEDUP_SHAPES)
def test_dedup_keys_sort_matches_lax(jax_dedups, n, cap):
    """The engine's dedup past the kernels' size gate is the reference's
    lax.sort formulation, at any size."""
    for i in range(3):
        keys, valid, (_, (rk, rc, ro)) = jax_dedups[(n, cap, i)]
        k, c, o = tbfs._dedup_keys_sort(_t(keys), torch.from_numpy(valid),
                                        cap)
        assert np.array_equal(_np(k), rk.astype(np.uint32))
        assert (int(c), bool(o)) == (int(rc), bool(ro))


@pytest.mark.parametrize("n_live", [700, 1024])
def test_filter_pass_keys_past_the_gate_matches_lax(monkeypatch, n_live):
    """The return filter's compaction with the kernel gated off (as past
    PSORT_MAX_N) against the reference's lax.sort filter."""
    cap, b, s = 1024, 3, 5
    rng = np.random.default_rng(n_live)
    keys = np.full(cap, FILL, np.uint32)
    keys[:n_live] = np.sort(rng.choice(1 << 24, n_live, replace=False))
    monkeypatch.setattr(tpsort, "available", lambda n: False)
    tk, tc, td = tbfs._filter_pass_keys(_t(keys), n_live, s, cap=cap, b=b)
    jk, jc, jd = jbfs._filter_pass_keys(jnp.asarray(keys), jnp.int32(n_live),
                                        jnp.int32(s), cap=cap, b=b,
                                        use_psort=False)
    assert np.array_equal(_np(tk), np.asarray(jk))
    assert (tc, td) == (int(jc), bool(jd))
    assert 0 < tc < n_live


@pytest.fixture(scope="module")
def jax_compacts():
    """compact_keys inputs and the Pallas kernel's outputs: the return
    filter's sorted-with-holes keys, and arbitrary keys (duplicates, bit
    31 set, holes) the kernel must also match."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_PSORT", "interpret")
        for n, cap in [(1024, 256), (2048, 2048), (1500, 1024)]:
            rng = np.random.default_rng(n + cap)
            holes = np.sort(rng.choice(1 << 20, n, replace=False)) \
                .astype(np.uint32)
            holes[rng.random(n) < 0.4] = FILL
            arb = rng.integers(0, 1 << 32, n, dtype=np.uint64) \
                .astype(np.uint32)
            arb[rng.random(n) < 0.3] = FILL
            arb[: n // 8] = arb[n // 8: 2 * (n // 8)]
            for i, keys in enumerate((holes, arb)):
                ok, oc = jpsort.compact_keys(jnp.asarray(keys), cap)
                out[(n, cap, i)] = (keys, np.asarray(ok), int(oc))
    return out


@pytest.mark.parametrize("n,cap", [(1024, 256), (2048, 2048), (1500, 1024)])
def test_compact_keys_plain_matches_pallas(jax_compacts, n, cap):
    for i in range(2):
        keys, rk, rc = jax_compacts[(n, cap, i)]
        k, c = tpsort.compact_keys_plain(_t(keys), cap)
        assert np.array_equal(_np(k), rk.astype(np.uint32))
        assert int(c) == rc
        # The engine's filter path: lax.sort of the same keys.
        if i == 0:
            lax = np.sort(keys)[:cap]
            assert np.array_equal(_np(k)[:lax.size], lax)


def test_wrappers_run_plain_on_the_cpu_and_check_their_contract():
    rng = np.random.default_rng(3)
    keys = _t(rng.integers(0, 1 << 12, 2000))
    valid = torch.ones(2000, dtype=torch.bool)
    before = dict(tpsort.LAUNCHES)
    a = tpsort.dedup_keys(keys, valid, 512)
    b = tpsort.dedup_keys_plain(keys, valid, 512)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(tpsort.compact_keys(keys, 512)[0],
                       tpsort.compact_keys_plain(keys, 512)[0])
    assert tpsort.LAUNCHES == before            # no kernel launched
    with pytest.raises(ValueError, match="contract"):
        tpsort.dedup_keys(keys[:100], valid[:100], 2048)
    with pytest.raises(ValueError, match="int32"):
        tpsort.compact_keys(keys.to(torch.int64), 512)
    assert tpsort.available(1 << 19) and not tpsort.available((1 << 19) + 1)
    assert tpsort.pad_size(1500) == 2048 and tpsort.pad_size(10) == 1024


# --- the dedups at the spike tiers' sizes ---------------------------------

SPIKE_N, SPIKE_CAP = 1 << 20, 1 << 19


def _spike_inputs(pair: bool, overflow: bool):
    """Seeded dedup inputs at n = 2^20, as a spike tier's candidates: about
    half valid, heavily duplicated, keys using bit 30 (pairs: hi's bit 30
    and lo's bit 31 as payload); more distinct valid keys than the cap
    when ``overflow``."""
    rng = np.random.default_rng(101 + 2 * pair + overflow)
    n = SPIKE_N
    pool = rng.integers(0, 1 << 31, (3 * n) // 2 if overflow else n // 4,
                        dtype=np.uint64).astype(np.uint32)
    lo = rng.choice(pool, n)
    valid = rng.random(n) < (0.9 if overflow else 0.5)
    if not pair:
        return (lo & np.uint32(0x7FFFFFFF),), valid
    hi = (lo >> np.uint32(24)) | (lo << np.uint32(6) & np.uint32(1 << 30))
    return (hi.astype(np.uint32), lo | np.uint32(1 << 31) * (lo & 1)), valid


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
@pytest.mark.parametrize("overflow", [False, True],
                         ids=["fits", "overflows"])
def test_dedup_plain_matches_sort_twin_and_lax_at_spike_size(pair, overflow):
    """At n = 2^20, cap 524288 (spike tier 524288): the plain dedup equals
    the engine's torch.sort twin and the reference's lax path
    (``use_psort=False``) bit for bit. The reference returns
    keys[:min(n, cap)]: its first ``count`` keys and the fill after."""
    words, valid = _spike_inputs(pair, overflow)
    tv = torch.from_numpy(valid)
    tw = tuple(_t(w) for w in words)
    if pair:
        plain = tpsort.dedup_keys2_plain(*tw, tv, SPIKE_CAP)
        twin = tbfs._dedup_keys2_sort(*tw, tv, SPIKE_CAP)
        ref = jbfs._dedup_keys2(*(jnp.asarray(w) for w in words),
                                jnp.asarray(valid), SPIKE_CAP,
                                use_psort=False)
    else:
        plain = tpsort.dedup_keys_plain(*tw, tv, SPIKE_CAP)
        twin = tbfs._dedup_keys_sort(*tw, tv, SPIKE_CAP)
        ref = jbfs._dedup_keys(jnp.asarray(words[0]), jnp.asarray(valid),
                               SPIKE_CAP, use_psort=False)
    assert all(torch.equal(a, b) for a, b in zip(plain, twin))
    count, ovf = int(ref[-2]), bool(ref[-1])
    assert (int(plain[-2]), bool(plain[-1])) == (count, ovf)
    assert ovf == overflow and count > SPIKE_CAP // 8
    for got, want in zip(plain[:-2], ref[:-2]):
        got, want = _np(got), np.asarray(want)
        assert np.array_equal(got[:count], want[:count])
        assert (got[count:] == FILL).all() and (want[count:] == FILL).all()
    if pair:
        live_hi = _np(plain[0])[:count]
        assert (live_hi >> 30 & 1).any() and (_np(plain[1])[:count] >> 31).any()
    else:
        assert (_np(plain[0])[:count] >> 30 & 1).any()


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_dedup_routing_on_both_sides_of_the_gate(monkeypatch, pair):
    """bfs._dedup_keys / _dedup_keys2 send n up to psort.DEDUP_MAX_N to the
    dedup wrapper (the kernel on the card, its plain version here) and
    larger n to the torch.sort twin, with the same result on both
    sides."""
    gate = tpsort.DEDUP_MAX_N
    assert tpsort.dedup_available(gate)
    assert not tpsort.dedup_available(gate + 1)
    assert tpsort.available(tpsort.PSORT_MAX_N) \
        and not tpsort.dedup_available(2 * gate)
    calls = []
    name = "dedup_keys2" if pair else "dedup_keys"
    wrapper = getattr(tpsort, name)
    twin_name = "_dedup_keys2_sort" if pair else "_dedup_keys_sort"
    twin = getattr(tbfs, twin_name)
    monkeypatch.setattr(tpsort, name,
                        lambda *a: calls.append("kernel") or wrapper(*a))
    monkeypatch.setattr(tbfs, twin_name,
                        lambda *a: calls.append("sort") or twin(*a))
    route = tbfs._dedup_keys2 if pair else tbfs._dedup_keys
    plain = tpsort.dedup_keys2_plain if pair else tpsort.dedup_keys_plain
    rng = np.random.default_rng(7 + pair)
    for n in (gate, gate + 1):
        keys = rng.integers(0, 1 << 20, n).astype(np.uint32)
        args = ((_t(keys >> np.uint32(12)),) if pair else ()) \
            + (_t(keys), torch.from_numpy(rng.random(n) < 0.5), 1 << 14)
        got = route(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, plain(*args)))
        assert bool(got[-1])                    # overflowing cap 2^14
    assert calls == ["kernel", "sort"]


# --- the fused fixpoint ---------------------------------------------------


def _packed_pair(n=60, concurrency=16, seed=7, value_range=5):
    kw = dict(concurrency=concurrency, seed=seed, value_range=value_range,
              crash_prob=0)
    pj = jprep.prepare(jm.cas_register(),
                       jsynth.generate_register_history(n, **kw))
    pt = tprep.prepare(tm.cas_register(),
                       tsynth.generate_register_history(n, **kw))
    return pj, pt


CAP = 256


@pytest.fixture(scope="module")
def fixpoint_case():
    """A mid-history row of ``_packed(60, 16, 7)`` with live mutator
    columns, its tables from both packages, and the Pallas kernel's
    (interpret mode) fixpoints: converged from the initial config, at
    it_max=1, and from a 256-key frontier that overflows cap 256."""
    pj, pt = _packed_pair()
    b = max(len(pj.unintern), 2).bit_length()
    nil_id = max(len(pj.unintern), 2)
    W = pj.window
    exp_j = jbfs.expansion_tables(pj, b)
    pure_j, _ = jbfs.reduction_bit_tables(pj, (W + 31) // 32)
    r = next(i for i in range(pj.R) if np.asarray(exp_j[4])[i].sum() >= 2)
    exp_r = tuple(jnp.asarray(t[r]) for t in exp_j)
    cols, sats = jbfs._fused_row_tables(
        exp_r, jnp.asarray(np.asarray(pj.active)[r]),
        jnp.asarray(np.asarray(pj.slot_v)[r]), jnp.asarray(pure_j[r]),
        W=W, b=b, nil_id=nil_id)
    M = int(cols.shape[1])
    it_max = W + 12

    lo0 = np.full(CAP, FILL, np.uint32)
    lo0[0] = nil_id
    rng = np.random.default_rng(5)
    big = np.sort(rng.choice(1 << (W + b - 2), CAP, replace=False)
                  ).astype(np.uint32)
    big = (big & ~np.uint32((1 << b) - 1)) | np.uint32(nil_id)
    big = np.unique(big)
    big = np.concatenate([big, np.full(CAP - big.size, FILL, np.uint32)])
    n_big = int((big != FILL).sum())
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_PSORT_FUSED", "interpret")
        for name, lo, cnt, itm in (("init", lo0, 1, it_max),
                                   ("budget", lo0, 1, 1),
                                   ("overflow", big, n_big, it_max)):
            flo, fhi, fc, conv, ovf = jfused.fixpoint(
                jnp.asarray(lo), None, jnp.int32(cnt), cols, sats, cap=CAP,
                b=b, it_max=itm)
            assert fhi is None
            runs[name] = (lo, cnt, itm, np.asarray(flo), int(fc),
                          bool(conv), bool(ovf))
    return dict(pj=pj, pt=pt, r=r, b=b, nil_id=nil_id, W=W, M=M,
                cols=np.asarray(cols), sats=np.asarray(sats), runs=runs)


def test_fused_row_tables_match_jax(fixpoint_case):
    fc = fixpoint_case
    pt, r, b, W = fc["pt"], fc["r"], fc["b"], fc["W"]
    exp_t = tbfs.expansion_tables(pt, b)
    pure_t, _ = tbfs.reduction_bit_tables(pt, (W + 31) // 32)
    cols, sats = tbfs._fused_row_tables(
        tuple(t[r] for t in exp_t), pt.active[r], pt.slot_v[r], pure_t[r],
        W=W, b=b, nil_id=fc["nil_id"])
    assert np.array_equal(cols, fc["cols"].astype(np.uint32))
    assert np.array_equal(sats, fc["sats"].astype(np.uint32))


@pytest.mark.parametrize("run", ["init", "budget", "overflow"])
def test_fixpoint_plain_matches_pallas(fixpoint_case, run):
    fc = fixpoint_case
    lo, cnt, itm, rlo, rcnt, rconv, rovf = fc["runs"][run]
    flo, fhi, c, conv, ovf = tfused.fixpoint_plain(
        _t(lo), None, cnt, _t(fc["cols"]), _t(fc["sats"]), cap=CAP,
        b=fc["b"], it_max=itm)
    assert fhi is None
    assert np.array_equal(_np(flo), rlo.astype(np.uint32))
    assert (int(c), bool(conv), bool(ovf)) == (rcnt, rconv, rovf)
    if run == "budget":
        assert not rconv and not rovf          # the honest budget signal
    if run == "overflow":
        assert rovf and rcnt > CAP             # the unclamped total


def test_fixpoint_plain_matches_the_unfused_chain(fixpoint_case):
    """One fused fixpoint equals the port's unfused pass chain iterated
    to convergence (ungrouped, and grouped two columns at a time)."""
    fc = fixpoint_case
    pt, r, b, W, nil_id = fc["pt"], fc["r"], fc["b"], fc["W"], fc["nil_id"]
    lo, cnt, itm, rlo, rcnt, _, _ = fc["runs"]["init"]
    eng = tbfs._Engine(pt, torch.device("cpu"))
    eng.load_chunk(r, 1)
    for G, Mg in ((1, fc["M"]), (fc["M"] // 2, 2)):
        ulo, uhi, ucnt, uovf = eng._closure_unfused(
            _t(lo), None, cnt, 0, CAP, G, Mg, G * (W + 4) + 8)
        assert uhi is None
        assert not uovf
        assert ucnt == rcnt
        assert np.array_equal(_np(ulo), rlo.astype(np.uint32))
    # The JAX package's unfused pass, iterated, agrees too.
    exp_r = tuple(jnp.asarray(t[r]) for t in jbfs.expansion_tables(
        fc["pj"], b))
    pure_j, _ = jbfs.reduction_bit_tables(fc["pj"], 1)
    jlo, jcnt = jnp.asarray(lo), jnp.int32(cnt)
    for _ in range(itm):
        jlo, _, jcnt, changed, ovf = jbfs._closure_pass_keys_compact(
            jlo, None, jcnt, jnp.asarray(fc["pj"].active[r]),
            jnp.asarray(fc["pj"].slot_v[r]), jnp.asarray(pure_j[r]), exp_r,
            cap=CAP, W=W, b=b, nil_id=nil_id,
            step_fn=fc["pj"].kernel.step, use_psort=False, crash_dom=False)
        if not bool(changed):
            break
    assert int(jcnt) == rcnt
    assert np.array_equal(np.asarray(jlo), rlo.astype(np.uint32))


def test_fixpoint_wrapper_gates():
    cols = torch.zeros((tfused.N_COL_ROWS, 8), dtype=torch.int32)
    sats = torch.zeros((2, 8), dtype=torch.int32)
    lo = torch.full((CAP,), -1, dtype=torch.int32)
    before = dict(tfused.LAUNCHES)
    out = tfused.fixpoint(lo, None, 0, cols, sats, cap=CAP, b=3, it_max=4)
    assert tfused.LAUNCHES == before           # plain on the CPU
    assert bool(out[3]) and int(out[2]) == 0   # empty frontier converges
    # Pair keys run the same loop; a malformed hi is refused.
    out = tfused.fixpoint(lo, lo.clone(), 0, cols, sats, cap=CAP, b=3,
                          it_max=4)
    assert tfused.LAUNCHES == before
    assert bool(out[3]) and torch.equal(out[1], lo)
    with pytest.raises(ValueError, match="hi must be"):
        tfused.fixpoint(lo, lo[:8], 0, cols, sats, cap=CAP, b=3, it_max=4)
    assert tfused.fits(1024, 8, 3) and not tfused.fits(1000, 8, 3)
    assert not tfused.fits(8, 8, 3) and not tfused.fits(1024, 8, 7)
    assert not tfused.fits(1 << 17, 32, 3)
    assert tfused.max_n() == tpsort.PSORT_MAX_N


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
@pytest.mark.parametrize("M", [16, 32])
def test_fixpoint_launcher_limits_and_scratch(pair, M):
    """The launcher takes n_pad up to the reference's clamp 2^21 while the
    engine's gate ``fits`` stays at PSORT_MAX_N (2^19), in both key
    modes; the device-memory scratch holds two buffers of the worst-case
    live count, cap * (1 + M) keys, exactly where that can exceed the
    shared path's capacity."""
    assert tfused_cuda.MAX_N == 1 << jfused.FUSED_MAX_EXP
    fused = [t for t in tbfs.ROW_TIERS if tfused.fits(t, M, 3)]
    assert fused == ([256, 1024, 4096] if M == 32
                     else [256, 1024, 4096, 16384])
    for cap in (256, 1024, 4096, 8192, 16384, 32768, 65536):
        n_pad = tpsort.pad_size(cap * (1 + M))
        assert tfused.fits(cap, M, 3) == (n_pad <= tpsort.PSORT_MAX_N)
        assert tfused_cuda.launchable(cap, M, 3, n_pad) == \
            (n_pad <= 1 << 21)
    assert tfused_cuda.launchable(16384, M, 6, 1 << 20)
    assert not tfused_cuda.launchable(16384, M, 7, 1 << 20)
    assert not tfused_cuda.launchable(1024, M, 3, 1 << 22)
    assert not tfused_cuda.launchable(1000, M, 3, 1 << 16)
    assert not tfused_cuda.launchable(1 << 16, M, 3, 1 << 16)
    shared = 12288 if pair else 24576
    words = 2 if pair else 1
    for cap in (256, 1024, 4096, 16384):
        n = cap * (1 + M)
        got = tfused_cuda.scratch_words(cap, M, pair, shared)
        assert got == (2 * n * words if n > shared else 1)
    # At the headlines' M 32 tier 256 always sorts in shared memory; from
    # tier 1024 the worst case needs the device buffers.
    assert tfused_cuda.scratch_words(256, 32, pair, shared) == 1
    assert tfused_cuda.scratch_words(1024, 32, pair, shared) == \
        2 * 33792 * words
    # The largest cap the launcher takes (n_pad 2^21): scratch of at most
    # two buffers of 2^21 keys.
    top = 1 << (((1 << 21) // (1 + M)).bit_length() - 1)
    assert top == (1 << 15 if M == 32 else 1 << 16)
    assert tfused_cuda.launchable(top, M, 3, 1 << 21)
    assert not tfused_cuda.launchable(2 * top, M, 3, 1 << 21)
    assert tfused_cuda.scratch_words(top, M, pair, shared) \
        <= 2 * (1 << 21) * words


# --- pair keys ------------------------------------------------------------


PAIR_SHAPES = [(1024, 256), (2048, 1000)]


def _pair_inputs(n):
    """Seeded (hi, lo, valid) dedup inputs: equal hi with different lo,
    lo's bit 31 set as payload (it is a slot's key bit in the pair band,
    not a flag), duplicates, (KEY_FILL, KEY_FILL) holes and mixed
    validity; and the same keys all invalid."""
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 4, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lo[::3] |= np.uint32(1 << 31)
    hi[:n // 4], lo[:n // 4] = hi[n // 4:n // 2], lo[n // 4:n // 2]
    hole = rng.random(n) < 0.1
    hi[hole], lo[hole] = FILL, FILL
    return [(hi, lo, rng.random(n) < 0.7), (hi, lo, np.zeros(n, bool))]


@pytest.fixture(scope="module")
def jax_dedups2():
    """Every pair input with the Pallas kernels' (interpret mode) and the
    lax formulation's outputs: dedup_keys2, the lax two-key dedup, and
    compact_keys2 of the same pairs with the invalid ones dropped."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_PSORT", "interpret")
        for n, cap in PAIR_SHAPES:
            for i, (hi, lo, valid) in enumerate(_pair_inputs(n)):
                h, lw, v = (jnp.asarray(x) for x in (hi, lo, valid))
                pk = jpsort.dedup_keys2(h, lw, v, cap)
                lk = jbfs._dedup_keys2(h, lw, v, cap, use_psort=False)
                dh = np.where(valid, hi, FILL).astype(np.uint32)
                dl = np.where(valid, lo, FILL).astype(np.uint32)
                ck = jpsort.compact_keys2(jnp.asarray(dh), jnp.asarray(dl),
                                          cap)
                out[(n, cap, i)] = ((hi, lo, valid, dh, dl),
                                    [tuple(np.asarray(x) for x in r)
                                     for r in (pk, lk, ck)])
    return out


@pytest.mark.parametrize("n,cap", PAIR_SHAPES)
def test_dedup_keys2_plain_matches_pallas_and_lax(jax_dedups2, n, cap):
    overflowed = False
    for i in range(2):
        (hi, lo, valid, _, _), refs = jax_dedups2[(n, cap, i)]
        args = (_t(hi), _t(lo), torch.from_numpy(valid), cap)
        plain = tpsort.dedup_keys2_plain(*args)
        # The engine's twin past the kernels' gate is the lax formulation.
        sort = tbfs._dedup_keys2_sort(*args)
        for (th, tl, tc, to), (rh, rl, rc, ro) in ((plain, refs[0]),
                                                   (plain, refs[1]),
                                                   (sort, refs[1])):
            assert np.array_equal(_np(th)[:rh.size], rh.astype(np.uint32))
            assert np.array_equal(_np(tl)[:rl.size], rl.astype(np.uint32))
            assert (_np(th)[rh.size:] == FILL).all()
            assert (int(tc), bool(to)) == (int(rc), bool(ro))
        overflowed |= bool(plain[3])
        if i == 0:
            # Survivors with lo's bit 31 set: payload, not the flag.
            assert (_np(plain[1])[:int(plain[2])] >> 31).any()
    assert overflowed


@pytest.mark.parametrize("n,cap", PAIR_SHAPES)
def test_compact_keys2_plain_matches_pallas(jax_dedups2, n, cap):
    (_, _, _, dh, dl), (_, _, (rh, rl, rc)) = jax_dedups2[(n, cap, 0)]
    th, tl, tc = tpsort.compact_keys2_plain(_t(dh), _t(dl), cap)
    assert np.array_equal(_np(th), rh.astype(np.uint32))
    assert np.array_equal(_np(tl), rl.astype(np.uint32))
    assert int(tc) == int(rc)
    before = dict(tpsort.LAUNCHES)
    wrapped = tpsort.compact_keys2(_t(dh), _t(dl), cap)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, (th, tl, tc)))
    assert tpsort.LAUNCHES == before            # plain on the CPU


PAIR_CAP = 128


@pytest.fixture(scope="module")
def pair_fixpoint_case():
    """A real row of ``tests/test_lin_psort_fused.py``'s pair-key history
    ``(140, 40, 3)`` (window 31, 3 state bits): the first row whose
    closure from the initial config converges at cap 128 with configs
    that hold key bits in hi (slots 29, 30) and lo's bit 31 (slot 28).
    The Pallas kernel's (interpret mode) fixpoints from it: converged,
    at it_max=1, and from 128 random configs, which overflow."""
    pj, pt = _packed_pair(140, 40, 3)
    eng = tbfs._Engine(pt, torch.device("cpu"))
    W, b = eng.W, eng.b
    assert eng.pair and (W, b) == (31, 3)
    it_max = W + 12
    lo0, hi0 = eng.init_keys(PAIR_CAP)
    eng.load_chunk(0, pt.R)
    for r in range(pt.R):
        flo, fhi, fl = tfused.fixpoint_flags_plain(
            lo0, hi0, 1, eng.cols[r], eng.sats[r], cap=PAIR_CAP, b=b,
            it_max=it_max)
        conv, _, _, fc = fl.tolist()
        if conv and (_np(fhi)[:fc] != 0).any() \
                and (_np(flo)[:fc] >> 31).any():
            break
    else:
        raise AssertionError("no row carries payload in both words")
    rng = np.random.default_rng(11)
    k = np.unique(rng.integers(0, 1 << (W + b - 1), 4 * PAIR_CAP,
                               dtype=np.uint64)
                  & ~np.uint64((1 << b) - 1) | np.uint64(eng.nil_id))
    k = np.sort(rng.permutation(k)[:PAIR_CAP])
    big = (k.astype(np.uint32), (k >> np.uint64(32)).astype(np.uint32))
    cols, sats = _np(eng.cols[r]), _np(eng.sats[r])
    exp_j = jbfs.expansion_tables(pj, b)
    pure_j, _ = jbfs.reduction_bit_tables(pj, (W + 31) // 32)
    exp_r = tuple(jnp.asarray(t[r]) for t in exp_j)
    jcols, jsats = jbfs._fused_row_tables(
        exp_r, jnp.asarray(np.asarray(pj.active)[r]),
        jnp.asarray(np.asarray(pj.slot_v)[r]), jnp.asarray(pure_j[r]),
        W=W, b=b, nil_id=eng.nil_id)
    assert np.array_equal(np.asarray(jcols), cols)
    assert np.array_equal(np.asarray(jsats), sats)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_PSORT_FUSED", "interpret")
        for name, (lo_, hi_), cnt, itm in (
                ("converged", (_np(lo0), _np(hi0)), 1, it_max),
                ("budget", (_np(lo0), _np(hi0)), 1, 1),
                ("overflow", big, PAIR_CAP, it_max)):
            flo, fhi, fc, conv, ovf = jfused.fixpoint(
                jnp.asarray(lo_), jnp.asarray(hi_), jnp.int32(cnt), jcols,
                jsats, cap=PAIR_CAP, b=b, it_max=itm)
            runs[name] = (lo_, hi_, cnt, itm, np.asarray(flo),
                          np.asarray(fhi), int(fc), bool(conv), bool(ovf))
    return dict(pj=pj, eng=eng, r=r, cols=cols, sats=sats, runs=runs,
                exp_r=exp_r, pure_j=pure_j)


@pytest.mark.parametrize("run", ["converged", "budget", "overflow"])
def test_fixpoint_pair_plain_matches_pallas(pair_fixpoint_case, run):
    fc = pair_fixpoint_case
    lo, hi, cnt, itm, rlo, rhi, rcnt, rconv, rovf = fc["runs"][run]
    flo, fhi, c, conv, ovf = tfused.fixpoint_plain(
        _t(lo), _t(hi), cnt, _t(fc["cols"]), _t(fc["sats"]), cap=PAIR_CAP,
        b=fc["eng"].b, it_max=itm)
    assert np.array_equal(_np(flo), rlo.astype(np.uint32))
    assert np.array_equal(_np(fhi), rhi.astype(np.uint32))
    assert (int(c), bool(conv), bool(ovf)) == (rcnt, rconv, rovf)
    if run == "converged":
        # Key bits past 31 live in hi; lo's bit 31 is slot 28's key bit.
        assert rconv and (rhi[:rcnt] != 0).any() \
            and (rlo[:rcnt] >> 31).any()
    if run == "budget":
        assert not rconv and not rovf
    if run == "overflow":
        assert rovf and rcnt > PAIR_CAP


def test_fixpoint_pair_plain_matches_the_unfused_chains(pair_fixpoint_case):
    """One pair fixpoint equals the port's unfused pair pass chain
    (ungrouped, and grouped two columns at a time) and the JAX package's
    unfused pair pass, iterated to convergence."""
    fc = pair_fixpoint_case
    eng, r, pj = fc["eng"], fc["r"], fc["pj"]
    lo, hi, cnt, _, rlo, rhi, rcnt, _, _ = fc["runs"]["converged"]
    eng.load_chunk(r, 1)
    M, W, b = eng.M, eng.W, eng.b
    for G, Mg in ((1, M), (M // 2, 2)):
        ulo, uhi, ucnt, uovf = eng._closure_unfused(
            _t(lo), _t(hi), cnt, 0, PAIR_CAP, G, Mg, G * (W + 4) + 8)
        assert not uovf and ucnt == rcnt
        assert np.array_equal(_np(ulo), rlo.astype(np.uint32))
        assert np.array_equal(_np(uhi), rhi.astype(np.uint32))
    jlo, jhi, jcnt = jnp.asarray(lo), jnp.asarray(hi), jnp.int32(cnt)
    for _ in range(W + 12):
        jlo, jhi, jcnt, changed, ovf = jbfs._closure_pass_keys_compact(
            jlo, jhi, jcnt, jnp.asarray(pj.active[r]),
            jnp.asarray(pj.slot_v[r]), jnp.asarray(fc["pure_j"][r]),
            fc["exp_r"], cap=PAIR_CAP, W=W, b=b, nil_id=eng.nil_id,
            step_fn=pj.kernel.step, use_psort=False, crash_dom=False)
        if not bool(changed):
            break
    assert int(jcnt) == rcnt
    assert np.array_equal(np.asarray(jlo), rlo.astype(np.uint32))
    assert np.array_equal(np.asarray(jhi), rhi.astype(np.uint32))
