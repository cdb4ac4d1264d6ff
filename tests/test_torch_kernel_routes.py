"""The host side of the dense kernel's, the dominance dedups' and the
compactions' routes, which the CPU can check without the card: which
kernel a chunk width takes and what shared memory it asks for, each
dominance dedup's choice between its one-launch and multi-launch paths
by padded size, each compaction's between its one launch and the
bitonic network, each path's scratch sizing, the launchers' limits, and
that a tensor on a device without a kernel raises instead of falling
back. The inputs ``chip_smoke.py`` adds for the one-launch paths (one
group dominated only at distance 128, every entry equal, valid counts
around the shared capacity; the compactions' ascending, descending,
bit-31, all-fill and hi-KEY_FILL cases) are held against the
reference's lax dominance dedup and its interpret-mode Pallas
compactions here, bit for bit (tolerance 0: the keys are integers).
Last, the property the one-launch compactions' speed rests on: the
sparse engine hands them live keys and pairs in ascending order."""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.lin import bfs as jbfs
from jepsen_tpu.lin import psort as jpsort
from jepsen_tpu_torch import _u32
from jepsen_tpu_torch import models as tm
from jepsen_tpu_torch.lin import bfs as tbfs
from jepsen_tpu_torch.lin import dense_cuda, prepare, psort, psort_cuda
from jepsen_tpu_torch.lin import synth as tsynth

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the card's inputs, built by numpy alone)

FILL = 0xFFFFFFFF
# Valid 16-byte entries the one-launch path sorts in shared memory
# (psort_dom_one_shared_max_n(1) in csrc/psort.cu: 96 KiB a buffer), and
# 8-byte ones (psort_dom_one_shared_max_n(0); also the live pairs the
# one-launch compaction sorts there, psort_compact2_one_shared_max_n()).
SHARED_PAIRS = 6144
SHARED_SINGLE = 12_288
# The in-chunk row tiers' dominance dedups at M = 32 (the pair crash-dom
# headline) and M = 16 (the single-key one): tier * (1 + M) entries.
M = 32
M1 = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the dense kernel --------------------------------------------------------

# Shared memory a block may take on the H100 (the opt-in maximum), and
# the sliced kernel's static share (15 x 32 masks and the targets).
BLOCK_SHARED_BYTES = 232_448
SLICED_STATIC_BYTES = 2 * 1024


@pytest.mark.parametrize("w", range(1, dense_cuda.MAX_W + 1))
def test_dense_kernel_path_by_width(w):
    """Up to SHARED_MAX_W the bitmap fits a block's shared memory as 32
    state slices (4 * 2^w bytes, at least a word a slice) with one
    thread a slice word, at most 1024; from the next width it does not,
    and the device-memory kernel takes it."""
    path = dense_cuda.kernel_path(w)
    fits = 4 * max(1 << w, 32) + SLICED_STATIC_BYTES <= BLOCK_SHARED_BYTES \
        and max(32, 1 << max(w - 5, 0)) <= 1024
    assert path == ("sliced" if w <= dense_cuda.SHARED_MAX_W else "device")
    assert fits == (path == "sliced")


def test_dense_headline_widths_take_the_sliced_kernel():
    from jepsen_tpu_torch.lin import dense

    # The dense headline's chunks run at w 14, its wide history at 16.
    assert [dense_cuda.kernel_path(w) for w in (13, 14, 16)] == \
        ["sliced", "sliced", "device"]
    # Every width bucket of the dense engine takes one of the two.
    assert {dense_cuda.kernel_path(b) for b in dense._W_BUCKETS} == \
        {"sliced", "device"}
    with pytest.raises(ValueError):
        dense_cuda.kernel_path(dense_cuda.MAX_W + 1)


def test_dense_chunk_raises_without_a_kernel():
    """A tensor on a device that is neither the CPU nor a card raises;
    nothing falls back to the plain version."""
    w, ns = 4, 8
    F = torch.zeros(1 << w, dtype=torch.int32, device="meta")
    masks = torch.zeros(2, w, ns, dtype=torch.int32, device="meta")
    ret = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        dense_cuda.dense_chunk(F, 2, masks, ret, w=w, ns=ns)
    cpu = torch.zeros(1 << 21, dtype=torch.int32)
    no_rows = torch.zeros(0, 21, ns, dtype=torch.int32)
    with pytest.raises(ValueError):
        dense_cuda.dense_chunk(cpu, 0, no_rows,
                               torch.zeros(0, dtype=torch.int32), w=21, ns=ns)


# --- the pair dominance dedup's routes ---------------------------------------

@pytest.mark.parametrize("tier", tbfs.ROW_TIERS)
def test_dom_route_of_each_in_chunk_tier(tier):
    n = tier * (1 + M)
    one = psort.pad_size(n) <= psort.DOM_ONE_MAX_N
    assert psort.dom_one_launch(n) == one
    # The tiers the pair crash-dom headline runs most (256 .. 4096) take
    # the one launch.
    assert one == (tier <= 4096)


@pytest.mark.parametrize("cap", [262_144, 524_288])
def test_dom_host_caps_keep_the_multi_launch_chain(cap):
    n = cap * (1 + M)
    assert not psort.dom_one_launch(n)
    assert psort.pad_size(n) <= psort.DOM_MAX_N


def test_dom_gate_is_a_power_of_two_inside_the_kernels_limit():
    g = psort.DOM_ONE_MAX_N
    assert g & (g - 1) == 0 and psort.MIN_N <= g <= psort.DOM_MAX_N
    assert psort.dom_one_launch(g) and not psort.dom_one_launch(g + 1)


@pytest.mark.parametrize("n", [1, 1000, SHARED_PAIRS, SHARED_PAIRS + 1,
                               8448, 33_792, 135_168, 1 << 18])
def test_dom_scratch_of_each_path(n):
    """The one launch needs no device scratch while every entry fits its
    shared buffers, else two entry buffers of n entries and n / 32 + 1
    keep words; always less than the multi-launch chain's five buffers
    of n_pad."""
    words = psort_cuda.dom_one_scratch_words(n, True, SHARED_PAIRS)
    if n <= SHARED_PAIRS:
        assert words == 1
    else:
        assert words == 2 * n * 2 + (n // 32 + 2) // 2
        assert 8 * words >= 2 * 16 * n + 4 * (n // 32 + 1)
    n_pad = psort.pad_size(n)
    multi = sum(t.numel() * t.element_size() for t in
                psort_cuda._dom_scratch(n_pad, 2, torch.int64, "meta"))
    assert multi == (2 * 16 + 1 + 8) * n_pad + 4 * (n_pad // 1024 + 1)
    assert 8 * words < multi


def _meta_words(n):
    return [torch.zeros(n, dtype=torch.int32, device="meta")
            for _ in range(4)]


def test_dom_wrapper_raises_without_a_kernel():
    with pytest.raises(ValueError, match="cuda or cpu"):
        psort.dedup_keys2_dom(*_meta_words(1024), 0, 0, 0, 0, 256,
                              force=True)


@pytest.mark.parametrize("n,route", [(8448, "one"), (1 << 18, "one"),
                                     ((1 << 18) + 1, "multi"),
                                     (262_144 * 33, "multi")])
def test_dom_wrapper_routes_by_padded_size(monkeypatch, n, route):
    """The wrapper sends each call to one launcher by n_pad, with the
    rounds and chain of its mode, and counts one launch a call."""
    calls = []

    def one(*args):
        calls.append(("one", args[8:]))
        return None, None, torch.zeros(2, dtype=torch.int32)

    def multi(*args):
        calls.append(("multi", args[8:]))
        return None, None, torch.zeros(2, dtype=torch.int32)

    monkeypatch.setattr(psort, "_dom_kernel_args", lambda *a: None)
    monkeypatch.setattr(psort_cuda, "dedup2_dom_one", one)
    monkeypatch.setattr(psort_cuda, "dedup2_dom", multi)
    before = psort.LAUNCHES["dedup_keys2_dom"]
    psort.dedup_keys2_dom(*_meta_words(n), 0, 0, 0, 0, 256, force=True,
                          iters=6)
    assert psort.LAUNCHES["dedup_keys2_dom"] == before + 1
    want = (256, psort.DOM_CHAIN, 6) if route == "one" else \
        (256, psort.pad_size(n), psort.DOM_CHAIN, 6)
    assert calls == [(route, want)]


# --- the card's new inputs against the reference ---------------------------

MODES = ((True, 2), (True, 6), (False, 1))


@functools.lru_cache(maxsize=None)
def _jax_dom(n, force, iters):
    return jax.jit(lambda hi, lo, valid, *m: jbfs._dedup_keys2_dom(
        hi, lo, valid, n, *m, use_psort=False, dom_force=force,
        dom_iters=iters))


def _case(label):
    rng = np.random.default_rng(91)
    cases = {c[0]: c for c in chip_smoke.dom_cases(rng, SHARED_PAIRS, True)}
    return cases[label]


@pytest.mark.parametrize("label,want", [("chain-128", [128, 128, 255]),
                                        ("every-entry-equal", [1, 1, 1])])
def test_card_inputs_match_the_reference(label, want):
    _, key, valid, cap, _, counts = _case(label)
    assert counts == want
    cmask, rmask = chip_smoke.DOM_MASKS[True]
    mw = chip_smoke.dom_mask_words(True, cmask, rmask)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    lo = key.astype(np.uint32)
    v = torch.from_numpy(valid)
    words = tbfs._dom_split2(_u32.bitmap_from_numpy(hi, "cpu"),
                             _u32.bitmap_from_numpy(lo, "cpu"), v, *mw)
    got_counts = []
    for force, iters in MODES:
        got = psort.dedup_keys2_dom_plain(*words, *mw, cap, force=force,
                                          iters=iters)
        out = _jax_dom(key.size, force, iters)(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
            *(jnp.uint32(x) for x in mw))
        *ref, total, _ = (np.asarray(x) for x in out)
        assert min(int(total), cap) == int(got[-2])
        assert (int(total) > cap) == bool(got[-1])
        for g, r in zip(got[:2], ref):
            g = _u32.bitmap_to_numpy(g)
            r = r[:cap]
            assert np.array_equal(g[:r.size], r)
            assert (g[r.size:] == FILL).all()
        got_counts.append(int(got[-2]))
    assert got_counts == want


@pytest.mark.parametrize("which", [0, 1, 2])
def test_card_capacity_inputs_straddle_the_shared_path(which):
    label, key, valid, cap, routes, path = _case(
        f"live={SHARED_PAIRS - 1 + which}")
    assert int(valid.sum()) == SHARED_PAIRS - 1 + which
    assert path == ("device" if which == 2 else "shared")
    assert routes == ("gate", "multi")
    assert psort.dom_one_launch(key.size)


# --- the single-key dominance dedup's routes ---------------------------------

@pytest.mark.parametrize("tier", tbfs.ROW_TIERS)
def test_dom1_route_of_each_in_chunk_tier(tier):
    n = tier * (1 + M1)
    one = psort.pad_size(n) <= psort.DOM1_ONE_MAX_N
    assert psort.dom_one_launch(n, pair=False) == one
    # The single-key crash-dom headline's tiers 256 .. 4096 (n_pad 8,192
    # .. 131,072) take the one launch.
    assert one == (tier <= 4096)


@pytest.mark.parametrize("cap", [262_144, 524_288])
def test_dom1_host_caps_keep_the_multi_launch_chain(cap):
    for m in (M1, M):
        n = cap * (1 + m)
        assert not psort.dom_one_launch(n, pair=False)
        assert psort.pad_size(n) <= psort.DOM_MAX_N


def test_dom1_gate_is_a_power_of_two_inside_the_kernels_limit():
    g = psort.DOM1_ONE_MAX_N
    assert g & (g - 1) == 0 and psort.MIN_N <= g <= psort.DOM_MAX_N
    assert psort.dom_one_launch(g, pair=False)
    assert not psort.dom_one_launch(g + 1, pair=False)


@pytest.mark.parametrize("n", [1, 4352, SHARED_SINGLE, SHARED_SINGLE + 1,
                               16_384, 69_632, 1 << 18])
def test_dom1_scratch_of_each_path(n):
    """As the pair dedup's: no device scratch while the valid entries
    fit the shared buffers (12,288 8-byte entries), else two buffers of n
    entries and n / 32 + 1 keep words; less than the chain's."""
    words = psort_cuda.dom_one_scratch_words(n, False, SHARED_SINGLE)
    if n <= SHARED_SINGLE:
        assert words == 1
    else:
        assert words == 2 * n + (n // 32 + 2) // 2
        assert 8 * words >= 2 * 8 * n + 4 * (n // 32 + 1)
    n_pad = psort.pad_size(n)
    multi = sum(t.numel() * t.element_size() for t in
                psort_cuda._dom_scratch(n_pad, 1, torch.int32, "meta"))
    assert multi == (2 * 8 + 1 + 4) * n_pad + 4 * (n_pad // 1024 + 1)
    assert 8 * words < multi


def test_dom1_wrapper_raises_without_a_kernel():
    with pytest.raises(ValueError, match="cuda or cpu"):
        psort.dedup_keys_dom(*_meta_words(1024)[:2], 0, 0, 256, force=True)


@pytest.mark.parametrize("n,route", [(4352, "one"), (69_632, "one"),
                                     (1 << 18, "one"),
                                     ((1 << 18) + 1, "multi"),
                                     (262_144 * 17, "multi")])
def test_dom1_wrapper_routes_by_padded_size(monkeypatch, n, route):
    """The single-key wrapper sends each call to one launcher by n_pad,
    with the rounds and chain of its mode, and counts one launch a
    call."""
    calls = []

    def one(*args):
        calls.append(("one", args[4:]))
        return None, torch.zeros(2, dtype=torch.int32)

    def multi(*args):
        calls.append(("multi", args[4:]))
        return None, torch.zeros(2, dtype=torch.int32)

    monkeypatch.setattr(psort, "_dom_kernel_args", lambda *a: None)
    monkeypatch.setattr(psort_cuda, "dedup_dom_one", one)
    monkeypatch.setattr(psort_cuda, "dedup_dom", multi)
    before = psort.LAUNCHES["dedup_keys_dom"]
    psort.dedup_keys_dom(*_meta_words(n)[:2], 0, 0, 256, force=True, iters=6)
    assert psort.LAUNCHES["dedup_keys_dom"] == before + 1
    want = (256, psort.DOM_CHAIN, 6) if route == "one" else \
        (256, psort.pad_size(n), psort.DOM_CHAIN, 6)
    assert calls == [(route, want)]


@functools.lru_cache(maxsize=None)
def _jax_dom1(n, force, iters):
    return jax.jit(lambda key, valid, *m: jbfs._dedup_keys_dom(
        key, valid, n, *m, use_psort=False, dom_force=force,
        dom_iters=iters))


def _case1(label):
    rng = np.random.default_rng(90)
    cases = {c[0]: c for c in chip_smoke.dom_cases(rng, SHARED_SINGLE,
                                                   False)}
    return cases[label]


@pytest.mark.parametrize("label", ["chain-128", "every-entry-equal",
                                   f"live={SHARED_SINGLE - 1}",
                                   f"live={SHARED_SINGLE}",
                                   f"live={SHARED_SINGLE + 1}"])
def test_card_inputs_of_the_single_key_dedup_match_the_reference(label):
    """The single-key dedup's card inputs through its plain version and
    the reference's lax dominance dedup (jitted at cap = n, cut to cap),
    in every mode: bit for bit, and the counts the card asserts."""
    _, key, valid, cap, routes, want = _case1(label)
    assert routes == ("gate", "multi")
    cmask, rmask = chip_smoke.DOM_MASKS[False]
    k = key.astype(np.uint32)
    assert np.array_equal(k.astype(np.uint64), key)     # single u32 keys
    words = tbfs._dom_split(_u32.bitmap_from_numpy(k, "cpu"),
                            torch.from_numpy(valid), cmask, rmask)
    got_counts = []
    for force, iters in MODES:
        got = psort.dedup_keys_dom_plain(*words, cmask, rmask, cap,
                                         force=force, iters=iters)
        ref, total, _ = (np.asarray(x) for x in _jax_dom1(
            key.size, force, iters)(jnp.asarray(k), jnp.asarray(valid),
                                    jnp.uint32(cmask), jnp.uint32(rmask)))
        assert min(int(total), cap) == int(got[1])
        assert (int(total) > cap) == bool(got[2])
        g = _u32.bitmap_to_numpy(got[0])
        r = ref[:cap]
        assert np.array_equal(g[:r.size], r)
        assert (g[r.size:] == FILL).all()
        got_counts.append(int(got[1]))
    if isinstance(want, list):
        assert got_counts == want
    else:
        live = int(label.split("=")[1])
        assert int(valid.sum()) == live
        assert want == ("device" if live > SHARED_SINGLE else "shared")
        assert psort.dom_one_launch(key.size, pair=False)


# --- the compactions' routes ------------------------------------------------

# Live 4-byte keys the one-launch compaction sorts in shared memory
# (psort_compact_one_shared_max_n(): two 96 KiB buffers); pairs take
# SHARED_SINGLE.
SHARED_COMPACT = 24_576


def _compact_routes(monkeypatch, width, n, route):
    """The compaction of ``width``-byte keys (4: ``compact_keys``, 8:
    ``compact_keys2``) sends each call to one launcher by n_pad (the one
    launch up to its gate, the bitonic network above, up to PSORT_MAX_N),
    checks the size against that launcher's limit, and counts one launch
    a call."""
    calls, limits = [], []
    count = torch.zeros(1, dtype=torch.int32)

    def one(*args):
        calls.append(("one", args[-1]))
        return (None,) * (len(args) - 1) + (count,)

    def bitonic(*args):
        calls.append(("bitonic", *args[-2:]))
        return (None,) * (len(args) - 2) + (count,)

    suffix = "" if width == 4 else "2"
    if width == 4:
        monkeypatch.setattr(psort, "_kernel_args",
                            lambda keys, what, max_n: limits.append(max_n))
    else:
        monkeypatch.setattr(psort, "_pair_kernel_args",
                            lambda hi, lo, what, max_n: limits.append(max_n))
    monkeypatch.setattr(psort_cuda, f"compact{suffix}_one", one)
    monkeypatch.setattr(psort_cuda, f"compact{suffix}", bitonic)
    name = f"compact_keys{suffix}"
    before = psort.LAUNCHES[name]
    getattr(psort, name)(*_meta_words(n)[:width // 4], 256)
    assert psort.LAUNCHES[name] == before + 1
    gate = psort.compact_one_launch if width == 4 \
        else psort.compact2_one_launch
    assert gate(n) == (route == "one")
    if route == "one":
        assert calls == [("one", 256)]
        assert limits == [psort.COMPACT_ONE_LIMIT]
    else:
        assert calls == [("bitonic", 256, psort.pad_size(n))]
        assert limits == [psort.PSORT_MAX_N]


@pytest.mark.parametrize("n,route", [(1024, "one"), (1500, "one"),
                                     (16_384, "one"), (1 << 17, "one"),
                                     (1 << 18, "one"),
                                     ((1 << 18) + 1, "bitonic"),
                                     (1 << 19, "bitonic")])
def test_compact_wrapper_routes_by_padded_size(monkeypatch, n, route):
    _compact_routes(monkeypatch, 4, n, route)


@pytest.mark.parametrize("n,route", [(1024, "one"), (1500, "one"),
                                     (16_384, "one"), (1 << 17, "one"),
                                     ((1 << 17) + 1, "bitonic"),
                                     (1 << 19, "bitonic")])
def test_compact2_wrapper_routes_by_padded_size(monkeypatch, n, route):
    _compact_routes(monkeypatch, 8, n, route)


def _gate_inside_limits(g, launch):
    assert g & (g - 1) == 0 and psort.MIN_N <= g <= psort.PSORT_MAX_N
    assert g <= psort.COMPACT_ONE_LIMIT
    assert launch(g) and not launch(g + 1)


def test_compact_gate_sits_inside_both_launchers_limits():
    _gate_inside_limits(psort.COMPACT_ONE_MAX_N, psort.compact_one_launch)


def test_compact2_gate_sits_inside_both_launchers_limits():
    _gate_inside_limits(psort.COMPACT2_ONE_MAX_N, psort.compact2_one_launch)


@pytest.mark.parametrize("cap", tbfs.ROW_TIERS
                         + tbfs.PACKED_CAP_SCHEDULE[-1:])
def test_compact_route_of_each_in_chunk_cap(cap):
    """The single-key return filter compacts cap keys at every row tier
    and chunk cap up to 131,072 (n_pad 1,024 ... 131,072 on the sparse
    headline): each takes the one launch."""
    assert psort.compact_one_launch(cap)


def _scratch_of_each_path(width, shared, n):
    """Two buffers of n keys of the keys' own width past the live keys
    shared memory holds (192 KiB over two buffers of width-byte keys),
    else one unused word."""
    assert shared == 192 * 1024 // 2 // width
    words = psort_cuda.compact_one_scratch_words(n, shared)
    assert words == (1 if n <= shared else 2 * n)


@pytest.mark.parametrize("n", [1, 1024, SHARED_COMPACT, SHARED_COMPACT + 1,
                               1 << 18])
def test_compact_scratch_of_each_path(n):
    _scratch_of_each_path(4, SHARED_COMPACT, n)


@pytest.mark.parametrize("n", [1, 1024, SHARED_SINGLE, SHARED_SINGLE + 1,
                               1 << 17])
def test_compact2_scratch_of_each_path(n):
    _scratch_of_each_path(8, SHARED_SINGLE, n)


@pytest.mark.parametrize("n", [1024, 1 << 19])
def test_compact_wrapper_raises_without_a_kernel(n):
    with pytest.raises(ValueError, match="cuda or cpu"):
        psort.compact_keys(_meta_words(n)[0], 256)


def test_compact2_wrapper_raises_without_a_kernel():
    words = _meta_words(1024)
    with pytest.raises(ValueError, match="cuda or cpu"):
        psort.compact_keys2(words[0], words[1], 256)


@pytest.fixture(scope="module")
def compact_cases():
    """The single-key one-launch compaction's card inputs at n = 1024
    with the reference's interpret-mode Pallas ``compact_keys`` outputs."""
    rng = np.random.default_rng(85)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_PSORT", "interpret")
        for label, keys, cap in chip_smoke.compact_cases(rng, 1024):
            ref = jpsort.compact_keys(jnp.asarray(keys), cap)
            out.append((label, keys, cap, tuple(np.asarray(x) for x in ref)))
    return out


@pytest.mark.parametrize("which", range(5))
def test_compact_card_inputs_match_pallas(compact_cases, which):
    label, keys, cap, (rk, rc) = compact_cases[which]
    live = keys != FILL
    lk = keys[live]
    down = np.flatnonzero(lk[1:] < lk[:-1])            # unsigned order
    high = lk >= np.uint32(1 << 31)
    if which == 0:
        assert down.size == 0 and live.sum() > cap
    elif which == 1:
        assert down.tolist() == [lk.size - 2]
    elif which == 2:
        assert down.size == 0 and high.any() and not high.all()
    elif which == 3:
        assert down.size == 1 and high[down[0]] and not high[down[0] + 1]
    else:
        assert not live.any()
    args = (_u32.bitmap_from_numpy(keys, "cpu"), cap)
    tk, tc = psort.compact_keys_plain(*args)
    assert np.array_equal(_u32.bitmap_to_numpy(tk), rk.astype(np.uint32))
    assert int(tc) == int(rc) == min(int(live.sum()), cap)
    before = dict(psort.LAUNCHES)
    wrapped = psort.compact_keys(*args)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, (tk, tc)))
    assert psort.LAUNCHES == before            # plain on the CPU


@pytest.fixture(scope="module")
def compact2_cases():
    """The one-launch compaction's card inputs at n = 1024 with the
    reference's interpret-mode Pallas ``compact_keys2`` outputs."""
    rng = np.random.default_rng(83)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JEPSEN_TPU_PSORT", "interpret")
        for label, hi, lo, cap in chip_smoke.compact2_cases(rng, 1024):
            ref = jpsort.compact_keys2(jnp.asarray(hi), jnp.asarray(lo), cap)
            out.append((label, hi, lo, cap,
                        tuple(np.asarray(x) for x in ref)))
    return out


@pytest.mark.parametrize("which", [0, 1, 2])
def test_compact2_card_inputs_match_pallas(compact2_cases, which):
    label, hi, lo, cap, (rh, rl, rc) = compact2_cases[which]
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    live = key != np.uint64((1 << 64) - 1)
    lk = key[live]
    descents = int((lk[1:] < lk[:-1]).sum())
    if which == 0:
        assert descents == 0 and live.sum() > cap
    elif which == 1:
        assert descents == 1 and lk[-1] < lk[-2]
    else:
        assert descents == 0 and hi[np.flatnonzero(live)[-1]] == FILL
    args = (_u32.bitmap_from_numpy(hi, "cpu"),
            _u32.bitmap_from_numpy(lo, "cpu"), cap)
    th, tl, tc = psort.compact_keys2_plain(*args)
    assert np.array_equal(_u32.bitmap_to_numpy(th), rh.astype(np.uint32))
    assert np.array_equal(_u32.bitmap_to_numpy(tl), rl.astype(np.uint32))
    assert int(tc) == int(rc) == min(int(live.sum()), cap)
    before = dict(psort.LAUNCHES)
    wrapped = psort.compact_keys2(*args)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, (th, tl, tc)))
    assert psort.LAUNCHES == before            # plain on the CPU


def test_engine_hands_the_pair_compaction_ascending_live_pairs(monkeypatch):
    """The sparse engine's pair return filter compacts survivors of an
    ascending frontier with one bit cleared: the live pairs it hands
    ``compact_keys2`` are ascending in input order, with KEY_FILL holes,
    which is what keeps the one launch on its ordered path (speed, not
    correctness: the kernel sorts any other input)."""
    h = tsynth.generate_register_history(300, concurrency=40, seed=3,
                                         value_range=60)
    p = prepare.prepare(tm.cas_register(), h)
    assert tbfs.band_error(p) is None and p.window >= 26
    seen = []
    compact = psort.compact_keys2

    def spy(hi, lo, cap):
        seen.append(_u32.pair_key(hi, lo))
        return compact(hi, lo, cap)

    monkeypatch.setattr(psort, "compact_keys2", spy)
    r = tbfs.check_packed(p, device="cpu")
    assert r["valid?"] is True and r["engine-stats"]["compactions"] > 0
    assert seen
    holes = 0
    for k in seen:
        live = k[k != _u32.PAIR_FILL]
        assert bool((live[1:] > live[:-1]).all())
        holes += int(live.numel() < k.numel())
    assert holes == len(seen)


def test_engine_hands_the_compaction_ascending_live_keys(monkeypatch):
    """The single-key twin: the return filter (``bfs._filter_pass_keys``)
    of a window-22 history hands ``compact_keys`` live keys ascending in
    input order (unsigned), with KEY_FILL holes."""
    h = tsynth.generate_register_history(200, concurrency=24, seed=3,
                                         value_range=5)
    p = prepare.prepare(tm.cas_register(), h)
    assert tbfs.band_error(p) is None and p.window <= 23
    assert not tbfs._Engine(p, "cpu").pair
    seen = []
    compact = psort.compact_keys

    def spy(keys, cap):
        seen.append(_u32.widen(keys))
        return compact(keys, cap)

    monkeypatch.setattr(psort, "compact_keys", spy)
    r = tbfs.check_packed(p, device="cpu")
    assert r["valid?"] is True
    assert len(seen) == r["engine-stats"]["compactions"] > 0
    for k in seen:
        live = k[k != FILL]
        assert bool((live[1:] > live[:-1]).all())
        assert live.numel() < k.numel()
