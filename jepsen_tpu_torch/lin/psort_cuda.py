"""ctypes binding of ``csrc/psort.cu``: the CUDA kernels behind
:func:`jepsen_tpu_torch.lin.psort.dedup_keys`,
:func:`jepsen_tpu_torch.lin.psort.compact_keys`, their pair-key
twins ``dedup_keys2`` and ``compact_keys2``, and the dominance dedups
``dedup_keys_dom`` and ``dedup_keys2_dom``.

The functions here take CUDA tensors that the wrappers in
:mod:`jepsen_tpu_torch.lin.psort` have checked, allocate the outputs and
scratch, and launch on the current stream. They do not synchronise.
Keys are raw int32 tensors read as ``uint32_t``
(:mod:`jepsen_tpu_torch._u32`); the pair kernels sort ``uint64_t`` keys
``hi << 32 | lo`` in an int64 scratch buffer. The dedups' int32 scratch
(look-back status words, histograms, tickets and the pass plan) is sized
by the library itself (``psort_dedup_scratch_words``). Each dominance
dedup has two routes, which its wrapper chooses from n_pad: one launch
(:func:`dedup_dom_one`, :func:`dedup2_dom_one`) or the multi-launch chain
(:func:`dedup_dom`, :func:`dedup2_dom`); so has each compaction: one
launch (:func:`compact_one`, :func:`compact2_one`) or the bitonic network
(:func:`compact`, :func:`compact2`).
"""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch import _build

_lib = None
# Values of the one-launch kernels' path word: the keys were sorted in
# shared memory, or in the device-memory scratch; or (the compaction)
# they were in order and kept it, with no sort.
PATH_SHARED, PATH_DEVICE, PATH_ORDERED = 1, 2, 4
# The route of the latest dominance dedup of either band ("one" or
# "multi") and, for "one", its path word (int32[1] on the card), for
# checks that every path ran; the same for the latest compaction of each
# key width in bytes ("one" or "bitonic"; 4: compact_keys, 8:
# compact_keys2).
last_dom_route = None
last_dom_path = None
last_compact_route = {4: None, 8: None}
last_compact_path = {4: None, 8: None}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("psort")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.psort_dedup_scratch_words.argtypes = [i, i]
        lib.psort_dedup_scratch_words.restype = i
        lib.psort_dedup_kernel_launches.argtypes = []
        lib.psort_dedup_kernel_launches.restype = ctypes.c_longlong
        lib.psort_dedup_launch.argtypes = [p, p, i, i, p, p, p, p, p]
        lib.psort_dedup_launch.restype = i
        lib.psort_compact_launch.argtypes = [p, i, i, i, p, p, p, p]
        lib.psort_compact_launch.restype = i
        lib.psort_dedup2_launch.argtypes = [p, p, p, i, i, p, p, p, p, p,
                                            p]
        lib.psort_dedup2_launch.restype = i
        lib.psort_compact2_launch.argtypes = [p, p, i, i, i, p, p, p, p, p]
        lib.psort_compact2_launch.restype = i
        lib.psort_compact_one_launch.argtypes = [p, i, i, p, p, p, p]
        lib.psort_compact_one_launch.restype = i
        lib.psort_compact2_one_launch.argtypes = [p, p, i, i, p, p, p, p, p]
        lib.psort_compact2_one_launch.restype = i
        lib.psort_compact_one_shared_max_n.argtypes = []
        lib.psort_compact_one_shared_max_n.restype = i
        lib.psort_compact2_one_shared_max_n.argtypes = []
        lib.psort_compact2_one_shared_max_n.restype = i
        u = ctypes.c_uint32
        lib.psort_dedup_dom_launch.argtypes = [p, p, u, u, i, i, i, i, i,
                                               p, p, p, p, p, p, p, p]
        lib.psort_dedup_dom_launch.restype = i
        lib.psort_dedup_dom_one_launch.argtypes = [p, p, u, u, i, i, i, i, p,
                                                   p, p, p]
        lib.psort_dedup_dom_one_launch.restype = i
        lib.psort_dedup2_dom_launch.argtypes = [p, p, p, p, u, u, u, u, i,
                                                i, i, i, i, p, p, p, p, p,
                                                p, p, p, p]
        lib.psort_dedup2_dom_launch.restype = i
        lib.psort_dedup2_dom_one_launch.argtypes = [p, p, p, p, u, u, u, u,
                                                    i, i, i, i, p, p, p, p,
                                                    p]
        lib.psort_dedup2_dom_one_launch.restype = i
        lib.psort_dom_one_shared_max_n.argtypes = [i]
        lib.psort_dom_one_shared_max_n.restype = i
        lib.psort_dom_kernel_launches.argtypes = []
        lib.psort_dom_kernel_launches.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str, **sizes) -> None:
    if rc != 0:
        shape = ", ".join(f"{k}={v}" for k, v in sizes.items())
        raise _build.LaunchError(
            f"{what} kernel launch failed: CUDA error {rc} "
            f"({shape})")


def dedup_kernel_launches() -> int:
    """Kernels the radix dedups have launched since the library was
    loaded: 2 + key bytes a call (the load, one pass per 8-bit digit and
    the finish)."""
    return int(_load().psort_dedup_kernel_launches())


def _dedup_scratch(lib, n: int, key_bytes: int, dev):
    """The radix dedup's scratch: two key buffers of n keys (int32 words
    for single keys, int64 for pairs) and its int32 status words."""
    dtype = torch.int32 if key_bytes == 4 else torch.int64
    return (torch.empty(2 * n, dtype=dtype, device=dev),
            torch.empty(lib.psort_dedup_scratch_words(n, key_bytes),
                        dtype=torch.int32, device=dev))


def dedup(key: torch.Tensor, valid: torch.Tensor, cap: int):
    """Launch the radix sort-dedup. Returns (keys int32[cap], flags
    int32[2] = (count, overflow)) on the keys' device."""
    lib = _load()
    n = key.numel()
    dev = key.device
    work, scratch = _dedup_scratch(lib, n, 4, dev)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.psort_dedup_launch(
            key.data_ptr(), valid.data_ptr(), n, cap, work.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), flags.data_ptr(),
            _stream(key))
    _raise_on(rc, "psort dedup_keys", n=n, cap=cap)
    return out, flags


def _compact_bitonic(words_in, cap: int, n_pad: int):
    """Launch the bitonic compaction of ``words_in``: (keys,) for single
    keys, (hi, lo) for pairs. Returns the outputs int32[cap], one per
    input word, and count int32[1] on the keys' device."""
    lib = _load()
    width = 4 * len(words_in)
    lo = words_in[-1]
    n = lo.numel()
    dev = lo.device
    work = torch.empty(n_pad, dtype=torch.int32 if width == 4
                       else torch.int64, device=dev)
    outs = [torch.empty(cap, dtype=torch.int32, device=dev)
            for _ in words_in]
    count = torch.empty(1, dtype=torch.int32, device=dev)
    fn = lib.psort_compact_launch if width == 4 else lib.psort_compact2_launch
    with torch.cuda.device(dev):
        rc = fn(*(w.data_ptr() for w in words_in), n, n_pad, cap,
                work.data_ptr(), *(o.data_ptr() for o in outs),
                count.data_ptr(), _stream(lo))
    _raise_on(rc, "psort compact_keys" + ("" if width == 4 else "2"), n=n,
              n_pad=n_pad, cap=cap)
    last_compact_route[width], last_compact_path[width] = "bitonic", None
    return (*outs, count)


def compact(keys: torch.Tensor, cap: int, n_pad: int):
    """Launch the compaction's bitonic sort. Returns (keys int32[cap],
    count int32[1]) on the keys' device."""
    return _compact_bitonic((keys,), cap, n_pad)


def dedup2(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
           cap: int):
    """Launch the pair radix sort-dedup. Returns (hi int32[cap], lo
    int32[cap], flags int32[2] = (count, overflow)) on the keys' device."""
    lib = _load()
    n = lo.numel()
    dev = lo.device
    work, scratch = _dedup_scratch(lib, n, 8, dev)
    out_hi = torch.empty(cap, dtype=torch.int32, device=dev)
    out_lo = torch.empty(cap, dtype=torch.int32, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.psort_dedup2_launch(
            hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), n, cap,
            work.data_ptr(), scratch.data_ptr(), out_hi.data_ptr(),
            out_lo.data_ptr(), flags.data_ptr(), _stream(lo))
    _raise_on(rc, "psort dedup_keys2", n=n, cap=cap)
    return out_hi, out_lo, flags


def compact2(hi: torch.Tensor, lo: torch.Tensor, cap: int, n_pad: int):
    """Launch the pair compaction's bitonic sort. Returns (hi int32[cap],
    lo int32[cap], count int32[1]) on the keys' device."""
    return _compact_bitonic((hi, lo), cap, n_pad)


def compact_shared_max_n(width: int) -> int:
    """Live keys of ``width`` bytes (4: single keys, 8: pairs) that the
    one-launch compaction sorts in shared memory when they are out of
    order; a call with more sorts in its device-memory scratch."""
    lib = _load()
    return int(lib.psort_compact_one_shared_max_n() if width == 4
               else lib.psort_compact2_one_shared_max_n())


def compact_one_scratch_words(n: int, shared_n: int) -> int:
    """Words of the one-launch compaction's device scratch for n keys, of
    the keys' own width (int32 for single keys, int64 for pairs): two
    buffers of n keys where n exceeds ``shared_n``
    (:func:`compact_shared_max_n`: the live keys may not fit in shared
    memory), else one unused word."""
    return 1 if n <= shared_n else 2 * n


def _compact_one(words_in, cap: int):
    """Launch the compaction of ``words_in`` ((keys,) or (hi, lo)) in one
    launch: in order when the live keys arrive ascending, else sorted.
    Returns the outputs int32[cap], one per input word, and count
    int32[1] on the keys' device, and sets :data:`last_compact_path`."""
    lib = _load()
    width = 4 * len(words_in)
    lo = words_in[-1]
    n = lo.numel()
    dev = lo.device
    scratch = torch.empty(
        compact_one_scratch_words(n, compact_shared_max_n(width)),
        dtype=torch.int32 if width == 4 else torch.int64, device=dev)
    outs = [torch.empty(cap, dtype=torch.int32, device=dev)
            for _ in words_in]
    words = torch.empty(2, dtype=torch.int32, device=dev)
    fn = lib.psort_compact_one_launch if width == 4 \
        else lib.psort_compact2_one_launch
    with torch.cuda.device(dev):
        rc = fn(*(w.data_ptr() for w in words_in), n, cap,
                scratch.data_ptr(), *(o.data_ptr() for o in outs),
                words.data_ptr(), _stream(lo))
    _raise_on(rc, "psort compact_keys" + ("" if width == 4 else "2")
              + " (one launch)", n=n, cap=cap)
    last_compact_route[width], last_compact_path[width] = "one", words[1:]
    return (*outs, words[:1])


def compact_one(keys: torch.Tensor, cap: int):
    """Launch the compaction in one launch. Returns (keys int32[cap],
    count int32[1]) on the keys' device."""
    return _compact_one((keys,), cap)


def compact2_one(hi: torch.Tensor, lo: torch.Tensor, cap: int):
    """Launch the pair compaction in one launch. Returns (hi int32[cap],
    lo int32[cap], count int32[1]) on the keys' device."""
    return _compact_one((hi, lo), cap)


def dom_kernel_launches() -> int:
    """Kernels the dominance dedups have launched since the library was
    loaded: one a call on the one-launch path, 14 or more on the
    multi-launch path."""
    return int(_load().psort_dom_kernel_launches())


def dom_one_shared_max_n(pair: bool = True) -> int:
    """Valid entries the one-launch dominance dedup sorts in shared
    memory; a call with more sorts in its device-memory scratch."""
    return int(_load().psort_dom_one_shared_max_n(int(pair)))


def dom_one_scratch_words(n: int, pair: bool, shared_n: int) -> int:
    """int64 words of the one-launch dominance dedup's device scratch for
    n entries: two entry buffers of n entries (two words each for pairs)
    and n // 32 + 1 int32 keep words where n exceeds ``shared_n``
    (:func:`dom_one_shared_max_n`: the valid entries may not fit in shared
    memory), else one unused word."""
    if n <= shared_n:
        return 1
    return 2 * n * (2 if pair else 1) + (n // 32 + 2) // 2


def _dom_scratch(n_pad: int, entry_words: int, full_dtype, dev):
    """The dominance dedup's scratch: two entry buffers (``entry_words``
    int64 words an entry), the keep flags, the block counts and the full
    keys."""
    return (torch.empty(n_pad * entry_words, dtype=torch.int64, device=dev),
            torch.empty(n_pad * entry_words, dtype=torch.int64, device=dev),
            torch.empty(n_pad, dtype=torch.uint8, device=dev),
            torch.empty(n_pad // 1024 + 1, dtype=torch.int32, device=dev),
            torch.empty(n_pad, dtype=full_dtype, device=dev))


def dedup_dom(a: torch.Tensor, w: torch.Tensor, cmask: int, rmask: int,
              cap: int, n_pad: int, chain: int, rounds: int):
    """Launch the single-key dominance dedup's multi-launch chain. Returns
    (keys int32[cap], flags int32[2] = (count, overflow)) on the keys'
    device."""
    global last_dom_route, last_dom_path
    lib = _load()
    n = a.numel()
    dev = a.device
    e0, e1, keep, blocks, full = _dom_scratch(n_pad, 1, torch.int32, dev)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.psort_dedup_dom_launch(
            a.data_ptr(), w.data_ptr(), cmask & 0xFFFFFFFF,
            rmask & 0xFFFFFFFF, n, n_pad, cap, chain, rounds, e0.data_ptr(),
            e1.data_ptr(), keep.data_ptr(), blocks.data_ptr(),
            full.data_ptr(), out.data_ptr(), flags.data_ptr(), _stream(a))
    _raise_on(rc, "psort dedup_keys_dom", n=n, n_pad=n_pad, cap=cap)
    last_dom_route, last_dom_path = "multi", None
    return out, flags


def dedup_dom_one(a: torch.Tensor, w: torch.Tensor, cmask: int, rmask: int,
                  cap: int, chain: int, rounds: int):
    """Launch the single-key dominance dedup in one launch. Returns (keys
    int32[cap], flags int32[2] = (count, overflow)) on the keys' device
    and sets :data:`last_dom_path`."""
    global last_dom_route, last_dom_path
    lib = _load()
    n = a.numel()
    dev = a.device
    scratch = torch.empty(
        dom_one_scratch_words(n, False, dom_one_shared_max_n(False)),
        dtype=torch.int64, device=dev)
    out = torch.empty(cap, dtype=torch.int32, device=dev)
    words = torch.empty(3, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.psort_dedup_dom_one_launch(
            a.data_ptr(), w.data_ptr(), cmask & 0xFFFFFFFF,
            rmask & 0xFFFFFFFF, n, cap, chain, rounds, scratch.data_ptr(),
            out.data_ptr(), words.data_ptr(), _stream(a))
    _raise_on(rc, "psort dedup_keys_dom (one launch)", n=n, cap=cap)
    last_dom_route, last_dom_path = "one", words[2:]
    return out, words[:2]


def dedup2_dom(a_hi: torch.Tensor, a_lo: torch.Tensor, w_hi: torch.Tensor,
               w_lo: torch.Tensor, cmask_hi: int, cmask_lo: int,
               rmask_hi: int, rmask_lo: int, cap: int, n_pad: int,
               chain: int, rounds: int):
    """Launch the pair-key dominance dedup's multi-launch chain. Returns
    (hi int32[cap], lo int32[cap], flags int32[2] = (count, overflow)) on
    the keys' device."""
    global last_dom_route, last_dom_path
    lib = _load()
    n = a_lo.numel()
    dev = a_lo.device
    e0, e1, keep, blocks, full = _dom_scratch(n_pad, 2, torch.int64, dev)
    out_hi = torch.empty(cap, dtype=torch.int32, device=dev)
    out_lo = torch.empty(cap, dtype=torch.int32, device=dev)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    m = 0xFFFFFFFF
    with torch.cuda.device(dev):
        rc = lib.psort_dedup2_dom_launch(
            a_hi.data_ptr(), a_lo.data_ptr(), w_hi.data_ptr(),
            w_lo.data_ptr(), cmask_hi & m, cmask_lo & m, rmask_hi & m,
            rmask_lo & m, n, n_pad, cap, chain, rounds, e0.data_ptr(),
            e1.data_ptr(), keep.data_ptr(), blocks.data_ptr(),
            full.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(),
            flags.data_ptr(), _stream(a_lo))
    _raise_on(rc, "psort dedup_keys2_dom", n=n, n_pad=n_pad, cap=cap)
    last_dom_route, last_dom_path = "multi", None
    return out_hi, out_lo, flags


def dedup2_dom_one(a_hi: torch.Tensor, a_lo: torch.Tensor,
                   w_hi: torch.Tensor, w_lo: torch.Tensor, cmask_hi: int,
                   cmask_lo: int, rmask_hi: int, rmask_lo: int, cap: int,
                   chain: int, rounds: int):
    """Launch the pair-key dominance dedup in one launch. Returns (hi
    int32[cap], lo int32[cap], flags int32[2] = (count, overflow)) on the
    keys' device and sets :data:`last_dom_path`."""
    global last_dom_route, last_dom_path
    lib = _load()
    n = a_lo.numel()
    dev = a_lo.device
    scratch = torch.empty(
        dom_one_scratch_words(n, True, dom_one_shared_max_n(True)),
        dtype=torch.int64, device=dev)
    out_hi = torch.empty(cap, dtype=torch.int32, device=dev)
    out_lo = torch.empty(cap, dtype=torch.int32, device=dev)
    words = torch.empty(3, dtype=torch.int32, device=dev)
    m = 0xFFFFFFFF
    with torch.cuda.device(dev):
        rc = lib.psort_dedup2_dom_one_launch(
            a_hi.data_ptr(), a_lo.data_ptr(), w_hi.data_ptr(),
            w_lo.data_ptr(), cmask_hi & m, cmask_lo & m, rmask_hi & m,
            rmask_lo & m, n, cap, chain, rounds, scratch.data_ptr(),
            out_hi.data_ptr(), out_lo.data_ptr(), words.data_ptr(),
            _stream(a_lo))
    _raise_on(rc, "psort dedup_keys2_dom (one launch)", n=n, cap=cap)
    last_dom_route, last_dom_path = "one", words[2:]
    return out_hi, out_lo, words[:2]
