"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), at first use, into ``build/torch_kernels/`` beside the
package. Each ``csrc/<name>.cc`` (host code: the native packing walk) is
compiled the same way by the host compiler, ``g++``. The library's file
name carries a hash of its source and flags, so an edited source is
rebuilt rather than a stale library loaded. Several libraries build in
parallel: one compiler per source, all started together. A failed build
raises :class:`BuildError`, which the dispatch watchdog never takes for a
device fault (:func:`jepsen_tpu_torch.lin.supervise.run_guarded`); a
kernel's wrapper raises :class:`LaunchError` for the CUDA error code its
launch returned, which it does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build wall time, "ptxas": the compiler's output (for
# nvcc its resource report)}; empty for a library found already built.
BUILD_LOG: dict[str, dict] = {}


class BuildError(RuntimeError):
    """A native source did not build (or its compiler is missing)."""


class LaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error code."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise BuildError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def cxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise BuildError("g++ not found: the native packing walk builds with "
                       "the host's C++ compiler")


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def _target(name: str) -> tuple[Path, Path]:
    for suffix in (".cu", ".cc"):
        src = CSRC / f"{name}{suffix}"
        if src.exists():
            break
    else:
        raise FileNotFoundError(f"no source csrc/{name}.cu or .cc")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(_flags(src)).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names) -> None:
    """Compile every named library that is missing, in parallel: ``nvcc``
    for a ``.cu`` source, ``g++`` for a ``.cc`` one. Raises with the
    compiler's output if any build fails."""
    todo = [(n, *_target(n)) for n in names]
    todo = [(n, s, o) for n, s, o in todo if not o.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        exe = nvcc() if src.suffix == ".cu" else cxx()
        cmd = [exe, *_flags(src), "-o", str(tmp), str(src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: {Path(proc.args[0]).name} exit "
                          f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": log}
    if failed:
        raise BuildError("native build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            _libs[name] = lib
        return lib
