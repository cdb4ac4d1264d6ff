"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, in a fresh interpreter and in its sources."""

import ast
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "jepsen_tpu_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|jepsen_tpu)(\.|\s|$)", re.M)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_no_jax_in_a_fresh_interpreter():
    mods = list(_port_modules())
    assert "jepsen_tpu_torch.lin.dense_cuda" in mods
    assert "jepsen_tpu_torch.util" in mods
    assert "jepsen_tpu_torch.lin.supervise" in mods
    for m in ("jepsen_tpu_torch.stream", "jepsen_tpu_torch.stream.incr",
              "jepsen_tpu_torch.stream.session",
              "jepsen_tpu_torch.stream.runner"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'jepsen_tpu'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_and_chip_smoke_name_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files
                 for m in _FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    # The pattern itself must catch what it guards against, and must not
    # catch the port's own name.
    assert _FORBIDDEN.search("from jepsen_tpu.lin import dense")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from jepsen_tpu_torch.lin import dense")


# A string that names a path under the JAX package's directories: a
# ``native/...`` or ``jepsen_tpu/...`` path, or the bare directory name as
# an operand of ``/`` (``root / "native"``). A ``file.py:line`` tag (the
# JAX kernel a port kernel replaces) names a place to read, not a path the
# program opens.
_REF_PATH = re.compile(r"(^|[^\w.])(\.\./)*(native|jepsen_tpu)/")
_TAG = re.compile(r"^[\w/]+\.py:\d+$")


def _reference_paths(source: str) -> list[str]:
    tree = ast.parse(source)
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.ClassDef))
                  and n.body and isinstance(n.body[0], ast.Expr)
                  and isinstance(n.body[0].value, ast.Constant)}
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            for side in (node.left, node.right):
                if isinstance(side, ast.Constant) and \
                        side.value in ("native", "jepsen_tpu"):
                    found.append(f"line {node.lineno}: / {side.value!r}")
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings \
                and _REF_PATH.search(node.value) \
                and not _TAG.match(node.value):
            found.append(f"line {node.lineno}: {node.value!r}")
    return found


def test_port_sources_and_chip_smoke_read_no_jax_package_path():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)} {hit}" for p in files
                 for hit in _reference_paths(p.read_text())]
    assert offenders == []
    # The check catches what it guards against, and passes the port's
    # own paths and the kernel table's tags.
    assert _reference_paths('src = ROOT / "native" / "history_pack.cc"')
    assert _reference_paths('open("native/history_pack.cc")')
    assert _reference_paths('lib = "../jepsen_tpu/lin/prepare.py"')
    assert not _reference_paths('src = "jepsen_tpu_torch/csrc/psort.cu"')
    assert not _reference_paths('tag = "jepsen_tpu/lin/psort.py:741"')
    assert not _reference_paths('"""Mirrors native/history_pack.cc."""')


# The audit hook of :func:`_opened`: it records each file opened, each
# library loaded and each program started, their paths made absolute
# against the working directory, so a relative path is caught too.
_HOOK = (
    "import os, sys\n"
    "seen = []\n"
    "def _abs(x):\n"
    "    if isinstance(x, (str, bytes, os.PathLike)):\n"
    "        return os.path.abspath(os.fsdecode(x))\n"
    "    if isinstance(x, (list, tuple)):\n"
    "        return [_abs(y) for y in x]\n"
    "    return repr(x)\n"
    "def hook(event, args):\n"
    "    if event in ('open', 'ctypes.dlopen', 'subprocess.Popen'):\n"
    "        seen.append((event, repr(_abs(args[:2]))))\n"
    "sys.addaudithook(hook)\n")


def _opened(body: str) -> list:
    """(event, absolute paths) of what ``body`` opens, loads and starts,
    run in a fresh interpreter from the repo's root."""
    code = _HOOK + body + "\nprint(repr(seen))\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return ast.literal_eval(out.stdout.strip().splitlines()[-1])


def _jax_package_paths(seen: list) -> list:
    roots = [str(ROOT / d) + "/" for d in ("native", "jepsen_tpu")]
    return [(e, a) for e, a in seen if any(r in a for r in roots)]


def test_port_opens_nothing_of_the_jax_package_while_it_packs():
    # Every file the port opens, every library it loads and every program
    # it starts, while it imports its modules and packs through each walk
    # and the device packer (the native walk builds from csrc/ if it is
    # not built yet), stays out of native/ and jepsen_tpu/.
    mods = list(_port_modules())
    seen = _opened(
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from jepsen_tpu_torch import models\n"
        "from jepsen_tpu_torch.lin import pack_dev, prepare, synth\n"
        "h = synth.generate_register_history(200, concurrency=4, seed=1,\n"
        "                                    crash_prob=0.05)\n"
        "s = synth.generate_set_history(100, concurrency=3, seed=0)\n"
        "for fast in ('1', '0'):\n"
        "    os.environ['JEPSEN_TPU_FAST_PACK'] = fast\n"
        "    for model, x in ((models.cas_register(), h),\n"
        "                     (models.set_model(), s)):\n"
        "        prepare.reduction_tables(prepare.prepare(model, x))\n"
        "pack_dev.materialize(pack_dev.prepack(models.cas_register(), h),\n"
        "                     device='cpu')\n"
        "assert prepare.pack_stats()['mode'] == 'dev'\n")
    assert any(e == "ctypes.dlopen" and "history_pack" in a
               for e, a in seen), seen
    assert _jax_package_paths(seen) == []
    # The check catches the JAX package's native library and sources,
    # by a relative path as by an absolute one.
    assert len(_jax_package_paths(_opened(
        "open('native/history_pack.cc').close()\n"
        "open(os.path.abspath('jepsen_tpu/native_ext.py')).close()\n"))) \
        == 2
    assert len(_jax_package_paths(_opened(
        "import ctypes\n"
        "try:\n"
        "    ctypes.CDLL('native/build/libhistorypack.so')\n"
        "except OSError:\n"
        "    pass\n"))) == 1
