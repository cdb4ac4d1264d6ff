"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, in a fresh interpreter and in its sources."""

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
