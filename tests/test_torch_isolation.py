"""The PyTorch port stands alone: ``repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, and ``chip_smoke.py`` refuses to
report a result without a card or outside a checkout."""
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "jaxlib" or m.startswith(("jax.",
                                                                "repro."))]
assert not bad, bad
print(len(names))
"""


def test_port_imports_with_jax_and_reference_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30       # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)\b(?!_)"
    r"|from\s+(jax|jaxlib|repro)[.\s])", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    hits = _FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, f"{path} imports {hits}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
