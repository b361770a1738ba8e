"""The PyTorch port stands alone: importing it loads neither jax nor the JAX
package, and no file of it names them in an import."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "quantized_training_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys, quantized_training_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('quantized_training_tpu')]\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(REPO).as_posix()
                   for p in PORT.rglob("*") if p.suffix in (".py", ".cu")))
def test_no_file_imports_jax(path):
    text = (REPO / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", text, re.M), \
        path
    assert not re.search(r"^\s*(import|from)\s+quantized_training_tpu\b",
                         text, re.M), path
