"""The PyTorch port stands alone: importing it loads neither jax, triton nor
the JAX package, and no file of it names them in an import.  Its public
layers run on CUDA unless asked for the CPU, and its kernel builds are named
by everything they compile."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "quantized_training_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys, quantized_training_torch\n"
        "import quantized_training_torch.numerics.lut\n"
        "import quantized_training_torch.ops.quantize_elemwise\n"
        "import quantized_training_torch.ops.quantized_matmul\n"
        "import quantized_training_torch.ops.softmax\n"
        "import quantized_training_torch.quantize.fold\n"
        "import quantized_training_torch.quantize.presets\n"
        "bad = [m for m in sys.modules if m in ('jax', 'triton')"
        " or m.startswith(('jax.', 'triton.', 'quantized_training_tpu'))]\n"
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


def test_public_layers_default_to_cuda():
    """QDense, QRMSNorm and Embed build on CUDA unless given a device, so a
    caller who names none never runs the plain CPU path by accident."""
    if torch.cuda.is_available():
        pytest.skip("checks the missing-CUDA error")
    from quantized_training_torch.models.layers import Embed, QDense, QRMSNorm
    for build in (lambda: QDense(8, 8), lambda: QRMSNorm(8),
                  lambda: Embed(16, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    assert QDense(8, 8, device="cpu").kernel.device.type == "cpu"


def test_kernel_build_name_covers_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, every csrc/*.cuh and the flags: an
    edit to the shared rounding header renames every kernel's build."""
    from quantized_training_torch.ops import _cuda
    for f in _cuda.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = {n: _cuda._paths(n)[1].name for n in _cuda.KERNEL_SOURCES}
    header = tmp_path / "qt_round.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _cuda._paths(n)[1].name for n in _cuda.KERNEL_SOURCES}
    assert all(before[n] != after[n] for n in before)


@pytest.mark.parametrize("reduced", [True, False])
def test_cuda_dense_path_requires_f32_reduction(reduced, monkeypatch):
    """On CUDA a dense layer multiplies bf16 operands with cuBLAS, which
    sums in f32 only while reduced-precision reduction is off: with it on,
    the guard the CUDA branch calls raises instead of letting the sum drop
    to bf16.  Other devices do not consult the flag (the meta device runs
    the same branch here)."""
    from quantized_training_torch.models import layers
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        reduced)
    if reduced:
        with pytest.raises(RuntimeError, match="reduced_precision"):
            layers._require_f32_reduction()
    else:
        layers._require_f32_reduction()
    layer = layers.QDense(8, 4, device="meta")
    y = layer(torch.empty((2, 8), dtype=torch.bfloat16, device="meta"))
    assert y.shape == (2, 4) and y.dtype == torch.bfloat16
