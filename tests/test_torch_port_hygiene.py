"""The port package stands alone: no JAX, no import of the JAX package, and
entry points that never fall back to the CPU."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import omr_a2s_multimodal_transformer_tpu_torch as port
from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device

PORT_DIR = Path(port.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "omr_a2s_multimodal_transformer_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix=port.__name__ + "."))


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 16
    for path in files:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.relative_to(PORT_DIR)} imports {name}"


def test_package_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (
        f"import importlib, sys; {blocked}; "
        f"[importlib.import_module(m) for m in {_port_modules()!r}]; "
        "import omr_a2s_multimodal_transformer_tpu_torch.inference; print('ok')"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(PORT_DIR.parent))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_entry_points_default_to_cuda_and_never_fall_back():
    from omr_a2s_multimodal_transformer_tpu_torch.inference import make_image_transcriber
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import make_train_step

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    hp = dict(vocab_size=11, max_seq_len=4, input_modality="image")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(hp)
    model, _ = build_model(hp, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(model, 11)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_image_transcriber(model, 1, 2)
    make_train_step(model, 11, device="cpu")
    make_image_transcriber(model, 1, 2, device="cpu")


def test_unported_options_raise():
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model

    base = dict(vocab_size=11, max_seq_len=4, input_modality="image")
    for over in (dict(input_modality="both"), dict(cache_dtype="int8"), dict(cache_dtype="int4")):
        with pytest.raises(NotImplementedError):
            build_model({**base, **over}, device="cpu")
