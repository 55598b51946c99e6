"""The port package stands alone: no JAX, no import of the JAX package, and
entry points that never fall back to the CPU."""

import ast
import importlib.util
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import omr_a2s_multimodal_transformer_tpu_torch as port
from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device

PORT_DIR = Path(port.__file__).parent
# the JAX stack, the JAX package, and the repository's tools/ (whose legacy flash kernels the port copies)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "omr_a2s_multimodal_transformer_tpu", "tools")


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
    for over in (dict(input_modality="both"), dict(cache_dtype="int8"), dict(cache_dtype="int4"), dict(remat=True),
                 dict(memory_partition=("data", "model", None))):
        with pytest.raises(NotImplementedError):
            build_model({**base, **over}, device="cpu")
    for mode in ("widened", "patched", "auto"):  # a TPU layout of the same convolutions: accepted, read nowhere
        build_model({**base, "packed_stem": True, "conv_mode": mode, "remat": False, "memory_partition": None},
                    device="cpu")


def test_bench_flash_packed_defaults_to_cuda_and_runs_on_the_cpu():
    from omr_a2s_multimodal_transformer_tpu_torch.tools import bench_flash_packed

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_flash_packed.main(["--iters", "1"])
    out = bench_flash_packed.main(["--iters", "1", "--shape", "1", "2", "16", "40", "64"], device="cpu")
    assert out["device"] == "cpu" and out["shape"] == dict(B=1, H=2, Lq=16, Lk=40, Dh=64)
    assert out["max_abs_old_new"] <= 2e-2 * out["max_abs_new"]  # per-head and packed compute one function
    assert out["dropout_deterministic"] and out["dropout_varies_with_seed"] and out["dropout_changed_frac"] > 0.5
    assert min(out["new_ms"], out["old_ms"], out["new_dropout_ms"]) > 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", PORT_DIR.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_tells_every_kernel_apart_in_a_trace():
    """chip_smoke picks a kernel's device time from a profiler trace by a
    substring of its symbol, and classes kernels by kernel_kind: no symbol
    may hold another, and each demangled name maps to its own kernel."""
    cs = _chip_smoke()
    symbols = [entry[3] for entry in cs.KERNELS.values()]
    assert len(set(symbols)) == len(symbols)
    assert not [(a, b) for a in symbols for b in symbols if a != b and a in b]
    names = {"void flash_fwd_tma_kernel(CUtensorMap_st, CUtensorMap_st, int const*)": "K1 flash fwd",
             "void flash_fwd_tma_merge_kernel(float const*, float const*)": "K1 flash fwd",
             "void flash_fwd_causal_kernel(__nv_bfloat16 const*)": "K1c flash fwd causal",
             "void flash_bwd_kernel(CUtensorMap_st, CUtensorMap_st)": "K2 flash bwd",
             "void flash_dq_kernel<3, false>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3a flash dq",
             "void flash_dq_kernel<2, true>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3a flash dq",
             "void flash_dq_merge_kernel(float const*, __nv_bfloat16*, unsigned long, int)": "K3a flash dq",
             "void flash_dkv_kernel<false>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3b flash dk/dv",
             "void flash_dkv_kernel<true>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3b flash dk/dv",
             "void lfany_fwd_kernel<float, true>(float const*, int)": "LA legacy flash fwd, any dtype",
             "void lfany_dq_kernel<__half>(__half const*)": "LA legacy flash dq, any dtype",
             "void lfany_dkv_kernel<__nv_bfloat16>(__nv_bfloat16 const*)": "LA legacy flash dk/dv, any dtype",
             "void lf_fwd_kernel<64, false>(__nv_bfloat16 const*, int)": "L1 legacy flash fwd",
             "void lf_fwd_kernel<128, true>(__nv_bfloat16 const*, int)": "L1 legacy flash fwd",
             "void lf_fwd_lse_kernel<64, false>(__nv_bfloat16 const*, float*)": "L2a legacy flash fwd lse",
             "void lf_fwd_lse_kernel<64, true>(__nv_bfloat16 const*, float*)": "L2a legacy flash fwd lse",
             "void lf_dq_kernel<64, true>(__nv_bfloat16 const*)": "L2b legacy flash dq",
             "void lf_dkv_kernel<128, false>(__nv_bfloat16 const*)": "L2c legacy flash dk/dv"}
    for name, kind in names.items():
        assert cs.kernel_kind(name) == kind, name
    for name, (_, _, _, symbol, _) in cs.KERNELS.items():
        for demangled, kind in names.items():
            assert (symbol in demangled) == (kind == name), (symbol, demangled)


def test_probe_legacy_any_changes_only_the_float32_split(tmp_path):
    """probe_legacy_any.py imports no JAX, and each scheme it writes differs
    from the port's LA backward in split_tf32 / mma_3xtf32 and nowhere
    else."""
    path = PORT_DIR.parent / "probe_legacy_any.py"
    assert not {name.split(".")[0] for name in _imported_roots(path)} & set(FORBIDDEN)
    spec = importlib.util.spec_from_file_location("probe_legacy_any", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    header = Path("csrc") / "legacy_flash_any_bwd.cuh"
    own = (PORT_DIR / header).read_text()
    rest = probe.MMA3.sub("", probe.SPLIT.sub("", own))
    for name in probe.SCHEMES:
        text = (probe.write_scheme(name, tmp_path) / probe.PORT / header).read_text()
        assert text != own and probe.MMA3.sub("", probe.SPLIT.sub("", text)) == rest, name


def test_probe_split_bwd_imports_no_jax_and_needs_a_gpu(tmp_path):
    """probe_split_bwd.py and probe_turns.py import no JAX and, without a
    GPU, the probe exits 2 and prints no result."""
    path = PORT_DIR.parent / "probe_split_bwd.py"
    for script in (path, PORT_DIR.parent / "probe_turns.py"):
        assert not {name.split(".")[0] for name in _imported_roots(script)} & set(FORBIDDEN), script.name
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    out = subprocess.run([sys.executable, str(path), "--out-dir", str(tmp_path)], capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 2 and out.stdout == ""


def test_probe_turns_copies_a_port_beside_the_scripts(tmp_path):
    """probe_turns.copy_port: the port of a checkout (without __pycache__)
    beside this checkout's chip_smoke.py, probe_turns.py and the probe, in
    a root of its own that a second copy replaces."""
    spec = importlib.util.spec_from_file_location("probe_turns", PORT_DIR.parent / "probe_turns.py")
    probe_turns = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe_turns)
    src = tmp_path / "checkout"
    (src / probe_turns.PORT / "__pycache__").mkdir(parents=True)
    (src / probe_turns.PORT / "ops.py").write_text("X = 1\n")
    (src / probe_turns.PORT / "__pycache__" / "ops.pyc").write_bytes(b"")
    root = probe_turns.copy_port(src, tmp_path / "roots" / "parent", "probe_split_bwd.py")
    (root / "stale").write_text("")
    root = probe_turns.copy_port(src, tmp_path / "roots" / "parent", "probe_split_bwd.py")
    assert sorted(p.name for p in root.iterdir()) == sorted(
        ["chip_smoke.py", "probe_turns.py", "probe_split_bwd.py", probe_turns.PORT])
    assert [p.name for p in (root / probe_turns.PORT).iterdir()] == ["ops.py"]
    assert (root / "chip_smoke.py").read_text() == (PORT_DIR.parent / "chip_smoke.py").read_text()
