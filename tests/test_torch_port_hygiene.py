"""The port package stands alone: no JAX, no import of the JAX package, and
entry points that never fall back to the CPU."""

import ast
import json
import os
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
    from omr_a2s_multimodal_transformer_tpu_torch.inference import (
        make_audio_transcriber,
        make_image_transcriber,
        make_multimodal_transcriber,
    )
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
    mm, _ = build_model(dict(hp, input_modality="both"), device="cpu")
    for make, m in ((make_audio_transcriber, model), (make_multimodal_transcriber, mm)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(m, 1, 2)
        make(m, 1, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(mm, 11, multimodal=True)


def test_unported_options_raise():
    """The options that raised until they were ported: remat builds every
    modality, its encoders (and decoder, off the flash path) rematerialized
    (tests/test_torch_port_remat.py holds its gradients); memory_partition
    without a mesh raises ValueError for every modality, as JAX's sharding
    constraint raises outside a mesh context (under a mesh:
    test_torch_port_remat.py); the int8 and int4 cache dtypes build every
    modality and decode a step from their quantized cross K/V
    (tests/test_torch_port_quant_decode.py holds them against JAX)."""
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model

    base = dict(vocab_size=11, max_seq_len=4, input_modality="image")
    for modality in ("image", "audio", "both"):
        model, _ = build_model({**base, "remat": True, "input_modality": modality}, device="cpu")
        encoders = [m for m in model.modules() if hasattr(m, "dscblocks")]
        assert len(encoders) == (2 if modality == "both" else 1) and all(e.remat for e in encoders)
        assert model.decoder.remat
        flash, _ = build_model({**base, "remat": True, "use_flash_cross": True, "input_modality": modality},
                               device="cpu")
        assert not flash.decoder.remat  # flash holds no score tensor: JAX remats the decoder only off it
        with pytest.raises(ValueError, match="needs a mesh"):
            build_model({**base, "memory_partition": ("data", "model", None), "input_modality": modality},
                        device="cpu")
    x = {"image": torch.rand(2, 32, 64, 1), "audio": torch.rand(2, 195, 24, 1)}
    for cache_dtype, codes in (("int8", torch.int8), ("int4", torch.uint8)):
        for modality in ("image", "audio", "both"):
            model, _ = build_model({**base, "cache_dtype": cache_dtype, "input_modality": modality}, device="cpu")
            with torch.no_grad():
                inputs = (x["image"], x["audio"]) if modality == "both" else (x[modality],)
                cross, valid = model.decode_prefill(*inputs)
                logits, _ = model.decode_step(torch.ones(2, dtype=torch.long), 0, model.decode_init_cache(2), cross,
                                              valid)
            entry = cross["layer0"]
            assert entry["k"].dtype == codes and entry["k_scale"].shape == (2, 256)
            assert ("k_tscale" in entry) == (cache_dtype == "int4")
            assert logits.shape == (2, 11) and bool(torch.isfinite(logits).all())
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


BENCH_TOOLS = ("bench_train_max", "bench_decode_max", "bench_serve", "bench_ingest")


@pytest.mark.parametrize("name", BENCH_TOOLS)
def test_bench_tools_are_scanned_and_default_to_cuda(name):
    """The measurement tools are port modules (the two scans above cover
    them) and, like every entry point, raise without a GPU unless given
    ``--device cpu``."""
    module = f"{port.__name__}.tools.{name}"
    assert module in _port_modules() and (PORT_DIR / "tools" / f"{name}.py").is_file()
    main = importlib.import_module(module).main
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])


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
             "void flash_fwd_causal_tma_kernel(CUtensorMap_st, CUtensorMap_st, int const*)": "K1c flash fwd causal",
             "void flash_bwd_kernel(CUtensorMap_st, CUtensorMap_st)": "K2 flash bwd",
             "void flash_dq_kernel<3, false>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3a flash dq",
             "void flash_dq_kernel<2, true>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3a flash dq",
             "void flash_dq_merge_kernel(float const*, __nv_bfloat16*, unsigned long, int)": "K3a flash dq",
             "void flash_dkv_kernel<false>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3b flash dk/dv",
             "void flash_dkv_kernel<true>(CUtensorMap_st, CUtensorMap_st, int const*)": "K3b flash dk/dv",
             "void lfany_fwd_kernel<float, true>(float const*, int)": "LA legacy flash fwd, any dtype",
             "void lfany_dq_kernel<__half>(__half const*)": "LA legacy flash dq, any dtype",
             "void lfany_dkv_kernel<__nv_bfloat16>(__nv_bfloat16 const*)": "LA legacy flash dk/dv, any dtype",
             "void lf_fwd_chunk<3, false, 1>(CUtensorMap_st, CUtensorMap_st, int const*)": "L1 legacy flash fwd",
             "void lf_fwd_chunk<2, true, 2>(CUtensorMap_st, CUtensorMap_st, int const*)": "L1 legacy flash fwd",
             "void lf_fwd_chunk_merge(float const*, float const*, __nv_bfloat16*)": "L1 legacy flash fwd",
             "void lf_fwd_lse_chunk<3, false, 1>(CUtensorMap_st, CUtensorMap_st, int const*)":
                 "L2a legacy flash fwd lse",
             "void lf_fwd_lse_chunk<2, true, 1>(CUtensorMap_st, CUtensorMap_st, int const*)":
                 "L2a legacy flash fwd lse",
             "void lf_fwd_lse_chunk_merge(float const*, float const*, __nv_bfloat16*, float*)":
                 "L2a legacy flash fwd lse",
             "void lf_dq_kernel<64, true>(__nv_bfloat16 const*)": "L2b legacy flash dq",
             "void lf_dkv_kernel<128, false>(__nv_bfloat16 const*)": "L2c legacy flash dk/dv",
             "void lf_dq_kernel<3, false, 1>(CUtensorMap_st, CUtensorMap_st, int const*)": "L2b legacy flash dq",
             "void lf_dq_kernel<2, true, 2>(CUtensorMap_st, CUtensorMap_st, int const*)": "L2b legacy flash dq",
             "void lf_dq_merge_kernel(float const*, __nv_bfloat16*, unsigned long, int)": "L2b legacy flash dq",
             "void lf_dkv_kernel<false, 2>(CUtensorMap_st, CUtensorMap_st, int const*)": "L2c legacy flash dk/dv",
             "void lf_dkv_kernel<true, 1>(CUtensorMap_st, CUtensorMap_st, int const*)": "L2c legacy flash dk/dv"}
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


def test_diag_grad_split_imports_no_jax_and_runs_on_the_cpu(tmp_path):
    """diag_grad_split.py imports no JAX; at its tiny CPU size it compares
    every leaf at both initialisers, and a step against itself reads 0."""
    path = PORT_DIR.parent / "diag_grad_split.py"
    assert not {name.split(".")[0] for name in _imported_roots(path)} & set(FORBIDDEN)
    env = {**os.environ, "DIAG_DEV": "cpu", "OMP_NUM_THREADS": "1"}  # tiny shapes: threads only contend
    out = subprocess.run([sys.executable, str(path), "--out", str(tmp_path)], capture_output=True, text=True,
                         timeout=300, cwd=str(PORT_DIR.parent), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads((tmp_path / "diag.json").read_text())
    for init in ("jax_init", "torch_init"):
        assert res[f"{init} bf16 8 rows, run to run"]["rel_l2"] == 0.0  # the CPU is deterministic
        assert 0 < res[f"{init} bf16 8 rows vs 4+4"]["rel_l2"] < 1e-1
