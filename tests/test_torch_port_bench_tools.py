"""The port's measurement tools (``tools/bench_train_max``,
``bench_decode_max``, ``bench_serve``, ``bench_ingest``) at tiny sizes on
the CPU: each prints the JAX tool's line, and what they draw or build
from their arguments equals what the JAX tools draw or build."""

import importlib.util
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest

from omr_a2s_multimodal_transformer_tpu_torch.tools import bench_decode_max, bench_ingest, bench_serve, bench_train_max
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

ROOT = Path(__file__).resolve().parents[1]
TINY_IMAGE = ["--image", "32", "64", "--audio", "195", "24", "--max_len", "12", "--vocab", "31"]
SERVE_KEYS = {"metric", "p50_ms", "p99_ms", "samples_per_sec", "clients", "requests", "max_batch", "cache_dtype",
              "batches"}
INGEST_KEYS = {"metric", "modality", "cold_samples_per_sec", "warm_samples_per_sec", "n", "batch", "workers"}


def _jax_tool(name):
    """The repository's tools/<name>.py, loaded by path (it imports JAX only inside its functions)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_train_max_runs_both_variants(capsys):
    """One block of one step each, the concat multimodal model at full width
    with remat: the plain and flash lines and their ratio, each first loss
    finite. With dropout on the two differ by design (flash draws hash
    bits, the plain path generator bits), so only finiteness is held; on
    the CPU neither launches a kernel."""
    out = bench_train_max.main(["1", "both", "--steps", "1", "--blocks", "1", *TINY_IMAGE, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    for variant in ("plain", "flash"):
        assert any(re.fullmatch(rf"{variant}\s+cross-attn train: b1\s+[0-9.]+ samples/s", ln) for ln in lines), lines
        r = out[variant]
        assert math.isfinite(r["first_loss"]) and r["samples_per_s"] > 0 and len(r["blocks"]) == 1
        assert (r["k1_per_step"], r["k2_per_step"]) == (0, 0)
    assert any(re.fullmatch(r"flash/plain: [0-9.]+x", ln) for ln in lines)


def test_bench_train_max_batch_is_jax_s():
    """JAX's all-ones batch at its shapes (tools/bench_train_max.py reads
    sys.argv at import, so its constants are written out here)."""
    b = bench_train_max.make_batch(2, (bench_train_max.H, bench_train_max.W), (bench_train_max.AH, bench_train_max.AW),
                                   bench_train_max.L, "cpu")
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        "xi": (2, 361, 4412, 1), "xi_hw": (2, 2), "xa": (2, 195, 808, 1), "xa_hw": (2, 2), "y_in": (2, 1268),
        "y_out": (2, 1268)}
    assert all(bool((v == 1).all()) for k, v in b.items() if not k.endswith("_hw"))
    assert b["xi_hw"].tolist() == [[361, 4412]] * 2 and b["xa_hw"].tolist() == [[195, 808]] * 2


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_bench_decode_max_prints_its_line(capsys, tmp_path, cache_dtype):
    out = bench_decode_max.main(["--batch", "2", "--max_len", "6", "--height", "32", "--width", "64", "--vocab",
                                 "31", "--iters", "1", "--cache_dtype", cache_dtype, "--decode_impl", "ignored",
                                 "--profile", "--profile_dir", str(tmp_path), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(rf"b2 32x64 \(S=16\) L6 W100 cache={cache_dtype}: [0-9.]+s/batch = [0-9.]+ samples/s, "
                        r"[0-9.]+ ms/step \([0-9]+ steps run\)", line), line
    assert 1 <= out["steps"] <= 6 and out["samples_per_s"] > 0
    assert Path(out["trace"]).is_file() and json.loads(Path(out["trace"]).read_text())


def test_steps_run_counts_to_the_last_row_s_eos():
    import torch

    tokens = torch.tensor([[5, 0, 0, 0], [5, 6, 0, 0]])
    assert bench_decode_max.steps_run(tokens, 0) == 3
    assert bench_decode_max.steps_run(torch.tensor([[5, 6, 7, 8], [0, 0, 0, 0]]), 0) == 4


def _tiny_payload(modality, rng):
    """Requests that fit a 32 x 64 image ladder and a 4,096 / 8,192-sample audio ladder."""
    if modality == "fused":
        return (_tiny_payload("image", rng), _tiny_payload("audio", rng))
    if modality == "image":
        img = np.full((int(rng.integers(24, 33)), int(rng.integers(40, 65))), 255, np.uint8)
        img[:, ::4] = 0
        return img
    return rng.standard_normal(int(rng.integers(3000, 8193))).astype(np.float32) * 0.1


@pytest.mark.parametrize("mode", ["image", "audio", "fused"])
def test_bench_serve_prints_jax_s_keys(capsys, mode):
    out = bench_serve.main([mode, "--clients", "2", "--requests", "1", "--max_batch", "2", "--max_len", "4",
                            "--image_height", "32", "--image_widths", "64", "--audio_samples", "4096", "8192",
                            "--device", "cpu"], payload=_tiny_payload)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == SERVE_KEYS and line == out[0]
    assert line["metric"] == f"serve_{mode}" and line["requests"] == 2 and line["p99_ms"] >= line["p50_ms"] > 0
    # the warm-up's full batch, its single request and the clients' two: 5 requests in all
    assert sum(int(k.rsplit("_b", 1)[1]) * n for k, n in line["batches"].items()) == 5


@pytest.mark.parametrize("modality", ["image", "audio", "fused"])
def test_bench_serve_payloads_equal_jax_s(modality):
    jax_serve = _jax_tool("bench_serve")
    for seed in (0, 1003):
        got, want = (f(modality, np.random.default_rng(seed)) for f in (bench_serve.make_payload,
                                                                        jax_serve.make_payload))
        for g, w in zip(*((x if modality == "fused" else (x,)) for x in (got, want))):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_bench_serve_builds_jax_s_server():
    """The server's ladders, eos out of the vocabulary and the fused alpha as
    JAX's ``build_server`` builds them."""
    server = bench_serve.build_server("fused", 2, 30.0, "bfloat16", "cpu", max_len=4)
    try:
        assert (server.image_height, server.image_widths) == (368, (2208, 4416))
        assert server.audio_samples == (206848, 413696)
        assert server.eos_id == 6997 and server.alpha == 0.5 and server.max_batch == 2
    finally:
        server.stop()


@pytest.mark.parametrize("extra", [{}, dict(measures_range=(2, 30), audio_style="bands")])
@pytest.mark.parametrize("backend", ["threads", "grain"])
def test_bench_ingest_make_dm_equals_jax_s(tmp_path, backend, extra):
    jax_ingest = _jax_tool("bench_ingest")
    args = (backend, 16, 4, "image", 8, str(tmp_path))
    got, want = bench_ingest.make_dm(*args, **extra), jax_ingest.make_dm(*args, **extra)
    for attr in ("kwargs", "loader_backend", "batch_size", "eval_batch_size", "num_workers", "seed",
                 "input_modality", "width_buckets"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_bench_ingest_prints_a_line_a_backend(capsys, tmp_path):
    out = bench_ingest.main(["--n", "4", "--batch", "2", "--workers", "2", "--workdir", str(tmp_path),
                             "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines == out and [ln["metric"] for ln in lines] == ["ingest_threads", "ingest_grain"]
    for ln in lines:
        assert set(ln) == INGEST_KEYS and ln["cold_samples_per_sec"] > 0 and ln["warm_samples_per_sec"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ingest_cache_grain", "ingest_cache_threads"]
