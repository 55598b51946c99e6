"""The port's profiling and microbench tools (``tools/trace_breakdown``,
``hlo_bytes``, ``profile_flagship``, ``hbm_ledger``,
``microbench_decode_step``, ``bench_stem``, ``bench_fused_block``,
``sweep_flash_blocks``, ``prerender_corpus``, ``measure_stream_rate``,
``summarize_ingest``) on the CPU at tiny sizes:

- ``trace_breakdown.group_key`` equals the JAX tool's on the same names; a
  CPU trace of a tiny step groups its op time by module, the groups sum to
  the total, and the backward's ops reach their forward modules; read as a
  GPU trace it raises, naming the file (it holds no kernel);
- ``hlo_bytes`` counts a tiny linear's bytes and ``profile_flagship`` a tiny
  step's FLOPs (and K1's/K2's by their formula) as a hand count does;
- ``bench_stem``'s three modes give equal gradients, equal to the JAX
  stem's at the same weights;
- ``microbench_decode_step``'s cross_a, cross_b and cross_c equal
  ``attend_packed_single_query`` on the same K/V;
- ``sweep_flash_blocks`` raises on the CPU;
- every other tool prints its JAX line at ``--smoke --device cpu`` (or a
  tiny shape).
"""

import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu.models.encoder import ConvStemEncoder as JStem
from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_encoder
from omr_a2s_multimodal_transformer_tpu_torch.ops.attention import attend_packed_single_query
from omr_a2s_multimodal_transformer_tpu_torch.tools import (
    bench_fused_block,
    bench_stem,
    hbm_ledger,
    hlo_bytes,
    measure_stream_rate,
    microbench_decode_step,
    prerender_corpus,
    profile_flagship,
    summarize_ingest,
    sweep_flash_blocks,
    trace_breakdown,
)
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

ROOT = Path(__file__).resolve().parents[1]
FLOAT = r"[0-9.]+"
DIFF = r"-?[0-9.]+(e[-+][0-9]+)?|-?inf|nan"  # a time taken as a difference of two runs, as JAX's timeit takes it


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these steps are small, and bf16 CPU kernels slow down many times over when the test
    workers' threads outnumber the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_tool(name):
    """The repository's tools/<name>.py, loaded by path (it imports its TPU libraries only inside functions)."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def _has(lines, pattern):
    assert any(re.fullmatch(pattern, ln) for ln in lines), (pattern, lines)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """profile_flagship's bench config at --smoke on the CPU, with a trace and its breakdown."""
    out = tmp_path_factory.mktemp("flagship")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = profile_flagship.main(["bench", "--smoke", "--device", "cpu", "--steps", "1", "--breakdown", "4",
                                     "--trace", str(out / "trace"), "--dump_hlo", str(out / "ops.tsv")])
    return got, buf.getvalue().splitlines(), out


def test_group_key_equals_jax():
    jtb = _jax_tool("trace_breakdown")
    names = ["encoder/conv_blocks/0/conv1", "jit(train_step)/jit(main)/decoder/layers/3/ff",
             "transpose(jvp(decoder/transformer_decoder/layers/0/self_attn))", "jvp(encoder/dsc1)/conv2",
             "", "a_very_long_unstructured_fusion_name_with_no_slashes_at_all", "transpose(jvp(x))"]
    for name in names:
        for depth in (1, 2, 3, 5):
            assert trace_breakdown.group_key(name, depth) == jtb.group_key(name, depth), (name, depth)


def test_cpu_trace_groups_op_time_by_module(flagship):
    got, _, out = flagship
    path = got["trace"]
    b = trace_breakdown.breakdown(path, depth=3, device="cpu")
    assert b["events"] > 0 and abs(sum(b["groups"].values()) - b["total_ms"]) <= 1e-9 * b["total_ms"] + 1e-9
    assert 0 < b["attributed_ms"] < b["total_ms"]  # Adam's ops belong to no module
    keys = set(b["groups"])
    assert {"encoder/conv_blocks/0", "encoder/conv_blocks/0 [bwd]", trace_breakdown.UNATTRIBUTED} <= keys, keys
    deep = trace_breakdown.breakdown(path, depth=6, device="cpu")["groups"]
    for part in ("self_attn", "multihead_attn", "ff"):  # the decoder layer's parts, forward and backward
        assert any(k.endswith(f"layers/0/{part}") for k in deep), sorted(deep)
        assert any(k.endswith(f"layers/0/{part} [bwd]") for k in deep), sorted(deep)
    with pytest.raises(RuntimeError, match=re.escape(path) + ".*no GPU kernel"):
        trace_breakdown.breakdown(path, device="cuda")


def test_hlo_bytes_counts_a_linear_by_hand():
    lin = torch.nn.Linear(8, 16)
    model = torch.nn.Sequential(lin)
    x = torch.randn(4, 8)
    rows = hlo_bytes.instruction_bytes(lambda: model(x), model)
    # addmm: bias 16, x 4 x 8, weight 16 x 8 and the result 4 x 16, float32; the weight's transpose is a view
    assert rows == [("0", 4.0 * (16 + 32 + 128 + 64), "addmm")]
    x = torch.randn(4, 8, dtype=torch.bfloat16)
    model = model.to(torch.bfloat16)
    rows = hlo_bytes.instruction_bytes(lambda: model(x).float().sum().backward(), model)
    assert rows[0] == ("0", 2.0 * (16 + 32 + 128 + 64), "addmm")
    bwd = [r for r in rows if r[0] == "transpose(jvp(0))"]
    # x takes no gradient: the weight's (16 x 4 by 4 x 8) and the bias's sum over the 4 rows, in bf16
    assert [(op, b) for _, b, op in bwd] == [("mm", 2.0 * (64 + 32 + 128)), ("sum", 2.0 * (64 + 16))]
    assert hlo_bytes.grouped(rows)["0"] == rows[0][1]


def test_profile_flagship_counts_flops_by_hand():
    lin = torch.nn.Linear(8, 16)
    x = torch.randn(4, 8, requires_grad=True)
    # forward 2 x 4 x 8 x 16; backward the gradients of x and of the weight, the same each
    assert profile_flagship.flop_count(lambda: lin(x).sum().backward()) == 3 * 2 * 4 * 8 * 16
    q = torch.zeros(2, 5, 256)
    valid = torch.tensor([[True] * 3 + [False] * 4, [True] * 7])
    assert profile_flagship.flash_flops(q, valid, 4, False) == 4 * 64 * 4 * 5 * 10
    assert profile_flagship.flash_flops(q, valid, 4, True) == 10 * 64 * 4 * 5 * 10


def test_bench_stem_modes_equal_each_other_and_jax():
    """The modes' float32 gradients (no dropout) bit for bit; the JAX stem's
    at the same weights in float64 (JAX's own float32 encoder gradients lie
    ~1e-2 from its float64 ones: test_torch_port_trainer.py), over the whole
    tree in relative L2."""
    x = torch.rand(1, 16, 32, 1, generator=torch.Generator().manual_seed(3))
    grads = {m: bench_stem.stem_grads(bench_stem.make_stem(m, "cpu", torch.float32), x, None) for m in bench_stem.MODES}
    for m in ("widened", "patched"):
        assert grads[m].keys() == grads["unpacked"].keys()
        for k, g in grads[m].items():
            assert torch.equal(g, grads["unpacked"][k]), (m, k)
    stem = bench_stem.make_stem("unpacked", "cpu", torch.float32)
    params = convert_encoder({f"encoder.{k}": v.detach().double() for k, v in stem.state_dict().items()})
    want = convert_encoder({f"encoder.{k}": v for k, v in grads["unpacked"].items()})
    jstem = JStem()
    with jax.enable_x64(True):
        def loss(p):
            return jnp.sum(jnp.square(jstem.apply({"params": p}, jnp.asarray(x.double().numpy()), True)))

        got = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, got)))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert flat_g.keys() == flat_w.keys() and flat_g
    diff = sum(np.sum((flat_g[k] - np.asarray(flat_w[k], np.float64)) ** 2) for k in flat_g) ** 0.5
    assert diff <= 1e-4 * sum(np.sum(g ** 2) for g in flat_g.values()) ** 0.5


def test_decode_step_cross_layouts_equal_attend_packed_single_query():
    g = torch.Generator().manual_seed(5)
    b, s = 2, 37
    q = torch.randn(b, 256, generator=g)
    k, v = (torch.randn(b, s, 256, generator=g).to(torch.bfloat16) for _ in range(2))
    want = attend_packed_single_query(q, k, v, 4)
    for name, (attend, layout) in microbench_decode_step.LAYOUTS.items():
        got = attend(q, layout(k), layout(v))
        assert got.shape == want.shape and torch.allclose(got, want, rtol=1e-5, atol=1e-6), name


def test_sweep_flash_blocks_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="on the card only"):
        sweep_flash_blocks.main(["--device", "cpu"])


def test_profile_flagship_and_trace_breakdown_print_jax_lines(flagship, capsys):
    got, lines, out = flagship
    _has(lines, rf"cost analysis: {FLOAT} TFLOP/step, {FLOAT} GB/step")
    _has(lines, rf"measured: {FLOAT} ms/step, {FLOAT} samples/s \(b1 32x64 L12 remat=False flash=False\)")
    _has(lines, rf"achieved: {FLOAT} TFLOP/s .*; the roof of (bytes|operations) binds .*")
    _has(lines, rf"# op traffic attribution: {FLOAT} GB summed over \d+ op groups \(top 4\)")
    assert got["flops"] > 0 and got["bytes"] > 0 and got["ms_per_step"] > 0
    assert len((out / "ops.tsv").read_text().splitlines()) > 100
    b = trace_breakdown.main([got["trace"], "--device", "cpu", "--top", "3"])
    printed = _lines(capsys)
    _has(printed, rf"# \d+ device events, {FLOAT} ms total \(all steps in trace\); attributed {FLOAT} ms \({FLOAT}%\)")
    assert len(printed) == 4 and b["groups"]


def test_hbm_ledger_and_microbench_print_jax_lines(tmp_path, capsys):
    report = hbm_ledger.main(["--smoke", "--skip_measure", "--device", "cpu", "--top", "3",
                              "--out", str(tmp_path / "ledger.json")])
    lines = _lines(capsys)
    assert json.loads((tmp_path / "ledger.json").read_text()) == json.loads(json.dumps(report))
    assert list(report["variants"]) == ["noremat", "remat"]
    for var in report["variants"].values():
        assert var["op_traffic_gb"] > 0 and len(var["top_sites"]) == 3
    _has(lines, r'\{"op_traffic_gb": [0-9.]+, "flops_tf": [0-9.]+\}')
    _has(lines, rf"report -> {re.escape(str(tmp_path / 'ledger.json'))}")
    got = microbench_decode_step.main(["--smoke", "--device", "cpu"])
    lines = _lines(capsys)
    assert list(got) == list(microbench_decode_step.VARIANTS)
    for name in microbench_decode_step.VARIANTS:
        _has(lines, rf"{name:10s}: +{FLOAT}s total, +{FLOAT} ms/step host, +{FLOAT} ms/step device \(host\)")


def test_bench_stem_reports_a_failed_mode_and_strict_raises(capsys, monkeypatch):
    def fails(stem, x, generator):
        raise RuntimeError("out of memory")

    monkeypatch.setattr(bench_stem, "stem_grads", fails)
    argv = ["--b", "1", "--h", "16", "--w", "32", "--steps", "1", "--modes", "widened", "--device", "cpu"]
    assert bench_stem.main(argv) == {}
    _has(_lines(capsys), r"widened: FAILED \(RuntimeError: out of memory\)")
    with pytest.raises(RuntimeError, match="out of memory"):
        bench_stem.main(argv + ["--strict"])


def test_stem_and_fused_block_benches_print_jax_lines(capsys):
    got = bench_stem.main(["--b", "1", "--h", "16", "--w", "32", "--steps", "1", "--device", "cpu"])
    lines = _lines(capsys)
    assert set(got) == set(bench_stem.MODES)
    for mode in bench_stem.MODES:
        _has(lines, rf"{mode}: {FLOAT} ms/step  \({FLOAT} samples/s fwd\+bwd, stem only\)")
    _has(lines, rf"patched speedup vs widened: {FLOAT}x")
    got = bench_fused_block.main(["--b", "1", "--steps", "2", "--shape", "6", "8", "--device", "cpu"])
    lines = _lines(capsys)
    for name in bench_fused_block.BLOCKS:
        assert got[name]["max_abs_err"] == 0.0  # on the CPU both columns are reference_block
        _has(lines, rf"{name}: fwd plain +({DIFF}) ms \| fused +({DIFF}) ms \(({DIFF})x\) \|\| fwd\+bwd plain +({DIFF}) ms"
                    rf" \| fused\(recompute\) +({DIFF}) ms \(({DIFF})x\) \| bf16 max\|d\| 0.00e\+00")


def test_data_tools_print_jax_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMR_A2S_CACHE_DIR", str(tmp_path / "frontend_cache"))
    got = prerender_corpus.main(["--smoke", "--train_n", "2", "--eval_n", "1", "--device", "cpu"])
    lines = _lines(capsys)
    assert {k: v["samples"] for k, v in got.items()} == {"train": 2, "val": 1, "test": 1}
    _has(lines, r"\[train\] done: 2 samples in \d+s")
    # a spectrogram a sample (an image at its own height is not cached)
    assert [p.parent.name for p in (tmp_path / "frontend_cache").rglob("*.npy")] == ["preprocess_audio"] * 4
    rate = measure_stream_rate.main(["--smoke", "--train_n", "4", "--seconds", "5", "--batch", "2", "--backends",
                                     "threads", "--device", "cpu", "--workdir", str(tmp_path / "sr"),
                                     "--out", str(tmp_path / "sr.json")])
    lines = _lines(capsys)
    assert rate["rates"]["threads"]["samples"] == rate["cold"]["threads"]["samples"] == 4
    assert json.loads((tmp_path / "sr.json").read_text()) == json.loads(json.dumps(rate))
    assert not list((tmp_path / "sr" / "frontend_cache").rglob("*.npy"))  # its cache emptied at the end
    _has(lines, r"threads \{'samples': 4, .*\} cold \{'samples': 4, .*\}")
    run = tmp_path / "run"
    run.mkdir()
    (run / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in (
        {"step": 2, "epoch": 1, "train_loss": 2.5, "samples_per_sec": 9.0, "time_data_total_s": 1.0,
         "time_step_total_s": 3.0}, {"step": 2, "val_sym-er": 80.0})) + "\n")
    (tmp_path / "ingest.log").write_text('noise\n{"metric": "ingest_threads", "cold_samples_per_sec": 20.0}\n')
    report = summarize_ingest.main(["--run_dir", str(run), "--ingest_log", str(tmp_path / "ingest.log"),
                                    "--device_cache_samples_per_sec", "36", "--out", str(tmp_path / "s.json")])
    lines = _lines(capsys)
    assert report["streaming_samples_per_sec"] == 9.0 and report["streaming_vs_device_cache_pct"] == 25.0
    assert report["loader_only"] == [{"metric": "ingest_threads", "cold_samples_per_sec": 20.0}]
    assert lines[-1] == f"-> {tmp_path / 's.json'}"
