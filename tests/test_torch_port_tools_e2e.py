"""The port's grid driver and its checkpoint evaluators end to end on the
CPU (``--device cpu``, the smoke corpus's tiny shapes):

- ``run_grid --smoke``: legs image, audio and concat, 1 epoch each, then
  Smith-Waterman and weighted (a=0.5) fusion: every report key present,
  every SER finite, the report file equal to the returned report, its
  markdown equal to the JAX tool's ``_markdown`` of it; each leg's
  ``cli.train`` argv holds ``--keep_cache`` and no other argv does, as in
  the JAX tool; every CLI is given ``--device cpu``.
- ``eval_cache_dtypes``: its bfloat16 beam-1 row equals ``cli.test``'s SER
  on the same checkpoint and split (the row rounds to 3 decimals, as the
  JAX tool's); its int8 row is finite.
- ``beam_sweep``: its beam-1 row equals ``cli.test``'s SER too; ``best`` is
  the row of least SER.
- ``diagnose_errors``, ``diagnose_audio_errors`` and ``diagnose_seq_errors``
  (on ``cli.test --save_preds``) run on the grid's checkpoints.
- Without ``--device`` every tool that reaches a model runs on the card:
  here, with none, it raises before it writes anything.
"""

import argparse
import json
import math

import pytest
import torch

from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
from omr_a2s_multimodal_transformer_tpu_torch.tools import beam_sweep, diagnose_audio_errors, diagnose_errors
from omr_a2s_multimodal_transformer_tpu_torch.tools import diagnose_seq_errors, eval_cache_dtypes
from omr_a2s_multimodal_transformer_tpu_torch.tools import run_grid as pgrid
from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg
from tools import run_grid as jgrid
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

torch.set_num_threads(2)  # several pytest workers share the host

TRAIN_N, EVAL_N, BATCH = 8, 2, 4
LEGS = ("image", "audio", "concat")
CORPUS = ["--train_n", str(TRAIN_N), "--eval_n", str(EVAL_N), "--batch", str(BATCH), "--smoke", "--device", "cpu"]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """run_grid --smoke --device cpu, with every argv any parser was given."""
    ws = tmp_path_factory.mktemp("grid")
    argvs = []
    parse = argparse.ArgumentParser.parse_args

    def recording(self, args=None, namespace=None):
        if args is not None:
            argvs.append([str(a) for a in args])
        return parse(self, args, namespace)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", recording)
        report = pgrid.main(["--workdir", str(ws), *CORPUS, "--epochs", "1", "--check_val_every_n_epoch", "1",
                             "--legs", *LEGS, "--alphas", "0.5"])
    return ws, report, argvs


def _test_cli(ws, tmp_path, modality="image", preds=None):
    """cli.test of the grid leg's best/ on the grid's corpus and cache."""
    argv = ["--ds_name", "synthetic", "--synthetic_config", synth_cfg(TRAIN_N, EVAL_N, True), "--krn_encoding",
            "kern", "--use_distorted_images", "--cache_root", str(ws / "grandstaff_cache"), "--eval_batch_size",
            str(BATCH), "--input_modality", modality, "--checkpoint_path", str(ws / "weights" / modality / "best"),
            "--run_dir", str(tmp_path / "test_run"), "--device", "cpu"]
    return test_cli.main(argv + (["--save_preds", str(preds)] if preds else []))


def test_run_grid_report(grid):
    ws, report, argvs = grid
    assert json.loads((ws / "report.json").read_text()) == json.loads(json.dumps(report))
    assert list(report["legs"]) == list(LEGS)
    for leg, r in report["legs"].items():
        assert (r["modality"], r["mixer"]) == jgrid.leg_spec(leg)
        assert {"best_val_sym-er", "trajectory", "test_sym-er", "test_seq-er", "wall_s"} <= set(r)
        assert [t["epoch"] for t in r["trajectory"]] == [1]
        for v in (r["best_val_sym-er"], r["test_sym-er"], r["test_seq-er"], r["trajectory"][0]["train_loss"]):
            assert math.isfinite(v), (leg, r)
    assert list(report["fusion"]) == ["smith_waterman", "weighted_a0.5"]
    for name, r in report["fusion"].items():
        assert {"sym-er", "seq-er", "wall_s"} <= set(r) and math.isfinite(r["sym-er"]), (name, r)
    assert pgrid._markdown(report) == jgrid._markdown(report)


def test_run_grid_argvs(grid):
    _, _, argvs = grid
    clis = [a for a in argvs if "--ds_name" in a]  # cli.train x3, cli.test (test_of_best) x3, sw_test, weighted_test
    assert len(clis) == 2 * len(LEGS) + 2
    assert all(a[a.index("--device") + 1] == "cpu" for a in clis)
    trains = [a for a in clis if "--use_flash_cross" in a]
    assert len(trains) == len(LEGS) and all("--remat" in a and "--device_cache" in a for a in trains)
    assert [a for a in argvs if "--keep_cache" in a] == trains


def test_eval_cache_dtypes_bf16_greedy_equals_cli_test(grid, tmp_path):
    ws, _, _ = grid
    report = eval_cache_dtypes.main(["--checkpoint", str(ws / "weights" / "image" / "best"), "--cache_root",
                                     str(ws / "grandstaff_cache"), "--workdir", str(tmp_path / "ecd"), *CORPUS,
                                     "--dtypes", "bfloat16", "int8", "--beams", "1"])
    assert json.loads((tmp_path / "ecd" / "report.json").read_text()) == report
    rows = {r["cache_dtype"]: r for r in report["rows"]}
    assert sorted(rows) == ["bfloat16", "int8"] and all(math.isfinite(r["test_sym-er"]) for r in rows.values())
    test = _test_cli(ws, tmp_path)
    assert rows["bfloat16"]["test_sym-er"] == round(test["test_sym-er"], 3)
    assert rows["bfloat16"]["test_seq-er"] == round(test["test_seq-er"], 3)


def test_beam_sweep_greedy_row_equals_cli_test(grid, tmp_path):
    ws, _, _ = grid
    report = beam_sweep.main(["--checkpoint", str(ws / "weights" / "image" / "best"), "--cache_root",
                              str(ws / "grandstaff_cache"), "--workdir", str(tmp_path / "bs"), *CORPUS,
                              "--beams", "1", "2", "--lps", "0.0", "0.6"])
    assert [(r["beam"], r["length_penalty"]) for r in report["rows"]] == [(1, 0.0), (2, 0.0), (2, 0.6)]
    assert report["best"] == min(report["rows"], key=lambda r: r["test_sym-er"])
    assert report["rows"][0]["test_sym-er"] == round(_test_cli(ws, tmp_path)["test_sym-er"], 3)


def test_diagnose_errors_runs_on_the_grid_checkpoint(grid, tmp_path):
    ws, _, _ = grid
    report = diagnose_errors.main(["--workdir", str(ws), "--ckpt", str(ws / "weights" / "image" / "best"),
                                   "--train_n", str(TRAIN_N), "--eval_n", str(EVAL_N), "--n_batches", "1", "--smoke",
                                   "--out", str(tmp_path / "diag.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "diag.json").read_text()) == report
    assert (report["train"]["n"], report["val"]["n"]) == (8, EVAL_N)  # one batch of the tool's 8, the val split
    for split in ("train", "val"):
        r = report[split]
        assert all(math.isfinite(r[k]) for k in ("sym-er", "seq-er", "tf_eval_loss", "tf_eval_top1")), r
        assert sum(r["edits"].values()) >= r["len_gt_mean"]


def test_diagnose_audio_and_seq_errors_run(grid, tmp_path):
    ws, _, _ = grid
    report = diagnose_audio_errors.main(["--workdir", str(ws), "--ckpt", str(ws / "weights" / "audio" / "best"),
                                         "--train_n", str(TRAIN_N), "--eval_n", str(EVAL_N), "--n_batches", "1",
                                         "--smoke", "--out", str(tmp_path / "audio.json"), "--device", "cpu"])
    assert report["n_samples"] == EVAL_N and math.isfinite(report["sym_er"])
    assert sum(report["error_mass_tokens"].values()) > 0 or report["sym_er"] == 0.0
    preds = tmp_path / "preds.jsonl"
    test = _test_cli(ws, tmp_path, preds=preds)
    seq = diagnose_seq_errors.main(["--preds", str(preds), "--out", str(tmp_path / "seq.json")])
    assert seq["n_samples"] == EVAL_N
    assert seq["seq_er_pct"] == round(test["test_seq-er"], 1)


@pytest.mark.parametrize("tool, argv", [
    ("run_grid", []), ("run_convergence", []), ("run_real_shape_e2e", []),
    ("eval_cache_dtypes", ["--checkpoint", "none"]), ("beam_sweep", ["--checkpoint", "none"]),
    ("diagnose_errors", ["--ckpt", "none"]), ("diagnose_audio_errors", ["--ckpt", "none"]),
])
def test_tools_need_a_gpu_unless_told_cpu(tool, argv, tmp_path):
    """Without --device the tools run on the card: with none present they raise before any work."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run on it")
    work = tmp_path / "work"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(f"omr_a2s_multimodal_transformer_tpu_torch.tools.{tool}").main(
            [*argv, "--workdir", str(work)])
    assert not work.exists()
