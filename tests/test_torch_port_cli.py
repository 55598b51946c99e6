"""The port's CLIs end to end on the CPU (``--device cpu``), on the corpus of
tests/test_cli_e2e.py, as README.md's port recipe runs
them: ``cli.train`` (2 epochs, validation each epoch) writes best/ and
last/ and finite metrics, ``cli.test --save_preds`` evaluates best/ and
writes one row per test sample. Every flag of a feature not ported yet
raises ``NotImplementedError``; without a GPU and without ``--device cpu``
both CLIs raise before any work.
"""

import json
import math

import pytest
import torch

from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli
from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib

SYN = dict(n=6, img_height_range=[32, 33], img_width_range=[64, 96], audio_seconds_range=[0.3, 0.5], n_measures=1)


def _common(ws):
    return ["--ds_name", "synthetic", "--krn_encoding", "kern", "--synthetic", "--synthetic_config", json.dumps(SYN),
            "--cache_root", str(ws / "cache"), "--batch_size", "3", "--num_workers", "1", "--input_modality", "image"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ws = tmp_path_factory.mktemp("cli")
    out = train_cli.main(_common(ws) + ["--epochs", "2", "--check_val_every_n_epoch", "1", "--weights_dir",
                                        str(ws / "weights"), "--run_dir", str(ws / "run"), "--no_bf16",
                                        "--device", "cpu", "--use_flash_cross", "--attn_window", "10"])
    return ws, out


def test_train_cli_writes_checkpoints_and_finite_metrics(trained):
    ws, out = trained
    recs = [json.loads(line) for line in open(ws / "run" / "metrics.jsonl")]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert all(math.isfinite(out[k]) for k in ("best_val_sym-er", "test_sym-er", "test_seq-er"))
    for tag, epoch in (("best", out["best_epoch"]), ("last", 2)):
        hp = ckpt_lib.load_hparams(str(ws / "weights" / tag))
        assert hp["epoch"] == epoch and hp["use_flash_cross"] and hp["attn_window"] == 10
        state = ckpt_lib.restore_checkpoint(str(ws / "weights" / tag))
        assert state["step"] == 2 * epoch and state["opt_state"]["state"]


def test_test_cli_evaluates_best_and_saves_preds(trained, tmp_path):
    ws, _ = trained
    preds = tmp_path / "preds.jsonl"
    metrics = test_cli.main(_common(ws) + ["--checkpoint_path", str(ws / "weights" / "best"), "--run_dir",
                                           str(tmp_path / "t"), "--no_bf16", "--device", "cpu", "--save_preds",
                                           str(preds), "--cache_dtype", "float32", "--packed_stem", "on"])
    assert math.isfinite(metrics["test_sym-er"]) and math.isfinite(metrics["test_seq-er"])
    rows = [json.loads(line) for line in preds.read_text().splitlines()]
    assert len(rows) == SYN["n"] and all(set(r) == {"y_true", "y_pred"} and r["y_true"] for r in rows)


UNPORTED = {
    "mesh_model": ["--mesh_model", "2"],
    "device_cache": ["--device_cache"],
    "device_cache_u8": ["--device_cache_u8"],
    "remat": ["--remat"],
    "init_image_checkpoint": ["--init_image_checkpoint", "x"],
    "init_audio_checkpoint": ["--init_audio_checkpoint", "x"],
    "cache_dtype_int8": ["--cache_dtype", "int8"],
    "cache_dtype_int4": ["--cache_dtype", "int4"],
    "modality_audio": ["--input_modality", "audio"],
    "modality_both": ["--input_modality", "both"],
    "grain": ["--loader_backend", "grain"],
    "mixer_type": ["--mixer_type", "concat"],
    "mixer_residual": ["--mixer_residual"],
    "init_decoder_from": ["--init_decoder_from", "audio"],
    "teacher_forcing_modality_prob": ["--teacher_forcing_modality_prob", "0.5"],
    "keep_cache": ["--keep_cache"],
}
UNPORTED_TEST = {
    "length_penalty": ["--length_penalty", "0.6"],
    "beam_size": ["--beam_size", "4"],
    "compute_mv2h": ["--compute_mv2h"],
    "cache_dtype_int4": ["--cache_dtype", "int4"],
    "modality_both": ["--input_modality", "both"],
}


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_train_cli_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train_cli.main(_common(tmp_path) + ["--device", "cpu", "--weights_dir", str(tmp_path / "w")] + UNPORTED[flag])
    assert not (tmp_path / "w").exists() and not (tmp_path / "cache").exists()  # raised before any work


@pytest.mark.parametrize("flag", sorted(UNPORTED_TEST))
def test_test_cli_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        test_cli.main(_common(tmp_path) + ["--device", "cpu", "--checkpoint_path", str(tmp_path)] + UNPORTED_TEST[flag])


def test_accepted_jax_only_flags_change_nothing(trained, tmp_path):
    """The parser takes every flag of the JAX CLIs. --threefry_prng picks a
    JAX PRNG and --conv_mode a TPU layout: both are accepted, and a train
    run with them gives the fixture's run exactly (metrics, best/ and last/
    weights)."""
    from omr_a2s_multimodal_transformer_tpu.cli import test as j_test
    from omr_a2s_multimodal_transformer_tpu.cli import train as j_train

    for jax_cli, port_cli in ((j_train, train_cli), (j_test, test_cli)):
        jax_flags = {a.dest for a in jax_cli.build_parser()._actions}
        port_flags = {a.dest for a in port_cli.build_parser()._actions}
        assert jax_flags <= port_flags and port_flags - jax_flags == {"device"}
    ws, want = trained
    got = train_cli.main(_common(ws) + ["--epochs", "2", "--check_val_every_n_epoch", "1", "--weights_dir",
                                        str(tmp_path / "weights"), "--run_dir", str(tmp_path / "run"), "--no_bf16",
                                        "--device", "cpu", "--use_flash_cross", "--attn_window", "10",
                                        "--threefry_prng", "--conv_mode", "patched"])
    assert got == want
    for tag in ("best", "last"):
        a, b = (ckpt_lib.restore_checkpoint(str(d / "weights" / tag))["params"] for d in (ws, tmp_path))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_clis_need_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(_common(tmp_path) + ["--weights_dir", str(tmp_path / "w")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main(_common(tmp_path) + ["--checkpoint_path", str(tmp_path)])
    assert not (tmp_path / "cache").exists()
