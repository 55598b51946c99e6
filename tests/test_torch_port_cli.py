"""The port's CLIs end to end on the CPU (``--device cpu``), on the corpus of
tests/test_cli_e2e.py, as README.md's port recipe runs
them: ``cli.train`` (2 epochs, validation each epoch) writes best/ and
last/ and finite metrics, ``cli.test --save_preds`` evaluates best/ and
writes one row per test sample. Then the audio and multimodal paths: an
audio model, and a gated attn_both multimodal model warm-started from the
image and audio checkpoints with only its mixer trained, then ``cli.test
--input_modality both``; each multimodal flag is shown read. Every flag of
a feature not ported yet raises ``NotImplementedError``; without a GPU and
without ``--device cpu`` both CLIs raise before any work.
"""

import json
import math

import pytest
import torch

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli
from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib

SYN = dict(n=6, img_height_range=[32, 33], img_width_range=[64, 96], audio_seconds_range=[0.3, 0.5], n_measures=1)


def _common(ws, modality="image"):
    return ["--ds_name", "synthetic", "--krn_encoding", "kern", "--synthetic", "--synthetic_config", json.dumps(SYN),
            "--cache_root", str(ws / "cache"), "--batch_size", "3", "--num_workers", "1", "--input_modality", modality]


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
    "cache_dtype_int8": ["--cache_dtype", "int8"],
    "cache_dtype_int4": ["--cache_dtype", "int4"],
    "grain": ["--loader_backend", "grain"],
    "keep_cache": ["--keep_cache"],
}
UNPORTED_TEST = {
    "length_penalty": ["--length_penalty", "0.6"],
    "beam_size": ["--beam_size", "4"],
    "compute_mv2h": ["--compute_mv2h"],
    "cache_dtype_int4": ["--cache_dtype", "int4"],
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


@pytest.fixture(scope="module")
def av(trained):
    """The audio and multimodal paths through the CLIs, on the image run's
    corpus and cache: cli.train of an audio model (2 epochs), cli.train of a
    gated attn_both multimodal model warm-started from the image and audio
    best/ (decoder from the audio one), mixer only, modality dropout 0.5 (2
    epochs; its modality draws recorded), then cli.test --input_modality both
    of its best/ with --save_preds."""
    from omr_a2s_multimodal_transformer_tpu_torch.training import loop

    ws, _ = trained
    flags = ["--epochs", "2", "--check_val_every_n_epoch", "1", "--no_bf16", "--device", "cpu", "--use_flash_cross",
             "--attn_window", "10"]
    audio = train_cli.main(_common(ws, "audio") + flags + ["--weights_dir", str(ws / "w_audio"),
                                                           "--run_dir", str(ws / "run_audio")])
    draws = []
    with pytest.MonkeyPatch.context() as mp:
        def recording(rng, prob, _draw=loop.draw_modality):
            draws.append((prob, _draw(rng, prob)))
            return draws[-1][1]

        mp.setattr(loop, "draw_modality", recording)
        both = train_cli.main(_common(ws, "both") + flags + [
            "--weights_dir", str(ws / "w_both"), "--run_dir", str(ws / "run_both"), "--mixer_type", "attn_both",
            "--mixer_residual", "--teacher_forcing_modality_prob", "0.5", "--train_only", "cross_attn,mix_gate",
            "--init_image_checkpoint", str(ws / "weights" / "best"),
            "--init_audio_checkpoint", str(ws / "w_audio" / "best"), "--init_decoder_from", "audio"])
    preds = ws / "preds_both.jsonl"
    test = test_cli.main(_common(ws, "both") + ["--checkpoint_path", str(ws / "w_both" / "best"), "--run_dir",
                                                str(ws / "t_both"), "--no_bf16", "--device", "cpu", "--save_preds",
                                                str(preds)])
    return dict(ws=ws, audio=audio, both=both, test=test, draws=draws, preds=preds)


def _params(path):
    return ckpt_lib.restore_checkpoint(str(path))["params"]


def test_audio_and_multimodal_clis_train_and_test(av):
    ws = av["ws"]
    for run, out in (("run_audio", av["audio"]), ("run_both", av["both"])):
        losses = [json.loads(line)["train_loss"] for line in open(ws / run / "metrics.jsonl")
                  if "train_loss" in json.loads(line)]
        assert len(losses) == 2 and all(map(math.isfinite, losses)), run
        assert all(math.isfinite(out[k]) for k in ("best_val_sym-er", "test_sym-er", "test_seq-er")), run
    for tag in ("best", "last"):
        state = ckpt_lib.restore_checkpoint(str(ws / "w_both" / tag))
        assert state["step"] == 2 * ckpt_lib.load_hparams(str(ws / "w_both" / tag))["epoch"]
        assert len(state["opt_state"]["state"]) == 5  # Adam over the mixer only: in_proj w/b, out_proj w/b, mix_gate
    assert all(math.isfinite(av["test"][k]) for k in ("test_sym-er", "test_seq-er"))
    rows = [json.loads(line) for line in av["preds"].read_text().splitlines()]
    assert len(rows) == SYN["n"] and all(set(r) == {"y_true", "y_pred"} and r["y_true"] for r in rows)


def _is_read(av, flag):
    """What shows that a multimodal flag was read by the run that set it."""
    ws = av["ws"]
    hp_audio, hp_both = (ckpt_lib.load_hparams(str(ws / w / "best")) for w in ("w_audio", "w_both"))
    audio, both = _params(ws / "w_audio" / "best"), _params(ws / "w_both" / "best")
    image_donor = _params(ws / "weights" / "best")

    def same(got, want, prefix_got, prefix_want):
        names = [k for k in want if k.startswith(prefix_want)]
        return names and all(torch.equal(got[prefix_got + k[len(prefix_want):]], want[k]) for k in names)

    if flag == "modality_audio":  # a unimodal model, built back from its checkpoint
        _, _, multimodal = common.build_from_checkpoint(str(ws / "w_audio" / "best"), device="cpu")
        return hp_audio["input_modality"] == "audio" and not multimodal and "encoder.conv_blocks.0.conv1.weight" in audio
    if flag == "modality_both":
        return hp_both["input_modality"] == "both" and any(k.startswith("audio_encoder.") for k in both)
    if flag == "mixer_type":
        return hp_both["mixer_type"] == "attn_both" and "cross_attn.attention.in_proj_weight" in both
    if flag == "mixer_residual":  # two gates, trained away from their zero init
        return hp_both["mixer_residual"] and both["mix_gate"].shape == (2,) and bool(both["mix_gate"].ne(0).all())
    if flag == "teacher_forcing_modality_prob":  # one draw a step at the flag's rate
        return len(av["draws"]) == 4 and {p for p, _ in av["draws"]} == {0.5}
    if flag == "init_image_checkpoint":  # the frozen image encoder is the image run's
        return same(both, image_donor, "image_encoder.", "encoder.")
    if flag == "init_audio_checkpoint":
        return same(both, audio, "audio_encoder.", "encoder.")
    if flag == "init_decoder_from":  # the frozen decoder is the audio run's, not the image run's
        return same(both, audio, "decoder.", "decoder.") and not same(both, image_donor, "decoder.", "decoder.")
    if flag == "test_modality_both":  # cli.test built the multimodal model and decoded both inputs
        return "test_sym-er" in av["test"] and len(av["preds"].read_text().splitlines()) == SYN["n"]
    raise KeyError(flag)


# the flags that raised until the audio and multimodal paths were ported, each now read
PORTED = ("modality_audio", "modality_both", "mixer_type", "mixer_residual", "init_decoder_from",
          "teacher_forcing_modality_prob", "init_image_checkpoint", "init_audio_checkpoint", "test_modality_both")


@pytest.mark.parametrize("flag", PORTED)
def test_ported_multimodal_flags_are_read(av, flag):
    assert _is_read(av, flag), flag


def test_warm_start_needs_both_modalities(trained, tmp_path):
    ws, _ = trained
    with pytest.raises(SystemExit, match="input_modality both"):
        train_cli.main(_common(ws) + ["--device", "cpu", "--weights_dir", str(tmp_path / "w"), "--no_bf16",
                                      "--run_dir", str(tmp_path / "r"),
                                      "--init_image_checkpoint", str(ws / "weights" / "best")])
