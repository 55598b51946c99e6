"""The port's CLIs end to end on the CPU (``--device cpu``), on the corpus of
tests/test_cli_e2e.py, as README.md's port recipe runs
them: ``cli.train`` (2 epochs, validation each epoch) writes best/ and
last/ and finite metrics, ``cli.test --save_preds`` evaluates best/ and
writes one row per test sample. Then the audio and multimodal paths: an
audio model, and a gated attn_both multimodal model warm-started from the
image and audio checkpoints with only its mixer trained, then ``cli.test
--input_modality both``; each multimodal flag is shown read. The flags
ported since run: ``--keep_cache`` (the frontend disk cache kept after the
run) and ``--remat`` give the fixture's run exactly, and
``--mesh_model 2`` trains and tests under two gloo ranks. Without a GPU and
without ``--device cpu`` both CLIs raise before any work.

Then the inference and serving CLIs on those checkpoints: ``cli.test
--beam_size 2 --length_penalty 0.6 --compute_mv2h``, ``cli.weighted_test``,
``cli.sw_test``, ``cli.split_ckpt`` of the multimodal best/,
``cli.transcribe`` of .wav files, of .png files (where PIL imports) and of
image/wave pairs, and ``cli.serve``'s fused server over HTTP; their metrics
and outputs equal what the port's decode functions give called directly,
and their flags are the JAX CLIs' plus ``--device``.
"""

import json
import math

import pytest
import torch
import torch_port_dist as D

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli
from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

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
    "device_cache_u8": ["--device_cache", "--device_cache_u8"],
    "remat": ["--remat"],
    "cache_dtype_int8": ["--cache_dtype", "int8"],
    "cache_dtype_int4": ["--cache_dtype", "int4"],
    "grain": ["--loader_backend", "grain"],
    "keep_cache": ["--keep_cache"],
}
UNPORTED_TEST = {
    "cache_dtype_int4": ["--cache_dtype", "int4"],
}
# flags that raised until their feature was ported: their cases now run it
PORTED_TRAIN = ("device_cache", "device_cache_u8", "cache_dtype_int8", "cache_dtype_int4", "grain", "remat",
                "keep_cache")
PORTED_TEST = ("cache_dtype_int4",)


def _fixture_run(ws, out, extra):
    return train_cli.main(_common(ws) + ["--epochs", "2", "--check_val_every_n_epoch", "1", "--weights_dir",
                                         str(out / "weights"), "--run_dir", str(out / "run"), "--no_bf16",
                                         "--device", "cpu", "--use_flash_cross", "--attn_window", "10"] + extra)


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_train_cli_unported_flags_raise(trained, tmp_path, flag):
    """A flag of a feature not ported yet raises before any work. The flags
    ported since run the fixture's training with the flag on the CPU: the
    device cache (u8 too) and the worker loader give the fixture's run
    exactly (metrics, best/ and last/ weights: the same batches); an
    int8/int4 cache trains the same and validates and tests by decoding
    from the quantized cross K/V, its cache_dtype kept in the checkpoint;
    --remat (the encoder's blocks recomputed, dropout replayed) gives the
    fixture's run exactly, and so does --keep_cache (the frontend disk
    cache kept, test_torch_port_frontend_cache.py holds what it keeps).
    --mesh_model 2 is held under two ranks
    (``_two_rank_cli_runs``)."""
    if flag == "mesh_model":
        _two_rank_cli_runs(trained, tmp_path)
        return
    if flag not in PORTED_TRAIN:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            train_cli.main(_common(tmp_path) + ["--device", "cpu", "--weights_dir", str(tmp_path / "w")]
                           + UNPORTED[flag])
        assert not (tmp_path / "w").exists() and not (tmp_path / "cache").exists()  # raised before any work
        return
    ws, want = trained
    got = _fixture_run(ws, tmp_path, UNPORTED[flag])
    for tag in ("best", "last"):
        a, b = (ckpt_lib.restore_checkpoint(str(d / "weights" / tag))["params"] for d in (ws, tmp_path))
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    if flag.startswith("cache_dtype"):
        assert ckpt_lib.load_hparams(str(tmp_path / "weights" / "best"))["cache_dtype"] == UNPORTED[flag][1]
        assert all(math.isfinite(got[k]) for k in ("best_val_sym-er", "test_sym-er", "test_seq-er"))
        losses = [[json.loads(line)["train_loss"] for line in open(d / "run" / "metrics.jsonl")
                   if "train_loss" in line] for d in (ws, tmp_path)]
        assert losses[0] == losses[1]
    else:
        assert got == want


def _two_rank_cli_runs(trained, tmp_path):
    """The CLIs on two gloo ranks of the CPU, as ``python -m
    torch.distributed.run --nproc_per_node 2`` starts them: cli.train on a
    2 x 1 mesh (data parallel) for one epoch; then cli.train --mesh_model 2
    (tensor parallel) resumes that run from its last/ for a second epoch,
    the checkpoint resharded onto the other mesh; then cli.test --mesh_model
    2 of the best/ on two ranks gives the single-process cli.test's metrics
    on it (the decode's tokens are the single-process ones). Every
    checkpoint holds the full tensors of the fixture's; rank 0 alone writes
    the metrics. In one process, --mesh_model 2 raises before any work (a
    model axis larger than the world), as JAX's mesh assert does."""
    ws, want = trained
    with pytest.raises(ValueError, match="not divisible"):
        train_cli.main(_common(tmp_path) + ["--device", "cpu", "--mesh_model", "2", "--weights_dir",
                                            str(tmp_path / "w0")])
    assert not (tmp_path / "w0").exists() and not (tmp_path / "cache").exists()
    base = _common(ws) + ["--check_val_every_n_epoch", "1", "--weights_dir", str(tmp_path / "weights"),
                          "--run_dir", str(tmp_path / "run"), "--no_bf16", "--device", "cpu", "--use_flash_cross",
                          "--attn_window", "10"]
    train = "omr_a2s_multimodal_transformer_tpu_torch.cli.train"
    dp = D.run_ranks(D.cli_main, 2, train, base + ["--epochs", "1"], timeout=240)
    tp = D.run_ranks(D.cli_main, 2, train, base + ["--epochs", "2", "--mesh_model", "2"], timeout=240)
    for out in dp + tp:
        assert all(math.isfinite(out[k]) for k in ("best_val_sym-er", "test_sym-er", "test_seq-er"))
    recs = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert [r["epoch"] for r in recs if "train_loss" in r] == [1, 2]  # one writer; the tp run resumed at epoch 2
    assert any(r.get("resumed_epoch") == 1 for r in recs)
    ref = ckpt_lib.restore_checkpoint(str(ws / "weights" / "last"))
    last = ckpt_lib.restore_checkpoint(str(tmp_path / "weights" / "last"))
    assert last["step"] == ref["step"] == 4
    assert {k: v.shape for k, v in last["params"].items()} == {k: v.shape for k, v in ref["params"].items()}
    assert [s["exp_avg"].shape for s in last["opt_state"]["state"].values()] == \
        [s["exp_avg"].shape for s in ref["opt_state"]["state"].values()]
    test_args = _common(ws) + ["--checkpoint_path", str(tmp_path / "weights" / "best"), "--no_bf16", "--device", "cpu"]
    single = test_cli.main(test_args + ["--run_dir", str(tmp_path / "t1")])
    two = D.run_ranks(D.cli_main, 2, "omr_a2s_multimodal_transformer_tpu_torch.cli.test",
                      test_args + ["--run_dir", str(tmp_path / "t2"), "--mesh_model", "2"], timeout=240)
    assert two[0] == two[1] == single


@pytest.mark.parametrize("flag", sorted(UNPORTED_TEST))
def test_test_cli_unported_flags_raise(trained, tmp_path, flag):
    """--cache_dtype int4, ported since: cli.test of the fixture's best/
    decodes from rank-1 int4 cross K/V, and gives the metrics and preds of
    greedy decoding by the model built with that cache over the test split."""
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn
    from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_metrics

    assert flag in PORTED_TEST
    ws, _ = trained
    preds = tmp_path / "preds.jsonl"
    got = test_cli.main(_common(ws) + ["--device", "cpu", "--no_bf16", "--checkpoint_path", str(ws / "weights" / "best"),
                                       "--run_dir", str(tmp_path / "t"), "--save_preds", str(preds)]
                        + UNPORTED_TEST[flag])
    model, _, _ = common.build_from_checkpoint(str(ws / "weights" / "best"), {"cache_dtype": "int4"}, device="cpu")
    assert model.decoder.cache_dtype == "int4"
    vocab, i2w, loader = _test_batches(ws, "image")
    decode = greedy_decode_fn(model, model.max_seq_len, vocab.sos_id, vocab.eos_id)
    y_true, y_pred = [], []
    for b in loader:
        tokens, _ = decode(torch.from_numpy(b["x"]), torch.from_numpy(b["x_hw"]))
        y_pred += [[vocab.i2w[i] for i in row] for row in _rows(tokens, vocab.eos_id)]
        y_true += _gt(b, i2w, vocab.eos_id)
    assert got == {f"test_{k}": v for k, v in compute_metrics(y_true, y_pred).items()}
    rows = [json.loads(line) for line in preds.read_text().splitlines()]
    assert rows == [{"y_true": t, "y_pred": p} for t, p in zip(y_true, y_pred)]


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


# ---------------------------------------------------------- inference and serving CLIs


@pytest.fixture(scope="module")
def rand(av):
    """Checkpoints of the image and audio runs' hparams (one vocabulary, one
    max_seq_len) with random weights from a seed: the fixture's 2-epoch
    models emit eos first, these decode every step, so the fusion and
    transcription outputs below are not empty."""
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model

    out = {}
    for tag, src, seed in (("image", av["ws"] / "weights" / "best", 31), ("audio", av["ws"] / "w_audio" / "best", 32)):
        hp = ckpt_lib.load_hparams(str(src))
        model, _ = build_model(hp, device="cpu", seed=seed)
        out[tag] = av["ws"] / f"rand_{tag}"
        ckpt_lib.save_checkpoint(str(out[tag]), {"params": model.state_dict()}, hp)
    return out


def _data(ws):
    """The data flags of the fusion CLIs, which take no --input_modality."""
    return _common(ws)[:-2]


def _test_batches(ws, modality):
    """(datamodule args, vocab, test loader) of the fixture's corpus."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import weighted_test

    args = weighted_test.build_parser().parse_args(_data(ws) + [
        "--image_checkpoint_path", "-", "--audio_checkpoint_path", "-"])
    dm = common.make_datamodule(args, modality)
    dm.setup("test")
    return dm.get_vocab(), dm.test_ds.i2w, dm.test_dataloader()


def _rows(tokens, eos):
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos

    return cut_at_eos(tokens, tokens, eos)[0]


def _gt(batch, i2w, eos):
    return [[i2w[g] for g in row if g != 0] for row in _rows(batch["y_out"], eos)]


def test_test_cli_beam_search_and_mv2h(av, rand, tmp_path):
    """cli.test --beam_size 2 --length_penalty 0.6 --compute_mv2h gives the
    metrics of beam_decode_fn over the test split and compute_metrics with
    MV2H (the native route: music21 and pyMV2H are not installed), on the
    trained best/ and on random weights."""
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import beam_decode_fn
    from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_metrics

    ws = av["ws"]
    for ckpt in (ws / "weights" / "best", rand["image"]):
        got = test_cli.main(_common(ws) + ["--checkpoint_path", str(ckpt), "--run_dir", str(tmp_path / "t"),
                                           "--no_bf16", "--device", "cpu", "--beam_size", "2", "--length_penalty",
                                           "0.6", "--compute_mv2h"])
        model, _, _ = common.build_from_checkpoint(str(ckpt), device="cpu")
        vocab, i2w, loader = _test_batches(ws, "image")
        decode = beam_decode_fn(model, model.max_seq_len, vocab.sos_id, vocab.eos_id, beam_size=2,
                                length_penalty=0.6)
        y_true, y_pred = [], []
        for b in loader:
            tokens, scores = decode(torch.from_numpy(b["x"]), torch.from_numpy(b["x_hw"]))
            assert scores.shape == (tokens.shape[0],)
            y_pred += [[vocab.i2w[i] for i in row] for row in _rows(tokens, vocab.eos_id)]
            y_true += _gt(b, i2w, vocab.eos_id)
        want = {f"test_{k}": v for k, v in compute_metrics(y_true, y_pred, compute_mv2h=True).items()}
        assert got == want and "test_mv2h" in got and all(map(math.isfinite, got.values()))
    assert max(map(len, y_pred)) > 2  # the random weights' rows are not empty


def test_weighted_test_cli(av, rand, tmp_path):
    from omr_a2s_multimodal_transformer_tpu_torch.cli import weighted_test
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import weighted_decode_fn
    from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_metrics

    ws = av["ws"]
    img, aud = rand["image"], rand["audio"]
    preds = tmp_path / "preds.jsonl"
    got = weighted_test.main(_data(ws) + ["--image_checkpoint_path", str(img), "--audio_checkpoint_path",
                                                    str(aud), "--alpha", "0.3", "--device", "cpu", "--run_dir",
                                                    str(tmp_path / "r"), "--save_preds", str(preds)])
    mi, _, _ = common.build_from_checkpoint(str(img), device="cpu")
    ma, _, _ = common.build_from_checkpoint(str(aud), device="cpu")
    vocab, i2w, loader = _test_batches(ws, "both")
    decode = weighted_decode_fn(mi, ma, max(mi.max_seq_len, ma.max_seq_len), vocab.sos_id, vocab.eos_id)
    y_true, y_pred = [], []
    for b in loader:
        tokens, _ = decode(*common.to_device(b, ("xi", "xi_hw", "xa", "xa_hw"), "cpu"), 0.3)
        y_pred += [[vocab.i2w[i] for i in row] for row in _rows(tokens, vocab.eos_id)]
        y_true += _gt(b, i2w, vocab.eos_id)
    assert got == compute_metrics(y_true, y_pred) and all(map(math.isfinite, got.values()))
    assert min(map(len, y_pred)) > 2
    rows = [json.loads(line) for line in preds.read_text().splitlines()]
    assert rows == [{"y_true": t, "y_pred": p} for t, p in zip(y_true, y_pred)]


def test_sw_test_cli(av, rand, tmp_path):
    from omr_a2s_multimodal_transformer_tpu_torch.cli import sw_test
    from omr_a2s_multimodal_transformer_tpu_torch.fusion.smith_waterman import fuse_predictions
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos, greedy_decode_fn
    from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_metrics

    ws = av["ws"]
    img, aud = rand["image"], rand["audio"]
    pen = ["--match", "3", "--mismatch", "-2", "--gap_penalty", "-1", "--gap_extension_penalty", "-2"]
    got = sw_test.main(_data(ws) + ["--image_checkpoint_path", str(img), "--audio_checkpoint_path", str(aud),
                                              "--device", "cpu", "--run_dir", str(tmp_path / "r")] + pen)
    vocab, i2w, loader = _test_batches(ws, "both")
    decoded = {}
    for tag, path, keys in (("image", img, ("xi", "xi_hw")), ("audio", aud, ("xa", "xa_hw"))):
        model, _, _ = common.build_from_checkpoint(str(path), device="cpu")
        decode = greedy_decode_fn(model, model.max_seq_len, vocab.sos_id, vocab.eos_id)
        rows, y_true = [], []
        for b in loader:
            t, s = decode(*common.to_device(b, keys, "cpu"))
            rows += list(zip(*cut_at_eos(t, s, vocab.eos_id)))
            y_true += _gt(b, i2w, vocab.eos_id)
        decoded[tag] = rows
    y_pred = [fuse_predictions([vocab.i2w[i] for i in it], isc, [vocab.i2w[i] for i in at], asc, 3, -2, -1, -2)
              for (it, isc), (at, asc) in zip(decoded["image"], decoded["audio"])]
    assert got == compute_metrics(y_true, y_pred) and all(map(math.isfinite, got.values()))
    assert min(len(ids) for ids, _ in decoded["image"]) > 2  # random weights: no early eos


def test_split_ckpt_cli(av, tmp_path):
    """cli.split_ckpt of the multimodal best/: an image and an audio
    checkpoint that build unimodal models holding its encoders and decoder."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import split_ckpt

    ws = av["ws"]
    img, aud = split_ckpt.main(["--ckpt_path", str(ws / "w_both" / "best"), "--out_prefix", str(tmp_path / "split")])
    both = _params(ws / "w_both" / "best")
    for path, modality, enc in ((img, "image", "image_encoder."), (aud, "audio", "audio_encoder.")):
        model, hp, multimodal = common.build_from_checkpoint(path, device="cpu")
        assert hp["input_modality"] == modality and not multimodal and "mixer_type" not in hp
        for k, v in model.state_dict().items():
            src = enc + k[len("encoder."):] if k.startswith("encoder.") else k
            assert torch.equal(v, both[src]), k


def _vocab_path(ws):
    (path,) = (ws / "cache" / "vocabs").glob("*.json")
    return str(path)


def _test_inputs(n=3):
    """The fixture corpus's first test samples: u8 images and waveforms."""
    from omr_a2s_multimodal_transformer_tpu_torch.data.sources import make_source

    src = make_source("synthetic", "test", encoding="kern", synthetic=True, synthetic_kwargs=dict(SYN))
    return [(src[i]["image"], src[i]["audio"]["array"]) for i in range(n)]


def _want_krn(model, xs, pad, vocab):
    """The .krn lines the greedy decode of host frontend outputs gives."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli.transcribe import _pad
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn
    from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h import seq2kern_lines

    tokens, _ = greedy_decode_fn(model, model.max_seq_len, vocab.sos_id, vocab.eos_id)(
        *_pad([(None, x) for x in xs], pad, "cpu"))
    return ["\n".join(seq2kern_lines(vocab.tokens(r, strip_special=True))) + "\n" for r in _rows(tokens, vocab.eos_id)]


@pytest.mark.parametrize("kind", ["wav", "png", "fused"])
def test_transcribe_cli(av, rand, tmp_path, kind):
    """cli.transcribe writes one .krn per input (batch size 2 over 3 inputs),
    the greedy (or weighted, for image/wave pairs) decode of the host
    frontends' outputs; .wav read by scipy, .png by PIL."""
    from scipy.io import wavfile

    from omr_a2s_multimodal_transformer_tpu_torch.cli import transcribe
    from omr_a2s_multimodal_transformer_tpu_torch.data import collate
    from omr_a2s_multimodal_transformer_tpu_torch.data.frontends import preprocess_audio, preprocess_image
    from omr_a2s_multimodal_transformer_tpu_torch.data.vocab import Vocabulary

    if kind != "wav":
        pytest.importorskip("PIL", reason="image inputs need PIL")
        from PIL import Image
    ws = av["ws"]
    samples = _test_inputs()
    for i, (img, wave) in enumerate(samples):
        wavfile.write(str(tmp_path / f"s{i}.wav"), 22050, wave)
        if kind != "wav":
            Image.fromarray(img).save(tmp_path / f"s{i}.png")
    vocab = Vocabulary.load(_vocab_path(ws))
    img_ckpt, aud_ckpt = rand["image"], rand["audio"]
    argv = ["--vocab_path", _vocab_path(ws), "--out_dir", str(tmp_path / "out"), "--batch_size", "2",
            "--device", "cpu"]
    images = [preprocess_image(img) for img, _ in samples]
    spectrograms = [preprocess_audio(wave, 22050) for _, wave in samples]
    if kind == "wav":
        argv += ["--checkpoint_path", str(aud_ckpt), "--inputs", str(tmp_path / "*.wav")]
        model, _, _ = common.build_from_checkpoint(str(aud_ckpt), device="cpu")
        want = (_want_krn(model, spectrograms[:2], collate.AUDIO_PAD_VALUE, vocab)
                + _want_krn(model, spectrograms[2:], collate.AUDIO_PAD_VALUE, vocab))
    elif kind == "png":
        argv += ["--checkpoint_path", str(img_ckpt), "--inputs", str(tmp_path / "*.png")]
        model, _, _ = common.build_from_checkpoint(str(img_ckpt), device="cpu")
        want = (_want_krn(model, images[:2], collate.IMAGE_PAD_VALUE, vocab)
                + _want_krn(model, images[2:], collate.IMAGE_PAD_VALUE, vocab))
    else:
        from omr_a2s_multimodal_transformer_tpu_torch.cli.transcribe import _pad
        from omr_a2s_multimodal_transformer_tpu_torch.training.decode import weighted_decode_fn
        from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h import seq2kern_lines

        argv += ["--checkpoint_path", str(img_ckpt), "--audio_checkpoint_path", str(aud_ckpt), "--inputs",
                 str(tmp_path / "*.png"), "--audio_inputs", str(tmp_path / "*.wav"), "--alpha", "0.4"]
        mi, _, _ = common.build_from_checkpoint(str(img_ckpt), device="cpu")
        ma, _, _ = common.build_from_checkpoint(str(aud_ckpt), device="cpu")
        decode = weighted_decode_fn(mi, ma, mi.max_seq_len, vocab.sos_id, vocab.eos_id)
        want = []
        for sl in (slice(0, 2), slice(2, 3)):
            tokens, _ = decode(*_pad([(None, x) for x in images[sl]], collate.IMAGE_PAD_VALUE, "cpu"),
                               *_pad([(None, x) for x in spectrograms[sl]], collate.AUDIO_PAD_VALUE, "cpu"), 0.4)
            want += ["\n".join(seq2kern_lines(vocab.tokens(r, strip_special=True))) + "\n"
                     for r in _rows(tokens, vocab.eos_id)]
    assert transcribe.main(argv) == 3
    got = [(tmp_path / "out" / f"s{i}.krn").read_text() for i in range(3)]
    assert got == want and all(g.startswith("**kern") for g in got)


def test_serve_cli_fused_over_http(av, rand):
    """cli.serve with an image and an audio checkpoint serves the fused
    pair: a POSTed .npz gives the server's own result, /healthz its stats."""
    import io
    import urllib.request

    import numpy as np

    from omr_a2s_multimodal_transformer_tpu_torch.cli import serve

    ws = av["ws"]
    args = serve.build_parser().parse_args([
        "--checkpoint_path", str(rand["image"]), "--audio_checkpoint_path", str(rand["audio"]),
        "--vocab_path", _vocab_path(ws), "--port", "0", "--image_height", "64", "--image_widths", "48,96",
        "--audio_seconds", "0.6", "--device", "cpu", "--threefry_prng"])
    server, httpd, modality = serve.start(args)
    try:
        assert modality == "fused" and server.audio_samples == (13312,)
        img, wave = _test_inputs(1)[0]
        buf = io.BytesIO()
        np.savez(buf, image=img, wave=wave)
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/transcribe", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        direct = server.transcribe((img, wave), timeout=120)
        assert out["token_ids"] == direct.token_ids and out["tokens"] == direct.tokens and direct.tokens
        assert server.batch_stats() == {"bucket96x13312_b1": 2}
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop(timeout=120)


NEW_CLIS = ("weighted_test", "sw_test", "transcribe", "serve")


@pytest.mark.parametrize("name", NEW_CLIS)
def test_inference_cli_flags_are_the_jax_ones_and_device(name):
    import importlib

    jax_flags = {a.dest for a in importlib.import_module(f"omr_a2s_multimodal_transformer_tpu.cli.{name}")
                 .build_parser()._actions}
    port_flags = {a.dest for a in importlib.import_module(f"omr_a2s_multimodal_transformer_tpu_torch.cli.{name}")
                  .build_parser()._actions}
    assert jax_flags <= port_flags and port_flags - jax_flags == {"device"}


@pytest.mark.parametrize("name", NEW_CLIS)
def test_inference_clis_need_a_gpu_unless_told_cpu_and_refuse_int4(av, rand, tmp_path, name):
    """Without a GPU each CLI raises unless given --device cpu. --cache_dtype
    int4, refused until it was ported, runs each on the random-weight
    checkpoints: weighted_test and sw_test give finite metrics over the
    test split, transcribe writes one .krn a .wav, serve answers a request;
    each builds its models with the int4 cache."""
    import importlib

    from scipy.io import wavfile

    from omr_a2s_multimodal_transformer_tpu_torch.cli import common as cli_common

    cli = importlib.import_module(f"omr_a2s_multimodal_transformer_tpu_torch.cli.{name}")
    if name in ("weighted_test", "sw_test"):
        argv = _data(tmp_path) + ["--image_checkpoint_path", str(tmp_path), "--audio_checkpoint_path",
                                            str(tmp_path)]
    else:
        argv = ["--checkpoint_path", str(tmp_path), "--vocab_path", str(tmp_path / "v.json")]
        argv += ["--inputs", str(tmp_path / "*.wav")] if name == "transcribe" else []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
    assert not (tmp_path / "cache").exists()

    ws, built = av["ws"], []
    build = cli_common.build_from_checkpoint

    def recording(path, hparams_override=None, device=None):
        built.append((hparams_override or {}).get("cache_dtype"))
        return build(path, hparams_override, device=device)

    int4 = ["--device", "cpu", "--cache_dtype", "int4"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_common, "build_from_checkpoint", recording)
        if name in ("weighted_test", "sw_test"):
            out = cli.main(_data(ws) + ["--image_checkpoint_path", str(rand["image"]), "--audio_checkpoint_path",
                                        str(rand["audio"]), "--run_dir", str(tmp_path / "r")] + int4)
            assert all(map(math.isfinite, out.values())) and "sym-er" in out
        elif name == "transcribe":
            for i, (_, wave) in enumerate(_test_inputs(2)):
                wavfile.write(str(tmp_path / f"s{i}.wav"), 22050, wave)
            n = cli.main(["--checkpoint_path", str(rand["audio"]), "--vocab_path", _vocab_path(ws), "--inputs",
                          str(tmp_path / "*.wav"), "--out_dir", str(tmp_path / "krn")] + int4)
            assert n == 2 and all((tmp_path / "krn" / f"s{i}.krn").read_text().startswith("**kern") for i in range(2))
        else:
            args = cli.build_parser().parse_args(["--checkpoint_path", str(rand["image"]), "--vocab_path",
                                                  _vocab_path(ws), "--port", "0", "--image_height", "64",
                                                  "--image_widths", "96"] + int4)
            server, httpd, modality = cli.start(args)
            try:
                result = server.transcribe(_test_inputs(1)[0][0], timeout=120)
                assert modality == "image" and result.tokens
            finally:
                httpd.shutdown()
                httpd.server_close()
                server.stop(timeout=120)
    assert built and set(built) == {"int4"}
