"""The port's Trainer against the JAX package's Trainer, on the CPU.

Both train the tiny image model (torch_port_common's architecture: the
full 8-layer decoder, d_model 256) on the corpus of tests/test_cli_e2e.py
(6 samples of 32-33 x 64-96 px, batch 3: 2 steps an epoch) from the same
weights (the JAX Trainer's init, loaded into the port by
``training/jax_import.load_jax_params``), deterministic (every dropout 0,
teacher forcing 0), clip_norm 1.0, warmup-cosine, each from its own data
module (the batches are equal: test_torch_port_data.py). The port runs in
float32 (``bf16_compute=False``).

- ``fit`` over two epochs: each epoch's train_loss within 1e-4 relative;
  each parameter leaf's update within 5e-2 in relative L2 norm, not
  elementwise, leaving out the key-projection biases, as
  test_torch_port_trajectory.py does and for its reason (Adam carries the
  rounding noise of near-zero gradients into full steps). The same with
  ``train_only=("decoder",)``: the encoder bit-identical to its start, the
  decoder as JAX's. That the clip's norm takes the frozen gradients too
  (the reference's order, matched) shows there only through Adam, which
  nearly cancels the clip's one scalar a step (a copy of the port that
  clips over the trainable groups alone moves the epoch-2 loss by 1.2e-3
  relative, and fails); ``test_clip_norm_takes_the_frozen_gradients``
  holds it directly on ``TrainState.apply_gradients``, against the JAX
  package's ``adam`` and beside the other order. Here the JAX Trainer
  runs in float64 (``jax.enable_x64``): on this corpus of mostly white
  images its own float32 encoder gradients lie 2-3% (relative L2) from its
  float64 ones, while the port's float32 ones lie within 5e-5 of them
  (``test_port_float32_encoder_gradient_is_close_to_float64``); the
  epoch-2 loss then moves by up to 1.6e-3 between JAX's float32 and
  float64 runs, more than the tolerance.
- ``evaluate`` before training (JAX in float32, as the port): the same
  val_sym-er / val_seq-er, exactly, and the same decoded token rows; also
  with beam search (beam 2, length penalty 0.6) and MV2H.
- Resume, checkpoint restore and its loud params-only fallback, and the
  arguments that raise.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import assert_rel_l2

from omr_a2s_multimodal_transformer_tpu.data.dataset import ARDataModule as JDataModule
from omr_a2s_multimodal_transformer_tpu.models import build_model as j_build_model
from omr_a2s_multimodal_transformer_tpu.training.loop import Trainer as JTrainer
from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu.training.train_state import TrainState as JTrainState
from omr_a2s_multimodal_transformer_tpu_torch.data.dataset import ARDataModule
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib
from omr_a2s_multimodal_transformer_tpu_torch.training.jax_import import load_jax_params
from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

SYN = dict(n=6, img_height_range=(32, 33), img_width_range=(64, 96), audio_seconds_range=(0.3, 0.5), n_measures=1)
DM = dict(ds_name="synthetic", krn_encoding="kern", input_modality="image", batch_size=3, num_workers=1,
          synthetic=True, synthetic_kwargs=SYN, seed=5)
NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=4, clip_norm=1.0, teacher_forcing_prob=0.0,
           bf16_compute=False, seed=7)


def _dm(cls, cache):
    dm = cls(cache_root=str(cache), **DM)
    dm.setup("fit")
    return dm


def _hparams(dm):
    return dict(vocab_size=len(dm.get_vocab()), max_seq_len=dm.get_max_seq_len(), input_modality="image",
                **NO_DROPOUT)


def _losses(trainer):
    return [r["train_loss"] for r in map(json.loads, open(trainer.logger.path)) if "train_loss" in r]


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """Data modules of both packages and the JAX Trainer's initial params (numpy)."""
    tmp = tmp_path_factory.mktemp("trainer")
    dj, dp = _dm(JDataModule, tmp / "cache_j"), _dm(ARDataModule, tmp / "cache_p")
    hp = _hparams(dj)
    jt = JTrainer(j_build_model(hp)[0], dj.get_vocab(), hp, weights_dir=str(tmp / "w_init"),
                  run_dir=str(tmp / "r_init"), **OPT)
    jt.init_state(next(iter(dj.train_dataloader())))
    p0 = jax.tree.map(lambda x: np.array(x), jt.state.params)
    return tmp, dj, dp, hp, p0


def _pair(start, tag, jax_dtype=np.float32, **over):
    """A JAX and a port Trainer from the same initial params (JAX's as jax_dtype)."""
    tmp, dj, dp, hp, p0 = start
    common = dict(epochs=2, check_val_every_n_epoch=3, **OPT, **over)  # no validation: no best reload
    jt = JTrainer(j_build_model(hp)[0], dj.get_vocab(), hp, weights_dir=str(tmp / f"wj_{tag}"),
                  run_dir=str(tmp / f"rj_{tag}"), **common)
    jt.state = JTrainState.create(jax.tree.map(lambda w: jnp.asarray(w, jax_dtype), p0), jt.tx)
    model, _ = build_model(hp, device="cpu")
    load_jax_params(model, p0)
    pt = Trainer(model, dp.get_vocab(), hp, weights_dir=str(tmp / f"wp_{tag}"), run_dir=str(tmp / f"rp_{tag}"),
                 device="cpu", **common)
    pt.init_state()
    return jt, pt


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_tree(model):
    return convert_unimodal_state_dict({n: p.detach().clone() for n, p in model.named_parameters()})


@pytest.mark.parametrize("train_only", [None, ("decoder",)], ids=["all", "decoder_only"])
def test_fit_two_epochs_matches_jax(start, train_only):
    tmp, dj, dp, hp, p0 = start
    with jax.enable_x64(True):
        jt, pt = _pair(start, f"fit_{train_only}", jax_dtype=np.float64, train_only=train_only)
        jt.fit(dj)
    pt.fit(dp)
    losses_j, losses_p = _losses(jt), _losses(pt)
    assert len(losses_j) == len(losses_p) == 2
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert pt.state.step == int(jt.state.step) == 4
    flat_0, flat_j, flat_p = _leaves(p0), _leaves(jt.state.params), _leaves(_port_tree(pt.model))
    assert flat_0.keys() == flat_j.keys() == flat_p.keys()
    for name, w0 in flat_0.items():
        if train_only and not name.startswith(f"['{train_only[0]}']"):
            np.testing.assert_array_equal(flat_p[name], w0, err_msg=f"frozen {name} moved")
            np.testing.assert_array_equal(flat_j[name], w0, err_msg=f"frozen {name} moved in JAX")
        elif "['k_proj']['bias']" not in name:  # exact gradient zero: the update is Adam-scaled noise
            assert np.linalg.norm(flat_j[name] - w0) > 0, name
            assert_rel_l2(flat_p[name] - w0, flat_j[name] - w0, 5e-2, name)


def _encoder_grads(model, batch, dtype):
    from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad

    model = model.to(dtype)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    model.zero_grad()
    cross_entropy_ignore_pad(model(b["x"].to(dtype), b["x_hw"], b["y_in"]), b["y_out"]).backward()
    return torch.cat([p.grad.double().flatten() for p in model.encoder.parameters()])


def test_port_float32_encoder_gradient_is_close_to_float64(start):
    """Why the fit comparison runs JAX in float64: on the corpus's first
    batch the port's float32 encoder gradient is within 2e-4 (relative L2)
    of its float64 one, and the float64 gradients of both packages agree to
    1e-6."""
    from omr_a2s_multimodal_transformer_tpu.training.losses import cross_entropy_ignore_pad as j_ce

    tmp, dj, dp, hp, p0 = start
    model, _ = build_model(hp, device="cpu")
    load_jax_params(model, p0)
    batch = next(iter(dp.train_dataloader()))
    g32, g64 = _encoder_grads(model, batch, torch.float32), _encoder_grads(model, batch, torch.float64)
    assert float((g32 - g64).norm() / g64.norm()) < 2e-4
    jmodel = j_build_model(hp)[0]
    with jax.enable_x64(True):
        def loss(params):
            logits = jmodel.apply({"params": params}, jnp.asarray(batch["x"], np.float64),
                                  jnp.asarray(batch["x_hw"]), jnp.asarray(batch["y_in"]), True)
            return j_ce(logits, jnp.asarray(batch["y_out"]))

        want = _leaves(jax.grad(loss)(jax.tree.map(lambda w: jnp.asarray(w, np.float64), p0))["encoder"])
    got = _leaves(convert_unimodal_state_dict({n: p.grad for n, p in model.named_parameters()})["encoder"])
    assert got.keys() == want.keys()
    diff = np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want))
    assert diff <= 1e-6 * np.sqrt(sum(np.sum(want[k] ** 2) for k in want))


class _TwoGroups(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(5, 4)
        self.decoder = torch.nn.Linear(4, 3)


def test_clip_norm_takes_the_frozen_gradients():
    """train_only=("decoder",) with clip_norm 1: the clip scales the
    decoder's gradients by clip / ||every gradient||, the frozen encoder's
    included (the JAX chain clips before it zeroes the frozen groups), not
    by clip / ||decoder gradients||. Over three steps whose encoder
    gradients dominate by changing factors, the port's parameters equal
    those of the JAX package's ``adam(clip_norm=1, train_only=("decoder",))``
    to 1e-6 relative and lie far from those of the other order (clip inside
    the trainable group), so the comparison tells the two apart. The
    encoder and its Adam state never move."""
    import optax

    from omr_a2s_multimodal_transformer_tpu.training.train_state import adam as j_adam
    from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState

    rng = np.random.default_rng(3)
    model = _TwoGroups()
    p0 = {g: {n: rng.standard_normal(tuple(p.shape)).astype(np.float32) for n, p in getattr(model, g).named_parameters()}
          for g in ("encoder", "decoder")}
    with torch.no_grad():
        for g, leaves in p0.items():
            for n, w in leaves.items():
                getattr(getattr(model, g), n).copy_(torch.from_numpy(w))
    lr, clip = 1e-2, 1.0
    state = TrainState.create(model, lr=lr, clip_norm=clip, train_only=("decoder",))
    grads = [{g: {n: (rng.standard_normal(w.shape) * (factor if g == "encoder" else 0.2)).astype(np.float32)
                  for n, w in leaves.items()} for g, leaves in p0.items()} for factor in (30.0, 3.0, 300.0)]
    for t, gr in enumerate(grads):
        for g, leaves in gr.items():
            for n, w in leaves.items():
                getattr(getattr(model, g), n).grad = torch.from_numpy(w.copy())
        state.apply_gradients()
        if t == 0:  # the clip's scale, read from the decoder's gradients it scaled in place
            norm_all = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2) for ls in gr.values() for w in ls.values()))
            norm_dec = np.sqrt(sum(np.sum(w.astype(np.float64) ** 2) for w in gr["decoder"].values()))
            assert norm_all > 10 * clip and norm_dec < clip  # the clip is active, and only with the frozen norm
            for n, w in gr["decoder"].items():
                np.testing.assert_allclose(getattr(model.decoder, n).grad.numpy(), w * clip / norm_all, rtol=1e-5)
    got = {g: {n: p.detach().numpy() for n, p in getattr(model, g).named_parameters()} for g in p0}

    def run(tx):
        params = jax.tree.map(jnp.asarray, p0)
        opt = tx.init(params)
        for gr in grads:
            updates, opt = tx.update(jax.tree.map(jnp.asarray, gr), opt, params)
            params = optax.apply_updates(params, updates)
        return jax.tree.map(np.asarray, params)

    want = run(j_adam(lr, clip_norm=clip, train_only=("decoder",)))
    other = run(optax.multi_transform(
        {"train": optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)),
         "freeze": optax.set_to_zero()}, {"encoder": "freeze", "decoder": "train"}))
    for n, w0 in p0["encoder"].items():
        np.testing.assert_array_equal(got["encoder"][n], w0)
        np.testing.assert_array_equal(want["encoder"][n], w0)
    assert all(p not in state.optimizer.state for p in model.encoder.parameters())
    for n, w0 in p0["decoder"].items():
        assert_rel_l2(got["decoder"][n] - w0, want["decoder"][n] - w0, 1e-4, n)
        step_other = other["decoder"][n] - w0
        assert np.linalg.norm(got["decoder"][n] - w0 - step_other) > 0.05 * np.linalg.norm(step_other), n


def test_evaluate_matches_jax_before_training(start):
    tmp, dj, dp, hp, p0 = start
    jt, pt = _pair(start, "eval")
    mj = jt.evaluate(dj.val_dataloader(), name="val", save_preds=str(tmp / "preds_j.jsonl"))
    mp = pt.evaluate(dp.val_dataloader(), name="val", save_preds=str(tmp / "preds_p.jsonl"))
    assert mp == mj
    rows_j = (tmp / "preds_j.jsonl").read_text().splitlines()
    rows_p = (tmp / "preds_p.jsonl").read_text().splitlines()
    assert len(rows_p) == SYN["n"] and rows_p == rows_j
    assert pt.last_eval["val_decode_batches"] == 1 and pt.last_eval["val_decode_steps"] > 0


def test_evaluate_with_beam_and_mv2h_matches_jax(start):
    """evaluate with beam_size 2, length_penalty 0.6 and compute_mv2h (JAX
    in float32, as the port): the same metrics, MV2H's among them, and the
    same decoded rows."""
    tmp, dj, dp, hp, p0 = start
    jt, pt = _pair(start, "beam", beam_size=2, length_penalty=0.6, compute_mv2h=True)
    mj = jt.evaluate(dj.val_dataloader(), name="val", save_preds=str(tmp / "beam_j.jsonl"))
    mp = pt.evaluate(dp.val_dataloader(), name="val", save_preds=str(tmp / "beam_p.jsonl"))
    assert mp == mj and "val_mv2h" in mp
    assert (tmp / "beam_p.jsonl").read_text() == (tmp / "beam_j.jsonl").read_text()


def _port_trainer(start, weights, run, epochs, **over):
    tmp, dj, dp, hp, p0 = start
    model, _ = build_model(hp, device="cpu", seed=3)
    kw = dict(OPT, **over)
    return Trainer(model, dp.get_vocab(), hp, weights_dir=str(weights), run_dir=str(run), epochs=epochs,
                   check_val_every_n_epoch=1, device="cpu", **kw)


def _record_steps(trainer):
    """y_in of every batch the trainer's step takes."""
    seen, step = [], trainer.train_step

    def recording(state, batch, generator):
        seen.append(batch["y_in"].clone())
        return step(state, batch, generator)

    trainer.train_step = recording
    return seen


def test_resume_from_last_carries_step_moments_and_best(start, tmp_path):
    tmp, dj, dp, hp, p0 = start
    weights = tmp_path / "weights"
    first = _port_trainer(start, weights, tmp_path / "run1", epochs=1)
    seen_first = _record_steps(first)
    first.fit(_dm(ARDataModule, tmp / "cache_p"))
    saved = ckpt_lib.restore_checkpoint(str(weights / "last"))
    best_meta = ckpt_lib.load_hparams(str(weights / "best"))
    assert saved["step"] == 2 and ckpt_lib.load_hparams(str(weights / "last"))["epoch"] == 1

    second = _port_trainer(start, weights, tmp_path / "run2", epochs=2)
    restore, after_restore = second.restore, {}

    def recording_restore(path):
        restore(path)
        if not after_restore:  # the resume from last, before any step
            after_restore.update(step=second.state.step, opt=copy.deepcopy(second.state.optimizer.state_dict()))

    second.restore = recording_restore
    seen_second = _record_steps(second)
    dm = _dm(ARDataModule, tmp / "cache_p")
    loaders = []
    make = dm.train_dataloader
    dm.train_dataloader = lambda: loaders.append(make()) or loaders[-1]
    second.fit(dm)

    assert second.start_epoch == 2 and after_restore["step"] == saved["step"]
    assert (second.best, second.best_epoch) == (best_meta["val_sym-er"], best_meta["epoch"]) == (
        best_meta["val_sym-er"], 1)
    want, got = saved["opt_state"]["state"], after_restore["opt"]["state"]
    assert want.keys() == got.keys() and len(want) == len(list(second.model.parameters()))
    for i in want:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(got[i][key], want[i][key], rtol=0, atol=0)
    assert ckpt_lib.restore_checkpoint(str(weights / "last"))["step"] == 4
    # the resumed loader replays the order of the first run's first epoch (a fresh loader: seed + 1 after
    # the peek at a sample batch, as in the JAX loop)
    assert loaders[0].epoch == 2 and len(seen_first) == len(seen_second) == 2
    for a, b in zip(seen_first, seen_second):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    recs = [json.loads(line) for line in open(second.logger.path)]
    resumed = [r for r in recs if "resumed_from" in r]
    assert resumed and resumed[0]["resumed_epoch"] == 1 and resumed[0]["resumed_step"] == 2


def test_restore_falls_back_loudly_to_params_only(start, tmp_path):
    tmp, dj, dp, hp, p0 = start
    full = _port_trainer(start, tmp_path / "w", tmp_path / "r1", epochs=1)
    full.init_state()
    path = full.save("mine", extra={"epoch": 0})
    assert sorted(os.listdir(path)) == [ckpt_lib.HPARAMS_FILE, ckpt_lib.STATE_FILE]  # no temporary left
    frozen = _port_trainer(start, tmp_path / "w", tmp_path / "r2", epochs=1, train_only=("decoder",))
    frozen.init_state()
    frozen.restore(path)  # its optimizer holds the decoder only: the full resume fails
    for a, b in zip(frozen.model.state_dict().values(), full.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    recs = [json.loads(line) for line in open(frozen.logger.path)]
    assert any("PARAMS-ONLY" in r.get("resume_degraded", "") for r in recs)
    fresh = _port_trainer(start, tmp_path / "w", tmp_path / "r3", epochs=1)
    fresh.restore(path)  # no state yet: params, then a new optimizer
    assert fresh.state is not None and fresh.state.step == 0


def test_trainer_arguments_that_raise(start, tmp_path):
    tmp, dj, dp, hp, p0 = start
    with pytest.raises(ValueError, match="nope"):
        _port_trainer(start, tmp_path / "w", tmp_path / "r", epochs=1, train_only=("nope",))
    # a mesh is ported (tests/test_torch_port_cli.py trains on two ranks): the model must be built on it
    with pytest.raises(ValueError, match="mesh"):
        _port_trainer(start, tmp_path / "w", tmp_path / "r", epochs=1, mesh=object())
    # the device cache is ported (tests/test_torch_port_device_cache.py): its flags are kept for fit
    for over in (dict(device_cache=True), dict(device_cache=True, device_cache_u8=True)):
        pt = _port_trainer(start, tmp_path / "w", tmp_path / "r", epochs=1, **over)
        assert (pt.device_cache, pt.device_cache_u8) == (True, "device_cache_u8" in over)
    # beam search and MV2H are ported (test_evaluate_with_beam_and_mv2h_matches_jax)
    pt = _port_trainer(start, tmp_path / "w", tmp_path / "r", epochs=1, beam_size=4, length_penalty=0.6,
                       compute_mv2h=True)
    assert pt.compute_mv2h and "beam_decode_fn" in pt._get_decode().__qualname__
    if not torch.cuda.is_available():
        model, _ = build_model(hp, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model, dp.get_vocab(), hp, weights_dir=str(tmp_path / "w"), run_dir=str(tmp_path / "r"))


def test_profile_first_epoch_writes_a_chrome_trace(start, tmp_path):
    """profile_first_epoch traces epoch 1 with torch.profiler (the JAX
    loop's jax.profiler trace) into a chrome trace beside the metrics log."""
    tmp, dj, dp, hp, p0 = start
    trainer = _port_trainer(start, tmp_path / "w", tmp_path / "r", epochs=1, profile_first_epoch=True)
    trainer.check_every = 2  # no validation
    trainer.fit(_dm(ARDataModule, tmp / "cache_p"))
    events = json.loads(open(trainer.logger.path + "_trace.json").read())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    recs = [json.loads(line) for line in open(trainer.logger.path)]
    epoch = [r for r in recs if "train_loss" in r][0]
    assert epoch["time_step_total_s"] > 0 and epoch["time_data_total_s"] > 0
