"""The port's Trainer against the JAX package's Trainer on the multimodal
model, on the CPU (the image model's comparisons: test_torch_port_trainer.py).

Both train the gated attn_both model (the tiny encoders, the full 8-layer
decoder, d_model 256) on the corpus of tests/test_cli_e2e.py in both
modalities (6 samples of 32-33 x 64-96 px and 0.3-0.5 s of audio, batch 3:
2 steps an epoch), from the same weights (the JAX Trainer's init, loaded
into the port by ``training/jax_import.load_jax_params``), deterministic
(every dropout 0, the JAX mixer's weight dropout off, teacher forcing 0),
clip_norm 1.0, warmup-cosine, modality dropout at 0.5, each from its own
data module, both in float64.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_port_common import assert_rel_l2, mm_state_dict_to_jax

from omr_a2s_multimodal_transformer_tpu.data import dataset as j_dataset
from omr_a2s_multimodal_transformer_tpu.data import frontends as j_frontends
from omr_a2s_multimodal_transformer_tpu.data.dataset import ARDataModule as JDataModule
from omr_a2s_multimodal_transformer_tpu.models import build_model as j_build_model
from omr_a2s_multimodal_transformer_tpu.models import multimodal as j_multimodal
from omr_a2s_multimodal_transformer_tpu.training import checkpoint as j_ckpt
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


def _hparams(dm):
    return dict(vocab_size=len(dm.get_vocab()), max_seq_len=dm.get_max_seq_len(), input_modality="image",
                **NO_DROPOUT)


def _losses(trainer):
    return [r["train_loss"] for r in map(json.loads, open(trainer.logger.path)) if "train_loss" in r]


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v) for path, v in jax.tree_util.tree_leaves_with_path(tree)}


# the same corpus in both modalities (its audio: 0.3-0.5 s, 195 x 13-22 spectrograms), the gated attn_both mixer
MM_HP = dict(input_modality="both", mixer_type="attn_both", mixer_residual=True, **NO_DROPOUT)
MM_OPT = dict(OPT, teacher_forcing_modality_prob=0.5)  # single-modality steps among the fused ones


class _NoDropoutCrossAttention(j_multimodal.CrossAttention):
    """The JAX mixer's CrossAttention with its weight dropout (0.1, not an
    hparam) off, for a deterministic comparison; same params."""

    dropout: float = 0.0


@pytest.fixture(scope="module")
def mm_start(tmp_path_factory):
    """Both packages' multimodal data modules (JAX's audio frontend
    uncached), the JAX Trainer's initial params (numpy), and unimodal image
    and audio weights of the same corpus in both checkpoint formats."""
    tmp = tmp_path_factory.mktemp("trainer_mm")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dataset, "preprocess_audio", getattr(j_frontends.preprocess_audio, "__wrapped__",
                                                          j_frontends.preprocess_audio))
        mp.setattr(j_multimodal, "CrossAttention", _NoDropoutCrossAttention)
        dj, dp = (cls(cache_root=str(tmp / c), **dict(DM, input_modality="both")) for cls, c in
                  ((JDataModule, "cache_j"), (ARDataModule, "cache_p")))
        for dm in (dj, dp):
            dm.setup("fit")
        hp = dict(_hparams(dj), **MM_HP)
        jt = JTrainer(j_build_model(hp)[0], dj.get_vocab(), hp, weights_dir=str(tmp / "w_init"),
                      run_dir=str(tmp / "r_init"), multimodal=True, **MM_OPT)
        jt.init_state(next(iter(dj.train_dataloader())))
        p0 = jax.tree.map(lambda x: np.array(x), jt.state.params)
        donors = {}
        for i, modality in enumerate(("image", "audio")):
            model, _ = build_model(dict(hp, input_modality=modality), device="cpu", seed=20 + i)
            sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
            paths = str(tmp / f"{modality}_j"), str(tmp / f"{modality}_p")
            j_ckpt.save_checkpoint(paths[0], {"params": convert_unimodal_state_dict(sd)})
            ckpt_lib.save_checkpoint(paths[1], {"params": sd})
            donors[modality] = paths
        yield tmp, dj, dp, hp, p0, donors


def _mm_pair(mm_start, tag, **over):
    """A JAX and a port Trainer, multimodal, both in float64, from the same
    initial params, each recording the modality of every train step."""
    tmp, dj, dp, hp, p0, donors = mm_start
    common = dict(epochs=2, check_val_every_n_epoch=3, multimodal=True, **MM_OPT, **over)
    jt = JTrainer(j_build_model(hp)[0], dj.get_vocab(), hp, weights_dir=str(tmp / f"wj_{tag}"),
                  run_dir=str(tmp / f"rj_{tag}"), **common)
    jt.state = JTrainState.create(jax.tree.map(lambda w: jnp.asarray(w, np.float64), p0), jt.tx)
    model, _ = build_model(hp, device="cpu")
    load_jax_params(model, p0)
    model.cross_attn.dropout = 0.0  # as the JAX side's
    model.double()
    pt = Trainer(model, dp.get_vocab(), hp, weights_dir=str(tmp / f"wp_{tag}"), run_dir=str(tmp / f"rp_{tag}"),
                 device="cpu", **common)
    pt.init_state()
    seen = {}
    for name, trainer in (("jax", jt), ("port", pt)):
        seen[name], step = [], trainer.train_step

        def recording(state, batch, rng, modality, _step=step, _seen=seen[name]):
            _seen.append(modality)
            return _step(state, batch, rng, modality)

        trainer.train_step = recording
    return jt, pt, seen


def _mm_port_tree(model):
    return mm_state_dict_to_jax(model.state_dict())


@pytest.mark.parametrize("warm", [False, True], ids=["fresh_all", "warm_mixer_only"])
def test_multimodal_fit_two_epochs_matches_jax(mm_start, warm):
    """Two epochs (4 steps) of the gated attn_both model, modality dropout at
    0.5: the modality sequence equal draw for draw (it holds an image-only
    step, in which the audio encoder takes Adam's step on a zero gradient,
    as under optax), the losses within 1e-6 relative, each leaf's update
    within 1e-3 relative L2. ``warm``: warm_start_from_unimodal (image and
    audio donors, the decoder from the audio one) gives JAX's stitched
    params exactly, and train_only=("cross_attn", "mix_gate") leaves the
    donors bit-identical.

    Both packages run in float64 here (the port's model cast with
    ``double()``; the Trainer's code path is the float32 one). In float32
    the port's epoch-2 loss moves 3e-3 from JAX's float64 one: Adam
    normalizes each element's step by its own gradient, and after its first
    update (step 2; the warmup's lr is 0 at step 1) the encoders' updates
    lie 1-2% (relative L2) from float64's, from the float32 rounding of
    their near-zero gradient elements; the same port in float64 agrees with
    JAX to 2e-7 (loss) and 8e-5 (updates)."""
    tmp, dj, dp, hp, p0, donors = mm_start
    over = dict(train_only=("cross_attn", "mix_gate")) if warm else {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(j_dataset, "preprocess_audio", getattr(j_frontends.preprocess_audio, "__wrapped__",
                                                          j_frontends.preprocess_audio))
        mp.setattr(j_multimodal, "CrossAttention", _NoDropoutCrossAttention)
        jt, pt, seen = _mm_pair(mm_start, f"fit_{warm}", **over)
        if warm:
            jt.warm_start_from_unimodal(donors["image"][0], donors["audio"][0], decoder_from="audio")
            pt.warm_start_from_unimodal(donors["image"][1], donors["audio"][1], decoder_from="audio")
            start_j = jax.tree.map(lambda w: np.asarray(w, np.float64), jt.state.params)
            _assert_same_tree(_mm_port_tree(pt.model), start_j)
            assert pt.state.step == int(jt.state.step) == 0
            jt.state = JTrainState.create(jax.tree.map(jnp.asarray, start_j), jt.tx)  # the donors' f32 leaves in f64
        else:
            start_j = p0
        jt.fit(dj)
    pt.fit(dp)
    assert len(seen["port"]) == 4 and seen["port"] == seen["jax"]
    assert set(seen["port"]) - {"both"}, seen  # the draws hold single-modality steps
    losses_j, losses_p = _losses(jt), _losses(pt)
    assert len(losses_j) == len(losses_p) == 2
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-6)
    assert pt.state.step == int(jt.state.step) == 4
    flat_0, flat_j, flat_p = _leaves(start_j), _leaves(jt.state.params), _leaves(_mm_port_tree(pt.model))
    assert flat_0.keys() == flat_j.keys() == flat_p.keys()
    for name, w0 in flat_0.items():
        if warm and not name.startswith(("['cross_attn']", "['mix_gate']")):
            np.testing.assert_array_equal(flat_p[name], w0, err_msg=f"frozen {name} moved")
            np.testing.assert_array_equal(flat_j[name], w0, err_msg=f"frozen {name} moved in JAX")
        elif "['k_proj']['bias']" not in name:  # exact gradient zero: the update is Adam-scaled noise
            assert np.linalg.norm(flat_j[name] - w0) > 0, name
            assert_rel_l2(flat_p[name] - w0, flat_j[name] - w0, 1e-3, name)


def _assert_same_tree(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
