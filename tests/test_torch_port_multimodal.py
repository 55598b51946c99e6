"""The port's early-fusion multimodal model against the JAX package's, on the CPU.

The tiny image + audio model of torch_port_common (32x64 images, 195 x 24
spectrograms, the full 8-layer decoder), the same weights in both packages
(the port's random init through the JAX package's
``convert_multimodal_state_dict``, plus ``mix_gate``, set nonzero so that
the gates are read), deterministic mode.

Tolerances: logits without flash agree to 1e-4 x max |JAX| (float32 in
both, other summation orders; measured ~1e-6). With ``use_flash_cross``
both packages round q/k/v and p to bf16 inside flash at different points,
as ``test_torch_port_model.py`` says, and the logits agree to 5e-3 x max
|JAX| (measured 1.5e-3; bf16's rounding step is 3.9e-3). Gradients of the
loss (attn_both with gates, float32) agree to 1e-4 in relative L2 norm over
the tree. Greedy decode and the transcriber give identical tokens.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (
    EOS,
    MAXLEN,
    MM_KEYS,
    SOS,
    V,
    assert_rel_l2,
    jax_mm_model,
    mm_batch,
    mm_hparams,
    mm_port_and_jax_params,
    mm_state_dict_to_jax,
    to_torch,
)

from omr_a2s_multimodal_transformer_tpu.ops import masks as jmasks
from omr_a2s_multimodal_transformer_tpu.training import checkpoint as jckpt
from omr_a2s_multimodal_transformer_tpu.training.decode import greedy_decode_fn as j_greedy
from omr_a2s_multimodal_transformer_tpu.training.losses import cross_entropy_ignore_pad as j_ce
from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.models import MultimodalTransformer, build_model
from omr_a2s_multimodal_transformer_tpu_torch.ops import masks as pmasks
from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn
from omr_a2s_multimodal_transformer_tpu_torch.training.jax_import import load_jax_params
from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad
from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
MIXERS = ("concat", "attn_img", "attn_audio", "attn_both")


def test_corner_attn_mask_equals_jax():
    rng = np.random.default_rng(0)
    qv, kv = rng.random((3, 7)) < 0.6, rng.random((3, 11)) < 0.5
    got = pmasks.corner_attn_mask(torch.from_numpy(qv), torch.from_numpy(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmasks.corner_attn_mask(jnp.asarray(qv), jnp.asarray(kv))))
    assert got.shape == (3, 1, 7, 11)


def _logits(mixer, residual, flash, modality, seed):
    model, params = mm_port_and_jax_params(seed=seed, mixer_type=mixer, mixer_residual=residual,
                                           use_flash_cross=flash)
    b = mm_batch(seed=seed)
    jm = jax_mm_model(mixer_type=mixer, mixer_residual=residual, use_flash_cross=flash)
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, modality))(params, *(b[k] for k in MM_KEYS)))
    tb = to_torch(b)
    with torch.no_grad():
        got = model(*(tb[k] for k in MM_KEYS), modality=modality).numpy()
    assert got.shape == (2, MAXLEN, V) and np.isfinite(got).all()
    return got, want


def _tol(flash):
    return 5e-3 if flash else 1e-4


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("residual", [False, True], ids=["raw", "gated"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_fused_logits_match_jax(mixer, residual, flash):
    got, want = _logits(mixer, residual, flash, "both", seed=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(flash) * np.abs(want).max())


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("modality", ["image", "audio"])
def test_single_modality_logits_match_jax(modality, flash):
    """Modality dropout's single-modality programs: only one encoder runs,
    and the mixer is not read (attn_both with gates, the widest mixer)."""
    got, want = _logits("attn_both", True, flash, modality, seed=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(flash) * np.abs(want).max())


def _attn_both_gradients(port_dtype):
    """The attn_both model's loss and gradients in JAX (float64) and in the port (port_dtype), on the same weights
    and batch: (the port's loss, JAX's, {group: relative L2 distance of the port's gradients from JAX's})."""
    model, params = mm_port_and_jax_params(seed=3, mixer_type="attn_both", mixer_residual=True)
    model.to(port_dtype)
    b = mm_batch(seed=3)
    jm = jax_mm_model(mixer_type="attn_both", mixer_residual=True)

    def jloss(p):
        args = (jnp.asarray(b[k], jnp.float64) if b[k].dtype == np.float32 else b[k] for k in MM_KEYS)
        return j_ce(jm.apply(p, *args, "both"), b["y_out"])

    with jax.enable_x64(True):
        loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(lambda w: jnp.asarray(w, jnp.float64), params))
        grads_j = jax.tree.map(np.asarray, grads_j)
    tb = {k: v.to(port_dtype) if v.is_floating_point() else v for k, v in to_torch(b).items()}
    loss_t = cross_entropy_ignore_pad(model(*(tb[k] for k in MM_KEYS)), tb["y_out"])
    loss_t.backward()
    grads_t = mm_state_dict_to_jax({n: p.grad.double() for n, p in model.named_parameters()})
    flat_t = dict(jax.tree_util.tree_leaves_with_path(grads_t))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(grads_j["params"]))
    assert flat_t.keys() == flat_j.keys()
    assert np.abs(np.asarray(flat_j[(jax.tree_util.DictKey("mix_gate"),)])).min() > 0  # the gates are trained
    dist = {}
    for group in ("image_encoder", "audio_encoder", "decoder", "cross_attn", "mix_gate"):
        keys = [k for k in flat_j if k[0].key == group]
        assert keys, group
        got = np.concatenate([np.ravel(np.asarray(flat_t[k], np.float64)) for k in keys])
        want = np.concatenate([np.ravel(np.asarray(flat_j[k], np.float64)) for k in keys])
        dist[group] = np.linalg.norm(got - want) / np.linalg.norm(want)
    return float(loss_t.detach()), float(loss_j), dist


def test_attn_both_gradients_match_jax():
    """The port's gradients against the JAX package's, both in float64: at
    JAX's initialisers both packages' float32 audio-encoder gradients on
    these spectrograms lie 1.6e-2 (relative L2) from their float64 ones, in
    the port and in JAX alike (a ReLU input of the last DSC block lies
    within float32 rounding of 0 and flips), and JAX's float32 image-encoder
    gradient 8e-4."""
    loss_t, loss_j, dist = _attn_both_gradients(torch.float64)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    for group, d in dist.items():
        assert d <= 1e-4, f"{group}: relative L2 error {d:.3g} > 1e-4"


def test_attn_both_gradients_float32_port_match_jax_float64():
    """The port at its own float32 against JAX in float64. Read here: the
    image encoder 4.0e-5, the decoder 1.3e-5, the mixer 1.7e-5 and 1.1e-5,
    held at the float64 test's 1e-4; the audio encoder 1.6e-2 (its ReLU
    flip above), held at 3.5e-2."""
    loss_t, loss_j, dist = _attn_both_gradients(torch.float32)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    for group, d in dist.items():
        tol = 3.5e-2 if group == "audio_encoder" else 1e-4
        assert d <= tol, f"{group}: relative L2 error {d:.3g} > {tol}"


def test_bf16_train_step_is_finite_and_near_f32():
    """Each modality's step in bf16 compute (parameters and both inputs cast,
    as the JAX step casts them) gives a finite loss within 5% of the float32
    one; the float32 parameters stay float32 and finite."""
    model, _ = mm_port_and_jax_params(seed=4, mixer_type="attn_both", mixer_residual=True, use_flash_cross=True,
                                      **NO_DROPOUT)
    tb = to_torch(mm_batch(seed=4))
    for modality in ("both", "image", "audio"):
        losses = {}
        for bf16 in (False, True):
            m = copy.deepcopy(model)
            step = make_train_step(m, V, teacher_forcing_prob=0.0, bf16_compute=bf16, multimodal=True, device="cpu")
            _, loss = step(TrainState.create(m, 1e-4), tb, torch.Generator().manual_seed(0), modality)
            losses[bf16] = float(loss)
            assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in m.parameters())
        assert np.isfinite(losses[True])
        assert abs(losses[True] - losses[False]) < 0.05 * losses[False], (modality, losses)
    step = make_train_step(model, V, multimodal=True, device="cpu")
    with pytest.raises(ValueError, match="modality"):
        step(TrainState.create(model, 1e-4), tb, torch.Generator())


def test_greedy_multimodal_decode_token_identical_to_jax():
    model, params = mm_port_and_jax_params(seed=5, mixer_type="attn_both", mixer_residual=True)
    b = mm_batch(seed=5)
    jm = jax_mm_model(mixer_type="attn_both", mixer_residual=True)
    args = [jnp.asarray(b[k]) for k in ("xi", "xi_hw", "xa", "xa_hw")]
    tok_j, score_j = jax.jit(j_greedy(jm, MAXLEN, SOS, EOS, multimodal=True))(params, *args)
    tb = to_torch(b)
    tok_t, score_t = greedy_decode_fn(model, MAXLEN, SOS, EOS, multimodal=True)(
        tb["xi"], tb["xi_hw"], tb["xa"], tb["xa_hw"])
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), rtol=1e-4, atol=1e-4)


def test_multimodal_transcriber_token_identical_to_jax():
    from omr_a2s_multimodal_transformer_tpu.inference import make_multimodal_transcriber as j_make
    from omr_a2s_multimodal_transformer_tpu_torch.inference import make_multimodal_transcriber

    model, params = mm_port_and_jax_params(seed=6, mixer_type="attn_img", mixer_residual=True)
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 256, size=(2, 32, 64), dtype=np.uint8)
    img_hw = np.array([[32, 64], [27, 40]], np.int32)
    wave = (0.3 * rng.standard_normal((2, 512 * 23))).astype(np.float32)
    n = np.array([512 * 23, 7000], np.int32)
    wave[1, n[1]:] = 0.0
    tok_j, _ = j_make(jax_mm_model(mixer_type="attn_img", mixer_residual=True), SOS, EOS)(params, raw, img_hw, wave, n)
    f = make_multimodal_transcriber(model, SOS, EOS, device="cpu")
    tok_t, _ = f(*(torch.from_numpy(a) for a in (raw, img_hw, wave, n)))
    assert tok_t.shape == (2, MAXLEN)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


def _jax_init_tree(**over):
    b = mm_batch()
    shapes = jax.eval_shape(jax_mm_model(**over).init, jax.random.PRNGKey(0), *(b[k] for k in MM_KEYS))["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize("mixer,residual", [("concat", False), ("attn_img", True), ("attn_both", True)])
def test_jax_import_converts_a_multimodal_tree(mixer, residual):
    """A JAX init tree fills every port parameter (mix_gate included), and
    the port's weights round-trip through the JAX package's
    convert_multimodal_state_dict and back."""
    tree = _jax_init_tree(mixer_type=mixer, mixer_residual=residual)
    model, _ = build_model(mm_hparams(mixer_type=mixer, mixer_residual=residual), device="cpu", seed=1)
    load_jax_params(model, tree)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["audio_encoder.dscblocks.2.conv1.point_conv.weight"].numpy(),
                                  tree["audio_encoder"]["dsc2"]["conv1"]["point_conv"]["kernel"].transpose(3, 2, 0, 1))
    if mixer != "concat":
        np.testing.assert_array_equal(sd["cross_attn.attention.in_proj_weight"][:256].numpy(),
                                      tree["cross_attn"]["mha"]["q_proj"]["kernel"].T)
        np.testing.assert_array_equal(sd["mix_gate"].numpy(), tree["mix_gate"])
    fresh, _ = build_model(mm_hparams(mixer_type=mixer, mixer_residual=residual), device="cpu", seed=2)
    load_jax_params(fresh, mm_state_dict_to_jax(sd))
    for name, value in fresh.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), sd[name].numpy(), err_msg=name)


def _sd(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_trees_equal(a, b):
    la, lb = (dict(jax.tree_util.tree_leaves_with_path(t)) for t in (a, b))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(np.asarray(la[k]), np.asarray(lb[k]), err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("decoder_from", ["image", "audio"])
def test_split_and_stitch_equal_jax(decoder_from):
    mm, _ = build_model(mm_hparams(mixer_type="attn_img", mixer_residual=True), device="cpu", seed=7)
    img, _ = build_model(dict(mm_hparams(), input_modality="image"), device="cpu", seed=8)
    audio, _ = build_model(dict(mm_hparams(), input_modality="audio"), device="cpu", seed=9)
    sd_mm, sd_img, sd_audio = _sd(mm), _sd(img), _sd(audio)
    tree_mm = mm_state_dict_to_jax(sd_mm)
    for got, want in zip(ckpt_lib.split_multimodal_params(sd_mm), jckpt.split_multimodal_params(tree_mm)):
        assert "cross_attn.attention.in_proj_weight" not in got and "mix_gate" not in got
        _assert_trees_equal(convert_unimodal_state_dict(got), want)
    stitched = ckpt_lib.stitch_multimodal_params(sd_mm, sd_img, sd_audio, decoder_from, mixer_type="attn_img")
    want = jckpt.stitch_multimodal_params(tree_mm, convert_unimodal_state_dict(sd_img),
                                          convert_unimodal_state_dict(sd_audio), decoder_from)
    assert stitched.keys() == sd_mm.keys()
    _assert_trees_equal(mm_state_dict_to_jax(stitched), want)
    torch.testing.assert_close(stitched["mix_gate"], sd_mm["mix_gate"], rtol=0, atol=0)  # the mixer keeps its init


def test_stitch_rejects_wrong_structures_and_shapes():
    mm, _ = build_model(mm_hparams(), device="cpu", seed=7)
    img, _ = build_model(dict(mm_hparams(), input_modality="image"), device="cpu", seed=8)
    sd_mm, sd_img = _sd(mm), _sd(img)
    missing = {k: v for k, v in sd_img.items() if k != "encoder.dscblocks.3.conv3.point_conv.bias"}
    with pytest.raises(ValueError, match="structure"):
        ckpt_lib.stitch_multimodal_params(sd_mm, missing)
    wrong = dict(sd_img, **{"decoder.embedding.weight": torch.zeros(V + 1, 256)})  # another vocabulary
    with pytest.raises(ValueError, match="shape mismatch in decoder.embedding.weight"):
        ckpt_lib.stitch_multimodal_params(sd_mm, wrong)
    with pytest.raises(ValueError, match="decoder_from"):
        ckpt_lib.stitch_multimodal_params(sd_mm, sd_img, decoder_from="both")
    # the JAX package rejects the same trees
    tree_mm, j_missing = mm_state_dict_to_jax(sd_mm), convert_unimodal_state_dict(sd_img)
    del j_missing["encoder"]["dsc3"]["conv3"]["point_conv"]["bias"]
    for bad in (j_missing, convert_unimodal_state_dict(wrong)):
        with pytest.raises(ValueError):
            jckpt.stitch_multimodal_params(tree_mm, bad)


def test_mix_gate_of_the_wrong_shape_is_rejected_on_restore_and_stitch(tmp_path):
    """A checkpoint of a gated attn_both mixer (gate (2,)) restored into a
    gated attn_img model (gate (1,)): Trainer.restore, build_from_checkpoint
    and the stitch raise, naming mix_gate (the JAX package fails only when
    the model is applied)."""
    both, _ = build_model(mm_hparams(mixer_type="attn_both", mixer_residual=True), device="cpu", seed=1)
    hp = mm_hparams(mixer_type="attn_both", mixer_residual=True)
    ckpt_lib.save_checkpoint(str(tmp_path / "both"), {"params": both.state_dict()}, hparams=hp)
    img_mixer, _ = build_model(mm_hparams(mixer_type="attn_img", mixer_residual=True), device="cpu", seed=2)
    from omr_a2s_multimodal_transformer_tpu_torch.data.vocab import Vocabulary

    vocab = Vocabulary({f"t{i}": i for i in range(V)}, {i: f"t{i}" for i in range(V)})
    trainer = Trainer(img_mixer, vocab, hp, weights_dir=str(tmp_path / "w"), run_dir=str(tmp_path / "r"),
                      multimodal=True, device="cpu")
    for state in (False, True):
        if state:
            trainer.init_state()
        with pytest.raises(ValueError, match=r"mix_gate has shape \(2,\), the model's is \(1,\)"):
            trainer.restore(str(tmp_path / "both"))
    with pytest.raises(ValueError, match="mix_gate"):
        common.build_from_checkpoint(str(tmp_path / "both"), hparams_override={"mixer_type": "attn_img"},
                                     device="cpu")
    with pytest.raises(ValueError, match=r"stitch: mix_gate has shape \(2,\)"):
        ckpt_lib.stitch_multimodal_params(_sd(both), mixer_type="attn_img")
    ungated, _ = build_model(mm_hparams(mixer_type="attn_both"), device="cpu", seed=3)
    with pytest.raises(ValueError, match=r"unexpected \['mix_gate'\].*mix_gate has one entry per attention pass"):
        ckpt_lib.load_params(ungated, both.state_dict())


def test_save_split_checkpoints_writes_two_unimodal_checkpoints(tmp_path):
    mm, _ = build_model(mm_hparams(mixer_type="attn_audio", mixer_residual=True), device="cpu", seed=4)
    hp = dict(mm_hparams(mixer_type="attn_audio", mixer_residual=True), teacher_forcing_modality_prob=0.3)
    ckpt_lib.save_checkpoint(str(tmp_path / "mm"), {"params": mm.state_dict(), "step": 5}, hparams=hp)
    paths = ckpt_lib.save_split_checkpoints(str(tmp_path / "mm"))
    assert [p.rsplit("/", 1)[1] for p in paths] == ["mm_only_image_distorted", "mm_only_audio"]
    for path, modality, enc in zip(paths, ("image", "audio"), ("image_encoder", "audio_encoder")):
        model, hp2, multimodal = common.build_from_checkpoint(path, device="cpu")
        assert not multimodal and hp2["input_modality"] == modality
        assert "mixer_type" not in hp2 and "teacher_forcing_modality_prob" not in hp2
        for name, value in model.state_dict().items():
            src = name.replace("encoder.", f"{enc}.", 1) if name.startswith("encoder.") else name
            torch.testing.assert_close(value, mm.state_dict()[src], rtol=0, atol=0)


def test_build_model_both_and_what_still_raises():
    model, multimodal = build_model(mm_hparams(), device="cpu")
    assert multimodal and isinstance(model, MultimodalTransformer) and model.mixer_type == "concat"
    assert not hasattr(model, "cross_attn") and not hasattr(model, "mix_gate")
    for mixer, shape in (("attn_img", (1,)), ("attn_audio", (1,)), ("attn_both", (2,))):
        model, _ = build_model(mm_hparams(mixer_type=mixer, mixer_residual=True), device="cpu")
        assert tuple(model.mix_gate.shape) == shape and not model.mix_gate.detach().any()
    # ported since: remat rematerializes both encoders; memory_partition needs a mesh (tests/test_torch_port_remat.py)
    model, _ = build_model(mm_hparams(remat=True), device="cpu")
    assert model.image_encoder.remat and model.audio_encoder.remat and model.decoder.remat
    with pytest.raises(ValueError, match="needs a mesh"):
        build_model(mm_hparams(memory_partition=("data", "model", None)), device="cpu")
    for cache_dtype in ("int8", "int4"):  # ported: quantized cross K/V under a bf16 self-cache
        model, _ = build_model(mm_hparams(cache_dtype=cache_dtype), device="cpu")
        assert model.decoder.cache_dtype == cache_dtype
        assert all(t.dtype == torch.bfloat16 for t in model.decode_init_cache(1)["layer0"].values())
    with pytest.raises(ValueError, match="mixer"):
        build_model(mm_hparams(mixer_type="gated"), device="cpu")
