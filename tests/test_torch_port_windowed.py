"""The paper's windowed decoder and the packed-stem hparams, ported, against
the JAX package on the CPU (deterministic mode, float32).

- Banded attention: the port's ``ops/banded_attention.py`` against JAX's,
  with and without a key bias and at the default and a small chunk.
- A tiny windowed unimodal model (``attn_window`` 20) against JAX: logits
  on both sides of the dense/banded switch (L 200 takes the masked matrix,
  L 300 > 2 x 128 the band), the one-step loss and gradients, and greedy
  tokens with the ring self-cache wrapping (window 8, 9 slots, 40 steps).
- ``packed_stem=True`` hparams build a model whose logits equal those of
  the JAX model with the packed stem, with its params carried across by
  ``training/jax_import.py``.

Tolerances: float32 in both packages with other summation orders. Logits
and attention outputs 5e-4 absolute / 1e-3 relative, as in
test_torch_port_model.py; gradients 1e-2 in relative L2 norm per leaf, the
bound test_torch_port_train.py gives the float32 path (the k-projection
biases, whose exact gradient is zero, to 1e-4 of the largest gradient);
greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import IMG_W, SOS, V, assert_rel_l2, batch, jax_model, port_and_jax_params, to_torch

from omr_a2s_multimodal_transformer_tpu.ops.banded_attention import banded_causal_attention as j_banded
from omr_a2s_multimodal_transformer_tpu.ops.packed_conv import choose_pack_factor
from omr_a2s_multimodal_transformer_tpu.training.decode import greedy_decode_fn as j_greedy
from omr_a2s_multimodal_transformer_tpu.training.losses import cross_entropy_ignore_pad as j_ce
from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.ops.banded_attention import banded_causal_attention
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn
from omr_a2s_multimodal_transformer_tpu_torch.training.jax_import import load_jax_params
from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad

F32_MODEL_TOL = dict(rtol=1e-3, atol=5e-4)
NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
WINDOW = 20


@pytest.mark.parametrize("chunk", [None, 32])
@pytest.mark.parametrize("bias", [False, True])
def test_banded_attention_matches_jax(chunk, bias):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 300, 4, 16)).astype(np.float32) for _ in range(3))
    key_bias = None
    if bias:
        key_bias = np.zeros((2, 300), np.float32)
        key_bias[0, 250:] = -1e9
    oj = j_banded(*(jnp.asarray(a) for a in (q, k, v)), WINDOW, None if key_bias is None else jnp.asarray(key_bias),
                  chunk=chunk)
    ot = banded_causal_attention(*(torch.from_numpy(a) for a in (q, k, v)), WINDOW,
                                 None if key_bias is None else torch.from_numpy(key_bias), chunk=chunk)
    assert ot.shape == (2, 300, 4, 16)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_MODEL_TOL)


@pytest.mark.parametrize("length", [200, 300])
def test_windowed_logits_match_jax(length):
    over = dict(attn_window=WINDOW, max_seq_len=length)
    model, params = port_and_jax_params(seed=21, **over)
    b = batch(seed=21, length=length)
    logits_j = jax.jit(jax_model(**over).apply)(params, b["x"], b["x_hw"], b["y_in"])
    tb = to_torch(b)
    with torch.no_grad():
        logits_t = model(tb["x"], tb["x_hw"], tb["y_in"])
    valid = b["y_out"] != 0
    assert logits_t.shape == (2, length, V) and torch.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t.numpy()[valid], np.asarray(logits_j)[valid], **F32_MODEL_TOL)


def test_windowed_one_step_loss_and_grads_match_jax():
    over = dict(attn_window=WINDOW, max_seq_len=300, **NO_DROPOUT)
    model, params = port_and_jax_params(seed=22, **over)
    b = batch(seed=22, length=300)
    jm = jax_model(**over)

    def jloss(p):
        return j_ce(jm.apply(p, b["x"], b["x_hw"], b["y_in"]), b["y_out"])

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(params)
    tb = to_torch(b)
    loss_t = cross_entropy_ignore_pad(model(tb["x"], tb["x_hw"], tb["y_in"]), tb["y_out"])
    loss_t.backward()
    grads_t = convert_unimodal_state_dict({n: p.grad for n, p in model.named_parameters()})

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    flat_t = jax.tree_util.tree_leaves_with_path(grads_t)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(grads_j["params"]))
    assert len(flat_t) == len(flat_j)
    g_max = max(float(np.abs(g).max()) for g in flat_j.values())
    for path, gt in flat_t:
        name, gj = jax.tree_util.keystr(path), np.asarray(flat_j[path])
        if "['k_proj']['bias']" in name:
            np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * g_max, err_msg=name)
        else:
            assert_rel_l2(gt, gj, 1e-2, name)


def test_ring_cache_greedy_tokens_identical_to_jax():
    """Window 8 over 40 positions: 9 ring slots, written 40 times. The eos id
    is one the model cannot emit, so both decoders run all 40 steps."""
    over = dict(attn_window=8, max_seq_len=40)
    model, params = port_and_jax_params(seed=23, **over)
    assert model.decoder.cache_len == 9
    b = batch(seed=23)
    tok_j, score_j = jax.jit(j_greedy(jax_model(**over), 40, SOS, V))(params, jnp.asarray(b["x"]),
                                                                      jnp.asarray(b["x_hw"]))
    tb = to_torch(b)
    tok_t, score_t = greedy_decode_fn(model, 40, SOS, V)(tb["x"], tb["x_hw"])
    assert tok_t.shape == (2, 40) and bool((tok_t != 0).all())
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), **F32_MODEL_TOL)


@pytest.mark.parametrize("length", [40, 300])
def test_ring_cache_steps_match_full_forward(length):
    """The ring's decode steps reproduce the teacher-forced logits, with the
    masked matrix (L 40) and the band (L 300) in the full forward."""
    model, _ = port_and_jax_params(seed=24, attn_window=8 if length == 40 else WINDOW, max_seq_len=length)
    tb = to_torch(batch(seed=24, length=length))
    with torch.no_grad():
        full = model(tb["x"], None, tb["y_in"])
        cross, valid = model.decode_prefill(tb["x"])
        cache = model.decode_init_cache(2)
        assert cache["layer0"]["k"].shape[1] == model.decoder.cache_len < length
        steps = []
        for pos in range(length):
            logits, cache = model.decode_step(tb["y_in"][:, pos].long(), pos, cache, cross, valid)
            steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=1e-4, atol=1e-4)


def test_packed_stem_hparams_build_a_model_that_matches_jax():
    assert choose_pack_factor(IMG_W) > 1
    src, params = port_and_jax_params(seed=25)
    jm = jax_model(packed_stem=True)
    b = batch(seed=25)
    # the packed JAX model takes the standard param tree (same names and shapes)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), b["x"], b["x_hw"], b["y_in"])
    assert jax.tree.map(lambda a: a.shape, shapes) == jax.tree.map(lambda a: a.shape, params)
    logits_j = jax.jit(jm.apply)(params, b["x"], b["x_hw"], b["y_in"])

    model, _ = build_model(dict(vocab_size=V, max_seq_len=12, input_modality="image", packed_stem=True),
                           device="cpu", seed=99)
    load_jax_params(model, jax.device_get(params["params"]))
    tb = to_torch(b)
    with torch.no_grad():
        logits_t = model(tb["x"], tb["x_hw"], tb["y_in"])
        logits_src = src(tb["x"], tb["x_hw"], tb["y_in"])
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **F32_MODEL_TOL)
    np.testing.assert_array_equal(logits_t.numpy(), logits_src.numpy())
