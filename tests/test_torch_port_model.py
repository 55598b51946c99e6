"""The port's model against the JAX package's, on the CPU, in deterministic mode.

Tolerances: the encoder, and the decoder without flash, run float32 in
both packages with other summation orders: 5e-4 absolute / 1e-3 relative,
the tolerance the JAX package's own torch parity test holds. With
``use_flash_cross`` both packages round q/k/v to bf16 at the kernel
boundary and p to bf16 before the PV product, at different points of the
online softmax, so logits agree to 2e-2. Greedy decode with a float32
cache must give identical tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import EOS, MAXLEN, SOS, batch, hparams, jax_model, port_and_jax_params, to_torch

from omr_a2s_multimodal_transformer_tpu.training.decode import greedy_decode_fn as j_greedy
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos, greedy_decode_fn
from omr_a2s_multimodal_transformer_tpu_torch.training.jax_import import load_jax_params

F32_MODEL_TOL = dict(rtol=1e-3, atol=5e-4)


def _jax_init_params():
    """A param tree with the structure and shapes of the JAX model's init
    (traced with eval_shape, filled from a seed: no compile needed)."""
    b = batch()
    shapes = jax.eval_shape(jax_model().init, jax.random.PRNGKey(0), b["x"], b["x_hw"], b["y_in"])["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


def test_load_jax_params_consumes_every_leaf_and_rejects_a_bad_tree():
    params = _jax_init_params()
    model, _ = build_model(hparams(), device="cpu", seed=5)
    load_jax_params(model, params)
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["encoder.conv_blocks.1.conv2.weight"].numpy(),
                                  params["encoder"]["block1"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["decoder.transformer_decoder.layers.3.multihead_attn.in_proj_weight"][256:512].numpy(),
                                  params["decoder"]["layer3"]["cross_attn"]["k_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["decoder.transformer_decoder.layers.0.norm2.weight"].numpy(),
                                  params["decoder"]["layer0"]["norm2"]["scale"])

    missing = jax.tree.map(lambda a: a, params)
    del missing["decoder"]["layer7"]["linear2"]["bias"]
    with pytest.raises(KeyError, match="lacks"):
        load_jax_params(model, missing)
    extra = jax.tree.map(lambda a: a, params)
    extra["decoder"]["layer2"]["spare"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="does not take"):
        load_jax_params(model, extra)


def test_jax_import_round_trips_the_port_weights():
    model, params = port_and_jax_params(seed=1)
    fresh, _ = build_model(hparams(), device="cpu", seed=2)
    load_jax_params(fresh, jax.device_get(params["params"]))
    for (n, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)


@pytest.mark.parametrize("masked_norm", [False, True])
def test_encode_matches_jax(masked_norm):
    model, params = port_and_jax_params(seed=3, masked_norm=masked_norm)
    b = batch(seed=3)
    jm = jax_model(masked_norm=masked_norm)
    mem_j, valid_j = jax.jit(lambda p, x, hw: jm.apply(p, x, hw, method="encode"))(params, b["x"], b["x_hw"])
    tb = to_torch(b)
    with torch.no_grad():
        mem_t, valid_t = model.encode(tb["x"], tb["x_hw"])
    assert mem_t.shape == (2, 2 * 8, 256)
    np.testing.assert_allclose(mem_t.numpy(), np.asarray(mem_j), **F32_MODEL_TOL)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))


@pytest.mark.parametrize("prefix", [False, True])
def test_memory_valid_from_hw(prefix):
    from omr_a2s_multimodal_transformer_tpu.models.transformer import memory_valid_from_hw as j_valid
    from omr_a2s_multimodal_transformer_tpu_torch.models.transformer import memory_valid_from_hw as t_valid

    hw = np.array([[32, 64], [17, 9], [1, 1]], np.int32)
    np.testing.assert_array_equal(t_valid(torch.from_numpy(hw), 3, 9, prefix).numpy(),
                                  np.asarray(j_valid(jnp.asarray(hw), 3, 9, prefix)))


def test_flash_logits_match_jax():
    model, params = port_and_jax_params(seed=4, use_flash_cross=True)
    b = batch(seed=4)
    jm = jax_model(use_flash_cross=True)
    logits_j = jax.jit(jm.apply)(params, b["x"], b["x_hw"], b["y_in"])
    tb = to_torch(b)
    with torch.no_grad():
        logits_t = model(tb["x"], tb["x_hw"], tb["y_in"])
    assert logits_t.shape == (2, MAXLEN, 31) and torch.isfinite(logits_t).all()
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=2e-2, atol=2e-2)


def test_torch_float_parity_logits_match_jax():
    model, params = port_and_jax_params(seed=5, torch_float_parity=True)
    b = batch(seed=5)
    logits_j = jax.jit(jax_model(torch_float_parity=True).apply)(params, b["x"], b["x_hw"], b["y_in"])
    tb = to_torch(b)
    with torch.no_grad():
        logits_t = model(tb["x"], tb["x_hw"], tb["y_in"])
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **F32_MODEL_TOL)


def test_flash_rejects_float_parity_masking():
    model, _ = build_model(hparams(use_flash_cross=True, torch_float_parity=True), device="cpu")
    tb = to_torch(batch())
    with pytest.raises(ValueError, match="-inf"):
        model(tb["x"], tb["x_hw"], tb["y_in"])


def test_greedy_decode_token_identical_to_jax():
    model, params = port_and_jax_params(seed=6)
    b = batch(seed=6)
    tok_j, score_j = jax.jit(j_greedy(jax_model(), MAXLEN, SOS, EOS))(params, jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]))
    tb = to_torch(b)
    tok_t, score_t = greedy_decode_fn(model, MAXLEN, SOS, EOS)(tb["x"], tb["x_hw"])
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), **F32_MODEL_TOL)
    assert cut_at_eos(tok_t, score_t, EOS)[0] == [list(r) for r in _cut(np.asarray(tok_j))]


def _cut(tokens):
    from omr_a2s_multimodal_transformer_tpu.training.decode import cut_at_eos as j_cut

    return j_cut(tokens, np.zeros(tokens.shape, np.float32), EOS)[0]


def test_decode_steps_match_full_forward():
    """KV-cached steps reproduce the teacher-forced logits (float32 cache)."""
    model, _ = port_and_jax_params(seed=7)
    tb = to_torch(batch(seed=7))
    with torch.no_grad():
        full = model(tb["x"], None, tb["y_in"])
        cross, valid = model.decode_prefill(tb["x"])
        cache = model.decode_init_cache(2)
        steps = []
        for pos in range(MAXLEN):
            logits, cache = model.decode_step(tb["y_in"][:, pos].long(), pos, cache, cross, valid)
            steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
