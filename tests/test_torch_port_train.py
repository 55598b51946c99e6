"""The port's train step against the JAX package's, on the CPU, dropout off.

- One step with flash cross-attention: loss and every gradient against
  ``jax.value_and_grad`` of the JAX model's loss. Both round q/k/v and p
  to bf16 inside flash, at different points, so the loss agrees to 2e-2
  relative and each gradient leaf to 1e-1 in relative L2 norm (the worst
  leaves, the cross-attention query biases and the FF weights, measured
  5.3e-2 here; the same comparison on the float32 path without flash
  stays under 1e-2, see test_torch_port_trajectory.py). Not elementwise:
  a ReLU unit whose input lies within bf16 rounding of zero switches, and
  then its gradient differs wholly. The key-projection
  biases are left out of the norm test: their exact gradient is zero
  (softmax is shift-invariant), so both packages return rounding noise;
  they are held to 1e-4 of the largest gradient in the tree instead.
- The Adam trajectory is in test_torch_port_trajectory.py.
- The bf16 compute mode gives a finite loss within 5% of the float32 one.
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch
from torch_port_common import V, assert_rel_l2, batch, jax_model, port_and_jax_params, to_torch

from omr_a2s_multimodal_transformer_tpu.training.losses import cross_entropy_ignore_pad as j_ce
from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import (
    TrainState,
    make_train_step,
    warmup_cosine,
)

NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)


def test_one_step_loss_and_grads_match_jax_with_flash():
    model, params = port_and_jax_params(seed=11, use_flash_cross=True, **NO_DROPOUT)
    b = batch(seed=11)
    jm = jax_model(use_flash_cross=True, **NO_DROPOUT)

    def jloss(p):
        logits = jm.apply(p, b["x"], b["x_hw"], b["y_in"], False, rngs={"dropout": jax.random.PRNGKey(0)})
        return j_ce(logits, b["y_out"])

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(params)

    tb = to_torch(b)
    loss_t = cross_entropy_ignore_pad(model(tb["x"], tb["x_hw"], tb["y_in"], generator=torch.Generator()), tb["y_out"])
    loss_t.backward()
    grads_t = convert_unimodal_state_dict({n: p.grad for n, p in model.named_parameters()})

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=2e-2)
    flat_t = jax.tree_util.tree_leaves_with_path(grads_t)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(grads_j["params"]))
    assert len(flat_t) == len(flat_j)
    g_max = max(float(np.abs(g).max()) for g in flat_j.values())
    for path, gt in flat_t:
        name, gj = jax.tree_util.keystr(path), np.asarray(flat_j[path])
        if "['k_proj']['bias']" in name:
            np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-4 * g_max, err_msg=name)
        else:
            assert_rel_l2(gt, gj, 1e-1, name)


def test_bf16_compute_loss_is_finite_and_near_f32():
    model, _ = port_and_jax_params(seed=13, use_flash_cross=True, **NO_DROPOUT)
    tb = to_torch(batch(seed=13))
    losses = {}
    for bf16 in (False, True):
        m = copy.deepcopy(model)
        step = make_train_step(m, V, teacher_forcing_prob=0.0, bf16_compute=bf16, device="cpu")
        _, loss = step(TrainState.create(m, 1e-4), tb, torch.Generator().manual_seed(0))
        losses[bf16] = float(loss)
        assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in m.parameters())
    assert np.isfinite(losses[True])
    assert abs(losses[True] - losses[False]) < 0.05 * losses[False], losses


@pytest.mark.parametrize("warmup,decay", [(0, 10), (3, 10), (4, 4)])
def test_warmup_cosine_matches_optax(warmup, decay):
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-3, warmup_steps=max(warmup, 1),
        decay_steps=max(decay, warmup + 1), end_value=1e-4)
    for c in range(14):
        np.testing.assert_allclose(warmup_cosine(c, 1e-3, warmup, decay), float(sched(c)), rtol=1e-6, atol=1e-12)


def test_train_step_with_dropout_is_seeded_by_the_generator():
    """Dropout everywhere (stem, positions, decoder, flash weights) and token
    corruption draw from the generator: equal seeds give equal losses."""
    model, _ = port_and_jax_params(seed=14, use_flash_cross=True)
    tb = to_torch(batch(seed=14))
    losses = []
    for seed in (3, 3, 4):
        m = copy.deepcopy(model)
        step = make_train_step(m, V, teacher_forcing_prob=0.2, bf16_compute=False, device="cpu")
        _, loss = step(TrainState.create(m, 1e-4), tb, torch.Generator().manual_seed(seed))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] and losses[0] != losses[2]
