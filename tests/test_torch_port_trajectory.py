"""Three Adam steps of the port's train step against the JAX
``make_train_step``, with warmup-cosine and global-norm clip on, dropout
off and teacher forcing off, on the non-flash path, both packages in
float64: at JAX's initialisers JAX's own float32 gradients lie 3-4e-3
(relative L2) from its float64 ones and the port's 5e-5, and Adam turns
that rounding into steps of the whole lr where a gradient is near zero,
so by the third step the port's float32 loss lies 1.9e-4 from the float64
one (test_torch_port_trainer.py's fits run in float64 for the same
reason). Losses agree to 1e-4 relative. A second test runs the port at
its own float32 against JAX's float64, at limits read from that run. The
three updates of each parameter leaf agree to 5e-2 in relative L2 norm,
not elementwise: Adam divides by the gradient's own scale, so an element
whose gradient is near zero carries its rounding noise into a step of up
to the lr. The key-projection biases, whose exact gradient is zero, are
left out for that reason.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_port_common import V, assert_rel_l2, batch, jax_model, port_and_jax_params, to_torch

from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu.training.train_state import TrainState as JTrainState
from omr_a2s_multimodal_transformer_tpu.training.train_state import adam as j_adam
from omr_a2s_multimodal_transformer_tpu.training.train_state import make_train_step as j_make_train_step
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
BATCHES = [batch(seed=20 + i) for i in range(3)]


LR, WARMUP, DECAY, CLIP = 3e-3, 2, 5, 0.5


@functools.lru_cache(maxsize=1)
def _jax_trajectory():
    """Three steps of JAX's make_train_step in float64: (its losses, the initial leaves, the final leaves)."""
    _, params = port_and_jax_params(seed=12, **NO_DROPOUT)
    flat_0 = {k: np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(params["params"])}  # donated below
    jstep = j_make_train_step(jax_model(**NO_DROPOUT), V, teacher_forcing_prob=0.0, bf16_compute=False)
    losses_j = []
    with jax.enable_x64(True):
        jstate = JTrainState.create(jax.tree.map(lambda w: jnp.asarray(w, np.float64), params["params"]),
                                    j_adam(LR, WARMUP, DECAY, CLIP))
        for i, b in enumerate(BATCHES):
            jb = {k: jnp.asarray(v, np.float64 if v.dtype == np.float32 else v.dtype) for k, v in b.items()}
            jstate, loss = jstep(jstate, jb, jax.random.PRNGKey(i))
            losses_j.append(float(loss))
    flat_j = {k: np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(jstate.params)}
    return losses_j, flat_0, flat_j


def _trajectory(port_dtype):
    """JAX's three steps in float64 and the port's in port_dtype, from the same weights and batches: (the port's
    losses, JAX's, {leaf: (the port's update, JAX's update)})."""
    losses_j, flat_0, flat_j = _jax_trajectory()
    model, _ = port_and_jax_params(seed=12, **NO_DROPOUT)
    model.to(port_dtype)
    step = make_train_step(model, V, teacher_forcing_prob=0.0, bf16_compute=False, device="cpu")
    state = TrainState.create(model, LR, WARMUP, DECAY, CLIP)
    gen = torch.Generator().manual_seed(0)
    losses_t = []
    for b in BATCHES:
        state, loss = step(state, {k: v.to(port_dtype) if v.is_floating_point() else v for k, v in to_torch(b).items()},
                           gen)
        losses_t.append(float(loss))
    assert state.step == 3

    after_t = convert_unimodal_state_dict({n: p.detach().double() for n, p in model.named_parameters()})
    updates = {}
    for path, pt in jax.tree_util.tree_leaves_with_path(after_t):
        name, p0 = jax.tree_util.keystr(path), flat_0[path]
        if "['k_proj']['bias']" not in name:  # exact gradient zero: the update is Adam-scaled noise
            updates[name] = (np.asarray(pt) - p0, flat_j[path] - p0)
    return losses_t, losses_j, updates


def test_three_step_trajectory_matches_jax_make_train_step():
    losses_t, losses_j, updates = _trajectory(torch.float64)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    for name, (ut, uj) in updates.items():
        assert_rel_l2(ut, uj, 5e-2, name)


def test_three_step_trajectory_float32_port_matches_jax_float64():
    """The port at its own training precision, float32, against JAX in
    float64. Read here: the third loss 1.85e-4 from JAX's (relative), the
    whole update 6.2e-2 (relative L2), the farthest leaf 0.26 (an encoder
    conv bias, its gradient near zero); the limits are about twice those."""
    losses_t, losses_j, updates = _trajectory(torch.float32)
    np.testing.assert_allclose(losses_t, losses_j, rtol=4e-4)
    assert_rel_l2(np.concatenate([ut.ravel() for ut, _ in updates.values()]),
                  np.concatenate([uj.ravel() for _, uj in updates.values()]), 0.13, "every update")
    for name, (ut, uj) in updates.items():
        assert_rel_l2(ut, uj, 0.55, name)
