"""Three Adam steps of the port's train step against the JAX
``make_train_step``, with warmup-cosine and global-norm clip on, dropout
off and teacher forcing off, on the float32 (non-flash) path where the
gradients agree to float32 rounding. Losses agree to 1e-4 relative. The
three updates of each parameter leaf agree to 5e-2 in relative L2 norm,
not elementwise: Adam divides by the gradient's own scale, so an element
whose gradient is near zero carries its rounding noise into a step of up
to the lr. The key-projection biases, whose exact gradient is zero, are
left out for that reason.
"""

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


def test_three_step_trajectory_matches_jax_make_train_step():
    lr, warmup, decay, clip = 3e-3, 2, 5, 0.5
    model, params = port_and_jax_params(seed=12, **NO_DROPOUT)
    batches = [batch(seed=20 + i) for i in range(3)]

    flat_0 = {k: np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(params["params"])}  # donated below
    jstep = j_make_train_step(jax_model(**NO_DROPOUT), V, teacher_forcing_prob=0.0, bf16_compute=False)
    jstate = JTrainState.create(params["params"], j_adam(lr, warmup, decay, clip))
    losses_j = []
    for i, b in enumerate(batches):
        jstate, loss = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        losses_j.append(float(loss))

    step = make_train_step(model, V, teacher_forcing_prob=0.0, bf16_compute=False, device="cpu")
    state = TrainState.create(model, lr, warmup, decay, clip)
    gen = torch.Generator().manual_seed(0)
    losses_t = []
    for b in batches:
        state, loss = step(state, to_torch(b), gen)
        losses_t.append(float(loss))
    assert state.step == 3

    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    after_t = convert_unimodal_state_dict({n: p.detach() for n, p in model.named_parameters()})
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jstate.params))
    for path, pt in jax.tree_util.tree_leaves_with_path(after_t):
        name, p0 = jax.tree_util.keystr(path), flat_0[path]
        pj = np.asarray(flat_j[path])
        if "['k_proj']['bias']" not in name:  # exact gradient zero: the update is Adam-scaled noise
            assert_rel_l2(pt - p0, pj - p0, 5e-2, name)
