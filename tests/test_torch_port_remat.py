"""Rematerialization and ``memory_partition`` in the port.

- ``remat=True`` recomputes the encoder's blocks (and the decoder's layers
  off the flash path) in the backward. With dropout on everywhere (stem,
  positions, decoder, attention weights, token corruption) and the same
  generator seed, the loss, every gradient and the generator's state after
  the step equal those without remat bit for bit on the CPU (the recompute
  replays the generator's state, and in bf16 compute the bf16 parameters
  the forward used): the image model on the float32 path (decoder remat
  on) and in bf16 with flash cross-attention (decoder remat off, as in
  JAX), and the attn_both multimodal model.
- ``memory_partition=('data', 'model', None)`` under tensor parallelism (a
  1 x 2 mesh of two gloo processes): the loss equals the unpartitioned
  loss and the encoder's gradients their values to 1e-6 relative (JAX's
  test_parallel.py holds the loss to 1e-5); without a mesh, or with a spec
  that is not [batch, seq, feature], it raises ValueError.
"""

import copy

import numpy as np
import pytest
import torch
import torch_port_dist as D
from torch_port_common import V, batch, mm_batch, port_and_jax_params, to_torch

from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.training.corruption import corrupt_tokens
from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad


def _grads(model, args, y_in, y_out, seed, bf16):
    g = torch.Generator().manual_seed(seed)
    y = corrupt_tokens(g, y_in, V, 0.2)
    if bf16:
        params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        args = tuple(a.to(torch.bfloat16) if a is not None and a.is_floating_point() else a for a in args)
        logits = torch.func.functional_call(model, params, (*args, y), {"generator": g})
    else:
        logits = model(*args, y, generator=g)
    loss = cross_entropy_ignore_pad(logits, y_out)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}, g.get_state()


@pytest.mark.parametrize("case", ["image_f32", "image_bf16_flash", "multimodal"])
def test_remat_gradients_equal_plain_gradients_with_dropout(case):
    over = dict(use_flash_cross=True) if case == "image_bf16_flash" else {}
    if case == "multimodal":
        hp = dict(vocab_size=V, max_seq_len=12, input_modality="both", mixer_type="attn_both", mixer_residual=True)
        b = to_torch(mm_batch(seed=4))
        args = (b["xi"], b["xi_hw"], b["xa"], b["xa_hw"])
    else:
        hp = dict(vocab_size=V, max_seq_len=12, input_modality="image", **over)
        b = to_torch(batch(seed=4))
        args = (b["x"], b["x_hw"])
    plain, _ = build_model(hp, device="cpu", seed=3)
    remat, _ = build_model(dict(hp, remat=True), device="cpu", seed=3)
    assert remat.decoder.remat == (not over) and all(e.remat for e in remat.modules() if hasattr(e, "dscblocks"))
    remat.load_state_dict(plain.state_dict())
    want = _grads(plain, args, b["y_in"], b["y_out"], 9, case == "image_bf16_flash")
    got = _grads(remat, args, b["y_in"], b["y_out"], 9, case == "image_bf16_flash")
    assert got[0] == want[0] and set(got[1]) == set(want[1])
    for n in want[1]:
        assert torch.equal(got[1][n], want[1][n]), n
    assert torch.equal(got[2], want[2])
    other = _grads(copy.deepcopy(plain), args, b["y_in"], b["y_out"], 10, case == "image_bf16_flash")
    assert other[0] != want[0]  # the dropout draws are live


def test_memory_partition_leaves_the_loss_unchanged_under_tp():
    b = batch(seed=6, b=2)
    res = D.run_ranks(D.partition_loss, 2, 7, b, ("data", "model", None))
    for r in res:
        np.testing.assert_allclose(r["partitioned"], r["plain"], rtol=1e-6)
        np.testing.assert_allclose(r["partitioned_grad"], r["plain_grad"], rtol=1e-6)
    model, _ = port_and_jax_params(seed=7, encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
    tb = to_torch(b)
    single = cross_entropy_ignore_pad(model(tb["x"], tb["x_hw"], tb["y_in"]), tb["y_out"])
    np.testing.assert_allclose(res[0]["plain"], float(single.detach()), rtol=1e-6)


def test_memory_partition_needs_a_mesh_and_a_spec():
    base = dict(vocab_size=V, max_seq_len=12, input_modality="image")
    with pytest.raises(ValueError, match="needs a mesh"):
        build_model(dict(base, memory_partition=("data", "model", None)), device="cpu")
    with pytest.raises(ValueError, match="spec"):
        build_model(dict(base, memory_partition=("model", "data", None)), device="cpu")
