"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels are
built with nvcc on first use) and skip elsewhere. They import nothing of
JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerance: for o, dq, dk and dv, max |kernel - plain| <= 2e-2 * max |plain|,
each tensor on its own scale (the rule chip_smoke.py holds the kernels
to). Both routes take the same bf16 inputs and the same keep-mask; the
kernels round p and ds to bf16 before their products and sum in another
order, the plain version keeps ds in float32. A kernel that wrote zeros
would miss this by a factor of 50.
"""

import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp

H = 4
REL_TOL = 2e-2
CASES = [
    dict(b=2, lq=150, lk=700, rate=0.0),
    dict(b=2, lq=150, lk=700, rate=0.1),
    dict(b=1, lq=70, lk=4200, rate=0.1),  # three 2048-key mask blocks, ragged tiles
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close(name, got, ref):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert scale > 0 and err <= REL_TOL * scale, f"{name}: max_abs_err {err:.3e} > {REL_TOL} x max |plain| {scale:.3e}"


def _inputs(b, lq, lk, dev, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, H * 64)).astype(np.float32)).to(dev, torch.bfloat16)
               for n in (lq, lk, lk))
    w = torch.from_numpy(rng.normal(size=(b, lq, H * 64)).astype(np.float32)).to(dev)
    kv_valid = np.ones((b, lk), bool)
    kv_valid[0, lk - 37:] = False
    if b > 1:
        kv_valid[1, 5:40] = False
    kv_len = np.full((b,), lk, np.int32)
    kv_len[-1] = lk - 11
    return q, k, v, w, torch.from_numpy(kv_len).to(dev), torch.from_numpy(kv_valid).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"b{c['b']}_q{c['lq']}_k{c['lk']}_r{c['rate']}")
def test_flash_kernels_match_plain_on_gpu(case):
    dev = _cuda()
    q, k, v, w, kv_len, kv_valid = _inputs(case["b"], case["lq"], case["lk"], dev)
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    n1, n2 = fp.flash_fwd_cuda.launches, fp.flash_bwd_cuda.launches
    o = fp.flash_attention_packed(*ins, kv_len, kv_valid, seed, dropout_rate=case["rate"], n_heads=H)
    o_ref, lse_ref = fp.flash_attention_plain(*ref_ins, kv_len, kv_valid, seed, case["rate"], H)
    (o.float() * w).sum().backward()
    (o_ref.float() * w).sum().backward()
    torch.cuda.synchronize()
    assert (fp.flash_fwd_cuda.launches - n1, fp.flash_bwd_cuda.launches - n2) == (1, 1)
    _assert_close("o", o, o_ref)
    for name, a, r in zip(("dq", "dk", "dv"), ins, ref_ins):
        _assert_close(name, a.grad, r.grad)
    bq, bk = fp.mask_geometry(case["lq"], case["lk"])
    _, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, case["rate"], H, bq, bk)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.detach().cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_flash_kernel_row_without_valid_key_is_finite():
    dev = _cuda()
    q, k, v, _, kv_len, kv_valid = _inputs(2, 20, 90, dev)
    kv_valid[1] = False
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, 0.0, H, *fp.mask_geometry(20, 90))
    torch.cuda.synchronize()
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()


@pytest.mark.cuda
def test_flash_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    q, k, v, _, kv_len, kv_valid = _inputs(1, 8, 16, dev)
    seed = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fp.flash_fwd_cuda(q.float(), k, v, kv_len, kv_valid, seed, 0.0, H, 128, 128)
    with pytest.raises(ValueError):
        fp.flash_fwd_cuda(q[:, :, :128], k, v, kv_len, kv_valid, seed, 0.0, H, 128, 128)


@pytest.mark.cuda
def test_tiny_model_train_step_on_gpu_matches_cpu():
    """One float32 step of a tiny flash model, dropout off: the GPU (K1/K2)
    and the CPU (plain version) give the same loss to 1e-2 and the same
    gradient to 5e-2 in relative L2 norm over all parameters (both round
    q/k/v and p to bf16 at the flash boundary, at other points)."""
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad

    dev = _cuda()
    hp = dict(vocab_size=31, max_seq_len=12, input_modality="image", use_flash_cross=True,
              encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(size=(2, 32, 64, 1)).astype(np.float32))
    hw = torch.tensor([[32, 64], [25, 44]], dtype=torch.int32)
    y = torch.from_numpy(rng.integers(2, 31, size=(2, 13)))
    y[0, 9:] = 0
    results = []
    for device in ("cpu", dev):
        model, _ = build_model(hp, device=device, seed=4)
        n1 = fp.flash_bwd_cuda.launches
        loss = cross_entropy_ignore_pad(model(x.to(device), hw.to(device), y[:, :-1].to(device)), y[:, 1:].to(device))
        loss.backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in model.parameters()])
        results.append((loss.item(), grads, fp.flash_bwd_cuda.launches - n1))
    (loss_c, g_c, n_c), (loss_g, g_g, n_g) = results
    assert (n_c, n_g) == (0, 8)
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-2)
    assert float((g_g - g_c).norm() / g_c.norm()) < 5e-2
