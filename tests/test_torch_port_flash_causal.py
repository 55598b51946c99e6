"""The port's causal, windowed and split-backward flash attention and its
keep-mask probe against the JAX package's, on the CPU.

The JAX side runs ``make_flash_attention_packed(..., interpret=True)`` and
``export_keep_masks(..., interpret=True)``, as the JAX package's own
tests do; the port takes its plain version (the route of CPU tensors), so
these tests fix the function that K1c, K3a, K3b and K4 are held to on the
card. Inputs are float32 from a numpy seed; o and (dq, dk, dv) through
``jax.vjp`` with the same cotangent are compared on the query rows that
have a key to see (the cotangent is zero on the others, whose output each
implementation defines its own way: ROADMAP Queue 3).

Tolerance 1e-5 relative and absolute: the same float32 formulas, the JAX
kernel's online softmax against the dense softmax, in another summation
order. The keep-masks must be equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu.ops.flash_packed import export_keep_masks as j_export
from omr_a2s_multimodal_transformer_tpu.ops.flash_packed import make_flash_attention_packed as j_make
from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as tflash

TOL = dict(rtol=1e-5, atol=1e-5)

CASES = [
    # the three cases of tests/test_flash_packed.py
    dict(b=1, h=4, lq=256, lk=256, causal=True, window=100, ragged=False, merged=True, rate=0.0, bq=128, bk=512),
    dict(b=2, h=2, lq=192, lk=192, causal=True, window=-1, ragged=False, merged=True, rate=0.0, bq=128, bk=512),
    dict(b=2, h=4, lq=160, lk=384, causal=False, window=-1, ragged=True, merged=False, rate=0.0, bq=128, bk=512),
    # the causal/window dropout case of tests/test_flash_dropout.py
    dict(b=1, h=4, lq=384, lk=384, causal=True, window=100, ragged=False, merged=True, rate=0.5, bq=128, bk=128),
    # the paper's self-attention geometry in small: window, ragged target lengths, dropout 0.1
    dict(b=2, h=4, lq=300, lk=300, causal=True, window=30, ragged=True, merged=True, rate=0.1, bq=128, bk=512),
]


def _inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, h, lq, lk = case["b"], case["h"], case["lq"], case["lk"]
    q, w = (rng.normal(size=(b, lq, h * 64)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, lk, h * 64)).astype(np.float32) for _ in range(2))
    kv_len = np.full((b,), lk, np.int32)
    kv_valid = np.ones((b, lk), bool)
    if case["ragged"] and case["causal"]:
        kv_valid[-1, lk // 2:] = False  # a short target: pad keys from the middle on
    elif case["ragged"]:
        kv_len[-1] = kv_valid.shape[1] - 100
        kv_valid[-1, lk - 100:] = False
    return q, k, v, w, kv_len, kv_valid


def _rows_with_a_key(case, kv_len, kv_valid):
    """[B, Lq] bool: the query rows that see at least one key."""
    lq, lk = case["lq"], case["lk"]
    qpos, kpos = np.arange(lq)[:, None], np.arange(lk)[None, :]
    see = (kv_valid & (kpos < kv_len[:, None]))[:, None, :]
    if case["causal"]:
        band = kpos <= qpos
        if case["window"] > 0:
            band &= kpos >= qpos - case["window"]
        see = see & band[None]
    return np.broadcast_to(see, (len(kv_len), lq, lk)).any(-1)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"q{c['lq']}_k{c['lk']}_h{c['h']}_c{int(c['causal'])}"
                                                      f"_w{c['window']}_r{c['rate']}_m{int(c['merged'])}")
def test_flash_causal_and_split_match_jax_interpret(case):
    q, k, v, w, kv_len, kv_valid = _inputs(case)
    rows = _rows_with_a_key(case, kv_len, kv_valid)
    w = w * rows[:, :, None]  # no cotangent on rows without a key
    seed = 4321
    kw = dict(causal=case["causal"], window=case["window"], block_q=case["bq"], block_k=case["bk"],
              dropout_rate=case["rate"], merged_bwd=case["merged"])
    j_flash = j_make(n_heads=case["h"], interpret=True, **kw)
    oj, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, jnp.asarray(kv_len), jnp.asarray(kv_valid), jnp.int32(seed)),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gj = vjp(jnp.asarray(w))

    t_flash = tflash.make_flash_attention_packed(n_heads=case["h"], **kw)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ot = t_flash(qt, kt, vt, torch.from_numpy(kv_len), torch.from_numpy(kv_valid), seed)
    ot.backward(torch.from_numpy(w))

    assert rows.any(1).all()
    np.testing.assert_allclose(ot.detach().numpy()[rows], np.asarray(oj)[rows], **TOL)
    np.testing.assert_allclose(qt.grad.numpy()[rows], np.asarray(gj[0])[rows], **TOL, err_msg="dq")
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gj[1]), **TOL, err_msg="dk")
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gj[2]), **TOL, err_msg="dv")


def test_window_applies_to_causal_calls_only():
    """JAX limits keys to [q - window, q] only when causal; a non-causal call
    with a window attends to every key, as does the port's."""
    q, k, v, _, kv_len, kv_valid = _inputs(dict(b=1, h=4, lq=40, lk=40, causal=False, ragged=False))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(kv_len),
            torch.from_numpy(kv_valid), 0)
    full = tflash.make_flash_attention_packed(4)(*args)
    windowed = tflash.make_flash_attention_packed(4, window=5)(*args)
    np.testing.assert_array_equal(windowed.numpy(), full.numpy())
    assert tflash.band_window(False, 5) == -1 and tflash.band_window(True, 5) == 5


@pytest.mark.parametrize("geometry", [(128, 512, 200, 700, 0.1, 7), (128, 128, 384, 384, 0.5, 12345),
                                      (128, 2048, 130, 2100, 0.3, -7)])
def test_export_keep_masks_bits_equal_jax(geometry):
    bq, bk, lq, lk, rate, seed = geometry
    ref = np.asarray(j_export(seed, 2, 4, lq, lk, dropout_rate=rate, block_q=bq, block_k=bk, interpret=True))
    got = tflash.export_keep_masks(seed, 2, 4, lq, lk, dropout_rate=rate, block_q=bq, block_k=bk, device="cpu")
    assert got.dtype == torch.bool and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mask_geometry_rounds_as_jax_shapes():
    assert tflash.mask_geometry(1268, 12696) == (128, 2048)
    assert tflash.mask_geometry(1268, 1268, 128, 512) == (128, 512)
    assert tflash.mask_geometry(70, 200, 128, 512) == (128, 256)
    assert tflash.mask_geometry(300, 300, 256, 1024) == (256, 384)


def test_export_keep_masks_defaults_to_cuda_and_kernels_refuse_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tflash.export_keep_masks(0, 1, 4, 8, 8, dropout_rate=0.1)
    q = torch.zeros((1, 8, 256), dtype=torch.bfloat16)
    kv_len, kv_valid, seed = torch.full((1,), 8, dtype=torch.int32), torch.ones((1, 8), dtype=torch.bool), \
        torch.zeros(1, dtype=torch.int32)
    lse = delta = torch.zeros((1, 4, 8))
    counts = [f.launches for f in (tflash.flash_fwd_causal_cuda, tflash.flash_dq_cuda, tflash.flash_dkv_cuda,
                                   tflash.keep_mask_cuda)]
    with pytest.raises(ValueError):
        tflash.flash_fwd_causal_cuda(q, q, q, kv_len, kv_valid, seed, 0.0, 4, 128, 512, 100)
    with pytest.raises(ValueError):
        tflash.flash_dq_cuda(q, q, q, kv_len, kv_valid, seed, q, lse, delta, 0.0, 4, 128, 512, True, 100)
    with pytest.raises(ValueError):
        tflash.flash_dkv_cuda(q, q, q, kv_len, kv_valid, seed, q, lse, delta, 0.0, 4, 128, 512, True, 100)
    with pytest.raises(ValueError):
        tflash.keep_mask_cuda(seed, 1, 4, 128, 512, 0.1, 128, 512)
    assert counts == [f.launches for f in (tflash.flash_fwd_causal_cuda, tflash.flash_dq_cuda,
                                           tflash.flash_dkv_cuda, tflash.keep_mask_cuda)]
