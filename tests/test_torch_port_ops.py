"""The port's ops against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and fed to both packages. The JAX
flash kernel runs in Pallas interpret mode; the port takes its plain
PyTorch version (the wrapper's route for CPU tensors). Tolerances:
float32 ops agree to 1e-5 (same formulas, different summation order); the
flash comparisons at float32 allow 2e-4, the tolerance the JAX package's
own flash tests hold its kernel to against dense attention (online vs
dense softmax, different accumulation order); at bfloat16 inputs both
round p to bf16 before the PV product but at different scalings (online
vs normalized p), so 3e-2 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu.ops import attention as jattn
from omr_a2s_multimodal_transformer_tpu.ops import masks as jmasks
from omr_a2s_multimodal_transformer_tpu.ops.flash_packed import export_keep_masks, make_flash_attention_packed
from omr_a2s_multimodal_transformer_tpu.ops.image import preprocess_image_batch as j_preprocess
from omr_a2s_multimodal_transformer_tpu.ops.norm import instance_norm as j_instance_norm
from omr_a2s_multimodal_transformer_tpu_torch.ops import attention as tattn
from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as tflash
from omr_a2s_multimodal_transformer_tpu_torch.ops import masks as tmasks
from omr_a2s_multimodal_transformer_tpu_torch.ops.image import preprocess_image_batch as t_preprocess
from omr_a2s_multimodal_transformer_tpu_torch.ops.norm import instance_norm as t_instance_norm

F32_TOL = dict(rtol=1e-5, atol=1e-5)
H = 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("window", [-1, 3])
def test_windowed_causal_mask(window):
    np.testing.assert_array_equal(
        tmasks.windowed_causal_mask(9, window).numpy(), np.asarray(jmasks.windowed_causal_mask(9, window))
    )


@pytest.mark.parametrize("parity", [False, True])
def test_validity_and_padding_masks(parity):
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 11, size=(3,))
    hw = rng.integers(1, 5, size=(3, 2))
    np.testing.assert_array_equal(
        tmasks.length_valid_mask(_t(lengths), 10).numpy(), np.asarray(jmasks.length_valid_mask(jnp.asarray(lengths), 10))
    )
    rect_t = tmasks.rect_valid_mask(_t(hw), 4, 5)
    rect_j = jmasks.rect_valid_mask(jnp.asarray(hw), 4, 5)
    np.testing.assert_array_equal(rect_t.numpy(), np.asarray(rect_j))
    np.testing.assert_array_equal(
        tmasks.key_padding_additive(rect_t, torch_float_parity=parity).numpy(),
        np.asarray(jmasks.key_padding_additive(rect_j, torch_float_parity=parity)),
    )


def test_preprocess_image_batch_u8():
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(3, 17, 29), dtype=np.uint8)
    hw = np.array([[17, 29], [10, 20], [5, 29]], np.int32)
    xj, hwj = j_preprocess(jnp.asarray(raw), jnp.asarray(hw))
    xt, hwt = t_preprocess(_t(raw), _t(hw))
    assert xt.shape == (3, 17, 29, 1) and xt.dtype == torch.float32
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **F32_TOL)
    np.testing.assert_array_equal(hwt.numpy(), np.asarray(hwj))
    # the bicubic resize is ported (tests/test_torch_port_decode_fusion.py holds more shapes)
    xj, hwj = j_preprocess(jnp.asarray(raw), jnp.asarray(hw), target_height=8)
    xt, hwt = t_preprocess(_t(raw), _t(hw), target_height=8)
    assert xt.shape == (3, 8, 14, 1)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **F32_TOL)
    np.testing.assert_array_equal(hwt.numpy(), np.asarray(hwj))


@pytest.mark.parametrize("masked", [False, True])
def test_instance_norm(masked):
    rng = np.random.default_rng(2)
    x = rng.normal(2.0, 3.0, size=(2, 6, 7, 5)).astype(np.float32)
    valid = None
    if masked:
        valid = np.zeros((2, 6, 7), bool)
        valid[0, :4, :5] = True
        valid[1] = True
    yj = j_instance_norm(jnp.asarray(x), 1e-3, None if valid is None else jnp.asarray(valid))
    yt = t_instance_norm(_t(x), 1e-3, None if valid is None else _t(valid))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5, atol=2e-5)


def test_attend_with_mask():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, n, H, 16)).astype(np.float32) for n in (5, 7, 7))
    mask = np.where(rng.uniform(size=(2, 1, 5, 7)) < 0.3, jmasks.NEG_INF, 0.0).astype(np.float32)
    oj = jattn.attend(*(jnp.asarray(a) for a in (q, k, v, mask)))
    ot = tattn.attend(*(_t(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **F32_TOL)
    merged = tattn.merge_heads(tattn.split_heads(_t(q.reshape(2, 5, H * 16)), H))
    np.testing.assert_array_equal(merged.numpy(), q.reshape(2, 5, H * 16))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_attend_packed_single_query(cache_dtype):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 64)).astype(np.float32) for _ in range(2))
    bias = np.where(rng.uniform(size=(2, 9)) < 0.3, jmasks.NEG_INF, 0.0).astype(np.float32)
    jdt = jnp.dtype(cache_dtype)
    tdt = getattr(torch, cache_dtype)
    oj = jattn.attend_packed_single_query(jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt), H, jnp.asarray(bias))
    ot = tattn.attend_packed_single_query(_t(q), _t(k).to(tdt), _t(v).to(tdt), H, _t(bias))
    tol = F32_TOL if cache_dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **tol)


# ------------------------------------------------------------------ flash

FLASH_CASES = [
    dict(b=2, lq=100, lk=300, rate=0.0, dtype="float32"),
    dict(b=2, lq=100, lk=300, rate=0.1, dtype="float32"),
    dict(b=1, lq=20, lk=2200, rate=0.1, dtype="float32"),  # crosses a 2048-key mask block
    dict(b=2, lq=70, lk=200, rate=0.1, dtype="bfloat16"),
]


def _flash_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    b, lq, lk = case["b"], case["lq"], case["lk"]
    q = rng.normal(size=(b, lq, H * 64)).astype(np.float32)
    k = rng.normal(size=(b, lk, H * 64)).astype(np.float32)
    v = rng.normal(size=(b, lk, H * 64)).astype(np.float32)
    w = rng.normal(size=(b, lq, H * 64)).astype(np.float32)
    kv_valid = np.ones((b, lk), bool)
    kv_valid[0, lk - 37:] = False  # ragged: row 0 has an invalid tail, row 1 a hole
    if b > 1:
        kv_valid[1, 5:40] = False
    kv_len = np.full((b,), lk, np.int32)
    kv_len[-1] = lk - 11
    return q, k, v, w, kv_valid, kv_len


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"b{c['b']}_q{c['lq']}_k{c['lk']}_r{c['rate']}_{c['dtype']}")
def test_flash_plain_matches_jax_interpret(case):
    q, k, v, w, kv_valid, kv_len = _flash_inputs(case)
    rate, seed = case["rate"], 12345
    jdt = jnp.dtype(case["dtype"])
    tdt = getattr(torch, case["dtype"])
    flash = make_flash_attention_packed(n_heads=H, block_q=128, block_k=2048, dropout_rate=rate, interpret=True)

    def jloss(q, k, v):
        o = flash(q, k, v, jnp.asarray(kv_len), jnp.asarray(kv_valid), jnp.int32(seed))
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, oj), gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt))

    qt, kt, vt = (_t(a).to(tdt).requires_grad_() for a in (q, k, v))
    ot = tflash.flash_attention_packed(qt, kt, vt, _t(kv_len), _t(kv_valid), torch.tensor([seed], dtype=torch.int32),
                                       dropout_rate=rate, n_heads=H)
    (ot.float() * _t(w)).sum().backward()

    tol = dict(rtol=2e-4, atol=2e-4) if case["dtype"] == "float32" else dict(rtol=3e-2, atol=3e-2)
    assert ot.dtype == tdt
    np.testing.assert_allclose(ot.detach().float().numpy(), np.asarray(oj, np.float32), **tol)
    for name, gt, gjx in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), gj):
        np.testing.assert_allclose(gt.float().numpy(), np.asarray(gjx, np.float32), **tol, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 100, 300, 0.1, 12345), (1, 130, 2100, 0.3, -7)])
def test_keep_mask_bits_equal_export_keep_masks(shape):
    b, lq, lk, rate, seed = shape
    ref = np.asarray(export_keep_masks(seed, b, H, lq, lk, dropout_rate=rate, block_q=128, block_k=2048,
                                       interpret=True))[:, :, :lq, :lk]
    np.testing.assert_array_equal(tflash.keep_mask(seed, b, H, lq, lk, rate).numpy(), ref)


def test_flash_lse_and_no_valid_key_row():
    """lse is the log-sum-exp of the masked scores; a row with no valid key
    gives finite output (the mean of v), not NaN."""
    q, k, v, _, kv_valid, kv_len = _flash_inputs(dict(b=2, lq=8, lk=50))
    kv_valid[1] = False
    o, lse = tflash.flash_attention_plain(_t(q), _t(k), _t(v), _t(kv_len), _t(kv_valid), torch.tensor([0]), n_heads=H)
    s = np.einsum("bqhd,bkhd->bhqk", q.reshape(2, 8, H, 64), k.reshape(2, 50, H, 64)) / 8.0
    valid = kv_valid & (np.arange(50)[None] < kv_len[:, None])
    s0 = np.where(valid[0][None, None], s[0], -np.inf)
    ref0 = np.log(np.exp(s0 - s0.max(-1, keepdims=True)).sum(-1)) + s0.max(-1)
    np.testing.assert_allclose(lse[0].numpy(), ref0, rtol=1e-5, atol=1e-5)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o[1].numpy(), np.broadcast_to(v[1].mean(0), (8, H * 64)), rtol=1e-5, atol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, _, kv_valid, kv_len = _flash_inputs(dict(b=1, lq=8, lk=16))
    args = (_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), _t(kv_len), _t(kv_valid),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        tflash.flash_fwd_cuda(*args, 0.0, H, 128, 128)
    assert tflash.flash_fwd_cuda.launches == 0
    lse = torch.zeros((1, H, 8), dtype=torch.float32)
    with pytest.raises(ValueError):
        tflash.flash_bwd_cuda(*args, args[0], lse, args[0], 0.0, H, 128, 128)
    assert tflash.flash_bwd_cuda.launches == 0


def _merge_partials(o_parts, lse_parts, n_heads):
    """What K1's merge kernel computes: partial (o_i [S, B, Lq, H*Dh] f32,
    normalized over key chunk i, and lse_i [S, B, H, Lq]) to (o, lse) with
    lse = log sum_i exp(lse_i) and o = sum_i exp(lse_i - lse) o_i."""
    mx = lse_parts.max(0).values
    w = torch.exp(lse_parts - mx)                                       # [S, B, H, Lq]
    tot = w.sum(0)
    s, b, lq, pd = o_parts.shape
    wc = (w / tot).transpose(2, 3)[..., None].expand(s, b, lq, n_heads, pd // n_heads).reshape(s, b, lq, pd)
    return (o_parts * wc).sum(0), mx + torch.log(tot)


def _flash_plain_split(q, k, v, kv_len, kv_valid, seed, rate, n_heads, per_keys):
    """K1 as it runs with split keys, in plain PyTorch: the non-causal
    ``flash_attention_plain`` over chunks of ``per_keys`` keys (each with
    the keys outside it masked), merged by lse. Returns (o f32, lse)."""
    kpos = torch.arange(k.shape[1])
    parts = []
    for k0 in range(0, k.shape[1], per_keys):
        chunk = kv_valid.bool() & (kpos >= k0) & (kpos < k0 + per_keys)
        parts.append(tflash.flash_attention_plain(q.float(), k.float(), v.float(), kv_len, chunk, seed, rate,
                                                  n_heads))
    return _merge_partials(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]), n_heads)


@pytest.mark.parametrize("case", [dict(rate=0.0, per_keys=64), dict(rate=0.1, per_keys=64), dict(rate=0.1, per_keys=192)],
                         ids=lambda c: f"r{c['rate']}_chunk{c['per_keys']}")
def test_flash_plain_over_key_chunks_merged_by_lse_equals_unsplit(case):
    """The plain version of K1 as it runs on the card with split keys: each
    chunk's normalized o and lse (every key outside it masked), merged by
    lse, equal the unsplit plain version to 1e-6 (float32), including a
    row whose only valid key is in the last chunk and chunks a row sees
    nothing of."""
    q, k, v, _, kv_valid, kv_len = _flash_inputs(dict(b=2, lq=37, lk=300))
    kv_len[:] = 300
    kv_valid[1] = False
    kv_valid[1, 290] = True  # row 1's only valid key, in the last chunk
    args = (_t(q), _t(k), _t(v), _t(kv_len), _t(kv_valid), torch.tensor([5]))
    o, lse = tflash.flash_attention_plain(*args, case["rate"], H)
    o_s, lse_s = _flash_plain_split(*args, case["rate"], H, case["per_keys"])
    np.testing.assert_allclose(o_s.numpy(), o.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse_s.numpy(), lse.numpy(), rtol=1e-6, atol=1e-6)


def test_fwd_splits_fill_the_card():
    """K1's key split: 4 chunks of 50 tiles at the flagship cross shape on
    132 SMs (896 blocks of 192 queries in 6.79 waves), none where there is
    one key tile, and always chunks that cover the tiles exactly."""
    assert tflash.fwd_splits(8, 4, 1268, 12696, 132) == (4, 50)
    assert tflash.fwd_splits(2, 4, 150, 60, 132) == (1, 1)
    for shape in [(1, 4, 70, 4200), (2, 4, 150, 700), (2, 4, 1280, 12696), (64, 8, 2048, 512)]:
        n_split, per = tflash.fwd_splits(*shape, 132)
        n_tiles = -(-shape[3] // 64)
        assert 1 <= n_split <= tflash.MAX_FWD_SPLITS and (n_split - 1) * per < n_tiles <= n_split * per


def test_given_split_covers_the_tiles_or_raises():
    """A chunk count given to K1 (chip_smoke.py times 1-8 at the cross
    shape's 199 key tiles) gives chunks that cover the tiles exactly; one
    that would leave a chunk empty raises."""
    for n_split in range(1, 9):
        n, per = tflash._split_of(199, n_split)
        assert n == n_split and (n_split - 1) * per < 199 <= n_split * per
    assert tflash._split_of(10, 4) == (4, 3)  # chunks of 3, 3, 3, 1
    for n_tiles, n_split in [(9, 4), (3, 4), (5, 0)]:  # 9 tiles in chunks of 3 are 3 chunks, not 4
        with pytest.raises(ValueError):
            tflash._split_of(n_tiles, n_split)


def test_dq_splits_fill_the_card():
    """K3a's key split: 4 chunks of 50 tiles at the flagship cross shape on
    132 SMs (896 blocks of 192 queries in 6.79 waves), none where there is
    one key tile, and always chunks that cover the tiles exactly."""
    assert tflash.dq_splits(8, 4, 1268, 12696, 132) == (4, 50)
    assert tflash.dq_splits(2, 4, 150, 60, 132) == (1, 1)
    assert tflash.dq_splits(2, 4, 300, 1000, 132) == (8, 2)  # the card tests' many-chunk case
    for shape in [(1, 4, 70, 4200), (2, 4, 150, 700), (2, 4, 1280, 12696), (64, 8, 2048, 512)]:
        n_split, per = tflash.dq_splits(*shape, 132)
        n_tiles = -(-shape[3] // 64)
        assert 1 <= n_split <= tflash.MAX_FWD_SPLITS and (n_split - 1) * per < n_tiles <= n_split * per


def test_bwd_stats_pairs_lse_and_delta_padded_to_the_tile():
    """What K2, K3a and K3b read per query: (lse * log2 e, delta) as f32
    pairs, Lq padded to the 64-query tile with zeros."""
    rng = np.random.default_rng(3)
    lse, delta = (torch.from_numpy(rng.normal(size=(2, 4, 70)).astype(np.float32)) for _ in range(2))
    stats = tflash.bwd_stats(lse, delta)
    assert stats.shape == (2, 4, 128, 2) and stats.dtype == torch.float32 and stats.is_contiguous()
    np.testing.assert_allclose(stats[:, :, :70, 0].numpy(), lse.numpy() * np.float32(np.log2(np.e)), rtol=1e-6)
    np.testing.assert_array_equal(stats[:, :, :70, 1].numpy(), delta.numpy())
    assert not stats[:, :, 70:].any()
