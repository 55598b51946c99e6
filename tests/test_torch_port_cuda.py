"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 and K2 (the decoder's cross-attention), K1c, K3a and K3b (causal,
windowed and split-backward calls of ``make_flash_attention_packed``),
K4 (``export_keep_masks``), K5a/K5b (the fused stem block, against
``plain_k1``, ``plain_k2`` and ``reference_block``: 2e-2 x max |plain| in
bf16, 1e-4 in float32 with TF32 off) and the per-head legacy flash L1,
L2a, L2b and L2c (``tools/legacy_flash``, against ``attention_plain`` and
its autograd: bf16 heads of 36 to 128 on the tensor-core kernels; float32
and float16 heads and heads of 192 and 256 on the any-dtype kernels, rows
off 16-byte alignment and float16 rows of odd width among them, float32 to
1e-4 x max |plain|; rows with no key must give o = 0 and lse = 0 in both;
both backward routes and the any-dtype forward bit-equal across two calls;
the any-dtype forward in float32 over 128 key tiles).
The K1/K2 cases include the edges of their Hopper design: lengths off the
TMA box and the key chunks, a row whose only key is in the last chunk,
grids smaller than the SM count, and dK/dV bit-equal across runs; the
K3a/K3b cases lengths off the 128-row blocks, four key chunks of K3a, a
whole invalid 128-key block of K3b, a batch row with no valid key (finite,
zero gradients) and dq, dk, dv bit-equal across runs.

These tests need an NVIDIA GPU and the CUDA toolkit (the kernels are
built with nvcc on first use) and skip elsewhere. They import nothing of
JAX, so they run on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerance: for o, dq, dk and dv, max |kernel - plain| <= 2e-2 * max |plain|,
each tensor on its own scale (the rule chip_smoke.py holds the kernels
to). Both routes take the same bf16 inputs and the same keep-mask; the
kernels round p and ds to bf16 before their products and sum in another
order, the plain version keeps ds in float32. A kernel that wrote zeros
would miss this by a factor of 50. Causal and windowed calls compare o, dq
and lse on the query rows that have a key to see; the cotangent is zero on
the others (ROADMAP Queue 3). K4 must equal the plain keep-mask bit for bit.
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
    # Lq and Lk off the 64-row TMA box, the 128-query block and the key chunks of K1's split
    dict(b=1, lq=130, lk=2100, rate=0.0),
    # batch row 1 sees one key, in the last of K1's key chunks (dropout 0: with one key, ds = p (dp -
    # delta) cancels to rounding, and delta from the bf16-rounded o = v / (1 - rate) would dominate dq)
    dict(b=2, lq=150, lk=700, rate=0.0, last_only=True),
    # grids smaller than the SM count: one key tile (no split), and one tile per chunk
    dict(b=2, lq=150, lk=60, rate=0.1),
    dict(b=1, lq=64, lk=256, rate=0.0),
    # dropout 0.3 at the decoder's 128/2048 mask geometry and at the factory's default 128/512
    dict(b=2, lq=150, lk=700, rate=0.3),
    dict(b=2, lq=150, lk=700, rate=0.3, block_k=512),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close(name, got, ref):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert scale > 0 and err <= REL_TOL * scale, f"{name}: max_abs_err {err:.3e} > {REL_TOL} x max |plain| {scale:.3e}"


def _inputs(b, lq, lk, dev, seed=0, last_only=False):
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
    if last_only:  # the last row's one valid key: below its kv_len, in the last 64-key tile
        kv_valid[-1] = False
        kv_valid[-1, lk - 20] = True
    return q, k, v, w, torch.from_numpy(kv_len).to(dev), torch.from_numpy(kv_valid).to(dev)


def _case_id(c):
    extra = ("_last" if c.get("last_only") else "") + (f"_bk{c['block_k']}" if "block_k" in c else "")
    return f"b{c['b']}_q{c['lq']}_k{c['lk']}_r{c['rate']}{extra}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_flash_kernels_match_plain_on_gpu(case):
    dev = _cuda()
    q, k, v, w, kv_len, kv_valid = _inputs(case["b"], case["lq"], case["lk"], dev, last_only=case.get("last_only"))
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    block_k = case.get("block_k", fp.MASK_BK)
    bq, bk = fp.mask_geometry(case["lq"], case["lk"], fp.MASK_BQ, block_k)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    n1, n2 = fp.flash_fwd_cuda.launches, fp.flash_bwd_cuda.launches
    flash = fp.make_flash_attention_packed(H, block_q=fp.MASK_BQ, block_k=block_k, dropout_rate=case["rate"])
    o = flash(*ins, kv_len, kv_valid, seed)
    o_ref, lse_ref = fp.flash_attention_plain(*ref_ins, kv_len, kv_valid, seed, case["rate"], H, block_q=bq,
                                              block_k=bk)
    (o.float() * w).sum().backward()
    (o_ref.float() * w).sum().backward()
    torch.cuda.synchronize()
    assert (fp.flash_fwd_cuda.launches - n1, fp.flash_bwd_cuda.launches - n2) == (1, 1)
    _assert_close("o", o, o_ref)
    for name, a, r in zip(("dq", "dk", "dv"), ins, ref_ins):
        _assert_close(name, a.grad, r.grad)
    _, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, case["rate"], H, bq, bk)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.detach().cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_merged_backward_dk_dv_are_deterministic_on_gpu():
    """K2 writes each dk and dv row once: two runs give the same bits (dq is
    summed by bulk reduce-adds in an order that may change)."""
    dev = _cuda()
    q, k, v, _, kv_len, kv_valid = _inputs(2, 150, 700, dev)
    do = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32)).to(dev, torch.bfloat16)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(150, 700)
    o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, 0.1, H, bq, bk)
    first = fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, 0.1, H, bq, bk)
    second = fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, 0.1, H, bq, bk)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


SPLIT_CASES = [
    # K1c + K3a + K3b: the paper's windowed self-attention in small, ragged targets
    dict(b=2, h=4, lq=300, lk=300, causal=True, window=100, rate=0.0, merged=True),
    dict(b=2, h=4, lq=300, lk=300, causal=True, window=100, rate=0.1, merged=True),
    # full causal with 2 heads (pd 128), as in tests/test_flash_packed.py
    dict(b=2, h=2, lq=192, lk=192, causal=True, window=-1, rate=0.1, merged=True),
    # K1 + K3a + K3b: a non-causal call with merged_bwd=False, two mask k-blocks of 512
    dict(b=2, h=4, lq=150, lk=700, causal=False, window=-1, rate=0.1, merged=False),
    # the same off the 64-row tiles and K3a's 192-query and K3b's 128-key blocks, over 16 key tiles (8 of
    # K3a's key chunks on 132 SMs),
    # with batch row 0's keys 256-383 (a whole K3b block) invalid, at both rates
    dict(b=2, h=4, lq=300, lk=1000, causal=False, window=-1, rate=0.0, merged=False, hole=True),
    dict(b=2, h=4, lq=300, lk=1000, causal=False, window=-1, rate=0.1, merged=False, hole=True),
]


def _split_inputs(case, dev):
    rng = np.random.default_rng(1)
    b, h, lq, lk = case["b"], case["h"], case["lq"], case["lk"]
    q, do = (torch.from_numpy(rng.normal(size=(b, lq, h * 64)).astype(np.float32)).to(dev, torch.bfloat16)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(b, lk, h * 64)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
    kv_valid = torch.ones((b, lk), dtype=torch.bool, device=dev)
    kv_valid[-1, lk // 2:] = False  # a short target, or a ragged memory
    if case.get("hole"):
        kv_valid[0, 256:384] = False
    kv_len = torch.full((b,), lk, dtype=torch.int32, device=dev)
    # rows without a key to see (pad queries past the window) get no cotangent
    qpos, kpos = torch.arange(lq, device=dev)[:, None], torch.arange(lk, device=dev)[None, :]
    band = torch.ones((lq, lk), dtype=torch.bool, device=dev)
    if case["causal"]:
        band = kpos <= qpos
        if case["window"] > 0:
            band &= kpos >= qpos - case["window"]
    rows = (kv_valid[:, None, :] & band[None]).any(-1)  # [B, Lq]
    return q, k, v, do * rows[:, :, None], kv_len, kv_valid, rows


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES, ids=lambda c: f"h{c['h']}_q{c['lq']}_c{int(c['causal'])}_w{c['window']}"
                                                            f"_r{c['rate']}" + ("_hole" if c.get("hole") else ""))
def test_causal_and_split_kernels_match_plain_on_gpu(case):
    dev = _cuda()
    q, k, v, do, kv_len, kv_valid, rows = _split_inputs(case, dev)
    seed = torch.tensor([91], dtype=torch.int32, device=dev)
    kw = dict(causal=case["causal"], window=case["window"], dropout_rate=case["rate"], merged_bwd=case["merged"])
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    counters = (fp.flash_fwd_cuda, fp.flash_fwd_causal_cuda, fp.flash_bwd_cuda, fp.flash_dq_cuda, fp.flash_dkv_cuda)
    before = [f.launches for f in counters]
    o = fp.make_flash_attention_packed(case["h"], **kw)(*ins, kv_len, kv_valid, seed)
    o.backward(do)
    bq, bk = fp.mask_geometry(case["lq"], case["lk"], 128, 512)
    o_ref, lse_ref = fp.flash_attention_plain(*ref_ins, kv_len, kv_valid, seed, case["rate"], case["h"],
                                              case["causal"], case["window"], bq, bk)
    o_ref.backward(do)
    torch.cuda.synchronize()
    fwd = (0, 1) if case["causal"] else (1, 0)
    assert [f.launches - n for f, n in zip(counters, before)] == [*fwd, 0, 1, 1]
    _assert_close("o", o[rows], o_ref[rows])
    _assert_close("dq", ins[0].grad[rows], ref_ins[0].grad[rows])
    _assert_close("dk", ins[1].grad, ref_ins[1].grad)
    _assert_close("dv", ins[2].grad, ref_ins[2].grad)
    launch = fp.flash_fwd_causal_cuda if case["causal"] else fp.flash_fwd_cuda
    extra = (case["window"],) if case["causal"] else ()
    _, lse = launch(q, k, v, kv_len, kv_valid, seed, case["rate"], case["h"], bq, bk, *extra)
    np.testing.assert_allclose(lse[rows.unsqueeze(1).expand_as(lse)].cpu().numpy(),
                               lse_ref.detach()[rows.unsqueeze(1).expand_as(lse)].cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["window100", "noncausal_4chunks"])
def test_split_backward_is_deterministic_on_gpu(causal):
    """dq, dk and dv bit-equal over two runs: the windowed call, and a
    non-causal one whose dq is summed from 4 key chunks by the merge."""
    dev = _cuda()
    q, k, v, do, kv_len, kv_valid, _ = _split_inputs(SPLIT_CASES[1 if causal else -1], dev)
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(q.shape[1], k.shape[1], 128, 512)
    if causal:
        o, lse = fp.flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, 0.1, 4, bq, bk, 100)
    else:
        o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, 0.1, 4, bq, bk)
    delta = fp.attention_delta(do, o, 4)
    args = (q, k, v, kv_len, kv_valid, seed, do, lse, delta, 0.1, 4, bq, bk, causal, 100 if causal else -1)
    dq_kw = {} if causal else dict(n_split=4)
    first = (fp.flash_dq_cuda(*args, **dq_kw), *fp.flash_dkv_cuda(*args))
    second = (fp.flash_dq_cuda(*args, **dq_kw), *fp.flash_dkv_cuda(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_split_backward_row_without_valid_key_is_finite():
    """A batch row with no valid key: K3a's dq and K3b's dk, dv are finite
    (p is 0 on every key, so all three are 0 there), at 1 and 4 key chunks."""
    dev = _cuda()
    q, k, v, do, kv_len, kv_valid, _ = _split_inputs(SPLIT_CASES[-1], dev)
    kv_valid[1] = False
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(q.shape[1], k.shape[1], 128, 512)
    o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, 0.1, 4, bq, bk)
    args = (q, k, v, kv_len, kv_valid, seed, do, lse, fp.attention_delta(do, o, 4), 0.1, 4, bq, bk)
    dk, dv = fp.flash_dkv_cuda(*args)
    for n_split in (1, 4):
        dq = fp.flash_dq_cuda(*args, n_split=n_split)
        torch.cuda.synchronize()
        assert torch.isfinite(dq.float()).all() and not dq[1].any()
    assert torch.isfinite(dk.float()).all() and torch.isfinite(dv.float()).all()
    assert not dk[1].any() and not dv[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", [(128, 512, 200, 700, 0.1, 7), (128, 2048, 130, 2100, 0.3, -7),
                                      (128, 128, 384, 384, 0.5, 12345)])
def test_keep_mask_kernel_bits_equal_plain(geometry):
    dev = _cuda()
    bq, bk, lq, lk, rate, seed = geometry
    n = fp.keep_mask_cuda.launches
    got = fp.export_keep_masks(seed, 2, 4, lq, lk, dropout_rate=rate, block_q=bq, block_k=bk)
    ref = fp.export_keep_masks(seed, 2, 4, lq, lk, dropout_rate=rate, block_q=bq, block_k=bk, device="cpu")
    torch.cuda.synchronize()
    assert fp.keep_mask_cuda.launches == n + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert torch.equal(got.cpu(), ref)


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


# ------------------------------------------------------- fused stem K5a/K5b

# (f_in, f_out, stride, ci, co, H, Wp): small ragged versions of the stem
# ladder's three packed stages: odd H, sh = 2, ci = 1, partial tiles in
# height and width
STEM_CASES = {
    "block0": (8, 8, (1, 1), 1, 16, 13, 9),
    "block1": (4, 2, (2, 2), 16, 32, 17, 11),
    "block2": (2, 1, (2, 2), 32, 64, 9, 19),
}
STEM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # x max |plain|


def _stem_inputs(geom, dtype, p, dev, seed=0):
    from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

    f_in, _, _, ci, co, h, wp = geom
    rng = np.random.default_rng(seed)
    shapes = [(2, h, wp, f_in * ci), (3, 3, ci, co), (co,), (3, 3, co, co), (co,), (3, 3, co, co), (co,)]
    scales = [1.0, 0.3, 0.1, 0.2, 0.1, 0.2, 0.1]
    args = [torch.from_numpy(rng.normal(size=s) * k).to(dev, dtype) for s, k in zip(shapes, scales)]
    drop = None
    if p is not None:
        drop = fs.make_drop_ctx(torch.Generator(device=dev).manual_seed(seed), p, (2, h, wp, f_in * co), co)
    return args, drop


def _stem_close(name, got, ref, dtype):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert scale > 0 and err <= STEM_TOL[dtype] * scale, \
        f"{name}: max_abs_err {err:.3e} > {STEM_TOL[dtype]} x max |plain| {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("p", [None, 0.5])
@pytest.mark.parametrize("name", list(STEM_CASES))
def test_fused_stem_kernels_match_plain_on_gpu(name, p, dtype):
    """K5a (y2, stats) and K5b (out) against plain_k1/plain_k2 on the same
    inputs, at every dropout site with elementwise and channel dropout, and
    the whole block against reference_block."""
    from omr_a2s_multimodal_transformer_tpu_torch.device import set_float32_precision
    from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

    dev = _cuda()
    set_float32_precision()
    f_in, f_out, stride, _, co, h, wp = STEM_CASES[name]
    (x, w1, b1, w2, b2, w3, b3), drop = _stem_inputs(STEM_CASES[name], dtype, p, dev)
    draws = [(None, None)] if drop is None else [(s, e) for s in (1, 2, 3) for e in (0, 1)]
    for pos, use_elem in draws:
        if drop is not None:
            drop["pos"] = torch.tensor(pos, dtype=torch.int32, device=dev)
            drop["use_elem"] = torch.tensor(use_elem, dtype=torch.int32, device=dev)
        n1, n2 = fs.fused_stem_k1_cuda.launches, fs.fused_stem_k2_cuda.launches
        y2, stats = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in)
        y2_p, stats_p = fs.plain_k1(x, w1, b1, w2, b2, f_in=f_in, drop=drop)
        mean_inv = fs.norm_from_stats(stats, h * wp * f_in, 1e-3)
        out = fs.fused_stem_k2_cuda(y2, mean_inv, w3, b3, drop, f_in=f_in, f_out=f_out, stride=stride)
        out_p = fs.plain_k2(y2, mean_inv, w3, b3, f_in=f_in, f_out=f_out, stride=stride, drop=drop)
        block = fs.fused_packed_block(x, w1, b1, w2, b2, w3, b3, f_in=f_in, f_out=f_out, stride=stride, drop=drop)
        block_p = fs.reference_block(x, w1, b1, w2, b2, w3, b3, f_in=f_in, f_out=f_out, stride=stride, drop=drop)
        torch.cuda.synchronize()
        assert (fs.fused_stem_k1_cuda.launches - n1, fs.fused_stem_k2_cuda.launches - n2) == (2, 2)
        assert y2.shape == y2_p.shape and out.shape == out_p.shape == block.shape == block_p.shape
        assert out.shape == (2, -(-h // stride[0]), wp, f_out * co) and out.dtype == dtype
        tag = f"pos {pos} use_elem {use_elem}"
        _stem_close(f"K5a y2 ({tag})", y2, y2_p, dtype)
        _stem_close(f"K5a stats ({tag})", stats, stats_p, dtype)
        _stem_close(f"K5b out ({tag})", out, out_p, dtype)
        _stem_close(f"block ({tag})", block, block_p, dtype)


@pytest.mark.cuda
def test_fused_stem_statistics_are_deterministic_on_gpu():
    from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

    dev = _cuda()
    f_in = STEM_CASES["block1"][0]
    (x, w1, b1, w2, b2, *_), drop = _stem_inputs(STEM_CASES["block1"], torch.bfloat16, 0.5, dev)
    first = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in)
    second = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_fused_stem_wrappers_reject_what_the_kernels_do_not_take():
    from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

    dev = _cuda()
    f_in, f_out, stride = STEM_CASES["block0"][:3]
    (x, w1, b1, w2, b2, w3, b3), drop = _stem_inputs(STEM_CASES["block0"], torch.float32, 0.5, dev)
    kw = dict(f_in=f_in, f_out=f_out, stride=stride)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fs.fused_packed_block(*(t.double() for t in (x, w1, b1, w2, b2, w3, b3)), **kw)
    with pytest.raises(ValueError, match="lies on"):
        fs.fused_stem_k1_cuda(x, w1.cpu(), b1, w2, b2, drop, f_in=f_in)
    with pytest.raises(ValueError, match="lies on"):
        fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, {**drop, "bits": drop["bits"].cpu()}, f_in=f_in)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fs.fused_stem_k1_cuda(x.cpu(), w1, b1, w2, b2, None, f_in=f_in)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_fused_stem_tile_height_on_gpu(dtype):
    """tile_h sets the kernels' tile height: H 17 in tiles of 4 (K5a) and 2
    (K5b) with ragged last tiles, against reference_block."""
    from omr_a2s_multimodal_transformer_tpu_torch.device import set_float32_precision
    from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

    dev = _cuda()
    set_float32_precision()
    f_in, f_out, stride = STEM_CASES["block1"][:3]
    args, drop = _stem_inputs(STEM_CASES["block1"], dtype, 0.5, dev, seed=3)
    kw = dict(f_in=f_in, f_out=f_out, stride=stride, drop=drop)
    out = fs.fused_packed_block(*args, tile_h=4, **kw)
    _stem_close("block, tile_h 4", out, fs.reference_block(*args, **kw), dtype)


# ------------------------------------------- per-head legacy flash L1, L2a-c

# bf16 on the tensor-core kernels: head widths 36 (padded to 40 by the
# wrapper), 40 and 64 (the 64 template) and 128; non-causal with Lq != Lk,
# full causal, and causal with window 30, where the short kv_len (L1) or
# target (L2's kv_valid) leaves rows with no key. On the any-dtype kernels:
# float32 and float16 at D 64, bf16 and float32 at D 192, causal and windowed;
# float32 at D 36 one element into its buffer (rows off 16-byte boundaries:
# the backward's wrapper copies them) and at D 256 (four 64-column chunks);
# float16 non-causal with Lq 90 != Lk 200, neither a multiple of 64, at D 64
# and at D 37 (rows aligned to 2 bytes only: the wrapper pads them to 40
# columns). At the any-dtype forward's width classes: float32 at D 72 (one
# 64-column chunk and 8 columns), float32 at D 320 (past the columns it
# keeps in registers, 128 in float32 and 192 in 16-bit types: o split over
# the grid, as for float32 at D 192), float16 at D 72 one element
# into its buffer; and a batch row whose kv_len is 0 (no key tile runs: o,
# lse and its gradients must be 0).
LEGACY_CASES = [dict(d=d, causal=c, window=w, dtype=torch.bfloat16)
                for d in (40, 64, 128) for c, w in ((False, -1), (True, -1), (True, 30))]
LEGACY_CASES.append(dict(d=36, causal=True, window=30, dtype=torch.bfloat16))
LEGACY_CASES += [dict(d=d, causal=True, window=w, dtype=dt)
                 for d, dt in ((64, torch.float32), (64, torch.float16), (192, torch.bfloat16), (192, torch.float32))
                 for w in (-1, 30)]
LEGACY_CASES += [dict(d=36, causal=True, window=30, dtype=torch.float32, offset=True),
                 dict(d=256, causal=True, window=30, dtype=torch.float32),
                 dict(d=64, causal=False, window=-1, dtype=torch.float16),
                 dict(d=37, causal=False, window=-1, dtype=torch.float16),
                 dict(d=72, causal=False, window=-1, dtype=torch.float32),
                 dict(d=320, causal=True, window=30, dtype=torch.float32),
                 dict(d=72, causal=False, window=-1, dtype=torch.float16, offset=True),
                 dict(d=64, causal=False, window=-1, dtype=torch.float32, zero_len=True)]
LEGACY_TOL = {torch.bfloat16: REL_TOL, torch.float16: REL_TOL, torch.float32: 1e-4}  # x max |plain|


def _legacy_inputs(case, dev, seed=2):
    rng = np.random.default_rng(seed)
    b, h, d = 2, 3, case["d"]
    lq, lk = (150, 150) if case["causal"] else (90, 200)
    dtype = case.get("dtype", torch.bfloat16)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(dev, dtype)
                   for n in (lq, lk, lk, lq))
    kv_len = torch.tensor([lk, 0 if case.get("zero_len") else 100 if case["causal"] else lk - 23],
                          dtype=torch.int32, device=dev)
    kv_valid = torch.ones((b, lk), dtype=torch.bool, device=dev)
    kv_valid[0, 40:70] = False  # a hole, as in the concat mixer's fused memories
    kv_valid[1, 90:] = False    # a short target
    return q, k, v, do, kv_len, kv_valid


def _legacy_id(c):
    dt = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}[c["dtype"]]
    return (f"d{c['d']}_c{int(c['causal'])}_w{c['window']}" + ("" if dt == "bf16" and c["d"] <= 128 else f"_{dt}")
            + ("_offset" if c.get("offset") else "") + ("_zero_len" if c.get("zero_len") else ""))


def _leaves(tensors, offset=False):
    """(leaves, kernel inputs): fresh copies that take gradients; with
    offset, the inputs are views one element into their leaf buffers, so
    their rows start off 16-byte boundaries."""
    if not offset:
        leaves = [t.clone().requires_grad_() for t in tensors]
        return leaves, leaves
    leaves = [torch.cat([t.new_zeros(1), t.flatten()]).requires_grad_() for t in tensors]
    return leaves, [b[1:].view(t.shape) for b, t in zip(leaves, tensors)]


def _grads(leaves, tensors):
    return [b.grad if b.shape == t.shape else b.grad[1:].view(t.shape) for b, t in zip(leaves, tensors)]


def _legacy_close(name, got, ref, dtype):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    tol = LEGACY_TOL[dtype]
    assert scale > 0 and err <= tol * scale, f"{name}: max_abs_err {err:.3e} > {tol} x max |plain| {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEGACY_CASES, ids=_legacy_id)
def test_legacy_flash_kernels_match_plain_on_gpu(case):
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention as l1
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as l2

    dev = _cuda()
    q, k, v, do, kv_len, kv_valid = _legacy_inputs(case, dev)
    dtype = case["dtype"]
    band = dict(causal=case["causal"], window=case["window"])
    wrappers = (l1.legacy_fwd_cuda, l2.legacy_fwd_lse_cuda, l2.legacy_dq_cuda, l2.legacy_dkv_cuda,
                l1.legacy_any_fwd_cuda, l2.legacy_any_dq_cuda, l2.legacy_any_dkv_cuda)
    before = [f.launches for f in wrappers]
    o1 = l1.flash_attention(q, k, v, kv_len, **band)
    leaves, ins = _leaves((q, k, v), case.get("offset", False))
    if case.get("offset"):
        assert all(t.data_ptr() % 16 for t in ins)
    o2 = l2.make_flash_attention(**band)(*ins, kv_len, kv_valid)
    o2.backward(do)
    torch.cuda.synchronize()
    tensor_cores = dtype == torch.bfloat16 and case["d"] <= 128
    want = [1, 1, 1, 1, 0, 0, 0] if tensor_cores else [0, 0, 0, 0, 2, 1, 1]
    assert [f.launches - n for f, n in zip(wrappers, before)] == want
    grads = _grads(leaves, (q, k, v))
    assert o1.dtype == o2.dtype == grads[0].dtype == dtype

    o1_ref, lse1_ref = l1.attention_plain(q, k, v, kv_len, None, **band)
    _legacy_close("L1 o", o1, o1_ref, dtype)
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o2_ref, lse_ref = l1.attention_plain(*ref_ins, kv_len, kv_valid, **band)
    o2_ref.backward(do)
    _legacy_close("L2a o", o2, o2_ref, dtype)
    for name, a, r in zip(("L2b dq", "L2c dk", "L2c dv"), grads, ref_ins):
        _legacy_close(name, a, r.grad, dtype)
    _, lse = l2.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, **band)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.detach().cpu().numpy(), rtol=1e-4, atol=1e-4)
    # rows with no key to see: o = 0 and lse = 0 exactly, in the kernels as in the plain version
    for o, lse_p, lse_k in ((o1, lse1_ref, None), (o2, lse_ref, lse)):
        empty = lse_p.detach() == 0
        if case["window"] > 0:
            assert empty.any()
        if case.get("zero_len"):
            assert empty[1].all()
        assert not o[empty].any() and (lse_k is None or not lse_k[empty].any())
    if case.get("zero_len"):
        assert not any(g[1].any() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(d=64, causal=True, window=30, dtype=torch.bfloat16),
                                  dict(d=64, causal=False, window=-1, dtype=torch.float32),
                                  dict(d=64, causal=False, window=-1, dtype=torch.float16),
                                  dict(d=192, causal=False, window=-1, dtype=torch.float32)], ids=_legacy_id)
def test_legacy_backward_is_deterministic_on_gpu(case):
    """Both backward routes write each row once: two calls give bit-equal
    dq, dk and dv (bf16 D 64 on the tensor-core kernels; float32, float16
    and D 192, three 64-column chunks of the output, on the any-dtype
    kernels)."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as l2

    dev = _cuda()
    q, k, v, do, kv_len, kv_valid = _legacy_inputs(case, dev)
    band = (case["causal"], case["window"])
    o, lse = l2.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, *band)
    args = (q, k, v, kv_len, kv_valid, do, lse, l2.attention_delta(do, o), *band)
    before = (l2.legacy_any_dq_cuda.launches, l2.legacy_any_dkv_cuda.launches)
    first = (l2.legacy_dq_cuda(*args), *l2.legacy_dkv_cuda(*args))
    second = (l2.legacy_dq_cuda(*args), *l2.legacy_dkv_cuda(*args))
    any_route = not (case["dtype"] == torch.bfloat16 and case["d"] <= 128)
    launched = (l2.legacy_any_dq_cuda.launches - before[0], l2.legacy_any_dkv_cuda.launches - before[1])
    assert launched == ((2, 2) if any_route else (0, 0))
    for a, b in zip(first, second):
        assert torch.equal(a, b) and a.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(d=64, causal=False, window=-1, dtype=torch.float32),
                                  dict(d=64, causal=True, window=30, dtype=torch.float16),
                                  dict(d=192, causal=False, window=-1, dtype=torch.bfloat16),
                                  dict(d=320, causal=True, window=30, dtype=torch.float32)], ids=_legacy_id)
def test_legacy_any_forward_is_deterministic_on_gpu(case):
    """The any-dtype forward writes each row once: two calls give bit-equal
    o and lse (D 64, bf16 D 192 in registers, float32 D 320 split over the
    grid)."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention as l1

    dev = _cuda()
    q, k, v, _, kv_len, kv_valid = _legacy_inputs(case, dev)
    band = (case["causal"], case["window"])
    before = l1.legacy_any_fwd_cuda.launches
    first, second = (l1.legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, *band, with_lse=True) for _ in range(2))
    assert l1.legacy_any_fwd_cuda.launches - before == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b) and a.abs().max() > 0


@pytest.mark.cuda
def test_legacy_any_forward_float32_over_128_key_tiles_on_gpu():
    """float32 o over 8,192 keys (128 key tiles) within 1e-4 x max |plain|:
    the tensor cores do not round their f32 sums to nearest, so a forward
    that summed p v straight into o over the tiles would drift; the kernel
    sums each tile from zero and folds it into o."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention as l1

    dev = _cuda()
    rng = np.random.default_rng(4)
    b, h, lq, lk, d = 2, 2, 128, 8192, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(dev) for n in (lq, lk, lk))
    kv_len = torch.full((b,), lk, dtype=torch.int32, device=dev)
    kv_valid = torch.ones((b, lk), dtype=torch.bool, device=dev)
    kv_valid[1, 3000:3500] = False
    o, lse = l1.legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, False, -1, with_lse=True)
    o_ref, lse_ref = l1.attention_plain(q, k, v, kv_len, kv_valid)
    _legacy_close("L2a o, 128 key tiles", o, o_ref, torch.float32)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(), rtol=1e-4, atol=1e-4)
    o1 = l1.legacy_any_fwd_cuda(q, k, v, kv_len, None, False, -1, with_lse=False)[0]
    _legacy_close("L1 o, 128 key tiles", o1, l1.attention_plain(q, k, v, kv_len)[0], torch.float32)


@pytest.mark.cuda
def test_legacy_wrappers_reject_what_the_kernels_do_not_take():
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention as l1
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as l2

    dev = _cuda()
    q, k, v, do, kv_len, kv_valid = _legacy_inputs(dict(d=64, causal=False, window=-1), dev)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        l1.legacy_fwd_cuda(q.double(), k.double(), v.double(), kv_len)
    with pytest.raises(ValueError, match="must be torch.float32"):
        l1.legacy_fwd_cuda(q.float(), k, v.float(), kv_len)
    with pytest.raises(ValueError, match="contiguous"):
        l2.legacy_fwd_lse_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, kv_len, kv_valid)
    with pytest.raises(ValueError, match="lies on"):
        l2.legacy_fwd_lse_cuda(q, k.cpu(), v, kv_len, kv_valid)
    with pytest.raises(ValueError, match="lies on"):
        l1.legacy_fwd_cuda(q, k, v, kv_len.cpu())
    o, lse = l2.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid)
    delta = l2.attention_delta(do, o)
    with pytest.raises(ValueError, match="float32"):
        l2.legacy_dq_cuda(q, k, v, kv_len, kv_valid, do, lse.double(), delta)
    with pytest.raises(ValueError, match="lies on"):
        l2.legacy_dkv_cuda(q, k, v, kv_len, kv_valid, do.cpu(), lse, delta)
