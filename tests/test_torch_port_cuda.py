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
both backward routes, L1 and L2a at 1-8 key chunks and the any-dtype
forward bit-equal across two calls;
the any-dtype forward in float32 over 128 key tiles).
The K1/K2 cases include the edges of their Hopper design: lengths off the
TMA box and the key chunks, a row whose only key is in the last chunk,
grids smaller than the SM count, and dK/dV bit-equal across runs; the
K3a/K3b cases lengths off the 128-row blocks, four key chunks of K3a, a
whole invalid 128-key block of K3b, a batch row with no valid key (finite,
zero gradients) and dq, dk, dv bit-equal across runs; K1 and K2 on the
tensors of the last visible card while card 0 is current. The train CLI on
a tiny corpus with flash cross-attention launches K1 and K2 8 times per
train step and no other kernel, for the image, the audio and the
multimodal model. The inference layer on a tiny model: beam search, an
image and a fused TranscriptionServer give the CPU's tokens, and the
bicubic resize lies within 1e-5 of the CPU's, with no kernel launched.

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

import json
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

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
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_kernels_launch_on_the_card_of_their_tensors(rate):
    """K1 and K2 on the tensors of the highest-numbered visible card, called
    while card 0 is the runtime's current device (a CLI run with --device
    cuda:1, a server on a second card): each wrapper launches on its
    tensors' card and the launcher opts its kernel in to its shared memory
    there, so both match the plain version on that card. On a machine with
    one card it is the same card."""
    _cuda()
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    q, k, v, w, kv_len, kv_valid = _inputs(2, 150, 700, dev)
    do = w.to(torch.bfloat16)
    seed = torch.tensor([77], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(150, 700)
    with torch.cuda.device(0):
        o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, H, bq, bk)
        grads = fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, rate, H, bq, bk)
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
    ref_ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o_ref, lse_ref = fp.flash_attention_plain(*ref_ins, kv_len, kv_valid, seed, rate, H, block_q=bq, block_k=bk)
    ref_grads = torch.autograd.grad(o_ref, ref_ins, do)
    assert o.device == dev and all(g.device == dev for g in grads)
    _assert_close("o", o, o_ref)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.detach().cpu().numpy(), rtol=1e-4, atol=1e-4)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _assert_close(name, a, r)


def _audio_shape_inputs(dev, seed=14):
    """The audio cli run's first K2 call, in shape: B 8, Lq 670, Lk 1,261,
    a 13 x 97 memory grid whose valid keys are each grid row's first
    ceil(frames / 8) columns (memory_valid_from_hw of 0.3-18 s waves), so
    short ragged key bands."""
    b, lq, rows, cols = 8, 670, 13, 97
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, n, H * 64)).astype(np.float32)).to(dev, torch.bfloat16)
                   for n in (lq, rows * cols, rows * cols, lq))
    widths = rng.integers(8, cols + 1, size=b)
    widths[0] = cols
    kv_valid = torch.from_numpy(np.arange(cols)[None, None, :] < widths[:, None, None]).expand(b, rows, cols)
    kv_len = torch.full((b,), rows * cols, dtype=torch.int32, device=dev)
    return q, k, v, do, kv_len, kv_valid.reshape(b, rows * cols).contiguous().to(dev)


def _dq_float64(q, k, v, do, kv_len, kv_valid, seed, rate, bq, bk):
    """dq of the flash function in float64 from the same bf16 inputs and
    keep-mask: p and ds unrounded."""
    b, lq, _ = q.shape
    lk = k.shape[1]
    qd = q.double().requires_grad_()
    qh, kh, vh = (fp._heads(t, H) for t in (qd, k.double(), v.double()))
    s = torch.matmul(qh, kh.transpose(-1, -2)) / 8.0
    see = (kv_valid & (torch.arange(lk, device=q.device)[None, :] < kv_len[:, None]))[:, None, None, :]
    p = torch.softmax(torch.where(see, s, -1e300), dim=-1)
    if rate > 0.0:
        keep = fp.keep_mask(int(seed), b, H, lq, lk, rate, q.device, bq, bk)
        p = torch.where(keep, p / fp._keep_den(rate), 0.0)
    o = torch.matmul(p, vh).transpose(1, 2).reshape(b, lq, H * 64)
    (dq,) = torch.autograd.grad(o, qd, do.double())
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_merged_backward_dq_at_the_audio_shape_against_float64(rate):
    """At the audio run's shape (B 8, Lq 670, Lk 1,261 in 13 x 97 key
    bands, ragged), on seeded normal inputs: against dq in float64, K2's
    error must be of the size of K3a's (whose f32 partials are summed in a
    fixed order), within 1.5x and 2e-3 of max |dq|, where a fault in K2's
    reduce-add of its dq partials would show as a larger error. The cli
    run's own inputs, where K2's dq lay 1.13e-2 of max |plain| from the
    float32 plain version, are read the same way by chip_smoke.py's
    check_cli_flash. The numbers are printed for the record."""
    dev = _cuda()
    q, k, v, do, kv_len, kv_valid = _audio_shape_inputs(dev)
    seed = torch.tensor([23], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(q.shape[1], k.shape[1])
    o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, H, bq, bk)
    dq_k2 = fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, rate, H, bq, bk)[0]
    dq_k3a = fp.flash_dq_cuda(q, k, v, kv_len, kv_valid, seed, do, lse, fp.attention_delta(do, o, H), rate, H, bq,
                              bk)
    qr = q.clone().requires_grad_()
    o_p, _ = fp.flash_attention_plain(qr, k, v, kv_len, kv_valid, seed, rate, H, block_q=bq, block_k=bk)
    (dq_plain,) = torch.autograd.grad(o_p, qr, do)
    dq64 = _dq_float64(q, k, v, do, kv_len, kv_valid, seed, rate, bq, bk)
    scale = float(dq64.abs().max())
    err = {name: float((t.double() - dq64).abs().max()) / scale
           for name, t in (("K2", dq_k2), ("K3a", dq_k3a), ("plain f32", dq_plain))}
    err["K2 vs plain f32"] = float((dq_k2.float() - dq_plain.float()).abs().max()) / float(dq_plain.float().abs().max())
    print(f"dq at B 8, Lq 670, Lk 1261, dropout {rate}: error over max |dq64| {err}")
    assert err["K2"] <= 1.5 * err["K3a"] + 2e-3, err
    assert max(err.values()) <= REL_TOL, err


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
    # K1c's band about its 64-key tiles and 192-query blocks (L 450: off both), ragged targets, both rates
    dict(b=2, h=4, lq=450, lk=450, causal=True, window=1, rate=0.1, merged=True),
    dict(b=2, h=4, lq=450, lk=450, causal=True, window=63, rate=0.0, merged=True),
    dict(b=2, h=4, lq=450, lk=450, causal=True, window=64, rate=0.1, merged=True),
    dict(b=2, h=4, lq=450, lk=450, causal=True, window=65, rate=0.0, merged=True),
    dict(b=2, h=4, lq=450, lk=450, causal=True, window=191, rate=0.1, merged=True),
    dict(b=2, h=4, lq=450, lk=450, causal=True, window=192, rate=0.0, merged=True),
    dict(b=2, h=4, lq=450, lk=450, causal=True, window=-1, rate=0.0, merged=True),
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
@pytest.mark.parametrize("window", [100, -1])
def test_causal_forward_is_deterministic_on_gpu(window):
    """K1c writes each o and lse row once: two runs give the same bits."""
    dev = _cuda()
    q, k, v, _, kv_len, kv_valid, _ = _split_inputs(SPLIT_CASES[1], dev)
    seed = torch.tensor([5], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(q.shape[1], k.shape[1], 128, 512)
    first = fp.flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, 0.1, 4, bq, bk, window)
    second = fp.flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, 0.1, 4, bq, bk, window)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


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
@pytest.mark.parametrize("geometry", [(2, 4, 128, 512, 200, 700, 0.1, 7), (2, 4, 128, 2048, 130, 2100, 0.3, -7),
                                      (2, 4, 128, 128, 384, 384, 0.5, 12345),
                                      # more query rows than a grid dimension holds, at B = H = 1 and B x H = 2
                                      (1, 1, 128, 2048, 70000, 300, 0.1, 5),
                                      (1, 2, 128, 128, 66000, 200, 0.0, 9),
                                      # the default grid (4 blocks of 8 warps an SM) with fewer (512-key strip,
                                      # row) units than warps, and with many more, over a ragged last strip
                                      (1, 1, 128, 512, 128, 512, 0.2, 11), (2, 3, 128, 2048, 1280, 1100, 0.2, 11)],
                         ids=lambda g: f"b{g[0]}_h{g[1]}_q{g[4]}_k{g[5]}_r{g[6]}")
def test_keep_mask_kernel_bits_equal_plain(geometry):
    """K4 (export_keep_masks at its default grid) against the plain
    keep-mask (the same function on the card), bit for bit."""
    dev = _cuda()
    b, h, block_q, block_k, lq, lk, rate, seed = geometry
    bq, bk = fp.mask_geometry(lq, lk, block_q, block_k)
    lq_p, lk_p = -(-lq // bq) * bq, -(-lk // bk) * bk
    n = fp.keep_mask_cuda.launches
    got = fp.export_keep_masks(seed, b, h, lq, lk, dropout_rate=rate, block_q=block_q, block_k=block_k)
    ref = fp.keep_mask(seed, b, h, lq_p, lk_p, rate, dev, bq, bk)
    torch.cuda.synchronize()
    assert fp.keep_mask_cuda.launches == n + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool and got.shape == (b, h, lq_p, lk_p)
    assert torch.equal(got, ref)


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
# height and width; and the "walk" cases of the bf16 strip walk: widths
# that cross three strips or more with a ragged last one (K5a: 62 y2
# columns a strip, K5b: 64 output columns), H over several row steps and
# segments, odd H at stride 2; co 32 at stride 1; ci 1 at a width that
# is not a multiple of 8
STEM_CASES = {
    "block0": (8, 8, (1, 1), 1, 16, 13, 9),
    "block1": (4, 2, (2, 2), 16, 32, 17, 11),
    "block2": (2, 1, (2, 2), 32, 64, 9, 19),
    "walk0": (8, 8, (1, 1), 1, 16, 21, 20),
    "walk1": (4, 2, (2, 2), 16, 32, 23, 70),
    "walk2": (2, 1, (2, 2), 32, 64, 19, 140),
    "s1co32": (2, 2, (1, 1), 16, 32, 19, 70),  # co 32 at stride 1: K5b's default stage is raised to 2 y2 rows
    "ci1w74": (2, 1, (2, 2), 1, 16, 15, 37),  # ci 1 at W 74, not a multiple of 8: x padded for K5a's map
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
@pytest.mark.parametrize("name", ["walk0", "walk1", "walk2"])
@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_fused_stem_forced_block_count_on_gpu(name, n_blocks):
    """The bf16 strip walk with fewer blocks than strips (each walks several
    units and resets its carry at each): K5a (y2, stats) and K5b against
    plain_k1/plain_k2 at dropout 0.5 on every site, elementwise and by
    channel; the statistics bit-equal across two runs at the same block
    count."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

    dev = _cuda()
    f_in, f_out, stride, ci, co, h, wp = STEM_CASES[name]
    (x, w1, b1, w2, b2, w3, b3), drop = _stem_inputs(STEM_CASES[name], torch.bfloat16, 0.5, dev, seed=4)
    for pos, use_elem in [(s, e) for s in (1, 2, 3) for e in (0, 1)]:
        drop["pos"] = torch.tensor(pos, dtype=torch.int32, device=dev)
        drop["use_elem"] = torch.tensor(use_elem, dtype=torch.int32, device=dev)
        y2, stats = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in, n_blocks=n_blocks)
        again = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in, n_blocks=n_blocks)
        y2_p, stats_p = fs.plain_k1(x, w1, b1, w2, b2, f_in=f_in, drop=drop)
        mean_inv = fs.norm_from_stats(stats, h * wp * f_in, 1e-3)
        out = fs.fused_stem_k2_cuda(y2, mean_inv, w3, b3, drop, f_in=f_in, f_out=f_out, stride=stride,
                                    n_blocks=n_blocks)
        out_p = fs.plain_k2(y2, mean_inv, w3, b3, f_in=f_in, f_out=f_out, stride=stride, drop=drop)
        torch.cuda.synchronize()
        tag = f"{name} n_blocks {n_blocks} pos {pos} use_elem {use_elem}"
        assert torch.equal(y2, again[0]) and torch.equal(stats, again[1]), tag
        _stem_close(f"K5a y2 ({tag})", y2, y2_p, torch.bfloat16)
        _stem_close(f"K5a stats ({tag})", stats, stats_p, torch.bfloat16)
        _stem_close(f"K5b out ({tag})", out, out_p, torch.bfloat16)


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
    # the bf16 kernels' own layouts (the built libraries) refuse what they do not take
    with pytest.raises(ValueError, match="does not take ci 128, co 128"):
        fs.k1_plan(2, 8, 64, 128, 128, True, 132)
    with pytest.raises(ValueError, match="does not take co 128"):
        fs.k2_plan(2, 8, 64, 128, (2, 1), 1, True, 132)
    with pytest.raises(ValueError, match="1 to 8 x rows"):
        fs.fused_packed_block(*(t.bfloat16() for t in (x, w1, b1, w2, b2, w3, b3)), tile_h=9, drop=drop, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_fused_stem_random_walks_on_gpu(seed):
    """The bf16 strip walk at 16 random launches a seed: geometry of one of
    the stem blocks (or co 32 at stride 1, or ci 1 at a ragged width), H
    3-40, widths of 1-5 strips, rows a stage, block counts and dropout
    sites drawn; every launch ends, K5a twice gives the same bits, and K5a
    (y2, stats) and K5b hold against plain_k1/plain_k2."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

    dev = _cuda()
    rng = np.random.default_rng(100 + seed)
    geoms = [STEM_CASES[n] for n in ("walk0", "walk1", "walk2", "s1co32", "ci1w74")]
    for i in range(16):
        f_in, f_out, stride, ci, co, _, _ = geoms[rng.integers(len(geoms))]
        h, wp = int(rng.integers(3, 41)), int(rng.integers(1, 5 * 64 // f_in + 1))
        geom = (f_in, f_out, stride, ci, co, h, wp)
        (x, w1, b1, w2, b2, w3, b3), drop = _stem_inputs(geom, torch.bfloat16, 0.5, dev, seed=1000 * seed + i)
        pos, use_elem = int(rng.integers(1, 4)), int(rng.integers(2))
        drop["pos"] = torch.tensor(pos, dtype=torch.int32, device=dev)
        drop["use_elem"] = torch.tensor(use_elem, dtype=torch.int32, device=dev)
        n_blocks = [None, None, 1, 2, 5][rng.integers(5)]
        tile1 = int(rng.integers(1, 9)) if co < 64 else int(rng.integers(1, 3))  # x rows a K5a stage that fit
        tile2 = int(rng.integers(-(-2 // stride[0]), {16: 16, 32: 8, 64: 2}[co] // stride[0] + 1))  # y2 rows that fit
        tag = f"{geom} tiles {tile1}/{tile2} n_blocks {n_blocks} pos {pos} use_elem {use_elem}"
        y2, stats = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in, tile=tile1, n_blocks=n_blocks)
        again = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in, tile=tile1, n_blocks=n_blocks)
        mean_inv = fs.norm_from_stats(stats, h * wp * f_in, 1e-3)
        out = fs.fused_stem_k2_cuda(y2, mean_inv, w3, b3, drop, f_in=f_in, f_out=f_out, stride=stride, tile=tile2,
                                    n_blocks=n_blocks)
        torch.cuda.synchronize()
        y2_p, stats_p = fs.plain_k1(x, w1, b1, w2, b2, f_in=f_in, drop=drop)
        out_p = fs.plain_k2(y2, mean_inv, w3, b3, f_in=f_in, f_out=f_out, stride=stride, drop=drop)
        assert torch.equal(y2, again[0]) and torch.equal(stats, again[1]), tag
        _stem_close(f"K5a y2 ({tag})", y2, y2_p, torch.bfloat16)
        _stem_close(f"K5a stats ({tag})", stats, stats_p, torch.bfloat16)
        _stem_close(f"K5b out ({tag})", out, out_p, torch.bfloat16)


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
# lse and its gradients must be 0). L2b and L2c run on K3a's and K3b's
# blocks in two width classes (64, 128 columns, zero-filled past D): bf16
# non-causal at D 128, 120 and 64 with Lq 300 and Lk 2100, where L2b splits
# its key tiles into chunks (legacy_dq_splits > 1) merged in order; D 72,
# whose second 64-column box is mostly zero fill; and a kv_valid that
# empties a whole 64-key tile (keys 128-191 of row 0: no product on it in
# L2b, a K3b consumer warpgroup with no valid key in L2c). L1 and L2a run on
# K1's block in the same width classes: every bf16 case of D <= 128 also
# runs them at each key split the launch takes (1-8 chunks merged by lse;
# a causal call in one), against the plain version with o = 0 and lse = 0
# on the rows with no key, and twice, bit-equal; Lk 2560 (40 key tiles)
# takes every split of 1-8, at D 72 and at D 64 with a batch row of kv_len
# 0 (no key in any chunk); D 120 causal is the 128 class's band.
LEGACY_CASES = [dict(d=d, causal=c, window=w, dtype=torch.bfloat16)
                for d in (40, 64, 128) for c, w in ((False, -1), (True, -1), (True, 30))]
LEGACY_CASES.append(dict(d=36, causal=True, window=30, dtype=torch.bfloat16))
LEGACY_CASES += [dict(d=d, causal=False, window=-1, dtype=torch.bfloat16, lq=300, lk=2100) for d in (128, 120, 64)]
LEGACY_CASES += [dict(d=72, causal=False, window=-1, dtype=torch.bfloat16),
                 dict(d=72, causal=True, window=30, dtype=torch.bfloat16),
                 dict(d=64, causal=False, window=-1, dtype=torch.bfloat16, empty_tile=True),
                 dict(d=128, causal=True, window=30, dtype=torch.bfloat16, empty_tile=True),
                 dict(d=120, causal=True, window=-1, dtype=torch.bfloat16),
                 dict(d=72, causal=False, window=-1, dtype=torch.bfloat16, lq=300, lk=2560),
                 dict(d=64, causal=False, window=-1, dtype=torch.bfloat16, lq=300, lk=2560, zero_len=True)]
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
    lq, lk = (150, 150) if case["causal"] else (case.get("lq", 90), case.get("lk", 200))
    dtype = case.get("dtype", torch.bfloat16)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32)).to(dev, dtype)
                   for n in (lq, lk, lk, lq))
    kv_len = torch.tensor([lk, 0 if case.get("zero_len") else 100 if case["causal"] else lk - 23],
                          dtype=torch.int32, device=dev)
    kv_valid = torch.ones((b, lk), dtype=torch.bool, device=dev)
    kv_valid[0, 40:70] = False  # a hole, as in the concat mixer's fused memories
    kv_valid[1, 90:] = False    # a short target
    if case.get("empty_tile"):
        kv_valid[0, 128:192] = False  # a whole 64-key tile, between tiles with valid keys
    return q, k, v, do, kv_len, kv_valid


def _legacy_id(c):
    dt = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}[c["dtype"]]
    return (f"d{c['d']}_c{int(c['causal'])}_w{c['window']}" + ("" if dt == "bf16" and c["d"] <= 128 else f"_{dt}")
            + ("_offset" if c.get("offset") else "") + ("_zero_len" if c.get("zero_len") else "")
            + (f"_q{c['lq']}_k{c['lk']}" if "lq" in c else "") + ("_empty_tile" if c.get("empty_tile") else ""))


def _l2b_splits(q, k, causal):
    """The key chunks of an L2b call on these [B, H, L, D] tensors (1 for a
    causal call)."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as l2

    if causal:
        return 1
    b, h, lq, d = q.shape
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return l2.legacy_dq_splits(b, h, lq, k.shape[2], d, n_sm)[0]


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
    if "lq" in case:  # the cases that split L2b's key tiles
        assert _l2b_splits(q, k, case["causal"]) > 1
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
    if tensor_cores:
        _legacy_forward_splits(case, q, k, v, kv_len, kv_valid, o1_ref, lse1_ref, o2_ref, lse_ref)


def _legacy_forward_splits(case, q, k, v, kv_len, kv_valid, o1_ref, lse1_ref, o2_ref, lse_ref):
    """L1 and L2a at each key split of 1-8 chunks the launch takes (one for
    a causal call), against the plain version, o = 0 and lse = 0 on the
    rows with no key, two calls bit-equal, and the block and grid of the
    launched chunk kernels those of ``legacy_fwd_splits``."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops.flash_packed import _split_of
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention as l1
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as l2

    band = dict(causal=case["causal"], window=case["window"])
    n_tiles = -(-k.shape[2] // 64)
    splits = [1] if case["causal"] else [n for n in range(1, min(8, n_tiles) + 1)
                                         if -(-n_tiles // -(-n_tiles // n)) == n]
    if case.get("lk") == 2560:
        assert splits == list(range(1, 9))
    empty1, empty2 = lse1_ref.detach() == 0, lse_ref.detach() == 0
    for n in splits:
        assert _split_of(n_tiles, n)[0] == n
        before = (l1.legacy_fwd_cuda.launches, l2.legacy_fwd_lse_cuda.launches)
        a1, b1 = (l1.legacy_fwd_cuda(q, k, v, kv_len, n_split=n, **band) for _ in range(2))
        (a2, al2), (b2, bl2) = (l2.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, n_split=n, **band) for _ in range(2))
        torch.cuda.synchronize()
        assert (l1.legacy_fwd_cuda.launches - before[0], l2.legacy_fwd_lse_cuda.launches - before[1]) == (2, 2)
        _legacy_close(f"L1 o, {n} key chunks", a1, o1_ref, torch.bfloat16)
        _legacy_close(f"L2a o, {n} key chunks", a2, o2_ref, torch.bfloat16)
        np.testing.assert_allclose(al2.cpu().numpy(), lse_ref.detach().cpu().numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"L2a lse, {n} key chunks")
        assert not a1[empty1].any() and not a2[empty2].any() and not al2[empty2].any()
        assert torch.isfinite(a1).all() and torch.isfinite(a2).all() and torch.isfinite(al2).all()
        assert torch.equal(a1, b1) and torch.equal(a2, b2) and torch.equal(al2, bl2), f"{n} key chunks"
    with pytest.raises(ValueError):  # a causal call walks its band in one chunk; no more chunks than tiles
        l1.legacy_fwd_cuda(q, k, v, kv_len, n_split=2 if case["causal"] else n_tiles + 1, **band)
    # the launched blocks hold the consumer warpgroups that legacy_fwd_splits sized the key chunks for
    b, h, lq, d = q.shape
    cons = l1.LEGACY_FWD_CONSUMERS[l1.width_class(d)]
    n_split = l1.legacy_fwd_splits(b, h, lq, k.shape[2], d, fp._sm_count(q.device), case["causal"])[0]
    for symbol, fn in (("lf_fwd_chunk", lambda: l1.legacy_fwd_cuda(q, k, v, kv_len, **band)),
                       ("lf_fwd_lse_chunk", lambda: l2.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, **band))):
        blocks = [(e["args"]["block"], e["args"]["grid"]) for e in _traced_kernels(fn, symbol)
                  if symbol in e["name"] and "merge" not in e["name"]]
        assert blocks == [([128 * (cons + 1), 1, 1], [-(-lq // (64 * cons)), h, b * n_split])], (symbol, blocks)


def _traced_kernels(fn, symbol, tries=5) -> list:
    """The kernel events (name, block, grid) of a profiler trace of one call
    of fn. The tracer now and then records none of a call's kernels; a trace
    that holds no kernel named ``symbol`` is taken again after a pause, up to
    ``tries`` times (chip_smoke.py's kernel_times does the same)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "kernel"]
        if any(symbol in e["name"] for e in events):
            break
        time.sleep(2.0)
    return events


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(d=64, causal=True, window=30, dtype=torch.bfloat16),
                                  dict(d=64, causal=False, window=-1, dtype=torch.float32),
                                  dict(d=64, causal=False, window=-1, dtype=torch.float16),
                                  dict(d=192, causal=False, window=-1, dtype=torch.float32),
                                  dict(d=128, causal=True, window=30, dtype=torch.bfloat16),
                                  dict(d=128, causal=False, window=-1, dtype=torch.bfloat16, lq=300, lk=2100),
                                  dict(d=64, causal=False, window=-1, dtype=torch.bfloat16, lq=300, lk=2100)],
                         ids=_legacy_id)
def test_legacy_backward_is_deterministic_on_gpu(case):
    """Both backward routes write each row once, and L2b sums its key
    chunks' partials in a fixed order: two calls give bit-equal dq, dk and
    dv (bf16 D 64 and 128 on L2b/L2c, causal in one key chunk and split;
    float32, float16 and D 192, three 64-column chunks of the output, on the
    any-dtype kernels)."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as l2

    dev = _cuda()
    q, k, v, do, kv_len, kv_valid = _legacy_inputs(case, dev)
    band = (case["causal"], case["window"])
    o, lse = l2.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, *band)
    args = (q, k, v, kv_len, kv_valid, do, lse, l2.attention_delta(do, o), *band)
    counters = (l2.legacy_any_dq_cuda, l2.legacy_any_dkv_cuda, l2.legacy_dq_cuda, l2.legacy_dkv_cuda)
    before = [f.launches for f in counters]
    first = (l2.legacy_dq_cuda(*args), *l2.legacy_dkv_cuda(*args))
    second = (l2.legacy_dq_cuda(*args), *l2.legacy_dkv_cuda(*args))
    any_route = not (case["dtype"] == torch.bfloat16 and case["d"] <= 128)
    launched = tuple(f.launches - n for f, n in zip(counters, before))
    # the any-dtype kernels, or (bf16 heads of up to 128) L2b and L2c, twice each
    assert launched == ((2, 2, 0, 0) if any_route else (0, 0, 2, 2))
    if "lq" in case:
        assert _l2b_splits(q, k, case["causal"]) > 1
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


# ------------------------------------------------------------ the train CLI


@pytest.mark.cuda
def test_train_cli_runs_k1_k2_each_step_on_gpu(tmp_path):
    """cli.train with --use_flash_cross on the card (tiny corpus of
    tests/test_cli_e2e.py, 2 epochs, validation each): K1 and K2 launch 8
    times per train step (one a decoder layer), the steps from the train
    loader's length; greedy decode launches neither; losses and SERs finite."""
    import math

    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli

    _cuda()
    syn = dict(n=6, img_height_range=[32, 33], img_width_range=[64, 96], audio_seconds_range=[0.3, 0.5],
               n_measures=1)
    argv = ["--ds_name", "synthetic", "--krn_encoding", "kern", "--synthetic", "--synthetic_config",
            json.dumps(syn), "--cache_root", str(tmp_path / "cache"), "--batch_size", "3", "--num_workers", "2",
            "--input_modality", "image", "--attn_window", "100", "--use_flash_cross", "--epochs", "2",
            "--check_val_every_n_epoch", "1", "--weights_dir", str(tmp_path / "w"), "--run_dir", str(tmp_path / "r")]
    kernels = (fp.flash_fwd_cuda, fp.flash_bwd_cuda, fp.flash_fwd_causal_cuda, fp.flash_dq_cuda,
               fp.flash_dkv_cuda, fp.keep_mask_cuda)
    before = [k.launches for k in kernels]
    out = train_cli.main(argv)
    launched = [k.launches - n for k, n in zip(kernels, before)]
    dm = common.make_datamodule(train_cli.build_parser().parse_args(argv), "image")
    dm.setup("fit")
    steps = 2 * len(dm.train_dataloader())
    assert steps == 4 and launched == [8 * steps, 8 * steps, 0, 0, 0, 0]
    assert all(math.isfinite(out[k]) for k in ("best_val_sym-er", "test_sym-er"))
    losses = [json.loads(line)["train_loss"] for line in open(tmp_path / "r" / "metrics.jsonl")
              if "train_loss" in line]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


@pytest.mark.cuda
@pytest.mark.parametrize("modality", ["audio", "both"])
def test_audio_and_multimodal_train_cli_run_k1_k2_each_step_on_gpu(tmp_path, modality):
    """cli.train of the audio model and of the gated attn_both multimodal
    model on the card (the same tiny corpus, its 0.3-0.5 s audio): K1 and K2
    launch 8 times per train step whatever modality a step draws (the
    decoder runs on every one), no other kernel; losses and SERs finite."""
    import math

    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli

    _cuda()
    syn = dict(n=6, img_height_range=[32, 33], img_width_range=[64, 96], audio_seconds_range=[0.3, 0.5],
               n_measures=1)
    argv = ["--ds_name", "synthetic", "--krn_encoding", "kern", "--synthetic", "--synthetic_config",
            json.dumps(syn), "--cache_root", str(tmp_path / "cache"), "--batch_size", "3", "--num_workers", "2",
            "--input_modality", modality, "--attn_window", "100", "--use_flash_cross", "--epochs", "2",
            "--check_val_every_n_epoch", "1", "--weights_dir", str(tmp_path / "w"), "--run_dir", str(tmp_path / "r")]
    if modality == "both":
        argv += ["--mixer_type", "attn_both", "--mixer_residual", "--teacher_forcing_modality_prob", "0.5"]
    kernels = (fp.flash_fwd_cuda, fp.flash_bwd_cuda, fp.flash_fwd_causal_cuda, fp.flash_dq_cuda,
               fp.flash_dkv_cuda, fp.keep_mask_cuda)
    before = [k.launches for k in kernels]
    out = train_cli.main(argv)
    launched = [k.launches - n for k, n in zip(kernels, before)]
    dm = common.make_datamodule(train_cli.build_parser().parse_args(argv), modality)
    dm.setup("fit")
    steps = 2 * len(dm.train_dataloader())
    assert steps == 4 and launched == [8 * steps, 8 * steps, 0, 0, 0, 0]
    assert all(math.isfinite(out[k]) for k in ("best_val_sym-er", "test_sym-er"))
    losses = [json.loads(line)["train_loss"] for line in open(tmp_path / "r" / "metrics.jsonl")
              if "train_loss" in line]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


# ------------------------------------------------------------ inference and serving


@pytest.mark.cuda
def test_beam_server_and_resize_on_gpu_match_cpu():
    """A tiny random image model and audio model (float32, TF32 off, as
    build_model sets it) on the card and on the CPU from one seed: beam 4
    with length penalty 0.6 gives the CPU's tokens (scores within 1e-4);
    an image and a fused TranscriptionServer on the card give, request for
    request, the CPU servers' tokens; preprocess_image_batch's bicubic
    resize on the card lies within 1e-5 of the CPU's, its hw equal. No
    kernel launches (decoding runs none)."""
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.ops.image import preprocess_image_batch
    from omr_a2s_multimodal_transformer_tpu_torch.serving import TranscriptionServer
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import beam_decode_fn

    dev = _cuda()
    hp = dict(vocab_size=31, max_seq_len=12, encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, size=(h, w), dtype=np.uint8) for h, w in ((32, 60), (30, 90), (32, 41))]
    waves = [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (4000, 9000, 6000)]
    raw = torch.full((3, 32, 96), 255, dtype=torch.uint8)
    for i, img in enumerate(imgs):
        raw[i, :img.shape[0], :img.shape[1]] = torch.from_numpy(img)
    hw = torch.tensor([img.shape for img in imgs], dtype=torch.int32)
    kernels = [fn for fn in (fp.flash_fwd_cuda, fp.flash_bwd_cuda, fp.flash_fwd_causal_cuda, fp.flash_dq_cuda,
                             fp.flash_dkv_cuda, fp.keep_mask_cuda)]
    before = [k.launches for k in kernels]
    out = {}
    for device in ("cpu", dev):
        img_model = build_model(dict(hp, input_modality="image"), device=device, seed=4)[0]
        aud_model = build_model(dict(hp, input_modality="audio"), device=device, seed=5)[0]
        x, hw2 = preprocess_image_batch(raw.to(device), hw.to(device), target_height=24)
        beam = beam_decode_fn(img_model, 12, 1, 30, beam_size=4, length_penalty=0.6)(x, hw2)
        results = {}
        for modality in ("image", "fused"):
            kw = dict(audio_model=aud_model, audio_samples=(8000, 12000)) if modality == "fused" else {}
            server = TranscriptionServer(img_model, modality, sos_id=1, eos_id=30, image_height=32,
                                         image_widths=(64, 96), max_wait_ms=500, device=device, **kw)
            try:
                futures = [server.submit((img, w) if modality == "fused" else img) for img, w in zip(imgs, waves)]
                results[modality] = [f.result(timeout=300).token_ids for f in futures]
                results[modality + "_stats"] = server.batch_stats()
            finally:
                server.stop(timeout=300)
        out[str(device)] = dict(x=x.cpu(), hw=hw2.cpu(), beam=[t.cpu() for t in beam], **results)
    cpu, gpu = out["cpu"], out[str(dev)]
    assert [k.launches for k in kernels] == before
    assert gpu["x"].shape == (3, 24, 72, 1) and float((gpu["x"] - cpu["x"]).abs().max()) <= 1e-5
    assert torch.equal(gpu["hw"], cpu["hw"])
    assert torch.equal(gpu["beam"][0], cpu["beam"][0])
    torch.testing.assert_close(gpu["beam"][1], cpu["beam"][1], rtol=0, atol=1e-4)
    for key in ("image", "fused", "image_stats", "fused_stats"):
        assert gpu[key] == cpu[key], key


# ------------------------------------------------------------ quantized decode and the device cache


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["int8", "int4"])
def test_quantized_decode_step_on_gpu_matches_dequantized_float32(cache_dtype):
    """One single-query cross-attention step from int8 / rank-1 int4 codes
    on the card (B 4, S 1,261, D 256, 4 heads, ragged mask): within 1e-2 of
    max |ref| of attention in float32 over the explicitly dequantized K/V
    (the quantized path rounds q and the softmax weights to bf16), and
    within 1e-4 of the same call on the CPU (another float32 summation
    order: a weight by a bf16 rounding boundary may round the other way,
    one bf16 ulp, 2^-8 of the weight; int4 gave 2.7e-5). The codes and
    scales equal the CPU's quantizer's. A tiny model's greedy decode with
    that cache gives the CPU's tokens."""
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import quantize_cross
    from omr_a2s_multimodal_transformer_tpu_torch.ops.attention import attend_packed_single_query, unpack_int4
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn

    dev = _cuda()
    rng = np.random.default_rng(11)
    b, s, d = 4, 1261, 256
    k, v = (torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)).to(dev) for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    valid = torch.arange(s, device=dev)[None, :] < torch.tensor([s, 900, 500, 77], device=dev)[:, None]
    bias = torch.where(valid, 0.0, -1e9)
    qk, qv = quantize_cross(k, cache_dtype), quantize_cross(v, cache_dtype)

    def dequant(e):
        codes = (unpack_int4(e["q"]) if cache_dtype == "int4" else e["q"]).float()
        if "tscale" in e:
            codes = codes * e["tscale"][:, :, None]
        return codes * e["scale"][:, None, :]

    kw = dict(k_scale=qk["scale"], v_scale=qv["scale"], k_tscale=qk.get("tscale"), v_tscale=qv.get("tscale"))
    got = attend_packed_single_query(q, qk["q"], qv["q"], H, bias, **kw)
    ref = attend_packed_single_query(q, dequant(qk), dequant(qv), H, bias)
    cpu = attend_packed_single_query(q.cpu(), qk["q"].cpu(), qv["q"].cpu(), H, bias.cpu(),
                                     **{n: None if t is None else t.cpu() for n, t in kw.items()})
    assert got.device.type == "cuda" and got.dtype == torch.float32
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-2 * scale
    assert float((got.cpu() - cpu).abs().max()) <= 1e-4 * scale
    for e, t in ((qk, k), (qv, v)):
        host = quantize_cross(t.cpu(), cache_dtype)
        assert all(torch.equal(e[n].cpu(), host[n]) for n in host)

    hp = dict(vocab_size=31, max_seq_len=12, input_modality="image", cache_dtype=cache_dtype, encoder_dropout=0.0,
              decoder_dropout=0.0, pos_dropout=0.0)
    x = torch.from_numpy(rng.uniform(size=(2, 32, 64, 1)).astype(np.float32))
    hw = torch.tensor([[32, 64], [25, 44]], dtype=torch.int32)
    tokens = [greedy_decode_fn(build_model(hp, device=device, seed=6)[0], 12, 1, 31)(x.to(device), hw.to(device))[0]
              .cpu() for device in ("cpu", dev)]
    assert torch.equal(tokens[0], tokens[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cast_bf16", [True, False], ids=["bf16", "f32"])
def test_device_cache_gathers_on_gpu_equal_the_host_loader(tmp_path, cast_bf16):
    """The device cache on the card (u8 images for the image corpus, the
    bf16 cast of the multimodal one's spectrograms): every batch of two
    epochs bit-equal to the streaming loader's batch moved to the card and
    cast as the Trainer casts it."""
    from omr_a2s_multimodal_transformer_tpu_torch.data.dataset import ARDataModule
    from omr_a2s_multimodal_transformer_tpu_torch.data.device_cache import DeviceCacheLoader

    dev = _cuda()
    syn = dict(n=7, img_height_range=[32, 33], img_width_range=[64, 96], audio_seconds_range=[0.3, 0.5],
               n_measures=1)
    for modality in ("image", "both"):
        dm = ARDataModule("synthetic", krn_encoding="kern", input_modality=modality, batch_size=3, num_workers=2,
                          synthetic=True, synthetic_kwargs=syn, cache_root=str(tmp_path / modality))
        dm.setup("fit")
        stream = dm.train_dataloader()
        cache = DeviceCacheLoader(dm.train_dataloader(), dev, cast_bf16=cast_bf16, store_u8=True)
        for _epoch in range(2):
            for s, c in zip(stream, cache):
                for k, t in s.items():
                    want = torch.from_numpy(t).to(dev)
                    if cast_bf16 and k in ("x", "xi", "xa"):
                        want = want.to(torch.bfloat16)
                    assert c[k].device.type == "cuda" and c[k].dtype == want.dtype, k
                    assert torch.equal(c[k], want), k
        assert cache._stacks[{"image": "x", "both": "xi"}[modality]].dtype == torch.uint8
