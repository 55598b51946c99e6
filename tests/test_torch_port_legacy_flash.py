"""The port's per-head legacy flash attention (L1, and L2 with its backward)
against the JAX kernels of ``tools/legacy_flash``, on the CPU.

The JAX side runs ``flash_attention(..., interpret=True)`` (L1) and
``make_flash_attention(..., interpret=True)`` through ``jax.vjp`` (L2a, L2b,
L2c), with L2a's lse read from the forward rule of its ``custom_vjp``. The
port takes its plain version (the route of CPU tensors), so these tests fix
the function that L1, L2a, L2b and L2c are held to on the card. The JAX
modules are loaded by path: ``tools/`` is not a package of the repository.

Inputs come from a numpy seed. o and lse are compared on the query rows
that see a key; on the others the port gives o = 0 and lse = 0, where the
JAX kernel averages v over the blocks it ran (ROADMAP Queue 3). dq, dk and
dv are compared on every row, with a nonzero cotangent everywhere: both
mask p before its products, so a row with no key adds nothing.

The forward of L1 and L2a on the card walks the keys in chunks of 64-key
tiles (``legacy_fwd_splits``) and merges the chunks' (o, lse) by lse:
``_chunked_plain`` does the same in float32 (a row that sees no key of a
chunk weighs 0 there; a row that sees none at all gets o = 0, lse = 0),
and is held against the JAX kernels at 1, 2 and 4 chunks.

Tolerance: float32 at 1e-5 relative and absolute (the same float32
formulas, the JAX kernel's online softmax against the dense softmax, in
another summation order; the conftest sets JAX's matmuls to full float32);
bf16 and float16 inputs at 3e-2 (outputs rounded at other points). Besides
the bf16 and float32 heads of 40 to 128, a float16 head of 64 and float32
heads of 72, 192 and 320 are cases of their own: on the card they take the
any-dtype kernels, which work in 64-column chunks. 72 is one chunk and 8
columns; the forward keeps up to 128 columns of float32 output in registers
(192 in 16-bit types) and splits wider ones over the grid, as at 192 and
320.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as tflash
from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention as tl1
from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as tl2

LEGACY = Path(__file__).resolve().parents[1] / "tools" / "legacy_flash"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_legacy_{name}", LEGACY / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jl1 = _load("flash_attention")
jl2 = _load("flash_attention_bwd")

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5), jnp.bfloat16: dict(rtol=3e-2, atol=3e-2),
       np.float16: dict(rtol=3e-2, atol=3e-2)}

CASES = {
    # non-causal, Lq != Lk, ragged kv_len; L2 adds non-prefix kv_valid holes (the concat mixer's fused memories)
    "cross_ragged_d40": dict(b=2, h=2, lq=70, lk=200, d=40, causal=False, window=-1, kv_len=(200, 137),
                             holes=((0, 10, 50), (1, 90, 120))),
    "causal_full_d64": dict(b=2, h=2, lq=150, lk=150, d=64, causal=True, window=-1, kv_len=(150, 150), holes=()),
    # the issue's probe: batch 1's queries past 180 see no key in their band
    "window30_ragged_d40": dict(b=2, h=2, lq=200, lk=200, d=40, causal=True, window=30, kv_len=(200, 150),
                                holes=()),
    # windowed with holes: a short target as kv_valid, so the last rows of batch 0 see no key
    "window20_holes_d128": dict(b=2, h=1, lq=130, lk=130, d=128, causal=True, window=20, kv_len=(130, 130),
                                holes=((0, 60, 130), (1, 5, 9))),
    # float16 inputs (float32 softmax and products in both, outputs rounded to float16)
    "cross_ragged_f16_d64": dict(b=2, h=2, lq=70, lk=200, d=64, causal=False, window=-1, kv_len=(200, 137),
                                 holes=((0, 10, 50), (1, 90, 120)), dtype=np.float16),
    # a head wider than 128 (JAX pads it to 256 lanes), windowed, with a short target
    "window30_holes_d192": dict(b=2, h=1, lq=100, lk=100, d=192, causal=True, window=30, kv_len=(100, 100),
                                holes=((1, 70, 100),)),
    # one 64-column chunk and 8 columns more (the any-dtype forward's second chunk is mostly zero-fill)
    "cross_ragged_d72": dict(b=2, h=2, lq=70, lk=200, d=72, causal=False, window=-1, kv_len=(200, 137),
                             holes=((0, 10, 50), (1, 90, 120))),
    # past the any-dtype forward's register-resident widths (128 in float32, 192 in 16-bit types): o split
    # into 64-column chunks over the grid
    "window30_ragged_d320": dict(b=2, h=1, lq=100, lk=100, d=320, causal=True, window=30, kv_len=(100, 70),
                                 holes=((0, 40, 60),)),
}
# two JAX block geometries per case (the L1 defaults, and 128/128): the function must not depend on them
BLOCKS = {"blocks_default": None, "blocks_128": (128, 128)}


def _inputs(case, dtype=None, seed=0):
    dtype = dtype or case.get("dtype", np.float32)
    rng = np.random.default_rng(seed)
    b, h, lq, lk, d = case["b"], case["h"], case["lq"], case["lk"], case["d"]
    q, w = (rng.normal(size=(b, h, lq, d)).astype(dtype) for _ in range(2))
    k, v = (rng.normal(size=(b, h, lk, d)).astype(dtype) for _ in range(2))
    kv_len = np.asarray(case["kv_len"], np.int32)
    kv_valid = np.ones((b, lk), bool)
    for row, lo, hi in case["holes"]:
        kv_valid[row, lo:hi] = False
    return q, k, v, w, kv_len, kv_valid


def _rows_with_a_key(case, kv_len, kv_valid):
    """[B, Lq] bool: the query rows that see at least one key."""
    qpos, kpos = np.arange(case["lq"])[:, None], np.arange(case["lk"])[None, :]
    see = (kv_valid & (kpos < kv_len[:, None]))[:, None, :]
    if case["causal"]:
        band = kpos <= qpos
        if case["window"] > 0:
            band &= kpos >= qpos - case["window"]
        see = see & band[None]
    return np.broadcast_to(see, (len(kv_len), case["lq"], case["lk"])).any(-1)


def _block_kw(blocks):
    return {} if blocks is None else dict(block_q=blocks[0], block_k=blocks[1])


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("blocks", list(BLOCKS.values()), ids=list(BLOCKS))
@pytest.mark.parametrize("name", list(CASES))
def test_l1_plain_matches_jax_interpret(name, blocks):
    case = CASES[name]
    q, k, v, _, kv_len, _ = _inputs(case)
    rows = _rows_with_a_key(case, kv_len, np.ones((case["b"], case["lk"]), bool))
    kw = dict(causal=case["causal"], window=case["window"], **_block_kw(blocks))
    oj = np.asarray(jl1.flash_attention(q, k, v, jnp.asarray(kv_len), interpret=True, **kw))
    ot = tl1.flash_attention(*_torch(q, k, v, kv_len), **kw).numpy()
    dtype = case.get("dtype", np.float32)
    assert ot.shape == oj.shape and ot.dtype == dtype
    ot, oj = ot.astype(np.float32), oj.astype(np.float32)
    np.testing.assert_allclose(ot.transpose(0, 2, 1, 3)[rows], oj.transpose(0, 2, 1, 3)[rows], **TOL[dtype])
    assert not ot.transpose(0, 2, 1, 3)[~rows].any(), "a row with no key to see must give o = 0"


@pytest.mark.parametrize("blocks", list(BLOCKS.values()), ids=list(BLOCKS))
@pytest.mark.parametrize("name", list(CASES))
def test_l2_plain_matches_jax_interpret_forward_lse_and_grads(name, blocks):
    case = CASES[name]
    q, k, v, w, kv_len, kv_valid = _inputs(case)
    rows = _rows_with_a_key(case, kv_len, kv_valid)
    kw = dict(causal=case["causal"], window=case["window"], **_block_kw(blocks))
    j_flash = jl2.make_flash_attention(interpret=True, **kw)
    j_len, j_valid = jnp.asarray(kv_len), jnp.asarray(kv_valid)
    oj, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, j_len, j_valid), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gj = vjp(jnp.asarray(w))
    lse_j = np.asarray(j_flash.fwd(q, k, v, j_len, j_valid)[1][5])  # residual lse, [B*H, Lq_p]
    lse_j = lse_j.reshape(case["b"], case["h"], -1)[:, :, :case["lq"]]

    qt, kt, vt = (t.requires_grad_() for t in _torch(q, k, v))
    lent, validt = _torch(kv_len, kv_valid)
    ot = tl2.make_flash_attention(**kw)(qt, kt, vt, lent, validt)
    ot.backward(torch.from_numpy(w))
    o_plain, lse_t = tl1.attention_plain(qt, kt, vt, lent, validt, case["causal"], case["window"])
    np.testing.assert_array_equal(ot.detach().numpy(), o_plain.detach().numpy())

    dtype = case.get("dtype", np.float32)
    tol = TOL[dtype]
    assert ot.dtype == qt.grad.dtype == torch.from_numpy(q).dtype
    o_rows = ot.detach().float().numpy().transpose(0, 2, 1, 3)
    lse_t = lse_t.detach().numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(o_rows[rows], np.asarray(oj, np.float32).transpose(0, 2, 1, 3)[rows], **tol)
    np.testing.assert_allclose(lse_t[rows], lse_j.astype(np.float32).transpose(0, 2, 1)[rows], **tol, err_msg="lse")
    assert not o_rows[~rows].any() and not lse_t[~rows].any(), "a row with no key must give o = 0, lse = 0"
    for label, got, ref in (("dq", qt, gj[0]), ("dk", kt, gj[1]), ("dv", vt, gj[2])):
        np.testing.assert_allclose(got.grad.float().numpy(), np.asarray(ref, np.float32), **tol, err_msg=label)


def test_l2_plain_matches_jax_interpret_in_bf16():
    case = CASES["window30_ragged_d40"] | dict(d=64)
    q, k, v, w, kv_len, kv_valid = _inputs(case, seed=1)
    rows = _rows_with_a_key(case, kv_len, kv_valid)
    kw = dict(causal=True, window=case["window"], block_q=128, block_k=128)
    j_flash = jl2.make_flash_attention(interpret=True, **kw)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    oj, vjp = jax.vjp(lambda q, k, v: j_flash(q, k, v, jnp.asarray(kv_len), jnp.asarray(kv_valid)), *args)
    gj = vjp(jnp.asarray(w, jnp.bfloat16))

    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    ot = tl2.make_flash_attention(**kw)(qt, kt, vt, *_torch(kv_len, kv_valid))
    ot.backward(torch.from_numpy(w).to(torch.bfloat16))
    assert ot.dtype == torch.bfloat16 and qt.grad.dtype == torch.bfloat16
    f32 = lambda t: (t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32))  # noqa: E731
    np.testing.assert_allclose(f32(ot.detach()).transpose(0, 2, 1, 3)[rows],
                               f32(oj).transpose(0, 2, 1, 3)[rows], **TOL[jnp.bfloat16])
    for label, got, ref in (("dq", qt, gj[0]), ("dk", kt, gj[1]), ("dv", vt, gj[2])):
        np.testing.assert_allclose(f32(got.grad), f32(ref), **TOL[jnp.bfloat16], err_msg=label)


def test_l1_kv_len_defaults_to_all_keys_and_window_needs_causal():
    case = CASES["cross_ragged_d40"]
    q, k, v, _, _, _ = _inputs(case)
    qt, kt, vt = _torch(q, k, v)
    full = torch.full((case["b"],), case["lk"], dtype=torch.int32)
    np.testing.assert_array_equal(tl1.flash_attention(qt, kt, vt).numpy(),
                                  tl1.flash_attention(qt, kt, vt, full).numpy())
    np.testing.assert_array_equal(tl1.flash_attention(qt, kt, vt, window=5).numpy(),
                                  tl1.flash_attention(qt, kt, vt).numpy())


def test_flash_attention_cached_returns_one_function_per_configuration():
    a = tl2.flash_attention_cached(True, 30)
    assert a is tl2.flash_attention_cached(True, 30)
    assert a is not tl2.flash_attention_cached(True, 31)


def test_legacy_kernels_refuse_cpu_tensors_without_launching():
    """A wrapper launches its kernel on CUDA tensors or raises: CPU tensors
    go through the plain version at the public functions, never here."""
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    kv_len, kv_valid = torch.full((1,), 8, dtype=torch.int32), torch.ones((1, 8), dtype=torch.bool)
    stats = torch.zeros((1, 2, 8))
    wrappers = (tl1.legacy_fwd_cuda, tl2.legacy_fwd_lse_cuda, tl2.legacy_dq_cuda, tl2.legacy_dkv_cuda)
    counts = [f.launches for f in wrappers]
    with pytest.raises(ValueError):
        tl1.legacy_fwd_cuda(q, q, q, kv_len)
    with pytest.raises(ValueError):
        tl2.legacy_fwd_lse_cuda(q, q, q, kv_len, kv_valid)
    with pytest.raises(ValueError):
        tl2.legacy_dq_cuda(q, q, q, kv_len, kv_valid, q, stats, stats)
    with pytest.raises(ValueError):
        tl2.legacy_dkv_cuda(q, q, q, kv_len, kv_valid, q, stats, stats)
    assert counts == [f.launches for f in wrappers]


def test_any_operands_pads_short_rows_and_copies_misaligned_views():
    """The any-dtype kernels copy 16 bytes at a time: rows that are not a
    multiple of 16 bytes are zero-padded to a multiple of 8 columns, and an
    operand whose rows are whole 16-byte copies but whose address is off a
    16-byte boundary is copied, values unchanged."""
    rng = np.random.default_rng(3)
    short = [torch.from_numpy(rng.normal(size=(1, 2, 5, 37)).astype(np.float32)) for _ in range(3)]
    padded = tl1.any_operands(*short)
    for p, t in zip(padded, short):
        assert p.shape == (1, 2, 5, 40) and p.is_contiguous() and p.data_ptr() % 16 == 0
        assert torch.equal(p[..., :37], t) and not p[..., 37:].any()
    # a 36-wide float32 row is 144 bytes, nine 16-byte copies: not padded, but a view one element into its
    # buffer starts 4 bytes off a boundary and is copied; an aligned operand is passed as it is
    buf = torch.from_numpy(rng.normal(size=1 + 2 * 5 * 36).astype(np.float32)).clone()  # torch's aligned buffer
    view = buf[1:].view(1, 2, 5, 36)
    aligned = torch.from_numpy(rng.normal(size=(1, 2, 5, 36)).astype(np.float32)).clone()
    assert view.data_ptr() % 16 and aligned.data_ptr() % 16 == 0
    got_view, got_aligned = tl1.any_operands(view, aligned)
    assert got_view.shape == view.shape and got_view.data_ptr() % 16 == 0 and torch.equal(got_view, view)
    assert got_aligned is aligned


# L2b's key split (legacy_dq_splits): K3a's chooser over L2b's blocks of
# LEGACY_DQ_CONSUMERS[width class] x 64 queries per (b, h), on 132 SMs
CHOOSER_SHAPES = [  # (B, H, Lq, Lk, D)
    (8, 4, 1268, 12696, 64),   # the legacy cross shape, 4 x 64 heads
    (8, 2, 1268, 12696, 128),  # the same keys at 2 x 128 (the model's 256 columns)
    (2, 3, 300, 2100, 120),    # the card tests' split cases
    (2, 3, 90, 200, 72),
    (2, 4, 150, 60, 64),       # one key tile
    (1, 1, 64, 130, 40),       # three key tiles, one block
    (64, 8, 2048, 4096, 64),   # 5,632 blocks: the grid fills the card many times over
    (64, 8, 2048, 4096, 128),
]


@pytest.mark.parametrize("shape", CHOOSER_SHAPES, ids=lambda s: "b{}_h{}_q{}_k{}_d{}".format(*s))
def test_legacy_dq_splits_cover_the_key_tiles(shape):
    """Never more chunks than key tiles, and every chunk holds a tile: the
    chunks of `per` tiles cover the ceil(Lk / 64) tiles exactly."""
    b, h, lq, lk, d = shape
    n_split, per = tl2.legacy_dq_splits(b, h, lq, lk, d, 132)
    n_tiles = -(-lk // 64)
    assert 1 <= n_split <= n_tiles and per >= 1
    assert (n_split - 1) * per < n_tiles <= n_split * per


@pytest.mark.parametrize("d", [40, 64, 72, 128])
def test_legacy_dq_splits_take_one_chunk_when_the_grid_fills_the_card(d):
    """5,632 (D <= 64) or 8,192 (D 128) blocks are 43 or 62 waves of 132:
    splitting the keys would add a block's set-up per chunk and no wave is
    short of work, so the chooser keeps one chunk."""
    assert tl2.legacy_dq_splits(64, 8, 2048, 4096, d, 132) == (1, 64)


@pytest.mark.parametrize("shape, want", [((8, 4, 1268, 12696, 64), (4, 50)), ((8, 2, 1268, 12696, 128), (4, 50))],
                         ids=["cross_d64", "cross_d128"])
def test_legacy_dq_splits_at_the_legacy_cross_shape(shape, want):
    """The picks PERF.md states: 224 blocks of 192 queries at D 64 (K3a's
    blocks and its 4 chunks of 50 key tiles), 160 blocks of 128 queries at
    D 128 with 2 heads (4 chunks too)."""
    b, h, lq, lk, d = shape
    assert tl2.legacy_dq_splits(b, h, lq, lk, d, 132) == want
    consumers = tl2.LEGACY_DQ_CONSUMERS[tl2.width_class(d)]
    assert -(-lq // (64 * consumers)) * h * b == (224 if d == 64 else 160)
    if d == 64:
        assert tl2.legacy_dq_splits(b, h, lq, lk, d, 132) == tflash.dq_splits(b, h, lq, lk, 132)


@pytest.mark.parametrize("d, cls", [(8, 64), (40, 64), (64, 64), (72, 128), (120, 128), (128, 128)])
def test_width_class_holds_the_head(d, cls):
    """L2b and L2c are built for heads of 64 and 128 columns; a narrower
    head takes the class that holds it (its columns past D read as zero)."""
    assert tl2.width_class(d) == cls and tl2.LEGACY_DQ_CONSUMERS[cls] in (2, 3)


# ------------------------------------------------ L1 / L2a in key chunks


def _chunked_plain(q, k, v, kv_len, kv_valid, causal, window, n_split):
    """(o, lse) of L1 (kv_valid None) or L2a as their kernels compute them,
    in float32: the keys in n_split chunks of ``per`` 64-key tiles
    (``_split_of``, as the launch splits them), each chunk's masked softmax
    giving its (o_c, lse_c), with o_c = 0 and lse_c = -inf on a row that
    sees no key of the chunk; then lse = mx + log sum_c exp(lse_c - mx) and
    o = sum_c exp(lse_c - lse) o_c in chunk order, mx the rows' largest
    lse_c; a row with no key in any chunk gets o = 0 and lse = 0."""
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    n_split, per = tflash._split_of(-(-lk // tflash.KERNEL_TILE), n_split)
    see = tl1.visible_keys(lq, lk, kv_len, kv_valid, causal, tflash.band_window(causal, window))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5
    o_parts, lse_parts = [], []
    for c in range(n_split):
        lo, hi = c * per * 64, min(lk, (c + 1) * per * 64)
        see_c = see[..., lo:hi].expand(*s.shape[:3], hi - lo)
        s_c = torch.where(see_c, s[..., lo:hi], float("-inf"))
        seen = see_c.any(-1)
        lse_c = torch.where(seen, torch.logsumexp(s_c, -1), float("-inf"))
        p = torch.where(see_c, torch.exp(s_c - torch.where(seen, lse_c, 0.0)[..., None]), 0.0)
        o_parts.append(torch.matmul(p, v[:, :, lo:hi].float()))
        lse_parts.append(lse_c)
    mx = torch.stack(lse_parts).amax(0)
    seen = mx > float("-inf")
    tot, acc = torch.zeros_like(mx), torch.zeros_like(o_parts[0])
    for o_c, lse_c in zip(o_parts, lse_parts):
        w = torch.where(seen, torch.exp(lse_c - torch.where(seen, mx, 0.0)), 0.0)
        tot = tot + w
        acc = acc + w[..., None] * o_c
    o = torch.where(seen[..., None], acc / torch.where(seen, tot, 1.0)[..., None], 0.0)
    return o, torch.where(seen, mx + torch.log(torch.where(seen, tot, 1.0)), 0.0)


# the float32 cases, and one whose chunks hold no key for some rows: a kv_valid hole of a whole 64-key tile
# (row 0), a kv_len that ends in the second tile (row 1) and a kv_len of 0 (row 2: no key at all)
CHUNK_CASES = {name: c for name, c in CASES.items() if c.get("dtype", np.float32) == np.float32} | {
    "cross_dead_chunks_d64": dict(b=3, h=2, lq=70, lk=256, d=64, causal=False, window=-1, kv_len=(256, 100, 0),
                                  holes=((0, 64, 128),)),
}
_JAX_FWD = {}


def _jax_forward(name):
    """(L1's o, L2a's o, L2a's lse) of the JAX kernels in interpret mode on
    the case's float32 inputs, once per case."""
    if name not in _JAX_FWD:
        case = CHUNK_CASES[name]
        q, k, v, _, kv_len, kv_valid = _inputs(case)
        kw = dict(causal=case["causal"], window=case["window"])
        o1 = np.asarray(jl1.flash_attention(q, k, v, jnp.asarray(kv_len), interpret=True, **kw))
        o2, res = jl2.make_flash_attention(interpret=True, **kw).fwd(q, k, v, jnp.asarray(kv_len),
                                                                     jnp.asarray(kv_valid))
        lse = np.asarray(res[5]).reshape(case["b"], case["h"], -1)[:, :, :case["lq"]]
        _JAX_FWD[name] = (o1, np.asarray(o2), lse)
    return _JAX_FWD[name]


def _chunks(case, n_split):
    """n_split, or the key tiles' count where there are fewer."""
    return min(n_split, -(-case["lk"] // 64))


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_l1_chunked_forward_matches_jax_interpret(name, n_split):
    case = CHUNK_CASES[name]
    q, k, v, _, kv_len, _ = _inputs(case)
    rows = _rows_with_a_key(case, kv_len, np.ones((case["b"], case["lk"]), bool))
    o, _ = _chunked_plain(*_torch(q, k, v, kv_len), None, case["causal"], case["window"], _chunks(case, n_split))
    o = o.numpy().transpose(0, 2, 1, 3)
    assert np.isfinite(o).all()
    np.testing.assert_allclose(o[rows], _jax_forward(name)[0].transpose(0, 2, 1, 3)[rows], **TOL[np.float32])
    assert not o[~rows].any(), "a row with no key to see must give o = 0"


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("name", list(CHUNK_CASES))
def test_l2a_chunked_forward_matches_jax_interpret(name, n_split):
    case = CHUNK_CASES[name]
    q, k, v, _, kv_len, kv_valid = _inputs(case)
    rows = _rows_with_a_key(case, kv_len, kv_valid)
    o, lse = _chunked_plain(*_torch(q, k, v, kv_len, kv_valid), case["causal"], case["window"],
                            _chunks(case, n_split))
    o, lse = o.numpy().transpose(0, 2, 1, 3), lse.numpy().transpose(0, 2, 1)
    assert np.isfinite(o).all() and np.isfinite(lse).all()
    _, oj, lse_j = _jax_forward(name)
    np.testing.assert_allclose(o[rows], oj.transpose(0, 2, 1, 3)[rows], **TOL[np.float32])
    np.testing.assert_allclose(lse[rows], lse_j.transpose(0, 2, 1)[rows], **TOL[np.float32], err_msg="lse")
    assert not o[~rows].any() and not lse[~rows].any(), "a row with no key must give o = 0, lse = 0"


def test_chunked_forward_cases_have_dead_chunks_and_rows_without_keys():
    """The chunked cases reach both edges of the merge: at 4 chunks some
    row sees no key of some chunk but sees one of another, and some row sees
    no key at all."""
    case = CHUNK_CASES["cross_dead_chunks_d64"]
    _, _, _, _, kv_len, kv_valid = _inputs(case)
    see = (kv_valid & (np.arange(case["lk"])[None, :] < kv_len[:, None])).reshape(case["b"], 4, 64).any(-1)
    assert (see.any(1) & ~see.all(1)).any() and (~see.any(1)).any()


# L1 and L2a's key split (legacy_fwd_splits): K1's chooser over their blocks of
# LEGACY_FWD_CONSUMERS[width class] x 64 queries per (b, h), on 132 SMs


@pytest.mark.parametrize("shape", CHOOSER_SHAPES, ids=lambda s: "b{}_h{}_q{}_k{}_d{}".format(*s))
def test_legacy_fwd_splits_cover_the_key_tiles(shape):
    """Never more chunks than key tiles, and every chunk holds a tile; a
    causal call takes one chunk of every tile."""
    b, h, lq, lk, d = shape
    n_tiles = -(-lk // 64)
    n_split, per = tl1.legacy_fwd_splits(b, h, lq, lk, d, 132)
    assert 1 <= n_split <= n_tiles and per >= 1
    assert (n_split - 1) * per < n_tiles <= n_split * per
    assert tl1.legacy_fwd_splits(b, h, lq, lk, d, 132, causal=True) == (1, n_tiles)


@pytest.mark.parametrize("shape, want", [((8, 4, 1268, 12696, 64), (4, 50)), ((8, 2, 1268, 12696, 128), (4, 50))],
                         ids=["cross_d64", "cross_d128"])
def test_legacy_fwd_splits_at_the_legacy_cross_shape(shape, want):
    """The picks PERF.md states: K1's 224 blocks of 192 queries and its 4
    chunks of 50 key tiles at D 64; 160 blocks of 128 queries at D 128
    with 2 heads, 4 chunks too; the self shape, causal, one chunk."""
    b, h, lq, lk, d = shape
    assert tl1.legacy_fwd_splits(b, h, lq, lk, d, 132) == want
    consumers = tl1.LEGACY_FWD_CONSUMERS[tl1.width_class(d)]
    assert -(-lq // (64 * consumers)) * h * b == (224 if d == 64 else 160)
    if d == 64:
        assert tl1.legacy_fwd_splits(b, h, lq, lk, d, 132) == tflash.fwd_splits(b, h, lq, lk, 132)
    assert tl1.legacy_fwd_splits(b, h, lq, lq, d, 132, causal=True) == (1, 20)


@pytest.mark.parametrize("source, launch, table", [("legacy_flash_fwd.cu", "launch_fwd", "LEGACY_FWD_CONSUMERS"),
                                                   ("legacy_flash_dq.cu", "launch_dq", "LEGACY_DQ_CONSUMERS")],
                         ids=["l1_l2a", "l2b"])
def test_consumer_tables_match_the_c_launches(source, launch, table):
    """The key-split choosers size their chunks for blocks of the consumer
    counts in the wrappers' tables; the C launches pick their instances by
    D: a non-causal call of each width class must launch the table's
    count (NB = 1: 64 columns, 2: 128)."""
    text = (Path(tl1.__file__).resolve().parents[2] / "csrc" / source).read_text()
    body = text[text.index('extern "C"'):]
    built = {64 * int(nb): int(n) for n, causal, nb in re.findall(launch + r"<(\d), (true|false), (\d)>", body)
             if causal == "false"}
    tables = {"LEGACY_FWD_CONSUMERS": tl1.LEGACY_FWD_CONSUMERS, "LEGACY_DQ_CONSUMERS": tl2.LEGACY_DQ_CONSUMERS}
    assert built == tables[table]
