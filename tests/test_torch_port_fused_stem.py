"""The fused stem block, ported, against the JAX package on the CPU.

- ``fused_packed_block``: the port (on the CPU its plain version,
  ``reference_block``) against the JAX block run as
  ``tests/test_fused_stem.py`` runs it (Pallas interpret mode), forward and
  the gradients of sum(sin(out)) in x and the six parameters, at the three
  packed stages of the stem ladder, with and without dropout. Both take
  the same numpy inputs and the dropout draw of JAX's ``make_drop_ctx``.
- ``reference_block``, ``packed_conv`` (all three modes, the ladder's
  strides, the geometry errors) and ``instance_norm_packed`` (with and
  without ``valid``) against their JAX functions.
- The tie to the model: ``fused_packed_block`` on ``pack_width(x)`` with a
  port ``ConvBlock``'s weights in HWIO equals that block's deterministic
  forward, packed.
- The kernels' default launches fit a block (float32: the wrapper's tile
  sizes; bf16: the kernels' layouts, csrc/fused_stem_layout.h, built by
  the host compiler; more in tests/test_torch_port_stem_layout.py).

Tolerances, max |port - JAX| / max |JAX| per tensor: float64 1e-10 for
outputs and 1e-9 for gradients, float32 1e-5 for both; the two packages
sum the convolutions in other orders. The CUDA kernels K5a/K5b are held
against ``reference_block`` on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu.ops.fused_stem import fused_packed_block as j_fused
from omr_a2s_multimodal_transformer_tpu.ops.fused_stem import make_drop_ctx as j_drop_ctx
from omr_a2s_multimodal_transformer_tpu.ops.fused_stem import reference_block as j_reference
from omr_a2s_multimodal_transformer_tpu.ops.norm import instance_norm_packed as j_norm_packed
from omr_a2s_multimodal_transformer_tpu.ops.packed_conv import packed_conv as j_packed_conv
from omr_a2s_multimodal_transformer_tpu_torch.models.encoder import ConvBlock
from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build
from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs
from omr_a2s_multimodal_transformer_tpu_torch.ops.norm import instance_norm_packed
from omr_a2s_multimodal_transformer_tpu_torch.ops.packed_conv import pack_width, packed_conv

# (f_in, f_out, stride, ci, co, H, Wp): the three packed stages of the stem
# ladder at f=8, tiny H/Wp (tests/test_fused_stem.py GEOMS)
GEOMS = {
    "block0": (8, 8, (1, 1), 1, 16, 13, 24),
    "block1": (4, 2, (2, 2), 32, 32, 13, 24),
    "block2": (2, 1, (2, 2), 64, 64, 14, 24),
}
# (f_in, f_out, stride, ci, co, H, Wp) at the flagship width (tools/bench_fused_block.py BLOCKS)
FLAGSHIP_BLOCKS = {
    "block0": (8, 8, (1, 1), 1, 16, 361, 552),
    "block1": (4, 2, (2, 2), 16, 32, 361, 1104),
    "block2": (2, 1, (2, 2), 32, 64, 181, 1104),
}
TOL = {np.float64: (1e-10, 1e-9), np.float32: (1e-5, 1e-5)}


@pytest.fixture(autouse=True)
def _x64():
    # scoped per test: a module-level flip would run the whole suite under x64
    with jax.enable_x64(True):
        yield


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / (float(np.abs(ref).max()) + 1e-30)


def _make(geom, p, dtype, seed=0):
    """(numpy x, w1..b3; JAX drop ctx; the same draw as torch tensors; kwargs)."""
    f_in, f_out, stride, ci, co, h, wp = geom
    rng = np.random.default_rng(seed)
    b = 2
    arrays = [rng.normal(size=(b, h, wp, f_in * ci)),
              rng.normal(size=(3, 3, ci, co)) * 0.3, rng.normal(size=(co,)) * 0.1,
              rng.normal(size=(3, 3, co, co)) * 0.2, rng.normal(size=(co,)) * 0.1,
              rng.normal(size=(3, 3, co, co)) * 0.2, rng.normal(size=(co,)) * 0.1]
    arrays = [a.astype(dtype) for a in arrays]
    jdrop = tdrop = None
    if p is not None:
        jdrop = j_drop_ctx(jax.random.PRNGKey(seed + 1), p, (b, h, wp, f_in * co), co, jnp.dtype(dtype))
        tdrop = {k: (torch.from_numpy(np.array(v)) if k in ("bits", "f_chan", "pos", "use_elem") else v)
                 for k, v in jdrop.items()}
    return arrays, jdrop, tdrop, dict(f_in=f_in, f_out=f_out, stride=stride)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("p", [None, 0.4])
@pytest.mark.parametrize("name", list(GEOMS))
def test_fused_block_forward_and_grads_match_jax(name, p, dtype):
    arrays, jdrop, tdrop, kw = _make(GEOMS[name], p, dtype)
    out_j, vjp = jax.vjp(lambda *a: j_fused(*a, drop=jdrop, **kw), *(jnp.asarray(a) for a in arrays))
    grads_j = vjp(jnp.cos(out_j))  # d sum(sin(out)) / d out
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fs.fused_packed_block(*ins, drop=tdrop, **kw)
    torch.sin(out).sum().backward()
    fwd_tol, grad_tol = TOL[dtype]
    assert out.shape == out_j.shape and out.dtype == ins[0].dtype
    assert _rel_err(out.detach().numpy(), out_j) <= fwd_tol
    for i, (t, gj) in enumerate(zip(ins, grads_j)):
        assert _rel_err(t.grad.numpy(), gj) <= grad_tol, (name, p, i)


def test_fused_block_ragged_height_tiles_match_jax():
    # H 13 in tiles of 4 (4, 4, 4, 1) in the JAX kernel
    arrays, jdrop, tdrop, kw = _make(GEOMS["block1"], 0.3, np.float64, seed=9)
    out_j = j_fused(*(jnp.asarray(a) for a in arrays), drop=jdrop, tile_h=4, **kw)
    out = fs.fused_packed_block(*(torch.from_numpy(a) for a in arrays), drop=tdrop, tile_h=4, **kw)
    assert _rel_err(out.numpy(), out_j) <= 1e-10


@pytest.mark.parametrize("bad, match", [
    (dict(f_out=4), "width stride"),
    (dict(stride=(3, 1)), "height stride"),
    (dict(conv_impl="dense"), "conv_impl"),
    (dict(w2=np.zeros((5, 5, 16, 16))), "3x3 kernels"),
])
def test_fused_block_rejects_bad_geometry(bad, match):
    bad = dict(bad)
    arrays, _, _, kw = _make(GEOMS["block0"], None, np.float64)
    names = ("x", "w1", "b1", "w2", "b2", "w3", "b3")
    args = dict(zip(names, arrays))
    for k in list(bad):
        if k in args:
            args[k] = bad.pop(k)
    kw.update(bad)
    with pytest.raises(ValueError, match=match):
        j_fused(*(jnp.asarray(args[n]) for n in names), **kw)
    with pytest.raises(ValueError, match=match):
        fs.fused_packed_block(*(torch.from_numpy(args[n]) for n in names), **kw)


@pytest.mark.parametrize("p", [None, 0.4])
@pytest.mark.parametrize("name", list(GEOMS))
def test_reference_block_matches_jax(name, p):
    arrays, jdrop, tdrop, kw = _make(GEOMS[name], p, np.float64, seed=3)
    out_j = j_reference(*(jnp.asarray(a) for a in arrays), drop=jdrop, **kw)
    out = fs.reference_block(*(torch.from_numpy(a) for a in arrays), drop=tdrop, **kw)
    assert _rel_err(out.numpy(), out_j) <= 1e-10


@pytest.mark.parametrize("p", [None, 0.4])
@pytest.mark.parametrize("name", list(GEOMS))
def test_plain_kernel_halves_compose_to_the_jax_block(name, p):
    """plain_k1 then plain_k2 (the functions K5a and K5b compute: statistics
    of the stored y2, the normalize before conv3's zero padding, site 3 on
    the corner of the draw) give the JAX reference block."""
    arrays, jdrop, tdrop, kw = _make(GEOMS[name], p, np.float64, seed=8)
    out_j = j_reference(*(jnp.asarray(a) for a in arrays), drop=jdrop, **kw)
    x, w1, b1, w2, b2, w3, b3 = (torch.from_numpy(a) for a in arrays)
    y2, stats = fs.plain_k1(x, w1, b1, w2, b2, f_in=kw["f_in"], drop=tdrop)
    mean_inv = fs.norm_from_stats(stats, x.shape[1] * x.shape[2] * kw["f_in"], 1e-3)
    out = fs.plain_k2(y2, mean_inv, w3, b3, drop=tdrop, **kw)
    assert _rel_err(out.numpy(), out_j) <= 1e-10


@pytest.mark.parametrize("mode", ["widened", "patched", "auto"])
@pytest.mark.parametrize("f_in, f_out, stride, ci, co", [(8, 8, (1, 1), 1, 16), (4, 2, (2, 2), 16, 32),
                                                        (2, 1, (2, 2), 32, 64)])
def test_packed_conv_matches_jax(f_in, f_out, stride, ci, co, mode):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, 6, f_in * ci))
    w, bias = rng.normal(size=(3, 3, ci, co)), rng.normal(size=(co,))
    y_j = j_packed_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), f_in, f_out, stride, mode=mode)
    y = packed_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), f_in, f_out, stride, mode=mode)
    assert y.shape == y_j.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("f_in, f_out, stride, wp, mode, match", [
    (2, 1, (1, 1), 8, "widened", "non-integral packed stride"),
    (1, 2, (1, 2), 8, "patched", "mode='patched'"),
    (1, 2, (1, 2), 9, "widened", "negative right pad"),
])
def test_packed_conv_geometry_errors_match_jax(f_in, f_out, stride, wp, mode, match):
    x, w, bias = np.zeros((1, 4, wp, f_in * 2)), np.zeros((3, 3, 2, 4)), np.zeros((4,))
    with pytest.raises(ValueError, match=match):
        j_packed_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), f_in, f_out, stride, mode=mode)
    with pytest.raises(ValueError, match=match):
        packed_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), f_in, f_out, stride, mode=mode)


@pytest.mark.parametrize("f", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_instance_norm_packed_matches_jax(f, masked):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 7, 12 // f, f * 8)) * 3 + 1).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones((2, 7, 12), bool)
        valid[1, 5:, :] = False
        valid[1, :, 9:] = False
    y_j = j_norm_packed(jnp.asarray(x), f, eps=1e-3, valid=None if valid is None else jnp.asarray(valid))
    y = instance_norm_packed(torch.from_numpy(x), f, eps=1e-3, valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(GEOMS))
def test_fused_block_equals_the_port_conv_block(name):
    f_in, f_out, stride, ci, co, h, wp = GEOMS[name]
    torch.manual_seed(6)
    block = ConvBlock(ci, co, stride).double()
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, h, wp * f_in, ci)))
    with torch.no_grad():
        ref = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # deterministic: no generator
        hwio = [t for c in (block.conv1, block.conv2, block.conv3) for t in (c.weight.permute(2, 3, 1, 0), c.bias)]
        out = fs.fused_packed_block(pack_width(x, f_in), *hwio, f_in=f_in, f_out=f_out, stride=stride)
    np.testing.assert_allclose(out.numpy(), pack_width(ref.contiguous(), f_out).numpy(), rtol=1e-10, atol=1e-10)


def test_make_drop_ctx_draws_the_jax_structure():
    g = torch.Generator().manual_seed(7)
    shape = (2, 5, 6, 4 * 8)
    drop = fs.make_drop_ctx(g, 0.5, shape, 8, torch.float32)
    j = j_drop_ctx(jax.random.PRNGKey(0), 0.5, shape, 8, jnp.float32)
    assert set(drop) == set(j)
    for k in ("bits", "f_chan", "pos", "use_elem"):
        assert tuple(drop[k].shape) == tuple(j[k].shape), k
        assert str(drop[k].dtype).split(".")[-1] == str(np.asarray(j[k]).dtype), k
    assert (drop["t"], drop["inv_e"]) == (j["t"], j["inv_e"])
    assert 1 <= int(drop["pos"]) <= 3 and int(drop["use_elem"]) in (0, 1)
    fc = drop["f_chan"].reshape(2, 4, 8)
    assert torch.equal(fc, fc[:, :1].expand_as(fc))  # one factor per original channel, tiled over slots
    assert set(fc.unique().tolist()) <= {0.0, float(np.float32(1 / 0.75))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FLAGSHIP_BLOCKS))
def test_default_kernel_tiles_fit_a_block(name, dtype):
    """The default launch of each kernel fits a block: float32 tiles two blocks an SM (a whole number of
    64-pixel x 16-channel tasks for each warp); the bf16 strip walk at dropout and none, with the blocks an
    SM its plan counts on (the SM's shared memory, each block's 1 KB included)."""
    f_in, f_out, (sh, sw), ci, co, h, wp = FLAGSHIP_BLOCKS[name]
    if dtype == torch.float32:
        (th, tw), (tho, two) = fs.f32_tiles(co, sh)
        assert fs._f32_k1_smem_bytes(ci, co, th, tw) <= fs.SMEM_MAX // 2  # two blocks per SM
        assert fs._f32_k2_smem_bytes(co, sh, sw, tho, two) <= fs.SMEM_MAX // 2
        assert th * tw * co == 8192 and tho * two * co == 4096
        return
    layout = cuda_build.host_library("fused_stem_layout")  # the kernels' layouts, built by the host compiler
    for has_drop in (True, False):
        for plan in (fs.k1_plan(8, h, wp * f_in, ci, co, has_drop, 132, layout=layout),
                     fs.k2_plan(8, h, wp * f_in, co, (sh, sw), f_out, has_drop, 132, layout=layout)):
            assert plan.smem <= fs.SMEM_MAX
            assert plan.blocks_per_sm * (plan.smem + 1024) <= 233472  # an SM's shared memory, 1 KB a block
            assert plan.blocks_per_sm * 160 <= 2048  # a block: a consumer warpgroup and its producer warp
