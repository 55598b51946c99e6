"""What the fused stem wrappers compute for the bf16 kernels, on the CPU.

- ``stem_weight_operand``: the weights as the kernels' wgmma B operand,
  rebuilt into HWIO by the PTX layout of a K-major operand without swizzle
  (core matrices of 8 rows x 16 bytes, the two 8-deep halves of a k step
  16 co bytes apart, 8-row groups 128 bytes apart), at the flagship widths
  and block0's padded ci 1 (K 9 -> 16).
- ``k1_plan``/``k2_plan``: strips and row segments cut from the SM count
  at the three flagship blocks and at a small ragged shape; forced block
  counts; default rows a stage that every stride takes; what the kernels
  do not take raises.
- ``fused_stem_site3_map``: the 5-D map whose boxes are K5b's site-3
  bits, the corner ``bits[:, :H3, :, :f_out * co]`` of the packed draw.

The plans' shared memory, blocks an SM, strips and rows a stage, and the
site-3 map, come from the kernels' own code (csrc/fused_stem_layout.h),
built here by the host's C++ compiler (``cuda_build.host_library``). The
kernels themselves run on the card (tests/test_torch_port_cuda.py,
chip_smoke.py).
"""

import ctypes

import pytest
import torch

from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build
from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs

# (f_in, f_out, stride, ci, co, H, Wp) at the flagship width (tools/bench_fused_block.py BLOCKS)
FLAGSHIP_BLOCKS = {
    "block0": (8, 8, (1, 1), 1, 16, 361, 552),
    "block1": (4, 2, (2, 2), 16, 32, 361, 1104),
    "block2": (2, 1, (2, 2), 32, 64, 181, 1104),
}
N_SM = 132  # H100 SXM


def _layout():
    """The kernels' layout functions, built by the host compiler on first use."""
    return cuda_build.host_library("fused_stem_layout")


@pytest.mark.parametrize("cin, co", [(16, 16), (16, 32), (32, 64), (1, 16)])
def test_weight_operand_follows_the_wgmma_b_layout(cin, co):
    w = torch.randn(3, 3, cin, co)
    op = fs.stem_weight_operand(w)
    k_steps = 1 if cin == 1 else 9 * cin // 16
    assert op.shape == (k_steps, 2, co, 8) and op.is_contiguous()
    assert op.numel() * 2 == k_steps * 32 * co  # weight_bytes in csrc/fused_stem_layout.h
    flat = op.reshape(k_steps, 16 * co)  # one k step: 32 co bytes
    lbo, sbo = 16 * co, 128  # bytes between the 8-deep halves; between groups of 8 rows (n)
    rebuilt = torch.zeros(16 * k_steps, co)
    for k in range(16):
        for n in range(co):
            byte = (k // 8) * lbo + (n // 8) * sbo + (n % 8) * 16 + (k % 8) * 2
            rebuilt[k::16, n] = flat[:, byte // 2]
    assert torch.equal(rebuilt[:9 * cin], w.reshape(9 * cin, co))  # k = (3 dy + dx) * cin + c
    assert not rebuilt[9 * cin:].any()  # ci 1: taps 9..15 are zero


def _check_plan(plan, n_rows, units_per_row):
    assert (plan.n_seg - 1) * plan.seg_len < n_rows <= plan.n_seg * plan.seg_len
    units = units_per_row * plan.n_seg
    assert 1 <= plan.grid <= units
    waves = -(-units // plan.grid)
    # useful rows over the blocks' rows, each segment's first halo row counted as work
    return units_per_row * n_rows / (waves * plan.grid * (plan.seg_len + 1)), waves


@pytest.mark.parametrize("name", list(FLAGSHIP_BLOCKS))
def test_strip_and_segment_chooser_at_the_flagship_blocks(name):
    """Segments fill the consumers: at least 85% of their rows are useful (strips alone leave 2.1-4.2
    waves, 54-75%), and the chooser does no worse than one segment an image."""
    f_in, f_out, stride, ci, co, h, wp = FLAGSHIP_BLOCKS[name]
    w = wp * f_in
    k1 = fs.k1_plan(8, h, w, ci, co, True, N_SM, layout=_layout())
    k2 = fs.k2_plan(8, h, w, co, stride, f_out, True, N_SM, layout=_layout())
    assert k1.n_strips == -(-w // 62) and k2.n_strips == -(-(w // stride[1]) // 64)  # y2 / out columns a strip
    assert k1.grid == N_SM * k1.blocks_per_sm and k2.grid == N_SM * k2.blocks_per_sm
    for plan, n_rows in ((k1, h), (k2, -(-h // stride[0]))):
        eff, _ = _check_plan(plan, n_rows, 8 * plan.n_strips)
        one = 8 * plan.n_strips * n_rows / (-(-8 * plan.n_strips // plan.grid) * plan.grid * (n_rows + 1))
        assert eff >= max(0.85, one), (name, plan, eff, one)


def test_strip_and_segment_chooser_at_a_ragged_shape_and_forced_block_counts():
    # block1's geometry at b2, H 17, W 44 (one ragged strip, odd H at stride 2)
    k1 = fs.k1_plan(2, 17, 44, 16, 32, True, N_SM, layout=_layout())
    assert (k1.n_strips, k1.seg_len, k1.n_seg) == (1, 1, 17) and k1.grid == 34  # one row a consumer
    k2 = fs.k2_plan(2, 17, 44, 32, (2, 2), 2, True, N_SM, layout=_layout())
    assert (k2.n_strips, k2.n_seg * k2.seg_len >= 9) == (1, True)
    # fewer blocks than strips: each block walks several units (and resets its carry at each)
    for n_blocks in (1, 3):
        plan = fs.k1_plan(8, 361, 4416, 16, 32, True, N_SM, n_blocks=n_blocks, layout=_layout())
        assert plan.grid == n_blocks and plan.n_strips == 72
        eff, waves = _check_plan(plan, 361, 8 * 72)
        assert waves >= 72 * 8 // n_blocks


@pytest.mark.parametrize("ci, co", [(1, 16), (16, 32), (32, 64), (16, 16), (64, 32)])
@pytest.mark.parametrize("sh", [1, 2])
def test_default_rows_a_stage_are_taken_at_every_stride(ci, co, sh):
    """Each kernel's default launch (tile_h None) is one it takes, at stride 1 and 2: K5b's stage holds
    2 y2 rows at least, also where its default out rows a stage are 1."""
    k1 = fs.k1_plan(8, 64, 4416, ci, co, True, N_SM, layout=_layout())
    k2 = fs.k2_plan(8, 64, 4416, co, (sh, sh), 1, True, N_SM, layout=_layout())
    assert k1.rows == fs.K1_ROWS[co] and k2.rows >= 2 and k2.rows % sh == 0
    assert k2.rows == sh * max(fs.K2_ROWS[co], -(-2 // sh))


@pytest.mark.parametrize("w", [4412, 44, 9])
def test_k1_plan_takes_a_width_that_is_not_a_multiple_of_8_at_ci_1(w):
    """At ci 1 the wrapper pads x's rows to a multiple of 8 pixels for the kernel's map; the plan takes any
    width."""
    plan = fs.k1_plan(2, 13, w, 1, 16, True, N_SM, layout=_layout())
    assert plan.n_strips == -(-w // 62)


@pytest.mark.parametrize("call, match", [
    (lambda: fs.k1_plan(8, 361, 4416, 16, 48, True, N_SM, layout=_layout()), "does not take ci 16, co 48"),
    (lambda: fs.k1_plan(8, 361, 4416, 8, 32, True, N_SM, layout=_layout()), "does not take ci 8, co 32"),
    (lambda: fs.k1_plan(8, 46, 552, 128, 128, True, N_SM, layout=_layout()), "does not take ci 128, co 128"),
    (lambda: fs.k2_plan(8, 361, 4416, 16, (1, 1), 8, True, N_SM, tile_h=1, layout=_layout()), "2 to 16 y2 rows"),
    (lambda: fs.k1_plan(8, 361, 4416, 16, 32, True, N_SM, tile_h=9, layout=_layout()), "1 to 8 x rows"),
    (lambda: fs.k1_plan(8, 181, 2208, 32, 64, True, N_SM, tile_h=8, layout=_layout()), "shared memory"),
    (lambda: fs.k1_plan(8, 181, 2208, 32, 64, True, N_SM, tile_h=4, layout=_layout()), "shared memory"),
    (lambda: fs.k1_plan(8, 91, 1104, 64, 64, True, N_SM, tile_h=1, layout=_layout()), "shared memory"),
    (lambda: fs.k1_plan(8, 361, 4416, 16, 32, True, N_SM, n_blocks=0, layout=_layout()), "at least 1"),
    (lambda: fs.k2_plan(8, 361, 4416, 32, (2, 4), 1, True, N_SM, layout=_layout()), "does not take"),
    (lambda: fs.k2_plan(8, 181, 2208, 64, (2, 2), 1, True, N_SM, tile_h=4, layout=_layout()), "shared memory"),
])
def test_plans_raise_for_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def _site3_map(b, h, wp, f_in, f_out, co):
    dims, strides, box = (ctypes.c_uint64 * 5)(), (ctypes.c_uint64 * 4)(), (ctypes.c_uint32 * 5)()
    _layout().fused_stem_site3_map(*(ctypes.c_int(v) for v in (b, h, wp, f_in, f_out, co)), dims, strides, box)
    return tuple(dims), tuple(strides), tuple(box)


@pytest.mark.parametrize("name", list(FLAGSHIP_BLOCKS))
def test_site3_bits_corner_is_a_box_of_the_5d_map(name):
    """The map K5b's launcher encodes (csrc/fused_stem_layout.h fused_stem_site3_map) over the packed draw."""
    f_in, f_out, (sh, sw), _, co, _, _ = FLAGSHIP_BLOCKS[name]
    b, h, wp = 2, 7, 16
    h3 = -(-h // sh)
    bits = torch.randint(0, 256, (b, h, wp, f_in * co), dtype=torch.uint8)
    dims, strides, box = _site3_map(b, h, wp, f_in, f_out, co)
    assert dims == (co, f_in, wp, h, b) and box == (co, f_out, 64 // f_out, 1, 1)
    assert strides[0] == dims[0] and all(s % 16 == 0 for s in strides)  # u8: byte strides, TMA's 16-byte rule
    view = torch.as_strided(bits, size=dims[::-1], stride=(*strides[::-1], 1))  # [B, H, Wp, f_in, co]
    corner = view[:, :h3, :, :f_out, :].reshape(b, h3, wp, f_out * co)
    assert torch.equal(corner, bits[:, :h3, :, :f_out * co])
    # a box at packed column p0 is [64 output columns][co]: output column ox = p0 f_out + m takes unpacked
    # input column (ox // f_out) f_in + ox % f_out
    unpacked = bits.reshape(b, h, wp * f_in, co)
    p0, n_p = 1, min(box[2], wp - 1)
    tile = view[1, 3, p0:p0 + n_p, :box[1], :box[0]].reshape(n_p * f_out, co)
    for m in range(n_p * f_out):
        ox = p0 * f_out + m
        assert torch.equal(tile[m], unpacked[1, 3, (ox // f_out) * f_in + ox % f_out])
