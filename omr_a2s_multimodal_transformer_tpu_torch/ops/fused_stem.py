"""Fused packed ConvBlock: the whole 3-conv stem block in two kernel passes.

Port of ``omr_a2s_multimodal_transformer_tpu/ops/fused_stem.py``. One
ConvBlock of the stem (conv1 + ReLU, conv2 + ReLU, instance norm, conv3 at
stride (sh, sw) + ReLU, positioned MixDropout at one of three sites) on a
width-packed input, in two passes that keep h1 and the normalized y2 out
of device memory:

  K5a (``csrc/fused_stem_k1.cu``): x -> conv1 -> conv2 -> y2, plus the
      per-(image, channel) sum and sum of squares of the stored y2.
  K5b (``csrc/fused_stem_k2.cu``): y2 -> normalize (mean/inv from those
      sums) -> conv3 -> out.

In bfloat16 both are persistent kernels for Hopper: a consumer warpgroup
walks a column strip (62 y2 / 64 output columns, one wgmma M) down a
segment of rows, carrying its halo rows in shared memory, fed by a TMA
ring; the products run on wgmma with the weights resident in shared
memory (``stem_weight_operand``). ``k1_plan``/``k2_plan`` cut the strips
and row segments from the SM count. They take the widths of the packed
stem's three blocks, ci 1, 16, 32 or 64 and co 16, 32 or 64 where the
layout fits a block (not ci 64 at co 64), and raise for others: at co 128
conv2's weights alone (295 KB) would not fit a block's shared memory.
float32 keeps tiles on the CUDA cores, the full-precision reference
route, at any co that is a multiple of 16 dividing 256.

Two routes, chosen by where the tensors lie:

- CUDA tensors go through ``FusedPackedBlock`` (a ``torch.autograd.Function``)
  whose forward launches K5a then K5b (float32 or bfloat16; any other dtype
  raises) and whose backward differentiates ``reference_block``, as the JAX
  ``bwd_rule`` takes the vjp of its reference in XLA (no backward kernel
  exists there either). There is no fallback: a kernel that does not build
  or launch raises.
- CPU tensors run ``reference_block``, the same function from
  ``packed_conv``, ``instance_norm_packed`` and the site factors, and
  autograd differentiates it.

The dropout draw is ``make_drop_ctx``'s: raw u8 bits, a per-channel factor
and the device scalars ``pos``/``use_elem``, fed to both routes, so both
apply the same masks. The kernels index the unpacked NHWC image (a packed
``[B, H, W/f, f*C]`` is ``[B, H, W, C]`` by a reshape) with the original
``[3, 3, ci, co]`` weights; the TPU's widened and patched weights exist to
fill 128-lane tiles and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build
from omr_a2s_multimodal_transformer_tpu_torch.ops.norm import instance_norm_packed
from omr_a2s_multimodal_transformer_tpu_torch.ops.packed_conv import packed_conv

__all__ = ["fused_packed_block", "reference_block", "make_drop_ctx"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
K1_THREADS, K5_CHANNEL_GROUP = 256, 16  # csrc/fused_stem_k1.cu, csrc/fused_stem_common.cuh OCB
SMEM_MAX = 232448  # dynamic shared memory a block may take on sm_90


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# --------------------------------------------------------------------- drop


def make_drop_ctx(generator: torch.Generator, p: float, shape12, c_orig: int, dtype=None) -> Dict:
    """Draw the positioned-MixDropout randomness of one block, as the JAX
    ``make_drop_ctx``: site ``pos`` in 1..3, a coin ``use_elem``, u8 bits
    for elementwise dropout (keep where bits < t, t = round((1-p)*256)) and
    a per-original-channel factor tiled over the packed slots. Draws come
    from ``generator`` on its device, so they differ from ``jax.random``.

    shape12 = (B, H, Wp, C) with C = f * c_orig. ``bits``, ``f_chan``,
    ``pos`` and ``use_elem`` are tensors on the generator's device; ``t``
    and ``inv_e`` are Python numbers. ``dtype`` is accepted as in JAX.
    """
    b, h, wp, c_rep = shape12
    f = c_rep // c_orig
    dev = generator.device
    pos = torch.randint(1, 4, (), generator=generator, device=dev, dtype=torch.int32)
    use_elem = (torch.rand((), generator=generator, device=dev) < 0.5).to(torch.int32)
    bits = torch.randint(0, 256, tuple(shape12), generator=generator, device=dev, dtype=torch.uint8)
    keep_c = torch.rand((b, c_orig), generator=generator, device=dev) < 1.0 - p / 2.0
    inv_c = float(torch.tensor(1.0 / (1.0 - p / 2.0), dtype=torch.float32))  # a float32 scale, as in JAX
    f_chan = (keep_c.to(torch.float32) * inv_c).repeat(1, f)  # [B, C]
    return {
        "bits": bits,
        "f_chan": f_chan,
        "pos": pos,
        "use_elem": use_elem,
        "t": int(round((1.0 - p) * 256.0)),
        "inv_e": float(1.0 / (1.0 - p)),
    }


def _site_factor(drop: Optional[Dict], site: int, bits: torch.Tensor, fchan: torch.Tensor, dtype):
    """Multiplicative factor of one dropout site from the raw draws: the
    drawn factor where pos == site, 1 elsewhere (JAX ``_site_factor``)."""
    if drop is None:
        return None
    t = drop["t"]
    keep = bits < t if t < 256 else torch.ones_like(bits, dtype=torch.bool)  # a u8 compare cannot hold 256
    f_elem = keep.to(dtype) * torch.tensor(drop["inv_e"], dtype=dtype, device=bits.device)
    fac = torch.where(drop["use_elem"] == 1, f_elem, fchan.to(dtype))
    return torch.where(drop["pos"] == site, fac, torch.ones((), dtype=dtype, device=bits.device))


# ----------------------------------------------------------- plain version


def _site_factors(drop: Optional[Dict], x: torch.Tensor, co: int, f_out: int, sh: int, sites=(1, 2, 3)):
    """The factors of the given sites: 1 and 2 at x's shape, 3 from the
    [:, :H3, :Wp, :f_out*co] corner of the draw; Nones without dropout."""
    if drop is None:
        return [None] * len(sites)
    h3, wp, c3 = _cdiv(x.shape[1], sh), x.shape[2], f_out * co
    fch = drop["f_chan"][:, None, None, :]
    corner = (drop["bits"][:, :h3, :wp, :c3], fch[..., :c3])
    return [_site_factor(drop, s, *(corner if s == 3 else (drop["bits"], fch)), x.dtype) for s in sites]


def _mul(v, f):
    return v if f is None else v * f


def _convs12(x, w1, b1, w2, b2, f_in, f1, f2):
    y = packed_conv(x, w1, b1, f_in, f_in, (1, 1))
    y = _mul(torch.relu(y), f1).to(x.dtype)
    y = packed_conv(y, w2, b2, f_in, f_in, (1, 1))
    return _mul(torch.relu(y), f2).to(x.dtype)


def _conv3(xh, w3, b3, f_in, f_out, stride, f3):
    return _mul(torch.relu(packed_conv(xh, w3, b3, f_in, f_out, stride)), f3).to(xh.dtype)


def reference_block(x: torch.Tensor, w1, b1, w2, b2, w3, b3, *, f_in: int, f_out: int,
                    stride: Tuple[int, int], drop: Optional[Dict] = None, eps: float = 1e-3) -> torch.Tensor:
    """Plain version of the fused block (JAX ``reference_block``):
    packed_conv, instance_norm_packed and the site factors from the same
    raw draws. x: [B, H, Wp, f_in*ci]; weights HWIO [3, 3, ci|co, co];
    returns [B, ceil(H/sh), Wp, f_out*co] in x's dtype."""
    f1, f2, f3 = _site_factors(drop, x, w1.shape[-1], f_out, stride[0])
    y2 = _convs12(x, w1, b1, w2, b2, f_in, f1, f2)
    return _conv3(instance_norm_packed(y2, f_in, eps=eps).to(x.dtype), w3, b3, f_in, f_out, stride, f3)


def plain_k1(x: torch.Tensor, w1, b1, w2, b2, *, f_in: int, drop: Optional[Dict] = None):
    """Plain version of K5a: (y2 [B, H, Wp, f_in*co] in x's dtype, stats
    [B, 2, co] in promote(x.dtype, float32): the sum and the sum of squares
    of y2 per image and original channel)."""
    f1, f2 = _site_factors(drop, x, w1.shape[-1], f_in, 1, sites=(1, 2))
    y2 = _convs12(x, w1, b1, w2, b2, f_in, f1, f2)
    b, h, wp, c = y2.shape
    y = y2.reshape(b, h * wp * f_in, c // f_in).to(torch.promote_types(y2.dtype, torch.float32))
    return y2, torch.stack([y.sum(1), y.square().sum(1)], dim=1)


def plain_k2(y2: torch.Tensor, mean_inv: torch.Tensor, w3, b3, *, f_in: int, f_out: int,
             stride: Tuple[int, int], drop: Optional[Dict] = None) -> torch.Tensor:
    """Plain version of K5b: (y2 - mean) * inv in promote(y2.dtype,
    float32), rounded to y2's dtype, then conv3 + bias + ReLU + site-3
    factor. mean_inv: [B, 2, co] (``norm_from_stats``)."""
    b, h, wp, c = y2.shape
    co = c // f_in
    (f3,) = _site_factors(drop, y2, co, f_out, stride[0], sites=(3,))
    mean, inv = (mean_inv[:, i].repeat(1, f_in)[:, None, None, :] for i in (0, 1))
    xh = ((y2.to(mean.dtype) - mean) * inv).to(y2.dtype)
    return _conv3(xh, w3, b3, f_in, f_out, stride, f3)


def norm_from_stats(stats: torch.Tensor, n: int, eps: float) -> torch.Tensor:
    """[B, 2, co] (mean, 1/sqrt(var + eps)) from K5a's sums over n pixels,
    as the JAX driver (:559-563)."""
    mean = stats[:, 0] / n
    var = (stats[:, 1] / n - mean * mean).clamp_min(0.0)
    return torch.stack([mean, torch.rsqrt(var + eps)], dim=1)


# ------------------------------------------------------------------ kernels

K1_ROWS = {16: 4, 32: 4, 64: 2}  # default x rows a K5a stage (tile_h), by co
K2_ROWS = {16: 4, 32: 1, 64: 1}  # default output rows a K5b stage, by co (a stage holds 2 or more y2 rows)
F32_TILES = {16: ((16, 32), (8, 32)), 32: ((8, 32), (8, 16))}  # float32 CUDA-core tiles by co; else ((8, 16), (4, 16))


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


class StemPlan(NamedTuple):
    """How a persistent stem kernel walks its output: `rows` a stage of its TMA ring (K5a: x rows, from which it
    makes as many y2 rows; K5b: y2 rows, sh of them for each out row), `smem` bytes of shared memory a block,
    `grid` blocks of one consumer warpgroup each (blocks_per_sm resident on each SM), n_strips column strips an
    image, segments of seg_len rows (n_seg an image); a unit is (image, segment, strip). The shared memory, the
    blocks an SM holds, the strip and the rows a stage takes come from the kernels' own layout
    (csrc/fused_stem_layout.h)."""
    rows: int
    smem: int
    blocks_per_sm: int
    grid: int
    n_strips: int
    seg_len: int
    n_seg: int


@functools.lru_cache(maxsize=None)
def segment_rows(n_rows: int, units_per_row: int, blocks: int) -> int:
    """Rows a segment takes so that units = units_per_row * segments spread evenly over the blocks: the
    fewest segments among those of least cost, where a block's cost is its units times the rows of one
    plus 1 (each segment recomputes its first halo rows)."""
    best = None
    for n in range(1, n_rows + 1):
        seg = _cdiv(n_rows, n)
        cost = _cdiv(units_per_row * _cdiv(n_rows, seg), blocks) * (seg + 1)
        if best is None or cost < best[0]:
            best = (cost, seg)
    return best[1]


_FIT_WIDTHS, _FIT_ROWS, _FIT_SMEM = 1, 2, 3  # csrc/fused_stem_layout.h STEM_FIT_*


def _fit(fn, args, kernel: str, widths: str, rows: int, unit: str) -> Tuple[int, int, int]:
    """(shared memory, blocks an SM, strip) of a bf16 launch from the layout's fit function `fn`
    (csrc/fused_stem_layout.h); raises for what the kernel does not take."""
    out = (ctypes.c_int * 5)()
    err = fn(*(ctypes.c_int(int(a)) for a in args), out)
    smem, bpsm, strip, lo, hi = out
    if err == _FIT_WIDTHS:
        raise ValueError(f"the bf16 {kernel} does not take {widths}")
    if err == _FIT_ROWS:
        raise ValueError(f"{kernel} takes {lo} to {hi} {unit} a stage; got {rows}")
    if err == _FIT_SMEM:
        raise ValueError(f"{rows} {unit} a stage at {widths} need {smem} bytes of shared memory; a block has "
                         f"{SMEM_MAX}")
    if err:
        raise ValueError(f"{kernel}: unknown fit error {err}")
    return smem, bpsm, strip


def _plan(n_rows, strips, b, rows, smem, bpsm, n_sm, n_blocks) -> StemPlan:
    if n_blocks is not None and int(n_blocks) < 1:
        raise ValueError(f"n_blocks must be at least 1, got {n_blocks}")
    grid = int(n_blocks) if n_blocks is not None else n_sm * bpsm
    seg = segment_rows(n_rows, b * strips, grid)
    n_seg = _cdiv(n_rows, seg)
    return StemPlan(rows, smem, bpsm, min(grid, b * strips * n_seg), strips, seg, n_seg)


def k1_plan(b: int, h: int, w: int, ci: int, co: int, has_drop: bool, n_sm: int, tile_h: Optional[int] = None,
            n_blocks: Optional[int] = None, layout=None) -> StemPlan:
    """The bf16 K5a launch for y2 [b, h, w, co] (unpacked): tile_h x rows a stage (K1_ROWS by default), strips
    and segments cut from the SM count n_sm (or n_blocks blocks). ``layout``: a library with the kernels'
    layout functions (K5a's own by default; ``cuda_build.host_library("fused_stem_layout")`` without nvcc).
    Raises for what the kernel does not take."""
    layout = layout or cuda_build.library("fused_stem_k1")
    rows = K1_ROWS.get(co, 1) if tile_h is None else int(tile_h)
    smem, bpsm, strip = _fit(layout.fused_stem_k1_fit, (ci, co, rows, has_drop), "K5a", f"ci {ci}, co {co}",
                             rows, "x rows")
    return _plan(h, _cdiv(w, strip), b, rows, smem, bpsm, n_sm, n_blocks)


def k2_plan(b: int, h: int, w: int, co: int, stride: Tuple[int, int], f_out: int, has_drop: bool, n_sm: int,
            tile_h: Optional[int] = None, n_blocks: Optional[int] = None, layout=None) -> StemPlan:
    """The bf16 K5b launch for y2 [b, h, w, co] (unpacked) at stride (sh, sw): tile_h output rows a stage (a
    stage holds sh x tile_h y2 rows; by default K2_ROWS, or more to make the 2 y2 rows a stage holds at
    least), strips and segments of output rows cut from the SM count; ``layout`` as in ``k1_plan``. Raises
    for what the kernel does not take."""
    sh, sw = stride
    layout = layout or cuda_build.library("fused_stem_k2")
    tho = max(K2_ROWS.get(co, 1), _cdiv(2, sh)) if tile_h is None else int(tile_h)
    smem, bpsm, strip = _fit(layout.fused_stem_k2_fit, (co, sh, sw, f_out, tho * sh, has_drop), "K5b",
                             f"co {co}, stride {tuple(stride)}, f_out {f_out}", tho * sh, "y2 rows")
    return _plan(_cdiv(h, sh), _cdiv(w // sw, strip), b, tho * sh, smem, bpsm, n_sm, n_blocks)


def f32_tiles(co: int, sh: int, tile_h: Optional[int] = None) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((th, tw), (tho, two)): the y2 tile of a float32 K5a block and the output tile of a float32 K5b block,
    in unpacked pixels (8192 and 4096 outputs, a whole number of 64-pixel x 16-channel tasks for each warp);
    tile_h sets th, and tho = max(1, th // sh), as the TPU kernel's tile height does."""
    (th, tw), (tho, two) = F32_TILES.get(co, ((8, 16), (4, 16)))
    if tile_h is not None:
        th, tho = int(tile_h), max(1, int(tile_h) // sh)
    return (th, tw), (tho, two)


def _f32_k1_smem_bytes(ci: int, co: int, th: int, tw: int) -> int:
    """Dynamic shared memory of a float32 K5a block (csrc/fused_stem_k1.cu k1_smem_bytes)."""
    x_floats = (th + 4) * (tw + 4) * (ci | 1)
    return (max(x_floats, th * tw * co) + (th + 2) * (tw + 2) * (co | 1) + 2 * K1_THREADS) * 4


def _f32_k2_smem_bytes(co: int, sh: int, sw: int, tho: int, two: int) -> int:
    return ((tho - 1) * sh + 3) * ((two - 1) * sw + 3) * (co | 1) * 4


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_cuda(name: str, t: torch.Tensor, device, dtype=None, shape=None):
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, the block's input on {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _drop_args(drop: Optional[Dict], b: int, h: int, wp: int, c: int, co: int, device):
    """(bits, f_chan [B, co], scal int32 [pos, use_elem], t, inv_e) for a
    launch, all on ``device`` (no host sync); Nones without dropout."""
    if drop is None:
        return None, None, None, 256, 1.0
    _check_cuda("bits", drop["bits"], device, torch.uint8, (b, h, wp, c))
    _check_cuda("f_chan", drop["f_chan"], device, shape=(b, c))
    for key in ("pos", "use_elem"):
        _check_cuda(key, drop[key], device)
    scal = torch.stack([drop["pos"].reshape(()), drop["use_elem"].reshape(())]).to(torch.int32)
    return (drop["bits"].contiguous(), drop["f_chan"][:, :co].to(torch.float32).contiguous(), scal,
            int(drop["t"]), float(drop["inv_e"]))


def _dtype_code(x: torch.Tensor) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"the fused stem kernels take CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the fused stem kernels take float32 or bfloat16, got {x.dtype}")
    return _DTYPE_CODE[x.dtype]


def _ptrs(*tensors):
    """Device pointers for a launch (None for an absent tensor); the kernels
    read 16-byte vectors, so every tensor must start on a 16-byte boundary."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the fused stem kernels take tensors that start on a 16-byte boundary")
    return [None if t is None else t.data_ptr() for t in tensors]


def stem_weight_operand(w: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, cin, co] -> [K / 16, 2, co, 8]: the B operand of the bf16
    kernels' wgmma products, K-major without swizzle. K index k = tap * cin
    + c (tap = 3 dy + dx; cin == 1 pads K from 9 to 16 with zeros); entry
    [s, h, n, e] is w at k = 16 s + 8 h + e, column n. A 16-deep k step is
    then 8-row core matrices of 16 bytes (co rows n, 8 k each), the two
    8-deep halves co * 16 bytes apart."""
    cin, co = w.shape[2], w.shape[3]
    wk = w.reshape(9 * cin, co)
    if cin == 1:
        wk = torch.cat([wk, wk.new_zeros(7, co)])
    return wk.reshape(-1, 2, 8, co).permute(0, 1, 3, 2).contiguous()


def fused_stem_k1_cuda(x, w1, b1, w2, b2, drop: Optional[Dict], *, f_in: int, tile: Optional[int] = None,
                       n_blocks: Optional[int] = None):
    """Launch K5a. x [B, H, Wp, f_in*ci] (CUDA; float32 runs on the CUDA
    cores, bfloat16 on the persistent TMA/wgmma kernel, which takes ci 1,
    16, 32 or 64 and co 16, 32 or 64), weights HWIO in x's dtype, ``drop``
    from ``make_drop_ctx`` or None. ``tile``: the y2 rows a block makes a
    step, the TPU kernel's tile height: float32, the height of its tile;
    bf16, the x rows of one stage of its TMA ring (``k1_plan``), from which
    it makes as many y2 rows. ``n_blocks`` sets the bf16 kernel's block
    count (for measuring). Returns (y2 [B, H, Wp, f_in*co] in x's dtype,
    stats float32 [B, 2, co]: the sum and the sum of squares of y2 per
    image and channel, added in a fixed order)."""
    code = _dtype_code(x)
    b, h, wp, cin = x.shape
    ci, co = w1.shape[2], w1.shape[3]
    if cin != f_in * ci or co % K5_CHANNEL_GROUP or K1_THREADS % co:
        raise ValueError(f"K5a takes x [B, H, Wp, f_in*ci] and co a multiple of 16 dividing 256; "
                         f"got x {tuple(x.shape)}, f_in {f_in}, w1 {tuple(w1.shape)}")
    for name, t, shape in (("w1", w1, (3, 3, ci, co)), ("b1", b1, (co,)), ("w2", w2, (3, 3, co, co)),
                           ("b2", b2, (co,))):
        _check_cuda(name, t, x.device, x.dtype, shape)
    w = wp * f_in
    if code == 1:
        plan = k1_plan(b, h, w, ci, co, drop is not None, _sm_count(x.device.index or 0), tile, n_blocks)
        rows, tw, n_tiles = plan.rows, 0, plan.n_seg * plan.n_strips
        w1op, w2op = stem_weight_operand(w1), stem_weight_operand(w2)
        launch = (plan.grid, plan.seg_len)
        if ci == 1 and w % 8:  # the kernel's map of x at ci 1 takes rows of a multiple of 8 pixels (16 bytes)
            x = torch.nn.functional.pad(x.reshape(b, h, w), (0, _align(w, 8) - w))
    else:
        (rows, tw), _ = f32_tiles(co, 1, tile)
        if _f32_k1_smem_bytes(ci, co, rows, tw) > SMEM_MAX:
            raise ValueError(f"K5a tile {rows}x{tw} at ci {ci}, co {co} needs more shared memory than a block has")
        n_tiles, w1op, w2op, launch = _cdiv(h, rows) * _cdiv(w, tw), None, None, (0, 0)
    bits, fchan, scal, t_keep, inv_e = _drop_args(drop, b, h, wp, f_in * co, co, x.device)
    x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
    y2 = torch.empty((b, h, wp, f_in * co), device=x.device, dtype=x.dtype)
    partial = torch.empty((b, n_tiles, 2, co), device=x.device, dtype=torch.float32)
    stats = torch.empty((b, 2, co), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = cuda_build.launch("fused_stem_k1", x.device,
                            *_ptrs(x, bits, fchan, scal, w1, w1op, b1, w2, w2op, b2, y2, partial, stats), code,
                            int(drop is not None), b, h, w, ci, co, rows, tw, *launch, t_keep, inv_e, stream)
    if err != 0:
        raise RuntimeError(f"fused_stem_k1 launch failed: cudaError {err}")
    fused_stem_k1_cuda.launches += 1
    return y2, stats


fused_stem_k1_cuda.launches = 0


def fused_stem_k2_cuda(y2, mean_inv, w3, b3, drop: Optional[Dict], *, f_in: int, f_out: int,
                       stride: Tuple[int, int], tile: Optional[int] = None, n_blocks: Optional[int] = None):
    """Launch K5b. y2 [B, H, Wp, f_in*co] from K5a (float32 on the CUDA
    cores, bfloat16 on the persistent TMA/wgmma kernel), mean_inv float32
    [B, 2, co] (``norm_from_stats``), w3 HWIO and b3 in y2's dtype.
    The bf16 kernel takes co 16, 32 or 64 and strides 1 or 2. ``tile``:
    the output rows a block makes a step (float32: the height of its tile;
    bf16: from one stage of its TMA ring, which holds sh x tile y2 rows,
    ``k2_plan``); ``n_blocks`` as in ``fused_stem_k1_cuda``.
    Returns out [B, ceil(H/sh), Wp, f_out*co] in y2's dtype."""
    code = _dtype_code(y2)
    sh, sw = stride
    b, h, wp, c = y2.shape
    co = w3.shape[-1]
    if c != f_in * co or co % K5_CHANNEL_GROUP or f_out * sw != f_in:
        raise ValueError(f"K5b takes y2 [B, H, Wp, f_in*co], co a multiple of 16 and f_out*sw == f_in; "
                         f"got y2 {tuple(y2.shape)}, w3 {tuple(w3.shape)}, f_in {f_in}, f_out {f_out}, sw {sw}")
    _check_cuda("w3", w3, y2.device, y2.dtype, (3, 3, co, co))
    _check_cuda("b3", b3, y2.device, y2.dtype, (co,))
    _check_cuda("mean_inv", mean_inv, y2.device, torch.float32, (b, 2, co))
    w = wp * f_in
    if code == 1:
        plan = k2_plan(b, h, w, co, (sh, sw), f_out, drop is not None, _sm_count(y2.device.index or 0), tile,
                       n_blocks)
        rows, two, w3op, launch = plan.rows, 0, stem_weight_operand(w3), (plan.grid, plan.seg_len)
    else:
        _, (rows, two) = f32_tiles(co, sh)
        rows = rows if tile is None else int(tile)
        if _f32_k2_smem_bytes(co, sh, sw, rows, two) > SMEM_MAX:
            raise ValueError(f"K5b tile {rows}x{two} at co {co} needs more shared memory than a block has")
        w3op, launch = None, (0, 0)
    bits, fchan, scal, t_keep, inv_e = _drop_args(drop, b, h, wp, c, co, y2.device)
    y2, mean_inv, w3, b3 = (t.contiguous() for t in (y2, mean_inv, w3, b3))
    out = torch.empty((b, _cdiv(h, sh), wp, f_out * co), device=y2.device, dtype=y2.dtype)
    stream = torch.cuda.current_stream(y2.device).cuda_stream
    err = cuda_build.launch("fused_stem_k2", y2.device, *_ptrs(y2, mean_inv, bits, fchan, scal, w3, w3op, b3, out),
                            code, int(drop is not None), b, h, w, co, sh, sw, f_in, f_out, rows, two, *launch, t_keep,
                            inv_e, stream)
    if err != 0:
        raise RuntimeError(f"fused_stem_k2 launch failed: cudaError {err}")
    fused_stem_k2_cuda.launches += 1
    return out


fused_stem_k2_cuda.launches = 0


# ------------------------------------------------------------------ autograd


_DROP_KEYS = ("bits", "f_chan", "pos", "use_elem")


class FusedPackedBlock(torch.autograd.Function):
    """K5a then K5b forward; backward: the vjp of ``reference_block``
    recomputed from the saved inputs (the JAX ``bwd_rule``). The draws get
    no gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, bits, f_chan, pos, use_elem, cfg):
        f_in, f_out, stride, eps, t, inv_e, tile_h = cfg
        drop = None if bits is None else dict(bits=bits, f_chan=f_chan, pos=pos, use_elem=use_elem, t=t,
                                              inv_e=inv_e)
        k2_tile = None if tile_h is None else max(1, tile_h // stride[0])
        y2, stats = fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in, tile=tile_h)
        mean_inv = norm_from_stats(stats, x.shape[1] * x.shape[2] * f_in, eps)
        out = fused_stem_k2_cuda(y2, mean_inv, w3, b3, drop, f_in=f_in, f_out=f_out, stride=stride, tile=k2_tile)
        ctx.save_for_backward(x, w1, b1, w2, b2, w3, b3)
        ctx.drop = drop
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        f_in, f_out, stride, eps, *_ = ctx.cfg
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = reference_block(*ins, f_in=f_in, f_out=f_out, stride=stride, drop=ctx.drop, eps=eps)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None, None, None, None)


def fused_packed_block(x: torch.Tensor, w1, b1, w2, b2, w3, b3, *, f_in: int, f_out: int,
                       stride: Tuple[int, int], drop: Optional[Dict] = None, eps: float = 1e-3,
                       tile_h: Optional[int] = None, conv_impl: Optional[str] = None) -> torch.Tensor:
    """Fused packed ConvBlock forward, differentiable in x and the weights.

    x: [B, H, Wp, f_in*ci]; w1 [3, 3, ci, co], w2/w3 [3, 3, co, co] (HWIO),
    biases [co]; returns [B, ceil(H/sh), Wp, f_out*co]. ``drop`` from
    ``make_drop_ctx`` (None = deterministic). ``conv_impl`` ('widened' or
    'patched') picks the TPU layout in JAX and is checked and accepted
    here. ``tile_h`` sets the rows a kernel makes a step, as the TPU
    kernels' tile height: K5a's y2 rows, and K5b's ``max(1, tile_h // sh)``
    out rows (in bf16 a step is one stage of the kernel's TMA ring; see
    ``fused_stem_k1_cuda``); a value a kernel cannot take raises. CUDA
    tensors launch K5a and K5b (float32 or bfloat16, in the promoted dtype
    of x and w1; the bf16 kernels take the widths of the packed stem's
    blocks, ci 1, 16, 32 or 64 and co 16, 32 or 64, and raise for
    others); CPU tensors run ``reference_block``.
    """
    sh, sw = stride
    if f_out * sw != f_in:
        raise ValueError(
            f"fused_packed_block needs packed-space width stride 1 "
            f"(f_out*sw == f_in); got f_in={f_in} f_out={f_out} sw={sw}"
        )
    if sh not in (1, 2):
        raise ValueError(f"height stride must be 1 or 2, got {sh}")
    if conv_impl is None:
        conv_impl = "widened"
    if conv_impl not in ("widened", "patched"):
        raise ValueError(f"conv_impl must be 'widened' or 'patched', got {conv_impl!r}")
    for name, w in (("w1", w1), ("w2", w2), ("w3", w3)):
        if tuple(w.shape[:2]) != (3, 3):
            raise ValueError(f"fused_packed_block requires 3x3 kernels; {name} is {tuple(w.shape[:2])}")
    kw = dict(f_in=f_in, f_out=f_out, stride=(sh, sw), drop=drop, eps=eps)
    if x.device.type == "cpu":
        return reference_block(x, w1, b1, w2, b2, w3, b3, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_packed_block runs on CPU or CUDA tensors, got {x.device}")
    dt = torch.promote_types(x.dtype, w1.dtype)
    args = [t.to(dt) for t in (x, w1, b1, w2, b2, w3, b3)]
    draws = [None] * 4 if drop is None else [drop[k] for k in _DROP_KEYS]
    cfg = (f_in, f_out, (sh, sw), float(eps), None if drop is None else int(drop["t"]),
           None if drop is None else float(drop["inv_e"]), tile_h)
    return FusedPackedBlock.apply(*args, *draws, cfg)
