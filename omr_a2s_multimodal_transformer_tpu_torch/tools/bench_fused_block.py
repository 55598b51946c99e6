"""Per-block microbench: the fused stem block (kernels K5a and K5b) against
the plain block.

Port of ``tools/bench_fused_block.py``. Times ONE packed conv block of JAX's
``BLOCKS`` at flagship shapes (b8 361 x 4416), forward and forward +
backward, per implementation:
  plain — ``ops/fused_stem.py`` ``reference_block`` (packed_conv and the
          instance norm in PyTorch; JAX's ``xla`` column)
  fused — ``ops/fused_stem.py`` ``fused_packed_block``: K5a then K5b on the
          card; its backward is the vjp of ``reference_block`` recomputed
          from the saved inputs (JAX's ``fused(recompute)``)
with bf16 inputs and weights and positioned MixDropout at ``--dropout``
(0.5, the encoder's), its draws from ``make_drop_ctx``. The max |fused -
plain| of the forward is printed beside the times.

Timing is JAX's: ``--steps`` queued calls against one, each run to a value
read to the host, the best of 3; ms = (t_steps - t_1) / (steps - 1).
``--tile_h`` sets the kernels' rows a step (``fused_packed_block``'s
``tile_h``) and ``--conv_impl`` is checked and accepted (the TPU's layout).
On the CPU both columns run ``reference_block``. Runs on ``cuda`` unless
given ``--device cpu``:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.bench_fused_block [--b 8] [--steps 20]
"""

from __future__ import annotations

import argparse
import time
import zlib
from typing import Dict

import torch

BLOCKS = {
    # name: (f_in, f_out, stride, ci, co, H, Wp)  at flagship b8 361x4416
    "block0": (8, 8, (1, 1), 1, 16, 361, 552),
    "block1": (4, 2, (2, 2), 16, 32, 361, 1104),
    "block2": (2, 1, (2, 2), 32, 64, 181, 1104),
}


def block_inputs(name: str, b: int, dropout: float, dev, h: int = None, wp: int = None, dtype=torch.bfloat16):
    """x, the six weights and biases, and the dropout draws of one block (JAX's scales: w1 0.3, w2/w3 0.1;
    ``h``/``wp`` cut the shape for a small run)."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops.fused_stem import make_drop_ctx

    f_in, f_out, stride, ci, co, H, Wp = BLOCKS[name]
    H, Wp = h or H, wp or Wp
    g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    x = randn(b, H, Wp, f_in * ci)
    w = (randn(3, 3, ci, co, scale=0.3), torch.zeros(co, dtype=dtype, device=dev),
         randn(3, 3, co, co, scale=0.1), torch.zeros(co, dtype=dtype, device=dev),
         randn(3, 3, co, co, scale=0.1), torch.zeros(co, dtype=dtype, device=dev))
    drop = make_drop_ctx(g, dropout, (b, H, Wp, f_in * co), co, dtype) if dropout > 0 else None
    return x, w, drop, dict(f_in=f_in, f_out=f_out, stride=stride)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, steps: int, dev) -> float:
    """JAX's scheme: (best of 3 runs of ``steps`` calls - best of 3 of one) / (steps - 1), in ms."""
    fn()
    _sync(dev)

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        _sync(dev)
        return time.perf_counter() - t0

    run(2)
    t1 = min(run(1) for _ in range(3))
    tn = min(run(steps) for _ in range(3))
    return (tn - t1) / (steps - 1) * 1e3


def main(argv=None) -> Dict[str, dict]:
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
    from omr_a2s_multimodal_transformer_tpu_torch.ops.fused_stem import fused_packed_block, reference_block

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--blocks", nargs="+", default=list(BLOCKS))
    p.add_argument("--tile_h", type=int, default=None)
    p.add_argument("--conv_impl", default="widened", choices=["widened", "patched"],
                   help="the TPU kernel's layout: checked and accepted, the same kernels run")
    p.add_argument("--fwd_only", action="store_true")
    p.add_argument("--shape", type=int, nargs=2, default=None, metavar=("H", "WP"),
                   help="cut every block to H x WP (a small run)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for name in args.blocks:
        h, wp = args.shape or (None, None)
        x, w, drop, kw = block_inputs(name, args.b, args.dropout, dev, h, wp)

        def fwd_x():
            return reference_block(x, *w, drop=drop, **kw)

        def fwd_f():
            return fused_packed_block(x, *w, drop=drop, tile_h=args.tile_h, conv_impl=args.conv_impl, **kw)

        def grad(fused):
            def g():  # the gradients of sum(y^2) with respect to x and the six weights, as JAX's argnums=0
                ins = [t.detach().requires_grad_() for t in (x, *w)]
                y = fused_packed_block(*ins, drop=drop, tile_h=args.tile_h, conv_impl=args.conv_impl, **kw) \
                    if fused else reference_block(*ins, drop=drop, **kw)
                return torch.autograd.grad(torch.square(y.float()).sum(), ins)
            return g

        with torch.no_grad():
            err = float((fwd_f().float() - fwd_x().float()).abs().max())
            t_fx, t_ff = timeit(fwd_x, args.steps, dev), timeit(fwd_f, args.steps, dev)
        row = dict(fwd_plain_ms=t_fx, fwd_fused_ms=t_ff, max_abs_err=err)
        if args.fwd_only:
            print(f"{name}: fwd plain {t_fx:7.2f} ms | fused {t_ff:7.2f} ms "
                  f"({t_fx/t_ff:4.2f}x) | bf16 max|d| {err:.2e}", flush=True)
        else:
            t_gx, t_gf = timeit(grad(False), args.steps, dev), timeit(grad(True), args.steps, dev)
            row.update(fwdbwd_plain_ms=t_gx, fwdbwd_fused_ms=t_gf)
            print(f"{name}: fwd plain {t_fx:7.2f} ms | fused {t_ff:7.2f} ms ({t_fx/t_ff:4.2f}x)"
                  f" || fwd+bwd plain {t_gx:7.2f} ms | fused(recompute) {t_gf:7.2f} ms"
                  f" ({t_gx/t_gf:4.2f}x) | bf16 max|d| {err:.2e}", flush=True)
        out[name] = row
        del x, w, drop
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
