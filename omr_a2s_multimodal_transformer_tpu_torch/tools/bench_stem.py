"""Conv-stem microbench: the encoder stem's train-time cost (forward and
backward, the stem alone) at flagship image shapes, per ``--modes`` entry.

Port of ``tools/bench_stem.py``. JAX times its three stem layouts:
``unpacked`` (plain convolutions, with remat to fit b8), and the
lane-packed ``widened`` and ``patched`` kernels. In the port all three run
the same plain convolutions (``ops/packed_conv.py``: a packed layout is a
relabeling of the same convolution, and ``packed_stem`` changes nothing in
``ConvStemEncoder``); ``unpacked`` keeps JAX's remat. The tool times them
anyway, so that a later stem change has its parent's numbers.

Each mode: ``models/encoder.py`` ``ConvStemEncoder`` (dropout 0.5, drawn
from a generator, as JAX's ``deterministic=False``) with its parameters
cast to bf16, loss sum(y^2) in float32, its gradient with respect to the
parameters; one untimed call, then the median of 3 blocks of ``--steps``
calls, each block timed on the host clock to a value read to the host.
A mode that fails (out of memory, say) is reported as FAILED and left out
of the result, as in JAX; ``--strict`` raises instead. Runs on ``cuda``
unless given ``--device cpu``:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.bench_stem [--b 8] [--h 361] [--w 4416] [--steps 10]
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, Optional

import torch

MODES = ("unpacked", "widened", "patched")


def make_stem(mode: str, dev, dtype=torch.bfloat16):
    """JAX's stem of ``mode`` (packed_stem off for unpacked, remat on for it),
    seeded, its parameters in ``dtype``."""
    from omr_a2s_multimodal_transformer_tpu_torch.models.encoder import ConvStemEncoder

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    torch.manual_seed(0)
    stem = ConvStemEncoder(packed_stem=mode != "unpacked", remat=mode == "unpacked")
    return stem.to(device=dev, dtype=dtype)


def stem_grads(stem, x: torch.Tensor, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
    """Gradients of sum(stem(x)^2) (float32) with respect to the stem's
    parameters; ``generator`` None runs without dropout."""
    stem.zero_grad(set_to_none=True)
    y = stem(x, generator)
    torch.square(y.float()).sum().backward()
    return {n: p.grad for n, p in stem.named_parameters()}


def main(argv=None) -> Dict[str, float]:
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--b", type=int, default=8)
    p.add_argument("--h", type=int, default=361)
    p.add_argument("--w", type=int, default=4416)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--modes", nargs="+", default=list(MODES),
                   help="unpacked, widened, patched: the same plain convolutions on the card (module docstring)")
    p.add_argument("--train", action="store_true", default=True)
    p.add_argument("--strict", action="store_true", help="raise where a mode fails instead of reporting it")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print("# every mode runs the same plain convolutions on this device (ops/packed_conv.py); unpacked with remat",
          flush=True)

    x = torch.ones((args.b, args.h, args.w, 1), dtype=torch.bfloat16, device=dev)
    results = {}
    for mode in args.modes:
        stem = make_stem(mode, dev)
        gen = torch.Generator(device=dev)

        def grad():
            gen.manual_seed(1)  # JAX passes the same key to every call
            return stem_grads(stem, x, gen)

        def force(g):
            return float(next(iter(g.values())).reshape(-1)[0])

        try:
            force(grad())
        except (RuntimeError, torch.cuda.OutOfMemoryError) as e:  # report OOM per mode, as JAX does
            if args.strict:
                raise
            print(f"{mode}: FAILED ({type(e).__name__}: {str(e)[:120]})")
            continue
        blocks = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(args.steps):
                g = grad()
            force(g)
            blocks.append((time.perf_counter() - t0) / args.steps)
        dt = statistics.median(blocks)
        results[mode] = dt
        print(f"{mode}: {dt*1e3:.2f} ms/step  ({args.b/dt:.1f} samples/s fwd+bwd, stem only)", flush=True)
        del stem
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if "widened" in results and "patched" in results:
        print(f"patched speedup vs widened: {results['widened']/results['patched']:.3f}x")
    return results


if __name__ == "__main__":
    main()
