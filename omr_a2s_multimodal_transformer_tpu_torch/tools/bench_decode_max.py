"""Flagship-shape decode bench: b8, image 361x4412 (S=12,696 memories),
L=1268, window 100: the reference's dominant evaluation cost.

Port of ``tools/bench_decode_max.py``. The port's greedy KV-cached decode
(``training/decode.py`` ``greedy_decode_fn``, sos 1, eos 0 as in JAX) of
an all-ones batch on a randomly initialised image model, the decode cache
in ``--cache_dtype`` (bfloat16 by default; float32, int8 and int4 too).
One untimed decode, then ``--iters`` decodes timed on the host clock to the
tokens read to the host; the line gives s a batch, samples/s and ms a step
(the time over ``--max_len``, as JAX divides it) and the steps the decode
ran (it stops early once every row has emitted eos).

``--profile`` writes a ``torch.profiler`` trace of one decode (Chrome
JSON) into ``--profile_dir`` where JAX wrote a ``jax.profiler`` one to
/tmp. ``--decode_impl`` is accepted and read nowhere: JAX defines it and
reads it nowhere.

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.bench_decode_max [--profile] [--cache_dtype bfloat16]
        [--batch 8] [--max_len 1268]

Runs on ``cuda`` unless given ``--device cpu``. ``main`` returns the numbers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import CACHE_DTYPES
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn

SOS_ID, EOS_ID = 1, 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--profile_dir", default="runs/decode_trace", help="where --profile writes its trace")
    ap.add_argument("--cache_dtype", default="bfloat16", choices=CACHE_DTYPES)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max_len", type=int, default=1268)
    ap.add_argument("--height", type=int, default=361)
    ap.add_argument("--width", type=int, default=4412)
    ap.add_argument("--window", type=int, default=100)
    ap.add_argument("--vocab", type=int, default=6997)
    ap.add_argument("--iters", type=int, default=3, help="timed decodes")
    ap.add_argument("--decode_impl", default=None, help="accepted and ignored, as in JAX")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return ap


def steps_run(tokens: torch.Tensor, eos_id: int) -> int:
    """The steps the greedy loop ran: it stops after the step where the last row emits eos."""
    hit = tokens == eos_id
    return int(torch.where(hit.any(1), hit.int().argmax(1) + 1, tokens.shape[1]).max())


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    hp = dict(vocab_size=args.vocab, max_seq_len=args.max_len, input_modality="image", attn_window=args.window,
              cache_dtype=args.cache_dtype)
    model, _ = build_model(hp, device=dev, seed=0)
    b = args.batch
    x = torch.ones((b, args.height, args.width, 1), dtype=torch.float32, device=dev)
    hw = torch.tensor([[args.height, args.width]] * b, dtype=torch.int32, device=dev)
    decode = greedy_decode_fn(model, args.max_len, sos_id=SOS_ID, eos_id=EOS_ID)

    t0 = time.perf_counter()
    tokens, _ = decode(x, hw)
    tokens = tokens.cpu()
    print(f"first run: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    trace = None
    if args.profile:
        os.makedirs(args.profile_dir, exist_ok=True)
        trace = os.path.join(args.profile_dir, f"decode_b{b}_{args.cache_dtype}.json")
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with torch.profiler.profile(activities=acts) as prof:
            decode(x, hw)[0].cpu()
        prof.export_chrome_trace(trace)
        print(f"trace written to {trace}", file=sys.stderr)

    t0 = time.perf_counter()
    for _ in range(args.iters):
        tokens, _ = decode(x, hw)
    tokens = tokens.cpu()
    dt = (time.perf_counter() - t0) / args.iters
    s = -(-args.height // 16) * -(-args.width // 8)
    steps = steps_run(tokens, EOS_ID)
    out = dict(batch=b, memory=s, max_len=args.max_len, window=args.window, cache_dtype=args.cache_dtype,
               s_per_batch=dt, samples_per_s=b / dt, ms_per_step=dt / args.max_len * 1e3, steps=steps, trace=trace)
    print(f"b{b} {args.height}x{args.width} (S={s}) L{args.max_len} W{args.window} cache={args.cache_dtype}: "
          f"{dt:.2f}s/batch = {b / dt:.2f} samples/s, {out['ms_per_step']:.2f} ms/step ({steps} steps run)")
    return out


if __name__ == "__main__":
    main()
