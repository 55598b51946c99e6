"""Flagship multimodal train step at the collection's largest shapes
(image 361x4412 + audio 195x808, L=1268, window 100, vocab 6997, fused
concat memories of 14,009 keys).

Port of ``tools/bench_train_max.py``. It times the port's train step
(``training/train_state.py`` ``make_train_step``, bf16 compute, Adam) of
the concat multimodal model with ``remat`` on an all-ones batch, with two
cross-attention variants:

- ``plain``: the dense PyTorch cross-attention (JAX's ``xla`` variant);
- ``flash``: ``use_flash_cross``, kernels K1 (forward) and K2 (merged
  backward) with dropout in the kernel.

``remat`` recomputes the encoder blocks in the backward, and the decoder
layers only off the flash path (``models/transformer.py``, as in JAX), so
the flash variant launches K1 and K2 8 times a step each: one forward and
one backward per decoder layer, none replayed.

One untimed step, then ``--blocks`` blocks of ``--steps`` steps, each
block timed on the host clock to a value read to the host; the median
block's samples/s is printed, as JAX prints it:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.bench_train_max [batch] [flash|plain|both]

Runs on ``cuda`` unless given ``--device cpu``; the shape options are for
a tiny run (their defaults are JAX's). ``main`` returns the numbers.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

H, W = 361, 4412
AH, AW = 195, 808
L, V, WIN = 1268, 6997, 100
STEPS, BLOCKS = 5, 3
VARIANTS = ("plain", "flash")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("batch", type=int, nargs="?", default=2)
    p.add_argument("which", nargs="?", default="both", choices=[*VARIANTS, "both"])
    p.add_argument("--steps", type=int, default=STEPS, help="steps a timed block")
    p.add_argument("--blocks", type=int, default=BLOCKS, help="timed blocks (the median is printed)")
    p.add_argument("--image", type=int, nargs=2, default=(H, W), metavar=("H", "W"))
    p.add_argument("--audio", type=int, nargs=2, default=(AH, AW), metavar=("H", "W"))
    p.add_argument("--max_len", type=int, default=L)
    p.add_argument("--vocab", type=int, default=V)
    p.add_argument("--window", type=int, default=WIN)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def make_batch(b: int, image, audio, max_len: int, dev: torch.device) -> dict:
    """JAX's all-ones batch: full-size images and spectrograms, ones for tokens."""
    (h, w), (ah, aw) = image, audio
    return {
        "xi": torch.ones((b, h, w, 1), dtype=torch.float32, device=dev),
        "xi_hw": torch.tensor([[h, w]] * b, dtype=torch.int32, device=dev),
        "xa": torch.ones((b, ah, aw, 1), dtype=torch.float32, device=dev),
        "xa_hw": torch.tensor([[ah, aw]] * b, dtype=torch.int32, device=dev),
        "y_in": torch.ones((b, max_len), dtype=torch.int32, device=dev),
        "y_out": torch.ones((b, max_len), dtype=torch.int32, device=dev),
    }


def flash_launches() -> tuple:
    return fp.flash_fwd_cuda.launches, fp.flash_bwd_cuda.launches


def run(variant: str, args, dev: torch.device) -> dict:
    """One variant: {samples_per_s (median block), blocks, first_loss, K1/K2 launches a step}."""
    hp = dict(vocab_size=args.vocab, max_seq_len=args.max_len, input_modality="both", mixer_type="concat",
              attn_window=args.window, remat=True, use_flash_cross=variant == "flash")
    model, _ = build_model(hp, device=dev, seed=0)
    state = TrainState.create(model, lr=1e-4)
    step = make_train_step(model, vocab_size=args.vocab, bf16_compute=True, multimodal=True, device=dev)
    batch = make_batch(args.batch, args.image, args.audio, args.max_len, dev)
    gen = torch.Generator(device=dev)

    def one():
        gen.manual_seed(1)  # JAX passes the same key to every step
        return step(state, batch, gen, "both")[1]

    before = flash_launches()
    first_loss = float(one())
    k1, k2 = (n - m for n, m in zip(flash_launches(), before))
    blocks = []
    for _ in range(args.blocks):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = one()
        float(loss)
        blocks.append(args.steps * args.batch / (time.perf_counter() - t0))
    del model, state
    return dict(samples_per_s=statistics.median(blocks), blocks=blocks, first_loss=first_loss,
                k1_per_step=k1, k2_per_step=k2)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for variant in VARIANTS:
        if args.which in (variant, "both"):
            out[variant] = r = run(variant, args, dev)
            print(f"{variant:5s} cross-attn train: b{args.batch}  {r['samples_per_s']:6.2f} samples/s", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if args.which == "both":
        out["flash_over_plain"] = out["flash"]["samples_per_s"] / out["plain"]["samples_per_s"]
        print(f"flash/plain: {out['flash_over_plain']:.2f}x")
    return out


if __name__ == "__main__":
    main()
