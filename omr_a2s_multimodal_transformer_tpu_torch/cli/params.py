"""Parameter-count report for every modality x mixer configuration
(reference src/utils/get_train_params.py:27-100).

Port of ``omr_a2s_multimodal_transformer_tpu/cli/params.py``, with its
flags and ``--device`` (``cuda`` unless given ``cpu``): each model is built
by ``build_model`` and its parameters counted.
"""

from __future__ import annotations

import argparse
from typing import Dict

from omr_a2s_multimodal_transformer_tpu_torch.models import build_model

CONFIGS = [("image", None), ("audio", None)] + [("both", m) for m in ("concat", "attn_img", "attn_audio", "attn_both")]


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vocab_size", type=int, default=6997)
    p.add_argument("--max_seq_len", type=int, default=1268)
    p.add_argument("--attn_window", type=int, default=100)
    p.add_argument("--device", default="cuda", help="torch device to build on: cuda (default) or cpu")
    return p


def main(argv=None) -> Dict[str, int]:
    """Print and return {config name: trainable parameter count}."""
    args = build_parser().parse_args(argv)
    out = {}
    for modality, mixer in CONFIGS:
        hp = {"vocab_size": args.vocab_size, "max_seq_len": args.max_seq_len, "input_modality": modality,
              "mixer_type": mixer, "attn_window": args.attn_window}
        model, _ = build_model(hp, device=args.device)
        name = modality + (f"_{mixer}" if mixer else "")
        out[name] = count_params(model)
        print(f"{name:>20}: {out[name]:,} trainable params")
        del model
    return out


if __name__ == "__main__":
    main()
