"""Convert a reference PyTorch-Lightning .ckpt into a port checkpoint
loadable by the port's CLIs (the parity bridge for reference-trained
weights).

Port of ``omr_a2s_multimodal_transformer_tpu/cli/import_torch.py``, with
the same flags; the output is a port checkpoint directory (``state.pt``
and ``hparams.json``, ``training/checkpoint.py``) instead of orbax. The
conversion is host work and runs on the CPU.

    python -m omr_a2s_multimodal_transformer_tpu_torch.cli.import_torch \
      --torch_ckpt reference.ckpt --out weights/imported
"""

from __future__ import annotations

import argparse
from typing import Dict

from omr_a2s_multimodal_transformer_tpu_torch.training.checkpoint import save_checkpoint
from omr_a2s_multimodal_transformer_tpu_torch.training.torch_import import convert_state_dict, load_torch_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--torch_ckpt", required=True, help="reference .ckpt path")
    p.add_argument("--out", required=True, help="output checkpoint dir")
    p.add_argument("--vocab_size", type=int, default=None,
                   help="override (else inferred from embedding shape)")
    return p


def main(argv=None) -> Dict:
    """Convert and save; returns the checkpoint's hparams."""
    args = build_parser().parse_args(argv)
    sd, hp = load_torch_checkpoint(args.torch_ckpt)
    multimodal = any(k.startswith("image_encoder.") for k in sd)
    params = convert_state_dict(sd)
    out_hp = {
        "vocab_size": args.vocab_size or int(params["decoder.embedding.weight"].shape[0]),
        "max_seq_len": int(hp.get("max_seq_len", 1268)),
        "input_modality": "both" if multimodal else hp.get("input_modality", "image"),
        "mixer_type": hp.get("mixer_type"),
        "attn_window": int(hp.get("attn_window", -1)),
        "imported_from": args.torch_ckpt,
    }
    save_checkpoint(args.out, {"params": params}, hparams=out_hp)
    print(f"Imported {'multimodal' if multimodal else 'unimodal'} checkpoint -> {args.out}")
    print(f"hparams: {out_hp}")
    return out_hp


if __name__ == "__main__":
    main()
