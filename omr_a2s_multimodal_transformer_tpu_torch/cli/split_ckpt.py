"""Split a multimodal checkpoint into two loadable unimodal checkpoints
(reference src/utils/split_multimodal_ckpt.py:8-110).

Port of ``omr_a2s_multimodal_transformer_tpu/cli/split_ckpt.py`` over the
port's checkpoint format (``training/checkpoint.py``
``save_split_checkpoints``).
"""

from __future__ import annotations

import argparse

from omr_a2s_multimodal_transformer_tpu_torch.training.checkpoint import save_split_checkpoints


def main(argv=None):
    """Returns (image checkpoint path, audio checkpoint path)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt_path", required=True)
    p.add_argument("--out_prefix", default=None)
    args = p.parse_args(argv)
    img_path, audio_path = save_split_checkpoints(args.ckpt_path, args.out_prefix)
    print(f"Image model saved at: {img_path}")
    print(f"Audio model saved at: {audio_path}")
    return img_path, audio_path


if __name__ == "__main__":
    main()
