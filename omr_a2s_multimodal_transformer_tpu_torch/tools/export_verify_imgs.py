"""Export a few tiny synthetic sample PNGs for the verify recipe's
transcribe step (``cli.transcribe --inputs $W/imgs/*.png``).

Port of ``tools/export_verify_imgs.py``: the port's ``SyntheticSource``
renders each image as a uint8 array, which PIL writes (imported here only).
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.export_verify_imgs [OUT_DIR]
"""

from __future__ import annotations

import os
import sys

from omr_a2s_multimodal_transformer_tpu_torch.data import sources

DEFAULT_OUT = os.path.join("build", "verify_port", "imgs")


def main(out_dir: str = DEFAULT_OUT) -> list:
    from PIL import Image

    src = sources.SyntheticSource(n=4, seed=3, n_measures=1, encoding="kern",
                                  img_height_range=(32, 33), img_width_range=(64, 96))
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(4):
        paths.append(os.path.join(out_dir, f"s{i}.png"))
        Image.fromarray(src[i]["image"]).save(paths[-1])
    print(f"exported 4 PNGs -> {out_dir}")
    return paths


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT)
