"""HuggingFace Hub uploader (reference src/data/update_dataset_to_hf.py).

Copy of ``omr_a2s_multimodal_transformer_tpu/data/hf_upload.py``; ``datasets``
is imported only by ``upload``, which needs the network.

Builds a DatasetDict with features {audio: Audio(22050), image: Image,
image_distorted: Image, kern: str, bekern: str} from the local grandstaff
tree + partition files and pushes ``PRAIG/{ds}-grandstaff-multimodal`` style
repos (override the org/user with --hf_org). Needs `datasets` + HF_TOKEN.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

from omr_a2s_multimodal_transformer_tpu_torch.data.sources import DATASETS, SPLITS


def collect_files(root: str, ds_name: str, split: str) -> Dict[str, List]:
    part = os.path.join(root, "partitions", ds_name, f"{split}.txt")
    with open(part) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    audio, image, image_distorted, kern, bekern = [], [], [], [], []
    for ln in lines:
        composer, piece = ln.split("\t") if "\t" in ln else (ds_name, ln)
        base = os.path.join(root, composer)
        audio.append(os.path.join(base, "wav", piece + ".wav"))
        image.append(os.path.join(base, "img", piece + ".jpg"))
        image_distorted.append(os.path.join(base, "img_distorted", piece + "_distorted.jpg"))
        with open(os.path.join(base, "krn", piece + ".krn")) as fk:
            kern.append(fk.read())
        with open(os.path.join(base, "bekrn", piece + ".bekrn")) as fb:
            bekern.append(fb.read())
    return {
        "audio": audio, "image": image, "image_distorted": image_distorted,
        "kern": kern, "bekern": bekern,
    }


def upload(root: str, ds_name: str, hf_org: str = "PRAIG", private: bool = True) -> None:
    from datasets import Audio, Dataset, DatasetDict, Features, Image, Value

    features = Features(
        {
            "audio": Audio(sampling_rate=22050),
            "image": Image(),
            "image_distorted": Image(),
            "kern": Value("string"),
            "bekern": Value("string"),
        }
    )
    dd = DatasetDict(
        {
            split: Dataset.from_dict(collect_files(root, ds_name, split), features=features)
            for split in SPLITS
        }
    )
    dd.push_to_hub(f"{hf_org}/{ds_name}-grandstaff-multimodal", private=private,
                   token=os.environ.get("HF_TOKEN"))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="./grandstaff")
    p.add_argument("--hf_org", default="PRAIG")
    p.add_argument("--datasets", nargs="*", default=DATASETS)
    p.add_argument("--public", action="store_true")
    args = p.parse_args()
    for ds in args.datasets:
        print(f"Uploading {ds}...")
        upload(args.root, ds, args.hf_org, private=not args.public)


if __name__ == "__main__":
    main()
