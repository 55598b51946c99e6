"""Real-shape end-to-end pipeline run of the port.

Port of ``tools/run_real_shape_e2e.py``. Drives the user-facing pipeline of
the port's CLIs: cli.train of the image model (fit -> validation every N
epochs -> best checkpoint -> test; flash cross-attention), cli.train of
the audio model, cli.test of the image best/, cli.sw_test and
cli.weighted_test of the pair, at the GRANDSTAFF configuration the
reference trains (run_experiments.sh:13): max_seq_len 1,268,
distorted-image canvas 361 x 4412, audio 195 x 808, attn_window 100. The
samples come from the synthetic corpus rendered at those shapes, and the
max-lens caches are seeded with the collection's values (``seed_caches``),
so every array the model sees has the production shape.

The vocabulary: ``--vocab_path`` copies a vocabulary file (for example the
collection's 6,997-token ``ar_w2i_kern.json``) into the cache; without it
the corpus builds its own over all of its splits, as any run of the CLIs
does. ``--max_lens corpus`` leaves the max-lens files to the corpus's scan
too (short-score runs: shapes and decodes end at the corpus's longest
sample). Both ``cli.train`` stages are given ``--keep_cache``, as in JAX.

Writes stage wall times and the validation trajectories to
``<workdir>/report.json``. Runs on ``cuda`` unless given ``--device cpu``,
which is passed to every CLI:
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_real_shape_e2e [--epochs 6] [--train_n 48]
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_real_shape_e2e --smoke --device cpu --train_n 4
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Optional

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device

REAL_MAX_LENS = {
    "max_seq_len": 1268,
    "max_image_height": 361,
    "max_image_width": 4412,
    "max_audio_height": 195,
    "max_audio_width": 808,
}


SMOKE_MAX_LENS = {
    "max_seq_len": 64,
    "max_image_height": 48,
    "max_image_width": 160,
    "max_audio_height": 195,
    "max_audio_width": 48,
}

MAX_LENS_FILES = ("ar_w2i_kern.json", "ImgDist_ar_w2i_kern.json")


def seed_caches(cache_root: str, smoke: bool = False, vocab_path: Optional[str] = None,
                max_lens: bool = True) -> None:
    """Make ``<cache_root>/vocabs`` and ``max_lens``; write the max-lens
    files (SMOKE_MAX_LENS with ``smoke``, else REAL_MAX_LENS; none with
    ``max_lens=False``: the corpus scans its own); copy ``vocab_path``
    (which must exist) as the kern vocabulary, or, without it, leave the
    vocabulary to the corpus."""
    os.makedirs(os.path.join(cache_root, "vocabs"), exist_ok=True)
    os.makedirs(os.path.join(cache_root, "max_lens"), exist_ok=True)
    if vocab_path is not None:
        if not os.path.isfile(vocab_path):
            raise FileNotFoundError(f"no vocabulary file at {vocab_path}")
        shutil.copy(vocab_path, os.path.join(cache_root, "vocabs", "ar_w2i_kern.json"))
    if max_lens:
        for name in MAX_LENS_FILES:
            with open(os.path.join(cache_root, "max_lens", name), "w") as f:
                json.dump(SMOKE_MAX_LENS if smoke else REAL_MAX_LENS, f)


def synth_cfg(n: int, smoke: bool = False) -> str:
    if smoke:  # tiny shapes: a CPU dry run of the same 5-stage pipeline
        return json.dumps({
            "n": n, "n_measures": 2,
            "img_height_range": [40, 48], "img_width_range": [96, 160],
            "audio_seconds_range": [0.5, 1.0],
        })
    return json.dumps({
        "n": n,
        "n_measures": 30,
        "img_height_range": [355, 362],
        "img_width_range": [4300, 4413],
        "audio_seconds_range": [17.0, 18.7],
    })


def add_cache_args(p: argparse.ArgumentParser) -> None:
    """The options every tool of the port adds to the JAX tool's: the device
    passed to the CLIs, and what ``seed_caches`` seeds."""
    p.add_argument("--device", default="cuda", help="torch device of every CLI and Trainer: cuda (default) or cpu")
    p.add_argument("--vocab_path", default=None,
                   help="a vocabulary file to copy into the cache (e.g. the collection's ar_w2i_kern.json); "
                        "default: the corpus builds its own")
    p.add_argument("--max_lens", default="real", choices=["real", "corpus"],
                   help="'real': seed the max-lens files (the collection's shapes, or the smoke's); "
                        "'corpus': the corpus scans its own")


def seed_from_args(cache_root: str, args) -> None:
    seed_caches(cache_root, smoke=args.smoke, vocab_path=args.vocab_path, max_lens=args.max_lens == "real")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--check_val_every_n_epoch", type=int, default=2)
    p.add_argument("--train_n", type=int, default=48,
                   help="samples per split (the synthetic source uses the same n for all splits)")
    p.add_argument("--image_batch", type=int, default=8)
    p.add_argument("--width_buckets", type=int, default=1,
                   help=">1: geometric width-bucket ladder (cuts padded-FLOP waste on narrow systems)")
    p.add_argument("--audio_batch", type=int, default=16)
    p.add_argument("--eval_batch", type=int, default=8)
    p.add_argument("--workdir", default="runs/real_shape_e2e")
    p.add_argument("--smoke", action="store_true",
                   help="tiny shapes (CPU plumbing dry-run, same 5 stages)")
    add_cache_args(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu

    os.makedirs(args.workdir, exist_ok=True)
    cache_root = os.path.join(args.workdir, "grandstaff_cache")
    seed_from_args(cache_root, args)

    common_flags = [
        "--ds_name", "synthetic",
        "--synthetic_config", synth_cfg(args.train_n, smoke=args.smoke),
        "--krn_encoding", "kern",
        "--use_distorted_images",
        "--cache_root", cache_root,
        "--eval_batch_size", str(args.eval_batch),
        "--num_workers", "8",
        "--width_buckets", str(args.width_buckets),
        "--device", args.device,
    ]
    report = {"stages": {}, "config": vars(args)}

    def stage(name, fn, *stage_argv):
        print(f"\n=== STAGE {name} ===", flush=True)
        t0 = time.time()
        fn(list(stage_argv))
        dt = time.time() - t0
        report["stages"][name] = {"wall_s": round(dt, 1)}
        print(f"=== STAGE {name} done in {dt:.1f}s ===", flush=True)

    from omr_a2s_multimodal_transformer_tpu_torch.cli import sw_test, test, train, weighted_test

    img_dir = os.path.join(args.workdir, "weights", "image_distorted_kern")
    aud_dir = os.path.join(args.workdir, "weights", "audio_kern")

    stage("train_image", train.main, *common_flags,
          "--input_modality", "image", "--attn_window", "100",
          "--epochs", str(args.epochs), "--patience", "5",
          "--check_val_every_n_epoch", str(args.check_val_every_n_epoch),
          "--batch_size", str(args.image_batch),
          "--use_flash_cross", "--keep_cache",
          "--weights_dir", img_dir,
          "--run_dir", os.path.join(args.workdir, "runs", "image"))

    stage("train_audio", train.main, *common_flags,
          "--input_modality", "audio", "--attn_window", "100",
          "--epochs", str(args.epochs), "--patience", "5",
          "--check_val_every_n_epoch", str(args.check_val_every_n_epoch),
          "--batch_size", str(args.audio_batch), "--keep_cache",
          "--weights_dir", aud_dir,
          "--run_dir", os.path.join(args.workdir, "runs", "audio"))

    stage("test_image", test.main, *common_flags,
          "--checkpoint_path", os.path.join(img_dir, "best"),
          "--input_modality", "image",
          "--run_dir", os.path.join(args.workdir, "runs", "test_image"))

    stage("sw_fusion", sw_test.main, *common_flags,
          "--image_checkpoint_path", os.path.join(img_dir, "best"),
          "--audio_checkpoint_path", os.path.join(aud_dir, "best"),
          "--run_dir", os.path.join(args.workdir, "runs", "sw"))

    stage("weighted_fusion", weighted_test.main, *common_flags,
          "--image_checkpoint_path", os.path.join(img_dir, "best"),
          "--audio_checkpoint_path", os.path.join(aud_dir, "best"),
          "--alpha", "0.5",
          "--run_dir", os.path.join(args.workdir, "runs", "weighted"))

    # the per-epoch trajectories the Trainer logged
    for modality in ("image", "audio"):
        path = os.path.join(args.workdir, "runs", modality, "metrics.jsonl")
        rows = []
        if os.path.exists(path):
            with open(path) as f:
                rows = [json.loads(ln) for ln in f if ln.strip()]
        report[f"{modality}_trajectory"] = [
            {k: r[k] for k in ("epoch", "train_loss", "samples_per_sec",
                               "val_sym-er", "val_seq-er") if k in r}
            for r in rows if "epoch" in r
        ]

    out = os.path.join(args.workdir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nreport -> {out}")
    print(json.dumps(report["stages"], indent=1))
    return report


if __name__ == "__main__":
    main()
