"""Test CLI — evaluate a checkpoint on (possibly another) dataset.

Port of ``omr_a2s_multimodal_transformer_tpu/cli/test.py`` (the reference's
src/test.py:19-80, incl. cross-domain ytest_i2w handling), for image, audio
and multimodal checkpoints. Runs on ``cuda`` unless given ``--device cpu``;
under ``python -m torch.distributed.run`` on a mesh (``--mesh_model``), each
rank decoding its rows of every batch, as ``cli/train.py``.
"""

from __future__ import annotations

import argparse
import os

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.parallel import multihost
from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_data_args(p)
    common.add_runtime_args(p)
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--input_modality", default="audio", choices=["audio", "image", "both"])
    p.add_argument("--compute_mv2h", action="store_true",
                   help="MV2H metrics (pyMV2H if installed, else utils/mv2h_native.py)")
    p.add_argument("--beam_size", type=int, default=1, help=">1: beam search instead of greedy")
    p.add_argument("--length_penalty", type=float, default=0.0,
                   help="GNMT length penalty for beam search (score / ((5+len)/6)^lp)")
    p.add_argument("--save_preds", default="",
                   help="write test-split (y_true, y_pred) token rows to this "
                        ".jsonl for offline error diagnosis (tools/diagnose_*)")
    p.add_argument("--packed_stem", choices=["on", "off"], default=None,
                   help="override the checkpoint's lane-packed-stem setting (numerics-equivalent)")
    return p


def main(argv=None) -> dict:
    """Evaluate the checkpoint on the test split; returns the metrics."""
    args = build_parser().parse_args(argv)
    started = common.init_cli(args)
    try:
        return _test(args)
    finally:
        common.finish_cli(started)


def _test(args) -> dict:
    if not os.path.exists(args.checkpoint_path):
        raise FileNotFoundError(f"Checkpoint path {args.checkpoint_path} does not exist")
    mesh = common.make_mesh_if_needed(args)
    if multihost.is_primary():
        common.print_config("TEST EXPERIMENT", args)

    dm = common.make_datamodule(args, args.input_modality)
    with multihost.primary_first():  # rank 0 writes the vocabulary and max-lens caches
        dm.setup("test")
    ytest_i2w = dm.test_ds.i2w

    model, hp, multimodal = common.build_from_checkpoint(args.checkpoint_path, hparams_override={
        "cache_dtype": args.cache_dtype,
        "packed_stem": None if args.packed_stem is None else args.packed_stem == "on",
    }, device=args.device, mesh=mesh)
    vocab = dm.get_vocab()  # model vocab == collection vocab (shared)
    trainer = Trainer(
        model, vocab, hp,
        weights_dir=os.path.dirname(args.checkpoint_path) or ".",
        run_dir=args.run_dir or os.path.join("runs", "test", args.ds_name),
        bf16_compute=not args.no_bf16, multimodal=multimodal,
        use_wandb=args.use_wandb, seed=args.seed,
        ytest_i2w=ytest_i2w, compute_mv2h=args.compute_mv2h,
        beam_size=args.beam_size, length_penalty=args.length_penalty,
        mesh=mesh, device=args.device,
    )
    trainer.restore(args.checkpoint_path)
    metrics = trainer.test(dm, save_preds=args.save_preds or None)
    if multihost.is_primary():
        print({k: round(v, 4) for k, v in metrics.items()})
    return metrics


if __name__ == "__main__":
    main()
