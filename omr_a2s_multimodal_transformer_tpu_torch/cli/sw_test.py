"""Smith-Waterman late-fusion evaluation CLI
(reference src/multimodal/smith_waterman/test.py:29-177).

Port of ``omr_a2s_multimodal_transformer_tpu/cli/sw_test.py``: loads two
unimodal checkpoints (image + audio), greedy-decodes the test set with each
(batched, KV-cached), aligns and fuses the predictions on the host
(``fusion/smith_waterman.py``), and reports SER/seq-ER. Runs on ``cuda``
unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import random

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.fusion.smith_waterman import fuse_predictions
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos, greedy_decode_fn
from omr_a2s_multimodal_transformer_tpu_torch.utils.logging import MetricsLogger
from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_metrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_data_args(p)
    common.add_runtime_args(p)
    p.add_argument("--image_checkpoint_path", required=True)
    p.add_argument("--audio_checkpoint_path", required=True)
    p.add_argument("--match", type=float, default=2)
    p.add_argument("--mismatch", type=float, default=-1)
    p.add_argument("--gap_penalty", type=float, default=-1)
    p.add_argument("--gap_extension_penalty", type=float, default=-1)
    return p


def decode_split(model, loader, vocab, multimodal_key: str, device):
    """Greedy-decode every batch; returns (token_lists, score_lists, gt_lists)."""
    decode = greedy_decode_fn(model, model.max_seq_len, vocab.sos_id, vocab.eos_id)
    toks, scores, gts = [], [], []
    keys = ("xi", "xi_hw") if multimodal_key == "image" else ("xa", "xa_hw")
    for batch in loader:
        t, s = decode(*common.to_device(batch, keys, device))
        t_rows, s_rows = cut_at_eos(t, s, vocab.eos_id)
        toks.extend(t_rows)
        scores.extend(s_rows)
        g_rows, _ = cut_at_eos(batch["y_out"], batch["y_out"], vocab.eos_id)
        gts.extend([[g for g in row if g != 0] for row in g_rows])
    return toks, scores, gts


def main(argv=None) -> dict:
    """Evaluate the aligned and fused pair on the test split; returns the metrics."""
    args = build_parser().parse_args(argv)
    common.init_cli(args)
    for path in (args.image_checkpoint_path, args.audio_checkpoint_path):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    common.print_config("SMITH-WATERMAN LATE FUSION TEST EXPERIMENT", args)

    dm = common.make_datamodule(args, "both")
    dm.setup("test")
    vocab = dm.get_vocab()
    ytest_i2w = dm.test_ds.i2w

    override = {"cache_dtype": args.cache_dtype}
    img_model, _, _ = common.build_from_checkpoint(args.image_checkpoint_path, override, device=args.device)
    audio_model, _, _ = common.build_from_checkpoint(args.audio_checkpoint_path, override, device=args.device)

    img_toks, img_scores, gts = decode_split(img_model, dm.test_dataloader(), vocab, "image", args.device)
    audio_toks, audio_scores, _ = decode_split(audio_model, dm.test_dataloader(), vocab, "audio", args.device)

    i2w = vocab.i2w
    Y = [[ytest_i2w[g] for g in gt] for gt in gts]
    YHAT = []
    for it, isc, at, asc in zip(img_toks, img_scores, audio_toks, audio_scores):
        r = [i2w[i] for i in it]
        q = [i2w[i] for i in at]
        YHAT.append(
            fuse_predictions(r, isc, q, asc, args.match, args.mismatch,
                             args.gap_penalty, args.gap_extension_penalty)
        )

    metrics = compute_metrics(y_true=Y, y_pred=YHAT)
    logger = MetricsLogger(
        args.run_dir or os.path.join("runs", "sw_fusion", args.ds_name),
        use_wandb=args.use_wandb, wandb_group="SMITH-WATERMAN-LATE-FUSION",
        config=common.dump_args(args),
    )
    logger.log(metrics, step=0)
    idx = random.randint(0, len(Y) - 1)
    print(f"Ground truth - {Y[idx]}")
    print(f"Prediction - {YHAT[idx]}")
    print("Done!")
    return metrics


if __name__ == "__main__":
    main()
