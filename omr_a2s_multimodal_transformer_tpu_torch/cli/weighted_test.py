"""Weighted-logit late-fusion evaluation CLI
(reference src/multimodal/weighted_multimodal/test.py:73-184).

Port of ``omr_a2s_multimodal_transformer_tpu/cli/weighted_test.py``: both
unimodal decoders run in lockstep on a shared prefix, batched and
KV-cached; the next-token distribution is
alpha*softmax(img) + (1-alpha)*softmax(audio). Runs on ``cuda`` unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import random

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos, weighted_decode_fn
from omr_a2s_multimodal_transformer_tpu_torch.utils.logging import MetricsLogger
from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_metrics


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_data_args(p)
    common.add_runtime_args(p)
    p.add_argument("--image_checkpoint_path", required=True)
    p.add_argument("--audio_checkpoint_path", required=True)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--save_preds", default="",
                   help="write (y_true, y_pred) token rows to this .jsonl "
                        "for offline error diagnosis (tools/diagnose_*)")
    return p


def main(argv=None) -> dict:
    """Evaluate the fused pair on the test split; returns the metrics."""
    args = build_parser().parse_args(argv)
    common.init_cli(args)
    for path in (args.image_checkpoint_path, args.audio_checkpoint_path):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    common.print_config("WEIGHTED MULTIMODAL TOKEN LATE FUSION TEST EXPERIMENT", args)

    dm = common.make_datamodule(args, "both")
    dm.setup("test")
    vocab = dm.get_vocab()
    ytest_i2w = dm.test_ds.i2w

    override = {"cache_dtype": args.cache_dtype}
    img_model, img_hp, _ = common.build_from_checkpoint(args.image_checkpoint_path, override, device=args.device)
    audio_model, audio_hp, _ = common.build_from_checkpoint(args.audio_checkpoint_path, override, device=args.device)
    if img_hp["vocab_size"] != audio_hp["vocab_size"]:
        raise ValueError("Vocabularies do not match")

    max_len = max(img_model.max_seq_len, audio_model.max_seq_len)
    decode = weighted_decode_fn(img_model, audio_model, max_len, vocab.sos_id, vocab.eos_id)

    Y, YHAT = [], []
    i2w = vocab.i2w
    for batch in dm.test_dataloader():
        tokens, _ = decode(*common.to_device(batch, ("xi", "xi_hw", "xa", "xa_hw"), args.device), args.alpha)
        rows, _ = cut_at_eos(tokens, tokens, vocab.eos_id)
        YHAT.extend([[i2w[i] for i in row] for row in rows])
        g_rows, _ = cut_at_eos(batch["y_out"], batch["y_out"], vocab.eos_id)
        Y.extend([[ytest_i2w[g] for g in row if g != 0] for row in g_rows])

    if args.save_preds:
        os.makedirs(os.path.dirname(args.save_preds) or ".", exist_ok=True)
        with open(args.save_preds, "w") as f:
            for g, p_row in zip(Y, YHAT):
                f.write(json.dumps({"y_true": g, "y_pred": p_row}) + "\n")
    metrics = compute_metrics(y_true=Y, y_pred=YHAT)
    logger = MetricsLogger(
        args.run_dir or os.path.join("runs", "weighted_fusion", args.ds_name),
        use_wandb=args.use_wandb, wandb_group="WEIGHTED-MULTIMODAL-TOKEN-LATE-FUSION",
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
