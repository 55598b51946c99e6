"""Error-pattern diagnostic of an image checkpoint on the synthetic corpus, on the port.

Port of ``tools/diagnose_errors.py``. Separates the hypotheses behind an
SER plateau by measuring, with an existing checkpoint:

  (a) TRAIN-set SER vs VAL-set SER (greedy decode, deterministic)
        train ~= val       -> underfit (model/optimization ceiling)
        train << val       -> generalization gap (data-limited)
  (b) teacher-forced deterministic loss + next-token accuracy (no
      corruption, no dropout) on train/val batches
        low loss + high acc with bad SER -> exposure bias / decode issue
  (c) token-level aligned diffs of a few val samples
        -> what is wrong: pitch confusions? durations? structure? length?

The model's parameters are cast to bfloat16, as the JAX tool casts its
params (the inputs stay float32 and each layer runs in the promoted dtype,
flax's rule, which the port follows). ``tf_eval`` runs the model's
teacher-forced forward: on the card a flash-cross model launches K1 there
(8 a batch; no backward, so no K2); ``decode_batches`` launches no kernel.

Runs on ``cuda`` unless given ``--device cpu``:
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.diagnose_errors --workdir runs/convergence_1k \
      --ckpt runs/convergence_1k/weights/production/best [--train_n 1024]
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
from collections import Counter

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg


def build(args):
    """(datamodule set up for fit, model on ``args.device``, hparams) of ``args.ckpt``."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli

    cache_root = os.path.join(args.workdir, "grandstaff_cache")
    a = test_cli.build_parser().parse_args([
        "--ds_name", "synthetic",
        "--synthetic_config", synth_cfg(args.train_n, args.eval_n, args.smoke,
                                        args.n_measures, args.render_style,
                                        measures_range=args.measures_range),
        "--krn_encoding", "kern",
        "--use_distorted_images",
        "--cache_root", cache_root,
        "--batch_size", "8", "--eval_batch_size", "8",
        "--num_workers", "8",
        "--input_modality", "image",
        "--checkpoint_path", args.ckpt,
        "--device", args.device,
    ])
    common.init_cli(a)
    dm = common.make_datamodule(a, "image")
    dm.setup("fit")
    model, hp, _ = common.build_from_checkpoint(args.ckpt, device=a.device)
    return dm, model, hp


def _inputs(model, batch, keys):
    dev = next(model.parameters()).device
    return [torch.as_tensor(np.asarray(batch[k])).to(dev) for k in keys]


def decode_batches(model, vocab, loader, n_batches):
    """Greedy-decode the first ``n_batches`` of ``loader``: [(gt tokens, predicted tokens)] a sample."""
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos, greedy_decode_fn

    decode = greedy_decode_fn(model, max_len=model.max_seq_len, sos_id=vocab.sos_id, eos_id=vocab.eos_id)
    out = []
    for bi, batch in enumerate(loader):
        if bi >= n_batches:
            break
        with torch.no_grad():
            tokens, _ = decode(*_inputs(model, batch, ("x", "x_hw")))
        tokens = tokens.cpu().numpy()
        pred_ids, _ = cut_at_eos(tokens, tokens, vocab.eos_id)
        gt_ids, _ = cut_at_eos(batch["y_out"], batch["y_out"], vocab.eos_id)
        for p_row, g_row in zip(pred_ids, gt_ids):
            g_row = [g for g in g_row if g != 0]
            out.append(([vocab.i2w[i] for i in g_row], [vocab.i2w[i] for i in p_row]))
    return out


def tf_eval(model, loader, n_batches, pad_id=0):
    """Teacher-forced deterministic loss + next-token top-1 accuracy, each
    the mean over the first ``n_batches`` batches."""
    losses, accs = [], []
    for bi, batch in enumerate(loader):
        if bi >= n_batches:
            break
        x, x_hw, y_in, y_out = _inputs(model, batch, ("x", "x_hw", "y_in", "y_out"))
        with torch.no_grad():
            logits = model(x, x_hw, y_in)
        mask = y_out != pad_id
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, y_out.long()[..., None])[..., 0]
        loss = (nll * mask).sum() / mask.sum()
        acc = ((logits.argmax(-1) == y_out) & mask).sum() / mask.sum()
        losses.append(float(loss))
        accs.append(float(acc))
    return float(np.mean(losses)), float(np.mean(accs))


def ser(pairs):
    from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_ed_metrics

    gt = [g for g, _ in pairs]
    pr = [p for _, p in pairs]
    return compute_ed_metrics(gt, pr)


def error_census(pairs):
    """Classify aligned token edits across all pairs."""
    cnt = Counter()
    subs = Counter()
    for g, p in pairs:
        sm = difflib.SequenceMatcher(a=g, b=p, autojunk=False)
        for tag, i1, i2, j1, j2 in sm.get_opcodes():
            if tag == "equal":
                cnt["equal"] += i2 - i1
            elif tag == "replace":
                n = max(i2 - i1, j2 - j1)
                cnt["replace"] += n
                for gg, pp in zip(g[i1:i2], p[j1:j2]):
                    subs[(gg, pp)] += 1
            elif tag == "delete":
                cnt["delete"] += i2 - i1
            elif tag == "insert":
                cnt["insert"] += j2 - j1
    return cnt, subs


def cast_params(model, dtype):
    """The model's floating-point parameters (not its buffers) in ``dtype``, in place."""
    for p in model.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="runs/convergence_1k")
    ap.add_argument("--ckpt", default="runs/convergence_1k/weights/production/best")
    ap.add_argument("--train_n", type=int, default=1024)
    ap.add_argument("--eval_n", type=int, default=64)
    ap.add_argument("--n_batches", type=int, default=2)
    ap.add_argument("--n_measures", type=int, default=30)
    ap.add_argument("--measures_range", nargs=2, type=int, default=None,
                    help="the corpus's per-sample measure range, as the checkpoint was trained on")
    ap.add_argument("--render_style", default="blob", choices=["blob", "grand"])
    ap.add_argument("--out", default=os.path.join("runs", "diagnose_errors", "report.json"))
    ap.add_argument("--smoke", action="store_true", help="the smoke corpus's tiny shapes (run_convergence.synth_cfg)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    dm, model, hp = build(args)
    vocab = dm.get_vocab()
    print(f"vocab={len(vocab)} max_seq_len={model.max_seq_len}", flush=True)
    cast_params(model, torch.bfloat16)

    report = {}
    for split, loader in (("train", dm.train_dataloader()), ("val", dm.val_dataloader())):
        pairs = decode_batches(model, vocab, loader, args.n_batches)
        m = ser(pairs)
        loss, acc = tf_eval(model, loader, args.n_batches)
        cnt, subs = error_census(pairs)
        report[split] = {
            "n": len(pairs), **{k: round(v, 2) for k, v in m.items()},
            "tf_eval_loss": round(loss, 4), "tf_eval_top1": round(acc, 4),
            "edits": dict(cnt),
            "len_gt_mean": round(float(np.mean([len(g) for g, _ in pairs])), 1),
            "len_pred_mean": round(float(np.mean([len(p) for _, p in pairs])), 1),
            "top_subs": [[f"{a}->{b}", c] for (a, b), c in subs.most_common(15)],
        }
        print(split, json.dumps(report[split], indent=1), flush=True)
        if split == "val":
            g, p = pairs[0]
            print("GT  :", " ".join(g[:120]))
            print("PRED:", " ".join(p[:120]))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("->", args.out)
    return report


if __name__ == "__main__":
    main()
