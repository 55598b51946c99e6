"""Beam size x length penalty SER table of a trained checkpoint, on the port.

Port of ``tools/beam_sweep.py``. Decodes one trained checkpoint over the
synthetic test split for every (beam, length_penalty) pair (the penalty is
a no-op at beam 1, which runs once) with the port's ``Trainer`` and
reports Sym-ER/Seq-ER and the wall time of the split (one batch decoded
first, untimed apart, as ``tools/eval_cache_dtypes.py``). The reference is
greedy-only (its model.py:170-199); this table is what justifies, or
rejects, a beam configuration as the serving default.

The corpus options must be the ones the checkpoint was trained on. Runs on
``cuda`` unless given ``--device cpu``:
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.beam_sweep \
      --checkpoint runs/.../weights/NAME/best [--train_n 1024] [--n_measures 30] [--render_style blob] \
      [--beams 1 2 4 8] [--lps 0.0 0.6 1.0] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--workdir", default="runs/beam_sweep")
    p.add_argument("--cache_root", default=None)
    p.add_argument("--train_n", type=int, default=1024)
    p.add_argument("--eval_n", type=int, default=64)
    p.add_argument("--n_measures", type=int, default=30)
    p.add_argument("--measures_range", nargs=2, type=int, default=None)
    p.add_argument("--render_style", default="blob", choices=["blob", "grand"])
    p.add_argument("--audio_style", default="tones", choices=["tones", "bands"])
    p.add_argument("--input_modality", default="image", choices=["image", "audio", "both"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--beams", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--lps", nargs="+", type=float, default=[0.0, 0.6, 1.0])
    p.add_argument("--out", default=None, help="the report (default: <workdir>/report.json)")
    p.add_argument("--smoke", action="store_true", help="the smoke corpus's tiny shapes (run_convergence.synth_cfg)")
    p.add_argument("--device", default="cuda", help="torch device of the decodes: cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu

    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli.test import build_parser as test_parser
    from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer

    os.makedirs(args.workdir, exist_ok=True)
    cache_root = args.cache_root or os.path.join(args.workdir, "grandstaff_cache")

    rows = []
    for beam in args.beams:
        for lp in args.lps if beam > 1 else [0.0]:  # lp is a no-op at beam 1
            argv = [
                "--ds_name", "synthetic",
                "--synthetic_config", synth_cfg(args.train_n, args.eval_n, args.smoke,
                                                args.n_measures, args.render_style,
                                                measures_range=args.measures_range,
                                                audio_style=args.audio_style),
                "--krn_encoding", "kern",
                "--use_distorted_images",
                "--cache_root", cache_root,
                "--eval_batch_size", str(args.batch),
                "--input_modality", args.input_modality,
                "--checkpoint_path", args.checkpoint,
                "--beam_size", str(beam),
                "--length_penalty", str(lp),
                "--run_dir", os.path.join(args.workdir, "runs", f"b{beam}_lp{lp}"),
                "--device", args.device,
            ]
            a = test_parser().parse_args(argv)
            common.init_cli(a)
            dm = common.make_datamodule(a, a.input_modality)
            dm.setup("test")
            model, hp, multimodal = common.build_from_checkpoint(a.checkpoint_path, device=a.device)
            trainer = Trainer(
                model, dm.get_vocab(), hp,
                weights_dir=os.path.dirname(a.checkpoint_path) or ".",
                run_dir=a.run_dir, bf16_compute=True, multimodal=multimodal,
                ytest_i2w=dm.test_ds.i2w, beam_size=beam, length_penalty=lp, device=a.device,
            )
            trainer.restore(a.checkpoint_path)
            t0 = time.time()
            trainer.evaluate([next(iter(dm.test_dataloader()))], name="warmup")
            compile_s = time.time() - t0
            t0 = time.time()
            metrics = trainer.test(dm)
            row = {"beam": beam, "length_penalty": lp,
                   "wall_s": round(time.time() - t0, 1),
                   "compile_warmup_s": round(compile_s, 1),
                   **{k: round(float(v), 3) for k, v in metrics.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)

    key = next((k for k in rows[0] if k.endswith("sym-er")), None)
    best = min(rows, key=lambda r: r[key]) if key else None
    report = {"checkpoint": args.checkpoint, "rows": rows, "best": best}
    out = args.out or os.path.join(args.workdir, "report.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {out}")
    return report


if __name__ == "__main__":
    main()
