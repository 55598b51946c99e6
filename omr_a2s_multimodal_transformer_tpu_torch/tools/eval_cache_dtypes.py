"""Corpus-scale SER table of the port's decode cache dtypes.

Port of ``tools/eval_cache_dtypes.py``. The decode and serving paths offer
int8/int4 cross-KV caches (``models/decoder.py`` ``quantize_cross``); this
tool measures what the cache dtype does to the metric the reference
evaluates (Sym-ER/Seq-ER, the reference's src/utils/metrics.py:75-88): one
trained image checkpoint (e.g. the convergence run's best/,
``tools/run_convergence.py``) decodes the same synthetic test split under
every cache_dtype x beam size with the port's ``Trainer``, and the table
(with each row's SER minus float32 greedy's) lands in ``--out``.

The corpus options must be the ones the checkpoint was trained on (the
synthetic source draws each split's content from n and the split's seed).
Each row first decodes one batch untimed (``compile_warmup_s``), then the
split (``wall_s``). Runs on ``cuda`` unless given ``--device cpu``:
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.eval_cache_dtypes \
      --checkpoint runs/convergence/weights/production/best [--workdir runs/convergence] [--eval_n 64] \
      [--beams 1 2] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
import time

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg
from omr_a2s_multimodal_transformer_tpu_torch.tools.run_real_shape_e2e import add_cache_args, seed_from_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--workdir", default="runs/cache_dtype_eval")
    p.add_argument("--cache_root", default=None,
                   help="existing seeded cache root (default: <workdir>/grandstaff_cache, seeded here)")
    p.add_argument("--train_n", type=int, default=256,
                   help="must match the corpus config the checkpoint was trained with "
                        "(the synthetic source derives per-split content from n + split seed)")
    p.add_argument("--eval_n", type=int, default=64)
    p.add_argument("--n_measures", type=int, default=30)
    p.add_argument("--measures_range", nargs=2, type=int, default=None)
    p.add_argument("--render_style", default="blob", choices=["blob", "grand"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16", "int8", "int4"])
    p.add_argument("--beams", nargs="+", type=int, default=[1])
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--out", default=None, help="the report (default: <workdir>/report.json)")
    add_cache_args(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu

    os.makedirs(args.workdir, exist_ok=True)
    cache_root = args.cache_root or os.path.join(args.workdir, "grandstaff_cache")
    if not os.path.isdir(os.path.join(cache_root, "vocabs")):
        seed_from_args(cache_root, args)

    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli.test import build_parser as test_parser
    from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer

    rows = []
    for dtype in args.dtypes:
        for beam in args.beams:
            argv = [
                "--ds_name", "synthetic",
                "--synthetic_config", synth_cfg(args.train_n, args.eval_n, args.smoke,
                                                args.n_measures, args.render_style,
                                                measures_range=args.measures_range),
                "--krn_encoding", "kern",
                "--use_distorted_images",
                "--cache_root", cache_root,
                "--eval_batch_size", str(args.batch),
                "--input_modality", "image",
                "--checkpoint_path", args.checkpoint,
                "--cache_dtype", dtype,
                "--beam_size", str(beam),
                "--run_dir", os.path.join(args.workdir, "runs", f"{dtype}_beam{beam}"),
                "--device", args.device,
            ]
            a = test_parser().parse_args(argv)
            common.init_cli(a)
            dm = common.make_datamodule(a, a.input_modality)
            dm.setup("test")
            model, hp, multimodal = common.build_from_checkpoint(
                a.checkpoint_path, hparams_override={"cache_dtype": dtype}, device=a.device)
            trainer = Trainer(
                model, dm.get_vocab(), hp,
                weights_dir=os.path.dirname(a.checkpoint_path) or ".",
                run_dir=a.run_dir, bf16_compute=True, multimodal=multimodal,
                ytest_i2w=dm.test_ds.i2w, beam_size=beam, device=a.device,
            )
            trainer.restore(a.checkpoint_path)
            # one batch first, untimed apart: the first decode's one-time costs (allocator growth, kernel
            # selection) stay out of the row's wall
            t0 = time.time()
            trainer.evaluate([next(iter(dm.test_dataloader()))], name="warmup")
            compile_s = time.time() - t0
            t0 = time.time()
            metrics = trainer.test(dm)
            row = {"cache_dtype": dtype, "beam_size": beam,
                   "wall_s": round(time.time() - t0, 1),
                   "compile_warmup_s": round(compile_s, 1),
                   **{k: round(float(v), 3) for k, v in metrics.items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)

    # deltas against the float32 greedy decode (the reference semantics)
    ref = next((r for r in rows if r["cache_dtype"] == "float32" and r["beam_size"] == 1), None)
    report = {"rows": rows}
    if ref is not None:
        key = next((k for k in ref if k.endswith("sym-er")), None)
        if key:
            report["deltas_vs_float32_greedy"] = {
                f"{r['cache_dtype']}_beam{r['beam_size']}": round(r[key] - ref[key], 3)
                for r in rows
            }
    out = args.out or os.path.join(args.workdir, "report.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {out}")
    return report


if __name__ == "__main__":
    main()
