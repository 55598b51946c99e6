"""Production-recipe convergence run of the port on synthetic data.

Port of ``tools/run_convergence.py``. Trains the production recipe (packed
stem, flash cross-attention with its in-kernel dropout, attn_window 100,
bf16, b8) through the port's cli.train on the content-deterministic
synthetic corpus (``data/sources.py``: the pixels encode the tokens, so
val/test under other generator seeds measure generalization), and a
control run without flash (the plain cross-attention, ``--remat``) on the
same data, seeds and batch size. It requires:

  (a) train loss -> ~0,
  (b) val/test SER descending to a clearly good value,
  (c) the production run's loss trajectory matching the control's
      (``trajectory_match``: the mean and max relative difference of the
      per-epoch train losses from the third epoch on).

On the card the production run's train step launches the flash kernels K1
and K2 (8 each a step); the control's launches none. Both draw their
dropout bits differently (the kernels hash theirs), so the match is
statistical; with every dropout at 0 the two runs differ only by the
kernels' bf16 rounding.

Writes ``<workdir>/report.json`` with both trajectories and the
comparison. Runs on ``cuda`` unless given ``--device cpu``:
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence [--epochs 300] [--train_n 256]
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence --smoke --device cpu --train_n 4 \
      --epochs 3 --control_epochs 3
Each ``cli.train`` is given ``--keep_cache``, as in JAX; the vocabulary and max lengths follow
``run_real_shape_e2e.seed_caches`` (``--vocab_path``, ``--max_lens``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.tools.run_real_shape_e2e import add_cache_args, seed_from_args


def synth_cfg(n: int, n_eval: int, smoke: bool, n_measures: int = 30, render_style: str = "blob",
              img_height: int = 361, measures_range=None, audio_style: str = "tones") -> str:
    if smoke:
        return json.dumps({
            "n": n, "n_val": n_eval, "n_test": n_eval, "n_measures": 2,
            "img_height_range": [40, 48], "img_width_range": [96, 160],
            "audio_seconds_range": [0.5, 1.0],
        })
    # GRANDSTAFF-shape geometry, scaled by measure count: heights (and thus
    # pitch-step pixel geometry) stay at production values; width/audio
    # length scale with the event count (30 measures = the 4300-4413 px /
    # 17-18.7 s production corpus).
    cfg = {
        "n": n, "n_val": n_eval, "n_test": n_eval,
        "n_measures": n_measures, "render_style": render_style,
        "img_height_range": [img_height - 6, img_height + 1],
        "img_width_range": [int(4300 / 30 * n_measures), int(4413 / 30 * n_measures)],
        "audio_seconds_range": [round(17.0 / 30 * n_measures, 2), round(18.7 / 30 * n_measures, 2)],
    }
    if measures_range:
        cfg["n_measures_range"] = list(measures_range)
    if audio_style != "tones":
        cfg["audio_style"] = audio_style
    return json.dumps(cfg)


def read_trajectory(run_dir: str):
    path = os.path.join(run_dir, "metrics.jsonl")
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
    out = {}
    for r in rows:
        if "epoch" in r:
            e = r["epoch"]
            out.setdefault(e, {}).update(
                {k: r[k] for k in ("train_loss", "val_sym-er", "val_seq-er", "samples_per_sec") if k in r}
            )
    return [{"epoch": e, **v} for e, v in sorted(out.items())]


def trajectory_match(ctrl, prod) -> dict:
    """Mean and max |prod - ctrl| / ctrl of the per-epoch train losses over
    the epochs both runs have, the first two left out (the noisiest)."""
    n = min(len(ctrl), len(prod))
    rels = [
        abs(q["train_loss"] - c["train_loss"]) / c["train_loss"]
        for c, q in zip(ctrl[2:n], prod[2:n])
        if "train_loss" in c and "train_loss" in q and c["train_loss"] > 0
    ]
    return {
        "epochs_compared": len(rels),
        "mean_rel_loss_diff": round(float(sum(rels) / max(1, len(rels))), 4),
        "max_rel_loss_diff": round(float(max(rels)) if rels else 0.0, 4),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--control_epochs", type=int, default=30,
                   help="no-flash control run length (trajectory-shape check)")
    p.add_argument("--train_n", type=int, default=256)
    p.add_argument("--eval_n", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--check_val_every_n_epoch", type=int, default=20)
    p.add_argument("--workdir", default="runs/convergence")
    p.add_argument("--skip_control", action="store_true")
    p.add_argument("--no_device_cache", action="store_true",
                   help="stream batches from the host every step instead of holding the corpus in device "
                        "memory (data/device_cache.py; the cached batches are bit-identical)")
    p.add_argument("--run_name", default="production",
                   help="run/weights subdirectory name (separate recipe variants)")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--decay_steps", type=int, default=0)
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="global-norm gradient clipping (post-LN spike guard for lr >= 3e-4)")
    p.add_argument("--encoder_dropout", type=float, default=0.5)
    p.add_argument("--decoder_dropout", type=float, default=0.1)
    p.add_argument("--pos_dropout", type=float, default=0.1)
    p.add_argument("--device_cache_u8", action="store_true",
                   help="uint8 image residency in the device cache")
    p.add_argument("--n_measures", type=int, default=30,
                   help="measures per score; width/audio-length scale with it (30 = production)")
    p.add_argument("--render_style", default="blob", choices=["blob", "grand"],
                   help="image render style (sources.render_score_image)")
    p.add_argument("--audio_style", default="tones", choices=["tones", "bands"],
                   help="audio encoding (sources.render_score_audio): 'tones' is the "
                        "musical-but-aliasing-lossy default; 'bands' is the separable "
                        "exactly-decodable code")
    p.add_argument("--measures_range", nargs=2, type=int, default=None,
                   help="per-sample measure count [lo hi]; width/audio scale with it "
                        "(GRANDSTAFF-realistic mixed lengths)")
    p.add_argument("--img_height", type=int, default=361,
                   help="image height (361 = production; taller stretches the pitch pixel geometry)")
    p.add_argument("--teacher_forcing_prob", type=float, default=0.2)
    p.add_argument("--input_modality", default="image", choices=["image", "audio", "both"])
    p.add_argument("--mixer_residual", action="store_true",
                   help="residual attention mixers (query + CrossAttn), framework addition")
    p.add_argument("--mixer_type", default=None,
                   choices=[None, "concat", "attn_img", "attn_audio", "attn_both"])
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU-runnable plumbing check")
    add_cache_args(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu

    os.makedirs(args.workdir, exist_ok=True)
    cache_root = os.path.join(args.workdir, "grandstaff_cache")
    seed_from_args(cache_root, args)

    common = [
        "--ds_name", "synthetic",
        "--synthetic_config", synth_cfg(args.train_n, args.eval_n, args.smoke, args.n_measures,
                                        args.render_style, args.img_height, args.measures_range,
                                        args.audio_style),
        "--krn_encoding", "kern",
        # a dataset-variant selector of the HF/directory sources: SyntheticSource has one clean render, so here it
        # only names the max-lens cache file
        "--use_distorted_images",
        "--cache_root", cache_root,
        "--eval_batch_size", str(args.batch),
        "--num_workers", "8",
        "--input_modality", args.input_modality,
        "--attn_window", "100",
        "--batch_size", str(args.batch),
        "--teacher_forcing_prob", str(args.teacher_forcing_prob),
        "--keep_cache",
        "--learning_rate", str(args.learning_rate),
        "--warmup_steps", str(args.warmup_steps),
        "--decay_steps", str(args.decay_steps),
        "--clip_norm", str(args.clip_norm),
        "--encoder_dropout", str(args.encoder_dropout),
        "--decoder_dropout", str(args.decoder_dropout),
        "--pos_dropout", str(args.pos_dropout),
        "--device", args.device,
    ]
    if args.mixer_type:
        common += ["--mixer_type", args.mixer_type]
        if args.mixer_residual:
            common += ["--mixer_residual"]
    if not args.no_device_cache:
        common.append("--device_cache")
        if args.device_cache_u8:
            common.append("--device_cache_u8")
    report = {"config": vars(args)}

    from omr_a2s_multimodal_transformer_tpu_torch.cli import train

    def run(name, epochs, extra):
        print(f"\n=== {name} ({epochs} epochs) ===", flush=True)
        run_dir = os.path.join(args.workdir, "runs", name)
        t0 = time.time()
        train.main(common + [
            "--epochs", str(epochs),
            "--patience", "1000000",  # a convergence probe never stops early
            "--check_val_every_n_epoch", str(args.check_val_every_n_epoch),
            "--weights_dir", os.path.join(args.workdir, "weights", name),
            "--run_dir", run_dir,
        ] + extra)
        report[name + "_wall_s"] = round(time.time() - t0, 1)
        report[name + "_trajectory"] = read_trajectory(run_dir)

    # The control first (shorter): the plain cross-attention (no flash kernel), with the same packed stem (a
    # relabeling of the same convolution in the port) and the JAX tool's --remat, numerics-neutral recompute.
    if not args.skip_control:
        run("control", args.control_epochs, ["--remat"])

    # the production recipe: packed stem (default), flash cross-attention, bf16 (default), --remat as the JAX tool
    run(args.run_name, args.epochs, ["--use_flash_cross", "--remat"])

    ctrl = report.get("control_trajectory") or []
    prod = report[args.run_name + "_trajectory"]
    if ctrl:
        report["trajectory_match"] = trajectory_match(ctrl, prod)

    out = os.path.join(args.workdir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nreport -> {out}")
    last = prod[-1] if prod else {}
    print("final:", json.dumps(last))
    if "trajectory_match" in report:
        print("trajectory match vs control:", json.dumps(report["trajectory_match"]))
    return report


def assemble_report(workdir: str = "runs/convergence", run_name: str = "production"):
    """Rebuild report.json from the runs' metrics.jsonl files (when control
    and production ran in separate invocations). Every run subdirectory
    found is included; ``run_name`` picks the one the trajectory match
    compares against the control."""
    report = {}
    runs_root = os.path.join(workdir, "runs")
    names = sorted(os.listdir(runs_root)) if os.path.isdir(runs_root) else []
    for name in names:
        rd = os.path.join(runs_root, name)
        if os.path.isdir(rd):
            report[name + "_trajectory"] = read_trajectory(rd)
    ctrl = report.get("control_trajectory") or []
    prod = report.get(run_name + "_trajectory") or []
    if ctrl and prod:
        report["trajectory_match"] = trajectory_match(ctrl, prod)
    out = os.path.join(workdir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report.get("trajectory_match", {})))
    return report


if __name__ == "__main__":
    main()
