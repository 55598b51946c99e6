"""Miniature reproduction of the reference's experiment grid, on the port.

Port of ``tools/run_grid.py``. The reference's central claim is that
multimodal fusion beats unimodal transcription (its
src/transformer/model.py:358-726; the 3-modality x 4-mixer x late-fusion
grid of run_experiments.sh:10-85). This tool trains that grid through the
port's cli.train on the content-deterministic synthetic corpus: image
only, audio only, multimodal (any of the 4 mixers, optionally
warm-started from the unimodal legs), tests each leg's best checkpoint
with the port's ``Trainer``, then evaluates both late-fusion schemes
(cli.sw_test, and cli.weighted_test at each alpha) on the trained
unimodal checkpoints, and writes one SER table covering every cell.

Geometry is measure-count scaled (default --n_measures 10, about 1/3 of
the 30-measure GRANDSTAFF shapes); every model is the production recipe
(packed stem, flash cross-attention, bf16, warmup-cosine). On the card
each leg's train step launches the flash kernels K1 and K2 (8 each a
step); no decode launches a kernel. Each leg's ``cli.train`` is given
``--keep_cache`` (the frontend disk cache outlives it), as in JAX.

Runs on ``cuda`` unless given ``--device cpu``, which is passed to every
CLI and Trainer:
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid [--train_n 1024] [--n_measures 10]
      [--epochs 150] [--legs image audio concat attn_img] [--alphas 0.3 0.5 0.7]
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --smoke --device cpu --train_n 4 \
      --eval_n 2 --batch 2 --epochs 1 --check_val_every_n_epoch 1 --legs image audio concat
Writes ``--out`` (default ``<workdir>/report.json``) after every leg and
prints a markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import read_trajectory, synth_cfg
from omr_a2s_multimodal_transformer_tpu_torch.tools.run_real_shape_e2e import add_cache_args, seed_from_args

MIXERS = ("concat", "attn_img", "attn_audio", "attn_both")


def leg_spec(leg: str):
    """leg name -> (input_modality, mixer_type)."""
    if leg in ("image", "audio"):
        return leg, None
    if leg in MIXERS:
        return "both", leg
    raise ValueError(f"unknown leg {leg!r}: use image|audio|{'|'.join(MIXERS)}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default="runs/grid")
    p.add_argument("--train_n", type=int, default=1024)
    p.add_argument("--eval_n", type=int, default=128)
    p.add_argument("--n_measures", type=int, default=10)
    p.add_argument("--measures_range", nargs=2, type=int, default=None,
                   help="per-sample measure-count range (varied lengths; GRANDSTAFF-like)")
    p.add_argument("--render_style", default="grand", choices=["blob", "grand"])
    p.add_argument("--audio_style", default="tones", choices=["tones", "bands"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--schedule_epochs", type=int, default=None,
                   help="cosine decay horizon in epochs (default = --epochs); the production recipe decays "
                        "over 150 epochs: a 60-epoch cosine halves the LR by epoch 30, before the "
                        "cross-attention alignment latch, which needs a sustained LR of ~2-3e-4")
    p.add_argument("--check_val_every_n_epoch", type=int, default=10)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_epochs", type=int, default=5)
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="global-norm gradient clipping (1.0 = the measured post-LN spike guard)")
    p.add_argument("--encoder_dropout", type=float, default=0.5)
    p.add_argument("--decoder_dropout", type=float, default=0.1)
    p.add_argument("--pos_dropout", type=float, default=0.1)
    p.add_argument("--teacher_forcing_prob", type=float, default=0.2)
    p.add_argument("--teacher_forcing_modality_prob", type=float, default=0.2,
                   help="modality dropout for mixer legs (reference parity 0.2; 0 trains the 'both' path only)")
    p.add_argument("--legs", nargs="+", default=["image", "audio", "concat", "attn_img"])
    p.add_argument("--alphas", nargs="+", type=float, default=[0.3, 0.5, 0.7])
    p.add_argument("--skip_fusion", action="store_true")
    p.add_argument("--skip_training", action="store_true",
                   help="reuse existing leg checkpoints; only (re)run tests + fusion")
    p.add_argument("--reuse_existing", action="store_true",
                   help="skip training any leg whose best checkpoint already exists")
    p.add_argument("--mixer_residual", action="store_true",
                   help="residual attention mixers (query + CrossAttn); pair with --leg_suffix to keep rows "
                        "distinct")
    p.add_argument("--mixer_train_only", default="",
                   help="freeze all but these top-level param groups in mixer legs (e.g. "
                        "'cross_attn,mix_gate'; pair with --warm_start_mixers)")
    p.add_argument("--warm_start_mixers", action="store_true",
                   help="initialize mixer legs' encoders+decoder from the trained unimodal image/audio leg "
                        "checkpoints (cross_attn stays fresh)")
    p.add_argument("--leg_suffix", default="",
                   help="suffix appended to mixer leg names in workdir paths and the report")
    p.add_argument("--smoke", action="store_true", help="tiny shapes, CPU plumbing check")
    p.add_argument("--out", default=None, help="the report (default: <workdir>/report.json)")
    p.add_argument("--eval_batch", type=int, default=None,
                   help="the batch of every decode (validation, test, fusion); default --batch")
    p.add_argument("--no_remat", action="store_true",
                   help="train the legs without --remat (it trades step time for memory; the numbers are the "
                        "same)")
    add_cache_args(p)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu
    out_path = args.out or os.path.join(args.workdir, "report.json")

    from omr_a2s_multimodal_transformer_tpu_torch.cli import common, sw_test, train, weighted_test
    from omr_a2s_multimodal_transformer_tpu_torch.cli.test import build_parser as test_parser
    from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer

    os.makedirs(args.workdir, exist_ok=True)
    cache_root = os.path.join(args.workdir, "grandstaff_cache")
    seed_from_args(cache_root, args)
    cfg = synth_cfg(args.train_n, args.eval_n, args.smoke, args.n_measures, args.render_style,
                    measures_range=args.measures_range, audio_style=args.audio_style)
    steps_per_epoch = max(1, args.train_n // args.batch)

    data_args = [
        "--ds_name", "synthetic",
        "--synthetic_config", cfg,
        "--krn_encoding", "kern",
        "--use_distorted_images",
        "--cache_root", cache_root,
        "--eval_batch_size", str(args.eval_batch or args.batch),
        "--device", args.device,
    ]

    report = {"config": vars(args), "legs": {}, "fusion": {}}

    def best_ckpt(leg):
        return os.path.join(args.workdir, "weights", leg, "best")

    def test_of_best(leg, modality, extra_argv=()):
        """Restore the leg's best checkpoint and run the test split."""
        argv = data_args + [
            "--input_modality", modality,
            "--checkpoint_path", best_ckpt(leg),
            "--run_dir", os.path.join(args.workdir, "runs", leg + "_test"),
            *extra_argv,
        ]
        a = test_parser().parse_args(argv)
        common.init_cli(a)
        dm = common.make_datamodule(a, modality)
        dm.setup("test")
        model, hp, multimodal = common.build_from_checkpoint(a.checkpoint_path, device=a.device)
        tr = Trainer(model, dm.get_vocab(), hp,
                     weights_dir=os.path.dirname(a.checkpoint_path), run_dir=a.run_dir,
                     bf16_compute=True, multimodal=multimodal, ytest_i2w=dm.test_ds.i2w, device=a.device)
        tr.restore(a.checkpoint_path)
        return {k: round(float(v), 3) for k, v in tr.test(dm).items()}

    # ---------------------------------------------------------------- legs
    for leg in args.legs:
        modality, mixer = leg_spec(leg)
        name = leg + (args.leg_suffix if mixer else "")
        t0 = time.time()
        if args.reuse_existing and os.path.exists(best_ckpt(name)):
            print(f"\n=== {name}: reusing existing checkpoint ===", flush=True)
        elif not args.skip_training:
            print(f"\n=== train {name} ({args.epochs} epochs) ===", flush=True)
            argv = data_args + [
                "--keep_cache",
                "--input_modality", modality,
                "--attn_window", "100",
                "--batch_size", str(args.batch),
                "--num_workers", "8",
                "--teacher_forcing_prob", str(args.teacher_forcing_prob),
                "--teacher_forcing_modality_prob", str(args.teacher_forcing_modality_prob),
                "--learning_rate", str(args.learning_rate),
                "--warmup_steps", str(args.warmup_epochs * steps_per_epoch),
                "--decay_steps", str((args.schedule_epochs or args.epochs) * steps_per_epoch),
                "--clip_norm", str(args.clip_norm),
                "--encoder_dropout", str(args.encoder_dropout),
                "--decoder_dropout", str(args.decoder_dropout),
                "--pos_dropout", str(args.pos_dropout),
                "--epochs", str(args.epochs),
                "--patience", "1000000",
                "--check_val_every_n_epoch", str(args.check_val_every_n_epoch),
                "--weights_dir", os.path.join(args.workdir, "weights", name),
                "--run_dir", os.path.join(args.workdir, "runs", name),
                "--use_flash_cross", "--device_cache", "--device_cache_u8",
            ] + ([] if args.no_remat else ["--remat"])
            if mixer:
                argv += ["--mixer_type", mixer]
                if args.mixer_residual:
                    argv += ["--mixer_residual"]
                if args.mixer_train_only:
                    argv += ["--train_only", args.mixer_train_only]
                if args.warm_start_mixers:
                    img_ck, aud_ck = best_ckpt("image"), best_ckpt("audio")
                    if not (os.path.exists(img_ck) and os.path.exists(aud_ck)):
                        raise SystemExit("--warm_start_mixers needs trained image+audio legs "
                                         f"({img_ck}, {aud_ck})")
                    # the decoder donor matches the mixer's memory content at init:
                    # - plain reference mixers: the memory is the attended values (attn_audio's memories are
                    #   audio values at image query positions, attn_img the reverse; concat/attn_both carry
                    #   both, and the stronger image decoder donates);
                    # - gated-residual mixers: tanh(0) = 0 makes the initial memory exactly the query
                    #   modality's, so attn_img starts as the audio-only system (donor audio), attn_audio as
                    #   the image-only one (donor image).
                    if args.mixer_residual:
                        donor = "audio" if mixer == "attn_img" else "image"
                    else:
                        donor = "audio" if mixer == "attn_audio" else "image"
                    argv += ["--init_image_checkpoint", img_ck,
                             "--init_audio_checkpoint", aud_ck,
                             "--init_decoder_from", donor]
            train.main(argv)
        traj = read_trajectory(os.path.join(args.workdir, "runs", name))
        best_val = min((r.get("val_sym-er", 1e9) for r in traj), default=None)
        test_m = test_of_best(name, modality)
        report["legs"][name] = {
            "modality": modality, "mixer": mixer,
            "best_val_sym-er": best_val,
            "trajectory": traj, **test_m,
            "wall_s": round(time.time() - t0, 1),
        }
        print(json.dumps({k: v for k, v in report["legs"][name].items() if k != "trajectory"}), flush=True)
        _write(report, out_path)

    # --------------------------------------------------------------- fusion
    have_uni = all(os.path.exists(best_ckpt(m)) for m in ("image", "audio"))
    if not args.skip_fusion and have_uni:
        fusion_common = data_args + [
            "--image_checkpoint_path", best_ckpt("image"),
            "--audio_checkpoint_path", best_ckpt("audio"),
        ]

        def read_last_metrics(run_dir):
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                rows = [json.loads(ln) for ln in f if ln.strip()]
            last = [r for r in rows if any(k.endswith("sym-er") for k in r)][-1]
            return {k: round(float(v), 3) for k, v in last.items()
                    if k not in ("step", "time")}

        rd = os.path.join(args.workdir, "runs", "fusion_sw")
        t0 = time.time()
        sw_test.main(fusion_common + ["--run_dir", rd])
        report["fusion"]["smith_waterman"] = {
            **read_last_metrics(rd), "wall_s": round(time.time() - t0, 1)}
        _write(report, out_path)

        for alpha in args.alphas:
            rd = os.path.join(args.workdir, "runs", f"fusion_w{alpha}")
            t0 = time.time()
            weighted_test.main(fusion_common + ["--alpha", str(alpha), "--run_dir", rd])
            report["fusion"][f"weighted_a{alpha}"] = {
                **read_last_metrics(rd), "wall_s": round(time.time() - t0, 1)}
            _write(report, out_path)

    _write(report, out_path)
    print(f"\nreport -> {out_path}\n")
    print(_markdown(report))
    return report


def _write(report, out):
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)


def _markdown(report) -> str:
    lines = ["| system | best val SER | test SER | test seq-ER |",
             "|---|---|---|---|"]
    for leg, r in report["legs"].items():
        lines.append(f"| {leg} | {r.get('best_val_sym-er')} | "
                     f"{r.get('test_sym-er')} | {r.get('test_seq-er')} |")
    for name, r in report["fusion"].items():
        ser = next((v for k, v in r.items() if k.endswith("sym-er")), None)
        seq = next((v for k, v in r.items() if k.endswith("seq-er")), None)
        lines.append(f"| fusion:{name} | — | {ser} | {seq} |")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
