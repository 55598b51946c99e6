"""Train CLI — reference-parity flag surface (the reference's src/train.py:21-36).

Port of ``omr_a2s_multimodal_transformer_tpu/cli/train.py``: image, audio
and the early-fusion multimodal model (``--input_modality both`` with
``--mixer_type``/``--mixer_residual``, modality dropout by
``--teacher_forcing_modality_prob``, warm start from unimodal checkpoints by
``--init_image_checkpoint``/``--init_audio_checkpoint``/``--init_decoder_from``).
Example (paper config, the reference's run_experiments.sh:13), on the card:
  python -m omr_a2s_multimodal_transformer_tpu_torch.cli.train \
    --ds_name grandstaff --krn_encoding kern --input_modality image \
    --attn_window 100 --epochs 300 --patience 5 --batch_size 16 \
    --use_distorted_images --use_flash_cross
``--device cpu`` runs it on the CPU. ``--remat`` recomputes the encoder's
blocks in the backward. Data and tensor parallelism, two ranks of one
card (gloo) or of two (NCCL), ``--mesh_model 2`` for tensor parallelism:
  python -m torch.distributed.run --nproc_per_node 2 \
    -m omr_a2s_multimodal_transformer_tpu_torch.cli.train ... [--mesh_model 2]
The frontend disk cache (``data/frontends.py``) is emptied after the run
(the JAX package's ``cli/train.py:170-174``) unless ``--keep_cache``.
"""

from __future__ import annotations

import argparse
import os

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.data.frontends import clear_cache
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.parallel import multihost
from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_data_args(p)
    common.add_runtime_args(p)
    p.add_argument("--input_modality", default="audio", choices=["audio", "image", "both"])
    p.add_argument("--attn_window", type=int, default=-1)
    p.add_argument("--mixer_type", default=None,
                   choices=[None, "concat", "attn_img", "attn_audio", "attn_both"])
    p.add_argument("--mixer_residual", action="store_true",
                   help="attention mixers emit query + CrossAttn(query, kv) instead of the "
                        "reference's raw MHA output (which starts as a no-signal random "
                        "projection and measures as a no-latch basin — STATUS r4)")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--check_val_every_n_epoch", type=int, default=5)
    p.add_argument("--checkpoint_path", default="", help="resume from this checkpoint if it exists")
    p.add_argument("--init_image_checkpoint", default="",
                   help="warm-start the multimodal image_encoder (+decoder, see "
                        "--init_decoder_from) from a trained unimodal image checkpoint; "
                        "mixer params keep their fresh init (multimodal runs only)")
    p.add_argument("--init_audio_checkpoint", default="",
                   help="warm-start the multimodal audio_encoder from a trained unimodal "
                        "audio checkpoint (multimodal runs only)")
    p.add_argument("--init_decoder_from", default="image", choices=["image", "audio"],
                   help="which unimodal checkpoint donates the shared decoder on warm start")
    p.add_argument("--teacher_forcing_prob", type=float, default=0.2)
    p.add_argument("--teacher_forcing_modality_prob", type=float, default=0.2)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--decay_steps", type=int, default=0)
    p.add_argument("--train_only", default="",
                   help="comma-separated top-level param groups to train; all "
                        "others frozen (e.g. 'cross_attn,mix_gate' trains only "
                        "the mixer on warm-started frozen unimodal parts)")
    p.add_argument("--clip_norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off, reference parity; the "
                        "post-LN decoder emits rare gradient spikes at lr >= 3e-4 that "
                        "collapse training into the unigram basin — 1.0 guards them)")
    p.add_argument("--encoder_dropout", type=float, default=0.5,
                   help="conv-stem MixDropout rate (reference default 0.5; the synthetic "
                        "convergence corpus' 2-8 px glyphs need lower — see "
                        "tools/diagnose_errors.py)")
    p.add_argument("--decoder_dropout", type=float, default=0.1)
    p.add_argument("--pos_dropout", type=float, default=0.1)
    p.add_argument("--masked_norm", action="store_true",
                   help="mask padded pixels out of instance-norm statistics")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize encoder blocks (less memory, bigger batches)")
    p.add_argument("--use_flash_cross", action="store_true",
                   help="flash cross-attention in training (the CUDA kernels K1/K2 on the card; in-kernel "
                        "attn dropout)")
    p.add_argument("--no_packed_stem", action="store_true",
                   help="disable the lane-packed (width space-to-depth) conv stem (ops/packed_conv.py); "
                        "packed is numerically equivalent")
    p.add_argument("--conv_mode", default="widened", choices=["widened", "patched", "auto"],
                   help="a TPU layout of the packed stem's convolutions in the JAX package: accepted "
                        "and read nowhere by the port")
    p.add_argument("--device_cache", action="store_true",
                   help="hold the preprocessed train corpus in device memory and gather each batch there "
                        "(data/device_cache.py; single-bucket collation only)")
    p.add_argument("--device_cache_u8", action="store_true",
                   help="with --device_cache: hold the cached images as uint8 (checked exact at the build), "
                        "dequantized on the device to the streaming batch's bits")
    p.add_argument("--weights_dir", default=None, help="default: weights/<ds_name>")
    p.add_argument("--keep_cache", action="store_true",
                   help="keep the frontend disk cache after the run (emptied otherwise)")
    return p


def main(argv=None) -> dict:
    """Train, validate, keep best/last checkpoints, test the best. Returns
    the fit result and the test metrics."""
    args = build_parser().parse_args(argv)
    started = common.init_cli(args)
    try:
        return _train(args)
    finally:
        common.finish_cli(started)


def _train(args) -> dict:
    mesh = common.make_mesh_if_needed(args)
    if multihost.is_primary():
        common.print_config("TRAIN EXPERIMENT", args)

    dm = common.make_datamodule(args, args.input_modality)
    with multihost.primary_first():  # rank 0 writes the vocabulary and max-lens caches
        dm.setup("fit")
        dm.setup("test")
    vocab = dm.get_vocab()

    hparams = {
        "vocab_size": len(vocab),
        "max_seq_len": dm.get_max_seq_len(),
        "input_modality": args.input_modality,
        "mixer_type": args.mixer_type,
        "mixer_residual": args.mixer_residual,
        "attn_window": args.attn_window,
        "encoder_dropout": args.encoder_dropout,
        "decoder_dropout": args.decoder_dropout,
        "pos_dropout": args.pos_dropout,
        "masked_norm": args.masked_norm,
        "remat": args.remat,
        "cache_dtype": args.cache_dtype or "bfloat16",
        "use_flash_cross": args.use_flash_cross,
        "packed_stem": not args.no_packed_stem,
        "conv_mode": args.conv_mode,
        "krn_encoding": args.krn_encoding,
        "ds_name": args.ds_name,
        "use_distorted_images": args.use_distorted_images,
        "img_height": args.img_height,
        "teacher_forcing_prob": args.teacher_forcing_prob,
        "teacher_forcing_modality_prob": args.teacher_forcing_modality_prob,
    }
    model, multimodal = build_model(hparams, device=args.device, seed=args.seed, mesh=mesh)
    model_name = common.model_name_from_args(args, args.input_modality, args.mixer_type)
    weights_dir = args.weights_dir or os.path.join("weights", args.ds_name, model_name)
    run_dir = args.run_dir or os.path.join("runs", args.ds_name, model_name)

    trainer = Trainer(
        model, vocab, hparams,
        weights_dir=weights_dir, run_dir=run_dir,
        epochs=args.epochs, patience=args.patience,
        check_val_every_n_epoch=args.check_val_every_n_epoch,
        learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps,
        clip_norm=args.clip_norm,
        train_only=tuple(s for s in args.train_only.split(",") if s) or None,
        teacher_forcing_prob=args.teacher_forcing_prob,
        teacher_forcing_modality_prob=args.teacher_forcing_modality_prob,
        bf16_compute=not args.no_bf16, multimodal=multimodal, mesh=mesh,
        use_wandb=args.use_wandb, wandb_group=model_name,
        wandb_name=f"Train-{args.ds_name}_Test-{args.ds_name}",
        seed=args.seed,
        device_cache=args.device_cache,
        device_cache_u8=args.device_cache_u8,
        device=args.device,
    )
    if args.checkpoint_path and os.path.exists(args.checkpoint_path):
        print(f"Resuming from checkpoint: {args.checkpoint_path}")
        trainer.init_state()
        trainer.restore(args.checkpoint_path)
    elif args.init_image_checkpoint or args.init_audio_checkpoint:
        if not multimodal:
            raise SystemExit("--init_{image,audio}_checkpoint require --input_modality both")
        print(f"Warm start: image={args.init_image_checkpoint or '-'} "
              f"audio={args.init_audio_checkpoint or '-'} decoder_from={args.init_decoder_from}")
        trainer.init_state()
        trainer.warm_start_from_unimodal(
            args.init_image_checkpoint or None, args.init_audio_checkpoint or None,
            decoder_from=args.init_decoder_from)

    result = trainer.fit(dm)
    metrics = trainer.test(dm)
    if multihost.is_primary():
        print(f"Best val_sym-er: {result['best_val_sym-er']:.4f} (epoch {result['best_epoch']})")
        print({k: round(v, 4) for k, v in metrics.items()})
        if not args.keep_cache:  # free the frontend disk cache (reference train.py:161)
            clear_cache()
    return {**result, **metrics}


if __name__ == "__main__":
    main()
