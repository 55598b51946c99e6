#!/bin/bash
# Port of the JAX repository's r05_queue.sh: the same steps, gates and order on the port's tools and CLIs
# (python -m omr_a2s_multimodal_transformer_tpu_torch...), run on a GPU from the repository's root;
# reports go to runs/reports/ and logs to runs/logs/. The comments below are the original's: their
# readings are the JAX package's on its TPU.
# Round-5 serialized TPU job queue (one chip): runs after the phase-1
# image+audio bands legs finish. Order = expected value per TPU-minute:
#   A. warm-started GATED-RESIDUAL attention mixers (the round's designed
#      early-fusion fix: init == the trained unimodal query-modality system)
#   B. concat mixer from scratch on bands (the reference mixer that trains)
#   C. tones audio-only retrain (300 ep) for the VERDICT #3 deficit attack
#   D. warm-started PLAIN mixers (restores the r4 warm-start artifact, #4)
#   E. gated-residual attn_img from scratch (does gating alone fix the latch?)
set -x
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/reports runs/logs

# 0: user-surface verify (train -> test -> transcribe on the tiny synthetic
# corpus, the verify recipe) on the TPU — the CPU variant hangs
# under host contention; the chip is free right now between queue jobs.
(
  W=runs/verify_ws; rm -rf $W; mkdir -p $W
  SYN='{"n":6,"img_height_range":[32,33],"img_width_range":[64,96],"audio_seconds_range":[0.3,0.5],"n_measures":1}'
  timeout 900 python -m omr_a2s_multimodal_transformer_tpu_torch.cli.train \
    --ds_name synthetic --krn_encoding kern --synthetic --synthetic_config "$SYN" \
    --cache_root $W/cache --batch_size 3 --num_workers 1 \
    --input_modality image --epochs 2 --check_val_every_n_epoch 1 \
    --weights_dir $W/weights --run_dir $W/run --no_bf16 && \
  timeout 600 python -m omr_a2s_multimodal_transformer_tpu_torch.cli.test \
    --ds_name synthetic --krn_encoding kern --synthetic --synthetic_config "$SYN" \
    --cache_root $W/cache --batch_size 3 --num_workers 1 \
    --input_modality image --checkpoint_path $W/weights/best --run_dir $W/t --no_bf16 \
    --save_preds $W/preds.jsonl && \
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.export_verify_imgs $W/imgs && \
  timeout 600 python -m omr_a2s_multimodal_transformer_tpu_torch.cli.transcribe \
    --checkpoint_path $W/weights/best --vocab_path $W/cache/vocabs/ar_w2i_kern.json \
    --inputs "$W/imgs/*.png" --out_dir $W/out --batch_size 2 && \
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.diagnose_seq_errors --preds $W/preds.jsonl --out runs/reports/verify_diag.json && \
  echo VERIFY_OK
) > runs/logs/verify_tpu.log 2>&1

# The r4 winning recipe (grid_r04_full.json config, varied2816 trajectory):
# ZERO regularization + lr 3e-4 + clip 1.0. The reference-default dropouts
# (0.5 encoder / 0.2 tf) stall train loss at ~2.2 and the cross-attention
# alignment latch never happens — measured again this round at production
# geometry (two runs flat at val ~44 through ep50) before re-finding the
# r4 config. grid_resid_small's broken control was the same bug.
GRID="--workdir runs/grid_r05 --train_n 1024 --eval_n 128 --n_measures 30 \
  --measures_range 2 30 --render_style grand --audio_style bands --epochs 60 \
  --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 \
  --teacher_forcing_prob 0 --check_val_every_n_epoch 5 --reuse_existing"

# Gate: the warm legs and the fusion rows are meaningless if the image
# control didn't latch (the alignment latch is stochastic in epoch count —
# r4 saw ep30, other seeds latch later). If best val > 15, extend the leg
# to 120 epochs via auto-resume (same 150-ep schedule) before anything
# warm-starts from it.
python - <<'GATE'
import json, sys
rows = [json.loads(l) for l in open('runs/grid_r05/runs/image/metrics.jsonl') if l.strip()]
best = min((r.get('val_sym-er', 1e9) for r in rows), default=1e9)
print('image-leg best val sym-er:', best, flush=True)
sys.exit(0 if best < 15 else 1)
GATE
if [ $? -ne 0 ]; then
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05 --train_n 1024 --eval_n 128 \
    --n_measures 30 --measures_range 2 30 --render_style grand --audio_style bands \
    --epochs 120 --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
    --check_val_every_n_epoch 5 --legs image --skip_fusion \
    --out runs/reports/grid_r05_image_ext.json > runs/logs/grid_ext.log 2>&1
fi

# Same gate for the audio control — the bands-audio latch took r4 an
# unknown slice of a 300-epoch run; audio epochs are cheap (~17 s), so an
# unlatched 60-epoch leg gets extended to 200 on the longer horizon.
python - <<'GATE'
import json, sys
rows = [json.loads(l) for l in open('runs/grid_r05/runs/audio/metrics.jsonl') if l.strip()]
best = min((r.get('val_sym-er', 1e9) for r in rows), default=1e9)
print('audio-leg best val sym-er:', best, flush=True)
sys.exit(0 if best < 15 else 1)
GATE
if [ $? -ne 0 ]; then
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05 --train_n 1024 --eval_n 128 \
    --n_measures 30 --measures_range 2 30 --render_style grand --audio_style bands \
    --epochs 200 --schedule_epochs 300 --learning_rate 3e-4 --clip_norm 1.0 \
    --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 --teacher_forcing_prob 0 \
    --check_val_every_n_epoch 5 --legs audio --skip_fusion \
    --out runs/reports/grid_r05_audio_ext.json > runs/logs/grid_audio_ext.log 2>&1
  # refresh the unimodal tests + fusion table with the extended audio leg
  python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --skip_training --legs image audio \
    --alphas 0.1 0.3 0.5 0.7 0.9 \
    --out runs/reports/grid_r05_bands.json > runs/logs/grid_fusion_refresh.log 2>&1
fi

# A: golden legs
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --legs attn_img attn_audio \
  --mixer_residual --warm_start_mixers --leg_suffix _warm_gres --skip_fusion \
  --out runs/reports/grid_r05_warm_gres.json > runs/logs/grid_A.log 2>&1

# B: concat from scratch
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --legs concat --skip_fusion \
  --out runs/reports/grid_r05_concat.json > runs/logs/grid_B.log 2>&1

# C: tones audio-only (deficit attack needs this checkpoint; r4's best val
# was ~ep40 of its 300-ep run — 100 epochs on the same-shape schedule is
# enough, audio steps are cheap)
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05_tones --train_n 1024 --eval_n 128 \
  --n_measures 30 --measures_range 2 30 --render_style grand --audio_style tones \
  --epochs 100 --schedule_epochs 300 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 --teacher_forcing_prob 0 \
  --check_val_every_n_epoch 10 --reuse_existing --legs audio --skip_fusion \
  --out runs/reports/grid_r05_tones_audio.json > runs/logs/grid_C.log 2>&1

# C2: tones-audio deficit measurements with the fresh checkpoint:
# beam sweep (does full-sequence scoring recover ambiguity-class mode
# mixing?) + the line-level error decomposition (VERDICT r4 #3)
TONES_DATA="--ds_name synthetic --krn_encoding kern --use_distorted_images \
  --cache_root runs/grid_r05_tones/grandstaff_cache --batch_size 8 \
  --eval_batch_size 8 --num_workers 8 --input_modality audio \
  --checkpoint_path runs/grid_r05_tones/weights/audio/best"
TONES_CFG=$(python -c "import sys; sys.path.insert(0,'.'); from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg; print(synth_cfg(1024,128,False,30,'grand',measures_range=[2,30],audio_style='tones'))")
for BEAM in 1 4 8; do
  python -m omr_a2s_multimodal_transformer_tpu_torch.cli.test $TONES_DATA \
    --synthetic_config "$TONES_CFG" --beam_size $BEAM --length_penalty 0.0 \
    --run_dir runs/grid_r05_tones/runs/beam$BEAM \
    --save_preds runs/reports/preds_tones_audio_beam$BEAM.jsonl \
    > runs/logs/tones_beam$BEAM.log 2>&1
done
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.diagnose_audio_errors --workdir runs/grid_r05_tones \
  --ckpt runs/grid_r05_tones/weights/audio/best --split test \
  --out runs/reports/diagnose_audio_errors_r05.json > runs/logs/tones_diag.log 2>&1

# I: reference-scale ingest (VERDICT r4 #5) — 25,691-sample corpus
# (GRANDSTAFF train-split size) streamed through the grain loader at
# production geometry, NO device cache; measures streaming samples/s.
ING_CFG=$(python -c "import sys; sys.path.insert(0,'.'); from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg; print(synth_cfg(25691,128,False,30,'grand',measures_range=[2,30],audio_style='bands'))")
timeout 3600 python -m omr_a2s_multimodal_transformer_tpu_torch.cli.train \
  --ds_name synthetic --synthetic_config "$ING_CFG" --krn_encoding kern \
  --use_distorted_images --cache_root runs/ingest_25k/grandstaff_cache \
  --eval_batch_size 8 --keep_cache \
  --input_modality image --attn_window 100 --batch_size 8 --num_workers 8 \
  --loader_backend grain --teacher_forcing_prob 0.2 --learning_rate 3e-4 \
  --warmup_steps 1600 --decay_steps 96000 --clip_norm 1.0 \
  --encoder_dropout 0.5 --decoder_dropout 0.1 --pos_dropout 0.1 \
  --epochs 2 --patience 1000000 --check_val_every_n_epoch 2 \
  --weights_dir runs/ingest_25k/weights --run_dir runs/ingest_25k/runs \
  --use_flash_cross > runs/logs/ingest.log 2>&1

# D: warm plain mixers (r4 claimed concat_warm 7.23 / attn warm ~355 on tones;
# artifact was lost — re-measure on the bands corpus; 30 epochs shows both
# behaviors: concat_warm latches immediately, attn_img_warm free-runs on
# fresh-attn noise from step 0)
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --epochs 30 --legs concat attn_img \
  --warm_start_mixers --leg_suffix _warm --skip_fusion \
  --out runs/reports/grid_r05_warm.json > runs/logs/grid_D.log 2>&1

# Z: validate the edited bench.py end-to-end on the chip
# (dropped: the line that ran the root bench.py, the JAX system's benchmark; the port has no benchmark script yet)

# F: small-geometry control closure (VERDICT r4 weak #1): r4's
# grid_resid_small image-only control sat at val ~2151 — same 60-epoch
# schedule-vs-budget coupling as the production no-latch measured this
# round. Re-run THAT control with the decay horizon fix; if it latches,
# the r4 small-geometry "mixer basin" measurements are attributable to
# the harness schedule, not the mixers.
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05_small --train_n 512 --eval_n 128 \
  --n_measures 10 --measures_range 1 4 --render_style grand --audio_style bands \
  --epochs 60 --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 --teacher_forcing_prob 0 \
  --check_val_every_n_epoch 5 --reuse_existing --legs image --skip_fusion \
  --out runs/reports/grid_r05_small_control.json > runs/logs/grid_F.log 2>&1

# E (best-effort): gated-residual from scratch
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --legs attn_img \
  --mixer_residual --leg_suffix _gres --skip_fusion \
  --out runs/reports/grid_r05_gres_scratch.json > runs/logs/grid_E.log 2>&1

echo QUEUE_DONE
