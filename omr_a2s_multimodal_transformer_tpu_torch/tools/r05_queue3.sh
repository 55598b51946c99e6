#!/bin/bash
# Port of the JAX repository's r05_queue3.sh: the same steps, gates and order on the port's tools and CLIs
# (python -m omr_a2s_multimodal_transformer_tpu_torch...), run on a GPU from the repository's root;
# reports go to runs/reports/ and logs to runs/logs/. The comments below are the original's: their
# readings are the JAX package's on its TPU.
# Round-5 queue, part 3. Parts 1-2 established (all measured this round):
#   - image control (1024, zero-reg, 3e-4+clip, 150-ep horizon): latched,
#     val 4.98 / test 5.01
#   - bands audio at 1024 does NOT generalize under EITHER recipe:
#     zero-reg 3e-4 memorizes (train 0.85 / val ~48 through ep108);
#     reference recipe (1e-4, dropout .5/.1/.1, tf .2) sits at train ~2.17
#     / val ~45 through ep190 of 300.
#   - data scale was the image side's alignment lever (varied2816 latched
#     ep8 vs 1024's ep30) -> train the audio legs on 4096 samples.
#     Vocabs are index-identical across corpus sizes (sorted token set,
#     verified equal), so a 4096-trained audio checkpoint is drop-in for
#     the 1024-corpus grid (fusion + warm-start donors).
set -x
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/reports runs/logs

GRID="--workdir runs/grid_r05 --train_n 1024 --eval_n 128 --n_measures 30 \
  --measures_range 2 30 --render_style grand --audio_style bands --epochs 60 \
  --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 \
  --teacher_forcing_prob 0 --check_val_every_n_epoch 5 --reuse_existing"

# A0: bands audio on 4096 samples, zero-reg latch recipe
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05_audio4k --train_n 4096 --eval_n 128 \
  --n_measures 30 --measures_range 2 30 --render_style grand --audio_style bands \
  --epochs 60 --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 --teacher_forcing_prob 0 \
  --check_val_every_n_epoch 5 --reuse_existing --legs audio --skip_fusion \
  --out runs/reports/grid_r05_audio4k.json > runs/logs/grid_A0.log 2>&1

# Gate: only proceed with a generalizing audio model
python - <<'GATE'
import json, sys
rows = [json.loads(l) for l in open('runs/grid_r05_audio4k/runs/audio/metrics.jsonl') if l.strip()]
best = min((r.get('val_sym-er', 1e9) for r in rows), default=1e9)
print('audio-4k best val sym-er:', best, flush=True)
sys.exit(0 if best < 15 else 1)
GATE
if [ $? -eq 0 ]; then
  mkdir -p runs/grid_r05/weights/audio
  cp -r runs/grid_r05_audio4k/weights/audio/best runs/grid_r05/weights/audio/best
  # stub run dir so run_grid's trajectory reader has something to read
  mkdir -p runs/grid_r05/runs/audio
  cp runs/grid_r05_audio4k/runs/audio/metrics.jsonl runs/grid_r05/runs/audio/ 2>/dev/null
else
  echo "AUDIO-4K DID NOT LATCH — grid continues with image-only evidence" >&2
fi

# A1: fusion refresh with both controls
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --skip_training --legs image audio \
  --alphas 0.1 0.3 0.5 0.7 0.9 \
  --out runs/reports/grid_r05_bands.json > runs/logs/grid_A1.log 2>&1

# A: golden legs — warm-started gated-residual mixers
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --legs attn_img attn_audio \
  --mixer_residual --warm_start_mixers --leg_suffix _warm_gres --skip_fusion \
  --out runs/reports/grid_r05_warm_gres.json > runs/logs/grid_A.log 2>&1

# B: concat from scratch
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --legs concat --skip_fusion \
  --out runs/reports/grid_r05_concat.json > runs/logs/grid_B.log 2>&1

# C: tones audio on 4096 samples (deficit attack: does data scale close
# part of the 45-vs-20.7 gap?)
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05_tones4k --train_n 4096 --eval_n 128 \
  --n_measures 30 --measures_range 2 30 --render_style grand --audio_style tones \
  --epochs 60 --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 --teacher_forcing_prob 0 \
  --check_val_every_n_epoch 5 --reuse_existing --legs audio --skip_fusion \
  --out runs/reports/grid_r05_tones_audio.json > runs/logs/grid_C.log 2>&1

# C2: tones-audio deficit measurements (beam sweep + decomposition)
TONES_DATA="--ds_name synthetic --krn_encoding kern --use_distorted_images \
  --cache_root runs/grid_r05_tones4k/grandstaff_cache --batch_size 8 \
  --eval_batch_size 8 --num_workers 8 --input_modality audio \
  --checkpoint_path runs/grid_r05_tones4k/weights/audio/best"
TONES_CFG=$(python -c "import sys; sys.path.insert(0,'.'); from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg; print(synth_cfg(4096,128,False,30,'grand',measures_range=[2,30],audio_style='tones'))")
for BEAM in 1 4 8; do
  python -m omr_a2s_multimodal_transformer_tpu_torch.cli.test $TONES_DATA \
    --synthetic_config "$TONES_CFG" --beam_size $BEAM --length_penalty 0.0 \
    --run_dir runs/grid_r05_tones4k/runs/beam$BEAM \
    --save_preds runs/reports/preds_tones_audio_beam$BEAM.jsonl \
    > runs/logs/tones_beam$BEAM.log 2>&1
done
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.diagnose_audio_errors --workdir runs/grid_r05_tones4k \
  --ckpt runs/grid_r05_tones4k/weights/audio/best --split test --train_n 4096 \
  --out runs/reports/diagnose_audio_errors_r05.json > runs/logs/tones_diag.log 2>&1

# I: reference-scale ingest — 25,691 samples through the grain loader
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

# D: warm plain mixers (restore the r4 warm-start artifact on bands)
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --epochs 30 --legs concat attn_img \
  --warm_start_mixers --leg_suffix _warm --skip_fusion \
  --out runs/reports/grid_r05_warm.json > runs/logs/grid_D.log 2>&1

# Z: validate the edited bench.py end-to-end on the chip
# (dropped: the line that ran the root bench.py, the JAX system's benchmark; the port has no benchmark script yet)

# F: small-geometry control closure
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

echo QUEUE3_DONE
