#!/bin/bash
# Port of the JAX repository's r05_queue6.sh: the same steps, gates and order on the port's tools and CLIs
# (python -m omr_a2s_multimodal_transformer_tpu_torch...), run on a GPU from the repository's root;
# reports go to runs/reports/ and logs to runs/logs/. The comments below are the original's: their
# readings are the JAX package's on its TPU.
# Round-5 queue, part 6: value-ordered tail (C2 -> I -> B -> D -> A2 -> F).
set -x
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/reports runs/logs

# C2: tones-audio deficit measurements
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

# I: reference-scale ingest
ING_CFG=$(python -c "import sys; sys.path.insert(0,'.'); from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg; print(synth_cfg(25691,128,False,30,'grand',measures_range=[2,30],audio_style='bands'))")
timeout 2700 python -m omr_a2s_multimodal_transformer_tpu_torch.cli.train \
  --ds_name synthetic --synthetic_config "$ING_CFG" --krn_encoding kern \
  --use_distorted_images --cache_root runs/ingest_25k/grandstaff_cache \
  --eval_batch_size 8 --keep_cache \
  --input_modality image --attn_window 100 --batch_size 8 --num_workers 8 \
  --loader_backend grain --teacher_forcing_prob 0.2 --learning_rate 3e-4 \
  --warmup_steps 1600 --decay_steps 96000 --clip_norm 1.0 \
  --encoder_dropout 0.5 --decoder_dropout 0.1 --pos_dropout 0.1 \
  --epochs 2 --patience 1000000 --check_val_every_n_epoch 5 \
  --weights_dir runs/ingest_25k/weights --run_dir runs/ingest_25k/runs \
  --use_flash_cross > runs/logs/ingest.log 2>&1

GRID="--workdir runs/grid_r05 --train_n 1024 --eval_n 128 --n_measures 30 \
  --measures_range 2 30 --render_style grand --audio_style bands --epochs 60 \
  --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 \
  --teacher_forcing_prob 0 --check_val_every_n_epoch 5 --reuse_existing"

# B: concat from scratch
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --legs concat --skip_fusion \
  --out runs/reports/grid_r05_concat.json > runs/logs/grid_B.log 2>&1

# D: warm plain concat
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --epochs 30 --legs concat \
  --warm_start_mixers --leg_suffix _warm --skip_fusion \
  --out runs/reports/grid_r05_warm.json > runs/logs/grid_D.log 2>&1

# A2: image-base golden leg on frozen donors
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid $GRID --legs attn_audio \
  --mixer_residual --warm_start_mixers --leg_suffix _warm_gres_frozen \
  --mixer_train_only cross_attn,mix_gate --teacher_forcing_modality_prob 0 \
  --skip_fusion --out runs/reports/grid_r05_warm_gres2.json > runs/logs/grid_A2f.log 2>&1

# F: small-geometry control closure
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05_small --train_n 512 --eval_n 128 \
  --n_measures 10 --measures_range 1 4 --render_style grand --audio_style bands \
  --epochs 60 --schedule_epochs 150 --learning_rate 3e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 --teacher_forcing_prob 0 \
  --check_val_every_n_epoch 5 --reuse_existing --legs image --skip_fusion \
  --out runs/reports/grid_r05_small_control.json > runs/logs/grid_F.log 2>&1

echo QUEUE6_DONE
