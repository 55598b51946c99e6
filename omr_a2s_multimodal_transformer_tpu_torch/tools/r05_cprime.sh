#!/bin/bash
# Port of the JAX repository's r05_cprime.sh: the same steps, gates and order on the port's tools and CLIs
# (python -m omr_a2s_multimodal_transformer_tpu_torch...), run on a GPU from the repository's root;
# reports go to runs/reports/ and logs to runs/logs/. The comments below are the original's: their
# readings are the JAX package's on its TPU.
# Tones-4k retry at a gentler LR (3e-4 + 4x steps/epoch collapsed to the
# unigram basin at ep15-25 despite clip 1.0), then the queue-6 tail.
set -x
cd "$(dirname "$0")/../.." || exit 1
mkdir -p runs/reports runs/logs
python -m omr_a2s_multimodal_transformer_tpu_torch.tools.run_grid --workdir runs/grid_r05_tones4k --train_n 4096 --eval_n 128 \
  --n_measures 30 --measures_range 2 30 --render_style grand --audio_style tones \
  --epochs 60 --schedule_epochs 150 --learning_rate 1.5e-4 --clip_norm 1.0 \
  --encoder_dropout 0 --decoder_dropout 0 --pos_dropout 0 --teacher_forcing_prob 0 \
  --check_val_every_n_epoch 5 --legs audio --skip_fusion \
  --out runs/reports/grid_r05_tones_audio.json > runs/logs/grid_C.log 2>&1
bash omr_a2s_multimodal_transformer_tpu_torch/tools/r05_queue6.sh
