#!/bin/bash
# Full experiment grid (mirrors the reference run_experiments.sh):
# unimodal/multimodal training + cross-dataset eval, then SW and weighted
# late-fusion sweeps. Paper config: kern encoding, distorted images,
# attn_window 100, epochs <=300, patience 5.
set -u

PY=python
TRAIN="-m omr_a2s_multimodal_transformer_tpu_torch.cli.train"
TEST="-m omr_a2s_multimodal_transformer_tpu_torch.cli.test"
SW="-m omr_a2s_multimodal_transformer_tpu_torch.cli.sw_test"
WEIGHTED="-m omr_a2s_multimodal_transformer_tpu_torch.cli.weighted_test"
BATCH=${BATCH:-16}   # the reference paper uses 1; batched is strictly faster here

############################## UNIMODAL AND MULTIMODAL EXPERIMENTS

for input_modality in image audio both; do
    for mixer_type in concat attn_img attn_audio attn_both; do
        # mixers only matter for the multimodal model
        if [ "$input_modality" != "both" ] && [ "$mixer_type" != "concat" ]; then continue; fi
        for train_ds in joplin mozart beethoven chopin scarlatti-d grandstaff; do
            mixer_flag=""
            if [ "$input_modality" == "both" ]; then mixer_flag="--mixer_type $mixer_type"; fi
            $PY $TRAIN --ds_name "$train_ds" --krn_encoding kern \
                --input_modality "$input_modality" $mixer_flag \
                --attn_window 100 --epochs 300 --patience 5 --batch_size "$BATCH" \
                --use_distorted_images
            for test_ds in grandstaff beethoven chopin hummel joplin mozart scarlatti-d; do
                if [ "$train_ds" != "$test_ds" ]; then
                    if [ "$input_modality" == "image" ]; then
                        ckpt=weights/$train_ds/image_distorted_kern/best
                    elif [ "$input_modality" == "audio" ]; then
                        ckpt=weights/$train_ds/audio_kern/best
                    else
                        ckpt=weights/$train_ds/both_${mixer_type}_kern/best
                    fi
                    $PY $TEST --ds_name "$test_ds" --krn_encoding kern \
                        --input_modality "$input_modality" --checkpoint_path "$ckpt" \
                        --use_distorted_images
                fi
            done
        done
    done
done

############################## LATE-FUSION SMITH-WATERMAN EXPERIMENTS

match=(2 10 20 5)
mismatch=(-1 5 10 2)
gap_penalty=(-1 -2 -4 -1)

for i in "${!match[@]}"; do
    for test_ds in hummel joplin mozart beethoven chopin scarlatti-d grandstaff; do
        for image_ds in joplin mozart beethoven chopin scarlatti-d; do
            for audio_ds in joplin mozart beethoven chopin scarlatti-d; do
                $PY $SW --match "${match[$i]}" --mismatch "${mismatch[$i]}" \
                    --gap_penalty "${gap_penalty[$i]}" --ds_name "$test_ds" \
                    --krn_encoding kern --use_distorted_images \
                    --image_checkpoint_path weights/$image_ds/image_distorted_kern/best \
                    --audio_checkpoint_path weights/$audio_ds/audio_kern/best
            done
        done
    done
done

############################## LATE-FUSION WEIGHTED AVERAGE EXPERIMENTS

for a in 0.1 0.2 0.3 0.4 0.5 0.6 0.7 0.8 0.9; do
    for test_ds in hummel joplin mozart beethoven chopin scarlatti-d grandstaff; do
        for image_ds in joplin mozart beethoven chopin scarlatti-d; do
            for audio_ds in joplin mozart beethoven chopin scarlatti-d; do
                $PY $WEIGHTED --alpha "$a" --ds_name "$test_ds" \
                    --krn_encoding kern --use_distorted_images \
                    --image_checkpoint_path weights/$image_ds/image_distorted_kern/best \
                    --audio_checkpoint_path weights/$audio_ds/audio_kern/best
            done
        done
    done
done
