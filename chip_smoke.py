#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also trace one train step of each model
    python3 chip_smoke.py --out-dir D  # write the result and traces to D (default build/chip_smoke/)
    python3 chip_smoke.py --min-cards 4  # fail unless four cards are visible

Phases, each of which raises on failure (exit code 1):
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version and time kernel,
     plain version and the PyTorch library call that computes the same
     function:
     - at the flagship cross-attention shape (B 8, Lq 1268, Lk 12,696,
       bf16, ragged keys), dropout 0 and 0.1: K1 and K2, K1 also at each
       split of its key tiles into 1-8 chunks (the split the wrapper
       launched is read from the trace's grid); K3a and K3b as the
       split backward of a merged_bwd=False call (both rates), K3a also at
       each split of its key tiles into 1-8 chunks (at dropout 0 beside
       L2b, per head, at the same splits), and the pair against SDPA's
       backward at the same rate; K4, the keep-mask probe at the decoder's
       128/2048 blocks and at B = H = 1 with 70,000 query rows, bit for
       bit, with the time of filling the same bytes as its write floor;
     - at the paper's self-attention shape (B 8, L 1268, 4 x 64 heads,
       window 100, ragged target lengths, 128/512 blocks), dropout 0 and
       0.1: K1c, K3a and K3b, with the banded attention of the windowed
       decoder as a second witness at dropout 0; full causal once; K1c's
       launch record (threads, grid, shared memory from the trace) must be
       the wrapper's plan (causal_fwd_plan);
     - at the three packed stem block shapes (tools/bench_fused_block.py:
       b8, bf16; blocks 0-2 on 361x4416 images), dropout 0.5 and none: K5a
       (y2, statistics) and K5b (out) against plain_k1/plain_k2 and the
       whole block against reference_block; the plain block's forward, the
       cuDNN convolutions of the block alone (convs_ms), and forward +
       backward of fused_packed_block against plain autograd; each bf16
       kernel's launch record (threads, registers, shared memory, grid from
       the trace; spills from ptxas), which must hold the threads, grid and
       shared memory of the wrapper's plan, beside its rows a stage, strips
       and row segments;
     - the per-head legacy flash family of tools/legacy_flash ([B, H, L, D]
       bf16) at the cross shape with 4 x 64 heads and with 2 x 128 (L2: the
       images' kv_valid; L1: kv_len of the same counts) and at the paper's
       self-attention shape (4 x 64, causal, window 100, the targets as
       kv_len for L1 and kv_valid for L2, so pad rows see no key and must
       give o = 0, lse = 0): L1, L2a, L2b, L2c against the plain version,
       with plain and SDPA times (SDPA's forward and backward also in device
       time), beside the head-packed K1, K3a, K3b and K2 at dropout 0;
     - the any-dtype legacy kernels (LA: float16, float32, heads over 128)
       at B 2, H 4, 256 x 1,024: float32 D 64 and 192 to 1e-4 x max |plain|,
       float16 D 64 and bf16 D 192 to 2e-2 (lse 1e-4), with times of the
       float32 call; then LA fwd (L1's o, L2a's o and lse), LA dq and LA
       dk/dv at the legacy cross shape in float32 D 64, float16 D 64 and
       bf16 D 192, each against the plain version, with its bound, plain
       time and SDPA's forward or backward (event and device time);
  3. eleven paths, each with every kernel's launch count set to 0 just
     before it (the serve path: before each of its steps) and read just
     after:
     - stem path: fused_packed_block forward and backward at the three
       stem block shapes (dropout 0.5); K5a and K5b once per block, no
       other kernel, gradients within tolerance of plain autograd;
     - flagship model (attn_window -1): 3 full-width train steps (vocab
       6,997, max_seq_len 1268, bf16 compute, flash cross-attention) on 8
       random 361x4416 images, then greedy decode of 4 raw u8 images with a
       bf16 cache; K1 and K2 must launch 8 times per train step;
     - paper model (attn_window 100, packed_stem, flash cross-attention):
       the same train (its decode, with a 101-slot ring self-cache, is the
       quant path's bf16 decode); K1 and K2
       8 times per step, K1c, K3a, K3b and K4 never (the model runs its
       windowed self-attention in plain PyTorch, as the JAX model does in
       XLA);
     - quant path: the paper model decodes a b4 batch of raw 361x4416 images
       (12,696 keys) greedily to 512 steps (QUANT_LEN)
       once per cache_dtype (bf16, int8, int4: the
       quantized cross K/V), no kernel launched: ms a step, peak memory, the
       cross cache's bytes, tokens equal to the bf16 decode's; for int8 and
       int4 one step's logits within 1e-2 x max |ref| of the same step over
       the dequantized K/V in float32;
     - op path: make_flash_attention_packed(causal, window 100, dropout 0.1)
       forward and backward at the paper shape, a merged_bwd=False call at
       the cross shape, and export_keep_masks at the cross shape: K1c, K3a,
       K3b and K4 must launch.
     - legacy path: the port's tools/bench_flash_packed.main (L2 against
       K1/K2, LEGACY_ITERS timed calls each) at its own shape, then one
       inference call of flash_attention (L1) at the paper shape: exact
       counts of all twelve kernels.
     - cli path: the port's entry points as a user calls them, three runs
       each counted from 0, on the synthetic corpus at production geometry
       (30-measure grand renders, 355-362 x 4300-4413 px, 17-18.7 s of
       "bands" audio at 30 measures; 32 train, 8 val, 8 test samples).
       cli.train trains the paper model at full width (attn_window 100,
       flash cross-attention, packed stem, bf16, b8), validating at its last
       epoch by greedy decode, keeping best/ and last/ and testing best/: the image
       model for 2 epochs (then cli.test of best/ with --save_preds), the
       audio model for 2 (its 2nd epoch reads the 32 train spectrograms
       back from the frontend disk cache), and the gated attn_both
       multimodal model for 1,
       warm-started from the image and audio best/ with only the mixer
       trained (then cli.test --input_modality both --save_preds). In each
       run K1 and K2 must launch 8 times per train step, no other kernel;
       after it K1 and K2 are held to their plain version on the inputs of
       their first call there (Lq 670; Lk the image bucket's 12,259, the
       audio bucket's 1,261, the fused 13,520 on this corpus; the collate's
       padding as the key mask); losses and SERs finite, 8 preds rows, best/ and last/
       round-trip through a Trainer's restore. Then the audio and the
       multimodal transcriber decode a b4 batch of the test split on the
       card from those checkpoints (the spectrogram on the card, no kernel
       launched). It logs samples/s, the StepTimer's data and step means,
       the decode times and steps, peak memory and the wall time of each
       run. Then the image run again, for 1 epoch, twice, each counted from 0
       (K1 and K2 8 launches a step, no validation): with the corpus held on the card
       (--device_cache --device_cache_u8) and with the worker-process loader
       (--loader_backend grain --num_workers 4); the first train batch of
       each must equal the thread loader's bit for bit; it logs their
       StepTimer data / step means and the resident corpus bytes.
     - serve path: the inference and serving layer on the cli path's
       checkpoints, each step counted from 0 and launching no kernel,
       every decode cut to SERVE_STEPS (160) steps: cli.test --beam_size 4
       --length_penalty 0.6 --compute_mv2h on the image best/ (8 test
       samples, 32 beam rows; MV2H by the native route),
       cli.weighted_test --alpha 0.5 and cli.sw_test on the image
       and audio best/ (the Smith-Waterman host time, on the native route,
       logged apart from the decodes), cli.split_ckpt of the multimodal
       best/ and cli.transcribe of 4 test waves written as .wav with the
       split audio checkpoint and the bf16 cache, then of their .png
       renders and waves as pairs with --cache_dtype int8 (where PIL does
       not import, of the waves again with int8);
       then a TranscriptionServer for images and one for the fused pair
       (alpha 0.5) at the serve CLI's default ladders (canvas 368, widths
       1104/2208/4416, 5/10/19 s), each taking 4 requests from 4 threads
       (test and val samples in the largest buckets: wider than 2208 px,
       longer than 10 s) and one POST to its HTTP front in one batching
       window: every batch
       it builds, decoded again by the direct transcriber, gives equal
       tokens, and each result is a row of one; last
       make_image_transcriber(img_height=256) on a b4 batch of raw images
       on a 361 x 4416 canvas: the resized batch within 1e-5 of the same
       function on the CPU, tokens (4, SERVE_STEPS). It logs decode ms,
       steps and ms a step, each request's latency, batch_stats, peak
       memory and the path's wall time.
     - tools path: the port's experiment layer (tools/) on the card, each
       part counted from 0, every cli.train it runs counted on its own:
       run_grid at the paper model's full width (b8, bf16, flash
       cross-attention, the r05 recipe's hparams with dropouts 0) on 16
       train and 8 val/test samples of short scores (2-4 measures) at
       production height, the corpus's own vocabulary and max lengths:
       legs image, audio and the gated attn_img mixer warm-started from
       both (cross_attn and mix_gate trained), 2 epochs each, validating at
       the last, then Smith-Waterman and weighted a=0.5 fusion; on the image
       leg's best/ eval_cache_dtypes (bf16, int8, int4, beam 1), beam_sweep
       (beams 1 and 2) and diagnose_errors; then run_convergence, control
       (plain cross-attention) and production (flash), 3 epochs each. K1
       and K2 8 launches a train step in every leg and the production run,
       none in the control run or any decode (diagnose_errors' teacher-forced
       forwards K1 8 a batch); K1/K2 held to their plain version on their
       first call in the grid; every SER finite, every report key present,
       trajectory_match's mean relative loss difference within 2e-2, and
       --keep_cache in every cli.train argv and no other, as the JAX tools
       pass it.
     - bench path: the port's four measurement tools at the collection's
       largest shapes, each counted from 0, each logging its line:
       bench_train_max (b2, the concat multimodal model with remat, image
       361x4412 + audio 195x808, 14,009 fused keys, L 1268, vocab 6,997,
       bf16) plain (no kernel) and flash (K1 and K2 8 launches a step, the
       flash decoder layers not rematerialized; K1/K2 held to their plain
       version on their first call), bench_decode_max (b8 bf16, a 64-step
       decode), bench_serve (image, the warm-up and 2 clients of 1 request,
       64-step decodes) and bench_ingest (n 16, the thread and the worker
       loader, cold on an emptied frontend cache, warm on the filled one);
       no kernel in the last three. Then the tools ported last
       (bench_tools), each counted from 0 and its first line logged:
       profile_flagship's paper-model b8 step in a process of its own
       (FLOPs, bytes, ms a step, the roof that binds, one traced step) and
       trace_breakdown of that trace here (by module and by role, the
       attributed share of device time; a trace without GPU kernels
       raises), hbm_ledger (b8 multimodal, remat off and on, bytes and
       FLOPs), a 64-step microbench_decode_step (host and device ms a
       step of each variant), bench_stem, bench_fused_block (K5a/K5b),
       sweep_flash_blocks (two mask geometries, two key splits of K1 and
       K3a), prerender_corpus, measure_stream_rate (the thread loader; the
       worker loader feeds the cli path's grain run and bench_ingest),
       summarize_ingest, and the frontend disk cache's cost and gain by
       frontend call (frontend_cache_times).
     - parallel path (its single-process part, up to the shard
       kernels, runs before the cli path: after the cli and serve paths
       this process's profiler traces held no kernel on the H100): the
       single-process reference, one step of the
       paper model at full width (b8, bf16, flash cross-attention, dropout
       and teacher forcing off) taken in the row blocks of each data-axis
       size the ranks run, its gradient the mean of PAR_REF_RUNS such steps
       (their spread and the leaves it lies in logged); remat against no remat
       on the paper and the gated attn_both multimodal model (b8, bf16,
       dropout on, the same weights and generator state: each remat'd
       block's output in the backward's recompute bit for bit its forward's,
       and the gradients within REMAT_SPREAD times the no-remat step's own
       run-to-run spread, peak and step time both ways; a traced step's
       random-number kernels); K1/K2 at the full
       cross shape and at the shard shape of each mesh the ranks run alone
       (device times, the key splits from their launch grids); with two or
       more cards, K1, K2 and K4 on cuda:1 tensors while cuda:0 is current
       (K1 at dropout 0 and K4 equal to the calls on cuda:0 bit for bit, K2
       within the gate). Then the ranks (spawned processes started by
       parallel/multihost.py initialize, each logging its backend, current
       device and the card's PCI bus id): on one card two ranks (gloo) on a
       dp 2 x 1 and then a tp 1 x 2 mesh, then four (gloo) on the 2 x 2
       mesh, which time nothing; on four or more cards four ranks, a card each (NCCL, on
       distinct bus ids), on dp 4 x 1, 2 x 2 and tp 1 x 4. On each mesh one
       dropout-0 step as the reference's with a global-norm clip that fires
       against it (loss and gathered gradients after the clip within
       PAR_TOL, the gradients within PAR_TP_GRAD_TOL on a mesh with a
       'model' axis, their global norm the clip's within PAR_CLIP_TOL, at most
       PAR_OTHERWISE_MAX of the parameter elements updated otherwise; the
       leaves that hold the distance logged), K1 and K2 8 launches a step
       counted from 0; then two dropout steps with
       finite losses, a third traced (its random-number and NCCL kernels,
       K1 and K2 8 each in the rank's trace), K1/K2 held to their plain
       version on their first call at the shard's shape with the mixed seed
       and K4's masks of that seed equal to the plain hash, under a 'model'
       axis memory_partition's loss equal to the unpartitioned one (the
       four ranks sharing one card: K1/K2 held to their plain version on
       the dropout-0 step's first call at dropout 0.1 with the mixed seed,
       and K4's masks, in place of the dropout steps); with a card a rank,
       the gated attn_both multimodal model's dropout-0 step on 2 x 2 held
       to its single-process step as above. Then cli.train under
       torch.distributed.run on the cli path's corpus cut to 2-4 measures
       (PAR_CORPUS), on two ranks (four with four or more cards, NCCL): dp
       for one epoch, then --mesh_model 2 (tp 1 x 2, or 2 x 2) resuming it
       for a second, and cli.test of its best/ on the same ranks and in
       this process, both with the checkpoint's bf16 decode cache: the
       rows, their lengths and the seq-er equal, the rows that differ and
       the SER gap within PAR_TEST_ROWS_MAX and PAR_TEST_SER_MAX; each rank
       prints its backend and device (cli/common.py), and NCCL ranks must
       sit on distinct cards. Ranks that share a card: their times are not
       scaling figures. With --min-cards N the smoke fails (no result) when
       fewer than N cards are visible.
     K5a and K5b launch on the stem path only: no model calls the fused
     block, as in the JAX package (fused_stem.py:24-35); L1-L2c on the
     legacy path only (no model calls them either).
It prints the card's name and power limit, one JSON line of kernel
numbers, and last {"ok": true, "device": {...}}. Without a GPU it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types
from collections import Counter
from pathlib import Path

# keep CUPTI attached from one profiler trace to the next (PyTorch detaches it after each trace by default and
# attaches it again for the next, a path with known faults, and sets this itself where it re-attaches often);
# whether it spares the occasional trace that records none or part of a call's kernels is not known
os.environ.setdefault("TEARDOWN_CUPTI", "0")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from omr_a2s_multimodal_transformer_tpu_torch.data import frontends  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.inference import make_image_transcriber  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.models.transformer import memory_valid_from_hw  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops import fused_stem as fs  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops.packed_conv import packed_conv  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops.banded_attention import banded_causal_attention  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops.image import preprocess_image_batch  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.tools import bench_flash_packed  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention as fl  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash import flash_attention_bwd as fb  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
# float32 bounds: the cheapest tensor-core scheme whose float32 products meet ANY_TOL, bf16x3 (three bf16
# passes; one TF32 pass fails it: probe_legacy_any.py)
PEAK_F32_ACCURATE_FLOPS = PEAK_BF16_FLOPS / 3
PEAK_BYTES = 3.35e12

B, LQ, IMG_H, IMG_W = 8, 1268, 361, 4416
GRID_H, GRID_W = -(-IMG_H // 16), IMG_W // 8
LK = GRID_H * GRID_W  # 12,696
VOCAB, SOS, EOS = 6997, 1, 2
HEADS = 4
WINDOW = 100  # the paper's attn_window (run_experiments.sh)
OP_BLOCKS = (128, 512)  # make_flash_attention_packed's default blocks
TARGET_LENGTHS = (1268, 1203, 1111, 1010, 905, 811, 702, 640)  # ragged targets of the paper-shape phase
K4_LONG_LQ = 70000  # K4's second geometry: B = H = 1, more query rows than a grid dimension holds
KERNEL_TOL = 2e-2  # max |kernel - plain| <= KERNEL_TOL * max |plain| (bf16 outputs, p rounded to bf16)
LSE_TOL = 1e-3     # lse is f32 from the same bf16 products, other summation order
CSRC = "omr_a2s_multimodal_transformer_tpu_torch/csrc/"
JAX_FLASH = "omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py:"
JAX_STEM = "omr_a2s_multimodal_transformer_tpu/ops/fused_stem.py:"
JAX_LEGACY = "tools/legacy_flash/"
# name -> (launching wrapper, source, TPU kernel (file:line), device symbol in a profiler trace,
#          device kernels per launch)
KERNELS = {
    # K1 launches the key-chunk kernel and the merge (four chunks at the cross shape, fwd_splits)
    "K1 flash fwd": (fp.flash_fwd_cuda, "flash_fwd.cu", JAX_FLASH + "161", "flash_fwd_tma", 2),
    "K2 flash bwd": (fp.flash_bwd_cuda, "flash_bwd.cu", JAX_FLASH + "364", "flash_bwd_kernel", 1),
    "K1c flash fwd causal": (fp.flash_fwd_causal_cuda, "flash_fwd.cu", JAX_FLASH + "161",
                             "flash_fwd_causal_tma_kernel", 1),
    # K3a launches the key-chunk kernel and the merge (four chunks at the cross shape, dq_splits); a causal
    # call or a single chunk launches the first alone
    "K3a flash dq": (fp.flash_dq_cuda, "flash_dq.cu", JAX_FLASH + "228", "flash_dq_", 2),
    "K3b flash dk/dv": (fp.flash_dkv_cuda, "flash_dkv.cu", JAX_FLASH + "283", "flash_dkv_kernel", 1),
    "K4 keep mask": (fp.keep_mask_cuda, "keep_mask.cu", JAX_FLASH + "747", "keep_mask_kernel", 1),
    # K5a launches its walk (bf16 fused_stem_k1_tma; float32 fused_stem_k1_kernel) and the fixed-order statistics
    # sum (fused_stem_k1_stats_kernel); K5b its walk (fused_stem_k2_tma; float32 fused_stem_k2_kernel) alone
    "K5a fused stem k1": (fs.fused_stem_k1_cuda, "fused_stem_k1.cu", JAX_STEM + "288", "fused_stem_k1_", 2),
    "K5b fused stem k2": (fs.fused_stem_k2_cuda, "fused_stem_k2.cu", JAX_STEM + "412", "fused_stem_k2_", 1),
    # the per-head legacy flash family of tools/legacy_flash. L1 and L2a, K1's block per head, share a source:
    # each launches its key-chunk kernel (lf_fwd_chunk, lf_fwd_lse_chunk) and its merge (lf_fwd_chunk_merge,
    # lf_fwd_lse_chunk_merge: a non-causal call of more than one chunk, legacy_fwd_splits) or the first alone
    "L1 legacy flash fwd": (fl.legacy_fwd_cuda, "legacy_flash_fwd.cu", JAX_LEGACY + "flash_attention.py:42",
                            "lf_fwd_chunk", 2),
    "L2a legacy flash fwd lse": (fb.legacy_fwd_lse_cuda, "legacy_flash_fwd.cu",
                                 JAX_LEGACY + "flash_attention_bwd.py:57", "lf_fwd_lse_chunk", 2),
    # L2b, K3a's block per head, launches the key-chunk kernel and the merge (a non-causal call of more than one
    # chunk, legacy_dq_splits) or the first alone
    "L2b legacy flash dq": (fb.legacy_dq_cuda, "legacy_flash_dq.cu", JAX_LEGACY + "flash_attention_bwd.py:109",
                            "lf_dq_", 2),
    "L2c legacy flash dk/dv": (fb.legacy_dkv_cuda, "legacy_flash_dkv.cu", JAX_LEGACY + "flash_attention_bwd.py:150",
                               "lf_dkv_kernel", 1),
    # the same family for what the bf16 tensor-core kernels do not take (float16, float32, heads over 128)
    "LA legacy flash fwd, any dtype": (fl.legacy_any_fwd_cuda, "legacy_flash_any_fwd.cu",
                                       JAX_LEGACY + "flash_attention.py:42", "lfany_fwd_kernel", 1),
    "LA legacy flash dq, any dtype": (fb.legacy_any_dq_cuda, "legacy_flash_any_dq.cu",
                                      JAX_LEGACY + "flash_attention_bwd.py:109", "lfany_dq_kernel", 1),
    "LA legacy flash dk/dv, any dtype": (fb.legacy_any_dkv_cuda, "legacy_flash_any_dkv.cu",
                                         JAX_LEGACY + "flash_attention_bwd.py:150", "lfany_dkv_kernel", 1),
}
LEGACY_BF16 = ("L1 legacy flash fwd", "L2a legacy flash fwd lse", "L2b legacy flash dq", "L2c legacy flash dk/dv")
LEGACY_ANY = ("LA legacy flash fwd, any dtype", "LA legacy flash dq, any dtype", "LA legacy flash dk/dv, any dtype")
ANY_TOL = 1e-4  # float32 any-dtype kernels: max |kernel - plain| <= ANY_TOL * max |plain| (f32 sums, other order)
ANY_LSE_TOL = 1e-4  # LA's lse: f32 scores of the same inputs, l from unrounded p
LEGACY_ITERS = 2  # timed calls of each forward + backward in the legacy path's bench run
# the fused stem block at b8 and the flagship width: (f_in, f_out, stride, ci, co, H, Wp) of
# tools/bench_fused_block.py:24-29 (blocks 0-2 of the packed stem on 361x4416 images)
STEM_BLOCKS = {
    "block0": (8, 8, (1, 1), 1, 16, 361, 552),
    "block1": (4, 2, (2, 2), 16, 32, 361, 1104),
    "block2": (2, 1, (2, 2), 32, 64, 181, 1104),
}
STEM_DROPOUT = 0.5  # the encoder's default
OUT_DIR = ROOT / "build" / "chip_smoke"  # set by --out-dir


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def time_ms(fn, reps=5, warmup=2):
    """Median over reps of CUDA-event time of fn() (each run timed alone)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


KERNEL_INFO = {}  # name -> the launch record of its longest device kernel in its last timing trace


# a profiler trace that records too few of a call's kernels (the runtime's launches but no device activity)
# is taken again after a pause, up to TRACE_TRIES times; TRACES counts the traces and the retaken ones
TRACE_TRIES = 5
TRACES = Counter()


def traced_kernels(fn, reps, path):
    """The kernel events of a profiler trace of reps calls of fn."""
    from torch.profiler import ProfilerActivity, profile

    TRACES["taken"] += 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "kernel"]


def kernel_times(name, fn, reps=10, per_launch=None, record=True):
    """(device ms, call ms) of a kernel's wrapper fn: the device time of
    one launch (its kernels' durations that a profiler trace of reps calls
    recorded, over the launches they make up, KERNELS' count unless
    per_launch is given; the tracer may miss one as it starts, and a trace
    that holds fewer than half of them is taken again, up to TRACE_TRIES
    times), and the CUDA-event median of one call, which holds the
    wrapper's host work and its other device work too (for a kernel of tens
    of microseconds, mostly host). With record, the longest kernel's launch
    record as the trace gives it (registers, shared memory, block and grid)
    goes to KERNEL_INFO."""
    call = time_ms(fn)
    _, _, _, symbol, n_kernels = KERNELS[name]
    per_launch = per_launch or n_kernels
    for _ in range(TRACE_TRIES):
        events = [e for e in traced_kernels(fn, reps, OUT_DIR / "kernel_timing_trace.json") if symbol in e["name"]]
        if reps // 2 * per_launch <= len(events) <= reps * per_launch:
            break
        TRACES["retaken"] += 1
        log(f"  {name}: {len(events)} kernels named {symbol} in the trace of {reps} calls; tracing again")
        time.sleep(2.0)
    else:
        raise AssertionError(f"{name}: {len(events)} kernels named {symbol} in the trace of {reps} calls")
    durs = [e["dur"] for e in events]
    args = max(events, key=lambda e: e["dur"])["args"]
    if record and "registers per thread" in args:
        KERNEL_INFO[name] = dict(registers=args["registers per thread"], smem_bytes=args.get("shared memory"),
                                 threads=args["block"][0] * args["block"][1] * args["block"][2],
                                 grid=args.get("grid"))
    return sum(durs) / (len(durs) / per_launch) / 1e3, call


def library_kernels(fn) -> list:
    """Names of the device kernels one call of fn runs, longest first (the
    backend a library call took)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = sorted(((e.device_time_total, e.key) for e in prof.key_averages() if e.device_time_total > 0), reverse=True)
    return [key[:120] for _, key in times[:3]]


def reset_counts():
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


def kernel_row(name, err, ms, plain_ms, flops, nbytes, library_ms, peak=PEAK_BF16_FLOPS, **extra):
    """One entry of the kernels line; the bound is the larger of the valid
    work's operations over the peak of their type (bf16 tensor cores unless
    given) and its bytes over the memory rate."""
    _, source, replaces, *_ = KERNELS[name]
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(name=name, route="cuda", source=CSRC + source, replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=library_ms, **extra)


def l2b_kernels(q, k, causal, n_split=None) -> int:
    """Device kernels of one L2b launch on [B, H, L, D] q and k: the
    key-chunk kernel and, for a non-causal call of more than one chunk
    (n_split, or legacy_dq_splits' for the card), the merge."""
    if causal:
        return 1
    if n_split is None:
        b, h, lq, d = q.shape
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split = fb.legacy_dq_splits(b, h, lq, k.shape[2], d, n_sm)[0]
    return 1 if n_split == 1 else 2


def lf_fwd_kernels(q, k, causal, n_split=None) -> int:
    """Device kernels of one L1 or L2a launch on [B, H, L, D] q and k: the
    key-chunk kernel and, for a non-causal call of more than one chunk
    (n_split, or legacy_fwd_splits' for the card), the merge."""
    if n_split is None:
        b, h, lq, d = q.shape
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_split = fl.legacy_fwd_splits(b, h, lq, k.shape[2], d, n_sm, causal)[0]
    return 1 if n_split == 1 else 2


def check_legacy_blocks(rows, tag, q, k, causal):
    """The launch records of L1, L2a and (non-causal) L2b at shape tag hold
    the consumer warpgroups a block that the wrappers' key-split choosers
    sized their chunks for (LEGACY_FWD_CONSUMERS, LEGACY_DQ_CONSUMERS; the
    C launches pick their counts by D) and the grid of those chunks."""
    b, h, lq, d = q.shape
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    plans = {name: (fl.LEGACY_FWD_CONSUMERS[fl.width_class(d)],
                    fl.legacy_fwd_splits(b, h, lq, k.shape[2], d, n_sm, causal)[0])
             for name in ("L1 legacy flash fwd", "L2a legacy flash fwd lse")}
    if not causal:
        plans["L2b legacy flash dq"] = (fb.LEGACY_DQ_CONSUMERS[fb.width_class(d)],
                                        fb.legacy_dq_splits(b, h, lq, k.shape[2], d, n_sm)[0])
    for name, (cons, n_split) in plans.items():
        record = rows[name][tag]["launch_record"]
        want = dict(threads=128 * (cons + 1), grid=[-(-lq // (64 * cons)), h, b * n_split])
        if {key: record.get(key) for key in want} != want:
            raise AssertionError(f"{name} at {tag}: launched {record}, planned {want} ({cons} consumers)")


def ragged_hw(n, device):
    """Image sizes with invalid tails: full width first, then narrower."""
    hws = [[IMG_H, IMG_W], [IMG_H, 4100], [340, 3900], [IMG_H, 3600], [300, 4416], [IMG_H, 4000], [361, 2800], [330, 4300]]
    return torch.tensor(hws[:n], dtype=torch.int32, device=device)


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def check(name, err, ref_max, rtol):
    ok = err <= rtol * max(ref_max, 1e-6)
    log(f"  {name}: max_abs_err {err:.3e} (max |plain| {ref_max:.3e}, tolerance {rtol:g} x that) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def check_vs(name, got, ref):
    return check(name, max_err(got, ref), float(ref.detach().float().abs().max()), KERNEL_TOL)


def check_lse(name, got, ref, tol=LSE_TOL):
    err = max_err(got, ref)
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:g}) {'ok' if err <= tol else 'FAIL'}")
    if err > tol:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def phase_cross(dev):
    """K1/K2, the split backward K3a/K3b and K4 at the flagship cross shape."""
    g = torch.Generator(device=dev).manual_seed(0)
    kv_valid = memory_valid_from_hw(ragged_hw(B, dev), GRID_H, GRID_W).contiguous()
    kv_len = torch.full((B,), LK, dtype=torch.int32, device=dev)
    seed = torch.tensor([20240611], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(LQ, LK)
    q, k, v, do = (torch.randn((B, n, HEADS * 64), generator=g, device=dev).to(torch.bfloat16)
                   for n in (LQ, LK, LK, LQ))
    # the bounds count only valid keys: a masked key's products never reach o, dq, dk or dv
    n_valid = int((kv_valid & (torch.arange(LK, device=dev)[None] < kv_len[:, None])).sum())  # over the batch
    log(f"[cross] B {B} Lq {LQ} Lk {LK} bf16, valid keys {n_valid} of {B * LK}")
    kv_bytes = n_valid * HEADS * 64 * 2  # k (or v) at the valid keys, bf16
    qb = q.numel() * 2  # q, o, do or dq, bf16
    stats = B * HEADS * LQ * 4  # lse or delta, f32
    small = kv_valid.numel() + kv_len.numel() * 4
    pairs = HEADS * LQ * n_valid  # (head, query, valid key) triples
    flops1, bytes1 = 4 * 64 * pairs, 2 * qb + 2 * kv_bytes + small + stats  # s = q k^T, o = p v; q, o, k, v, lse
    # K2: s, dp = do v^T, dv = p^T do, dk = ds^T q, dq = ds k; reads q, do, lse, delta and the valid k, v;
    # writes dq and the whole of dk, dv
    flops2, bytes2 = 10 * 64 * pairs, 3 * qb + 2 * stats + 2 * kv_bytes + small + 2 * k.numel() * 2
    flops3a, bytes3a = 6 * 64 * pairs, 3 * qb + 2 * stats + 2 * kv_bytes + small  # s, dp, dq
    flops3b, bytes3b = 8 * 64 * pairs, 2 * qb + 2 * stats + 2 * kv_bytes + small + 2 * k.numel() * 2  # s, dp, dv, dk
    bound3 = sum(max(f / PEAK_BF16_FLOPS, n / PEAK_BYTES) for f, n in ((flops3a, bytes3a), (flops3b, bytes3b)))
    rows = {}
    for rate in (0.0, 0.1):
        o_k, lse_k = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk)
        dq_k, dk_k, dv_k = fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o_k, lse_k, do, rate, HEADS, bq, bk)
        torch.cuda.synchronize()
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_p, lse_p = fp.flash_attention_plain(qr, kr, vr, kv_len, kv_valid, seed, rate, HEADS)
        dq_p, dk_p, dv_p = torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True)
        log(f"[cross] dropout {rate}")
        r = dict(err1=max(check_vs("K1 o", o_k, o_p), check_lse("K1 lse", lse_k, lse_p)),
                 err2=max(check_vs(f"K2 {n}", a, p) for n, a, p in
                          (("dq", dq_k, dq_p), ("dk", dk_k, dk_p), ("dv", dv_k, dv_p))))
        r["ms1"], r["call1"] = kernel_times("K1 flash fwd", lambda: fp.flash_fwd_cuda(
            q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk))
        grid = KERNEL_INFO["K1 flash fwd"]["grid"]  # the chunk kernel's (query tiles, H, B x chunks)
        if grid[1] != HEADS or grid[2] % B:
            raise AssertionError(f"K1's longest kernel has grid {grid}, not the chunk kernel's")
        r["n_split"] = grid[2] // B
        # K1 at each split of its key tiles into 1-8 chunks (chunk kernel + merge), against the plain version
        r["split_ms"], split_errs = {}, []
        for n_split in range(1, 9):
            o_s, lse_s = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk, n_split=n_split)
            split_errs.append((max_err(o_s, o_p), max_err(lse_s, lse_p)))
            r["split_ms"][n_split] = kernel_times("K1 flash fwd", lambda: fp.flash_fwd_cuda(
                q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk, n_split=n_split), reps=20,
                per_launch=1 if n_split == 1 else 2, record=False)[0]
        r["err1"] = max(r["err1"], check("K1 o, 1-8 key chunks", max(e for e, _ in split_errs),
                                         float(o_p.detach().float().abs().max()), KERNEL_TOL))
        lse_err = max(e for _, e in split_errs)
        log(f"  K1 lse, 1-8 key chunks: max_abs_err {lse_err:.3e} (tolerance {LSE_TOL:g})")
        if lse_err > LSE_TOL:
            raise AssertionError("K1 lse at a given split disagrees with its plain version")
        fastest = min(r["split_ms"], key=r["split_ms"].get)
        log(f"  K1 launched {r['n_split']} key chunks (grid {grid} in its trace); device ms by chunks: "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in r["split_ms"].items()) + f"; fastest {fastest}")
        r["ms2"], r["call2"] = kernel_times("K2 flash bwd", lambda: fp.flash_bwd_cuda(
            q, k, v, kv_len, kv_valid, seed, o_k, lse_k, do, rate, HEADS, bq, bk))
        r["plain1"] = time_ms(lambda: fp.flash_attention_plain(q, k, v, kv_len, kv_valid, seed, rate, HEADS),
                              reps=3, warmup=1)
        r["plain2"] = time_ms(lambda: torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True), reps=3, warmup=1)
        log(f"  K1 {r['ms1']:.3f} ms (call {r['call1']:.3f}, plain {r['plain1']:.3f} ms), K2 {r['ms2']:.3f} ms "
            f"(call {r['call2']:.3f}, plain autograd {r['plain2']:.3f} ms)")
        # the split backward of a merged_bwd=False call (at dropout 0 also the packed twin of L2b/L2c)
        delta = fp.attention_delta(do, o_k, HEADS)
        args = (q, k, v, kv_len, kv_valid, seed, do, lse_k, delta, rate, HEADS, bq, bk, False, -1)
        dq3 = fp.flash_dq_cuda(*args)
        dk3, dv3 = fp.flash_dkv_cuda(*args)
        torch.cuda.synchronize()
        r["err3a"] = check_vs("K3a dq", dq3, dq_p)
        r["err3b"] = max(check_vs("K3b dk", dk3, dk_p), check_vs("K3b dv", dv3, dv_p))
        r["n_split3a"] = fp.dq_splits(B, HEADS, LQ, LK, torch.cuda.get_device_properties(dev).multi_processor_count)[0]
        r["ms3a"], r["call3a"] = kernel_times("K3a flash dq", lambda: fp.flash_dq_cuda(*args),
                                              per_launch=1 if r["n_split3a"] == 1 else 2)
        r["ms3b"], r["call3b"] = kernel_times("K3b flash dk/dv", lambda: fp.flash_dkv_cuda(*args))
        r["info3a"], r["info3b"] = KERNEL_INFO.get("K3a flash dq"), KERNEL_INFO.get("K3b flash dk/dv")
        # K3a at each split of its key tiles into 1-8 chunks (chunk kernel + merge), against the plain version
        r["split_ms3a"], split_errs = {}, []
        for n_split in range(1, 9):
            split_errs.append(max_err(fp.flash_dq_cuda(*args, n_split=n_split), dq_p))
            r["split_ms3a"][n_split] = kernel_times("K3a flash dq", lambda: fp.flash_dq_cuda(*args, n_split=n_split),
                                                    reps=20, per_launch=1 if n_split == 1 else 2, record=False)[0]
        r["err3a"] = max(r["err3a"], check("K3a dq, 1-8 key chunks", max(split_errs),
                                           float(dq_p.detach().float().abs().max()), KERNEL_TOL))
        fastest = min(r["split_ms3a"], key=r["split_ms3a"].get)
        log(f"  K3a {r['ms3a']:.3f} ms at dq_splits' {r['n_split3a']} key chunks (call {r['call3a']:.3f}), K3b "
            f"{r['ms3b']:.3f} ms (call {r['call3b']:.3f}) (split backward, non-causal); K3a device ms by chunks: "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in r["split_ms3a"].items()) + f"; fastest {fastest}")
        if rate == 0.0:  # L2b, K3a's block per head, on the same heads at the same splits (legacy flash: no dropout)
            per_head = [t.view(B, t.shape[1], HEADS, 64).transpose(1, 2).contiguous() for t in (q, k, v, do, dq_p)]
            largs = (*per_head[:3], kv_len, kv_valid, per_head[3], lse_k, delta, False, -1)
            r["split_ms_l2b"], split_errs = {}, []
            for n_split in range(1, 9):
                split_errs.append(max_err(fb.legacy_dq_cuda(*largs, n_split=n_split), per_head[4]))
                r["split_ms_l2b"][n_split] = kernel_times(
                    "L2b legacy flash dq", lambda: fb.legacy_dq_cuda(*largs, n_split=n_split), reps=20,
                    per_launch=l2b_kernels(per_head[0], per_head[1], False, n_split), record=False)[0]
            r["err_l2b"] = check("L2b dq, 1-8 key chunks", max(split_errs), float(dq_p.detach().float().abs().max()),
                                 KERNEL_TOL)
            fastest = min(r["split_ms_l2b"], key=r["split_ms_l2b"].get)
            log("  L2b device ms by chunks (per head, dropout 0): "
                + ", ".join(f"{n} {ms:.4f}" for n, ms in r["split_ms_l2b"].items()) + f"; fastest {fastest}")
            del per_head, largs
        del dq3, dk3, dv3, delta, args
        rows[rate] = r
        del o_p, lse_p, dq_p, dk_p, dv_p, qr, kr, vr
        torch.cuda.empty_cache()

    # K4: the keep-mask probe at the decoder's geometry, bit for bit, and at B = H = 1 with more query rows
    # than a grid dimension holds (65,535), which the first design could not launch
    lq_p, lk_p = -(-LQ // bq) * bq, -(-LK // bk) * bk
    for b4, h4, lq4, lk4 in ((B, HEADS, LQ, LK), (1, 1, K4_LONG_LQ, LQ)):
        bq4, bk4 = fp.mask_geometry(lq4, lk4)
        keep_k = fp.export_keep_masks(int(seed), b4, h4, lq4, lk4, dropout_rate=0.1, block_q=bq4, block_k=bk4)
        keep_p = fp.keep_mask(int(seed), b4, h4, -(-lq4 // bq4) * bq4, -(-lk4 // bk4) * bk4, 0.1, dev, bq4, bk4)
        torch.cuda.synchronize()
        if not torch.equal(keep_k, keep_p):
            raise AssertionError(f"K4 keep-mask {tuple(keep_k.shape)} differs from its plain version")
        log(f"[cross] K4 keep-mask {list(keep_k.shape)} equal to the plain version bit for bit")
        del keep_k, keep_p
        torch.cuda.empty_cache()
    ms4, call4 = kernel_times("K4 keep mask", lambda: fp.keep_mask_cuda(seed, B, HEADS, lq_p, lk_p, 0.1, bq, bk))
    plain4 = time_ms(lambda: fp.keep_mask(int(seed), B, HEADS, lq_p, lk_p, 0.1, dev, bq, bk), reps=3, warmup=1)
    # the card's write floor for the same bytes: filling the same bool tensor (a yardstick, not a library call
    # of this hash: no PyTorch call computes it)
    mask4 = torch.empty((B, HEADS, lq_p, lk_p), dtype=torch.bool, device=dev)
    fill4 = device_ms(lambda: mask4.fill_(True), reps=10)
    del mask4
    log(f"  K4 {ms4:.3f} ms (call {call4:.3f}, plain {plain4:.3f} ms; fill_ of the same bytes {fill4:.4f} ms)")

    # library yardstick (never called by the port): SDPA on the same tensors and boolean mask, at dropout 0
    # and at the path's 0.1 (its own RNG: another keep-mask, the same work)
    qs, ks, vs = (t.view(t.shape[0], t.shape[1], HEADS, 64).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = kv_valid[:, None, None, :]
    do_s = do.view(B, LQ, HEADS, 64).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = {}
    for rate in (0.0, 0.1):
        lib1 = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask, dropout_p=rate))
        o_s = sdpa(qs, ks, vs, attn_mask=mask, dropout_p=rate)
        lib2 = time_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True))
        backend = library_kernels(lambda: torch.autograd.grad(sdpa(qs, ks, vs, attn_mask=mask, dropout_p=rate),
                                                              (qs, ks, vs), do_s))
        lib2_dev = device_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True))
        lib[rate] = (lib1, lib2, backend, lib2_dev)
        log(f"[cross] library: SDPA fwd {lib1:.3f} ms, SDPA bwd {lib2:.3f} ms (device {lib2_dev:.3f}) "
            f"(dropout {rate}; kernels {backend})")
        pair = rows[rate]["ms3a"] + rows[rate]["ms3b"]
        log(f"[cross] dropout {rate}: K3a + K3b {pair:.3f} ms (bound {bound3 * 1e3:.4f}), {pair / lib2:.3f} x SDPA's "
            f"backward ({pair / lib2_dev:.3f} x its device time); K2 {rows[rate]['ms2']:.3f} ms")
        del o_s
    lib1, lib2 = lib[0.1][0], lib[0.1][1]
    del q, k, v, do
    torch.cuda.empty_cache()

    main, r0 = rows[0.1], rows[0.0]  # the training path runs dropout 0.1
    return {
        "K1 flash fwd": kernel_row("K1 flash fwd", max(main["err1"], r0["err1"]), main["ms1"], main["plain1"],
                                   flops1, bytes1, lib1, call_ms=main["call1"],
                                   ms_dropout0=r0["ms1"], plain_ms_dropout0=r0["plain1"],
                                   library_ms_dropout0=lib[0.0][0], library_kernels=lib[0.1][2],
                                   n_split=main["n_split"], split_ms=main["split_ms"],
                                   split_ms_dropout0=r0["split_ms"]),
        "K2 flash bwd": kernel_row("K2 flash bwd", max(main["err2"], r0["err2"]), main["ms2"], main["plain2"],
                                   flops2, bytes2, lib2, call_ms=main["call2"], ms_dropout0=r0["ms2"],
                                   plain_ms_dropout0=r0["plain2"], library_ms_dropout0=lib[0.0][1],
                                   library_kernels=lib[0.1][2]),
        # SDPA's backward computes dq, dk and dv together: the library time of the pair K3a + K3b
        "cross3a": dict(max_abs_err_cross=max(main["err3a"], r0["err3a"]), ms_cross=main["ms3a"],
                        call_ms_cross=main["call3a"], ms_cross_dropout0=r0["ms3a"],
                        plain_ms_cross=main["plain2"],
                        bound_ms_cross=max(flops3a / PEAK_BF16_FLOPS, bytes3a / PEAK_BYTES) * 1e3,
                        library_ms_cross=lib2, library_ms_cross_dropout0=lib[0.0][1],
                        library_device_ms_cross=lib[0.1][3], library_device_ms_cross_dropout0=lib[0.0][3],
                        n_split_cross=main["n_split3a"], split_ms_cross=main["split_ms3a"],
                        split_ms_cross_dropout0=r0["split_ms3a"], launch_record_cross=main["info3a"]),
        # L2b at 1-8 key chunks on the per-head copies of the dropout-0 inputs
        "l2b_sweep": dict(split_ms_cross=r0["split_ms_l2b"], max_abs_err_splits=r0["err_l2b"]),
        "cross3b": dict(max_abs_err_cross=max(main["err3b"], r0["err3b"]), ms_cross=main["ms3b"],
                        call_ms_cross=main["call3b"], ms_cross_dropout0=r0["ms3b"],
                        plain_ms_cross=main["plain2"],
                        bound_ms_cross=max(flops3b / PEAK_BF16_FLOPS, bytes3b / PEAK_BYTES) * 1e3,
                        library_ms_cross=lib2, library_ms_cross_dropout0=lib[0.0][1],
                        library_device_ms_cross=lib[0.1][3], library_device_ms_cross_dropout0=lib[0.0][3],
                        launch_record_cross=main["info3b"]),
        # K4 reads nothing and writes the mask; its hash is integer work, which the bf16 peak does not rate
        "K4 keep mask": kernel_row("K4 keep mask", 0.0, ms4, plain4, 0, B * HEADS * lq_p * lk_p + 4, None,
                                   call_ms=call4, fill_ms=fill4),
    }


def check_k1c_launch(record):
    """The launch record of K1c's kernel (threads, grid, shared memory, as
    the trace gives them) must be the wrapper's plan (causal_fwd_plan, read
    from the library that launches it)."""
    plan = fp.causal_fwd_plan(B, HEADS, LQ)
    want = {key: plan[key] for key in ("threads", "grid", "smem_bytes")}
    got = {key: (record or {}).get(key) for key in want}
    if got != want:
        raise AssertionError(f"K1c: the trace recorded {got}, the plan launched {want}")
    log(f"  K1c launch: {plan['grid'][0]} blocks of {plan['threads']} threads ({plan['consumers']} consumer "
        f"warpgroups), {plan['smem_bytes']} B shared, as planned; trace: {record}")


def band_mask(lengths, window, dev):
    """[B, L, L] bool: query q sees key k (valid target position, causal,
    and within the window when window > 0)."""
    pos = torch.arange(LQ, device=dev)
    band = pos[None, :] <= pos[:, None]
    if window > 0:
        band &= pos[None, :] >= pos[:, None] - window
    return band[None] & (pos[None, None, :] < lengths[:, None, None])


def phase_self(dev):
    """K1c, K3a and K3b at the paper's self-attention shape."""
    g = torch.Generator(device=dev).manual_seed(1)
    bq, bk = fp.mask_geometry(LQ, LQ, *OP_BLOCKS)
    lengths = torch.tensor(TARGET_LENGTHS, device=dev)
    pos = torch.arange(LQ, device=dev)
    kv_valid = (pos[None, :] < lengths[:, None]).contiguous()
    kv_len = torch.full((B,), LQ, dtype=torch.int32, device=dev)
    seed = torch.tensor([1268100], dtype=torch.int32, device=dev)
    rows = kv_valid  # valid query rows: each sees itself
    q, k, v, do = (torch.randn((B, LQ, HEADS * 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(4))
    do = do * rows[:, :, None]  # compared on valid query rows only: no cotangent on pad rows
    n_keys = int(lengths.sum())
    qb, stats, small = q.numel() * 2, B * HEADS * LQ * 4, kv_valid.numel() + B * 4
    kv_bytes = n_keys * HEADS * 64 * 2
    log(f"[self] B {B} L {LQ} H {HEADS}x64 bf16, blocks {bq}/{bk}, target lengths {list(TARGET_LENGTHS)}")
    out = {}
    for window, rates in ((WINDOW, (0.0, 0.1)), (-1, (0.1,))):
        see = band_mask(lengths, window, dev)
        # the forward computes every row; the backward's cotangent is zero on pad rows
        pairs, pairs_valid = HEADS * int(see.sum()), HEADS * int((see & rows[:, :, None]).sum())
        work = {"K1c": (4 * 64 * pairs, 2 * qb + 2 * kv_bytes + small + stats),
                "K3a": (6 * 64 * pairs_valid, 3 * qb + 2 * stats + 2 * kv_bytes + small),
                "K3b": (8 * 64 * pairs_valid, 2 * qb + 2 * stats + 2 * kv_bytes + small + 2 * qb)}
        log(f"[self] window {window}: {pairs // HEADS} (query, key) pairs to see over the batch, "
            f"{pairs_valid // HEADS} from valid query rows")
        mask_sdpa = see[:, None]  # [B, 1, L, L]
        for rate in rates:
            o_k, lse_k = fp.flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk, window)
            delta = fp.attention_delta(do, o_k, HEADS)
            args = (q, k, v, kv_len, kv_valid, seed, do, lse_k, delta, rate, HEADS, bq, bk, True, window)
            dq_k = fp.flash_dq_cuda(*args)
            dk_k, dv_k = fp.flash_dkv_cuda(*args)
            torch.cuda.synchronize()
            qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
            o_p, lse_p = fp.flash_attention_plain(qr, kr, vr, kv_len, kv_valid, seed, rate, HEADS, True, window, bq, bk)
            dq_p, dk_p, dv_p = torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True)
            log(f"[self] window {window}, dropout {rate}")
            lrows = rows[:, None, :].expand_as(lse_k)
            r = dict(window=window, rate=rate, pairs=pairs)
            r["err1c"] = max(check_vs("K1c o", o_k[rows], o_p[rows]), check_lse("K1c lse", lse_k[lrows], lse_p[lrows]))
            r["err3a"] = check_vs("K3a dq", dq_k[rows], dq_p[rows])
            r["err3b"] = max(check_vs("K3b dk", dk_k, dk_p), check_vs("K3b dv", dv_k, dv_p))
            if window > 0 and rate == 0.0:  # second witness: the windowed decoder's banded attention
                key_bias = torch.where(kv_valid, 0.0, -1e9)
                heads = [t.float().view(B, LQ, HEADS, 64) for t in (q, k, v)]
                o_b = banded_causal_attention(*heads, window, key_bias).reshape(B, LQ, HEADS * 64)
                r["err_banded"] = check_vs("K1c o vs banded attention", o_k[rows], o_b[rows])
                hb = [t.detach().clone().requires_grad_() for t in heads]
                o_bg = banded_causal_attention(*hb, window, key_bias)
                do_b = do.float().view(B, LQ, HEADS, 64)
                r["banded_fwd_ms"] = time_ms(lambda: banded_causal_attention(*heads, window, key_bias), reps=3)
                r["banded_bwd_ms"] = time_ms(lambda: torch.autograd.grad(o_bg, hb, do_b, retain_graph=True), reps=3)
                log(f"  banded plain attention: fwd {r['banded_fwd_ms']:.3f} ms, bwd {r['banded_bwd_ms']:.3f} ms (f32)")
                del o_b, o_bg, hb, heads
            r["ms1c"], r["call1c"] = kernel_times("K1c flash fwd causal", lambda: fp.flash_fwd_causal_cuda(
                q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk, window))
            check_k1c_launch(KERNEL_INFO.get("K1c flash fwd causal"))
            r["ms3a"], r["call3a"] = kernel_times("K3a flash dq", lambda: fp.flash_dq_cuda(*args), per_launch=1)
            r["ms3b"], r["call3b"] = kernel_times("K3b flash dk/dv", lambda: fp.flash_dkv_cuda(*args))
            r["plain_fwd"] = time_ms(lambda: fp.flash_attention_plain(q, k, v, kv_len, kv_valid, seed, rate, HEADS,
                                                                      True, window, bq, bk), reps=3, warmup=1)
            r["plain_bwd"] = time_ms(lambda: torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True),
                                     reps=3, warmup=1)
            log(f"  K1c {r['ms1c']:.4f} ms, K3a {r['ms3a']:.4f} ms, K3b {r['ms3b']:.4f} ms on the device; calls "
                f"{r['call1c']:.3f}, {r['call3a']:.3f}, {r['call3b']:.3f} ms (plain fwd {r['plain_fwd']:.3f} ms, "
                f"bwd {r['plain_bwd']:.3f} ms)")
            out[(window, rate)] = r
            del o_p, lse_p, dq_p, dk_p, dv_p, qr, kr, vr, args, delta
        # library yardstick (never called by the port): SDPA with the same boolean band mask, dropout 0
        qs, ks, vs = (t.view(B, LQ, HEADS, 64).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_f = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask_sdpa))
        o_s = sdpa(qs, ks, vs, attn_mask=mask_sdpa)
        do_s = do.view(B, LQ, HEADS, 64).transpose(1, 2)
        lib_b = time_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True))
        log(f"[self] window {window} library: SDPA fwd {lib_f:.3f} ms, bwd {lib_b:.3f} ms (bool band mask, dropout 0)")
        for rate in rates:
            out[(window, rate)].update(work=work, lib_fwd=lib_f, lib_bwd=lib_b)
        del o_s, qs, ks, vs, see, mask_sdpa
        torch.cuda.empty_cache()

    main, r0, full = out[(WINDOW, 0.1)], out[(WINDOW, 0.0)], out[(-1, 0.1)]

    def row(name, key, lib, wk):
        err = max(main["err" + key], r0["err" + key], full["err" + key])
        return kernel_row(name, err, main["ms" + key], main["plain_fwd" if key == "1c" else "plain_bwd"],
                          *main["work"][wk], lib, call_ms=main["call" + key], ms_dropout0=r0["ms" + key],
                          ms_full_causal=full["ms" + key],
                          bound_ms_full_causal=max(full["work"][wk][0] / PEAK_BF16_FLOPS,
                                                   full["work"][wk][1] / PEAK_BYTES) * 1e3,
                          library_ms_full_causal=full["lib_fwd" if key == "1c" else "lib_bwd"])

    banded = dict(banded_fwd_ms=r0["banded_fwd_ms"], banded_bwd_ms=r0["banded_bwd_ms"],
                  max_abs_err_vs_banded=r0["err_banded"])
    return {
        "K1c flash fwd causal": row("K1c flash fwd causal", "1c", main["lib_fwd"], "K1c") | banded,
        "K3a flash dq": row("K3a flash dq", "3a", main["lib_bwd"], "K3a"),
        "K3b flash dk/dv": row("K3b flash dk/dv", "3b", main["lib_bwd"], "K3b"),
    }


def stem_inputs(name, dev, p):
    """bf16 input, HWIO weights and the dropout draw of one stem block at b8."""
    f_in, _, _, ci, co, h, wp = STEM_BLOCKS[name]
    g = torch.Generator(device=dev).manual_seed(5 + list(STEM_BLOCKS).index(name))

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    args = [randn(B, h, wp, f_in * ci), randn(3, 3, ci, co, scale=0.3), randn(co, scale=0.1),
            randn(3, 3, co, co, scale=0.1), randn(co, scale=0.1), randn(3, 3, co, co, scale=0.1), randn(co, scale=0.1)]
    drop = None if p is None else fs.make_drop_ctx(g, p, (B, h, wp, f_in * co), co)
    return args, drop


def stem_work(name, drop):
    """(K5a, K5b) of one block as (operations, bytes) of the original 3x3
    products and of x, y2, out (bf16) and the u8 bits a kernel must read:
    K5a reads bits only when site 1 or 2 runs elementwise dropout, K5b when
    site 3 does (the draw decides; its other sites multiply by 1 or by a
    channel factor)."""
    f_in, f_out, (sh, sw), ci, co, h, wp = STEM_BLOCKS[name]
    px, px3 = B * h * wp * f_in, B * -(-h // sh) * wp * f_out  # pixels of y2 and of out
    pos, use_elem = (0, 0) if drop is None else (int(drop["pos"]), int(drop["use_elem"]))
    bits_a = px * co if use_elem and pos in (1, 2) else 0
    bits_b = px3 * co if use_elem and pos == 3 else 0
    k5a = (2 * px * 9 * co * (ci + co), px * ci * 2 + bits_a + px * co * 2 + B * 2 * co * 4)
    k5b = (2 * px3 * 9 * co * co, px * co * 2 + B * 2 * co * 4 + bits_b + px3 * co * 2)
    return k5a, k5b


def ptxas_spills(lib: str, symbol: str) -> dict:
    """{kernel instance: ptxas's register and spill line} for the instances
    of `symbol` in library `lib`'s build log."""
    out, current = {}, None
    for line in cuda_build.build_log(lib).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1) if symbol in m.group(1) else None
        elif current and ("spill" in line or "registers" in line):
            out[current] = (out.get(current, "") + " " + line.strip()).strip()
    return out


def stem_launch(kind, plan, record):
    """The log line and the kernels-line entry of one bf16 stem kernel's
    launch: the trace's launch record of its longest kernel, held against
    the wrapper's plan (k1_plan/k2_plan, whose shared memory comes from the
    kernels' own layout, csrc/fused_stem_layout.h): the threads, the grid
    and the shared memory the trace recorded must be the plan's. The entry
    keeps the record and the launch's arguments (rows a stage, strips and
    segments an image)."""
    want = dict(threads=160, grid=[plan.grid, 1, 1], smem_bytes=plan.smem)
    got = {key: (record or {}).get(key) for key in want}
    log(f"  {kind} launch: {plan.grid} blocks of 160 threads (a consumer warpgroup and its producer warp, "
        f"{plan.blocks_per_sm} a SM by the plan), {plan.rows} rows a stage, "
        f"{plan.n_strips} strips x {plan.n_seg} segments of {plan.seg_len} rows an image, {plan.smem} B shared; "
        f"trace: {record}")
    if got != want:
        raise AssertionError(f"{kind}: the trace recorded {got}, the plan launched {want}")
    return dict(record=record, rows=plan.rows, n_strips=plan.n_strips, n_seg=plan.n_seg, seg_len=plan.seg_len,
                setmaxnreg="none: one producer warp a consumer warpgroup")


def phase_stem(dev):
    """K5a and K5b at the three stem block shapes (b8, bf16), dropout 0.5
    and none: each kernel against its plain version, the whole block against
    reference_block; device times, the plain block's forward, the cuDNN
    convolutions of the same block alone, and forward + backward of the
    fused block against plain autograd; each kernel's launch record,
    held against its plan."""
    t0 = time.perf_counter()
    rows = {}
    for lib, sym in (("fused_stem_k1", "fused_stem_k1_tma"), ("fused_stem_k2", "fused_stem_k2_tma")):
        for inst, line in ptxas_spills(lib, sym).items():
            log(f"[stem] ptxas {inst}: {line}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (f_in, f_out, stride, ci, co, h, wp) in STEM_BLOCKS.items():
        for p in (STEM_DROPOUT, None):
            (x, w1, b1, w2, b2, w3, b3), drop = stem_inputs(name, dev, p)
            kw = dict(f_in=f_in, f_out=f_out, stride=stride)
            draw = "none" if drop is None else f"pos {int(drop['pos'])}, use_elem {int(drop['use_elem'])}"
            log(f"[stem] {name}: x {tuple(x.shape)} bf16, ci {ci} -> co {co}, stride {stride}, dropout {p} ({draw})")
            y2, stats = fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in)
            mean_inv = fs.norm_from_stats(stats, h * wp * f_in, 1e-3)
            out = fs.fused_stem_k2_cuda(y2, mean_inv, w3, b3, drop, **kw)
            block = fs.fused_packed_block(x, w1, b1, w2, b2, w3, b3, drop=drop, **kw)
            torch.cuda.synchronize()
            y2_p, stats_p = fs.plain_k1(x, w1, b1, w2, b2, f_in=f_in, drop=drop)
            r = dict(pos=None if drop is None else int(drop["pos"]),
                     use_elem=None if drop is None else int(drop["use_elem"]))
            r["err_a"] = check_vs("K5a y2", y2, y2_p)
            r["stats_rel_err"] = check_vs("K5a stats", stats, stats_p) / float(stats_p.abs().max())
            del y2_p, stats_p
            r["err_b"] = check_vs("K5b out", out, fs.plain_k2(y2, mean_inv, w3, b3, drop=drop, **kw))
            r["err_block"] = check_vs("K5a+K5b block", block, fs.reference_block(x, w1, b1, w2, b2, w3, b3,
                                                                                  drop=drop, **kw))
            del block
            torch.cuda.empty_cache()
            r["ms_a"], r["call_a"] = kernel_times("K5a fused stem k1", lambda: fs.fused_stem_k1_cuda(
                x, w1, b1, w2, b2, drop, f_in=f_in))
            r["launch_a"] = stem_launch("K5a", fs.k1_plan(B, h, wp * f_in, ci, co, drop is not None, n_sm),
                                        KERNEL_INFO.get("K5a fused stem k1"))
            r["ms_b"], r["call_b"] = kernel_times("K5b fused stem k2", lambda: fs.fused_stem_k2_cuda(
                y2, mean_inv, w3, b3, drop, **kw))
            r["launch_b"] = stem_launch("K5b", fs.k2_plan(B, h, wp * f_in, co, stride, f_out, drop is not None,
                                                                n_sm), KERNEL_INFO.get("K5b fused stem k2"))
            r["plain_ms"] = time_ms(lambda: fs.reference_block(x, w1, b1, w2, b2, w3, b3, drop=drop, **kw))
            r["convs12_ms"] = time_ms(lambda: packed_conv(packed_conv(x, w1, b1, f_in, f_in, (1, 1)), w2, b2, f_in,
                                                          f_in, (1, 1)))
            r["conv3_ms"] = time_ms(lambda: packed_conv(y2, w3, b3, f_in, f_out, stride))
            (ops_a, bytes_a), (ops_b, bytes_b) = stem_work(name, drop)
            r["bound_a"] = max(ops_a / PEAK_BF16_FLOPS, bytes_a / PEAK_BYTES) * 1e3
            r["bound_b"] = max(ops_b / PEAK_BF16_FLOPS, bytes_b / PEAK_BYTES) * 1e3
            r["by_a"] = "operations" if ops_a / PEAK_BF16_FLOPS >= bytes_a / PEAK_BYTES else "bytes"
            r["by_b"] = "operations" if ops_b / PEAK_BF16_FLOPS >= bytes_b / PEAK_BYTES else "bytes"
            log(f"  K5a {r['ms_a']:.3f} ms (call {r['call_a']:.3f}, bound {r['bound_a']:.4f}), K5b {r['ms_b']:.3f} ms "
                f"(call {r['call_b']:.3f}, bound {r['bound_b']:.4f}); plain block fwd {r['plain_ms']:.3f} ms, "
                f"cuDNN conv1+conv2 {r['convs12_ms']:.3f} ms, conv3 {r['conv3_ms']:.3f} ms")
            if p is not None:  # forward + backward, fused against plain autograd
                gout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(9),
                                   device=dev).to(out.dtype)
                leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2, w3, b3)]

                def fwd_bwd(block_fn):
                    return torch.autograd.grad(block_fn(*leaves, drop=drop, **kw), leaves, gout)

                r["fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(fs.fused_packed_block), reps=3, warmup=1)
                r["plain_fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(fs.reference_block), reps=3, warmup=1)
                log(f"  forward + backward: fused {r['fwd_bwd_ms']:.3f} ms, plain {r['plain_fwd_bwd_ms']:.3f} ms")
            rows[(name, p)] = r
            del x, w1, b1, w2, b2, w3, b3, drop, y2, stats, mean_inv, out
            torch.cuda.empty_cache()
    log(f"[stem] kernel checks and timings took {time.perf_counter() - t0:.1f} s")
    return rows


def stem_path(dev):
    """The fused block's entry point at the three stem block shapes (b8,
    bf16, dropout 0.5), forward and backward, counted from 0: K5a and K5b
    once per block, no other kernel; gradients finite and within tolerance
    of plain autograd through reference_block."""
    inputs = {name: stem_inputs(name, dev, STEM_DROPOUT) for name in STEM_BLOCKS}
    errs = {}
    reset_counts()
    for name, (args, drop) in inputs.items():
        f_in, f_out, stride, *_ = STEM_BLOCKS[name]
        kw = dict(f_in=f_in, f_out=f_out, stride=stride, drop=drop)
        leaves = [t.detach().requires_grad_() for t in args]
        out = fs.fused_packed_block(*leaves, **kw)
        gout = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(10), device=dev).to(out.dtype)
        out.backward(gout)
        inputs[name] = (leaves, out.detach(), gout, kw)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[stem path] kernel launches {launches}")
    want = {name: 3 if name in ("K5a fused stem k1", "K5b fused stem k2") else 0 for name in KERNELS}
    if launches != want:
        raise AssertionError(f"stem path launched {launches}, expected {want}")
    for name, (leaves, out, gout, kw) in inputs.items():
        ref_leaves = [t.detach().requires_grad_() for t in leaves]
        ref = fs.reference_block(*ref_leaves, **kw)
        ref.backward(gout)
        if not torch.isfinite(out.float()).all() or not all(torch.isfinite(t.grad.float()).all() for t in leaves):
            raise AssertionError(f"stem path {name}: non-finite output or gradient")
        log(f"[stem path] {name}")
        errs[name] = max([check_vs("block out", out, ref)] +
                         [check_vs(f"d{n}", t.grad, r.grad) for n, t, r in
                          zip(("x", "w1", "b1", "w2", "b2", "w3", "b3"), leaves, ref_leaves)])
    del inputs
    torch.cuda.empty_cache()
    return launches, errs


def stem_rows(rows, launches, errs):
    """The K5a and K5b entries of the kernels line: times and bounds summed
    over the three blocks at dropout 0.5, per-block numbers inside."""
    out = {}
    for key, name, conv in (("a", "K5a fused stem k1", "convs12_ms"), ("b", "K5b fused stem k2", "conv3_ms")):
        main = [rows[(blk, STEM_DROPOUT)] for blk in STEM_BLOCKS]
        none = [rows[(blk, None)] for blk in STEM_BLOCKS]
        bound = sum(r["bound_" + key] for r in main)
        by = "operations" if any(r["by_" + key] == "operations" for r in main) else "bytes"
        per_block = {blk: dict(ms=r["ms_" + key], call_ms=r["call_" + key], bound_ms=r["bound_" + key],
                               bound_by=r["by_" + key], plain_ms=r["plain_ms"], convs_ms=r[conv],
                               pos=r["pos"], use_elem=r["use_elem"], max_abs_err=r["err_" + key],
                               max_abs_err_block=r["err_block"], fwd_bwd_ms=r["fwd_bwd_ms"],
                               plain_fwd_bwd_ms=r["plain_fwd_bwd_ms"], ms_dropout_none=n["ms_" + key],
                               plain_ms_dropout_none=n["plain_ms"], max_abs_err_dropout_none=n["err_" + key],
                               max_abs_err_path=errs[blk], launch=r["launch_" + key],
                               launch_dropout_none=n["launch_" + key])
                     | (dict(stats_rel_err=max(r["stats_rel_err"], n["stats_rel_err"])) if key == "a" else {})
                     for blk, r, n in zip(STEM_BLOCKS, main, none)}
        out[name] = dict(name=name, route="cuda", source=CSRC + KERNELS[name][1], replaces=KERNELS[name][2],
                         launches=launches[name],
                         max_abs_err=max(max(r["err_" + key], r["err_block"]) for r in main + none),
                         ms=sum(r["ms_" + key] for r in main), plain_ms=sum(r["plain_ms"] for r in main),
                         bound_ms=bound, bound_by=by, library_ms=None,
                         library_note="no one PyTorch call computes the fused convolutions, ReLU, dropout "
                                      "and instance norm; convs_ms times the block's cuDNN convolutions alone",
                         convs_ms=sum(r[conv] for r in main),
                         call_ms=sum(r["call_" + key] for r in main), blocks=per_block)
    return out


def build(dev, mesh=None, **hp):
    hp = {**dict(vocab_size=VOCAB, max_seq_len=LQ, input_modality="image", use_flash_cross=True,
                 cache_dtype="bfloat16"), **hp}
    model, _ = build_model(hp, device=dev, seed=0, mesh=mesh)
    return model


def train_batch(dev, g):
    raw = torch.randint(0, 256, (B, IMG_H, IMG_W), generator=g, device=dev, dtype=torch.uint8)
    x, hw = preprocess_image_batch(raw, ragged_hw(B, dev))
    lengths = torch.randint(LQ // 2, LQ, (B,), generator=g, device=dev)
    toks = torch.randint(3, VOCAB, (B, LQ + 1), generator=g, device=dev)
    pos = torch.arange(LQ + 1, device=dev)[None]
    toks = torch.where(pos == 0, SOS, toks)
    toks = torch.where(pos == lengths[:, None], EOS, toks)
    toks = torch.where(pos > lengths[:, None], 0, toks)
    return {"x": x, "x_hw": hw, "y_in": toks[:, :-1], "y_out": toks[:, 1:]}


def phase_train(model, dev, tag, n_steps=3):
    """n_steps bf16 train steps; returns (step, state, batch, generator, stats)."""
    g = torch.Generator(device=dev).manual_seed(2)
    batch = train_batch(dev, g)
    step = make_train_step(model, VOCAB, teacher_forcing_prob=0.2, bf16_compute=True)
    state = TrainState.create(model, lr=1e-4)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, g)
        loss = float(loss)  # waits for the step
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        log(f"[{tag} train] step {i}: loss {loss:.4f}, {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[{tag} train] peak memory {peak:.2f} GiB")
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite train loss: {losses}")
    return step, state, batch, g, dict(steps=n_steps, step_ms=times, loss=losses, peak_gib=peak)


def kernel_kind(name: str) -> str:
    """Coarse class of a device kernel, by its name."""
    low = name.lower()
    if "flash_fwd_causal" in low:
        return "K1c flash fwd causal"
    for key, kind in (("lfany_fwd_kernel", "LA legacy flash fwd, any dtype"),
                      ("lfany_dq_kernel", "LA legacy flash dq, any dtype"),
                      ("lfany_dkv_kernel", "LA legacy flash dk/dv, any dtype"),
                      ("lf_fwd_lse_chunk", "L2a legacy flash fwd lse"), ("lf_fwd_chunk", "L1 legacy flash fwd"),
                      ("lf_dq_", "L2b legacy flash dq"), ("lf_dkv_kernel", "L2c legacy flash dk/dv"),
                      ("flash_fwd", "K1 flash fwd"), ("flash_bwd", "K2 flash bwd"), ("flash_dq", "K3a flash dq"),
                      ("flash_dkv", "K3b flash dk/dv"), ("keep_mask", "K4 keep mask"),
                      ("fused_stem_k1", "K5a fused stem k1"), ("fused_stem_k2", "K5b fused stem k2")):
        if key in low:
            return kind
    if re.search(r"conv|cudnn|implicit_gemm|wgrad|dgrad|fprop", low):
        return "convolution"
    if re.search(r"gemm|nvjet|cutlass|xmma", low):
        return "matmul"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def trace_summary(path: Path) -> dict:
    """Device busy time, span and time by kernel class of a chrome trace;
    elementwise and reduction time also by the aten op that launched it."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    op_of = {e["args"].get("External id"): e["name"] for e in events if e.get("cat") == "cpu_op"}
    by_kind, by_op = Counter(), Counter()
    for e in kernels:
        kind = kernel_kind(e["name"])
        by_kind[kind] += e["dur"] / 1e3
        if kind in ("elementwise", "reduction"):
            by_op[op_of.get(e["args"].get("External id"), "?")] += e["dur"] / 1e3
    busy = sum(by_kind.values())
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    return dict(busy_ms=busy, span_ms=span, by_kind=dict(by_kind.most_common()),
                elementwise_by_op=dict(by_op.most_common(8)))


def profile_step(step, state, batch, g, out_dir: Path, tag: str):
    """One traced train step: device time by kernel, table and trace to out_dir."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, g)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / f"{tag}_train_step_profile.txt").write_text(table)
    trace = out_dir / f"{tag}_train_step_trace.json"
    prof.export_chrome_trace(str(trace))
    summary = trace_summary(trace)
    log(f"[{tag} profile] device busy {summary['busy_ms']:.3f} ms of a {summary['span_ms']:.3f} ms span")
    for kind, ms in summary["by_kind"].items():
        log(f"[{tag} profile]   {kind:20s} {ms:9.3f} ms {100 * ms / summary['busy_ms']:5.1f}%")
    for op, ms in summary["elementwise_by_op"].items():
        log(f"[{tag} profile]   elementwise/reduction in {op}: {ms:.3f} ms")
    return summary


def phase_serve(model, dev, tag):
    g = torch.Generator(device=dev).manual_seed(3)
    raw = torch.randint(0, 256, (4, IMG_H, IMG_W), generator=g, device=dev, dtype=torch.uint8)
    hw = ragged_hw(4, dev)
    transcribe = make_image_transcriber(model, SOS, EOS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, scores = transcribe(raw, hw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    steps = int((tokens != 0).any(0).sum())
    log(f"[{tag} serve] tokens {tuple(tokens.shape)} {tokens.dtype}, {steps} decode steps run, "
        f"self-cache {model.decoder.cache_len} slots, {ms:.1f} ms ({ms / max(steps, 1):.3f} ms/step)")
    if tokens.shape != (4, LQ) or not torch.isfinite(scores).all() or int(tokens.max()) >= VOCAB:
        raise AssertionError("decode output has the wrong shape or values")
    return dict(decode_ms=ms, steps=steps, batch=4, cache_len=model.decoder.cache_len)


def model_path(dev, tag, out_dir, profile, serve=True, **hp):
    """Train and serve one model with every launch count from 0; each of K1
    and K2 must launch once per decoder layer and step, no other kernel.
    ``serve=False`` leaves the decode to another path (the paper model's is
    the quant path's bf16 decode)."""
    model = build(dev, **hp)
    reset_counts()
    step, state, batch, g, train = phase_train(model, dev, tag)
    serve = phase_serve(model, dev, tag) if serve else None
    launches = read_counts()
    log(f"[{tag} path] kernel launches {launches}")
    want = {name: 8 * train["steps"] if name in ("K1 flash fwd", "K2 flash bwd") else 0 for name in KERNELS}
    if launches != want:
        raise AssertionError(f"{tag} path launched {launches}, expected {want}")
    summary = profile_step(step, state, batch, g, out_dir, tag) if profile else None
    del model, step, state, batch
    torch.cuda.empty_cache()
    return dict(hparams=hp, train=train, serve=serve, launches=launches, profile=summary)


QUANT_DTYPES = ("bfloat16", "int8", "int4")
# the quant path's decodes run to this max_seq_len: past its 101-slot ring the self-attention's cost a step is flat,
# so it reads the ms a step of the paper model's 1,268-step decode in 40% of the time
QUANT_LEN = 512
# one step's logits from int8/int4 codes against the same step over the dequantized K/V in float32: the
# quantized path rounds q and the softmax weights to bf16 before its products (1.1-1.6e-3 of max |logits| on
# the CPU at a cut size)
QUANT_TOL = 1e-2


def cross_bytes(cross) -> int:
    return sum(t.numel() * t.element_size() for entry in cross.values() for t in entry.values())


def dequantized(cross) -> dict:
    """Each layer's quantized cross entry as float32 K/V: codes x token scale x channel scale."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops.attention import unpack_int4

    out = {}
    for layer, e in cross.items():
        out[layer] = {}
        for n in ("k", "v"):
            codes = (unpack_int4(e[n]) if e[n].dtype == torch.uint8 else e[n]).float()
            if f"{n}_tscale" in e:
                codes = codes * e[f"{n}_tscale"][:, :, None]
            out[layer][n] = codes * e[f"{n}_scale"][:, None, :]
    return out


def quant_path(dev):
    """The paper model at full width (random weights from seed 0, the
    paper path's model; its bf16 decode is that path's) decodes a
    b4 batch of raw 361x4416 images (the flagship memory, 12,696 keys)
    greedily through make_image_transcriber, once per cache_dtype (bf16,
    int8, int4: the runtime knob build_from_checkpoint overrides), counted
    from 0: no kernel launches. For each: ms a step, peak memory, the cross
    cache's resident bytes, tokens equal to the bf16 decode's; for int8 and
    int4, one step's logits within QUANT_TOL x max |ref| of the same step
    over the explicitly dequantized K/V in float32. The decodes run to
    QUANT_LEN steps."""
    model = build(dev, attn_window=WINDOW, packed_stem=True, max_seq_len=QUANT_LEN)
    cache_len = model.decoder.cache_len
    g = torch.Generator(device=dev).manual_seed(3)
    raw = torch.randint(0, 256, (4, IMG_H, IMG_W), generator=g, device=dev, dtype=torch.uint8)
    hw = ragged_hw(4, dev)
    out, tokens = {}, {}
    reset_counts()
    for cache_dtype in QUANT_DTYPES:
        model.decoder.cache_dtype = cache_dtype
        with torch.no_grad():
            x, hw2 = preprocess_image_batch(raw, hw)
            cross, valid = model.decode_prefill(x, hw2)
            nbytes = cross_bytes(cross)
            row = dict(cross_bytes=nbytes, cross_keys=int(next(iter(cross.values()))["k"].shape[1]))
            if cache_dtype != "bfloat16":
                tok = torch.full((4,), SOS, dtype=torch.long, device=dev)
                lq, _ = model.decode_step(tok, 0, model.decode_init_cache(4), cross, valid)
                lr, _ = model.decode_step(tok, 0, model.decode_init_cache(4), dequantized(cross), valid)
                row["logits_rel_err"] = max_err(lq, lr) / float(lr.abs().max())
                if not row["logits_rel_err"] <= QUANT_TOL:
                    raise AssertionError(f"quant {cache_dtype}: step logits {row['logits_rel_err']:.3e} of max |ref| "
                                         f"from the dequantized float32 step (tolerance {QUANT_TOL})")
                del lq, lr
            del cross, valid, x
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        transcribe = make_image_transcriber(model, SOS, EOS)
        t0 = time.perf_counter()
        tokens[cache_dtype], scores = transcribe(raw, hw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps = int((tokens[cache_dtype] != 0).any(0).sum())
        row.update(decode_ms=ms, steps=steps, ms_per_step=ms / max(steps, 1),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   peak_over_weights_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        if tokens[cache_dtype].shape != (4, QUANT_LEN) or not torch.isfinite(scores).all() \
                or int(tokens[cache_dtype].max()) >= VOCAB:
            raise AssertionError(f"quant {cache_dtype}: tokens {tuple(tokens[cache_dtype].shape)}")
        row["tokens_equal_bf16"] = int((tokens[cache_dtype] == tokens["bfloat16"]).sum())
        first = (tokens[cache_dtype] != tokens["bfloat16"]).int().argmax(1)
        row["first_disagreement"] = [int(p) if bool((tokens[cache_dtype][i] != tokens["bfloat16"][i]).any()) else None
                                     for i, p in enumerate(first)]
        out[cache_dtype] = row
        log(f"[quant {cache_dtype}] b4 greedy, {row['cross_keys']} keys: {ms:.1f} ms, {steps} steps "
            f"({row['ms_per_step']:.2f} ms/step); cross cache {nbytes / 1e6:.1f} MB; peak {row['peak_gib']:.2f} GiB "
            f"({row['peak_over_weights_gib']:.2f} over the weights); tokens equal to bf16's {row['tokens_equal_bf16']} "
            f"of {tokens[cache_dtype].numel()} (first disagreement per row {row['first_disagreement']})"
            + (f"; step logits {row['logits_rel_err']:.2e} of max |ref| from the dequantized float32 step"
               if "logits_rel_err" in row else ""))
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"quant path launched {launches}")
    del model
    torch.cuda.empty_cache()
    return dict(dtypes=out, launches=launches, tolerance=QUANT_TOL, cache_len=cache_len)


def op_path(dev):
    """The op-level entry points that reach K1c, K3a, K3b and K4, counted
    from 0: a windowed causal call with dropout (forward and backward) at the
    paper shape, a merged_bwd=False call at the cross shape and the
    keep-mask probe at the cross shape."""
    g = torch.Generator(device=dev).manual_seed(4)
    lengths = torch.tensor(TARGET_LENGTHS, device=dev)
    valid_self = (torch.arange(LQ, device=dev)[None, :] < lengths[:, None]).contiguous()
    valid_cross = memory_valid_from_hw(ragged_hw(B, dev), GRID_H, GRID_W).contiguous()
    reset_counts()
    for lk, valid, kw in ((LQ, valid_self, dict(causal=True, window=WINDOW, dropout_rate=0.1)),
                          (LK, valid_cross, dict(dropout_rate=0.1, block_k=2048, merged_bwd=False))):
        q, k, v = (torch.randn((B, n, HEADS * 64), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
                   for n in (LQ, lk, lk))
        kv_len = torch.full((B,), lk, dtype=torch.int32, device=dev)
        o = fp.make_flash_attention_packed(HEADS, **kw)(q, k, v, kv_len, valid, 77)
        o.backward(torch.randn(o.shape, generator=g, device=dev).to(o.dtype))
        if not all(torch.isfinite(t.grad.float()).all() for t in (q, k, v)) or not torch.isfinite(o.float()).all():
            raise AssertionError(f"op path {kw}: non-finite output or gradient")
    keep = fp.export_keep_masks(77, B, HEADS, LQ, LK, dropout_rate=0.1, block_q=128, block_k=2048)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[op path] kernel launches {launches}, keep-mask {tuple(keep.shape)} keeps {float(keep.float().mean()):.4f}")
    want = {name: 0 for name in KERNELS} | {"K1 flash fwd": 1, "K1c flash fwd causal": 1, "K3a flash dq": 2,
                                            "K3b flash dk/dv": 2, "K4 keep mask": 1}
    if launches != want:
        raise AssertionError(f"op path launched {launches}, expected {want}")
    del keep
    torch.cuda.empty_cache()
    return launches


def legacy_work(pairs, n_keys, lk, kv_valid, heads=HEADS, d=64):
    """(operations, bytes) of L1, L2a, L2b and L2c at `heads` heads of
    width d for `pairs` (head, query, key) triples that a query sees and
    `n_keys` valid keys over the batch: the products of those pairs; q, o,
    do, dq once, k and v at the valid keys, lse and delta (f32), the key
    masks, and dk and dv written whole."""
    qb = B * heads * LQ * d * 2
    kv_bytes = n_keys * heads * d * 2
    stats = B * heads * LQ * 4
    small = B * 4 + kv_valid.numel()
    return {"L1 legacy flash fwd": (4 * d * pairs, 2 * qb + 2 * kv_bytes + B * 4),
            "L2a legacy flash fwd lse": (4 * d * pairs, 2 * qb + 2 * kv_bytes + stats + small),
            "L2b legacy flash dq": (6 * d * pairs, 3 * qb + 2 * kv_bytes + 2 * stats + small),
            "L2c legacy flash dk/dv": (8 * d * pairs, 2 * qb + 2 * kv_bytes + 2 * stats + small
                                       + 2 * B * heads * lk * d * 2)}


def phase_legacy(dev, cross):
    """L1, L2a, L2b and L2c, per-head [B, H, L, D] bf16, at the flagship
    cross shape with 4 x 64 heads and with 2 x 128 (the model's 256
    columns; L2: the images' kv_valid; L1: kv_len of the same counts) and
    at the paper's self-attention shape (4 x 64, causal, window 100, the
    targets as kv_len for L1 and as kv_valid for L2, so that the pad rows
    past a target see no key): each against its plain version (rows with no
    key: o = 0 and lse = 0 in both), device time with its launch record,
    plain time and SDPA with the same boolean mask (forward beside L1 and
    L2a, backward beside L2b and L2c, both also in device time).
    The head-packed kernels of the cross phase at dropout 0 stand beside
    them: K1 beside L2a, K3a beside L2b (also at 1-8 key chunks), K3b
    beside L2c, K2 beside L2b + L2c."""
    g = torch.Generator(device=dev).manual_seed(6)
    lengths = torch.tensor(TARGET_LENGTHS, dtype=torch.int32, device=dev)
    valid_cross = memory_valid_from_hw(ragged_hw(B, dev), GRID_H, GRID_W).contiguous()
    cross_shape = dict(lk=LK, band=dict(causal=False, window=-1), kv_len1=valid_cross.sum(1).to(torch.int32),
                       kv_valid=valid_cross)
    shapes = {  # the cross shape at D 64 last: its launch records stay in KERNEL_INFO for the kernels line
        "self": dict(lk=LQ, band=dict(causal=True, window=WINDOW), kv_len1=lengths, heads=HEADS, d=64,
                     kv_valid=(torch.arange(LQ, device=dev)[None, :] < lengths[:, None]).contiguous()),
        "cross128": dict(cross_shape, heads=2, d=128),
        "cross": dict(cross_shape, heads=HEADS, d=64),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {name: {} for name in LEGACY_BF16}
    for tag, s in shapes.items():
        lk, band, kv_len1, kv_valid, heads, d = s["lk"], s["band"], s["kv_len1"], s["kv_valid"], s["heads"], s["d"]
        kv_len2 = torch.full((B,), lk, dtype=torch.int32, device=dev)
        q, k, v, do = (torch.randn((B, heads, n, d), generator=g, device=dev).to(torch.bfloat16)
                       for n in (LQ, lk, lk, LQ))
        see = fl.visible_keys(LQ, lk, kv_len2, kv_valid, band["causal"], band["window"])  # [B, 1, Lq or 1, Lk]
        pairs = heads * int(see.sum()) * (LQ if see.shape[2] == 1 else 1)
        work = legacy_work(pairs, int(kv_valid.sum()), lk, kv_valid, heads, d)
        log(f"[legacy {tag}] B {B} H {heads} Lq {LQ} Lk {lk} D {d} bf16, {band}, "
            f"{pairs // heads} (query, key) pairs to see over the batch")

        o1 = fl.legacy_fwd_cuda(q, k, v, kv_len1, **band)
        o2, lse2 = fb.legacy_fwd_lse_cuda(q, k, v, kv_len2, kv_valid, **band)
        bargs = (q, k, v, kv_len2, kv_valid, do, lse2, fb.attention_delta(do, o2), band["causal"], band["window"])
        dq = fb.legacy_dq_cuda(*bargs)
        dk, dv = fb.legacy_dkv_cuda(*bargs)
        torch.cuda.synchronize()
        o1_p, lse1_p = fl.attention_plain(q, k, v, kv_len1, None, **band)
        err = {"L1 legacy flash fwd": check_vs("L1 o", o1, o1_p)}
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o2_p, lse2_p = fl.attention_plain(qr, kr, vr, kv_len2, kv_valid, **band)
        grads_p = torch.autograd.grad(o2_p, (qr, kr, vr), do, retain_graph=True)
        err["L2a legacy flash fwd lse"] = max(check_vs("L2a o", o2, o2_p), check_lse("L2a lse", lse2, lse2_p))
        err["L2b legacy flash dq"] = check_vs("L2b dq", dq, grads_p[0])
        err["L2c legacy flash dk/dv"] = max(check_vs("L2c dk", dk, grads_p[1]), check_vs("L2c dv", dv, grads_p[2]))
        n_empty = []
        for name, o, lse_p, lse_k in (("L1", o1, lse1_p, None), ("L2a", o2, lse2_p, lse2)):
            empty = lse_p.detach() == 0  # the plain version's rows with no key to see
            n_empty.append(int(empty.sum()))
            if o[empty].any() or (lse_k is not None and lse_k[empty].any()):
                raise AssertionError(f"{name}: a row with no key to see must give o = 0 and lse = 0")
        if band["causal"]:
            if not all(n_empty):
                raise AssertionError("the paper shape must have rows with no key to see")
            empty = (lse2_p.detach() == 0)[..., None]
            if (dq * empty).any():
                raise AssertionError("L2b: a row with no key to see must give dq = 0")
        log(f"  rows with no key (o = 0, lse = 0 in kernel and plain version): L1 {n_empty[0]}, L2a {n_empty[1]} "
            f"of {B * heads * LQ}")
        del o1_p, lse1_p, o1, dq, dk, dv

        timed = {"L1 legacy flash fwd": lambda: fl.legacy_fwd_cuda(q, k, v, kv_len1, **band),
                 "L2a legacy flash fwd lse": lambda: fb.legacy_fwd_lse_cuda(q, k, v, kv_len2, kv_valid, **band),
                 "L2b legacy flash dq": lambda: fb.legacy_dq_cuda(*bargs),
                 "L2c legacy flash dk/dv": lambda: fb.legacy_dkv_cuda(*bargs)}
        n_fwd = lf_fwd_kernels(q, k, band["causal"])
        per_launch = {"L1 legacy flash fwd": n_fwd, "L2a legacy flash fwd lse": n_fwd,
                      "L2b legacy flash dq": l2b_kernels(q, k, band["causal"])}
        plain_fwd1 = time_ms(lambda: fl.attention_plain(q, k, v, kv_len1, None, **band), reps=3, warmup=1)
        plain_fwd2 = time_ms(lambda: fl.attention_plain(q, k, v, kv_len2, kv_valid, **band), reps=3, warmup=1)
        plain_bwd = time_ms(lambda: torch.autograd.grad(o2_p, (qr, kr, vr), do, retain_graph=True), reps=3, warmup=1)
        del o2_p, lse2_p, grads_p
        # library yardstick (never called by the port): SDPA on the same [B, H, L, D] tensors and boolean mask
        mask1 = fl.visible_keys(LQ, lk, kv_len1, None, band["causal"], band["window"])
        lib_fwd1 = time_ms(lambda: sdpa(q, k, v, attn_mask=mask1))
        lib_fwd2 = time_ms(lambda: sdpa(q, k, v, attn_mask=see))
        lib_fwd1_dev = device_ms(lambda: sdpa(q, k, v, attn_mask=mask1))
        lib_fwd2_dev = device_ms(lambda: sdpa(q, k, v, attn_mask=see))
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o_s = sdpa(qs, ks, vs, attn_mask=see)
        lib_bwd = time_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do, retain_graph=True))
        lib_bwd_dev = device_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do, retain_graph=True))
        del o_s, qs, ks, vs
        plain = {"L1 legacy flash fwd": plain_fwd1, "L2a legacy flash fwd lse": plain_fwd2,
                 "L2b legacy flash dq": plain_bwd, "L2c legacy flash dk/dv": plain_bwd}
        lib = {"L1 legacy flash fwd": lib_fwd1, "L2a legacy flash fwd lse": lib_fwd2,
               "L2b legacy flash dq": lib_bwd, "L2c legacy flash dk/dv": lib_bwd}
        for name, fn in timed.items():
            ms, call = kernel_times(name, fn, per_launch=per_launch.get(name))
            ops, nbytes = work[name]
            t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            rows[name][tag] = dict(err=err[name], ms=ms, call_ms=call, plain_ms=plain[name], library_ms=lib[name],
                                   work=work[name], bound_ms=max(t_ops, t_bytes) * 1e3,
                                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                                   launch_record=dict(KERNEL_INFO.get(name, {})))
            rows[name][tag]["library_device_ms"] = {"L1 legacy flash fwd": lib_fwd1_dev,
                                                    "L2a legacy flash fwd lse": lib_fwd2_dev}.get(name, lib_bwd_dev)
        log("  " + ", ".join(f"{n.split()[0]} {rows[n][tag]['ms']:.4f} ms (call {rows[n][tag]['call_ms']:.3f}, "
                               f"bound {rows[n][tag]['bound_ms']:.4f})" for n in timed))
        pair = rows["L2b legacy flash dq"][tag]["ms"] + rows["L2c legacy flash dk/dv"][tag]["ms"]
        ms1, ms2 = rows["L1 legacy flash fwd"][tag]["ms"], rows["L2a legacy flash fwd lse"][tag]["ms"]
        log(f"  plain fwd {plain_fwd1:.3f} (L1) / {plain_fwd2:.3f} (L2a) ms, plain autograd bwd {plain_bwd:.3f} ms; "
            f"SDPA fwd {lib_fwd1:.3f} / {lib_fwd2:.3f} ms (device {lib_fwd1_dev:.4f} / {lib_fwd2_dev:.4f} ms), "
            f"bwd {lib_bwd:.3f} ms (device {lib_bwd_dev:.4f} ms); L1 {ms1 / lib_fwd1_dev:.3f} x and L2a "
            f"{ms2 / lib_fwd2_dev:.3f} x SDPA's forward device time; L2b + L2c {pair:.4f} ms, "
            f"{pair / lib_bwd_dev:.3f} x SDPA's backward device time")
        for name in LEGACY_BF16:
            log(f"  {name.split()[0]} launch record: {rows[name][tag]['launch_record']}")
        check_legacy_blocks(rows, tag, q, k, band["causal"])
        del q, k, v, do, o2, lse2, bargs, qr, kr, vr, see, mask1, timed
        torch.cuda.empty_cache()

    # the head-packed kernels of the same function at the cross shape, dropout 0
    packed = {"L2a legacy flash fwd lse": dict(k1_ms_dropout0=cross["K1 flash fwd"]["ms_dropout0"]),
              "L2b legacy flash dq": dict(k2_ms_dropout0=cross["K2 flash bwd"]["ms_dropout0"],
                                          k3a_ms_dropout0=cross["cross3a"]["ms_cross_dropout0"],
                                          k3a_split_ms_dropout0=cross["cross3a"]["split_ms_cross_dropout0"],
                                          **cross["l2b_sweep"]),
              "L2c legacy flash dk/dv": dict(k2_ms_dropout0=cross["K2 flash bwd"]["ms_dropout0"],
                                             k3b_ms_dropout0=cross["cross3b"]["ms_cross_dropout0"])}
    ms = {name: r["cross"]["ms"] for name, r in rows.items()}
    log(f"[legacy] per-head vs head-packed at the cross shape, dropout 0: forward L2a "
        f"{ms['L2a legacy flash fwd lse']:.3f} ms vs K1 {cross['K1 flash fwd']['ms_dropout0']:.3f} ms; dq L2b "
        f"{ms['L2b legacy flash dq']:.3f} ms vs K3a {cross['cross3a']['ms_cross_dropout0']:.3f} ms; dk/dv L2c "
        f"{ms['L2c legacy flash dk/dv']:.3f} ms vs K3b {cross['cross3b']['ms_cross_dropout0']:.3f} ms; L2b + L2c "
        f"{ms['L2b legacy flash dq'] + ms['L2c legacy flash dk/dv']:.3f} ms vs K2 "
        f"{cross['K2 flash bwd']['ms_dropout0']:.3f} ms")
    out = {}
    for name, r in rows.items():
        c = r["cross"]
        extra = {}
        for tag in ("self", "cross128"):
            x = r[tag]
            extra |= {f"max_abs_err_{tag}": x["err"], f"ms_{tag}": x["ms"], f"call_ms_{tag}": x["call_ms"],
                      f"plain_ms_{tag}": x["plain_ms"], f"bound_ms_{tag}": x["bound_ms"],
                      f"bound_by_{tag}": x["bound_by"], f"library_ms_{tag}": x["library_ms"],
                      f"launch_record_{tag}": x["launch_record"]}
            if "library_device_ms" in x:
                extra[f"library_device_ms_{tag}"] = x["library_device_ms"]
        if "library_device_ms" in c:
            extra["library_device_ms"] = c["library_device_ms"]
        out[name] = kernel_row(name, max(x["err"] for x in r.values()), c["ms"], c["plain_ms"], *c["work"],
                               c["library_ms"], call_ms=c["call_ms"], max_abs_err_cross=c["err"],
                               **extra, **packed.get(name, {}))
    return out


# the any-dtype legacy kernels at a small shape: B 2, H 4, Lq 256, Lk 1024, D 64
ANY_SHAPE = (2, 4, 256, 1024, 64)


def any_inputs(dev, dtype, d=64, causal=False):
    """q, k, v, do [B, H, L, d] of dtype, the images-like kv_valid of L2
    (a hole and a short row) and kv_len of the same counts for L1."""
    b, h, lq, lk, _ = ANY_SHAPE
    if causal:
        lk = lq
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v, do = (torch.randn((b, h, n, d), generator=g, device=dev).to(dtype) for n in (lq, lk, lk, lq))
    kv_valid = torch.ones((b, lk), dtype=torch.bool, device=dev)
    kv_valid[0, 100:300] = False
    kv_valid[1, lk * 3 // 4:] = False
    return q, k, v, do, kv_valid.sum(1).to(torch.int32), kv_valid


def any_work(b, h, lq, lk, d, n_keys, pairs, elem):
    """(operations, bytes) of the any-dtype forward, dq and dk/dv for
    `pairs` (head, query, key) triples that a query sees and `n_keys` valid
    keys over the batch, at head width d and `elem` bytes an element: the
    products of those pairs; q, o, do, dq once, k and v at the valid keys,
    lse and delta (f32), and dk and dv written whole."""
    qb, kvb, stats = b * h * lq * d * elem, n_keys * h * d * elem, b * h * lq * 4
    return {"LA legacy flash fwd, any dtype": (4 * d * pairs, 2 * qb + 2 * kvb + stats),
            "LA legacy flash dq, any dtype": (6 * d * pairs, 3 * qb + 2 * kvb + 2 * stats),
            "LA legacy flash dk/dv, any dtype": (8 * d * pairs, 2 * qb + 2 * kvb + 2 * stats
                                                 + 2 * b * h * lk * d * elem)}


def device_ms(fn, reps=5):
    """Device time of one call of fn: the durations of every device kernel
    that a profiler trace of reps calls recorded, over reps (a library
    call's own kernels, without its host work). Every call runs the same
    kernels, so a trace in which some kernel's count is not a multiple of
    reps (or that holds none) missed some and is taken again, up to
    TRACE_TRIES times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        events = traced_kernels(fn, reps, OUT_DIR / "library_timing_trace.json")
        counts = Counter(e["name"] for e in events)
        if counts and all(n % reps == 0 for n in counts.values()):
            return sum(e["dur"] for e in events) / reps / 1e3
        TRACES["retaken"] += 1
        log(f"  {len(events)} device kernels ({len(counts)} names) in the trace of {reps} library calls; "
            "tracing again")
        time.sleep(2.0)
    raise AssertionError(f"{len(events)} device kernels in the last of {TRACE_TRIES} traces of {reps} calls, "
                         f"some not once a call: {dict(counts)}")


# the any-dtype kernels at the legacy cross shape (the images' kv_valid): the three cases they exist for
ANY_CROSS = ((torch.float32, 64), (torch.float16, 64), (torch.bfloat16, 192))


def any_cross_fwd(q, k, v, kv_valid, tag, tol, peak, work):
    """LA fwd at the legacy cross shape on q, k, v: L2a's o and lse (the
    images' kv_valid) and L1's o (kv_len = each row's count of valid keys)
    against the plain version, then its device time with the launch record
    (the L2a call), bound, plain time and SDPA's forward with the same
    boolean mask (CUDA-event and device time)."""
    name = LEGACY_ANY[0]
    kv_len = torch.full((B,), LK, dtype=torch.int32, device=q.device)
    kv_len1 = kv_valid.sum(1).to(torch.int32)
    o2, lse2 = fb.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid)
    o2_p, lse2_p = fl.attention_plain(q, k, v, kv_len, kv_valid)
    err = max(check(f"LA L2a o ({tag})", max_err(o2, o2_p), float(o2_p.float().abs().max()), tol),
              check_lse(f"LA L2a lse ({tag})", lse2, lse2_p, ANY_LSE_TOL))
    del o2, o2_p, lse2, lse2_p
    o1 = fl.legacy_fwd_cuda(q, k, v, kv_len1)
    o1_p = fl.flash_attention_plain(q, k, v, kv_len1)
    err = max(err, check(f"LA L1 o ({tag})", max_err(o1, o1_p), float(o1_p.float().abs().max()), tol))
    del o1, o1_p
    torch.cuda.empty_cache()
    plain = time_ms(lambda: fl.attention_plain(q, k, v, kv_len, kv_valid), reps=3, warmup=1)
    sdpa_fwd = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=kv_valid[:, None, None, :])
    lib, lib_dev = time_ms(sdpa_fwd), device_ms(sdpa_fwd)
    lib_names = library_kernels(sdpa_fwd)
    ms, call = kernel_times(name, lambda: fl.legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, False, -1,
                                                                 with_lse=True))
    ops, nbytes = work[name]
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    row = dict(max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain, library_ms=lib, library_device_ms=lib_dev,
               library_kernels=lib_names, bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes", **KERNEL_INFO.pop(name, {}))
    log(f"  fwd {ms:.4f} ms (bound {row['bound_ms']:.4f}); plain fwd {plain:.3f} ms; SDPA fwd {lib:.3f} ms "
        f"(device {lib_dev:.4f} ms: {lib_names[:2]})")
    return row


def any_cross(dev):
    """LA fwd (any_cross_fwd), LA dq and LA dk/dv at the legacy cross shape
    (B 8, H 4, Lq 1268, Lk 12,696, the images' kv_valid) in float32 D 64,
    float16 D 64 and bf16 D 192: each against the plain version (ANY_TOL in
    float32, KERNEL_TOL else), device time with the launch record, bound
    (float32 at PEAK_F32_ACCURATE_FLOPS, else the 16-bit tensor-core peak),
    plain time and SDPA's forward or backward with the same boolean mask
    (CUDA-event and device time)."""
    g = torch.Generator(device=dev).manual_seed(9)
    kv_valid = memory_valid_from_hw(ragged_hw(B, dev), GRID_H, GRID_W).contiguous()
    kv_len = torch.full((B,), LK, dtype=torch.int32, device=dev)
    n_keys = int(kv_valid.sum())
    pairs = HEADS * LQ * n_keys
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = kv_valid[:, None, None, :]
    out = {name: {} for name in LEGACY_ANY}
    for dtype, d in ANY_CROSS:
        tag = f"{str(dtype)[6:]} D {d}"
        tol = ANY_TOL if dtype == torch.float32 else KERNEL_TOL
        peak = PEAK_F32_ACCURATE_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        q, k, v, do = (torch.randn((B, HEADS, n, d), generator=g, device=dev).to(dtype) for n in (LQ, LK, LK, LQ))
        work = any_work(B, HEADS, LQ, LK, d, n_keys, pairs, q.element_size())
        log(f"[legacy any cross] B {B} H {HEADS} Lq {LQ} Lk {LK} {tag}, {n_keys} of {B * LK} keys valid")
        out[LEGACY_ANY[0]][tag] = any_cross_fwd(q, k, v, kv_valid, tag, tol, peak, work)
        o, lse = fb.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid)
        bargs = (q, k, v, kv_len, kv_valid, do, lse, fb.attention_delta(do, o), False, -1)
        dq = fb.legacy_any_dq_cuda(*bargs)
        dk, dv = fb.legacy_any_dkv_cuda(*bargs)
        torch.cuda.synchronize()
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_p, _ = fl.attention_plain(qr, kr, vr, kv_len, kv_valid)
        grads_p = torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True)
        errs = {"LA legacy flash dq, any dtype": check(f"LA dq ({tag})", max_err(dq, grads_p[0]),
                                                       float(grads_p[0].abs().max()), tol),
                "LA legacy flash dk/dv, any dtype": max(
                    check(f"LA {n} ({tag})", max_err(a, r), float(r.abs().max()), tol)
                    for n, a, r in (("dk", dk, grads_p[1]), ("dv", dv, grads_p[2])))}
        del dq, dk, dv
        plain_bwd = time_ms(lambda: torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True), reps=3, warmup=1)
        del o_p, grads_p
        o_s = sdpa(qr, kr, vr, attn_mask=mask)
        sdpa_bwd = lambda: torch.autograd.grad(o_s, (qr, kr, vr), do, retain_graph=True)  # noqa: E731
        lib_bwd, lib_dev = time_ms(sdpa_bwd), device_ms(sdpa_bwd)
        lib_names = library_kernels(sdpa_bwd)
        timed = {"LA legacy flash dq, any dtype": lambda: fb.legacy_any_dq_cuda(*bargs),
                 "LA legacy flash dk/dv, any dtype": lambda: fb.legacy_any_dkv_cuda(*bargs)}
        for name, fn in timed.items():
            ms, call = kernel_times(name, fn)
            ops, nbytes = work[name]
            t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
            out[name][tag] = dict(max_abs_err=errs[name], ms=ms, call_ms=call, plain_ms=plain_bwd,
                                  library_ms=lib_bwd, library_device_ms=lib_dev, library_kernels=lib_names,
                                  bound_ms=max(t_ops, t_bytes) * 1e3,
                                  bound_by="operations" if t_ops >= t_bytes else "bytes",
                                  **KERNEL_INFO.pop(name, {}))
        pair_ms = sum(out[name][tag]["ms"] for name in timed)
        log(f"  dq {out[LEGACY_ANY[1]][tag]['ms']:.4f} ms (bound {out[LEGACY_ANY[1]][tag]['bound_ms']:.4f}), dk/dv "
            f"{out[LEGACY_ANY[2]][tag]['ms']:.4f} ms (bound {out[LEGACY_ANY[2]][tag]['bound_ms']:.4f}), pair "
            f"{pair_ms:.4f} ms; plain bwd {plain_bwd:.3f} ms; SDPA bwd {lib_bwd:.3f} ms (device {lib_dev:.4f} ms: "
            f"{lib_names[:2]})")
        del q, k, v, do, o, lse, bargs, qr, kr, vr, o_s, timed
        torch.cuda.empty_cache()
    return out


def phase_legacy_any(dev):
    """The any-dtype legacy kernels (what the bf16 tensor-core kernels do
    not take) against the plain version: float32 at ANY_SHAPE, non-causal
    and causal with window 100, and float32 at D 192, within ANY_TOL x max
    |plain|; float16 at D 64 and bf16 at D 192 within KERNEL_TOL; lse
    within ANY_LSE_TOL; device, plain and SDPA (float32, same boolean mask;
    event and device time) times of the float32 non-causal call; then LA
    fwd, dq and dk/dv at the legacy cross shape (any_cross)."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash.flash_attention_bwd import make_flash_attention

    errs = {name: 0.0 for name in LEGACY_ANY}
    for dtype, d, causal, tol in ((torch.float32, 64, False, ANY_TOL), (torch.float32, 64, True, ANY_TOL),
                                  (torch.float16, 64, True, KERNEL_TOL), (torch.bfloat16, 192, False, KERNEL_TOL),
                                  (torch.float32, 192, False, ANY_TOL)):
        band = dict(causal=causal, window=WINDOW if causal else -1)
        q, k, v, do, kv_len1, kv_valid = any_inputs(dev, dtype, d, causal)
        kv_len2 = torch.full_like(kv_len1, k.shape[2])
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        n = read_counts()
        o1 = fl.flash_attention(q, k, v, kv_len1, **band)
        o2 = make_flash_attention(**band)(*ins, kv_len2, kv_valid)
        o2.backward(do)
        _, lse2 = fb.legacy_fwd_lse_cuda(q, k, v, kv_len2, kv_valid, **band)
        torch.cuda.synchronize()
        got = {name: read_counts()[name] - n[name] for name in LEGACY_ANY + LEGACY_BF16}
        if got != dict.fromkeys(LEGACY_BF16, 0) | dict(zip(LEGACY_ANY, (3, 1, 1))):
            raise AssertionError(f"any-dtype legacy call launched {got}")
        refs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o2_p, lse2_p = fl.attention_plain(*refs, kv_len2, kv_valid, **band)
        o2_p.backward(do)
        tag = f"{str(dtype)[6:]} D {d} {'window 100' if causal else 'non-causal'}"
        log(f"[legacy any] {tag}: B, H, Lq, Lk = {tuple(q.shape[:3]) + (k.shape[2],)}")
        o1_p = fl.flash_attention_plain(q, k, v, kv_len1, **band)
        e_fwd = max(check(f"LA L1 o ({tag})", max_err(o1, o1_p), float(o1_p.float().abs().max()), tol),
                    check(f"LA L2a o ({tag})", max_err(o2, o2_p), float(o2_p.detach().float().abs().max()), tol),
                    check_lse(f"LA L2a lse ({tag})", lse2, lse2_p, ANY_LSE_TOL))
        e_dq = check(f"LA dq ({tag})", max_err(ins[0].grad, refs[0].grad), float(refs[0].grad.abs().max()), tol)
        e_dkv = max(check(f"LA {n_} ({tag})", max_err(a.grad, r.grad), float(r.grad.abs().max()), tol)
                    for n_, a, r in (("dk", ins[1], refs[1]), ("dv", ins[2], refs[2])))
        if dtype == torch.float32:
            for name, e in zip(LEGACY_ANY, (e_fwd, e_dq, e_dkv)):
                errs[name] = max(errs[name], e)
        del o1, o1_p, o2, o2_p, lse2, lse2_p, ins, refs

    # times of the float32 non-causal call
    q, k, v, do, _, kv_valid = any_inputs(dev, torch.float32)
    b, h, lq, lk, d = ANY_SHAPE
    kv_len = torch.full((b,), lk, dtype=torch.int32, device=dev)
    o, lse = fb.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid)
    bargs = (q, k, v, kv_len, kv_valid, do, lse, fb.attention_delta(do, o), False, -1)
    timed = {"LA legacy flash fwd, any dtype": lambda: fl.legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, False, -1,
                                                                               with_lse=True),
             "LA legacy flash dq, any dtype": lambda: fb.legacy_any_dq_cuda(*bargs),
             "LA legacy flash dk/dv, any dtype": lambda: fb.legacy_any_dkv_cuda(*bargs)}
    n_keys = int(kv_valid.sum())
    work = any_work(b, h, lq, lk, d, n_keys, h * lq * n_keys, 4)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_p, _ = fl.attention_plain(qr, kr, vr, kv_len, kv_valid)
    plain_fwd = time_ms(lambda: fl.attention_plain(q, k, v, kv_len, kv_valid), reps=3, warmup=1)
    plain_bwd = time_ms(lambda: torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True), reps=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = kv_valid[:, None, None, :]
    lib_fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    lib_fwd_dev = device_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    o_s = sdpa(qr, kr, vr, attn_mask=mask)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o_s, (qr, kr, vr), do, retain_graph=True))
    lib_bwd_dev = device_ms(lambda: torch.autograd.grad(o_s, (qr, kr, vr), do, retain_graph=True))
    out = {}
    for name, fn in timed.items():
        ms, call = kernel_times(name, fn)
        is_fwd = "fwd" in name
        out[name] = kernel_row(name, errs[name], ms, plain_fwd if is_fwd else plain_bwd, *work[name],
                               lib_fwd if is_fwd else lib_bwd, peak=PEAK_F32_ACCURATE_FLOPS,
                               call_ms=call, shape="B 2, H 4, Lq 256, Lk 1024, D 64, float32",
                               library_device_ms=lib_fwd_dev if is_fwd else lib_bwd_dev)
        out[name].update(KERNEL_INFO.get(name, {}))  # the launch record at ANY_SHAPE; any_cross keeps its own
    log("  " + ", ".join(f"{n.split(',')[0]} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})" for n, r in out.items())
        + f"; plain fwd {plain_fwd:.3f} / bwd {plain_bwd:.3f} ms; SDPA f32 fwd {lib_fwd:.3f} / bwd {lib_bwd:.3f} ms "
        f"(device {lib_fwd_dev:.4f} / {lib_bwd_dev:.4f} ms)")
    del q, k, v, do, o, lse, bargs, qr, kr, vr, o_p, o_s
    torch.cuda.empty_cache()
    for name, cases in any_cross(dev).items():
        out[name]["cross"] = cases
    return out


def legacy_path(dev):
    """The legacy entry points, counted from 0: the port's
    bench_flash_packed at its own shape (L2 against K1/K2, LEGACY_ITERS timed
    calls each), then one inference call of flash_attention (L1) at the
    paper's self-attention shape, held against its plain version, and the
    float32 route at ANY_SHAPE: one flash_attention call and one forward +
    backward of make_flash_attention (the any-dtype kernels)."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash.flash_attention_bwd import make_flash_attention

    g = torch.Generator(device=dev).manual_seed(7)
    lengths = torch.tensor(TARGET_LENGTHS, dtype=torch.int32, device=dev)
    q, k, v = (torch.randn((B, HEADS, LQ, 64), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    q32, k32, v32, do32, kv_len32, kv_valid32 = any_inputs(dev, torch.float32)
    leaves = [t.requires_grad_() for t in (q32, k32, v32)]
    reset_counts()
    bench = bench_flash_packed.main(["--iters", str(LEGACY_ITERS)])
    with torch.no_grad():
        o = fl.flash_attention(q, k, v, lengths, causal=True, window=WINDOW)
        o32 = fl.flash_attention(q32, k32, v32, kv_len32)
    o32b = make_flash_attention()(*leaves, torch.full_like(kv_len32, k32.shape[2]), kv_valid32)
    o32b.backward(do32)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[legacy path] kernel launches {launches}")
    n = LEGACY_ITERS
    # bench: each forward + backward runs once untimed and n times timed; then one forward of old and new,
    # and three dropout forwards
    want = {name: 0 for name in KERNELS} | {
        "K1 flash fwd": 2 * (n + 1) + 1 + 3, "K2 flash bwd": 2 * (n + 1), "L2a legacy flash fwd lse": n + 2,
        "L2b legacy flash dq": n + 1, "L2c legacy flash dk/dv": n + 1, "L1 legacy flash fwd": 1,
        "LA legacy flash fwd, any dtype": 2, "LA legacy flash dq, any dtype": 1, "LA legacy flash dk/dv, any dtype": 1}
    if launches != want:
        raise AssertionError(f"legacy path launched {launches}, expected {want}")
    err = check_vs("legacy path L1 o", o, fl.flash_attention_plain(q, k, v, lengths, causal=True, window=WINDOW))
    o32_p = fl.flash_attention_plain(q32.detach(), k32.detach(), v32.detach(), kv_len32)
    err32 = check("legacy path float32 L1 o", max_err(o32, o32_p), float(o32_p.abs().max()), ANY_TOL)
    if not all(torch.isfinite(t.grad).all() for t in leaves) or not torch.isfinite(o32b).all():
        raise AssertionError("legacy path float32: non-finite output or gradient")
    bench_err = check("bench max |old - new| fwd", bench["max_abs_old_new"], bench["max_abs_new"], KERNEL_TOL)
    if not (bench["dropout_deterministic"] and bench["dropout_varies_with_seed"]
            and bench["dropout_changed_frac"] > 0.5):
        raise AssertionError(f"bench dropout checks failed: {bench}")
    del q, k, v, o, q32, k32, v32, do32, o32, o32b, leaves
    torch.cuda.empty_cache()
    return dict(launches=launches, bench=bench, max_abs_err_l1=err, max_abs_err_l1_float32=err32,
                max_abs_err_bench=bench_err)


# the cli path's corpus: the synthetic source at production geometry (tools/run_real_shape_e2e.py:60-75,
# tools/run_convergence.py:46-53), 32 train samples (4 steps of 8 an epoch), 8 val, 8 test; its audio at the
# production length (17-18.7 s for 30 measures, tools/run_real_shape_e2e.py:73) in the accuracy-gate corpus's
# "bands" style (reports/grid_r05_bands.json). The audio keys change no image and no transcript (the image is
# drawn first from the same generator), so the image run sees the corpus it saw without them.
CLI_CORPUS = dict(n=32, n_val=8, n_test=8, n_measures=30, n_measures_range=[2, 30], render_style="grand",
                  img_height_range=[355, 362], img_width_range=[4300, 4413], audio_seconds_range=[17.0, 18.7],
                  audio_style="bands")
CLI_EPOCHS = 2  # the image run
# the audio run: its second epoch reads every train wave's spectrogram back from the frontend disk cache
# (data/frontends.py), which cli.train empties after the run
AUDIO_EPOCHS = 2
AV_EPOCHS = 1  # the multimodal run
LOADER_EPOCHS = 1  # the loader runs: their first train batch is the one held to the thread loader's
FRONTEND_CACHE = ROOT / "build" / "chip_smoke_frontend_cache"  # OMR_A2S_CACHE_DIR of the run and its processes
CLI_WS = ROOT / "build" / "chip_smoke_cli"  # checkpoints and caches of the cli path (Adam moments: kept off out_dir)


def cli_records(run_dir: Path) -> list:
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


class FirstCall:
    """Stands in for a kernel wrapper in ops/flash_packed.py, where the
    autograd function looks it up: keeps a copy of the arguments of its
    first call and calls it. The wrapper counts its launches under its
    module name, which is then this: ``launches`` reads and writes the
    wrapper's own count."""

    def __init__(self, fn):
        self.fn, self.args = fn, None

    def __call__(self, *args):
        if self.args is None:
            self.args = tuple(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args)
        return self.fn(*args)

    launches = property(lambda self: self.fn.launches, lambda self, n: setattr(self.fn, "launches", n))


class FirstCalls:
    """K1's and K2's wrappers replaced by FirstCall while the path runs."""

    def __enter__(self):
        self.saved = fp.flash_fwd_cuda, fp.flash_bwd_cuda
        fp.flash_fwd_cuda, fp.flash_bwd_cuda = (FirstCall(fn) for fn in self.saved)
        return self

    def __exit__(self, *exc):
        self.args = {"K1 flash fwd": fp.flash_fwd_cuda.args, "K2 flash bwd": fp.flash_bwd_cuda.args}
        fp.flash_fwd_cuda, fp.flash_bwd_cuda = self.saved


def check_cli_flash(args: dict, tag: str, padded: bool = True) -> dict:
    """K1 and K2 against their plain version on the inputs of their first
    call in a cli run: the decoder's cross-attention of the first train
    step (K2: its last layer's backward), with the memory of the real
    collate's padding through memory_valid_from_hw (``padded``: some key
    must be padded; the bench's full-size inputs pad none). Launches
    outside the counted run."""
    q, k, v, kv_len, kv_valid, seed, rate, heads, bq, bk = args["K1 flash fwd"]
    n_valid, n_keys = int(kv_valid.sum()), kv_valid.numel()
    log(f"[cli {tag}] K1/K2 at the run's first call: B {q.shape[0]} Lq {q.shape[1]} Lk {k.shape[1]} {q.dtype}, "
        f"dropout {rate}, valid keys {n_valid} of {n_keys} (per row {kv_valid.sum(1).tolist()})")
    if padded and n_valid == n_keys:
        raise AssertionError(f"cli {tag}: the first K1 call saw no padded key")
    o_k, lse_k = fp.flash_fwd_cuda(*args["K1 flash fwd"])
    o_p, lse_p = fp.flash_attention_plain(q, k, v, kv_len, kv_valid, seed, rate, heads, False, -1, bq, bk)
    errs = {"K1 flash fwd": max(check_vs("K1 o", o_k, o_p), check_lse("K1 lse", lse_k, lse_p))}
    rel = {"K1 flash fwd": rel_err(o_k, o_p)}  # of max |plain|, each output on its own scale
    del o_k, lse_k, o_p, lse_p
    q, k, v, kv_len, kv_valid, seed, o, lse, do, rate, heads, bq, bk = args["K2 flash bwd"]
    grads_k = fp.flash_bwd_cuda(*args["K2 flash bwd"])
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_p, _ = fp.flash_attention_plain(qr, kr, vr, kv_len, kv_valid, seed, rate, heads, False, -1, bq, bk)
    grads_p = torch.autograd.grad(o_p, (qr, kr, vr), do)
    errs["K2 flash bwd"] = max(check_vs(f"K2 {n}", a, p) for n, a, p in zip(("dq", "dk", "dv"), grads_k, grads_p))
    rel["K2 flash bwd"] = max(rel_err(a, p) for a, p in zip(grads_k, grads_p))
    log(f"[cli {tag}] largest error over max |plain|: K1 o {rel['K1 flash fwd']:.2e}, "
        f"K2 dq/dk/dv {rel['K2 flash bwd']:.2e}")
    # the same call against float64: K2, the plain version and K3a (dq of the split backward, whose float32
    # partials are summed in a fixed order) read on one yardstick, to tell bf16 rounding from a fault in K2's
    # reduce-add; K3a again with delta = rowsum(do * o) from the float64 o, where the kernels (and JAX's) take
    # the bf16 o, to show that rounding's share
    o64, grads_64 = flash_grads_f64(q, k, v, kv_len, kv_valid, seed, do, rate, heads, bq, bk)
    dq_k3a = {who: fp.flash_dq_cuda(q, k, v, kv_len, kv_valid, seed, do, lse, fp.attention_delta(do, o_d, heads),
                                    rate, heads, bq, bk) for who, o_d in (("K3a", o), ("K3a, delta of the f64 o", o64))}
    f64 = {}
    for i, n in enumerate(("dq", "dk", "dv")):
        scale = float(grads_64[i].abs().max())
        f64[n] = {who: float((t.double() - grads_64[i]).abs().max()) / scale
                  for who, t in (("K2", grads_k[i]), ("plain f32", grads_p[i]), *(dq_k3a.items() if i == 0 else ()))}
    log(f"[cli {tag}] K2 bwd against float64, error over max |f64|: "
        + "; ".join(f"{n} " + ", ".join(f"{who} {e:.3e}" for who, e in d.items()) for n, d in f64.items()))
    if f64["dq"]["K2"] > 1.5 * f64["dq"]["K3a"] + 2e-3:  # the card test's rule, on this run's inputs
        raise AssertionError(f"cli {tag}: K2's dq lies further from float64 than K3a's: {f64['dq']}")
    del grads_k, grads_p, o_p, qr, kr, vr, dq_k3a, grads_64, o64
    torch.cuda.empty_cache()
    return dict(errs, rel=rel, f64=f64, lk=int(k.shape[1]), lq=int(q.shape[1]))


def flash_grads_f64(q, k, v, kv_len, kv_valid, seed, do, rate, heads, bq, bk):
    """o and (dq, dk, dv) of the flash function in float64 from the same
    bf16 inputs and keep-mask, with p and ds unrounded."""
    b, lq, pd = q.shape
    lk = k.shape[1]
    qd, kd, vd = (t.detach().double().requires_grad_() for t in (q, k, v))
    qh, kh, vh = (fp._heads(t, heads) for t in (qd, kd, vd))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / (pd // heads) ** 0.5)
    see = (kv_valid.bool() & (torch.arange(lk, device=q.device)[None, :] < kv_len[:, None]))[:, None, None, :]
    p = torch.softmax(torch.where(see, s, -1e300), dim=-1)
    if rate > 0.0:
        keep = fp.keep_mask(int(seed), b, heads, lq, lk, rate, q.device, bq, bk)
        p = torch.where(keep, p / fp._keep_den(rate), 0.0)
    o = torch.matmul(p, vh).transpose(1, 2).reshape(b, lq, pd)
    return o.detach(), torch.autograd.grad(o, (qd, kd, vd), do.double())


def rel_err(got, ref) -> float:
    return max_err(got, ref) / float(ref.detach().float().abs().max())


def cli_data(modality: str, corpus: dict = CLI_CORPUS, cache: Path = CLI_WS / "cache") -> list:
    return ["--ds_name", "synthetic", "--krn_encoding", "kern", "--synthetic", "--synthetic_config",
            json.dumps(corpus), "--cache_root", str(cache), "--batch_size", "8", "--input_modality", modality]


def cli_run(dev, tag: str, modality: str, epochs: int, test_cli_run: bool, extra=(), train_only=None) -> dict:
    """One cli.train run of the paper model at full width (attn_window 100,
    flash cross-attention, packed stem, bf16, b8) on CLI_CORPUS, validating
    at its last epoch, keeping best/ and last/ and testing best/; with
    test_cli_run, then cli.test of best/ with --save_preds. Counted from 0:
    K1 and K2 8 launches a train step, no other kernel (greedy decode runs
    none); then check_cli_flash holds them to their plain version on the
    inputs of their first call in the run. Losses and SERs finite, one preds
    row a test sample, best/ and last/ round-trip through
    build_from_checkpoint and a Trainer's full restore (optimizer state and
    step; over ``train_only``'s groups, as the run's). An audio run of more
    than one epoch reads each train wave's spectrogram from the frontend
    disk cache in every epoch after its first (frontends.stats)."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
    from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli
    from omr_a2s_multimodal_transformer_tpu_torch.data import frontends
    from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib
    from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer

    weights, run, test_run = (CLI_WS / f"{x}_{tag}" for x in ("weights", "run", "test_run"))
    preds = CLI_WS / f"preds_{tag}.jsonl"
    train_args = cli_data(modality) + ["--attn_window", str(WINDOW), "--use_flash_cross", "--epochs", str(epochs),
                                       "--check_val_every_n_epoch", str(epochs), "--weights_dir", str(weights),
                                       "--run_dir", str(run), *extra]
    if train_only:
        train_args += ["--train_only", ",".join(train_only)]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    test = None
    stats = Counter(frontends.stats)
    with FirstCalls() as first:
        fit = train_cli.main(train_args)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        cache = {f"{name} {kind}": n for (name, kind), n in (frontends.stats - stats).items()}
        if test_cli_run:
            test = test_cli.main(cli_data(modality) + ["--checkpoint_path", str(weights / "best"), "--save_preds",
                                                        str(preds), "--run_dir", str(test_run)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    errs = check_cli_flash(first.args, tag)
    del first

    dm = common.make_datamodule(train_cli.build_parser().parse_args(train_args), modality)
    dm.setup("fit")
    steps_per_epoch = len(dm.train_dataloader())
    steps = epochs * steps_per_epoch
    log(f"[cli {tag}] kernel launches {launches} over {steps} train steps; frontend cache calls in cli.train {cache}")
    if modality == "audio" and cache.get("preprocess_audio hit", 0) < (epochs - 1) * CLI_CORPUS["n"]:
        raise AssertionError(f"cli {tag}: {epochs} epochs read the frontend cache {cache}")
    want = {name: 8 * steps if name in ("K1 flash fwd", "K2 flash bwd") else 0 for name in KERNELS}
    if launches != want:
        raise AssertionError(f"cli {tag} launched {launches}, expected {want}")

    recs = cli_records(run)
    epochs_r = [r for r in recs if "train_loss" in r]
    vals = [r for r in recs if "val_sym-er" in r]
    decodes = [dict(r, cli="train") for r in recs if "val_decode_s" in r or "test_decode_s" in r]
    if test_cli_run:
        decodes += [dict(r, cli="test") for r in cli_records(test_run) if "test_decode_s" in r]
    losses = [r["train_loss"] for r in epochs_r]
    if len(epochs_r) != epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"cli {tag} train losses {losses}")
    checks = [("val_sym-er", [r["val_sym-er"] for r in vals]), ("train CLI test_sym-er", [fit["test_sym-er"]])]
    if test_cli_run:
        checks.append(("test_sym-er", [test["test_sym-er"]]))
        rows = preds.read_text().splitlines()
        if len(rows) != CLI_CORPUS["n_test"]:
            raise AssertionError(f"cli {tag}: preds.jsonl has {len(rows)} rows, expected {CLI_CORPUS['n_test']}")
    for name, value in checks:
        if not value or not all(map(math.isfinite, value)):
            raise AssertionError(f"cli {tag} {name} {value}")

    # best/ and last/ round-trip: a model built from the sidecar holds the saved weights, and a Trainer's
    # full restore takes the optimizer state and step (no params-only fallback)
    vocab = dm.get_vocab()
    for ckpt in ("best", "last"):
        saved = ckpt_lib.restore_checkpoint(str(weights / ckpt))
        model, hp, multimodal = common.build_from_checkpoint(str(weights / ckpt), device=dev)
        trainer = Trainer(model, vocab, hp, weights_dir=str(weights), run_dir=str(CLI_WS / f"restore_{tag}_{ckpt}"),
                          multimodal=multimodal, train_only=train_only, device=dev)
        trainer.init_state()
        trainer.restore(str(weights / ckpt))
        got = model.state_dict()
        same = all(torch.equal(got[k].cpu(), v) for k, v in saved["params"].items())
        degraded = any("resume_degraded" in r for r in cli_records(CLI_WS / f"restore_{tag}_{ckpt}"))
        if not same or degraded or trainer.state.step != saved["step"] or len(saved["params"]) != len(got):
            raise AssertionError(f"cli {tag}: {ckpt}/ does not round-trip (weights equal {same}, "
                                 f"degraded {degraded}, step {trainer.state.step} vs {saved['step']})")
        del model, trainer
    torch.cuda.empty_cache()

    per_epoch = epoch_rows(tag, epochs_r, steps_per_epoch)
    for r in decodes:
        name = "val" if "val_decode_s" in r else "test"
        ms, n = r[f"{name}_decode_s"] * 1e3, r[f"{name}_decode_steps"]
        log(f"[cli {tag}] cli.{r['cli']} {name} decode: {ms:.1f} ms, {n} decode steps ({ms / max(n, 1):.2f} "
            f"ms/step), {r[f'{name}_decode_batches']} batch")
    test_ser = (test or fit)["test_sym-er"]
    log(f"[cli {tag}] val_sym-er {[round(r['val_sym-er'], 4) for r in vals]}, test_sym-er {test_ser:.4f}, best "
        f"epoch {fit['best_epoch']}; peak memory {peak:.2f} GiB; wall {wall:.1f} s (train CLI {t_train:.1f} s"
        + (f", test CLI {wall - t_train:.1f} s)" if test_cli_run else ")"))
    return dict(modality=modality, args=train_args, steps=steps, launches=launches, max_abs_err=errs, epochs=per_epoch,
                decodes=[{k: v for k, v in r.items() if k not in ("time",)} for r in decodes],
                val=[{k: r[k] for k in ("epoch", "val_sym-er", "val_seq-er")} for r in vals],
                test=test or {k: v for k, v in fit.items() if k.startswith("test_")}, best_epoch=fit["best_epoch"],
                peak_gib=peak, wall_s=wall, train_cli_s=t_train, frontend_cache=cache, vocab=vocab)


def epoch_rows(tag: str, epochs_r: list, steps_per_epoch: int) -> list:
    """Per-epoch samples/s and StepTimer means of a cli run's records. The
    StepTimer totals are cumulative over the fit: an epoch's share is the
    difference; its data phase runs once more than its steps (the fetch
    that ends the epoch)."""
    per_epoch, prev = [], dict(data=0.0, step=0.0)
    for r in epochs_r:
        row = dict(epoch=r["epoch"], train_loss=r["train_loss"], samples_per_sec=r["samples_per_sec"])
        for ph, n in (("data", steps_per_epoch + 1), ("step", steps_per_epoch)):
            total = r[f"time_{ph}_total_s"]
            row[f"{ph}_ms_mean"] = (total - prev[ph]) * 1e3 / n
            prev[ph] = total
        row["epoch_s"] = 8 * steps_per_epoch / r["samples_per_sec"]
        per_epoch.append(row)
        log(f"[cli {tag}] epoch {row['epoch']}: train_loss {row['train_loss']:.4f}, "
            f"{row['samples_per_sec']:.2f} samples/s ({row['epoch_s']:.2f} s), StepTimer means (host clock): "
            f"data {row['data_ms_mean']:.1f} ms, step {row['step_ms_mean']:.1f} ms")
    return per_epoch


# the image run again with the corpus held on the card (u8 images) and with the worker-process loader; no
# validation (the loaders feed the train steps only), the rest as the cli path's image run
LOADER_RUNS = {"device_cache_u8": ("--device_cache", "--device_cache_u8"),
               "grain": ("--loader_backend", "grain", "--num_workers", "4")}


def loader_run(dev, tag: str, extra, threads_epoch: dict) -> dict:
    """cli.train of the paper model's image run (LOADER_EPOCHS epochs, no
    validation) with ``extra`` flags, counted from 0 (K1 and K2 8 launches a
    step, no other kernel). The run's first train batch, as the step gets it
    on the card, must equal bit for bit the thread loader's batch of the same
    epoch put there by the Trainer. Logs the StepTimer's data / step means
    beside ``threads_epoch``'s (the cli path's image run, on the thread
    loader, in this call) and the device cache's resident bytes."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli
    from omr_a2s_multimodal_transformer_tpu_torch.training import loop

    weights, run = CLI_WS / f"weights_{tag}", CLI_WS / f"run_{tag}"
    args = cli_data("image") + ["--attn_window", str(WINDOW), "--use_flash_cross", "--epochs", str(LOADER_EPOCHS),
                                "--check_val_every_n_epoch", "100", "--weights_dir", str(weights), "--run_dir",
                                str(run), *extra]
    puts, trainers = [], []
    put, fit = loop.Trainer._put, loop.Trainer.fit

    def first_put(self, batch, **kw):
        b = put(self, batch, **kw)
        if not puts:
            puts.append({k: v.clone() for k, v in b.items()})
        return b

    def kept_fit(self, *a, **kw):
        trainers.append(self)
        return fit(self, *a, **kw)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(loop.Trainer, "_put", first_put), patched(loop.Trainer, "fit", kept_fit):
        result = train_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    (trainer,) = trainers
    threads = train_cli.build_parser().parse_args(args)
    threads.loader_backend, threads.device_cache, threads.device_cache_u8 = "threads", False, False
    dm = common.make_datamodule(threads, "image")
    dm.setup("fit")
    loader = dm.train_dataloader()
    steps = LOADER_EPOCHS * len(loader)
    loader._epoch_batches()  # the fit moves the shuffle stream on one epoch before its first, as JAX's init batch
    want = put(trainer, next(iter(loader)), bf16_inputs=trainer.bf16_compute)
    got = puts[0]
    same = sorted(got) == sorted(want) and all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
                                               for k in want)
    log(f"[cli {tag}] first train batch {'bit-equal to' if same else 'DIFFERENT from'} the thread loader's: "
        f"{ {k: (tuple(v.shape), str(v.dtype).replace('torch.', '')) for k, v in got.items()} }")
    if not same:
        raise AssertionError(f"cli {tag}: the first train batch differs from the thread loader's")
    want_launches = {name: 8 * steps if name in ("K1 flash fwd", "K2 flash bwd") else 0 for name in KERNELS}
    if launches != want_launches:
        raise AssertionError(f"cli {tag} launched {launches}, expected {want_launches}")
    recs = cli_records(run)
    epochs_r = [r for r in recs if "train_loss" in r]
    if len(epochs_r) != LOADER_EPOCHS or not all(math.isfinite(r["train_loss"]) for r in epochs_r):
        raise AssertionError(f"cli {tag} train losses {[r['train_loss'] for r in epochs_r]}")
    per_epoch = epoch_rows(tag, epochs_r, len(loader))
    cache = [r for r in recs if "device_cache_bytes" in r]  # the fit logs the bytes of the cache it freed
    if len(cache) != ("--device_cache" in extra) or (cache and cache[0]["device_cache_bytes"] <= 0):
        raise AssertionError(f"cli {tag}: device cache records {cache}")
    resident = cache[0]["device_cache_bytes"] if cache else None
    last = per_epoch[-1]
    log(f"[cli {tag}] epoch {last['epoch']} data / step {last['data_ms_mean']:.1f} / {last['step_ms_mean']:.1f} ms "
        f"(the thread loader's image run: {threads_epoch['data_ms_mean']:.1f} / {threads_epoch['step_ms_mean']:.1f})"
        + (f"; corpus resident on the card {resident / 1e6:.1f} MB ({cache[0]['device_cache_samples']} samples)"
           if cache else "") + f"; test_sym-er {result['test_sym-er']:.4f}; wall {wall:.1f} s")
    del trainer, trainers
    torch.cuda.empty_cache()
    return dict(args=args, steps=steps, launches=launches, epochs=per_epoch, resident_bytes=resident,
                first_batch_equal=same, test=result, wall_s=wall)


def av_serve(dev, vocab) -> dict:
    """make_audio_transcriber and make_multimodal_transcriber decode a b4
    batch of the corpus's test split (raw u8 images at their own height,
    zero-padded waveforms) on the card from the audio and the multimodal
    run's best/: tokens [4, max_seq_len], the spectrogram on the card (the
    device log_spectrogram, not the loader's numpy one), no kernel
    launched."""
    from omr_a2s_multimodal_transformer_tpu_torch import inference
    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.data.sources import make_source

    src = make_source("synthetic", "test", encoding="kern", synthetic=True, synthetic_kwargs=dict(CLI_CORPUS))
    samples = [src[i] for i in range(4)]
    hw = torch.tensor([s["image"].shape for s in samples], dtype=torch.int32)
    raw = torch.full((4, int(hw[:, 0].max()), int(hw[:, 1].max())), 255, dtype=torch.uint8)
    n = torch.tensor([len(s["audio"]["array"]) for s in samples], dtype=torch.int32)
    wave = torch.zeros((4, int(n.max())), dtype=torch.float32)
    for i, s in enumerate(samples):
        raw[i, :s["image"].shape[0], :s["image"].shape[1]] = torch.from_numpy(s["image"])
        wave[i, :len(s["audio"]["array"])] = torch.from_numpy(s["audio"]["array"])
    spectrograms, device_frontend = [], inference.log_spectrogram

    def recording(w, valid=None):
        spectrograms.append(device_frontend(w, valid))
        return spectrograms[-1]

    out = {}
    for tag, make, args in (("audio", inference.make_audio_transcriber, (wave, n)),
                            ("both", inference.make_multimodal_transcriber, (raw, hw, wave, n))):
        model, hp, _ = common.build_from_checkpoint(str(CLI_WS / f"weights_{tag}" / "best"), device=dev)
        transcribe = make(model, vocab.sos_id, vocab.eos_id, device=dev)
        inference.log_spectrogram, spectrograms[:] = recording, []
        reset_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, scores = transcribe(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            inference.log_spectrogram = device_frontend
        launches = read_counts()
        steps = int((tokens != 0).any(0).sum())
        spec = spectrograms[0]
        log(f"[cli serve {tag}] tokens {tuple(tokens.shape)} on {tokens.device}, spectrogram {tuple(spec.shape)} "
            f"{spec.dtype} on {spec.device}, {steps} decode steps, {ms:.1f} ms ({ms / max(steps, 1):.2f} ms/step)")
        if (len(spectrograms) != 1 or spec.device.type != dev.type or spec.dtype != torch.float32
                or tokens.shape != (4, hp["max_seq_len"]) or tokens.device.type != dev.type
                or not torch.isfinite(scores).all() or any(launches.values())):
            raise AssertionError(f"cli serve {tag}: tokens {tuple(tokens.shape)} on {tokens.device}, "
                                 f"{len(spectrograms)} spectrograms, launches {launches}")
        out[tag] = dict(decode_ms=ms, steps=steps, batch=4, tokens_shape=list(tokens.shape),
                        spectrogram_shape=list(spec.shape), spectrogram_device=str(spec.device))
        del model, transcribe, tokens, scores, spec
        spectrograms.clear()
        torch.cuda.empty_cache()
    return out


def cli_path(dev, out_dir: Path):
    """The port's entry points as a user calls them, each run counted from
    0 (cli_run): the image run (cli.train for CLI_EPOCHS epochs, then
    cli.test of best/ with --save_preds), the audio run (cli.train
    --input_modality audio, AUDIO_EPOCHS), the multimodal run (cli.train
    --input_modality both, the gated attn_both mixer warm-started from the
    image and audio runs' best/ with only the mixer trained, AV_EPOCHS; then
    cli.test --input_modality both --save_preds); then av_serve decodes a b4
    batch through the audio and multimodal transcribers."""
    import shutil

    shutil.rmtree(CLI_WS, ignore_errors=True)
    t0 = time.perf_counter()
    runs = {"image": cli_run(dev, "image", "image", CLI_EPOCHS, True)}
    t_image = time.perf_counter() - t0
    runs["audio"] = cli_run(dev, "audio", "audio", AUDIO_EPOCHS, False)
    runs["both"] = cli_run(dev, "both", "both", AV_EPOCHS, True, extra=(
        "--mixer_type", "attn_both", "--mixer_residual",
        "--init_image_checkpoint", str(CLI_WS / "weights_image" / "best"),
        "--init_audio_checkpoint", str(CLI_WS / "weights_audio" / "best")), train_only=("cross_attn", "mix_gate"))
    vocabs = {tag: r.pop("vocab") for tag, r in runs.items()}
    if not vocabs["image"].w2i == vocabs["audio"].w2i == vocabs["both"].w2i:
        raise AssertionError("the cli runs built different vocabularies")
    serve = av_serve(dev, vocabs["both"])
    wall = time.perf_counter() - t0
    log(f"[cli path] wall {wall:.1f} s: image run {t_image:.1f} s, audio and multimodal runs and serve "
        f"{wall - t_image:.1f} s")
    (out_dir / "cli_path").mkdir(parents=True, exist_ok=True)
    for tag in runs:
        shutil.copyfile(CLI_WS / f"run_{tag}" / "metrics.jsonl", out_dir / "cli_path" / f"train_metrics_{tag}.jsonl")
        if (CLI_WS / f"test_run_{tag}").exists():
            shutil.copyfile(CLI_WS / f"test_run_{tag}" / "metrics.jsonl",
                            out_dir / "cli_path" / f"test_metrics_{tag}.jsonl")
            shutil.copyfile(CLI_WS / f"preds_{tag}.jsonl", out_dir / "cli_path" / f"preds_{tag}.jsonl")
    errs = {name: max(r["max_abs_err"][name] for r in runs.values()) for name in ("K1 flash fwd", "K2 flash bwd")}
    return dict(corpus=CLI_CORPUS, runs=runs, serve=serve, max_abs_err=errs, wall_s=wall, image_run_s=t_image,
                vocab=vocabs["both"])


# the serve path: the JAX serve CLI's default ladders (cli/serve.py): canvas height 368 and widths 1104/2208/4416
# hold the corpus's 355-362 x 4300-4413 renders; 5/10/19 s buckets its 17-18.7 s waves
SERVE_HEIGHT, SERVE_WIDTHS, SERVE_SECONDS = 368, (1104, 2208, 4416), (5, 10, 19)
SERVE_REQUESTS = 4  # a server's requests, each from a thread of its own (and one more over HTTP)
SERVE_WAIT_MS = 3000  # the batching window: every request of a server lands in one device call
RESIZE_HEIGHT, RESIZE_TOL = 256, 1e-5
# every decode of the serve path stops after this many steps (serve_steps): the cli path's checkpoints, trained 2
# epochs on 32 scores, emit no EOS and ran each decode to the corpus's max_seq_len (670); every decode mode still
# runs, and its ms a step is taken over these steps
SERVE_STEPS = 160
MV2H_KEYS = ("multi-pitch", "voice", "meter", "note_value", "mv2h")


class Timed:
    """Wraps a decode function factory of a CLI module: every decode it
    builds is timed (host clock to a synchronize) and its steps counted."""

    def __init__(self, factory):
        self.factory, self.calls = factory, []

    def __call__(self, *args, **kw):
        decode = self.factory(*args, **kw)

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens, scores = decode(*a)
            torch.cuda.synchronize()
            self.calls.append(dict(ms=(time.perf_counter() - t0) * 1e3, steps=int((tokens != 0).any(0).sum()),
                                   batch=int(tokens.shape[0]), length=int(tokens.shape[-1])))
            return tokens, scores

        return timed

    def summary(self) -> list:
        return [dict(c, ms_per_step=c["ms"] / max(c["steps"], 1)) for c in self.calls]


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield value
    finally:
        setattr(module, name, saved)


def counted(tag: str, fn, want=None):
    """Runs fn with every kernel's launch count set to 0 first; raises unless
    the launches are ``want``'s (0 for a kernel not named: no decode or
    frontend runs one)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    expected = {k: (want or {}).get(k, 0) for k in launches}
    if launches != expected:
        raise AssertionError(f"{tag}: kernels launched {launches}, expected {expected}")
    return out, wall


def finite_metrics(tag: str, metrics: dict, keys) -> None:
    bad = {k: metrics.get(k) for k in keys if not (k in metrics and math.isfinite(metrics[k]))}
    if bad:
        raise AssertionError(f"{tag}: metrics {bad} of {metrics}")


def within_serve_steps(tag: str, lengths: list) -> None:
    """Raises unless a serve sub-phase decoded and every decode ran at most SERVE_STEPS steps (its tokens that
    long): serve_steps' cut took at each decode site."""
    if not lengths or max(lengths) > SERVE_STEPS:
        raise AssertionError(f"serve {tag}: decodes of {lengths} steps, SERVE_STEPS {SERVE_STEPS}")


def log_decodes(tag: str, calls: list) -> None:
    for c in calls:
        log(f"[serve {tag}] decode b{c['batch']}: {c['ms']:.1f} ms, {c['steps']} steps of {c['length']} "
            f"({c['ms'] / max(c['steps'], 1):.2f} ms/step)")
    within_serve_steps(tag, [c["length"] for c in calls])


@contextlib.contextmanager
def serve_steps(limit: int):
    """Every decode factory the serve path reaches (cli.test's Trainer, the fusion CLIs, cli.transcribe, the
    transcribers that the servers build) with its max_len cut to limit."""
    import inspect

    from omr_a2s_multimodal_transformer_tpu_torch import inference
    from omr_a2s_multimodal_transformer_tpu_torch.cli import sw_test, transcribe, weighted_test
    from omr_a2s_multimodal_transformer_tpu_torch.training import loop

    def clamped(factory):
        sig = inspect.signature(factory)

        def make(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.arguments["max_len"] = min(bound.arguments["max_len"], limit)
            return factory(*bound.args, **bound.kwargs)

        return make

    with contextlib.ExitStack() as stack:
        for module in (loop, sw_test, weighted_test, transcribe, inference):
            for name in ("greedy_decode_fn", "weighted_decode_fn", "beam_decode_fn"):
                if hasattr(module, name):
                    stack.enter_context(patched(module, name, clamped(getattr(module, name))))
        yield


def serve_cli_evals(dev, out_dir: Path) -> dict:
    """cli.test with beam search and MV2H, cli.weighted_test and cli.sw_test
    on the cli path's image and audio best/."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import sw_test, weighted_test
    from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
    from omr_a2s_multimodal_transformer_tpu_torch.training import loop

    img, aud = str(CLI_WS / "weights_image" / "best"), str(CLI_WS / "weights_audio" / "best")
    out = {}
    with patched(loop, "beam_decode_fn", Timed(loop.beam_decode_fn)) as beam:
        metrics, wall = counted("serve beam", lambda: test_cli.main(cli_data("image") + [
            "--device", dev.type, "--checkpoint_path", img, "--run_dir", str(CLI_WS / "test_run_beam"), "--beam_size", "4",
            "--length_penalty", "0.6", "--compute_mv2h", "--save_preds", str(out_dir / "preds_beam.jsonl")]))
    finite_metrics("serve beam", metrics, ["test_sym-er", "test_seq-er"] + [f"test_{k}" for k in MV2H_KEYS])
    if not beam.calls or beam.calls[0]["batch"] != CLI_CORPUS["n_test"]:
        raise AssertionError(f"serve beam: decodes {beam.calls}")
    log_decodes("beam k4", beam.calls)
    log(f"[serve beam] cli.test --beam_size 4 --length_penalty 0.6 --compute_mv2h: "
        f"{ {k: round(v, 4) for k, v in metrics.items()} }, {4 * beam.calls[0]['batch']} beam rows; wall {wall:.1f} s")
    out["beam"] = dict(metrics=metrics, decodes=beam.summary(), wall_s=wall)

    both = cli_data("both")[:-2] + ["--device", dev.type]  # the fusion CLIs take no --input_modality
    with patched(weighted_test, "weighted_decode_fn", Timed(weighted_test.weighted_decode_fn)) as weighted:
        metrics, wall = counted("serve weighted", lambda: weighted_test.main(both + [
            "--image_checkpoint_path", img, "--audio_checkpoint_path", aud, "--alpha", "0.5",
            "--run_dir", str(CLI_WS / "run_weighted"), "--save_preds", str(out_dir / "preds_weighted.jsonl")]))
    finite_metrics("serve weighted", metrics, ["sym-er", "seq-er"])
    log_decodes("weighted a=0.5", weighted.calls)
    log(f"[serve weighted] cli.weighted_test --alpha 0.5: {metrics}; wall {wall:.1f} s")
    out["weighted"] = dict(metrics=metrics, decodes=weighted.summary(), wall_s=wall)

    sw_s, sw_args = [], []

    def timed_fuse(*a, _fuse=sw_test.fuse_predictions):
        t0 = time.perf_counter()
        fused = _fuse(*a)
        sw_s.append(time.perf_counter() - t0)
        sw_args.append(a)
        return fused

    with patched(sw_test, "greedy_decode_fn", Timed(sw_test.greedy_decode_fn)) as greedy, \
            patched(sw_test, "fuse_predictions", timed_fuse):
        metrics, wall = counted("serve sw", lambda: sw_test.main(both + [
            "--image_checkpoint_path", img, "--audio_checkpoint_path", aud, "--run_dir", str(CLI_WS / "run_sw")]))
    finite_metrics("serve sw", metrics, ["sym-er", "seq-er"])
    if len(sw_s) != CLI_CORPUS["n_test"]:
        raise AssertionError(f"serve sw: {len(sw_s)} fused pairs")
    log_decodes("sw greedy", greedy.calls)
    # the longest pair again by the Python Gotoh route, the plain version: the same fusion, its time beside
    longest = sw_args[max(range(len(sw_s)), key=sw_s.__getitem__)]
    t0 = time.perf_counter()
    fused_python = sw_test.fuse_predictions(*longest, route="python")
    python_s = time.perf_counter() - t0
    if fused_python != sw_test.fuse_predictions(*longest):
        raise AssertionError("serve sw: the native and the Python route fuse the longest pair differently")
    log(f"[serve sw] cli.sw_test: {metrics}; Smith-Waterman on the host (the native route, csrc/editdist.cpp) "
        f"{sum(sw_s):.4f} s for {len(sw_s)} pairs ({max(sw_s):.4f} s the longest; that pair by the Python route "
        f"{python_s:.3f} s, the same fusion), decodes {sum(c['ms'] for c in greedy.calls) / 1e3:.1f} s; "
        f"wall {wall:.1f} s")
    out["sw"] = dict(metrics=metrics, decodes=greedy.summary(), host_sw_s=sw_s, python_route_longest_s=python_s,
                     wall_s=wall)
    return out


def serve_files(dev) -> dict:
    """cli.split_ckpt of the multimodal best/, then cli.transcribe of 4 test
    waves written as .wav with the split audio checkpoint (and, where PIL
    imports, of .png renders with the split image checkpoint and of the
    image/wave pairs): one .krn per input."""
    import shutil

    from scipy.io import wavfile

    from omr_a2s_multimodal_transformer_tpu_torch.cli import split_ckpt, transcribe
    from omr_a2s_multimodal_transformer_tpu_torch.data.sources import make_source
    from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h import seq2kern_lines

    (img_ckpt, aud_ckpt), wall = counted("serve split", lambda: split_ckpt.main([
        "--ckpt_path", str(CLI_WS / "weights_both" / "best"), "--out_prefix", str(CLI_WS / "split")]))
    log(f"[serve split] cli.split_ckpt: {Path(img_ckpt).name}, {Path(aud_ckpt).name} in {wall:.1f} s")
    files = CLI_WS / "files"
    shutil.rmtree(files, ignore_errors=True)
    files.mkdir(parents=True)
    src = make_source("synthetic", "test", encoding="kern", synthetic=True, synthetic_kwargs=dict(CLI_CORPUS))
    samples = [src[i] for i in range(SERVE_REQUESTS)]
    for i, s in enumerate(samples):
        wavfile.write(str(files / f"s{i}.wav"), s["audio"]["sampling_rate"], s["audio"]["array"])
    try:
        from PIL import Image
    except ImportError:
        Image = None
    # two runs: the waves alone in bf16 (greedy), and the .png renders with their waves in int8 (weighted): both
    # input kinds, both decode modes of cli.transcribe, bf16 and int8
    runs = [("wav", ["--checkpoint_path", aud_ckpt, "--inputs", str(files / "*.wav")])]
    if Image is None:
        log("[serve transcribe] PIL does not import on this machine: no .png run of cli.transcribe; the servers "
            "below take images and image/wave pairs as arrays")
        runs.append(("wav_int8", ["--checkpoint_path", aud_ckpt, "--inputs", str(files / "*.wav"), "--cache_dtype",
                                  "int8"]))
    else:
        for i, s in enumerate(samples):
            Image.fromarray(s["image"]).save(files / f"s{i}.png")
        runs.append(("fused_int8", ["--checkpoint_path", img_ckpt, "--audio_checkpoint_path", aud_ckpt, "--inputs",
                                    str(files / "*.png"), "--audio_inputs", str(files / "*.wav"), "--cache_dtype",
                                    "int8"]))
    (vocab_path,) = (CLI_WS / "cache" / "vocabs").glob("*.json")
    out = dict(split=[img_ckpt, aud_ckpt], pil=Image is not None)
    for tag, argv in runs:
        out_dir, written = files / f"krn_{tag}", {}

        def recording(tokens, path, _write=transcribe.seq2kern):
            written[Path(path).name] = tokens
            _write(tokens, path)

        with patched(transcribe, "seq2kern", recording):
            n, wall = counted(f"serve transcribe {tag}", lambda: transcribe.main(argv + [
                "--vocab_path", str(vocab_path), "--out_dir", str(out_dir), "--batch_size", "8",
                "--device", dev.type]))
        krn = sorted(out_dir.glob("*.krn"))
        # each file holds the kern lines of the tokens decoded for it
        wrong = [p.name for p in krn if p.read_text() != "\n".join(seq2kern_lines(written.get(p.name, []))) + "\n"]
        if n != SERVE_REQUESTS or [p.name for p in krn] != sorted(written) or len(krn) != SERVE_REQUESTS or wrong:
            raise AssertionError(f"serve transcribe {tag}: {n} transcribed, files {[p.name for p in krn]}, "
                                 f"written {sorted(written)}, wrong {wrong}")
        lines = [len(p.read_text().splitlines()) for p in krn]
        tokens = [len(written[p.name]) for p in krn]
        within_serve_steps(f"transcribe {tag}", tokens)
        log(f"[serve transcribe {tag}] cli.transcribe: {[p.name for p in krn]}, {tokens} tokens, {lines} kern "
            f"lines; wall {wall:.1f} s")
        out[tag] = dict(files=[p.name for p in krn], tokens=tokens, lines=lines, wall_s=wall, ids=written)
    if "wav_int8" in out:  # the int8 run decodes the same waves from quantized cross K/V: its tokens beside bf16's
        a, q = out["wav"].pop("ids"), out["wav_int8"].pop("ids")
        same = sum(int(x == y) for f in a for x, y in zip(a[f], q[f]))
        out["wav_int8"]["tokens_equal_bf16"] = same
        log(f"[serve transcribe wav_int8] --cache_dtype int8: {same} of {sum(map(len, a.values()))} tokens equal to "
            f"the bf16 run's, position for position")
    for tag in out:
        if isinstance(out[tag], dict):
            out[tag].pop("ids", None)
    return out


def serve_arrays(n):
    """n samples of the test split, then the val split, in the ladders'
    largest buckets (images wider than 2208, waves longer than 10 s): u8
    images and float32 waveforms. The corpus's 2-30 measure renders span
    293-4257 px and 1.2-18 s; one bucket pair keeps each server to one
    device call (its routing is held by the CPU tests)."""
    from omr_a2s_multimodal_transformer_tpu_torch.data.sources import make_source

    out = []
    for split in ("test", "val"):
        src = make_source("synthetic", split, encoding="kern", synthetic=True, synthetic_kwargs=dict(CLI_CORPUS))
        for i in range(len(src)):
            img, wave = src[i]["image"], src[i]["audio"]["array"]
            if img.shape[1] > SERVE_WIDTHS[-2] and len(wave) > SERVE_SECONDS[-2] * 22050 and len(out) < n:
                out.append((img, wave))
    if len(out) < n:
        raise AssertionError(f"serve: {len(out)} samples of the test and val splits in the largest buckets")
    log(f"[serve samples] images {[img.shape for img, _ in out]}, waves {[round(len(w) / 22050, 2) for _, w in out]} s")
    return out


def serve_server(dev, tag: str, models, vocab, samples) -> dict:
    """A TranscriptionServer (image, or fused at alpha 0.5) at the serve
    CLI's default ladders and its HTTP front: SERVE_REQUESTS requests from
    as many threads and one POST, released together. Every batch the
    server builds is recorded on its way to the device, then decoded again
    by the direct transcriber: the tokens must be equal, and each result
    must be a row of its batch."""
    import io
    import threading
    import urllib.request

    import numpy as np

    from omr_a2s_multimodal_transformer_tpu_torch import inference
    from omr_a2s_multimodal_transformer_tpu_torch.serving import TranscriptionServer, serve_http
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos

    kw = dict(image_height=SERVE_HEIGHT, image_widths=SERVE_WIDTHS)
    if tag == "fused":
        kw.update(audio_model=models[1], alpha=0.5, audio_samples=[int(s * 22050) for s in SERVE_SECONDS])
    server = TranscriptionServer(models[0], tag, vocab=vocab, max_wait_ms=SERVE_WAIT_MS, device=dev, **kw)
    calls, transcribe = [], server._transcribe

    def recording(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = transcribe(*a)
        torch.cuda.synchronize()
        calls.append((a, out, (time.perf_counter() - t0) * 1e3))
        return out

    server._transcribe = recording
    payloads = [(img, wave) if tag == "fused" else img for img, wave in samples]
    buf = io.BytesIO()
    if tag == "fused":
        np.savez(buf, image=samples[-1][0], wave=samples[-1][1])
    else:
        np.save(buf, samples[-1][0])
    httpd = serve_http(server, host="127.0.0.1", port=0)
    results, errors, posted = [None] * SERVE_REQUESTS, [], {}
    start = threading.Barrier(SERVE_REQUESTS + 1)

    def client(i):
        try:
            start.wait(timeout=60)
            results[i] = server.transcribe(payloads[i], timeout=600)
        except Exception as e:  # handed to the main thread, which raises it
            errors.append(e)

    def poster():
        try:
            start.wait(timeout=60)
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/transcribe",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                posted.update(status=r.status, body=json.loads(r.read()))
        except Exception as e:
            errors.append(e)

    reset_counts()
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_REQUESTS)]
        threads.append(threading.Thread(target=poster))
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) or None in results:
            raise AssertionError(f"serve {tag} server: errors {errors}, results {[r is not None for r in results]}")
        with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        stats = server.batch_stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop(timeout=600)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"serve {tag} server: kernels launched {launches}")
    if posted.get("status") != 200 or health != {"ok": True, "batches": stats}:
        raise AssertionError(f"serve {tag}: POST {posted.get('status')}, healthz {health}")
    # each recorded batch decoded again by the direct transcriber, out of the server
    if tag == "fused":
        direct = inference.make_fused_transcriber(models[0], models[1], vocab.sos_id, vocab.eos_id, device=dev)
    else:
        direct = inference.make_image_transcriber(models[0], vocab.sos_id, vocab.eos_id, device=dev)
    rows, max_score_err = [], 0.0
    for args, (tokens, scores), ms in calls:
        tokens2, scores2 = direct(*args)
        if not torch.equal(tokens2, tokens):
            raise AssertionError(f"serve {tag}: the direct transcriber's tokens differ from the server's batch")
        max_score_err = max(max_score_err, float((scores2 - scores).abs().max()))
        rows += cut_at_eos(tokens, tokens, vocab.eos_id)[0]
    served = [r.token_ids for r in results] + [posted["body"]["token_ids"]]
    if any(ids not in rows for ids in served):
        raise AssertionError(f"serve {tag}: a result is no row of the batches the server built")
    shapes = [tuple(a[0].shape) for a, _, _ in calls]
    within_serve_steps(f"{tag} server", [int(t.shape[-1]) for _, (t, _), _ in calls])
    latency = [r.latency_s for r in results] + [posted["body"]["latency_s"]]
    log(f"[serve {tag} server] {len(served)} requests ({SERVE_REQUESTS} threads + 1 POST): batch_stats {stats}, "
        f"batches {shapes}, device calls {[round(ms, 1) for _, _, ms in calls]} ms, latency per request "
        f"{[round(x, 2) for x in latency]} s, tokens equal to the direct transcriber's (scores within "
        f"{max_score_err:.2e}), POST 200 with {len(posted['body']['token_ids'])} tokens; wall {wall:.1f} s")
    return dict(batch_stats=stats, batches=shapes, device_call_ms=[ms for _, _, ms in calls], latency_s=latency,
                max_score_err=max_score_err, steps=[int((t != 0).any(0).sum()) for _, (t, _), _ in calls],
                wall_s=wall)


def serve_resize(dev, model, vocab, samples) -> dict:
    """make_image_transcriber(img_height=RESIZE_HEIGHT) on a b4 batch of raw
    u8 images on a 361 x 4416 canvas (white): the resized batch on the card
    within RESIZE_TOL of the same function on the CPU, tokens (4, SERVE_STEPS) (serve_steps cuts the decode)."""
    from omr_a2s_multimodal_transformer_tpu_torch import inference

    hw = torch.tensor([img.shape for img, _ in samples], dtype=torch.int32)
    raw = torch.full((len(samples), max(IMG_H, int(hw[:, 0].max())), IMG_W), 255, dtype=torch.uint8)
    for i, (img, _) in enumerate(samples):
        raw[i, :img.shape[0], :img.shape[1]] = torch.from_numpy(img)
    seen = []

    def recording(*a, _pre=inference.preprocess_image_batch, **kw):
        seen.append(_pre(*a, **kw))
        return seen[-1]

    transcribe = inference.make_image_transcriber(model, vocab.sos_id, vocab.eos_id, img_height=RESIZE_HEIGHT,
                                                  device=dev)
    with patched(inference, "preprocess_image_batch", recording):
        (tokens, scores), wall = counted("serve resize", lambda: transcribe(raw, hw))
    (x, hw2), = seen
    x_cpu, hw_cpu = preprocess_image_batch(raw, hw, target_height=RESIZE_HEIGHT)
    err = float((x.cpu() - x_cpu).abs().max())
    steps = int((tokens != 0).any(0).sum())
    log(f"[serve resize] raw {tuple(raw.shape)} -> x {tuple(x.shape)} on {x.device}, hw {hw2.tolist()}; max |card - "
        f"CPU| {err:.2e} (limit {RESIZE_TOL}); tokens {tuple(tokens.shape)}, {steps} steps in {wall * 1e3:.1f} ms "
        f"({wall * 1e3 / max(steps, 1):.2f} ms/step)")
    if (err > RESIZE_TOL or not torch.equal(hw2.cpu(), hw_cpu) or x.device.type != dev.type
            or tokens.shape != (len(samples), min(model.max_seq_len, SERVE_STEPS))
            or not torch.isfinite(scores).all()):
        raise AssertionError(f"serve resize: err {err}, hw {hw2.tolist()} vs {hw_cpu.tolist()}, tokens "
                             f"{tuple(tokens.shape)}")
    return dict(raw_shape=list(raw.shape), x_shape=list(x.shape), max_abs_err_vs_cpu=err, steps=steps,
                decode_ms=wall * 1e3)


def serve_path(dev, out_dir: Path, vocab) -> dict:
    """The inference and serving layer on the cli path's checkpoints (the
    paper model at full width, vocab and max_seq_len of the corpus), each
    step counted from 0 and launching no kernel, every decode SERVE_STEPS
    steps long (serve_steps): serve_cli_evals (beam + MV2H, weighted,
    Smith-Waterman), serve_files (split, transcribe), serve_server (image
    and fused, with HTTP), serve_resize."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import common

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (out_dir / "serve_path").mkdir(parents=True, exist_ok=True)
    with serve_steps(SERVE_STEPS):
        out = serve_cli_evals(dev, out_dir / "serve_path")
        out["files"] = serve_files(dev)
        models = [common.build_from_checkpoint(str(CLI_WS / f"weights_{tag}" / "best"), device=dev)[0]
                  for tag in ("image", "audio")]
        samples = serve_arrays(SERVE_REQUESTS)
        out["image_server"] = serve_server(dev, "image", models, vocab, samples)
        out["fused_server"] = serve_server(dev, "fused", models, vocab, samples)
        out["resize"] = serve_resize(dev, models[0], vocab, samples)
    del models
    torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["wall_s"] = time.perf_counter() - t0
    log(f"[serve path] peak memory {out['peak_gib']:.2f} GiB; wall {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ the tools path
# The port's experiment layer (omr_a2s_multimodal_transformer_tpu_torch/tools/) as a user runs it: the grid
# driver, the checkpoint evaluators and the diagnostics on the grid's image checkpoint, then the convergence run.
# The corpus: production image height on short scores (2-4 measures at the 30-measure geometry's density: 57-59 px
# of width a measure), "bands" audio, 16 train and 8 val/test samples; the max lengths and the vocabulary the
# corpus's own (--max_lens corpus), so every decode ends at its longest transcript. The hparams: the paper model at
# full width (attn_window 100, packed stem, bf16, flash cross-attention, b8) with the recipe of
# reports/grid_r05_bands.json's config (lr 3e-4, warmup 5 and cosine 150 epochs, clip 1.0, dropouts and token
# corruption 0), cut to TOOLS_EPOCHS a leg and CONV_EPOCHS a convergence run.
TOOLS_WS = ROOT / "build" / "chip_smoke_tools"
TOOLS_CORPUS = ["--train_n", "16", "--eval_n", "8", "--n_measures", "4", "--measures_range", "2", "4",
                "--render_style", "grand"]
TOOLS_RECIPE = ["--batch", "8", "--learning_rate", "3e-4", "--clip_norm", "1.0", "--encoder_dropout", "0",
                "--decoder_dropout", "0", "--pos_dropout", "0", "--teacher_forcing_prob", "0"]
TOOLS_STEPS_PER_EPOCH = 2  # 16 train samples at b8
TOOLS_EPOCHS = 2  # each grid leg, validating at the last
TOOLS_LEGS = ("image", "audio", "attn_img")
CONV_EPOCHS = 3  # the control and the production run alike (trajectory_match compares from the third epoch)
TRAJECTORY_TOL = 2e-2  # the mean relative train-loss difference, production against control, dropouts 0
DIAG_BATCHES = 1  # diagnose_errors' batches a split (train and val), each a tf_eval forward: K1 8 times


class CliTrains:
    """cli.train.main wrapped while the tools path runs: each call's kernel
    launches (the difference of the counts around it, which it does not
    reset), its steps (the Trainer's step at its last epoch) and wall."""

    def __init__(self):
        from omr_a2s_multimodal_transformer_tpu_torch.cli import train as train_cli

        self.module, self.real, self.calls = train_cli, train_cli.main, []

    def __call__(self, argv):
        before = read_counts()
        t0 = time.perf_counter()
        out = self.real(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = read_counts()
        run_dir = Path(argv[argv.index("--run_dir") + 1])
        steps = [r["step"] for r in cli_records(run_dir) if "train_loss" in r][-1]
        flash = "--use_flash_cross" in argv
        launches = {k: after[k] - before[k] for k in after}
        want = {k: 8 * steps if flash and k in ("K1 flash fwd", "K2 flash bwd") else 0 for k in after}
        log(f"[tools] cli.train {run_dir.name}: {steps} steps, launches {launches}, {wall:.1f} s")
        if launches != want:
            raise AssertionError(f"tools cli.train {run_dir.name} launched {launches}, expected {want}")
        self.calls.append(dict(run=run_dir.name, steps=steps, flash=flash, launches=launches, wall_s=wall,
                               keep_cache="--keep_cache" in argv))
        return out


def tools_path(dev, out_dir: Path) -> dict:
    """The port's tools on the card: run_grid (legs image, audio and the gated attn_img mixer warm-started from
    both with only cross_attn and mix_gate trained; TOOLS_EPOCHS each; then Smith-Waterman and weighted a=0.5
    fusion), then on the image leg's best/ eval_cache_dtypes (bf16, int8, int4 at beam 1), beam_sweep (beams 1
    and 2, length penalties 0 and 0.6) and diagnose_errors, then run_convergence (control and production,
    CONV_EPOCHS each). Every cli.train counted (CliTrains): K1 and K2 8 launches a train step in every leg and in
    the production run, none in the control run; no decode launches a kernel (each evaluator counted from 0;
    diagnose_errors' teacher-forced forwards launch K1 8 times a batch). K1 and K2 held to their plain version
    on the inputs of their first call in the grid (check_cli_flash). Every SER finite, every report key present,
    trajectory_match's mean within TRAJECTORY_TOL, and --keep_cache in each cli.train's argv and no other argv
    given to a parser, as the JAX tools pass it."""
    import argparse
    import shutil

    from omr_a2s_multimodal_transformer_tpu_torch.tools import (
        beam_sweep,
        diagnose_errors,
        eval_cache_dtypes,
        run_convergence,
        run_grid,
    )

    shutil.rmtree(TOOLS_WS, ignore_errors=True)
    grid_ws, flash_pair = TOOLS_WS / "grid", ("K1 flash fwd", "K2 flash bwd")
    best = str(grid_ws / "weights" / "image" / "best")
    evals = TOOLS_CORPUS + ["--batch", "8", "--checkpoint", best, "--cache_root", str(grid_ws / "grandstaff_cache"),
                            "--device", dev.type]
    argvs = []
    real_parse = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        if args is not None:
            argvs.append([str(a) for a in args])
        return real_parse(self, args, namespace)

    trains = CliTrains()
    t0 = time.perf_counter()
    out = {}
    with patched(argparse.ArgumentParser, "parse_args", parse), patched(trains.module, "main", trains):
        grid_argv = ["--workdir", str(grid_ws), *TOOLS_CORPUS, "--audio_style", "bands", *TOOLS_RECIPE,
                     "--epochs", str(TOOLS_EPOCHS), "--check_val_every_n_epoch", str(TOOLS_EPOCHS),
                     "--warmup_epochs", "5", "--schedule_epochs", "150", "--legs", *TOOLS_LEGS, "--mixer_residual",
                     "--warm_start_mixers", "--mixer_train_only", "cross_attn,mix_gate", "--alphas", "0.5",
                     "--max_lens", "corpus", "--device", dev.type]
        steps = len(TOOLS_LEGS) * TOOLS_EPOCHS * TOOLS_STEPS_PER_EPOCH
        with FirstCalls() as first:
            grid, grid_s = counted("tools run_grid", lambda: run_grid.main(grid_argv),
                                   {k: 8 * steps for k in flash_pair})
        errs = check_cli_flash(first.args, "tools grid")
        del first
        out["eval_cache_dtypes"], out["eval_cache_dtypes_s"] = counted("tools eval_cache_dtypes", lambda: (
            eval_cache_dtypes.main(evals + ["--workdir", str(TOOLS_WS / "cache_dtypes"), "--dtypes", "bfloat16",
                                            "int8", "int4", "--beams", "1"])))
        out["beam_sweep"], out["beam_sweep_s"] = counted("tools beam_sweep", lambda: beam_sweep.main(
            evals + ["--workdir", str(TOOLS_WS / "beam_sweep"), "--beams", "1", "2", "--lps", "0.0", "0.6"]))
        diag_argv = ["--workdir", str(grid_ws), "--ckpt", best, "--train_n", "16", "--eval_n", "8", "--n_measures",
                     "4", "--measures_range", "2", "4", "--render_style", "grand", "--n_batches", str(DIAG_BATCHES),
                     "--out", str(TOOLS_WS / "diagnose_errors.json"), "--device", dev.type]
        out["diagnose_errors"], out["diagnose_errors_s"] = counted(
            "tools diagnose_errors", lambda: diagnose_errors.main(diag_argv), {"K1 flash fwd": 8 * 2 * DIAG_BATCHES})
        conv_argv = ["--workdir", str(TOOLS_WS / "convergence"), *TOOLS_CORPUS, "--audio_style", "bands",
                     *TOOLS_RECIPE, "--eval_n", "8", "--epochs", str(CONV_EPOCHS), "--control_epochs",
                     str(CONV_EPOCHS), "--check_val_every_n_epoch", str(CONV_EPOCHS), "--warmup_steps",
                     str(5 * TOOLS_STEPS_PER_EPOCH), "--decay_steps", str(150 * TOOLS_STEPS_PER_EPOCH),
                     "--max_lens", "corpus", "--device", dev.type]
        conv_steps = CONV_EPOCHS * TOOLS_STEPS_PER_EPOCH
        out["convergence"], out["convergence_s"] = counted(
            "tools run_convergence", lambda: run_convergence.main(conv_argv), {k: 8 * conv_steps for k in flash_pair})
    wall = time.perf_counter() - t0

    # the launches of every cli.train: a leg or the production run 8 a step, the control none (CliTrains held each)
    runs = {c["run"]: c for c in trains.calls}
    if sorted(runs) != sorted([*TOOLS_LEGS, "control", "production"]) or runs["control"]["flash"] \
            or not all(runs[r]["flash"] for r in (*TOOLS_LEGS, "production")):
        raise AssertionError(f"tools: the cli.train runs {trains.calls}")
    keep = [a for a in argvs if "--keep_cache" in a]
    if len(keep) != len(trains.calls) or not all(c["keep_cache"] for c in trains.calls):
        raise AssertionError(f"tools: --keep_cache not in every cli.train argv and only there: {keep}")

    # the reports: every SER and loss finite, every key present
    conv = out["convergence"]
    match = conv.get("trajectory_match", {})
    checks = [(f"grid leg {leg}", grid["legs"].get(leg, {}), ("best_val_sym-er", "test_sym-er", "test_seq-er"))
              for leg in TOOLS_LEGS]
    checks += [(f"fusion {name}", grid["fusion"].get(name, {}), ("sym-er", "seq-er"))
               for name in ("smith_waterman", "weighted_a0.5")]
    checks += [(f"{name} row {i}", row, ("test_sym-er", "test_seq-er", "wall_s"))
               for name in ("eval_cache_dtypes", "beam_sweep") for i, row in enumerate(out[name]["rows"])]
    checks += [(f"diagnose_errors {split}", out["diagnose_errors"].get(split, {}),
                ("sym-er", "seq-er", "tf_eval_loss", "tf_eval_top1")) for split in ("train", "val")]
    checks += [("trajectory_match", match, ("epochs_compared", "mean_rel_loss_diff", "max_rel_loss_diff"))]
    trajectories = {f"grid leg {leg}": (grid["legs"].get(leg, {}).get("trajectory", []), TOOLS_EPOCHS)
                    for leg in TOOLS_LEGS}
    trajectories.update({f"convergence {tag}": (conv.get(f"{tag}_trajectory", []), CONV_EPOCHS)
                         for tag in ("control", "production")})
    for tag, (traj, epochs) in trajectories.items():
        if len(traj) != epochs:
            raise AssertionError(f"tools {tag}: {len(traj)} epochs, expected {epochs}: {traj}")
        checks += [(f"{tag} epoch {t['epoch']}", t, ("train_loss",)) for t in traj]
        checks.append((f"{tag} validation", traj[-1], ("val_sym-er", "val_seq-er")))
    for tag, metrics, keys in checks:
        finite_metrics(f"tools {tag}", metrics, keys)
    if [len(out[name]["rows"]) for name in ("eval_cache_dtypes", "beam_sweep")] != [3, 3] \
            or "best" not in out["beam_sweep"]:
        raise AssertionError(f"tools: the evaluators' rows {out['eval_cache_dtypes']}, {out['beam_sweep']}")
    if match["epochs_compared"] < 1 or not match["mean_rel_loss_diff"] <= TRAJECTORY_TOL:
        raise AssertionError(f"tools convergence: trajectory_match {match} (mean within {TRAJECTORY_TOL})")
    table = run_grid._markdown(grid)

    (out_dir / "tools_path").mkdir(parents=True, exist_ok=True)
    for path in TOOLS_WS.rglob("*"):
        if path.name in ("metrics.jsonl", "report.json", "diagnose_errors.json"):
            shutil.copyfile(path, out_dir / "tools_path" / str(path.relative_to(TOOLS_WS)).replace("/", "_"))
    log("[tools] run_grid table:\n" + table)
    dtypes = [(r["cache_dtype"], r["beam_size"], r["test_sym-er"]) for r in out["eval_cache_dtypes"]["rows"]]
    beams = [(r["beam"], r["length_penalty"], r["test_sym-er"]) for r in out["beam_sweep"]["rows"]]
    log(f"[tools] eval_cache_dtypes {dtypes}; beam_sweep {beams}; "
        f"diagnose_errors val sym-er {out['diagnose_errors']['val']['sym-er']}, tf loss "
        f"{out['diagnose_errors']['val']['tf_eval_loss']}; trajectory_match {match}")
    log(f"[tools path] wall {wall:.1f} s: run_grid {grid_s:.1f} s (cli.train "
        + ", ".join(f"{c['run']} {c['wall_s']:.1f}" for c in trains.calls) + f"), eval_cache_dtypes "
        f"{out['eval_cache_dtypes_s']:.1f} s, beam_sweep {out['beam_sweep_s']:.1f} s, diagnose_errors "
        f"{out['diagnose_errors_s']:.1f} s, run_convergence {out['convergence_s']:.1f} s")
    return dict(out, grid=grid, grid_s=grid_s, trains=trains.calls, argvs=len(argvs), wall_s=wall,
                steps=dict(grid=steps, production=conv_steps), max_abs_err=errs)


# ------------------------------------------------------------------ the bench path
# The port's measurement tools at the collection's largest shapes, each cut to the fewest iterations that read a
# steady number (their defaults are JAX's; PERF.md has their numbers at those): bench_train_max one untimed step and
# BENCH_BLOCKS blocks of BENCH_STEPS steps a variant, bench_decode_max and bench_serve decodes of BENCH_DECODE_LEN
# steps, bench_serve 2 clients of 1 request after its warm-up, bench_ingest 16 samples a backend.
BENCH_WS = ROOT / "build" / "chip_smoke_bench"
BENCH_STEPS, BENCH_BLOCKS = 2, 2
BENCH_DECODE_LEN = 64
BENCH_INGEST_N = 16
# remat recomputes the encoder blocks in the backward and the decoder layers only off the flash path
# (models/transformer.py, as in JAX): K1 and K2 launch once a decoder layer a step, none replayed
BENCH_FLASH_PER_STEP = 8
# K1's o and K2's dq/dk/dv at bench_train_max's first flash call, as a share of max |plain| (the cli runs' fused
# memory, 13,520 keys: 5.6-7.4e-3)
BENCH_FLASH_TOL = 1e-2


def bench_path(dev, out_dir: Path) -> dict:
    """The four measurement tools of the port on the card, each counted from 0 (BENCH_* above): bench_train_max's
    plain variant launching no kernel and its flash variant K1 and K2 BENCH_FLASH_PER_STEP times a step (the tool's
    own count of its first step too), K1/K2 held to their plain version on their first call there (B 2, Lq 1268,
    Lk 14,009, dropout 0.1, no padded key) within BENCH_FLASH_TOL; bench_decode_max (b8, bf16 cache), bench_serve (image) and bench_ingest
    launching none. Every number finite and positive; each tool's line logged."""
    import shutil

    from omr_a2s_multimodal_transformer_tpu_torch.tools import (
        bench_decode_max,
        bench_ingest,
        bench_serve,
        bench_train_max,
    )

    shutil.rmtree(BENCH_WS, ignore_errors=True)
    flash_pair = ("K1 flash fwd", "K2 flash bwd")
    steps = 1 + BENCH_STEPS * BENCH_BLOCKS

    def train(variant):
        argv = ["2", variant, "--steps", str(BENCH_STEPS), "--blocks", str(BENCH_BLOCKS), "--device", dev.type]
        return bench_train_max.main(argv)[variant]

    t0 = time.perf_counter()
    out = {}
    out["train_plain"], out["train_plain_s"] = counted("bench_train_max plain", lambda: train("plain"))
    with FirstCalls() as first:
        out["train_flash"], out["train_flash_s"] = counted("bench_train_max flash", lambda: train("flash"),
                                                           {k: BENCH_FLASH_PER_STEP * steps for k in flash_pair})
    launches = {k: read_counts()[k] for k in flash_pair}  # before the comparison's own launches
    errs = check_cli_flash(first.args, "bench_train_max", padded=False)
    del first
    if max(errs["rel"].values()) > BENCH_FLASH_TOL:
        raise AssertionError(f"bench_train_max: K1/K2 at their first call {errs['rel']} of max |plain|, "
                             f"above {BENCH_FLASH_TOL}")
    torch.cuda.empty_cache()
    flash = out["train_flash"]
    if (flash["k1_per_step"], flash["k2_per_step"]) != (BENCH_FLASH_PER_STEP,) * 2:
        raise AssertionError(f"bench_train_max flash: its first step launched K1/K2 {flash['k1_per_step']}/"
                             f"{flash['k2_per_step']} times, expected {BENCH_FLASH_PER_STEP}")
    out["decode"], out["decode_s"] = counted("bench_decode_max", lambda: bench_decode_max.main(
        ["--batch", "8", "--max_len", str(BENCH_DECODE_LEN), "--iters", "1", "--device", dev.type]))
    out["serve"], out["serve_s"] = counted("bench_serve", lambda: bench_serve.main(
        ["image", "--clients", "2", "--requests", "1", "--max_len", str(BENCH_DECODE_LEN), "--device", dev.type])[0])
    out["ingest"], out["ingest_s"] = counted("bench_ingest", lambda: bench_ingest.main(
        ["--n", str(BENCH_INGEST_N), "--workdir", str(BENCH_WS / "ingest"), "--device", dev.type]))
    wall = time.perf_counter() - t0
    torch.cuda.empty_cache()

    numbers = {"train plain": [out["train_plain"]["samples_per_s"], out["train_plain"]["first_loss"]],
               "train flash": [flash["samples_per_s"], flash["first_loss"]],
               "decode": [out["decode"]["samples_per_s"], out["decode"]["ms_per_step"]],
               "serve": [out["serve"]["p50_ms"], out["serve"]["p99_ms"], out["serve"]["samples_per_sec"]],
               "ingest": [v for ln in out["ingest"] for v in (ln["cold_samples_per_sec"], ln["warm_samples_per_sec"])]}
    bad = {k: v for k, v in numbers.items() if not all(math.isfinite(x) and x > 0 for x in v)}
    if bad or len(out["ingest"]) != 2 or out["serve"]["requests"] != 2:
        raise AssertionError(f"bench path: numbers {bad or numbers}, ingest {out['ingest']}, serve {out['serve']}")
    (out_dir / "bench_path").mkdir(parents=True, exist_ok=True)
    (out_dir / "bench_path" / "lines.json").write_text(json.dumps(out, indent=1))
    log(f"[bench] bench_train_max b2: plain {out['train_plain']['samples_per_s']:.3f} samples/s (blocks "
        f"{out['train_plain']['blocks']}), flash {flash['samples_per_s']:.3f} (blocks {flash['blocks']}), K1/K2 "
        f"{flash['k1_per_step']}/{flash['k2_per_step']} a step, {launches} launches read in its {steps} steps; first "
        f"losses {out['train_plain']['first_loss']:.4f} / {flash['first_loss']:.4f}")
    log(f"[bench] bench_decode_max {json.dumps(out['decode'])}")
    log(f"[bench] bench_serve {json.dumps(out['serve'])}")
    for line in out["ingest"]:
        log(f"[bench] bench_ingest {json.dumps(line)}")
    log(f"[bench path] wall {wall:.1f} s: train plain {out['train_plain_s']:.1f} s, flash {out['train_flash_s']:.1f} "
        f"s, decode {out['decode_s']:.1f} s, serve {out['serve_s']:.1f} s, ingest {out['ingest_s']:.1f} s")
    return dict(out, steps=steps, launches=launches, wall_s=wall, max_abs_err=errs)


# the tools of the bench path at cut shapes (bench_tools); the paper model's traced step runs in a process of its
# own: a profiler trace taken late in the smoke's process has held no kernel (5 takes of 5 after the cli and serve
# paths)
TOOLS_DECODE_STEPS = 64
TOOLS_STREAM_SECONDS = 2
FRONTEND_REPS = 5  # frontend_cache_times: the median of this many calls of each
TOOLS_TRACE_TIMEOUT_S = 600
# hbm_ledger --skip_measure: in each of its two variants (remat off, on) the first step, the byte count's and the
# FLOP count's: K1 and K2 8 launches each
LEDGER_STEPS = 3


def tool_lines(tag: str, fn, kernels=(), exact=None, out_dir: Path = None):
    """fn() with its standard output kept (out_dir/bench_path/<tag>.txt) and its first line logged, every kernel's
    launch count set to 0 first: ``exact`` the launches it must make ({name: n}), else each of ``kernels`` at
    least once and no other; a line of its output that reports a failure (FAILED) is logged and fails the phase.
    Returns (fn's result, wall s, launches)."""
    import io

    reset_counts()
    torch.cuda.synchronize()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    text = buf.getvalue()
    (out_dir / "bench_path" / f"{tag}.txt").write_text(text)
    lines = text.splitlines()
    log(f"[bench tools] {tag}: {wall:.1f} s, launches {launches}; {lines[0] if lines else '(no output)'}")
    failed = [ln for ln in lines if "FAILED" in ln]
    for ln in failed:
        log(f"[bench tools] {tag}: {ln}")
    if failed:
        raise AssertionError(f"bench tools {tag}: {failed}")
    if (exact is not None and launches != exact) or (exact is None and set(launches) != set(kernels)):
        raise AssertionError(f"bench tools {tag}: launched {launches}, expected {exact or kernels}")
    return out, wall, launches


def finite_positive(tag: str, values) -> None:
    values = list(values)
    if not values or not all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0 for v in values):
        raise AssertionError(f"bench tools {tag}: numbers {values}")


def traced_paper_step(out_dir: Path) -> dict:
    """profile_flagship's paper config (the paper model's b8 step, packed stem, flash cross-attention) in a process
    of its own: 1 step a block, FLOPs and bytes, one traced step by module; then trace_breakdown of its trace here
    (raising on a trace without GPU kernels), by module and by role, the attributed share logged."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools import trace_breakdown as tb

    trace_dir = out_dir / "bench_path" / "paper_trace"
    cmd = [sys.executable, "-m", "omr_a2s_multimodal_transformer_tpu_torch.tools.profile_flagship", "paper",
           "--packed", "--steps", "1", "--breakdown", "30", "--trace", str(trace_dir)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=TOOLS_TRACE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    (out_dir / "bench_path" / "profile_flagship.txt").write_text(run.stdout + run.stderr)
    if run.returncode != 0:
        raise AssertionError(f"profile_flagship paper exited {run.returncode}: {run.stderr[-2000:]}")
    keep = [ln for ln in run.stdout.splitlines() if ln.startswith(("cost analysis", "memory", "measured", "achieved"))]
    log(f"[bench tools] profile_flagship paper ({wall:.1f} s, its own process): {'; '.join(keep)}")
    b = tb.breakdown(str(trace_dir / "trace.json"), depth=tb.ROLE_DEPTH, device="cuda")
    by_role = tb.roles(b["groups"])
    share = b["attributed_ms"] / b["total_ms"]
    log(f"[bench tools] trace_breakdown of one paper-model b8 step: {b['events']} device events, "
        f"{b['total_ms']:.3f} ms, attributed {b['attributed_ms']:.3f} ms ({100 * share:.1f}%); by role: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_role.items(), key=lambda kv: -kv[1])))
    finite_positive("trace_breakdown", [b["total_ms"], b["attributed_ms"]])
    top = sorted(b["groups"].items(), key=lambda kv: -kv[1])[:40]
    return dict(wall_s=wall, lines=keep, total_ms=b["total_ms"], attributed_ms=b["attributed_ms"],
                attributed_share=share, events=b["events"], roles=by_role, top_groups=dict(top))


def frontend_cache_times(folder: Path) -> dict:
    """Host ms of each frontend call on a cli-path sample of 30 measures (a 355-362 x 4300-4413 render, a
    17-18.7 s wave),
    computed (the function under the cache) against the cache's own work: hashing the arguments, and reading the
    entry back (a hit: the key and a memory-mapped read, the values touched). The spectrogram and the resize
    (RESIZE_HEIGHT) through the cached functions; the image at its own height, which is not cached, through the
    same key and read of an entry of its output. Medians of FRONTEND_REPS calls; the reads are warm (the entry
    just written, in the page cache)."""
    import shutil
    import statistics

    import numpy as np

    from omr_a2s_multimodal_transformer_tpu_torch.data import frontends
    from omr_a2s_multimodal_transformer_tpu_torch.data.sources import make_source

    def ms(fn):
        times = []
        for _ in range(FRONTEND_REPS):
            t0 = time.perf_counter()
            out = fn()
            if isinstance(out, np.ndarray):  # an entry read back: its values touched
                out.sum()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    shutil.rmtree(folder, ignore_errors=True)
    saved = os.environ[frontends.CACHE_ENV]
    os.environ[frontends.CACHE_ENV] = str(folder)
    try:
        corpus = dict(CLI_CORPUS, n_measures_range=[30, 30])  # a render and a wave at the corpus's largest
        s = make_source("synthetic", "test", encoding="kern", synthetic=True, synthetic_kwargs=corpus)[0]
        image, wave, sr = s["image"], s["audio"]["array"], s["audio"]["sampling_rate"]
        entry = folder / "image.npy"
        frontends._store(str(entry), frontends.preprocess_image(image))
        calls = {
            "preprocess_audio": (lambda: frontends.preprocess_audio.__wrapped__(wave, sr),
                                 lambda: frontends._key("preprocess_audio", np.asarray(wave, np.float32), (sr,)),
                                 lambda: frontends.preprocess_audio(wave, sr)),
            "preprocess_image resize": (lambda: frontends.resized_image.__wrapped__(image, RESIZE_HEIGHT),
                                        lambda: frontends._key("resized_image", image, (RESIZE_HEIGHT,)),
                                        lambda: frontends.preprocess_image(image, RESIZE_HEIGHT)),
            "preprocess_image own height (not cached)": (
                lambda: frontends.preprocess_image(image),
                lambda: frontends._key("image", image, (None,)),
                lambda: (frontends._key("image", image, (None,)), frontends._load(str(entry)))[1]),
        }
        out = {}
        for name, (compute, key, hit) in calls.items():
            hit()  # the cached functions write their entry here
            out[name] = dict(compute_ms=ms(compute), key_ms=ms(key), hit_ms=ms(hit))
            out[name]["saved_ms"] = out[name]["compute_ms"] - out[name]["hit_ms"]
    finally:
        os.environ[frontends.CACHE_ENV] = saved
        shutil.rmtree(folder, ignore_errors=True)
    log(f"[bench tools] frontend cache, host ms a call (image {tuple(image.shape)}, wave {len(wave)} samples at {sr} "
        "Hz): " + "; ".join(f"{k}: computed {v['compute_ms']:.2f}, key {v['key_ms']:.2f}, read back {v['hit_ms']:.2f}"
                             for k, v in out.items()))
    finite_positive("frontend cache", [v for row in out.values() for k, v in row.items() if k != "saved_ms"])
    return out


def bench_tools(dev, out_dir: Path, ingest_lines: list) -> dict:
    """The root tools ported last, at cut shapes, each counted from 0 and its first line logged (tool_lines):
    profile_flagship's paper step with its trace read by trace_breakdown (traced_paper_step, its own process);
    hbm_ledger at FCFG (b8 multimodal, remat off and on) without its timing (K1/K2 8 a step, LEDGER_STEPS steps a
    variant); microbench_decode_step at its shapes for TOOLS_DECODE_STEPS steps a variant (no kernel); bench_stem
    at b8 361 x 4416, 2-step blocks (no kernel); bench_fused_block at its three blocks, 3-step runs (K5a and K5b);
    sweep_flash_blocks over two mask geometries and two key splits (K1, K2, K3a); prerender_corpus of 8 renders,
    measure_stream_rate's thread loader on a 64-sample corpus for TOOLS_STREAM_SECONDS s a phase, summarize_ingest of
    the cli path's image run and bench_ingest's lines, frontend_cache_times (no kernel). Every number finite and
    positive."""
    from omr_a2s_multimodal_transformer_tpu_torch.tools import (
        bench_fused_block,
        bench_stem,
        hbm_ledger,
        measure_stream_rate,
        microbench_decode_step,
        prerender_corpus,
        summarize_ingest,
        sweep_flash_blocks,
    )

    ws, d = BENCH_WS / "tools", ["--device", dev.type]
    ws.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = {"paper_step": traced_paper_step(out_dir)}
    flash = {"K1 flash fwd": 8 * 2 * LEDGER_STEPS, "K2 flash bwd": 8 * 2 * LEDGER_STEPS}
    ledger, out["hbm_ledger_s"], _ = tool_lines("hbm_ledger", lambda: hbm_ledger.main(
        ["--skip_measure", "--top", "10", "--out", str(ws / "hbm_ledger.json"), *d]), exact=flash, out_dir=out_dir)
    out["hbm_ledger"] = {k: {m: v[m] for m in v if m != "top_sites"} for k, v in ledger["variants"].items()}
    finite_positive("hbm_ledger", [v for var in out["hbm_ledger"].values() for v in
                                   (var["op_traffic_gb"], var["flops_tf"], var["peak_gib"])])
    torch.cuda.empty_cache()
    out["decode_split"], out["decode_split_s"], _ = tool_lines("microbench_decode_step", lambda: microbench_decode_step.main(
        ["--steps", str(TOOLS_DECODE_STEPS), *d]), exact={}, out_dir=out_dir)
    finite_positive("microbench_decode_step", [v[k] for v in out["decode_split"].values() for k in ("host_ms", "device_ms")])
    torch.cuda.empty_cache()
    out["stem"], out["stem_s"], _ = tool_lines("bench_stem", lambda: bench_stem.main(["--steps", "2", "--strict", *d]),
                                               exact={}, out_dir=out_dir)
    if set(out["stem"]) != set(bench_stem.MODES):
        raise AssertionError(f"bench_stem: modes {sorted(out['stem'])}, expected {bench_stem.MODES}")
    finite_positive("bench_stem", out["stem"].values())
    torch.cuda.empty_cache()
    out["fused_block"], out["fused_block_s"], launches = tool_lines(
        "bench_fused_block", lambda: bench_fused_block.main(["--steps", "3", *d]),
        kernels=("K5a fused stem k1", "K5b fused stem k2"), out_dir=out_dir)
    if launches["K5a fused stem k1"] != launches["K5b fused stem k2"]:
        raise AssertionError(f"bench_fused_block: K5a and K5b launched {launches}")
    finite_positive("bench_fused_block", [v for row in out["fused_block"].values() for k, v in row.items()
                                          if k.endswith("_ms")])
    torch.cuda.empty_cache()
    out["sweep"], out["sweep_s"], _ = tool_lines("sweep_flash_blocks", lambda: sweep_flash_blocks.main(
        ["--bq", "128", "256", "--bk", "2048", "--splits", "3", "4", "--iters", "3", *d]),
        kernels=("K1 flash fwd", "K2 flash bwd", "K3a flash dq"), out_dir=out_dir)
    finite_positive("sweep_flash_blocks", [*out["sweep"]["blocks"].values(), *out["sweep"]["k1"].values(),
                                           *out["sweep"]["k3a"].values()])
    if len(out["sweep"]["blocks"]) != 2:
        raise AssertionError(f"sweep_flash_blocks: geometries {out['sweep']['blocks']}")
    torch.cuda.empty_cache()
    out["prerender"], out["prerender_s"], _ = tool_lines("prerender_corpus", lambda: prerender_corpus.main(
        ["--train_n", "4", "--eval_n", "2", "--measures_range", "2", "4", *d]), exact={}, out_dir=out_dir)
    out["stream_rate"], out["stream_rate_s"], _ = tool_lines("measure_stream_rate", lambda: measure_stream_rate.main(
        ["--train_n", "64", "--seconds", str(TOOLS_STREAM_SECONDS), "--backends", "threads", "--workdir",
         str(ws / "stream"), "--out", str(ws / "stream_rate.json"), *d]), exact={}, out_dir=out_dir)
    finite_positive("measure_stream_rate", [v.get("samples_per_sec", math.nan) for ph in ("rates", "cold")
                                            for v in out["stream_rate"][ph].values()])
    (ws / "ingest.log").write_text("".join(json.dumps(ln) + "\n" for ln in ingest_lines))
    out["ingest_summary"], _, _ = tool_lines("summarize_ingest", lambda: summarize_ingest.main(
        ["--run_dir", str(CLI_WS / "run_image"), "--ingest_log", str(ws / "ingest.log"),
         "--out", str(ws / "ingest_summary.json")]), exact={}, out_dir=out_dir)
    if out["ingest_summary"]["loader_only"] != ingest_lines or not out["ingest_summary"]["train_epochs"]:
        raise AssertionError(f"summarize_ingest: {out['ingest_summary']}")
    out["frontend_cache"] = frontend_cache_times(ws / "frontend_times")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[bench tools] wall {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ the parallel path
# The parallel path's ranks, each a process of its own. With one card they share it under gloo (NCCL refuses two
# ranks on one GPU): two ranks on a dp 2 x 1 and a tp 1 x 2 mesh, then four on the 2 x 2 mesh; their times are not
# scaling figures (each rank's step runs beside the others'). With four or more cards each of four ranks takes a
# card of its own under NCCL (parallel/multihost.py initialize) and runs dp 4 x 1, 2 x 2 and tp 1 x 4 (with two or
# three cards the two ranks run NCCL and the four ranks of the 2 x 2 mesh gloo).
PAR_WS = ROOT / "build" / "chip_smoke_parallel"
PAR_TWO = (("dp", 2, 1), ("tp", 1, 2))  # (tag, data ranks, model ranks)
PAR_FOUR = (("dp4", 4, 1), ("2x2", 2, 2), ("tp4", 1, 4))
PAR_2X2 = (("2x2", 2, 2),)
PAR_NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
# the single-process reference of a rank's dropout-0 step takes the batch in the row blocks of the rank's data
# axis (split_grads), as the ranks do, and its gradient is the mean of PAR_REF_RUNS such steps: at JAX's
# initialisers the encoder's conv kernels hold most of the gradient's norm, and their gradients move 1.2-1.3e-2
# (relative L2, the whole gradient) from one bf16 step to the same step again on an H100 (K2's reduce-add; cuDNN's
# deterministic algorithms leave it so), 2.3-2.5e-2 between 8 rows and two blocks of 4 and 0.22 between 8 rows and
# four blocks of 2 (diag_grad_split.py; at torch's initialisers 7e-4, 7.8e-3 and 1.1e-2). The mean of three
# steps takes the reference's own share of a rank's distance to it down by a factor of about 1.7 (the root of 3).
PAR_REF_RUNS = 3
PAR_LR = 1e-4
# the gated attn_both model's mix_gate in the multimodal step: nonzero, so that the mixer's gradients are not 0
PAR_MM_GATE = (0.7, -1.3)
PAR_MM = dict(input_modality="both", mixer_type="attn_both", mixer_residual=True)
# the dropout-0 step's global-norm clip: far below the paper model's gradient norm at its seeded weights, so it
# fires; the gradients after it, gathered to full tensors, must have the global norm PAR_CLIP to PAR_CLIP_TOL
# (relative) in the reference and in every rank: a mesh norm that counted a replicated parameter twice or a
# sharded one in part would scale them otherwise (Adam's first step, lr * g / |g|, does not show the clip)
PAR_CLIP = 0.1
PAR_CLIP_TOL = 1e-3
# a rank's loss against the single-process step's on the card, and on a mesh without a 'model' axis its gradients
# (relative L2) against the reference in its own row blocks: bf16 scale (JAX holds its model forward under a mesh
# to 2e-2, tests/test_flash_sharded.py:58); the dp reading is the step's own spread above against the mean of three
PAR_TOL = 2e-2
# the gradients on a mesh with a 'model' axis: the tp forward's per-rank column and row products round otherwise
# than the single process's one GEMM (the loss 1.2-1.5e-6 relative, dp 0), and at JAX's initialisers the encoder's
# conv gradients amplify any such rounding (as they do a row split: 0.21 at 2-row blocks, diag_grad_split.py). Both
# tp sums are float32 (models/decoder.py row_parallel, column_parallel, the memory's summed_once); on an H100 80GB
# HBM3 at 700 W tp 1 x 2 read 2.81e-2 with bf16 sums, 2.33-2.57e-2 with float32 forward sums, 2.27-2.46e-2 with
# float32 input-gradient sums all-reduced a layer (2.29e-2 in a later call), and 2.235-2.366e-2 (the encoder's
# leaves 2.45e-2, the rest 1.56e-2) with the memory's summed over the layers first and all-reduced once; 2 x 2
# 2.92e-2, 2.31-2.77e-2, 2.42-2.60e-2 and 2.436-2.497e-2; on four such cards (NCCL, the per-layer sums) 2 x 2
# 2.493e-2 (the gated attn_both model 2.144e-2)
# and tp 1 x 4 2.177e-2; deterministic on the CPU at a mid size 3.58e-2, 3.44e-2, 3.40e-2, 3.41e-2
# (diag_grad_split.py --ranks; PERF.md). Still above PAR_TOL, so the limit is 1.5 times the largest reading with
# both sums float32 (2.602e-2 gives 3.90e-2), rounded down to the first design's 3.7e-2
PAR_TP_GRAD_TOL = 3.7e-2
# the share of parameter elements whose update differs from the single-process one by more than 1e-3 x lr:
# Adam's first step moves each by lr times the sign of its gradient, which the rounding above flips where the
# gradient is near 0, and, where the clip has brought a gradient near Adam's eps, by less than lr, which that
# rounding changes too (on the card at JAX's initialisers dp 2.67-2.90%, tp 1 x 2 19.49-19.53% and 2 x 2
# 19.07-19.08% with the float32 sums, 20.7-20.8% with bf16 ones; on four cards tp 1 x 4 18.75%, 2 x 2 19.07%, the
# gated attn_both model 20.81%; 16.8% under tp on the CPU, diag_grad_split.py --ranks): 1.5 times the largest
# (0.312), capped at 0.25
PAR_OTHERWISE_MAX = 0.25
PARTITION_TOL = 1e-5  # memory_partition's loss against the unpartitioned one (JAX: tests/test_parallel.py:138)
# remat against no remat: the same first step, the same seeded weights and generator state, each with the default
# backward (K2's reduce-add, cuDNN's algorithms), whose gradients move from run to run. The exact gate is the
# recompute itself: each remat'd block's output in the backward's recompute equals its forward's bit for bit
# (RecomputeCheck; a recompute in another precision or with other dropout bits fails it). The coarse one: the remat
# step's gradients (relative L2 over the whole tree) must lie within REMAT_SPREAD times the no-remat step's distance
# to itself run again. At JAX's initialisers on an H100 remat lay 1.46-1.51e-2 from no remat and the bf16 step
# 1.2-1.5e-2 from itself (diag_grad_split.py)
REMAT_SPREAD = 2.0
PAR_RANK_TIMEOUT_S = 900
# the CLIs under torchrun train and decode the cli path's corpus cut to scores of 2-4 measures at the same image
# widths and vocabulary of 215 (the cli path's 2-30 measures give max_seq_len 670, 2-10 gave 240, 2-6 148): a tp
# rank's greedy step on the one card waits on 25 gloo all-reduces through the host (82 ms a step against dp's 15),
# and every cli.train validates once and tests once by greedy decode to max_seq_len (the tp resume's two decodes
# took 57.6 s of its 101.3 s at 240); the tp resume's validation also saves the last/ that parallel_cli reads
PAR_CORPUS = dict(CLI_CORPUS, n_measures=4, n_measures_range=[2, 4])
# cli.test on the ranks against the single process on the same checkpoint, both with its default bf16 decode cache:
# a rank decodes 8 / nproc rows where the single process decodes 8, so the card rounds the cached K/V and the
# logits otherwise, and a near-tie greedy step can flip a token and what follows it (in one of four runs on an
# H100 80GB HBM3 at 700 W, at the cli path's corpus: 1 row of 8, SER 181.027 against 180.986, one edit of 2,406
# reference tokens). Held exactly: the rows, each
# row's length (where its EOS fell, or max_seq_len) and the seq-er; bounded: the rows that differ (twice that
# reading) and the SER gap in points (about ten edits of the 2-10 measure corpus's 966 test reference tokens; fewer
# at 2-6 measures)
PAR_TEST_ROWS_MAX = 2
PAR_TEST_SER_MAX = 1.0


def rank_groups(n_cards: int) -> list:
    """(world, meshes) of each spawn of the parallel path's ranks on n_cards cards."""
    if n_cards >= 4:
        return [(4, PAR_FOUR)]
    return [(2, PAR_TWO), (4, PAR_2X2)]


def _global_norm(grads: dict) -> float:
    return sum(float(g.double().square().sum()) for g in grads.values()) ** 0.5


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    return (num / max(den, 1e-30)) ** 0.5


def rng_device_ms(fn, path: Path) -> dict:
    """Device time of one train step fn(): all its kernels, the random-number kernels among them (PyTorch's
    distribution kernels: every dropout draw and token corruption) and NCCL's (the collectives of a rank a card;
    gloo's run on the host), from a profiler trace that holds its 8 K1 and 8 K2 launches (taken again, with
    another step, up to TRACE_TRIES times)."""
    for _ in range(TRACE_TRIES):
        events = traced_kernels(fn, 1, path)
        flash = {"K1": sum("flash_fwd_tma" in e["name"] and "merge" not in e["name"] for e in events),
                 "K2": sum("flash_bwd_kernel" in e["name"] for e in events)}
        if flash == {"K1": 8, "K2": 8}:
            break
        TRACES["retaken"] += 1
    rng = [e["dur"] for e in events if "distribution" in e["name"]]
    nccl = sorted((e["dur"] for e in events if "nccl" in e["name"].lower()), reverse=True)
    return dict(rng_ms=sum(rng) / 1e3, rng_kernels=len(rng), all_ms=sum(e["dur"] for e in events) / 1e3,
                flash_kernels=flash, nccl_ms=sum(nccl) / 1e3, nccl_kernels=len(nccl),
                nccl_longest_ms=nccl[0] / 1e3 if nccl else 0.0)


def multimodal_batch(dev) -> dict:
    """The b8 image batch of train_batch with 18 s spectrograms: 1,261 memory keys (13 x 97), the cli path's
    audio bucket."""
    g = torch.Generator(device=dev).manual_seed(2)
    batch = train_batch(dev, g)
    audio_w = 776
    xa = torch.rand((B, 195, audio_w, 1), generator=g, device=dev)
    xa_hw = torch.tensor([[195, audio_w - 40 * i] for i in range(B)], dtype=torch.int32, device=dev)
    return {"xi": batch["x"], "xi_hw": batch["x_hw"], "xa": xa, "xa_hw": xa_hw, "y_in": batch["y_in"],
            "y_out": batch["y_out"]}


def build_mm(dev, mesh=None):
    """The gated attn_both model, dropout off (the mixer's own attention dropout too), PAR_MM_GATE."""
    model = build(dev, mesh, attn_window=WINDOW, packed_stem=True, **PAR_MM, **PAR_NO_DROPOUT)
    model.cross_attn.dropout = 0.0
    with torch.no_grad():
        model.mix_gate.copy_(torch.tensor(PAR_MM_GATE))
    return model


def split_grads(model, step, batch, data_ranks: int, modality=None):
    """(loss, gradients) of one train step as data_ranks data ranks take it before their all-reduce, in this
    process: step (make_train_step's) on each of shard_batch's row blocks, its token NLL over the whole batch's
    token count (the global count a rank's step divides by), the blocks' losses and float32 gradients summed."""
    from omr_a2s_multimodal_transformer_tpu_torch.training import train_state as ts

    rows = batch["y_out"].shape[0] // data_ranks
    count = (batch["y_out"] != 0).sum().float()
    loss, grads = 0.0, {}
    hold = types.SimpleNamespace(model=model, apply_gradients=lambda: None)  # the gradients are read, not applied
    sums = ts.cross_entropy_sums
    with patched(ts, "cross_entropy_sums", lambda logits, y, pad: (sums(logits, y, pad)[0], count)):
        for i in range(data_ranks):
            block = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            _, part = step(hold, block, torch.Generator(device=count.device).manual_seed(3),
                           *(() if modality is None else (modality,)))
            loss += float(part)
            for n, p in model.named_parameters():
                g = torch.zeros_like(p) if p.grad is None else p.grad.detach()
                grads[n] = g.clone() if i == 0 else grads[n] + g
    return loss, grads


def parallel_reference(dev, multimodal: bool) -> dict:
    """The single-process steps the ranks are held to, dropout and teacher forcing off, bf16 and flash
    cross-attention (K1/K2) as the ranks run them, one Adam step clipped at PAR_CLIP: the paper model at full width
    (b8 361x4416) and, with multimodal, the gated attn_both model (build_mm, multimodal_batch, modality both). For
    each data-axis size d of rank_groups' meshes, the step in d row blocks (split_grads), its gradient the mean of
    PAR_REF_RUNS of them (their spread logged), then the clip and Adam's step on it; its loss, gradients after the
    clip and updated parameters go to PAR_WS/reference_{paper|multimodal}_d{d}.pt."""
    refs = {}
    splits = sorted({data for _, meshes in rank_groups(torch.cuda.device_count()) for _, data, _ in meshes})
    models = [("paper", lambda: build(dev, attn_window=WINDOW, packed_stem=True, **PAR_NO_DROPOUT),
               lambda: train_batch(dev, torch.Generator(device=dev).manual_seed(2)), None, splits)]
    if multimodal:  # on the 2 x 2 mesh
        models.append(("multimodal", lambda: build_mm(dev), lambda: multimodal_batch(dev), "both", [2]))
    for tag, make_model, make_batch, modality, datas in models:
        batch = make_batch()
        for d in datas:
            model = make_model()
            step = make_train_step(model, VOCAB, teacher_forcing_prob=0.0, bf16_compute=True,
                                   multimodal=modality is not None)
            runs = [split_grads(model, step, batch, d, modality) for _ in range(PAR_REF_RUNS)]
            spread = [_rel_l2(g, runs[0][1]) for _, g in runs[1:]]
            for n, p in model.named_parameters():
                p.grad = sum(g[n] for _, g in runs) / PAR_REF_RUNS
            state = TrainState.create(model, lr=PAR_LR, clip_norm=PAR_CLIP)
            state.apply_gradients()
            ref = dict(loss=sum(loss for loss, _ in runs) / PAR_REF_RUNS,
                       grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                       params={n: p.detach().cpu() for n, p in model.named_parameters()})
            norm = _global_norm(ref["grads"])
            torch.save(ref, PAR_WS / f"reference_{tag}_d{d}.pt")
            log(f"[parallel] single-process reference step, {tag}, {d} row block(s): loss {ref['loss']:.6f} (runs "
                f"{[loss for loss, _ in runs]}), its {PAR_REF_RUNS} runs' gradients {spread} from the first's "
                f"(relative L2; {top_leaves(runs[1][1], runs[0][1])}), clipped gradients' norm {norm:.6f}")
            if not abs(norm / PAR_CLIP - 1) <= PAR_CLIP_TOL:
                raise AssertionError(f"the {tag} reference step's clip ({PAR_CLIP}) left the gradients' norm at {norm}")
            refs[f"{tag} d{d}"] = dict(loss=ref["loss"], run_spread=spread)
            del model, step, state, ref, runs
            torch.cuda.empty_cache()
    return refs


def top_leaves(got: dict, want: dict, n: int = 3) -> str:
    """The n leaves with the largest shares of got's squared distance from want, and the encoder's share."""
    d2 = {k: float((got[k].double() - want[k].double()).square().sum()) for k in want}
    total = max(sum(d2.values()), 1e-300)
    top = sorted(d2, key=d2.get, reverse=True)[:n]
    enc = sum(v for k, v in d2.items() if "encoder" in k) / total
    return ", ".join(f"{k} {d2[k] / total:.2f}" for k in top) + f"; encoder leaves {enc:.2f} of the distance"


class RecomputeCheck:
    """While entered, every function that models/remat.py hands to the checkpoint keeps its outputs at the forward
    and holds them bit for bit to the backward's recompute of the same call (the checkpoint's early stop off, so
    that each recompute runs to its end). ``compared`` counts the recomputes held, ``differ`` the calls that
    disagreed, ``pending`` the forwards never recomputed."""

    def __init__(self):
        self.pending, self.compared, self.differ, self.calls = {}, 0, [], 0

    def checkpoint(self, run, *args, **kw):
        call, self.calls = self.calls, self.calls + 1

        def held(*flat):
            out = run(*flat)
            leaves = [t.detach() for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
            if call not in self.pending:
                self.pending[call] = [t.clone() for t in leaves]
            else:
                want = self.pending.pop(call)
                self.compared += 1
                if len(want) != len(leaves) or not all(torch.equal(w, g) for w, g in zip(want, leaves)):
                    self.differ.append(call)
            return out

        return self.real(held, *args, **kw)

    def __enter__(self):
        from torch.utils.checkpoint import set_checkpoint_early_stop

        from omr_a2s_multimodal_transformer_tpu_torch.models import remat as remat_lib

        self.real = remat_lib.checkpoint
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(patched(remat_lib, "checkpoint", self.checkpoint))
        self.stack.enter_context(set_checkpoint_early_stop(False))
        return self

    def __exit__(self, *exc):
        self.stack.close()
        return False


def remat_phase(dev) -> dict:
    """The paper and the multimodal (gated attn_both) models, b8 at full width, bf16, dropout on: the first train
    step of each with and without remat from the same seeded weights and generator state, and the first step
    without remat once more from its reset weights, all with the default backward (K2, cuDNN's algorithms). The
    remat step's recompute must give every remat'd block's output bit for bit as its forward did (RecomputeCheck),
    and its gradients must lie within REMAT_SPREAD times the no-remat step's own spread (its two runs' distance) of
    the first no-remat run; then a second step of each, timed, its peak memory logged."""
    mm_batch = multimodal_batch(dev)
    batch = {"x": mm_batch["xi"], "x_hw": mm_batch["xi_hw"], "y_in": mm_batch["y_in"], "y_out": mm_batch["y_out"]}
    out = {}
    for tag, hp, b, modality in (("paper", {}, batch, None), ("multimodal", PAR_MM, mm_batch, "both")):
        extra = () if modality is None else (modality,)
        runs = {}
        for remat in (False, True):
            model = build(dev, attn_window=WINDOW, packed_stem=True, remat=remat, **hp)
            step = make_train_step(model, VOCAB, teacher_forcing_prob=0.2, bf16_compute=True,
                                   multimodal=modality is not None)
            start = None if remat else {k: v.clone() for k, v in model.state_dict().items()}
            firsts = []
            for _ in range(1 if remat else 2):  # without remat the first step twice: its own spread
                if firsts:
                    model.load_state_dict(start)
                state = TrainState.create(model, lr=PAR_LR)
                with RecomputeCheck() if remat else contextlib.nullcontext() as held:
                    state, loss = step(state, b, torch.Generator(device=dev).manual_seed(7), *extra)
                    firsts.append((float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                                                 if p.grad is not None}))
                if remat:
                    recompute = dict(calls=held.calls, compared=held.compared, differ=held.differ,
                                     pending=sorted(held.pending))
                    log(f"[parallel remat {tag}] recompute: {held.compared} of {held.calls} remat'd calls held to "
                        f"their forward, {len(held.differ)} differ bit for bit, {len(held.pending)} never recomputed")
                    if not held.calls or held.compared != held.calls or held.differ or held.pending:
                        raise AssertionError(f"remat {tag}: the recompute is not the forward: {recompute}")
                    del held
            del start
            gen = torch.Generator(device=dev).manual_seed(8)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, loss = step(state, b, gen, *extra)
            float(loss)
            torch.cuda.synchronize()
            runs[remat] = dict(loss=firsts[0][0], grads=firsts[0][1], step_ms=(time.perf_counter() - t0) * 1e3,
                               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            if not remat:
                runs[remat]["spread"] = _rel_l2(firsts[1][1], firsts[0][1])
            if tag == "paper" and not remat:  # the single-process step's device time, beside the ranks'
                runs[remat]["rng"] = rng_device_ms(lambda: step(state, b, gen), PAR_WS / "rng_single.json")
            del model, step, state, firsts
            torch.cuda.empty_cache()
        rel, spread = _rel_l2(runs[True]["grads"], runs[False]["grads"]), runs[False]["spread"]
        row = {("remat" if k else "plain"): dict(loss=v["loss"], step_ms=v["step_ms"], peak_gib=v["peak_gib"],
                                                 **({"rng": v["rng"]} if "rng" in v else {}))
               for k, v in runs.items()}
        out[tag] = dict(row, grad_rel_l2=rel, grad_rel_l2_spread=spread, recompute=recompute)
        log(f"[parallel remat {tag}] loss {runs[False]['loss']:.5f} / {runs[True]['loss']:.5f}, gradients' relative "
            f"L2 distance {rel:.3e}, the no-remat step's own spread {spread:.3e} (the limit {REMAT_SPREAD:g} x "
            f"that); peak {row['plain']['peak_gib']:.2f} -> {row['remat']['peak_gib']:.2f} GiB, step "
            f"{row['plain']['step_ms']:.1f} -> {row['remat']['step_ms']:.1f} ms")
        if not rel <= REMAT_SPREAD * spread or runs[True]["grads"].keys() != runs[False]["grads"].keys():
            raise AssertionError(f"remat {tag}: gradients {rel:.3e} from the plain step's (its spread {spread:.3e})")
    return out


def keep_masks_equal(args) -> dict:
    """K4's export of the keep masks of a K1 call's (mixed) seed against the plain hash, bit for bit."""
    q, k, v, kv_len, kv_valid, seed, rate, heads, bq, bk = args
    b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
    got = fp.export_keep_masks(int(seed), b, heads, lq, lk, dropout_rate=rate, block_q=bq, block_k=bk, device=q.device)
    lq_p, lk_p = got.shape[2], got.shape[3]
    want = fp.keep_mask(int(seed), b, heads, lq_p, lk_p, rate, q.device, bq, bk)
    if not torch.equal(got, want):
        raise AssertionError("K4's keep masks of the mixed seed differ from the plain hash")
    return dict(seed=int(seed), shape=list(got.shape), kept=float(got.float().mean()))


def held_step(dev, mesh, who: str, model, batch, ref: dict, modality=None) -> dict:
    """One dropout-0 step of model (built on mesh) on this rank's rows of batch, bf16, counted from 0: K1 and K2 8
    launches, nothing else; the loss, the gathered gradients after the clip and the gathered updated parameters
    held to the single-process step ref taken in the mesh's row blocks (parallel_reference; PAR_TOL, with a
    'model' axis PAR_TP_GRAD_TOL for the gradients, PAR_CLIP_TOL, PAR_OTHERWISE_MAX); the gradients' distance and
    the elements updated otherwise also logged apart for the encoder's leaves and the rest."""
    from omr_a2s_multimodal_transformer_tpu_torch.parallel import tp
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import shard_batch

    local = shard_batch(batch, mesh)
    step = make_train_step(model, VOCAB, teacher_forcing_prob=0.0, bf16_compute=True,
                           multimodal=modality is not None)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(TrainState.create(model, lr=PAR_LR, clip_norm=PAR_CLIP), local, mesh.generator(dev, 3),
                       *(() if modality is None else (modality,)))
    loss = float(loss)
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    specs = model.tp_specs
    grads = {n: tp.gather_full(p.grad, specs[n], mesh).cpu() for n, p in model.named_parameters()}
    params = {k: v.cpu() for k, v in tp.full_state_dict(model, mesh).items() if k in ref["params"]}
    moved = max(float((params[k] - ref["params"][k]).abs().max()) for k in ref["params"])
    differ = {k: int(((params[k] - ref["params"][k]).abs() > 1e-3 * PAR_LR).sum()) for k in ref["params"]}
    rows = next(v for k, v in local.items() if k in ("x", "xi")).shape[0]
    enc = {k for k in ref["grads"] if "encoder" in k}
    parts = {"encoder": enc, "rest": set(ref["grads"]) - enc}

    def otherwise(keys):
        return sum(differ[k] for k in keys) / sum(ref["params"][k].numel() for k in keys)

    st = dict(loss=loss, loss_rel=abs(loss - ref["loss"]) / abs(ref["loss"]), grad_rel_l2=_rel_l2(grads, ref["grads"]),
              **{f"grad_rel_l2_{tag}": _rel_l2(grads, {k: ref["grads"][k] for k in keys}) for tag, keys in parts.items()},
              clipped_grad_norm=_global_norm(grads), param_max_abs_over_lr=moved / PAR_LR,
              params_updated_otherwise=otherwise(ref["params"]),
              **{f"params_updated_otherwise_{tag}": otherwise(keys) for tag, keys in parts.items()},
              local_rows=int(rows),
              local_heads=model.decoder.layers[0].self_attn.heads, launches=counts, first_step_ms=step_ms)
    log(f"[{who}] step at dropout 0: {st}; the gradients' distance by leaf: {top_leaves(grads, ref['grads'])}")
    want = {name: 8 if name in ("K1 flash fwd", "K2 flash bwd") else 0 for name in KERNELS}
    if counts != want:
        raise AssertionError(f"{who}: launched {counts}, expected {want}")
    grad_tol = PAR_TOL if mesh.model == 1 else PAR_TP_GRAD_TOL
    if not (st["loss_rel"] <= PAR_TOL and st["grad_rel_l2"] <= grad_tol and st["params_updated_otherwise"] <= PAR_OTHERWISE_MAX
            and abs(st["clipped_grad_norm"] / PAR_CLIP - 1) <= PAR_CLIP_TOL):
        raise AssertionError(f"{who}: the step differs from the single-process step: {st}")
    del step, state, grads, params
    return st


def flash_args_at(args: dict, rate: float) -> dict:
    """The arguments of the first K1 and K2 calls (FirstCalls) at dropout rate: K2's o and lse from K1 at that
    rate on K2's own q, k, v (its call is the last decoder layer's backward, K1's the first layer's forward)."""
    q, k, v, kv_len, kv_valid, seed, _, heads, bq, bk = args["K1 flash fwd"]
    q2, k2, v2, kv_len2, kv_valid2, seed2, _, _, do, _, heads2, bq2, bk2 = args["K2 flash bwd"]
    o, lse = fp.flash_fwd_cuda(q2, k2, v2, kv_len2, kv_valid2, seed2, rate, heads2, bq2, bk2)
    return {"K1 flash fwd": (q, k, v, kv_len, kv_valid, seed, rate, heads, bq, bk),
            "K2 flash bwd": (q2, k2, v2, kv_len2, kv_valid2, seed2, o, lse, do, rate, heads2, bq2, bk2)}


def parallel_rank_mesh(dev, mesh, tag: str, full: bool) -> dict:
    """One mesh of a rank: the paper model's dropout-0 step held to the reference (held_step). full: then the
    default dropouts (stem 0.5, decoder and positions 0.1, teacher forcing 0.2), two steps timed by the host
    clock and a third traced (its random-number and NCCL kernels), K1/K2 held to their plain version on their
    first call there (the shard's shape, the mixed seed; K4's masks of that seed equal to the plain hash), and
    under a 'model' axis memory_partition; else K1/K2 held to their plain version on the inputs of their first
    call in the dropout-0 step at dropout 0.1 (flash_args_at: the shard's shape, the mixed seed) and K4's masks
    of that seed. On a 2 x 2 mesh whose ranks each have a card, then the multimodal model's dropout-0 step held
    to its reference."""
    who = f"parallel {tag} rank {mesh.rank}"
    out = {}
    batch = train_batch(dev, torch.Generator(device=dev).manual_seed(2))
    ref = torch.load(PAR_WS / f"reference_paper_d{mesh.data}.pt", weights_only=True)
    with contextlib.nullcontext() if full else FirstCalls() as first:
        out["step"] = held_step(dev, mesh, who, build(dev, mesh, attn_window=WINDOW, packed_stem=True,
                                                      **PAR_NO_DROPOUT), batch, ref)
    del ref
    torch.cuda.empty_cache()
    if not full:
        args = flash_args_at(first.args, 0.1)
        errs = check_cli_flash(args, who)
        masks = keep_masks_equal(args["K1 flash fwd"])
        out["dropout_0.1_check"] = dict(max_abs_err=errs, keep_masks=masks, kernel_rows=int(args["K1 flash fwd"][0].shape[0]),
                                        kernel_heads=int(args["K1 flash fwd"][7]))
        log(f"[{who}] K1/K2 at {out['dropout_0.1_check']['kernel_rows']} rows x "
            f"{out['dropout_0.1_check']['kernel_heads']} heads, dropout 0.1, seed {masks['seed']} (mixed): within the "
            f"gate; K4's masks equal the plain hash")
        return out

    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import shard_batch

    local = shard_batch(batch, mesh)
    model = build(dev, mesh, attn_window=WINDOW, packed_stem=True)
    step = make_train_step(model, VOCAB, teacher_forcing_prob=0.2, bf16_compute=True)
    state, gen = TrainState.create(model, lr=PAR_LR), mesh.generator(dev, 3)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    with FirstCalls() as first:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, local, gen)
            losses.append(float(loss))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {name: 16 if name in ("K1 flash fwd", "K2 flash bwd") else 0 for name in KERNELS}
    if counts != want or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{who}: dropout steps launched {counts}, losses {losses}")
    # a third step, traced: its random-number and NCCL kernels, on this rank alone
    rng = rng_device_ms(lambda: step(state, local, gen), PAR_WS / f"rng_{tag}_{mesh.rank}.json")
    # the rank's own trace of one step (the launch counts above are the gate; a trace that recorded no kernel at
    # all, the profiler's known fault, is logged and not held)
    if rng["all_ms"] > 0 and rng["flash_kernels"] != {"K1": 8, "K2": 8}:
        raise AssertionError(f"{who}: a traced step ran {rng['flash_kernels']} flash kernels")
    del model, step, state
    torch.cuda.empty_cache()
    errs = check_cli_flash(first.args, who)  # K1/K2 against the plain version at the shard's shape, mixed seed
    masks = keep_masks_equal(first.args["K1 flash fwd"])
    k1 = first.args["K1 flash fwd"]
    out["dropout"] = dict(losses=losses, step_ms=times, peak_gib=peak, launches=counts, max_abs_err=errs, rng=rng,
                          keep_masks=masks, kernel_rows=int(k1[0].shape[0]), kernel_heads=int(k1[7]),
                          mixed_seed_part=fp.shard_seed(mesh.data_index, mesh.model_index,
                                                        fp.shard_heads(HEADS, 64, mesh.model)))
    log(f"[{who}] dropout steps: losses {losses}, host {times[-1]:.1f} ms, peak {peak:.2f} GiB; K1/K2 at "
        f"{out['dropout']['kernel_rows']} rows x {out['dropout']['kernel_heads']} heads; K4 masks of seed "
        f"{masks['seed']} equal the plain hash; a traced step: {rng['all_ms']:.1f} ms device time, random-number "
        f"kernels {rng['rng_ms']:.3f} ms, NCCL {rng['nccl_ms']:.3f} ms in {rng['nccl_kernels']} kernels (longest "
        f"{rng['nccl_longest_ms']:.3f} ms)")
    del first
    if mesh.model > 1:  # memory_partition: the memory held split over S across the model ranks
        out["memory_partition"] = partition_check(dev, mesh, local)
    if (mesh.data, mesh.model) == (2, 2):  # a full 2 x 2 mesh: four ranks, a card each
        ref = torch.load(PAR_WS / f"reference_multimodal_d{mesh.data}.pt", weights_only=True)
        out["multimodal"] = held_step(dev, mesh, who + " multimodal", build_mm(dev, mesh), multimodal_batch(dev),
                                      ref, modality="both")
        del ref
        torch.cuda.empty_cache()
    return out


def dist_backend() -> str:
    import torch.distributed as dist

    return dist.get_backend()


def partition_check(dev, mesh, local) -> dict:
    from torch.func import functional_call

    from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_sums

    res = {}
    for tag, part in (("plain", None), ("partitioned", ("data", "model", None))):
        model = build(dev, mesh, attn_window=WINDOW, packed_stem=True, memory_partition=part, **PAR_NO_DROPOUT)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        logits = functional_call(model, params, (local["x"].to(torch.bfloat16), local["x_hw"], local["y_in"]))
        nll, count = cross_entropy_sums(logits, local["y_out"])
        loss = nll / count
        loss.backward()
        torch.cuda.synchronize()
        res[tag] = dict(loss=float(loss.detach()), peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, params, logits, loss
        torch.cuda.empty_cache()
    rel = abs(res["partitioned"]["loss"] - res["plain"]["loss"]) / abs(res["plain"]["loss"])
    log(f"[parallel memory_partition rank {mesh.rank}] {res}, relative difference {rel:.2e}")
    if rel > PARTITION_TOL:
        raise AssertionError(f"memory_partition changed the loss: {res}")
    return dict(res, rel=rel)


def bus_id(index: int) -> str:
    """Card index's PCI address, domain:bus:device.function."""
    p = torch.cuda.get_device_properties(index)
    return f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"


def parallel_rank(rank: int, port: int, world: int, meshes) -> None:
    """One rank of the parallel path (a process of its own), started by the port's multihost.initialize: a card
    of its own under NCCL when the cards allow, else the current card under gloo; each of meshes in turn (full
    procedure where the rank has a card of its own, or on a mesh of two ranks); its result to
    PAR_WS/rank{rank}_{world}.json."""
    from omr_a2s_multimodal_transformer_tpu_torch.parallel import multihost
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    global OUT_DIR
    OUT_DIR = PAR_WS
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cuda")
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        ident = dict(backend=dist_backend(), current_device=torch.cuda.current_device(), bus_id=bus_id(dev.index))
        log(f"[parallel rank {rank} of {world}] backend {ident['backend']}, current device "
            f"{ident['current_device']}, bus id {ident['bus_id']}")
        out = dict(ident=ident)
        for tag, data, model in meshes:
            mesh = make_mesh(data, model)
            out[tag] = parallel_rank_mesh(dev, mesh, tag, full=ident["backend"] == "nccl" or world == 2)
        (PAR_WS / f"rank{rank}_{world}.json").write_text(json.dumps(out))
    finally:
        multihost.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, meshes) -> list:
    """parallel_rank in ``world`` spawned processes; every one joined or killed. Under NCCL the ranks must sit
    on distinct cards."""
    import torch.multiprocessing as mp

    ctx, port = mp.get_context("spawn"), _free_port()
    procs = [ctx.Process(target=parallel_rank, args=(r, port, world, meshes)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + PAR_RANK_TIMEOUT_S
    try:
        for p in procs:
            p.join(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"parallel ranks exited with {codes}")
    ranks = [json.loads((PAR_WS / f"rank{r}_{world}.json").read_text()) for r in range(world)]
    idents = [r["ident"] for r in ranks]
    if idents[0]["backend"] == "nccl" and len({i["bus_id"] for i in idents}) != world:
        raise AssertionError(f"NCCL ranks share a card: {idents}")
    return ranks


def shard_kernels(dev) -> dict:
    """K1 and K2 at the full cross shape and at the shard shapes of the meshes the ranks run (rank_groups: the
    cross shape's rows and heads of one rank, one card dp 2 x 1 4 rows x 4 heads, tp 1 x 2 8 x 2, 2 x 2 4 x 2;
    four cards dp 4 x 1 2 x 4, 2 x 2, and tp 1 x 4's 8 x 1, the heads a rank holds: its dispatch gathers them to
    8 x 4 before the kernel, JAX's 128-lane rule), dropout 0.1 and 0, against the plain version, device-timed on
    the card alone; the key splits of K1 (fwd_splits) and K3a (dq_splits) as their launches' grids give them."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    meshes = [m for _, group in rank_groups(torch.cuda.device_count()) for m in group]
    for tag, data, model in [("full", 1, 1), *meshes]:
        b, heads = B // data, HEADS // model
        g = torch.Generator(device=dev).manual_seed(0)
        kv_valid = memory_valid_from_hw(ragged_hw(B, dev), GRID_H, GRID_W)[:b].contiguous()
        kv_len = torch.full((b,), LK, dtype=torch.int32, device=dev)
        seed = torch.tensor([20240611 ^ fp.shard_seed(1, 1, True)], dtype=torch.int32, device=dev)
        bq, bk = fp.mask_geometry(LQ, LK)
        q, k, v, do = (torch.randn((b, n, heads * 64), generator=g, device=dev).to(torch.bfloat16)
                       for n in (LQ, LK, LK, LQ))
        n_valid = int(kv_valid.sum())
        pairs = heads * LQ * n_valid
        qb, kv_bytes, stats = q.numel() * 2, n_valid * heads * 64 * 2, b * heads * LQ * 4
        bound1 = max(4 * 64 * pairs / PEAK_BF16_FLOPS, (2 * qb + 2 * kv_bytes + stats) / PEAK_BYTES) * 1e3
        bound2 = max(10 * 64 * pairs / PEAK_BF16_FLOPS,
                     (3 * qb + 2 * stats + 2 * kv_bytes + 2 * k.numel() * 2) / PEAK_BYTES) * 1e3
        row = dict(rows=b, heads=heads, bound_ms={"K1": bound1, "K2": bound2},
                   splits=dict(fwd_splits=fp.fwd_splits(b, heads, LQ, LK, n_sm), dq_splits=fp.dq_splits(b, heads, LQ, LK, n_sm)))
        for rate in (0.1, 0.0):
            o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, heads, bq, bk)
            grads = fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do, rate, heads, bq, bk)
            qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
            o_p, _ = fp.flash_attention_plain(qr, kr, vr, kv_len, kv_valid, seed, rate, heads, False, -1, bq, bk)
            grads_p = torch.autograd.grad(o_p, (qr, kr, vr), do)
            err1 = check_vs(f"K1 o ({tag}, dropout {rate})", o, o_p)
            err2 = max(check_vs(f"K2 {n} ({tag}, dropout {rate})", a, p)
                       for n, a, p in zip(("dq", "dk", "dv"), grads, grads_p))
            ms1, _ = kernel_times("K1 flash fwd", lambda: fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate,
                                                                             heads, bq, bk), record=False)
            ms2, _ = kernel_times("K2 flash bwd", lambda: fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse,
                                                                             do, rate, heads, bq, bk), record=False)
            row[f"dropout {rate}"] = dict(K1_ms=ms1, K2_ms=ms2, K1_err=err1, K2_err=err2)
            del o_p, grads_p, qr, kr, vr
        delta = fp.attention_delta(do, o, heads)
        for name, fn, symbol in (("K1", lambda: fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, 0.1, heads, bq, bk),
                                  "flash_fwd_tma"),
                                 ("K3a", lambda: fp.flash_dq_cuda(q, k, v, kv_len, kv_valid, seed, do, lse, delta, 0.1,
                                                                  heads, bq, bk), "flash_dq_")):
            row["splits"][f"{name} launch grid"] = launch_grid(name, fn, symbol)
        out[tag] = row
        log(f"[parallel kernels {tag}] B {b} H {heads}: {row}")
        del q, k, v, do, o, lse, grads
        torch.cuda.empty_cache()
    return out


def launch_grid(name: str, fn, symbol: str) -> list:
    """The grid of the chunk kernel (named ``symbol``, not its merge) that fn launches, from a profiler trace of
    10 calls (the tracer may miss the first kernels of a trace; one that holds none is taken again, up to
    TRACE_TRIES times, and then the smoke fails)."""
    for _ in range(TRACE_TRIES):
        events = [e for e in traced_kernels(fn, 10, PAR_WS / "split_trace.json")
                  if symbol in e["name"] and "merge" not in e["name"]]
        if events:
            return events[-1]["args"]["grid"]
        TRACES["retaken"] += 1
        time.sleep(2.0)
    raise AssertionError(f"{name}: no kernel named {symbol} in {TRACE_TRIES} traces of 10 calls")


def cross_card_check() -> dict:
    """K1, K2 and K4 of the cross shape on cuda:1 tensors, called while cuda:0 is the runtime's current device (the
    launchers opted their kernels in to their shared memory on cuda:0 before): K1 at dropout 0 and K4 (dropout 0.1)
    equal to the same calls on cuda:0 bit for bit, K2 (dropout 0.1) within KERNEL_TOL of its plain version on
    cuda:1."""
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    torch.cuda.set_device(d0)
    g = torch.Generator(device=d0).manual_seed(0)
    kv_valid = memory_valid_from_hw(ragged_hw(B, d0), GRID_H, GRID_W).contiguous()
    kv_len = torch.full((B,), LK, dtype=torch.int32, device=d0)
    seed = torch.tensor([20240611], dtype=torch.int32, device=d0)
    bq, bk = fp.mask_geometry(LQ, LK)
    q, k, v, do = (torch.randn((B, n, HEADS * 64), generator=g, device=d0).to(torch.bfloat16) for n in (LQ, LK, LK, LQ))
    on0 = (q, k, v, kv_len, kv_valid, seed)
    on1 = tuple(t.to(d1) for t in on0)
    outs = {}
    for d, ins in ((d0, on0), (d1, on1)):
        o, lse = fp.flash_fwd_cuda(*ins, 0.0, HEADS, bq, bk)
        mask = fp.keep_mask_cuda(ins[5], B, HEADS, -(-LQ // bq) * bq, -(-LK // bk) * bk, 0.1, bq, bk)
        outs[d.index] = (o.cpu(), lse.cpu(), mask.cpu())
    torch.cuda.synchronize(d1)
    o1, lse1 = fp.flash_fwd_cuda(*on1, 0.1, HEADS, bq, bk)
    do1 = do.to(d1)
    grads = fp.flash_bwd_cuda(*on1, o1, lse1, do1, 0.1, HEADS, bq, bk)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in on1[:3])
    o_p, _ = fp.flash_attention_plain(qr, kr, vr, *on1[3:], 0.1, HEADS, False, -1, bq, bk)
    grads_p = torch.autograd.grad(o_p, (qr, kr, vr), do1)
    err2 = max(check_vs(f"K2 {n} on cuda:1", a, p) for n, a, p in zip(("dq", "dk", "dv"), grads, grads_p))
    current = torch.cuda.current_device()
    equal = dict(K1=all(torch.equal(a, b) for a, b in zip(outs[0][:2], outs[1][:2])),
                 K4=torch.equal(outs[0][2], outs[1][2]))
    res = dict(current_device=current, bit_equal=equal, K2_max_abs_err=err2, devices=[str(t.device) for t in grads])
    log(f"[parallel cross-card] K1/K2/K4 on cuda:1 tensors with cuda:{current} current: {res}")
    if current != 0 or not all(equal.values()) or res["devices"] != ["cuda:1"] * 3:
        raise AssertionError(f"a kernel launched off its tensors' card: {res}")
    del on1, o1, lse1, do1, grads, grads_p, o_p, qr, kr, vr
    torch.cuda.empty_cache()
    return res


def torchrun(module: str, args: list, tag: str, nproc: int, timeout: float = 900) -> dict:
    """``python -m torch.distributed.run --nproc_per_node nproc -m module args`` from the checkout's root; its
    output to PAR_WS/<tag>.log; returns its wall seconds and the process-group line each rank printed
    (cli/common.py init_cli). Under NCCL the ranks must sit on distinct cards."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc), "--master_addr",
           "127.0.0.1", "--master_port", str(_free_port()), "-m", module, *args]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    (PAR_WS / f"{tag}.log").write_text(run.stdout + "\n--- stderr ---\n" + run.stderr)
    if run.returncode != 0:
        raise AssertionError(f"torchrun {tag} exited with {run.returncode}:\n{run.stderr[-3000:]}")
    found = set(re.findall(r"process group: rank (\d+) of (\d+), backend (\w+), device (cuda:\d+)", run.stdout))
    groups = [f"rank {r} of {w}, backend {b}, device {d}" for r, w, b, d in sorted(found)]
    backends, devices = {b for _, _, b, _ in found}, {d for *_, d in found}
    if len(found) != nproc or (backends == {"nccl"} and len(devices) != nproc):
        raise AssertionError(f"torchrun {tag}: the ranks' process-group lines {groups}")
    log(f"[parallel cli] {tag}: {wall:.1f} s; {groups}")
    return dict(wall_s=wall, ranks=groups)


def parallel_cli(n_cards: int) -> dict:
    """cli.train and cli.test under ``torch.distributed.run`` on PAR_CORPUS (the paper model, b8 global, bf16, flash
    cross-attention): two ranks (gloo on one card, else NCCL), or four under NCCL with four or more cards. Data
    parallel for one epoch; then --mesh_model 2 (tp 1 x 2, or 2 x 2 on four ranks) resumes it for a second epoch
    (the checkpoint resharded onto the other mesh), validating once; then cli.test of the run's best/ on the same
    ranks (dp) and in this process, each with the checkpoint's decode cache, held to each other as PAR_TEST_*
    says. Each cli.train validates and tests by greedy decode; under tp on the one card every decode step's
    collectives go through gloo."""
    from omr_a2s_multimodal_transformer_tpu_torch.cli import test as test_cli
    from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib

    nproc = 4 if n_cards >= 4 else 2
    train, test = ("omr_a2s_multimodal_transformer_tpu_torch.cli." + m for m in ("train", "test"))
    data = cli_data("image", PAR_CORPUS, PAR_WS / "cache")
    out = dict(nproc=nproc)

    def train_args(epochs, *extra):
        return data + ["--attn_window", str(WINDOW), "--use_flash_cross", "--epochs", str(epochs),
                       "--check_val_every_n_epoch", "1", "--weights_dir", str(PAR_WS / "weights"),
                       "--run_dir", str(PAR_WS / "run"), *extra]

    resumed = "tp resumed" if nproc == 2 else "2x2 resumed"
    for tag, args in (("dp", train_args(1)), (resumed, train_args(2, "--mesh_model", "2"))):
        run = torchrun(train, args, tag.replace(" ", "_"), nproc)
        recs = cli_records(PAR_WS / "run")
        epochs = [r for r in recs if "train_loss" in r]
        last = epochs[-1]
        if not all(math.isfinite(r["train_loss"]) for r in epochs):
            raise AssertionError(f"parallel cli {tag}: losses {[r['train_loss'] for r in epochs]}")
        steps = PAR_CORPUS["n"] // 8  # one process ran this epoch alone: its StepTimer totals are its own
        decodes = {k: r[k] for r in recs for k in ("val_decode_s", "test_decode_s", "val_decode_steps",
                                                    "test_decode_steps") if k in r}
        out[tag] = dict(run, epochs=[r["epoch"] for r in epochs], train_loss=last["train_loss"],
                        samples_per_sec=last["samples_per_sec"], data_ms_mean=last["time_data_total_s"] * 1e3 / (steps + 1),
                        step_ms_mean=last["time_step_total_s"] * 1e3 / steps, last_decodes=decodes)
        log(f"[parallel cli] {tag}: {out[tag]}")
    if out[resumed]["epochs"] != [1, 2] or not any("resumed_from" in r for r in cli_records(PAR_WS / "run")):
        raise AssertionError(f"parallel cli epochs: {out}")
    last_ckpt = str(PAR_WS / "weights" / "last")
    single_model, _ = build_model(ckpt_lib.load_hparams(last_ckpt), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in ckpt_lib.restore_checkpoint(last_ckpt)["params"].items()}
    if shapes != {k: tuple(v.shape) for k, v in single_model.state_dict().items()}:
        raise AssertionError(f"the {resumed} run's checkpoint does not hold a single-process model's full tensors")
    base = data + ["--checkpoint_path", str(PAR_WS / "weights" / "best")]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    single = test_cli.main(base + ["--run_dir", str(PAR_WS / "test_single"), "--save_preds",
                                   str(PAR_WS / "preds_single.jsonl")])
    t_single = time.perf_counter() - t0
    torch.cuda.empty_cache()
    run = torchrun(test, base + ["--run_dir", str(PAR_WS / "test_ranks"), "--save_preds",
                                 str(PAR_WS / "preds_ranks.jsonl")], "test_ranks", nproc)
    ranks = {k: v for k, v in [r for r in cli_records(PAR_WS / "test_ranks") if "test_sym-er" in r][-1].items()
             if k in single}
    rows = [[json.loads(line)["y_pred"] for line in (PAR_WS / f"preds_{who}.jsonl").read_text().splitlines()]
            for who in ("single", "ranks")]
    # each row's first differing token, None where the rows agree as far as the shorter goes (lengths held below)
    first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None) for a, b in zip(*rows)]
    flipped = sum(f is not None for f in first)
    gap = abs(ranks["test_sym-er"] - single["test_sym-er"])
    out["test"] = dict(single=single, ranks=ranks, preds_rows_differing=flipped, preds_rows=len(rows[0]),
                       first_differing_token=first, ser_gap=gap, single_s=t_single, ranks_s=run["wall_s"],
                       ranks_groups=run["ranks"])
    log(f"[parallel cli] cli.test single process {single}, {nproc} ranks {ranks}; prediction rows that differ: "
        f"{flipped} of {len(rows[0])} (first differing token of each row {first}), SER gap {gap:.4f}")
    if len(rows[0]) != PAR_CORPUS["n_test"] or len(rows[1]) != len(rows[0]) \
            or [len(r) for r in rows[0]] != [len(r) for r in rows[1]] \
            or ranks["test_seq-er"] != single["test_seq-er"] or flipped > PAR_TEST_ROWS_MAX or gap > PAR_TEST_SER_MAX:
        raise AssertionError(f"cli.test on {nproc} ranks against the single-process cli.test: {out['test']}")
    return out


def parallel_phase(dev) -> dict:
    """The single-process half of the parallel path, run before the cli path (a profiler trace the smoke takes
    after the cli and serve paths, or after other processes have used the card, held no kernel on the H100 in 5
    takes): the reference steps the ranks are held to, remat against no remat, K1/K2 at the shard shapes, and with
    two or more cards the cross-card check."""
    import shutil

    shutil.rmtree(PAR_WS, ignore_errors=True)
    PAR_WS.mkdir(parents=True)
    t0 = time.perf_counter()
    # the multimodal step runs on the 2 x 2 mesh where its ranks each have a card (four or more cards)
    out = dict(reference=parallel_reference(dev, multimodal=torch.cuda.device_count() >= 4),
               remat=remat_phase(dev), shard_kernels=shard_kernels(dev))
    if torch.cuda.device_count() >= 2:
        out["cross_card"] = cross_card_check()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    log(f"[parallel phase] wall {out['phase_s']:.1f} s")
    return out


def run_group(world: int, meshes) -> dict:
    t0 = time.perf_counter()
    out = dict(ranks=run_ranks(world, meshes), wall_s=time.perf_counter() - t0)
    log(f"[parallel path] {world} ranks ({out['ranks'][0]['ident']['backend']}, meshes "
        f"{[tag for tag, *_ in meshes]}): {out['wall_s']:.1f} s")
    return out


def parallel_path(dev, out_dir: Path, phase: dict) -> dict:
    """The parallel path (parallel/, ops/flash_packed.py's sharded dispatch, remat, memory_partition, the CLIs under
    torchrun), after parallel_phase: each group of rank_groups in turn (parallel_rank_mesh on each of its meshes),
    then the CLIs under torchrun (parallel_cli). The CLIs' logs and metrics go to out_dir/parallel_path/."""
    import shutil

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    groups = {world: run_group(world, meshes) for world, meshes in rank_groups(n_cards)}
    t_ranks = time.perf_counter() - t0
    cli = parallel_cli(n_cards)
    wall = time.perf_counter() - t0
    (out_dir / "parallel_path").mkdir(parents=True, exist_ok=True)
    for path in [*PAR_WS.glob("*.log"), *PAR_WS.glob("*.jsonl"), *PAR_WS.glob("*/metrics.jsonl")]:
        shutil.copyfile(path, out_dir / "parallel_path" / str(path.relative_to(PAR_WS)).replace("/", "_"))
    log(f"[parallel path] wall {wall:.1f} s on {n_cards} card(s) (ranks {t_ranks:.1f} s; the phase before the cli "
        f"path {phase['phase_s']:.1f} s)")
    return dict(phase, cards=n_cards, groups=groups, cli=cli, wall_s=wall, ranks_s=t_ranks)


def parallel_kernel_rows(kernels: list, parallel: dict) -> None:
    """K1's and K2's rows of the kernels line gain each rank's launches a step on the parallel path and the shard
    readings (shard_kernels)."""
    for k in kernels:
        if k["name"] not in ("K1 flash fwd", "K2 flash bwd"):
            continue
        key = k["name"][:2]
        k["launches_parallel_path"] = {f"{tag} rank {r}": rank[tag]["step"]["launches"][k["name"]]
                                       for group in parallel["groups"].values()
                                       for r, rank in enumerate(group["ranks"]) for tag in rank if tag != "ident"}
        k["shard_readings"] = {tag: dict(rows=row["rows"], heads=row["heads"], bound_ms=row["bound_ms"][key],
                                         ms={rate: row[rate][f"{key}_ms"] for rate in ("dropout 0.1", "dropout 0.0")},
                                         max_abs_err=max(row[rate][f"{key}_err"] for rate in ("dropout 0.1", "dropout 0.0")))
                               for tag, row in parallel["shard_kernels"].items()}


def start(out_dir: Path):
    """What a run does first (main, probe_parallel.py): the card's line logged, every kernel built, the results
    to out_dir, and this run's frontend disk cache empty (every process it starts inherits it). Returns the
    device, the card's line and the clock at the start."""
    global OUT_DIR
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}; {torch.cuda.device_count()} card(s) visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    log(f"[build] {sorted(p.name for p in paths.values())} in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] {name}: {line.strip()}")
    out_dir.mkdir(parents=True, exist_ok=True)
    OUT_DIR = out_dir
    os.environ[frontends.CACHE_ENV] = str(FRONTEND_CACHE)
    shutil.rmtree(FRONTEND_CACHE, ignore_errors=True)
    return dev, card, t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="trace one train step of each model")
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="where the result file and the traces go")
    ap.add_argument("--min-cards", type=int, default=1,
                    help="fail (no result) unless at least this many cards are visible")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.min_cards:
        print(f"chip_smoke: {torch.cuda.device_count()} card(s) visible, --min-cards {args.min_cards}",
              file=sys.stderr)
        return 1
    dev, card, t0 = start(args.out_dir)
    walls, mark = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        walls[name], mark[0] = now - mark[0], now

    lap("build")
    cross = phase_cross(dev)
    self_rows = phase_self(dev)
    stem = phase_stem(dev)
    stem_launches, stem_errs = stem_path(dev)
    stem_k = stem_rows(stem, stem_launches, stem_errs)
    legacy_k = phase_legacy(dev, cross) | phase_legacy_any(dev)
    lap("kernel checks")
    kernels = [cross["K1 flash fwd"], cross["K2 flash bwd"], self_rows["K1c flash fwd causal"],
               self_rows["K3a flash dq"] | cross["cross3a"], self_rows["K3b flash dk/dv"] | cross["cross3b"],
               cross["K4 keep mask"]]

    flagship = model_path(dev, "flagship", args.out_dir, args.profile)
    paper = model_path(dev, "paper", args.out_dir, args.profile, serve=False, attn_window=WINDOW, packed_stem=True)
    log("[paper path] K1c, K3a, K3b and K4 launched 0 times: the windowed self-attention is plain PyTorch "
        "(dense mask up to 256 positions, banded above), as in the JAX model")
    quant = quant_path(dev)
    paper["serve"] = dict(quant["dtypes"]["bfloat16"], cache_len=quant["cache_len"], batch=4)
    if paper["serve"]["cache_len"] != WINDOW + 1:
        raise AssertionError(f"the paper model's ring cache has {paper['serve']['cache_len']} slots")
    ops = op_path(dev)
    for k in kernels:  # K1/K2 from the paper model's path, the rest from the op path
        k["launches"] = paper["launches"][k["name"]] if k["name"] in ("K1 flash fwd", "K2 flash bwd") else ops[k["name"]]
    kernels += [stem_k["K5a fused stem k1"], stem_k["K5b fused stem k2"]]  # launches from the stem path
    legacy = legacy_path(dev)
    for name, row in legacy_k.items():
        kernels.append(row | dict(launches=legacy["launches"][name]))
    lap("model, quant, op and legacy paths")
    par_phase = parallel_phase(dev)
    lap("parallel phase")
    cli = cli_path(dev, args.out_dir)
    cli["loader_runs"] = {tag: loader_run(dev, tag, extra, cli["runs"]["image"]["epochs"][-1])
                          for tag, extra in LOADER_RUNS.items()}
    lap("cli path and loader runs")
    serve = serve_path(dev, args.out_dir, cli.pop("vocab"))
    lap("serve path")
    tools = tools_path(dev, args.out_dir)
    lap("tools path")
    bench = bench_path(dev, args.out_dir)
    bench["tools"] = bench_tools(dev, args.out_dir, bench["ingest"])
    lap("bench path")
    parallel = parallel_path(dev, args.out_dir, par_phase)
    lap("parallel path after the bench path")
    log("[smoke] walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    for k in kernels:  # K1/K2 held to their plain version at the cross shape and at each cli run's first call
        if k["name"] in cli["max_abs_err"]:
            k["max_abs_err_cli_path"] = cli["max_abs_err"][k["name"]]  # the largest of the three runs
            k["max_abs_err_cli_runs"] = {tag: dict(err=r["max_abs_err"][k["name"]],
                                                   rel=r["max_abs_err"]["rel"][k["name"]], lk=r["max_abs_err"]["lk"],
                                                   **({"vs_f64": r["max_abs_err"]["f64"]}
                                                      if k["name"] == "K2 flash bwd" else {}))
                                         for tag, r in cli["runs"].items()}
            k["max_abs_err"] = max(k["max_abs_err"], k["max_abs_err_cli_path"])
            # and on the tools path: at its first call in the grid, and the launches of each cli.train it ran
            k["max_abs_err_tools_path"] = dict(err=tools["max_abs_err"][k["name"]], rel=tools["max_abs_err"]["rel"][
                k["name"]], lk=tools["max_abs_err"]["lk"], lq=tools["max_abs_err"]["lq"])
            k["max_abs_err"] = max(k["max_abs_err"], tools["max_abs_err"][k["name"]])
            k["launches_tools_path"] = {c["run"]: dict(launches=c["launches"][k["name"]], steps=c["steps"])
                                        for c in tools["trains"]}
            # and on the bench path: at bench_train_max's first flash call, and its launches
            k["max_abs_err_bench_path"] = dict(err=bench["max_abs_err"][k["name"]], rel=bench["max_abs_err"]["rel"][
                k["name"]], lk=bench["max_abs_err"]["lk"], lq=bench["max_abs_err"]["lq"])
            k["max_abs_err"] = max(k["max_abs_err"], bench["max_abs_err"][k["name"]])
            k["launches_bench_path"] = dict(launches=bench["launches"][k["name"]], steps=bench["steps"])
        k.update(KERNEL_INFO.get(k["name"], {}))
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")

    parallel_kernel_rows(kernels, parallel)
    result = dict(card=card, kernels=kernels, flagship=flagship, paper=paper, quant_path=quant, op_path=ops,
                  stem_path=dict(launches=stem_launches, max_abs_err=stem_errs), legacy_path=legacy,
                  cli_path=cli, serve_path=serve, tools_path=tools, bench_path=bench, parallel_path=parallel,
                  traces=dict(TRACES), walls_s=walls,
                  wall_s=time.perf_counter() - t0)
    return finish(card, result, args.out_dir, kernels)


def finish(card: str, result: dict, out_dir: Path, kernels) -> int:
    """The result file, then the card line, the kernels line and the contract line."""
    log(f"[trace] {TRACES['taken']} profiler traces, {TRACES['retaken']} taken again "
        f"(TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')})")
    (out_dir / "chip_smoke_result.json").write_text(json.dumps(result, indent=1))
    log(f"[smoke] wall {result['wall_s']:.1f} s, the build included")
    log(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(json.dumps({"kernels": [{**{k: kern[k] for k in keys}, **kern} for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
