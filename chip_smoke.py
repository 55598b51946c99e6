#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also trace one train step of each model
    python3 chip_smoke.py --out-dir D  # write the result and traces to D (default build/chip_smoke/)

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
       each split of its key tiles into 1-8 chunks, and the pair against
       SDPA's backward at the same rate; K4, the keep-mask probe at the
       decoder's 128/2048 blocks, bit for bit;
     - at the paper's self-attention shape (B 8, L 1268, 4 x 64 heads,
       window 100, ragged target lengths, 128/512 blocks), dropout 0 and
       0.1: K1c, K3a and K3b, with the banded attention of the windowed
       decoder as a second witness at dropout 0; full causal once;
     - at the three packed stem block shapes (tools/bench_fused_block.py:
       b8, bf16; blocks 0-2 on 361x4416 images), dropout 0.5 and none: K5a
       (y2, statistics) and K5b (out) against plain_k1/plain_k2 and the
       whole block against reference_block; the plain block's forward, the
       cuDNN convolutions of the block alone (convs_ms), and forward +
       backward of fused_packed_block against plain autograd;
     - the per-head legacy flash family of tools/legacy_flash ([B, H, L, 64]
       bf16) at the cross shape (L2: the images' kv_valid; L1: kv_len of
       the same counts) and at the paper's self-attention shape (causal,
       window 100, the targets as kv_len for L1 and kv_valid for L2, so pad
       rows see no key and must give o = 0, lse = 0): L1, L2a, L2b, L2c
       against the plain version, with plain and SDPA times, beside the
       head-packed K1, K3a, K3b and K2 at dropout 0;
     - the any-dtype legacy kernels (LA: float16, float32, heads over 128)
       at B 2, H 4, 256 x 1,024: float32 D 64 and 192 to 1e-4 x max |plain|,
       float16 D 64 and bf16 D 192 to 2e-2 (lse 1e-4), with times of the
       float32 call; then LA fwd (L1's o, L2a's o and lse), LA dq and LA
       dk/dv at the legacy cross shape in float32 D 64, float16 D 64 and
       bf16 D 192, each against the plain version, with its bound, plain
       time and SDPA's forward or backward (event and device time);
  3. five paths, each with every kernel's launch count set to 0 just
     before it and read just after:
     - stem path: fused_packed_block forward and backward at the three
       stem block shapes (dropout 0.5); K5a and K5b once per block, no
       other kernel, gradients within tolerance of plain autograd;
     - flagship model (attn_window -1): 3 full-width train steps (vocab
       6,997, max_seq_len 1268, bf16 compute, flash cross-attention) on 8
       random 361x4416 images, then greedy decode of 4 raw u8 images with a
       bf16 cache; K1 and K2 must launch 8 times per train step;
     - paper model (attn_window 100, packed_stem, flash cross-attention):
       the same train and decode, with a 101-slot ring self-cache; K1 and K2
       8 times per step, K1c, K3a, K3b and K4 never (the model runs its
       windowed self-attention in plain PyTorch, as the JAX model does in
       XLA);
     - op path: make_flash_attention_packed(causal, window 100, dropout 0.1)
       forward and backward at the paper shape, a merged_bwd=False call at
       the cross shape, and export_keep_masks at the cross shape: K1c, K3a,
       K3b and K4 must launch.
     - legacy path: the port's tools/bench_flash_packed.main (L2 against
       K1/K2, LEGACY_ITERS timed calls each) at its own shape, then one
       inference call of flash_attention (L1) at the paper shape: exact
       counts of all twelve kernels.
     K5a and K5b launch on the stem path only: no model calls the fused
     block, as in the JAX package (fused_stem.py:24-35); L1-L2c on the
     legacy path only (no model calls them either).
It prints the card's name and power limit, one JSON line of kernel
numbers, and last {"ok": true, "device": {...}}. Without a GPU it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

# keep CUPTI attached from one profiler trace to the next (PyTorch detaches it after each trace by default and
# attaches it again for the next, a path with known faults, and sets this itself where it re-attaches often);
# whether it spares the occasional trace that records none or part of a call's kernels is not known
os.environ.setdefault("TEARDOWN_CUPTI", "0")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

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
    "K1c flash fwd causal": (fp.flash_fwd_causal_cuda, "flash_fwd.cu", JAX_FLASH + "161", "flash_fwd_causal_kernel",
                             1),
    # K3a launches the key-chunk kernel and the merge (four chunks at the cross shape, dq_splits); a causal
    # call or a single chunk launches the first alone
    "K3a flash dq": (fp.flash_dq_cuda, "flash_dq.cu", JAX_FLASH + "228", "flash_dq_", 2),
    "K3b flash dk/dv": (fp.flash_dkv_cuda, "flash_dkv.cu", JAX_FLASH + "283", "flash_dkv_kernel", 1),
    "K4 keep mask": (fp.keep_mask_cuda, "keep_mask.cu", JAX_FLASH + "747", "keep_mask_kernel", 1),
    # K5a launches the tile kernel and the fixed-order statistics sum
    "K5a fused stem k1": (fs.fused_stem_k1_cuda, "fused_stem_k1.cu", JAX_STEM + "288", "fused_stem_k1", 2),
    "K5b fused stem k2": (fs.fused_stem_k2_cuda, "fused_stem_k2.cu", JAX_STEM + "412", "fused_stem_k2", 1),
    # the per-head legacy flash family of tools/legacy_flash (L1 and L2a share a source, not a symbol)
    "L1 legacy flash fwd": (fl.legacy_fwd_cuda, "legacy_flash_fwd.cu", JAX_LEGACY + "flash_attention.py:42",
                            "lf_fwd_kernel", 1),
    "L2a legacy flash fwd lse": (fb.legacy_fwd_lse_cuda, "legacy_flash_fwd.cu",
                                 JAX_LEGACY + "flash_attention_bwd.py:57", "lf_fwd_lse_kernel", 1),
    "L2b legacy flash dq": (fb.legacy_dq_cuda, "legacy_flash_dq.cu", JAX_LEGACY + "flash_attention_bwd.py:109",
                            "lf_dq_kernel", 1),
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
        del dq3, dk3, dv3, delta, args
        rows[rate] = r
        del o_p, lse_p, dq_p, dk_p, dv_p, qr, kr, vr
        torch.cuda.empty_cache()

    # K4: the keep-mask probe at the decoder's geometry, bit for bit
    lq_p, lk_p = -(-LQ // bq) * bq, -(-LK // bk) * bk
    keep_k = fp.export_keep_masks(int(seed), B, HEADS, LQ, LK, dropout_rate=0.1, block_q=bq, block_k=bk)
    keep_p = fp.keep_mask(int(seed), B, HEADS, lq_p, lk_p, 0.1, dev, bq, bk)
    torch.cuda.synchronize()
    if not torch.equal(keep_k, keep_p):
        raise AssertionError("K4 keep-mask differs from its plain version")
    log(f"[cross] K4 keep-mask [{B}, {HEADS}, {lq_p}, {lk_p}] equal to the plain version bit for bit")
    del keep_k, keep_p
    torch.cuda.empty_cache()
    ms4, call4 = kernel_times("K4 keep mask", lambda: fp.keep_mask_cuda(seed, B, HEADS, lq_p, lk_p, 0.1, bq, bk))
    plain4 = time_ms(lambda: fp.keep_mask(int(seed), B, HEADS, lq_p, lk_p, 0.1, dev, bq, bk), reps=3, warmup=1)
    log(f"  K4 {ms4:.3f} ms (call {call4:.3f}, plain {plain4:.3f} ms)")

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
        "cross3b": dict(max_abs_err_cross=max(main["err3b"], r0["err3b"]), ms_cross=main["ms3b"],
                        call_ms_cross=main["call3b"], ms_cross_dropout0=r0["ms3b"],
                        plain_ms_cross=main["plain2"],
                        bound_ms_cross=max(flops3b / PEAK_BF16_FLOPS, bytes3b / PEAK_BYTES) * 1e3,
                        library_ms_cross=lib2, library_ms_cross_dropout0=lib[0.0][1],
                        library_device_ms_cross=lib[0.1][3], library_device_ms_cross_dropout0=lib[0.0][3],
                        launch_record_cross=main["info3b"]),
        # K4 reads nothing and writes the mask; its hash is integer work, which the bf16 peak does not rate
        "K4 keep mask": kernel_row("K4 keep mask", 0.0, ms4, plain4, 0, B * HEADS * lq_p * lk_p + 4, None,
                                   call_ms=call4),
    }


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


def phase_stem(dev):
    """K5a and K5b at the three stem block shapes (b8, bf16), dropout 0.5
    and none: each kernel against its plain version, the whole block against
    reference_block; device times, the plain block's forward, the cuDNN
    convolutions of the same block alone, and forward + backward of the
    fused block against plain autograd."""
    t0 = time.perf_counter()
    rows = {}
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
            r["ms_b"], r["call_b"] = kernel_times("K5b fused stem k2", lambda: fs.fused_stem_k2_cuda(
                y2, mean_inv, w3, b3, drop, **kw))
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
                               max_abs_err_path=errs[blk])
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


def build(dev, **hp):
    hp = dict(vocab_size=VOCAB, max_seq_len=LQ, input_modality="image", use_flash_cross=True,
              cache_dtype="bfloat16", **hp)
    model, _ = build_model(hp, device=dev, seed=0)
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
    if "flash_fwd_causal_kernel" in low:
        return "K1c flash fwd causal"
    for key, kind in (("lfany_fwd_kernel", "LA legacy flash fwd, any dtype"),
                      ("lfany_dq_kernel", "LA legacy flash dq, any dtype"),
                      ("lfany_dkv_kernel", "LA legacy flash dk/dv, any dtype"),
                      ("lf_fwd_lse_kernel", "L2a legacy flash fwd lse"), ("lf_fwd_kernel", "L1 legacy flash fwd"),
                      ("lf_dq_kernel", "L2b legacy flash dq"), ("lf_dkv_kernel", "L2c legacy flash dk/dv"),
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


def model_path(dev, tag, out_dir, profile, **hp):
    """Train and serve one model with every launch count from 0; each of K1
    and K2 must launch once per decoder layer and step, no other kernel."""
    model = build(dev, **hp)
    reset_counts()
    step, state, batch, g, train = phase_train(model, dev, tag)
    serve = phase_serve(model, dev, tag)
    launches = read_counts()
    log(f"[{tag} path] kernel launches {launches}")
    want = {name: 8 * train["steps"] if name in ("K1 flash fwd", "K2 flash bwd") else 0 for name in KERNELS}
    if launches != want:
        raise AssertionError(f"{tag} path launched {launches}, expected {want}")
    summary = profile_step(step, state, batch, g, out_dir, tag) if profile else None
    del model, step, state, batch
    torch.cuda.empty_cache()
    return dict(hparams=hp, train=train, serve=serve, launches=launches, profile=summary)


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


def legacy_work(pairs, n_keys, lk, kv_valid):
    """(operations, bytes) of L1, L2a, L2b and L2c at head width 64 for
    `pairs` (head, query, key) triples that a query sees and `n_keys` valid
    keys over the batch: the products of those pairs; q, o, do, dq once,
    k and v at the valid keys, lse and delta (f32), the key masks, and dk
    and dv written whole."""
    qb = B * HEADS * LQ * 64 * 2
    kv_bytes = n_keys * HEADS * 64 * 2
    stats = B * HEADS * LQ * 4
    small = B * 4 + kv_valid.numel()
    return {"L1 legacy flash fwd": (4 * 64 * pairs, 2 * qb + 2 * kv_bytes + B * 4),
            "L2a legacy flash fwd lse": (4 * 64 * pairs, 2 * qb + 2 * kv_bytes + stats + small),
            "L2b legacy flash dq": (6 * 64 * pairs, 3 * qb + 2 * kv_bytes + 2 * stats + small),
            "L2c legacy flash dk/dv": (8 * 64 * pairs, 2 * qb + 2 * kv_bytes + 2 * stats + small
                                       + 2 * B * HEADS * lk * 64 * 2)}


def phase_legacy(dev, cross):
    """L1, L2a, L2b and L2c, per-head [B, H, L, 64] bf16, at the flagship
    cross shape (L2: the images' kv_valid; L1: kv_len of the same counts)
    and at the paper's self-attention shape (causal, window 100, the
    targets as kv_len for L1 and as kv_valid for L2, so that the pad rows
    past a target see no key): each against its plain version (rows with no
    key: o = 0 and lse = 0 in both), device time, plain time and SDPA with
    the same boolean mask (forward beside L1 and L2a, backward beside L2b
    and L2c). The head-packed kernels of the cross phase at dropout 0 stand
    beside them: K1 beside L2a, K3a beside L2b, K3b beside L2c, K2 beside
    L2b + L2c."""
    g = torch.Generator(device=dev).manual_seed(6)
    lengths = torch.tensor(TARGET_LENGTHS, dtype=torch.int32, device=dev)
    valid_cross = memory_valid_from_hw(ragged_hw(B, dev), GRID_H, GRID_W).contiguous()
    shapes = {
        "cross": dict(lk=LK, band=dict(causal=False, window=-1), kv_len1=valid_cross.sum(1).to(torch.int32),
                      kv_valid=valid_cross),
        "self": dict(lk=LQ, band=dict(causal=True, window=WINDOW), kv_len1=lengths,
                     kv_valid=(torch.arange(LQ, device=dev)[None, :] < lengths[:, None]).contiguous()),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {name: {} for name in LEGACY_BF16}
    for tag, s in shapes.items():
        lk, band, kv_len1, kv_valid = s["lk"], s["band"], s["kv_len1"], s["kv_valid"]
        kv_len2 = torch.full((B,), lk, dtype=torch.int32, device=dev)
        q, k, v, do = (torch.randn((B, HEADS, n, 64), generator=g, device=dev).to(torch.bfloat16)
                       for n in (LQ, lk, lk, LQ))
        see = fl.visible_keys(LQ, lk, kv_len2, kv_valid, band["causal"], band["window"])  # [B, 1, Lq or 1, Lk]
        pairs = HEADS * int(see.sum()) * (LQ if see.shape[2] == 1 else 1)
        work = legacy_work(pairs, int(kv_valid.sum()), lk, kv_valid)
        log(f"[legacy {tag}] B {B} H {HEADS} Lq {LQ} Lk {lk} D 64 bf16, {band}, "
            f"{pairs // HEADS} (query, key) pairs to see over the batch")

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
        if band["causal"] and not all(n_empty):
            raise AssertionError("the paper shape must have rows with no key to see")
        log(f"  rows with no key (o = 0, lse = 0 in kernel and plain version): L1 {n_empty[0]}, L2a {n_empty[1]} "
            f"of {B * HEADS * LQ}")
        del o1_p, lse1_p, o1, dq, dk, dv

        timed = {"L1 legacy flash fwd": lambda: fl.legacy_fwd_cuda(q, k, v, kv_len1, **band),
                 "L2a legacy flash fwd lse": lambda: fb.legacy_fwd_lse_cuda(q, k, v, kv_len2, kv_valid, **band),
                 "L2b legacy flash dq": lambda: fb.legacy_dq_cuda(*bargs),
                 "L2c legacy flash dk/dv": lambda: fb.legacy_dkv_cuda(*bargs)}
        plain_fwd1 = time_ms(lambda: fl.attention_plain(q, k, v, kv_len1, None, **band), reps=3, warmup=1)
        plain_fwd2 = time_ms(lambda: fl.attention_plain(q, k, v, kv_len2, kv_valid, **band), reps=3, warmup=1)
        plain_bwd = time_ms(lambda: torch.autograd.grad(o2_p, (qr, kr, vr), do, retain_graph=True), reps=3, warmup=1)
        del o2_p, lse2_p, grads_p
        # library yardstick (never called by the port): SDPA on the same [B, H, L, D] tensors and boolean mask
        mask1 = fl.visible_keys(LQ, lk, kv_len1, None, band["causal"], band["window"])
        lib_fwd1 = time_ms(lambda: sdpa(q, k, v, attn_mask=mask1))
        lib_fwd2 = time_ms(lambda: sdpa(q, k, v, attn_mask=see))
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o_s = sdpa(qs, ks, vs, attn_mask=see)
        lib_bwd = time_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do, retain_graph=True))
        del o_s, qs, ks, vs
        plain = {"L1 legacy flash fwd": plain_fwd1, "L2a legacy flash fwd lse": plain_fwd2,
                 "L2b legacy flash dq": plain_bwd, "L2c legacy flash dk/dv": plain_bwd}
        lib = {"L1 legacy flash fwd": lib_fwd1, "L2a legacy flash fwd lse": lib_fwd2,
               "L2b legacy flash dq": lib_bwd, "L2c legacy flash dk/dv": lib_bwd}
        for name, fn in timed.items():
            ms, call = kernel_times(name, fn)
            ops, nbytes = work[name]
            t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
            rows[name][tag] = dict(err=err[name], ms=ms, call_ms=call, plain_ms=plain[name], library_ms=lib[name],
                                   work=work[name], bound_ms=max(t_ops, t_bytes) * 1e3,
                                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log("  " + ", ".join(f"{n.split()[0]} {rows[n][tag]['ms']:.4f} ms (call {rows[n][tag]['call_ms']:.3f}, "
                               f"bound {rows[n][tag]['bound_ms']:.4f})" for n in timed))
        log(f"  plain fwd {plain_fwd1:.3f} (L1) / {plain_fwd2:.3f} (L2a) ms, plain autograd bwd {plain_bwd:.3f} ms; "
            f"SDPA fwd {lib_fwd1:.3f} / {lib_fwd2:.3f} ms, bwd {lib_bwd:.3f} ms")
        del q, k, v, do, o2, lse2, bargs, qr, kr, vr, see, mask1, timed
        torch.cuda.empty_cache()

    # the head-packed kernels of the same function at the cross shape, dropout 0
    packed = {"L2a legacy flash fwd lse": dict(k1_ms_dropout0=cross["K1 flash fwd"]["ms_dropout0"]),
              "L2b legacy flash dq": dict(k2_ms_dropout0=cross["K2 flash bwd"]["ms_dropout0"],
                                          k3a_ms_dropout0=cross["cross3a"]["ms_cross_dropout0"]),
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
        c, sf = r["cross"], r["self"]
        out[name] = kernel_row(name, max(c["err"], sf["err"]), c["ms"], c["plain_ms"], *c["work"], c["library_ms"],
                               call_ms=c["call_ms"], max_abs_err_cross=c["err"], max_abs_err_self=sf["err"],
                               ms_self=sf["ms"], call_ms_self=sf["call_ms"], plain_ms_self=sf["plain_ms"],
                               bound_ms_self=sf["bound_ms"], bound_by_self=sf["bound_by"],
                               library_ms_self=sf["library_ms"], **packed.get(name, {}))
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


def main(argv=None):
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="trace one train step of each model")
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="where the result file and the traces go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    log(f"[build] {sorted(p.name for p in paths.values())} in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"[build] {name}: {line.strip()}")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    OUT_DIR = args.out_dir

    cross = phase_cross(dev)
    self_rows = phase_self(dev)
    stem = phase_stem(dev)
    stem_launches, stem_errs = stem_path(dev)
    stem_k = stem_rows(stem, stem_launches, stem_errs)
    legacy_k = phase_legacy(dev, cross) | phase_legacy_any(dev)
    kernels = [cross["K1 flash fwd"], cross["K2 flash bwd"], self_rows["K1c flash fwd causal"],
               self_rows["K3a flash dq"] | cross["cross3a"], self_rows["K3b flash dk/dv"] | cross["cross3b"],
               cross["K4 keep mask"]]

    flagship = model_path(dev, "flagship", args.out_dir, args.profile)
    paper = model_path(dev, "paper", args.out_dir, args.profile, attn_window=WINDOW, packed_stem=True)
    if paper["serve"]["cache_len"] != WINDOW + 1:
        raise AssertionError(f"the paper model's ring cache has {paper['serve']['cache_len']} slots")
    log("[paper path] K1c, K3a, K3b and K4 launched 0 times: the windowed self-attention is plain PyTorch "
        "(dense mask up to 256 positions, banded above), as in the JAX model")
    ops = op_path(dev)
    for k in kernels:  # K1/K2 from the paper model's path, the rest from the op path
        k["launches"] = paper["launches"][k["name"]] if k["name"] in ("K1 flash fwd", "K2 flash bwd") else ops[k["name"]]
    kernels += [stem_k["K5a fused stem k1"], stem_k["K5b fused stem k2"]]  # launches from the stem path
    legacy = legacy_path(dev)
    for name, row in legacy_k.items():
        kernels.append(row | dict(launches=legacy["launches"][name]))
    for k in kernels:
        k.update(KERNEL_INFO.get(k["name"], {}))
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")

    log(f"[trace] {TRACES['taken']} profiler traces, {TRACES['retaken']} taken again "
        f"(TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')})")
    result = dict(card=card, kernels=kernels, flagship=flagship, paper=paper, op_path=ops,
                  stem_path=dict(launches=stem_launches, max_abs_err=stem_errs), legacy_path=legacy,
                  traces=dict(TRACES))
    (args.out_dir / "chip_smoke_result.json").write_text(json.dumps(result, indent=1))
    log(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    log(json.dumps({"kernels": [{**{k: kern[k] for k in keys}, **kern} for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
