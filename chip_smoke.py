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
       bf16, ragged keys), dropout 0 and 0.1: K1 and K2; K3a and K3b as the
       split backward of a merged_bwd=False call (dropout 0.1); K4, the
       keep-mask probe at the decoder's 128/2048 blocks, bit for bit;
     - at the paper's self-attention shape (B 8, L 1268, 4 x 64 heads,
       window 100, ragged target lengths, 128/512 blocks), dropout 0 and
       0.1: K1c, K3a and K3b, with the banded attention of the windowed
       decoder as a second witness at dropout 0; full causal once;
  3. three paths, each with every kernel's launch count set to 0 just
     before it and read just after:
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
It prints the card's name and power limit, one JSON line of kernel
numbers, and last {"ok": true, "device": {...}}. Without a GPU it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from omr_a2s_multimodal_transformer_tpu_torch.inference import make_image_transcriber  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.models.transformer import memory_valid_from_hw  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops.banded_attention import banded_causal_attention  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.ops.image import preprocess_image_batch  # noqa: E402
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet), at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
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
JAX_OP = "omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py:"
# name -> (launching wrapper, source, TPU kernel line, device symbol in a profiler trace)
KERNELS = {
    "K1 flash fwd": (fp.flash_fwd_cuda, "flash_fwd.cu", 161, "flash_fwd_kernel<false>"),
    "K2 flash bwd": (fp.flash_bwd_cuda, "flash_bwd.cu", 364, "flash_bwd_kernel"),
    "K1c flash fwd causal": (fp.flash_fwd_causal_cuda, "flash_fwd.cu", 161, "flash_fwd_kernel<true>"),
    "K3a flash dq": (fp.flash_dq_cuda, "flash_dq.cu", 228, "flash_dq_kernel"),
    "K3b flash dk/dv": (fp.flash_dkv_cuda, "flash_dkv.cu", 283, "flash_dkv_kernel"),
    "K4 keep mask": (fp.keep_mask_cuda, "keep_mask.cu", 747, "keep_mask_kernel"),
}
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


def kernel_times(name, fn, reps=10):
    """(device ms, call ms) of a kernel's wrapper fn: the mean duration of
    the kernel itself over the launches that a profiler trace of reps calls
    recorded (the tracer may miss one as it starts), and the CUDA-event
    median of one call, which holds the wrapper's host work and its other
    device work too (for a kernel of tens of microseconds, mostly host)."""
    from torch.profiler import ProfilerActivity, profile

    call = time_ms(fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    trace = OUT_DIR / "kernel_timing_trace.json"
    prof.export_chrome_trace(str(trace))
    symbol = KERNELS[name][3]
    durs = [e["dur"] for e in json.loads(trace.read_text())["traceEvents"]
            if e.get("cat") == "kernel" and symbol in e["name"]]
    if not reps // 2 <= len(durs) <= reps:
        raise AssertionError(f"{name}: {len(durs)} kernels named {symbol} in the trace of {reps} calls")
    return sum(durs) / len(durs) / 1e3, call


def reset_counts():
    for fn, *_ in KERNELS.values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


def kernel_row(name, err, ms, plain_ms, flops, nbytes, library_ms, **extra):
    """One entry of the kernels line; the bound is the larger of the valid
    work's operations over the bf16 peak and its bytes over the memory rate."""
    _, source, line, _ = KERNELS[name]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return dict(name=name, route="cuda", source=CSRC + source, replaces=f"{JAX_OP}{line}", max_abs_err=err, ms=ms,
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


def check_lse(name, got, ref):
    err = max_err(got, ref)
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {LSE_TOL:g}) {'ok' if err <= LSE_TOL else 'FAIL'}")
    if err > LSE_TOL:
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
        r["ms2"], r["call2"] = kernel_times("K2 flash bwd", lambda: fp.flash_bwd_cuda(
            q, k, v, kv_len, kv_valid, seed, o_k, lse_k, do, rate, HEADS, bq, bk))
        r["plain1"] = time_ms(lambda: fp.flash_attention_plain(q, k, v, kv_len, kv_valid, seed, rate, HEADS),
                              reps=3, warmup=1)
        r["plain2"] = time_ms(lambda: torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True), reps=3, warmup=1)
        log(f"  K1 {r['ms1']:.3f} ms (call {r['call1']:.3f}, plain {r['plain1']:.3f} ms), K2 {r['ms2']:.3f} ms "
            f"(call {r['call2']:.3f}, plain autograd {r['plain2']:.3f} ms)")
        if rate > 0.0:  # the split backward of a merged_bwd=False call
            delta = fp.attention_delta(do, o_k, HEADS)
            args = (q, k, v, kv_len, kv_valid, seed, do, lse_k, delta, rate, HEADS, bq, bk, False, -1)
            dq3 = fp.flash_dq_cuda(*args)
            dk3, dv3 = fp.flash_dkv_cuda(*args)
            torch.cuda.synchronize()
            r["err3a"] = check_vs("K3a dq", dq3, dq_p)
            r["err3b"] = max(check_vs("K3b dk", dk3, dk_p), check_vs("K3b dv", dv3, dv_p))
            r["ms3a"], r["call3a"] = kernel_times("K3a flash dq", lambda: fp.flash_dq_cuda(*args))
            r["ms3b"], r["call3b"] = kernel_times("K3b flash dk/dv", lambda: fp.flash_dkv_cuda(*args))
            log(f"  K3a {r['ms3a']:.3f} ms (call {r['call3a']:.3f}), K3b {r['ms3b']:.3f} ms (call {r['call3b']:.3f}) "
                "(split backward, non-causal)")
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

    # library yardstick (never called by the port): SDPA, same boolean mask, dropout 0
    qs, ks, vs = (t.view(t.shape[0], t.shape[1], HEADS, 64).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = kv_valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib1 = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
    o_s = sdpa(qs, ks, vs, attn_mask=mask)
    do_s = do.view(B, LQ, HEADS, 64).transpose(1, 2)
    lib2 = time_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True))
    log(f"[cross] library: SDPA fwd {lib1:.3f} ms, SDPA bwd {lib2:.3f} ms (dropout 0)")
    del o_s, q, k, v, do
    torch.cuda.empty_cache()

    main, r0 = rows[0.1], rows[0.0]  # the training path runs dropout 0.1
    return {
        "K1 flash fwd": kernel_row("K1 flash fwd", max(main["err1"], r0["err1"]), main["ms1"], main["plain1"],
                                   flops1, bytes1, lib1, call_ms=main["call1"],
                                   ms_dropout0=r0["ms1"], plain_ms_dropout0=r0["plain1"]),
        "K2 flash bwd": kernel_row("K2 flash bwd", max(main["err2"], r0["err2"]), main["ms2"], main["plain2"],
                                   flops2, bytes2, lib2, call_ms=main["call2"], ms_dropout0=r0["ms2"],
                                   plain_ms_dropout0=r0["plain2"]),
        "cross3a": dict(max_abs_err_cross=main["err3a"], ms_cross=main["ms3a"], call_ms_cross=main["call3a"],
                        plain_ms_cross=main["plain2"],
                        bound_ms_cross=max(flops3a / PEAK_BF16_FLOPS, bytes3a / PEAK_BYTES) * 1e3,
                        library_ms_cross=lib2),
        "cross3b": dict(max_abs_err_cross=main["err3b"], ms_cross=main["ms3b"], call_ms_cross=main["call3b"],
                        plain_ms_cross=main["plain2"],
                        bound_ms_cross=max(flops3b / PEAK_BF16_FLOPS, bytes3b / PEAK_BYTES) * 1e3,
                        library_ms_cross=lib2),
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
            r["ms3a"], r["call3a"] = kernel_times("K3a flash dq", lambda: fp.flash_dq_cuda(*args))
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
    if "flash_fwd_kernel<true>" in low:
        return "K1c flash fwd causal"
    for key, kind in (("flash_fwd", "K1 flash fwd"), ("flash_bwd", "K2 flash bwd"), ("flash_dq", "K3a flash dq"),
                      ("flash_dkv", "K3b flash dk/dv"), ("keep_mask", "K4 keep mask")):
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
    want = {"K1 flash fwd": 1, "K2 flash bwd": 0, "K1c flash fwd causal": 1, "K3a flash dq": 2,
            "K3b flash dk/dv": 2, "K4 keep mask": 1}
    if launches != want:
        raise AssertionError(f"op path launched {launches}, expected {want}")
    del keep
    torch.cuda.empty_cache()
    return launches


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
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    OUT_DIR = args.out_dir

    cross = phase_cross(dev)
    self_rows = phase_self(dev)
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
    for k in kernels:  # K1/K2 from this slice's model path, the rest from the op path
        k["launches"] = paper["launches"][k["name"]] if k["name"] in ("K1 flash fwd", "K2 flash bwd") else ops[k["name"]]
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} never launched on its path")

    result = dict(card=card, kernels=kernels, flagship=flagship, paper=paper, op_path=ops)
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
