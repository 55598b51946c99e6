#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py              # from the root of a checkout
    python3 chip_smoke.py --profile    # also trace one train step
    python3 chip_smoke.py --out-dir D  # write the result and trace to D (default build/chip_smoke/)

Phases, each of which raises on failure (exit code 1):
  1. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version at the flagship
     cross-attention shape (B 8, Lq 1268, Lk 12,696, bf16, ragged keys),
     with dropout 0 and 0.1, and time kernel, plain version and the
     PyTorch library call that computes the same function;
  3. train: 3 full-width steps of the image model (vocab 6,997, max_seq_len
     1268, bf16 compute, flash cross-attention) on 8 random 361x4416
     images;
  4. serve: greedy decode of 4 raw u8 361x4416 images with a bf16 cache.
The kernels' launch counts are set to 0 before phase 3 and read after
phase 4: each kernel must have launched 8 times per train step.
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
KERNEL_TOL = 2e-2  # max |kernel - plain| <= KERNEL_TOL * max |plain| (bf16 outputs, p rounded to bf16)
LSE_TOL = 1e-3     # lse is f32 from the same bf16 products, other summation order


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


def phase_kernels(dev):
    """K1/K2 against the plain version, and times at the flagship shape."""
    g = torch.Generator(device=dev).manual_seed(0)
    kv_valid = memory_valid_from_hw(ragged_hw(B, dev), GRID_H, GRID_W).contiguous()
    kv_len = torch.full((B,), LK, dtype=torch.int32, device=dev)
    seed = torch.tensor([20240611], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(LQ, LK)
    q, k, v, do = (torch.randn((B, n, HEADS * 64), generator=g, device=dev).to(torch.bfloat16)
                   for n in (LQ, LK, LK, LQ))
    # the bounds count only valid keys: a masked key's products never reach o, dq, dk or dv
    n_valid = int((kv_valid & (torch.arange(LK, device=dev)[None] < kv_len[:, None])).sum())  # over the batch
    log(f"[kernels] B {B} Lq {LQ} Lk {LK} bf16, valid keys {n_valid} of {B * LK}")
    kv_bytes = n_valid * HEADS * 64 * 2  # k (or v) at the valid keys, bf16
    small = kv_valid.numel() + kv_len.numel() * 4
    flops1 = 4 * HEADS * LQ * n_valid * 64  # s = q k^T, o = p v
    bytes1 = 2 * q.numel() * 2 + 2 * kv_bytes + small + B * HEADS * LQ * 4  # q, o, k, v, lse
    flops2 = 10 * HEADS * LQ * n_valid * 64  # s, dp = do v^T, dv = p^T do, dk = ds^T q, dq = ds k
    # reads q, do, lse, delta and the valid k, v; writes dq and the whole of dk, dv
    bytes2 = 2 * q.numel() * 2 + 2 * B * HEADS * LQ * 4 + 2 * kv_bytes + small + q.numel() * 2 + 2 * k.numel() * 2
    rows = {}
    for rate in (0.0, 0.1):
        o_k, lse_k = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk)
        dq_k, dk_k, dv_k = fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o_k, lse_k, do, rate, HEADS, bq, bk)
        torch.cuda.synchronize()
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_p, lse_p = fp.flash_attention_plain(qr, kr, vr, kv_len, kv_valid, seed, rate, HEADS)
        dq_p, dk_p, dv_p = torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True)
        log(f"[kernels] dropout {rate}")
        errs1 = [max_err(o_k, o_p)]
        check("K1 o", errs1[0], float(o_p.detach().float().abs().max()), KERNEL_TOL)
        lse_err = max_err(lse_k, lse_p)
        log(f"  K1 lse: max_abs_err {lse_err:.3e} (tolerance {LSE_TOL:g}) {'ok' if lse_err <= LSE_TOL else 'FAIL'}")
        if lse_err > LSE_TOL:
            raise AssertionError("K1 lse disagrees with its plain version")
        errs2 = []
        for name, a, r in (("dq", dq_k, dq_p), ("dk", dk_k, dk_p), ("dv", dv_k, dv_p)):
            errs2.append(max_err(a, r))
            check(f"K2 {name}", errs2[-1], float(r.float().abs().max()), KERNEL_TOL)
        ms1 = time_ms(lambda: fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, HEADS, bq, bk))
        ms2 = time_ms(lambda: fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o_k, lse_k, do, rate, HEADS, bq, bk))
        plain1 = time_ms(lambda: fp.flash_attention_plain(q, k, v, kv_len, kv_valid, seed, rate, HEADS), reps=3, warmup=1)
        plain2 = time_ms(lambda: torch.autograd.grad(o_p, (qr, kr, vr), do, retain_graph=True), reps=3, warmup=1)
        rows[rate] = dict(err1=max(errs1 + [lse_err]), err2=max(errs2), ms1=ms1, ms2=ms2, plain1=plain1, plain2=plain2)
        log(f"  K1 {ms1:.3f} ms (plain {plain1:.3f} ms), K2 {ms2:.3f} ms (plain autograd {plain2:.3f} ms)")
        del o_p, lse_p, dq_p, dk_p, dv_p, qr, kr, vr
        torch.cuda.empty_cache()

    # library yardstick (never called by the port): SDPA, same boolean mask, dropout 0
    qs, ks, vs = (t.view(t.shape[0], t.shape[1], HEADS, 64).transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    mask = kv_valid[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib1 = time_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
    o_s = sdpa(qs, ks, vs, attn_mask=mask)
    do_s = do.view(B, LQ, HEADS, 64).transpose(1, 2)
    lib2 = time_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True))
    log(f"[kernels] library: SDPA fwd {lib1:.3f} ms, SDPA bwd {lib2:.3f} ms (dropout 0)")
    del o_s
    torch.cuda.empty_cache()

    main = rows[0.1]  # the training path runs dropout 0.1
    bound1 = max(flops1 / PEAK_BF16_FLOPS, bytes1 / PEAK_BYTES) * 1e3
    bound2 = max(flops2 / PEAK_BF16_FLOPS, bytes2 / PEAK_BYTES) * 1e3
    kernels = [
        dict(name="K1 flash fwd", route="cuda", source="omr_a2s_multimodal_transformer_tpu_torch/csrc/flash_fwd.cu",
             replaces="omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py:161",
             max_abs_err=max(r["err1"] for r in rows.values()), ms=main["ms1"], plain_ms=main["plain1"],
             bound_ms=bound1, bound_by="operations" if flops1 / PEAK_BF16_FLOPS >= bytes1 / PEAK_BYTES else "bytes",
             library_ms=lib1, ms_dropout0=rows[0.0]["ms1"], plain_ms_dropout0=rows[0.0]["plain1"]),
        dict(name="K2 flash bwd", route="cuda", source="omr_a2s_multimodal_transformer_tpu_torch/csrc/flash_bwd.cu",
             replaces="omr_a2s_multimodal_transformer_tpu/ops/flash_packed.py:364",
             max_abs_err=max(r["err2"] for r in rows.values()), ms=main["ms2"], plain_ms=main["plain2"],
             bound_ms=bound2, bound_by="operations" if flops2 / PEAK_BF16_FLOPS >= bytes2 / PEAK_BYTES else "bytes",
             library_ms=lib2, ms_dropout0=rows[0.0]["ms2"], plain_ms_dropout0=rows[0.0]["plain2"]),
    ]
    del q, k, v, do
    torch.cuda.empty_cache()
    return kernels


def full_model(dev):
    hp = dict(vocab_size=VOCAB, max_seq_len=LQ, input_modality="image", use_flash_cross=True,
              cache_dtype="bfloat16")
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


def phase_train(model, dev, n_steps=3):
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
        log(f"[train] step {i}: loss {loss:.4f}, {times[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] peak memory {peak:.2f} GiB")
    if not all(torch.isfinite(torch.tensor(losses))):
        raise AssertionError(f"non-finite train loss: {losses}")
    return step, state, batch, g, dict(steps=n_steps, step_ms=times, loss=losses, peak_gib=peak)


def kernel_kind(name: str) -> str:
    """Coarse class of a device kernel, by its name."""
    low = name.lower()
    if "flash_fwd" in low:
        return "K1 flash fwd"
    if "flash_bwd" in low:
        return "K2 flash bwd"
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


def profile_step(step, state, batch, g, out_dir: Path):
    """One traced train step: device time by kernel, table and trace to out_dir."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, g)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out_dir / "train_step_profile.txt").write_text(table)
    trace = out_dir / "train_step_trace.json"
    prof.export_chrome_trace(str(trace))
    summary = trace_summary(trace)
    log(f"[profile] device busy {summary['busy_ms']:.3f} ms of a {summary['span_ms']:.3f} ms span")
    for kind, ms in summary["by_kind"].items():
        log(f"[profile]   {kind:14s} {ms:9.3f} ms {100 * ms / summary['busy_ms']:5.1f}%")
    for op, ms in summary["elementwise_by_op"].items():
        log(f"[profile]   elementwise/reduction in {op}: {ms:.3f} ms")
    return summary


def phase_serve(model, dev):
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
    log(f"[serve] tokens {tuple(tokens.shape)} {tokens.dtype}, {steps} decode steps run, {ms:.1f} ms "
        f"({ms / max(steps, 1):.3f} ms/step)")
    if tokens.shape != (4, LQ) or not torch.isfinite(scores).all() or int(tokens.max()) >= VOCAB:
        raise AssertionError("decode output has the wrong shape or values")
    return dict(decode_ms=ms, steps=steps, batch=4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="trace one train step")
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "chip_smoke",
                    help="where the result file and the trace go")
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

    kernels = phase_kernels(dev)
    model = full_model(dev)

    # the main path: counts from 0, read after train and serve
    fp.flash_fwd_cuda.launches = 0
    fp.flash_bwd_cuda.launches = 0
    step, state, batch, g, train = phase_train(model, dev)
    serve = phase_serve(model, dev)
    launches = {"K1 flash fwd": fp.flash_fwd_cuda.launches, "K2 flash bwd": fp.flash_bwd_cuda.launches}
    log(f"[main path] kernel launches {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] != 8 * train["steps"]:  # one per decoder layer and step
            raise AssertionError(f"{k['name']} launched {k['launches']} times in {train['steps']} steps")
    args.out_dir.mkdir(parents=True, exist_ok=True)
    profile = profile_step(step, state, batch, g, args.out_dir) if args.profile else None

    result = dict(card=card, kernels=kernels, train=train, serve=serve, profile=profile)
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
