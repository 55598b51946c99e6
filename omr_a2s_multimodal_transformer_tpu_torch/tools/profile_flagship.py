"""Flagship max-shape train-step analysis: FLOPs and bytes of one step,
the measured step time, and which roof binds; optionally a profiler trace.

Port of ``tools/profile_flagship.py``, with JAX's three ``CONFIGS`` and its
flags, and a fourth config of its own, ``paper`` (the paper model's b8
step: window 100, flash cross-attention, no remat). JAX reads FLOPs and
bytes from XLA's cost analysis of the compiled step. The port counts them
on one step run on the device:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
  convolutions, forward and backward), plus the flash kernels', which run
  outside ATen and which it does not see: K1 4 x 64 and K2 10 x 64 FLOPs a
  (head, query, valid key) triple (``flash_flops``), as ``PERF.md`` counts
  the flash bound;
- bytes: ``hlo_bytes``'s counter (every ATen op's operands and results,
  K1's and K2's own).

The step is ``training/train_state.py`` ``make_train_step`` (bf16 compute,
Adam) on JAX's all-ones batch. One untimed step, then 3 blocks of
``--steps`` steps, each timed on the host clock to its loss read to the
host; the median block gives ms a step, TFLOP/s against the H100's 989
dense bf16 TFLOP/s and GB/s against its 3,350 GB/s of HBM3, and the roof
that binds (the larger of FLOPs / 989e12 and bytes / 3.35e12).

``--trace DIR`` traces one more step with ``trace_breakdown.ModuleRanges``
into ``DIR/trace.json``; ``--breakdown N`` prints ``hlo_bytes``'s top N
groups (JAX's) and, with ``--trace``, ``trace_breakdown``'s top N modules
by device time and its table by role. ``--packed`` sets ``packed_stem`` and ``--conv_mode`` is
accepted (both run the same plain convolutions on the card:
``ops/packed_conv.py``); ``--dump_hlo FILE`` writes the counted ops (group,
bytes, op) in place of HLO text. ``--smoke`` is tiny shapes; runs on
``cuda`` unless given ``--device cpu``:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.profile_flagship [image|multimodal|bench|paper] [--trace DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time

import torch

CONFIGS = {
    # bench config
    "bench": dict(modality="image", b=16, ih=128, iw=1024, L=256, remat=False, flash=False),
    # unimodal image at true max shapes
    "image": dict(modality="image", b=4, ih=361, iw=4416, L=1268, remat=True, flash=False),
    # flagship multimodal at true max shapes
    "multimodal": dict(modality="both", b=2, ih=361, iw=4416, L=1268, remat=True, flash=True),
    # the port's: the paper model's b8 train step (window 100, flash cross-attention; with --packed its stem)
    "paper": dict(modality="image", b=8, ih=361, iw=4416, L=1268, remat=False, flash=True),
}
SMOKE = dict(b=1, ih=32, iw=64, L=12, ah=195, aw=24, vocab=31)
VOCAB, AH, AW = 6997, 195, 808
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="multimodal", choices=list(CONFIGS))
    p.add_argument("--trace", default=None, help="write a torch.profiler trace of one step to this dir")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--no_flash", action="store_true")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--packed", action="store_true", help="packed_stem (the same convolutions on the card)")
    p.add_argument("--conv_mode", default="widened", choices=["widened", "patched", "auto"],
                   help="the TPU's packed_conv layout: accepted, read nowhere on the card")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--breakdown", type=int, default=0,
                   help="print the top-N op groups by bytes (hlo_bytes), and by device time with --trace")
    p.add_argument("--dump_hlo", default=None, help="write the counted ops (group, bytes, op) here")
    p.add_argument("--smoke", action="store_true", help="tiny shapes")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def flash_flops(q: torch.Tensor, kv_valid: torch.Tensor, n_heads: int, backward: bool) -> float:
    """K1's (4 x 64) or K2's (10 x 64) FLOPs a (head, query, valid key) triple."""
    pairs = n_heads * q.shape[1] * int(kv_valid.sum())
    return (10 if backward else 4) * 64 * pairs


@contextlib.contextmanager
def counted_flash(add):
    """K1/K2 wrappers that call ``add(flops)`` at each launch."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp

    saved = fp.flash_fwd_cuda, fp.flash_bwd_cuda

    def fwd(q, k, v, kv_len, kv_valid, seed, rate, n_heads, *a, **kw):
        add(flash_flops(q, kv_valid, n_heads, False))
        return saved[0](q, k, v, kv_len, kv_valid, seed, rate, n_heads, *a, **kw)

    def bwd(q, k, v, kv_len, kv_valid, seed, o, lse, do, rate, n_heads, *a, **kw):
        add(flash_flops(q, kv_valid, n_heads, True))
        return saved[1](q, k, v, kv_len, kv_valid, seed, o, lse, do, rate, n_heads, *a, **kw)

    fwd.launches, bwd.launches = saved[0].launches, saved[1].launches
    fp.flash_fwd_cuda, fp.flash_bwd_cuda = fwd, bwd
    try:
        yield
    finally:
        saved[0].launches, saved[1].launches = fwd.launches, bwd.launches  # counted on the module's name meanwhile
        fp.flash_fwd_cuda, fp.flash_bwd_cuda = saved


def flop_count(step) -> float:
    """FLOPs of one call of ``step()``: FlopCounterMode's and K1's/K2's."""
    from torch.utils.flop_counter import FlopCounterMode

    flash = []
    with counted_flash(flash.append), FlopCounterMode(display=False) as counter:
        step()
    return float(counter.get_total_flops() + sum(flash))


def make_batch(cfg: dict, multimodal: bool, dev) -> dict:
    """JAX's all-ones batch."""
    b, L = cfg["b"], cfg["L"]
    ones = dict(dtype=torch.float32, device=dev)
    out = {"y_in": torch.ones((b, L), dtype=torch.int32, device=dev),
           "y_out": torch.ones((b, L), dtype=torch.int32, device=dev)}
    image = torch.ones((b, cfg["ih"], cfg["iw"], 1), **ones)
    image_hw = torch.tensor([[cfg["ih"], cfg["iw"]]] * b, dtype=torch.int32, device=dev)
    if not multimodal:
        return dict(out, x=image, x_hw=image_hw)
    return dict(out, xi=image, xi_hw=image_hw, xa=torch.ones((b, cfg["ah"], cfg["aw"], 1), **ones),
                xa_hw=torch.tensor([[cfg["ah"], cfg["aw"]]] * b, dtype=torch.int32, device=dev))


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.tools import hlo_bytes, trace_breakdown
    from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dict(CONFIGS[args.mode], ah=AH, aw=AW, vocab=VOCAB)
    if args.smoke:
        cfg.update(SMOKE)
    if args.no_flash:
        cfg["flash"] = False
    if args.no_remat:
        cfg["remat"] = False
    if args.batch:
        cfg["b"] = args.batch
    hp = {"vocab_size": cfg["vocab"], "max_seq_len": cfg["L"], "input_modality": cfg["modality"],
          "attn_window": 100, "remat": cfg["remat"], "use_flash_cross": cfg["flash"], "packed_stem": args.packed,
          "conv_mode": args.conv_mode}
    if cfg["modality"] == "both":
        hp["mixer_type"] = "concat"
    model, multimodal = build_model(hp, device=dev, seed=0)
    state = TrainState.create(model, lr=1e-4)
    step = make_train_step(model, vocab_size=cfg["vocab"], bf16_compute=True, multimodal=multimodal, device=dev)
    batch = make_batch(cfg, multimodal, dev)
    gen = torch.Generator(device=dev)

    def one():
        gen.manual_seed(1)  # JAX passes the same key to every step
        return step(state, batch, gen, *(("both",) if multimodal else ()))[1]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    float(one())
    print(f"# first step {time.perf_counter() - t0:.1f}s")
    flops = flop_count(one)
    rows = hlo_bytes.instruction_bytes(one, model)
    bytes_acc = sum(b for _, b, _ in rows)
    print(f"cost analysis: {flops/1e12:.3f} TFLOP/step, {bytes_acc/1e9:.2f} GB/step")
    if dev.type == "cuda":
        print(f"memory: peak {torch.cuda.max_memory_allocated(dev)/1e9:.2f} GB")
    if args.breakdown:
        hlo_bytes.print_top(rows, top=args.breakdown)
    if args.dump_hlo:
        with open(args.dump_hlo, "w") as f:
            f.writelines(f"{g}\t{b:.0f}\t{op}\n" for g, b, op in rows)
        print(f"# ops -> {args.dump_hlo}")

    blocks = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = one()
        float(loss)
        blocks.append((time.perf_counter() - t0) / args.steps)
    dt = statistics.median(blocks)
    sps = cfg["b"] / dt
    print(f"measured: {dt*1e3:.1f} ms/step, {sps:.2f} samples/s "
          f"(b{cfg['b']} {cfg['ih']}x{cfg['iw']} L{cfg['L']} remat={cfg['remat']} flash={cfg['flash']})")
    t_flops, t_bytes = flops / PEAK_FLOPS, bytes_acc / PEAK_BYTES
    roof = "bytes" if t_bytes > t_flops else "operations"
    print(f"achieved: {flops/dt/1e12:.1f} TFLOP/s ({flops/dt/PEAK_FLOPS*100:.1f}% of 989 bf16 dense), "
          f"{bytes_acc/dt/1e9:.0f} GB/s ({bytes_acc/dt/PEAK_BYTES*100:.0f}% of 3350 GB/s HBM3); "
          f"the roof of {roof} binds ({max(t_flops, t_bytes)*1e3:.1f} ms a step)")
    out = dict(config=cfg, flops=flops, bytes=bytes_acc, ms_per_step=dt * 1e3, samples_per_s=sps, blocks=blocks,
               bound_ms=max(t_flops, t_bytes) * 1e3, bound_by=roof)
    if args.trace:
        import os

        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with trace_breakdown.ModuleRanges(model), profile(activities=acts) as prof:
            float(one())
            sync(dev)
        prof.export_chrome_trace(path)
        print(f"# trace -> {path}")
        out["trace"] = path
        if args.breakdown:
            b = trace_breakdown.breakdown(path, depth=trace_breakdown.ROLE_DEPTH, device=dev.type)
            trace_breakdown.print_breakdown(b, top=args.breakdown)
            trace_breakdown.print_roles(b)
            out["breakdown"] = b
    return out


if __name__ == "__main__":
    main()
