"""Per-site memory-traffic ledger of the flagship train step, with remat on
and off.

Port of ``tools/hbm_ledger.py``:

1. builds ``FCFG``'s step (the concat multimodal model, packed stem, flash
   cross-attention, window 100, bf16 compute, Adam; JAX's all-ones batch)
   with remat off and on,
2. writes each variant's traffic by module (``hlo_bytes``: every ATen op's
   operands and results, K1's and K2's own, grouped by module path; what
   stands in for XLA's static HLO attribution) and its FLOPs
   (``profile_flagship.flop_count``) to ``--out`` (``reports/`` in JAX; the
   port's default is under ``runs/``),
3. measures both variants' samples/s (the median of 3 blocks of
   ``--steps`` steps, each timed on the host clock to its loss read to the
   host), unless ``--skip_measure``, and the share of a step that moving
   the counted bytes at 3,350 GB/s would take.

``--smoke`` is tiny shapes; runs on ``cuda`` unless given ``--device cpu``:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.hbm_ledger [--steps 20] [--top 40]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

FCFG = {  # bench.py's flagship config (true max shapes)
    "batch": 8, "height": 361, "width": 4416,
    "audio_height": 195, "audio_width": 808,
    "seq_len": 1268, "vocab": 6997, "attn_window": 100,
}
SMOKE = dict(FCFG, batch=1, height=32, width=64, audio_width=24, seq_len=12, vocab=31)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def build_step(remat: bool, cfg: dict, dev):
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

    hp = {
        "vocab_size": cfg["vocab"], "max_seq_len": cfg["seq_len"],
        "input_modality": "both", "mixer_type": "concat",
        "attn_window": cfg["attn_window"], "remat": remat,
        "use_flash_cross": True, "packed_stem": True,
    }
    model, _ = build_model(hp, device=dev, seed=0)
    b = cfg["batch"]
    ones = dict(dtype=torch.float32, device=dev)
    batch = {
        "xi": torch.ones((b, cfg["height"], cfg["width"], 1), **ones),
        "xi_hw": torch.tensor([[cfg["height"], cfg["width"]]] * b, dtype=torch.int32, device=dev),
        "xa": torch.ones((b, cfg["audio_height"], cfg["audio_width"], 1), **ones),
        "xa_hw": torch.tensor([[cfg["audio_height"], cfg["audio_width"]]] * b, dtype=torch.int32, device=dev),
        "y_in": torch.ones((b, cfg["seq_len"]), dtype=torch.int32, device=dev),
        "y_out": torch.ones((b, cfg["seq_len"]), dtype=torch.int32, device=dev),
    }
    state = TrainState.create(model, lr=1e-4)
    step = make_train_step(model, vocab_size=cfg["vocab"], bf16_compute=True, multimodal=True, device=dev)
    gen = torch.Generator(device=dev)

    def one():
        gen.manual_seed(1)  # JAX passes the same key to every step
        return step(state, batch, gen, "both")[1]

    return model, one


def measure(one, steps: int, batch: int) -> float:
    float(one())
    blocks = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = one()
        float(loss)
        blocks.append(steps * batch / (time.perf_counter() - t0))
    return statistics.median(blocks)


def main(argv=None) -> dict:
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
    from omr_a2s_multimodal_transformer_tpu_torch.tools.hlo_bytes import grouped, instruction_bytes
    from omr_a2s_multimodal_transformer_tpu_torch.tools.profile_flagship import flop_count

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--out", default="runs/hbm_ledger.json")
    p.add_argument("--skip_measure", action="store_true")
    p.add_argument("--smoke", action="store_true", help="tiny shapes")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = SMOKE if args.smoke else FCFG

    report = {"config": cfg, "variants": {}}
    for remat in (False, True):
        name = "remat" if remat else "noremat"
        model, one = build_step(remat, cfg, dev)
        float(one())  # the first step allocates Adam's moments
        groups = sorted(grouped(instruction_bytes(one, model)).items(), key=lambda kv: -kv[1])
        total = sum(b for _, b in groups)
        var = {
            "op_traffic_gb": round(total / 1e9, 2),
            "flops_tf": round(flop_count(one) / 1e12, 2),
            "top_sites": [
                {"site": n, "gb": round(b / 1e9, 3), "pct": round(100 * b / total, 1)}
                for n, b in groups[: args.top]
            ],
        }
        if not args.skip_measure:
            sps = measure(one, args.steps, cfg["batch"])
            var["samples_per_sec"] = round(sps, 2)
            var["ms_per_step"] = round(1000 * cfg["batch"] / sps, 1)
            var["roof_pct_at_3350GBps"] = round(100 * (total / PEAK_BYTES) / (cfg["batch"] / sps), 1)
        if dev.type == "cuda":
            var["peak_gib"] = round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2)
            torch.cuda.reset_peak_memory_stats(dev)
        report["variants"][name] = var
        print(json.dumps({k: v for k, v in var.items() if k != "top_sites"}), flush=True)
        for s in var["top_sites"][:20]:
            print(f"  {s['gb']:8.3f} GB {s['pct']:5.1f}%  {s['site']}", flush=True)
        del model, one
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {args.out}")
    return report


if __name__ == "__main__":
    main()
