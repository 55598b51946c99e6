#!/usr/bin/env python3
"""Time the split flash backward (K3a dq, K3b dk/dv) on one GPU, against another checkout's.

    python3 probe_split_bwd.py                # from the root of a checkout
    python3 probe_split_bwd.py --parent P     # also time the K3a/K3b of the checkout at P, in turns
    python3 probe_split_bwd.py --out-dir D    # results to D (default build/split_bwd_probe/)

Each part runs in a process of its own (probe_turns.py), on the port beside
this file or (--parent) on P's port with this checkout's chip_smoke.py, in
the order parent, this, this, parent, so that they are compared within one
call on one card. Each times, with chip_smoke.py's kernel_times (device ms
of the wrapper's kernels in a profiler trace) and device_ms:
- the flagship cross shape of chip_smoke.py (B 8, Lq 1268, Lk 12,696, the
  images' kv_valid, bf16), the split backward of a merged_bwd=False call
  at dropout 0.1 and 0: K3a (its chunk kernel and merge), K3b, K2 (whose
  block K3b shares) and SDPA's backward on the same tensors and boolean
  mask at the same rate, with each kernel's launch record;
- the paper's self-attention shape (B 8, L 1268, 4 x 64 heads, ragged
  targets, 128/512 blocks), window 100 at dropout 0.1 and 0 and full causal
  at 0.1: K3a and K3b.
The results go to <out-dir>/split_bwd_probe.json and, as one JSON object,
to the last line of standard output. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from probe_turns import build, card, copy_port, run_in_turns  # noqa: E402

LIBS = ["flash_fwd", "flash_bwd", "flash_dq", "flash_dkv"]


def timed(cs, name: str, fn, per_launch: int = 1) -> dict:
    """Device ms of one call of fn (the wrapper of KERNELS' `name`) and the
    launch record of its longest kernel."""
    ms = cs.kernel_times(name, fn, per_launch=per_launch)[0]
    return dict(ms=ms, launch=cs.KERNEL_INFO.pop(name, None))


def cross(cs, fp, dev) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    kv_valid = cs.memory_valid_from_hw(cs.ragged_hw(cs.B, dev), cs.GRID_H, cs.GRID_W).contiguous()
    kv_len = torch.full((cs.B,), cs.LK, dtype=torch.int32, device=dev)
    seed = torch.tensor([20240611], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(cs.LQ, cs.LK)
    q, k, v, do = (torch.randn((cs.B, n, cs.HEADS * 64), generator=g, device=dev).to(torch.bfloat16)
                   for n in (cs.LQ, cs.LK, cs.LK, cs.LQ))
    qs, ks, vs = (t.view(t.shape[0], t.shape[1], cs.HEADS, 64).transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    do_s = do.view(cs.B, cs.LQ, cs.HEADS, 64).transpose(1, 2)
    # K3a's chunk kernel and merge, or its one kernel where the port has no key split
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = fp.dq_splits(cs.B, cs.HEADS, cs.LQ, cs.LK, n_sm)[0] if hasattr(fp, "dq_splits") else 1
    out = {}
    for rate in (0.1, 0.0):
        o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, cs.HEADS, bq, bk)
        delta = fp.attention_delta(do, o, cs.HEADS)
        args = (q, k, v, kv_len, kv_valid, seed, do, lse, delta, rate, cs.HEADS, bq, bk, False, -1)
        r = dict(k3a=timed(cs, "K3a flash dq", lambda: fp.flash_dq_cuda(*args), 1 if n_split == 1 else 2),
                 k3b=timed(cs, "K3b flash dk/dv", lambda: fp.flash_dkv_cuda(*args)),
                 k2=timed(cs, "K2 flash bwd", lambda: fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do,
                                                                       rate, cs.HEADS, bq, bk)))
        o_s = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=kv_valid[:, None, None, :],
                                                               dropout_p=rate)
        r["sdpa_bwd_ms"] = cs.device_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True))
        del o_s
        print(f"[cross dropout {rate}] " + json.dumps(r), flush=True)
        out[str(rate)] = r
        del o, lse, delta, args
        torch.cuda.empty_cache()
    return out


def self_shape(cs, fp, dev) -> dict:
    import torch

    g = torch.Generator(device=dev).manual_seed(1)
    bq, bk = fp.mask_geometry(cs.LQ, cs.LQ, *cs.OP_BLOCKS)
    lengths = torch.tensor(cs.TARGET_LENGTHS, device=dev)
    kv_valid = (torch.arange(cs.LQ, device=dev)[None, :] < lengths[:, None]).contiguous()
    kv_len = torch.full((cs.B,), cs.LQ, dtype=torch.int32, device=dev)
    seed = torch.tensor([1268100], dtype=torch.int32, device=dev)
    q, k, v, do = (torch.randn((cs.B, cs.LQ, cs.HEADS * 64), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    do = do * kv_valid[:, :, None]
    out = {}
    for window, rate in ((cs.WINDOW, 0.1), (cs.WINDOW, 0.0), (-1, 0.1)):
        o, lse = fp.flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, rate, cs.HEADS, bq, bk, window)
        args = (q, k, v, kv_len, kv_valid, seed, do, lse, fp.attention_delta(do, o, cs.HEADS), rate, cs.HEADS, bq,
                bk, True, window)
        out[f"window {window}, dropout {rate}"] = dict(
            k3a=timed(cs, "K3a flash dq", lambda: fp.flash_dq_cuda(*args)),
            k3b=timed(cs, "K3b flash dk/dv", lambda: fp.flash_dkv_cuda(*args)))
    print("[self] " + json.dumps(out), flush=True)
    return out


def child(mode: str, out_dir: Path) -> dict:
    import torch

    import chip_smoke as cs

    fp = cs.fp
    if Path(fp.__file__).resolve().parents[2] != ROOT:
        raise RuntimeError(f"imported {fp.__file__}, not the port under {ROOT}")
    cs.OUT_DIR = out_dir / f"traces_{mode}"
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    return dict(mode=mode, cross=cross(cs, fp, dev), self=self_shape(cs, fp, dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "split_bwd_probe")
    ap.add_argument("--parent", type=Path, default=None, help="a checkout whose K3a/K3b are timed in turns")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out_dir = args.out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.child:
        res = child(args.child, out_dir)
        (out_dir / f"{args.child}.json").write_text(json.dumps(res, indent=1))
        return 0
    results = {"card": card()}
    print(results["card"], flush=True)
    roots = {"this": ROOT}
    if args.parent:
        roots["parent"] = copy_port(args.parent.resolve(), ROOT / "build" / "split_bwd_probe_roots" / "parent",
                                    Path(__file__).name)
    build({root: LIBS for root in roots.values()})
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    results["runs"] = [dict(tag=f"{name}_{i}", **res)
                       for i, (name, res) in enumerate(zip(order, run_in_turns(Path(__file__).name, order, roots,
                                                                               out_dir)))]
    (out_dir / "split_bwd_probe.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
