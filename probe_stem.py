#!/usr/bin/env python3
"""Time the fused stem kernels K5a and K5b on one GPU, against another checkout's.

    python3 probe_stem.py                # from the root of a checkout
    python3 probe_stem.py --parent P     # also time the kernels of the checkout at P, in turns
    python3 probe_stem.py --out-dir D    # results to D (default build/stem_probe/)
    python3 probe_stem.py --stress S     # only random launches for S seconds (below)

Each part runs in a process of its own (probe_turns.py), on the port beside
this file or (--parent) on P's port with this checkout's chip_smoke.py, in
the order parent, this, this, parent, so that they are compared within one
call on one card. Each times, with chip_smoke.py's kernel_times (device ms
of the wrapper's kernels in a profiler trace), K5a (its walk or tile kernel
and the statistics sum) and K5b at the three stem blocks of chip_smoke.py
(b8, bf16, 361 x 4416 images), dropout 0.5 and none, with each kernel's
launch record. A last part, on this checkout alone, sweeps the bf16
kernels' launch at dropout 0.5: the rows a step (tile_h) and, at the
default rows, the block count (the plan's, and half, three quarters and
one and a half times it).
--stress S runs, in a process of its own with a time limit, random bf16
launches of this checkout's kernels at the three stem blocks (dropout 0.5
and none) for S seconds: rows a stage and block counts drawn (1 block to
1.5 times the plan's). Every launch must end, and its y2 or out must be
bit-equal to the default launch's: each output pixel is the same products
in the same order whatever the walk (out from the default launch's
statistics). The results go to <out-dir>/stem_probe.json and, as one JSON
object, to the last line of standard output. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from probe_turns import build, card, copy_port, run_in_turns  # noqa: E402

LIBS = ["fused_stem_k1", "fused_stem_k2"]
K5A, K5B = "K5a fused stem k1", "K5b fused stem k2"


def timed(cs, name: str, fn) -> dict:
    """Device ms of one call of fn (the wrapper of KERNELS' `name`) and the
    launch record of its longest kernel."""
    ms = cs.kernel_times(name, fn)[0]
    return dict(ms=ms, launch=cs.KERNEL_INFO.pop(name, None))


def block_args(cs, name, p, dev):
    (x, w1, b1, w2, b2, w3, b3), drop = cs.stem_inputs(name, dev, p)
    f_in, f_out, stride, _, _, h, wp = cs.STEM_BLOCKS[name]
    y2, stats = cs.fs.fused_stem_k1_cuda(x, w1, b1, w2, b2, drop, f_in=f_in)
    mean_inv = cs.fs.norm_from_stats(stats, h * wp * f_in, 1e-3)
    k1 = (x, w1, b1, w2, b2, drop)
    k2 = (y2, mean_inv, w3, b3, drop)
    return k1, k2, dict(f_in=f_in, f_out=f_out, stride=stride)


def blocks(cs, dev) -> dict:
    import torch

    out = {}
    for name in cs.STEM_BLOCKS:
        for p in (cs.STEM_DROPOUT, None):
            k1, k2, kw = block_args(cs, name, p, dev)
            out[f"{name} p={p}"] = dict(
                k5a=timed(cs, K5A, lambda: cs.fs.fused_stem_k1_cuda(*k1, f_in=kw["f_in"])),
                k5b=timed(cs, K5B, lambda: cs.fs.fused_stem_k2_cuda(*k2, **kw)))
            print(name, p, {k: round(v["ms"], 4) for k, v in out[f"{name} p={p}"].items()}, flush=True)
            del k1, k2
            torch.cuda.empty_cache()
    return out


def sweep(cs, dev) -> dict:
    """The bf16 launch at dropout 0.5: rows a step, consumers a block, blocks."""
    import torch

    fs = cs.fs
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, (f_in, f_out, stride, ci, co, h, wp) in cs.STEM_BLOCKS.items():
        k1, k2, kw = block_args(cs, name, cs.STEM_DROPOUT, dev)
        w = wp * f_in
        runs = []
        for kern, plan_fn, rows_all in (
                ("k5a", lambda **a: fs.k1_plan(8, h, w, ci, co, True, n_sm, **a), (1, 2, 4, 8)),
                ("k5b", lambda **a: fs.k2_plan(8, h, w, co, stride, f_out, True, n_sm, **a), (1, 2, 4, 8))):
            for rows in rows_all:
                try:
                    plan = plan_fn(tile_h=rows)
                except ValueError:
                    continue
                grids = [None] if rows != (fs.K1_ROWS if kern == "k5a" else fs.K2_ROWS)[co] \
                    else [None] + [max(1, int(plan.grid * f)) for f in (0.5, 0.75, 1.5)]
                for n_blocks in grids:
                    a = dict(tile=rows, n_blocks=n_blocks)
                    if kern == "k5a":
                        t = timed(cs, K5A, lambda: fs.fused_stem_k1_cuda(*k1, f_in=kw["f_in"], **a))
                    else:
                        t = timed(cs, K5B, lambda: fs.fused_stem_k2_cuda(*k2, **kw, **a))
                    used = plan_fn(tile_h=rows, n_blocks=n_blocks)
                    runs.append(dict(kernel=kern, rows=rows, n_blocks=n_blocks, plan=used._asdict(), **t))
                    print(name, kern, a, round(t["ms"], 4), used, flush=True)
        out[name] = runs
        del k1, k2
        torch.cuda.empty_cache()
    return out


def stress(cs, dev, seconds: float) -> dict:
    """Random launches for `seconds` (module note): {block p kernel: launches}."""
    import random
    import time

    import torch

    fs, rng = cs.fs, random.Random(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    refs = {}
    for name in cs.STEM_BLOCKS:
        for p in (cs.STEM_DROPOUT, None):
            k1, k2, kw = block_args(cs, name, p, dev)
            refs[(name, p)] = (k1, k2, kw, k2[0], fs.fused_stem_k2_cuda(*k2, **kw))
    counts, t_end = {}, time.time() + seconds
    while time.time() < t_end:
        (name, p), kern = rng.choice(list(refs)), rng.choice(("k5a", "k5b"))
        k1, k2, kw, y2_ref, out_ref = refs[(name, p)]
        f_in, f_out, stride, ci, co, h, wp = cs.STEM_BLOCKS[name]
        if kern == "k5a":
            plan_fn = lambda **a: fs.k1_plan(8, h, wp * f_in, ci, co, p is not None, n_sm, **a)  # noqa: E731
        else:
            plan_fn = lambda **a: fs.k2_plan(8, h, wp * f_in, co, stride, f_out, p is not None, n_sm, **a)  # noqa: E731
        try:
            plan = plan_fn(tile_h=rng.randint(1, 8))
        except ValueError:  # rows a stage the kernel does not take at this width
            continue
        a = dict(tile=plan.rows if kern == "k5a" else plan.rows // stride[0],
                 n_blocks=rng.randint(1, max(1, plan.grid * 3 // 2)))
        if kern == "k5a":
            got, ref = fs.fused_stem_k1_cuda(*k1, f_in=f_in, **a)[0], y2_ref
        else:
            got, ref = fs.fused_stem_k2_cuda(*k2, **kw, **a), out_ref
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} p={p} {kern} {a}: output differs from the default launch's")
        key = f"{name} p={p} {kern}"
        counts[key] = counts.get(key, 0) + 1
    print("stress launches", counts, flush=True)
    return dict(seconds=seconds, launches=counts, total=sum(counts.values()))


def child(mode: str, out_dir: Path, seconds: float = 0.0) -> dict:
    import torch

    import chip_smoke as cs

    if Path(cs.fs.__file__).resolve().parents[2] != ROOT:
        raise RuntimeError(f"imported {cs.fs.__file__}, not the port under {ROOT}")
    cs.OUT_DIR = out_dir / f"traces_{mode}"
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    if mode == "sweep":
        return dict(mode=mode, sweep=sweep(cs, dev))
    if mode == "stress":
        return dict(mode=mode, stress=stress(cs, dev, seconds))
    return dict(mode=mode, blocks=blocks(cs, dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "stem_probe")
    ap.add_argument("--parent", type=Path, default=None, help="a checkout whose kernels are timed in turns")
    ap.add_argument("--no-sweep", action="store_true", help="skip the launch sweep")
    ap.add_argument("--stress", type=float, default=None, help="only random launches for this many seconds")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out_dir = args.out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.child:
        res = child(args.child, out_dir, args.stress or 0.0)
        (out_dir / f"{args.child}.json").write_text(json.dumps(res, indent=1))
        return 0
    results = {"card": card()}
    print(results["card"], flush=True)
    if args.stress:
        build({ROOT: LIBS})
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", "stress", "--stress",
                        str(args.stress), "--out-dir", str(out_dir)], cwd=ROOT, timeout=args.stress + 600, check=True)
        results["stress"] = json.loads((out_dir / "stress.json").read_text())["stress"]
        (out_dir / "stem_probe.json").write_text(json.dumps(results, indent=1))
        print(json.dumps(results))
        return 0
    roots = {"this": ROOT, "sweep": ROOT}
    if args.parent:
        roots["parent"] = copy_port(args.parent.resolve(), ROOT / "build" / "stem_probe_roots" / "parent",
                                    Path(__file__).name)
    build({root: LIBS for root in {roots[k] for k in roots}})
    order = ["parent", "this", "this", "parent"] if args.parent else ["this"]
    if not args.no_sweep:
        order.append("sweep")
    results["runs"] = [dict(tag=f"{name}_{i}", **res)
                       for i, (name, res) in enumerate(zip(order, run_in_turns(Path(__file__).name, order, roots,
                                                                               out_dir)))]
    (out_dir / "stem_probe.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
