#!/usr/bin/env python3
"""Probe the any-dtype legacy flash kernels (LA fwd, LA dq, LA dk/dv) on one GPU.

    python3 probe_legacy_any.py                 # from the root of a checkout
    python3 probe_legacy_any.py --out-dir D     # results to D (default build/legacy_any_probe/)
    python3 probe_legacy_any.py --parent P      # also time the LA fwd of the checkout at P

1. Float32 schemes. LA runs its float32 products as three TF32 passes
   (csrc/legacy_flash_any_bwd.cuh: split_tf32, mma_3xtf32, which the
   forward and both backward kernels use). The probe writes copies of the
   port under build/legacy_any_probe/<scheme>/ whose split is a cheaper
   scheme:
   - tf32x1: one pass, operands rounded to nearest TF32;
   - bf16x3: big and small parts rounded to nearest bf16, three passes
     (bf16 values are exact in TF32, so the TF32 instruction forms
     bf16x3's products and sums; the tensor cores run bf16 at twice the
     TF32 rate).
   For the port's own scheme (tf32x3) and each copy, in a process of its
   own, it runs chip_smoke.py's float32 checks of LA (B 2, H 4, 256 x
   1,024 at D 64 non-causal and window 100 and at D 192; the legacy cross
   shape at D 64) and prints max |kernel - plain| / max |plain| of o, dq,
   dk and dv beside chip_smoke.ANY_TOL, and the cross shape's device ms of
   the three kernels.
2. LA against the bf16 tensor-core kernels in bf16 at the cross shape, D
   64 and 128, on the same inputs: LA fwd against L1 and L2a (on K1's
   TMA/wgmma block), LA dq and dk/dv against L2b/L2c (on K3a's and K3b's):
   device ms and launch records of each, their errors against the plain
   version, the forward's max |LA - L1/L2a| and whether the backward's
   outputs are bit-equal, and SDPA's forward and backward device ms.
3. With --parent P (a checkout of another commit, e.g. a git archive of
   the parent), chip_smoke.any_cross_fwd on P's port in a process of its
   own: that LA fwd at the cross shape in float32 D 64, float16 D 64 and
   bf16 D 192, against the plain version, with its device ms.

The results go to <out-dir>/legacy_any_probe.json and, as one JSON object,
to the last line of standard output. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
from probe_turns import PORT, build, card, copy_port, run_in_turns  # noqa: E402

LA_LIBS = ["legacy_flash_any_fwd", "legacy_flash_any_dq", "legacy_flash_any_dkv"]
BF16_LIBS = ["legacy_flash_fwd", "legacy_flash_dq", "legacy_flash_dkv"]
SPLIT = re.compile(r"(__device__ __forceinline__ void split_tf32\(float x, uint32_t& big, uint32_t& small\) \{\n)"
                   r".*?\n\}", re.S)
MMA3 = re.compile(r"(__device__ __forceinline__ void mma_3xtf32\([^{]*\{\n).*?\n\}", re.S)
SCHEMES = {  # name -> (body of split_tf32, body of mma_3xtf32 or None to keep three passes)
    "tf32x1": ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n  small = 0u;",
               "  mma_tf32(c, ab, bb);"),
    "bf16x3": ("  const uint32_t u = __float_as_uint(x);\n"
               "  big = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;\n"
               "  const uint32_t s = __float_as_uint(x - __uint_as_float(big));\n"
               "  small = (s + 0x7fffu + ((s >> 16) & 1u)) & 0xffff0000u;", None),
}


def write_scheme(name: str, dest: Path) -> Path:
    """A copy of the port and of the scripts under dest/name whose float32
    split is scheme `name`."""
    root = copy_port(ROOT, dest / name, Path(__file__).name)
    header = root / PORT / "csrc" / "legacy_flash_any_bwd.cuh"
    split, mma = SCHEMES[name]
    text, n = SPLIT.subn(lambda m: m.group(1) + split + "\n}", header.read_text())
    if mma:
        text, m = MMA3.subn(lambda m: m.group(1) + mma + "\n}", text)
        n += m - 1
    if n != 1:
        raise RuntimeError(f"{header}: split_tf32 / mma_3xtf32 not found")
    header.write_text(text)
    return root


def rel_err(a, r) -> float:
    return float((a.float() - r.float()).abs().max()) / float(r.float().abs().max())


def float32_checks(cs, dev) -> dict:
    """Part 1 for the port this process imported: errors of o, dq, dk, dv
    and the cross shape's device ms."""
    import torch

    fb, fl = cs.fb, cs.fl

    def any_outputs(q, k, v, do, kv_len, kv_valid, causal, window):
        o, lse = fb.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, causal, window)
        bargs = (q, k, v, kv_len, kv_valid, do, lse, fb.attention_delta(do, o), causal, window)
        return (o, fb.legacy_any_dq_cuda(*bargs), *fb.legacy_any_dkv_cuda(*bargs)), bargs

    def plain_outputs(q, k, v, do, kv_len, kv_valid, causal, window):
        refs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o, _ = fl.attention_plain(*refs, kv_len, kv_valid, causal, window)
        return (o.detach(), *torch.autograd.grad(o, refs, do))

    errs = {}
    for d, causal in ((64, False), (64, True), (192, False)):
        window = cs.WINDOW if causal else -1
        q, k, v, do, _, kv_valid = cs.any_inputs(dev, torch.float32, d, causal)
        kv_len = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32, device=dev)
        got, _ = any_outputs(q, k, v, do, kv_len, kv_valid, causal, window)
        ref = plain_outputs(q, k, v, do, kv_len, kv_valid, causal, window)
        errs[f"B 2 H 4 256x1024 D {d} {'window 100' if causal else 'non-causal'}"] = [
            rel_err(a, r) for a, r in zip(got, ref)]
    g = torch.Generator(device=dev).manual_seed(9)  # chip_smoke.any_cross's float32 D 64 inputs
    kv_valid = cs.memory_valid_from_hw(cs.ragged_hw(cs.B, dev), cs.GRID_H, cs.GRID_W).contiguous()
    kv_len = torch.full((cs.B,), cs.LK, dtype=torch.int32, device=dev)
    q, k, v, do = (torch.randn((cs.B, cs.HEADS, n, 64), generator=g, device=dev) for n in (cs.LQ, cs.LK, cs.LK, cs.LQ))
    got, bargs = any_outputs(q, k, v, do, kv_len, kv_valid, False, -1)
    ref = plain_outputs(q, k, v, do, kv_len, kv_valid, False, -1)
    errs["cross D 64"] = [rel_err(a, r) for a, r in zip(got, ref)]
    del got, ref
    torch.cuda.empty_cache()
    ms = {"fwd": cs.kernel_times(cs.LEGACY_ANY[0], lambda: fl.legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, False,
                                                                                  -1, with_lse=True))[0],
          "dq": cs.kernel_times(cs.LEGACY_ANY[1], lambda: fb.legacy_any_dq_cuda(*bargs))[0],
          "dk/dv": cs.kernel_times(cs.LEGACY_ANY[2], lambda: fb.legacy_any_dkv_cuda(*bargs))[0]}
    worst = max(max(e) for e in errs.values())
    return {"errors (o, dq, dk, dv) / max |plain|": errs, "worst": worst, "passes ANY_TOL": worst <= cs.ANY_TOL,
            "cross float32 D 64 device ms": ms}


def bf16_routes(cs, dev) -> dict:
    """Part 2: LA against L1, L2a and L2b/L2c on the same bf16 inputs at
    the cross shape."""
    import torch

    fb, fl = cs.fb, cs.fl
    kv_valid = cs.memory_valid_from_hw(cs.ragged_hw(cs.B, dev), cs.GRID_H, cs.GRID_W).contiguous()
    kv_len = torch.full((cs.B,), cs.LK, dtype=torch.int32, device=dev)
    kv_len1 = kv_valid.sum(1).to(torch.int32)  # L1's prefix of the same counts
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for d in (64, 128):
        g = torch.Generator(device=dev).manual_seed(10 + d)
        q, k, v, do = (torch.randn((cs.B, cs.HEADS, n, d), generator=g, device=dev).bfloat16()
                       for n in (cs.LQ, cs.LK, cs.LK, cs.LQ))
        fwd = {"LA fwd (L2a)": lambda: fl.legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, False, -1, with_lse=True),
               "L2a fwd": lambda: fb.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid),
               "LA fwd (L1)": lambda: fl.legacy_any_fwd_cuda(q, k, v, kv_len1, None, False, -1, with_lse=False),
               "L1 fwd": lambda: (fl.legacy_fwd_cuda(q, k, v, kv_len1), None)}
        got = {key: fn() for key, fn in fwd.items()}
        o, lse = got["L2a fwd"]
        o_p, lse_p = fl.attention_plain(q, k, v, kv_len, kv_valid)
        o1_p = fl.flash_attention_plain(q, k, v, kv_len1)
        row = {"LA fwd error (L2a o, lse; L1 o)": [rel_err(got["LA fwd (L2a)"][0], o_p),
                                                   float((got["LA fwd (L2a)"][1] - lse_p).abs().max()),
                                                   rel_err(got["LA fwd (L1)"][0], o1_p)],
               "L1/L2a error (L2a o, lse; L1 o)": [rel_err(o, o_p), float((lse - lse_p).abs().max()),
                                                   rel_err(got["L1 fwd"][0], o1_p)],
               # L1/L2a merge key chunks by lse, LA walks every key in one block: max |LA - L1/L2a|
               "LA fwd - L2a (o, lse), L1 (o) max abs": [
                   float((got["LA fwd (L2a)"][0].float() - o.float()).abs().max()),
                   float((got["LA fwd (L2a)"][1] - lse).abs().max()),
                   float((got["LA fwd (L1)"][0].float() - got["L1 fwd"][0].float()).abs().max())]}
        del got, o_p, lse_p, o1_p
        bargs = (q, k, v, kv_len, kv_valid, do, lse, fb.attention_delta(do, o), False, -1)
        la = (fb.legacy_any_dq_cuda(*bargs), *fb.legacy_any_dkv_cuda(*bargs))
        l2 = (fb.legacy_dq_cuda(*bargs), *fb.legacy_dkv_cuda(*bargs))
        refs = [t.detach().clone().float().requires_grad_() for t in (q, k, v)]
        o_p, _ = fl.attention_plain(*refs, kv_len, kv_valid)
        ref = torch.autograd.grad(o_p, refs, do.float())
        row |= {"LA error (dq, dk, dv)": [rel_err(a, r) for a, r in zip(la, ref)],
                "L2 error (dq, dk, dv)": [rel_err(a, r) for a, r in zip(l2, ref)],
                "LA - L2 max abs (dq, dk, dv)": [float((a.float() - b.float()).abs().max()) for a, b in zip(la, l2)],
                "LA bit-equal to L2 (dq, dk, dv)": [torch.equal(a, b) for a, b in zip(la, l2)]}
        del la, l2, refs, o_p, ref
        timed = (("L2a fwd", "L2a legacy flash fwd lse", fwd["L2a fwd"]),
                 ("LA fwd (L2a)", cs.LEGACY_ANY[0], fwd["LA fwd (L2a)"]),
                 ("L1 fwd", "L1 legacy flash fwd", fwd["L1 fwd"]),
                 ("LA fwd (L1)", cs.LEGACY_ANY[0], fwd["LA fwd (L1)"]),
                 ("L2b dq", "L2b legacy flash dq", lambda: fb.legacy_dq_cuda(*bargs)),
                 ("LA dq", cs.LEGACY_ANY[1], lambda: fb.legacy_any_dq_cuda(*bargs)),
                 ("L2c dk/dv", "L2c legacy flash dk/dv", lambda: fb.legacy_dkv_cuda(*bargs)),
                 ("LA dk/dv", cs.LEGACY_ANY[2], lambda: fb.legacy_any_dkv_cuda(*bargs)))
        per_launch = {"L2b legacy flash dq": cs.l2b_kernels(q, k, False)}  # L2b's chunk kernel and merge
        for rep in ("", " again"):  # each twice, interleaved
            for key, name, fn in timed:
                row[key + rep] = cs.kernel_times(name, fn, per_launch=per_launch.get(name))[0]
                row[key + " launch"] = cs.KERNEL_INFO.pop(name, {})
        row["SDPA fwd device ms"] = cs.device_ms(lambda: sdpa(q, k, v, attn_mask=kv_valid[:, None, None, :]))
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o_s = sdpa(qr, kr, vr, attn_mask=kv_valid[:, None, None, :])
        row["SDPA bwd device ms"] = cs.device_ms(lambda: torch.autograd.grad(o_s, (qr, kr, vr), do, retain_graph=True))
        out[f"bf16 D {d}"] = row
        print(f"[bf16 D {d}] " + json.dumps({k_: v_ for k_, v_ in row.items() if "launch" not in k_}), flush=True)
        del q, k, v, do, o, lse, bargs, qr, kr, vr, o_s, fwd
        torch.cuda.empty_cache()
    return out


def parent_forward(cs, dev) -> dict:
    """Part 3, in a process that imported another checkout's port:
    chip_smoke.any_cross_fwd on the any_cross inputs of each case."""
    import torch

    g = torch.Generator(device=dev).manual_seed(9)
    kv_valid = cs.memory_valid_from_hw(cs.ragged_hw(cs.B, dev), cs.GRID_H, cs.GRID_W).contiguous()
    n_keys = int(kv_valid.sum())
    out = {}
    for dtype, d in cs.ANY_CROSS:
        tag = f"{str(dtype)[6:]} D {d}"
        q, k, v, _ = (torch.randn((cs.B, cs.HEADS, n, d), generator=g, device=dev).to(dtype)
                      for n in (cs.LQ, cs.LK, cs.LK, cs.LQ))
        work = cs.any_work(cs.B, cs.HEADS, cs.LQ, cs.LK, d, n_keys, cs.HEADS * cs.LQ * n_keys, q.element_size())
        f32 = dtype == torch.float32
        out[tag] = cs.any_cross_fwd(q, k, v, kv_valid, tag, cs.ANY_TOL if f32 else cs.KERNEL_TOL,
                                    cs.PEAK_F32_ACCURATE_FLOPS if f32 else cs.PEAK_BF16_FLOPS, work)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def child(mode: str, out_dir: Path) -> dict:
    """Run one part on the port beside this file: a scheme's part 1 (and
    part 2 for the port's own, tf32x3), or part 3 ("parent")."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    if Path(cs.fb.__file__).resolve().parents[3] != ROOT:
        raise RuntimeError(f"imported {cs.fb.__file__}, not the port under {ROOT}")
    cs.OUT_DIR = out_dir / f"traces_{mode}"
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    if mode == "parent":
        return {"LA fwd, cross shape": parent_forward(cs, dev)}
    res = {"scheme": mode, **float32_checks(cs, dev)}
    print(f"[{mode}] " + json.dumps(res), flush=True)
    if mode == "tf32x3":
        res["bf16 routes"] = bf16_routes(cs, dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "legacy_any_probe")
    ap.add_argument("--parent", type=Path, default=None, help="a checkout whose LA fwd part 3 times")
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
    roots = {"tf32x3": ROOT, **{name: write_scheme(name, out_dir / "schemes") for name in SCHEMES}}
    if args.parent:  # the parent's port beside this checkout's chip_smoke.py, whose any_cross_fwd drives it
        roots["parent"] = copy_port(args.parent.resolve(), out_dir / "schemes" / "parent", Path(__file__).name)
    build({root: (LA_LIBS[:1] if name == "parent" else LA_LIBS) + (BF16_LIBS if name == "tf32x3" else [])
           for name, root in roots.items()})
    results |= zip(roots, run_in_turns(Path(__file__).name, list(roots), roots, out_dir))
    (out_dir / "legacy_any_probe.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
