#!/usr/bin/env python3
"""Time the split flash backward (K3a dq, K3b dk/dv), K1, K1c, K4 and the per-head L1-L2c on one GPU, against another checkout's.

    python3 probe_split_bwd.py                # from the root of a checkout
    python3 probe_split_bwd.py --parent P     # also time the kernels of the checkout at P, in turns
    python3 probe_split_bwd.py --out-dir D    # results to D (default build/split_bwd_probe/)
    python3 probe_split_bwd.py --parent P --variant V --parts self,keep_mask
                                              # also the checkout at V, only the self shape and K4

Each run is a process of its own (probe_turns.py), on the port beside
this file or (--parent, --variant) on P's or V's port with this checkout's
chip_smoke.py, in the order parent, this, the variants, and back (parent,
this, this, parent without variants), so that they are compared within
one call on one card. Each times, with chip_smoke.py's kernel_times (device ms
of the wrapper's kernels in a profiler trace) and device_ms:
- the flagship cross shape of chip_smoke.py (B 8, Lq 1268, Lk 12,696, the
  images' kv_valid, bf16), the split backward of a merged_bwd=False call
  at dropout 0.1 and 0: K3a (its chunk kernel and merge), K3b, K2 (whose
  block K3b shares), K1 (the forward, its chunk kernel and merge) and SDPA's
  backward on the same tensors and boolean mask at the same rate, with each
  kernel's launch record;
- the paper's self-attention shape (B 8, L 1268, 4 x 64 heads, ragged
  targets, 128/512 blocks), window 100 at dropout 0.1 and 0 and full causal
  at 0.1: K1c (the causal forward) and K3a and K3b given its lse, and
  K1c's hash instructions a score by pipe, from the SASS of the library,
  with the floor they set on the logic pipe over the pairs a query sees;
- K4, the keep-mask probe, at the cross shape's mask [8, 4, 1280, 14336]
  (the decoder's 128/2048 blocks) at dropout 0.1 and 0.5, beside the
  device time of filling the same bool tensor (the card's write floor for
  those bytes), and K4's instructions in its loop by pipe, from the SASS of
  the library (cuobjdump), with the floor they set on the logic pipe;
- the per-head legacy family (tools/legacy_flash: [B, H, L, D] bf16, no
  dropout), L1 and L2a (the forward: its chunk kernel and merge where it
  splits the keys; L2a also at 1-8 chunks), L2b (dq, likewise) and L2c
  (dk, dv), at the cross shape with 4 x 64 and with 2 x 128 heads and at
  the self shape (4 x 64, window 100, the targets as kv_valid for L2 and
  kv_len for L1), with SDPA's forward and backward on the same tensors and
  boolean mask.
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

# the kernel libraries each part builds
PART_LIBS = {"cross": ("flash_fwd", "flash_bwd", "flash_dq", "flash_dkv"),
             "self": ("flash_fwd", "flash_dq", "flash_dkv"),
             "keep_mask": ("keep_mask",),
             "legacy": ("legacy_flash_fwd", "legacy_flash_dq", "legacy_flash_dkv")}
# the pipe of each SASS opcode in K4's loop: the INT32 / logic pipe (64 lanes an SM on the H100), the multiply
# (FMA) pipe, or neither (stores, branches, uniform-datapath and constant loads)
LOGIC_OPS = ("LOP3", "SHF", "IADD3", "ISETP", "SEL", "VIADD", "LEA", "PRMT", "PLOP3", "IABS", "MOV")
FMA_OPS = ("IMAD",)


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
        fwd = lambda: fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, rate, cs.HEADS, bq, bk)  # noqa: E731
        o, lse = fwd()
        delta = fp.attention_delta(do, o, cs.HEADS)
        args = (q, k, v, kv_len, kv_valid, seed, do, lse, delta, rate, cs.HEADS, bq, bk, False, -1)
        r = dict(k3a=timed(cs, "K3a flash dq", lambda: fp.flash_dq_cuda(*args), 1 if n_split == 1 else 2),
                 k3b=timed(cs, "K3b flash dk/dv", lambda: fp.flash_dkv_cuda(*args)),
                 k2=timed(cs, "K2 flash bwd", lambda: fp.flash_bwd_cuda(q, k, v, kv_len, kv_valid, seed, o, lse, do,
                                                                       rate, cs.HEADS, bq, bk)),
                 k1=timed(cs, "K1 flash fwd", fwd, 2))
        o_s = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=kv_valid[:, None, None, :],
                                                               dropout_p=rate)
        r["sdpa_bwd_ms"] = cs.device_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do_s, retain_graph=True))
        del o_s
        print(f"[cross dropout {rate}] " + json.dumps(r), flush=True)
        out[str(rate)] = r
        del o, lse, delta, args, fwd
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
        fwd = lambda: fp.flash_fwd_causal_cuda(q, k, v, kv_len, kv_valid, seed, rate, cs.HEADS, bq, bk, window)  # noqa
        o, lse = fwd()
        args = (q, k, v, kv_len, kv_valid, seed, do, lse, fp.attention_delta(do, o, cs.HEADS), rate, cs.HEADS, bq,
                bk, True, window)
        out[f"window {window}, dropout {rate}"] = dict(
            k1c=timed(cs, "K1c flash fwd causal", fwd),
            k3a=timed(cs, "K3a flash dq", lambda: fp.flash_dq_cuda(*args)),
            k3b=timed(cs, "K3b flash dk/dv", lambda: fp.flash_dkv_cuda(*args)))
    # K1c's hash from its SASS, and the floor its logic instructions set over the pairs a query sees
    from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build

    hash_ = sass_hash(cuda_build._lib_path("flash_fwd"), cs.KERNELS["K1c flash fwd causal"][3])
    out["k1c_hash"] = dict(sass=hash_, max_sm_mhz=max_sm_mhz())
    for window in (cs.WINDOW, -1):
        pairs = cs.HEADS * int(cs.band_mask(lengths, window, dev).sum())
        out["k1c_hash"][f"window {window}"] = dict(
            pairs=pairs, logic_floor_ms=hash_.get("logic_a_score", 0) * pairs / logic_rate(dev, max_sm_mhz()) * 1e3)
    print("[self] " + json.dumps(out), flush=True)
    return out


def sass_functions(lib: Path, symbol: str) -> list:
    """The SASS of each function of library `lib` whose name holds `symbol`
    (cuobjdump), as lists of (address, opcode, branch target or None,
    operands)."""
    import re
    import subprocess

    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    funcs = []
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if symbol not in func.split("\n")[0]:
            continue
        ins = []
        for line in func.split("\n"):
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*);", line)
            if m:
                t = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", m.group(2) + m.group(3))
                ins.append((int(m.group(1), 16), m.group(2), int(t.group(1), 16) if t else None, m.group(3)))
        funcs.append(ins)
    return funcs


def by_pipe(ops: list) -> dict:
    """Opcode counts of `ops`, and their sums on the logic and multiply pipes."""
    counts = {o: ops.count(o) for o in sorted(set(ops))}
    logic = sum(n for o, n in counts.items() if o.startswith(LOGIC_OPS))
    fma = sum(n for o, n in counts.items() if o.startswith(FMA_OPS))
    return dict(opcodes=counts, logic=logic, fma=fma, other=sum(counts.values()) - logic - fma)


def sass_loop(lib: Path, symbol: str) -> dict:
    """Opcode counts of the loop around the 16-byte store (STG.E.128) of
    `symbol` in library `lib`: from the target of the loop's backward branch
    to the first branch after the store (the path of a row that starts no
    mask q-block), or the whole function where there is no loop; of the
    function's stores, the one whose path holds the most instructions a
    store (the hash's, not the rate-0 path's)."""
    best = []
    for ins in sass_functions(lib, symbol):
        for i, (addr, op, _, _) in enumerate(ins):
            if op != "STG":
                continue
            back = [t for a, o, t, _ in ins[i:] if o == "BRA" and t is not None and t <= addr]
            lo = back[0] if back else ins[0][0]
            hi = next((a for a, o, _, _ in ins[i:] if o == "BRA"), ins[-1][0])
            ops = [o for a, o, _, _ in ins if lo <= a <= hi]
            if not best or len(ops) / ops.count("STG") > len(best) / best.count("STG"):
                best = ops
    return by_pipe(best)


# the finalizer's first multiplier (flash_common.cuh FMIX_MUL1), as SASS may print it
FMIX_MUL1 = ("0x85ebca6b", "-0x7a143595")


def sass_hash(lib: Path, symbol: str) -> dict:
    """The keep-mask hash of a flash kernel's consumer in its SASS: the
    straight-line code from the last branch before the first multiply by
    FMIX_MUL1 to the first branch after the last (the dropout path of a key
    tile: the hash, and the exponentials and sums it is interleaved with),
    its opcodes by pipe, and a score's share (one FMIX_MUL1 multiply a
    score): the integer instructions a score, with a tile's share of its
    row terms."""
    ins = sass_functions(lib, symbol)[0]
    at = [a for a, o, _, x in ins if o.startswith("IMAD") and any(c in x.lower() for c in FMIX_MUL1)]
    if not at:
        return dict(error=f"no multiply by FMIX_MUL1 in {symbol}")
    lo = max((a for a, o, _, _ in ins if o == "BRA" and a < at[0]), default=ins[0][0])
    hi = min((a for a, o, _, _ in ins if o == "BRA" and a > at[-1]), default=ins[-1][0])
    r = by_pipe([o for a, o, _, _ in ins if lo < a < hi])
    r.update(scores=len(at), logic_a_score=r["logic"] / len(at), fma_a_score=r["fma"] / len(at))
    return r


def max_sm_mhz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm)."""
    import subprocess

    return float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                capture_output=True, text=True).stdout.split()[0])


def logic_rate(dev, mhz: float) -> float:
    """Logic-pipe instructions a second: 64 lanes an SM at `mhz`."""
    import torch

    return 64 * torch.cuda.get_device_properties(dev).multi_processor_count * mhz * 1e6


def keep_mask(cs, fp, dev) -> dict:
    """K4 at the cross shape's mask at dropout 0.1 and 0.5, the fill floor of
    the same bytes and K4's loop from its SASS, with the floor its logic
    instructions set (16 bytes a store, 64 logic lanes an SM at the card's
    maximum SM clock)."""
    import torch

    from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build

    seed = torch.tensor([20240611], dtype=torch.int32, device=dev)
    bq, bk = fp.mask_geometry(cs.LQ, cs.LK)
    lq_p, lk_p = -(-cs.LQ // bq) * bq, -(-cs.LK // bk) * bk
    n_bytes = cs.B * cs.HEADS * lq_p * lk_p
    out = {rate: timed(cs, "K4 keep mask", lambda rate=rate: fp.keep_mask_cuda(seed, cs.B, cs.HEADS, lq_p, lk_p, rate,
                                                                            bq, bk))
           for rate in (0.1, 0.5)}
    mask = torch.empty((cs.B, cs.HEADS, lq_p, lk_p), dtype=torch.bool, device=dev)
    fill_ms = cs.device_ms(lambda: mask.fill_(True), reps=10)
    del mask
    loop = sass_loop(cuda_build._lib_path("keep_mask"), "keep_mask_kernel")
    mhz = max_sm_mhz()
    logic_floor_ms = loop["logic"] / (16 * loop["opcodes"]["STG"]) * n_bytes / logic_rate(dev, mhz) * 1e3
    r = dict(shape=[cs.B, cs.HEADS, lq_p, lk_p], k4={str(k): v for k, v in out.items()}, fill_ms=fill_ms,
             bytes_bound_ms=n_bytes / cs.PEAK_BYTES * 1e3, sass_loop=loop, max_sm_mhz=mhz,
             logic_floor_ms=logic_floor_ms)
    print("[keep mask] " + json.dumps(r), flush=True)
    return r


def legacy(cs, dev) -> dict:
    """L1 and L2a, then L2b and L2c given L2a's lse, at the cross shape (4 x
    64 and 2 x 128 heads; L2: the images' kv_valid, L1: kv_len of the same
    counts) and the self shape (4 x 64, window 100, the targets as kv_valid
    for L2 and as kv_len for L1), beside SDPA's forward and backward
    (device ms). Where the port splits the forward's keys: L2a at each
    split of 1-8 chunks."""
    import torch

    fb, fl = cs.fb, cs.fl
    g = torch.Generator(device=dev).manual_seed(2)
    lengths = torch.tensor(cs.TARGET_LENGTHS, dtype=torch.int32, device=dev)
    valid_cross = cs.memory_valid_from_hw(cs.ragged_hw(cs.B, dev), cs.GRID_H, cs.GRID_W).contiguous()
    valid_self = (torch.arange(cs.LQ, device=dev)[None, :] < lengths[:, None]).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    split_fwd = hasattr(fl, "legacy_fwd_splits")
    if not split_fwd:  # a port whose L1 and L2a are one kernel each, named as before the key split
        for name, symbol in (("L1 legacy flash fwd", "lf_fwd_kernel"), ("L2a legacy flash fwd lse", "lf_fwd_lse_kernel")):
            cs.KERNELS[name] = (*cs.KERNELS[name][:3], symbol, 1)
    out = {}
    for tag, heads, d, lk, kv_valid, kv_len1, causal, window in (
            ("cross D 64", cs.HEADS, 64, cs.LK, valid_cross, valid_cross.sum(1).to(torch.int32), False, -1),
            ("cross D 128", 2, 128, cs.LK, valid_cross, valid_cross.sum(1).to(torch.int32), False, -1),
            ("self D 64", cs.HEADS, 64, cs.LQ, valid_self, lengths, True, cs.WINDOW)):
        q, k, v, do = (torch.randn((cs.B, heads, n, d), generator=g, device=dev).to(torch.bfloat16)
                       for n in (cs.LQ, lk, lk, cs.LQ))
        kv_len = torch.full((cs.B,), lk, dtype=torch.int32, device=dev)
        o, lse = fb.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, causal, window)
        args = (q, k, v, kv_len, kv_valid, do, lse, fb.attention_delta(do, o), causal, window)
        # L1/L2a's and L2b's chunk kernel and merge, or their one kernel where the port has no key split
        n_fwd = cs.lf_fwd_kernels(q, k, causal) if split_fwd else 1
        n_dq = cs.l2b_kernels(q, k, causal) if hasattr(fb, "legacy_dq_splits") else 1
        l1 = lambda **kw: fl.legacy_fwd_cuda(q, k, v, kv_len1, causal, window, **kw)  # noqa: E731
        l2a = lambda **kw: fb.legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, causal, window, **kw)  # noqa: E731
        r = dict(l1=timed(cs, "L1 legacy flash fwd", l1, n_fwd), l2a=timed(cs, "L2a legacy flash fwd lse", l2a, n_fwd),
                 l2b=timed(cs, "L2b legacy flash dq", lambda: fb.legacy_dq_cuda(*args), n_dq),
                 l2c=timed(cs, "L2c legacy flash dk/dv", lambda: fb.legacy_dkv_cuda(*args)))
        if split_fwd and not causal:
            r["l2a_ms_at_splits"] = {n: timed(cs, "L2a legacy flash fwd lse", lambda n=n: l2a(n_split=n),
                                              1 if n == 1 else 2)["ms"] for n in range(1, 9)}
        see = fl.visible_keys(cs.LQ, lk, kv_len, kv_valid, causal, window)
        see1 = fl.visible_keys(cs.LQ, lk, kv_len1, None, causal, window)
        r["sdpa_fwd_ms"] = cs.device_ms(lambda: sdpa(q, k, v, attn_mask=see))
        r["sdpa_fwd_l1_mask_ms"] = cs.device_ms(lambda: sdpa(q, k, v, attn_mask=see1))
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        o_s = sdpa(qs, ks, vs, attn_mask=see)
        r["sdpa_bwd_ms"] = cs.device_ms(lambda: torch.autograd.grad(o_s, (qs, ks, vs), do, retain_graph=True))
        print(f"[legacy {tag}] " + json.dumps(r), flush=True)
        out[tag] = r
        del q, k, v, do, o, lse, args, qs, ks, vs, o_s, see, see1
        torch.cuda.empty_cache()
    return out


PARTS = tuple(PART_LIBS)


def child(mode: str, out_dir: Path, parts: list) -> dict:
    import torch

    import chip_smoke as cs

    fp = cs.fp
    if Path(fp.__file__).resolve().parents[2] != ROOT:
        raise RuntimeError(f"imported {fp.__file__}, not the port under {ROOT}")
    cs.OUT_DIR = out_dir / f"traces_{mode}"
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    # K1c's kernel by a name that both its designs carry (flash_fwd_causal_kernel before the redesign)
    cs.KERNELS["K1c flash fwd causal"] = (*cs.KERNELS["K1c flash fwd causal"][:3], "flash_fwd_causal", 1)
    dev = torch.device("cuda")
    run = dict(cross=lambda: cross(cs, fp, dev), self=lambda: self_shape(cs, fp, dev),
               keep_mask=lambda: keep_mask(cs, fp, dev), legacy=lambda: legacy(cs, dev))
    return dict(mode=mode, **{part: run[part]() for part in parts})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", type=Path, default=ROOT / "build" / "split_bwd_probe")
    ap.add_argument("--parent", type=Path, default=None, help="a checkout whose kernels are timed in turns")
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="another checkout (e.g. this one with a constant changed) timed in turns too, by its "
                         "directory's name; may be given more than once")
    ap.add_argument("--parts", default=",".join(PARTS), help="the parts each run times, of " + ",".join(PARTS))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if not parts or set(parts) - set(PARTS):
        ap.error(f"--parts takes some of {','.join(PARTS)}")
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out_dir = args.out_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.child:
        res = child(args.child, out_dir, parts)
        (out_dir / f"{args.child}.json").write_text(json.dumps(res, indent=1))
        return 0
    results = {"card": card()}
    print(results["card"], flush=True)
    roots = {"this": ROOT}
    others = ([("parent", args.parent)] if args.parent else []) + [(v.resolve().name, v) for v in args.variant]
    if len({name for name, _ in others} | {"this"}) != len(others) + 1:
        ap.error("the parent and the variants need directories of distinct names, none of them 'this'")
    for name, path in others:
        roots[name] = copy_port(path.resolve(), ROOT / "build" / "split_bwd_probe_roots" / name, Path(__file__).name)
    build({root: sorted({lib for part in parts for lib in PART_LIBS[part]}) for root in roots.values()})
    names = [n for n, _ in others[:1] if n == "parent"] + ["this"] + [n for n, _ in others if n != "parent"]
    order = names + names[::-1] if len(names) > 1 else names  # e.g. parent, this, this, parent
    results["runs"] = [dict(tag=f"{name}_{i}", **res)
                       for i, (name, res) in enumerate(zip(order, run_in_turns(Path(__file__).name, order, roots,
                                                                               out_dir, args=("--parts", args.parts))))]
    (out_dir / "split_bwd_probe.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
