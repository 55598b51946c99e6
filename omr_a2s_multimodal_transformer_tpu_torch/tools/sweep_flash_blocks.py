"""Block and split sweep of the packed flash cross-attention at flagship
train shapes (b8, Lq 1280, Lk 14,336 fused memories, dropout 0.1).

Port of ``tools/sweep_flash_blocks.py``. JAX sweeps its kernels' (block_q,
block_k) tiles. The port's kernels run fixed 64-row tiles; what JAX's
blocks set on the card is the keep-mask geometry (``mask_bq``, ``mask_bk``:
the blocks the dropout hash is seeded by, ``ops/flash_packed.py``
``mask_geometry``), so the first sweep runs K1 + K2 (forward and merged
backward through ``make_flash_attention_packed``) at each of ``--bq`` x
``--bk``. The second runs K1 (``flash_fwd_cuda(n_split=)``) and K3a
(``flash_dq_cuda(n_split=)``) alone over ``--splits`` key chunks at the
decoder's mask geometry, and marks the split that ``fwd_splits`` and
``dq_splits`` choose for the card.

Timing: JAX's (``--iters`` queued calls against one, each run to a value
read to the host, the best of 3) for the block sweep; CUDA events over
``--iters`` calls for the splits. For the card only: the CPU has no
kernels, and the plain version no blocks or splits, so it raises there:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.sweep_flash_blocks [--b 8] [--lq 1280] [--lk 14336]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

PEAK_FLOPS = 989e12  # H100 SXM dense bf16


def main(argv=None) -> Dict:
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
    from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--lq", type=int, default=1280)
    ap.add_argument("--lk", type=int, default=14336)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bq", nargs="+", type=int, default=[128, 256, 512], help="keep-mask block_q")
    ap.add_argument("--bk", nargs="+", type=int, default=[512, 1024, 2048], help="keep-mask block_k")
    ap.add_argument("--splits", nargs="+", type=int, default=list(range(1, 9)),
                    help="key chunks of K1 and K3a")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default); the CPU raises")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("sweep_flash_blocks times the CUDA kernels: it runs on the card only")

    B, H, DH, LQ, LK = args.b, args.heads, args.dh, args.lq, args.lk
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((B, n, H * DH), generator=g, device=dev).to(torch.bfloat16) for n in (LQ, LK, LK))
    kv_len = torch.full((B,), LK, dtype=torch.int32, device=dev)
    kv_valid = torch.ones((B, LK), dtype=torch.bool, device=dev)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    nominal_fb = 3.5 * 4.0 * B * H * LQ * LK * DH  # fwd 4*n*d FLOPs, bwd 2.5x

    def timeit(f):
        def run(n):
            t0 = time.perf_counter()
            for _ in range(n):
                out = f()
            float(out[0].reshape(-1)[0])
            return time.perf_counter() - t0

        run(2)
        t1 = min(run(1) for _ in range(3))
        tn = min(run(args.iters) for _ in range(3))
        return (tn - t1) / (args.iters - 1)

    out = {"blocks": {}, "k1": {}, "k3a": {}}
    for bq in args.bq:
        for bk in args.bk:
            try:
                fa = fp.make_flash_attention_packed(n_heads=H, causal=False, window=-1, block_q=bq, block_k=bk,
                                                    dropout_rate=args.dropout)

                def fwdbwd():
                    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
                    o = fa(qg, kg, vg, kv_len, kv_valid, seed)
                    return torch.autograd.grad(o.float().sum(), (qg, kg, vg))

                t = timeit(fwdbwd)
                out["blocks"][f"{bq}x{bk}"] = t * 1e3
                print(f"bq={bq:4d} bk={bk:5d}: {t*1e3:7.2f} ms fwd+bwd "
                      f"({nominal_fb/t/1e12:5.1f} nominal TFLOP/s, "
                      f"{nominal_fb/t/PEAK_FLOPS*100:4.1f}% MFU)", flush=True)
            except (RuntimeError, ValueError) as e:
                print(f"bq={bq:4d} bk={bk:5d}: FAIL {str(e).splitlines()[0][:90]}", flush=True)

    mbq, mbk = fp.mask_geometry(LQ, LK)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = {"k1": fp.fwd_splits(B, H, LQ, LK, n_sm)[0], "k3a": fp.dq_splits(B, H, LQ, LK, n_sm)[0]}
    o, lse = fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, args.dropout, H, mbq, mbk)
    do = torch.randn(o.shape, generator=g, device=dev).to(torch.bfloat16)
    delta = fp.attention_delta(do, o, H)
    calls = {
        "k1": lambda n: fp.flash_fwd_cuda(q, k, v, kv_len, kv_valid, seed, args.dropout, H, mbq, mbk, n_split=n),
        "k3a": lambda n: fp.flash_dq_cuda(q, k, v, kv_len, kv_valid, seed, do, lse, delta, args.dropout, H, mbq,
                                          mbk, n_split=n),
    }
    for kernel, call in calls.items():
        choice = "fwd_splits" if kernel == "k1" else "dq_splits"
        for n in args.splits:
            call(n)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                call(n)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / args.iters
            out[kernel][n] = ms
            mark = f"  <- {choice}" if n == chosen[kernel] else ""
            print(f"{kernel.upper()} n_split={n}: {ms:7.3f} ms{mark}", flush=True)
    out["chosen"] = chosen
    return out


if __name__ == "__main__":
    main()
