"""Per-head (L2) against head-packed (K1/K2) flash attention at the flagship
cross-attention shape: forward + backward through autograd.

Port of ``tools/bench_flash_packed.py``. The old path is the per-head
legacy kernels (``tools/legacy_flash``: L2a forward, L2b and L2c backward,
q/k/v [B, H, L, 64]); the new one ``make_flash_attention_packed`` (K1
forward, K2 merged backward, [B, L, H*64]) without dropout and with
dropout 0.1. It prints the lines of the JAX bench: the three
forward + backward times, the max |old - new| of the forward, and the
dropout checks (a fraction of outputs changed, the same seed gives the same
output, another seed another one).

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.bench_flash_packed [block_q block_k [new]]
        [--iters N]

Runs on ``cuda`` unless ``main`` is given another device, and raises
without a GPU. On the card each time is the CUDA-event time of ``iters``
calls after one untimed call, over ``iters``; on the CPU (a tiny shape,
for tests) the host clock's. ``main`` returns the numbers as a dict.
"""

from __future__ import annotations

import argparse
import time

import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.ops.flash_packed import make_flash_attention_packed
from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash.flash_attention_bwd import make_flash_attention

B, H, LQ, LK, DH = 2, 4, 1280, 12696, 64


def time_per_call(fn, iters: int, device: torch.device) -> float:
    """Seconds per call of fn over iters calls, after one untimed call."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def fwd_bwd(flash, *args):
    """Gradients of sum(o) in float32 with respect to q, k and v."""
    q, k, v = (t.detach().requires_grad_() for t in args)
    return lambda: torch.autograd.grad(flash(q, k, v).float().sum(), (q, k, v))


def main(argv=None, device: DeviceLike = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("block_q", type=int, nargs="?", default=128)
    ap.add_argument("block_k", type=int, nargs="?", default=512)
    ap.add_argument("which", nargs="?", choices=("new",), help="time the head-packed kernels only")
    ap.add_argument("--iters", type=int, default=10, help="timed calls of each forward + backward")
    ap.add_argument("--shape", type=int, nargs=5, default=(B, H, LQ, LK, DH), metavar=("B", "H", "LQ", "LK", "DH"),
                    help="batch, heads, queries, keys, head width (default: the flagship cross-attention)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    b, h, lq, lk, dh = args.shape
    bq, bk = args.block_q, args.block_k
    g = torch.Generator(device=dev).manual_seed(0)
    q4, k4, v4 = (torch.randn((b, h, n, dh), generator=g, device=dev).to(torch.bfloat16) for n in (lq, lk, lk))

    def packed(t):
        return t.transpose(1, 2).reshape(b, t.shape[2], h * dh).contiguous()

    qp, kp, vp = packed(q4), packed(k4), packed(v4)
    kv_len = torch.full((b,), lk, dtype=torch.int32, device=dev)
    kv_valid = torch.ones((b, lk), dtype=torch.bool, device=dev)
    seed = torch.tensor([3], dtype=torch.int32, device=dev)
    old = make_flash_attention(causal=False, window=-1, block_q=bq, block_k=bk)
    new = make_flash_attention_packed(n_heads=h, causal=False, window=-1, block_q=bq, block_k=bk)
    new_do = make_flash_attention_packed(n_heads=h, causal=False, window=-1, block_q=bq, block_k=bk,
                                         dropout_rate=0.1)
    print(f"block_q={bq} block_k={bk}")
    out = dict(device=str(dev), shape=dict(B=b, H=h, Lq=lq, Lk=lk, Dh=dh), block_q=bq, block_k=bk, iters=args.iters)

    def timed(flash, *inputs):
        return time_per_call(fwd_bwd(flash, *inputs), args.iters, dev)

    t_new = timed(lambda q, k, v: new(q, k, v, kv_len, kv_valid, seed), qp, kp, vp)
    out["new_ms"] = t_new * 1e3
    print(f"fwd+bwd new (head-packed)   : {t_new * 1e3:7.2f} ms")
    if args.which == "new":
        t_do = timed(lambda q, k, v: new_do(q, k, v, kv_len, kv_valid, seed), qp, kp, vp)
        out["new_dropout_ms"] = t_do * 1e3
        print(f"fwd+bwd new + dropout 0.1   : {t_do * 1e3:7.2f} ms")
        return out
    t_old = timed(lambda q, k, v: old(q, k, v, kv_len, kv_valid), q4, k4, v4)
    out["old_ms"], out["speedup"] = t_old * 1e3, t_old / t_new
    print(f"fwd+bwd old (per-head [B, H, L, {dh}]): {t_old * 1e3:7.2f} ms   (new = {t_old / t_new:.2f}x old)")

    with torch.no_grad():
        o_old = old(q4, k4, v4, kv_len, kv_valid)
        o_new = new(qp, kp, vp, kv_len, kv_valid, seed)
    out["max_abs_old_new"] = float((packed(o_old).float() - o_new.float()).abs().max())
    out["max_abs_new"] = float(o_new.float().abs().max())
    print(f"max |old-new| fwd: {out['max_abs_old_new']:.4e}")

    t_do = timed(lambda q, k, v: new_do(q, k, v, kv_len, kv_valid, seed), qp, kp, vp)
    other = torch.tensor([4], dtype=torch.int32, device=dev)
    with torch.no_grad():
        o_do, o_do2, o_do3 = (new_do(qp, kp, vp, kv_len, kv_valid, s) for s in (seed, seed, other))
    out["new_dropout_ms"] = t_do * 1e3
    out["dropout_changed_frac"] = float((o_do != o_new).float().mean())
    print(f"fwd+bwd new + dropout 0.1   : {t_do * 1e3:7.2f} ms; "
          f"outputs changed frac={out['dropout_changed_frac']:.3f}")
    out["dropout_deterministic"] = bool(torch.equal(o_do, o_do2))
    print(f"dropout deterministic (same seed): {out['dropout_deterministic']}")
    out["dropout_varies_with_seed"] = bool((o_do != o_do3).any())
    print(f"dropout varies with seed: {out['dropout_varies_with_seed']}")
    return out


if __name__ == "__main__":
    main()
