"""Isolate decode-step costs at flagship shapes (b8, S=12696, 8 layers).

Port of ``tools/microbench_decode_step.py``. JAX runs each variant as a
1268-iteration ``lax.while_loop`` on the device. The port decodes in a
Python loop that reads its done flags on the host every step
(``training/decode.py`` ``_loop``), so each variant here is that loop:
``STEPS`` calls of its step body, each followed by one host read of a flag
(``all_done``'s), and reports two numbers a step:

- host ms: the loop's wall clock over ``STEPS`` (what a decode pays);
- device ms: CUDA-event time of one step body captured in a CUDA graph and
  replayed ``STEPS`` times back to back (the device's own work, without
  the host's launches and reads). Where a body cannot be captured, the
  events around each step's body, a synchronize before each (its device
  span, host gaps inside it included), and the line says so.

Host-bound shows as host ms far above device ms. The variants:

  empty   : the loop and its per-step flag read, a trivial body: the floor
  cross_a : 8x cross-attend, K/V [B,S,H,64] bf16
  cross_b : 8x cross-attend, K/V [B,H,64,S] bf16 (S innermost)
  cross_c : 8x cross-attend on the packed [B,S,256] bf16, the port's
            ``ops/attention.py`` ``attend_packed_single_query``
  rest    : everything except cross-attend (self ring cache + FF + projs x8,
            the output projection and its argmax)
  model   : the port's own decode step (``training/decode.py`` ``_model_step``)
            of the paper model (attn_window 100, bf16 cache) at full width,
            after the prefill of a random b8 361 x 4416 image

cross_a, cross_b and cross_c compute ``attend_packed_single_query``'s
function (the query rounded to bf16, float32 logits and softmax, the
weights rounded to bf16, a float32 output) on their layouts. ``--smoke`` is
tiny shapes; runs on ``cuda`` unless given ``--device cpu`` (device ms is
then the host's):

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.microbench_decode_step [variant ...]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import torch

B, S, H, DH, D, L, NL = 8, 12696, 4, 64, 256, 1268, 8
STEPS = 1268
VOCAB, CL = 6997, 101
SMOKE = dict(B=2, S=64, NL=2, STEPS=4, VOCAB=31, H_IMG=32, W_IMG=64)
VARIANTS = ("empty", "cross_a", "cross_b", "cross_c", "rest", "model")


def _qh(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.bfloat16).float().reshape(q.shape[0], H, DH)


def cross_a(q, k, v):
    """q [B, D]; k, v [B, S, H, 64]."""
    logits = torch.einsum("bhd,bshd->bsh", _qh(q), k.float()) * (1.0 / DH ** 0.5)
    w = torch.softmax(logits, dim=1).to(torch.bfloat16).float()
    return torch.einsum("bsh,bshd->bhd", w, v.float()).reshape(q.shape[0], D)


def cross_b(q, k, v):
    """q [B, D]; k, v [B, H, 64, S]."""
    logits = torch.einsum("bhd,bhds->bhs", _qh(q), k.float()) * (1.0 / DH ** 0.5)
    w = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhs,bhds->bhd", w, v.float()).reshape(q.shape[0], D)


def cross_c(q, k, v):
    """q [B, D]; k, v [B, S, 256] head-packed."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops.attention import attend_packed_single_query

    return attend_packed_single_query(q, k, v, H)


LAYOUTS = {  # variant -> (attend, the packed [B, S, D] K/V in its layout)
    "cross_a": (cross_a, lambda t: t.reshape(t.shape[0], t.shape[1], H, DH).contiguous()),
    "cross_b": (cross_b, lambda t: t.reshape(t.shape[0], t.shape[1], H, DH).permute(0, 2, 3, 1).contiguous()),
    "cross_c": (cross_c, lambda t: t.contiguous()),
}


def _ln(x):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], eps=1e-5)


def device_ms(body: Callable[[], None], steps: int, dev) -> tuple:
    """(ms a step, how): a CUDA graph of one body replayed ``steps`` times,
    else events around each body."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(steps):
            body()
        return (time.perf_counter() - t0) / steps * 1e3, "host"
    try:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        graph.replay()
        start.record()
        for _ in range(steps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps, "graph"
    except RuntimeError:  # not capturable: a host read or sync in the body
        torch.cuda.synchronize(dev)
        total = 0.0
        for _ in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            body()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / steps, "events"


def run(name: str, body: Callable[[], None], flag: torch.Tensor, steps: int, dev) -> Dict:
    """The decode loop: ``steps`` bodies, each followed by a host read of ``flag``."""
    body()
    bool(flag.any())
    t0 = time.perf_counter()
    for _ in range(steps):
        body()
        bool(flag.any())
    dt = time.perf_counter() - t0
    dev_ms, how = device_ms(body, steps, dev)
    host_ms = dt / steps * 1e3
    print(f"{name:10s}: {dt:6.2f}s total, {host_ms:6.3f} ms/step host, {dev_ms:6.3f} ms/step device "
          f"({how})", flush=True)
    return dict(total_s=dt, host_ms=host_ms, device_ms=dev_ms, device_how=how)


def main(argv=None) -> Dict:
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS), help=f"any of {', '.join(VARIANTS)}")
    ap.add_argument("--steps", type=int, default=None, help=f"loop steps (default {STEPS})")
    ap.add_argument("--smoke", action="store_true", help="tiny shapes")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}: choose from {VARIANTS}")
    dev = resolve_device(args.device)
    b, s, nl, steps, vocab = B, S, NL, STEPS, VOCAB
    img = (361, 4416)
    if args.smoke:
        b, s, nl, steps, vocab = SMOKE["B"], SMOKE["S"], SMOKE["NL"], SMOKE["STEPS"], SMOKE["VOCAB"]
        img = (SMOKE["H_IMG"], SMOKE["W_IMG"])
    steps = args.steps or steps
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    out = {}
    flag = torch.zeros((b,), dtype=torch.bool, device=dev)
    if "empty" in args.variants:
        c = torch.zeros((8, 128), device=dev)
        out["empty"] = run("empty", lambda: c.add_(1.0), flag, steps, dev)

    for name in ("cross_a", "cross_b", "cross_c"):
        if name not in args.variants:
            continue
        attend, layout = LAYOUTS[name]
        ks = [layout(randn(b, s, D, dtype=torch.bfloat16)) for _ in range(nl)]
        vs = [layout(randn(b, s, D, dtype=torch.bfloat16)) for _ in range(nl)]
        x = torch.ones((b, D), device=dev)

        def body(x=x, ks=ks, vs=vs, attend=attend):
            y = x
            for k, v in zip(ks, vs):
                y = y + attend(y, k, v)
            x.copy_(y)

        out[name] = run(name, body, flag, steps, dev)
        del ks, vs

    if "rest" in args.variants:
        w_qkv = randn(nl, 3, D, D, scale=0.05)
        w_ff1, w_ff2 = randn(nl, D, D, scale=0.05), randn(nl, D, D, scale=0.05)
        w_out = randn(D, vocab, scale=0.05)
        ck = torch.zeros((nl, b, CL, H, DH), dtype=torch.bfloat16, device=dev)
        cv = torch.zeros_like(ck)
        x0 = torch.ones((b, D), device=dev)
        pos = [0]

        def body_r():
            wr = pos[0] % CL
            x = x0
            for layer in range(nl):
                q = (x @ w_qkv[layer, 0]).reshape(b, H, DH)
                ck[layer, :, wr] = (x @ w_qkv[layer, 1]).reshape(b, H, DH).to(torch.bfloat16)
                cv[layer, :, wr] = (x @ w_qkv[layer, 2]).reshape(b, H, DH).to(torch.bfloat16)
                logits = torch.einsum("bhd,bkhd->bhk", q, ck[layer].float()) * (1.0 / DH ** 0.5)
                o = torch.einsum("bhk,bkhd->bhd", torch.softmax(logits, -1), cv[layer].float())
                x = _ln(x + o.reshape(b, D))
                x = _ln(x + torch.relu(x @ w_ff1[layer]) @ w_ff2[layer])
            nt = torch.argmax(x @ w_out, -1)
            x0.copy_(x + 0.0 * nt[:, None].float())

        out["rest"] = run("rest", body_r, flag, steps, dev)

    if "model" in args.variants:
        from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
        from omr_a2s_multimodal_transformer_tpu_torch.training.decode import _model_step

        model, _ = build_model(dict(vocab_size=vocab, max_seq_len=L,
                                    input_modality="image", attn_window=100, packed_stem=True,
                                    cache_dtype="bfloat16"), device=dev, seed=0)
        model.eval()
        with torch.no_grad():
            x = torch.rand((b, *img, 1), generator=g, device=dev)
            cross, mem_valid = model.decode_prefill(x, None)
            step = _model_step(model, cross, mem_valid)
            cache = model.decode_init_cache(b)
            tok = torch.ones((b,), dtype=torch.int64, device=dev)
            pos = [0]

            def body_m():
                logits, _ = step(tok, pos[0], cache)  # the cache is updated in place; past L the step clamps
                tok.copy_(logits.argmax(-1))
                pos[0] += 1

            out["model"] = run("model", body_m, flag, steps, dev)
        out["model"]["keys"] = next(iter(cross.values()))["k"].shape[1]
    return out


if __name__ == "__main__":
    main()
