"""Where a bf16 train step's gradient moves between runs and row splits, leaf by leaf.

The paper model at full width (chip_smoke.py's ``build`` and ``train_batch``: b8 361x4416, L 1268, attn_window
100, flash cross-attention, dropout off), one bf16 step's gradients of the token NLL over the whole batch's token
count, compared (relative L2 of the whole gradient, and the ten leaves with the largest shares of the squared
distance) between:
  - the same 8-row step twice, with cuDNN's default and then its deterministic algorithms;
  - 8 rows against two blocks of 4 and four blocks of 2 (the blocks' gradients summed, as data ranks sum theirs);
at the JAX package's initialisers (the port's own) and again at torch's defaults. Runs on the card:

    python3 diag_grad_split.py [--out build/diag_grad_split]

``DIAG_DEV=cpu`` runs it on the CPU at a tiny size (8 x 32 x 64 images, L 24), to check the script.

``--ranks`` instead holds a mesh's ranks to their single-process reference as chip_smoke.py's parallel path does
(parallel_reference, then held_step in gloo processes on the dp 2 x 1, tp 1 x 2 and 2 x 2 meshes), on the CPU at a
mid size (8 x 64 x 1024 images, L 128; the full-width paper model otherwise), bf16 and deterministic, so each
reading is the mesh's own rounding and nothing else; ``--torch-init`` draws torch's defaults instead:

    python3 diag_grad_split.py --ranks [--torch-init]
"""
import argparse
import functools
import json
import os
import time
from pathlib import Path

import torch
from torch import nn
from torch.func import functional_call

import chip_smoke as cs
from omr_a2s_multimodal_transformer_tpu_torch.models import decoder as D
from omr_a2s_multimodal_transformer_tpu_torch.models import encoder as E
from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_sums

dev = torch.device(os.environ.get("DIAG_DEV", "cuda"))
if dev.type == "cpu" and not os.environ.get("DIAG_RANKS"):
    cs.B, cs.LQ, cs.IMG_H, cs.IMG_W = 8, 24, 32, 64
    _build = cs.build
    cs.build = lambda d, **hp: _build(d, **{**hp, "max_seq_len": 24})
res = {}


def grads(model, batch, parts, det=False, bf16=True):
    """The step's gradients, each in_proj leaf split into its q, k and v thirds; parts are row blocks."""
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, False
    model.zero_grad(set_to_none=True)
    n_tot = (batch["y_out"] != 0).float().sum()
    gen = torch.Generator(device=dev).manual_seed(3)
    for a, b in parts:
        sub = {k: v[a:b] for k, v in batch.items()}
        params = {n: (p.to(torch.bfloat16) if bf16 else p) for n, p in model.named_parameters()}
        x = sub["x"].to(torch.bfloat16) if bf16 else sub["x"]
        logits = functional_call(model, params, (x, sub["x_hw"], sub["y_in"]), {"generator": gen})
        nll, _ = cross_entropy_sums(logits, sub["y_out"], 0)
        (nll / n_tot).backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {}
    for n, p in model.named_parameters():
        g = p.grad.detach().double().cpu()
        if n.endswith("in_proj_weight") or n.endswith("in_proj_bias"):
            for i, s in enumerate("qkv"):
                out[f"{n}.{s}"] = g.chunk(3, 0)[i]
        else:
            out[n] = g
    torch.backends.cudnn.deterministic = False
    return out


def compare(a, b, tag):
    d2 = {k: float((a[k] - b[k]).square().sum()) for k in a}
    n2 = {k: float(a[k].square().sum()) for k in a}
    tot_d, tot_n = sum(d2.values()), sum(n2.values())
    top = sorted(d2, key=d2.get, reverse=True)[:10]
    rows = [dict(leaf=k, share_of_diff2=d2[k] / max(tot_d, 1e-300), share_of_norm2=n2[k] / tot_n,
                 leaf_rel=(d2[k] / max(n2[k], 1e-300)) ** 0.5) for k in top]
    biggest = sorted(n2, key=n2.get, reverse=True)[:6]
    r = dict(rel_l2=(tot_d / tot_n) ** 0.5, top=rows,
             largest_norm=[dict(leaf=k, share_of_norm2=n2[k] / tot_n) for k in biggest])
    print(f"== {tag}: rel_l2 {r['rel_l2']:.3e}", flush=True)
    for row in rows[:8]:
        print(f"   {row['leaf']}: diff2 share {row['share_of_diff2']:.3f}, norm2 share {row['share_of_norm2']:.2e}, "
              f"leaf rel {row['leaf_rel']:.3e}", flush=True)
    res[tag] = r
    return r


def run(init_tag):
    model = cs.build(dev, attn_window=cs.WINDOW, packed_stem=True, **cs.PAR_NO_DROPOUT)
    batch = cs.train_batch(dev, torch.Generator(device=dev).manual_seed(2))
    full, halves, quarters = [(0, 8)], [(0, 4), (4, 8)], [(0, 2), (2, 4), (4, 6), (6, 8)]
    t0 = time.perf_counter()
    a, a2 = grads(model, batch, full), grads(model, batch, full)
    s = grads(model, batch, halves)
    compare(a, a2, f"{init_tag} bf16 8 rows, run to run")
    compare(a, s, f"{init_tag} bf16 8 rows vs 4+4")
    ad, ad2 = grads(model, batch, full, det=True), grads(model, batch, full, det=True)
    sd, sd2 = grads(model, batch, halves, det=True), grads(model, batch, halves, det=True)
    compare(ad, ad2, f"{init_tag} bf16 cudnn-det 8 rows, run to run")
    compare(sd, sd2, f"{init_tag} bf16 cudnn-det 4+4, run to run")
    compare(ad, sd, f"{init_tag} bf16 cudnn-det 8 rows vs 4+4")
    q = grads(model, batch, quarters, det=True)
    compare(ad, q, f"{init_tag} bf16 cudnn-det 8 rows vs 2+2+2+2")
    print(f"{init_tag}: {time.perf_counter() - t0:.1f} s", flush=True)


def torch_init():
    """torch's defaults: every Linear/Conv as torch draws it, the packed in_proj_weight xavier-uniform."""
    D.dense_ = E.dense_ = lambda m: m
    D.lecun_normal_ = nn.init.xavier_uniform_


def cpu_mid(ws: Path, init: str):
    """chip_smoke.py's parallel path at --ranks' size on the CPU (its CUDA-only calls stubbed, every kernel count
    read as the step's 8 K1 and 8 K2 launches: the CPU runs their plain version)."""
    cs.B, cs.LQ, cs.IMG_H, cs.IMG_W = 8, 128, 64, 1024
    build = cs.build
    cs.build = lambda d, mesh=None, **hp: build(d, mesh, **{**hp, "max_seq_len": cs.LQ})
    cs.make_train_step = functools.partial(cs.make_train_step, device="cpu")
    cs.read_counts = lambda: {n: 8 if n in ("K1 flash fwd", "K2 flash bwd") else 0 for n in cs.KERNELS}
    cs.PAR_WS = ws
    cs.log = lambda m: print(m, flush=True)
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.device_count = lambda: 1
    if init == "torch":
        torch_init()


def rank(r: int, port: int, world: int, meshes, ws: Path, init: str) -> None:
    from omr_a2s_multimodal_transformer_tpu_torch.parallel import multihost
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    cpu_mid(ws, init)
    os.environ.update(LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
    multihost.initialize(f"127.0.0.1:{port}", world, r, device="cpu")
    try:
        for tag, data, model in meshes:
            mesh = make_mesh(data, model)
            batch = cs.train_batch(dev, torch.Generator(device=dev).manual_seed(2))
            ref = torch.load(ws / f"reference_paper_d{mesh.data}.pt", weights_only=True)
            model = cs.build(dev, mesh, attn_window=cs.WINDOW, packed_stem=True, **cs.PAR_NO_DROPOUT)
            try:
                cs.held_step(dev, mesh, f"{tag} rank {r}", model, batch, ref)
            except AssertionError as e:  # the reading is logged either way
                print(f"[{tag} rank {r}] {e}", flush=True)
    finally:
        multihost.shutdown()


def ranks(ws: Path, init: str) -> None:
    import torch.multiprocessing as mp

    cpu_mid(ws, init)
    ws.mkdir(parents=True, exist_ok=True)
    cs.parallel_reference(dev, multimodal=False)
    ctx = mp.get_context("spawn")
    for world, meshes in cs.rank_groups(1):
        port = cs._free_port()
        procs = [ctx.Process(target=rank, args=(r, port, world, meshes, ws, init)) for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("build") / "diag_grad_split")
    ap.add_argument("--ranks", action="store_true", help="the parallel path's ranks on the CPU (module docstring)")
    ap.add_argument("--torch-init", action="store_true", help="with --ranks: torch's default initialisers")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    if args.ranks:  # the spawned ranks import this module on the CPU too
        global dev
        os.environ.update(DIAG_DEV="cpu", DIAG_RANKS="1")
        dev = torch.device("cpu")
        return ranks(args.out / ("ranks_torch_init" if args.torch_init else "ranks_jax_init"),
                     "torch" if args.torch_init else "jax")
    run("jax_init")
    torch_init()
    run("torch_init")
    (args.out / "diag.json").write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
