"""Streaming-loader feed rate at reference scale (25,691-sample corpus,
production geometry, warm frontend cache, NO device cache): the rate the
data layer can feed a train step.

Port of ``tools/measure_stream_rate.py``: the CLI's data module
(``ARDataModule``, image, distorted images, the r05 "bands" corpus of 2-30
measures at production geometry) with each ``--backends`` loader (the
thread loader ``threads``, the worker loader ``grain``), its train loader
read for ``--seconds``. JAX reads a corpus that ``prerender_corpus`` put in
its cache before; the port warms its own: each backend's loader first
reads for ``--seconds`` on an emptied frontend cache (``cold``, which fills
it), then a fresh loader of the same order reads those samples back for at
most ``--seconds`` (the warm rate, JAX's ``rates``). The images are read
at their own height, which the port's frontend cache does not keep
(``data/frontends.py``): warm and cold compute the image frontend alike. The max lengths are
seeded (``run_real_shape_e2e.seed_caches``), so no scan renders the
corpus; the frontend cache is a folder of its own under ``--workdir``,
emptied at the end. Writes JAX's JSON to ``--out``; ``--device`` is checked
as every tool checks it, and ``--smoke`` is a tiny corpus:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.measure_stream_rate [--seconds 90] [--backends threads grain]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg


def read_for(loader, seconds: float, limit=None) -> dict:
    """Samples of ``loader`` read for ``seconds`` (or up to ``limit``)."""
    n, t0 = 0, time.perf_counter()
    for b in loader:
        n += next(iter(b.values())).shape[0]
        if time.perf_counter() - t0 > seconds or (limit is not None and n >= limit):
            break
    dt = time.perf_counter() - t0
    return {"samples": n, "wall_s": round(dt, 1), "samples_per_sec": round(n / dt, 2)}


def main(argv=None) -> dict:
    from omr_a2s_multimodal_transformer_tpu_torch.data import frontends
    from omr_a2s_multimodal_transformer_tpu_torch.data.dataset import ARDataModule
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device
    from omr_a2s_multimodal_transformer_tpu_torch.tools.run_real_shape_e2e import seed_caches

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=90)
    ap.add_argument("--train_n", type=int, default=25691)
    ap.add_argument("--backends", nargs="+", default=["threads", "grain"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="runs/stream_rate_25k.json")
    ap.add_argument("--workdir", default="runs/stream_rate", help="the cache root and the frontend cache")
    ap.add_argument("--smoke", action="store_true", help="a tiny corpus")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu
    cfg = json.loads(synth_cfg(args.train_n, 128, args.smoke, 30, "grand", measures_range=[2, 30],
                               audio_style="bands"))
    cache_root = os.path.join(args.workdir, "cache")
    seed_caches(cache_root, smoke=args.smoke)
    saved = os.environ.get(frontends.CACHE_ENV)
    os.environ[frontends.CACHE_ENV] = os.path.join(args.workdir, "frontend_cache")
    out = {"train_n": args.train_n, "batch": args.batch, "workers": args.workers,
           "seconds_per_backend": args.seconds, "rates": {}, "cold": {}}
    try:
        for backend in args.backends:
            frontends.clear_cache()

            def loader():
                dm = ARDataModule(ds_name="synthetic", krn_encoding="kern", input_modality="image",
                                  batch_size=args.batch, num_workers=args.workers, synthetic=True,
                                  synthetic_kwargs=cfg, cache_root=cache_root, use_distorted_images=True,
                                  loader_backend=backend)
                dm.setup("fit")
                return dm.train_dataloader()

            try:
                for phase in ("cold", "rates"):
                    ld = loader()
                    try:
                        limit = out["cold"][backend]["samples"] if phase == "rates" else None
                        out[phase][backend] = read_for(ld, args.seconds, limit)
                    finally:
                        getattr(ld, "close", lambda: None)()  # the worker loader's processes end here
            except Exception as e:  # a backend that wedges/crashes is a result too
                out["rates"][backend] = {"error": repr(e)[:200]}
                continue
            print(backend, out["rates"][backend], "cold", out["cold"][backend], flush=True)
    finally:
        frontends.clear_cache()
        if saved is None:
            os.environ.pop(frontends.CACHE_ENV)
        else:
            os.environ[frontends.CACHE_ENV] = saved
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("->", args.out)
    return out


if __name__ == "__main__":
    main()
