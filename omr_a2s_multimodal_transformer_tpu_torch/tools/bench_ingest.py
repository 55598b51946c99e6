"""Ingest-throughput bench: data-loading samples/s of the port's two loader
backends at the collection's image shapes.

Port of ``tools/bench_ingest.py``. The backends are the thread loader
(``threads``: render threads under the GIL) and the worker loader
(``grain``: ``data/grain_pipeline.py`` ``GrainLoader`` on
``torch.utils.data`` worker processes, where JAX runs grain's). Each reads
one epoch of ``--n`` synthetic grand renders (355-362 x 4300-4412 px, 30
measures; JAX's ``make_dm`` kwargs) twice:

- cold: the first epoch of a fresh ``cache_root``'s train loader (the
  worker loader starts its processes in it);
- warm: the second epoch of the same loader (JAX asks the data module for
  a second loader, which reads its disk cache).

The port has no joblib frontend cache (the JAX package's renders are
cached on disk after epoch 1, so its warm epoch reads them back): every
epoch renders every sample, and JAX's ``--keep_cache`` is dropped. One
JSON line a backend:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.bench_ingest [--n 64] [--batch 4] [--modality image]

The cache roots go under ``--workdir`` (JAX's go to /tmp). The loaders run
on the host, as JAX's do (the worker loader pins its batches when a card
is present); ``--device`` is checked as every tool checks it (``cuda``
unless given ``--device cpu``, raising without a GPU). ``main`` returns
the lines.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device


def make_dm(backend: str, n: int, batch: int, modality: str, workers: int, cache_root: str,
            measures_range=None, audio_style: str = "tones"):
    """JAX's data module, with the port's ``ARDataModule``."""
    from omr_a2s_multimodal_transformer_tpu_torch.data.dataset import ARDataModule

    kwargs = {
        "n": n,
        "n_measures": 30,
        "img_height_range": [355, 362],
        "img_width_range": [4300, 4413],
        "audio_seconds_range": [17.0, 18.7],
        "render_style": "grand",
    }
    if measures_range:
        kwargs["n_measures_range"] = list(measures_range)
    if audio_style != "tones":
        kwargs["audio_style"] = audio_style
    return ARDataModule(
        ds_name="synthetic",
        krn_encoding="kern",
        input_modality=modality,
        batch_size=batch,
        num_workers=workers,
        synthetic=True,
        synthetic_kwargs=kwargs,
        cache_root=cache_root,
        loader_backend=backend,
    )


def time_epoch(loader) -> float:
    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        first = next(iter(batch.values()))
        n += first.shape[0]
    return n / (time.perf_counter() - t0)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--modality", default="image", choices=["image", "audio", "both"])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--backends", default="threads,grain")
    p.add_argument("--measures_range", nargs=2, type=int, default=None)
    p.add_argument("--audio_style", default="tones", choices=["tones", "bands"])
    p.add_argument("--workdir", default="runs/bench_ingest", help="the backends' cache roots")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu
    out = []
    for backend in args.backends.split(","):
        cache_root = os.path.join(args.workdir, f"ingest_cache_{backend}")
        shutil.rmtree(cache_root, ignore_errors=True)  # a fresh cache root a backend: honest cold numbers
        dm = make_dm(backend, args.n, args.batch, args.modality, args.workers, cache_root,
                     args.measures_range, args.audio_style)
        dm.setup("fit")
        loader = dm.train_dataloader()
        try:
            cold, warm = time_epoch(loader), time_epoch(loader)
        finally:
            getattr(loader, "close", lambda: None)()  # the worker loader's processes end here
        line = {
            "metric": f"ingest_{backend}",
            "modality": args.modality,
            "cold_samples_per_sec": round(cold, 2),
            "warm_samples_per_sec": round(warm, 2),
            "n": args.n, "batch": args.batch, "workers": args.workers,
        }
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
