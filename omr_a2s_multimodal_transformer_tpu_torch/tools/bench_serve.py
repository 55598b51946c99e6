"""Serving latency/throughput bench: closed-loop clients against the port's
``TranscriptionServer``.

Port of ``tools/bench_serve.py``, at the collection's largest shapes
(vocab 6,997; images up to 361x4412 in the 368 x (2208, 4416) ladder,
decoded to L=1268; audio up to 413,696 samples in the (206848, 413696)
ladder). eos is set out of the vocabulary (6,997) so that every request
decodes the full length: the latencies are ceilings. The models are the
paper's (window 100, packed stem), randomly initialised from a seed; the
fused server pairs an image and an audio model at alpha 0.5.

The server is warmed with ``--max_batch`` requests and one more, then
``--clients`` threads each send ``--requests`` requests one after the
other. One JSON line a modality, with JAX's keys:

  {"metric": "serve_image", "p50_ms": ..., "p99_ms": ..., "samples_per_sec": ..., "clients": ..., "requests": ...,
   "max_batch": ..., "cache_dtype": ..., "batches": {...}}

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.bench_serve [image|audio|fused|all] [--clients N]
        [--requests N] [--max_batch N] [--cache_dtype int8|bfloat16]

Runs on ``cuda`` unless given ``--device cpu``. ``--max_len`` (a shorter
decode) and the ladder options are for a short or tiny run; their defaults
are JAX's. ``main`` returns the lines as dicts.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time

import numpy as np

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device

VOCAB, MAX_LEN = 6997, 1268
IMAGE_HEIGHT, IMAGE_WIDTHS = 368, (2208, 4416)
AUDIO_SAMPLES = (206848, 413696)  # ~404 / ~808 frames


def _build_one(modality: str, cache_dtype: str, max_len: int, dev):
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model

    hp = {
        "vocab_size": VOCAB,
        "max_seq_len": max_len,
        "input_modality": modality,
        "attn_window": 100,
        "cache_dtype": cache_dtype,
        "packed_stem": True,  # the JAX production default (the same convolutions in the port)
    }
    return build_model(hp, device=dev, seed=0)[0]  # JAX inits both models of a fused server from key 0


def build_server(modality: str, max_batch: int, max_wait_ms: float, cache_dtype: str, dev,
                 max_len: int = MAX_LEN, image_height: int = IMAGE_HEIGHT, image_widths=IMAGE_WIDTHS,
                 audio_samples=AUDIO_SAMPLES):
    from omr_a2s_multimodal_transformer_tpu_torch.serving import TranscriptionServer

    if modality == "fused":
        model = _build_one("image", cache_dtype, max_len, dev)
        kw = dict(image_height=image_height, image_widths=image_widths, audio_samples=audio_samples,
                  audio_model=_build_one("audio", cache_dtype, max_len, dev), alpha=0.5)
    else:
        model = _build_one(modality, cache_dtype, max_len, dev)
        kw = (dict(image_height=image_height, image_widths=image_widths) if modality == "image"
              else dict(audio_samples=audio_samples))
    # eos out of vocab -> full worst-case decode every request
    return TranscriptionServer(model, modality, sos_id=1, eos_id=VOCAB, max_batch=max_batch,
                               max_wait_ms=max_wait_ms, device=dev, **kw)


def make_payload(modality: str, rng: np.random.Generator):
    """JAX's payloads, drawn in its order from the same generator."""
    if modality == "fused":
        return (make_payload("image", rng), make_payload("audio", rng))
    if modality == "image":
        h = int(rng.integers(300, 362))
        w = int(rng.integers(3000, 4413))
        img = np.full((h, w), 255, np.uint8)
        img[:, :: max(1, w // 200)] = 0
        return img
    n = int(rng.integers(300000, 413697))
    return rng.standard_normal(n).astype(np.float32) * 0.1


def run_bench(modality: str, clients: int, requests_per_client: int, max_batch: int, max_wait_ms: float,
              cache_dtype: str, dev, payload=None, **server_kw) -> dict:
    """``payload(modality, rng)`` draws a request (default ``make_payload``)."""
    payload = payload or make_payload
    server = build_server(modality, max_batch, max_wait_ms, cache_dtype, dev, **server_kw)
    try:
        # the warm-up: a full batch, then one request alone (the port compiles nothing; the first calls
        # allocate the caches and pick cuDNN's algorithms)
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        warm = [server.submit(payload(modality, rng)) for _ in range(max_batch)]
        for f in warm:
            f.result(timeout=3600)
        server.transcribe(payload(modality, rng), timeout=3600)
        print(f"# warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)

        lat = []
        lock = threading.Lock()
        t_start = time.perf_counter()

        def client(cid):
            crng = np.random.default_rng(1000 + cid)
            for _ in range(requests_per_client):
                res = server.transcribe(payload(modality, crng), timeout=3600)
                with lock:
                    lat.append(res.latency_s)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        lat_ms = sorted(x * 1e3 for x in lat)
        out = {
            "metric": f"serve_{modality}",
            "p50_ms": round(statistics.median(lat_ms), 1),
            "p99_ms": round(lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))], 1),
            "samples_per_sec": round(len(lat) / wall, 3),
            "clients": clients,
            "requests": len(lat),
            "max_batch": max_batch,
            "cache_dtype": cache_dtype,
            "batches": server.batch_stats(),
        }
        print(json.dumps(out), flush=True)
        return out
    finally:
        server.stop()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="all", choices=["image", "audio", "fused", "all"])
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=4, help="per client")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=30.0)
    p.add_argument("--cache_dtype", default="bfloat16", choices=["bfloat16", "int8", "int4"])
    p.add_argument("--max_len", type=int, default=MAX_LEN, help="the models' max_seq_len: every decode's length")
    p.add_argument("--image_height", type=int, default=IMAGE_HEIGHT)
    p.add_argument("--image_widths", type=int, nargs="+", default=IMAGE_WIDTHS)
    p.add_argument("--audio_samples", type=int, nargs="+", default=AUDIO_SAMPLES)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None, payload=None) -> list:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    modes = ["image", "audio"] if args.mode == "all" else [args.mode]
    return [run_bench(m, args.clients, args.requests, args.max_batch, args.max_wait_ms, args.cache_dtype, dev,
                      payload=payload, max_len=args.max_len, image_height=args.image_height,
                      image_widths=tuple(args.image_widths), audio_samples=tuple(args.audio_samples))
            for m in modes]


if __name__ == "__main__":
    main()
