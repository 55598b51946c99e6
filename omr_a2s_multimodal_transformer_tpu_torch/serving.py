"""Batching transcription server (serving daemon).

Port of ``omr_a2s_multimodal_transformer_tpu/serving.py``: a
dynamic-batching loop around the end-to-end transcribers (``inference.py``),
with the JAX package's shape discipline:

- **Static shape buckets.** Every request is padded to a (height, width)
  bucket from a fixed ladder (audio buckets rounded up to whole hops), and
  every device call is padded to a power-of-two batch size (white images,
  silent waves), so the device sees a small, bounded set of shapes
  (#width_buckets x #batch_buckets).
- **Dynamic batching.** A worker thread drains the request queue up to
  ``max_batch`` or ``max_wait_ms`` (whichever first), groups the drained
  requests by bucket (fused requests by the (image width, audio samples)
  bucket pair), and makes one device call per group. A device error goes
  to every waiter of its group.
- **Host/device split.** Raw uint8 images / float32 waveforms go to the
  device; preprocessing (normalize/resize/STFT) runs there, then encode and
  decode. The transcribers carry their own ``torch.no_grad()``: grad mode
  is per thread, and the worker is a thread of its own.

An optional stdlib HTTP front (``serve_http``) exposes POST /transcribe
for npy-encoded payloads; the CLI entry is
``python -m omr_a2s_multimodal_transformer_tpu_torch.cli.serve``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.data.collate import round_up
from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike
from omr_a2s_multimodal_transformer_tpu_torch.inference import (
    make_audio_transcriber,
    make_fused_transcriber,
    make_image_transcriber,
)
from omr_a2s_multimodal_transformer_tpu_torch.ops.stft import HOP_LENGTH
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import cut_at_eos


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class _Request:
    payload: object  # [H, W] u8 image, [N] f32 waveform, or an (image, wave) pair
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass
class Result:
    """Per-request transcription result."""

    token_ids: List[int]  # decoded ids, cut right after the first <eos>
    tokens: Optional[List[str]]  # i2w-mapped (None if no vocab given)
    scores: List[float]  # per emitted token: the top-1 raw logit (fused: the top-1 mixed probability)
    latency_s: float  # submit -> fulfilled (includes queueing + batching)


class TranscriptionServer:
    """Dynamic-batching server over one unimodal model, or over a weighted
    late-fusion pair.

    modality 'image': submit [H, W] uint8 arrays.
    modality 'audio': submit [N] float32 waveforms at 22.05 kHz.
    modality 'fused': submit ([H, W] uint8 image, [N] float32 waveform)
      pairs; decoding runs the two unimodal models in lockstep with
      next-token dist = alpha*softmax(img) + (1-alpha)*softmax(audio).
      Requires ``audio_model`` plus BOTH bucket ladders; requests are
      grouped by the (image-width, audio-samples) bucket pair.
    The models must live on ``device`` (``cuda`` unless the caller says
    otherwise).
    """

    def __init__(
        self,
        model,
        modality: str,
        vocab=None,
        sos_id: Optional[int] = None,
        eos_id: Optional[int] = None,
        max_batch: int = 16,
        max_wait_ms: float = 5.0,
        image_height: Optional[int] = None,
        image_widths: Optional[Sequence[int]] = None,
        audio_samples: Optional[Sequence[int]] = None,
        img_height: Optional[int] = None,
        audio_model=None,
        alpha: float = 0.5,
        device: DeviceLike = None,
    ):
        if modality not in ("image", "audio", "fused"):
            raise ValueError(f"modality must be image, audio or fused, got {modality!r}")
        if vocab is not None:
            sos_id = vocab.sos_id if sos_id is None else sos_id
            eos_id = vocab.eos_id if eos_id is None else eos_id
        if sos_id is None or eos_id is None:
            raise ValueError("need vocab or sos_id/eos_id")
        self.modality = modality
        self.vocab = vocab
        self.eos_id = eos_id
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        if modality in ("image", "fused"):
            if not (image_height and image_widths):
                raise ValueError("image serving needs a bucket ladder")
            self.image_height = int(image_height)
            self.image_widths = tuple(sorted(int(w) for w in image_widths))
        if modality in ("audio", "fused"):
            if not audio_samples:
                raise ValueError("audio serving needs a sample-count bucket ladder")
            # STFT frame counts must land on the model's width buckets, so
            # round sample buckets up to whole hops.
            self.audio_samples = tuple(sorted(round_up(int(n), HOP_LENGTH) for n in audio_samples))
        if modality == "image":
            self._transcribe = make_image_transcriber(model, sos_id, eos_id, img_height=img_height, device=device)
        elif modality == "audio":
            self._transcribe = make_audio_transcriber(model, sos_id, eos_id, device=device)
        else:
            if audio_model is None:
                raise ValueError("fused serving needs audio_model beside the image model")
            self.alpha = float(alpha)
            self._transcribe = make_fused_transcriber(model, audio_model, sos_id, eos_id, img_height=img_height,
                                                      device=device)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stats_lock = threading.Lock()
        # Serializes submit vs stop: without it, a submit that passes the
        # _stopped check while stop() enqueues the None sentinel can land
        # AFTER the sentinel; the worker exits and the caller's
        # future.result() blocks forever.
        self._lifecycle_lock = threading.Lock()
        self._batches: Dict[Tuple[int, int], int] = {}  # (bucket, batch) -> count
        self._worker = threading.Thread(target=self._run, name="transcription-server", daemon=True)
        self._stopped = False
        self._worker.start()

    # ------------------------------------------------------------- client API

    def _check_image(self, img) -> np.ndarray:
        img = np.asarray(img)
        if img.ndim != 2:
            raise ValueError(f"image payload must be [H, W], got {img.shape}")
        if img.shape[0] > self.image_height or img.shape[1] > self.image_widths[-1]:
            raise ValueError(f"image {img.shape} exceeds the largest bucket "
                             f"({self.image_height}x{self.image_widths[-1]})")
        return img.astype(np.uint8)

    def _check_wave(self, wave) -> np.ndarray:
        wave = np.asarray(wave)
        if wave.ndim != 1:
            raise ValueError(f"audio payload must be [N], got {wave.shape}")
        if wave.shape[0] > self.audio_samples[-1]:
            raise ValueError(f"waveform of {wave.shape[0]} samples exceeds the largest "
                             f"bucket ({self.audio_samples[-1]})")
        return wave.astype(np.float32)

    def submit(self, payload) -> "Future[Result]":
        """Enqueue one raw sample ([H,W] u8 image / [N] f32 waveform /
        an (image, waveform) pair for 'fused'); returns a Future[Result]."""
        if self._stopped:
            raise RuntimeError("server is stopped")
        if self.modality == "image":
            payload = self._check_image(payload)
        elif self.modality == "audio":
            payload = self._check_wave(payload)
        else:
            if not (isinstance(payload, (tuple, list)) and len(payload) == 2):
                raise ValueError("fused payload must be an (image, waveform) pair")
            payload = (self._check_image(payload[0]), self._check_wave(payload[1]))
        req = _Request(payload)
        with self._lifecycle_lock:
            if self._stopped:
                raise RuntimeError("server is stopped")
            self._q.put(req)
        return req.future

    def transcribe(self, payload, timeout: Optional[float] = None) -> Result:
        return self.submit(payload).result(timeout=timeout)

    def stop(self, timeout: Optional[float] = None) -> None:
        """Serve what is queued, then end the worker (waiting at most
        ``timeout`` seconds for it); a request left behind fails."""
        with self._lifecycle_lock:
            if self._stopped:
                return
            self._stopped = True
            self._q.put(None)  # FIFO: every already-queued request precedes it
        self._worker.join(timeout)
        # Defensive drain: fail any stray entries instead of hanging waiters.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("server stopped"))

    def batch_stats(self) -> Dict[str, int]:
        """(bucket, batch) -> number of device calls made (observability)."""
        with self._stats_lock:
            def _name(bucket):  # fused buckets are (img_width, audio_samples) pairs
                return "x".join(map(str, bucket)) if isinstance(bucket, tuple) else str(bucket)
            return {f"bucket{_name(k[0])}_b{k[1]}": v for k, v in self._batches.items()}

    # ---------------------------------------------------------------- worker

    def _bucket_of(self, payload):
        if self.modality == "image":
            w = payload.shape[1]
            return next(x for x in self.image_widths if x >= w)
        if self.modality == "fused":
            img, wave = payload
            return (next(x for x in self.image_widths if x >= img.shape[1]),
                    next(x for x in self.audio_samples if x >= wave.shape[0]))
        n = payload.shape[0]
        return next(x for x in self.audio_samples if x >= n)

    def _run(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                return
            batch = [req]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=wait)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        groups: Dict[int, List[_Request]] = {}
        for r in batch:
            groups.setdefault(self._bucket_of(r.payload), []).append(r)
        for bucket, reqs in sorted(groups.items()):
            try:
                self._run_group(bucket, reqs)
            except Exception as e:  # surface device errors to every waiter
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _run_group(self, bucket, reqs: List[_Request]) -> None:
        n = len(reqs)
        b = min(self.max_batch, _next_pow2(n))  # pad to a batch bucket
        if self.modality == "fused":
            wb, ab = bucket
            raw = np.full((b, self.image_height, wb), 255, np.uint8)  # white
            hw = np.ones((b, 2), np.int32)
            wave = np.zeros((b, ab), np.float32)  # silence
            ns = np.full((b,), HOP_LENGTH, np.int32)
            for i, r in enumerate(reqs):
                img, wv = r.payload
                h, w = img.shape
                raw[i, :h, :w] = img
                hw[i] = (h, w)
                wave[i, : wv.shape[0]] = wv
                ns[i] = wv.shape[0]
            tokens, scores = self._transcribe(*map(torch.from_numpy, (raw, hw, wave, ns)), self.alpha)
        elif self.modality == "image":
            raw = np.full((b, self.image_height, bucket), 255, np.uint8)  # white
            hw = np.ones((b, 2), np.int32)
            for i, r in enumerate(reqs):
                h, w = r.payload.shape
                raw[i, :h, :w] = r.payload
                hw[i] = (h, w)
            tokens, scores = self._transcribe(torch.from_numpy(raw), torch.from_numpy(hw))
        else:
            wave = np.zeros((b, bucket), np.float32)  # silence
            ns = np.full((b,), HOP_LENGTH, np.int32)
            for i, r in enumerate(reqs):
                wave[i, : r.payload.shape[0]] = r.payload
                ns[i] = r.payload.shape[0]
            tokens, scores = self._transcribe(torch.from_numpy(wave), torch.from_numpy(ns))
        ids, scs = cut_at_eos(tokens, scores, self.eos_id)
        now = time.perf_counter()
        with self._stats_lock:
            self._batches[(bucket, b)] = self._batches.get((bucket, b), 0) + 1
        for i, r in enumerate(reqs):
            words = self.vocab.tokens(ids[i]) if self.vocab is not None else None
            r.future.set_result(Result(ids[i], words, scs[i], now - r.t_submit))


# ------------------------------------------------------------------ HTTP front


def serve_http(server: TranscriptionServer, host: str = "127.0.0.1", port: int = 8787):
    """Minimal stdlib HTTP front. POST /transcribe with a raw .npy body
    ([H,W] uint8 image or [N] float32 waveform, matching the server's
    modality) returns JSON {token_ids, tokens, scores, latency_s}.
    A 'fused' server takes an .npz body with arrays 'image' and 'wave'.
    GET /healthz returns batch stats. Returns the HTTPServer (caller owns
    shutdown); serve_forever runs in a daemon thread."""
    import io
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "batches": server.batch_stats()})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/transcribe":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                arr = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                if server.modality == "fused":
                    arr = (arr["image"], arr["wave"])  # .npz pair
                res = server.transcribe(arr)
                self._json(200, {
                    "token_ids": res.token_ids,
                    "tokens": res.tokens,
                    "scores": res.scores,
                    "latency_s": res.latency_s,
                })
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    httpd = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
