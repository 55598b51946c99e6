"""Host-side image/audio frontends (parity path) + disk cache.

Port of ``omr_a2s_multimodal_transformer_tpu/data/frontends.py``:
- image: grayscale, optional aspect-preserving resize to a target height,
  scale to [0, 1]; output [1, H, W] float32, the same values as the JAX
  package's ``preprocess_image`` (which calls PIL's ``convert("L")`` and
  ``resize``);
- audio: resample to 22.05 kHz, band-limited log-STFT in [0, 1]; output
  [1, 195, T] float32, ``ops/stft.py``'s numpy ``log_spectrogram_np``.

The grayscale conversion is numpy, so the synthetic corpus needs neither
PIL nor joblib: a uint8 L image passes through, and RGB takes PIL's own
integer ITU-R 601-2 luma. PIL is imported only for the ``img_height``
resize (PIL's bicubic, which the reference calls) and for PIL images of
other modes.

The audio frontend and the image frontend's resize are memoised to disk,
as the JAX package's frontends are by joblib (which the port does not
need): one ``.npy`` file a call under ``$OMR_A2S_CACHE_DIR`` (default
``./frontend_cache``, read at each call), in a folder per function, named
by a hash of the arguments (the raw array's bytes, dtype and shape, ``sr``
or ``img_height``) and of the source of the code that computes it, so that
an edited frontend never reads what an earlier one wrote (joblib hashes
the function's code too). An image without ``img_height`` is not cached:
its grayscale and scaling cost less than hashing its bytes and reading a
float32 copy back four times their size (PERF.md). An entry is written to
a temporary file and renamed into place, so concurrent loader threads and
worker processes and an interrupted write never leave a partial entry,
and read back memory-mapped (read only). An entry that is missing or
cannot be read is computed again and rewritten (JAX's ``KeyError``
fallback); a cache that cannot be written is skipped. ``stats`` counts
each cached function's hits and misses in this process. ``clear_cache``
empties the cache; ``cli.train`` does so after its run unless given
``--keep_cache``.

``spectrogram_shape`` gives ``preprocess_audio``'s output shape from the
waveform's length alone, which the max-lens scan needs.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import inspect
import math
import os
import shutil
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from omr_a2s_multimodal_transformer_tpu_torch.ops import stft
from omr_a2s_multimodal_transformer_tpu_torch.ops.stft import HOP_LENGTH, NUM_FREQ_BINS, SAMPLE_RATE, log_spectrogram_np


def _require_pil(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs PIL (Pillow), which is not installed") from e
    return Image


def rgb_to_luma(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [H, W]: PIL's ``convert("L")`` of an RGB
    image, L = (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16."""
    c = rgb.astype(np.uint32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def to_grayscale(raw_image) -> np.ndarray:
    """uint8 [H, W] of an image given as a uint8 [H, W] or [H, W, 3] array
    or as a PIL image."""
    if hasattr(raw_image, "convert"):  # a PIL image
        if raw_image.mode not in ("L", "RGB"):
            raw_image = raw_image.convert("L")
        raw_image = np.asarray(raw_image)
    arr = np.asarray(raw_image)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected a uint8 image, got {arr.dtype}")
    if arr.ndim == 2:
        return arr
    if arr.ndim == 3 and arr.shape[2] == 3:
        return rgb_to_luma(arr)
    raise ValueError(f"expected an [H, W] or [H, W, 3] image, got shape {arr.shape}")


CACHE_ENV = "OMR_A2S_CACHE_DIR"
DEFAULT_CACHE_DIR = "./frontend_cache"
_CACHED = []  # the cached functions' folder names
stats = collections.Counter()  # (function name, "hit" or "miss") -> calls in this process
_stats_lock = threading.Lock()  # loader threads count at once


def cache_dir() -> str:
    return os.environ.get(CACHE_ENV, DEFAULT_CACHE_DIR)


def _key(name: str, arr: np.ndarray, extra, code: str = "") -> str:
    h = hashlib.blake2b(digest_size=20)
    h.update(repr((name, code, arr.dtype.str, arr.shape, extra)).encode())
    h.update(np.ascontiguousarray(arr).data)
    return h.hexdigest()


def _load(path: str) -> Optional[np.ndarray]:
    try:
        return np.load(path, mmap_mode="r", allow_pickle=False)
    except (OSError, ValueError, EOFError):  # missing, truncated or not an array
        return None


def _store(path: str, out: np.ndarray) -> None:
    folder = os.path.dirname(path)
    try:
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    except OSError:
        return
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, out, allow_pickle=False)
        os.replace(tmp, path)
    except OSError:  # a full disk, or the folder cleared meanwhile: the result stands uncached
        try:
            os.unlink(tmp)
        except OSError:
            pass


def code_hash(*code) -> str:
    """A hash of the source of ``code`` (functions and modules)."""
    return hashlib.blake2b("".join(map(inspect.getsource, code)).encode(), digest_size=8).hexdigest()


def _cached(as_array, *code):
    """Memoise ``fn(raw, arg)`` to disk, keyed by ``as_array(raw)``, ``arg``
    and the source of ``fn`` and of ``code`` (the functions and modules it
    computes with), which the wrapper keeps as ``.code``."""

    def wrap(fn):
        _CACHED.append(fn.__name__)
        sig = inspect.signature(fn)
        src = code_hash(fn, *code)

        @functools.wraps(fn)
        def cached(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            raw, *rest = bound.arguments.values()
            path = os.path.join(cache_dir(), fn.__name__,
                                _key(fn.__name__, as_array(raw), tuple(rest), src) + ".npy")
            out = _load(path)
            with _stats_lock:
                stats[fn.__name__, "miss" if out is None else "hit"] += 1
            if out is None:
                out = fn(*bound.args, **bound.kwargs)
                _store(path, out)
            return out

        cached.code = src
        return cached

    return wrap


def clear_cache() -> None:
    """Remove every cached frontend output (the cached functions' folders
    under ``cache_dir()``, nothing else there)."""
    for name in _CACHED:
        shutil.rmtree(os.path.join(cache_dir(), name), ignore_errors=True)


def _scaled(gray: np.ndarray) -> np.ndarray:
    return (np.asarray(gray, dtype=np.float32) / 255.0)[None, ...]


@_cached(lambda raw: to_grayscale(raw) if hasattr(raw, "convert") else np.asarray(raw),  # a PIL image by its pixels
         to_grayscale, rgb_to_luma, _scaled)
def resized_image(raw_image, img_height: int) -> np.ndarray:
    """Image -> [1, img_height, W'] float32 in [0, 1], the width scaled to
    keep the aspect (PIL's bicubic resize)."""
    image = _require_pil("preprocess_image(img_height=...)").fromarray(to_grayscale(raw_image))
    new_width = int(img_height * image.size[0] / image.size[1])
    return _scaled(np.asarray(image.resize((new_width, img_height))))


def preprocess_image(raw_image, img_height: Optional[int] = None) -> np.ndarray:
    """Image -> [1, H, W] float32 in [0, 1]; resized to ``img_height``
    (cached, ``resized_image``) where it is given."""
    if img_height is not None:
        return resized_image(raw_image, img_height)
    return _scaled(to_grayscale(raw_image))


def spectrogram_shape(num_samples: int, sr: float) -> Tuple[int, int]:
    """(bins, frames) of ``preprocess_audio``'s output for a waveform of
    num_samples at sr: resampled to 22.05 kHz by a polyphase filter
    (ceil(n * up / down) samples), then a centered STFT of hop 512."""
    if int(sr) != SAMPLE_RATE:
        g = math.gcd(int(sr), SAMPLE_RATE)
        up, down = SAMPLE_RATE // g, int(sr) // g
        num_samples = -(-num_samples * up // down)
    return NUM_FREQ_BINS, 1 + num_samples // HOP_LENGTH


@_cached(lambda raw: np.asarray(raw, np.float32), stft)
def preprocess_audio(raw_audio: np.ndarray, sr: float) -> np.ndarray:
    """Waveform -> [1, NUM_FREQ_BINS, T] float32 log-spectrogram in [0, 1]."""
    x = log_spectrogram_np(np.asarray(raw_audio, np.float32), sr=sr)
    return x[None, ...].astype(np.float32)
