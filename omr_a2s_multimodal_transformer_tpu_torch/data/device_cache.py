"""Device-resident dataset cache: the preprocessed train corpus held in
device memory once, each batch gathered there.

Port of ``omr_a2s_multimodal_transformer_tpu/data/device_cache.py``. The
streaming loader renders, collates and ships every batch every epoch; a
corpus of a few thousand samples fits in a fraction of the card's memory,
so each sample is preprocessed and collated once, the per-key stacks go to
the device once, and a step's batch is one ``index_select`` over them by a
host-chosen index list (a few hundred bytes a step over the bus).

Exactness: with a single-bucket ``BucketSpec`` every sample pads to the
same static target, so the rows of a per-sample collation are the rows of
any batch's collation, and the cached batches are bit-identical to the
streaming loader's (same shuffle stream: ``Loader._order`` is reused, with
its batch split and ``drop_remainder``). Multi-bucket loaders are rejected.

Each key is one stack on the device. JAX splits stacks above 4 GiB into
row shards, a limit of the TPU compiler's gathers; the card has no such
limit, so the port keeps one stack a key (the gathers give the same bits).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# float input keys stored as bf16 when the train step computes in bf16 (it
# casts them there anyway: Trainer._BF16_SHIP_KEYS)
_CAST_KEYS = ("x", "xi", "xa")

# image keys per input modality: eligible for uint8 residency (pixels are
# k/255 for u8-origin images with no resize, so u8 round-trips exactly;
# spectrograms are arbitrary floats and stay in the cast path)
_IMAGE_KEYS = {"image": ("x",), "both": ("xi",), "audio": ()}

# samples per preprocessing chunk while building the cache
_CHUNK = 16

# u8 -> the float32 the host frontend gives (np.float32(k) / 255): a table,
# so the device gives the host's bits whatever its division does
_U8_TABLE = np.arange(256, dtype=np.float32) / np.float32(255.0)


def _single_bucket(spec) -> bool:
    return len(spec.heights) == 1 and len(spec.widths) == 1 and len(spec.lengths) == 1


class DeviceCacheLoader:
    """Wrap a ``dataset.Loader``; same iteration protocol, same batches
    (bit-identical under a single-bucket spec) as tensors on ``device``.

    Builds lazily on the first iteration: collates sample chunks on host
    threads, casts float inputs to bf16 with ``cast_bf16`` (image keys to
    uint8 with ``store_u8``, checked exact), concatenates on the host and
    ships each key to ``device`` once, from pinned memory.
    """

    def __init__(self, loader, device, cast_bf16: bool = False, store_u8: bool = False):
        m = loader.ds.input_modality
        buckets: Tuple = (loader.image_bucket, loader.audio_bucket) if m == "both" else (loader.bucket,)
        if not all(_single_bucket(b) for b in buckets):
            raise ValueError(
                "DeviceCacheLoader requires single-bucket specs (batch padding must not depend on batch "
                "composition); use the streaming Loader for width-bucketed corpora"
            )
        self.loader = loader
        self.device = torch.device(device)
        self.batch_size = loader.batch_size
        self.cast_dtype = torch.bfloat16 if cast_bf16 else None
        self.u8_keys = _IMAGE_KEYS.get(m, ()) if store_u8 else ()
        self._stacks: Dict[str, torch.Tensor] = {}
        self._u8_table = None

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def ds(self):
        return self.loader.ds

    def _epoch_batches(self):
        return self.loader._epoch_batches()  # the streaming Loader's shuffle stream and batch split

    def close(self) -> None:
        """Free the stacks (the next iteration builds them again)."""
        self._stacks, self._u8_table = {}, None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._stacks.values())

    def _host_chunk(self, idx) -> Dict[str, torch.Tensor]:
        batch = self.loader._collate([self.loader.ds.__getitem__(i) for i in idx])
        out = {}
        for k, v in batch.items():
            if k in self.u8_keys and v.dtype == np.float32:
                q = np.round(v * 255.0).astype(np.uint8)
                if not np.array_equal(_U8_TABLE[q], v):
                    raise ValueError(f"device cache store_u8: key '{k}' is not exactly k/255-valued (resized or "
                                     "non-u8-origin images?); disable u8 residency for this corpus")
                v = q
            t = torch.from_numpy(v)
            if self.cast_dtype is not None and k in _CAST_KEYS and k not in self.u8_keys and t.dtype == torch.float32:
                t = t.to(self.cast_dtype)
            out[k] = t
        return out

    def _build(self) -> None:
        n = len(self.loader.ds)
        chunks = [list(range(lo, min(lo + _CHUNK, n))) for lo in range(0, n, _CHUNK)]
        with ThreadPoolExecutor(max_workers=max(1, self.loader.num_threads)) as ex:
            host_chunks = list(ex.map(self._host_chunk, chunks))
        # concatenate on the host and ship each key once: chunk copies on the
        # device and a device concatenate would hold twice the corpus there
        pin = self.device.type == "cuda"
        self._stacks = {}
        for k in list(host_chunks[0]):
            host = torch.cat([c.pop(k) for c in host_chunks])
            if pin:
                host = host.pin_memory()
            self._stacks[k] = host.to(self.device)
            del host
        if self.u8_keys:
            self._u8_table = torch.from_numpy(_U8_TABLE).to(self.device)
        logger.info("device cache: %d samples, %.1f MB resident (%s)", n, self.nbytes() / 2 ** 20,
                    ", ".join(f"{k}:{t.dtype}{list(t.shape)}" for k, t in self._stacks.items()))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if not self._stacks:
            self._build()
        for b in self._epoch_batches():
            idx = torch.as_tensor(np.asarray(b, np.int64)).to(self.device, non_blocking=True)
            out = {k: t.index_select(0, idx) for k, t in self._stacks.items()}
            for k in self.u8_keys:
                # u8 -> the host's float32 k/255 by the table, then the step's dtype: the streaming
                # batch's f32 cast to bf16 on the device, bit for bit
                out[k] = self._u8_table[out[k].int()].to(self.cast_dtype or torch.float32)
            yield out
