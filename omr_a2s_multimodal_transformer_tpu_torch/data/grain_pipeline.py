"""Multiprocess input pipeline (``--loader_backend grain``).

Port of ``omr_a2s_multimodal_transformer_tpu/data/grain_pipeline.py``,
which runs on ``grain.DataLoader``. The port keeps its flag and its class
name but runs on ``torch.utils.data.DataLoader`` workers: each worker
renders the samples of a batch (``ARDataset.__getitem__``: tokenizer,
image and log-STFT frontends) and collates them (``Loader._collate``, the
static bucketed shapes); the main process receives the batch through
shared memory, pinned when a GPU is present.

- Order: the batches are the thread ``Loader``'s (its ``_order`` and
  batch split, ``drop_remainder`` included), so unshuffled they equal
  JAX's ``GrainLoader``'s in order, and shuffled they equal the port's and
  JAX's thread loaders'. JAX's shuffled order is grain's own
  ``IndexSampler`` stream, which the port does not reproduce.
- Workers start by ``forkserver``: the parent may hold an initialised CUDA
  context and loader or server threads, which a forked child would copy
  (CUDA cannot be used in it, and a lock held by another thread stays held
  for ever); the fork server is a fresh single-threaded process that never
  touched CUDA, and the workers it forks touch none either.
- The workers persist from one epoch to the next (their start is paid
  once); a consumer that stops early, or a sample that raises, shuts them
  down, and so does ``close``: none is left behind.
- Per-process sharding, JAX's ``ShardByJaxProcess(drop_remainder=True)``
  (its ``shard_by_process`` default, the one value the port takes): in a
  ``torch.distributed`` world of n processes, process i reads records
  [i * k, (i + 1) * k) with k = len // n (the remainder is dropped), in
  its own shuffle order and batches. The streams are disjoint, they
  cover the truncated range and each holds k records. ``set_shard``
  picks another shard (the Trainer shards over the data ranks of a mesh).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.data import collate as C
from omr_a2s_multimodal_transformer_tpu_torch.data.dataset import ARDataset, Loader

START_METHOD = "forkserver"


class _Collate:
    """The thread loader's collate as host tensors (which cross from a
    worker through shared memory, where numpy arrays would be pickled)."""

    def __init__(self, loader: Loader):
        self._loader = loader

    def __call__(self, samples: List[Dict]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v) for k, v in self._loader._collate(samples).items()}


class _Batches:
    """The batch sampler: the epoch's batches, set before each iteration
    (the DataLoader may iterate its sampler more than once an epoch)."""

    def __init__(self):
        self.batches: List[List[int]] = []

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[List[int]]:
        return iter(self.batches)


class GrainLoader:
    """Iterable of static-shape batch dicts (host tensors, pinned on a
    GPU machine), built by ``num_workers`` worker processes."""

    def __init__(
        self,
        dataset: ARDataset,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        num_workers: int = 4,
        drop_remainder: bool = False,
        image_bucket: Optional[C.BucketSpec] = None,
        audio_bucket: Optional[C.BucketSpec] = None,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        self.num_workers = max(1, num_workers)
        self._order_of = Loader(dataset, batch_size, shuffle=shuffle, seed=seed, drop_remainder=drop_remainder,
                                image_bucket=image_bucket, audio_bucket=audio_bucket, num_threads=1)
        self.image_bucket, self.audio_bucket = self._order_of.image_bucket, self._order_of.audio_bucket
        self.bucket = self._order_of.bucket
        self._batches, self._dl = _Batches(), None
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            self.set_shard(dist.get_rank(), dist.get_world_size())
        else:
            self.set_shard(0, 1)

    def set_shard(self, index: int, count: int) -> None:
        """Read shard ``index`` of ``count``: records [index * k, (index +
        1) * k), k = len // count (all of them for one shard)."""
        if not 0 <= index < count:
            raise ValueError(f"shard {index} of {count}")
        n = len(self.ds)
        k = n // count if count > 1 else n
        self.shard_index, self.shard_count = index, count
        self._order_of.records = range(index * k, (index + 1) * k)

    @property
    def epoch(self) -> int:
        return self._order_of.epoch

    @property
    def num_threads(self) -> int:
        return self.num_workers

    def __len__(self) -> int:
        return len(self._order_of)

    # the thread loader's order and collate, which the device cache reads too
    def _epoch_batches(self) -> List[List[int]]:
        return self._order_of._epoch_batches()

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        return self._order_of._collate(samples)

    def _loader(self) -> torch.utils.data.DataLoader:
        if self._dl is None:
            import multiprocessing

            self._dl = torch.utils.data.DataLoader(
                self.ds, batch_sampler=self._batches, collate_fn=_Collate(self._order_of),
                num_workers=self.num_workers, pin_memory=torch.cuda.is_available(), persistent_workers=True,
                multiprocessing_context=multiprocessing.get_context(START_METHOD))
        return self._dl

    def close(self) -> None:
        """Shut the worker processes down (the next iteration starts new ones)."""
        if self._dl is not None and self._dl._iterator is not None:
            self._dl._iterator._shutdown_workers()
        self._dl = None

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        self._batches.batches = self._epoch_batches()
        finished = False
        try:
            yield from self._loader()
            finished = True
        finally:
            if not finished:  # the consumer left early, or a sample raised: no worker stays behind
                self.close()
