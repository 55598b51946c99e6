"""Dataset + data module: the online data layer.

Port of ``omr_a2s_multimodal_transformer_tpu/data/dataset.py`` (the
reference's ``ARDataset``/``ARDataModule``, its
``src/data/ar_dataset.py:39-442``): batches come out as numpy dicts with
*static bucketed shapes* (see ``collate.py``), which the Trainer moves to
the device. A background thread pool renders and collates the next batches
while the device runs the current one.

Samples are {"x", "y"} for the image and the audio modality and
{"xi", "xa", "y"} for both; the audio frontend is the host numpy
``preprocess_audio``, as in the JAX package, and the frontends read and
write their disk cache (``data/frontends.py``: the spectrograms and the
resized images) in every loader: the thread loader, the worker processes
and the device cache's build.
``loader_backend="grain"`` takes the worker-process loader of
``data/grain_pipeline.py`` (the same batches) in place of the thread
loader.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from omr_a2s_multimodal_transformer_tpu_torch.data import collate as C
from omr_a2s_multimodal_transformer_tpu_torch.data.encoding import KrnParser
from omr_a2s_multimodal_transformer_tpu_torch.data.frontends import (
    preprocess_audio,
    preprocess_image,
    spectrogram_shape,
)
from omr_a2s_multimodal_transformer_tpu_torch.data.sources import MODALITIES, make_source
from omr_a2s_multimodal_transformer_tpu_torch.data.vocab import (
    Vocabulary,
    load_or_build_max_lens,
    load_or_build_vocabulary,
)

GRANDSTAFF_PATH = os.environ.get("GRANDSTAFF_PATH", "./grandstaff")


class ARDataset:
    """Map-style dataset: source sample -> preprocessed arrays + token ids."""

    def __init__(
        self,
        ds_name: str,
        partition_type: str,
        krn_encoding: str = "bekern",
        input_modality: str = "both",
        use_distorted_images: bool = False,
        img_height: Optional[int] = None,
        data_root: Optional[str] = None,
        synthetic: bool = False,
        synthetic_kwargs: Optional[Dict] = None,
        cache_root: Optional[str] = None,
    ) -> None:
        assert input_modality in MODALITIES, f"Invalid input_modality: {input_modality}"
        self.ds_name = ds_name.lower()
        self.partition_type = partition_type
        self.input_modality = input_modality.lower()
        self.use_distorted_images = use_distorted_images
        self.img_height = img_height
        self.parser = KrnParser(encoding=krn_encoding)
        self._source_kwargs = dict(
            encoding=krn_encoding, use_distorted_images=use_distorted_images,
            data_root=data_root, synthetic=synthetic, synthetic_kwargs=synthetic_kwargs,
        )
        self.source = make_source(self.ds_name, partition_type, **self._source_kwargs)

        # Vocabulary + max-lens caches (reference layout, ar_dataset.py:277-295).
        # The vocabulary spans ALL splits of the collection
        # (reference ar_dataset.py:312-321 builds over train+val+test).
        root = cache_root or GRANDSTAFF_PATH
        vocab_name = f"ar_w2i_{krn_encoding}.json"
        self.w2i_path = os.path.join(root, "vocabs", vocab_name)
        self.vocab = load_or_build_vocabulary(self.w2i_path, self._vocab_corpus, krn_encoding)
        max_lens_name = ("ImgDist_" if use_distorted_images else "") + vocab_name
        self.max_lens_path = os.path.join(root, "max_lens", max_lens_name)
        max_lens = load_or_build_max_lens(self.max_lens_path, self._scan_max_lens)
        self.max_seq_len = max_lens["max_seq_len"]
        self.max_image_height = max_lens["max_image_height"]
        self.max_image_width = max_lens["max_image_width"]
        self.max_audio_height = max_lens["max_audio_height"]
        self.max_audio_width = max_lens["max_audio_width"]

    # Reference-parity accessors
    @property
    def w2i(self):
        return self.vocab.w2i

    @property
    def i2w(self):
        return self.vocab.i2w

    def _vocab_corpus(self):
        """Transcripts from every split (single shared vocabulary)."""
        out = []
        for split in ("train", "val", "test"):
            src = self.source if split == self.partition_type else make_source(
                self.ds_name, split, **self._source_kwargs
            )
            out.extend(src.transcripts())
        return out

    def _scan_max_lens(self) -> Dict[str, int]:
        """Cold scan over ALL splits to establish global padding bounds
        (reference ar_dataset.py:349-392 scans the full collection;
        +1 on seq len for EOS). The audio dims come from the waveform's
        length alone (``spectrogram_shape``), the shape the JAX package's
        frontend gives it."""
        msl = mih = miw = mah = maw = 0
        sources = [
            self.source if split == self.partition_type else make_source(self.ds_name, split, **self._source_kwargs)
            for split in ("train", "val", "test")
        ]
        for src in sources:
            for i in range(len(src)):
                s = src[i]
                msl = max(msl, len(self.parser.encode(s["transcript"])) + 1)
                if "audio" in s and s["audio"] is not None:
                    ha, wa = spectrogram_shape(len(s["audio"]["array"]), s["audio"]["sampling_rate"])
                    mah, maw = max(mah, ha), max(maw, wa)
                if "image" in s and s["image"] is not None:
                    xi = preprocess_image(s["image"], self.img_height)
                    mih, miw = max(mih, xi.shape[1]), max(miw, xi.shape[2])
        return {
            "max_seq_len": msl,
            "max_image_height": mih,
            "max_image_width": miw,
            "max_audio_height": mah,
            "max_audio_width": maw,
        }

    def __len__(self) -> int:
        return len(self.source)

    def transcript_ids(self, text: str) -> np.ndarray:
        """<sos> + tokens + <eos> as int ids (reference ar_dataset.py:433-437)."""
        return np.asarray(self.vocab.ids(self.parser.encode(text)), dtype=np.int32)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.source[idx]
        y = self.transcript_ids(s["transcript"])
        if self.input_modality == "image":
            return {"x": preprocess_image(s["image"], self.img_height), "y": y}
        if self.input_modality == "audio":
            return {"x": preprocess_audio(s["audio"]["array"], s["audio"]["sampling_rate"]), "y": y}
        return {
            "xi": preprocess_image(s["image"], self.img_height),
            "xa": preprocess_audio(s["audio"]["array"], s["audio"]["sampling_rate"]),
            "y": y,
        }


class Loader:
    """Batching iterator with static bucketed shapes and background prefetch."""

    def __init__(
        self,
        dataset: ARDataset,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        drop_remainder: bool = False,
        image_bucket: Optional[C.BucketSpec] = None,
        audio_bucket: Optional[C.BucketSpec] = None,
        num_threads: int = 8,
        prefetch: int = 4,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0
        self.num_threads = num_threads
        self.prefetch = prefetch
        m = dataset.input_modality
        self.image_bucket = image_bucket or C.BucketSpec.single(
            dataset.max_image_height, dataset.max_image_width, dataset.max_seq_len + 1
        )
        self.audio_bucket = audio_bucket or C.BucketSpec.single(
            dataset.max_audio_height, dataset.max_audio_width, dataset.max_seq_len + 1
        )
        self.bucket = self.image_bucket if m == "image" else self.audio_bucket
        self.records = range(len(dataset))  # the sample indices it batches (a shard: data/grain_pipeline.py)

    def __len__(self) -> int:
        n = len(self.records) / self.batch_size
        return math.floor(n) if self.drop_remainder else math.ceil(n)

    def _order(self) -> np.ndarray:
        idx = np.arange(self.records.start, self.records.stop)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _collate(self, samples: List[Dict]) -> Dict[str, np.ndarray]:
        m = self.ds.input_modality
        if m == "both":
            hi = max(s["xi"].shape[1] for s in samples)
            wi = max(s["xi"].shape[2] for s in samples)
            ha = max(s["xa"].shape[1] for s in samples)
            wa = max(s["xa"].shape[2] for s in samples)
            ly = max(len(s["y"]) for s in samples)
            ti = self.image_bucket.pick(hi, wi, ly)
            ta = self.audio_bucket.pick(ha, wa, ly)
            return C.collate_multimodal(samples, (ti[0], ti[1]), (ta[0], ta[1]), ti[2])
        pad = C.IMAGE_PAD_VALUE if m == "image" else C.AUDIO_PAD_VALUE
        h = max(s["x"].shape[1] for s in samples)
        w = max(s["x"].shape[2] for s in samples)
        ly = max(len(s["y"]) for s in samples)
        th, tw, tl = self.bucket.pick(h, w, ly)
        return C.collate_unimodal(samples, pad, th, tw, tl)

    def _epoch_batches(self) -> List[List[int]]:
        """The next epoch's batches of sample indices: the shuffle order
        split into batch_size runs, the short last one dropped with
        drop_remainder. Advances the epoch. The worker loader and the
        device cache take their batches from here too."""
        order = self._order()
        self.epoch += 1
        bs = self.batch_size
        batches = [[int(i) for i in order[i:i + bs]] for i in range(0, len(order), bs)]
        if self.drop_remainder and batches and len(batches[-1]) < bs:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._epoch_batches()

        if self.num_threads <= 1:
            for b in batches:
                yield self._collate([self.ds[i] for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a consumer that stops early (a peek at the first batch) sets
            # stop: the producer then ends instead of blocking on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as ex:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(ex.map(self.ds.__getitem__, b))
                        if not put(self._collate(samples)):
                            return
            except Exception as e:  # raised in the consumer, which would otherwise wait forever
                put(e)
                return
            put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


class ARDataModule:
    """Reference-parity facade over ARDataset/Loader
    (reference ar_dataset.py:39-184)."""

    def __init__(
        self,
        ds_name: str,
        krn_encoding: str = "bekern",
        input_modality: str = "both",
        use_distorted_images: bool = False,
        img_height: Optional[int] = None,
        batch_size: int = 16,
        eval_batch_size: Optional[int] = None,
        num_workers: int = 8,
        data_root: Optional[str] = None,
        synthetic: bool = False,
        synthetic_kwargs: Optional[Dict] = None,
        cache_root: Optional[str] = None,
        seed: int = 42,
        loader_backend: str = "threads",  # "threads" | "grain" (worker processes: data/grain_pipeline.py)
        width_buckets: int = 1,  # >1: geometric width-bucket ladder
    ) -> None:
        assert loader_backend in ("threads", "grain")
        self.loader_backend = loader_backend
        self.width_buckets = width_buckets
        self.kwargs = dict(
            ds_name=ds_name,
            krn_encoding=krn_encoding,
            input_modality=input_modality,
            use_distorted_images=use_distorted_images,
            img_height=img_height,
            data_root=data_root,
            synthetic=synthetic,
            synthetic_kwargs=synthetic_kwargs,
            cache_root=cache_root,
        )
        self.input_modality = input_modality
        self.batch_size = batch_size
        # Unlike the reference (batch_size=1 eval), evaluation is batched.
        # Decode has a fixed per-step dispatch cost, so large eval batches
        # amortize it.
        self.eval_batch_size = eval_batch_size or max(batch_size, 64)
        self.num_workers = num_workers
        self.seed = seed
        self.train_ds: Optional[ARDataset] = None
        self.val_ds: Optional[ARDataset] = None
        self.test_ds: Optional[ARDataset] = None

    def setup(self, stage: str) -> None:
        if stage == "fit":
            if self.train_ds is None:
                self.train_ds = ARDataset(partition_type="train", **self.kwargs)
            if self.val_ds is None:
                self.val_ds = ARDataset(partition_type="val", **self.kwargs)
        if stage in ("test", "predict") and self.test_ds is None:
            self.test_ds = ARDataset(partition_type="test", **self.kwargs)

    def _buckets(self, ds: ARDataset):
        if self.width_buckets <= 1:
            return None, None
        img = C.BucketSpec.geometric(ds.max_image_height, ds.max_image_width,
                                     ds.max_seq_len + 1, self.width_buckets)
        audio = C.BucketSpec.geometric(ds.max_audio_height, ds.max_audio_width,
                                       ds.max_seq_len + 1, self.width_buckets)
        return img, audio

    def _make_loader(self, ds: ARDataset, batch_size: int, shuffle: bool, drop_remainder: bool):
        img_bucket, audio_bucket = self._buckets(ds)
        if self.loader_backend == "grain":
            from omr_a2s_multimodal_transformer_tpu_torch.data.grain_pipeline import GrainLoader

            return GrainLoader(ds, batch_size, shuffle=shuffle, seed=self.seed, num_workers=self.num_workers,
                               drop_remainder=drop_remainder, image_bucket=img_bucket, audio_bucket=audio_bucket)
        return Loader(ds, batch_size, shuffle=shuffle, seed=self.seed,
                      drop_remainder=drop_remainder, num_threads=self.num_workers,
                      image_bucket=img_bucket, audio_bucket=audio_bucket)

    def train_dataloader(self):
        return self._make_loader(self.train_ds, self.batch_size, shuffle=True, drop_remainder=True)

    def val_dataloader(self):
        return self._make_loader(self.val_ds, self.eval_batch_size, shuffle=False, drop_remainder=False)

    def test_dataloader(self):
        return self._make_loader(self.test_ds, self.eval_batch_size, shuffle=False, drop_remainder=False)

    def _any_ds(self) -> ARDataset:
        for ds in (self.train_ds, self.val_ds, self.test_ds):
            if ds is not None:
                return ds
        raise RuntimeError("call setup() first")

    def get_w2i_and_i2w(self) -> Tuple[Dict[str, int], Dict[int, str]]:
        ds = self._any_ds()
        return ds.w2i, ds.i2w

    def get_vocab(self) -> Vocabulary:
        return self._any_ds().vocab

    def get_max_seq_len(self) -> int:
        return self._any_ds().max_seq_len

    def get_max_image_height_and_width(self) -> Tuple[int, int]:
        ds = self._any_ds()
        return ds.max_image_height, ds.max_image_width

    def get_max_audio_height_and_width(self) -> Tuple[int, int]:
        ds = self._any_ds()
        return ds.max_audio_height, ds.max_audio_width

    def get_max_input_size(self):
        if self.input_modality == "image":
            return self.get_max_image_height_and_width()
        if self.input_modality == "audio":
            return self.get_max_audio_height_and_width()
        return (self.get_max_image_height_and_width(), self.get_max_audio_height_and_width())
