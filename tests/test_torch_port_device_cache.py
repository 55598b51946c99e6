"""The port's device-resident corpus (``data/device_cache.py``) on the
CPU, the counterparts of tests/test_device_cache.py:

- cached batches bit-identical to the streaming loader's over two epochs
  (the same shuffle stream), for the image and the multimodal corpus;
- the bf16 cast of the float inputs, the int keys untouched;
- a multi-bucket loader rejected;
- uint8 image residency: batches bit-identical to the streaming batch cast
  to bf16 (what the bf16 step reads), the stack really uint8; pixels that
  are not k/255 rejected at the build;
- equal to the JAX package's cache (forced to one row a shard, the TPU
  compiler's workaround the port leaves out), in float32 and bf16;
- two Trainer fits from one seed, with and without the cache (u8 images):
  equal losses. In float32: the bf16 batches are held bit-equal above,
  and the CPU's bf16 matmuls, run on many threads, gave two such fits
  1e-5 apart.
"""

import json

import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu.data import dataset as jds
from omr_a2s_multimodal_transformer_tpu.data.device_cache import DeviceCacheLoader as JaxCache
from omr_a2s_multimodal_transformer_tpu_torch.data import collate as C
from omr_a2s_multimodal_transformer_tpu_torch.data.dataset import ARDataModule, Loader
from omr_a2s_multimodal_transformer_tpu_torch.data.device_cache import DeviceCacheLoader
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

torch.set_num_threads(2)  # several pytest workers share the host

SYN = dict(n=7, img_height_range=(32, 33), img_width_range=(64, 96), audio_seconds_range=(0.3, 0.5), n_measures=1)
KW = dict(ds_name="synthetic", krn_encoding="kern", batch_size=3, num_workers=2, synthetic=True,
          synthetic_kwargs=SYN)


@pytest.fixture(scope="module", params=["image", "both"])
def dm(request, tmp_path_factory):
    dm = ARDataModule(input_modality=request.param, cache_root=str(tmp_path_factory.mktemp("cache")), **KW)
    dm.setup("fit")
    return dm


def _bits(t):
    """A batch value as comparable numpy bits (bf16 as uint16)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    t = np.asarray(t)
    return t.view(np.uint16) if t.dtype.name == "bfloat16" else t


def test_cached_batches_bit_identical_across_epochs(dm):
    stream = dm.train_dataloader()
    cached = DeviceCacheLoader(dm.train_dataloader(), "cpu")
    assert len(stream) == len(cached)
    for _epoch in range(2):  # the shuffle stream advances alike
        sb, cb = list(stream), list(cached)
        assert len(sb) == len(cb) > 0
        for s, c in zip(sb, cb):
            assert set(s) == set(c)
            for k in s:
                assert c[k].device.type == "cpu" and c[k].dtype == torch.from_numpy(s[k]).dtype
                np.testing.assert_array_equal(s[k], c[k].numpy(), err_msg=k)


def test_cast_bf16_matches_trainer_cast(dm):
    b = next(iter(DeviceCacheLoader(dm.train_dataloader(), "cpu", cast_bf16=True)))
    s = next(iter(dm.train_dataloader()))
    float_keys = [k for k in ("x", "xi", "xa") if k in b]
    assert float_keys
    for k in b:
        if k in float_keys:  # the Trainer's cast of the streaming batch
            assert b[k].dtype == torch.bfloat16
            assert torch.equal(b[k].view(torch.int16), torch.from_numpy(s[k]).to(torch.bfloat16).view(torch.int16))
        else:
            assert b[k].dtype == torch.int32


def test_multibucket_rejected(dm):
    ds = dm.train_ds
    spec = C.BucketSpec.geometric(ds.max_image_height, ds.max_image_width, ds.max_seq_len + 1, 3)
    loader = Loader(ds, 3, shuffle=False, image_bucket=spec, audio_bucket=spec)
    with pytest.raises(ValueError, match="single-bucket"):
        DeviceCacheLoader(loader, "cpu")


@pytest.mark.parametrize("cast_bf16", [True, False], ids=["bf16", "f32"])
def test_store_u8_bit_identical_to_streaming(dm, cast_bf16):
    """u8 image residency: the dequantized batches equal the streaming
    batches (cast to bf16 as the Trainer casts them, or float32) bit for
    bit; spectrograms stay in the cast path."""
    stream = DeviceCacheLoader(dm.train_dataloader(), "cpu", cast_bf16=cast_bf16)
    u8 = DeviceCacheLoader(dm.train_dataloader(), "cpu", cast_bf16=cast_bf16, store_u8=True)
    img_key = {"image": "x", "both": "xi"}[dm.train_ds.input_modality]
    for rb, ub in zip(stream, u8):
        assert ub[img_key].dtype == (torch.bfloat16 if cast_bf16 else torch.float32)
        for k in rb:
            np.testing.assert_array_equal(_bits(rb[k]), _bits(ub[k]), err_msg=k)
    assert u8._stacks[img_key].dtype == torch.uint8  # the point: 4x the corpus a byte against float32
    assert u8.nbytes() < stream.nbytes()


def test_store_u8_rejects_non_k255_pixels(dm):
    loader = dm.train_dataloader()
    orig = loader._collate

    def poisoned(samples):
        b = orig(samples)
        for k in ("x", "xi"):
            if k in b and b[k].dtype == np.float32:
                b[k] = b[k] * np.float32(0.7)
        return b

    loader._collate = poisoned
    with pytest.raises(ValueError, match="store_u8"):
        next(iter(DeviceCacheLoader(loader, "cpu", cast_bf16=True, store_u8=True)))


@pytest.mark.parametrize("cast_bf16", [False, True], ids=["f32", "bf16"])
def test_equals_jax_cache_forced_to_shards(dm, tmp_path, cast_bf16):
    jdm = jds.ARDataModule(input_modality=dm.train_ds.input_modality, cache_root=str(tmp_path), **KW)
    jdm.setup("fit")
    jax_cache = JaxCache(jdm.train_dataloader(), cast_bf16=cast_bf16)
    jax_cache.max_stack_bytes = 1  # one row a shard
    port = DeviceCacheLoader(dm.train_dataloader(), "cpu", cast_bf16=cast_bf16)
    for _epoch in range(2):
        jb, pb = list(jax_cache), list(port)
        assert len(jb) == len(pb) > 0
        for a, b in zip(jb, pb):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)
    assert all(len(shards) == len(dm.train_ds) for shards in jax_cache._stacks.values())


def test_trainer_losses_equal_with_device_cache(tmp_path):
    """Two fits from one seed, streaming and device-cached (u8 images):
    the same per-epoch train losses."""
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.training.loop import Trainer

    def fit(**cache):
        dm = ARDataModule(input_modality="image", cache_root=str(tmp_path / "data"), **dict(KW, num_workers=1))
        dm.setup("fit")
        vocab = dm.get_vocab()
        hp = dict(vocab_size=len(vocab), max_seq_len=dm.get_max_seq_len(), input_modality="image", attn_window=10)
        model, _ = build_model(hp, device="cpu", seed=0)
        tag = "dc" if cache else "st"
        tr = Trainer(model, vocab, hp, weights_dir=str(tmp_path / f"w_{tag}"), run_dir=str(tmp_path / f"r_{tag}"),
                     epochs=2, check_val_every_n_epoch=10, bf16_compute=False, device="cpu", **cache)
        tr.fit(dm, auto_resume=False)
        recs = [json.loads(line) for line in open(tr.logger.path)]
        resident = [r for r in recs if "device_cache_bytes" in r]  # logged by the fit, whose cache it freed
        assert len(resident) == bool(cache)
        if cache:
            assert resident[0]["device_cache_bytes"] > 0 and resident[0]["device_cache_samples"] == len(dm.train_ds)
        return [r["train_loss"] for r in recs if "train_loss" in r]

    a, b = fit(), fit(device_cache=True, device_cache_u8=True)
    assert len(a) == len(b) == 2
    assert a == b


def test_device_cache_over_the_worker_loader(dm):
    """--device_cache with --loader_backend grain: the cache reads the
    worker loader's order and collate (no worker starts) and gives the
    thread loader's batches."""
    from omr_a2s_multimodal_transformer_tpu_torch.data.grain_pipeline import GrainLoader

    ds = dm.train_ds
    grain = GrainLoader(ds, 3, shuffle=True, seed=dm.seed, num_workers=2, drop_remainder=True)
    cached, stream = DeviceCacheLoader(grain, "cpu"), dm.train_dataloader()
    for _epoch in range(2):
        sb, cb = list(stream), list(cached)
        assert len(sb) == len(cb) > 0
        for s, c in zip(sb, cb):
            for k in s:
                np.testing.assert_array_equal(s[k], c[k].numpy(), err_msg=k)
    assert grain.epoch == 2 and grain._dl is None
