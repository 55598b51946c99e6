"""The port's data path, SER and host utilities against the JAX package.

Exact equality throughout (no tolerance): the same synthetic source and
seed give the same pixels, audio and transcripts; the port's data module
gives the same batches (x, x_hw, frames, y_in, y_out) from its train, val
and test loaders, in the same shuffle order over two epochs, with one and
with three width buckets; the vocabulary and max-lens caches are the same
bytes, and either package reads the other's; the frontend gives the same
float32 for L, RGB and resized images (the port's RGB luma is numpy,
checked bit for bit against PIL); ``compute_ed_metrics`` gives the same
numbers on random token lists, empty ones among them.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from omr_a2s_multimodal_transformer_tpu.data import dataset as jds
from omr_a2s_multimodal_transformer_tpu.data import frontends as jfe
from omr_a2s_multimodal_transformer_tpu.data import sources as jsrc
from omr_a2s_multimodal_transformer_tpu.utils import metrics as jmetrics
from omr_a2s_multimodal_transformer_tpu_torch.data import dataset as pds
from omr_a2s_multimodal_transformer_tpu_torch.data import frontends as pfe
from omr_a2s_multimodal_transformer_tpu_torch.data import sources as psrc
from omr_a2s_multimodal_transformer_tpu_torch.utils import edit_distance as ped
from omr_a2s_multimodal_transformer_tpu_torch.utils import metrics as pmetrics
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

# the corpus of tests/test_cli_e2e.py
SYN = dict(n=6, img_height_range=(32, 33), img_width_range=(64, 96), audio_seconds_range=(0.3, 0.5), n_measures=1)
# varied score lengths, so that width buckets split the batches
SYN_VARIED = dict(SYN, n=7, n_measures=2, n_measures_range=(1, 3), render_style="grand")


def _dms(tmp_path, syn, width_buckets, batch_size=3):
    kw = dict(ds_name="synthetic", krn_encoding="kern", input_modality="image", batch_size=batch_size,
              eval_batch_size=2, synthetic=True, synthetic_kwargs=syn, seed=5, width_buckets=width_buckets)
    dj = jds.ARDataModule(num_workers=1, cache_root=str(tmp_path / "jax"), **kw)
    dp = pds.ARDataModule(num_workers=2, cache_root=str(tmp_path / "port"), **kw)  # the thread loader
    for dm in (dj, dp):
        dm.setup("fit")
        dm.setup("test")
    return dj, dp


def _assert_batches_equal(lj, lp, what):
    bj, bp = list(lj), list(lp)
    assert len(bj) == len(bp) == len(lj) == len(lp) > 0, what
    for i, (a, b) in enumerate(zip(bj, bp)):
        assert sorted(a) == sorted(b), what
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{what} batch {i} {k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} batch {i} {k}")


@pytest.mark.parametrize("syn", [SYN, SYN_VARIED], ids=["blob", "grand_varied"])
@pytest.mark.parametrize("width_buckets", [1, 3])
def test_batches_equal_jax_over_two_epochs(tmp_path, syn, width_buckets):
    dj, dp = _dms(tmp_path, syn, width_buckets)
    assert dj.get_max_seq_len() == dp.get_max_seq_len()
    assert dj.get_max_image_height_and_width() == dp.get_max_image_height_and_width()
    assert dj.get_max_audio_height_and_width() == dp.get_max_audio_height_and_width()
    lj, lp = dj.train_dataloader(), dp.train_dataloader()
    for epoch in range(2):  # the shuffle order moves with the loader's epoch
        _assert_batches_equal(lj, lp, f"train epoch {epoch}")
    assert lj.epoch == lp.epoch == 2
    _assert_batches_equal(dj.val_dataloader(), dp.val_dataloader(), "val")
    _assert_batches_equal(dj.test_dataloader(), dp.test_dataloader(), "test")


def test_varied_corpus_fills_more_than_one_width_bucket(tmp_path):
    _, dp = _dms(tmp_path, SYN_VARIED, 3, batch_size=1)
    widths = {b["x"].shape[2] for b in dp.train_dataloader()}
    assert len(widths) > 1, widths


def test_vocab_and_max_lens_caches_are_the_same_bytes(tmp_path):
    _dms(tmp_path, SYN, 1)
    for sub in ("vocabs", "max_lens"):
        j = (tmp_path / "jax" / sub / "ar_w2i_kern.json").read_bytes()
        p = (tmp_path / "port" / sub / "ar_w2i_kern.json").read_bytes()
        assert j == p, sub
    # either package reads the other's cache: a source that could not build them is never asked
    for cache, mod in ((tmp_path / "jax", pds), (tmp_path / "port", jds)):
        ds = mod.ARDataset("synthetic", "test", krn_encoding="kern", input_modality="image", synthetic=True,
                           synthetic_kwargs=dict(SYN, n=1), cache_root=str(cache))
        assert ds.vocab.w2i == json.loads((tmp_path / "jax" / "vocabs" / "ar_w2i_kern.json").read_text())
        assert ds.max_seq_len == json.loads((tmp_path / "port" / "max_lens" / "ar_w2i_kern.json").read_text())[
            "max_seq_len"]


@pytest.mark.parametrize("kw", [SYN, SYN_VARIED, dict(n=3, audio_style="bands", render_style="blob")],
                         ids=["blob", "grand_varied", "bands"])
def test_synthetic_source_renders_what_jax_renders(kw):
    sj, sp = jsrc.SyntheticSource(seed=3, **kw), psrc.SyntheticSource(seed=3, **kw)
    assert sj.transcripts() == sp.transcripts()
    for i in range(len(sj)):
        a, b = sj[i], sp[i]
        assert a["transcript"] == b["transcript"]
        assert b["image"].dtype == np.uint8 and b["image"].ndim == 2
        np.testing.assert_array_equal(np.asarray(a["image"]), b["image"])
        np.testing.assert_array_equal(a["audio"]["array"], b["audio"]["array"])
        assert a["audio"]["sampling_rate"] == b["audio"]["sampling_rate"]
        np.testing.assert_array_equal(jfe.preprocess_image(a["image"]), pfe.preprocess_image(b["image"]))


def test_rgb_luma_equals_pil_bit_for_bit():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(67, 131, 3), dtype=np.uint8)
    corners = np.array([[[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0]],
                        [[0, 0, 255], [1, 2, 3], [254, 253, 252], [128, 127, 129]]], np.uint8)
    for arr in (rgb, corners):
        want = np.asarray(Image.fromarray(arr).convert("L"))
        np.testing.assert_array_equal(pfe.rgb_to_luma(arr), want)
        np.testing.assert_array_equal(pfe.preprocess_image(arr), jfe.preprocess_image(Image.fromarray(arr)))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("img_height", [None, 24, 57])
def test_preprocess_image_equals_jax(mode, img_height):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, size=(40, 90, 3), dtype=np.uint8)
    image = Image.fromarray(rgb).convert(mode)
    got = pfe.preprocess_image(image, img_height)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jfe.preprocess_image(image, img_height))


@pytest.mark.parametrize("sr", [22050, 16000, 44100, 48000])
def test_spectrogram_shape_equals_the_jax_frontend(sr):
    for n in (1, 511, 512, 22050, 33333):
        wave = np.zeros(n, np.float32)
        assert pfe.spectrogram_shape(n, sr) == jfe.preprocess_audio(wave, sr).shape[1:], (n, sr)


def test_directory_source_gives_what_jax_gives(tmp_path):
    """A prepared tree (partitions + krn/img/wav per composer): the same
    transcripts and, through each package's frontend, the same pixels."""
    from scipy.io import wavfile

    syn = psrc.SyntheticSource(n=2, seed=4, **{k: v for k, v in SYN.items() if k != "n"})
    (tmp_path / "partitions" / "mozart").mkdir(parents=True)
    for sub in ("krn", "img", "wav"):
        (tmp_path / "mozart" / sub).mkdir(parents=True)
    names = []
    for i in range(2):
        s, name = syn[i], f"piece{i}"
        names.append(name)
        (tmp_path / "mozart" / "krn" / f"{name}.krn").write_text(s["transcript"])
        Image.fromarray(np.stack([s["image"]] * 3, -1)).save(tmp_path / "mozart" / "img" / f"{name}.jpg")
        wavfile.write(str(tmp_path / "mozart" / "wav" / f"{name}.wav"), 22050, s["audio"]["array"])
    (tmp_path / "partitions" / "mozart" / "train.txt").write_text("\n".join(names) + "\n")
    dj = jsrc.make_source("mozart", "train", "kern", data_root=str(tmp_path))
    dp = psrc.make_source("mozart", "train", "kern", data_root=str(tmp_path))
    assert isinstance(dp, psrc.DirectorySource) and dj.transcripts() == dp.transcripts()
    for i in range(2):
        a, b = dj[i], dp[i]
        assert a["transcript"] == b["transcript"]
        np.testing.assert_array_equal(jfe.preprocess_image(a["image"]), pfe.preprocess_image(b["image"]))
        np.testing.assert_array_equal(a["audio"]["array"], b["audio"]["array"])


def _random_rows(rng, n_rows, vocab, empty_every):
    rows = []
    for i in range(n_rows):
        n = 0 if i % empty_every == 0 else int(rng.integers(1, 30))
        rows.append([vocab[int(t)] for t in rng.integers(0, len(vocab), size=n)])
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_compute_ed_metrics_equals_jax(seed):
    rng = np.random.default_rng(seed)
    vocab = [f"tok{i}" for i in range(7)] + ["<coc>", "DOT"]
    y_true = _random_rows(rng, 25, vocab, empty_every=7)
    y_pred = _random_rows(rng, 25, vocab, empty_every=5)
    y_pred[3] = list(y_true[3])  # one exact row
    assert pmetrics.compute_ed_metrics(y_true, y_pred) == jmetrics.compute_ed_metrics(y_true, y_pred)
    assert pmetrics.compute_metrics(y_true, y_pred) == jmetrics.compute_metrics(y_true, y_pred)
    for t, p in zip(y_true, y_pred):
        assert ped.levenshtein(t, p) == ped.levenshtein_python(t, p)
    assert pmetrics.compute_ed_metrics([], []) == jmetrics.compute_ed_metrics([], [])
    assert pmetrics.compute_ed_metrics([[]], [["a"]]) == jmetrics.compute_ed_metrics([[]], [["a"]])


def test_unported_data_paths_raise(tmp_path):
    """Every data path is ported now: MV2H, the audio frontend, the
    multimodal collate and the audio/both datasets
    (tests/test_torch_port_mv2h.py and test_torch_port_audio.py hold them
    against the JAX package), and the grain loader, whose worker processes
    give the thread loader's batches (tests/test_torch_port_loader.py)."""
    rows = [["*clefG2", "<cor>", "4c", "<cor>", "=", "<cor>"]]
    got = pmetrics.compute_metrics(rows, rows, compute_mv2h=True)
    assert got == jmetrics.compute_metrics(rows, rows, compute_mv2h=True) and got["mv2h"] == 1.0
    for modality in ("audio", "both"):
        ds = pds.ARDataset("synthetic", "train", krn_encoding="kern", input_modality=modality, synthetic=True,
                           synthetic_kwargs=SYN, cache_root=str(tmp_path))
        assert set(ds[0]) == ({"x", "y"} if modality == "audio" else {"xi", "xa", "y"})
    kw = dict(krn_encoding="kern", input_modality="image", batch_size=3, num_workers=2, synthetic=True,
              synthetic_kwargs=SYN, cache_root=str(tmp_path))
    threads, grain = (pds.ARDataModule("synthetic", loader_backend=b, **kw) for b in ("threads", "grain"))
    for dm in (threads, grain):
        dm.setup("test")
    got = [{k: np.asarray(v) for k, v in b.items()} for b in grain.test_dataloader()]
    _assert_batches_equal(threads.test_dataloader(), got, "grain")


def test_loader_stops_its_producer_and_raises_its_errors(tmp_path):
    """A consumer that takes one batch and leaves ends the producer thread;
    an error in a sample reaches the consumer instead of a wait forever."""
    import threading

    dm = pds.ARDataModule("synthetic", krn_encoding="kern", input_modality="image", batch_size=1,
                          num_workers=2, synthetic=True, synthetic_kwargs=dict(SYN, n=12),
                          cache_root=str(tmp_path))
    dm.setup("fit")
    loader = dm.train_dataloader()
    loader.prefetch = 1
    before = threading.active_count()
    assert next(iter(loader))["x"].shape[0] == 1
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before

    def broken(idx):
        raise OSError(f"unreadable sample {idx}")

    loader.ds.__getitem__ = broken
    with pytest.raises(OSError, match="unreadable sample"):
        list(loader)
