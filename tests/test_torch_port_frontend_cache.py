"""The port's frontend disk cache (``data/frontends.py``) on the CPU, each
test in a cache folder of its own (``OMR_A2S_CACHE_DIR``):

- ``preprocess_image`` (a uint8 array, an RGB array, a PIL image with the
  ``img_height`` resize) and ``preprocess_audio`` give the JAX package's
  values bit for bit, computed and read back from the cache; an image
  without ``img_height`` is not cached;
- a second call computes nothing, and reads a read-only memory map; the
  key holds the source of the code that computes the entry;
- ``clear_cache`` removes every entry and nothing else in the folder;
- a truncated entry is computed again and rewritten whole;
- two processes writing one key leave one whole entry and no temporary file;
- the thread loader's second epoch, read from the cache, equals its first;
- ``cli.train`` (with ``--img_height``) keeps the cache with
  ``--keep_cache`` and empties it without.
"""

import multiprocessing

import numpy as np
import pytest
import torch
import torch_port_dist as D

from omr_a2s_multimodal_transformer_tpu.data import frontends as jfr
from omr_a2s_multimodal_transformer_tpu_torch.data import dataset as pds
from omr_a2s_multimodal_transformer_tpu_torch.data import frontends as pfr

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for cli.train's tiny steps: CPU kernels slow down many times over when the test workers'
    threads outnumber the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    root = tmp_path / "frontend_cache"
    monkeypatch.setenv(pfr.CACHE_ENV, str(root))
    return root


def _entries(root, name=None):
    return sorted(p for p in root.rglob("*") if p.is_file() and (name is None or p.parent.name == name))


def _jax(fn):
    return getattr(fn, "__wrapped__", fn)  # JAX's frontend without its joblib cache


def _inputs():
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (33, 71), dtype=np.uint8)
    rgb = rng.integers(0, 256, (20, 45, 3), dtype=np.uint8)
    wave = (0.3 * rng.standard_normal(SR // 2)).astype(np.float32)
    return gray, rgb, wave


def test_cached_frontends_equal_jax_bit_for_bit(cache):
    from PIL import Image

    gray, rgb, wave = _inputs()
    cases = [
        ("preprocess_image", lambda f: f(Image.fromarray(gray), None), pfr.preprocess_image, gray, None),
        ("preprocess_image", lambda f: f(Image.fromarray(rgb), None), pfr.preprocess_image, rgb, None),
        ("preprocess_image", lambda f: f(Image.fromarray(gray), 24), pfr.preprocess_image, Image.fromarray(gray), 24),
        ("preprocess_audio", lambda f: f(wave, SR), pfr.preprocess_audio, wave, SR),
    ]
    for name, jax_call, port, raw, arg in cases:
        want = jax_call(_jax(getattr(jfr, name)))
        for _ in range(2):  # computed, then read back
            got = port(raw, arg)
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert np.array_equal(np.asarray(got), want), name
    assert [p.parent.name for p in _entries(cache)] == ["preprocess_audio", "resized_image"]  # the resize alone


def test_second_call_computes_nothing(cache, monkeypatch):
    gray, _, wave = _inputs()
    calls = []
    for name in ("log_spectrogram_np", "to_grayscale"):
        real = getattr(pfr, name)
        monkeypatch.setattr(pfr, name, lambda *a, _real=real, _n=name, **k: calls.append(_n) or _real(*a, **k))
    pfr.stats.clear()
    first = pfr.preprocess_audio(wave, SR), pfr.preprocess_image(gray, 24)
    assert calls == ["log_spectrogram_np", "to_grayscale"]
    second = pfr.preprocess_audio(wave, sr=SR), pfr.preprocess_image(gray, img_height=24)
    assert calls == ["log_spectrogram_np", "to_grayscale"]  # keywords give the same keys
    for a, b in zip(first, second):
        assert isinstance(b, np.memmap) and not b.flags.writeable and np.array_equal(a, b)
    assert pfr.stats == {("preprocess_audio", "miss"): 1, ("preprocess_audio", "hit"): 1,
                         ("resized_image", "miss"): 1, ("resized_image", "hit"): 1}
    pfr.preprocess_audio(wave[:-1], SR)
    pfr.preprocess_audio(wave, SR + 1)
    assert calls.count("log_spectrogram_np") == 3  # another array or another sr is another key
    for _ in range(2):  # an image at its own height: computed each time, never cached
        assert not isinstance(pfr.preprocess_image(gray), np.memmap)
    assert calls.count("to_grayscale") == 3 and len(_entries(cache)) == 4


def test_key_holds_the_code_that_computes_the_entry(cache):
    _, _, wave = _inputs()
    pfr.preprocess_audio(wave, SR)
    (entry,) = _entries(cache)
    code = pfr.preprocess_audio.code
    assert code == pfr.code_hash(pfr.preprocess_audio.__wrapped__, pfr.stft)
    assert entry.stem == pfr._key("preprocess_audio", wave, (SR,), code)
    # an edited frontend (or an edited STFT) hashes otherwise: its key never names the entry written before
    assert pfr.code_hash(pfr.preprocess_audio.__wrapped__) != code
    assert pfr.code_hash(_inputs, pfr.stft) != code
    assert pfr._key("preprocess_audio", wave, (SR,), pfr.code_hash(_inputs, pfr.stft)) != entry.stem
    assert pfr.resized_image.code == pfr.code_hash(pfr.resized_image.__wrapped__, pfr.to_grayscale, pfr.rgb_to_luma,
                                                   pfr._scaled)


def test_clear_cache_removes_every_entry_and_nothing_else(cache):
    gray, _, wave = _inputs()
    pfr.preprocess_image(gray, 24)
    pfr.preprocess_audio(wave, SR)
    other = cache / "notes.txt"
    other.write_text("kept")
    assert len(_entries(cache)) == 3
    pfr.clear_cache()
    assert _entries(cache) == [other]
    pfr.clear_cache()  # an empty or missing cache is no error


def test_truncated_entry_is_computed_again(cache):
    _, _, wave = _inputs()
    want = pfr.preprocess_audio(wave, SR)
    (entry,) = _entries(cache)
    whole = entry.read_bytes()
    for cut in (len(whole) // 2, 40, 0):
        entry.write_bytes(whole[:cut])
        got = pfr.preprocess_audio(wave, SR)
        assert not isinstance(got, np.memmap) and np.array_equal(got, want)
        assert entry.read_bytes() == whole
    assert np.array_equal(pfr.preprocess_audio(wave, SR), want)


def test_two_processes_writing_one_key_leave_one_whole_entry(cache):
    _, _, wave = _inputs()
    ctx = multiprocessing.get_context("spawn")
    start = ctx.Event()
    procs = [ctx.Process(target=D.write_frontend_key, args=(str(cache), start, wave, SR, 4)) for _ in range(2)]
    for p in procs:
        p.start()
    start.set()
    try:
        for p in procs:
            p.join(120)
            assert p.exitcode == 0
    finally:
        for p in procs:
            p.kill()
    entries = _entries(cache)
    assert len(entries) == 1, entries
    (entry,) = entries
    assert entry.suffix == ".npy"
    assert np.array_equal(np.load(entry), _jax(jfr.preprocess_audio)(wave, SR))


def test_thread_loader_second_epoch_reads_the_cache(cache, tmp_path):
    syn = dict(n=6, img_height_range=(32, 33), img_width_range=(64, 96), audio_seconds_range=(0.3, 0.5), n_measures=1)
    dm = pds.ARDataModule(ds_name="synthetic", krn_encoding="kern", input_modality="both", batch_size=3,
                          num_workers=1, synthetic=True, synthetic_kwargs=syn, cache_root=str(tmp_path / "c"))
    dm.setup("fit")
    loader = dm._make_loader(dm.train_ds, 3, shuffle=False, drop_remainder=True)
    pfr.stats.clear()
    epochs = []
    for _ in range(2):
        epochs.append([{k: np.array(v) for k, v in b.items()} for b in loader])
        epochs[-1].append(dict(pfr.stats))
    assert len(epochs[0]) == 3
    for a, b in zip(*(e[:-1] for e in epochs)):
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    # the audio of the train split's 6 samples, computed in the first epoch and read in the second; the images
    # (no img_height) are not cached
    assert epochs[0][-1] == {("preprocess_audio", "miss"): 6}
    assert epochs[1][-1] == {("preprocess_audio", "miss"): 6, ("preprocess_audio", "hit"): 6}
    assert (len(_entries(cache, "preprocess_audio")), len(_entries(cache, "resized_image"))) == (6, 0)


def test_cli_train_keeps_the_cache_only_with_keep_cache(cache, tmp_path):
    from omr_a2s_multimodal_transformer_tpu_torch.cli import train

    syn = '{"n":3,"img_height_range":[32,33],"img_width_range":[64,72],"n_measures":1}'
    argv = ["--ds_name", "synthetic", "--krn_encoding", "kern", "--synthetic", "--synthetic_config", syn,
            "--cache_root", str(tmp_path / "c"), "--batch_size", "3", "--num_workers", "1", "--input_modality",
            "image", "--img_height", "24", "--epochs", "1", "--check_val_every_n_epoch", "1", "--no_bf16", "--device",
            "cpu"]
    for keep in (True, False):
        tag = "keep" if keep else "clear"
        train.main(argv + ["--weights_dir", str(tmp_path / tag / "w"), "--run_dir", str(tmp_path / tag / "r")]
                   + (["--keep_cache"] if keep else []))
        assert bool(_entries(cache, "resized_image")) == keep
