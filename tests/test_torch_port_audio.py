"""The port's audio path against the JAX package's, on the CPU.

- The host frontend (``ops/stft.py``'s numpy functions, copied) gives the
  JAX package's bytes: window, DFT matrices, |STFT|, dB, resampling,
  ``log_spectrogram_np`` at 22.05 and 44.1 kHz; ``preprocess_audio`` equals
  JAX's ``log_spectrogram_np(...)[None]`` (compared against that function,
  not JAX's joblib-cached ``preprocess_audio``, so that no cache is written)
  and ``spectrogram_shape`` its shape.
- The device ``log_spectrogram`` (float32, two matmuls) against JAX's
  (HIGHEST-precision matmuls) on ragged ``valid_samples``: frames past the
  valid ones exactly 0.0 in both, the rest within 1e-4 absolute. The
  output is 1 + dB/80 with a floor at -80 dB, so a bin just above the floor
  carries a float32 rounding of its magnitude amplified by its 1e-4 share
  of the sample's max: two float32 summation orders of the 2048-term DFT
  sums differ there by up to 7.4e-5 (measured on these inputs; JAX's own
  float32 lies 1.3e-5 from a float64 evaluation, the port's 6e-5), while
  in the bins within 60 dB of the max they agree to 2e-5.
- ``collate_multimodal`` and the audio and both-modality data modules give
  JAX's batches (JAX's loader with its audio frontend uncached).
- ``make_audio_transcriber`` gives JAX's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import EOS, MAXLEN, SOS, jax_model, port_and_jax_params

from omr_a2s_multimodal_transformer_tpu.data import collate as jcollate
from omr_a2s_multimodal_transformer_tpu.data import dataset as jds
from omr_a2s_multimodal_transformer_tpu.data import frontends as jfe
from omr_a2s_multimodal_transformer_tpu.data.sources import SyntheticSource as JSource
from omr_a2s_multimodal_transformer_tpu.ops import stft as jstft
from omr_a2s_multimodal_transformer_tpu_torch.data import collate as pcollate
from omr_a2s_multimodal_transformer_tpu_torch.data import dataset as pds
from omr_a2s_multimodal_transformer_tpu_torch.data import frontends as pfe
from omr_a2s_multimodal_transformer_tpu_torch.inference import make_audio_transcriber
from omr_a2s_multimodal_transformer_tpu_torch.ops import stft as pstft
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

SYN = dict(n=6, img_height_range=(32, 33), img_width_range=(64, 96), audio_seconds_range=(0.3, 0.5), n_measures=1)
SR = jstft.SAMPLE_RATE


def _waves(style="bands", n=4, seed=3):
    src = JSource(n=n, seed=seed, audio_seconds_range=(0.5, 1.5), n_measures=2, audio_style=style)
    return [src[i]["audio"]["array"] for i in range(n)]


def _noisy(seed=0, n=SR):
    """A tone in noise: many bins just above the -80 dB floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.15 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_numpy_frontend_is_jax_s_bit_for_bit():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "WIN_LENGTH", "NUM_FREQ_BINS", "AMIN", "TOP_DB"):
        assert getattr(pstft, name) == getattr(jstft, name), name
    np.testing.assert_array_equal(pstft.hann_window(), jstft.hann_window())
    np.testing.assert_array_equal(pstft.hann_window(100, np.float64), jstft.hann_window(100, np.float64))
    for a, b in zip(pstft._dft_matrices(), jstft._dft_matrices()):
        np.testing.assert_array_equal(a, b)
    assert [pstft.num_frames(n) for n in (0, 511, 512, 40000)] == [jstft.num_frames(n) for n in (0, 511, 512, 40000)]
    for y in _waves() + [_noisy()]:
        mag = pstft.magnitude_stft_np(y)
        np.testing.assert_array_equal(mag, jstft.magnitude_stft_np(y))
        np.testing.assert_array_equal(pstft.amplitude_to_db_np(mag), jstft.amplitude_to_db_np(mag))
        for sr in (SR, 44100):
            np.testing.assert_array_equal(pstft.log_spectrogram_np(y, sr), jstft.log_spectrogram_np(y, sr))
        np.testing.assert_array_equal(pstft.resample_np(y, 44100, SR), jstft.resample_np(y, 44100, SR))


@pytest.mark.parametrize("sr", [SR, 44100])
def test_preprocess_audio_and_its_shape_equal_jax(sr):
    for y in _waves("tones") + [_noisy(n=12345)]:
        got = pfe.preprocess_audio(y, sr)
        want = jstft.log_spectrogram_np(np.asarray(y, np.float32), sr=sr)[None]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert got.shape[1:] == pfe.spectrogram_shape(len(y), sr)


def _ragged(waves):
    lengths = np.array([len(w) for w in waves], np.int32)
    batch = np.zeros((len(waves), int(lengths.max()) + 700), np.float32)  # right padding past the longest too
    for i, w in enumerate(waves):
        batch[i, :len(w)] = w
    return batch, lengths


@pytest.mark.parametrize("inputs", ["bands", "tones", "noisy"])
def test_device_log_spectrogram_matches_jax(inputs):
    waves = [_noisy(s, n) for s, n in ((0, SR), (1, 15000), (2, 7777))] if inputs == "noisy" else _waves(inputs)
    wave, n = _ragged(waves)
    for valid in (n, None):
        want = np.asarray(jstft.log_spectrogram(jnp.asarray(wave), None if valid is None else jnp.asarray(valid)))
        got = pstft.log_spectrogram(torch.from_numpy(wave), None if valid is None else torch.from_numpy(valid))
        assert got.dtype == torch.float32 and got.shape == want.shape == (len(waves), 195, 1 + wave.shape[1] // 512)
        got = got.numpy()
        if valid is not None:  # padded frames are exactly 0.0 (as is a valid bin at the -80 dB floor)
            pad = np.arange(got.shape[2])[None, :] >= (1 + n // 512)[:, None]
            assert pad.any() and (got.transpose(0, 2, 1)[pad] == 0.0).all()
            assert (want.transpose(0, 2, 1)[pad] == 0.0).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        top = want > 0.25  # within 60 dB of the sample's max
        np.testing.assert_allclose(got[top], want[top], rtol=0, atol=2e-5)


def test_collate_multimodal_equals_jax():
    rng = np.random.default_rng(0)
    samples = [{"xi": rng.uniform(size=(1, 30 + i, 50 + 3 * i)).astype(np.float32),
                "xa": rng.uniform(size=(1, 195, 11 + 2 * i)).astype(np.float32),
                "y": rng.integers(1, 9, size=5 + i).astype(np.int32)} for i in range(3)]
    for targets in ((None, None, None), ((48, 64), (208, 24), 12)):
        a, b = jcollate.collate_multimodal(samples, *targets), pcollate.collate_multimodal(samples, *targets)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("modality", ["audio", "both"])
def test_audio_and_multimodal_batches_equal_jax(tmp_path, monkeypatch, modality):
    monkeypatch.setattr(jds, "preprocess_audio", getattr(jfe.preprocess_audio, "__wrapped__", jfe.preprocess_audio))
    kw = dict(ds_name="synthetic", krn_encoding="kern", input_modality=modality, batch_size=4, eval_batch_size=4,
              synthetic=True, synthetic_kwargs=SYN, seed=5)
    dj = jds.ARDataModule(num_workers=1, cache_root=str(tmp_path / "jax"), **kw)
    dp = pds.ARDataModule(num_workers=2, cache_root=str(tmp_path / "port"), **kw)
    for dm in (dj, dp):
        dm.setup("fit")
        dm.setup("test")
    assert dp.get_max_input_size() == dj.get_max_input_size()
    keys = {"audio": {"x", "x_hw", "frames", "y_in", "y_out"},
            "both": {"xi", "xi_hw", "frames_i", "xa", "xa_hw", "frames_a", "y_in", "y_out"}}[modality]
    lj, lp = dj.train_dataloader(), dp.train_dataloader()
    loaders = [("train epoch 1", lj, lp), ("train epoch 2", lj, lp),  # the shuffle order moves with the epoch
               ("val", dj.val_dataloader(), dp.val_dataloader()), ("test", dj.test_dataloader(), dp.test_dataloader())]
    for what, loader_j, loader_p in loaders:
        bj, bp = list(loader_j), list(loader_p)
        assert len(bj) == len(bp) > 0, what
        for a, b in zip(bj, bp):
            assert set(a) == set(b) == keys, what
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, f"{what} {k}"
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
    xa = bp[0]["xa" if modality == "both" else "x"]
    assert xa.shape[1] == 208 and (xa[:, 195:] == 0.0).all()  # 195 bins padded to the stem's multiple of 16


def test_audio_transcriber_token_identical_to_jax():
    from omr_a2s_multimodal_transformer_tpu.inference import make_audio_transcriber as j_make

    model, params = port_and_jax_params(seed=8, input_modality="audio")
    wave, n = _ragged(_waves("bands", n=2, seed=4))
    tok_j, _ = j_make(jax_model(input_modality="audio"), SOS, EOS)(params, jnp.asarray(wave), jnp.asarray(n))
    tok_t, _ = make_audio_transcriber(model, SOS, EOS, device="cpu")(torch.from_numpy(wave), torch.from_numpy(n))
    assert tok_t.shape == (2, MAXLEN)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_audio_transcriber(model, SOS, EOS)
