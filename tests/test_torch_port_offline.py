"""The port's offline dataset tools against the JAX package's: each runs
on a twin of the same input and must leave the same files, byte for byte.

- ``data/synth.py``: the WAV bytes of hand-written and synthetic-corpus
  kern, the waveform arrays, the error of a kern with no note.
- ``data/prepare_dataset.py``: ``split_samples`` (the port recomputes
  scikit-learn's ``train_test_split``, which the card's machine lacks;
  the JAX package calls it) over lists of 1-123 samples with and without
  transpositions of test pieces, the raise of an empty train part;
  ``restructure`` of a nested GRANDSTAFF-like tree; ``synthesize_audio``
  with the native engine (the error log and the sibling deletion), with
  the FluidSynth engine on fake ``music21``/``midi2audio`` modules, and
  'auto' without the FluidSynth binary (the ``.synthesis_engine``
  marker); the composer and the global partitions;
  ``download_and_extract`` from a fake ``requests``. The port imports no
  scikit-learn.
- ``data/hf_upload.py``: ``collect_files`` of both partition layouts.
"""

import ast
import io
import os
import shutil
import sys
import tarfile
import types

import numpy as np
import pytest

from omr_a2s_multimodal_transformer_tpu.data import hf_upload as j_hf
from omr_a2s_multimodal_transformer_tpu.data import prepare_dataset as j_prep
from omr_a2s_multimodal_transformer_tpu.data import synth as j_synth
from omr_a2s_multimodal_transformer_tpu.data.sources import synthetic_kern
from omr_a2s_multimodal_transformer_tpu_torch.data import hf_upload as t_hf
from omr_a2s_multimodal_transformer_tpu_torch.data import prepare_dataset as t_prep
from omr_a2s_multimodal_transformer_tpu_torch.data import synth as t_synth

KERNS = ["**kern\n=1\n4c\n4d\n4e\n4f\n*-\n", "**kern\t**kern\n=1\t=1\n1C\t2r\n.\t2a\n*-\t*-\n",
         "**kern\n=1\n4c 4e 4g\n*-\n"]


def _files(root):
    out = {}
    for folder, _, names in os.walk(root):
        for n in names:
            p = os.path.join(folder, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _twins(tmp_path, build):
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for r in roots:
        os.makedirs(r)
        build(r)
    return roots


def test_synth_wav_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    texts = KERNS + [synthetic_kern(rng, n_measures=3)]
    for i, text in enumerate(texts):
        krn = tmp_path / f"{i}.krn"
        krn.write_text(text)
        for mod, tag in ((j_synth, "jax"), (t_synth, "port")):
            mod.render_kern_to_wav(str(krn), str(tmp_path / f"{i}_{tag}.wav"))
        assert (tmp_path / f"{i}_jax.wav").read_bytes() == (tmp_path / f"{i}_port.wav").read_bytes()
        lines = text.splitlines()
        np.testing.assert_array_equal(t_synth.kern_lines_to_wave(lines, 16000), j_synth.kern_lines_to_wave(lines, 16000))
    with pytest.raises(ValueError, match="no parseable notes"):
        t_synth.kern_lines_to_wave(["**kern", "*-"])


def test_split_samples_equal_jax():
    for n in (2, 3, 5, 7, 10, 41, 123):
        plain = [f"x_p{i}_maj2_up_m-1-4" for i in range(n)]
        assert t_prep.split_samples(plain) == j_prep.split_samples(plain), n
        mixed = plain + [f"x_p{i}_original_m-1-4" for i in range(0, n, 3)] + ["y_q_min3_down_m-2-3"]
        assert t_prep.split_samples(mixed) == j_prep.split_samples(mixed), n
    with pytest.raises(ValueError, match="train set will be empty"):
        t_prep.split_samples(["x_p1_maj2_up_m-1-4"])
    with pytest.raises(ValueError, match="train set will be empty"):
        j_prep.split_samples(["x_p1_maj2_up_m-1-4"])
    tree = ast.parse(open(t_prep.__file__).read())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names]
    names += [node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module]
    assert not any(n.split(".")[0] == "sklearn" for n in names)


def _nested(root):
    for composer, pieces in (("mozart", ("sonata01/mvt1/orig_m-1-4", "sonata01/mvt1/maj2_up_m-1-4")),
                             ("chopin", ("etude/op10_original_m-5-8",))):
        for p in pieces:
            d, name = os.path.split(os.path.join(root, composer, p))
            os.makedirs(d, exist_ok=True)
            for suffix, data in ((".krn", "**kern\n4c\n*-\n"), (".bekrn", "**bekern\n4c\n*-\n"),
                                 (".jpg", "jpg"), ("_distorted.jpg", "djpg"), (".txt", "skip")):
                with open(os.path.join(d, name + suffix), "w") as f:
                    f.write(data + name)
    os.makedirs(os.path.join(root, "partitions"))


def test_restructure_equals_jax(tmp_path):
    j_root, t_root = _twins(tmp_path, _nested)
    j_prep.restructure(j_root)
    t_prep.restructure(t_root)
    assert _files(t_root) == _files(j_root) and "mozart/krn/sonata01_mvt1_orig_m-1-4.krn" in _files(t_root)


def _corpus(root):
    for composer, pieces in (("mozart", ("good_original_m-1-4", "bad_original_m-5-8", "ok_maj2_up_m-2-3",
                                         "good_min2_down_m-1-4", "p3_maj3_up_m-1-2", "p4_min6_up_m-3-4")),
                             ("chopin", ("a_min3_down_m-1-2", "b_maj2_up_m-1-2", "c_maj2_up_m-4-5"))):
        base = os.path.join(root, composer)
        for sub in ("krn", "bekrn", "img", "img_distorted", "wav"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        for p in pieces:
            kern = "**kern\n*-\n" if p.startswith("bad") else "**kern\n=1\n4c 4e\n2g\n*-\n"
            for sub, suffix, data in (("krn", ".krn", kern), ("bekrn", ".bekrn", "**bekern\n*-\n"),
                                      ("img", ".jpg", "jpg"), ("img_distorted", "_distorted.jpg", "djpg")):
                with open(os.path.join(base, sub, p + suffix), "w") as f:
                    f.write(data)


def _fake_fluidsynth(monkeypatch, fail="bad_"):
    class Stream:
        def write(self, fmt, fp):
            with open(fp, "w") as f:
                f.write("MIDI")

    def parse(path):
        if fail in os.path.basename(path):
            raise ValueError(f"cannot parse {os.path.basename(path)}")
        return Stream()

    class FluidSynth:
        def __init__(self, sample_rate, sound_font):
            self.sample_rate = sample_rate

        def midi_to_audio(self, midi_path, wav_path):
            with open(wav_path, "wb") as f:
                f.write(b"RIFF" + open(midi_path, "rb").read())

    monkeypatch.setitem(sys.modules, "music21", types.SimpleNamespace(converter=types.SimpleNamespace(parse=parse)))
    monkeypatch.setitem(sys.modules, "midi2audio", types.SimpleNamespace(FluidSynth=FluidSynth))


@pytest.mark.parametrize("engine", ["native", "fluidsynth", "auto"])
def test_synthesize_audio_and_partitions_equal_jax(tmp_path, monkeypatch, engine):
    if engine != "native":
        _fake_fluidsynth(monkeypatch)
    if engine == "auto":  # the modules import, the binary is absent: the native engine, recorded in the marker
        monkeypatch.setattr(shutil, "which", lambda name: None)
    j_root, t_root = _twins(tmp_path, _corpus)
    errors = [mod.synthesize_audio(root, engine=engine) for mod, root in ((j_prep, j_root), (t_prep, t_root))]
    assert errors[0] == errors[1] and len(errors[1]["mozart"]) == 1
    for mod, root in ((j_prep, j_root), (t_prep, t_root)):
        mod.create_composer_partitions(root)
        mod.create_grandstaff_partitions(root)
    got = _files(t_root)
    assert got == _files(j_root)
    assert "mozart/wav/good_original_m-1-4.wav" in got and "mozart/img/bad_original_m-5-8.jpg" not in got
    assert ("errors/mozart.txt" in got) and (got.get(".synthesis_engine") == (b"native\n" if engine == "auto" else None))
    assert "partitions/grandstaff/test.txt" in got


def test_download_and_extract_equals_jax(tmp_path, monkeypatch):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in (("grandstaff/mozart/a/x.krn", b"**kern\n*-\n"), ("grandstaff/mozart/a/x.jpg", b"jpg")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    got_urls = []

    def get(url):
        got_urls.append(url)
        return types.SimpleNamespace(content=buf.getvalue())

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(get=get))
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    j_prep.download_and_extract(roots[0], url="https://example.invalid/g.tgz")
    t_prep.download_and_extract(roots[1], url="https://example.invalid/g.tgz")
    assert _files(roots[1]) == _files(roots[0]) and len(_files(roots[1])) == 2
    assert got_urls == ["https://example.invalid/g.tgz"] * 2


def test_hf_upload_collect_files_equals_jax(tmp_path):
    root = str(tmp_path)
    _corpus(root)
    os.makedirs(os.path.join(root, "partitions", "mozart"))
    os.makedirs(os.path.join(root, "partitions", "grandstaff"))
    with open(os.path.join(root, "partitions", "mozart", "train.txt"), "w") as f:
        f.write("good_original_m-1-4\nok_maj2_up_m-2-3\n")
    with open(os.path.join(root, "partitions", "grandstaff", "train.txt"), "w") as f:
        f.write("mozart\tgood_original_m-1-4\nchopin\ta_min3_down_m-1-2\n")
    for ds in ("mozart", "grandstaff"):
        got = t_hf.collect_files(root, ds, "train")
        assert got == j_hf.collect_files(root, ds, "train") and len(got["kern"]) == 2
