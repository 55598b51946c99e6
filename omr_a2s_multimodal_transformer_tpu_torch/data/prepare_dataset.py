"""Offline dataset preparation (reference src/data/prepare_dataset.py).

Pipeline: download GRANDSTAFF -> restructure into
``composer/{img,img_distorted,krn,bekrn,wav}`` -> synthesize audio
(kern -> MIDI via music21 -> WAV via FluidSynth; failures logged to
``errors/<composer>.txt`` and the sample's sibling files removed) ->
create per-composer and global partitions.

Network / external tools (requests, music21, midi2audio+fluidsynth) are
optional imports: partitioning and restructuring run without them, which is
what the tests cover. The partition logic is the parity-critical piece:
test = untransposed ("original") pieces, transpositions of test pieces are
excluded from train/val, remaining 80/20 split with seed 42
(reference prepare_dataset.py:190-238).

Port of ``omr_a2s_multimodal_transformer_tpu/data/prepare_dataset.py``.
``split_samples`` needs no scikit-learn: its 80/20 split is
``train_test_split(test_size=0.2, random_state=seed)``'s, recomputed (a
``RandomState(seed)`` permutation; the first ceil(0.2 n) are val), so the
partitions are the JAX package's.
Run it (it downloads GRANDSTAFF, needs the network):
  python -m omr_a2s_multimodal_transformer_tpu_torch.data.prepare_dataset
"""

from __future__ import annotations

import logging
import math
import os
import re
import shutil
import tarfile
from typing import Dict, List, Tuple

import numpy as np

GRANDSTAFF_URL = "https://grfia.dlsi.ua.es/musicdocs/grandstaff.tgz"
GRANDSTAFF_PATH = os.environ.get("GRANDSTAFF_PATH", "./grandstaff")
SOUND_FONT = os.environ.get(
    "GRANDSTAFF_SOUNDFONT", "./SGM-v2.01-YamahaGrand-Guit-Bass-v2.7.sf2"
)
_NON_COMPOSER_DIRS = {"partitions", "errors", "vocabs", "max_lens"}


def download_and_extract(root: str = GRANDSTAFF_PATH, url: str = GRANDSTAFF_URL) -> None:
    import requests

    os.makedirs(root, exist_ok=True)
    tgz = os.path.join(root, "grandstaff.tgz")
    with open(tgz, "wb") as f:
        f.write(requests.get(url=url).content)
    with tarfile.open(tgz, "r:gz") as tar:
        tar.extractall(root, filter="data")  # no member lands outside root
    os.remove(tgz)


def restructure(root: str = GRANDSTAFF_PATH) -> None:
    """Flatten the nested per-piece layout into per-composer
    ``{img,img_distorted,krn,bekrn,wav}`` folders; filenames are the
    path components joined with '_' (reference prepare_dataset.py:38-94)."""
    for composer in sorted(os.listdir(root)):
        src = os.path.join(root, composer)
        if not os.path.isdir(src) or composer in _NON_COMPOSER_DIRS or composer.startswith("."):
            continue
        if os.path.isdir(os.path.join(src, "krn")):
            continue  # already restructured
        dst = src + "_parsed"
        for sub in ("wav", "krn", "bekrn", "img", "img_distorted"):
            os.makedirs(os.path.join(dst, sub), exist_ok=True)
        for folder, _, files in os.walk(src):
            for fn in files:
                if fn.startswith("."):
                    continue
                rel = os.path.relpath(folder, src)
                parts = [] if rel == "." else rel.split(os.sep)
                new_name = "_".join(parts + [fn])
                if fn.endswith(".bekrn"):
                    sub = "bekrn"
                elif fn.endswith(".krn"):
                    sub = "krn"
                elif fn.endswith("_distorted.jpg"):
                    sub = "img_distorted"
                elif fn.endswith(".jpg"):
                    sub = "img"
                else:
                    continue
                shutil.move(os.path.join(folder, fn), os.path.join(dst, sub, new_name))
        shutil.rmtree(src)
        os.rename(dst, src)


def synthesize_audio(
    root: str = GRANDSTAFF_PATH, sample_rate: int = 22050, engine: str = "auto"
) -> Dict[str, List[str]]:
    """kern -> WAV. Failed parses are logged and the sample's files removed
    across all modalities, keeping the corpus consistent (reference
    prepare_dataset.py:100-162).

    engine: 'fluidsynth' (reference pipeline: music21 MIDI + FluidSynth +
    SoundFont), 'native' (dependency-free additive synthesis, data/synth.py),
    or 'auto' (fluidsynth when importable, else native). Both engines share
    the error-logging + sibling-deletion semantics."""
    if engine not in ("auto", "fluidsynth", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "auto":
        # 'auto' must probe the WHOLE fluidsynth path, not just the Python
        # imports: a pip-installed midi2audio with no fluidsynth binary or
        # SoundFont would crash mid-corpus (outside the per-file try) when
        # the dependency-free native engine was available all along.
        try:
            import midi2audio  # noqa: F401
            import music21  # noqa: F401

            engine = (
                "fluidsynth"
                if shutil.which("fluidsynth") and os.path.exists(SOUND_FONT)
                else "native"
            )
        except ImportError:
            engine = "native"
        # Record the resolution: corpora re-prepared in a changed environment
        # could otherwise end up with acoustically MIXED WAVs (train/eval
        # distribution shift) that is undetectable afterwards (ADVICE r3).
        logging.getLogger(__name__).info("synthesize_audio: engine 'auto' resolved to %r", engine)
        marker = os.path.join(root, ".synthesis_engine")
        prev = open(marker).read().strip() if os.path.exists(marker) else None
        if prev is not None and prev != engine:
            logging.getLogger(__name__).warning(
                "synthesize_audio: corpus at %s was previously synthesized with engine "
                "%r, re-running with %r — WAVs will be acoustically mixed", root, prev, engine,
            )
        with open(marker, "w") as f:
            f.write(engine + "\n")
    if engine == "native":
        return _synthesize_audio_native(root, sample_rate)

    from midi2audio import FluidSynth
    from music21 import converter

    os.makedirs(os.path.join(root, "errors"), exist_ok=True)
    fs = FluidSynth(sample_rate=sample_rate, sound_font=SOUND_FONT)
    all_errors: Dict[str, List[str]] = {}
    for composer in sorted(os.listdir(root)):
        cpath = os.path.join(root, composer)
        if not os.path.isdir(cpath) or composer in _NON_COMPOSER_DIRS or composer.startswith("."):
            continue
        errors = []
        for krn_file in sorted(os.listdir(os.path.join(cpath, "krn"))):
            krn_path = os.path.join(cpath, "krn", krn_file)
            try:
                stream = converter.parse(krn_path)
            except Exception as err:
                errors.append(f"{krn_file}\t{type(err)}\t{err}")
                _remove_siblings(cpath, krn_file)
                continue
            midi_path = krn_path + ".mid"
            stream.write("midi", fp=midi_path)
            fs.midi_to_audio(midi_path, os.path.join(cpath, "wav", krn_file.replace(".krn", ".wav")))
            os.remove(midi_path)
        if errors:
            all_errors[composer] = errors
            with open(os.path.join(root, "errors", f"{composer}.txt"), "w") as f:
                f.write("\n".join(errors))
    return all_errors


def _remove_siblings(cpath: str, krn_file: str) -> None:
    """Drop every modality of a sample whose kern failed to synthesize
    (reference prepare_dataset.py error path)."""
    for sub, suffix in (
        ("krn", ".krn"), ("img", ".jpg"),
        ("img_distorted", "_distorted.jpg"), ("bekrn", ".bekrn"),
    ):
        p = os.path.join(cpath, sub, krn_file.replace(".krn", suffix))
        if os.path.exists(p):
            os.remove(p)


def _synthesize_audio_native(root: str, sample_rate: int) -> Dict[str, List[str]]:
    """Dependency-free engine: kern -> timed notes -> additive rendering ->
    16-bit WAV (data/synth.py). Same tree walk / error semantics as the
    fluidsynth engine."""
    from omr_a2s_multimodal_transformer_tpu_torch.data.synth import render_kern_to_wav

    os.makedirs(os.path.join(root, "errors"), exist_ok=True)
    all_errors: Dict[str, List[str]] = {}
    for composer in sorted(os.listdir(root)):
        cpath = os.path.join(root, composer)
        if not os.path.isdir(cpath) or composer in _NON_COMPOSER_DIRS or composer.startswith("."):
            continue
        errors = []
        for krn_file in sorted(os.listdir(os.path.join(cpath, "krn"))):
            krn_path = os.path.join(cpath, "krn", krn_file)
            try:
                os.makedirs(os.path.join(cpath, "wav"), exist_ok=True)
                render_kern_to_wav(
                    krn_path,
                    os.path.join(cpath, "wav", krn_file.replace(".krn", ".wav")),
                    sample_rate=sample_rate,
                )
            except Exception as err:
                errors.append(f"{krn_file}\t{type(err)}\t{err}")
                _remove_siblings(cpath, krn_file)
        if errors:
            all_errors[composer] = errors
            with open(os.path.join(root, "errors", f"{composer}.txt"), "w") as f:
                f.write("\n".join(errors))
    return all_errors


def extract_org_name(name: str) -> str:
    """Strip transposition suffixes so all transpositions of a piece share a
    key (reference prepare_dataset.py:197-206)."""
    return re.sub(r"_(maj\d+|min\d+|original|up|down)", "", name)


def split_samples(samples: List[str], seed: int = 42) -> Tuple[List[str], List[str], List[str]]:
    """(train, val, test): test = 'original' pieces; any transposition of a
    test piece is excluded from train/val; remaining 80/20 split."""
    test = [s for s in samples if "original" in s]
    org_test = {extract_org_name(s) for s in test}
    train_val = [s for s in samples if s not in test and extract_org_name(s) not in org_test]
    train, val = train_test_split(train_val, 0.2, seed)
    return train, val, test


def train_test_split(items: List[str], test_size: float, seed: int) -> Tuple[List[str], List[str]]:
    """scikit-learn's ``train_test_split(items, test_size=test_size,
    random_state=seed)`` for a float ``test_size``, without scikit-learn:
    a ``RandomState(seed)`` permutation, its first ceil(test_size * n) the
    test part. Raises as it does when either part would be empty."""
    n = len(items)
    n_test = math.ceil(test_size * n)
    if n == 0 or n - n_test <= 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and train_size=None, the resulting train set "
                         "will be empty. Adjust any of the aforementioned parameters.")
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def create_composer_partitions(root: str = GRANDSTAFF_PATH) -> None:
    partitions = os.path.join(root, "partitions")
    os.makedirs(partitions, exist_ok=True)
    for composer in sorted(os.listdir(root)):
        cpath = os.path.join(root, composer)
        if not os.path.isdir(cpath) or composer in _NON_COMPOSER_DIRS or composer.startswith("."):
            continue
        wav_dir = os.path.join(cpath, "wav")
        samples = [
            f[: -len(".wav")]
            for f in os.listdir(wav_dir)
            if f.endswith(".wav") and not f.startswith(".")
        ]
        train, val, test = split_samples(samples)
        out = os.path.join(partitions, composer)
        os.makedirs(out, exist_ok=True)
        for name, part in (("train", train), ("val", val), ("test", test)):
            with open(os.path.join(out, f"{name}.txt"), "w") as f:
                f.write("\n".join(part))


def create_grandstaff_partitions(root: str = GRANDSTAFF_PATH) -> None:
    """Global partition = concat of per-composer partitions with
    ``composer\\tpiece`` lines (reference prepare_dataset.py:241-259)."""
    partitions = os.path.join(root, "partitions")
    out = os.path.join(partitions, "grandstaff")
    os.makedirs(out, exist_ok=True)
    for split in ("train", "val", "test"):
        lines: List[str] = []
        for composer in sorted(os.listdir(partitions)):
            if composer == "grandstaff" or composer.startswith("."):
                continue
            with open(os.path.join(partitions, composer, f"{split}.txt")) as f:
                lines.extend(f"{composer}\t{s}" for s in f.read().splitlines() if s)
        with open(os.path.join(out, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def main() -> None:
    print("Downloading and extracting GRANDSTAFF dataset...")
    download_and_extract()
    print("Restructuring...")
    restructure()
    print("Synthesizing audio...")
    synthesize_audio()
    print("Creating partitions...")
    create_composer_partitions()
    create_grandstaff_partitions()
    print("Done!")


if __name__ == "__main__":
    main()
