"""Batch transcription CLI (serving path): score images and/or WAVs in,
kern files out.

Port of ``omr_a2s_multimodal_transformer_tpu/cli/transcribe.py``: globs
inputs, runs the host frontends (``data/frontends.py``) and the KV-cached
greedy decode (or, with ``--audio_checkpoint_path``, the weighted late
fusion of an image and an audio model over inputs paired by file stem) on
``--device`` (``cuda`` unless given ``cpu``), and writes one reconstructed
``.krn`` per input (``utils/mv2h.seq2kern``). ``.wav`` files are read by
``scipy.io.wavfile``; image files need PIL (Pillow), imported when an image
is read.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.data import collate as C
from omr_a2s_multimodal_transformer_tpu_torch.data.frontends import _require_pil, preprocess_audio, preprocess_image
from omr_a2s_multimodal_transformer_tpu_torch.data.vocab import Vocabulary
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import (
    cut_at_eos,
    greedy_decode_fn,
    weighted_decode_fn,
)
from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h import seq2kern

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--vocab_path", required=True, help="ar_w2i_*.json vocabulary file")
    p.add_argument("--inputs", required=True, help="glob of .jpg/.png (image model) or .wav (audio model)")
    p.add_argument("--audio_checkpoint_path", default="",
                   help="weighted late fusion: --checkpoint_path is the image model, this "
                        "the audio model; --inputs globs images and --audio_inputs the "
                        "paired WAVs (matched by filename stem)")
    p.add_argument("--audio_inputs", default="",
                   help="glob of .wav files paired with --inputs by stem (fused mode)")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="fusion mix: alpha*softmax(img) + (1-alpha)*softmax(audio)")
    p.add_argument("--out_dir", default="transcriptions")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--img_height", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cache_dtype", default=None, choices=["float32", "bfloat16", "int8", "int4"],
                   help="override the decode KV-cache dtype (int8/int4 are not ported yet)")
    p.add_argument("--device", default="cuda", help="torch device to run on: cuda (default) or cpu")
    return p


def _load_inputs(paths, img_height):
    from scipy.io import wavfile

    for path in paths:
        if path.lower().endswith(IMAGE_SUFFIXES):
            image = _require_pil(f"reading {path}")
            yield path, preprocess_image(image.open(path), img_height)
        elif path.lower().endswith(".wav"):
            sr, wave = wavfile.read(path)
            if wave.dtype.kind == "i":
                wave = wave.astype(np.float32) / np.iinfo(wave.dtype).max
            if wave.ndim == 2:
                wave = wave.mean(axis=1)
            yield path, preprocess_audio(wave.astype(np.float32), sr)
        else:
            raise ValueError(f"Unsupported input type: {path}")


def _pair_by_stem(img_paths, wav_paths):
    stems = {os.path.splitext(os.path.basename(p))[0]: p for p in wav_paths}
    pairs = []
    for ip in img_paths:
        stem = os.path.splitext(os.path.basename(ip))[0]
        if stem not in stems:
            raise FileNotFoundError(f"fused transcribe: no .wav pairs image stem {stem!r}")
        pairs.append((ip, stems[stem]))
    return pairs


def _pad(chunk, pad_value, device):
    """[(path, [1, H, W])] -> ([B, H', W', 1] on device, hw [B, 2]), padded
    to multiples of 16 x 8."""
    hmax = C.round_up(max(x.shape[1] for _, x in chunk), 16)
    wmax = C.round_up(max(x.shape[2] for _, x in chunk), 8)
    batch = np.stack([C.pad_input(x, hmax, wmax, pad_value) for _, x in chunk])
    hw = np.asarray([[x.shape[1], x.shape[2]] for _, x in chunk], np.int32)
    return torch.from_numpy(batch).to(device), torch.from_numpy(hw).to(device)


def _write_krn(chunk, tokens, vocab, out_dir) -> int:
    rows, _ = cut_at_eos(tokens, tokens, vocab.eos_id)
    for (path, _), row in zip(chunk, rows):
        toks = vocab.tokens(row, strip_special=True)
        seq2kern(toks, os.path.join(out_dir, os.path.splitext(os.path.basename(path))[0] + ".krn"))
    return len(rows)


def _main_fused(args) -> int:
    """Weighted late-fusion offline transcription: two unimodal checkpoints
    decoded in lockstep (reference weighted_multimodal/test.py:21-70, but
    over raw files instead of a prepared dataset)."""
    img_paths = sorted(glob.glob(args.inputs))
    wav_paths = sorted(glob.glob(args.audio_inputs))
    if not img_paths:
        raise FileNotFoundError(f"No inputs match {args.inputs}")
    if not wav_paths:
        raise FileNotFoundError(f"fused transcribe needs --audio_inputs (got {args.audio_inputs!r})")
    pairs = _pair_by_stem(img_paths, wav_paths)
    vocab = Vocabulary.load(args.vocab_path)
    ov = {"cache_dtype": args.cache_dtype}
    img_model, ihp, imulti = common.build_from_checkpoint(args.checkpoint_path, ov, device=args.device)
    aud_model, ahp, amulti = common.build_from_checkpoint(args.audio_checkpoint_path, ov, device=args.device)
    if imulti or amulti:
        raise SystemExit("fused transcribe drives two unimodal checkpoints")
    if ihp.get("input_modality") != "image" or ahp.get("input_modality") != "audio":
        raise SystemExit("fused transcribe: --checkpoint_path must be the image model and "
                         "--audio_checkpoint_path the audio model")

    decode = weighted_decode_fn(img_model, aud_model, img_model.max_seq_len, vocab.sos_id, vocab.eos_id)
    os.makedirs(args.out_dir, exist_ok=True)
    imgs = list(_load_inputs([p for p, _ in pairs], args.img_height))
    wavs = list(_load_inputs([p for _, p in pairs], args.img_height))
    n_done = 0
    for i in range(0, len(pairs), args.batch_size):
        ic, ac = imgs[i: i + args.batch_size], wavs[i: i + args.batch_size]
        xi, hwi = _pad(ic, C.IMAGE_PAD_VALUE, args.device)
        xa, hwa = _pad(ac, C.AUDIO_PAD_VALUE, args.device)
        tokens, _ = decode(xi, hwi, xa, hwa, args.alpha)
        n_done += _write_krn(ic, tokens, vocab, args.out_dir)
    print(f"Transcribed {n_done} fused pairs -> {args.out_dir}/")
    return n_done


def main(argv=None) -> int:
    """Returns the number of .krn files written."""
    args = build_parser().parse_args(argv)
    common.init_cli(args)
    if args.audio_checkpoint_path:
        return _main_fused(args)
    paths = sorted(glob.glob(args.inputs))
    if not paths:
        raise FileNotFoundError(f"No inputs match {args.inputs}")
    vocab = Vocabulary.load(args.vocab_path)
    model, hp, multimodal = common.build_from_checkpoint(args.checkpoint_path, {"cache_dtype": args.cache_dtype},
                                                         device=args.device)
    if multimodal:
        raise SystemExit("transcribe drives unimodal checkpoints (image or audio)")

    decode = greedy_decode_fn(model, model.max_seq_len, vocab.sos_id, vocab.eos_id)
    os.makedirs(args.out_dir, exist_ok=True)

    items = list(_load_inputs(paths, args.img_height))
    pad = C.IMAGE_PAD_VALUE if paths[0].lower().endswith(IMAGE_SUFFIXES) else C.AUDIO_PAD_VALUE
    n_done = 0
    for i in range(0, len(items), args.batch_size):
        chunk = items[i: i + args.batch_size]
        tokens, _ = decode(*_pad(chunk, pad, args.device))
        n_done += _write_krn(chunk, tokens, vocab, args.out_dir)
    print(f"Transcribed {n_done} inputs -> {args.out_dir}/")
    return n_done


if __name__ == "__main__":
    main()
