"""Vocabulary + max-lens construction with the reference's cache layout.

Copy of ``omr_a2s_multimodal_transformer_tpu/data/vocab.py``. A single
shared vocabulary is built over the *whole* collection (all splits), tokens
sorted, ids starting at 1, ``<PAD>`` = 0; cached at
``<root>/vocabs/ar_w2i_{encoding}.json``. Max lengths (transcript, image,
audio dims) are scanned once and cached at
``<root>/max_lens/[ImgDist_]ar_w2i_{encoding}.json``. Both files are written
with the same ``json.dump`` calls as the JAX package's, so either package
reads the other's cache.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from omr_a2s_multimodal_transformer_tpu_torch.data.encoding import KrnParser

SOS_TOKEN = "<sos>"
EOS_TOKEN = "<eos>"
PAD_TOKEN = "<PAD>"
PAD_ID = 0


@dataclass
class Vocabulary:
    w2i: Dict[str, int]
    i2w: Dict[int, str]

    def __len__(self) -> int:
        return len(self.w2i)

    @property
    def sos_id(self) -> int:
        return self.w2i[SOS_TOKEN]

    @property
    def eos_id(self) -> int:
        return self.w2i[EOS_TOKEN]

    def ids(self, tokens: List[str], add_sos_eos: bool = True) -> List[int]:
        toks = [SOS_TOKEN] + tokens + [EOS_TOKEN] if add_sos_eos else tokens
        return [self.w2i[t] for t in toks]

    def tokens(self, ids: Iterable[int], strip_special: bool = False) -> List[str]:
        out = [self.i2w[int(i)] for i in ids]
        if strip_special:
            out = [t for t in out if t not in (SOS_TOKEN, EOS_TOKEN, PAD_TOKEN)]
        return out

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.w2i, f)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        with open(path) as f:
            w2i = json.load(f)
        return Vocabulary(w2i=w2i, i2w={v: k for k, v in w2i.items()})

    @staticmethod
    def from_tokens(all_tokens: Iterable[str]) -> "Vocabulary":
        """Sorted unique tokens + sos/eos, ids from 1, PAD=0
        (reference ar_dataset.py:312-334)."""
        vocab = sorted(set(all_tokens))
        vocab = sorted(set([SOS_TOKEN, EOS_TOKEN] + vocab))
        w2i = {w: i + 1 for i, w in enumerate(vocab)}
        w2i[PAD_TOKEN] = PAD_ID
        return Vocabulary(w2i=w2i, i2w={v: k for k, v in w2i.items()})


def build_vocabulary(texts: Iterable[str], encoding: str = "bekern") -> Vocabulary:
    parser = KrnParser(encoding=encoding)
    tokens: List[str] = []
    for text in texts:
        tokens.extend(parser.encode(text))
    return Vocabulary.from_tokens(tokens)


def load_or_build_vocabulary(
    cache_path: str, texts_fn: Optional[Callable[[], Iterable[str]]], encoding: str = "bekern"
) -> Vocabulary:
    if os.path.isfile(cache_path):
        return Vocabulary.load(cache_path)
    if texts_fn is None:
        raise FileNotFoundError(f"No cached vocabulary at {cache_path} and no corpus provided to build one")
    vocab = build_vocabulary(texts_fn(), encoding=encoding)
    vocab.save(cache_path)
    return vocab


def load_or_build_max_lens(cache_path: str, scan_fn: Optional[Callable[[], Dict[str, int]]]) -> Dict[str, int]:
    """max_lens dict: max_seq_len (tokens + 1 for EOS), max image/audio H,W."""
    if os.path.isfile(cache_path):
        with open(cache_path) as f:
            return json.load(f)
    if scan_fn is None:
        raise FileNotFoundError(f"No cached max_lens at {cache_path} and no corpus provided to scan")
    max_lens = scan_fn()
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    with open(cache_path, "w") as f:
        json.dump(max_lens, f)
    return max_lens
