"""Fixed sinusoidal positional encodings (1D and 2D).

A copy of the numpy code in
``omr_a2s_multimodal_transformer_tpu/models/positional.py`` (the port
imports nothing from the JAX package). 1D: pe[:, 0::2] = sin, 1::2 = cos.
2D: the first half of the channels encodes width, the second half height.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def positional_encoding_1d(max_len: int, emb_dim: int) -> np.ndarray:
    """[max_len, emb_dim] float32; pe[:, 0::2]=sin(pos/den), 1::2=cos."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    den = np.power(10000.0, np.arange(0, emb_dim, 2, dtype=np.float64) / emb_dim)
    pe = np.zeros((max_len, emb_dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos / den)
    pe[:, 1::2] = np.cos(pos / den)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=8)
def positional_encoding_2d(num_channels: int, max_height: int, max_width: int) -> np.ndarray:
    """[max_height, max_width, num_channels] float32 (NHWC layout).

    Channels [0, C/2) encode width (sin on even, cos on odd offsets);
    channels [C/2, C) encode height likewise.
    """
    c = num_channels
    den = np.power(10000.0, np.arange(0, c // 2, 2, dtype=np.float64) / c)
    pos_h = np.arange(max_height, dtype=np.float64)[:, None]
    pos_w = np.arange(max_width, dtype=np.float64)[:, None]
    pe = np.zeros((max_height, max_width, c), dtype=np.float64)
    sw = np.sin(pos_w / den)  # [W, c//4]
    cw = np.cos(pos_w / den)
    sh = np.sin(pos_h / den)  # [H, c//4]
    ch = np.cos(pos_h / den)
    pe[:, :, 0 : c // 2 : 2] = sw[None, :, :]
    pe[:, :, 1 : c // 2 : 2] = cw[None, :, :]
    pe[:, :, c // 2 :: 2] = sh[:, None, :]
    pe[:, :, c // 2 + 1 :: 2] = ch[:, None, :]
    return pe.astype(np.float32)
