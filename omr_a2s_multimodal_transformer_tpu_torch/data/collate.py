"""Static-shape batching (numpy, on the host).

Copy of ``omr_a2s_multimodal_transformer_tpu/data/collate.py``. Every batch
is padded to *bucketed* target shapes: a small, fixed set of (H, W, L)
targets chosen up front from the dataset's max-lens statistics, so the
train step sees few distinct shapes. Images pad with 1.0 (white
background), spectrograms with 0.0 (silence), transcripts with 0 (<PAD>),
the reference's pad values. Layout is NHWC, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HEIGHT_REDUCTION = 16  # conv stem reduction (reference encoder.py:8-9)
WIDTH_REDUCTION = 8

IMAGE_PAD_VALUE = 1.0  # white
AUDIO_PAD_VALUE = 0.0  # silence
PAD_ID = 0


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def reduced_hw(h: int, w: int) -> Tuple[int, int]:
    """Spatial dims after the conv stem: (ceil(h/16), ceil(w/8))."""
    return ceil_div(h, HEIGHT_REDUCTION), ceil_div(w, WIDTH_REDUCTION)


def num_frames(h: int, w: int) -> int:
    """Flattened memory length for an input of size h x w
    (reference ar_dataset.py:439-442)."""
    rh, rw = reduced_hw(h, w)
    return rh * rw


def round_up(x: int, multiple: int) -> int:
    return ceil_div(x, multiple) * multiple


@dataclass(frozen=True)
class BucketSpec:
    """Fixed padding targets. `widths` (and `lengths`) may hold several
    buckets; a sample picks the smallest target that fits. Heights in this
    corpus are nearly constant per modality, so a single height is typical."""

    heights: Tuple[int, ...]
    widths: Tuple[int, ...]
    lengths: Tuple[int, ...]  # transcript lengths INCLUDING sos/eos

    @staticmethod
    def single(max_h: int, max_w: int, max_len: int) -> "BucketSpec":
        return BucketSpec(
            heights=(round_up(max_h, HEIGHT_REDUCTION),),
            widths=(round_up(max_w, WIDTH_REDUCTION),),
            lengths=(max_len,),
        )

    @staticmethod
    def geometric(max_h: int, max_w: int, max_len: int, n_width_buckets: int = 4) -> "BucketSpec":
        """Width buckets in a geometric ladder ending at max (fewer wasted
        FLOPs on narrow systems while keeping the count of distinct shapes small)."""
        widths = sorted(
            {round_up(max(1, int(max_w * (0.5 ** i))), WIDTH_REDUCTION * 16) for i in range(n_width_buckets)}
            | {round_up(max_w, WIDTH_REDUCTION)}
        )
        lengths = sorted({round_up(max(32, max_len // (2 ** i)), 32) for i in range(3)} | {max_len})
        return BucketSpec(heights=(round_up(max_h, HEIGHT_REDUCTION),), widths=tuple(widths), lengths=tuple(lengths))

    def pick(self, h: int, w: int, length: int) -> Tuple[int, int, int]:
        th = min((x for x in self.heights if x >= h), default=max(self.heights))
        tw = min((x for x in self.widths if x >= w), default=max(self.widths))
        tl = min((x for x in self.lengths if x >= length), default=max(self.lengths))
        return th, tw, tl


def pad_input(x: np.ndarray, target_h: int, target_w: int, pad_value: float) -> np.ndarray:
    """[1, H, W] or [H, W] -> [target_h, target_w, 1] (NHWC), bottom/right pad."""
    if x.ndim == 3:
        x = x[0]
    h, w = x.shape
    out = np.full((target_h, target_w, 1), pad_value, dtype=np.float32)
    out[:h, :w, 0] = x
    return out


def pad_ids(ids: np.ndarray, target_len: int) -> np.ndarray:
    out = np.zeros((target_len,), dtype=np.int32)
    out[: len(ids)] = ids[:target_len]
    return out


def _stack_inputs(
    xs: Sequence[np.ndarray], pad_value: float, target_h: Optional[int], target_w: Optional[int]
) -> Tuple[np.ndarray, np.ndarray]:
    hs = [x.shape[-2] for x in xs]
    ws = [x.shape[-1] for x in xs]
    th = target_h or max(hs)
    tw = target_w or max(ws)
    batch = np.stack([pad_input(x, th, tw, pad_value) for x in xs])
    hw = np.asarray(list(zip(hs, ws)), dtype=np.int32)  # original (pre-reduction) dims
    return batch, hw


def _stack_transcripts(ys: Sequence[np.ndarray], target_len: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Full transcripts (sos..eos) -> (y_in, y_out), each [B, L]."""
    tl = target_len or max(len(y) for y in ys)
    y_in = np.stack([pad_ids(np.asarray(y[:-1]), tl - 1) for y in ys])
    y_out = np.stack([pad_ids(np.asarray(y[1:]), tl - 1) for y in ys])
    return y_in.astype(np.int32), y_out.astype(np.int32)


def collate_unimodal(
    samples: List[Dict],
    pad_value: float,
    target_h: Optional[int] = None,
    target_w: Optional[int] = None,
    target_len: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Batch of {'x': [1,H,W], 'y': [L]} -> static-shape arrays.

    Returns x [B,H,W,1], x_hw [B,2] (original dims), frames [B] (flattened
    valid memory length), y_in/y_out [B,L-1].
    """
    x, x_hw = _stack_inputs([s["x"] for s in samples], pad_value, target_h, target_w)
    y_in, y_out = _stack_transcripts([s["y"] for s in samples], target_len)
    frames = np.asarray([num_frames(h, w) for h, w in x_hw], dtype=np.int32)
    return {"x": x, "x_hw": x_hw, "frames": frames, "y_in": y_in, "y_out": y_out}


def collate_multimodal(
    samples: List[Dict],
    target_img: Optional[Tuple[int, int]] = None,
    target_audio: Optional[Tuple[int, int]] = None,
    target_len: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Batch of {'xi','xa','y'} -> static-shape arrays for both modalities."""
    ti = target_img or (None, None)
    ta = target_audio or (None, None)
    xi, xi_hw = _stack_inputs([s["xi"] for s in samples], IMAGE_PAD_VALUE, *ti)
    xa, xa_hw = _stack_inputs([s["xa"] for s in samples], AUDIO_PAD_VALUE, *ta)
    y_in, y_out = _stack_transcripts([s["y"] for s in samples], target_len)
    fi = np.asarray([num_frames(h, w) for h, w in xi_hw], dtype=np.int32)
    fa = np.asarray([num_frames(h, w) for h, w in xa_hw], dtype=np.int32)
    return {
        "xi": xi, "xi_hw": xi_hw, "frames_i": fi,
        "xa": xa, "xa_hw": xa_hw, "frames_a": fa,
        "y_in": y_in, "y_out": y_out,
    }
