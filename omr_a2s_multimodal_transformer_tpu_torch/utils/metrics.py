"""Evaluation metrics: Symbol/Sequence Error Rate (+ optional MV2H).

Port of ``omr_a2s_multimodal_transformer_tpu/utils/metrics.py`` (parity
with the reference's ``src/utils/metrics.py``):
- sym-er = 100 * sum(edit_distance) / sum(len(ground_truth))
- seq-er = 100 * (#sequences with any error) / #sequences
- MV2H (``compute_mv2h=True``): the reference pipeline (music21 -> MIDI ->
  pyMV2H, ``utils/mv2h.py``) when installed, else the dependency-free
  ``utils/mv2h_native.py``, its undefined components (harmony) dropped.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence

from omr_a2s_multimodal_transformer_tpu_torch.utils.edit_distance import levenshtein


def compute_ed_metrics(y_true: Sequence[List[str]], y_pred: Sequence[List[str]]) -> Dict[str, float]:
    ed_acc = 0
    length_acc = 0
    wrong_seqs = 0
    for t, h in zip(y_true, y_pred):
        ed = levenshtein(t, h)
        ed_acc += ed
        length_acc += len(t)
        if ed > 0:
            wrong_seqs += 1
    return {
        "sym-er": 100.0 * ed_acc / max(length_acc, 1),
        "seq-er": 100.0 * wrong_seqs / max(len(y_pred), 1),
    }


def compute_metrics(
    y_true: Sequence[List[str]],
    y_pred: Sequence[List[str]],
    compute_mv2h: bool = False,
) -> Dict[str, float]:
    metrics = compute_ed_metrics(y_true, y_pred)
    if compute_mv2h:
        try:
            from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h import compute_mv2h_metrics

            metrics.update(compute_mv2h_metrics(y_true, y_pred))
        except ImportError:
            from omr_a2s_multimodal_transformer_tpu_torch.utils.mv2h_native import compute_mv2h_metrics_native

            logging.getLogger(__name__).warning(
                "music21/pyMV2H not installed: scoring MV2H with the native "
                "implementation (utils/mv2h_native.py; harmony undefined on kern)"
            )
            metrics.update({k: v for k, v in compute_mv2h_metrics_native(y_true, y_pred).items()
                            if v is not None})
    return metrics
