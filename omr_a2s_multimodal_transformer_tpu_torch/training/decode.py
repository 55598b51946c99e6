"""Greedy KV-cached decoding.

Port of ``greedy_decode_fn`` and ``cut_at_eos`` from
``omr_a2s_multimodal_transformer_tpu/training/decode.py``. The JAX
``lax.while_loop`` becomes a Python loop over ``decode_step`` that stops
when every row has emitted <eos> (one host read of the done flags per
step). Weighted and beam decoding are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def greedy_decode_fn(model, max_len: int, sos_id: int, eos_id: int) -> Callable:
    """f(x [B, H, W, 1], hw [B, 2] or None) -> (tokens [B, max_len] int32,
    scores [B, max_len] f32: the top-1 raw logit per step). Positions after
    the loop stops stay 0."""

    @torch.no_grad()
    def decode(x: torch.Tensor, hw: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        cross, mem_valid = model.decode_prefill(x, hw)
        cache = model.decode_init_cache(b)
        tokens = torch.zeros((b, max_len), dtype=torch.int32, device=x.device)
        scores = torch.zeros((b, max_len), dtype=torch.float32, device=x.device)
        tok = torch.full((b,), sos_id, dtype=torch.int64, device=x.device)
        done = torch.zeros((b,), dtype=torch.bool, device=x.device)
        for pos in range(max_len):
            logits, cache = model.decode_step(tok, pos, cache, cross, mem_valid)
            score, tok = logits.max(dim=-1)
            tokens[:, pos] = tok.to(torch.int32)
            scores[:, pos] = score.float()
            done |= tok == eos_id
            if bool(done.all()):
                break
        return tokens, scores

    return decode


def cut_at_eos(tokens, scores, eos_id: int) -> Tuple[list, list]:
    """[B, L] -> per-sample lists of ids and scores, cut right after the
    first <eos> (the reference keeps the eos token)."""
    tokens = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor) else tokens)
    scores = np.asarray(scores.cpu() if isinstance(scores, torch.Tensor) else scores)
    out_t, out_s = [], []
    for row_t, row_s in zip(tokens, scores):
        hits = np.nonzero(row_t == eos_id)[0]
        end = int(hits[0]) + 1 if len(hits) else len(row_t)
        out_t.append(row_t[:end].tolist())
        out_s.append(row_s[:end].tolist())
    return out_t, out_s
