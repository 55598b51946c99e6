"""KV-cached decoding: greedy, weighted late fusion and beam search.

Port of ``omr_a2s_multimodal_transformer_tpu/training/decode.py``. Each JAX
``lax.while_loop`` becomes a Python loop over ``decode_step`` that stops
when every row (every beam) has emitted <eos>, with one host read of the
done flags per step:

- ``greedy``: tokens + the top-1 raw-logit score per step;
- ``weighted``: two unimodal models in lockstep, next-token distribution
  alpha*softmax(img) + (1-alpha)*softmax(audio), score the top-1 mixed
  probability;
- ``beam``: batched beam search, finished beams frozen, GNMT length
  penalty at the end.

The caches are updated in place by ``decode_step``; beam search replaces
every cache tensor by its rows gathered by source beam, so beams that share
a source never alias. Under ``OMR_A2S_DEBUG_CHECKS`` (``utils/debug.py``)
every step raises on a token id fed outside the vocabulary and on
non-finite logits.

On a mesh (a model built with ``build_model(..., mesh=)``) each rank
decodes its rows on its heads, and the loops stop only when every row of
every rank is done (``all_done``): the tensor-parallel collectives need
every rank to run the same number of steps, and the tokens then equal a
single-process decode of the whole batch. A remainder batch is padded by
``parallel/mesh.py`` ``shard_batch``; the caller drops the padded rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_reduce
from omr_a2s_multimodal_transformer_tpu_torch.utils.debug import check_finite, check_token_ids, debug_checks_enabled

NEG_INF = -1e9  # the score of a dead beam


def _checked_step(model):
    """``model.decode_step``, with the debug checks when they are on."""
    if not debug_checks_enabled():
        return model.decode_step
    vocab = model.vocab_size

    def step(tok, pos, cache, cross, mem_valid):
        check_token_ids("a decode step's input token", tok, vocab)
        logits, cache = model.decode_step(tok, pos, cache, cross, mem_valid)
        check_finite(f"the decode logits at position {pos}", [logits])
        return logits, cache

    return step


def all_done(done: torch.Tensor, mesh) -> bool:
    """Whether every row is done on every rank of ``mesh`` (one host read)."""
    pending = (~done).any().to(torch.int32)
    if mesh is not None and mesh.size > 1:
        pending = all_reduce(all_reduce(pending.reshape(1), mesh.data_axis), mesh.model_axis)
    return not bool(pending.any())


def _loop(step_logits: Callable, batch: int, max_len: int, sos_id: int, eos_id: int, carry,
          device: torch.device, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared greedy loop. ``step_logits(tok, pos, carry) -> (logits, carry)``;
    the top-1 index is the next token and its value the step's score."""
    tokens = torch.zeros((batch, max_len), dtype=torch.int32, device=device)
    scores = torch.zeros((batch, max_len), dtype=torch.float32, device=device)
    tok = torch.full((batch,), sos_id, dtype=torch.int64, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    for pos in range(max_len):
        logits, carry = step_logits(tok, pos, carry)
        score, tok = logits.max(dim=-1)
        tokens[:, pos] = tok.to(torch.int32)
        scores[:, pos] = score.float()
        done |= tok == eos_id
        if all_done(done, mesh):
            break
    return tokens, scores


def _model_step(model, cross, mem_valid):
    decode_step = _checked_step(model)

    def step_logits(tok, pos, cache):
        return decode_step(tok, pos, cache, cross, mem_valid)

    return step_logits


def greedy_decode_fn(model, max_len: int, sos_id: int, eos_id: int, multimodal: bool = False) -> Callable:
    """Unimodal:   f(x [B, H, W, 1], hw [B, 2] or None) -> (tokens, scores).
    Multimodal: f(xi, xi_hw, xa, xa_hw) -> (tokens, scores).

    tokens [B, max_len] int32, scores [B, max_len] f32: the top-1 raw logit
    per step. Positions after the loop stops stay 0. hw arguments may be
    None (no memory padding, no mask)."""

    if multimodal:
        @torch.no_grad()
        def decode_mm(xi: torch.Tensor, xi_hw: Optional[torch.Tensor], xa: torch.Tensor,
                      xa_hw: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
            b = xi.shape[0]
            step = _model_step(model, *model.decode_prefill(xi, xa, xi_hw, xa_hw))
            return _loop(step, b, max_len, sos_id, eos_id, model.decode_init_cache(b), xi.device, model.mesh)

        return decode_mm

    @torch.no_grad()
    def decode(x: torch.Tensor, hw: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        b = x.shape[0]
        step = _model_step(model, *model.decode_prefill(x, hw))
        return _loop(step, b, max_len, sos_id, eos_id, model.decode_init_cache(b), x.device, model.mesh)

    return decode


def weighted_decode_fn(img_model, audio_model, max_len: int, sos_id: int, eos_id: int) -> Callable:
    """Two-unimodal-model weighted late fusion:
    f(xi, xi_hw, xa, xa_hw, alpha) -> (tokens [B, max_len], scores), the
    next-token distribution alpha*softmax(img) + (1-alpha)*softmax(audio)
    and the score its top-1 probability. Both caches advance in lockstep."""

    @torch.no_grad()
    def decode(xi: torch.Tensor, xi_hw: Optional[torch.Tensor], xa: torch.Tensor, xa_hw: Optional[torch.Tensor],
               alpha) -> Tuple[torch.Tensor, torch.Tensor]:
        b = xi.shape[0]
        step_i = _model_step(img_model, *img_model.decode_prefill(xi, xi_hw))
        step_a = _model_step(audio_model, *audio_model.decode_prefill(xa, xa_hw))
        a = torch.as_tensor(alpha, dtype=torch.float32, device=xi.device)  # 1 - alpha in float32, as JAX's traced alpha

        def step_logits(tok, pos, carry):
            li, ci = step_i(tok, pos, carry["i"])
            la, ca = step_a(tok, pos, carry["a"])
            mixed = a * torch.softmax(li, dim=-1) + (1.0 - a) * torch.softmax(la, dim=-1)
            return mixed, {"i": ci, "a": ca}

        carry = {"i": img_model.decode_init_cache(b), "a": audio_model.decode_init_cache(b)}
        return _loop(step_logits, b, max_len, sos_id, eos_id, carry, xi.device, img_model.mesh)

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


# ----------------------------------------------------------------- beam search


def _reorder(cache: Dict, rows: torch.Tensor) -> Dict:
    """Every cache tensor replaced by its rows ``rows`` (a gather copies, so
    beams that take the same source own separate rows)."""
    return {name: {k: t.index_select(0, rows) for k, t in layer.items()} for name, layer in cache.items()}


def beam_decode_fn(model, max_len: int, sos_id: int, eos_id: int, beam_size: int = 4,
                   length_penalty: float = 0.0, multimodal: bool = False) -> Callable:
    """Batched beam search over the KV-cached decoder.

    Unimodal:   f(x, hw) -> (tokens [B, max_len], scores [B]).
    Multimodal: f(xi, xi_hw, xa, xa_hw) -> same.
    Finished beams are frozen (forced eos continuation with zero added
    logprob). Length penalty: score / ((5+len)/6)^lp (GNMT).

    The top k of the k*V candidates is a stable descending sort: equal
    scores (every dead or frozen candidate rounds to exactly -1e9 in
    float32) go to the lower flat index first, as ``jax.lax.top_k`` does.
    """

    @torch.no_grad()
    def decode(*inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        if multimodal:
            xi, xi_hw, xa, xa_hw = inputs
            cross, mem_valid = model.decode_prefill(xi, xa, xi_hw, xa_hw)
            b, dev = xi.shape[0], xi.device
        else:
            x, hw = inputs
            cross, mem_valid = model.decode_prefill(x, hw)
            b, dev = x.shape[0], x.device
        k = beam_size
        decode_step = _checked_step(model)
        cross_k = {name: {n: t.repeat_interleave(k, dim=0) for n, t in layer.items()} for name, layer in cross.items()}
        valid_k = None if mem_valid is None else mem_valid.repeat_interleave(k, dim=0)
        cache = model.decode_init_cache(b * k)

        # beam 0 live, the others dead at the start, so the first expansion is unique
        logp = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
        logp[:, 0] = 0.0
        tokens = torch.zeros((b, k, max_len), dtype=torch.int32, device=dev)
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        tok = torch.full((b * k,), sos_id, dtype=torch.int64, device=dev)
        batch_idx = torch.arange(b, device=dev)[:, None]
        frozen = None
        for pos in range(max_len):
            logits, cache = decode_step(tok, pos, cache, cross_k, valid_k)
            v = logits.shape[-1]
            if frozen is None:  # a finished beam: only eos, at no change of score
                frozen = torch.full((k, v), NEG_INF, dtype=torch.float32, device=dev)
                frozen[:, eos_id] = 0.0
            lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
            lp = torch.where(done[..., None], frozen[None], lp)
            flat = (logp[..., None] + lp).reshape(b, k * v)
            top_logp, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
            top_logp, top_idx = top_logp[:, :k], top_idx[:, :k]
            src_beam = top_idx // v
            next_tok = top_idx % v
            tokens = tokens[batch_idx, src_beam]
            tokens[:, :, pos] = next_tok.to(torch.int32)
            done = done[batch_idx, src_beam] | (next_tok == eos_id)
            cache = _reorder(cache, (batch_idx * k + src_beam).reshape(-1))
            tok, logp = next_tok.reshape(-1), top_logp
            if all_done(done, model.mesh):
                break

        if length_penalty > 0.0:
            lens = ((tokens == eos_id).cumsum(dim=-1) == 0).sum(dim=-1) + 1
            logp = logp / torch.pow((5.0 + lens.float()) / 6.0, length_penalty)
        best = logp.argmax(dim=1)
        rows = torch.arange(b, device=dev)
        return tokens[rows, best], logp[rows, best]

    return decode
