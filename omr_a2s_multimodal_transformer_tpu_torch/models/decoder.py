"""Autoregressive transformer decoder with KV-cached decoding.

Port of ``omr_a2s_multimodal_transformer_tpu/models/decoder.py``: token
embedding (pad row pinned to zero), fixed 1D sinusoidal PE + dropout, 8
post-LN decoder layers (4 heads, d_model 256, ff 256, ReLU, dropout 0.1)
and a pointwise classifier. Parameters carry the reference PyTorch
state_dict names (``transformer_decoder.layers.{i}.self_attn.in_proj_*``,
``multihead_attn``, ``linear{1,2}``, ``norm{1,2,3}``, ``out_layer`` as a
Conv1d weight [V, D, 1]).

Ported: the full-sequence forward with plain or flash cross-attention
(``ops/flash_packed.py``, kernels K1/K2 on CUDA) and float decode caches.
Not ported yet: ``attn_window > 0`` (banded self-attention and the ring
cache) and int8/int4 caches; both raise.

Dtypes follow flax's promotion rule (a layer runs in the promoted dtype of
its input and parameters), so the bf16 compute mode of the train step,
which casts the parameters to bf16, promotes the same tensors as in the
JAX package: the f32 positional encodings lift the decoder back to f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omr_a2s_multimodal_transformer_tpu_torch.models.positional import positional_encoding_1d
from omr_a2s_multimodal_transformer_tpu_torch.ops import masks as M
from omr_a2s_multimodal_transformer_tpu_torch.ops.attention import (
    attend,
    attend_packed_single_query,
    merge_heads,
    split_heads,
)
from omr_a2s_multimodal_transformer_tpu_torch.ops.flash_packed import flash_attention_packed

INT32_MAX = 2 ** 31 - 1


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Statistics in f32, output in the promoted dtype (flax LayerNorm)."""
    dt = torch.promote_types(x.dtype, norm.weight.dtype)
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
    return y.to(dt)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class MultiheadProj(nn.Module):
    """Q/K/V/out projections with torch ``nn.MultiheadAttention``'s
    parameter names: packed ``in_proj_weight`` [3D, D] and ``out_proj``."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def _proj(self, x, i):
        d = self.in_proj_weight.shape[1]
        return linear(x, self.in_proj_weight[i * d:(i + 1) * d], self.in_proj_bias[i * d:(i + 1) * d])

    def q_proj(self, x):
        return self._proj(x, 0)

    def k_proj(self, x):
        return self._proj(x, 1)

    def v_proj(self, x):
        return self._proj(x, 2)

    def out(self, x):
        return linear(x, self.out_proj.weight, self.out_proj.bias)

    def forward(self, q_in, kv_in, mask, dropout_rate=0.0, generator=None):
        q = split_heads(self.q_proj(q_in), self.n_heads)
        k = split_heads(self.k_proj(kv_in), self.n_heads)
        v = split_heads(self.v_proj(kv_in), self.n_heads)
        return self.out(merge_heads(attend(q, k, v, mask, dropout_rate, generator)))


class DecoderLayer(nn.Module):
    """Post-LN layer: self-attn -> cross-attn -> FF (torch
    TransformerDecoderLayer with norm_first=False, ReLU)."""

    def __init__(self, d_model=256, n_heads=4, ff_dim=256, dropout=0.1, use_flash_cross=False):
        super().__init__()
        self.self_attn = MultiheadProj(d_model, n_heads)
        self.multihead_attn = MultiheadProj(d_model, n_heads)
        self.linear1 = nn.Linear(d_model, ff_dim)
        self.linear2 = nn.Linear(ff_dim, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.n_heads, self.dropout, self.use_flash_cross = n_heads, dropout, use_flash_cross

    def _ff(self, x, generator):
        h = torch.relu(linear(x, self.linear1.weight, self.linear1.bias))
        return linear(dropout(h, self.dropout, generator), self.linear2.weight, self.linear2.bias)

    def forward(self, x, memory, self_mask, mem_mask, generator=None, memory_valid=None):
        rate = self.dropout if generator is not None else 0.0
        h = self.self_attn(x, x, self_mask, rate, generator)
        x = layer_norm(x + dropout(h, rate, generator), self.norm1)
        if self.use_flash_cross:
            # bf16 at the kernel boundary, as in the JAX layer; softmax
            # statistics stay f32 inside the kernel.
            ca = self.multihead_attn
            qp = ca.q_proj(x).to(torch.bfloat16).contiguous()
            kp = ca.k_proj(memory).to(torch.bfloat16).contiguous()
            vp = ca.v_proj(memory).to(torch.bfloat16).contiguous()
            b, s = memory.shape[0], memory.shape[1]
            kv_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
            kv_valid = memory_valid if memory_valid is not None else torch.ones((b, s), dtype=torch.bool, device=x.device)
            if rate > 0.0:
                seed = torch.randint(0, INT32_MAX, (1,), generator=generator, device=x.device, dtype=torch.int32)
            else:
                seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
            o = flash_attention_packed(qp, kp, vp, kv_len, kv_valid.contiguous(), seed,
                                       dropout_rate=rate, n_heads=self.n_heads)
            h = ca.out(o)
        else:
            h = self.multihead_attn(x, memory, mem_mask, rate, generator)
        x = layer_norm(x + dropout(h, rate, generator), self.norm2)
        x = layer_norm(x + dropout(self._ff(x, generator), rate, generator), self.norm3)
        return x

    def cross_kv(self, memory):
        """Cross-attention K/V, head-packed [B, S, D], once per sequence."""
        return self.multihead_attn.k_proj(memory), self.multihead_attn.v_proj(memory)

    def step(self, x, pos: int, cache_k, cache_v, cross_k, cross_v, self_mask, mem_bias):
        """One decode step. x [B, 1, D]; caches head-packed [B, cache_len, D],
        written in place at ``pos``. Returns y [B, 1, D]."""
        sa, ca = self.self_attn, self.multihead_attn
        q = sa.q_proj(x)[:, 0]
        cache_k[:, pos] = sa.k_proj(x)[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = sa.v_proj(x)[:, 0].to(cache_v.dtype)
        h = attend_packed_single_query(q, cache_k, cache_v, self.n_heads, self_mask)
        x = layer_norm(x + sa.out(h[:, None, :].to(x.dtype)), self.norm1)
        q2 = ca.q_proj(x)[:, 0]
        h = attend_packed_single_query(q2, cross_k, cross_v, self.n_heads, mem_bias)
        x = layer_norm(x + ca.out(h[:, None, :].to(x.dtype)), self.norm2)
        return layer_norm(x + self._ff(x, None), self.norm3)


class _Layers(nn.Module):
    """Holder that gives the layers the reference path ``transformer_decoder.layers``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class KernDecoder(nn.Module):
    """Embedding + PE + N decoder layers + classifier."""

    def __init__(self, vocab_size: int, max_seq_len: int, d_model: int = 256, n_heads: int = 4,
                 ff_dim: int = 256, n_layers: int = 8, dropout: float = 0.1, attn_window: int = -1,
                 cache_dtype: str = "float32", use_flash_cross: bool = False):
        super().__init__()
        if attn_window > 0:
            raise NotImplementedError("windowed self-attention (attn_window > 0) is not ported yet")
        if cache_dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"cache_dtype {cache_dtype!r} is not ported yet")
        self.vocab_size, self.max_seq_len, self.d_model = vocab_size, max_seq_len, d_model
        self.n_layers, self.dropout, self.cache_dtype = n_layers, dropout, cache_dtype
        self.use_flash_cross = use_flash_cross
        self.embedding = nn.Embedding(vocab_size, d_model)
        nn.init.normal_(self.embedding.weight, std=1.0)
        self.transformer_decoder = _Layers(
            DecoderLayer(d_model, n_heads, ff_dim, dropout, use_flash_cross) for _ in range(n_layers)
        )
        self.out_layer = nn.Conv1d(d_model, vocab_size, 1)
        self.register_buffer("pe", torch.from_numpy(positional_encoding_1d(max_seq_len, d_model)), persistent=False)

    @property
    def layers(self):
        return self.transformer_decoder.layers

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        # pad row pinned to zero: zero vector and zero gradient (padding_idx)
        w = self.embedding.weight
        row0 = torch.arange(w.shape[0], device=w.device)[:, None] == 0
        return F.embedding(ids, torch.where(row0, torch.zeros((), dtype=w.dtype, device=w.device), w))

    def _logits(self, x):
        return linear(x, self.out_layer.weight[:, :, 0], self.out_layer.bias)

    def forward(self, tgt_ids: torch.Tensor, memory: torch.Tensor, memory_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, torch_float_parity: bool = False) -> torch.Tensor:
        """Full-sequence decode (training). Returns logits [B, L, V].

        generator=None is deterministic. The target pad mask is applied
        only when a memory mask is present, as in the reference.
        """
        b, l = tgt_ids.shape
        gen = generator if self.dropout > 0.0 else None
        x = dropout(self._embed(tgt_ids) + self.pe[None, :l], self.dropout, gen)
        self_mask = M.windowed_causal_mask(l, -1, device=x.device)[None, None]
        mem_mask = None
        if memory_valid is not None:
            pad_bias = 1.0 if torch_float_parity else M.NEG_INF
            key_bias = torch.where(tgt_ids != 0, 0.0, pad_bias)
            self_mask = self_mask + key_bias[:, None, None, :]
            mem_mask = M.key_padding_additive(memory_valid, torch_float_parity=torch_float_parity)
        if self.use_flash_cross and torch_float_parity:
            raise ValueError("flash cross-attention implies -inf pad masking")
        for layer in self.layers:
            x = layer(x, memory, self_mask, mem_mask, gen, memory_valid if self.use_flash_cross else None)
        return self._logits(x)

    # ---------------------------------------------------------------- decode
    @property
    def cache_len(self) -> int:
        return self.max_seq_len

    def _cache_dtype(self):
        return getattr(torch, self.cache_dtype)

    def init_cache(self, batch: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Head-packed [B, cache_len, D] self-attention caches per layer."""
        dev = self.embedding.weight.device
        shape = (batch, self.cache_len, self.d_model)
        return {
            f"layer{i}": {"k": torch.zeros(shape, dtype=self._cache_dtype(), device=dev),
                          "v": torch.zeros(shape, dtype=self._cache_dtype(), device=dev)}
            for i in range(self.n_layers)
        }

    def prefill(self, memory: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-layer cross-attention K/V from the memory, in the cache dtype."""
        dt = self._cache_dtype()
        return {
            f"layer{i}": {n: t.to(dt) for n, t in zip(("k", "v"), layer.cross_kv(memory))}
            for i, layer in enumerate(self.layers)
        }

    def step(self, token_ids: torch.Tensor, pos: int, cache, cross,
             memory_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """One greedy-decode step at position ``pos`` (a Python int).
        Returns (logits [B, V], cache); the caches are updated in place."""
        x = self._embed(token_ids)[:, None, :] + self.pe[pos][None, None]
        allowed = torch.arange(self.cache_len, device=x.device)[None, :] <= pos
        self_mask = torch.where(allowed, 0.0, M.NEG_INF)  # [1, cache_len]
        mem_bias = None if memory_valid is None else torch.where(memory_valid, 0.0, M.NEG_INF)
        for i, layer in enumerate(self.layers):
            c, cr = cache[f"layer{i}"], cross[f"layer{i}"]
            x = layer.step(x, pos, c["k"], c["v"], cr["k"], cr["v"], self_mask, mem_bias)
        return self._logits(x)[:, 0, :], cache
