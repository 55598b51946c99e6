"""Autoregressive transformer decoder with KV-cached decoding.

Port of ``omr_a2s_multimodal_transformer_tpu/models/decoder.py``: token
embedding (pad row pinned to zero), fixed 1D sinusoidal PE + dropout, 8
post-LN decoder layers (4 heads, d_model 256, ff 256, ReLU, dropout 0.1)
and a pointwise classifier. Parameters carry the reference PyTorch
state_dict names (``transformer_decoder.layers.{i}.self_attn.in_proj_*``,
``multihead_attn``, ``linear{1,2}``, ``norm{1,2,3}``, ``out_layer`` as a
Conv1d weight [V, D, 1]) and are drawn as JAX's are: lecun_normal kernels
and zero biases (``models/init.py``), the embedding from normal(1.0).

Ported: the full-sequence forward with plain or flash cross-attention
(``ops/flash_packed.py``, kernels K1/K2 on CUDA), windowed self-attention
(``attn_window > 0``: the windowed causal mask up to two band chunks, the
banded attention of ``ops/banded_attention.py`` above, both plain PyTorch
as they are XLA in the JAX package) and the decode caches, with a ring
self-cache of ``attn_window + 1`` slots when windowed: float32 or bfloat16
throughout, or int8/int4 cross K/V (``quantize_cross``) beside a bfloat16
self-cache.

Tensor parallelism (``parallel/``, after ``parallel.tp.shard_model``): the
q/k/v rows of each packed ``in_proj`` block and ``linear1`` are
column-parallel, so each rank runs its heads and FF columns; ``out_proj``
and ``linear2`` are row-parallel, summed over 'model' by an all-reduce
before their bias; ``out_layer`` is column-parallel when the vocabulary
divides, its logits gathered. Decoding runs on the local heads too; int4's
per-token scale is a max over all channels, an all-reduce over 'model'.
``remat`` recomputes each layer in the backward (``models/remat.py``); the
models ask for it only off the flash path, as JAX's do.

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

from omr_a2s_multimodal_transformer_tpu_torch.models.init import dense_, lecun_normal_
from omr_a2s_multimodal_transformer_tpu_torch.models.positional import positional_encoding_1d
from omr_a2s_multimodal_transformer_tpu_torch.ops import masks as M
from omr_a2s_multimodal_transformer_tpu_torch.ops.attention import (
    attend,
    attend_packed_single_query,
    merge_heads,
    pack_int4,
    split_heads,
)
from omr_a2s_multimodal_transformer_tpu_torch.ops.banded_attention import band_chunk, banded_causal_attention
from omr_a2s_multimodal_transformer_tpu_torch.models.remat import remat
from omr_a2s_multimodal_transformer_tpu_torch.ops.flash_packed import MASK_BK, MASK_BQ, flash_attention_packed_auto
from omr_a2s_multimodal_transformer_tpu_torch.parallel import mesh as mesh_lib
from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_reduce, copy_to, gather_from, reduce_from

INT32_MAX = 2 ** 31 - 1
CACHE_DTYPES = ("float32", "bfloat16", "int8", "int4")
QUANT_QMAX = {"int8": 127.0, "int4": 7.0}


def quantize_cross(t: torch.Tensor, cache_dtype: str, axis=None) -> Dict[str, torch.Tensor]:
    """One cross K or V [B, S, D] -> its cache entry, computed in float32
    as the JAX prefill computes it (``torch.round`` and ``jnp.round`` both
    round half to even):

    - int8: scale s = max(max_S |t|, 1e-8) / 127 per (batch, channel),
      [B, D]; codes clip(round(t / s), +-127) as ``torch.int8``.
      Returns {"q": codes, "scale": s}.
    - int4 (rank-1): s_c = max(max_S |t|, 1e-8) per (batch, channel), not
      divided by qmax; t' = t / s_c; s_t = max(max_D |t'|, 1e-8) / 7 per
      (batch, token), [B, S]; codes clip(round(t' / s_t), +-7), packed two
      a byte by ``pack_int4`` into uint8 [B, S, D/2].
      Returns {"q": packed codes, "scale": s_c, "tscale": s_t}.

    ``axis``: the 'model' axis when ``t`` holds this rank's channels; the
    int4 token scale's max over channels is then reduced over it.
    """
    qmax = QUANT_QMAX[cache_dtype]
    t = t.float()
    # qmax as a tensor: a CUDA division by a host scalar multiplies by its reciprocal (an ulp off the quotient)
    q = torch.tensor(qmax, dtype=torch.float32, device=t.device)
    if cache_dtype == "int4":
        s_c = torch.clamp(t.abs().amax(dim=1), min=1e-8)  # [B, D]
        t = t / s_c[:, None, :]
        s_t = torch.clamp(all_reduce(t.abs().amax(dim=2), axis, "max"), min=1e-8) / q  # [B, S]
        codes = torch.clamp(torch.round(t / s_t[:, :, None]), -qmax, qmax).to(torch.int8)
        return {"q": pack_int4(codes), "scale": s_c, "tscale": s_t}
    s = torch.clamp(t.abs().amax(dim=1), min=1e-8) / q  # [B, D]
    return {"q": torch.clamp(torch.round(t / s[:, None, :]), -qmax, qmax).to(torch.int8), "scale": s}


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Statistics in f32, output in the promoted dtype (flax LayerNorm)."""
    dt = torch.promote_types(x.dtype, norm.weight.dtype)
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
    return y.to(dt)


def row_parallel(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], axis) -> torch.Tensor:
    """``linear`` of a row-parallel layer: this rank's input columns, the
    products summed over ``axis``, then the (replicated) bias."""
    if axis is None:
        return linear(x, weight, bias)
    y = reduce_from(linear(x, weight, None), axis)
    return y if bias is None else y + bias.to(y.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            model_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout; the bits are this rank's slice of the global draw
    (``parallel/mesh.py`` ``rand``; ``model_dim`` the dim sharded over
    'model', if any)."""
    if generator is None or rate == 0.0:
        return x
    keep = mesh_lib.rand(x.shape, generator, x.device, model_dim) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class MultiheadProj(nn.Module):
    """Q/K/V/out projections with torch ``nn.MultiheadAttention``'s
    parameter names: packed ``in_proj_weight`` [3D, D] and ``out_proj``.
    Sharded over 'model', each D-row block of ``in_proj`` holds this rank's
    heads and ``out_proj`` their input columns."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        # JAX draws three [d, d] Dense kernels (fan_in d each) and zero biases
        self.in_proj_weight = nn.Parameter(lecun_normal_(torch.empty(3 * d_model, d_model)))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = dense_(nn.Linear(d_model, d_model))
        self.mesh = None  # parallel.tp.shard_model sets it

    @property
    def axis(self):
        """The 'model' axis when the heads are sharded over it, else None."""
        w = self.in_proj_weight
        return None if self.mesh is None or w.shape[0] == 3 * w.shape[1] else self.mesh.model_axis

    @property
    def heads(self) -> int:
        """The heads this rank computes."""
        return self.in_proj_weight.shape[0] // (3 * self.head_dim)

    def inp(self, x):
        """An input of the projections (replicated over 'model'): its gradient is summed over the heads' ranks."""
        return copy_to(x, self.axis)

    def _proj(self, x, i):
        n = self.in_proj_weight.shape[0] // 3
        return linear(x, self.in_proj_weight[i * n:(i + 1) * n], self.in_proj_bias[i * n:(i + 1) * n])

    def q_proj(self, x):
        return self._proj(x, 0)

    def k_proj(self, x):
        return self._proj(x, 1)

    def v_proj(self, x):
        return self._proj(x, 2)

    def out(self, x):
        return row_parallel(x, self.out_proj.weight, self.out_proj.bias, self.axis)

    def forward(self, q_in, kv_in, mask, dropout_rate=0.0, generator=None, kv_in_copied=False):
        """``kv_in_copied``: ``kv_in`` has been through ``inp`` already (the
        decoder's memory, whose gradient is summed over 'model' once for all
        its layers)."""
        same = kv_in is q_in
        q_in = self.inp(q_in)
        kv_in = q_in if same else (kv_in if kv_in_copied else self.inp(kv_in))
        h = self.heads
        q, k, v = (split_heads(f(x), h) for f, x in ((self.q_proj, q_in), (self.k_proj, kv_in), (self.v_proj, kv_in)))
        o = attend(q, k, v, mask, dropout_rate, generator, heads_sharded=self.axis is not None)
        return self.out(merge_heads(o))


class DecoderLayer(nn.Module):
    """Post-LN layer: self-attn -> cross-attn -> FF (torch
    TransformerDecoderLayer with norm_first=False, ReLU)."""

    def __init__(self, d_model=256, n_heads=4, ff_dim=256, dropout=0.1, use_flash_cross=False):
        super().__init__()
        self.self_attn = MultiheadProj(d_model, n_heads)
        self.multihead_attn = MultiheadProj(d_model, n_heads)
        self.linear1 = dense_(nn.Linear(d_model, ff_dim))
        self.linear2 = dense_(nn.Linear(ff_dim, d_model))
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.n_heads, self.dropout, self.use_flash_cross = n_heads, dropout, use_flash_cross
        self.ff_dim = ff_dim
        self.mesh = None  # parallel.tp.shard_model sets it

    @property
    def ff_axis(self):
        """The 'model' axis when the FF columns are sharded over it, else None."""
        return None if self.mesh is None or self.linear1.weight.shape[0] == self.ff_dim else self.mesh.model_axis

    def _ff(self, x, generator):
        ax = self.ff_axis
        h = torch.relu(linear(copy_to(x, ax), self.linear1.weight, self.linear1.bias))
        h = dropout(h, self.dropout, generator, model_dim=None if ax is None else -1)
        return row_parallel(h, self.linear2.weight, self.linear2.bias, ax)

    def forward(self, x, memory, self_mask, mem_mask, generator=None, memory_valid=None,
                banded_window: int = 0, self_key_bias=None):
        """banded_window > 0 computes the self-attention as that exact band
        (``self_key_bias`` [B, L] its additive key bias); else ``self_mask``.
        ``memory`` has been through the cross-attention's ``inp`` (the
        decoder does it once for all layers)."""
        rate = self.dropout if generator is not None else 0.0
        if banded_window > 0:
            sa = self.self_attn
            xs = sa.inp(x)
            q, k, v = (split_heads(f(xs), sa.heads) for f in (sa.q_proj, sa.k_proj, sa.v_proj))
            h = banded_causal_attention(q, k, v, banded_window, key_bias=self_key_bias, dropout_rate=rate,
                                        generator=generator, heads_sharded=sa.axis is not None)
            h = sa.out(merge_heads(h))
        else:
            h = self.self_attn(x, x, self_mask, rate, generator)
        x = layer_norm(x + dropout(h, rate, generator), self.norm1)
        if self.use_flash_cross:
            # bf16 at the kernel boundary, as in the JAX layer; softmax
            # statistics stay f32 inside the kernel.
            # Under a mesh the kernel runs on this rank's rows and heads
            # (flash_attention_packed_auto); each projection is contiguous.
            ca = self.multihead_attn
            qp = ca.q_proj(ca.inp(x)).to(torch.bfloat16).contiguous()
            kp = ca.k_proj(memory).to(torch.bfloat16).contiguous()
            vp = ca.v_proj(memory).to(torch.bfloat16).contiguous()
            b, s = memory.shape[0], memory.shape[1]
            kv_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
            kv_valid = memory_valid if memory_valid is not None else torch.ones((b, s), dtype=torch.bool, device=x.device)
            if rate > 0.0:
                seed = torch.randint(0, INT32_MAX, (1,), generator=generator, device=x.device, dtype=torch.int32)
            else:
                seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
            mesh = self.mesh
            flash = flash_attention_packed_auto(self.n_heads, ca.head_dim, b * (mesh.data if mesh else 1),
                                                block_q=MASK_BQ, block_k=MASK_BK, dropout_rate=rate, mesh=mesh)
            h = ca.out(flash(qp, kp, vp, kv_len, kv_valid.contiguous(), seed))
        else:
            h = self.multihead_attn(x, memory, mem_mask, rate, generator, kv_in_copied=True)
        x = layer_norm(x + dropout(h, rate, generator), self.norm2)
        x = layer_norm(x + dropout(self._ff(x, generator), rate, generator), self.norm3)
        return x

    def cross_kv(self, memory):
        """Cross-attention K/V, head-packed [B, S, D], once per sequence."""
        return self.multihead_attn.k_proj(memory), self.multihead_attn.v_proj(memory)

    def step(self, x, write_at: int, cache_k, cache_v, cross_k, cross_v, self_mask, mem_bias,
             cross_k_scale=None, cross_v_scale=None, cross_k_tscale=None, cross_v_tscale=None):
        """One decode step. x [B, 1, D]; caches head-packed [B, cache_len, D],
        written in place at slot ``write_at`` (the position, or its ring
        slot); cross K/V float, or int8/int4 codes with their scales
        (``quantize_cross``). Returns y [B, 1, D]."""
        sa, ca = self.self_attn, self.multihead_attn
        q = sa.q_proj(x)[:, 0]
        cache_k[:, write_at] = sa.k_proj(x)[:, 0].to(cache_k.dtype)
        cache_v[:, write_at] = sa.v_proj(x)[:, 0].to(cache_v.dtype)
        h = attend_packed_single_query(q, cache_k, cache_v, sa.heads, self_mask)
        x = layer_norm(x + sa.out(h[:, None, :].to(x.dtype)), self.norm1)
        q2 = ca.q_proj(x)[:, 0]
        h = attend_packed_single_query(q2, cross_k, cross_v, ca.heads, mem_bias,
                                       k_scale=cross_k_scale, v_scale=cross_v_scale,
                                       k_tscale=cross_k_tscale, v_tscale=cross_v_tscale)
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
                 cache_dtype: str = "float32", use_flash_cross: bool = False, remat: bool = False):
        super().__init__()
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype {cache_dtype!r} is not one of {CACHE_DTYPES}")
        self.vocab_size, self.max_seq_len, self.d_model = vocab_size, max_seq_len, d_model
        self.n_layers, self.dropout, self.cache_dtype = n_layers, dropout, cache_dtype
        self.attn_window = attn_window
        self.use_flash_cross = use_flash_cross
        self.remat = remat
        self.mesh = None  # parallel.tp.shard_model sets it
        self.embedding = nn.Embedding(vocab_size, d_model)
        nn.init.normal_(self.embedding.weight, std=1.0)
        self.transformer_decoder = _Layers(
            DecoderLayer(d_model, n_heads, ff_dim, dropout, use_flash_cross) for _ in range(n_layers)
        )
        self.out_layer = dense_(nn.Conv1d(d_model, vocab_size, 1))
        self.register_buffer("pe", torch.from_numpy(positional_encoding_1d(max_seq_len, d_model)), persistent=False)

    @property
    def layers(self):
        return self.transformer_decoder.layers

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        # pad row pinned to zero: zero vector and zero gradient (padding_idx)
        w = self.embedding.weight
        row0 = torch.arange(w.shape[0], device=w.device)[:, None] == 0
        return F.embedding(ids, torch.where(row0, torch.zeros((), dtype=w.dtype, device=w.device), w))

    @property
    def vocab_axis(self):
        """The 'model' axis when the classifier's vocabulary is sharded over it, else None."""
        return None if self.mesh is None or self.out_layer.weight.shape[0] == self.vocab_size \
            else self.mesh.model_axis

    def _logits(self, x):
        ax = self.vocab_axis
        return gather_from(linear(copy_to(x, ax), self.out_layer.weight[:, :, 0], self.out_layer.bias), ax, -1)

    def forward(self, tgt_ids: torch.Tensor, memory: torch.Tensor, memory_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, torch_float_parity: bool = False) -> torch.Tensor:
        """Full-sequence decode (training). Returns logits [B, L, V].

        generator=None is deterministic. The target pad mask is applied
        only when a memory mask is present, as in the reference.
        """
        b, l = tgt_ids.shape
        gen = generator if self.dropout > 0.0 else None
        x = dropout(self._embed(tgt_ids) + self.pe[None, :l], self.dropout, gen)
        # windowed: the exact band above two chunks, the full masked matrix below
        w = self.attn_window
        banded = w if (w > 0 and l > 2 * band_chunk(w)) else 0
        self_mask = None if banded else M.windowed_causal_mask(l, w, device=x.device)[None, None]
        self_key_bias = mem_mask = None
        if memory_valid is not None:
            pad_bias = 1.0 if torch_float_parity else M.NEG_INF
            key_bias = torch.where(tgt_ids != 0, 0.0, pad_bias)
            if banded:
                self_key_bias = key_bias
            else:
                self_mask = self_mask + key_bias[:, None, None, :]
            mem_mask = M.key_padding_additive(memory_valid, torch_float_parity=torch_float_parity)
        if self.use_flash_cross and torch_float_parity:
            raise ValueError("flash cross-attention implies -inf pad masking")
        # the memory's gradient is summed over 'model' once, not once a layer (one all-reduce of [B, S, D])
        memory = self.layers[0].multihead_attn.inp(memory)
        args = (memory, self_mask, mem_mask, gen, memory_valid if self.use_flash_cross else None, banded,
                self_key_bias)
        for layer in self.layers:
            x = remat(layer, gen, x, *args) if self.remat and torch.is_grad_enabled() else layer(x, *args)
        return self._logits(x)

    # ---------------------------------------------------------------- decode
    @property
    def cache_len(self) -> int:
        """Self-attention cache slots: with a window only the last W + 1
        positions are attended, so the cache is a ring of that size."""
        if self.attn_window > 0:
            return min(self.max_seq_len, self.attn_window + 1)
        return self.max_seq_len

    def _cache_dtype(self):
        """The self-cache's dtype, and the cross K/V's when not quantized:
        under int8/int4 the self ring cache stays bfloat16 (it is appended
        every step; requantizing a running ring would drift)."""
        return torch.bfloat16 if self.cache_dtype in QUANT_QMAX else getattr(torch, self.cache_dtype)

    def init_cache(self, batch: int) -> Dict[str, Dict[str, torch.Tensor]]:
        """Head-packed [B, cache_len, D] self-attention caches per layer (D: this rank's heads' columns)."""
        dev = self.embedding.weight.device
        shape = (batch, self.cache_len, self.layers[0].self_attn.heads * self.layers[0].self_attn.head_dim)
        return {
            f"layer{i}": {"k": torch.zeros(shape, dtype=self._cache_dtype(), device=dev),
                          "v": torch.zeros(shape, dtype=self._cache_dtype(), device=dev)}
            for i in range(self.n_layers)
        }

    def prefill(self, memory: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-layer cross-attention K/V from the memory, in the cache dtype.
        Under int8/int4 each layer's entry holds, with JAX's key names, the
        codes "k", "v" and their scales "k_scale", "v_scale" [B, D] (int4:
        also "k_tscale", "v_tscale" [B, S]); every tensor's dim 0 is the
        batch, so a consumer that repeats or gathers rows takes them all."""
        if self.cache_dtype in QUANT_QMAX:
            out = {}
            for i, layer in enumerate(self.layers):
                entry = {}
                for name, t in zip(("k", "v"), layer.cross_kv(memory)):
                    qt = quantize_cross(t, self.cache_dtype, layer.multihead_attn.axis)
                    entry[name], entry[f"{name}_scale"] = qt["q"], qt["scale"]
                    if "tscale" in qt:
                        entry[f"{name}_tscale"] = qt["tscale"]
                out[f"layer{i}"] = entry
            return out
        dt = self._cache_dtype()
        return {
            f"layer{i}": {n: t.to(dt) for n, t in zip(("k", "v"), layer.cross_kv(memory))}
            for i, layer in enumerate(self.layers)
        }

    def step(self, token_ids: torch.Tensor, pos: int, cache, cross,
             memory_valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """One greedy-decode step at position ``pos`` (a Python int).
        Returns (logits [B, V], cache); the caches are updated in place.

        Past ``max_seq_len`` (a lockstep decode of two models of different
        lengths) the positional row and the cache slot clamp to the last
        ones, as JAX's dynamic slices clamp their start."""
        x = self._embed(token_ids)[:, None, :] + self.pe[min(pos, self.max_seq_len - 1)][None, None]
        c_len, w = self.cache_len, self.attn_window
        slot = torch.arange(c_len, device=x.device)[None, :]
        if w > 0 and c_len < self.max_seq_len:
            # ring: slot s holds position p_s = pos - ((pos - s) mod C), the
            # latest congruent to s; unwritten slots have p_s < 0
            write_at = pos % c_len
            p_s = pos - (pos - slot) % c_len
            allowed = (p_s >= 0) & (p_s >= pos - w)
        else:
            write_at = min(pos, c_len - 1)
            allowed = slot <= pos
            if w > 0:
                allowed &= slot >= pos - w
        self_mask = torch.where(allowed, 0.0, M.NEG_INF)  # [1, cache_len]
        mem_bias = None if memory_valid is None else torch.where(memory_valid, 0.0, M.NEG_INF)
        for i, layer in enumerate(self.layers):
            c, cr = cache[f"layer{i}"], cross[f"layer{i}"]
            x = layer.step(x, write_at, c["k"], c["v"], cr["k"], cr["v"], self_mask, mem_bias,
                           cr.get("k_scale"), cr.get("v_scale"), cr.get("k_tscale"), cr.get("v_tscale"))
        return self._logits(x)[:, 0, :], cache
