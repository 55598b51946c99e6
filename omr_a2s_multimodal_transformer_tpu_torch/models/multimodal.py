"""Multimodal (image + audio) transformer with early-fusion mixers.

Port of ``omr_a2s_multimodal_transformer_tpu/models/multimodal.py`` (the
reference's ``MultimodalTransformer``, its model.py:358-726): two
independent conv-stem encoders with their own 2D PEs, one shared decoder,
and a modality mixer chosen at construction:

- ``concat``     sequence concat + concatenated validity mask
- ``attn_img``   audio queries attend to image keys/values (output len = La)
- ``attn_audio`` image queries attend to audio keys/values (output len = Li)
- ``attn_both``  both directions then concat. It keeps the reference's
  dataflow (model.py:713-726): the image-query pass attends to the
  *already attended* audio, not the raw audio; both passes share one
  CrossAttention module.

The mixer's cross-attention masks only the (pad query x pad key) corner,
the reference's ``create_attention_mask`` (model.py:343-351). It is a plain
attention (``ops/attention.py`` ``attend``), as in the JAX package, where
it is XLA and not a Pallas kernel. With ``mixer_residual`` an attention
mixer emits ``query + tanh(g) * CrossAttn(query, kv)`` with a zero-init
gate ``mix_gate``, one entry per attention pass: (2,) for ``attn_both``,
(1,) for the single-direction mixers.

Parameter names follow the reference state_dict: ``image_encoder.*``,
``audio_encoder.*``, ``decoder.*``, ``cross_attn.attention.{in_proj_weight,
in_proj_bias, out_proj.*}``, and ``mix_gate``. Training-time modality
dropout is a host-side draw (``training/corruption.py`` ``draw_modality``);
the forward takes the chosen ``modality`` and runs only the encoders it
needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import KernDecoder, MultiheadProj
from omr_a2s_multimodal_transformer_tpu_torch.models.encoder import ConvStemEncoder
from omr_a2s_multimodal_transformer_tpu_torch.models.transformer import encode_memory, gather_memory
from omr_a2s_multimodal_transformer_tpu_torch.ops import masks as M

MIXER_TYPES = ("concat", "attn_img", "attn_audio", "attn_both")


class CrossAttention(nn.Module):
    """4-head attention with the reference's corner pad mask and dropout on
    the attention weights (its model.py:268-355)."""

    def __init__(self, d_model: int = 256, n_heads: int = 4, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attention = MultiheadProj(d_model, n_heads)

    def forward(self, query: torch.Tensor, key_value: torch.Tensor, q_valid: Optional[torch.Tensor] = None,
                k_valid: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """query [B, Lq, D], key_value [B, Lk, D], validity [B, Lq] / [B, Lk]
        bool; generator=None is deterministic."""
        mask = None
        if q_valid is not None and k_valid is not None:
            mask = M.corner_attn_mask(q_valid, k_valid)
        rate = self.dropout if generator is not None else 0.0
        return self.attention(query, key_value, mask, rate, generator)


def _cat_valid(vi: Optional[torch.Tensor], va: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return torch.cat([vi, va], dim=1) if (vi is not None and va is not None) else None


class MultimodalTransformer(nn.Module):
    """Image and audio encoders + mixer + decoder."""

    def __init__(self, vocab_size: int, max_seq_len: int, mixer_type: str = "concat",
                 mixer_residual: bool = False, attn_window: int = -1, encoder_dropout: float = 0.5,
                 decoder_dropout: float = 0.1, pos_dropout: float = 0.1, masked_norm: bool = False,
                 prefix_memory_mask: bool = False, torch_float_parity: bool = False,
                 cache_dtype: str = "float32", use_flash_cross: bool = False, packed_stem: bool = False,
                 remat: bool = False, memory_partition=None):
        super().__init__()
        if mixer_type not in MIXER_TYPES:
            raise ValueError(f"Invalid mixer type: {mixer_type}")
        self.vocab_size, self.max_seq_len = vocab_size, max_seq_len
        self.mixer_type, self.mixer_residual = mixer_type, mixer_residual
        self.pos_dropout, self.masked_norm = pos_dropout, masked_norm
        self.prefix_memory_mask, self.torch_float_parity = prefix_memory_mask, torch_float_parity
        self.memory_partition = None if memory_partition is None else tuple(memory_partition)
        self.mesh = None  # parallel.tp.shard_model sets it
        enc = dict(dropout=encoder_dropout, masked_norm=masked_norm, packed_stem=packed_stem, remat=remat)
        self.image_encoder = ConvStemEncoder(**enc)
        self.audio_encoder = ConvStemEncoder(**enc)
        self.decoder = KernDecoder(vocab_size=vocab_size, max_seq_len=max_seq_len, dropout=decoder_dropout,
                                   attn_window=attn_window, cache_dtype=cache_dtype,
                                   use_flash_cross=use_flash_cross, remat=remat and not use_flash_cross)
        if mixer_type != "concat":
            self.cross_attn = CrossAttention()
            if mixer_residual:
                # one zero-init gate per attention pass; tanh(0) = 0 => exact query passthrough at init
                self.mix_gate = nn.Parameter(torch.zeros(mix_gate_shape(mixer_type)))

    def mix(self, xi: torch.Tensor, xa: torch.Tensor, vi: Optional[torch.Tensor], va: Optional[torch.Tensor],
            generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Fuse encoded modalities -> (memory, memory_valid)."""
        if self.mixer_type == "concat":
            return torch.cat([xi, xa], dim=1), _cat_valid(vi, va)
        res = self.mixer_residual  # memory = query + tanh(gate) * attended
        g = torch.tanh(self.mix_gate) if res else None
        if self.mixer_type == "attn_img":
            out = self.cross_attn(xa, xi, va, vi, generator)
            return (xa + g[0] * out if res else out), va
        if self.mixer_type == "attn_audio":
            out = self.cross_attn(xi, xa, vi, va, generator)
            return (xi + g[0] * out if res else out), vi
        # attn_both, the reference's dataflow (model.py:723-725): the second pass attends to the attended audio
        xa2 = self.cross_attn(xa, xi, va, vi, generator)
        if res:
            xa2 = xa + g[0] * xa2
        xi2 = self.cross_attn(xi, xa2, vi, va, generator)
        if res:
            xi2 = xi + g[1] * xi2
        return torch.cat([xi2, xa2], dim=1), _cat_valid(vi, va)

    def encoder_forward(self, xi: Optional[torch.Tensor], xa: Optional[torch.Tensor],
                        xi_hw: Optional[torch.Tensor] = None, xa_hw: Optional[torch.Tensor] = None,
                        modality: str = "both", generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Encode + fuse. ``modality`` ("image", "audio", "both") is drawn on
        the host during training (modality dropout, reference
        model.py:561-575); only the needed encoders run. Under
        ``memory_partition`` each encoder's memory is held split and
        gathered for the mixer and the decoder."""
        if modality in ("image", "audio"):
            enc, x, hw = (self.image_encoder, xi, xi_hw) if modality == "image" else (self.audio_encoder, xa, xa_hw)
            mem, valid = encode_memory(self, enc, x, hw, generator)
            return gather_memory(self, mem), valid
        mi, vi = encode_memory(self, self.image_encoder, xi, xi_hw, generator)
        ma, va = encode_memory(self, self.audio_encoder, xa, xa_hw, generator)
        return self.mix(gather_memory(self, mi), gather_memory(self, ma), vi, va, generator)

    def forward(self, xi: Optional[torch.Tensor], xi_hw: Optional[torch.Tensor], xa: Optional[torch.Tensor],
                xa_hw: Optional[torch.Tensor], y_in: torch.Tensor, modality: str = "both",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced forward; generator=None is deterministic. Returns logits [B, L, V]."""
        memory, mem_valid = self.encoder_forward(xi, xa, xi_hw, xa_hw, modality, generator)
        return self.decoder(y_in, memory, mem_valid, generator=generator,
                            torch_float_parity=self.torch_float_parity)

    # Decode-path helpers
    def decode_prefill(self, xi, xa, xi_hw=None, xa_hw=None, modality: str = "both"):
        memory, mem_valid = self.encoder_forward(xi, xa, xi_hw, xa_hw, modality)
        return self.decoder.prefill(memory), mem_valid

    def decode_step(self, token_ids, pos: int, cache, cross, memory_valid=None):
        return self.decoder.step(token_ids, pos, cache, cross, memory_valid)

    def decode_init_cache(self, batch: int):
        return self.decoder.init_cache(batch)


def mix_gate_shape(mixer_type: str) -> Tuple[int]:
    """The gate of a residual attention mixer: one entry per attention pass."""
    return (2,) if mixer_type == "attn_both" else (1,)
