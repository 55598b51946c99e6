"""Unimodal image -> kern transformer.

Port of ``omr_a2s_multimodal_transformer_tpu/models/transformer.py``:
conv-stem encoder, fixed 2D positional encoding + dropout, flatten to a
[B, S, 256] memory, autoregressive decoder. Parameter paths follow the
reference PyTorch state_dict (``encoder.*``, ``decoder.*``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import KernDecoder, dropout
from omr_a2s_multimodal_transformer_tpu_torch.models.encoder import (
    HEIGHT_REDUCTION,
    WIDTH_REDUCTION,
    ConvStemEncoder,
)
from omr_a2s_multimodal_transformer_tpu_torch.models.positional import positional_encoding_2d
from omr_a2s_multimodal_transformer_tpu_torch.ops import masks as M


def ceil_div(a, b: int):
    return -(-a // b)


def add_pos2d_and_flatten(feats: torch.Tensor) -> torch.Tensor:
    """[B, H', W', C] + PE2D -> [B, H'*W', C] (row-major flatten)."""
    b, h, w, c = feats.shape
    pe = torch.from_numpy(positional_encoding_2d(c, h, w)).to(feats.device)
    return (feats + pe[None]).reshape(b, h * w, c)


def memory_valid_from_hw(hw: torch.Tensor, grid_h: int, grid_w: int, prefix_semantics: bool = False) -> torch.Tensor:
    """[B, S] validity of the flattened memory from the original [B, 2]
    input sizes: the rectangle of ceil(h/16) x ceil(w/8) cells, or with
    prefix_semantics the reference's prefix of that many positions."""
    rh = ceil_div(hw[:, 0], HEIGHT_REDUCTION)
    rw = ceil_div(hw[:, 1], WIDTH_REDUCTION)
    if prefix_semantics:
        return M.length_valid_mask(rh * rw, grid_h * grid_w)
    return M.rect_valid_mask(torch.stack([rh, rw], dim=1), grid_h, grid_w)


class UnimodalTransformer(nn.Module):
    """Encoder + PE2D + decoder."""

    def __init__(self, vocab_size: int, max_seq_len: int, attn_window: int = -1,
                 encoder_dropout: float = 0.5, decoder_dropout: float = 0.1, pos_dropout: float = 0.1,
                 masked_norm: bool = False, prefix_memory_mask: bool = False,
                 torch_float_parity: bool = False, cache_dtype: str = "float32",
                 use_flash_cross: bool = False, packed_stem: bool = False):
        super().__init__()
        self.vocab_size, self.max_seq_len = vocab_size, max_seq_len
        self.pos_dropout, self.masked_norm = pos_dropout, masked_norm
        self.prefix_memory_mask, self.torch_float_parity = prefix_memory_mask, torch_float_parity
        self.encoder = ConvStemEncoder(dropout=encoder_dropout, masked_norm=masked_norm, packed_stem=packed_stem)
        self.decoder = KernDecoder(vocab_size=vocab_size, max_seq_len=max_seq_len, dropout=decoder_dropout,
                                   attn_window=attn_window, cache_dtype=cache_dtype,
                                   use_flash_cross=use_flash_cross)

    def encode(self, x: torch.Tensor, hw: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [B, H, W, 1], hw [B, 2] original dims. Returns (memory [B, S, C], memory_valid [B, S] or None)."""
        valid = None
        if hw is not None and self.masked_norm:
            hh = torch.arange(x.shape[1], device=x.device)[None, :, None] < hw[:, 0][:, None, None]
            ww = torch.arange(x.shape[2], device=x.device)[None, None, :] < hw[:, 1][:, None, None]
            valid = hh & ww
        feats = self.encoder(x, generator=generator, valid=valid)
        mem = dropout(add_pos2d_and_flatten(feats), self.pos_dropout, generator)
        mem_valid = None
        if hw is not None:
            mem_valid = memory_valid_from_hw(hw, feats.shape[1], feats.shape[2], self.prefix_memory_mask)
        return mem, mem_valid

    def forward(self, x: torch.Tensor, hw: Optional[torch.Tensor], y_in: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced forward; generator=None is deterministic. Returns logits [B, L, V]."""
        memory, mem_valid = self.encode(x, hw, generator)
        return self.decoder(y_in, memory, mem_valid, generator=generator,
                            torch_float_parity=self.torch_float_parity)

    def decode_prefill(self, x, hw=None):
        memory, mem_valid = self.encode(x, hw)
        return self.decoder.prefill(memory), mem_valid

    def decode_step(self, token_ids, pos: int, cache, cross, memory_valid=None):
        return self.decoder.step(token_ids, pos, cache, cross, memory_valid)

    def decode_init_cache(self, batch: int):
        return self.decoder.init_cache(batch)
