"""Unimodal image -> kern transformer.

Port of ``omr_a2s_multimodal_transformer_tpu/models/transformer.py``:
conv-stem encoder, fixed 2D positional encoding + dropout, flatten to a
[B, S, 256] memory, autoregressive decoder. Parameter paths follow the
reference PyTorch state_dict (``encoder.*``, ``decoder.*``).

``remat`` recomputes the encoder's blocks in the backward, and the
decoder's layers off the flash path (JAX's ``transformer.py:101``: flash
never holds a score tensor). ``memory_partition`` (JAX's sharding
constraint on the [B, S, C] memory, e.g. ('data', 'model', None)) holds
the memory split over its 'model' dimension across the 'model' ranks
after the positional dropout, and gathers it where cross-attention needs
all of it; it changes no value and needs a mesh, as JAX's constraint
needs a mesh context.
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
from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_reduce, gather_from, scatter_to


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


def check_memory_partition(spec, mesh) -> None:
    """A ``memory_partition`` is a [batch, seq, feature] spec of None,
    'data' (the batch, dim 0 only) and at most one 'model'; it needs a
    mesh (ValueError, as JAX raises outside a mesh context)."""
    if spec is None:
        return
    spec = tuple(spec)
    if len(spec) > 3 or any(a not in (None, "data", "model") for a in spec) or spec.count("model") > 1 \
            or "data" in spec[1:]:
        raise ValueError(f"memory_partition {spec} is not a [batch, seq, feature] spec of None, 'data' (dim 0) "
                         "and one 'model'")
    if mesh is None:
        raise ValueError("memory_partition needs a mesh (build_model(..., mesh=make_mesh(...)))")


def partition_dim(spec):
    """The memory dimension a ``memory_partition`` splits over 'model', or None."""
    return None if spec is None or "model" not in tuple(spec) else tuple(spec).index("model")


def gather_memory(model: nn.Module, mem: torch.Tensor) -> torch.Tensor:
    """The whole memory from its ``memory_partition`` parts (the lengths
    of the parts are summed over 'model' first: they may differ by one)."""
    dim = partition_dim(model.memory_partition)
    if dim is None:
        return mem
    axis = model.mesh.model_axis
    full = all_reduce(torch.tensor([mem.shape[dim]], device=mem.device), axis)
    return gather_from(mem, axis, dim, int(full))


def encode_memory(model: nn.Module, encoder: ConvStemEncoder, x: torch.Tensor, hw: Optional[torch.Tensor],
                  generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One conv stem + PE2D + positional dropout -> (memory [B, S, C],
    memory_valid [B, S] or None), with ``model``'s masked_norm,
    pos_dropout and prefix_memory_mask; generator=None is deterministic."""
    valid = None
    if hw is not None and model.masked_norm:
        hh = torch.arange(x.shape[1], device=x.device)[None, :, None] < hw[:, 0][:, None, None]
        ww = torch.arange(x.shape[2], device=x.device)[None, None, :] < hw[:, 1][:, None, None]
        valid = hh & ww
    feats = encoder(x, generator=generator, valid=valid)
    mem = dropout(add_pos2d_and_flatten(feats), model.pos_dropout, generator)
    dim = partition_dim(model.memory_partition)
    if dim is not None:
        mem = scatter_to(mem, model.mesh.model_axis, dim)
    mem_valid = None
    if hw is not None:
        mem_valid = memory_valid_from_hw(hw, feats.shape[1], feats.shape[2], model.prefix_memory_mask)
    return mem, mem_valid


class UnimodalTransformer(nn.Module):
    """Encoder + PE2D + decoder."""

    def __init__(self, vocab_size: int, max_seq_len: int, attn_window: int = -1,
                 encoder_dropout: float = 0.5, decoder_dropout: float = 0.1, pos_dropout: float = 0.1,
                 masked_norm: bool = False, prefix_memory_mask: bool = False,
                 torch_float_parity: bool = False, cache_dtype: str = "float32",
                 use_flash_cross: bool = False, packed_stem: bool = False, remat: bool = False,
                 memory_partition=None):
        super().__init__()
        self.vocab_size, self.max_seq_len = vocab_size, max_seq_len
        self.pos_dropout, self.masked_norm = pos_dropout, masked_norm
        self.prefix_memory_mask, self.torch_float_parity = prefix_memory_mask, torch_float_parity
        self.memory_partition = None if memory_partition is None else tuple(memory_partition)
        self.mesh = None  # parallel.tp.shard_model sets it
        self.encoder = ConvStemEncoder(dropout=encoder_dropout, masked_norm=masked_norm, packed_stem=packed_stem,
                                       remat=remat)
        self.decoder = KernDecoder(vocab_size=vocab_size, max_seq_len=max_seq_len, dropout=decoder_dropout,
                                   attn_window=attn_window, cache_dtype=cache_dtype,
                                   use_flash_cross=use_flash_cross, remat=remat and not use_flash_cross)

    def encode(self, x: torch.Tensor, hw: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [B, H, W, 1], hw [B, 2] original dims. Returns (memory [B, S, C], memory_valid [B, S] or None);
        under ``memory_partition`` the memory is this rank's part (``gather_memory``)."""
        return encode_memory(self, self.encoder, x, hw, generator)

    def forward(self, x: torch.Tensor, hw: Optional[torch.Tensor], y_in: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced forward; generator=None is deterministic. Returns logits [B, L, V]."""
        memory, mem_valid = self.encode(x, hw, generator)
        return self.decoder(y_in, gather_memory(self, memory), mem_valid, generator=generator,
                            torch_float_parity=self.torch_float_parity)

    def decode_prefill(self, x, hw=None):
        memory, mem_valid = self.encode(x, hw)
        return self.decoder.prefill(gather_memory(self, memory)), mem_valid

    def decode_step(self, token_ids, pos: int, cache, cross, memory_valid=None):
        return self.decoder.step(token_ids, pos, cache, cross, memory_valid)

    def decode_init_cache(self, batch: int):
        return self.decoder.init_cache(batch)
