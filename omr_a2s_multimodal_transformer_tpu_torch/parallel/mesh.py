"""The process mesh and its sharding rules (dp + tp).

Port of ``omr_a2s_multimodal_transformer_tpu/parallel/mesh.py``. JAX lays
its devices out as a ``('data', 'model')`` mesh and lets GSPMD insert the
collectives; here each process is one cell of that grid (rank = data_index
* model + model_index, JAX's ``reshape(data, model)``), with a process
group per row and per column, and the sharded model calls its collectives
itself (``parallel/collectives.py``):

- 'data': each data rank takes its rows of the global batch
  (``shard_batch``); gradients are summed over it.
- 'model': the decoder's q/k/v, ``linear1`` and (when the vocabulary
  divides) ``out_layer`` are column-parallel, ``out_proj`` and ``linear2``
  row-parallel (``TP_RULES``, first match wins, anything unmatched is
  replicated; a dimension the axis does not divide is replicated, as in
  ``param_shardings``). The conv stems stay replicated.

Dropout bits across ranks: every random draw of the model goes through
``rand``/``randint`` with a ``ShardedGenerator``. A draw is made at the
GLOBAL shape (the batch rows of every data rank and, for a head- or
column-sharded tensor, every model rank's heads or columns) from the
generator, whose state is the same on every rank, and the rank keeps its
own slice. The generators stay in lockstep, data shards get different
masks, tensor-parallel replicas of a replicated activation get the same
ones, and a dp/tp run draws every generator bit the single-process run
draws. The cost is the world size times the random numbers of one rank.
The flash kernels' hash masks are not drawn: they follow JAX's per-shard
seed (``ops/flash_packed.py`` ``shard_seed``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its size, this rank's
    index along it, and the process group of the ranks along it (None when
    the axis has one rank)."""

    name: str
    size: int
    index: int
    group: Optional[object] = field(default=None, compare=False, repr=False)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a ('data', 'model') grid of processes."""

    data_axis: Axis
    model_axis: Axis
    rank: int = 0

    @property
    def data(self) -> int:
        return self.data_axis.size

    @property
    def model(self) -> int:
        return self.model_axis.size

    @property
    def data_index(self) -> int:
        return self.data_axis.index

    @property
    def model_index(self) -> int:
        return self.model_axis.index

    @property
    def size(self) -> int:
        return self.data * self.model

    def generator(self, device, seed: int) -> "ShardedGenerator":
        """The dropout generator of a step on this mesh (the same state on
        every rank), on ``device`` (``cuda`` without an index: the current
        card, the rank's own under a rank a card)."""
        g = ShardedGenerator(device=resolve_device(device))
        g.manual_seed(seed)
        g.mesh = self
        return g


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over the ``torch.distributed`` world
    (one process when no group is initialised): data = world // model by
    default. Every rank must call it, in the same order as any other
    group it makes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        if world % model:
            raise ValueError(f"{world} processes not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    grid = np.arange(world).reshape(data, model)
    d_idx, m_idx = divmod(rank, model)
    model_group = data_group = None
    if world > 1:
        for row in grid:  # the model groups: one per data index
            g = dist.new_group(row.tolist()) if model > 1 else None
            if row[0] == grid[d_idx, 0]:
                model_group = g
        for col in grid.T:  # the data groups: one per model index
            g = dist.new_group(col.tolist()) if data > 1 else None
            if col[0] == grid[0, m_idx]:
                data_group = g
    return Mesh(Axis("data", data, d_idx, data_group), Axis("model", model, m_idx, model_group), rank)


# ---------------------------------------------------------------- random draws


class ShardedGenerator(torch.Generator):
    """A ``torch.Generator`` that knows the mesh: ``rand``/``randint``
    draw at the global shape from it and keep this rank's slice."""

    mesh: Mesh


def _global_draw(draw, shape, generator, model_dim: Optional[int]):
    mesh = getattr(generator, "mesh", None)
    if mesh is None or mesh.size == 1 or len(shape) == 0:
        return draw(tuple(shape))
    full, keep = list(shape), [slice(None)] * len(shape)
    full[0] *= mesh.data
    keep[0] = slice(mesh.data_index * shape[0], (mesh.data_index + 1) * shape[0])
    if model_dim is not None and mesh.model > 1:
        d = model_dim % len(shape)
        full[d] *= mesh.model
        keep[d] = slice(mesh.model_index * shape[d], (mesh.model_index + 1) * shape[d])
    return draw(tuple(full))[tuple(keep)]


def rand(shape, generator: Optional[torch.Generator], device, model_dim: Optional[int] = None) -> torch.Tensor:
    """``torch.rand(shape)``; with a ``ShardedGenerator`` this rank's slice
    of the global draw: dim 0 is the batch (data-sharded), ``model_dim``
    the dimension sharded over 'model' (heads or columns), if any."""
    return _global_draw(lambda s: torch.rand(s, generator=generator, device=device), shape, generator, model_dim)


def randint(low: int, high: int, shape, generator: Optional[torch.Generator], device, dtype=torch.int64,
            model_dim: Optional[int] = None) -> torch.Tensor:
    """``torch.randint`` by the rule of ``rand``."""
    return _global_draw(lambda s: torch.randint(low, high, s, generator=generator, device=device, dtype=dtype),
                        shape, generator, model_dim)


# ---------------------------------------------------------------- parameter rules


@dataclass(frozen=True)
class Placement:
    """A parameter sharded over 'model' along ``dim``; ``blocks`` > 1 cuts
    that dim into equal blocks first and shards each (the packed q/k/v
    ``in_proj`` [3D, D]: each D-row block by heads)."""

    dim: int
    blocks: int = 1


COLS, ROWS, QKV = Placement(0), Placement(1), Placement(0, 3)

# Port parameter name regex -> placement (torch [out, in] weights: JAX's
# P(None, 'model') on a flax [in, out] kernel is dim 0 here). First match
# wins; anything unmatched is replicated.
TP_RULES: Tuple[Tuple[str, Optional[Placement]], ...] = (
    (r"^decoder\..*\.(self_attn|multihead_attn)\.in_proj_(weight|bias)$", QKV),  # shard heads
    (r"^decoder\..*\.out_proj\.weight$", ROWS),
    (r"^decoder\..*\.linear1\.(weight|bias)$", COLS),
    (r"^decoder\..*\.linear2\.weight$", ROWS),
    (r"^decoder\.embedding\.weight$", None),  # small table row-gather; replicate
    (r"^decoder\.out_layer\.(weight|bias)$", COLS),  # vocab-sharded logits
    (r"^cross_attn\..*\.in_proj_(weight|bias)$", QKV),
    (r"^cross_attn\..*\.out_proj\.weight$", ROWS),
)


def spec_for_path(path: str) -> Optional[Placement]:
    """The rule's placement of a parameter name (None: replicated)."""
    for pattern, spec in TP_RULES:
        if re.search(pattern, path):
            return spec
    return None


def placement(name: str, shape: Sequence[int], model: int) -> Optional[Placement]:
    """The placement of a parameter of ``shape`` over a 'model' axis of
    ``model`` ranks: None when replicated, by the rules or because the axis
    does not divide the dimension (``param_shardings``' rule)."""
    spec = spec_for_path(name)
    if spec is None or model == 1 or spec.dim >= len(shape):
        return None
    if shape[spec.dim] % spec.blocks or (shape[spec.dim] // spec.blocks) % model:
        return None
    return spec


def local_shard(t: torch.Tensor, spec: Optional[Placement], model: int, index: int) -> torch.Tensor:
    """The slice of the full tensor ``t`` that model rank ``index`` holds."""
    if spec is None:
        return t
    shape = list(t.shape)
    n = shape[spec.dim] // spec.blocks
    per = n // model
    view = t.reshape(shape[:spec.dim] + [spec.blocks, n] + shape[spec.dim + 1:])
    part = view.narrow(spec.dim + 1, index * per, per)
    return part.reshape(shape[:spec.dim] + [spec.blocks * per] + shape[spec.dim + 1:])


# ---------------------------------------------------------------- batches


def pad_rows(x, n_pad: int, is_target: bool):
    """``x`` (numpy array or tensor) with ``n_pad`` rows appended: targets
    zeros, inputs the last row repeated."""
    if n_pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        filler = torch.zeros((n_pad,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device) if is_target \
            else x[-1:].expand((n_pad,) + tuple(x.shape[1:]))
        return torch.cat([x, filler], dim=0)
    x = np.asarray(x)
    filler = np.zeros((n_pad,) + x.shape[1:], x.dtype) if is_target else np.repeat(x[-1:], n_pad, axis=0)
    return np.concatenate([x, filler], axis=0)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This data rank's rows of a host batch dict (numpy arrays or
    tensors). A batch whose rows the data axis does not divide is padded
    first, as in JAX: inputs repeat the last row (an all-invalid memory
    mask would softmax over -inf), ``y*`` keys are padded with zeros (the
    pad-masked loss ignores them). Consumers drop the padded rows. A
    0-d value is kept as it is (replicated)."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) < 1:
            out[k] = v
            continue
        v = pad_rows(v, (-v.shape[0]) % mesh.data, str(k).startswith("y"))
        per = v.shape[0] // mesh.data
        out[k] = v[mesh.data_index * per:(mesh.data_index + 1) * per]
    return out

