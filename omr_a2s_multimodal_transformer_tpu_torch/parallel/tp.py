"""A model on a mesh: its parameters sharded by ``TP_RULES``, and back.

``shard_model`` keeps this rank's slice of every parameter the rules shard
over 'model' (``parallel/mesh.py`` ``placement``: replicated where the axis
does not divide) and hands the mesh to the modules, which see from their
parameters' shapes which of them are sharded. ``full_state_dict`` and
``full_optimizer_state`` gather the full tensors, so that rank 0 writes the
checkpoint of a single-process run; ``load_full_state_dict`` and
``local_optimizer_state`` slice a full checkpoint back onto the rank, as
JAX's ``_reshard`` puts a restored tree on its mesh (``loop.py:136-150``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_gather
from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import (
    Mesh,
    Placement,
    local_shard,
    placement,
)


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Shard ``model`` (built with its full weights on every rank) in place
    for this rank of ``mesh``; returns it. The heads and FF columns must
    split evenly over 'model'."""
    specs: Dict[str, Optional[Placement]] = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = placement(name, tuple(p.shape), mesh.model)
            specs[name] = spec
            if spec is not None:
                p.data = local_shard(p.data, spec, mesh.model, mesh.model_index).clone()
    for name, module in model.named_modules():
        heads = getattr(module, "n_heads", None)
        if heads is not None and heads % mesh.model:
            raise ValueError(f"{name or 'model'}: {heads} heads do not split over {mesh.model} model ranks")
        if hasattr(module, "mesh"):
            module.mesh = mesh
    model.tp_specs = specs
    return model


def _spec(model, name: str) -> Optional[Placement]:
    return getattr(model, "tp_specs", {}).get(name)


def gather_full(t: torch.Tensor, spec: Optional[Placement], mesh: Mesh) -> torch.Tensor:
    """The full tensor from this rank's shard (a collective over 'model')."""
    if spec is None or mesh.model == 1:
        return t
    shape = list(t.shape)
    per = shape[spec.dim] // spec.blocks
    view = t.reshape(shape[:spec.dim] + [spec.blocks, per] + shape[spec.dim + 1:])
    full = all_gather(view.contiguous(), mesh.model_axis, spec.dim + 1)
    return full.reshape(shape[:spec.dim] + [spec.blocks * per * mesh.model] + shape[spec.dim + 1:])


def full_state_dict(model: torch.nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The model's state_dict with every sharded parameter gathered (every
    rank of the model group must call it)."""
    sd = model.state_dict()
    if mesh is None:
        return sd
    return {k: gather_full(v, _spec(model, k), mesh) for k, v in sd.items()}


def load_full_state_dict(model: torch.nn.Module, full: Mapping[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict:
    """``full`` sliced to this rank's shards (what ``load_state_dict`` takes)."""
    if mesh is None:
        return dict(full)
    return {k: local_shard(v, _spec(model, k), mesh.model, mesh.model_index).clone() for k, v in full.items()}


def _param_names(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> Dict[int, str]:
    """Optimizer state index -> parameter name (state_dict numbers the
    parameters of its groups in order)."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    order = [by_id[id(p)] for g in optimizer.param_groups for p in g["params"]]
    return dict(enumerate(order))


def _map_state(model, optimizer, state: Dict, fn) -> Dict:
    names = _param_names(model, optimizer)
    out = {"param_groups": state["param_groups"], "state": {}}
    for idx, entry in state["state"].items():
        spec = _spec(model, names[int(idx)])
        out["state"][idx] = {k: fn(v, spec) if isinstance(v, torch.Tensor) and v.dim() > 0 else v
                             for k, v in entry.items()}
    return out


def full_optimizer_state(model, optimizer, mesh: Optional[Mesh]) -> Dict:
    """The optimizer's state_dict with its moments gathered like their parameters."""
    state = optimizer.state_dict()
    if mesh is None:
        return state
    return _map_state(model, optimizer, state, lambda v, spec: gather_full(v, spec, mesh))


def local_optimizer_state(model, optimizer, full: Dict, mesh: Optional[Mesh]) -> Dict:
    """A full optimizer state_dict sliced to this rank's shards."""
    if mesh is None:
        return full
    return _map_state(model, optimizer, full,
                      lambda v, spec: local_shard(v, spec, mesh.model, mesh.model_index).clone())

