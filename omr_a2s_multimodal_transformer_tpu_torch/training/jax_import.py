"""Load a JAX ``UnimodalTransformer`` or ``MultimodalTransformer`` param
tree into the port model.

Input: ``variables["params"]`` of the JAX model as nested dicts of numpy
arrays (``jax.device_get``). A multimodal tree (top-level
``image_encoder``) maps ``image_encoder``/``audio_encoder`` as the
unimodal ``encoder``, ``cross_attn/mha`` to ``cross_attn.attention`` and
``mix_gate`` to ``mix_gate`` (the one leaf the JAX package's
``torch_import.convert_multimodal_state_dict`` does not map back). Dense kernels [in, out] become Linear weights
[out, in]; conv kernels HWIO become OIHW; LayerNorm ``scale`` becomes
``weight``; the q/k/v projections of each attention become the packed
``in_proj_weight``/``in_proj_bias``; the classifier Dense [D, V] becomes
the Conv1d weight [V, D, 1]. Every leaf of the tree must be consumed and
every port parameter filled: a missing or extra leaf raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _conv(leaves, path):
    return {"weight": leaves.pop(f"{path}/kernel").transpose(3, 2, 0, 1), "bias": leaves.pop(f"{path}/bias")}


def _dense(leaves, path):
    return {"weight": leaves.pop(f"{path}/kernel").T, "bias": leaves.pop(f"{path}/bias")}


def _norm(leaves, path):
    return {"weight": leaves.pop(f"{path}/scale"), "bias": leaves.pop(f"{path}/bias")}


def _mha(leaves, path):
    q, k, v = (_dense(leaves, f"{path}/{n}_proj") for n in ("q", "k", "v"))
    out = _dense(leaves, f"{path}/out_proj")
    return {
        "in_proj_weight": np.concatenate([q["weight"], k["weight"], v["weight"]], axis=0),
        "in_proj_bias": np.concatenate([q["bias"], k["bias"], v["bias"]], axis=0),
        "out_proj.weight": out["weight"],
        "out_proj.bias": out["bias"],
    }


def _put(sd, prefix, entries):
    for name, arr in entries.items():
        sd[f"{prefix}.{name}"] = arr


def _encoder(sd, leaves, port, jax_prefix):
    for i in range(5):  # the conv stem's 5 ConvBlocks and 4 DSCBlocks
        for j in (1, 2, 3):
            _put(sd, f"{port}.conv_blocks.{i}.conv{j}", _conv(leaves, f"{jax_prefix}/block{i}/conv{j}"))
    for i in range(4):
        for j in (1, 2, 3):
            for part in ("depth_conv", "point_conv"):
                _put(sd, f"{port}.dscblocks.{i}.conv{j}.{part}",
                     _conv(leaves, f"{jax_prefix}/dsc{i}/conv{j}/{part}"))


def _decoder(sd, leaves):
    sd["decoder.embedding.weight"] = leaves.pop("decoder/embedding")
    i = 0
    while f"decoder/layer{i}/norm1/scale" in leaves:
        lp, jp = f"decoder.transformer_decoder.layers.{i}", f"decoder/layer{i}"
        _put(sd, f"{lp}.self_attn", _mha(leaves, f"{jp}/self_attn"))
        _put(sd, f"{lp}.multihead_attn", _mha(leaves, f"{jp}/cross_attn"))
        for n in ("linear1", "linear2"):
            _put(sd, f"{lp}.{n}", _dense(leaves, f"{jp}/{n}"))
        for n in ("norm1", "norm2", "norm3"):
            _put(sd, f"{lp}.{n}", _norm(leaves, f"{jp}/{n}"))
        i += 1
    out = _dense(leaves, "decoder/out_layer")
    sd["decoder.out_layer.weight"] = out["weight"][:, :, None]
    sd["decoder.out_layer.bias"] = out["bias"]


def jax_params_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX UnimodalTransformer or MultimodalTransformer params -> port
    state_dict (numpy arrays)."""
    leaves = _flatten(params)
    sd: Dict[str, np.ndarray] = {}
    try:
        if "image_encoder" in params:
            _encoder(sd, leaves, "image_encoder", "image_encoder")
            _encoder(sd, leaves, "audio_encoder", "audio_encoder")
            if "cross_attn" in params:
                _put(sd, "cross_attn.attention", _mha(leaves, "cross_attn/mha"))
            if "mix_gate" in params:
                sd["mix_gate"] = leaves.pop("mix_gate")
        else:
            _encoder(sd, leaves, "encoder", "encoder")
        _decoder(sd, leaves)
    except KeyError as e:
        raise KeyError(f"JAX param tree lacks leaf {e.args[0]}") from None
    if leaves:
        raise KeyError(f"JAX param tree has leaves the port does not take: {sorted(leaves)}")
    return sd


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Fill ``model`` (a port UnimodalTransformer or MultimodalTransformer)
    from a JAX param tree of the same architecture."""
    sd = jax_params_to_state_dict(params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"param mismatch: port parameters not in the tree {missing}, tree leaves not in the port {extra}")
    for name, p in own.items():
        arr = sd[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {arr.shape} != port shape {tuple(p.shape)}")
        p.copy_(torch.tensor(arr, dtype=p.dtype))
    return model
