"""Checkpointing: torch save/restore with the JAX package's hparams sidecar.

Port of ``omr_a2s_multimodal_transformer_tpu/training/checkpoint.py``. A
checkpoint is a directory per tag holding ``state.pt`` (a dict: the
model's ``state_dict`` under "params", the optimizer's under "opt_state",
and "step") and the ``hparams.json`` sidecar that rebuilds the model
without the original CLI flags. Both files are written to a temporary name
and moved into place with ``os.replace``, so a reader never sees half a
file.

``split_multimodal_params``/``stitch_multimodal_params`` and
``save_split_checkpoints`` are the reference's checkpoint surgery
(split_multimodal_ckpt.py:8-110) on the port's flat state_dicts: a group
is the set of names under one top-level prefix. ``load_params`` checks a
state_dict against a model leaf by leaf before loading it, so a
``mix_gate`` of the wrong shape (the old fixed (2,) of a single-direction
mixer) is rejected on restore with an error that names it; the reference
fails only when the model is applied (its models/multimodal.py:137).

A model sharded on a mesh (``parallel/tp.py``) saves and loads full
tensors: its Trainer gathers them and rank 0 writes the same files as a
single-process run; ``load_params`` with the mesh slices a full
state_dict to the rank's shards, so a checkpoint restores onto any mesh.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]

HPARAMS_FILE = "hparams.json"
STATE_FILE = "state.pt"


def _replace_into(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: Dict[str, Any], hparams: Optional[Dict] = None) -> None:
    """Atomic save of ``state`` (tensors and plain values) + JSON hparams sidecar."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _replace_into(os.path.join(path, STATE_FILE), lambda tmp: torch.save(state, tmp))
    if hparams is not None:
        def write_hparams(tmp):
            with open(tmp, "w") as f:
                json.dump(hparams, f, indent=1, default=str)

        _replace_into(os.path.join(path, HPARAMS_FILE), write_hparams)


def load_hparams(path: str) -> Dict:
    with open(os.path.join(os.path.abspath(path), HPARAMS_FILE)) as f:
        return json.load(f)


def restore_checkpoint(path: str, map_location: Any = "cpu") -> Dict[str, Any]:
    """The saved state dict, its tensors on ``map_location``."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=map_location,
                      weights_only=True)


def params_of(state: Dict[str, Any]) -> Params:
    """The model state_dict of a restored checkpoint (a params-only one included)."""
    return state["params"] if "params" in state else state


def _gate_hint(name: str) -> str:
    return (" (mix_gate has one entry per attention pass of the mixer: (2,) for attn_both, (1,) for "
            "attn_img and attn_audio)") if name == "mix_gate" else ""


def load_params(model: torch.nn.Module, params: Mapping[str, torch.Tensor], mesh=None) -> None:
    """Load a state_dict into ``model`` after checking it leaf by leaf: the
    same names, and each the model's shape (ValueError naming the leaf).
    With the ``mesh`` the model is sharded on, ``params`` are full tensors
    and each rank loads its slice of them."""
    own = model.state_dict()
    missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
    if missing or extra:
        hint = "".join(_gate_hint(n) for n in ("mix_gate",) if n in missing + extra)
        raise ValueError(f"checkpoint params do not fit the model: missing {missing}, unexpected {extra}{hint}")
    if mesh is not None:
        from omr_a2s_multimodal_transformer_tpu_torch.parallel.tp import load_full_state_dict

        params = load_full_state_dict(model, params, mesh)
    for name, ref in own.items():
        if tuple(params[name].shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint {name} has shape {tuple(params[name].shape)}, the model's is "
                             f"{tuple(ref.shape)}{_gate_hint(name)}")
    model.load_state_dict(params)


def _group(params: Mapping[str, torch.Tensor], prefix: str) -> Params:
    """The leaves under ``prefix.``, named without it."""
    head = prefix + "."
    return {k[len(head):]: v for k, v in params.items() if k.startswith(head)}


def _prefixed(group: Mapping[str, torch.Tensor], prefix: str) -> Params:
    return {f"{prefix}.{k}": v.clone() for k, v in group.items()}


def split_multimodal_params(params: Mapping[str, torch.Tensor]) -> Tuple[Params, Params]:
    """Multimodal state_dict -> (image_model_params, audio_model_params).

    Each output is a valid UnimodalTransformer state_dict: the modality
    encoder is renamed to 'encoder', the shared decoder is copied, and the
    mixer (cross_attn, mix_gate) is dropped — semantics of the reference's
    split_multimodal_ckpt.py:43-70.
    """
    dec = _prefixed(_group(params, "decoder"), "decoder")
    img = {**_prefixed(_group(params, "image_encoder"), "encoder"), **dec}
    audio = {**_prefixed(_group(params, "audio_encoder"), "encoder"), **{k: v.clone() for k, v in dec.items()}}
    return img, audio


def stitch_multimodal_params(
    mm_params: Mapping[str, torch.Tensor],
    img_params: Optional[Mapping[str, torch.Tensor]] = None,
    audio_params: Optional[Mapping[str, torch.Tensor]] = None,
    decoder_from: str = "image",
    mixer_type: Optional[str] = None,
) -> Params:
    """Inverse of ``split_multimodal_params``: warm-start a multimodal
    state_dict from trained unimodal ones.

    ``image_encoder``/``audio_encoder`` are overwritten from the respective
    unimodal state_dicts' ``encoder``; the shared ``decoder`` comes from the
    leg named by ``decoder_from``. Mixer-only params (``cross_attn``,
    ``mix_gate``) keep their values in ``mm_params`` (a fresh init).

    Names and shapes are validated leaf by leaf; a unimodal checkpoint with
    a different geometry fails loudly instead of training from a silently
    mis-stitched tree. With ``mixer_type`` given, a ``mix_gate`` in
    ``mm_params`` of another shape than that mixer's is rejected too.
    """
    from omr_a2s_multimodal_transformer_tpu_torch.models.multimodal import mix_gate_shape

    if decoder_from not in ("image", "audio"):
        raise ValueError(f"decoder_from must be 'image' or 'audio', got {decoder_from!r}")
    if mixer_type is not None and "mix_gate" in mm_params:
        want = mix_gate_shape(mixer_type)
        if tuple(mm_params["mix_gate"].shape) != want:
            raise ValueError(f"stitch: mix_gate has shape {tuple(mm_params['mix_gate'].shape)}, a residual "
                             f"{mixer_type} mixer takes {want}{_gate_hint('mix_gate')}")
    out = dict(mm_params)

    def _take(dst_key: str, src_tree: Mapping[str, torch.Tensor], src_key: str, src_name: str) -> None:
        ref, new = _group(mm_params, dst_key), _group(src_tree, src_key)
        if sorted(ref) != sorted(new):
            raise ValueError(
                f"stitch: {src_name}[{src_key!r}] tree structure does not match multimodal[{dst_key!r}]")
        for name, p_ref in ref.items():
            if tuple(p_ref.shape) != tuple(new[name].shape):
                raise ValueError(
                    f"stitch: shape mismatch in {dst_key}.{name}: {tuple(p_ref.shape)} vs {tuple(new[name].shape)}")
        out.update(_prefixed(new, dst_key))

    if img_params is not None:
        _take("image_encoder", img_params, "encoder", "image ckpt")
    if audio_params is not None:
        _take("audio_encoder", audio_params, "encoder", "audio ckpt")
    dec_src = img_params if decoder_from == "image" else audio_params
    if dec_src is not None:
        _take("decoder", dec_src, "decoder", f"{decoder_from} ckpt")
    return out


def save_split_checkpoints(ckpt_path: str, out_prefix: Optional[str] = None) -> Tuple[str, str]:
    """Load a multimodal checkpoint and write two unimodal ones
    ('<ckpt>_only_image_distorted', '<ckpt>_only_audio' — reference naming),
    each with its params only and hparams of its modality."""
    ckpt_path = os.path.abspath(ckpt_path.rstrip("/"))
    hp = load_hparams(ckpt_path)
    img_params, audio_params = split_multimodal_params(params_of(restore_checkpoint(ckpt_path)))

    def sub_hparams(modality: str) -> Dict:
        out = dict(hp)
        out.pop("mixer_type", None)
        out.pop("teacher_forcing_modality_prob", None)
        out["input_modality"] = modality
        return out

    prefix = out_prefix or ckpt_path
    img_path = prefix + "_only_image_distorted"
    audio_path = prefix + "_only_audio"
    save_checkpoint(img_path, {"params": img_params}, sub_hparams("image"))
    save_checkpoint(audio_path, {"params": audio_params}, sub_hparams("audio"))
    return img_path, audio_path
