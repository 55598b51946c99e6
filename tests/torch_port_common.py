"""Shared inputs for the port's parity tests (tests/test_torch_port_*.py).

A tiny unimodal image model: 32x64 images, vocab 31, max_seq_len 12, the
full decoder (8 layers, d_model 256). The port model is random-initialised
from a seed, and its state_dict goes through the JAX package's own
``training/torch_import.py`` converter to give the JAX params: that checks
the port's parameter names against the reference state_dict layout on the
way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu.models.transformer import UnimodalTransformer as JaxUnimodal
from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model

# The suite runs several pytest workers on one host: a few intra-op threads
# each keep them from oversubscribing its cores.
torch.set_num_threads(2)

V, MAXLEN, IMG_H, IMG_W = 31, 12, 32, 64
SOS, EOS = 1, V - 1


def hparams(**over):
    hp = dict(vocab_size=V, max_seq_len=MAXLEN, input_modality="image")
    hp.update(over)
    return hp


def jax_model(**over):
    hp = hparams(**over)
    hp.pop("input_modality")
    return JaxUnimodal(**hp)


def port_and_jax_params(seed=0, **over):
    """(port model on the CPU, JAX params {"params": tree}) with equal weights."""
    model, _ = build_model(hparams(**over), device="cpu", seed=seed)
    tree = convert_unimodal_state_dict({k: v.detach().clone() for k, v in model.state_dict().items()})  # no aliasing of the port weights
    return model, {"params": jax.tree.map(jnp.asarray, tree)}


def batch(seed=0, b=2, length=MAXLEN):
    """Images in [0, 1], ragged hw, token rows of ``length`` with pads (0) at
    the end of row 0 (its last quarter, at least 3)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(b, IMG_H, IMG_W, 1)).astype(np.float32)
    hw = np.array([[IMG_H, IMG_W]] + [[IMG_H - 7, IMG_W - 20]] * (b - 1), np.int32)
    y = rng.integers(2, V, size=(b, length + 1)).astype(np.int32)
    y[0, length - max(3, length // 4):] = 0
    return {"x": x, "x_hw": hw, "y_in": y[:, :-1], "y_out": y[:, 1:]}


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def assert_rel_l2(actual, desired, tol, name=""):
    """||actual - desired|| <= tol * ||desired|| (+ a floor for all-zero leaves)."""
    actual, desired = np.asarray(actual, np.float64), np.asarray(desired, np.float64)
    err = np.linalg.norm(actual - desired)
    ref = np.linalg.norm(desired)
    assert err <= tol * ref + 1e-12, f"{name}: relative L2 error {err / max(ref, 1e-30):.3g} > {tol}"


# ---------------------------------------------------------------- multimodal
# a tiny image + audio model: 32x64 images, 195 x AUDIO_T spectrograms (the audio frontend's fixed height)
AUDIO_T = 24
MM_KEYS = ("xi", "xi_hw", "xa", "xa_hw", "y_in")


def mm_hparams(**over):
    return hparams(input_modality="both", **over)


def jax_mm_model(**over):
    from omr_a2s_multimodal_transformer_tpu.models.multimodal import MultimodalTransformer as JaxMultimodal

    hp = mm_hparams(**over)
    hp.pop("input_modality")
    return JaxMultimodal(**hp)


def mm_state_dict_to_jax(sd):
    """Port multimodal state_dict -> JAX param tree: the JAX package's
    converter, plus mix_gate, which it does not map."""
    from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_multimodal_state_dict

    sd = {k: v.detach().clone() for k, v in sd.items()}
    tree = convert_multimodal_state_dict(sd)
    if "mix_gate" in sd:
        tree["mix_gate"] = sd["mix_gate"].numpy()
    return tree


def mm_port_and_jax_params(seed=0, gate=(0.7, -1.3), **over):
    """(port MultimodalTransformer on the CPU, JAX params {"params": tree})
    with equal weights; a residual mixer's gate is set to ``gate`` (nonzero,
    so that it is read)."""
    model, _ = build_model(mm_hparams(**over), device="cpu", seed=seed)
    if hasattr(model, "mix_gate"):
        with torch.no_grad():
            model.mix_gate.copy_(torch.tensor(gate[:model.mix_gate.numel()]))
    return model, {"params": jax.tree.map(jnp.asarray, mm_state_dict_to_jax(model.state_dict()))}


def mm_batch(seed=0, b=2, length=MAXLEN):
    """Images in [0, 1] and spectrograms in [0, 1] with ragged hw (the
    spectrogram's padded frames 0.0, as the collate pads), token rows as in
    ``batch``."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(b, IMG_H, IMG_W, 1)).astype(np.float32)
    xa = rng.uniform(size=(b, 195, AUDIO_T, 1)).astype(np.float32)
    hwi = np.array([[IMG_H, IMG_W]] + [[IMG_H - 7, IMG_W - 20]] * (b - 1), np.int32)
    hwa = np.array([[195, AUDIO_T]] + [[195, AUDIO_T - 9]] * (b - 1), np.int32)
    xa[1:, :, AUDIO_T - 9:] = 0.0
    y = rng.integers(2, V, size=(b, length + 1)).astype(np.int32)
    y[0, length - max(3, length // 4):] = 0
    return {"xi": xi, "xi_hw": hwi, "xa": xa, "xa_hw": hwa, "y_in": y[:, :-1], "y_out": y[:, 1:]}
