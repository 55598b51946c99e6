"""The port's early-fusion multimodal model's logits against the JAX
package's, on the CPU, for every mixer (raw and gated, plain and flash
cross-attention) and for modality dropout's single-modality programs.

The tiny image + audio model of torch_port_common (32x64 images, 195 x 24
spectrograms, the full 8-layer decoder), the same weights in both packages
(the port's random init through the JAX package's
``convert_multimodal_state_dict``, plus ``mix_gate``, set nonzero so that
the gates are read), deterministic mode.

Tolerances: logits without flash agree to 1e-4 x max |JAX| (float32 in
both, other summation orders; measured ~1e-6). With ``use_flash_cross``
both packages round q/k/v and p to bf16 inside flash at different points,
as ``test_torch_port_model.py`` says, and the logits agree to 5e-3 x max
|JAX| (measured 1.5e-3; bf16's rounding step is 3.9e-3). The rest of the
multimodal model: test_torch_port_multimodal.py.
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_common import MAXLEN, MM_KEYS, V, jax_mm_model, mm_batch, mm_port_and_jax_params, to_torch

MIXERS = ("concat", "attn_img", "attn_audio", "attn_both")


def _logits(mixer, residual, flash, modality, seed):
    model, params = mm_port_and_jax_params(seed=seed, mixer_type=mixer, mixer_residual=residual,
                                           use_flash_cross=flash)
    b = mm_batch(seed=seed)
    jm = jax_mm_model(mixer_type=mixer, mixer_residual=residual, use_flash_cross=flash)
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, modality))(params, *(b[k] for k in MM_KEYS)))
    tb = to_torch(b)
    with torch.no_grad():
        got = model(*(tb[k] for k in MM_KEYS), modality=modality).numpy()
    assert got.shape == (2, MAXLEN, V) and np.isfinite(got).all()
    return got, want


def _tol(flash):
    return 5e-3 if flash else 1e-4


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("residual", [False, True], ids=["raw", "gated"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_fused_logits_match_jax(mixer, residual, flash):
    got, want = _logits(mixer, residual, flash, "both", seed=1)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(flash) * np.abs(want).max())


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("modality", ["image", "audio"])
def test_single_modality_logits_match_jax(modality, flash):
    """Modality dropout's single-modality programs: only one encoder runs,
    and the mixer is not read (attn_both with gates, the widest mixer)."""
    got, want = _logits("attn_both", True, flash, modality, seed=2)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tol(flash) * np.abs(want).max())
