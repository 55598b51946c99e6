from typing import Dict, Tuple

import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, resolve_device, set_float32_precision
from omr_a2s_multimodal_transformer_tpu_torch.models.transformer import UnimodalTransformer


def build_model(hparams: Dict, device: DeviceLike = None, seed: int = 0) -> Tuple[UnimodalTransformer, bool]:
    """Model factory from an hparams dict (the keys of the JAX package's
    ``build_model``). Returns (model on ``device``, multimodal flag).

    ``device`` defaults to ``cuda`` and raises when no GPU is present.
    Weights are random from ``seed``; ``training/jax_import.py`` loads a
    JAX param tree. Only unimodal models are ported.
    """
    dev = resolve_device(device)
    if hparams["input_modality"] == "both":
        raise NotImplementedError("multimodal models are not ported yet")
    set_float32_precision()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UnimodalTransformer(
            vocab_size=hparams["vocab_size"],
            max_seq_len=hparams["max_seq_len"],
            attn_window=hparams.get("attn_window", -1),
            encoder_dropout=hparams.get("encoder_dropout", 0.5),
            decoder_dropout=hparams.get("decoder_dropout", 0.1),
            pos_dropout=hparams.get("pos_dropout", 0.1),
            masked_norm=hparams.get("masked_norm", False),
            prefix_memory_mask=hparams.get("prefix_memory_mask", False),
            torch_float_parity=hparams.get("torch_float_parity", False),
            cache_dtype=hparams.get("cache_dtype", "float32"),
            use_flash_cross=hparams.get("use_flash_cross", False),
            packed_stem=hparams.get("packed_stem", False),
        )
    return model.to(dev), False


__all__ = ["UnimodalTransformer", "build_model"]
