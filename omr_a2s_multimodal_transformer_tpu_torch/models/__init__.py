from typing import Dict, Optional, Tuple, Union

import torch

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, resolve_device, set_float32_precision
from omr_a2s_multimodal_transformer_tpu_torch.models.multimodal import MultimodalTransformer
from omr_a2s_multimodal_transformer_tpu_torch.models.transformer import UnimodalTransformer, check_memory_partition
from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import Mesh
from omr_a2s_multimodal_transformer_tpu_torch.parallel.tp import shard_model


def build_model(hparams: Dict, device: DeviceLike = None, seed: int = 0, mesh: Optional[Mesh] = None
                ) -> Tuple[Union[UnimodalTransformer, MultimodalTransformer], bool]:
    """Model factory from an hparams dict (the keys of the JAX package's
    ``build_model``). Returns (model on ``device``, multimodal flag):
    ``input_modality="both"`` builds a MultimodalTransformer with
    ``mixer_type`` (default concat) and ``mixer_residual``; "image" and
    "audio" a UnimodalTransformer.

    ``device`` defaults to ``cuda`` and raises when no GPU is present.
    Weights are random from ``seed``, drawn from the JAX package's
    initialisers (``models/init.py``); ``training/jax_import.py`` loads a
    JAX param tree.

    ``conv_mode`` is accepted and read nowhere: it only picks the JAX
    package's TPU layout of the same convolutions. ``cache_dtype`` is one
    of float32, bfloat16, int8 and int4 (quantized cross K/V,
    ``models/decoder.py``). ``remat=True`` recomputes the encoder blocks
    (and the decoder layers off the flash path) in the backward.

    ``mesh`` (``parallel/mesh.py`` ``make_mesh``; not an hparam: it is the
    machine, not the model) shards the model for this rank: every rank
    builds the same full weights from ``seed`` and keeps its slice
    (``parallel/tp.py`` ``shard_model``). A set ``memory_partition`` needs
    a mesh and raises ``ValueError`` without one, as JAX's sharding
    constraint raises outside a mesh context.
    """
    dev = resolve_device(device)
    check_memory_partition(hparams.get("memory_partition"), mesh)
    set_float32_precision()
    common = dict(
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
        remat=hparams.get("remat", False),
        memory_partition=hparams.get("memory_partition"),
    )
    multimodal = hparams["input_modality"] == "both"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if multimodal:
            model = MultimodalTransformer(mixer_type=hparams.get("mixer_type") or "concat",
                                          mixer_residual=hparams.get("mixer_residual", False), **common)
        else:
            model = UnimodalTransformer(**common)
    model = model.to(dev)
    if mesh is not None:
        shard_model(model, mesh)
    return model, multimodal


__all__ = ["UnimodalTransformer", "MultimodalTransformer", "build_model"]
