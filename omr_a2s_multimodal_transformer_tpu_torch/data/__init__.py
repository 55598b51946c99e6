from omr_a2s_multimodal_transformer_tpu_torch.data.encoding import KrnParser
from omr_a2s_multimodal_transformer_tpu_torch.data.vocab import (
    EOS_TOKEN,
    PAD_ID,
    PAD_TOKEN,
    SOS_TOKEN,
    Vocabulary,
)

__all__ = ["KrnParser", "Vocabulary", "SOS_TOKEN", "EOS_TOKEN", "PAD_TOKEN", "PAD_ID"]
