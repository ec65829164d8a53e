from zerovox_tpu_torch.text.normalize import ZeroVoxNormalizer, zerovox_normalize
from zerovox_tpu_torch.text.tokenizer import transcript2phonemids, text2phonemeids

__all__ = [
    "ZeroVoxNormalizer",
    "zerovox_normalize",
    "transcript2phonemids",
    "text2phonemeids",
]
