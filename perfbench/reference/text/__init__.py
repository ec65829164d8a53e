"""A frozen copy of the port's English/German text frontend
(`zerovox_tpu_torch/text/` and `symbols.py`), with its imports made local.

The benchmark's reference derives the phone and punctuation ids of every
text itself, so a later change to the port's frontend shows as a different
answer instead of moving the yardstick with it.
"""

from .normalize import ZeroVoxNormalizer
from .symbols import Symbols
from .tokenizer import transcript2phonemids


def text_ids(text: str, symbols: Symbols, normalizer: ZeroVoxNormalizer):
    """text -> (phone ids, punct ids), the port's `text2phonemeids`."""
    uroman, _ = normalizer.normalize(text)
    return transcript2phonemids(uroman, symbols)
