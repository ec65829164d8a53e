"""Phone / punctuation vocabularies.

Behavioral parity with the reference's Symbols class
(reference zerovox/tts/symbols.py:2-49): phones are assigned ids starting at 0
in string order; punctuation ids start at 1 with id 0 reserved for NO_PUNCT.
Ids must match the reference exactly so that upstream torch checkpoints
loaded by zerovox_tpu_torch.weights produce identical embeddings.
"""

from __future__ import annotations


class Symbols:
    """Bidirectional phone<->id and punct<->id maps."""

    NO_PUNCT = "_NP_"

    def __init__(self, phones, puncts):
        self._phonemap: dict[str, int] = {}
        self._phonemapr: dict[int, str] = {}
        for idx, p in enumerate(phones):
            self._phonemap[p] = idx
            self._phonemapr[idx] = p

        self._punctmap: dict[str, int] = {Symbols.NO_PUNCT: 0}
        self._punctmapr: dict[int, str] = {0: Symbols.NO_PUNCT}
        for idx, p in enumerate(puncts, start=1):
            self._punctmap[p] = idx
            self._punctmapr[idx] = p

    # -- phones --------------------------------------------------------------

    def is_phone(self, p: str) -> bool:
        return p in self._phonemap

    def encode_phone(self, phone: str) -> int:
        return self._phonemap[phone]

    def decode_phone(self, phone_id: int) -> str:
        return self._phonemapr[phone_id]

    @property
    def num_phones(self) -> int:
        return len(self._phonemap)

    # -- puncts --------------------------------------------------------------

    def is_punct(self, p: str) -> bool:
        return p in self._punctmap

    def encode_punct(self, punct: str) -> int:
        return self._punctmap[punct]

    def decode_punct(self, punct_id: int) -> str:
        return self._punctmapr[punct_id]

    @property
    def num_puncts(self) -> int:
        return len(self._punctmap)
