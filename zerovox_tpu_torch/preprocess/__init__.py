"""Offline corpus preprocessing: forced alignment and acoustic features."""

from zerovox_tpu_torch.preprocess.ctc_align import TokenSpan, forced_align, merge_tokens

__all__ = ["TokenSpan", "forced_align", "merge_tokens"]
