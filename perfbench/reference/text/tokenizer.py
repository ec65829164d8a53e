"""Character-level "phoneme" tokenizer.

Converts a romanized transcript into parallel (phone_ids, punct_ids)
sequences. Behavioral parity with the reference tokenizer
(zerovox/tts/synthesize.py:145-190): whitespace/punctuation runs collapse and
the *maximum-priority* punctuation id of the run attaches to the *preceding*
phone (a prosodic pause signal); unknown characters are skipped; leading
punctuation with no preceding phone is dropped.
"""

from __future__ import annotations

from .symbols import Symbols


def transcript2phonemids(transcript: str, symbols: Symbols) -> tuple[list[int], list[int]]:
    phones: list[int] = []
    puncts: list[int] = []

    punct = 0
    pidx = 0

    while pidx < len(transcript):
        p = transcript[pidx]
        if p == " " or symbols.is_punct(p):
            pu = symbols.encode_punct(p)
            if pu > punct:
                punct = pu

            pidx += 1
            while pidx < len(transcript):
                p = transcript[pidx]
                if p != " " and not symbols.is_punct(p):
                    break
                pu = symbols.encode_punct(p)
                if pu > punct:
                    punct = pu
                pidx += 1

            if puncts:
                puncts[-1] = punct
            continue

        if not symbols.is_phone(p):
            pidx += 1
            continue

        punct = 0
        phones.append(symbols.encode_phone(p))
        puncts.append(punct)
        pidx += 1

    return phones, puncts


def text2phonemeids(
    text: str,
    symbols: Symbols,
    normalizer,
    verbose: bool = False,
) -> tuple[list[int], list[int]]:
    """Full text -> ids path (reference zerovox/tts/synthesize.py:192-211)."""
    transcript_uroman, _ = normalizer.normalize(text)
    phone_ids, punct_ids = transcript2phonemids(transcript_uroman, symbols)

    if verbose:
        print(f"Raw Text Sequence: {text}")
        print(f"Normalized       : {transcript_uroman}")
        print(f"Phoneme IDs      : {phone_ids}")
        print(f"Punct IDs        : {punct_ids}")

    return phone_ids, punct_ids
