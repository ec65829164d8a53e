"""German number verbalization (cardinals, ordinals, years, decimals).

Self-contained replacement for the subset of NeMo WFST German normalization
the reference relies on (reference zerovox/tts/normalize.py:28-47)."""

from __future__ import annotations

_ONES = [
    "null", "eins", "zwei", "drei", "vier", "fünf", "sechs", "sieben",
    "acht", "neun", "zehn", "elf", "zwölf", "dreizehn", "vierzehn",
    "fünfzehn", "sechzehn", "siebzehn", "achtzehn", "neunzehn",
]
# the form used inside compounds ("einundzwanzig", "einhundert")
_ONES_COMPOUND = dict(enumerate(_ONES))
_ONES_COMPOUND[1] = "ein"

_TENS = [
    "", "", "zwanzig", "dreißig", "vierzig", "fünfzig", "sechzig",
    "siebzig", "achtzig", "neunzig",
]


def _below_hundred(n: int, as_prefix: bool) -> str:
    # `as_prefix`: the number fuses into a following scale word
    # ("eintausend") so 1 reads "ein"; trailing 1 reads "eins".
    if n < 20:
        return _ONES_COMPOUND[n] if as_prefix else _ONES[n]
    t, o = divmod(n, 10)
    if o == 0:
        return _TENS[t]
    return _ONES_COMPOUND[o] + "und" + _TENS[t]


def _below_thousand(n: int, as_prefix: bool) -> str:
    h, rest = divmod(n, 100)
    out = ""
    if h:
        out += _ONES_COMPOUND[h] + "hundert"
    if rest:
        out += _below_hundred(rest, as_prefix)
    return out or _ONES[0]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n == 0:
        return "null"
    if n >= 10**12:
        return " ".join(c for c in str(n))  # fall back to digit reading

    parts = []
    billions, rest = divmod(n, 10**9)
    millions, rest2 = divmod(rest, 10**6)
    thousands, below = divmod(rest2, 10**3)

    if billions:
        if billions == 1:
            parts.append("eine milliarde")
        else:
            parts.append(_below_thousand(billions, False) + " milliarden")
    if millions:
        if millions == 1:
            parts.append("eine million")
        else:
            parts.append(_below_thousand(millions, False) + " millionen")

    tail = ""
    if thousands:
        tail += _below_thousand(thousands, True) + "tausend"
    if below:
        tail += _below_thousand(below, False)
    if tail:
        parts.append(tail)
    return " ".join(parts)


_ORD_SPECIAL = {1: "erste", 3: "dritte", 7: "siebte", 8: "achte"}


def ordinal_to_words(n: int) -> str:
    if n in _ORD_SPECIAL:
        return _ORD_SPECIAL[n]
    words = number_to_words(n)
    if n < 20:
        return words + "te"
    return words + "ste"


def year_to_words(n: int) -> str:
    """German year reading: 1999 -> neunzehnhundertneunundneunzig."""
    if 1100 <= n < 2000:
        hi, lo = divmod(n, 100)
        out = _below_hundred(hi, True) + "hundert"
        if lo:
            out += _below_thousand(lo, False)
        return out
    return number_to_words(n)


def digits_to_words(s: str) -> str:
    return " ".join(_ONES[int(c)] for c in s if c.isdigit())


def decimal_to_words(int_part: str, frac_part: str) -> str:
    head = number_to_words(int(int_part)) if int_part else "null"
    return head + " komma " + digits_to_words(frac_part)
