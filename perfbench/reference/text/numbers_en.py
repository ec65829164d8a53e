"""English number verbalization (cardinals, ordinals, years, decimals).

Self-contained replacement for the subset of NeMo WFST text normalization the
reference relies on (reference zerovox/tts/normalize.py:28-47 delegates to
nemo_text_processing); used by the rule-based normalizer when NeMo is absent.
"""

from __future__ import annotations

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALE = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
]

_ORD_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    for value, name in _SCALE:
        if n >= value:
            head, rest = divmod(n, value)
            words = number_to_words(head) + " " + name
            if rest:
                words += " " + number_to_words(rest)
            return words
    return _ONES[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if last in _ORD_SPECIAL:
        last = _ORD_SPECIAL[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    elif last in ("hundred", "thousand", "million", "billion", "trillion"):
        last = last + "th"
    else:
        last = last + "th"
    parts[-1] = last
    return " ".join(parts)


def year_to_words(n: int) -> str:
    """Read 4-digit years the way people say them (nineteen ninety-nine)."""
    if 1000 <= n <= 9999:
        hi, lo = divmod(n, 100)
        if lo == 0:
            if hi % 10 == 0:
                return number_to_words(n)
            return number_to_words(hi) + " hundred"
        if lo < 10:
            return number_to_words(hi) + " oh " + number_to_words(lo)
        return number_to_words(hi) + " " + number_to_words(lo)
    return number_to_words(n)


def digits_to_words(s: str) -> str:
    return " ".join(_ONES[int(c)] for c in s if c.isdigit())


def decimal_to_words(int_part: str, frac_part: str) -> str:
    head = number_to_words(int(int_part)) if int_part else "zero"
    return head + " point " + digits_to_words(frac_part)
