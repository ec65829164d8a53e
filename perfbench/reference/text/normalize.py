"""Text normalization: verbalize numbers/symbols, romanize, lowercase, strip.

Pipeline parity with the reference (zerovox/tts/normalize.py:28-47):

    normalize(text) -> (transcript_uroman, transcript_uroman_normalized)

where `transcript_uroman` is the verbalized + romanized + lowercased text
(still containing punctuation — the tokenizer extracts punctuation ids from
it) and `transcript_uroman_normalized` has everything outside [a-z' ]
replaced by spaces and whitespace collapsed (the alignment-target string).

The reference delegates verbalization to NeMo's WFST normalizer; when
`nemo_text_processing` is importable we do the same, otherwise a rule-based
normalizer is used covering cardinals, ordinals, decimals, dates (name,
numeric, ISO and day-first formats), roman numerals, fractions, numeric
ranges, currency (incl. million/billion/k magnitudes), percent, time (with
seconds and am/pm), units, years, phone numbers (digit-by-digit with group
pauses), street addresses (paired house numbers, suffix disambiguation
'Main St.' vs 'St. James'), consonant-only acronym spelling and common
abbreviations for en/de (behavior battery mirrors reference
utils/nemo_test.py:14-68; tests/test_text.py).
"""

from __future__ import annotations

import re

from . import numbers_de, numbers_en
from .romanize import romanize

try:  # pragma: no cover - optional heavyweight dependency
    from nemo_text_processing.text_normalization.normalize import Normalizer as _NemoNormalizer
except Exception:  # pragma: no cover
    _NemoNormalizer = None


_ABBREV = {
    "en": {
        "mr": "mister", "mrs": "misses", "ms": "miss", "dr": "doctor",
        "prof": "professor", "st": "saint", "jr": "junior", "sr": "senior",
        "vs": "versus", "etc": "et cetera", "no": "number",
        "dept": "department", "approx": "approximately",
    },
    "de": {
        "dr": "doktor", "prof": "professor", "nr": "nummer",
        "str": "straße", "z.b": "zum beispiel", "bzw": "beziehungsweise",
        "usw": "und so weiter", "ca": "circa", "ggf": "gegebenenfalls",
        "evtl": "eventuell", "inkl": "inklusive", "d.h": "das heißt",
        "u.a": "unter anderem", "bzgl": "bezüglich",
    },
}

_MONTHS_EN = ["january", "february", "march", "april", "may", "june", "july",
              "august", "september", "october", "november", "december"]
_MONTH_ABBR_EN = {m[:3]: m for m in _MONTHS_EN}
_MONTH_ABBR_EN["sept"] = "september"
_MONTHS_DE = ["januar", "februar", "märz", "april", "mai", "juni", "juli",
              "august", "september", "oktober", "november", "dezember"]
_MONTH_ABBR_DE = {m[:3]: m for m in _MONTHS_DE}
_MONTH_ABBR_DE["mär"] = "märz"

_UNITS = {
    "en": {"kg": ("kilogram", "kilograms"), "km": ("kilometer", "kilometers"),
           "cm": ("centimeter", "centimeters"), "mm": ("millimeter", "millimeters"),
           "ml": ("milliliter", "milliliters"), "mph": ("mile per hour", "miles per hour"),
           "kb": ("kilobyte", "kilobytes"), "mb": ("megabyte", "megabytes"),
           "gb": ("gigabyte", "gigabytes")},
    "de": {"kg": ("kilogramm", "kilogramm"), "km": ("kilometer", "kilometer"),
           "cm": ("zentimeter", "zentimeter"), "mm": ("millimeter", "millimeter"),
           "ml": ("milliliter", "milliliter"), "kb": ("kilobyte", "kilobyte"),
           "mb": ("megabyte", "megabyte"), "gb": ("gigabyte", "gigabyte")},
}

# common vowel-containing initialisms that read letter-by-letter (the
# consonant-only rule in _acronyms catches TV/PC/HTML/... automatically)
_SPELL_ACRONYMS = {
    "FBI", "CIA", "IBM", "USA", "EU", "UN", "UK", "US", "CEO", "CFO", "CTO",
    "CPU", "GPU", "API", "URL", "USB", "ATM", "GPS", "PDF", "SQL", "DNA",
    "RNA", "HIV", "IRS", "FDA", "EPA", "NBA", "NFL", "NHL", "UCLA", "MIT",
    "UFO", "VIP", "DIY", "FAQ", "ID", "IP", "AI", "OS", "UI",
    "ISBN", "IQ", "ICU", "EKG", "EDV", "IOC",
}

_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}
# all-roman-letter tokens that are (far) more likely ordinary words/acronyms
_ROMAN_BLOCKLIST = {"MIX", "CD", "DC", "MD", "CM", "MM", "DI", "LI", "MI", "XL"}


def _roman_to_int(s: str) -> int | None:
    """Strict roman-numeral parse; None when malformed (e.g. 'DID')."""
    if not re.fullmatch(
            r"M{0,3}(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})(IX|IV|V?I{0,3})", s) or not s:
        return None
    total = 0
    for i, c in enumerate(s):
        v = _ROMAN_VALUES[c]
        if i + 1 < len(s) and _ROMAN_VALUES[s[i + 1]] > v:
            total -= v
        else:
            total += v
    return total

_CURRENCY = {
    "en": {"$": ("dollar", "dollars", "cent", "cents"),
           "€": ("euro", "euros", "cent", "cents"),
           "£": ("pound", "pounds", "penny", "pence")},
    "de": {"$": ("dollar", "dollar", "cent", "cent"),
           "€": ("euro", "euro", "cent", "cent"),
           "£": ("pfund", "pfund", "penny", "pence")},
}


class _RuleBasedVerbalizer:
    """Verbalize digits/symbols into words for one language."""

    def __init__(self, lang: str):
        self.lang = "de" if lang.startswith("de") else "en"
        self.num = numbers_de if self.lang == "de" else numbers_en

    # -- helpers -------------------------------------------------------------

    def _cardinal(self, s: str) -> str:
        return self.num.number_to_words(int(s))

    def _maybe_year(self, s: str) -> str:
        n = int(s)
        if 1100 <= n <= 2099:
            return self.num.year_to_words(n)
        return self.num.number_to_words(n)

    def _day_word(self, d: int) -> str:
        if self.lang == "de":
            return self.num.ordinal_to_words(d) + "r"  # "erster januar"
        return self.num.ordinal_to_words(d)

    def _month_name(self, m: int) -> str:
        months = _MONTHS_DE if self.lang == "de" else _MONTHS_EN
        return months[m - 1] if 1 <= m <= 12 else str(m)

    def _digits(self, s: str) -> str:
        """Read a digit string digit-by-digit (phone numbers, NeMo
        telephone-grammar equivalent)."""
        zero = "null" if self.lang == "de" else "zero"
        return " ".join(zero if c == "0" else self.num.number_to_words(int(c))
                        for c in s if c.isdigit())

    # -- rule groups ----------------------------------------------------------

    def _phones(self, text: str) -> str:
        """Phone numbers -> digit-by-digit with per-group pauses
        (NeMo telephone WFST equivalent): (555) 123-4567, 555-123-4567,
        +1-800-555-0199, 555-0199; German 030/12345678, 0171 2345678."""
        def groups(*gs):
            return ", ".join(self._digits(g) for g in gs if g)

        # international prefix + grouped number
        text = re.sub(
            r"\+(\d{1,3})[-.\s]\(?(\d{2,4})\)?[-.\s](\d{3,4})[-.\s](\d{3,4})\b",
            lambda m: f"plus {self._digits(m.group(1))}, "
                      + groups(m.group(2), m.group(3), m.group(4)),
            text)
        if self.lang == "de":
            # area code / subscriber: 030/12345678, 0171 2345678
            text = re.sub(
                r"\b(0\d{2,4})[\s/](\d{5,8})\b",
                lambda m: groups(m.group(1), m.group(2)), text)
        # US 10-digit: (555) 123-4567 / 555-123-4567 / 555.123.4567
        text = re.sub(
            r"\(?\b(\d{3})\)?[-.\s](\d{3})[-.](\d{4})\b",
            lambda m: groups(m.group(1), m.group(2), m.group(3)), text)
        # US 7-digit: a bare 3-4 digit split is ambiguous with numeric
        # ranges ('400-7000 nm'), so read it as a phone only when it cannot
        # plausibly be a range: a phone-context word precedes, or the
        # subscriber group starts with 0 ('555-0199' — no range ends in a
        # leading-zero number). Everything else falls through to _ranges.
        text = re.sub(
            r"\b((?:phone|call|tel|telephone|fax|dial)\W{1,8})(\d{3})[-.](\d{4})\b",
            lambda m: m.group(1) + groups(m.group(2), m.group(3)),
            text, flags=re.IGNORECASE)
        text = re.sub(
            r"\b(\d{3})[-.](0\d{3})\b",
            lambda m: groups(m.group(1), m.group(2)), text)
        return text

    def _addresses(self, text: str) -> str:
        """US street addresses: the house number reads in pairs ('123 Main
        St.' -> 'one twenty three main street') and the suffix expands when
        it FOLLOWS the street name — 'St./Dr.' before a capitalized word
        stay saint/doctor (handled by the abbreviation pass)."""
        if self.lang != "en":
            return text
        suffixes = {"st": "street", "ave": "avenue", "rd": "road",
                    "blvd": "boulevard", "dr": "drive", "ln": "lane",
                    "ct": "court", "hwy": "highway"}
        # written suffixes are title-cased ('Main St.'); keep the street
        # name's [A-Z][a-z]+ case-sensitive, so no IGNORECASE here
        suf_pat = "|".join(s.capitalize() for s in suffixes)

        def house(m):
            n = m.group(1)
            return self._address_number(n) + " " + m.group(2)

        def suffix(m):
            return m.group(1) + " " + suffixes[m.group(2).lower()]

        # expand the suffix first: '<Name> St.' at end / before punct /
        # before a lowercase word is a street, not a saint
        text = re.sub(
            rf"\b([A-Z][a-z]+)\s+({suf_pat})\.?(?=$|[,;:!?]|\s+[a-z0-9])",
            suffix, text)
        # pair-read the house number before '<Name> street|avenue|...'
        full = "|".join(suffixes.values())
        text = re.sub(
            rf"\b(\d{{2,4}})\s+([A-Z][a-z]+\s+(?:{full})\b)", house, text)
        return text

    def _address_number(self, s: str) -> str:
        """House/address numbers read in pairs like NeMo: 123 -> 'one
        twenty three', 4675 -> 'forty six seventy five', 1200 -> 'twelve
        hundred', 100 -> 'one hundred', 105 -> 'one oh five', 4607 ->
        'forty six oh seven', 4000 -> 'four thousand'."""
        n = int(s)
        num = self.num

        def low_pair(lo: str) -> str:
            # a zero tens digit reads 'oh five', not 'five'
            if lo[0] == "0":
                return f"oh {num.number_to_words(int(lo[1]))}"
            return num.number_to_words(int(lo))

        if len(s) == 3:
            if s[1:] == "00":
                return num.number_to_words(n)
            return f"{num.number_to_words(int(s[0]))} {low_pair(s[1:])}"
        if len(s) == 4:
            # x00y (incl. x000) reads as a plain number ('four thousand
            # seven') — check BEFORE the trailing-00 'hundred' rule so
            # 4000 isn't read 'forty hundred'
            if s[1:3] == "00":
                return num.number_to_words(n)
            if s[2:] == "00":
                return f"{num.number_to_words(int(s[:2]))} hundred"
            return f"{num.number_to_words(int(s[:2]))} {low_pair(s[2:])}"
        return num.number_to_words(n)

    def _acronyms(self, text: str) -> str:
        """Spell initialisms letter-by-letter: consonant-only uppercase
        tokens ('HTML' -> 'H T M L', 'TV') plus a curated list of common
        vowel-containing initialisms ('FBI', 'CEO', 'USA'). Pronounceable
        all-caps words ('NASA', shouting-caps 'STOP') pass through. Runs
        after the roman-numeral rule so 'XIV' is already a number;
        blocklisted roman collisions ('MM') do get spelled."""
        def sub(m):
            tok = m.group(0)
            if tok in _SPELL_ACRONYMS or not any(v in tok for v in "AEIOUY"):
                return " ".join(tok)
            return tok

        return re.sub(r"\b[A-Z]{2,5}\b", sub, text)

    def _money_magnitude(self, text: str) -> str:
        """'$3.5 million' / '$5M' / '€10k' -> 'three point five million
        dollars' (NeMo money-magnitude grammar); runs before the plain
        currency rule."""
        num = self.num
        if self.lang == "de":
            mags = {"million": "millionen", "millionen": "millionen",
                    "mio": "millionen", "mrd": "milliarden",
                    "milliarde": "milliarden", "milliarden": "milliarden"}
        else:
            mags = {"million": "million", "billion": "billion",
                    "trillion": "trillion", "m": "million", "bn": "billion",
                    "k": "thousand"}
        mag_pat = "|".join(mags)

        def sub(m):
            sym = m.group("sym")
            amt = m.group("amt")
            mag = mags[m.group("mag").lower()]
            names = _CURRENCY[self.lang][sym]
            if "." in amt or "," in amt:
                whole, frac = re.split("[.,]", amt)
                amount = num.decimal_to_words(whole, frac)
            else:
                amount = num.number_to_words(int(amt))
            return f"{amount} {mag} {names[1]}"

        dec = "," if self.lang == "de" else r"\."
        return re.sub(
            rf"(?P<sym>[$€£])\s?(?P<amt>\d+(?:{dec}\d+)?)\s?(?P<mag>{mag_pat})\b",
            sub, text, flags=re.IGNORECASE)

    def _dates(self, text: str) -> str:
        """Name, numeric and ISO date formats (reference NeMo battery:
        'January 1st, 2024', 'Jan 1, 2024', '1/1/2024', '1. Januar 2024',
        '1.1.2024', '10.05.2024', '2024-12-25')."""
        num = self.num

        def ymd(y, m, d):
            y_w = self._maybe_year(str(y))
            if self.lang == "de":
                return f"{self._day_word(d)} {self._month_name(m)} {y_w}"
            return f"{self._month_name(m)} {self._day_word(d)} {y_w}"

        # ISO YYYY-MM-DD
        text = re.sub(r"\b(\d{4})-(\d{2})-(\d{2})\b",
                      lambda m: ymd(int(m.group(1)), int(m.group(2)), int(m.group(3))),
                      text)

        if self.lang == "de":
            months = "|".join(_MONTHS_DE + list(_MONTH_ABBR_DE))
            # 1. Januar 2024 / 1. Januar
            def de_name(m):
                d = int(m.group(1))
                mon = m.group(2).lower().rstrip(".")
                mon = _MONTH_ABBR_DE.get(mon, mon)
                out = f"{self._day_word(d)} {mon}"
                if m.group(3):
                    out += " " + self._maybe_year(m.group(3))
                return out

            text = re.sub(rf"\b(\d{{1,2}})\.\s*({months})\.?\s*(\d{{4}})?\b",
                          de_name, text, flags=re.IGNORECASE)
            # 1.1.2024 / 10.05.2024
            text = re.sub(
                r"\b(\d{1,2})\.(\d{1,2})\.(\d{4})\b",
                lambda m: ymd(int(m.group(3)), int(m.group(2)), int(m.group(1))),
                text)
        else:
            months = "|".join(_MONTHS_EN + list(_MONTH_ABBR_EN))
            # January 1st, 2024 / Jan 1, 2024 / May 23 1984 / January 1st
            def en_name(m):
                mon = m.group(1).lower().rstrip(".")
                mon = _MONTH_ABBR_EN.get(mon, mon)
                out = f"{mon} {self._day_word(int(m.group(2)))}"
                if m.group(3):
                    out += " " + self._maybe_year(m.group(3))
                return out

            text = re.sub(
                rf"\b({months})\.?\s+(\d{{1,2}})(?:st|nd|rd|th)?\s*,?\s*(\d{{4}})?\b",
                en_name, text, flags=re.IGNORECASE)

            # day-first: '23rd of May', 'the 3rd of May, 2021'
            def en_dayfirst(m):
                mon = m.group(2).lower().rstrip(".")
                mon = _MONTH_ABBR_EN.get(mon, mon)
                out = f"{self._day_word(int(m.group(1)))} of {mon}"
                if m.group(3):
                    out += " " + self._maybe_year(m.group(3))
                return out

            text = re.sub(
                rf"\b(\d{{1,2}})(?:st|nd|rd|th)?\s+of\s+({months})\.?\s*,?\s*(\d{{4}})?\b",
                en_dayfirst, text, flags=re.IGNORECASE)
            # M/D/YYYY
            text = re.sub(
                r"\b(\d{1,2})/(\d{1,2})/(\d{4})\b",
                lambda m: ymd(int(m.group(3)), int(m.group(1)), int(m.group(2))),
                text)
        return text

    def _times(self, text: str) -> str:
        """HH:MM[:SS] with optional am/pm / 'Uhr' context."""
        num = self.num
        lang = self.lang

        def time_sub(m):
            h, mm = int(m.group(1)), int(m.group(2))
            ss = int(m.group(3)) if m.group(3) else None
            suffix = (m.group(4) or "").replace(".", "").replace(" ", "").lower()
            if lang == "de":
                out = num.number_to_words(h) + " uhr"
                if mm:
                    out += " " + num.number_to_words(mm)
                if ss:
                    out += " und " + num.number_to_words(ss) + " sekunden"
                return out
            out = num.number_to_words(h)
            if mm == 0:
                out += "" if suffix else " o'clock"
            elif mm < 10:
                out += " oh " + num.number_to_words(mm)
            else:
                out += " " + num.number_to_words(mm)
            if ss:
                out += " and " + num.number_to_words(ss) + " seconds"
            if suffix == "am":
                out += " a m"
            elif suffix == "pm":
                out += " p m"
            return out

        pattern = r"\b(\d{1,2}):(\d{2})(?::(\d{2}))?(?:\s*(AM|PM|am|pm|a\.m\.|p\.m\.)\b)?"
        if lang == "de":
            # consume a following literal "Uhr" — verbalized as part of the time
            pattern += r"(?:\s*[Uu]hr\b)?"
        return re.sub(pattern, time_sub, text)

    def _roman(self, text: str) -> str:
        """Standalone uppercase roman numerals -> cardinals ('Chapter IV' ->
        'chapter four'); single letters and common collisions excluded."""
        def sub(m):
            tok = m.group(0)
            if tok in _ROMAN_BLOCKLIST:
                return tok
            n = _roman_to_int(tok)
            return self.num.number_to_words(n) if n else tok

        return re.sub(r"\b[IVXLCDM]{2,}\b", sub, text)

    def _frac_words(self, a: int, b: int) -> str:
        num = self.num
        if self.lang == "de":
            denoms = {2: "halb", 3: "drittel", 4: "viertel"}
            d = denoms.get(b, num.ordinal_to_words(b) + "l")
            return f"{'ein' if a == 1 else num.number_to_words(a)} {d}"
        denoms = {2: ("half", "halves"), 3: ("third", "thirds"),
                  4: ("quarter", "quarters")}
        if b in denoms:
            d = denoms[b][0 if a == 1 else 1]
        else:
            d = num.ordinal_to_words(b) + ("" if a == 1 else "s")
        return f"{num.number_to_words(a)} {d}"

    def _fractions(self, text: str) -> str:
        """1/2, 3/4, mixed 2 1/2 (dates are already consumed)."""
        conj = "und" if self.lang == "de" else "and"
        text = re.sub(
            r"\b(\d+)\s+(\d{1,2})/(\d{1,2})\b",
            lambda m: f"{self.num.number_to_words(int(m.group(1)))} {conj} "
                      f"{self._frac_words(int(m.group(2)), int(m.group(3)))}",
            text)
        return re.sub(
            r"\b(\d{1,2})/(\d{1,2})\b",
            lambda m: self._frac_words(int(m.group(1)), int(m.group(2))),
            text)

    def _ranges(self, text: str) -> str:
        """Numeric ranges: 10-20 -> 'ten to twenty' / 'zehn bis zwanzig';
        1939-1945 reads both ends as years."""
        word = "bis" if self.lang == "de" else "to"

        def sub(m):
            a, b = int(m.group(1)), int(m.group(2))
            if 1100 <= a <= 2099 and 1100 <= b <= 2099 and b >= a:
                return f"{self.num.year_to_words(a)} {word} {self.num.year_to_words(b)}"
            if b < a:  # more likely a phone number / code than a range
                return f"{self.num.number_to_words(a)} {word} {self.num.number_to_words(b)}"
            return f"{self.num.number_to_words(a)} {word} {self.num.number_to_words(b)}"

        return re.sub(r"\b(\d+)\s?[-–]\s?(\d+)\b", sub, text)

    def _units(self, text: str) -> str:
        num = self.num
        per = "pro stunde" if self.lang == "de" else "per hour"
        kmw = _UNITS[self.lang]["km"]
        text = re.sub(
            r"\b(\d+)\s?km/h\b",
            lambda m: f"{num.number_to_words(int(m.group(1)))} "
                      f"{kmw[0 if int(m.group(1)) == 1 else 1]} {per}",
            text)
        units = "|".join(_UNITS[self.lang])

        def sub(m):
            n = int(m.group(1))
            u = _UNITS[self.lang][m.group(2).lower()]
            return f"{num.number_to_words(n)} {u[0 if n == 1 else 1]}"

        return re.sub(rf"\b(\d+)\s?({units})\b", sub, text, flags=re.IGNORECASE)

    # -- main ----------------------------------------------------------------

    def verbalize(self, text: str) -> str:
        lang = self.lang
        num = self.num

        # street addresses BEFORE the abbreviation pass — '<Name> St.' must
        # become 'street' before the abbrev table reads 'St.' as 'saint'
        text = self._addresses(text)

        # common abbreviations (dot-terminated or bare word, case-insensitive)
        def abbrev_sub(m):
            key = m.group(1).lower()
            table = _ABBREV[lang]
            return table.get(key, m.group(0))

        abbrev_keys = "|".join(re.escape(k) for k in _ABBREV[lang])
        text = re.sub(rf"\b({abbrev_keys})\.(?=\s|$)", lambda m: abbrev_sub(m), text, flags=re.IGNORECASE)

        # dates before everything numeric (they contain '/', '.', '-');
        # phones after dates (ISO dates contain '-') but before ranges
        # (a 3-4 digit split like 555-0199 reads as a phone, not a range)
        text = self._dates(text)
        text = self._phones(text)

        # money magnitudes ($3.5 million / €10k) before plain currency
        text = self._money_magnitude(text)

        # currency: $12.50 / 12,50 € / €5
        def currency_sub(m):
            sym = m.group("sym")
            whole = m.group("whole").replace(",", "").replace(".", "") if lang == "de" else m.group("whole").replace(",", "")
            frac = m.group("frac")
            names = _CURRENCY[lang][sym]
            n = int(whole)
            out = num.number_to_words(n) + " " + (names[0] if n == 1 else names[1])
            if frac:
                c = int(frac)
                out += (" und " if lang == "de" else " ") + num.number_to_words(c) + " " + (names[2] if c == 1 else names[3])
            return out

        dec_sep = "," if lang == "de" else r"\."
        text = re.sub(
            rf"(?P<sym>[$€£])\s?(?P<whole>\d+)(?:{dec_sep}(?P<frac>\d{{2}}))?",
            currency_sub, text)
        text = re.sub(
            rf"(?P<whole>\d+)(?:{dec_sep}(?P<frac>\d{{2}}))?\s?(?P<sym>[$€£])",
            currency_sub, text)

        # percent
        pct_word = "prozent" if lang == "de" else "percent"
        text = re.sub(r"(\d+)\s?%", lambda m: self._cardinal(m.group(1)) + " " + pct_word, text)

        # time HH:MM[:SS] (+am/pm), roman numerals, fractions, ranges, units
        text = self._times(text)
        text = self._roman(text)
        text = self._fractions(text)
        text = self._ranges(text)
        text = self._units(text)
        # acronym spelling AFTER units — '5 GB' must stay gigabytes
        text = self._acronyms(text)

        # ordinals: English 1st/2nd/..., German "3." before a word (German
        # nouns are capitalized — "1. Übersicht", "2. Platz" — so any letter
        # qualifies; dates were consumed above)
        if lang == "en":
            text = re.sub(r"\b(\d+)(st|nd|rd|th)\b", lambda m: num.ordinal_to_words(int(m.group(1))), text)
        else:
            text = re.sub(r"\b(\d+)\.(?=\s+[A-Za-zäöüßÄÖÜ])",
                          lambda m: num.ordinal_to_words(int(m.group(1))), text)

        # thousands separators first — strip them (keeping any decimal part)
        # so "1,234.56" / "1.234,56" fall through to the decimal rule
        if lang == "en":
            text = re.sub(r"\b\d{1,3}(?:,\d{3})+(?=\.\d|\b)",
                          lambda m: m.group(0).replace(",", ""), text)
        else:
            text = re.sub(r"\b\d{1,3}(?:\.\d{3})+(?=,\d|\b)",
                          lambda m: m.group(0).replace(".", ""), text)

        # decimals
        if lang == "de":
            text = re.sub(r"\b(\d+),(\d+)\b", lambda m: num.decimal_to_words(m.group(1), m.group(2)), text)
        else:
            text = re.sub(r"\b(\d+)\.(\d+)\b", lambda m: num.decimal_to_words(m.group(1), m.group(2)), text)

        # remaining integers: 4-digit in year range read as years
        text = re.sub(r"\b\d{4}\b", lambda m: self._maybe_year(m.group(0)), text)
        text = re.sub(r"\b\d+\b", lambda m: self._cardinal(m.group(0)), text)

        # leftover symbols
        sym_words = {"&": " und " if lang == "de" else " and ",
                     "+": " plus ", "=": " gleich " if lang == "de" else " equals ",
                     "@": " at ", "/": " "}
        for sym, word in sym_words.items():
            text = text.replace(sym, word)

        return text


_normalizer_cache: dict[str, "_Backend"] = {}


class _Backend:
    def __init__(self, lang: str):
        self.lang = lang
        self.nemo = None
        if _NemoNormalizer is not None:  # pragma: no cover
            try:
                self.nemo = _NemoNormalizer(input_case="cased", lang=lang)
            except Exception:
                self.nemo = None
        self.rules = _RuleBasedVerbalizer(lang)

    def verbalize(self, text: str) -> str:
        if self.nemo is not None:  # pragma: no cover
            return self.nemo.normalize(text)
        return self.rules.verbalize(text)


def _get_backend(lang: str) -> _Backend:
    if lang not in _normalizer_cache:
        _normalizer_cache[lang] = _Backend(lang)
    return _normalizer_cache[lang]


def zerovox_normalize(transcript: str, lang: str) -> tuple[str, str]:
    """Normalize + romanize. Returns (uroman, uroman_normalized);
    semantics mirror reference zerovox/tts/normalize.py:28-47."""
    backend = _get_backend(lang)

    transcript_normalized = backend.verbalize(transcript)
    transcript_uroman = romanize(transcript_normalized).lower().strip()

    transcript_uroman_normalized = re.sub("([^a-z' ])", " ", transcript_uroman)
    transcript_uroman_normalized = re.sub(" +", " ", transcript_uroman_normalized)
    transcript_uroman_normalized = transcript_uroman_normalized.strip()

    return transcript_uroman, transcript_uroman_normalized


class ZeroVoxNormalizer:
    """Per-language normalizer facade (reference zerovox/tts/normalize.py:49-61)."""

    def __init__(self, lang: str):
        self._lang = lang

    @property
    def language(self) -> str:
        return self._lang

    def normalize(self, transcript: str) -> tuple[str, str]:
        return zerovox_normalize(transcript=transcript, lang=self._lang)
