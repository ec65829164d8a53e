"""Latin romanization of arbitrary text.

The reference pipes normalized text through the `uroman` package
(reference zerovox/tts/normalize.py:34). uroman is not available in this
environment, so this module provides a self-contained romanizer that matches
uroman's behavior on the languages the framework targets (en/de and other
Latin-script European text): NFKD decomposition with combining-mark removal,
plus explicit transliterations for letters that do not decompose (ß, æ, ø, þ,
đ, ł, ...). Non-Latin scripts are covered so mixed-script input degrades
gracefully: Greek, Cyrillic, Arabic, Hebrew, Devanagari (table-driven),
Korean Hangul (algorithmic jamo decomposition, Revised-Romanization), and
Japanese kana (with yōon digraphs, sokuon gemination and chōonpu), and Han
ideographs via a bundled frequency-ranked toneless-pinyin table
(han_pinyin.py: ~2000 most frequent characters, ~96% of running Chinese
text; rarer ideographs are dropped — the documented coverage cutoff).
Han runs are grouped into words with jieba when installed (pinyin joined
within a word), else each character romanizes as its own word. When the
real `uroman` package is importable it is used instead.
"""

from __future__ import annotations

import functools
import unicodedata

try:  # pragma: no cover - optional dependency
    import uroman as _uroman_pkg

    _UROMAN = _uroman_pkg.Uroman()
except Exception:  # pragma: no cover
    _UROMAN = None

# letters that NFKD does not decompose
_SPECIAL = {
    "ß": "ss", "ẞ": "SS",
    "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O", "å": "a", "Å": "A",
    "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
    "đ": "d", "Đ": "D", "ħ": "h", "Ħ": "H",
    "ł": "l", "Ł": "L", "ŋ": "ng", "Ŋ": "Ng",
    "ı": "i", "İ": "I", "ĸ": "k",
    "ŧ": "t", "Ŧ": "T", "ƒ": "f",
    "'": "'", "’": "'", "‘": "'", "ʼ": "'",
    "–": "-", "—": "-", "­": "",
}

_GREEK = {
    "α": "a", "β": "b", "γ": "g", "δ": "d", "ε": "e", "ζ": "z", "η": "e",
    "θ": "th", "ι": "i", "κ": "k", "λ": "l", "μ": "m", "ν": "n", "ξ": "x",
    "ο": "o", "π": "p", "ρ": "r", "σ": "s", "ς": "s", "τ": "t", "υ": "y",
    "φ": "f", "χ": "ch", "ψ": "ps", "ω": "o",
}

_CYRILLIC = {
    "а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e", "ё": "e",
    "ж": "zh", "з": "z", "и": "i", "й": "y", "к": "k", "л": "l", "м": "m",
    "н": "n", "о": "o", "п": "p", "р": "r", "с": "s", "т": "t", "у": "u",
    "ф": "f", "х": "kh", "ц": "ts", "ч": "ch", "ш": "sh", "щ": "shch",
    "ъ": "", "ы": "y", "ь": "", "э": "e", "ю": "yu", "я": "ya",
}


_ARABIC = {
    "ا": "a", "ب": "b", "ت": "t", "ث": "th", "ج": "j", "ح": "h", "خ": "kh",
    "د": "d", "ذ": "dh", "ر": "r", "ز": "z", "س": "s", "ش": "sh", "ص": "s",
    "ض": "d", "ط": "t", "ظ": "z", "ع": "'", "غ": "gh", "ف": "f", "ق": "q",
    "ك": "k", "ل": "l", "م": "m", "ن": "n", "ه": "h", "و": "w", "ي": "y",
    "ء": "'", "آ": "a", "أ": "a", "إ": "i", "ؤ": "u", "ئ": "i", "ة": "h",
    "ى": "a", "ٱ": "a",
    # short-vowel diacritics; tanwin/sukun/shadda dropped
    "َ": "a", "ِ": "i", "ُ": "u",
    "ً": "an", "ٍ": "in", "ٌ": "un",
    "ْ": "", "ّ": "",
}
_ARABIC.update({chr(0x0660 + d): str(d) for d in range(10)})   # ٠-٩
_ARABIC.update({chr(0x06F0 + d): str(d) for d in range(10)})   # ۰-۹

_HEBREW = {
    "א": "a", "ב": "b", "ג": "g", "ד": "d", "ה": "h", "ו": "v", "ז": "z",
    "ח": "ch", "ט": "t", "י": "y", "כ": "k", "ך": "k", "ל": "l", "מ": "m",
    "ם": "m", "נ": "n", "ן": "n", "ס": "s", "ע": "a", "פ": "p", "ף": "f",
    "צ": "ts", "ץ": "ts", "ק": "q", "ר": "r", "ש": "sh", "ת": "t",
}

# Devanagari: consonants carry an inherent 'a' unless followed by a
# dependent vowel sign (matra) or virama
_DEVANAGARI_CONS = {
    "क": "k", "ख": "kh", "ग": "g", "घ": "gh", "ङ": "ng",
    "च": "ch", "छ": "chh", "ज": "j", "झ": "jh", "ञ": "ny",
    "ट": "t", "ठ": "th", "ड": "d", "ढ": "dh", "ण": "n",
    "त": "t", "थ": "th", "द": "d", "ध": "dh", "न": "n",
    "प": "p", "फ": "ph", "ब": "b", "भ": "bh", "म": "m",
    "य": "y", "र": "r", "ल": "l", "व": "v",
    "श": "sh", "ष": "sh", "स": "s", "ह": "h",
    "क़": "q", "ख़": "kh", "ग़": "gh", "ज़": "z", "ड़": "r", "ढ़": "rh", "फ़": "f",
}
_DEVANAGARI_VOWELS = {
    "अ": "a", "आ": "aa", "इ": "i", "ई": "ii", "उ": "u", "ऊ": "uu",
    "ऋ": "ri", "ए": "e", "ऐ": "ai", "ओ": "o", "औ": "au", "ऑ": "o",
}
_DEVANAGARI_MATRAS = {
    "ा": "aa", "ि": "i", "ी": "ii", "ु": "u", "ू": "uu", "ृ": "ri",
    "े": "e", "ै": "ai", "ो": "o", "ौ": "au", "ॉ": "o",
}
_DEVANAGARI_MISC = {"ं": "n", "ः": "h", "ँ": "n", "़": "", "्": ""}
_DEVANAGARI_MISC.update({chr(0x0966 + d): str(d) for d in range(10)})  # ०-९

# Hangul jamo (Revised Romanization)
_HANGUL_LEADS = ("g", "kk", "n", "d", "tt", "r", "m", "b", "pp", "s", "ss",
                 "", "j", "jj", "ch", "k", "t", "p", "h")
_HANGUL_VOWELS = ("a", "ae", "ya", "yae", "eo", "e", "yeo", "ye", "o", "wa",
                  "wae", "oe", "yo", "u", "wo", "we", "wi", "yu", "eu", "ui", "i")
_HANGUL_TAILS = ("", "g", "kk", "gs", "n", "nj", "nh", "d", "l", "lg", "lm",
                 "lb", "ls", "lt", "lp", "lh", "m", "b", "bs", "s", "ss",
                 "ng", "j", "ch", "k", "t", "p", "h")

# Hiragana -> Hepburn-ish romaji (katakana normalized onto this table)
_KANA = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "wi", "ゑ": "we", "を": "o", "ん": "n",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o", "ゔ": "vu",
}
_KANA_SMALL = {"ゃ": "ya", "ゅ": "yu", "ょ": "yo"}
_SOKUON = "っ"
_CHOONPU = "ー"



# Thai (RTGS-style, char-level): preposed vowels reorder after the next
# consonant; tone marks / thanthakhat / mai taikhu are dropped
_THAI_CONS = {
    "ก": "k", "ข": "kh", "ฃ": "kh", "ค": "kh", "ฅ": "kh", "ฆ": "kh",
    "ง": "ng", "จ": "ch", "ฉ": "ch", "ช": "ch", "ซ": "s", "ฌ": "ch",
    "ญ": "y", "ฎ": "d", "ฏ": "t", "ฐ": "th", "ฑ": "th", "ฒ": "th",
    "ณ": "n", "ด": "d", "ต": "t", "ถ": "th", "ท": "th", "ธ": "th",
    "น": "n", "บ": "b", "ป": "p", "ผ": "ph", "ฝ": "f", "พ": "ph",
    "ฟ": "f", "ภ": "ph", "ม": "m", "ย": "y", "ร": "r", "ฤ": "rue",
    "ล": "l", "ฦ": "lue", "ว": "w", "ศ": "s", "ษ": "s", "ส": "s",
    "ห": "h", "ฬ": "l", "อ": "", "ฮ": "h",
}
_THAI_VOWELS = {  # postposed / above / below signs
    "ะ": "a", "\u0e31": "a", "า": "a", "ำ": "am", "\u0e34": "i",
    "\u0e35": "i", "\u0e36": "ue", "\u0e37": "ue", "\u0e38": "u",
    "\u0e39": "u", "ๅ": "", "ฯ": "", "ๆ": "",
}
_THAI_PREPOSED = {"เ": "e", "แ": "ae", "โ": "o", "ใ": "ai", "ไ": "ai"}
_THAI_DROP = {"\u0e47", "\u0e48", "\u0e49", "\u0e4a", "\u0e4b", "\u0e4c",
              "\u0e4d", "\u0e4e"}  # mai taikhu, 4 tones, thanthakhat, ...
_THAI_DIGITS = {chr(0x0E50 + d): str(d) for d in range(10)}


def _is_han(ch: str) -> bool:
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0xF900 <= cp <= 0xFAFF)


@functools.lru_cache(maxsize=1)
def _jieba():
    try:  # pragma: no cover - optional dependency
        import jieba

        jieba.setLogLevel(60)
        return jieba
    except Exception:
        return None


def _romanize_han(run: str) -> str:
    """Han run -> space-separated pinyin words (uroman emits per-character
    readings; with jieba installed, characters of one word are joined so
    the downstream tokenizer sees word-level pause structure)."""
    from .han_pinyin import pinyin

    seg = _jieba()
    words = seg.cut(run) if seg is not None else run
    out = []
    for word in words:
        r = "".join(pinyin(c) or "" for c in word)
        if r:
            out.append(r)
    return " " + " ".join(out) + " " if out else ""


def _hangul_syllable(cp: int) -> str:
    idx = cp - 0xAC00
    lead = idx // 588
    vowel = (idx % 588) // 28
    tail = idx % 28
    return _HANGUL_LEADS[lead] + _HANGUL_VOWELS[vowel] + _HANGUL_TAILS[tail]


def _norm_kana(ch: str) -> str:
    """Katakana -> hiragana (same syllabary, fixed offset)."""
    cp = ord(ch)
    if 0x30A1 <= cp <= 0x30F6:
        return chr(cp - 0x60)
    return ch


def _translit_char(ch: str) -> str:
    if ch in _SPECIAL:
        return _SPECIAL[ch]
    low = ch.lower()
    if low in _GREEK:
        out = _GREEK[low]
        return out.upper() if ch.isupper() else out
    if low in _CYRILLIC:
        out = _CYRILLIC[low]
        return out.capitalize() if ch.isupper() else out
    if ch in _ARABIC:
        return _ARABIC[ch]
    if ch in _HEBREW:
        return _HEBREW[ch]
    cp = ord(ch)
    if 0xAC00 <= cp <= 0xD7A3:
        return _hangul_syllable(cp)
    if ch in _DEVANAGARI_VOWELS:
        return _DEVANAGARI_VOWELS[ch]
    if ch in _DEVANAGARI_MISC:
        return _DEVANAGARI_MISC[ch]
    # NFKD-decompose and drop combining marks; re-transliterate the base
    # characters (e.g. Greek alpha-with-tonos decomposes to bare alpha,
    # which still needs the Greek table)
    decomp = unicodedata.normalize("NFKD", ch)
    stripped = "".join(c for c in decomp if not unicodedata.combining(c))
    if stripped != ch:
        return "".join(_translit_char(c) for c in stripped)
    return stripped


@functools.lru_cache(maxsize=4096)
def _translit_cached(ch: str) -> str:
    return _translit_char(ch)


def _emit_kana(text: str, i: int, out: list) -> int:
    """Transliterate one kana unit at text[i]; returns the next index."""
    k = _norm_kana(text[i])
    nxt = _norm_kana(text[i + 1]) if i + 1 < len(text) else ""
    if k == _SOKUON:
        # gemination: double the following syllable's leading consonant
        r = _KANA.get(nxt, "")
        out.append(r[0] if r and r[0] not in "aeiou" else "")
        return i + 1
    if k == _CHOONPU:
        # long-vowel mark: repeat the previous vowel
        prev = out[-1][-1] if out and out[-1] else ""
        out.append(prev if prev in "aeiou" else "")
        return i + 1
    if k in _KANA_SMALL:  # stray small ya/yu/yo
        out.append(_KANA_SMALL[k])
        return i + 1
    r = _KANA[k]
    if nxt in _KANA_SMALL and r.endswith("i") and len(r) >= 2:
        # yoon digraph: ki+ya -> kya, shi+ya -> sha, ji+yo -> jo
        cons = r[:-1]
        small = _KANA_SMALL[nxt]
        out.append(cons + small[1:] if cons.endswith("h") or cons == "j"
                   else cons + small)
        return i + 2
    out.append(r)
    return i + 1


def _romanize_fallback(text: str) -> str:
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if _is_han(ch):
            j = i
            while j < n and _is_han(text[j]):
                j += 1
            out.append(_romanize_han(text[i:j]))
            i = j
            continue
        k = _norm_kana(ch)
        if k in _KANA or k in _KANA_SMALL or k in (_SOKUON, _CHOONPU):
            i = _emit_kana(text, i, out)
            continue
        if ch in _THAI_PREPOSED:
            # preposed vowel: written before, pronounced after the consonant
            v = _THAI_PREPOSED[ch]
            j = i + 1
            cons = ""
            while j < n and (text[j] in _THAI_CONS or text[j] in _THAI_DROP):
                if text[j] in _THAI_CONS:
                    cons += _THAI_CONS[text[j]]
                    j += 1
                    break
                j += 1
            out.append(cons + v)
            i = j
            continue
        if ch in _THAI_CONS or ch in _THAI_VOWELS or ch in _THAI_DROP \
                or ch in _THAI_DIGITS:
            if ch in _THAI_CONS:
                out.append(_THAI_CONS[ch])
            elif ch in _THAI_VOWELS:
                out.append(_THAI_VOWELS[ch])
            elif ch in _THAI_DIGITS:
                out.append(_THAI_DIGITS[ch])
            i += 1
            continue
        if ch in _DEVANAGARI_CONS:
            base = _DEVANAGARI_CONS[ch]
            nxt = text[i + 1] if i + 1 < n else ""
            if nxt in _DEVANAGARI_MATRAS:
                out.append(base + _DEVANAGARI_MATRAS[nxt])
                i += 2
            elif nxt == "्":  # virama suppresses the inherent vowel
                out.append(base)
                i += 2
            else:
                out.append(base + "a")
                i += 1
            continue
        out.append(_translit_cached(ch))
        i += 1
    return "".join(out)


def romanize(text: str) -> str:
    """Romanize `text` to Latin script. Uses uroman when installed."""
    if _UROMAN is not None:  # pragma: no cover - env without uroman
        return str(_UROMAN.romanize_string(text))
    return _romanize_fallback(text)
