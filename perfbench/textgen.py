"""Seeded English sentences of given lengths, and the sizes the mixes draw.

Every seed draws the same multiset of sizes (lengths, gaps): quantiles of
the stated distribution, put in another order by the seed, so runs with
different seeds do the same amount of work. The seed picks the words.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_WORDS = (
    "the a of and to in is was that for it with as his on be at by had not are but from or "
    "have an they which one you were her all she there would their we him been has when who "
    "will more no if out so said what up its about into than them can only other new some "
    "could time these two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much your way well down "
    "should because each just those people how too little state good very make world still "
    "own see men work long get here between both life being under never day same another "
    "know while last might us great old year off come since against go came right used take "
    "three himself few house use during without again place around however home small found "
    "thought went say part once general high upon school every does got united left number "
    "course war until always away something fact though water less public put think almost "
    "hand enough far took head yet government system better set told nothing night end why "
    "called didn't eyes find going look asked later knew point next program city business "
    "give group toward young days let room president side social given present several "
    "order national second possible rather per face among form important often things "
    "looked early white case john become large big need four within felt children along "
    "saw best church ever least power development light seemed family interest want members "
    "mind country area others done turned although open god service certain kind problem "
    "began different door thus help sense means whole matter perhaps itself york it's times "
    "law human line above name example action company hands local show whether five history "
    "gave today either act feet across taken past quite anything having seen death experience "
    "body word half really field am car words already themselves i'm information tell "
    "together college shall money period held keep sure probably free seems real behind "
    "cannot miss political air question making office brought whose special heard major "
    "problems ago became federal moment study available known result street economic boy "
    "position reason change south board individual job society areas west close turn love "
    "community true court force full seem wife future age voice center woman control common "
    "necessary policy following front sometimes six girl clear further land able feel "
    "mother music party provide university child effect level stood military town short "
    "morning total outside rate figure class art century washington north usually leave "
    "therefore evidence percent black strong believe"
).split()
_TITLES = ("Dr.", "Mr.", "Mrs.", "Ms.", "Prof.", "St.")
_NAMES = ("Smith", "Miller", "Jones", "Taylor", "Brown", "Clark", "Lewis", "Walker")
_TAILS = ("etc.", "vs.", "approx.")


def lognormal_sizes(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """n integer sizes at the lognormal's quantiles (i + 1/2) / n, clipped
    to [lo, hi], in increasing order."""
    nd = NormalDist()
    q = [math.exp(math.log(median) + sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.round(q), lo, hi).astype(np.int64)


def exponential_gaps(n: int, mean: float) -> np.ndarray:
    """n gaps at the exponential's quantiles (i + 1/2) / n, rescaled to
    sum to n * mean: a Poisson process's inter-arrival times, as a set."""
    g = -np.log(1.0 - (np.arange(n) + 0.5) / n)
    return g * (n * mean / g.sum())


def _number(rng: np.random.Generator) -> str:
    kind = rng.integers(6)
    if kind == 0:
        return str(int(rng.integers(2, 100)))
    if kind == 1:
        return str(int(rng.integers(1900, 2030)))
    if kind == 2:
        return f"{int(rng.integers(1, 20))}.{int(rng.integers(1, 10))}"
    if kind == 3:
        return f"${int(rng.integers(2, 500))}"
    if kind == 4:
        return f"{int(rng.integers(2, 100))}%"
    return str(int(rng.integers(100, 5000)))


def sentence(rng: np.random.Generator, n_chars: int) -> str:
    """An English sentence of about n_chars characters: common words with
    some numbers, titles, abbreviations and commas, ending in . ? or !"""
    parts: list[str] = []
    length = 0
    while length < n_chars - 1:
        r = rng.random()
        if r < 0.05:
            w = _number(rng)
        elif r < 0.07:
            w = f"{_TITLES[rng.integers(len(_TITLES))]} {_NAMES[rng.integers(len(_NAMES))]}"
        elif r < 0.08 and parts:
            w = _TAILS[rng.integers(len(_TAILS))]
        else:
            w = _WORDS[rng.integers(len(_WORDS))]
        if parts and rng.random() < 0.08 and not parts[-1].endswith((",", ".")):
            parts[-1] += ","
        parts.append(w)
        length += len(w) + 1
    text = " ".join(parts).rstrip(",.")
    text = text[0].upper() + text[1:]
    return text + ".?!"[int(rng.choice(3, p=(0.8, 0.12, 0.08)))]
