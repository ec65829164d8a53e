"""CTC forced alignment (Viterbi) + token-span merging.

Self-contained replacement for torchaudio's
``functional.forced_align`` / ``functional.merge_tokens`` used by the
reference preprocessor (utils/preprocess.py:421, 447), as the JAX package's
`preprocess/ctc_align.py` has it. Given per-frame CTC log-probabilities and a
target token sequence, finds the maximum-probability monotonic alignment over
the standard CTC state graph (blank-interleaved targets), returning a
per-frame token id (blank where the path is in a blank state) and the
per-frame log-probability score; ``merge_tokens`` collapses the framewise
path into per-token spans.

Three versions of one DP: `forced_align` runs the native C++ pass
(native/ctc_align.cpp, built with g++ at first use; a failed build raises),
`forced_align_plain` the numpy DP vectorized over states, and
`forced_align_torch` the same Viterbi over a tensor on its device, the
counterpart of the JAX package's `forced_align_jax`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

NEG_INF = -1e30


@dataclass
class TokenSpan:
    """One aligned target token occupying frames [start, end)."""

    token: int
    start: int
    end: int
    score: float


def _extend_targets(targets: np.ndarray, blank: int) -> np.ndarray:
    """Interleave blanks: [t1, t2, ...] -> [b, t1, b, t2, ..., b]."""
    n = len(targets)
    ext = np.full(2 * n + 1, blank, dtype=np.int64)
    ext[1::2] = targets
    return ext


def _native_lib() -> ctypes.CDLL:
    from zerovox_tpu_torch import native

    lib = native.load("ctc_align")
    fn = lib.zv_forced_align
    fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float)]
    fn.restype = ctypes.c_int
    return lib


def forced_align(log_probs: np.ndarray, targets: np.ndarray,
                 blank: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Viterbi CTC alignment by the native C++ DP.

    Args:
      log_probs: [T, C] log-probabilities (log_softmax over classes).
      targets:   [N] target token ids (no blanks).
      blank:     blank id.

    Returns:
      (aligned_tokens [T] int64 — target token id per frame, `blank` where
       the path sits in a blank state; scores [T] float32 — the emission
       log-probability of the aligned class at each frame).

    Raises ValueError when T < required minimum path length.
    """
    log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
    targets = np.ascontiguousarray(np.asarray(targets, dtype=np.int64).reshape(-1))
    T, C = log_probs.shape
    if targets.size and (targets.min() < 0 or targets.max() >= C):
        raise ValueError(f"target ids must lie in [0, {C})")
    out_tokens = np.empty(T, dtype=np.int64)
    out_scores = np.empty(T, dtype=np.float32)
    rc = _native_lib().zv_forced_align(
        log_probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, C,
        targets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(targets), blank,
        out_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc == -1:
        raise ValueError(f"targets length {len(targets)} too long for {T} frames")
    return out_tokens, out_scores


def forced_align_plain(log_probs: np.ndarray, targets: np.ndarray,
                       blank: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """`forced_align`'s DP in numpy (float64 sums), vectorized over states;
    the same path as the native pass."""
    log_probs = np.asarray(log_probs, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.int64).reshape(-1)
    T, C = log_probs.shape
    ext = _extend_targets(targets, blank)
    S = len(ext)

    if len(targets) == 0:
        return np.full(T, blank, np.int64), log_probs[:, blank].astype(np.float32)
    # minimal frames: each target needs a frame, plus a frame between repeats
    min_frames = len(targets) + np.sum(targets[1:] == targets[:-1])
    if T < min_frames:
        raise ValueError(f"targets length {len(targets)} too long for {T} frames")

    # skip-transition allowed into state s when ext[s] != blank and != ext[s-2]
    can_skip = np.zeros(S, dtype=bool)
    can_skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])

    alpha = np.full(S, NEG_INF)
    alpha[0] = log_probs[0, ext[0]]
    if S > 1:
        alpha[1] = log_probs[0, ext[1]]

    backptr = np.zeros((T, S), dtype=np.int8)  # 0: stay, 1: from s-1, 2: from s-2

    emit = log_probs[:, ext]  # [T, S]
    for t in range(1, T):
        stay = alpha
        prev1 = np.concatenate([[NEG_INF], alpha[:-1]])
        prev2 = np.concatenate([[NEG_INF, NEG_INF], alpha[:-2]])
        prev2 = np.where(can_skip, prev2, NEG_INF)

        stacked = np.stack([stay, prev1, prev2])  # [3, S]
        choice = np.argmax(stacked, axis=0)
        best = stacked[choice, np.arange(S)]
        backptr[t] = choice
        alpha = best + emit[t]

    # end state: last blank or last token
    s = S - 1 if alpha[S - 1] >= alpha[S - 2] else S - 2

    states = np.zeros(T, dtype=np.int64)
    for t in range(T - 1, -1, -1):
        states[t] = s
        s -= backptr[t, s]

    aligned = ext[states]
    scores = log_probs[np.arange(T), aligned]
    return aligned.astype(np.int64), scores.astype(np.float32)


def merge_tokens(aligned_tokens: np.ndarray, scores: np.ndarray, blank: int = 0) -> list[TokenSpan]:
    """Collapse a framewise alignment into per-token spans (consecutive equal
    non-blank frames merge; score = mean frame score over the span)."""
    spans: list[TokenSpan] = []
    T = len(aligned_tokens)
    t = 0
    while t < T:
        tok = int(aligned_tokens[t])
        if tok == blank:
            t += 1
            continue
        start = t
        while t < T and int(aligned_tokens[t]) == tok:
            t += 1
        spans.append(TokenSpan(token=tok, start=start, end=t,
                               score=float(np.mean(scores[start:t]))))
    return spans


def forced_align_torch(log_probs: torch.Tensor, targets, blank: int = 0):
    """The Viterbi of `forced_align` over a [T, C] float32 tensor on its
    device (the JAX package's `forced_align_jax`: float32 sums from -1e30,
    first-maximum ties, the back-trace on the device). Returns
    (aligned_tokens [T] int64, scores [T]) on the device."""
    dev = log_probs.device
    targets = torch.as_tensor(np.asarray(targets, dtype=np.int64).reshape(-1), device=dev)
    n = targets.shape[0]
    ext = torch.full((2 * n + 1,), blank, dtype=torch.int64, device=dev)
    ext[1::2] = targets
    S = ext.shape[0]
    can_skip = torch.zeros(S, dtype=torch.bool, device=dev)
    can_skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])

    emit = log_probs[:, ext]  # [T, S]
    T = emit.shape[0]
    neg = torch.full((2,), NEG_INF, dtype=emit.dtype, device=dev)
    alpha = torch.full((S,), NEG_INF, dtype=emit.dtype, device=dev)
    alpha[: min(S, 2)] = emit[0, : min(S, 2)]
    backptrs = torch.empty((max(T - 1, 0), S), dtype=torch.int64, device=dev)
    for t in range(1, T):
        prev1 = torch.cat([neg[:1], alpha[:-1]])
        prev2 = torch.where(can_skip, torch.cat([neg, alpha[:-2]])[:S], neg[0])
        best, choice = torch.stack([alpha, prev1, prev2]).max(dim=0)
        backptrs[t - 1] = choice
        alpha = best + emit[t]
    s = torch.where(alpha[S - 1] >= alpha[S - 2], S - 1, S - 2)
    states = torch.empty(T, dtype=torch.int64, device=dev)
    states[T - 1] = s
    for t in range(T - 2, -1, -1):
        s = s - backptrs[t, s]
        states[t] = s
    aligned = ext[states]
    scores = log_probs.gather(1, aligned[:, None])[:, 0]
    return aligned, scores
