"""Static-shape length regulation.

Each phone feature is expanded `duration[i]` times into a fixed
`max_mel_len` frame grid by a compare-and-count gather, as in the JAX
package:

    ends[i]   = cumsum(durations)[i]          (end frame of phone i)
    phone(t)  = #{i : ends[i] <= t}           (frame t -> source phone index)
    out[t]    = x[phone(t)]                   (gather)
    mask[t]   = t >= sum(durations)           (tail padding)
"""

from __future__ import annotations

import torch


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask, True at padded positions."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids >= lengths[:, None]


def length_regulate(x: torch.Tensor, durations: torch.Tensor, max_mel_len: int):
    """Expand phone features [B, L, H] by int durations [B, L] (0 on padded
    phones) into [B, max_mel_len, H].

    Returns (frames with zeros past each item's mel_len, mel_len [B] int32
    clamped to max_mel_len, mel_mask [B, T] True at padded frames)."""
    durations = durations.to(torch.int32)
    ends = torch.cumsum(durations, dim=1, dtype=torch.int32)  # [B, L]
    mel_len = torch.clamp(ends[:, -1], max=max_mel_len)

    t = torch.arange(max_mel_len, dtype=torch.int32, device=x.device)
    idx = (ends[:, None, :] <= t[None, :, None]).sum(dim=-1)  # [B, T]
    idx = torch.clamp(idx, max=x.shape[1] - 1)

    frames = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    mel_mask = get_mask_from_lengths(mel_len, max_mel_len)
    frames = frames.masked_fill(mel_mask[..., None], 0.0)
    return frames, mel_len, mel_mask
