"""The port's static-grid length regulator against the JAX package's:
integer results exactly, gathered features bit for bit."""

import numpy as np
import pytest
import torch

from zerovox_tpu.ops.length_regulator import length_regulate as jax_length_regulate

from zerovox_tpu_torch.ops.length_regulator import get_mask_from_lengths, length_regulate


@pytest.mark.parametrize("max_len,high", [(96, 5), (40, 6), (200, 1)])
def test_length_regulate_matches_jax(max_len, high):
    rng = np.random.default_rng(max_len)
    x = rng.normal(size=(3, 17, 8)).astype(np.float32)
    dur = rng.integers(0, high + 1, size=(3, 17)).astype(np.int32)
    dur[1, 9:] = 0  # padded phones
    dur[2] = 0  # an empty item
    f_j, len_j, mask_j = jax_length_regulate(x, dur, max_len)
    f, n, mask = length_regulate(torch.from_numpy(x), torch.from_numpy(dur), max_len)
    np.testing.assert_array_equal(n.numpy(), np.asarray(len_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_j))


def test_frames_repeat_each_phone_by_its_duration():
    x = torch.arange(4, dtype=torch.float32).reshape(1, 4, 1)
    f, n, mask = length_regulate(x, torch.tensor([[2, 0, 3, 1]]), 8)
    assert n.tolist() == [6]
    assert f[0, :, 0].tolist() == [0, 0, 2, 2, 2, 3, 0, 0]
    assert mask[0].tolist() == [False] * 6 + [True] * 2
    assert get_mask_from_lengths(torch.tensor([0, 2]), 3).tolist() == [
        [True, True, True], [False, False, True]]
