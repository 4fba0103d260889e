"""The port's static-shape ``unique_with_mask`` against the JAX package's
(``jnp.unique(idx, size=size, fill_value=-1)``, selfrec_tpu/ops/sampling.py:
187-196), exactly: the sorted distinct values (a -1 in ``idx`` counts as a
value) cut or filled with -1 to ``size``, the mask ``>= 0``, invalid slots
mapped to 0. The port computes it with a sort, a cumulative sum and a
scatter, with no device-to-host sync, so that a train step holding it can be
captured into a CUDA graph."""

import numpy as np
import pytest
import torch

from selfrec_tpu.ops.sampling import unique_with_mask as jax_unique
from selfrec_tpu_torch.ops.sampling import unique_with_mask

CASES = {
    # name: (seed, n, value range, share of -1 lanes, size)
    "duplicates": (0, 64, 20, 0.0, 64),
    "duplicates_with_pad_lanes": (1, 64, 30, 0.25, 64),
    "all_pad_lanes": (2, 16, 5, 1.0, 16),
    "all_distinct": (3, 50, None, 0.0, 50),
    "all_distinct_size_larger": (4, 50, None, 0.0, 80),
    "size_smaller_than_distinct": (5, 100, 1000, 0.1, 7),
    "size_larger_than_distinct": (6, 40, 8, 0.2, 33),
    "size_one": (7, 30, 10, 0.3, 1),
    "one_lane": (8, 1, 10, 0.0, 4),
    "int64_ids": (9, 200, 10**6, 0.05, 150),
}


def _idx(seed, n, hi, pad):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n * 3)[:n] if hi is None else rng.integers(0, hi, n)
    return np.where(rng.random(n) < pad, -1, idx).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_unique_equals_jax(case):
    seed, n, hi, pad, size = CASES[case]
    idx = _idx(seed, n, hi, pad)
    want_ids, want_mask = (np.asarray(a) for a in jax_unique(idx, size))
    dtype = torch.int64 if case == "int64_ids" else torch.int32
    got_ids, got_mask = unique_with_mask(torch.as_tensor(idx).to(dtype), size)
    assert got_ids.shape == (size,) and got_mask.dtype == torch.bool
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)


def test_empty_input_gives_only_fill():
    ids, mask = unique_with_mask(torch.zeros(0, dtype=torch.int64), 5)
    assert ids.tolist() == [0] * 5 and not mask.any()


def test_no_torch_unique_on_the_train_step_path():
    """The helper no longer calls torch.unique (a device-to-host sync that a
    CUDA graph cannot capture), and no model file does."""
    import inspect
    import pathlib

    from selfrec_tpu_torch.ops import sampling

    assert "torch.unique(" not in inspect.getsource(sampling.unique_with_mask)
    root = pathlib.Path(sampling.__file__).parents[1] / "models"
    assert not [p.name for p in root.rglob("*.py") if "torch.unique(" in p.read_text()]
