"""Kernel K1's plain version (selfrec_tpu_torch.ops.dense_dual) against the
JAX package's Pallas kernel run in interpret mode on the CPU.

int8 operands accumulate exactly in int32 in both, so the outputs must be
EQUAL, not close. The CUDA kernel itself is held against the same plain
version on the card (tests/test_torch_isolation.py, marked ``cuda``, and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops import dense_dual as jax_dual
from selfrec_tpu_torch.ops import dense_dual


def _int8_case(u, i, d, seed, density=0.5):
    rng = np.random.default_rng(seed)
    b = (rng.random((u, i)) < density).astype(np.int8)
    xu = rng.integers(-127, 128, (u, d)).astype(np.int8)
    xi = rng.integers(-127, 128, (i, d)).astype(np.int8)
    return b, xu, xi


@pytest.mark.parametrize("u,i,d", [(70, 90, 16), (700, 1300, 64), (300, 450, 64)])
def test_plain_equals_pallas_interpret_int8(u, i, d):
    b, xu, xi = _int8_case(u, i, d, seed=u + i + d)
    ju, ji = jax_dual._dual_call(jnp.asarray(b), jnp.asarray(xu), jnp.asarray(xi),
                                 interpret=True)
    pu, pi = dense_dual.dual_matmul_plain(torch.from_numpy(b), torch.from_numpy(xu),
                                          torch.from_numpy(xi))
    assert pu.dtype == pi.dtype == torch.int32
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def test_plain_is_exact_at_extreme_operands():
    """Every product at +-127 and a fully dense column: the float64 route of
    the plain version still gives the exact int32 sum."""
    u, i, d = 257, 1031, 8
    b = np.ones((u, i), np.int8)
    xu = np.full((u, d), -127, np.int8)
    xi = np.full((i, d), 127, np.int8)
    xi[::2] = -127
    pu, pi = dense_dual.dual_matmul_plain(torch.from_numpy(b), torch.from_numpy(xu),
                                          torch.from_numpy(xi))
    np.testing.assert_array_equal(pu.numpy(), b.astype(np.int64) @ xi.astype(np.int64))
    np.testing.assert_array_equal(pi.numpy(), b.astype(np.int64).T @ xu.astype(np.int64))


def test_wrapper_on_cpu_takes_the_plain_version_without_counting():
    b, xu, xi = _int8_case(33, 47, 64, seed=9, density=0.2)
    tb, tu, ti = map(torch.from_numpy, (b, xu, xi))
    before = dense_dual.dual_matmul.launches
    ou, oi = dense_dual.dual_matmul(tb, tu, ti)
    pu, pi = dense_dual.dual_matmul_plain(tb, tu, ti)
    assert dense_dual.dual_matmul.launches == before
    assert torch.equal(ou, pu) and torch.equal(oi, pi)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device_mix"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    b, xu, xi = map(torch.from_numpy, _int8_case(8, 12, 16, seed=1))
    if bad == "dtype":
        with pytest.raises(TypeError):
            dense_dual.dual_matmul(b, xu.to(torch.bfloat16), xi)
    elif bad == "shape":
        with pytest.raises(ValueError):
            dense_dual.dual_matmul(b, xu[:, :8], xi)
    else:
        with pytest.raises(ValueError):
            dense_dual.dual_matmul(b, xu.to("meta"), xi)
