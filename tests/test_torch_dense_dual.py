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
    ou, oi = dense_dual.dual_matmul(tb, tu, ti, dense_dual.block_transpose(tb))
    pu, pi = dense_dual.dual_matmul_plain(tb, tu, ti)
    assert dense_dual.dual_matmul.launches == before
    assert torch.equal(ou, pu) and torch.equal(oi, pi)


@pytest.mark.parametrize("bad", ["dtype", "mixed_float", "float_block", "shape",
                                 "bt_shape", "device_mix"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    b, xu, xi = map(torch.from_numpy, _int8_case(8, 12, 16, seed=1))
    bt = dense_dual.block_transpose(b)
    if bad == "dtype":
        with pytest.raises(TypeError):
            dense_dual.dual_matmul(b, xu.to(torch.bfloat16), xi, bt)
    elif bad == "mixed_float":
        with pytest.raises(TypeError, match="one dtype"):
            dense_dual.dual_matmul(b, xu.to(torch.bfloat16), xi.float(), bt)
    elif bad == "float_block":
        with pytest.raises(TypeError):
            dense_dual.dual_matmul(b.float(), xu.float(), xi.float(), bt)
    elif bad == "bt_shape":
        with pytest.raises(ValueError, match="transpose"):
            dense_dual.dual_matmul(b, xu, xi, b)
    elif bad == "shape":
        with pytest.raises(ValueError):
            dense_dual.dual_matmul(b, xu[:, :8], xi, bt)
    else:
        with pytest.raises(ValueError):
            dense_dual.dual_matmul(b, xu.to("meta"), xi, bt)


# -- the float-operand variant -------------------------------------------------

FLOAT_SHAPES = [(70, 90, 16), (700, 1300, 64), (2500, 2100, 32)]
FLOAT_TOL = dict(rtol=1e-5, atol=1e-3)  # tests/test_dense_dual.py:31-34


def _float_case(u, i, d, seed, dtype):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, (u, i)).astype(np.int8)
    xu = rng.normal(size=(u, d)).astype(np.float32)
    xi = rng.normal(size=(i, d)).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values in both packages
        xu = torch.from_numpy(xu).to(torch.bfloat16).float().numpy()
        xi = torch.from_numpy(xi).to(torch.bfloat16).float().numpy()
    return b, xu, xi


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("u,i,d", FLOAT_SHAPES)
def test_float_plain_matches_pallas_interpret(u, i, d, dtype):
    """bf16 or f32 operands, f32 sums: the plain version against the TPU
    kernel in interpret mode, at the JAX test's shapes and tolerance."""
    b, xu, xi = _float_case(u, i, d, seed=u + d, dtype=dtype)
    ju, ji = jax_dual._dual_call(jnp.asarray(b), jnp.asarray(xu, dtype=dtype),
                                 jnp.asarray(xi, dtype=dtype), interpret=True)
    tdt = getattr(torch, dtype)
    tb = torch.from_numpy(b)
    pu, pi = dense_dual.dual_matmul(tb, torch.from_numpy(xu).to(tdt),
                                    torch.from_numpy(xi).to(tdt), dense_dual.block_transpose(tb))
    assert pu.dtype == pi.dtype == torch.float32
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), **FLOAT_TOL)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), **FLOAT_TOL)


@pytest.mark.parametrize("u,i,d", FLOAT_SHAPES)
def test_float_autograd_matches_jax_grad(u, i, d):
    """The autograd backward (the same dual product over the cotangents)
    against jax.grad of the JAX package's custom-VJP dual_matmul."""
    import jax

    b, xu, xi = _float_case(u, i, d, seed=3 * u + d, dtype="float32")
    rng = np.random.default_rng(7)
    wu = rng.normal(size=(u, d)).astype(np.float32)
    wi = rng.normal(size=(i, d)).astype(np.float32)

    def f_jax(xu, xi):
        ou, oi = jax_dual.dual_matmul(jnp.asarray(b), xu, xi, True)
        return jnp.sum(ou * wu) + jnp.sum(oi * wi)

    jgu, jgi = jax.grad(f_jax, argnums=(0, 1))(jnp.asarray(xu), jnp.asarray(xi))
    tu = torch.from_numpy(xu).requires_grad_(True)
    ti = torch.from_numpy(xi).requires_grad_(True)
    before = dense_dual.dual_matmul.float_launches
    tb = torch.from_numpy(b)
    ou, oi = dense_dual.dual_matmul(tb, tu, ti, dense_dual.block_transpose(tb))
    (torch.sum(ou * torch.from_numpy(wu)) + torch.sum(oi * torch.from_numpy(wi))).backward()
    assert dense_dual.dual_matmul.float_launches == before  # CPU: plain version
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(jgu), **FLOAT_TOL)
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(jgi), **FLOAT_TOL)


def test_bf16_backward_returns_bf16_gradients():
    """As the JAX VJP casts the cotangents to the operand dtype and back."""
    b, xu, xi = _float_case(40, 50, 16, seed=2, dtype="bfloat16")
    tu = torch.from_numpy(xu).to(torch.bfloat16).requires_grad_(True)
    ti = torch.from_numpy(xi).to(torch.bfloat16).requires_grad_(True)
    tb = torch.from_numpy(b)
    ou, oi = dense_dual.dual_matmul(tb, tu, ti, dense_dual.block_transpose(tb))
    (ou.sum() + 2 * oi.sum()).backward()
    assert tu.grad.dtype == ti.grad.dtype == torch.bfloat16
    bf = torch.from_numpy(b).double()
    # d/dxu of sum(B@xi) + 2 sum(B.T@xu) = 2 * B @ 1; d/dxi = B.T @ 1
    torch.testing.assert_close(tu.grad.double(), (2 * bf.sum(1, keepdim=True)).expand(40, 16))
    torch.testing.assert_close(ti.grad.double(), bf.sum(0)[:, None].expand(50, 16))


# -- operands as the kernels take them -------------------------------------------

@pytest.mark.parametrize("u,i", [(31, 47), (64, 128), (1, 17)])
def test_block_transpose_and_k_major_are_pitched_transposes(u, i):
    rng = np.random.default_rng(u * i)
    b = torch.from_numpy((rng.random((u, i)) < 0.4).astype(np.int8))
    bt = dense_dual.block_transpose(b)
    assert bt.shape == (i, u) and torch.equal(bt, b.T)
    assert bt.stride(1) == 1 and bt.stride(0) % 16 == 0 and bt.data_ptr() % 16 == 0
    x = torch.from_numpy(rng.integers(-127, 128, (u, 24)).astype(np.int8))
    xt = dense_dual.k_major(x)
    assert torch.equal(xt, x.T) and xt.stride(0) % 16 == 0
    # an unaligned block is copied to a pitched one, an aligned one is kept
    p = dense_dual._pitched(b)
    assert torch.equal(p, b) and p.stride(0) % 16 == 0
    assert (p.data_ptr() == b.data_ptr()) == (i % 16 == 0)


def test_int8_block_keeps_its_transpose_through_refactor_view(monkeypatch):
    """int8 blocks carry B.T for K1's item direction, and so do SGL's
    per-epoch dropped views; float-mode blocks do not need it."""
    from selfrec_tpu_torch.ops import spmm_dense

    rng = np.random.default_rng(5)
    nu, ni = 37, 53
    key = np.unique(rng.integers(0, nu * ni, 400))
    eu, ei = (key // ni).astype(np.int32), (key % ni).astype(np.int32)
    du, di = np.bincount(eu, minlength=nu), np.bincount(ei, minlength=ni)
    w = (1 / np.sqrt(du[eu] * di[ei])).astype(np.float32)
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "int8")
    adj = spmm_dense.dense_adj_from_edges(eu, ei, w, nu, ni, device="cpu")
    assert torch.equal(adj.a_iu, adj.a_ui.T)
    view = adj.refactor_view(torch.from_numpy(rng.random(len(eu)) < 0.8))
    assert torch.equal(view.a_iu, view.a_ui.T) and not torch.equal(view.a_ui, adj.a_ui)
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "float32")
    assert spmm_dense.dense_adj_from_edges(eu, ei, w, nu, ni, device="cpu").a_iu is None


def test_edge_index_check_names_the_bad_positions():
    from selfrec_tpu_torch.ops.spmm_dense import check_edge_index

    host = np.arange(10, dtype=np.int64)
    check_edge_index("edge_users", torch.from_numpy(host.copy()), host, 10)
    bad = host.copy()
    bad[[3, 7]] = [99, -1]
    with pytest.raises(RuntimeError, match=r"2 of 10 entries.*positions \[3, 7\]"):
        check_edge_index("edge_users", torch.from_numpy(bad), host, 10)
    with pytest.raises(RuntimeError, match=r"positions \[9\]"):
        check_edge_index("edge_items", torch.from_numpy(host.copy()), host, 9)
