"""The port's halo exchange (``selfrec_tpu_torch.parallel.halo``) against
the JAX package's (``selfrec_tpu.parallel.halo``) on the same edges and
inputs: the host plan's arrays exactly, and on (1, 2), (2, 1) and (2, 2)
meshes the forward, the backward over the transpose plan and the packed
P = 3 form within 1e-5. The port runs in gloo process groups of CPU
processes (tests/_torch_dist_worker.py), K2 through its plain version; the
JAX package on this process's virtual CPU devices."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist_worker import DistGroup
from selfrec_tpu.parallel import halo as jhalo
from selfrec_tpu.parallel.mesh import build_mesh as jax_mesh
from selfrec_tpu_torch.parallel import halo

MESHES = [(1, 2), (2, 1), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def group():
    g = DistGroup(4)
    yield g
    g.close()


def graph(n_rows=37, n_cols=29, nnz=300, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_cols, nnz).astype(np.int32)
    dst = rng.integers(0, n_rows, nnz).astype(np.int32)
    dst[:20] = 3  # one long destination row: several virtual rows
    w = rng.uniform(0.1, 1.0, nnz).astype(np.float32)
    return src, dst, w, n_rows, n_cols


def _ranks(results):
    return [r for r in results if r is not None]


def jax_fwd_grad(f, x, g):
    """f(x) and the gradient of <f(x), g> from one jitted JAX program."""
    @jax.jit
    def both(xx, gg):
        out, pull = jax.vjp(f, xx)
        return out, pull(gg)[0]

    out, grad = both(jnp.asarray(x), jnp.asarray(g))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("shape", MESHES + [(4, 1), (1, 4)])
@pytest.mark.parametrize("k", [4, 16])
def test_plan_arrays_equal_jax(shape, k):
    src, dst, w, n_rows, n_cols = graph()
    mine = halo.build_halo_plan(src, dst, n_rows, n_cols, *shape, k=k)
    ref = jhalo.build_halo_plan(src, dst, n_rows, n_cols, *shape, k=k)
    for f in ("vidx", "vdst", "slot_edge", "send_idx"):
        np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(ref, f)), f)
    for f in ("n_rows", "n_cols", "r_dst", "r_src", "k", "h", "vmax", "n_edges"):
        assert getattr(mine, f) == getattr(ref, f), f


def _jax_adj(src, dst, w, n_rows, n_cols, shape):
    return jhalo.build_halo_adj(src, dst, w, n_rows, n_cols, jax_mesh(*shape), k=4)


@pytest.mark.parametrize("shape", MESHES)
def test_forward_and_backward_match_jax(group, shape):
    src, dst, w, n_rows, n_cols = graph()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n_cols, 8)).astype(np.float32)
    g = rng.standard_normal((n_rows, 8)).astype(np.float32)
    jadj = _jax_adj(src, dst, w, n_rows, n_cols, shape)
    ref, ref_grad = jax_fwd_grad(lambda xx: jhalo.halo_spmm(jadj, xx), x, g)
    res = _ranks(group.run("case_halo", shape=shape, src=src, dst=dst, w=w,
                           n_rows=n_rows, n_cols=n_cols, x=x, g=g))
    assert len(res) == shape[0] * shape[1]
    for r in res:
        np.testing.assert_allclose(r["out"], ref, **TOL)
        np.testing.assert_allclose(r["grad"], ref_grad, **TOL)
        assert (r["k2_fwd"], r["k2_bwd"]) == (1, 1)  # one K2 call a rank a direction


@pytest.mark.parametrize("shape", MESHES)
def test_packed_three_passes_match_jax(group, shape):
    src, dst, w, n_rows, n_cols = graph(seed=2)
    rng = np.random.default_rng(3)
    w_stack = np.stack([w, w * 0.5, rng.uniform(0, 1, len(w)).astype(np.float32)])
    x = rng.standard_normal((n_cols, 3 * 4)).astype(np.float32)
    g = rng.standard_normal((n_rows, 3 * 4)).astype(np.float32)
    jadj = _jax_adj(src, dst, w, n_rows, n_cols, shape)

    ref, ref_grad = jax_fwd_grad(
        lambda xx: jhalo.halo_spmm_packed(jadj, jnp.asarray(w_stack), xx, 3), x, g)
    for r in _ranks(group.run("case_halo", shape=shape, src=src, dst=dst, w=w,
                              n_rows=n_rows, n_cols=n_cols, x=x, g=g, w_stack=w_stack)):
        np.testing.assert_allclose(r["out"], ref, **TOL)
        np.testing.assert_allclose(r["grad"], ref_grad, **TOL)
        assert (r["k2_fwd"], r["k2_bwd"]) == (1, 1)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_bf16_compute_dtype_matches_jax(group, shape):
    from selfrec_tpu.ops import precision as jprec

    src, dst, w, n_rows, n_cols = graph(seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n_cols, 8)).astype(np.float32)
    g = rng.standard_normal((n_rows, 8)).astype(np.float32)
    jadj = _jax_adj(src, dst, w, n_rows, n_cols, shape)
    jprec.set_compute_dtype("bfloat16")
    try:
        ref = np.asarray(jax.jit(lambda xx: jhalo.halo_spmm(jadj, xx))(jnp.asarray(x)))
    finally:
        jprec.set_compute_dtype(None)
    for r in _ranks(group.run("case_halo", shape=shape, src=src, dst=dst, w=w,
                              n_rows=n_rows, n_cols=n_cols, x=x, g=g,
                              compute_dtype="bfloat16")):
        np.testing.assert_allclose(r["out"], ref, **TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_comm_bytes_match_jax(group, shape):
    src, dst, w, n_rows, n_cols = graph()
    x = np.zeros((n_cols, 8), np.float32)
    g = np.zeros((n_rows, 8), np.float32)
    jref = _jax_adj(src, dst, w, n_rows, n_cols, shape).comm_bytes(8)
    for r in _ranks(group.run("case_halo", shape=shape, src=src, dst=dst, w=w,
                              n_rows=n_rows, n_cols=n_cols, x=x, g=g)):
        for direction in ("fwd", "bwd"):
            mine = r["comm"][direction]
            assert {k: mine[k] for k in jref[direction]} == jref[direction]


@pytest.mark.parametrize("shape", MESHES)
def test_from_ell_and_dropout_views(group, shape):
    src, dst, w, n, _ = graph(n_rows=31, n_cols=31, seed=6)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    keep = rng.random(len(w)) > 0.3
    for r in _ranks(group.run("case_halo_views", shape=shape, src=src, dst=dst, w=w,
                              n_rows=n, x=x, keep=keep, rate=0.3)):
        np.testing.assert_allclose(r["from_ell"], r["ell"], **TOL)
        np.testing.assert_allclose(r["dropped"], r["dropped_ell"], **TOL)
        assert r["supports_packed"]
