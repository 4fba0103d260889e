"""The port's sharded dense block (``selfrec_tpu_torch.parallel.dense_shard``)
against the JAX package's (``selfrec_tpu.parallel.dense_shard``) on the same
edges and inputs: the host plan exactly; on (1, 2), (2, 1) and (2, 2) meshes
the forward and gradient in the f32 mode within 1e-5; in the int8 mode each
rank's quantized operands and scales exactly (JAX's per-device ones) and
the outputs within the f32 sum-order tolerance; ``reweight`` to bf16 and
``refactor_view`` staying int8; ``ShardedDenseMat``; one K1 call a rank a
propagation. The port runs in gloo process groups of CPU processes
(tests/_torch_dist_worker.py), K1 through its plain version."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist_worker import DistGroup
from selfrec_tpu.ops.spmm_dense import DenseMat as JaxDenseMat
from selfrec_tpu.ops.spmm_dense import _quant_per_channel as jax_quant
from selfrec_tpu.parallel import dense_shard as jds
from selfrec_tpu.parallel.mesh import build_mesh as jax_mesh
from selfrec_tpu_torch.parallel import dense_shard as ds
from selfrec_tpu_torch.parallel.mesh import build_mesh
from test_torch_halo import jax_fwd_grad

MESHES = [(1, 2), (2, 1), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
U, I, D = 37, 53, 8


@pytest.fixture(scope="module")
def group():
    g = DistGroup(4)
    yield g
    g.close()


def bipartite(n_users=U, n_items=I, nnz=400, seed=0):
    """Distinct edges with symmetric-normalized weights (the factored form)."""
    rng = np.random.default_rng(seed)
    eu = rng.integers(0, n_users, nnz)
    ei = rng.integers(0, n_items, nnz)
    _, idx = np.unique(eu.astype(np.int64) * n_items + ei, return_index=True)
    eu, ei = eu[idx].astype(np.int32), ei[idx].astype(np.int32)
    du = np.bincount(eu, minlength=n_users)
    di = np.bincount(ei, minlength=n_items)
    w = (1.0 / np.sqrt(np.maximum(du[eu] * di[ei], 1))).astype(np.float32)
    return eu, ei, w


def inputs(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((U + I, D)).astype(np.float32),
            rng.standard_normal((U + I, D)).astype(np.float32))


def _ranks(results):
    return [r for r in results if r is not None]


@pytest.mark.parametrize("shape", MESHES + [(4, 2), (1, 8)])
def test_plan_equals_jax(shape):
    eu, ei, w = bipartite()
    plan = ds.dense_plan(eu, ei, U, I, *shape)
    ref = jds.build_sharded_dense(eu, ei, w, U, I, jax_mesh(*shape))
    n = shape[0] * shape[1]
    for mine, theirs in ((plan.eu_dev, ref.eu_dev), (plan.ei_dev, ref.ei_dev),
                         (plan.eid_dev, ref.eid_dev)):
        np.testing.assert_array_equal(mine, np.asarray(theirs).reshape(n, -1))
    assert (plan.u_pad, plan.i_pad, plan.i_blk) == (ref.u_pad, ref.i_pad, ref.i_blk)


@pytest.mark.parametrize("shape", MESHES)
def test_f32_forward_and_grad_match_jax(group, shape, monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "float32")
    eu, ei, w = bipartite()
    x, g = inputs()
    jadj = jds.build_sharded_dense(eu, ei, w, U, I, jax_mesh(*shape))
    ref, ref_grad = jax_fwd_grad(lambda xx: jds.sharded_dense_spmm(jadj, xx), x, g)
    res = _ranks(group.run("case_dense", shape=shape, eu=eu, ei=ei, w=w, n_users=U,
                           n_items=I, x=x, g=g, dtype="float32"))
    assert len(res) == shape[0] * shape[1]
    for r in res:
        assert r["factored"] and r["b_dtype"] == "torch.int8" and r["bt_is_transpose"]
        np.testing.assert_allclose(r["out"], ref, **TOL)
        np.testing.assert_allclose(r["grad"], ref_grad, **TOL)
        assert r["k1_calls"] == 1  # one K1 call a rank a propagation
        d, s = r["coords"]
        np.testing.assert_array_equal(r["b"], np.asarray(jadj.b)[d, s].astype(np.float32))


@pytest.mark.parametrize("shape", MESHES)
def test_int8_local_operands_equal_jax(group, shape, monkeypatch):
    """Each rank quantizes its own operands (dense_shard.py:310-328): its
    int8 values and scales equal JAX's on that device's slices, and the
    output agrees with JAX's up to the order of its f32 sums."""
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "int8")
    eu, ei, w = bipartite(seed=2)
    x, g = inputs(seed=3)
    mesh = jax_mesh(*shape)
    jadj = jds.build_sharded_dense(eu, ei, w, U, I, mesh)
    ref, ref_grad = jax_fwd_grad(lambda xx: jds.sharded_dense_spmm(jadj, xx), x, g)
    xu = jnp.asarray(x[:U]) * (jadj.row_scale[:, None] * jadj.gain)
    xi = jnp.asarray(x[U:]) * jadj.col_scale[:, None]
    xu = jnp.pad(xu, ((0, jadj.u_pad - U), (0, 0)))
    xi = jnp.pad(xi, ((0, jadj.i_pad - I), (0, 0)))
    zq, zs = jax_quant(xu)
    res = _ranks(group.run("case_dense", shape=shape, eu=eu, ei=ei, w=w, n_users=U,
                           n_items=I, x=x, g=g, dtype="int8"))
    for r in res:
        d, s = r["coords"]
        start = s * (jadj.i_pad // shape[1]) + d * jadj.i_blk
        yq, ys = jax_quant(xi[start: start + jadj.i_blk])
        np.testing.assert_array_equal(r["zq"], np.asarray(zq))
        np.testing.assert_array_equal(r["zs"], np.asarray(zs))
        np.testing.assert_array_equal(r["yq"], np.asarray(yq))
        np.testing.assert_array_equal(r["ys"], np.asarray(ys))
        assert r["mm_dtype"] == "torch.int8" and r["k1_calls"] == 1
        np.testing.assert_allclose(r["out"], ref, **TOL)
        np.testing.assert_allclose(r["grad"], ref_grad, **TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_reweight_goes_to_float_and_refactor_stays_int8(group, shape, dtype, monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype)
    eu, ei, w = bipartite(seed=4)
    x, g = inputs(seed=5)
    keep = np.random.default_rng(6).random(len(w)) > 0.3
    w2 = (w * 1.7).astype(np.float32)
    jadj = jds.build_sharded_dense(eu, ei, w, U, I, jax_mesh(*shape))
    rw = jadj.reweight(jnp.asarray(w2))
    view_ref, rw_ref = map(np.asarray, jax.jit(lambda xx: (
        jds.sharded_dense_spmm(jadj.refactor_view(jnp.asarray(keep)), xx),
        jds.sharded_dense_spmm(rw, xx)))(jnp.asarray(x)))
    want = "torch.bfloat16" if dtype == "int8" else "torch.float32"
    for r in _ranks(group.run("case_dense", shape=shape, eu=eu, ei=ei, w=w, n_users=U,
                              n_items=I, x=x, g=g, dtype=dtype, keep=keep, w2=w2)):
        assert r["view_factored"] and r["view_mm_dtype"] == f"torch.{dtype}"
        assert r["reweight_dtype"] == (want, want) == (f"torch.{rw.b.dtype}",
                                                       f"torch.{rw.mm_dtype}")
        np.testing.assert_allclose(r["view"], view_ref, **TOL)
        np.testing.assert_allclose(r["reweight"], rw_ref, **TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_dense_mat_forward_and_grad_match_jax(group, shape, dtype):
    rng = np.random.default_rng(7)
    m, n = 23, 19  # rows not a multiple of the grid: padded
    a = (rng.random((m, n)) * (rng.random((m, n)) > 0.6)).astype(np.float32)
    x = rng.standard_normal((n, D)).astype(np.float32)
    g = rng.standard_normal((m, D)).astype(np.float32)
    dm = jds.shard_dense_mat(JaxDenseMat(jnp.asarray(a).astype(dtype)), jax_mesh(*shape))
    ref, ref_grad = jax_fwd_grad(lambda xx: jds.sharded_dense_mat_spmm(dm, xx), x, g)
    for r in _ranks(group.run("case_dense_mat", shape=shape, a=a, x=x, g=g, dtype=dtype)):
        np.testing.assert_allclose(r["out"], ref, **TOL)
        np.testing.assert_allclose(r["grad"], ref_grad, **TOL)
        assert r["rows"] == -(-m // (shape[0] * shape[1]))


@pytest.mark.parametrize("shape", MESHES)
def test_comm_bytes(group, shape, monkeypatch):
    """The sums and the item gather over data as the JAX package counts
    them; over model the port gathers both outputs in place of the user
    rows."""
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "float32")
    eu, ei, w = bipartite()
    x, g = inputs()
    jref = jds.build_sharded_dense(eu, ei, w, U, I, jax_mesh(*shape)).comm_bytes(D)
    nd, nm = shape
    for r in _ranks(group.run("case_dense", shape=shape, eu=eu, ei=ei, w=w, n_users=U,
                              n_items=I, x=x, g=g, dtype="float32")):
        mine = r["comm"]
        for key in ("psum_scatter_model", "psum_data", "all_gather_data"):
            assert mine[key] == jref[key]
        plan = ds.dense_plan(eu, ei, U, I, nd, nm)
        assert mine["all_gather_model"] == (plan.u_pad + plan.i_pad) * D * 4 * (nm - 1) // nm


@pytest.mark.parametrize("shape,budget,fits", [((1, 1), "7e-7", False), ((2, 2), "7e-7", True),
                                               ((1, 2), "7e-7", False)])
def test_budget_gate_matches_jax(shape, budget, fits, monkeypatch):
    """The per-rank gate (dense_shard.py:285-299) on a block whose slices
    fit the budget only over four ranks."""
    monkeypatch.setenv("SELFREC_TPU_DENSE_BUDGET_GB", budget)
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "int8")
    from selfrec_tpu_torch.parallel.mesh import Mesh

    n_users, n_items = 40, 40  # 1,600 B on one rank, 800 B on two, 400 B on four
    assert (n_users * n_items / (shape[0] * shape[1]) <= float(budget) * 1e9) == fits
    assert ds.fits_sharded_dense(n_users, n_items, Mesh(*shape)) == fits
    assert jds.fits_sharded_dense(n_users, n_items, jax_mesh(*shape)) == fits


def test_one_by_one_mesh_equals_the_single_device_block(monkeypatch):
    """Without a process group a 1x1 mesh is the whole block: the sharded
    layer equals DenseAdj's propagation (int8: exactly)."""
    import torch

    from selfrec_tpu_torch.ops.spmm_dense import dense_adj_from_edges, dense_spmm

    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "int8")
    eu, ei, w = bipartite(seed=8)
    x, _ = inputs(seed=9)
    adj = ds.build_sharded_dense(eu, ei, w, U, I, build_mesh(1, 1), device="cpu")
    single = dense_adj_from_edges(eu, ei, w, U, I, device="cpu")
    np.testing.assert_array_equal(ds.sharded_dense_spmm(adj, torch.tensor(x)).numpy(),
                                  dense_spmm(single, torch.tensor(x)).numpy())
