"""The ELL layout and kernel K2's plain version (selfrec_tpu_torch.ops.
spmm_ell, ops.ell_gather, ops.graph) against the JAX package on the same
numpy inputs.

Layouts (vidx, vdst, edge_slots) and scattered weights are integer or
copied values and must be EQUAL. Products and their gradients are f32 sums
of the same terms in another order (JAX: gather, einsum, segment_sum;
the port: K2's plain version, einsum and index_add_), held to rtol/atol
2e-5, the JAX package's own tolerance for its Pallas kernel
(tests/test_spmm_pallas.py). The renormalized weights are exact integer
degree counts through rsqrt, rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selfrec_tpu.ops import graph as jax_graph
from selfrec_tpu.ops import precision as jax_precision
from selfrec_tpu.ops import spmm_ell as jax_ell
from selfrec_tpu.ops.spmm_pallas import PallasEll
from selfrec_tpu_torch.ops import ell_gather
from selfrec_tpu_torch.ops import graph as t_graph
from selfrec_tpu_torch.ops import precision as t_precision
from selfrec_tpu_torch.ops import spmm_ell as t_ell

TOL = dict(rtol=2e-5, atol=2e-5)


def _graph(kind, n_rows=150, n_cols=90, nnz=1500, seed=0):
    """(src, dst, w): uniform destinations, or power-law ones where a few
    rows span many virtual rows; duplicate (dst, src) pairs removed."""
    rng = np.random.default_rng(seed)
    if kind == "power_law":
        p = 1.0 / np.arange(1, n_rows + 1)
        dst = rng.choice(n_rows, size=nnz, p=p / p.sum())
    else:
        dst = rng.integers(0, n_rows, nnz)
    src = rng.integers(0, n_cols, nnz)
    _, idx = np.unique(dst.astype(np.int64) * n_cols + src, return_index=True)
    w = rng.normal(size=len(idx)).astype(np.float32)
    return src[idx].astype(np.int32), dst[idx].astype(np.int32), w


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("kind", ["random", "power_law"])
@pytest.mark.parametrize("k", [4, 16])
def test_layout_and_weights_identical_to_jax(kind, k):
    src, dst, w = _graph(kind)
    jl, jorder = jax_ell.build_ell_layout(src, dst, 150, k=k)
    tl, torder = t_ell.build_ell_layout(src, dst, 150, k=k, device="cpu")
    np.testing.assert_array_equal(torder, jorder)
    for name in ("vidx", "vdst", "edge_slots"):
        got, ref = _np(getattr(tl, name)), np.asarray(getattr(jl, name))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    assert (tl.n_rows, tl.k) == (jl.n_rows, jl.k)
    # the row pointer the kernel reads delimits the same sorted vdst runs
    np.testing.assert_array_equal(
        _np(tl.row_ptr), np.searchsorted(np.asarray(jl.vdst), np.arange(151)))
    assert tl.n_src == src.max() + 1
    np.testing.assert_array_equal(_np(t_ell.ell_weights(tl, torch.from_numpy(w))),
                                  np.asarray(jax_ell.ell_weights(jl, jnp.asarray(w))))


def _values_and_grads(shape, k, d, seed):
    n_rows, n_cols = shape
    src, dst, w = _graph("power_law", n_rows, n_cols, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(n_cols, d)).astype(np.float32)
    wout = rng.normal(size=(n_rows, d)).astype(np.float32)
    jadj = jax_ell.ell_adj_from_edges(src, dst, w, n_rows, n_cols, k=k)
    tadj = t_ell.ell_adj_from_edges(src, dst, w, n_rows, n_cols, k=k, device="cpu")
    return jadj, tadj, x, wout


@pytest.mark.parametrize("shape", [(150, 150), (150, 90)])
@pytest.mark.parametrize("k", [4, 16])
def test_ell_spmm_values_and_grads_match_jax(shape, k):
    jadj, tadj, x, wout = _values_and_grads(shape, k, 24, seed=k)
    jg = jax.grad(lambda x: jnp.sum(jax_ell.ell_spmm(jadj, x) * wout))(jnp.asarray(x))
    jo = np.asarray(jax_ell.ell_spmm(jadj, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    to = t_ell.ell_spmm(tadj, xt)
    torch.sum(to * torch.from_numpy(wout)).backward()
    assert to.dtype == torch.float32 and to.shape == (shape[0], 24)
    np.testing.assert_allclose(_np(to), jo, **TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jg), **TOL)


@pytest.mark.parametrize("form", ["stack", "prebuilt"])
def test_ell_spmm_packed_matches_jax_with_zero_weight_grad(monkeypatch, form):
    """The packed product from a (P, E) weight stack, which the call
    scatters (the forward's block in the forward, the backward's in the
    backward, only the first under no_grad), and from the slot weights
    built beforehand, which it reads as they are: one block per layout
    either way, the same values as JAX, and a zero gradient for the
    stack."""
    n, p, d = 150, 3, 16
    src, dst, _ = _graph("power_law", n, n, seed=4)
    rng = np.random.default_rng(5)
    w_stack = rng.uniform(0.1, 1.0, size=(p, len(src))).astype(np.float32)
    w_stack[1, ::3] = 0.0  # dropped edges of one view
    x = rng.normal(size=(n, p * d)).astype(np.float32)
    wout = rng.normal(size=(n, p * d)).astype(np.float32)
    jadj = jax_ell.ell_adj_from_edges(src, dst, np.ones(len(src)), n, k=16)
    tadj = t_ell.ell_adj_from_edges(src, dst, np.ones(len(src)), n, k=16, device="cpu")

    def jloss(ws, x):
        return jnp.sum(jax_ell.ell_spmm_packed(jadj, ws, x, p) * wout)

    jo = np.asarray(jax_ell.ell_spmm_packed(jadj, jnp.asarray(w_stack), jnp.asarray(x), p))
    jgw, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w_stack), jnp.asarray(x))
    assert t_graph.supports_packed(tadj) and jax_graph.supports_packed(jadj)
    wt = torch.from_numpy(w_stack).requires_grad_(True)
    want = [t_ell.ell_weights(layout, wt.detach()) for layout in (tadj.fwd, tadj.bwd)]
    scattered = []  # the layouts that ell_weights scatters onto, in order

    def counted(layout, edge_w, scatter=t_ell.ell_weights):
        scattered.append(layout)
        return scatter(layout, edge_w)

    monkeypatch.setattr(t_ell, "ell_weights", counted)
    w = wt
    if form == "prebuilt":
        w = t_ell.packed_slot_weights(tadj, wt)
        for got, ref in zip(w, want):
            assert torch.equal(got, ref)
        assert w.fwd.shape != w.bwd.shape  # V of the transpose differs
    xt = torch.from_numpy(x).requires_grad_(True)
    to = t_graph.spmm_packed(tadj, w, xt, p)
    torch.sum(to * torch.from_numpy(wout)).backward()
    assert len(scattered) == 2
    assert scattered[0] is tadj.fwd and scattered[1] is tadj.bwd
    with torch.no_grad():
        assert torch.equal(t_graph.spmm_packed(tadj, w, xt, p), to.detach())
    assert len(scattered) == (3 if form == "stack" else 2)
    np.testing.assert_allclose(_np(to), jo, **TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), **TOL)
    assert not np.any(np.asarray(jgw)) and not torch.any(wt.grad)
    # each pass equals a single-pass product with that pass's weights
    for i in range(p):
        single = t_ell.ell_spmm(tadj.reweight(torch.from_numpy(w_stack[i])),
                                torch.from_numpy(x[:, i * d:(i + 1) * d]))
        np.testing.assert_allclose(_np(to[:, i * d:(i + 1) * d]), _np(single), **TOL)


@pytest.mark.parametrize("k", [4, 16])
def test_k2_plain_matches_pallas_interpret(k):
    """The plain version against the TPU kernel itself, in interpret mode
    with a small tile (as tests/test_spmm_pallas.py runs it)."""
    n_rows, n_cols, d = 90, 70, 64
    src, dst, w = _graph("power_law", n_rows, n_cols, nnz=600, seed=k)
    x = np.random.default_rng(1).normal(size=(n_cols, d)).astype(np.float32)
    jl, _ = jax_ell.build_ell_layout(src, dst, n_rows, k=k)
    want = np.asarray(PallasEll(jl, jax_ell.ell_weights(jl, jnp.asarray(w)),
                                tile_v=32).apply(jnp.asarray(x), interpret=True))
    tl, _ = t_ell.build_ell_layout(src, dst, n_rows, k=k, device="cpu")
    tw = t_ell.ell_weights(tl, torch.from_numpy(w))[None]
    got = ell_gather.ell_gather_sum(tl, tw, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want, **TOL)
    # rows with no edge come out zero, as in the segment-sum
    empty = np.setdiff1d(np.arange(n_rows), dst)
    assert len(empty) and not np.any(_np(got)[empty])


def test_probe_gather_is_k2_with_one_unit_slot():
    """scripts/probe_mosaic_gather.py's row gather (n 256, D 128) as K2 with
    K = 1 and unit weights: exactly table[idx]."""
    n, d = 256, 128
    table = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, n, size=n).astype(np.int32)
    layout, _ = t_ell.build_ell_layout(idx, np.arange(n, dtype=np.int32), n, k=1,
                                       device="cpu")
    got = ell_gather.ell_gather_sum(layout, torch.ones((1, n, 1)),
                                    torch.from_numpy(table))
    np.testing.assert_array_equal(_np(got), table[idx])


@pytest.fixture
def bf16_compute():
    jax_precision.set_compute_dtype("bfloat16")
    t_precision.set_compute_dtype("bfloat16")
    try:
        yield
    finally:
        jax_precision.set_compute_dtype("float32")
        t_precision.set_compute_dtype("float32")


def test_bf16_compute_dtype_matches_jax(bf16_compute):
    """Under compute.dtype bfloat16 both packages round the rows and the
    weights to bf16 and sum exact f32 products; f32 output."""
    jadj, tadj, x, _ = _values_and_grads((150, 150), 16, 32, seed=9)
    jo = np.asarray(jax_ell.ell_spmm(jadj, jnp.asarray(x)))
    to = t_ell.ell_spmm(tadj, torch.from_numpy(x))
    assert to.dtype == torch.float32
    np.testing.assert_allclose(_np(to), jo, **TOL)
    t_precision.set_compute_dtype("float32")
    assert not np.allclose(_np(t_ell.ell_spmm(tadj, torch.from_numpy(x))), jo,
                           rtol=1e-6, atol=1e-6)


def _bipartite(n_users=40, n_items=60, seed=2):
    rng = np.random.default_rng(seed)
    eu = np.repeat(np.arange(n_users), 5)
    ei = rng.integers(0, n_items, len(eu))
    key = np.unique(eu.astype(np.int64) * n_items + ei)
    return (key // n_items).astype(np.int32), (key % n_items).astype(np.int32)


def test_bipartite_renorm_weights_and_template_match_jax():
    nu, ni = 40, 60
    eu, ei = _bipartite(nu, ni)
    keep = np.random.default_rng(3).random(len(eu)) < 0.9
    jw = np.asarray(jax_graph.bipartite_renorm_weights(
        jnp.asarray(eu), jnp.asarray(ei), jnp.asarray(keep), nu, ni))
    tw = t_graph.bipartite_renorm_weights(torch.from_numpy(eu), torch.from_numpy(ei),
                                          torch.from_numpy(keep), nu, ni)
    np.testing.assert_allclose(_np(tw), jw, rtol=1e-6, atol=0)
    assert not np.any(_np(tw)[: len(eu)][~keep])
    jt = jax_graph.build_bipartite_ell_template(eu, ei, nu, ni)
    tt = t_graph.build_bipartite_ell_template(eu, ei, nu, ni, device="cpu")
    for jl, tl in ((jt.fwd, tt.fwd), (jt.bwd, tt.bwd)):
        assert tl.k == jl.k == 16
        for name in ("vidx", "vdst", "edge_slots"):
            np.testing.assert_array_equal(_np(getattr(tl, name)),
                                          np.asarray(getattr(jl, name)))
    # reweighted by the clean weights, the template propagates like norm_adj
    x = np.random.default_rng(4).normal(size=(nu + ni, 8)).astype(np.float32)
    full = t_graph.bipartite_renorm_weights(
        torch.from_numpy(eu), torch.from_numpy(ei), torch.ones(len(eu), dtype=torch.bool),
        nu, ni)
    jfull = jax_graph.bipartite_renorm_weights(
        jnp.asarray(eu), jnp.asarray(ei), jnp.ones(len(eu), bool), nu, ni)
    np.testing.assert_allclose(
        _np(t_ell.ell_spmm(tt.reweight(full), torch.from_numpy(x))),
        np.asarray(jax_ell.ell_spmm(jt.reweight(jfull), jnp.asarray(x))), **TOL)


# -- K2's work items ---------------------------------------------------------------

def _sum_over_work_items(layout, w, x):
    """The kernel's order of work: each virtual row's weighted gather, each
    item's sum of its virtual rows, short rows' items written into their
    rows and long rows' partial slots added into theirs."""
    p, v, k = w.shape
    c = x.shape[1]
    g = x[layout.vidx].reshape(v, k, p, c // p).to(torch.float32)
    per_vrow = torch.einsum("pvk,vkpd->vpd", w, g).reshape(v, c)
    n_items = layout.item_dst.shape[0]
    item_of = torch.repeat_interleave(torch.arange(n_items),
                                      torch.diff(layout.item_ptr).long())
    items = torch.zeros((n_items, c)).index_add_(0, item_of, per_vrow)
    out = torch.zeros((layout.n_rows, c))
    direct = layout.item_dst >= 0
    out[layout.item_dst[direct].long()] = items[direct]
    long_of = torch.repeat_interleave(layout.long_rows.long(),
                                      torch.diff(layout.long_ptr).long())
    return out.index_add_(0, long_of, items[~direct])


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("kind", ["random", "power_law"])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_row_work_covers_every_virtual_row_once_in_order(monkeypatch, kind, k, chunk):
    monkeypatch.setattr(t_ell, "ROW_CHUNK", chunk)
    src, dst, _ = _graph(kind, n_rows=150, n_cols=90, nnz=2500, seed=k + chunk)
    layout, _ = t_ell.build_ell_layout(src, dst, 150, k=k, device="cpu")
    row_ptr = _np(layout.row_ptr)
    item_ptr, item_dst, long_rows, long_ptr = t_ell.row_work(row_ptr)
    v = row_ptr[-1]
    # items tile [0, V) in order: contiguous, non-decreasing, none too long
    assert item_ptr[0] == 0 and item_ptr[-1] == v
    sizes = np.diff(item_ptr)
    assert np.all(sizes >= 0) and np.all(sizes <= chunk)
    nv = np.diff(row_ptr)
    assert np.array_equal(long_rows, np.nonzero(nv > chunk)[0])
    direct = item_dst >= 0
    # every short row is one item writing the row, over exactly its run
    short = np.nonzero(nv <= chunk)[0]
    assert np.array_equal(item_dst[direct], short)
    np.testing.assert_array_equal(item_ptr[:-1][direct], row_ptr[short])
    np.testing.assert_array_equal(item_ptr[1:][direct], row_ptr[short + 1])
    # long rows' items write partial slots 0, 1, 2, ... in item order, and
    # each long row adds its own contiguous slots, which cover its run
    slots = ~item_dst[~direct]
    np.testing.assert_array_equal(slots, np.arange(len(slots)))
    assert long_ptr[0] == 0 and long_ptr[-1] == len(slots)
    starts = item_ptr[:-1][~direct]
    ends = item_ptr[1:][~direct]
    for t, r in enumerate(long_rows):
        s0, s1 = long_ptr[t], long_ptr[t + 1]
        assert starts[s0] == row_ptr[r] and ends[s1 - 1] == row_ptr[r + 1]
        np.testing.assert_array_equal(starts[s0 + 1:s1], ends[s0:s1 - 1])
    # the layout carries the same items
    for name, got in zip(("item_ptr", "item_dst", "long_rows", "long_ptr"),
                         (item_ptr, item_dst, long_rows, long_ptr)):
        np.testing.assert_array_equal(_np(getattr(layout, name)), got)


@pytest.mark.parametrize("kind", ["random", "power_law"])
@pytest.mark.parametrize("k,p", [(1, 1), (4, 3), (16, 1), (16, 3)])
def test_sum_over_work_items_equals_the_plain_and_jax(kind, k, p):
    """Summing in the kernel's order of work items gives K2's plain version
    (per virtual row, independent of the items) and the JAX package's ELL
    product, pass by pass."""
    n_rows, n_cols, d = 150, 400, 8
    src, dst, _ = _graph(kind, n_rows, n_cols, nnz=3000, seed=11 * k + p)
    rng = np.random.default_rng(k + p)
    # row 0 owns 10 * k distinct sources: more than ROW_CHUNK virtual rows
    heavy = rng.choice(n_cols, size=10 * k, replace=False).astype(np.int32)
    keep = dst != 0
    src = np.concatenate([heavy, src[keep]])
    dst = np.concatenate([np.zeros(10 * k, np.int32), dst[keep]])
    w_edges = rng.normal(size=(p, len(src))).astype(np.float32)
    x = rng.normal(size=(n_cols, p * d)).astype(np.float32)
    layout, _ = t_ell.build_ell_layout(src, dst, n_rows, k=k, device="cpu")
    assert len(layout.long_rows) > 0  # the skewed rows take the long path
    w = t_ell.ell_weights(layout, torch.from_numpy(w_edges))
    got = _sum_over_work_items(layout, w, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(ell_gather.ell_gather_sum(
        layout, w, torch.from_numpy(x))), **TOL)
    for i in range(p):
        jadj = jax_ell.ell_adj_from_edges(src, dst, w_edges[i], n_rows, n_cols, k=k)
        want = np.asarray(jax_ell.ell_spmm(jadj, jnp.asarray(x[:, i * d:(i + 1) * d])))
        np.testing.assert_allclose(_np(got[:, i * d:(i + 1) * d]), want, **TOL)
    # rows with no edge come out zero
    empty = np.setdiff1d(np.arange(n_rows), dst)
    assert not np.any(_np(got)[empty])
