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
    before = dense_dual.float_products.launches
    tb = torch.from_numpy(b)
    ou, oi = dense_dual.dual_matmul(tb, tu, ti, dense_dual.block_transpose(tb))
    (torch.sum(ou * torch.from_numpy(wu)) + torch.sum(oi * torch.from_numpy(wi))).backward()
    assert dense_dual.float_products.launches == before  # CPU: plain version
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
    per-epoch dropped views; factored float-mode blocks run K1's float
    kernel and carry it too, with no copy of B in the matmul dtype, and a
    generic value block carries none."""
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
    for dtype in ("float32", "bfloat16"):
        monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype)
        fadj = spmm_dense.dense_adj_from_edges(eu, ei, w, nu, ni, device="cpu")
        assert fadj.factored and fadj.mm_dtype == getattr(torch, dtype)
        assert torch.equal(fadj.a_iu, fadj.a_ui.T) and not hasattr(fadj, "a_mm")
    generic = spmm_dense.dense_adj_from_edges(eu, ei, w, nu, ni, dtype=torch.float32,
                                              device="cpu")
    assert not generic.factored and generic.a_iu is None


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


# -- any width: the wrapper's plan and operands, through the kernels' arithmetic --

def _fragment_order():
    """Contraction index a float-kernel thread reads at each position of
    16: the 32-bit word of thread t holds B's bytes 4t..4t+3, which the
    `wgmma` A fragment takes as indices 2t, 2t+1, 2t+8, 2t+9 (the m64k16
    bf16 register layout), so position 2t + j + 8h reads byte 4t + 2h + j."""
    order = np.empty(16, np.int64)
    for t in range(4):
        for h in range(2):
            for j in range(2):
                order[8 * h + 2 * t + j] = 4 * t + 2 * h + j
    return order


def _emulate_kernels(b, xu, xi):
    """What the CUDA kernels compute, on the CPU, from the operands the
    wrapper prepares for them (:func:`width_plan`, :func:`k_major`,
    :func:`float_operand`): per chunk, B (the float kernel: its bytes in
    fragment order) times the chunk's K-major operand rows; int8 sums
    exact, float sums in f32 with one sum per f32 piece, added smallest
    first."""
    d = xu.shape[1]
    outs = []
    for a, x in ((b, xi), (b.T, xu)):
        if x.dtype == torch.int8:
            plan = dense_dual.width_plan(d)
            xt = dense_dual.k_major(torch.nn.functional.pad(x, (0, plan.x_width - d)))
            chunks = [a.double() @ xt[c * plan.n:(c + 1) * plan.n].double().T
                      for c in range(plan.chunks)]
            outs.append(torch.cat(chunks, 1).to(torch.int32)[:, :d])
            continue
        plan = dense_dual.width_plan(d, 3 if x.dtype == torch.float32 else 1)
        xt = dense_dual.float_operand(x, plan)
        n_pad = xt.shape[1]
        a_pad = torch.nn.functional.pad(a, (0, n_pad - a.shape[1]))
        idx = (np.arange(0, n_pad, 16)[:, None] + _fragment_order()[None]).reshape(-1)
        a_frag = a_pad[:, torch.from_numpy(idx)].float()
        cols = []
        for c in range(plan.chunks):
            s = a_frag @ xt[c * plan.n:(c + 1) * plan.n].float().T  # f32 sums
            if plan.pieces == 3:
                s = (s[:, 128:] * 2.0 ** -16 + s[:, 64:128] * 2.0 ** -8) + s[:, :64]
            cols.append(s)
        outs.append(torch.cat(cols, 1)[:, :d])
    return tuple(outs)


@pytest.mark.parametrize("d", [8, 32, 100, 200])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_width_plan_matches_pallas_interpret(dtype, d):
    """Any D: the kernels' arithmetic over the wrapper's padded, chunked
    (and, for floats, permuted and split) operands against the TPU kernel
    in interpret mode, which pads D itself. int8 exact; floats at the JAX
    test's tolerance."""
    u, i = 70, 150
    if dtype == "int8":
        b, xu, xi = _int8_case(u, i, d, seed=d)
    else:
        b, xu, xi = _float_case(u, i, d, seed=d, dtype=dtype)
    ju, ji = jax_dual._dual_call(jnp.asarray(b), jnp.asarray(xu, dtype=dtype),
                                 jnp.asarray(xi, dtype=dtype), interpret=True)
    tdt = getattr(torch, dtype)
    eu, ei = _emulate_kernels(torch.from_numpy(b), torch.from_numpy(xu).to(tdt),
                              torch.from_numpy(xi).to(tdt))
    assert eu.shape == (u, d) and ei.shape == (i, d)
    if dtype == "int8":
        np.testing.assert_array_equal(eu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(ei.numpy(), np.asarray(ji))
    else:
        np.testing.assert_allclose(eu.numpy(), np.asarray(ju), **FLOAT_TOL)
        np.testing.assert_allclose(ei.numpy(), np.asarray(ji), **FLOAT_TOL)


@pytest.mark.parametrize("d,plan", [(1, (64, 1, 1)), (64, (64, 1, 1)), (100, (128, 1, 1)),
                                    (192, (192, 1, 1)), (200, (128, 2, 1)),
                                    (320, (192, 2, 1))])
def test_width_plan_pads_to_64_and_chunks_at_most_192(d, plan):
    p = dense_dual.width_plan(d)
    assert tuple(p) == plan and p.out_width >= d and p.out_width - d < 64 * p.chunks
    f = dense_dual.width_plan(d, 3)
    assert (f.n, f.chunks) == (192, -(-d // 64)) and f.out_width == 64 * f.chunks
    with pytest.raises(ValueError):
        dense_dual.width_plan(0)


def _awkward_f32(seed):
    """Normal values over many magnitudes, +-0, subnormals, the smallest
    normal, values near the largest finite f32 and residuals that cross
    bf16's subnormal range."""
    rng = np.random.default_rng(seed)
    fin = np.finfo(np.float32)
    special = np.array([0.0, -0.0, fin.tiny, -fin.tiny, fin.max, -fin.max, fin.smallest_subnormal,
                        -fin.smallest_subnormal, 3 * fin.smallest_subnormal, 1.0, -1.0,
                        1 + fin.eps, 2.0 ** -120 * (1 + 2 * fin.eps)], np.float32)
    mags = rng.normal(size=4000) * np.exp2(rng.integers(-149, 127, 4000).astype(np.float64))
    sub = (rng.integers(-2 ** 23 + 1, 2 ** 23, 500) * fin.smallest_subnormal.astype(
        np.float64))
    big = rng.uniform(-1, 1, 500) * float(fin.max)
    x = np.concatenate([special, mags.astype(np.float32), sub.astype(np.float32),
                        big.astype(np.float32)])
    return x[np.isfinite(x)].astype(np.float32)


def test_split_f32_pieces_add_up_exactly():
    x = torch.from_numpy(_awkward_f32(0))
    hi, mid, lo = dense_dual.split_f32(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert all(bool(torch.isfinite(p).all()) for p in (hi, mid, lo))
    total = hi.double() + mid.double() * 2.0 ** -8 + lo.double() * 2.0 ** -16
    assert torch.equal(total, x.double()), int((total != x.double()).sum())
    # the sign of zero is kept in the largest piece
    assert torch.equal(torch.signbit(hi[:2]), torch.tensor([False, True]))


def test_split_f32_pieces_in_the_operand():
    """float_operand lays the pieces out side by side in groups of 64
    columns, with zero rows and columns past n and D."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(37, 100)).astype(np.float32))
    plan = dense_dual.width_plan(100, 3)
    op = dense_dual.float_operand(x, plan)
    assert op.shape == (plan.x_width, 128) and op.dtype == torch.bfloat16 and op.is_contiguous()
    inv = np.argsort(np.concatenate([16 * q + _fragment_order() for q in range(8)]))
    w = op[:, torch.from_numpy(inv)].T.double()  # (128, 3 * 128), contraction order restored
    pieces = w.view(128, 2, 3, 64)
    total = pieces[:, :, 0] + pieces[:, :, 1] * 2.0 ** -8 + pieces[:, :, 2] * 2.0 ** -16
    torch.testing.assert_close(total.reshape(128, 128)[:37, :100], x.double(), rtol=0, atol=0)
    assert not bool(total.reshape(128, 128)[37:].any() | total.reshape(128, 128)[:, 100:].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_sums_are_within_1e5_of_the_f32_product(dtype):
    """The kernel's method (bf16 pieces, one f32 sum a piece, added
    smallest first) against the correctly rounded product, relative to
    each output row's magnitude, at a contraction as long as yelp2018's
    block rows hold on average and more."""
    rng = np.random.default_rng(8)
    u, i, d = 64, 4000, 64
    b = (rng.random((u, i)) < 0.5).astype(np.int8)
    xu = rng.normal(size=(u, d)).astype(np.float32)
    xi = rng.normal(size=(i, d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tb = torch.from_numpy(b)
    tu, ti = torch.from_numpy(xu).to(tdt), torch.from_numpy(xi).to(tdt)
    eu, ei = _emulate_kernels(tb, tu, ti)
    for got, a, x in ((eu, tb, ti), (ei, tb.T, tu)):
        ref = a.double() @ x.double()
        scale = a.double() @ x.double().abs()
        assert float(((got.double() - ref).abs() / scale).max()) < 1e-5
