"""The PyTorch port (selfrec_tpu_torch) and chip_smoke.py stand alone: they
import neither JAX nor the JAX package, and the registry, device and kernel
wrappers refuse what the port does not do instead of falling back."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import selfrec_tpu_torch
from selfrec_tpu_torch import device as device_lib
from selfrec_tpu_torch.models import MODEL_REGISTRY, get_model_class
from selfrec_tpu_torch.ops import cuda_build, dense_dual, ell_gather, rank_topk
from selfrec_tpu_torch.ops.spmm_ell import build_ell_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "selfrec_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "selfrec_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="selfrec_tpu_torch.") if not m.name.endswith("__main__"))


def _port_sources():
    for root, _dirs, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_importing_every_module_loads_no_jax():
    mods = _port_modules() + ["selfrec_tpu_torch.__main__"]
    assert {"selfrec_tpu_torch.ops.dense_dual", "selfrec_tpu_torch.ops.ell_gather",
            "selfrec_tpu_torch.models.graph.sgl", "selfrec_tpu_torch.ops.kmeans",
            "selfrec_tpu_torch.models.graph.ncl", "selfrec_tpu_torch.models.graph.buir",
            "selfrec_tpu_torch.models.graph.selfcf",
            "selfrec_tpu_torch.models.graph.ssl4rec", "selfrec_tpu_torch.models.graph.mhcn",
            "selfrec_tpu_torch.models.graph.sept", "selfrec_tpu_torch.data.motifs",
            "selfrec_tpu_torch.data.social", "selfrec_tpu_torch.data.sequence",
            "selfrec_tpu_torch.data.augmentor", "selfrec_tpu_torch.utils.similarity",
            "selfrec_tpu_torch.ops.seq_sampling", "selfrec_tpu_torch.ops.transformer",
            "selfrec_tpu_torch.models.sequential.sasrec",
            "selfrec_tpu_torch.models.sequential.cl4srec",
            "selfrec_tpu_torch.models.sequential.bert4rec"} <= set(mods)
    code = (
        "import sys, importlib, importlib.util, runpy\n"
        f"for m in {mods!r}:\n"
        "    if m.endswith('__main__'):\n"
        "        importlib.util.find_spec(m)\n"
        "    else:\n"
        "        importlib.import_module(m)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(_port_sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_registry_lists_every_model_and_refuses_unported():
    """All 18 models of the JAX package resolve to classes of the port, the
    sequential ones under models.sequential; an unknown name raises."""
    from selfrec_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY) and len(MODEL_REGISTRY) == 18
    for name, (_, _, kind) in JAX_REGISTRY.items():
        cls = get_model_class(name)
        assert cls.__name__ == name
        assert cls.__module__.startswith(f"selfrec_tpu_torch.models.{kind}.")
        assert MODEL_REGISTRY[name][2] == kind
    with pytest.raises(KeyError):
        get_model_class("NoSuchModel")


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_lib.resolve_device(None)
    with pytest.raises(RuntimeError):
        device_lib.resolve_device("cuda")
    assert device_lib.resolve_device("cpu") == torch.device("cpu")


def test_dual_matmul_wrapper_checks_and_counts_only_launches():
    b = torch.ones((4, 5), dtype=torch.int8)
    xu = torch.ones((4, 8), dtype=torch.int8)
    xi = torch.ones((5, 8), dtype=torch.int8)
    bt = dense_dual.block_transpose(b)
    before = dense_dual.dual_matmul.launches
    ou, oi = dense_dual.dual_matmul(b, xu, xi, bt)
    assert dense_dual.dual_matmul.launches == before  # CPU: plain version
    assert ou.dtype == torch.int32 and torch.all(ou == 5)
    assert oi.dtype == torch.int32 and torch.all(oi == 4)
    with pytest.raises(TypeError, match="one dtype"):
        dense_dual.dual_matmul(b, xu.float(), xi, bt)
    with pytest.raises(ValueError):
        dense_dual.dual_matmul(b, xi, xu, bt)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA (this machine) the script exits non-zero and prints no
    result line."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_build_dir_is_ignored_by_git():
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    rel = os.path.relpath(cuda_build.build_dir(), REPO).split(os.sep)[0]
    assert f"/{rel}/" in ignored


def _ragged_layout(k, device, n_rows=300, n_src=200, seed=0):
    """A random layout where row 0 spans many virtual rows."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(40 * k, np.int32),
                          rng.integers(1, n_rows, 2000).astype(np.int32)])
    src = rng.integers(0, n_src, len(dst)).astype(np.int32)
    layout, _ = build_ell_layout(src, dst, n_rows, k=k, device=device)
    return layout


def test_ell_gather_wrapper_checks_and_counts_only_launches():
    layout = _ragged_layout(4, "cpu")
    v = layout.vdst.shape[0]
    w = torch.rand((3, v, 4))
    x = torch.randn((200, 3 * 8))
    before = ell_gather.ell_gather_sum.launches
    out = ell_gather.ell_gather_sum(layout, w, x)
    assert ell_gather.ell_gather_sum.launches == before  # CPU: plain version
    assert out.shape == (300, 24) and out.dtype == torch.float32
    with pytest.raises(TypeError):
        ell_gather.ell_gather_sum(layout, w.double(), x)
    with pytest.raises(ValueError, match="passes"):
        ell_gather.ell_gather_sum(layout, w, x[:, :22])
    with pytest.raises(ValueError, match="gathers from"):
        ell_gather.ell_gather_sum(layout, w, x[:150])
    with pytest.raises(ValueError, match="layout"):
        ell_gather.ell_gather_sum(layout, w[:, :-1], x)


@pytest.mark.parametrize("failure", ["not_hopper", "no_library"])
def test_ell_gather_refuses_cuda_tensors_it_cannot_launch_on(monkeypatch, failure):
    """CUDA tensors never take the plain version: where the kernel cannot
    launch, the wrapper raises. Fake CUDA tensors stand in for a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plain_calls = []
    monkeypatch.setattr(ell_gather, "ell_gather_sum_plain",
                        lambda *a: plain_calls.append(a))
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (8, 0) if failure == "not_hopper" else (9, 0))

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ell_gather, "_load", no_library)
    cpu_layout = _ragged_layout(16, "cpu")
    before = ell_gather.ell_gather_sum.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        def fake(t):
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")

        layout = cpu_layout._replace(**{n: fake(getattr(cpu_layout, n)) for n in
                                        ("vidx", "vdst", "edge_slots", "row_ptr")})
        w = torch.ones((1, layout.vdst.shape[0], 16), device="cuda")
        x = torch.ones((200, 64), device="cuda")
        assert x.device.type == "cuda"
        with pytest.raises(RuntimeError, match="sm_90a" if failure == "not_hopper"
                           else "nvcc"):
            ell_gather.ell_gather_sum(layout, w, x)
    assert plain_calls == []
    assert ell_gather.ell_gather_sum.launches == before


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("failure", ["not_hopper", "no_library"])
def test_dual_matmul_refuses_cuda_tensors_it_cannot_launch_on(monkeypatch, failure,
                                                              dtype):
    """As K2's wrapper: both K1 kernels raise where they cannot launch, and
    never take the plain version for CUDA tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plain_calls = []
    monkeypatch.setattr(dense_dual, "dual_matmul_plain", lambda *a: plain_calls.append(a))
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (8, 0) if failure == "not_hopper" else (9, 0))

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(dense_dual, "_load", no_library)
    before = (dense_dual.dual_matmul.launches, dense_dual.float_products.launches)
    with FakeTensorMode(allow_non_fake_inputs=True):
        b = torch.empty((96, 160), dtype=torch.int8, device="cuda")
        xu = torch.empty((96, 64), dtype=getattr(torch, dtype), device="cuda")
        xi = torch.empty((160, 64), dtype=getattr(torch, dtype), device="cuda")
        bt = torch.empty((160, 96), dtype=torch.int8, device="cuda")
        with pytest.raises(RuntimeError, match="sm_90a" if failure == "not_hopper"
                           else "nvcc"):
            dense_dual.dual_matmul(b, xu, xi, bt)
    assert plain_calls == []
    assert (dense_dual.dual_matmul.launches,
            dense_dual.float_products.launches) == before


def _check_int8_on_the_card(gen, u, i, d):
    b = (torch.rand((u, i), generator=gen, device="cuda") < 0.3).to(torch.int8)
    xu = torch.randint(-127, 128, (u, d), generator=gen, device="cuda", dtype=torch.int8)
    xi = torch.randint(-127, 128, (i, d), generator=gen, device="cuda", dtype=torch.int8)
    before = dense_dual.dual_matmul.launches
    ou, oi = dense_dual.dual_matmul(b, xu, xi, dense_dual.block_transpose(b))
    torch.cuda.synchronize()
    assert dense_dual.dual_matmul.launches == before + 1
    pu, pi = dense_dual.dual_matmul_plain(b, xu, xi)
    assert ou.shape == (u, d) and oi.shape == (i, d)
    assert torch.equal(ou, pu) and torch.equal(oi, pi)


def _check_float_on_the_card(gen, u, i, d, dtype):
    """Forward within rtol 1e-5 / atol 1e-3 of the plain version (the JAX
    package's own tolerance for its float variant, tests/test_dense_dual.py),
    and the backward against the plain products of the cotangents."""
    b = (torch.rand((u, i), generator=gen, device="cuda") < 0.3).to(torch.int8)
    xu = torch.randn((u, d), generator=gen, device="cuda").to(dtype).requires_grad_(True)
    xi = torch.randn((i, d), generator=gen, device="cuda").to(dtype).requires_grad_(True)
    plan = dense_dual.width_plan(d, 3 if dtype == torch.float32 else 1)
    assert torch.equal(dense_dual.float_operand(xu.detach(), plan),
                       dense_dual.float_operand_plain(xu.detach(), plan))
    before = dense_dual.float_products.launches
    ou, oi = dense_dual.dual_matmul(b, xu, xi, dense_dual.block_transpose(b))
    torch.cuda.synchronize()
    assert dense_dual.float_products.launches == before + 1
    pu, pi = dense_dual.dual_matmul_plain(b, xu.detach(), xi.detach())
    torch.testing.assert_close(ou, pu, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(oi, pi, rtol=1e-5, atol=1e-3)
    wu, wi = torch.randn_like(ou), torch.randn_like(oi)
    (ou * wu).sum().add((oi * wi).sum()).backward()
    assert dense_dual.float_products.launches == before + 2
    # gxu = B @ g_i, gxi = B.T @ g_u, in the operands' dtype: bf16
    # gradients may differ by one bf16 step of the rounded f32 sum
    gu, gi = dense_dual.dual_matmul_plain(b, wu.to(dtype), wi.to(dtype))
    tol = dict(rtol=1e-5, atol=1e-3) if dtype == torch.float32 else dict(
        rtol=2 ** -7, atol=1e-2)
    torch.testing.assert_close(xu.grad.float(), gu.to(dtype).float(), **tol)
    torch.testing.assert_close(xi.grad.float(), gi.to(dtype).float(), **tol)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
def test_dual_kernel_matches_plain_on_the_card():
    """On the card's machine, which has no JAX for tests/conftest.py:
    ``python -m pytest --noconftest -m cuda tests/test_torch_isolation.py``."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for u, i, d in [(70, 90, 64), (517, 1029, 192), (1000, 1337, 64)]:
        _check_int8_on_the_card(gen, u, i, d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 128, 200])
def test_dual_kernel_any_width_matches_plain_on_the_card(d):
    """K1 int8 at widths outside {64, 192}: padded to 64, 128 and two
    128-wide chunks; equal to the plain version bit for bit."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    for u, i in [(70, 90), (517, 1029)]:
        _check_int8_on_the_card(gen, u, i, d)


@pytest.mark.cuda
def test_dual_float_kernel_matches_plain_on_the_card():
    """K1's float kernel (bf16 and f32 operands), forward and backward. Run
    as the dual kernel's test above."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for u, i, d in [(70, 90, 64), (517, 1029, 192), (1000, 1337, 64)]:
        for dtype in (torch.bfloat16, torch.float32):
            _check_float_on_the_card(gen, u, i, d, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [64, 100, 192])
def test_dual_float_kernel_any_width_on_the_card(d, dtype):
    """K1's float kernel at D 64, 100 (padded to 128; f32: two chunks) and
    192 (f32: three chunks), forward and backward."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    _check_float_on_the_card(gen, 300, 700, d, getattr(torch, dtype))


@pytest.mark.cuda
def test_ell_gather_kernel_matches_plain_on_the_card():
    """K2 against its plain version at rtol/atol 2e-5: ragged layouts at
    K 4 and 16, one and three passes, f32 and bf16 rows. Run as the dual
    kernel's test above."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k, p, d, dtype in [(4, 1, 64, torch.float32), (16, 3, 64, torch.float32),
                           (16, 1, 64, torch.bfloat16), (16, 2, 20, torch.float32)]:
        layout = _ragged_layout(k, "cuda", seed=k)
        v = layout.vdst.shape[0]
        w = torch.rand((p, v, k), generator=gen, device="cuda")
        x = torch.randn((200, p * d), generator=gen, device="cuda").to(dtype)
        if dtype == torch.bfloat16:
            w = w.to(dtype).float()
        before = ell_gather.ell_gather_sum.launches
        out = ell_gather.ell_gather_sum(layout, w, x)
        torch.cuda.synchronize()
        assert ell_gather.ell_gather_sum.launches == before + 1
        torch.testing.assert_close(out, ell_gather.ell_gather_sum_plain(layout, w, x),
                                   rtol=2e-5, atol=2e-5)
        assert torch.equal(out, ell_gather.ell_gather_sum(layout, w, x))


def _factored_edges(nu, ni, seed):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, nu * ni, 8 * nu))
    eu, ei = (key // ni).astype(np.int32), (key % ni).astype(np.int32)
    du, di = np.bincount(eu, minlength=nu), np.bincount(ei, minlength=ni)
    return eu, ei, (1 / np.sqrt(du[eu] * di[ei])).astype(np.float32)


@pytest.mark.cuda
def test_dense_bf16_spmm_on_the_card_matches_the_cpu(monkeypatch):
    """The factored bf16 mode on the card (K1's float kernel: one launch
    forward with bf16 operands, one backward with f32 cotangents) against
    the same block on the CPU at a ragged shape: values within K1 float's
    rtol 1e-5 / atol 1e-3, grads within one bf16 step of the rounded f32
    sums (rtol 2^-7, atol 1e-2). Run as the dual kernel's test above."""
    _needs_card()
    from selfrec_tpu_torch.ops import spmm_dense

    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "bfloat16")
    nu, ni = 517, 1029
    eu, ei, w = _factored_edges(nu, ni, 3)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((nu + ni, 64), generator=gen)
    wout = torch.randn((nu + ni, 64), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        adj = spmm_dense.dense_adj_from_edges(eu, ei, w, nu, ni, device=dev)
        xr = x.to(dev).detach().requires_grad_(True)
        before = dense_dual.float_products.launches
        y = spmm_dense.dense_spmm(adj, xr)
        (y * wout.to(dev)).sum().backward()
        launched = dense_dual.float_products.launches - before
        assert launched == (2 if dev == "cuda" else 0)
        out[dev] = (y.detach().cpu(), xr.grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=2 ** -7, atol=1e-2)


@pytest.mark.cuda
def test_dropout_view_on_the_card_keeps_b_and_its_transpose_alike(monkeypatch):
    """A per-edge dropout view made on the card (fed keep, and drawn from a
    card generator): B and the kept transpose stay transposes of each
    other at K1's row pitch, the kept edges are the keep mask's, and the fed
    view equals the CPU's."""
    _needs_card()
    from selfrec_tpu_torch.ops import spmm_dense

    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", "bfloat16")
    monkeypatch.setenv("SELFREC_TPU_DROPOUT_MASK", "scatter")
    nu, ni = 700, 1337
    eu, ei, w = _factored_edges(nu, ni, 4)
    adj = spmm_dense.dense_adj_from_edges(eu, ei, w, nu, ni, device="cuda")
    cpu = spmm_dense.dense_adj_from_edges(eu, ei, w, nu, ni, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(4)
    keep = torch.rand(adj.edge_w.shape, generator=gen, device="cuda") >= 0.3
    rate = torch.tensor(0.3, device="cuda")
    for view in (adj.dropout_view(rate, keep=keep), adj.dropout_view(rate, generator=gen)):
        torch.cuda.synchronize()
        assert torch.equal(view.a_iu, view.a_ui.T)
        assert set(view.a_ui.unique().tolist()) <= {0, 1}
        # a ragged width keeps K1's row pitch: a launch copies nothing
        assert all(dense_dual._pitched(t) is t for t in (view.a_ui, view.a_iu))
    fed = adj.dropout_view(rate, keep=keep)
    assert int(fed.a_ui.sum()) == int(keep.sum())
    assert torch.equal(fed.a_ui.cpu(), cpu.dropout_view(0.3, keep=keep.cpu()).a_ui)
    assert int(adj.a_ui.sum()) == len(eu) and torch.equal(adj.a_iu, adj.a_ui.T)


@pytest.mark.cuda
def test_csr_sampler_on_the_card_matches_the_cpu():
    """The CSR membership search on the card answers as on the CPU for the
    same (user, candidate) pairs fed to both, empty segments included; on
    the card the CSR sampler equals the bitmap sampler for one generator
    seed and returns no rated item. Run as the dual kernel's test above."""
    _needs_card()
    from selfrec_tpu_torch.ops import sampling

    rng = np.random.default_rng(0)
    n_users, n_items = 300, 2000
    counts = rng.integers(0, 60, n_users)
    counts[::17] = 0
    items = np.concatenate([np.sort(rng.choice(n_items, c, replace=False)) for c in counts])
    items = items.astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    steps = int(np.ceil(np.log2(counts.max() + 1))) + 1
    seg = torch.from_numpy(rng.integers(0, n_users, 200_000))
    vals = torch.from_numpy(rng.integers(-1, n_items + 1, 200_000))
    got = {dev: sampling.searchsorted_in_segments(
        torch.from_numpy(items).to(dev), torch.from_numpy(off).to(dev), seg.to(dev),
        vals.to(dev), steps).cpu() for dev in ("cpu", "cuda")}
    assert torch.equal(got["cuda"], got["cpu"]) and bool(got["cpu"].any())
    bitmap = sampling.bitmap_to_device(
        sampling.pack_rated_bitmap(off, items, n_users, n_items), "cuda")
    users = torch.from_numpy(rng.integers(0, n_users, 4096)).cuda()
    keys = sampling.rated_keys(torch.from_numpy(off).cuda(), torch.from_numpy(items).cuda(),
                               n_items)
    csr = sampling.sample_negatives(torch.Generator(device="cuda").manual_seed(3), users, keys,
                                    n_items, shape=(4096, 8))
    bm = sampling.sample_negatives_bitmap(torch.Generator(device="cuda").manual_seed(3), users,
                                          bitmap, n_items, shape=(4096, 8))
    assert torch.equal(csr, bm)
    lanes = users.repeat_interleave(8).cpu()
    assert not bool(sampling.searchsorted_in_segments(
        torch.from_numpy(items), torch.from_numpy(off), lanes, csr.reshape(-1).cpu(),
        steps).any())


@pytest.mark.cuda
def test_knn_build_and_tie_order_on_the_card_match_the_cpu():
    """``topk_lowest_index`` and the KNN similarity build (``torch._int_mm``
    on the card, an int32 product on the CPU) give the CPU's values and ids
    exactly. Run as the dual kernel's test above."""
    _needs_card()
    from selfrec_tpu_torch.ops import knn, ranking

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-3, 4, size=(300, 5000)).astype(np.float32))
    for a, b in zip(ranking.topk_lowest_index(x.cuda(), 50), ranking.topk_lowest_index(x, 50)):
        assert torch.equal(a.cpu(), b)
    n_dst, n_src = 1500, 901  # a ragged second block, columns padded to 960
    key = np.unique(rng.integers(0, n_dst * n_src, 20 * n_dst))
    dst, src = key // n_src, key % n_src
    deg = torch.from_numpy(np.bincount(dst, minlength=n_dst).astype(np.float32))
    got = {dev: knn.topk_shrunk_cosine(dst, src, n_dst, n_src, deg.to(dev), 100, 50)
           for dev in ("cpu", "cuda")}
    for a, b in zip(got["cuda"], got["cpu"]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_mat_spmm_on_the_card_matches_the_cpu(monkeypatch, dtype):
    """DenseMat's product on the card (bf16: cuBLAS with f32 output, the
    backward over the cotangent's three bf16 pieces; f32: a full-f32 GEMM)
    against the CPU's at a ragged shape: forward rtol 1e-5 / atol 1e-6;
    grads rtol 1e-5 in f32, and in bf16 within one bf16 step (rtol 2^-7) of
    the CPU's, both bf16 values. Run as the dual kernel's test above."""
    _needs_card()
    import scipy.sparse as sp

    from selfrec_tpu_torch.ops import spmm_dense

    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", dtype)
    a = sp.random(517, 1029, density=0.05, random_state=3, format="csr", dtype=np.float32)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((1029, 64), generator=gen)
    g = torch.randn((517, 64), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        adj = spmm_dense.dense_mat_from_scipy(a, device=dev)
        xr = x.to(dev).detach().requires_grad_(True)
        y = spmm_dense.dense_mat_spmm(adj, xr)
        y.backward(g.to(dev))
        out[dev] = (y.detach().cpu(), xr.grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-6)
    if dtype == "float32":
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-6)
    else:
        for grad in (out["cuda"][1], out["cpu"][1]):
            assert torch.equal(grad.bfloat16().float(), grad)
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=2 ** -7, atol=1e-6)


@pytest.mark.cuda
def test_device_motifs_on_the_card_equal_the_cpu():
    """The motif algebra on the card (f32 products, TF32 off in its own
    scope even where the caller turned it on) equals the CPU's exactly: the
    counts are integers."""
    _needs_card()
    import scipy.sparse as sp

    from selfrec_tpu_torch.data import motifs

    s = sp.random(300, 300, density=0.05, random_state=4, format="csr", dtype=np.float32)
    s.data[:] = 1.0
    y = sp.random(300, 400, density=0.05, random_state=5, format="csr", dtype=np.float32)
    y.data[:] = 1.0
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 on for the caller
    try:
        card = motifs.mhcn_hypergraphs_device(s, y, "cuda")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    for got, want in zip(card, motifs.mhcn_hypergraphs_device(s, y, "cpu")):
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("failure", ["not_hopper", "no_library"])
def test_rank_topk_refuses_cuda_tensors_it_cannot_launch_on(monkeypatch, failure):
    """As K1's and K2's wrappers: the ranking kernels raise where they
    cannot launch, and never take the plain twin for CUDA tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    plain_calls = []
    monkeypatch.setattr(rank_topk, "rank_topk_plain", lambda *a: plain_calls.append(a))
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (8, 0) if failure == "not_hopper" else (9, 0))

    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(rank_topk, "_load", no_library)
    before = rank_topk.rank_topk.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        ue = torch.empty((96, 64), device="cuda")
        ie = torch.empty((300, 64), device="cuda")
        rated = torch.empty((96, 300), dtype=torch.int8, device="cuda")
        uids = torch.empty((50,), dtype=torch.int64, device="cuda")
        with pytest.raises(RuntimeError, match="sm_90a" if failure == "not_hopper"
                           else "nvcc"):
            rank_topk.rank_topk(ue, ie, rated, uids, 20)
    assert plain_calls == []
    assert rank_topk.rank_topk.launches == before


def _rank_case(gen, n_users, n_items, d, share, integer=False):
    """Embeddings, a rated incidence of the given density and a sorted
    subset of test users, on the card."""
    if integer:
        ue = torch.randint(-2, 3, (n_users, d), generator=gen, device="cuda").float()
        ie = torch.randint(-2, 3, (n_items, d), generator=gen, device="cuda").float()
    else:
        ue = torch.randn((n_users, d), generator=gen, device="cuda") * 0.3
        ie = torch.randn((n_items, d), generator=gen, device="cuda") * 0.3
    rated = (torch.rand((n_users, n_items), generator=gen, device="cuda") < share).to(
        torch.int8)
    uids = torch.randperm(n_users, generator=gen, device="cuda")[:n_users - 1].sort().values
    return ue, ie, rated, uids


def _no_rated_no_repeat(ids, rated, uids):
    assert not bool(rated[uids[:, None], ids].any())
    srt = ids.sort(dim=1).values
    assert not bool((srt[:, 1:] == srt[:, :-1]).any())


@pytest.mark.cuda
def test_rank_topk_kernels_score_like_the_plain_twin_on_the_card():
    """At the eval cell's shape (31,668 users, 31,667 of them tested, 38,048
    items, D 64, k 20, yelp2018's density of rated items): the kernels'
    ids score like the plain twin's position by position in float64
    rescoring (rtol 1e-5 / atol 1e-6: f32 sums in another order may swap
    near-ties), their scores within 1e-5; no rated id, none repeated. Run
    as the dual kernel's test above."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(18)
    ue, ie, rated, uids = _rank_case(gen, 31668, 38048, 64, 1561406 / (31668 * 38048))
    before = rank_topk.rank_topk.launches
    scs, ids = rank_topk.rank_topk(ue, ie, rated, uids, 20)
    torch.cuda.synchronize()
    assert rank_topk.rank_topk.launches == before + 1
    pscs, pids = rank_topk.rank_topk_plain(ue, ie, rated, uids, 20)
    u64, i64 = ue.double()[uids], ie.double()
    torch.testing.assert_close((u64[:, None, :] * i64[ids]).sum(-1),
                               (u64[:, None, :] * i64[pids]).sum(-1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(scs, pscs, rtol=1e-5, atol=1e-5)
    _no_rated_no_repeat(ids, rated, uids)


@pytest.mark.cuda
@pytest.mark.parametrize("k, d, share", [(20, 64, 0.3), (128, 100, 0.3), (7, 16, 0.999)])
def test_rank_topk_kernels_tie_as_the_plain_twin_on_the_card(k, d, share):
    """Integer embeddings, whose scores tie everywhere and sum alike in any
    order: ids and scores EQUAL to the plain twin's (ties by the lowest
    id), at a k that fills the kernels' lists, a padded D, and users with
    fewer unrated items than k (rated ones at -1e9, lowest id first)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(k)
    ue, ie, rated, uids = _rank_case(gen, 1500, 2900, d, share, integer=True)
    scs, ids = rank_topk.rank_topk(ue, ie, rated, uids, k)
    pscs, pids = rank_topk.rank_topk_plain(ue, ie, rated, uids, k)
    assert torch.equal(ids, pids) and torch.equal(scs, pscs)
    if share < 0.5:
        _no_rated_no_repeat(ids, rated, uids)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["wrong_dtype", "non_contiguous", "k_over_max",
                                  "gt_int64_items", "gt_on_the_cpu"])
def test_rank_topk_wrapper_raises_on_the_card(case):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    ue, ie, rated, uids = _rank_case(gen, 300, 700, 64, 0.1)
    k = rank_topk.K_MAX + 1 if case == "k_over_max" else 20
    gt = None
    if case == "wrong_dtype":
        ue = ue.half()
    elif case == "non_contiguous":
        ie = torch.cat([ie, ie], dim=1)[:, ::2]
    elif case.startswith("gt_"):
        offsets = torch.arange(uids.shape[0] + 1, device="cuda")
        items = torch.zeros(uids.shape[0], dtype=torch.int32, device="cuda")
        gt = ((offsets, items.long()) if case == "gt_int64_items"
              else (offsets.cpu(), items.cpu()))
    with pytest.raises((TypeError, ValueError)):
        rank_topk.rank_topk(ue, ie, rated, uids, k, gt=gt)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, rank_topk.K_MAX])
def test_rank_merge_hit_mask_equals_the_host_search_on_the_card(k):
    """At the eval cell's shape, ground truths of 0 to 300 items a test
    user, each holding a random share of the user's answer (some none):
    ``rank_merge``'s epilogue gives the host search's mask exactly, at k 20
    and at K_MAX (four ids a lane), and the scores and ids equal the call
    without it bit for bit. The ground truth and the host search are
    chip_smoke.py's."""
    _needs_card()
    from chip_smoke import host_hits, synthetic_gt
    gen = torch.Generator(device="cuda").manual_seed(k)
    n_items = 38048
    ue, ie, rated, uids = _rank_case(gen, 31668, n_items, 64, 1561406 / (31668 * n_items))
    scs, ids = rank_topk.rank_topk(ue, ie, rated, uids, k)
    gt = synthetic_gt(np.random.default_rng(k), uids.shape[0], n_items, ids.cpu().numpy())
    gscs, gids, hits = rank_topk.rank_topk(ue, ie, rated, uids, k, gt=gt)
    torch.cuda.synchronize()
    assert torch.equal(gids, ids)
    assert torch.equal(gscs.view(torch.int32), scs.view(torch.int32))
    want = host_hits(ids.cpu(), *(t.cpu().numpy() for t in gt), n_items)
    assert np.array_equal(hits.cpu().numpy(), want)
    assert want.any() and not want.any(axis=1).all()
    assert torch.equal(hits, rank_topk.hits_plain(ids, *gt))


@pytest.mark.cuda
def test_eval_ranking_takes_the_kernels_on_the_card():
    """``topk_ids_from_embeddings`` on the card with the resident mask: one
    call of the kernels, counted by the host span ``rank.fused``; under a
    profiler the device spans ``rank.score`` and ``rank.topk`` read one
    pair each. The hit mask it hands back is the host search's; its ids
    score like the CPU's (the plain twin)."""
    _needs_card()
    from chip_smoke import host_hits
    from selfrec_tpu_torch.config import ModelConf
    from selfrec_tpu_torch.data.interaction import Interaction
    from selfrec_tpu_torch.ops import ranking
    from selfrec_tpu_torch.utils import trace
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    conf = {"training.set": "<memory>", "test.set": "<memory>",
            "model": {"name": "SimGCL", "type": "graph"}, "item.ranking.topN": [20],
            "embedding.size": 64, "max.epoch": 1, "batch.size": 64,
            "learning.rate": 0.01, "reg.lambda": 0.0001, "output": "unused"}
    data = Interaction(ModelConf(conf), *synth_graph_mapped(2000, 3000, 40000, seed=5))
    gen = torch.Generator().manual_seed(5)
    ue = torch.randn((data.user_num, 64), generator=gen)
    ie = torch.randn((data.item_num, 64), generator=gen)
    trace.reset()
    hits = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        ids = ranking.topk_ids_from_embeddings(data, ue.cuda(), ie.cuda(), 20, hits_out=hits)
    totals = trace.totals()
    assert totals["rank.fused"].count == 1
    assert totals["rank.score"].device_count == 1 and totals["rank.topk"].device_count == 1
    np.testing.assert_array_equal(hits[0], host_hits(ids, *data.test_gt_csr(), data.item_num))
    cpu = ranking.topk_ids_from_embeddings(data, ue, ie, 20)
    uids = torch.as_tensor(data.test_user_ids).long()
    u64, i64 = ue.double()[uids], ie.double()
    torch.testing.assert_close((u64[:, None, :] * i64[torch.as_tensor(ids)]).sum(-1),
                               (u64[:, None, :] * i64[torch.as_tensor(cpu)]).sum(-1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_eval_ranking_on_the_card_past_k_max_takes_the_block_scan(monkeypatch):
    """On the card the resident mask takes the dense-mask block scan past
    the kernels' K_MAX (up to it, the test above), whose ids ``hits_plain``
    tests on the card: the one mask it hands back is the host search's. Its
    answer scores like the CPU's twin's."""
    _needs_card()
    from chip_smoke import host_hits
    from selfrec_tpu_torch.config import ModelConf
    from selfrec_tpu_torch.data.interaction import Interaction
    from selfrec_tpu_torch.ops import ranking
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    conf = {"training.set": "<memory>", "test.set": "<memory>",
            "model": {"name": "SimGCL", "type": "graph"}, "item.ranking.topN": [20],
            "embedding.size": 64, "max.epoch": 1, "batch.size": 64,
            "learning.rate": 0.01, "reg.lambda": 0.0001, "output": "unused"}
    data = Interaction(ModelConf(conf), *synth_graph_mapped(500, 1200, 9000, seed=6))
    k = rank_topk.K_MAX + 2
    taken = []
    for mod, name in ((rank_topk, "rank_topk"), (ranking, "_topk_all_blocks_dense")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            taken.append(_name)
            return _real(*a, **kw)

        # the wrapper counts its launches on whatever its module's name holds
        spy.launches = getattr(real, "launches", 0)
        monkeypatch.setattr(mod, name, spy)
    gen = torch.Generator().manual_seed(6)
    ue = torch.randn((data.user_num, 64), generator=gen)
    ie = torch.randn((data.item_num, 64), generator=gen)
    hits = []
    ids = ranking.topk_ids_from_embeddings(data, ue.cuda(), ie.cuda(), k, hits_out=hits)
    assert taken == ["_topk_all_blocks_dense"] and len(hits) == 1
    np.testing.assert_array_equal(hits[0], host_hits(ids, *data.test_gt_csr(), data.item_num))
    cpu = ranking.topk_ids_from_embeddings(data, ue, ie, k)
    uids = torch.as_tensor(data.test_user_ids).long()
    u64, i64 = ue.double()[uids], ie.double()
    torch.testing.assert_close((u64[:, None, :] * i64[torch.as_tensor(ids)]).sum(-1),
                               (u64[:, None, :] * i64[torch.as_tensor(cpu)]).sum(-1),
                               rtol=1e-5, atol=1e-6)
