"""The port's SGL against the plain reference of the benchmark's SGL
configuration (``benchmark/reference/sgl.py``), and the gates that send
that configuration down the ELL arm and the CSR sampler.

At a small size on the CPU the port runs its ELL arm (the default on the
CPU) with the CSR sampler forced (``SELFREC_TPU_NEG_BITMAP_MB=0``), from
the reference's seeded weights, through its own ``epoch_batches``,
``begin_epoch`` and ``train_batches``, and the reference replays the same
three steps over the same batches. Compared:

- the keep masks: equal, element for element (both draw them from
  ``default_rng((seed, epoch, 1))`` with the augmentor's counts);
- the views' weights against the reference's renormalized views: rtol
  1e-6 (one rsqrt and two products a weight, in another order);
- each step's loss: rtol 1e-6 (the same f32 sums in another order: K2's
  plain version against a sparse product; the largest gap seen is 1e-7);
- the first gradients: within 1e-5 of the largest entry of each leaf
  (f32 sums of up to three hops back through the graph, in another
  order);
- the change after three Adam steps: its norm, each leaf's, within 1e-5
  of the reference's, as the benchmark's ``delta_gap`` reads it; each
  entry within 1e-2 of the learning rate (Adam divides by the gradient's
  own size, so an entry moves by about the learning rate whatever its
  gradient, and one whose gradient cancels to a few ulps of its terms
  moves by a share of it that round-off sets: 2e-3 of it at most, in one
  entry of 18,816, at this size).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import sgl as ref_sgl
from benchmark.reference import synth
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.ops import sampling, spmm_dense
from selfrec_tpu_torch.ops.spmm_ell import EllAdj
from selfrec_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


SGL_CONF = _config("SGL-amazon-book")
SEED = 2**31 + 4242  # the benchmark's seeds pass 32 bits
DRAW, WEIGHTS = 977, 31


def _inputs():
    return synth.graph_arrays(SEED, 200, 300, 4000, 11)


def _conf(aug_type=1):
    conf = dict(SGL_CONF["conf"], **{"batch.size": 128, "seed": SEED})
    conf["SGL"] = dict(conf["SGL"], aug_type=aug_type)
    return conf


def _mapped(inputs):
    """The training pairs as the native loader maps them, and the test
    triples."""
    nu, ni = inputs["n_users"], inputs["n_items"]
    mapped = (inputs["train_u"].astype(np.int32), inputs["train_i"].astype(np.int32),
              np.ones(len(inputs["train_u"]), np.float32),
              [f"u{k}" for k in range(nu)], [f"i{k}" for k in range(ni)])
    return mapped, [(f"u{u}", f"i{i}", 1.0) for u, i in zip(inputs["test_u"], inputs["test_i"])]


def _model(monkeypatch, inputs, conf):
    monkeypatch.delenv("SELFREC_TPU_DENSE", raising=False)
    monkeypatch.setenv("SELFREC_TPU_NEG_BITMAP_MB", "0")
    model = get_model_class("SGL")(ModelConf(conf), *_mapped(inputs), device="cpu")
    model.build()
    assert isinstance(model.adj, EllAdj) and isinstance(model._view_template, EllAdj)
    assert model._rated_bitmap is None
    return model


@pytest.mark.parametrize("aug_type", [1, 2])
def test_keep_masks_and_views_equal_the_reference(monkeypatch, aug_type):
    """aug_type 2 (random walk) is edge dropout in SELFRec and the port."""
    inputs, conf = _inputs(), _conf(aug_type)
    model = _model(monkeypatch, inputs, conf)
    nu, n = inputs["n_users"], inputs["n_users"] + inputs["n_items"]
    u = torch.as_tensor(inputs["train_u"])
    i = torch.as_tensor(inputs["train_i"]) + nu
    for epoch in (0, 2):
        rng = model.epoch_rng(epoch, stream=1)
        mine = [model._edge_keep_mask(rng), model._edge_keep_mask(rng)]
        want = ref_sgl.keep_masks(inputs, conf, epoch)
        for a, b in zip(mine, want):
            np.testing.assert_array_equal(a, b)
            assert 0 < a.sum() < len(a)
        aux = model.epoch_setup(epoch)
        for key, keep in zip(("w1", "w2"), want):
            w = aux[key][: len(u)]
            dense = torch.zeros((n, n))
            dense[u, i] = w
            dense[i, u] = w
            ref = ref_sgl.view_adj(inputs, keep, "cpu").to_dense()
            torch.testing.assert_close(dense, ref, rtol=1e-6, atol=0)


def test_three_steps_match_the_reference(monkeypatch):
    inputs, conf = _inputs(), _conf()
    model = _model(monkeypatch, inputs, conf)
    params0 = ref_sgl.make_params(WEIGHTS, inputs, conf, "cpu")
    model.set_params(params0)
    model.generator.manual_seed(DRAW)
    users, items, masks = model.epoch_batches(0)
    assert bool((masks[:3] == 1).all())
    model.begin_epoch(0)
    losses = model.train_batches(users[:1], items[:1], masks[:1]).tolist()
    grad1 = {k: p.grad.clone() for k, p in model.params.items()}
    losses += model.train_batches(users[1:3], items[1:3], masks[1:3]).tolist()
    ref = ref_sgl.train_readings(inputs, params0, [(users[s], items[s]) for s in range(3)],
                                 DRAW, conf, "cpu", 3)
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-6, atol=0)
    lr = float(conf["learning.rate"])
    for k, p in model.params.items():
        g = ref["grad1"][k]
        assert float(g.abs().max()) > 0
        torch.testing.assert_close(grad1[k], g, rtol=0, atol=1e-5 * float(g.abs().max()))
        change, want = p.detach() - params0[k], ref["delta"][k]
        assert abs(float(change.norm() - want.norm())) <= 1e-5 * float(want.norm())
        torch.testing.assert_close(change, want, rtol=0, atol=1e-2 * lr)


@pytest.mark.parametrize("budget_mb, sampler", [("0", "sampler.csr"), ("512", "sampler.bitmap")])
def test_build_counts_what_it_built_and_epochs_span_their_views(monkeypatch, budget_mb,
                                                                 sampler):
    """The counters name the layouts (the model's adjacency and the view
    template, both ELL here) and the sampler that set-up built; each
    epoch's views are one ``views.keep`` and one ``views.weights`` span."""
    monkeypatch.delenv("SELFREC_TPU_DENSE", raising=False)
    monkeypatch.setenv("SELFREC_TPU_NEG_BITMAP_MB", budget_mb)
    model = get_model_class("SGL")(ModelConf(_conf()), *_mapped(_inputs()), device="cpu")
    model.build()
    assert trace.counts() == {"layout.EllAdj": 2, sampler: 1}
    assert trace.totals()["setup.adj"].count == 2
    for epoch in range(3):
        model.begin_epoch(epoch)
    spans = trace.totals()
    assert spans["views.keep"].count == spans["views.weights"].count == 3


def test_the_gates_choose_ell_and_csr_at_amazon_book_size(monkeypatch):
    """By arithmetic on the sizes alone: at amazon-book's the bf16 (U, I)
    block (9.64 GB) is over the default 5 GB dense budget and the rated
    bitmap (603 MB) over its default 512 MB, so the port's own gates take
    the ELL layout and the CSR sampler; at yelp2018's, which the SimGCL
    cells run, both fit."""
    for key in ("SELFREC_TPU_DENSE_BUDGET_GB", "SELFREC_TPU_DENSE_DTYPE",
                "SELFREC_TPU_NEG_BITMAP_MB"):
        monkeypatch.delenv(key, raising=False)
    book, yelp = SGL_CONF["data"], _config("SimGCL-yelp2018")["data"]
    assert book["users"] * book["items"] * 2 > 5e9
    assert not spmm_dense.fits_dense(book["users"], book["items"])
    assert not sampling.bitmap_fits(book["users"], book["items"])
    assert spmm_dense.fits_dense(yelp["users"], yelp["items"])
    assert sampling.bitmap_fits(yelp["users"], yelp["items"])
    monkeypatch.setenv("SELFREC_TPU_NEG_BITMAP_MB", "700")
    assert sampling.bitmap_fits(book["users"], book["items"])


def test_the_reference_imports_neither_package():
    probe = ("import sys; sys.path.insert(0, %r); import benchmark.reference.sgl; "
             "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % ROOT)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "selfrec_tpu", "selfrec_tpu_torch"}


def test_step_flops_by_hand():
    conf = {"embedding.size": 4, "batch.size": 8,
            "SGL": {"n_layer": 2, "drop_rate": 0.1, "aug_type": 1}}
    inputs = {"train_u": np.zeros(10)}
    prop = 2 * 2 * 2 * (2 * (10 + 2 * 9) * 4)  # hops, fwd+bwd, directions; views keep 9
    infonce = 3 * (2 * 16 * 16 * 4)           # 2B anchors, three products
    bpr = 3 * 2 * (2 * 8 * 4)
    assert ref_sgl.step_flops(inputs, conf) == prop + infonce + bpr
