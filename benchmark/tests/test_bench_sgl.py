"""The cell ``SGL-amazon-book.train`` end to end at a small size on the
CPU, through the harness, its traffic file, the ELL family and the plain
reference: the line has the contract's shape and passes its check; the
traced run reads the program's view spans and the family's K2 calls; the
family refuses a program off the ELL and CSR path; three faults planted
in the program each fail a limit; and K2's bound and its reader's
arithmetic by hand.

At the small size the rated bitmap fits its budget, so the runs force the
CSR sampler as the cell's size does (``SELFREC_TPU_NEG_BITMAP_MB=0``);
the CPU takes the ELL layout by default."""

import time
from types import SimpleNamespace

import pytest
import torch

from _small import SEED
from benchmark.core import harness, registry
from benchmark.core.peaks import HBM_BYTES_PER_S, PEAK
from benchmark.core.peaks_ell import K2Call, k2_bound_s, k2_bytes
from selfrec_tpu_torch.models.graph import sgl
from selfrec_tpu_torch.ops import graph
from selfrec_tpu_torch.utils import trace

CELL = "SGL-amazon-book.train"
SMALL = {"users": 300, "items": 400, "interactions": 6000, "batch.size": 128}


@pytest.fixture
def csr(monkeypatch):
    monkeypatch.setenv("SELFREC_TPU_NEG_BITMAP_MB", "0")


def _run(seed, seconds=0.0, traced=False):
    return harness.run(CELL, seed, seconds, traced, "cpu", time.perf_counter(), overrides=SMALL)


def test_cell_end_to_end_on_the_cpu(csr):
    out = _run(SEED, 0.3)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"train_pairs_per_s", "setup_s"}
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "delta_gap", "batch_bad"}
    for number, limit in out["checks"].values():
        assert number <= limit
    # on the CPU both sides take plain f32 paths: every gap is round-off
    assert max(n for n, _ in out["checks"].values()) < 1e-6


def test_traced_run_records_the_view_spans_and_k2_calls(csr, monkeypatch):
    seen = {}
    reader = registry.reader

    def keep(name):
        read = reader(name)

        def wrapped(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return wrapped

    monkeypatch.setattr(registry, "reader", keep)
    out = _run(SEED + 1, 0.2, traced=True)
    assert out["correct"] is True
    want = {m["name"] for m in registry.cell(CELL).per_layer}
    assert {"k2_roofline", "train.views_ms.sgl", "train.mfu.graph",
            "device.idle_share.train_graph", "train.runner_idle_ms.graph", "setup.data_s",
            "setup.device_build_s"} == want
    # the CPU gives no device time: only the set-up spans are read
    assert set(out["metrics"]) == {"setup.data_s", "setup.device_build_s"}
    spans = trace.totals(profiled=True)
    epochs = out["samples"]["epochs"]
    assert spans["views.keep"].count == spans["views.weights"].count == epochs >= 1
    assert trace.totals(profiled=False)["views.keep"].count == 1  # the check steps' epoch
    assert trace.counts() == {"layout.EllAdj": 2, "sampler.csr": 1}
    calls = seen["ctx"].k1_calls
    n_layers = registry.cell(CELL).config["conf"]["SGL"]["n_layer"]
    assert calls and all(isinstance(c, K2Call) for c in calls)
    assert len(calls) == 2 * n_layers * seen["ctx"].rec["steps"]
    assert {(c.p, c.d, c.dtype, c.capturing) for c in calls} == {(3, 64, "float32", False)}


def test_the_family_refuses_the_bitmap_sampler():
    with pytest.raises(RuntimeError, match="the bitmap sampler"):
        _run(SEED + 2)


def _no_layer0(self, params, aux):
    ego = self._ego(params)
    w_stack = torch.stack([self._w_clean, aux["w1"], aux["w2"]])
    x = torch.cat([ego, ego, ego], dim=1)
    acc = torch.zeros_like(x)
    for _ in range(self.n_layers):
        x = graph.spmm_packed(self._view_template, w_stack, x, 3)
        acc = acc + x
    out = acc / self.n_layers
    d = self.emb_size
    return out[:, :d], out[:, d: 2 * d], out[:, 2 * d:]


def _not_renormalized(self, keep):
    return torch.cat([keep, keep]).to(torch.float32) * self._w_clean


def _repeated_anchors(idx, size):
    return torch.where(idx >= 0, idx, torch.zeros_like(idx)), idx >= 0


FAULTS = {"layer 0 dropped from the mean": (sgl.SGL, "_propagated_views", _no_layer0),
          "views not renormalized": (sgl.SGL, "_view_weights", _not_renormalized),
          "InfoNCE over repeated anchors": (sgl, "unique_with_mask", _repeated_anchors)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_fails_a_limit(csr, monkeypatch, fault):
    owner, attr, value = FAULTS[fault]
    monkeypatch.setattr(owner, attr, value)
    out = _run(SEED + 3)
    assert out["correct"] is False
    assert any(number > limit for number, limit in out["checks"].values()), out["checks"]


def test_k2_bound_by_hand():
    call = K2Call(v=10, k=16, p=3, d=64, dtype="float32", n_rows=7, n_src=6, n_slots=2,
                  capturing=False)
    nbytes = 10 * 16 * 4 + 3 * 10 * 16 * 4 + 6 * 192 * 4 + 7 * 192 * 4 + 2 * 2 * 192 * 4
    assert k2_bytes(call) == nbytes
    assert k2_bound_s(call) == max(nbytes / HBM_BYTES_PER_S, 2 * 10 * 16 * 3 * 64 / PEAK["float32"])
    assert k2_bytes(call._replace(dtype="bfloat16")) == nbytes - 6 * 192 * 2
    with pytest.raises(ValueError):
        k2_bytes(call._replace(dtype="float16"))


def test_k2_reader_counts_replays_and_reads_none_without_k2():
    read = registry.reader("k2_roofline")
    eager = K2Call(100, 16, 3, 64, "float32", 50, 50, 4, False)
    captured = eager._replace(capturing=True)
    base = dict(rec={"epochs": 1, "steps": 10}, k1_calls=[eager, captured, captured],
                k1_launches=11)
    run = SimpleNamespace(trace={"busy_s": 1.0, "kernels": {
        "void (anonymous namespace)::ell_items_kernel<float>(x)": 0.75e-3,
        "void (anonymous namespace)::ell_long_rows_kernel(x)": 0.25e-3, "other": 5.0}}, **base)
    one = k2_bound_s(eager)
    # one eager call, then a graph of two calls replayed 5 times: 11 launches
    assert read(run) == pytest.approx(100 * (one + 5 * 2 * one) / 1e-3)
    assert read(SimpleNamespace(trace={"busy_s": 1.0, "kernels": {"other": 1.0}}, **base)) is None
    # K1's calls, as the graph family records them, are not K2's
    k1 = dict(base, k1_calls=[(100, 200, 64, "bfloat16", False)])
    assert read(SimpleNamespace(trace=run.trace, **k1)) is None
    assert read(SimpleNamespace(trace=None, **base)) is None
