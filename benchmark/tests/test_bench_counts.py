"""The operations and bytes behind the per-layer shares, on small shapes
worked out by hand, and the readers' arithmetic on made-up runs."""

from types import SimpleNamespace

import numpy as np
import pytest

import _small  # noqa: F401  (puts the checkout on the path)
from benchmark.core import peaks, registry
from benchmark.reference import sasrec, simgcl


def test_k1_bound_bytes_and_operations():
    # (U, I) = (100, 200), width 64: bytes of B once, operands, f32 outputs
    b = 100 * 200 + 300 * 64 * 2 + 300 * 64 * 4
    assert peaks.k1_bound_s(100, 200, 64, "bfloat16") == pytest.approx(
        max(4 * 100 * 200 * 64 / 989e12, b / 3.35e12))
    # f32 operands: three bf16 products, f32 operand bytes
    b32 = 100 * 200 + 300 * 64 * 4 + 300 * 64 * 4
    assert peaks.k1_bound_s(100, 200, 64, "float32") == pytest.approx(
        max(3 * 4 * 100 * 200 * 64 / 989e12, b32 / 3.35e12))
    b8 = 100 * 200 + 300 * 64 + 300 * 64 * 4
    assert peaks.k1_bound_s(100, 200, 64, "int8") == pytest.approx(
        max(4 * 100 * 200 * 64 / 1979e12, b8 / 3.35e12))
    with pytest.raises(ValueError):
        peaks.k1_bound_s(1, 1, 1, "float16")


def test_k1_bound_at_yelp_scale_matches_the_kernel_table():
    # PERF.md's kernel table: bf16 D 64 0.367653 ms (bytes), D 192 0.935629
    # ms (operations), f32 D 192 2.806887 ms (operations)
    assert peaks.k1_bound_s(31667, 38048, 64, "bfloat16") * 1e3 == pytest.approx(0.367653, rel=1e-4)
    assert peaks.k1_bound_s(31667, 38048, 192, "bfloat16") * 1e3 == pytest.approx(0.935629, rel=1e-4)
    assert peaks.k1_bound_s(31667, 38048, 192, "float32") * 1e3 == pytest.approx(2.806887, rel=1e-4)


def test_simgcl_step_flops_by_hand():
    conf = {"embedding.size": 4, "batch.size": 8, "SimGCL": {"n_layer": 2}}
    inputs = {"train_u": np.zeros(10)}
    prop = 2 * 2 * 2 * (2 * 10 * 12)     # hops, fwd+bwd, directions, 2·nnz·3D
    infonce = 2 * 3 * (2 * 8 * 8 * 4)    # users and items, three products
    bpr = 3 * 2 * (2 * 8 * 4)
    assert simgcl.step_flops(inputs, conf) == prop + infonce + bpr


def test_sasrec_step_flops_by_hand():
    conf = {"embedding.size": 4, "batch.size": 2, "max.len": 3, "SASRec": {"n_blocks": 1}}
    block = 6 * 2 * 2 * 3 * 16 + 2 * 2 * 2 * 9 * 4
    logits = 2 * 2 * 2 * 3 * 4
    assert sasrec.step_flops({}, conf) == 3 * (block + logits)


def _run(**kw):
    base = dict(rec={"epochs": 1, "steps": 10, "evals_s": [], "train_s": 2.0,
                     "train_samples": 100}, trace=None, k1_calls=[], k1_launches=0,
                spans=SimpleNamespace(total={}), setup_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


def test_k1_reader_counts_replays():
    read = registry.reader("k1_roofline")
    calls = [(100, 200, 64, "bfloat16", False), (100, 200, 64, "bfloat16", True),
             (100, 200, 64, "float32", True)]
    one = peaks.k1_bound_s(100, 200, 64, "bfloat16")
    f32 = peaks.k1_bound_s(100, 200, 64, "float32")
    # one eager call, then a graph of two calls replayed 5 times: 11 launches
    run = _run(trace={"busy_s": 1.0, "kernels": {"void dual_float_kernel<64, 1>(x)": 1e-3,
                                                 "other": 5.0}},
               k1_calls=calls, k1_launches=11)
    assert read(run) == pytest.approx(100 * (one + 5 * (one + f32)) / 1e-3)
    assert read(_run(trace={"busy_s": 1.0, "kernels": {"other": 1.0}}, k1_calls=calls)) is None
    assert read(_run()) is None


def test_mfu_idle_and_eval_readers():
    fam = SimpleNamespace(SAMPLES="seqs")
    conf = {"embedding.size": 4, "batch.size": 2, "max.len": 3, "SASRec": {"n_blocks": 1}}
    run = _run(trace={"busy_s": 0.5, "window_s": 2.0}, family=fam, reference=sasrec,
               inputs={}, conf=conf, cfg={"precision": "float32"})
    want = 100 * sasrec.step_flops({}, conf) * 10 / (2.0 * 67e12)
    assert registry.reader("train.mfu.seq")(run) == pytest.approx(want)
    assert registry.reader("train.mfu.graph")(run) is None
    assert registry.reader("device.idle_share.train_seq")(run) == pytest.approx(75.0)
    assert registry.reader("train_seqs_per_s")(run) == pytest.approx(50.0)
    evals = _run(rec={"epochs": 0, "steps": 0, "evals_s": [0.1] * 19 + [0.3]},
                 spans=SimpleNamespace(total={"eval.rank": 1.0, "eval.host": 0.5}),
                 trace={"busy_s": 0.4, "window_s": 2.0})
    assert registry.reader("eval_ms")(evals) == pytest.approx(110.0)
    assert registry.reader("eval_ms_p95")(evals) == pytest.approx(100.0)
    assert registry.reader("eval.rank_ms")(evals) == pytest.approx(50.0)
    assert registry.reader("eval.host_ms")(evals) == pytest.approx(25.0)
    assert registry.reader("device.idle_share.eval")(evals) == pytest.approx(80.0)
