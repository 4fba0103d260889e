"""The port end to end on the CPU: the session and the CLI train SimGCL on
the tiny block-structured dataset, on the dense layout
(``SELFREC_TPU_DENSE=1``; the CPU's default is ELL), write the reference-format artifacts and
beat random (random Recall@10 is about 10/60 = 0.17), as
tests/test_models_e2e.py holds the JAX package."""

import glob
import os
import subprocess
import sys

import pytest

from selfrec_tpu_torch import ModelConf, SelfRecTorch
from selfrec_tpu_torch.ops import dense_dual
from selfrec_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _conf(out_dir, **extra):
    conf = {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": "SimGCL", "type": "graph"},
        "item.ranking.topN": [5, 10], "embedding.size": 16, "max.epoch": 8,
        "batch.size": 64, "learning.rate": 0.05, "reg.lambda": 0.0001,
        "output": str(out_dir), "seed": 42,
        "SimGCL": {"n_layer": 2, "lambda": 0.5, "eps": 0.1},
    }
    conf.update(extra)
    return ModelConf(conf)


@pytest.mark.parametrize("mode", ["int8", "float32"])
def test_session_trains_simgcl_and_beats_random(tmp_path, tiny_graph_dataset,
                                                monkeypatch, mode):
    monkeypatch.setenv("SELFREC_TPU_DENSE", "1")
    monkeypatch.setenv("SELFREC_TPU_DENSE_DTYPE", mode)
    train, test = tiny_graph_dataset
    launches = dense_dual.dual_matmul.launches
    rec_list = SelfRecTorch(_conf(tmp_path), device="cpu", training_data=train,
                            test_data=test).execute()
    assert dense_dual.dual_matmul.launches == launches  # CPU: plain version
    assert len(rec_list) == len({u for u, _, _ in test})
    perf = metrics.parse_measure(
        metrics.ranking_evaluation({u: {i: 1.0} for u, i, _ in test}, rec_list, [10]))
    assert perf["Recall"] > 0.2
    rated = {}
    for u, i, _ in train:
        rated.setdefault(u, set()).add(i)
    for user, recs in rec_list.items():
        assert len(recs) == 10 and not rated[user] & {r[0] for r in recs}
    assert len(glob.glob(str(tmp_path / "SimGCL@*-top-10items.txt"))) == 1
    perf_files = glob.glob(str(tmp_path / "SimGCL@*-performance.txt"))
    assert len(perf_files) == 1
    assert open(perf_files[0]).read().startswith("Top 5\n")


def test_cli_runs_on_the_cpu(tmp_path, tiny_graph_dataset):
    train, test = tiny_graph_dataset
    for name, rows in (("train.txt", train), ("test.txt", test)):
        with open(tmp_path / name, "w") as f:
            f.writelines(f"{u} {i} {w}\n" for u, i, w in rows)
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "selfrec_tpu_torch", "--conf",
           os.path.join(REPO, "conf", "SimGCL.yaml"), "--device", "cpu",
           "--set", f"training.set={tmp_path / 'train.txt'}",
           "--set", f"test.set={tmp_path / 'test.txt'}",
           "--set", "max.epoch=2", "--set", "batch.size=64",
           "--set", "embedding.size=16", "--set", f"output={out}/"]
    env = dict(os.environ, PYTHONPATH=REPO, SELFREC_TPU_DENSE="1",
               SELFREC_TPU_DENSE_DTYPE="int8")
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "Device: cpu" in proc.stdout
    assert len(glob.glob(str(out / "SimGCL@*-performance.txt"))) == 1


def test_cli_refuses_cuda_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "selfrec_tpu_torch", "--model",
                           "SimGCL"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
