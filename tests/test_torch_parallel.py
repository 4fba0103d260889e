"""The port's scale-out (``selfrec_tpu_torch.parallel`` and the trainers
under a mesh) on gloo process groups of CPU processes
(tests/_torch_dist_worker.py): the mesh and its collectives, the sharded
top-k against the JAX package's ``make_sharded_topk``, one epoch or more of
SimGCL (dense and ELL), SGL (dense and ELL views), BUIR and NCL on the halo
layout, SASRec, SEPT's joint phase and MHCN on ``ShardedDenseMat`` under a
(2, 2) mesh against the port's
single-device run within the JAX package's tolerances
(tests/test_parallel.py:58-59, :127-132), data replicas bit-equal,
checkpoint/resume under the mesh against a continuous run, and a
two-process ``distributed: true`` session."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _social_data import MHCN_EXTRA, SEPT_EXTRA, social_conf_dict, social_relations
from _torch_dist_worker import REPO, DistGroup, free_port
from selfrec_tpu.ops import ranking as jax_ranking
from selfrec_tpu.parallel.mesh import build_mesh as jax_mesh
from selfrec_tpu.parallel.topk import make_sharded_topk as jax_sharded_topk
from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.parallel import mesh as mesh_lib

MESH = {"data": 2, "model": 2}
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_parallel.py:58-59
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_parallel.py:127-132


@pytest.fixture(scope="module")
def group():
    g = DistGroup(4, timeout=240)
    yield g
    g.close()


def graph_conf(name="SimGCL", **top):
    conf = {"training.set": "<memory>", "test.set": "<memory>",
            "model": {"name": name, "type": "graph"}, "item.ranking.topN": [5, 10],
            "embedding.size": 16, "max.epoch": 2, "batch.size": 64,
            "learning.rate": 0.05, "reg.lambda": 0.0001,
            "SimGCL": {"n_layer": 2, "lambda": 0.5, "eps": 0.1},
            "SGL": {"n_layer": 2, "lambda": 0.1, "drop_rate": 0.1, "aug_type": 1,
                    "temp": 0.2},
            "output": "/tmp/selfrec_tpu_torch_test_results/", "seed": 42}
    conf.update(top)
    return conf


def seq_data():
    """tests/test_parallel.py's sequences: 64 windows over 20 items."""
    rng = np.random.default_rng(11)
    train, test = {}, {}
    for s in range(64):
        start = int(rng.integers(0, 20))
        length = int(rng.integers(6, 14))
        train[f"s{s}"] = [f"i{(start + k) % 20}" for k in range(length)]
        test[f"s{s}"] = [f"i{(start + length) % 20}"]
    return train, test


def seq_conf(**top):
    conf = {"training.set": "<memory>", "test.set": "<memory>",
            "model": {"name": "SASRec", "type": "sequential"},
            "item.ranking.topN": [5, 10], "embedding.size": 32, "max.epoch": 1,
            "batch.size": 32, "learning.rate": 0.01, "reg.lambda": 0.0001, "max.len": 16,
            "SASRec": {"n_blocks": 1, "drop_rate": 0.0, "n_heads": 2},
            "output": "/tmp/selfrec_tpu_torch_test_results/", "seed": 3}
    conf.update(top)
    return conf


# -- the mesh ------------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [((None, None), (1, 1)), ((1, None), (1, 1)),
                                        ((None, 1), (1, 1)), ((1, 1), (1, 1))])
def test_build_mesh_defaults_without_a_process_group(shape, want):
    m = mesh_lib.build_mesh(*shape)
    j = jax_mesh(*shape, devices=jax.devices()[:1])
    assert (m.shape["data"], m.shape["model"]) == want == j.devices.shape
    assert m.rank == 0 and m.coords == (0, 0)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2), (8, 1)])
def test_mesh_above_the_world_raises_as_jax(shape):
    with pytest.raises(ValueError) as mine:
        mesh_lib.build_mesh(*shape)
    with pytest.raises(ValueError) as theirs:
        jax_mesh(*shape, devices=jax.devices()[:1])
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (4, 1), (1, 4)])
def test_collectives_over_each_axis(group, shape):
    """psum, psum_scatter, all_gather and all_to_all (tiled on the first
    dimension) over data, model and the grid, against numpy; bf16 moves as
    its bytes, and a bf16 sum over gloo raises instead of adding bytes."""
    res = [r for r in group.run("case_collectives", shape=shape) if r is not None]
    nd, nm = shape
    assert [r["rank"] for r in res] == list(range(nd * nm))
    members = {"data": lambda d, s: [dd * nm + s for dd in range(nd)],
               "model": lambda d, s: [d * nm + ss for ss in range(nm)],
               "grid": lambda d, s: list(range(nd * nm))}
    for r in res:
        d, s = r["coords"]
        assert divmod(r["rank"], nm) == (d, s)
        for axis, ranks in members.items():
            ranks = ranks(d, s)
            n, me = len(ranks), ranks.index(r["rank"])
            x = [np.arange(12, dtype=np.float32).reshape(4, 3) * (q + 1) for q in ranks]
            y = [np.arange(2 * n * 3, dtype=np.float32).reshape(2 * n, 3) + 100 * q
                 for q in ranks]
            out = r["out"][axis]
            np.testing.assert_array_equal(out["psum"], sum(x))
            np.testing.assert_array_equal(out["psum_scatter"], sum(y)[2 * me: 2 * me + 2])
            np.testing.assert_array_equal(out["all_gather"], np.concatenate(x))
            np.testing.assert_array_equal(out["all_gather_bf16"], np.concatenate(x))
            np.testing.assert_array_equal(out["all_to_all"], np.concatenate(
                [yy[2 * me: 2 * me + 2] for yy in y]))
            assert out["bf16_sums_raise"] == [n > 1, n > 1]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_sharded_topk_ids_equal_jax(group, shape):
    rng = np.random.default_rng(0)
    b, n_items, k = 16, 48, 10
    u = rng.standard_normal((b, 8)).astype(np.float32)
    items = rng.standard_normal((n_items, 8)).astype(np.float32)
    items[5] = items[29]  # two items of equal score in different shards
    rows = np.concatenate([rng.integers(0, b, 40), np.full(8, b)]).astype(np.int64)
    cols = np.concatenate([rng.integers(0, n_items, 40), np.zeros(8)]).astype(np.int64)
    fn = jax_sharded_topk(jax_mesh(*shape), n_items, k)
    ref_s, ref_i = fn(jnp.asarray(u), jnp.asarray(items), jnp.asarray(rows, jnp.int32),
                      jnp.asarray(cols, jnp.int32))
    dense_s, dense_i = jax_ranking.topk_scores(jnp.asarray(u), jnp.asarray(items),
                                               jnp.asarray(rows, jnp.int32),
                                               jnp.asarray(cols, jnp.int32), k)
    np.testing.assert_array_equal(np.asarray(ref_i), np.asarray(dense_i))
    for r in group.run("case_topk", shape=shape, u_block=u, item_emb=items, rows=rows,
                       cols=cols, k=k):
        if r is None:
            continue
        np.testing.assert_array_equal(r["ids"], np.asarray(ref_i))
        np.testing.assert_allclose(r["scores"], np.asarray(ref_s), rtol=1e-6, atol=1e-6)


# -- models under a (2, 2) mesh against the single-device port ----------------------

def single_run(conf, train, test, epochs, social=None, env=None, attrs=None):
    """The port's single-device run, on one thread as the ranks run: the
    order of a multi-threaded f32 matmul's sums alone moves SSL4Rec's
    towers by up to 2e-2 after an epoch (Adam scales near-zero gradients'
    rounding)."""
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = {"social.data": social} if social is not None else {}
        model = get_model_class(conf["model"]["name"])(ModelConf(dict(conf)), train, test,
                                                       device="cpu", **kw)
        for k, v in (attrs or {}).items():
            setattr(model, k, v)
        model.build()
        losses = np.concatenate([np.asarray(model.run_epoch(e)) for e in range(epochs)])
        params = {k: v.detach().numpy() for k, v in model.params.items()}
        rec = None
        if conf["model"]["type"] == "graph":
            model.user_emb, model.item_emb = model.embeddings()
            rec = {u: [i for i, _ in r] for u, r in model.test().items()}
        return losses, params, rec
    finally:
        torch.set_num_threads(threads)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_against_single(res, single, param_tol=PARAM_TOL, loss_tol=LOSS_TOL, keys=None):
    """Every rank's losses and params near the single-device run's, the
    data replicas' shards bit-equal and the ranks' full params equal."""
    losses, params, rec = single
    for r in res:
        np.testing.assert_allclose(r["losses"], losses, **loss_tol)
        for k in keys or params:
            np.testing.assert_allclose(r["params"][k], params[k], err_msg=k, **param_tol)
            np.testing.assert_array_equal(r["params"][k], res[0]["params"][k])
    by_shard = {}
    for r in res:
        by_shard.setdefault(r["coords"][1], []).append(r["shards"])
    for replicas in by_shard.values():
        for other in replicas[1:]:
            for k in other:
                np.testing.assert_array_equal(other[k], replicas[0][k], err_msg=k)
    if rec is not None:
        n_same = sum(r == rec[u] for u, r in res[0]["rec"].items())
        assert n_same >= 0.95 * len(rec)


@pytest.mark.parametrize("arm,env,layout", [
    ("dense", {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"},
     "ShardedDenseAdj"),
    ("ell", {"SELFREC_TPU_DENSE": "0"}, "HaloAdj")])
def test_simgcl_epoch_matches_single_device(group, tiny_graph_dataset, arm, env, layout):
    train, test = tiny_graph_dataset
    conf = graph_conf()
    single = single_run(conf, train, test, 1, env=env)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=1, env=env)
    assert {r["adj"] for r in res} == {layout}
    assert all(r["sharded_topk"] for r in res)
    check_against_single(res, single)


def test_sgl_dense_views_match_single_device(group, tiny_graph_dataset):
    train, test = tiny_graph_dataset
    env = {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"}
    conf = graph_conf("SGL")
    single = single_run(conf, train, test, 2, env=env)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=2, env=env)
    assert {(r["adj"], r["_view1"]) for r in res} == {("ShardedDenseAdj", "ShardedDenseAdj")}
    check_against_single(res, single)


def test_sgl_ell_views_match_single_device(group, tiny_graph_dataset):
    train, test = tiny_graph_dataset
    env = {"SELFREC_TPU_DENSE": "0"}
    conf = graph_conf("SGL")
    single = single_run(conf, train, test, 1, env=env)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=1, env=env)
    assert {r["_view_template"] for r in res} == {"HaloAdj"}
    check_against_single(res, single)


@pytest.mark.parametrize("name,extra,attrs", [
    ("BUIR", {"n_layer": 2, "drop_rate": 0.2, "tau": 0.995}, {}),
    ("NCL", {"n_layer": 2, "ssl_reg": 1e-6, "proto_reg": 1e-7, "tau": 0.05,
             "hyper_layers": 1, "alpha": 1.5, "num_clusters": 4}, {"warm_up_epochs": 0})])
def test_halo_models_with_aux_state_match_single_device(group, tiny_graph_dataset, name,
                                                        extra, attrs):
    """BUIR (per-step dropout over the HaloAdj, target tables in ``aux``
    updated from the gathered params) and NCL in its prototype phase
    (k-means over the gathered tables each epoch) on the ELL arm under
    (2, 2)."""
    train, test = tiny_graph_dataset
    env = {"SELFREC_TPU_DENSE": "0"}
    conf = graph_conf(name, **{name: extra})
    single = single_run(conf, train, test, 1, env=env, attrs=attrs)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=1, env=env, attrs=attrs)
    assert {r["adj"] for r in res} == {"HaloAdj"}
    check_against_single(res, single)


@pytest.mark.parametrize("name,env", [
    ("LightGCN", {"SELFREC_TPU_DENSE": "0"}),
    ("XSimGCL", {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"}),
    ("DirectAU", {"SELFREC_TPU_DENSE": "0"}),
    ("MixGCF", {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"}),
    ("SelfCF", {"SELFREC_TPU_DENSE": "0"}),
    ("SSL4Rec", {}),
    ("MF", {})])
def test_other_graph_models_match_single_device(group, tiny_graph_dataset, name, env):
    """The rest of the graph family at its defaults under (2, 2): the
    trainer's gather, gradient sums and sharded layouts serve every model
    unchanged."""
    train, test = tiny_graph_dataset
    conf = graph_conf(name)
    single = single_run(conf, train, test, 1, env=env)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=1, env=env)
    check_against_single(res, single)


@pytest.mark.parametrize("name,extra", [
    ("SASRec", {"n_blocks": 1, "drop_rate": 0.0, "n_heads": 2}),
    ("CL4SRec", {"n_blocks": 1, "drop_rate": 0.1, "n_heads": 2, "aug_type": 0,
                 "aug_rate": 0.5, "cl_rate": 0.05}),
    ("BERT4Rec", {"n_blocks": 1, "drop_rate": 0.1, "n_heads": 2, "mask_rate": 0.5})])
def test_sasrec_epoch_matches_single_device(group, name, extra):
    """tests/test_parallel.py:101-137 on the port, and the other two
    sequential models (their augmentation and dropout draws come from the
    same step generator on every rank)."""
    train, test = seq_data()
    conf = seq_conf(model={"name": name, "type": "sequential"}, **{name: extra})
    single = single_run(conf, train, test, 1)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=1)
    check_against_single(res, single)


def test_sept_joint_phase_matches_single_device(group, tiny_graph_dataset):
    """SEPT across the warm/joint boundary on the ELL arm: the union and
    bipartite templates become HaloAdj packed chains (P = 2)."""
    train, test = tiny_graph_dataset
    conf = social_conf_dict("SEPT", SEPT_EXTRA)
    env = {"SELFREC_TPU_DENSE": "0"}
    social = social_relations()
    single = single_run(conf, train, test, 4, social=social, env=env)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=4, social=social, env=env)
    assert {(r["_view_template"], r["_social_template"]) for r in res} == {
        ("HaloAdj", "HaloAdj")}
    check_against_single(res, single, param_tol=LOSS_TOL)


def test_mhcn_on_sharded_dense_mat_matches_single_device(group, tiny_graph_dataset):
    train, test = tiny_graph_dataset
    conf = social_conf_dict("MHCN", MHCN_EXTRA, learning_rate=0.02)
    env = {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"}
    social = social_relations()
    single = single_run(conf, train, test, 2, social=social, env=env)
    res = group.run("case_train", conf=dict(conf, mesh=MESH), train=train, test=test,
                    epochs=2, social=social, env=env)
    assert {tuple(r["H"]) for r in res} == {("ShardedDenseMat",) * 3}
    check_against_single(res, single, param_tol=LOSS_TOL)


def test_checkpoint_resume_under_mesh_matches_continuous_run(group, tiny_graph_dataset,
                                                             tmp_path):
    """tests/test_checkpoint.py:81-109 on the port: rank 0 writes the full
    state, every rank restores its rows."""
    train, test = tiny_graph_dataset
    conf = dict(graph_conf(), mesh=MESH, output=str(tmp_path / "out") + "/")
    res = group.run("case_resume", conf=conf, train=train, test=test,
                    ckpt_dir=str(tmp_path / "ckpt"), full_epochs=4, first_epochs=2)
    for r in res:
        for k in r["full"]:
            np.testing.assert_allclose(r["resumed"][k], r["full"][k], rtol=2e-3, atol=2e-4)
    state = torch.load(tmp_path / "ckpt" / "step_2" / "state.pt", weights_only=True)
    assert state["params"]["user_emb"].shape == (40, 16)  # full, not a row block
    np.testing.assert_array_equal(state["params"]["user_emb"].numpy(),
                                  res[0]["first"]["user_emb"])


def test_two_process_distributed_session(tmp_path, tiny_graph_dataset):
    """``python -m selfrec_tpu_torch`` in two processes with torchrun's
    environment and ``distributed: true``: both join one gloo group over a
    1x2 mesh, train, and rank 0 alone writes the results."""
    train, test = tiny_graph_dataset
    for name, rows in (("train.txt", train), ("test.txt", test)):
        with open(tmp_path / name, "w") as f:
            f.writelines(f"{u} {i} {w}\n" for u, i, w in rows)
    out = tmp_path / "out"
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   SELFREC_TPU_DIST_TIMEOUT_S="120")
        cmd = [sys.executable, "-m", "selfrec_tpu_torch", "--conf",
               os.path.join(REPO, "conf", "SimGCL.yaml"), "--device", "cpu",
               "--set", f"training.set={tmp_path / 'train.txt'}",
               "--set", f"test.set={tmp_path / 'test.txt'}", "--set", "max.epoch=1",
               "--set", "batch.size=64", "--set", "embedding.size=16",
               "--set", "distributed=true", "--set", "mesh.model=2",
               "--set", f"output={out}/"]
        procs.append(subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, text[-3000:]
        assert f"process {rank}/2, device cpu, backend gloo" in text
    assert len(glob.glob(str(out / "SimGCL@*-performance.txt"))) == 1
