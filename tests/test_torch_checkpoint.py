"""Checkpoint/resume and the profiler hook of the port's trainer
(selfrec_tpu_torch.utils.checkpoint, TorchGraphRecommender.train), as
tests/test_checkpoint.py and tests/test_untested_surfaces.py hold the JAX
package's.

A run stopped after epoch 2 and resumed to epoch 4 equals a continuous
4-epoch run exactly on the CPU, aux included (SelfCF's history buffers): the epoch shuffles are functions of (seed,
epoch), the step generator's state is restored, and every CPU op here is
deterministic. The sequential trainer resumes the same way, its best
params in the checkpoint. (chip_smoke.py makes the same comparison on the card, held
to the JAX test's rtol 2e-3 / atol 2e-4.)
"""

import json
import os

import pytest
import torch

from selfrec_tpu_torch.config import ModelConf
from selfrec_tpu_torch.models import get_model_class
from selfrec_tpu_torch.utils import checkpoint as ckpt

from _social_data import SEPT_EXTRA, social_conf_dict, social_relations

CASES = {
    "MF": ({}, {}),
    "XSimGCL-ell": ({"n_layer": 2, "l_star": 1, "lambda": 0.2, "eps": 0.2, "tau": 0.15},
                    {"SELFREC_TPU_DENSE": "0"}),
    "XSimGCL-int8": ({"n_layer": 2, "l_star": 1, "lambda": 0.2, "eps": 0.2, "tau": 0.15},
                     {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "int8"}),
    # the CSR sampler (bitmap over budget) and the host shuffle
    "MF-csr-hostbatches": ({}, {"SELFREC_TPU_NEG_BITMAP_MB": "0.0001",
                                "SELFREC_TPU_HOST_BATCHES": "1"}),
    # history buffers in aux, dotted predictor keys in Adam's state
    "SelfCF-bf16": ({"n_layer": 2, "tau": 0.05},
                    {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "bfloat16"}),
}


def _conf(tmp_path, case, max_epoch, **extra):
    name = case.split("-")[0]
    conf = {
        "training.set": "<memory>", "test.set": "<memory>",
        "model": {"name": name, "type": "graph"},
        "item.ranking.topN": [5, 10], "embedding.size": 16, "max.epoch": max_epoch,
        "batch.size": 64, "learning.rate": 0.05, "reg.lambda": 0.0001,
        "output": str(tmp_path / "out"), "seed": 42, name: CASES[case][0],
        "checkpoint.dir": str(tmp_path / "ckpt"), "checkpoint.interval": 2,
    }
    conf.update(extra)
    return ModelConf(conf)


def _run(dataset, conf):
    train, test = dataset
    model = get_model_class(conf["model"]["name"])(conf, train, test, device="cpu")
    model.build()
    model.train()
    return model


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_at_epoch_two_equals_a_continuous_run(tiny_graph_dataset, tmp_path,
                                                     monkeypatch, case):
    for k, v in CASES[case][1].items():
        monkeypatch.setenv(k, v)
    full = _run(tiny_graph_dataset, _conf(tmp_path / "full", case, 4))
    first = _run(tiny_graph_dataset, _conf(tmp_path, case, 2))
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 2
    resumed = _run(tiny_graph_dataset, _conf(tmp_path, case, 4))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2", "step_4"]
    assert not torch.equal(first.params["user_emb"], full.params["user_emb"])
    assert list(resumed.params) == list(full.params)
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
    assert set(resumed.aux) == set(full.aux)
    for k in full.aux:
        assert torch.equal(resumed.aux[k], full.aux[k]), k
    for a, b in zip(resumed.optimizer.state_dict()["state"].values(),
                    full.optimizer.state_dict()["state"].values()):
        assert float(a["step"]) == float(b["step"]) == 4 * -(-first.data.n_edges // 64)
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert torch.equal(resumed.generator.get_state(), full.generator.get_state())
    assert resumed.best_performance == full.best_performance


def test_resume_does_not_care_which_sampler_ran(tiny_graph_dataset, tmp_path, monkeypatch):
    """Two epochs on the CSR sampler, resumed to four on the bitmap sampler,
    equal four continuous epochs on the bitmap sampler: both samplers draw
    the same negatives from the step generator, whose state the checkpoint
    keeps."""
    full = _run(tiny_graph_dataset, _conf(tmp_path / "full", "MF", 4))
    monkeypatch.setenv("SELFREC_TPU_NEG_BITMAP_MB", "0.0001")
    first = _run(tiny_graph_dataset, _conf(tmp_path, "MF", 2))
    assert first._rated_bitmap is None
    monkeypatch.delenv("SELFREC_TPU_NEG_BITMAP_MB")
    resumed = _run(tiny_graph_dataset, _conf(tmp_path, "MF", 4))
    assert resumed._rated_bitmap is not None
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
    assert torch.equal(resumed.best_user_emb, full.best_user_emb)


# How Adam's state may stand in a checkpoint of the port: as a
# non-capturable Adam writes it (the CPU's, and the card's before the port's
# steps ran as CUDA graphs), as the card's capturable Adam writes it, and
# with the step count in another float type
ADAM_FORMS = ("non-capturable", "capturable", "float64-step")


@pytest.mark.parametrize("form", ADAM_FORMS)
def test_resume_from_each_adam_form_equals_a_continuous_run(tiny_graph_dataset, tmp_path,
                                                            monkeypatch, form):
    """A checkpoint whose Adam state says another ``capturable`` than the
    live optimizer, or holds its step in float64, loads: the live
    optimizer's param groups stay, the state goes into them, and the
    resumed run equals the continuous one exactly, aux included."""
    for k, v in CASES["SelfCF-bf16"][1].items():
        monkeypatch.setenv(k, v)
    full = _run(tiny_graph_dataset, _conf(tmp_path / "full", "SelfCF-bf16", 4))
    _run(tiny_graph_dataset, _conf(tmp_path, "SelfCF-bf16", 2))
    path = tmp_path / "ckpt" / "step_2" / ckpt.STATE_FILE
    state = torch.load(path, weights_only=True)
    for group in state["optimizer"]["param_groups"]:
        group["capturable"] = form == "capturable"
    if form == "float64-step":
        for st in state["optimizer"]["state"].values():
            st["step"] = st["step"].double()
    torch.save(state, path)
    resumed = _run(tiny_graph_dataset, _conf(tmp_path, "SelfCF-bf16", 4))
    assert not resumed.optimizer.defaults["capturable"]
    assert all(not g["capturable"] for g in resumed.optimizer.param_groups)
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
    for k in full.aux:
        assert torch.equal(resumed.aux[k], full.aux[k]), k
    for a, b in zip(resumed.optimizer.state_dict()["state"].values(),
                    full.optimizer.state_dict()["state"].values()):
        assert a["step"].dtype == torch.float32 and float(a["step"]) == float(b["step"])
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


@pytest.mark.cuda
def test_a_non_capturable_checkpoint_loads_into_the_cards_capturable_adam(tmp_path):
    """On the card the port's Adam is capturable (its steps run as CUDA
    graphs). A card checkpoint of a non-capturable Adam, as the port wrote
    them before, loads: the step count moves to the device, the moments
    and params are the checkpoint's, and the resumed graphed epoch matches
    the old optimizer's eager epoch within rtol 1e-5 / atol 1e-6 (the
    capturable Adam computes its bias correction on the device, which may
    differ in the last bits). Run with ``python -m pytest --noconftest -m
    cuda tests/test_torch_checkpoint.py`` on a machine with the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    train, test = synth_graph_mapped(40, 60, 400, seed=7)
    old = get_model_class("MF")(_conf(tmp_path, "MF", 3), train, test, device="cuda")
    old.build()
    old.optimizer = torch.optim.Adam(list(old.params.values()), lr=old.lrate,
                                     betas=(0.9, 0.999), eps=1e-8)
    for epoch in range(2):
        old.eager_batches(*old.epoch_batches(epoch))
    ckpt.save_checkpoint(str(tmp_path / "ckpt"), 2, ckpt.train_state(old))
    model = get_model_class("MF")(_conf(tmp_path, "MF", 3), train, test, device="cuda")
    model.build()
    assert model._maybe_resume() == 2
    assert model.optimizer.defaults["capturable"]
    for (k, p), q in zip(model.params.items(), old.params.values()):
        assert torch.equal(p.detach(), q.detach()), k
        st, want = model.optimizer.state[p], old.optimizer.state[q]
        assert st["step"].device.type == "cuda" and float(st["step"]) == float(want["step"])
        assert torch.equal(st["exp_avg"], want["exp_avg"])
    old.eager_batches(*old.epoch_batches(2))
    model.train_batches(*model.epoch_batches(2))
    assert model._graphs["train"].captures == 1
    for (k, p), q in zip(model.params.items(), old.params.values()):
        assert torch.allclose(p.detach(), q.detach(), rtol=1e-5, atol=1e-6), k


def test_checkpoint_preserves_best_tracking(tiny_graph_dataset, tmp_path):
    """As tests/test_checkpoint.py:61-78: best_performance and the best
    embeddings survive resume."""
    m1 = _run(tiny_graph_dataset, _conf(tmp_path, "MF", 2))
    assert m1.best_performance
    train, test = tiny_graph_dataset
    m2 = get_model_class("MF")(_conf(tmp_path, "MF", 4), train, test, device="cpu")
    m2.build()
    assert m2._maybe_resume() == 2
    assert m2.best_performance[0] == m1.best_performance[0]
    assert m2.best_performance[1] == m1.best_performance[1]
    assert torch.equal(m2.best_user_emb, m1.best_user_emb)
    assert torch.equal(m2.best_item_emb, m1.best_item_emb)


def test_state_is_tensors_on_the_cpu_loadable_with_weights_only(tiny_graph_dataset,
                                                                tmp_path):
    m = _run(tiny_graph_dataset, _conf(tmp_path, "MF", 2))
    path = tmp_path / "ckpt" / "step_2" / ckpt.STATE_FILE
    state = torch.load(path, weights_only=True)
    assert set(state) == {"params", "optimizer", "generator", "aux", "best"}
    assert state["generator"].dtype == torch.uint8
    assert state["best"]["perf"].tolist()[0] == m.best_performance[0]
    assert all(v.device.type == "cpu" for v in state["params"].values())
    step, again = ckpt.restore_checkpoint(str(tmp_path / "ckpt"))
    assert step == 2 and torch.equal(again["params"]["item_emb"], m.params["item_emb"])
    assert ckpt.restore_checkpoint(str(tmp_path / "nothing")) == (None, None)


def test_a_fresh_directory_starts_at_epoch_zero(tiny_graph_dataset, tmp_path):
    train, test = tiny_graph_dataset
    m = get_model_class("MF")(_conf(tmp_path, "MF", 1), train, test, device="cpu")
    m.build()
    assert m._maybe_resume() == 0


@pytest.mark.parametrize("max_epoch", [2, 3])
def test_profile_dir_writes_a_trace_and_leaves_none_active(tiny_graph_dataset, tmp_path,
                                                          max_epoch):
    """The second epoch of the process is traced; the trace stops before the
    third epoch or at the end of train()."""
    profile_dir = tmp_path / "trace"
    conf = _conf(tmp_path, "MF", max_epoch, **{"profile.dir": str(profile_dir)})
    m = _run(tiny_graph_dataset, conf)
    assert m._trace is None
    assert not torch.autograd.profiler._is_profiler_enabled
    files = os.listdir(profile_dir)
    assert len(files) == 1 and files[0].startswith("MF_epoch2_")
    with open(profile_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("Optimizer.step" in e.get("name", "") for e in events)


def test_resume_traces_the_second_epoch_it_runs(tiny_graph_dataset, tmp_path):
    _run(tiny_graph_dataset, _conf(tmp_path, "MF", 2))
    conf = _conf(tmp_path, "MF", 4, **{"profile.dir": str(tmp_path / "trace")})
    _run(tiny_graph_dataset, conf)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].startswith("MF_epoch4_")


SEPT_ARMS = {"ell": {"SELFREC_TPU_DENSE": "0"},
             "dense": {"SELFREC_TPU_DENSE": "1", "SELFREC_TPU_DENSE_DTYPE": "float32"}}


def _sept(dataset, tmp_path, tag):
    """SEPT at max.epoch 9 (joint from epoch 4 on), a checkpoint every 2
    epochs into ``tmp_path/tag``; built, not trained."""
    conf = social_conf_dict("SEPT", SEPT_EXTRA, max_epoch=9, **{
        "output": str(tmp_path / "out"), "checkpoint.dir": str(tmp_path / tag),
        "checkpoint.interval": 2})
    train, test = dataset
    model = get_model_class("SEPT")(ModelConf(conf), train, test, device="cpu",
                                    **{"social.data": social_relations()})
    model.build()
    return model


@pytest.mark.parametrize("resume_step", [6, 2])
@pytest.mark.parametrize("arm", sorted(SEPT_ARMS))
def test_sept_resumed_equals_a_continuous_run(tiny_graph_dataset, tmp_path, monkeypatch,
                                              arm, resume_step):
    """SEPT resumed at step 6 (inside the joint phase: the restored Adam
    moments are kept) or at step 2 (the warm phase: the joint phase's fresh
    Adam is made once, at the boundary) equals 9 continuous epochs bit for
    bit; either way the last Adam has run the joint phase's 5 epochs."""
    import shutil

    for k, v in SEPT_ARMS[arm].items():
        monkeypatch.setenv(k, v)
    full = _sept(tiny_graph_dataset, tmp_path, "full")
    full.train()
    assert full._joint_phase
    shutil.copytree(tmp_path / "full", tmp_path / "part")
    for step in (2, 4, 6, 8):
        if step > resume_step:
            shutil.rmtree(tmp_path / "part" / f"step_{step}")
    resumed = _sept(tiny_graph_dataset, tmp_path, "part")
    made = []
    make = resumed.make_optimizer
    monkeypatch.setattr(resumed, "make_optimizer", lambda p: made.append(1) or make(p))
    resumed.train()
    # the restore makes one optimizer; crossing the boundary one more
    assert len(made) == (1 if resume_step == 6 else 2)
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
    n_batches = -(-full.data.n_edges // full.batch_size)
    for a, b in zip(resumed.optimizer.state_dict()["state"].values(),
                    full.optimizer.state_dict()["state"].values()):
        assert float(a["step"]) == float(b["step"]) == 5 * n_batches
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def test_sept_continuous_run_makes_one_fresh_adam(tiny_graph_dataset, tmp_path,
                                                  monkeypatch):
    """Across the warm-to-joint boundary (epoch 3 to 4 of 9) the trainer
    gets one fresh Adam, and no other."""
    model = _sept(tiny_graph_dataset, tmp_path, "ckpt")
    phases = []
    run_epoch = model.run_epoch
    monkeypatch.setattr(model, "run_epoch", lambda e: (
        run_epoch(e), phases.append((e, model._joint_phase, id(model.optimizer))))[0])
    model.train()
    assert [j for _, j, _ in phases] == [False] * 4 + [True] * 5
    assert len({o for _, _, o in phases}) == 2
    assert phases[3][2] != phases[4][2] and len({o for _, _, o in phases[4:]}) == 1


SEQ_CASES = {  # dropout on: the step generator's draws must resume too
    "SASRec": {"drop_rate": 0.2},
    "CL4SRec": {"drop_rate": 0.2, "aug_type": 1},
    "BERT4Rec": {"drop_rate": 0.2},
}


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_sequential_resume_at_epoch_two_equals_a_continuous_run(tmp_path, name):
    """The sequential trainer shares the graph trainer's hooks: 2 epochs
    then resumed to 4 equal 4 continuous epochs exactly, Adam's state, the
    generator, the best params and best_performance included. One CPU
    thread: above their grain size torch's CPU index and scatter backward
    sum in an order that varies with the threads, run to run."""
    from _seq_data import seq_conf_dict, seq_dataset

    train, test = seq_dataset()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(tag, epochs):
        conf = ModelConf(dict(seq_conf_dict(name, SEQ_CASES[name]), **{
            "max.epoch": epochs, "checkpoint.dir": str(tmp_path / tag),
            "checkpoint.interval": 2, "output": str(tmp_path / "out")}))
        model = get_model_class(name)(conf, train, test, device="cpu")
        model.build()
        model.train()
        return model

    try:
        full = run("full", 4)
        first = run("resumed", 2)
        resumed = run("resumed", 4)
    finally:
        torch.set_num_threads(threads)
    assert sorted(os.listdir(tmp_path / "resumed")) == ["step_2", "step_4"]
    assert not torch.equal(first.params["item_emb"], full.params["item_emb"])
    assert list(resumed.params) == list(full.params)
    for k in full.params:
        assert torch.equal(resumed.params[k], full.params[k]), k
        assert torch.equal(resumed.best_params[k], full.best_params[k]), k
    for a, b in zip(resumed.optimizer.state_dict()["state"].values(),
                    full.optimizer.state_dict()["state"].values()):
        assert float(a["step"]) == float(b["step"]) == 4 * 4  # 120 sequences, batch 32
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert torch.equal(resumed.generator.get_state(), full.generator.get_state())
    assert resumed.best_performance == full.best_performance
    state = torch.load(tmp_path / "resumed" / "step_2" / ckpt.STATE_FILE, weights_only=True)
    assert set(state["best"]) == {"perf", "params"} and state["aux"] == {}
