"""One run of one cell: set-up, the measured window, the check, the line.

Set-up makes the data and the weights from the seed, builds the program
(the port's model through its own constructor and ``build``), hands it the
weights, drives the check steps or the warm-up evals through the window's
own calls, and so warms up every shape the window uses. The window is the
traffic's loop (:func:`window`). Once it has closed the peak of device
memory is read, the program is freed, and the plain reference judges what
the program produced.

``setup_s`` runs from the start of the process to the start of the window;
a traced run (``trace``) wraps the layers' entry functions in spans and
profiles the window, and reports the per-layer metrics in place of the
end-to-end ones."""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from benchmark.core import registry
from benchmark.core.trace import Spans, profiled_window
from benchmark.reference import judge

FORBIDDEN = ("jax", "jaxlib", "flax", "selfrec_tpu")


def seeds(seed: int):
    """Data, weight and draw seeds derived from the run's seed: every seed
    gives the same sizes and a different draw of the same marginals."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(3, dtype=np.uint64)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's own name only begins alike)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def window(prog, traffic: dict, seconds: float, spans: Spans, device) -> dict:
    """The traffic's loop: rounds of ``train_epochs`` whole epochs and then
    ``evals`` evals, a round started only while one more fits in
    ``seconds`` (the first always). Host clock, each epoch and eval ending
    in a synchronise."""
    rec = {"epochs": 0, "steps": 0, "failed": 0, "train_samples": 0, "train_s": 0.0,
           "evals_s": [], "rounds": 0}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    epoch, last = 1, 0.0
    t_start = time.perf_counter()
    while rec["rounds"] == 0 or time.perf_counter() - t_start + last <= seconds:
        r0 = time.perf_counter()
        for _ in range(traffic["train_epochs"]):
            t0 = time.perf_counter()
            with spans.span("train.epoch"):
                losses = np.asarray(prog.train_epoch(epoch))
                sync()
            rec["train_s"] += time.perf_counter() - t0
            rec["epochs"] += 1
            rec["steps"] += len(losses)
            rec["failed"] += int((~np.isfinite(losses)).sum())
            rec["train_samples"] += prog.samples_per_epoch()
            epoch += 1
        for _ in range(traffic["evals"]):
            t0 = time.perf_counter()
            with spans.span("eval"):
                prog.evaluate(epoch)
                sync()
            rec["evals_s"].append(time.perf_counter() - t0)
        rec["rounds"] += 1
        last = time.perf_counter() - r0
    rec["window_s"] = time.perf_counter() - t_start
    return rec


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def judge_run(family, ref, cfg, conf, inputs, params0, draw_seed, device, prog_train,
              batches, answers, control):
    """The numbers that decide ``correct``: the check steps' against the
    reference's same steps, and the last eval's answers against the
    reference's scores; with ``control``, also the readings of the
    lower-precision control and of the faults planted in the reference
    put in the program's place."""
    numbers, extra = {}, {}
    if prog_train:
        n = len(batches)
        ref_batches = family.reference_batches(batches, device)
        steps = lambda **kw: ref.train_readings(inputs, params0, ref_batches, draw_seed, conf,
                                                device, n, **kw)
        ref_train = steps()
        numbers.update(judge.train_numbers(prog_train, ref_train))
        numbers["batch_bad"] = family.check_batches(inputs, batches, device)
        if control:
            as_program = lambda r: judge.train_numbers(judge.reference_train_answers(r), ref_train)
            extra["half_batch"] = as_program(steps(half_batch=True))
            extra["state_unchanged"] = {"delta_gap": 1.0}
            if cfg["control"].get("reference_tf32"):
                extra["control"] = as_program(steps(tf32=True))
    if answers is not None:
        scorer = ref.Scorer(inputs, params0, conf, device)
        numbers.update(family.eval_numbers(scorer, answers))
        if control:
            mine = family.reference_answers(scorer)
            mine["ids"][:, 0] = (mine["ids"][:, 0] + 1) % (scorer.n_items + 1)
            extra["answer_altered"] = family.eval_numbers(scorer, mine)
            if cfg["control"].get("reference_tf32"):
                low = ref.Scorer(inputs, params0, conf, device, tf32=True)
                extra["control"] = family.eval_numbers(scorer, family.reference_answers(low))
    return numbers, extra


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        overrides: Optional[dict] = None, control: bool = False,
        root: str = registry.ROOT) -> dict:
    """One run of ``cell`` (a workload's name, or a :class:`registry.Cell`);
    returns the result line as a dict.

    ``overrides`` replaces entries of the configuration's ``data`` and
    ``conf`` (the tests' small sizes); ``control`` adds
    the readings of the lower-precision control and of the faults planted
    in the reference put in the program's place."""
    device = torch.device(device)
    if isinstance(cell, str):
        cell = registry.cell(cell, root)
    cfg, traffic = cell.config, cell.traffic
    data, conf = dict(cfg["data"]), dict(cfg["conf"])
    for key, value in (overrides or {}).items():
        (data if key in data else conf)[key] = value
    conf["seed"] = seed
    family = registry.module("families", cfg["family"])
    ref = registry.module("reference", cfg["reference"])
    data_seed, param_seed, draw_seed = seeds(seed)

    inputs = family.make_inputs(data, data_seed)
    spans = Spans(profiled=trace)
    prog = family.Program(cfg, conf, inputs, device, spans)
    params0 = ref.make_params(param_seed, inputs, conf, device)
    prog.set_state(params0, draw_seed)
    n_check = int(traffic["check_steps"])
    prog_train = prog.check_steps(n_check, params0) if n_check else None
    del params0
    for _ in range(int(traffic["warm_evals"])):
        prog.evaluate(0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    tr = None
    if trace:
        prog.trace_spans()
        launches0 = prog.kernel_launches()
        with profiled_window(os.path.join(root, "build", "bench_trace", "window.json"),
                             device) as tr:
            rec = window(prog, traffic, min(seconds, traffic["trace_seconds"]), spans, device)
        k1_launches = prog.kernel_launches() - launches0
    else:
        rec = window(prog, traffic, seconds, spans, device)
        k1_launches = 0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    answers = prog.answers() if traffic["evals"] else None
    batches = getattr(prog, "batches", None)
    k1_calls = getattr(prog, "k1_calls", [])
    spans.close()
    prog.free()
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the process that reports: {', '.join(found)}")

    params0 = ref.make_params(param_seed, inputs, conf, device)
    numbers, extra = judge_run(family, ref, cfg, conf, inputs, params0, draw_seed, device,
                               prog_train, batches, answers, control)
    limits = {**(cfg["limits"]["train"] if prog_train else {}),
              **(cfg["limits"]["eval"] if answers is not None else {})}
    checks = judge.decide(numbers, limits)

    ctx = SimpleNamespace(rec=rec, setup_s=setup_s, trace=tr, spans=spans, k1_calls=k1_calls,
                          k1_launches=k1_launches, family=family, reference=ref, cfg=cfg,
                          conf=conf, inputs=inputs, traffic=traffic)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    out = {"correct": judge.passed(checks), "attempted": rec["steps"] + len(rec["evals_s"]),
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.get("busy_s", 0.0), tr.get("window_s", 0.0)
        if "breakdown" in tr:
            out["breakdown"] = tr["breakdown"]
    out["samples"] = {"epochs": rec["epochs"], "steps": rec["steps"],
                      "evals": len(rec["evals_s"]), "window_s": rec["window_s"],
                      "setup_s": setup_s}
    if control:
        out["control"] = extra
    out["checks"] = checks
    return out

