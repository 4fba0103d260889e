#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (selfrec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds kernel K1 (csrc/dense_dual.cu) from the checkout, then:

1. kernel phase: K1 against its plain torch version on the card, at a ragged
   small shape and at the yelp2018-scale block (31,668 x 38,048) with D = 64
   and D = 192; int8 outputs must match exactly. Times the kernel, the plain
   version and two ``torch._int_mm`` calls (a yardstick the port never
   calls), and computes each shape's bound from its bytes and operations.
2. reference phase: on a small synthetic graph, the SimGCL embeddings, one
   batch loss and the full-rank top-20 lists on the card agree with the
   same model on the CPU.
3. train phase: SimGCL in int8x8 mode (D = 64, n_layer = 3, lambda = 0.5,
   eps = 0.1, batch 2048, the repo's headline configuration) on the
   yelp2018-scale synthetic graph, through the trainer's step on the first
   50 batches of an epoch. Losses must be finite and K1 must have launched.
   Five more steps under torch.profiler then print where a step's device
   time goes (outside the counted main path).
4. eval phase: compute_embeddings and one fast_evaluation over all test
   users; K1 must have launched once per layer. One more eval under
   torch.profiler prints where its device time goes.

Prints the kernel table as one JSON line, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Any failure raises and
exits non-zero; without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15   # H100 SXM data sheet, dense int8 tensor rate
N_TRAIN_BATCHES = 50
N_PROFILE_STEPS = 5


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` launches, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(u, i, d):
    """Least time on the card for (B @ xi, B.T @ xu): each input byte read
    once, each int32 output written once, 2*2*U*I*D int8 operations."""
    nbytes = u * i + (u + i) * d + 4 * (u + i) * d
    ops = 4.0 * u * i * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_case(tag, b, d, gen):
    """Kernel vs plain on one shape; returns its row of the kernel table."""
    import torch
    import torch.nn.functional as F

    from selfrec_tpu_torch.ops import dense_dual

    u, i = b.shape
    dev = b.device
    xu = torch.randint(-127, 128, (u, d), generator=gen, device=dev, dtype=torch.int8)
    xi = torch.randint(-127, 128, (i, d), generator=gen, device=dev, dtype=torch.int8)
    ou, oi = dense_dual.dual_matmul(b, xu, xi)
    torch.cuda.synchronize()
    pu, pi = dense_dual.dual_matmul_plain(b, xu, xi)
    err = max(int((ou.long() - pu.long()).abs().max()),
              int((oi.long() - pi.long()).abs().max()))
    if err != 0:
        n_bad = int((ou != pu).sum()) + int((oi != pi).sum())
        raise RuntimeError(f"K1 {tag} U={u} I={i} D={d}: {n_bad} outputs differ "
                           f"from the plain version, max |err| {err}")
    del pu, pi
    ms = cuda_ms(lambda: dense_dual.dual_matmul(b, xu, xi), reps=20)
    plain_ms = cuda_ms(lambda: dense_dual.dual_matmul_plain(b, xu, xi), reps=3)
    # yardstick: torch._int_mm wants K and N multiples of 8, so pad the
    # contraction dims with zeros once, outside the timing
    i8, u8 = -(-i // 8) * 8, -(-u // 8) * 8
    b_pad = F.pad(b, (0, i8 - i))
    bt_pad = F.pad(b.T.contiguous(), (0, u8 - u))
    xi_pad = F.pad(xi, (0, 0, 0, i8 - i))
    xu_pad = F.pad(xu, (0, 0, 0, u8 - u))
    lib_u = torch._int_mm(b_pad, xi_pad)
    lib_i = torch._int_mm(bt_pad, xu_pad)
    if not (torch.equal(lib_u, ou) and torch.equal(lib_i, oi)):
        raise RuntimeError(f"K1 {tag}: torch._int_mm yardstick disagrees")
    library_ms = cuda_ms(lambda: (torch._int_mm(b_pad, xi_pad),
                                  torch._int_mm(bt_pad, xu_pad)), reps=10)
    del b_pad, bt_pad, lib_u, lib_i
    bound_ms, bound_by = bound(u, i, d)
    row = {"shape": [u, i, d], "tag": tag, "match": "exact", "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"[kernel] K1 {tag} U={u} I={i} D={d}: exact, {ms:.4f} ms "
        f"(bound {bound_ms:.4f} ms by {bound_by}, plain {plain_ms:.3f} ms, "
        f"_int_mm x2 {library_ms:.4f} ms)")
    return row


def profile_window(tag, fn, n):
    """Where device time goes: ``fn`` (``n`` steps, or one eval) under
    torch.profiler, outside the counted main path; prints the kernels with
    the most device time and the device's busy share of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.time() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"[profile {tag}] the profiler recorded no device time: not measured")
        return
    log(f"[profile {tag}] per unit of {n}: {wall_us / n / 1e3:.2f} ms wall, device "
        f"busy {busy_us / n / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}% of the window)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile {tag}]   {e.self_device_time_total / n / 1e3:8.3f} ms "
            f"{100 * e.self_device_time_total / busy_us:5.1f}%  x{e.count / n:<5g} "
            f"{e.key[:90]}")


def graph_conf(name_extra, **top):
    from selfrec_tpu_torch.config import ModelConf

    conf = {
        "training.set": "<synthetic>",
        "test.set": "<synthetic>",
        "model": {"name": "SimGCL", "type": "graph"},
        "item.ranking.topN": [10, 20],
        "embedding.size": 64,
        "max.epoch": 1,
        "batch.size": 2048,
        "learning.rate": 0.001,
        "reg.lambda": 0.0001,
        "SimGCL": name_extra,
        "output": os.path.join("results", "chip_smoke"),
        "seed": 0,
    }
    conf.update(top)
    return ModelConf(conf)


def reference_phase():
    """Small graph: the card's SimGCL agrees with the same weights on the CPU."""
    import torch

    from selfrec_tpu_torch.models.graph.simgcl import SimGCL
    from selfrec_tpu_torch.ops import ranking
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    train, test = synth_graph_mapped(600, 900, 12000, seed=5)
    conf = graph_conf({"n_layer": 3, "lambda": 0.5, "eps": 0.1}, **{"batch.size": 256})
    models = {dev: SimGCL(conf, train, test, device=dev) for dev in ("cpu", "cuda")}
    for m in models.values():
        m.build()
    models["cuda"].set_params(models["cpu"].params)
    gen = torch.Generator().manual_seed(3)
    n = models["cpu"].data.user_num + models["cpu"].data.item_num
    noise = [[torch.rand((n, 64), generator=gen) for _ in range(2)] for _ in range(3)]
    nb = 256
    batch = {"u": torch.randint(0, models["cpu"].data.user_num, (nb,), generator=gen),
             "i": torch.randint(0, models["cpu"].data.item_num, (nb,), generator=gen),
             "j": torch.randint(0, models["cpu"].data.item_num, (nb,), generator=gen),
             "mask": (torch.arange(nb) < 200).float()}
    out = {}
    for dev, m in models.items():
        with torch.no_grad():
            ue, ie = m.embeddings()
            loss = m.batch_loss(m.params, {k: v.to(dev) for k, v in batch.items()},
                                noise=[[x.to(dev) for x in pair] for pair in noise])
        out[dev] = (ue.cpu(), ie.cpu(), loss.cpu())
    # int8 quantization is a step function: a last-bit difference in a
    # reduction (norms, means) can move a value across a rounding boundary
    # and change it by one quantum (max|column|/127 before rescaling). So at
    # most 0.1% of the values may leave rtol 1e-4 / atol 1e-6, and none by
    # more than 1% of the largest magnitude.
    for a, b, what in zip(out["cuda"], out["cpu"], ("user_emb", "item_emb", "loss")):
        off = ~torch.isclose(a, b, rtol=1e-4, atol=1e-6)
        worst = float((a - b).abs().max())
        if float(off.float().mean()) > 1e-3 or worst > 1e-2 * float(b.abs().max()):
            raise RuntimeError(f"reference phase: {what} on the card differs from "
                               f"the CPU in {int(off.sum())} values, by up to {worst}")
    # full-rank eval of the same embeddings on both devices. Items with the
    # same neighbourhood get the same embedding (8 of 891 here), and f32
    # scores summed in another order may swap near-ties, so the devices may
    # order ties differently: the card's lists must score like the CPU's
    # position by position (float64 rescoring), as they do when they differ
    # only by the order of ties
    ue, ie = out["cpu"][0].double(), out["cpu"][1].double()
    top = {dev: torch.as_tensor(ranking.topk_ids_from_embeddings(
               m.data, out["cpu"][0].to(dev), out["cpu"][1].to(dev), 20))
           for dev, m in models.items()}
    uids = torch.as_tensor(models["cpu"].data.test_user_ids).long()

    def rescore(ids):
        return (ue[uids][:, None, :] * ie[ids]).sum(-1)

    id_off = float((top["cuda"] != top["cpu"]).double().mean())
    if not torch.allclose(rescore(top["cuda"]), rescore(top["cpu"]), rtol=1e-5, atol=1e-6):
        raise RuntimeError("reference phase: the card's top-20 lists score differently "
                           f"from the CPU's ({100 * id_off:.2f}% of ids differ)")
    log(f"[reference] small graph U={models['cpu'].data.user_num} "
        f"I={models['cpu'].data.item_num}: card agrees with the CPU "
        f"(<= 0.1% of values beyond rtol 1e-4 / atol 1e-6), "
        f"loss {float(out['cuda'][2]):.6f} vs {float(out['cpu'][2]):.6f}; "
        f"top-20 lists of {len(uids)} users score alike ({100 * id_off:.2f}% of "
        f"ids differ, all within score ties)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.environ["SELFREC_TPU_DENSE_DTYPE"] = "int8"
    from selfrec_tpu_torch.device import disable_tf32
    from selfrec_tpu_torch.models.graph.simgcl import SimGCL
    from selfrec_tpu_torch.ops import dense_dual
    from selfrec_tpu_torch.utils import metrics
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    disable_tf32()
    t_start = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    so = dense_dual.build()
    log(f"[build] {so} in {time.time() - t0:.1f} s")
    with open(so[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log(f"[build] {line.strip()}")

    # the headline model on yelp2018-scale synthetic data
    t0 = time.time()
    train, test = synth_graph_mapped()
    model = SimGCL(graph_conf({"n_layer": 3, "lambda": 0.5, "eps": 0.1}),
                   train, test, device="cuda")
    model.build()
    torch.cuda.synchronize()
    log(f"[setup] {model.adj!r}, {model.data.n_edges} edges, "
        f"{len(model.data.test_user_ids)} test users, {time.time() - t0:.1f} s")

    # 1. kernel phase ------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    small = (torch.rand((1000, 1337), generator=gen, device="cuda") < 0.3).to(torch.int8)
    rows = [kernel_case("ragged", small, 64, gen),
            kernel_case("ragged", small[:517, :1029].contiguous(), 192, gen),
            kernel_case("yelp", model.adj.a_ui, 64, gen),
            kernel_case("yelp", model.adj.a_ui, 192, gen)]
    del small
    torch.cuda.empty_cache()

    # 2. reference phase ---------------------------------------------------
    reference_phase()

    # 3. train phase: the main path, counts from 0 -------------------------
    users, items, masks = model.epoch_batches(0)
    m = min(N_TRAIN_BATCHES, users.shape[0] - N_PROFILE_STEPS)
    torch.cuda.synchronize()
    dense_dual.dual_matmul.launches = 0
    t0 = time.time()
    first = model.train_batches(users[:1], items[:1], masks[:1])
    torch.cuda.synchronize()
    t1 = time.time()
    rest = model.train_batches(users[1:m], items[1:m], masks[1:m])
    torch.cuda.synchronize()
    t2 = time.time()
    train_launches = dense_dual.dual_matmul.launches
    losses = torch.cat([first, rest]).cpu()
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"train phase: non-finite losses {losses.tolist()}")
    if train_launches <= 0:
        raise RuntimeError("train phase: K1 was never launched")
    ex_s = m * model.batch_size / (t2 - t0)
    steady_ex_s = (m - 1) * model.batch_size / (t2 - t1)
    log(f"[train] {m} batches x {model.batch_size}: loss {float(losses[0]):.6f} -> "
        f"{float(losses[-1]):.6f}, {t2 - t0:.3f} s, {ex_s:.1f} examples/s "
        f"(first step {1e3 * (t1 - t0):.1f} ms; steps 2..{m}: "
        f"{1e3 * (t2 - t1) / (m - 1):.2f} ms/step, {steady_ex_s:.1f} examples/s), "
        f"K1 launches {train_launches}")
    n = N_PROFILE_STEPS
    profile_window("train step", lambda: model.train_batches(
        users[m:m + n], items[m:m + n], masks[m:m + n]), n)

    # 4. eval phase --------------------------------------------------------
    torch.cuda.synchronize()
    dense_dual.dual_matmul.launches = 0
    t0 = time.time()
    model.user_emb, model.item_emb = model.embeddings()
    measure = model.fast_evaluation(0)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.time() - t0)
    eval_launches = dense_dual.dual_matmul.launches
    ue, ie = model.user_emb, model.item_emb
    if (tuple(ue.shape) != (model.data.user_num, 64)
            or tuple(ie.shape) != (model.data.item_num, 64)
            or not bool(torch.isfinite(ue).all() & torch.isfinite(ie).all())):
        raise RuntimeError("eval phase: embeddings of the wrong shape or not finite")
    if eval_launches != model.n_layers:
        raise RuntimeError(f"eval phase: K1 launched {eval_launches} times, "
                           f"expected {model.n_layers}")
    perf = metrics.parse_measure(measure)
    if not all(math.isfinite(v) for v in perf.values()):
        raise RuntimeError(f"eval phase: metrics not finite: {perf}")
    log(f"[eval] Recall@20 {perf['Recall']} NDCG@20 {perf['NDCG']}, "
        f"{eval_ms:.1f} ms, K1 launches {eval_launches}")

    def one_eval():
        model.user_emb, model.item_emb = model.embeddings()
        model.fast_evaluation(0)

    profile_window("eval", one_eval, 1)

    main_row = next(r for r in rows if r["tag"] == "yelp" and r["shape"][2] == 192)
    kernels = [{
        "name": "K1 dual_matmul (int8)",
        "route": "cuda",
        "source": "selfrec_tpu_torch/csrc/dense_dual.cu",
        "replaces": "selfrec_tpu/ops/dense_dual.py:174",
        "launches": train_launches + eval_launches,
        "match": "exact",
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows,
    }]
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
