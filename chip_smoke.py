#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (selfrec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds kernels K1 (csrc/dense_dual.cu), K2 (csrc/ell_gather.cu) and the
eval's ranking kernels (csrc/rank_topk.cu) from the checkout, one nvcc
each, started together. Every model but the social ones
runs on the yelp2018-scale synthetic graph (31,667 users, 38,048 items,
1,428,306 training edges) at D = 64 and batch 2048, with random weights
from a seed.

Prints each kernel's registers, shared memory and spills from
``nvcc -Xptxas -v``.

CUDA graphs (selfrec_tpu_torch.utils.cuda_graph): every single-device
training path below runs its steps as the trainer runs them on the card,
two eager warm-up steps, the capture of the step into a CUDA graph, then one
replay a step (each prints ``[graph] <model> <arm> train: captured``); ms/step
is over the replays. After each path's steps, its eager twin: from one
trainer state (a checkpoint's, put back in place) the next 5 steps replayed,
run eagerly, and run eagerly again; losses, params, Adam's moments and aux
of the replays and of the second eager run must equal the first eager
run's bit for bit, or within rtol 1e-5 / atol 1e-6 where the path has float
atomics (named); both ms/step are printed. The sequential evals replay one graph a block and
must equal the eager block loop. Every kernel check also replays the kernel
from a captured graph against its plain version. The profiled windows run
graphed steps.

SimGCL, int8x8 dense layout (SELFREC_TPU_DENSE=1):
1. K1 kernel phase: K1's int8 kernel against its plain torch version at
   three ragged small shapes and at the yelp block (with its kept
   transpose, as the model path passes it) with D = 64, 192 and 100 (a
   width the kernel pads); outputs must match exactly. Times the kernel
   (one call at a time, and back to back; at the yelp block also its
   kernel alone under torch.profiler), the plain version and two
   ``torch._int_mm`` calls (a yardstick; the port calls it only in KNN's
   similarity build, never in K1's place), and computes each bound.
   Then K1's float kernel (the dense bf16 mode's, phases 17-19) with
   bf16 and f32 operands at the same shapes: its operand pass equal to
   its plain version bit for bit, the products within rtol 1e-5 / atol
   1e-3 of the plain version, its backward too at the ragged shapes;
   two ``torch.matmul`` over a copy of B in the operands' dtype are its
   yardstick.
2. reference phase: on a small graph, the embeddings, one batch loss and
   the top-20 lists on the card agree with the same model on the CPU.
3. train phase: n_layer 3, lambda 0.5, eps 0.1 (the repo's headline
   configuration), the first 50 batches of an epoch through the trainer's
   step; finite losses, K1 launched. Three more (graphed) under torch.profiler.
4. eval phase: compute_embeddings and one fast_evaluation over all test
   users; K1 launches once per layer, the ranking kernels
   (csrc/rank_topk.cu) once, and the eval takes rank_merge's hit mask,
   which must equal the host search of the same ids (every eval path that
   takes the kernels checks this). One more eval under the profiler. Then the
   ranking kernels alone on the model's embeddings (31,667 test users,
   38,048 items, D 64, k 20): their ids score like the plain twin's and
   like today's library path's (GEMM, ``torch.where`` and ``torch.topk``
   over the 31 blocks of 1,024) position by position in float64
   rescoring (rtol 1e-5), no rated id and none repeated; the kernels
   timed (and each alone under the profiler) against their 2.30 ms f32
   FMA bound, beside the plain twin and the library path; rank_merge's
   hit mask equal to the host search on yelp's ground truth and on slices
   of up to 300 items at k 20 and 128, scores and ids unchanged by it, and
   rank_merge timed with and without it on both ground truths.

SGL (conf/SGL.yaml: n_layer 2, lambda 0.1, drop_rate 0.1, aug_type 1,
temp 0.2), ELL layout (SELFREC_TPU_DENSE=0), and LightGCN on it:
5. K2 kernel phase: K2 against its plain version at rtol/atol 2e-5 on two
   ragged layouts (K 4 and 16, one row spanning many virtual rows), on the
   yelp unified layout at P = 1 (D 64, f32 and bf16 rows) and on SGL's
   packed template at P = 3 (D 64 x 3; the epoch's slot weights, which
   over both layouts must equal ell_weights of the epoch's weight stack
   bit for bit), and exactly on the Mosaic gather probe's case
   (scripts/probe_mosaic_gather.py: n 256, D 128, K = 1, unit weights).
   Times the kernel (one call at a time, and back to back), the plain
   version and ``torch.sparse.mm`` over the same CSR matrices (one call
   per pass; a yardstick the port never calls), and computes
   each bound.
6. reference phase: on a small graph, SGL's ELL arm on the card agrees with
   the CPU (same weights, keep masks and batch): embeddings, loss, grads
   and top-20 lists.
7. train phase: 50 steps of epoch 0 after epoch_setup; finite losses and
   exactly 4 K2 launches a step (2 hops forward and backward, the three
   views packed), and the slot weights scattered once a layout over the
   epoch (its epoch_setup; warm-up, capture and replays none). Three more
   (graphed) steps under the profiler.
8. eval phase: compute_embeddings and one fast_evaluation; K2 launches
   n_layer times.
9. LightGCN (n_layer 3) on the ELL layout: 10 steps, 6 K2 launches a step.
10. SGL's dense int8x8 arm: 10 steps over per-epoch refactored views, 12
    K1 launches a step.

XSimGCL, DirectAU and MixGCF on the dense int8x8 block, and MF:
11. reference phase: on a small graph, XSimGCL on the card agrees with the
    CPU: embeddings, one batch loss with fed noise, top-20 lists.
12. XSimGCL (bench.py:715-727: n_layer 3, l_star 1, lambda 0.2, eps 0.2,
    tau 0.15): 50 steps, 6 K1 launches a step (each hop forward and
    backward); three more under the profiler; one eval, 3 launches.
13. DirectAU (bench.py:764-775: gamma 2, n_layers 3): 10 steps, 6 K1
    launches a step; three more under the profiler; one eval.
14. MixGCF (conf/MixGCF.yaml: n_layer 3, n_negs 64): 10 steps, 6 K1
    launches a step, with (2048, 64, 64) mixing tensors and 131,072
    sampler lanes a step; three more under the profiler.
15. MF: 10 steps and one eval, with no K1 or K2 launch; three more steps
    under the profiler.
16. resume phase: on a small graph, XSimGCL on the card for 4 epochs, and
    for 2 then resumed to 4 from checkpoint.interval 2; the parameters
    agree within rtol 2e-3 / atol 2e-4 (the JAX package's resume test,
    tests/test_checkpoint.py:53-58; the largest difference is printed).
    The continuous run's profile.dir trace must show a K1 launch.

SelfCF and BUIR in the dense bf16 mode (K1's float kernel: bf16 operands
forward, f32 cotangents backward), pinned around their builds as
bench.py's _pinned_bf16 does; BUIR on ELL; NCL int8x8; SSL4Rec:
17. dense float reference phase: on a small graph, SelfCF, and BUIR with
    fed rates and keep draws, on the card against the CPU: embeddings,
    one loss, its grads and the top-20 lists.
18. SelfCF (bench.py:786-805: n_layer 2, tau 0.05): 50 steps, 4 K1 float
    launches a step (2 hops forward, 2 backward) and 2 operand passes
    each; three more under the profiler; one eval, 2 launches.
19. BUIR (bench.py:690-712: n_layer 2, drop_rate 0.2, tau 0.995): 10
    steps over two dropout views a step, 6 K1 float launches a step
    (online 2 forward and 2 backward, target 2 forward); three more under
    the profiler; one eval, 2 launches. Then BUIR's ELL arm: K2 at P = 2
    against its plain version (its row of the K2 checks), and 10 steps, 4
    K2 launches a step.
20. NCL (bench.py:651-676: n_layer 3, ssl_reg 1e-6, proto_reg 1e-7, tau
    0.05, hyper_layers 1, alpha 1.5, num_clusters 2000), int8x8: 10
    warm-up steps, the E-step timed on its own (2 tables x 25 Lloyd
    iterations at k 2000), 10 prototype-phase steps, each 6 K1 int8
    launches; one eval, 3 launches.
21. SSL4Rec (bench.py:777-783: tau 0.07, alpha 0.1, drop 0.1): 10 steps
    and one eval, with no K1 or K2 launch.

The budget fallbacks, forced on the yelp graph by lowering the budgets, and
UserKNN/ItemKNN, which rank through the scatter-mask path:
22. SimGCL int8x8 with the CSR sampler (SELFREC_TPU_NEG_BITMAP_MB=100; the
    bitmap is 150 MB): from one trainer state the CSR and bitmap samplers
    give the same negatives and bit-identical losses over 3 steps, and the
    card's CSR membership search equals the CPU's on 1,000,000 lanes; one
    sampler call of each timed. Then 10 steps (6 K1 launches a step, five
    more under the profiler) and one eval with SELFREC_TPU_EVAL_MASK=scatter
    (3 launches); the scatter-mask ids equal the dense-mask block scan's
    (the same GEMM and torch.topk), and the dense-mask eval's (the ranking
    kernels') score like them position by position.
23. Over budget under auto (SELFREC_TPU_DENSE=auto,
    SELFREC_TPU_DENSE_BUDGET_GB=1.0: the 1.205 GB block and mask do not
    fit) with SELFREC_TPU_HOST_BATCHES=1: LightGCN on ELL, 10 steps (6 K2
    launches a step at P = 1), one eval through the scatter mask (3).
24. SELFREC_TPU_ELL=0: LightGCN on the edge-list NormAdj, 10 steps (five
    more under the profiler) and one eval, with no K1 or K2 launch.
25. KNN reference phase: on the small graph, UserKNN and ItemKNN (topK 50,
    shrinkage 100) on the card against the CPU: sims and ids exactly, the
    card's blocked build equal to the dense one, rec lists alike (scores
    within rtol 1e-5 / atol 1e-7, differing ids only within score ties).
26. UserKNN and ItemKNN at bench.py:808-855 (topK 50, shrinkage 100): the
    similarity build twice and the eval (rec list through the scatter-mask
    plan), with no K1 or K2 launch.

MHCN and SEPT (bench.py:353-464) on douban-book-scale synthetic data
(13,024 users, 22,345 items, 712,881 training edges, 169,150 trust
relations, 155,341 distinct pairs; quarter douban 3,256 × 5,586):
27. MHCN (n_layer 2, ss_rate 0.01) under SELFREC_TPU_DENSE=auto: the
    motifs built on the card (timed twice), 512 rows equal to the scipy
    route exactly; the three U × U channels, R and Rᵀ as bf16 DenseMat; 20
    steps and one eval with no K1 or K2 launch (three more steps under the
    profiler); DenseMat's GEMM timed alone at each shape and its share of
    the step.
28. MHCN's ELL arm at quarter douban (SELFREC_TPU_DENSE=0): K2 against its
    plain version on every layout the path runs: H_s, H_j and H_p forward
    and backward, R and R's transpose layout; 10 steps, 26 K2 launches a
    step (13 products forward, 13 backward); one eval, 10.
29. SEPT (n_layer 2, ss_rate 0.005, drop_rate 0.3, ins_cnt 10, max.epoch 9)
    on the dense int8x8 block, social views as DenseMat: K1 int8 against
    its plain version (exactly) on the 13,024 × 22,345 block at D 64; 10
    warm steps (4 K1 int8 launches a step), the joint phase entered through
    the model's ``enter_phase``, 20 joint steps (8 a step; the epoch's
    refactored view timed as epoch_setup; three more under the profiler);
    K1 int8 against its plain version on that refactored view; one eval
    (2).
30. SEPT's ELL arm, joint phase: K2 against its plain version on the union
    template and the bipartite template at P = 2; 10 steps, 8 K2 launches a
    step.
31. Small graph (600 × 900, 3,000 relations): MHCN on DenseMat in f32 and
    bf16 (fed permutations) and SEPT's joint phase on the dense arm (f32 and
    int8x8) and the ELL arm, on the card against the CPU: embeddings, one
    loss and (but for int8x8) its grads.

SASRec, CL4SRec and BERT4Rec (bench.py:283-350: D 64, 2 blocks, 1 head,
drop_rate 0.2, batch 256, max.len 50; BERT4Rec mask_rate 0.5; CL4SRec
aug_type 0, aug_rate 0.5, cl_rate 0.05) on amazon-beauty-scale synthetic
sequences (22,363 sequences over 12,101 items, utils/synth.py):
32. each model: one epoch (88 steps; the first step apart, ms/step over
    steps 2..88 and sequences/s), three more steps under the profiler, and
    one test() plus ranking_evaluation (SASRec's under the profiler too)
    with the ranking alone (``top_items``) timed apart; finite losses and
    metrics, and no K1 or K2 launch on either path. For SASRec, one
    batch's table lookups forward and backward timed as advanced indexing
    and as the F.embedding the encoder takes.
33. Small data (400 sequences over 300 items, max.len 20, D 32, drop_rate
    0): each model, CL4SRec at aug_type 0, 1 and 2, on the card against the
    CPU with the CPU's weights and the same batch, negatives and draws: the
    encoder's output and the loss within rtol/atol 1e-5, the grads within
    rtol 1e-4 / atol 1e-6 (TF32 off), the top-20 ids of every sequence
    equal (a position may differ only where both devices' scores there
    agree within rtol 1e-5, an f32 near-tie; the count is printed).
34. Resume: SASRec on the small data (drop_rate 0) for 2 epochs, and for 1
    then resumed to 2 (checkpoint.interval 1); params, best params and the
    best epoch agree within rtol 2e-3 / atol 2e-4.

Scale-out (selfrec_tpu_torch.parallel), one card:
35. NCCL at world size 1 in this process: all_reduce, all_gather,
    reduce_scatter and all_to_all on the card; a ShardedDenseAdj and a
    HaloAdj over a 1x1 mesh on the yelp graph, one propagation each,
    equal to DenseAdj int8 exactly and to EllAdj within 2e-5. Then two
    NCCL ranks on the card, whose refusal is printed (not a gate).
36. Two ranks on the card over gloo (this file run with
    ``--scale-out-rank``, each with a timeout; a rank that fails or times
    out fails the script): SimGCL int8x8 on the yelp graph on a 1x2 and a
    2x1 mesh (each rank's K1 on its slice exactly equal to the plain
    version at D 192 and 64, timed on rank 0 alone against its bound; the
    JAX package's int8 gate, 0.02 of each column's largest value, on its
    own test's inputs, and the same measure on the yelp graph printed for
    the sharded and the single-device block; 10 steps, 6 K1 launches a
    rank a step, three more on 1x2 under the profiler on both ranks; one
    eval, 3 a rank, the 1x2 one through the sharded top-k); SimGCL in the
    f32 dense mode on the small graph, 3 steps equal to the single-device
    card run within rtol 2e-4 / atol 2e-5; SGL's ELL arm on 1x2 (HaloAdj;
    each rank's K2 on its halo layout within 2e-5, timed on rank 0; 10
    steps, 4 K2 launches a rank a step, three more under the profiler; one
    eval); SASRec at bench widths on 1x2 (6 steps) and MHCN on
    ShardedDenseMat at quarter douban on 1x2 (5 steps). After each model:
    data replicas bit-equal, full params equal on every rank. Prints
    ms/step and ms/eval for two ranks sharing the card and the bytes a
    rank receives a step.

Every path sets the launch counts to 0 just before it and reads them just
after; each phase's knobs are set around it and restored. Prints the kernel table as one JSON line, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}. Any failure
raises and exits non-zero; without a CUDA device it exits 1 and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

from benchmark.core.peaks import HBM_BYTES_PER_S, PEAK

K1_FLOAT_RTOL, K1_FLOAT_ATOL = 1e-5, 1e-3  # the JAX package's (tests/test_dense_dual.py)
N_TRAIN_BATCHES = 50
RANK_LAUNCHES = {}  # eval path tag: calls of the ranking kernels in its eval
N_SHORT_BATCHES = 10
N_PROFILE_STEPS = 3
TWIN_STEPS = 5              # the eager twin's steps (k >= 5)
GRAPH_WARMUP = 2            # StepGraph's eager warm-up steps before its capture
K2_RTOL = K2_ATOL = 2e-5    # the JAX package's own (tests/test_spmm_pallas.py)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, inner=1):
    """Time of one call of ``fn`` on the card: the median over ``reps``
    timings after one warm-up, each of ``inner`` back-to-back calls between
    two CUDA events divided by ``inner``. With one call a timing (``ms``,
    ``plain_ms``, ``library_ms``) the card waits while the host prepares the
    call, so the host's own time per call is in it; with more
    (``ms_back_to_back``) the card stays busy while the host enqueues the
    next call, so the host's time shows only where it exceeds the kernel's."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def back_to_back_ms(fn, ms):
    """``fn``'s time in runs of back-to-back calls (enough for about 2 ms,
    at most 20), given its time ``ms`` one call at a time."""
    return cuda_ms(fn, reps=10, inner=max(1, min(20, int(2.0 / max(ms, 1e-3)))))


def kernel_only_ms(fn, kernel_name, n=5):
    """Device time of the kernels named ``kernel_name`` in one call of
    ``fn``, from torch.profiler over ``n`` calls (the wrapper's operand
    copies and the host's time left out); None where the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name in e.key)
    return us / n / 1e3 if us > 0 else None


def bound_ms(nbytes, ops, ops_per_s):
    """Least time on the card: bytes over the memory rate or operations over
    the peak rate, whichever is larger; and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def set_layout(dense):
    """Pin the layout gate: the dense block (1) or the ELL layout (0)."""
    os.environ["SELFREC_TPU_DENSE"] = "1" if dense else "0"


def k1_case(tag, b, bt, d, gen):
    """K1 (int8) vs plain on one shape, with the block's transpose ``bt``
    as the model path passes it; returns its row of the kernel table. The
    bound reads each input byte once (B once), writes each int32 output
    once and does 2*2*U*I*D int8 operations."""
    import torch
    import torch.nn.functional as F

    from selfrec_tpu_torch.ops import dense_dual

    u, i = b.shape
    dev = b.device
    xu = torch.randint(-127, 128, (u, d), generator=gen, device=dev, dtype=torch.int8)
    xi = torch.randint(-127, 128, (i, d), generator=gen, device=dev, dtype=torch.int8)
    ou, oi = dense_dual.dual_matmul(b, xu, xi, bt)
    torch.cuda.synchronize()
    pu, pi = dense_dual.dual_matmul_plain(b, xu, xi)
    err = max(int((ou.long() - pu.long()).abs().max()),
              int((oi.long() - pi.long()).abs().max()))
    if err != 0:
        n_bad = int((ou != pu).sum()) + int((oi != pi).sum())
        raise RuntimeError(f"K1 {tag} U={u} I={i} D={d}: {n_bad} outputs differ "
                           f"from the plain version, max |err| {err}")

    def same_as_plain(out):
        if not (torch.equal(out[0], pu) and torch.equal(out[1], pi)):
            raise RuntimeError(f"K1 {tag} U={u} I={i} D={d}: launched from a replayed "
                               f"graph, it differs from the plain version")

    graph_ms = graph_replay_check(lambda: dense_dual.dual_matmul(b, xu, xi, bt),
                                  same_as_plain)
    del pu, pi
    again = dense_dual.dual_matmul(b, xu, xi, bt)
    if not (torch.equal(ou, again[0]) and torch.equal(oi, again[1])):
        raise RuntimeError(f"K1 {tag}: two runs on the same inputs differ")
    del again
    ms = cuda_ms(lambda: dense_dual.dual_matmul(b, xu, xi, bt), reps=20)
    ms_b2b = back_to_back_ms(lambda: dense_dual.dual_matmul(b, xu, xi, bt), ms)
    plain_ms = cuda_ms(lambda: dense_dual.dual_matmul_plain(b, xu, xi), reps=3)
    # yardstick: torch._int_mm wants K and N multiples of 8, so pad the
    # contraction dims and D with zeros once, outside the timing
    i8, u8, d8 = -(-i // 8) * 8, -(-u // 8) * 8, -(-d // 8) * 8
    b_pad = F.pad(b, (0, i8 - i))
    bt_pad = F.pad(b.T.contiguous(), (0, u8 - u))
    xi_pad = F.pad(xi, (0, d8 - d, 0, i8 - i))
    xu_pad = F.pad(xu, (0, d8 - d, 0, u8 - u))
    lib_u = torch._int_mm(b_pad, xi_pad)[:, :d]
    lib_i = torch._int_mm(bt_pad, xu_pad)[:, :d]
    if not (torch.equal(lib_u, ou) and torch.equal(lib_i, oi)):
        raise RuntimeError(f"K1 {tag}: torch._int_mm yardstick disagrees")
    library_ms = cuda_ms(lambda: (torch._int_mm(b_pad, xi_pad),
                                  torch._int_mm(bt_pad, xu_pad)), reps=10)
    del b_pad, bt_pad, lib_u, lib_i
    bms, bound_by = bound_ms(u * i + (u + i) * d + 4 * (u + i) * d, 4.0 * u * i * d,
                             PEAK["int8"])
    k_ms = (kernel_only_ms(lambda: dense_dual.dual_matmul(b, xu, xi, bt), "dual_s8_kernel")
            if tag in ("yelp", "douban SEPT") else None)
    row = {"shape": [u, i, d], "tag": tag, "match": "exact", "max_abs_err": err,
           "ms": ms, "ms_back_to_back": ms_b2b, "kernel_only_ms": k_ms, "graph_ms": graph_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
           "bound_by": bound_by}
    log(f"[kernel] K1 {tag} U={u} I={i} D={d}: exact (also replayed from a graph, "
        f"{graph_ms:.4f} ms), {ms:.4f} ms "
        f"({ms_b2b:.4f} back to back, kernel alone {k_ms}; bound {bms:.4f} ms by "
        f"{bound_by}, plain {plain_ms:.3f} ms, _int_mm x2 {library_ms:.4f} ms)")
    return row


def k1_float_case(tag, b, bt, d, dtype, gen, grad=False):
    """K1's float kernel vs plain on one shape, operands N(0, 0.1^2) in
    ``dtype``, within rtol 1e-5 / atol 1e-3; with ``grad`` its autograd
    backward (the same kernel) too. Returns its row of the kernel table.
    The bound reads B once and each operand once, writes each f32 output
    once, and does 2*2*U*I*D operations at the bf16 tensor rate, three
    times over for f32 operands (the kernel's method: three bf16 pieces a
    value, each through the tensor cores). The yardstick is two
    torch.matmul over a copy of B in the operands' dtype."""
    import torch

    from selfrec_tpu_torch.ops import dense_dual

    u, i = b.shape
    xu = (0.1 * torch.randn((u, d), generator=gen, device=b.device)).to(dtype)
    xi = (0.1 * torch.randn((i, d), generator=gen, device=b.device)).to(dtype)
    plan = dense_dual.width_plan(d, 3 if dtype == torch.float32 else 1)
    for x in (xu, xi):
        if not torch.equal(dense_dual.float_operand(x, plan),
                           dense_dual.float_operand_plain(x, plan)):
            raise RuntimeError(f"K1 float {tag} {dtype} D={d}: the operand pass differs "
                               f"from its plain version")
    ou, oi = dense_dual.dual_matmul(b, xu, xi, bt)
    torch.cuda.synchronize()
    pu, pi = dense_dual.dual_matmul_plain(b, xu, xi)
    err = max(float((ou - pu).abs().max()), float((oi - pi).abs().max()))
    for got, want in ((ou, pu), (oi, pi)):
        if not torch.allclose(got, want, rtol=K1_FLOAT_RTOL, atol=K1_FLOAT_ATOL):
            raise RuntimeError(f"K1 float {tag} {dtype} U={u} I={i} D={d}: differs "
                               f"from the plain version, max |err| {err}")

    def close_to_plain(out):
        if not all(torch.allclose(got, want, rtol=K1_FLOAT_RTOL, atol=K1_FLOAT_ATOL)
                   for got, want in zip(out, (pu, pi))):
            raise RuntimeError(f"K1 float {tag} {dtype} U={u} I={i} D={d}: launched from a "
                               f"replayed graph, it differs from the plain version")

    graph_ms = graph_replay_check(lambda: dense_dual.dual_matmul(b, xu, xi, bt),
                                  close_to_plain)
    del pu, pi
    if grad:
        xu.requires_grad_(True)
        xi.requires_grad_(True)
        ou, oi = dense_dual.dual_matmul(b, xu, xi, bt)
        wu, wi = torch.randn_like(ou), torch.randn_like(oi)
        ((ou * wu).sum() + (oi * wi).sum()).backward()
        gu, gi = dense_dual.dual_matmul_plain(b, wu.to(dtype), wi.to(dtype))
        # a bf16 gradient is the f32 sum rounded to bf16: two f32 sums a few
        # bits apart may round to neighbouring bf16 values, 2^-7 apart
        rtol = K1_FLOAT_RTOL if dtype == torch.float32 else 2 ** -7
        for got, want in ((xu.grad, gu), (xi.grad, gi)):
            if not torch.allclose(got.float(), want.to(dtype).float(), rtol=rtol,
                                  atol=K1_FLOAT_ATOL):
                raise RuntimeError(f"K1 float {tag} {dtype}: the backward differs "
                                   f"from the plain products")
        xu, xi = xu.detach(), xi.detach()
    ms = cuda_ms(lambda: dense_dual.dual_matmul(b, xu, xi, bt), reps=5)
    ms_b2b = back_to_back_ms(lambda: dense_dual.dual_matmul(b, xu, xi, bt), ms)
    plain_ms = cuda_ms(lambda: dense_dual.dual_matmul_plain(b, xu, xi), reps=3)
    b_mm = b.to(dtype)
    lib_u, lib_i = torch.matmul(b_mm, xi), torch.matmul(b_mm.T, xu)
    # the yardstick must compute the same function; in bf16 its output is
    # bf16 and its reductions may run in bf16, which is no measure of K1,
    # so its distance is only reported
    lib_err = max(float((lib_u.float() - ou).abs().max()),
                  float((lib_i.float() - oi).abs().max()))
    if dtype == torch.float32 and not (torch.allclose(lib_u, ou, rtol=1e-4, atol=1e-4)
                                       and torch.allclose(lib_i, oi, rtol=1e-4, atol=1e-4)):
        raise RuntimeError(f"K1 float {tag}: the torch.matmul yardstick disagrees by {lib_err}")
    library_ms = cuda_ms(lambda: (torch.matmul(b_mm, xi), torch.matmul(b_mm.T, xu)), reps=5)
    del b_mm, lib_u, lib_i
    esz = xu.element_size()
    pieces = 1 if dtype == torch.bfloat16 else 3
    bms, bound_by = bound_ms(u * i + esz * (u + i) * d + 4 * (u + i) * d,
                             pieces * 4.0 * u * i * d, PEAK["bfloat16"])
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    k_ms = (kernel_only_ms(lambda: dense_dual.dual_matmul(b, xu, xi, bt), "dual_float_kernel")
            if tag == "yelp" else None)
    row = {"shape": [u, i, d], "x": dt, "tag": tag,
           "match": f"rtol {K1_FLOAT_RTOL} atol {K1_FLOAT_ATOL}", "max_abs_err": err,
           "ms": ms, "ms_back_to_back": ms_b2b, "kernel_only_ms": k_ms, "graph_ms": graph_ms,
           "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bms, "bound_by": bound_by,
           "library_max_abs_diff": lib_err}
    log(f"[kernel] K1 float {tag} U={u} I={i} D={d} {dt}: max |err| {err:.3g} (also "
        f"replayed from a graph, {graph_ms:.4f} ms), {ms:.4f} ms ({ms_b2b:.4f} back to back, kernel alone {k_ms}; bound {bms:.4f} ms "
        f"by {bound_by}, plain {plain_ms:.3f} ms, torch.matmul x2 {library_ms:.4f} ms)")
    return row


def k2_case(tag, layout, w, x, exact=False):
    """K2 vs plain on one layout, weights (P, V, K) and rows x (n, P*D);
    returns its row of the kernel table. The bound reads vidx, w, x and the
    row pointer once, writes the f32 output once, and does 2*V*K*P*D f32
    operations; the gathered-row bytes (V*K rows of P*D values) are printed
    beside it. The library time is torch.sparse.mm over each pass's CSR
    matrix of the same nonzeros, in x's dtype."""
    import torch

    from selfrec_tpu_torch.ops import ell_gather

    p, v, k = w.shape
    c = x.shape[1]
    out = ell_gather.ell_gather_sum(layout, w, x)
    torch.cuda.synchronize()
    ref = ell_gather.ell_gather_sum_plain(layout, w, x)
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    if exact:
        if not torch.equal(out, ref):
            raise RuntimeError(f"K2 {tag}: {int((out != ref).sum())} outputs differ "
                               f"from the plain version, max |err| {err}")
    elif not torch.allclose(out, ref, rtol=K2_RTOL, atol=K2_ATOL):
        raise RuntimeError(f"K2 {tag}: differs from the plain version beyond "
                           f"rtol/atol {K2_RTOL}, max |err| {err}")
    if not torch.equal(out, ell_gather.ell_gather_sum(layout, w, x)):
        raise RuntimeError(f"K2 {tag}: two runs on the same inputs differ")

    def same_as_eager(got):
        # the eager launch equals the plain version (above) and K2 repeats
        # bit for bit, so the replay must equal it exactly
        if not torch.equal(got, out):
            raise RuntimeError(f"K2 {tag}: launched from a replayed graph, it differs "
                               f"from the plain version")

    graph_ms = graph_replay_check(lambda: ell_gather.ell_gather_sum(layout, w, x),
                                  same_as_eager)
    del ref
    ms = cuda_ms(lambda: ell_gather.ell_gather_sum(layout, w, x), reps=20)
    ms_b2b = back_to_back_ms(lambda: ell_gather.ell_gather_sum(layout, w, x), ms)
    plain_ms = cuda_ms(lambda: ell_gather.ell_gather_sum_plain(layout, w, x), reps=3)

    rows = layout.vdst.long().repeat_interleave(k)
    cols = layout.vidx.long()
    d = c // p
    mats = []
    for i in range(p):
        keep = w[i].reshape(-1) != 0
        csr = torch.sparse_coo_tensor(
            torch.stack([rows[keep], cols[keep]]), w[i].reshape(-1)[keep],
            (layout.n_rows, x.shape[0])).coalesce().to_sparse_csr()
        mats.append(torch.sparse_csr_tensor(
            csr.crow_indices(), csr.col_indices(), csr.values().to(x.dtype), csr.shape))
    xs = [x[:, i * d:(i + 1) * d].contiguous() for i in range(p)]

    def library():
        return [torch.sparse.mm(m, xi) for m, xi in zip(mats, xs)]

    lib = torch.cat(library(), dim=1).float()
    # the yardstick must compute the same function; with bf16 rows its
    # output is bf16, whose rounding (and the library's own summation in
    # bf16) is no measure of K2, so its distance is only reported
    lib_err = float((lib - out).abs().max()) if out.numel() else 0.0
    if x.dtype == torch.float32 and not torch.allclose(lib, out, rtol=1e-4, atol=1e-4):
        raise RuntimeError(f"K2 {tag}: the torch.sparse.mm yardstick disagrees "
                           f"by {lib_err}")
    library_ms = cuda_ms(library, reps=10)
    del mats, lib
    nbytes = (layout.vidx.numel() * 4 + w.numel() * 4 + x.numel() * x.element_size()
              + layout.row_ptr.numel() * 4 + out.numel() * 4)
    bms, bound_by = bound_ms(nbytes, 2.0 * v * k * c, PEAK["float32"])
    gathered = v * k * c * x.element_size()
    dt = "bf16" if x.dtype == torch.bfloat16 else "f32"
    row = {"shape": {"V": v, "K": k, "P": p, "D": d, "n_rows": layout.n_rows,
                     "n_src": x.shape[0], "x": dt},
           "tag": tag, "match": "exact" if exact else f"rtol/atol {K2_RTOL}",
           "max_abs_err": err, "ms": ms, "ms_back_to_back": ms_b2b, "graph_ms": graph_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
           "bound_by": bound_by, "gathered_bytes": gathered,
           "library_max_abs_diff": lib_err}
    log(f"[kernel] K2 {tag} V={v} K={k} P={p} D={d} {dt}: max |err| {err:.3g} (also "
        f"replayed from a graph, {graph_ms:.4f} ms), {ms:.4f} ms ({ms_b2b:.4f} back to back; bound {bms:.4f} ms by {bound_by}, "
        f"gathered rows {gathered / 1e9:.3f} GB; plain {plain_ms:.3f} ms, sparse.mm x{p} "
        f"{library_ms:.4f} ms, kernel/sparse.mm {ms / library_ms:.3f}, max |sparse.mm "
        f"- K2| {lib_err:.3g})")
    return row


def ragged_layout(k, n_rows, n_src, gen_np):
    """A random layout in which row 0 spans 60 virtual rows."""
    import numpy as np

    from selfrec_tpu_torch.ops.spmm_ell import build_ell_layout

    dst = np.concatenate([np.zeros(60 * k, np.int32),
                          gen_np.integers(1, n_rows, 40 * n_rows).astype(np.int32)])
    src = gen_np.integers(0, n_src, len(dst)).astype(np.int32)
    return build_ell_layout(src, dst, n_rows, k=k, device="cuda")[0]


def k2_phase(sgl):
    """K2's rows: ragged layouts, the yelp unified layout (P = 1, f32 and
    bf16 rows), SGL's packed template (P = 3) and the gather probe."""
    import numpy as np
    import torch

    from selfrec_tpu_torch.ops.spmm_ell import build_ell_layout, ell_weights

    gen = torch.Generator(device="cuda").manual_seed(1)
    rng = np.random.default_rng(1)
    rows = []
    for k, p in ((4, 1), (16, 3)):
        layout = ragged_layout(k, 5000, 4000, rng)
        w = torch.rand((p, layout.vdst.shape[0], k), generator=gen, device="cuda")
        x = torch.randn((4000, p * 64), generator=gen, device="cuda")
        rows.append(k2_case("ragged", layout, w, x))
    n = sgl.data.user_num + sgl.data.item_num
    fwd = sgl.adj.fwd
    w1 = sgl.adj.w_fwd[None]
    x1 = torch.randn((n, 64), generator=gen, device="cuda")
    rows.append(k2_case("yelp", fwd, w1, x1))
    rows.append(k2_case("yelp", fwd, w1.to(torch.bfloat16).float(), x1.to(torch.bfloat16)))
    tmpl = sgl._view_template
    stack = torch.stack([sgl._w_clean, sgl.aux["w1"], sgl.aux["w2"]])
    for got, layout in zip(sgl._slots, (tmpl.fwd, tmpl.bwd)):
        if not torch.equal(got, ell_weights(layout, stack)):
            raise RuntimeError("SGL's slot weights differ from ell_weights of the epoch's stack")
    log(f"[k2] SGL ELL: the epoch's slot weights {tuple(sgl._slots.fwd.shape)} and "
        f"{tuple(sgl._slots.bwd.shape)} equal ell_weights of its stack")
    rows.append(k2_case("yelp packed", tmpl.fwd, sgl._slots.fwd,
                        torch.randn((n, 192), generator=gen, device="cuda")))
    # scripts/probe_mosaic_gather.py's case: table[idx], n 256, D 128
    table = torch.as_tensor(np.random.default_rng(0).normal(size=(256, 128)),
                            dtype=torch.float32, device="cuda")
    idx = np.random.default_rng(1).integers(0, 256, size=256).astype(np.int32)
    probe, _ = build_ell_layout(idx, np.arange(256, dtype=np.int32), 256, k=1,
                                device="cuda")
    ones = torch.ones((1, 256, 1), device="cuda")
    rows.append(k2_case("probe", probe, ones, table, exact=True))
    from selfrec_tpu_torch.ops.ell_gather import ell_gather_sum

    if not torch.equal(ell_gather_sum(probe, ones, table), table[torch.as_tensor(
            idx, device="cuda").long()]):
        raise RuntimeError("K2 probe: the gather differs from table[idx]")
    return rows


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


def graph_conf(name, extra, **top):
    from selfrec_tpu_torch.config import ModelConf

    conf = {
        "training.set": "<synthetic>",
        "test.set": "<synthetic>",
        "model": {"name": name, "type": "graph"},
        "item.ranking.topN": [10, 20],
        "embedding.size": 64,
        "max.epoch": 1,
        "batch.size": 2048,
        "learning.rate": 0.001,
        "reg.lambda": 0.0001,
        name: extra,
        "output": os.path.join("results", "chip_smoke"),
        "seed": 0,
    }
    conf.update(top)
    return ModelConf(conf)


SIMGCL = {"n_layer": 3, "lambda": 0.5, "eps": 0.1}
SGL_CONF = {"n_layer": 2, "lambda": 0.1, "drop_rate": 0.1, "aug_type": 1, "temp": 0.2}
XSIMGCL = {"n_layer": 3, "l_star": 1, "lambda": 0.2, "eps": 0.2, "tau": 0.15}
DIRECTAU = {"gamma": 2, "n_layers": 3}
MIXGCF = {"n_layer": 3, "n_negs": 64}
SELFCF = {"n_layer": 2, "tau": 0.05}
BUIR_CONF = {"n_layer": 2, "drop_rate": 0.2, "tau": 0.995}
NCL_CONF = {"n_layer": 3, "ssl_reg": 1e-6, "proto_reg": 1e-7, "tau": 0.05,
            "hyper_layers": 1, "alpha": 1.5, "num_clusters": 2000}
SSL4REC = {"tau": 0.07, "alpha": 0.1, "drop": 0.1}


class knobs:
    """Environment knobs set for one phase and restored after (None unsets)."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pinned_bf16():
    """The dense bf16 mode around a build, as bench.py's _pinned_bf16 pins
    it for BUIR and SelfCF: SELFREC_TPU_DENSE_DTYPE unset (its default is
    bfloat16) inside, restored after."""
    return knobs(SELFREC_TPU_DENSE_DTYPE=None)


def check_close(tag, what, a, b, rtol, atol):
    import torch

    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        raise RuntimeError(f"{tag}: {what} on the card differs from the CPU by up to "
                           f"{float((a - b).abs().max())} (rtol {rtol}, atol {atol})")


def check_topk_alike(tag, models, ue_cpu, ie_cpu):
    """Full-rank eval of the same embeddings on both devices. Items with the
    same neighbourhood get the same embedding, and f32 scores summed in
    another order may swap near-ties, so the devices may order ties
    differently: the card's lists must score like the CPU's position by
    position (float64 rescoring), as they do when they differ only by the
    order of ties. Returns the share of ids that differ."""
    import torch

    from selfrec_tpu_torch.ops import ranking

    top = {dev: torch.as_tensor(ranking.topk_ids_from_embeddings(
               m.data, ue_cpu.to(m.device), ie_cpu.to(m.device), 20))
           for dev, m in models.items()}
    uids = torch.as_tensor(models["cpu"].data.test_user_ids).long()
    id_off = float((top["cuda"] != top["cpu"]).double().mean())
    if not torch.allclose(rescored(ue_cpu, ie_cpu, uids, top["cuda"]),
                          rescored(ue_cpu, ie_cpu, uids, top["cpu"]), rtol=1e-5, atol=1e-6):
        raise RuntimeError(f"{tag}: the card's top-20 lists score differently "
                           f"from the CPU's ({100 * id_off:.2f}% of ids differ)")
    return id_off, len(uids)


def small_pair(cls, conf):
    """The same model on the CPU and on the card, on a small graph, with the
    CPU's weights on both."""
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    train, test = synth_graph_mapped(600, 900, 12000, seed=5)
    models = {dev: cls(conf, train, test, device=dev) for dev in ("cpu", "cuda")}
    for m in models.values():
        m.build()
    models["cuda"].set_params(models["cpu"].params)
    return models


def small_batch(data, gen, nb=256, n_valid=200):
    import torch

    return {"u": torch.randint(0, data.user_num, (nb,), generator=gen),
            "i": torch.randint(0, data.item_num, (nb,), generator=gen),
            "j": torch.randint(0, data.item_num, (nb,), generator=gen),
            "mask": (torch.arange(nb) < n_valid).float()}


def check_int8_alike(tag, out):
    """Card against CPU for (user_emb, item_emb, loss) through int8
    propagation. Quantization is a step function: a last-bit difference in
    a reduction (norms, means) can move a value across a rounding boundary
    and change it by one quantum (max|column|/127 before rescaling). So at
    most 0.1% of the values may leave rtol 1e-4 / atol 1e-6, and none by
    more than 1% of the largest magnitude."""
    import torch

    for a, b, what in zip(out["cuda"], out["cpu"], ("user_emb", "item_emb", "loss")):
        off = ~torch.isclose(a, b, rtol=1e-4, atol=1e-6)
        worst = float((a - b).abs().max())
        if float(off.float().mean()) > 1e-3 or worst > 1e-2 * float(b.abs().max()):
            raise RuntimeError(f"{tag}: {what} on the card differs from the CPU in "
                               f"{int(off.sum())} values, by up to {worst}")


def simgcl_reference_phase():
    """Small graph: the card's SimGCL (int8x8 dense) agrees with the same
    weights on the CPU."""
    import torch

    from selfrec_tpu_torch.models.graph.simgcl import SimGCL

    set_layout(dense=True)
    models = small_pair(SimGCL, graph_conf("SimGCL", SIMGCL, **{"batch.size": 256}))
    gen = torch.Generator().manual_seed(3)
    n = models["cpu"].data.user_num + models["cpu"].data.item_num
    noise = [[torch.rand((n, 64), generator=gen) for _ in range(2)] for _ in range(3)]
    batch = small_batch(models["cpu"].data, gen)
    out = {}
    for dev, m in models.items():
        with torch.no_grad():
            ue, ie = m.embeddings()
            loss = m.batch_loss(m.params, {k: v.to(dev) for k, v in batch.items()},
                                noise=[[x.to(dev) for x in pair] for pair in noise])
        out[dev] = (ue.cpu(), ie.cpu(), loss.cpu())
    check_int8_alike("reference phase", out)
    id_off, n_users = check_topk_alike("reference phase", models, out["cpu"][0],
                                       out["cpu"][1])
    log(f"[reference] SimGCL small graph U={models['cpu'].data.user_num} "
        f"I={models['cpu'].data.item_num}: card agrees with the CPU "
        f"(<= 0.1% of values beyond rtol 1e-4 / atol 1e-6), "
        f"loss {float(out['cuda'][2]):.6f} vs {float(out['cpu'][2]):.6f}; "
        f"top-20 lists of {n_users} users score alike ({100 * id_off:.2f}% of "
        f"ids differ, all within score ties)")


def sgl_reference_phase():
    """Small graph: SGL's ELL arm on the card (K2) agrees with the CPU (K2's
    plain version) on the same weights, keep masks and batch. f32
    throughout, sums in another order: embeddings rtol 1e-5 / atol 1e-6,
    loss rtol 1e-5, grads rtol 1e-4 / atol 1e-7 (the CPU tests' tolerances
    against the JAX package)."""
    import torch

    from selfrec_tpu_torch.models.graph.sgl import SGL

    set_layout(dense=False)
    models = small_pair(SGL, graph_conf("SGL", SGL_CONF, **{"batch.size": 256}))
    batch = small_batch(models["cpu"].data, torch.Generator().manual_seed(4))
    out = {}
    for dev, m in models.items():
        m.aux = m.epoch_setup(0)
        with torch.no_grad():
            ue, ie = m.embeddings()
        params = {k: v.detach().clone().requires_grad_(True) for k, v in m.params.items()}
        loss = m.batch_loss(params, dict({k: v.to(m.device) for k, v in batch.items()},
                                         aux=m.aux))
        loss.backward()
        out[dev] = {"user_emb": ue.cpu(), "item_emb": ie.cpu(), "loss": loss.detach().cpu(),
                    "w1": m.aux["w1"].cpu(), "w2": m.aux["w2"].cpu(),
                    **{f"grad {k}": v.grad.cpu() for k, v in params.items()}}
    tol = {"user_emb": (1e-5, 1e-6), "item_emb": (1e-5, 1e-6), "loss": (1e-5, 0.0),
           "w1": (1e-6, 0.0), "w2": (1e-6, 0.0)}
    for what, a in out["cuda"].items():
        rtol, atol = tol.get(what, (1e-4, 1e-7))
        check_close("SGL reference phase", what, a, out["cpu"][what], rtol, atol)
    id_off, n_users = check_topk_alike("SGL reference phase", models,
                                       out["cpu"]["user_emb"], out["cpu"]["item_emb"])
    log(f"[reference] SGL ELL small graph: card agrees with the CPU (embeddings "
        f"rtol 1e-5, grads rtol 1e-4), loss {float(out['cuda']['loss']):.6f} vs "
        f"{float(out['cpu']['loss']):.6f}; top-20 lists of {n_users} users score "
        f"alike ({100 * id_off:.2f}% of ids differ, all within score ties)")


def xsimgcl_reference_phase():
    """Small graph: the card's XSimGCL (int8x8 dense) agrees with the same
    weights on the CPU: embeddings (the clean pass), one batch loss with
    fed noise (the perturbed pass), top-20 lists."""
    import torch

    from selfrec_tpu_torch.models.graph.xsimgcl import XSimGCL

    set_layout(dense=True)
    models = small_pair(XSimGCL, graph_conf("XSimGCL", XSIMGCL, **{"batch.size": 256}))
    gen = torch.Generator().manual_seed(6)
    n = models["cpu"].data.user_num + models["cpu"].data.item_num
    noise = [torch.rand((n, 64), generator=gen) for _ in range(XSIMGCL["n_layer"])]
    batch = small_batch(models["cpu"].data, gen)
    out = {}
    for dev, m in models.items():
        with torch.no_grad():
            ue, ie = m.embeddings()
            loss = m.batch_loss(m.params, {k: v.to(dev) for k, v in batch.items()},
                                noise=[x.to(dev) for x in noise])
        out[dev] = (ue.cpu(), ie.cpu(), loss.cpu())
    check_int8_alike("XSimGCL reference phase", out)
    id_off, n_users = check_topk_alike("XSimGCL reference phase", models, out["cpu"][0],
                                       out["cpu"][1])
    log(f"[reference] XSimGCL small graph: card agrees with the CPU (<= 0.1% of values "
        f"beyond rtol 1e-4 / atol 1e-6), loss {float(out['cuda'][2]):.6f} vs "
        f"{float(out['cpu'][2]):.6f}; top-20 lists of {n_users} users score alike "
        f"({100 * id_off:.2f}% of ids differ, all within score ties)")


def resume_phase():
    """Small graph: XSimGCL on the card for 4 epochs, and for 2 epochs then
    resumed to 4 from its checkpoint (checkpoint.interval 2), under
    results/; the parameters agree within the JAX package's resume test's
    rtol 2e-3 / atol 2e-4 (tests/test_checkpoint.py:53-58). The continuous
    run's profile.dir trace (its second epoch) names K1's kernel. The
    runs' own prints go to results/ too."""
    import contextlib
    import shutil

    import torch

    from selfrec_tpu_torch.models.graph.xsimgcl import XSimGCL
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    set_layout(dense=True)
    train, test = synth_graph_mapped(600, 900, 12000, seed=5)
    root = os.path.join("results", "chip_smoke", f"resume_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def run(tag, epochs, **extra):
        conf = graph_conf("XSimGCL", XSIMGCL, **{"max.epoch": epochs, "checkpoint.interval": 2,
                                                 "checkpoint.dir": os.path.join(root, tag),
                                                 **extra})
        model = XSimGCL(conf, train, test, device="cuda")
        model.build()
        with open(os.path.join(root, f"{tag}_{epochs}.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            model.train()
        torch.cuda.synchronize()
        return model

    try:
        t0 = time.time()
        trace_dir = os.path.join(root, "trace")
        full = run("full", 4, **{"profile.dir": trace_dir})
        run("resumed", 2)
        resumed = run("resumed", 4)
        worst = 0.0
        for k in full.params:
            a, b = resumed.params[k].detach(), full.params[k].detach()
            worst = max(worst, float((a - b).abs().max()))
            check_close("resume phase", f"{k} after resuming at epoch 2", a, b, 2e-3, 2e-4)
        traces = os.listdir(trace_dir)
        if len(traces) != 1:
            raise RuntimeError(f"resume phase: profile.dir holds {traces}, expected one trace")
        with open(os.path.join(trace_dir, traces[0])) as f:
            k1_in_trace = f.read().count("dual_s8_kernel")
        if k1_in_trace == 0:
            raise RuntimeError("resume phase: the profile.dir trace shows no K1 launch")
        log(f"[resume] XSimGCL small graph U={full.data.user_num} I={full.data.item_num}: "
            f"2 epochs + resume to 4 agree with 4 epochs (max |diff| {worst:.3g}, rtol 2e-3 "
            f"/ atol 2e-4); trace {traces[0]} names dual_s8_kernel {k1_in_trace} times; "
            f"{time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_float_alike(tag, out):
    """Card against CPU in the dense bf16 mode, tensor by tensor. Both round
    each hop's operand to bf16 and sum exact products in f32, in another
    order, so a value next to a bf16 rounding boundary can round the other
    way (2^-8 relative) and carry into the next hop: at most 0.1% of a
    tensor's values may leave rtol 1e-4 / atol 1e-5 of its largest
    magnitude, none by more than 2^-7 of it. Returns the largest difference
    relative to the largest magnitude."""
    import torch

    worst_share = 0.0
    for what, a in out["cuda"].items():
        b = out["cpu"][what]
        scale = float(b.abs().max())
        off = ~torch.isclose(a, b, rtol=1e-4, atol=1e-5 * scale)
        worst = float((a - b).abs().max())
        worst_share = max(worst_share, worst / max(scale, 1e-30))
        if float(off.float().mean()) > 1e-3 or worst > 2 ** -7 * scale:
            raise RuntimeError(f"{tag}: {what} on the card differs from the CPU in "
                               f"{int(off.sum())} of {off.numel()} values, by up to {worst} "
                               f"(largest magnitude {scale})")
    return worst_share


def dense_float_reference_phase(k1_float):
    """Small graph, dense bf16 mode: SelfCF, and BUIR with the CPU's rate
    and keep draws fed to both, on the card (K1's float kernel, forward and
    backward: SelfCF 4 launches, BUIR 6) against the CPU (its plain
    version): embeddings, one batch loss, its grads, top-20 lists."""
    import torch

    from selfrec_tpu_torch.models.graph.buir import BUIR
    from selfrec_tpu_torch.models.graph.selfcf import SelfCF

    set_layout(dense=True)
    for cls, name, extra, expect in ((SelfCF, "SelfCF", SELFCF, 4),
                                     (BUIR, "BUIR", BUIR_CONF, 6)):
        with pinned_bf16():
            models = small_pair(cls, graph_conf(name, extra, **{"batch.size": 256}))
        models["cuda"].aux = {k: v.to("cuda") for k, v in models["cpu"].aux.items()}
        batch = small_batch(models["cpu"].data, torch.Generator().manual_seed(7))
        views = (models["cpu"].draw(torch.Generator().manual_seed(8)) if name == "BUIR"
                 else None)
        out = {}
        for dev, m in models.items():
            if m.adj.mm_dtype != torch.bfloat16:
                raise RuntimeError(f"{name} reference phase: {m.adj!r} is not bf16")
            with torch.no_grad():
                ue, ie = m.embeddings()
            params = {k: v.detach().clone().requires_grad_(True) for k, v in m.params.items()}
            b = dict({k: v.to(dev) for k, v in batch.items()}, aux=m.aux)
            kw = {} if views is None else {"views": [(r.to(dev), k.to(dev))
                                                     for r, k in views]}
            before = k1_float.launches
            loss = m.batch_loss(params, b, **kw)
            loss.backward()
            torch.cuda.synchronize()
            launched = k1_float.launches - before
            if launched != (expect if dev == "cuda" else 0):
                raise RuntimeError(f"{name} reference phase: {launched} K1 float launches "
                                   f"on {dev}, expected {expect if dev == 'cuda' else 0}")
            out[dev] = {"user_emb": ue.cpu(), "item_emb": ie.cpu(), "loss": loss.detach().cpu(),
                        **{f"grad {k}": v.grad.cpu() for k, v in params.items()}}
        share = check_float_alike(f"{name} reference phase", out)
        id_off, n_users = check_topk_alike(f"{name} reference phase", models,
                                           out["cpu"]["user_emb"], out["cpu"]["item_emb"])
        log(f"[reference] {name} dense bf16 small graph: card (K1 float, {expect} launches) "
            f"agrees with the CPU (largest difference {share:.3g} of the largest magnitude), "
            f"loss {float(out['cuda']['loss']):.6f} vs {float(out['cpu']['loss']):.6f}; "
            f"top-20 lists of {n_users} users score alike ({100 * id_off:.2f}% of ids differ, "
            f"all within score ties)")


def buir_k2_row(model):
    """K2's row at P = 2: BUIR's packed online + target chain, one step's
    dropped weights over the yelp unified layout, D 64 a pass."""
    import torch

    from selfrec_tpu_torch.ops.spmm_ell import ell_weights

    ew = model.adj.edge_w
    views = model.draw(torch.Generator(device="cuda").manual_seed(2))
    w_stack = torch.stack([torch.where(keep, ew / (1.0 - rate), torch.zeros_like(ew))
                           for rate, keep in views])
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = model.data.user_num + model.data.item_num
    return k2_case("yelp packed P2", model.adj.fwd, ell_weights(model.adj.fwd, w_stack),
                   torch.randn((n, 128), generator=gen, device="cuda"))


def ncl_estep(model):
    """NCL's E-step on its own, as bench.py:663-670 isolates it: k-means on
    both raw tables, 25 Lloyd iterations at k 2000. Timed twice (the first
    pays the allocator's warm-up); checks the centroids and assignments."""
    import torch

    model._proto_phase = True
    times = []
    for epoch in (20, 21):
        torch.cuda.synchronize()
        t0 = time.time()
        aux = model.epoch_setup(epoch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.time() - t0))
    for side, n in (("user", model.data.user_num), ("item", model.data.item_num)):
        cent, assign = aux[f"{side}_cent"], aux[f"{side}2c"]
        if (tuple(cent.shape) != (model.k, 64) or tuple(assign.shape) != (n,)
                or not bool(torch.isfinite(cent).all())
                or int(assign.min()) < 0 or int(assign.max()) >= model.k):
            raise RuntimeError(f"NCL E-step: bad {side} centroids or assignments")
    used = [int(torch.unique(aux[f"{s}2c"]).numel()) for s in ("user", "item")]
    log(f"[estep NCL] 2 tables x 25 Lloyd iterations at k {model.k}: {times[0]:.1f} ms, "
        f"again {times[1]:.1f} ms; clusters in use {used[0]} (users), {used[1]} (items)")
    return times


def train_path(tag, model, counter, n_batches, per_step=None, profile_steps=0, atomics=None):
    """The trainer's step over the first ``n_batches`` batches of epoch 0,
    after epoch_setup, with ``counter`` (a kernel wrapper, or a tuple of
    them whose counts add) set to 0 just before and read just after. The
    steps run as the trainer runs them on the card: the first
    ``GRAPH_WARMUP`` eagerly as the step graph's warm-up, then the capture,
    then replays. Checks finite losses and the launch count (exactly
    ``per_step`` a step, 0 included, or at least one), replays included.
    Then the eager twin (:func:`twin_gate`, ``atomics`` as there) over the
    next ``TWIN_STEPS`` batches, and ``profile_steps`` graphed steps under
    the profiler. Returns the launches and the graphed ms/step of the replays."""
    import torch

    counters = counter if isinstance(counter, tuple) else (counter,)
    users, items, masks = model.epoch_batches(0)
    torch.cuda.synchronize()
    t_setup = time.time()
    model.begin_epoch(0)
    torch.cuda.synchronize()
    setup_ms = 1e3 * (time.time() - t_setup)
    m = min(n_batches, users.shape[0] - profile_steps - TWIN_STEPS)
    w = GRAPH_WARMUP + 1  # the warm-up steps and the captured one
    replays0 = model._graphs["train"].replays if "train" in model._graphs else 0
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.time()
    first = model.train_batches(users[:w], items[:w], masks[:w])
    torch.cuda.synchronize()
    t1 = time.time()
    rest = model.train_batches(users[w:m], items[w:m], masks[w:m])
    torch.cuda.synchronize()
    t2 = time.time()
    launches = sum(c.launches for c in counters)
    step_ms = 1e3 * (t2 - t1) / (m - w)
    losses = torch.cat([first, rest]).cpu()
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"{tag} train: non-finite losses {losses.tolist()}")
    if (launches != per_step * m) if per_step is not None else launches <= 0:
        raise RuntimeError(f"{tag} train: {launches} kernel launches in {m} steps, "
                           f"expected {'some' if per_step is None else per_step} a step")
    eager = model.step_graph_eager_reason()  # a mesh: eager by rule
    runner = model._graphs.get("train")
    if eager is None and (runner is None or not runner.graphed
                          or runner.replays - replays0 != m - GRAPH_WARMUP):
        raise RuntimeError(f"{tag} train: the steps did not run as replays of a captured "
                           f"graph ({model.graph_report() or 'no graph'})")
    first_how = (f"{GRAPH_WARMUP} eager warm-up and the capture" if eager is None
                 else f"eager: {eager}")
    log(f"[train {tag}] {m} batches x {model.batch_size}: loss {float(losses[0]):.6f} -> "
        f"{float(losses[-1]):.6f}, {t2 - t0:.3f} s, "
        f"{m * model.batch_size / (t2 - t0):.1f} examples/s (first {w} steps, {first_how}, "
        f"{1e3 * (t1 - t0):.1f} ms; steps {w + 1}..{m} "
        f"{'replayed' if eager is None else 'eager'}: {step_ms:.2f} ms/step, "
        f"{(m - w) * model.batch_size / (t2 - t1):.1f} examples/s), launches {launches}; "
        f"epoch_setup {setup_ms:.1f} ms; graph {model.graph_report() or 'none'}")
    if eager is None:
        twin = slice(m, m + TWIN_STEPS)
        twin_gate(tag, model, (users[twin], items[twin], masks[twin]), atomics)
    if profile_steps:
        n = profile_steps
        p = slice(m + TWIN_STEPS, m + TWIN_STEPS + n)
        profile_window(f"train {tag}{' graphed' if eager is None else ''}",
                       lambda: model.train_batches(users[p], items[p], masks[p]), n)
    return launches, step_ms


def eval_path(tag, model, counter, profile=False, expect=None, width=64):
    """compute_embeddings plus one fast_evaluation over all test users, with
    the kernel's count (or the counts of a tuple of wrappers) set to 0 just
    before; it must launch ``expect`` times, by default once a layer. The
    embeddings are ``width`` wide (128 for the concatenated or tower
    embeddings of BUIR, SelfCF and SSL4Rec)."""
    import torch

    from selfrec_tpu_torch.ops import rank_topk
    from selfrec_tpu_torch.utils import metrics

    counters = counter if isinstance(counter, tuple) else (counter,)
    expect = model.n_layers if expect is None else expect
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    ranked = rank_topk.rank_topk.launches
    t0 = time.time()
    model.user_emb, model.item_emb = model.embeddings()
    measure = model.fast_evaluation(0)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.time() - t0)
    launches = sum(c.launches for c in counters)
    RANK_LAUNCHES[tag] = rank_topk.rank_topk.launches - ranked
    if RANK_LAUNCHES[tag]:
        hit_gate(tag, model)
    ue, ie = model.user_emb, model.item_emb
    if (tuple(ue.shape) != (model.data.user_num, width)
            or tuple(ie.shape) != (model.data.item_num, width)
            or not bool(torch.isfinite(ue).all() & torch.isfinite(ie).all())):
        raise RuntimeError(f"{tag} eval: embeddings of the wrong shape or not finite")
    if launches != expect:
        raise RuntimeError(f"{tag} eval: {launches} kernel launches, expected {expect}")
    perf = metrics.parse_measure(measure)
    if not all(math.isfinite(v) for v in perf.values()):
        raise RuntimeError(f"{tag} eval: metrics not finite: {perf}")
    log(f"[eval {tag}] Recall@20 {perf['Recall']} NDCG@20 {perf['NDCG']}, "
        f"{eval_ms:.1f} ms, launches {launches}, ranking kernels {RANK_LAUNCHES[tag]}")
    if profile:
        def one_eval():
            model.user_emb, model.item_emb = model.embeddings()
            model.fast_evaluation(0)

        profile_window(f"eval {tag}", one_eval, 1)
    return launches


def host_hits(ids, offsets, items, n_items):
    """The hit test on the host, independent of the port's: each (row, id)
    key searched among the sorted ground-truth keys of the CSR
    ``offsets``, ``items`` (any order within a row)."""
    import numpy as np

    offsets, items = np.asarray(offsets, np.int64), np.asarray(items, np.int64)
    ids = np.asarray(ids, np.int64)
    keys = np.repeat(np.arange(len(offsets) - 1, dtype=np.int64), np.diff(offsets)) * n_items
    keys = np.sort(keys + items)
    want = np.arange(ids.shape[0], dtype=np.int64)[:, None] * n_items + ids
    if len(keys) == 0:
        return np.zeros(ids.shape, dtype=bool)
    return keys[np.minimum(np.searchsorted(keys, want), len(keys) - 1)] == want


def hit_gate(tag, model):
    """The eval's hit mask from the card (as ``_fast_measure`` takes it:
    ``rank_merge``'s epilogue on the kernels' route, ``hits_plain`` on the
    others) on the model's embeddings equals the host search of the same
    ids, and the metric strings from it equal the string path's over
    ``model.test()``."""
    from selfrec_tpu_torch.ops import ranking
    from selfrec_tpu_torch.utils import metrics

    data, hits = model.data, []
    ids = ranking.topk_ids_from_embeddings(data, model.user_emb, model.item_emb, model.max_N,
                                           block_size=model.eval_block_size, hits_out=hits)
    offsets, items = data.test_gt_csr()
    if len(hits) != 1 or not (hits[0] == host_hits(ids, offsets, items, data.item_num)).all():
        raise RuntimeError(f"{tag} eval: the card's hit mask differs from the host search")
    top_ns = [model.max_N]
    if metrics.ranking_evaluation_ids(offsets, items, ids, top_ns, hits[0]) != \
            metrics.ranking_evaluation(data.test_set, model.test(), top_ns):
        raise RuntimeError(f"{tag} eval: the metrics from the hit mask differ from the "
                           f"string path's")
    log(f"[eval {tag}] hit test on the card equals the host search "
        f"({int(hits[0].sum())} hits in {hits[0].size} ids)")


def synthetic_gt(rng, n, n_items, ids, longest=300):
    """A ground-truth CSR on the card, ascending in a row: 0 to ``longest``
    random items a test user plus a random share (none to all) of its row
    of ``ids`` (host, (n, k)), no repeats."""
    import numpy as np
    import torch

    lengths = rng.integers(0, longest + 1, n)
    keys = np.repeat(np.arange(n, dtype=np.int64), lengths) * n_items + rng.integers(
        0, n_items, int(lengths.sum()))
    take = rng.random(ids.shape) < rng.random((n, 1))
    keys = np.unique(np.concatenate(
        [keys, (np.arange(n, dtype=np.int64)[:, None] * n_items + ids)[take]]))
    offsets = np.concatenate([[0], np.cumsum(np.bincount(keys // n_items, minlength=n))])
    return (torch.as_tensor(offsets, dtype=torch.int64, device="cuda"),
            torch.as_tensor((keys % n_items).astype(np.int32), device="cuda"))


def rank_hits_case(ue, ie, rated, uids, k, gt, host_gt, what):
    """``rank_merge`` with its ground-truth test: scores and ids equal to
    the call without it bit for bit, the mask equal to the host search
    over ``host_gt`` (the same ground truth on the host, any order within
    a row). Returns the share of ids that hit."""
    import torch

    from selfrec_tpu_torch.ops import rank_topk

    scs, ids = rank_topk.rank_topk(ue, ie, rated, uids, k)
    gscs, gids, hits = rank_topk.rank_topk(ue, ie, rated, uids, k, gt=gt)
    torch.cuda.synchronize()
    if not (torch.equal(gids, ids) and torch.equal(gscs.view(torch.int32),
                                                   scs.view(torch.int32))):
        raise RuntimeError(f"ranking kernels ({what}, k {k}): the ground-truth test changed "
                           f"the scores or ids")
    if not (hits.cpu().numpy() == host_hits(ids.cpu(), *host_gt, ie.shape[0])).all():
        raise RuntimeError(f"ranking kernels ({what}, k {k}): the hit mask differs from the "
                           f"host search")
    return float(hits.float().mean())


def rank_case(model, k=20):
    """The eval's ranking kernels alone on the model's embeddings, resident
    mask and test users; returns their row of the kernel table. Their ids
    must score like the plain twin's and like the library path's (the GEMM,
    ``torch.where`` and ``torch.topk`` over the plan's blocks, which the
    dense mask took before the kernels) position by position in float64
    rescoring (rtol 1e-5 / atol 1e-6: f32 sums in another order may swap
    near-ties), their scores within 1e-5 of the plain twin's, with no rated
    id and none repeated. Then ``rank_merge``'s ground-truth test
    (:func:`rank_hits_case`) on yelp's ground truth at k and on slices of
    up to 300 items at k and K_MAX, and the kernels timed with and without
    it (``rank_merge`` alone on both ground truths). The bound: 2 * n * I * D f32 FMA operations at 67 TFLOP/s; the
    bytes (the two tables once, the answer) take less."""
    import numpy as np
    import torch

    from selfrec_tpu_torch.ops import rank_topk, ranking

    data = model.data
    ue, ie = model.user_emb.float().contiguous(), model.item_emb.float().contiguous()
    rated = ranking.get_rated_dense(data, "cuda")
    plan = ranking.get_eval_plan(data, model.eval_block_size, "cuda")
    uids = plan.uids
    n, n_items, d = uids.shape[0], ie.shape[0], ie.shape[1]
    before = rank_topk.rank_topk.launches
    scs, ids = rank_topk.rank_topk(ue, ie, rated, uids, k)
    torch.cuda.synchronize()
    if rank_topk.rank_topk.launches != before + 1:
        raise RuntimeError("ranking kernels: no launch counted")
    pscs, pids = rank_topk.rank_topk_plain(ue, ie, rated, uids, k)
    lids = ranking._topk_all_blocks_dense(ue, ie, plan.uids_all, rated, k)[1].reshape(-1, k)[:n]
    ucpu = uids.cpu()
    mine = rescored(ue, ie, ucpu, ids)
    for what, other in (("plain twin", pids), ("library path", lids)):
        if not torch.allclose(mine, rescored(ue, ie, ucpu, other), rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"ranking kernels: the ids score differently from the {what}'s "
                               f"({int((ids != other).sum())} ids differ)")
    err = float((scs - pscs).abs().max())
    if err > 1e-5:
        raise RuntimeError(f"ranking kernels: scores differ from the plain twin's by {err}")
    srt = ids.sort(dim=1).values
    if bool(rated[uids[:, None], ids].any()) or bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise RuntimeError("ranking kernels: a rated or repeated id returned")
    id_off = float((ids != pids).double().mean())
    gt = ranking.get_test_gt(data, "cuda")
    hit_share = rank_hits_case(ue, ie, rated, uids, k, gt, data.test_gt_csr(), "yelp")
    rng = np.random.default_rng(20)
    long_share, long_merge_ms = {}, {}
    for kk in (k, rank_topk.K_MAX):
        kk_ids = rank_topk.rank_topk(ue, ie, rated, uids, kk)[1].cpu().numpy()
        long_gt = synthetic_gt(rng, n, n_items, kk_ids)
        long_share[kk] = rank_hits_case(ue, ie, rated, uids, kk, long_gt,
                                        tuple(t.cpu().numpy() for t in long_gt),
                                        "slices of up to 300")
        # rank_merge alone at k kk, without and with the epilogue searching
        # slices of up to 300 items (yelp's slices of one never iterate)
        long_merge_ms[kk] = [
            kernel_only_ms(lambda kk=kk: rank_topk.rank_topk(ue, ie, rated, uids, kk),
                           "rank_merge_kernel"),
            kernel_only_ms(lambda kk=kk, g=long_gt: rank_topk.rank_topk(ue, ie, rated, uids,
                                                                        kk, gt=g),
                           "rank_merge_kernel")]
    shares = ", ".join(f"{100 * v:.2f}%" for v in long_share.values())
    merges = "; ".join(f"k {kk} {a} without, {b} with" for kk, (a, b) in long_merge_ms.items())
    log(f"[kernel] ranking hit test: rank_merge's mask equals the host search on yelp's "
        f"ground truth ({100 * hit_share:.3f}% of ids hit) and on slices of up to 300 items "
        f"at k {k} and {rank_topk.K_MAX} ({shares} hit); scores and ids unchanged bit for "
        f"bit; rank_merge alone on those slices (ms): {merges}")

    def call():
        return rank_topk.rank_topk(ue, ie, rated, uids, k)

    def call_hits():
        return rank_topk.rank_topk(ue, ie, rated, uids, k, gt=gt)

    ms = cuda_ms(call, reps=20)
    ms_b2b = back_to_back_ms(call, ms)
    ms_hits = cuda_ms(call_hits, reps=20)
    partial_ms = kernel_only_ms(call, "rank_partial_kernel")
    merge_ms = kernel_only_ms(call, "rank_merge_kernel")
    merge_hits_ms = kernel_only_ms(call_hits, "rank_merge_kernel")
    plain_ms = cuda_ms(lambda: rank_topk.rank_topk_plain(ue, ie, rated, uids, k), reps=3)
    library_ms = cuda_ms(lambda: ranking._topk_all_blocks_dense(ue, ie, plan.uids_all, rated,
                                                                k), reps=10)
    tiles_per_slice, slices = rank_topk.slice_plan(n, n_items, ue.device)
    bms, bound_by = bound_ms(4 * (n + n_items) * d + 12 * n * k, 2.0 * n * n_items * d,
                             PEAK["float32"])
    row = {"shape": [n, n_items, d, k], "tag": "yelp eval", "slices": slices,
           "tiles_per_slice": tiles_per_slice, "match": "rescored rtol 1e-5",
           "max_abs_err": err, "ids_differ": id_off, "ms": ms, "ms_back_to_back": ms_b2b,
           "partial_ms": partial_ms, "merge_ms": merge_ms, "ms_with_hits": ms_hits,
           "merge_with_hits_ms": merge_hits_ms, "hit_share": hit_share,
           "merge_long_slices_ms": {str(kk): v for kk, v in long_merge_ms.items()},
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
           "bound_by": bound_by}
    log(f"[kernel] ranking n={n} I={n_items} D={d} k={k}: ids score like the plain twin's and "
        f"the library path's ({100 * id_off:.4f}% of ids differ from the twin's), scores "
        f"within {err:.2e}; {ms:.4f} ms ({ms_b2b:.4f} back to back; rank_partial alone "
        f"{partial_ms}, rank_merge alone {merge_ms}, with its hit test {merge_hits_ms} "
        f"(the call {ms_hits:.4f} ms), {slices} slices of {tiles_per_slice} tiles; bound "
        f"{bms:.4f} ms by {bound_by}, plain {plain_ms:.3f} ms, GEMM + where + topk over "
        f"{plan.uids_all.shape[0]} blocks {library_ms:.4f} ms)")
    return row


def snapshot(model):
    """The trainer state a step changes (params, Adam's state, the step
    generator's state, aux) as a checkpoint holds it, copied to the CPU."""
    from selfrec_tpu_torch.utils import checkpoint as ckpt

    return ckpt._to(ckpt.train_state(model), "cpu")


def restore(model, state):
    """Put ``snapshot``'s state back, in place where a step graph holds it
    (the checkpoint's resume path)."""
    from selfrec_tpu_torch.utils import checkpoint as ckpt

    ckpt.apply_train_state(model, state)


def trainer_values(model, losses):
    """Losses, params, Adam's moments and aux after a run, on the CPU."""
    out = {"losses": losses.detach().cpu()}
    for k, p in model.params.items():
        out[f"param {k}"] = p.detach().cpu()
        for m in ("exp_avg", "exp_avg_sq"):
            out[f"{m} {k}"] = model.optimizer.state[p][m].cpu()
    for k, v in getattr(model, "aux", {}).items():
        out[f"aux {k}"] = v.cpu()
    return out


def twin_gate(tag, model, batches, atomics=None):
    """The eager twin: from one trainer state, the same steps over
    ``batches`` replayed from the captured step graph, run eagerly
    (``eager_batches``), and run eagerly once more. Losses, params, Adam's
    moments and aux of the replays and of the second eager run must equal
    the first eager run's bit for bit, or where the path has float atomics
    (``atomics`` names them) within rtol 1e-5 / atol 1e-6. Returns
    (graphed, eager) ms/step over these few steps, each host clock over the
    run ended by a synchronise: a reading of the twin, not a baseline (the
    eager time follows the host)."""
    import torch

    start = snapshot(model)
    n = batches[0].shape[0]
    runs = {}
    for how, run in (("graphed", model.train_batches), ("eager", model.eager_batches),
                     ("eager again", model.eager_batches)):
        restore(model, start)
        torch.cuda.synchronize()
        t0 = time.time()
        losses = run(*batches)
        torch.cuda.synchronize()
        runs[how] = (1e3 * (time.time() - t0) / n, trainer_values(model, losses))
    e = runs["eager"][1]
    found = []
    for how in ("graphed", "eager again"):
        g = runs[how][1]
        worst = max(float((g[k].double() - e[k].double()).abs().max()) for k in g)
        equal = all(torch.equal(g[k], e[k]) for k in g)
        if not equal and (atomics is None or not all(
                torch.allclose(g[k], e[k], rtol=1e-5, atol=1e-6) for k in g)):
            bad = [k for k in g if not torch.equal(g[k], e[k])]
            need = "bit-equal" if atomics is None else "rtol 1e-5 / atol 1e-6"
            raise RuntimeError(f"{tag} twin: {how} and eager differ after {n} steps in "
                               f"{bad[:6]}, max |diff| {worst} ({need} required)")
        found.append(f"{how} vs eager " + (
            "bit-equal" if equal else f"within rtol 1e-5 / atol 1e-6 (max |diff| {worst:.3g})"))
    log(f"[twin {tag}] {n} steps from one state; losses, params, Adam moments"
        f"{', aux' if getattr(model, 'aux', None) else ''}: {'; '.join(found)}"
        f"{'' if atomics is None else f'; float atomics: {atomics}'}; {n}-step twin reading: "
        f"graphed {runs['graphed'][0]:.2f} ms/step, eager {runs['eager'][0]:.2f} ms/step")
    return runs["graphed"][0], runs["eager"][0]


def graph_replay_check(fn, check):
    """``fn`` (a kernel wrapper's call on fixed inputs) captured into a
    CUDA graph after one warm-up call and replayed: ``check`` gets the
    replay's outputs (it raises where they differ from the plain version).
    Returns the ms of one replay, timed as ``ms``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn()
    graph.replay()
    torch.cuda.synchronize()
    check(static)
    ms = cuda_ms(graph.replay, reps=20)
    del graph, static
    return ms


def free(model):
    """Drop a model's step graphs and their pools before the next phase."""
    import torch

    if hasattr(model, "release_graphs"):
        model.release_graphs()
    torch.cuda.empty_cache()


def sampler_gates(model, n_steps=3):
    """The CSR sampler (the bitmap over budget) against the bitmap sampler
    on the same model: from one generator state the same negatives, and
    over ``n_steps`` trainer steps from one state the same negatives and
    bit-identical losses; then the trainer state is put back. Times one
    sampler call of each at the step's (batch,) lanes."""
    import torch

    from selfrec_tpu_torch.ops import sampling

    if model._rated_bitmap is not None:
        raise RuntimeError("CSR phase: the bitmap fits SELFREC_TPU_NEG_BITMAP_MB")
    bitmap = sampling.bitmap_to_device(sampling.pack_rated_bitmap(
        model.data.rated_offsets, model.data.rated_items, model.data.user_num,
        model.data.item_num), "cuda")
    users, items, masks = model.epoch_batches(0)
    start = snapshot(model)
    drawn = {}
    for tag in ("csr", "bitmap"):
        restore(model, start)
        model._rated_bitmap = bitmap if tag == "bitmap" else None
        negs = []
        sample = type(model).sample_negatives
        model.sample_negatives = lambda u: negs.append(sample(model, u)) or negs[-1]
        # eager steps: the patched sampler and the swapped bitmap are Python
        # state that a captured step would not see again
        losses = model.eager_batches(users[:n_steps], items[:n_steps], masks[:n_steps])
        del model.sample_negatives
        drawn[tag] = (torch.stack(negs), losses)
    model._rated_bitmap = None
    restore(model, start)
    if not torch.equal(drawn["csr"][0], drawn["bitmap"][0]):
        raise RuntimeError("CSR phase: the CSR and bitmap samplers drew different negatives")
    if not torch.equal(drawn["csr"][1], drawn["bitmap"][1]):
        raise RuntimeError(f"CSR phase: losses differ, CSR {drawn['csr'][1].tolist()} bitmap "
                           f"{drawn['bitmap'][1].tolist()}")
    u = users[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = tuple(u.shape)
    csr_ms = cuda_ms(lambda: sampling.sample_negatives(
        gen, u, model._rated_keys, model.data.item_num, shape), reps=20)
    bitmap_ms = cuda_ms(lambda: sampling.sample_negatives_bitmap(
        gen, u, bitmap, model.data.item_num, shape), reps=20)
    log(f"[sampler] CSR (sorted keys) equals the bitmap over "
        f"{n_steps} steps: negatives and losses {drawn['csr'][1].tolist()}; one call at "
        f"{shape[0]} lanes: CSR {csr_ms:.4f} ms, bitmap {bitmap_ms:.4f} ms")


def csr_on_card_gate(model, n=1_000_000):
    """The CSR membership search on the card equals the CPU's on the same
    (user, candidate) lanes of the yelp CSR, and so does the sampler's
    search of the sorted keys on the card."""
    import numpy as np
    import torch

    from selfrec_tpu_torch.ops import sampling

    gen = torch.Generator().manual_seed(5)
    users = torch.randint(0, model.data.user_num, (n,), generator=gen)
    cand = torch.randint(0, model.data.item_num, (n,), generator=gen)
    # half the lanes ask for an item the user rated
    off = torch.as_tensor(model.data.rated_offsets)
    pick = off[users] + (torch.rand(n, generator=gen) * (off[users + 1] - off[users])).long()
    cand = torch.where(torch.arange(n) % 2 == 0,
                       torch.as_tensor(model.data.rated_items).long()[pick], cand)
    steps = int(np.ceil(np.log2(int(np.diff(model.data.rated_offsets).max()) + 1))) + 1
    got = {dev: sampling.searchsorted_in_segments(
        torch.as_tensor(model.data.rated_items, device=dev), off.to(dev), users.to(dev),
        cand.to(dev), steps).cpu() for dev in ("cpu", "cuda")}
    keys = model._rated_keys
    q = users.cuda() * model.data.item_num + cand.cuda()
    keyed = keys[torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)] == q
    if not (torch.equal(got["cuda"], got["cpu"]) and torch.equal(keyed.cpu(), got["cpu"])):
        raise RuntimeError("CSR phase: the card's membership search differs from the CPU's")
    log(f"[sampler] CSR membership on the card equals the CPU on {n} lanes "
        f"({float(got['cpu'].float().mean()):.3f} rated)")


TIMED_IDS_BLOCK = 1024  # the eval plan's users a block in timed_ids


def timed_ids(data, model):
    """Top-20 ids of the model's embeddings, and the ms of that ranking."""
    import torch

    from selfrec_tpu_torch.ops import ranking

    torch.cuda.synchronize()
    t0 = time.time()
    ids = ranking.topk_ids_from_embeddings(data, model.user_emb, model.item_emb, 20,
                                           block_size=TIMED_IDS_BLOCK)
    torch.cuda.synchronize()
    return ids, 1e3 * (time.time() - t0)


def rescored(ue, ie, uids, ids):
    """float64 scores of each row's ``ids`` (rows of ``uids``), on the CPU."""
    import torch

    ids = torch.as_tensor(ids).long().cpu()
    return (ue.double().cpu()[uids][:, None, :] * ie.double().cpu()[ids]).sum(-1)


def scatter_eval_gate(tag, model):
    """The scatter-mask ranking's ids EQUAL the resident mask's block scan
    (``ranking._topk_all_blocks_dense``: the same GEMM and ``torch.topk``
    over the same blocks) on the same embeddings; the dense-mask eval's
    ids (the ranking kernels', whose f32 sums run in another order and
    whose ties go to the lowest id) score like them position by position
    in float64 rescoring, rtol 1e-5. The two evals timed (the second of two
    runs)."""
    import numpy as np
    import torch

    from selfrec_tpu_torch.ops import ranking

    with knobs(SELFREC_TPU_EVAL_MASK="scatter"):
        timed_ids(model.data, model)
        scatter, scatter_ms = timed_ids(model.data, model)
    with knobs(SELFREC_TPU_EVAL_MASK="dense"):
        timed_ids(model.data, model)
        dense, dense_ms = timed_ids(model.data, model)
        ue, ie = model.user_emb.float().contiguous(), model.item_emb.float().contiguous()
        plan = ranking.get_eval_plan(model.data, TIMED_IDS_BLOCK, ue.device)
        rated = ranking.get_rated_dense(model.data, ue.device)
        blocks = ranking._topk_all_blocks_dense(ue, ie, plan.uids_all, rated, 20)[1]
        blocks = blocks.reshape(-1, 20)[:len(plan.user_ids)].cpu().numpy()
    if not np.array_equal(scatter, blocks):
        raise RuntimeError(f"{tag}: the scatter-mask ids differ from the dense-mask block "
                           f"scan's in {int((scatter != blocks).sum())} places")
    uids = torch.as_tensor(model.data.test_user_ids).long()
    if not torch.allclose(rescored(ue, ie, uids, dense), rescored(ue, ie, uids, blocks),
                          rtol=1e-5, atol=1e-6):
        raise RuntimeError(f"{tag}: the ranking kernels' ids score differently from the "
                           f"block scans' ({int((dense != blocks).sum())} ids differ)")
    log(f"[eval {tag}] scatter-mask ids equal the dense-mask block scan's ({scatter.shape[0]} "
        f"users); the ranking kernels' score like them ({100 * float(np.mean(dense != blocks)):.3f}"
        f"% of ids differ); ranking alone: scatter {scatter_ms:.1f} ms, dense (kernels) "
        f"{dense_ms:.1f} ms")


KNN_CONF = {"topK": 50, "shrinkage": 100}


def knn_rec_check(tag, rec, data, k=20):
    if len(rec) != len(data.test_user_ids) or any(len(v) != k for v in rec.values()):
        raise RuntimeError(f"{tag}: rec list of the wrong shape")
    if not all(math.isfinite(s) for v in rec.values() for _, s in v):
        raise RuntimeError(f"{tag}: rec list scores not finite")


def knn_reference_phase():
    """Small graph (600 x 900): UserKNN and ItemKNN on the card against the
    CPU. Sims and ids exactly (the dense build's int8 product and its
    shrunk cosine rounded once are exact on both), the card's blocked
    fallback build equal to its dense build, and the rec lists: each
    position's score within rtol 1e-5 / atol 1e-7 of the CPU's, and where
    the ids differ the CPU scores both ids alike (the scores' edge-list sums
    add in another order on the card, so near-ties may swap)."""
    import numpy as np
    import torch

    from selfrec_tpu_torch.models.graph.itemknn import ItemKNN
    from selfrec_tpu_torch.models.graph.userknn import UserKNN
    from selfrec_tpu_torch.ops import ranking
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    train, test = synth_graph_mapped(600, 900, 12000, seed=5)
    for cls in (UserKNN, ItemKNN):
        name = cls.__name__
        conf = graph_conf(name, {}, **KNN_CONF)
        models = {dev: cls(conf, train, test, device=dev) for dev in ("cpu", "cuda")}
        out = {}
        for dev, m in models.items():
            m.train()
            out[dev] = knn_neighbours(m)
        with knobs(SELFREC_TPU_DENSE_BUDGET_GB="1e-9"):
            models["cuda"].train()  # the blocked edge-list build
            out["blocked"] = knn_neighbours(models["cuda"])
        for what, got in (("neighbours", out["cuda"]), ("blocked build", out["blocked"])):
            for a, b in zip(got, out["cpu"]):
                if not torch.equal(a, b):
                    raise RuntimeError(f"{name} reference phase: the card's {what} differ "
                                       f"from the CPU's dense build")
        recs = {dev: m.test() for dev, m in models.items()}
        plan = ranking.get_eval_plan(models["cpu"].data, 512, "cpu")
        cpu_scores = torch.cat([models["cpu"]._score_block(u)[:v] for u, _, _, v
                                in plan.blocks])
        item_id = models["cpu"].data.item
        n_off = 0
        for row, user in enumerate(models["cpu"].data.test_user_ids):
            uname = models["cpu"].data.id2user[user]
            got, want = recs["cuda"][uname], recs["cpu"][uname]
            gs, ws = np.array([x[1] for x in got]), np.array([x[1] for x in want])
            if not np.allclose(gs, ws, rtol=1e-5, atol=1e-7):
                raise RuntimeError(f"{name} reference phase: user {uname}'s scores differ")
            for (gi, _), (wi, _) in zip(got, want):
                if gi != wi:
                    n_off += 1
                    a, b = (float(cpu_scores[row, item_id[x]]) for x in (gi, wi))
                    if not np.isclose(a, b, rtol=1e-5, atol=1e-7):
                        raise RuntimeError(f"{name} reference phase: user {uname} ranks "
                                           f"{gi} for {wi}, CPU scores {a} vs {b}")
        log(f"[reference] {name} small graph: sims and ids on the card equal the CPU's, the "
            f"blocked build equals the dense build; rec lists of {len(recs['cpu'])} users "
            f"score alike ({n_off} ids differ, all within score ties)")


def knn_neighbours(model):
    """A trained KNN model's neighbours on the CPU: UserKNN's (sims, ids),
    ItemKNN's kept similarity edges (src, dst, w)."""
    if hasattr(model, "neighbor_sims"):
        return model.neighbor_sims.cpu(), model.neighbor_ids.cpu()
    return tuple(t.cpu() for t in (model._sim_adj.src, model._sim_adj.dst, model._sim_adj.w))


def knn_path(tag, model, counters):
    """KNN on the yelp graph: the similarity build (train()) twice and the
    eval (test(): the rec list through the scatter-mask plan), with the
    kernels' counts set to 0 just before and read just after: no K1 or K2
    launch. Returns the launches."""
    import torch

    for c in counters:
        c.launches = 0
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        model.train()
        torch.cuda.synchronize()
        times.append(1e3 * (time.time() - t0))
    t0 = time.time()
    rec = model.test()
    eval_ms = 1e3 * (time.time() - t0)
    launches = sum(c.launches for c in counters)
    if launches:
        raise RuntimeError(f"{tag}: {launches} kernel launches, expected none")
    knn_rec_check(tag, rec, model.data)
    saturated = sum(s == 1.0 for v in rec.values() for _, s in v) / (20 * len(rec))
    log(f"[knn {tag}] build {times[0]:.1f} ms, again {times[1]:.1f} ms; eval (rec list of "
        f"{len(rec)} users) {eval_ms:.1f} ms, {100 * saturated:.1f}% of listed scores at 1.0; "
        f"launches {launches}")
    profile_window(f"build {tag}", model.train, 1)
    profile_window(f"eval {tag}", model.test, 1)
    return launches


def yelp_model(cls, name, extra, data, dense):
    import torch

    set_layout(dense)
    t0 = time.time()
    model = cls(graph_conf(name, extra), *data, device="cuda")
    model.build()
    torch.cuda.synchronize()
    log(f"[setup] {name}: {getattr(model, 'adj', 'no adjacency')!r}, {model.data.n_edges} edges, "
        f"{len(model.data.test_user_ids)} test users, {time.time() - t0:.1f} s")
    return model


SOCIAL_SEED = 1237           # bench.py:118-130, 381-423
MHCN_CONF = {"n_layer": 2, "ss_rate": 0.01}                                    # bench.py:353-378
SEPT_CONF = {"n_layer": 2, "ss_rate": 0.005, "drop_rate": 0.3, "ins_cnt": 10}  # bench.py:426-464


def douban_data(div=1):
    """bench.py's social data: douban-book marginals (13,024 users, 22,347
    items, 792,062 interactions, 169,150 trust relations), divided by
    ``div`` (4: bench.py's quarter douban). Returns (train, test, social)."""
    from selfrec_tpu_torch.utils import synth

    train, test = synth.synth_graph_triples(
        synth.DOUBAN_USERS // div, synth.DOUBAN_ITEMS // div,
        synth.DOUBAN_INTERACTIONS // div, seed=SOCIAL_SEED)
    social = synth.synth_social_triples(n_users=synth.DOUBAN_USERS // div,
                                        n_relations=synth.DOUBAN_RELATIONS // div)
    return train, test, social


def social_model(cls, name, extra, data, **top):
    """A social model on the card built from ``data`` (train, test, social),
    with the layout knobs as the caller set them."""
    import torch

    train, test, social = data
    t0 = time.time()
    model = cls(graph_conf(name, extra, **{"social.data": "<synthetic>", **top}), train, test,
                device="cuda", **{"social.data": social})
    model.build()
    torch.cuda.synchronize()
    adjs = getattr(model, "H", None) or [model.adj, model._social_d1 or model._social_template]
    log(f"[setup] {name}: {adjs!r}, U={model.data.user_num} I={model.data.item_num}, "
        f"{model.data.n_edges} edges, {model.social_data.size()[1]} relations, "
        f"{time.time() - t0:.1f} s")
    return model


def mhcn_rows_scipy(social_mat, interaction_mat, rows):
    """Rows ``rows`` of the scipy route's [H_s, H_j, H_p]
    (motifs.mhcn_hypergraphs) by the same sparse algebra restricted to
    them: row r of (X·Y)⊙Z is (X[r]·Y)⊙Z[r], and row r of its transpose is
    column r, (X·Y[:, r])⊙Z[:, r]. The full route takes about 30 s of host
    time at douban scale; 512 rows take about 1 s."""
    from selfrec_tpu_torch.data import motifs

    S = social_mat.tocsr()
    Y = interaction_mat.tocsr()
    B = S.multiply(S.T).tocsr()
    U = (S - B).tocsr()
    mats = {"B": B, "U": U, "Ut": U.T.tocsr()}
    cols = {k: v.tocsc() for k, v in mats.items()}

    def term(x, y, z):
        return ((mats[x][rows].dot(mats[y])).multiply(mats[z][rows]),
                (mats[x].dot(cols[y][:, rows])).multiply(cols[z][:, rows]).T)

    def with_transpose(*terms):  # C + C.T
        parts = [term(*t) for t in terms]
        return sum(p[0] for p in parts) + sum(p[1] for p in parts)

    def alone(*terms):
        return sum(term(*t)[0] for t in terms)

    a = [with_transpose(("U", "U", "Ut")),
         with_transpose(("B", "U", "Ut"), ("U", "B", "Ut"), ("U", "U", "B")),
         with_transpose(("B", "B", "U"), ("B", "U", "B"), ("U", "B", "B")),
         alone(("B", "B", "B")),
         with_transpose(("U", "U", "U"), ("U", "Ut", "U"), ("Ut", "U", "U")),
         alone(("U", "B", "U"), ("B", "Ut", "Ut"), ("Ut", "U", "B")),
         alone(("Ut", "B", "Ut"), ("B", "U", "U"), ("U", "Ut", "B"))]
    yyt = Y[rows].dot(Y.T)
    a8 = yyt.multiply(B[rows])
    a9 = yyt.multiply(U[rows]) + yyt.multiply(mats["Ut"][rows])  # (YYᵀ⊙U)ᵀ = YYᵀ⊙Uᵀ
    a10 = yyt - a8 - a9
    return [motifs._row_normalize(sum(a)), motifs._row_normalize(a8 + a9),
            motifs._row_normalize(a10.multiply(a10 > 3))]


def motif_phase(model, n_rows=512):
    """The device motif build on the card (timed twice: the first pays
    cuBLAS's set-up) against the scipy route on ``n_rows`` random rows:
    equal element for element (integer motif counts are exact in f32)."""
    import numpy as np
    import torch

    from selfrec_tpu_torch.data import motifs

    social = model.social_data.get_social_mat()
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        h = motifs.mhcn_hypergraphs_device(social, model.data.interaction_mat, "cuda")
        torch.cuda.synchronize()
        times.append(1e3 * (time.time() - t0))
    rows = np.sort(np.random.default_rng(0).choice(model.data.user_num, n_rows, replace=False))
    t0 = time.time()
    want = mhcn_rows_scipy(social, model.data.interaction_mat, rows)
    host_ms = 1e3 * (time.time() - t0)
    nnz = []
    for name, got, w in zip(("H_s", "H_j", "H_p"), h, want):
        g = got[torch.as_tensor(rows, device="cuda")].cpu().numpy()
        if not np.array_equal(g, w.toarray()):
            raise RuntimeError(f"MHCN motifs: {name} on the card differs from the scipy route in "
                               f"{int((g != w.toarray()).sum())} of {g.size} values")
        nnz.append(int((got != 0).sum()))
    del h
    torch.cuda.empty_cache()
    u = model.data.user_num
    ops = 2.0 * (8 * u ** 3 + u * u * model.data.item_num)
    log(f"[motifs MHCN] device build U={u}: {times[0]:.1f} ms, again {times[1]:.1f} ms "
        f"(8 U×U×U and one U×I×U f32 products, {ops / 1e12:.1f} TFLOP: "
        f"{ops / times[1] / 1e9:.1f} TFLOP/s); {n_rows} rows equal the scipy route "
        f"exactly (scipy on those rows {host_ms:.0f} ms); nonzeros H_s {nnz[0]}, "
        f"H_j {nnz[1]}, H_p {nnz[2]}")
    return times


def densemat_gemm_ms(model, step_ms):
    """DenseMat's product alone at MHCN's shapes, forward and forward plus
    backward: one call between CUDA events (median; host time included)
    and its device time under torch.profiler (every kernel of the call: the
    cast, the cotangent's split and the GEMMs). Weighed by the calls of one
    step (per layer three H products, Rᵀ and R, plus three H products in
    the self-supervision, each forward and backward) against ``step_ms``.
    The design: cuBLAS with f32 output (``torch.mm(..., out_dtype=
    float32)``), reduced-precision reductions off; the backward's f32
    cotangent as three bf16 pieces, one GEMM of width 3D; the block at a
    16-byte row pitch."""
    import torch

    from selfrec_tpu_torch.ops.spmm_dense import dense_mat_spmm

    d = model.emb_size
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    for tag, adj, calls in (("H", model.H[0], 3 * model.n_layers + 3),
                            ("R", model.R, model.n_layers), ("Rt", model.Rt, model.n_layers)):
        x = torch.randn((adj.shape[1], d), generator=gen, device="cuda", requires_grad=True)
        g = torch.randn((adj.shape[0], d), generator=gen, device="cuda")

        def fwd():
            return dense_mat_spmm(adj, x.detach())

        def both():
            dense_mat_spmm(adj, x).backward(g)

        m, k = adj.shape
        rows[tag] = {"shape": [m, k, d], "calls_per_step": calls,
                     "fwd_ms": cuda_ms(fwd, reps=10), "fwd_bwd_ms": cuda_ms(both, reps=10),
                     "fwd_device_ms": kernel_only_ms(fwd, ""),
                     "fwd_bwd_device_ms": kernel_only_ms(both, ""),
                     "fwd_bound_ms": bound_ms(2 * m * k + 4 * k * d + 4 * m * d,
                                              2.0 * m * k * d, PEAK["bfloat16"])[0]}
    per_step = sum(r["calls_per_step"] * (r["fwd_bwd_device_ms"] or float("nan"))
                   for r in rows.values())
    log(f"[densemat MHCN] {model.H[0]!r}: cuBLAS bf16 GEMM with f32 output "
        f"(torch.mm out_dtype), backward one GEMM of width 3D over the cotangent's bf16 "
        f"pieces, rows at a 16-byte pitch; " + "; ".join(
            f"{t} {r['shape']} x{r['calls_per_step']}: fwd {r['fwd_ms']:.4f} ms (device "
            f"{r['fwd_device_ms']}, bound {r['fwd_bound_ms']:.4f}), fwd+bwd "
            f"{r['fwd_bwd_ms']:.4f} (device {r['fwd_bwd_device_ms']})"
            for t, r in rows.items())
        + f"; device {per_step:.3f} ms a step, {100 * per_step / step_ms:.1f}% of "
        f"{step_ms:.2f} ms/step")
    return per_step


def social_pair(cls, conf, data):
    """The same social model on the CPU and on the card, on a small graph,
    with the CPU's weights on both."""
    train, test, social = data
    models = {dev: cls(conf, train, test, device=dev, **{"social.data": social})
              for dev in ("cpu", "cuda")}
    for m in models.values():
        m.build()
    models["cuda"].set_params(models["cpu"].params)
    return models


def social_reference_phase():
    """Small graph (600 × 900, 3,000 relations): MHCN on DenseMat in f32 and
    in bf16 with the CPU's permutations fed to both, and SEPT's joint phase
    on the dense arm (f32 and int8x8) and on the ELL arm with the same keep
    mask, on the card against the CPU: embeddings, one batch loss and its
    grads, within the CPU tests' tolerances (tests/test_torch_mhcn.py,
    test_torch_sept.py): f32 embeddings rtol 1e-5 / atol 1e-6, loss rtol
    1e-5, grads rtol 1e-4 / atol 1e-6; bf16 within 2^-8 of each tensor's
    largest magnitude, loss rtol 1e-4. The int8x8 case compares the
    embeddings and the loss as the other int8 reference phases do
    (``check_int8_alike``): its backward quantizes the cotangent, so a
    last-bit difference upstream may move a gradient by one quantum."""
    import torch

    from selfrec_tpu_torch.models.graph.mhcn import MHCN
    from selfrec_tpu_torch.models.graph.sept import SEPT
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped, synth_social_triples

    data = (*synth_graph_mapped(600, 900, 12000, seed=5),
            synth_social_triples(n_users=600, n_relations=3000, seed=5))
    cases = (("MHCN DenseMat f32", MHCN, MHCN_CONF, {"SELFREC_TPU_DENSE": "1",
                                                     "SELFREC_TPU_DENSE_DTYPE": "float32"}),
             ("MHCN DenseMat bf16", MHCN, MHCN_CONF, {"SELFREC_TPU_DENSE": "1",
                                                      "SELFREC_TPU_DENSE_DTYPE": None}),
             ("SEPT dense f32", SEPT, SEPT_CONF, {"SELFREC_TPU_DENSE": "1",
                                                  "SELFREC_TPU_DENSE_DTYPE": "float32"}),
             ("SEPT dense int8x8", SEPT, SEPT_CONF, {"SELFREC_TPU_DENSE": "1",
                                                     "SELFREC_TPU_DENSE_DTYPE": "int8"}),
             ("SEPT ELL", SEPT, SEPT_CONF, {"SELFREC_TPU_DENSE": "0"}))
    for tag, cls, extra, env in cases:
        int8 = tag.endswith("int8x8")
        with knobs(**env):
            conf = graph_conf(cls.__name__, extra, **{"batch.size": 256, "max.epoch": 9,
                                                      "social.data": "<synthetic>"})
            models = social_pair(cls, conf, data)
            batch = small_batch(models["cpu"].data, torch.Generator().manual_seed(11))
            kw = {}
            if cls is MHCN:
                perms = models["cpu"].ss_permutations(torch.Generator().manual_seed(12))
            out = {}
            for dev, m in models.items():
                if cls is MHCN:
                    kw = {"perms": [tuple(p.to(dev) for p in c) for c in perms]}
                else:
                    m.enter_phase(4)
                    m.aux = m.epoch_setup(4)
                with torch.no_grad():
                    ue, ie = m.embeddings()
                params = {k: v.detach().clone().requires_grad_(not int8)
                          for k, v in m.params.items()}
                with torch.set_grad_enabled(not int8):
                    loss = m.batch_loss(params, dict({k: v.to(dev) for k, v in batch.items()},
                                                     aux=m.aux), **kw)
                if not int8:
                    loss.backward()
                out[dev] = {"user_emb": ue.cpu(), "item_emb": ie.cpu(),
                            "loss": loss.detach().cpu(),
                            **({} if int8 else {f"grad {k}": v.grad.cpu()
                                                for k, v in params.items()})}
        if int8:
            check_int8_alike(f"{tag} reference phase", {
                dev: (o["user_emb"], o["item_emb"], o["loss"]) for dev, o in out.items()})
        for what, a in () if int8 else out["cuda"].items():
            b = out["cpu"][what]
            if tag.endswith("bf16"):
                rtol, atol = (1e-4, 0.0) if what == "loss" else (0.0, 2 ** -8 * float(
                    b.abs().max()))
            else:
                rtol, atol = {"user_emb": (1e-5, 1e-6), "item_emb": (1e-5, 1e-6),
                              "loss": (1e-5, 0.0)}.get(what, (1e-4, 1e-6))
            check_close(f"{tag} reference phase", what, a, b, rtol, atol)
        worst = max(float((out["cuda"][k] - out["cpu"][k]).abs().max()) for k in out["cpu"])
        log(f"[reference] {tag} small graph U={models['cpu'].data.user_num}: card agrees with "
            f"the CPU (largest difference {worst:.3g}), loss {float(out['cuda']['loss']):.6f} "
            f"vs {float(out['cpu']['loss']):.6f}")


def mhcn_k2_rows(model):
    """K2's rows on every layout of MHCN's ELL arm (quarter douban), D 64:
    each channel H_s, H_j, H_p forward and backward (the backward gathers
    over the transpose: the channels are row-normalized, not symmetric;
    H_p's rows are all long, about 1,150 slots each), R (U rows gathering
    items) and its backward layout (I rows gathering users)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(13)
    nu, ni = model.data.user_num, model.data.item_num
    rows = []
    for name, adj in (("H_s", model.H[0]), ("H_j", model.H[1]), ("H_p", model.H[2])):
        for way, layout, w in (("", adj.fwd, adj.w_fwd), (" bwd", adj.bwd, adj.w_bwd)):
            rows.append(k2_case(f"MHCN {name}{way}", layout, w[None],
                                torch.randn((nu, 64), generator=gen, device="cuda")))
    r = model.R
    return rows + [k2_case("MHCN R", r.fwd, r.w_fwd[None],
                           torch.randn((ni, 64), generator=gen, device="cuda")),
                   k2_case("MHCN R bwd", r.bwd, r.w_bwd[None],
                           torch.randn((nu, 64), generator=gen, device="cuda"))]


def sept_k2_rows(model):
    """K2's rows on SEPT's ELL layouts at P = 2, D 64 a pass: the social
    union template (a zero weight where a view lacks a union edge) and the
    bipartite template with the rec and the epoch's dropped weights."""
    import torch

    from selfrec_tpu_torch.ops.spmm_ell import ell_weights

    gen = torch.Generator(device="cuda").manual_seed(14)
    nu, ni = model.data.user_num, model.data.item_num
    union = model._social_template.fwd
    bip = model._view_template.fwd
    aug_w = model.epoch_setup(4)["aug_w"]
    return [k2_case("SEPT union P2", union, ell_weights(union, model._social_w_stack),
                    torch.randn((nu, 128), generator=gen, device="cuda")),
            k2_case("SEPT bipartite P2", bip,
                    ell_weights(bip, torch.stack([model._w_rec, aug_w])),
                    torch.randn((nu + ni, 128), generator=gen, device="cuda"))]


def social_phases(k1_paths, k1_rows, k1_float, k2_paths, k2_rows):
    """MHCN and SEPT (bench.py:353-464) on douban-book-scale synthetic data:
    MHCN on DenseMat (auto) and on ELL (quarter douban), SEPT's dense int8x8
    arm (warm and joint) and ELL arm (joint), then the small-graph reference
    phase. Adds each path's launches to ``k1_paths`` / ``k2_paths``, K1
    int8's rows on SEPT's douban block and its dropped view to ``k1_rows``
    and K2's rows on the social layouts to ``k2_rows``."""
    import torch

    from selfrec_tpu_torch.models.graph.mhcn import MHCN
    from selfrec_tpu_torch.models.graph.sept import SEPT
    from selfrec_tpu_torch.ops import dense_dual, ell_gather
    from selfrec_tpu_torch.ops.spmm_dense import DenseAdj, DenseMat

    t0 = time.time()
    douban = douban_data()
    log(f"[setup] douban-scale social data in {time.time() - t0:.1f} s")
    social_kernels = (dense_dual.dual_matmul, k1_float, ell_gather.ell_gather_sum)
    # MHCN under auto: the three U x U channels, R and R^T as DenseMat, the
    # motifs built on the card; no kernel of the port runs
    with knobs(SELFREC_TPU_DENSE="auto"):
        model = social_model(MHCN, "MHCN", MHCN_CONF, douban)
    if not all(isinstance(a, DenseMat) for a in model.H + [model.R, model.Rt]):
        raise RuntimeError("MHCN under auto: not every adjacency is a DenseMat")
    motif_phase(model)
    k1_paths["mhcn_dense_train"], step_ms = train_path(
        "MHCN DenseMat", model, social_kernels, 20, per_step=0,
        profile_steps=N_PROFILE_STEPS)
    densemat_gemm_ms(model, step_ms)
    k1_paths["mhcn_dense_eval"] = eval_path("MHCN DenseMat", model, social_kernels, expect=0)
    free(model)
    del model
    torch.cuda.empty_cache()

    # MHCN's ELL arm at quarter douban (bench.py:353-378): each product of a
    # step one K2 launch forward and one backward: per layer three channels,
    # R^T and R, plus three channels in the self-supervision
    with knobs(SELFREC_TPU_DENSE="0"):
        model = social_model(MHCN, "MHCN", MHCN_CONF, douban_data(4))
    k2_rows.extend(mhcn_k2_rows(model))
    k2_paths["mhcn_ell_train"], _ = train_path(
        "MHCN ELL quarter douban", model, ell_gather.ell_gather_sum, N_SHORT_BATCHES,
        per_step=2 * (5 * model.n_layers + 3))
    k2_paths["mhcn_ell_eval"] = eval_path("MHCN ELL quarter douban", model,
                                          ell_gather.ell_gather_sum, expect=5 * model.n_layers)
    free(model)
    del model
    torch.cuda.empty_cache()

    # SEPT's dense int8x8 arm: the rec chain (and in the joint phase the
    # epoch's dropped view) on K1 int8, each hop forward and backward; the
    # social views as DenseMat
    with knobs(SELFREC_TPU_DENSE="1"):
        model = social_model(SEPT, "SEPT", SEPT_CONF, douban, **{"max.epoch": 9})
    if not (isinstance(model.adj, DenseAdj) and model.adj.mm_dtype == torch.int8
            and isinstance(model._social_d1, DenseMat)):
        raise RuntimeError(f"SEPT dense: {model.adj!r}, {model._social_d1!r}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    k1_rows.append(k1_case("douban SEPT", model.adj.a_ui, model.adj.a_iu, 64, gen))
    model.enter_phase(0)
    k1_paths["sept_warm_train"], _ = train_path(
        "SEPT int8x8 warm", model, dense_dual.dual_matmul, N_SHORT_BATCHES,
        per_step=2 * model.n_layers)
    model.enter_phase(4)  # max.epoch 9: joint from epoch 4, a fresh Adam
    if not model._joint_phase:
        raise RuntimeError("SEPT: enter_phase(4) left the warm phase on")
    k1_paths["sept_joint_train"], _ = train_path(
        "SEPT int8x8 joint", model, dense_dual.dual_matmul, 20, per_step=4 * model.n_layers,
        profile_steps=N_PROFILE_STEPS)
    view = model._aug_view  # epoch_setup's refactored dropped view
    k1_rows.append(k1_case("douban SEPT dropped view", view.a_ui, view.a_iu, 64, gen))
    del view
    k1_paths["sept_eval"] = eval_path("SEPT int8x8", model, dense_dual.dual_matmul)
    free(model)
    del model
    torch.cuda.empty_cache()

    # SEPT's ELL arm, joint phase: rec + dropped view and social + sharing
    # view as two packed chains at P = 2, each hop one K2 launch forward and
    # one backward
    with knobs(SELFREC_TPU_DENSE="0"):
        model = social_model(SEPT, "SEPT", SEPT_CONF, douban, **{"max.epoch": 9})
    model.enter_phase(4)
    k2_rows.extend(sept_k2_rows(model))
    k2_paths["sept_ell_joint_train"], _ = train_path(
        "SEPT ELL joint", model, ell_gather.ell_gather_sum, N_SHORT_BATCHES,
        per_step=4 * model.n_layers)
    free(model)
    del model, douban
    torch.cuda.empty_cache()
    social_reference_phase()


SEQ_CONF = {  # bench.py:291-293, 336-350
    "SASRec": {"n_blocks": 2, "drop_rate": 0.2, "n_heads": 1},
    "CL4SRec": {"n_blocks": 2, "drop_rate": 0.2, "n_heads": 1, "aug_type": 0,
                "aug_rate": 0.5, "cl_rate": 0.05},
    "BERT4Rec": {"n_blocks": 2, "drop_rate": 0.2, "n_heads": 1, "mask_rate": 0.5},
}
SEQ_RTOL, SEQ_ATOL = 1e-5, 1e-5            # the encoder's and the loss's (f32, TF32 off)
SEQ_GRAD_RTOL, SEQ_GRAD_ATOL = 1e-4, 1e-6  # the grads' (tests/test_torch_sasrec.py)


def seq_conf(name, extra, **top):
    """bench.py's sequential configuration (bench.py:283-350): D 64, batch
    256, max.len 50, lr 0.001, reg 1e-4, top-N 10 and 20."""
    from selfrec_tpu_torch.config import ModelConf

    conf = {
        "training.set": "<synthetic>", "test.set": "<synthetic>",
        "model": {"name": name, "type": "sequential"}, "item.ranking.topN": [10, 20],
        "embedding.size": 64, "max.epoch": 1, "batch.size": 256, "learning.rate": 0.001,
        "reg.lambda": 0.0001, "max.len": 50, name: extra,
        "output": os.path.join("results", "chip_smoke"), "seed": 0,
    }
    conf.update(top)
    return ModelConf(conf)


def seq_draws(model, b, l, gen):
    """The model's draws for one batch, made on the CPU, fed to both
    devices: the views' augmentation draws (CL4SRec) or the masked
    positions' uniforms (BERT4Rec); dropout is off."""
    import torch

    def u(*shape):
        return torch.rand(shape, generator=gen)

    if model.model_name == "CL4SRec":
        one = {0: lambda: u(b), 1: lambda: (u(b), u(b, l)), 2: lambda: u(b, l)}[model.aug_type]
        return {"aug": (one(), one())}
    if model.model_name == "BERT4Rec":
        return {"mask": u(b, l)}
    return None


def to_device(tree, dev):
    """Every tensor of a dict/tuple tree on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_device(v, dev) for v in tree)
    return tree.to(dev) if hasattr(tree, "to") else tree


def check_top_ids(tag, models):
    """The top-20 ids of every sequence on the card equal the CPU's,
    position by position. Where they differ, the two devices' scores at
    that position must agree within rtol 1e-5 / atol 1e-6, which only a
    near-tie (two ids whose f32 scores are that close, ordered by rounding)
    allows; the count of such positions is returned and printed."""
    import torch

    (sc_cpu, id_cpu), (sc_gpu, id_gpu) = (
        tuple(x.cpu() for x in models[dev].top_items()) for dev in ("cpu", "cuda"))
    off = id_cpu != id_gpu
    if not torch.allclose(sc_gpu, sc_cpu, rtol=1e-5, atol=1e-6):
        raise RuntimeError(f"{tag}: the card's top-20 scores differ from the CPU's by up to "
                           f"{float((sc_gpu - sc_cpu).abs().max())}")
    return int(off.sum()), id_cpu.numel()


def seq_reference_phase():
    """Small data (400 sequences over 300 items, max.len 20, D 32, 2
    blocks, drop_rate 0): each sequential model (CL4SRec at each aug_type)
    on the card against the CPU, the CPU's weights and the same batch,
    negatives and draws on both: the encoder's output and the loss within
    rtol/atol 1e-5, the grads within rtol 1e-4 / atol 1e-6 (TF32 off), and
    the top-20 ids of every sequence (check_top_ids)."""
    import torch

    from selfrec_tpu_torch.models import get_model_class
    from selfrec_tpu_torch.ops import seq_sampling
    from selfrec_tpu_torch.utils.synth import synth_sequences

    t0 = time.time()
    train, test = synth_sequences(n_seqs=400, n_items=300, seed=9)
    cases = [("SASRec", {}), ("CL4SRec", {"aug_type": 0}), ("CL4SRec", {"aug_type": 1}),
             ("CL4SRec", {"aug_type": 2}), ("BERT4Rec", {})]
    for name, extra in cases:
        conf = seq_conf(name, {**SEQ_CONF[name], "drop_rate": 0.0, **extra},
                        **{"embedding.size": 32, "max.len": 20, "batch.size": 128})
        models = {dev: get_model_class(name)(conf, train, test, device=dev)
                  for dev in ("cpu", "cuda")}
        for m in models.values():
            m.build()
        models["cuda"].set_params(models["cpu"].params)
        cpu = models["cpu"]
        gen = torch.Generator().manual_seed(3)
        rows = torch.randperm(len(cpu.data.original_seq), generator=gen)[:128]
        batch = {k: torch.as_tensor(a)[rows].long()
                 for k, a in zip(("seq", "pos", "y", "seq_len"), cpu._train_arrays)}
        batch["row_mask"] = (torch.arange(128) < 120).float()
        batch["neg"] = seq_sampling.sample_seq_negatives(gen, batch["seq"], cpu.data.item_num)
        draws = seq_draws(cpu, 128, 20, gen)
        out = {}
        for dev, m in models.items():
            b, d = to_device(batch, dev), to_device(draws, dev)
            params = {k: v.detach().clone().requires_grad_(True) for k, v in m.params.items()}
            with torch.no_grad():
                enc = m._encode(params, b["seq"], b["pos"])
            loss = m.batch_loss(params, b, None, draws=d)
            loss.backward()
            out[dev] = (enc.cpu(), loss.detach().cpu(),
                        {k: v.grad.cpu() for k, v in params.items()})
        tag = f"seq reference {name}{extra.get('aug_type', '')}"
        check_close(tag, "encoder output", out["cuda"][0], out["cpu"][0], SEQ_RTOL, SEQ_ATOL)
        check_close(tag, "loss", out["cuda"][1], out["cpu"][1], SEQ_RTOL, SEQ_ATOL)
        worst = 0.0
        for k, g in out["cpu"][2].items():
            check_close(tag, f"grad of {k}", out["cuda"][2][k], g, SEQ_GRAD_RTOL, SEQ_GRAD_ATOL)
            worst = max(worst, float((out["cuda"][2][k] - g).abs().max()))
        near_ties, n_ids = check_top_ids(tag, models)
        log(f"[{tag}] {len(cpu.data.original_seq)} sequences, {cpu.data.item_num} items: "
            f"encoder max |diff| {float((out['cuda'][0] - out['cpu'][0]).abs().max()):.3g}, "
            f"loss {float(out['cpu'][1]):.6f} vs {float(out['cuda'][1]):.6f}, grads max |diff| "
            f"{worst:.3g}; top-20 ids equal but {near_ties} near-tie positions of {n_ids}")
    log(f"[seq reference] {time.time() - t0:.1f} s")


def seq_resume_phase():
    """Small data: SASRec on the card (D 32, max.len 20, drop_rate 0) for 2
    epochs, and for 1 then resumed to 2 from its checkpoint
    (checkpoint.interval 1); the params, the best params and the best
    epoch agree within the graph resume phase's rtol 2e-3 / atol 2e-4."""
    import contextlib
    import shutil

    import torch

    from selfrec_tpu_torch.models.sequential.sasrec import SASRec
    from selfrec_tpu_torch.utils.synth import synth_sequences

    train, test = synth_sequences(n_seqs=400, n_items=300, seed=9)
    root = os.path.join("results", "chip_smoke", f"seq_resume_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def run(tag, epochs):
        conf = seq_conf("SASRec", {**SEQ_CONF["SASRec"], "drop_rate": 0.0},
                        **{"embedding.size": 32, "max.len": 20, "batch.size": 128,
                           "max.epoch": epochs, "checkpoint.interval": 1,
                           "checkpoint.dir": os.path.join(root, tag)})
        model = SASRec(conf, train, test, device="cuda")
        model.build()
        with open(os.path.join(root, f"{tag}_{epochs}.log"), "w") as f, \
                contextlib.redirect_stdout(f):
            model.train()
        torch.cuda.synchronize()
        return model

    try:
        t0 = time.time()
        full = run("full", 2)
        run("resumed", 1)
        resumed = run("resumed", 2)
        worst = 0.0
        for k in full.params:
            for what, a, b in (("params", resumed.params[k], full.params[k]),
                               ("best params", resumed.best_params[k], full.best_params[k])):
                worst = max(worst, float((a.detach() - b.detach()).abs().max()))
                check_close("seq resume phase", f"{what} {k} after resuming at epoch 1",
                            a.detach(), b.detach(), 2e-3, 2e-4)
        if resumed.best_performance[0] != full.best_performance[0]:
            raise RuntimeError(f"seq resume phase: best epoch {resumed.best_performance[0]} "
                               f"after resuming, {full.best_performance[0]} continuous")
        log(f"[seq resume] SASRec small data: 1 epoch + resume to 2 agrees with 2 epochs (max "
            f"|diff| {worst:.3g}, rtol 2e-3 / atol 2e-4); {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def seq_path(tag, model, counters, profile_steps=N_PROFILE_STEPS, profile_eval=False):
    """One epoch of ``model`` through the trainer's step graph (the warm-up
    steps and the capture apart, the eager twin over the last
    ``TWIN_STEPS`` batches), then one full test() plus ranking_evaluation
    through the eval graph, each with the launch counts of ``counters``
    (name -> kernel wrapper) set to 0 just before and read just after:
    none may launch. Checks finite losses and metrics, that the steps and
    the eval blocks ran as replays, and that the graphed top_items equals
    the eager block loop (ids may differ only at an f32 near-tie, counted);
    ``profile_steps`` more graphed steps, and with ``profile_eval`` one
    more graphed ranking, under the profiler. Returns {name: launches} of
    the train and eval runs."""
    import torch

    from selfrec_tpu_torch.models.base import SequentialRecommender
    from selfrec_tpu_torch.utils import metrics

    idx, row_mask = model.epoch_batches(0)
    m = idx.shape[0] - TWIN_STEPS
    w = GRAPH_WARMUP + 1
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    first = model.train_batches(idx[:w], row_mask[:w])
    torch.cuda.synchronize()
    t1 = time.time()
    rest = model.train_batches(idx[w:m], row_mask[w:m])
    torch.cuda.synchronize()
    t2 = time.time()
    train_launches = {k: c.launches for k, c in counters.items()}
    losses = torch.cat([first, rest]).cpu()
    if not bool(torch.isfinite(losses).all()):
        raise RuntimeError(f"{tag} train: non-finite losses {losses.tolist()}")
    if any(train_launches.values()):
        raise RuntimeError(f"{tag} train: kernel launches {train_launches}, expected none")
    runner = model._graphs.get("train")
    if runner is None or not runner.graphed or runner.replays != m - GRAPH_WARMUP:
        raise RuntimeError(f"{tag} train: the steps did not run as replays of a captured "
                           f"graph ({model.graph_report() or 'no graph'})")
    n_seqs = len(model.data.original_seq)
    log(f"[train {tag}] {m} batches x {model.batch_size} ({n_seqs} sequences): loss "
        f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f}, {t2 - t0:.3f} s, "
        f"{m * model.batch_size / (t2 - t0):.1f} sequences/s (first {w} steps, "
        f"{GRAPH_WARMUP} eager warm-up and the capture, {1e3 * (t1 - t0):.1f} ms; steps "
        f"{w + 1}..{m} replayed: {1e3 * (t2 - t1) / (m - w):.2f} ms/step, "
        f"{(m - w) * model.batch_size / (t2 - t1):.1f} sequences/s), launches "
        f"{train_launches}; graph {model.graph_report()}")
    twin_gate(tag, model, (idx[m:], row_mask[m:]))
    if profile_steps:
        profile_window(f"train {tag} graphed", lambda: model.train_batches(
            idx[:profile_steps], row_mask[:profile_steps]), profile_steps)

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    rec_list = model.test()
    measure = metrics.ranking_evaluation(model.data.test_set, rec_list, [model.max_N])
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.time() - t0)
    eval_launches = {k: c.launches for k, c in counters.items()}
    if any(eval_launches.values()):
        raise RuntimeError(f"{tag} eval: kernel launches {eval_launches}, expected none")
    perf = metrics.parse_measure(measure)
    if len(rec_list) != n_seqs or not all(math.isfinite(v) for v in perf.values()):
        raise RuntimeError(f"{tag} eval: {len(rec_list)} lists for {n_seqs} sequences, {perf}")
    n_blocks = -(-n_seqs // model.batch_size)
    ev = model._graphs.get("eval")
    if ev is None or not ev.graphed or ev.replays != n_blocks - 1:
        raise RuntimeError(f"{tag} eval: the blocks did not run as replays of a captured "
                           f"graph ({model.graph_report()})")
    (sc_g, id_g), (sc_e, id_e) = (tuple(x.cpu() for x in run()) for run in (
        model.top_items, lambda: SequentialRecommender.top_items(model)))
    if not torch.allclose(sc_g, sc_e, rtol=1e-5, atol=1e-6):
        raise RuntimeError(f"{tag} eval: the graphed top-{model.max_N} scores differ from "
                           f"the eager blocks' by up to {float((sc_g - sc_e).abs().max())}")
    rank_ms = cuda_ms(model.top_items, reps=3)
    eager_rank_ms = cuda_ms(lambda: SequentialRecommender.top_items(model), reps=3)
    log(f"[eval {tag}] test() + ranking_evaluation over {n_seqs} sequences: Recall@20 "
        f"{perf['Recall']} NDCG@20 {perf['NDCG']}, {eval_ms:.1f} ms, launches {eval_launches}; "
        f"ranking alone (top_items: {n_blocks} blocks of encoder, scores and "
        f"top-{model.max_N}) graphed {rank_ms:.1f} ms, eager {eager_rank_ms:.1f} ms; graphed "
        f"ids equal the eager blocks' but at {int((id_g != id_e).sum())} of {id_g.numel()} "
        f"positions (f32 near-ties, scores within rtol 1e-5 / atol 1e-6)")
    if profile_eval:
        profile_window(f"eval {tag} ranking graphed", model.top_items, 1)
        profile_window(f"eval {tag}", lambda: metrics.ranking_evaluation(
            model.data.test_set, model.test(), [model.max_N]), 1)
    return train_launches, eval_launches


def lookup_phase(model):
    """The design choice behind the encoder's table lookups, timed on the
    card: SASRec's four lookups of one batch (the item table at the
    window, the targets and the negatives; the position table), forward
    and backward, as advanced indexing (``table[ids]``, whose backward
    walks each row's duplicates in turn) and as ``F.embedding`` (sorted
    segment sums), from one batch of epoch 0; CUDA events, median of 5."""
    import torch
    import torch.nn.functional as F

    from selfrec_tpu_torch.ops import seq_sampling

    idx, _ = model.epoch_batches(0)
    seq, pos, y, _ = (a[idx[0]] for a in model._train_dev)
    gen = torch.Generator(device="cuda").manual_seed(1)
    neg = seq_sampling.sample_seq_negatives(gen, seq, model.data.item_num)
    item = model.params["item_emb"].detach().clone().requires_grad_(True)
    pos_emb = model.params["pos_emb"].detach().clone().requires_grad_(True)
    grad = torch.randn((*seq.shape, item.shape[1]), generator=gen, device="cuda")

    def run(lookup):
        item.grad = pos_emb.grad = None
        out = lookup(item, seq) + lookup(pos_emb, pos) + lookup(item, y) + lookup(item, neg)
        out.backward(grad)

    ms_index = cuda_ms(lambda: run(lambda t, i: t[i]), reps=5)
    ms_embed = cuda_ms(lambda: run(lambda t, i: F.embedding(i, t)), reps=5)
    pads = int((seq == 0).sum())
    log(f"[lookup SASRec] one batch's four lookups forward and backward ({seq.numel()} ids a "
        f"lookup, {pads} pads): advanced indexing {ms_index:.3f} ms, F.embedding "
        f"{ms_embed:.3f} ms")


def sequential_phases(paths):
    """SASRec, CL4SRec and BERT4Rec at bench.py's configurations on
    amazon-beauty-scale synthetic sequences, then the small-data reference
    and resume phases. ``paths`` maps each kernel's name to its wrapper and
    its launches_by_path dict; each path's launches (all 0) are added."""
    import torch

    from selfrec_tpu_torch.models import get_model_class
    from selfrec_tpu_torch.utils.synth import synth_sequences

    t0 = time.time()
    train, test = synth_sequences()
    log(f"[setup] amazon-beauty-scale synthetic sequences ({len(train)} sequences) in "
        f"{time.time() - t0:.1f} s")
    counters = {name: wrapper for name, (wrapper, _) in paths.items()}
    for name in ("SASRec", "CL4SRec", "BERT4Rec"):
        t0 = time.time()
        model = get_model_class(name)(seq_conf(name, SEQ_CONF[name]), train, test,
                                      device="cuda")
        model.build()
        torch.cuda.synchronize()
        log(f"[setup] {name}: {len(model.data.original_seq)} sequences, {model.data.item_num} "
            f"items, vocab {model.vocab_size()}, {time.time() - t0:.1f} s")
        train_l, eval_l = seq_path(name, model, counters, profile_eval=name == "SASRec")
        if name == "SASRec":
            lookup_phase(model)
        for k, (_, by_path) in paths.items():
            by_path[f"{name.lower()}_train"] = train_l[k]
            by_path[f"{name.lower()}_eval"] = eval_l[k]
        free(model)
        del model
        torch.cuda.empty_cache()
    seq_reference_phase()
    seq_resume_phase()


# -- scale-out: the (data, model) mesh over torch.distributed -----------------------

SCALE_OUT_TIMEOUT_S = 480    # one rank process, its setup included
PARALLEL_RTOL, PARALLEL_ATOL = 2e-4, 2e-5  # the JAX package's (tests/test_parallel.py:58-59)
INT8_COL_REL = 0.02          # the JAX package's (tests/test_dense_shard.py:235-236)
# the sharded int8 propagation on the yelp graph against the single-device
# block, in the same column-relative measure: local per-channel scales are
# no coarser than the block's global ones, and both read 0.0229 on 1x2 and
# 2x1 on an H100; the margin allows for the sum order
INT8_SHARDED_MARGIN = 0.05


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_world_one_phase(data, k1_paths, k2_paths):
    """NCCL at world size 1 in this process: its collectives on the card
    (all_reduce, all_gather, reduce_scatter, all_to_all), then a
    ShardedDenseAdj and a HaloAdj over a 1x1 mesh through the layer API on
    the yelp graph, one propagation each against DenseAdj (int8: exactly)
    and EllAdj (within 2e-5). The process group is taken down after."""
    import datetime

    import torch
    import torch.distributed as dist

    from selfrec_tpu_torch.data.interaction import Interaction
    from selfrec_tpu_torch.ops import dense_dual, ell_gather, spmm_dense
    from selfrec_tpu_torch.ops.graph import norm_adj_from_scipy, spmm
    from selfrec_tpu_torch.parallel import dense_shard, halo
    from selfrec_tpu_torch.parallel import mesh as mesh_lib

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda")
        y = x.clone()
        dist.all_reduce(y)
        ag = torch.empty_like(x)
        dist.all_gather_into_tensor(ag, x)
        rs = torch.empty_like(x)
        dist.reduce_scatter_tensor(rs, x)
        a2a = torch.empty_like(x)
        dist.all_to_all_single(a2a, x)
        if not all(torch.equal(t, x) for t in (y, ag, rs, a2a)):
            raise RuntimeError("NCCL at world size 1: a collective changed its input")
        mesh = mesh_lib.build_mesh(1, 1)
        log(f"[scale-out] NCCL at world size 1: {mesh!r}; all_reduce, all_gather, "
            f"reduce_scatter and all_to_all on the card give their input back")
        inter = Interaction(graph_conf("LightGCN", {}), *data)
        mat = inter.norm_adj
        eu, ei, w = spmm_dense.bipartite_blocks(mat.tocoo(), inter.user_num)
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((mat.shape[0], 64), generator=gen, device="cuda")
        single = spmm_dense.dense_adj_from_edges(eu, ei, w, inter.user_num, inter.item_num,
                                                 device="cuda")
        ref = spmm(single, x)
        del single
        sharded = dense_shard.build_sharded_dense(eu, ei, w, inter.user_num, inter.item_num,
                                                  mesh, device="cuda")
        dense_dual.dual_matmul.launches = 0
        out = spmm(sharded, x)
        torch.cuda.synchronize()
        k1_paths["sharded_1x1_nccl"] = dense_dual.dual_matmul.launches
        if not torch.equal(out, ref):
            raise RuntimeError(f"1x1 ShardedDenseAdj: differs from DenseAdj by "
                               f"{float((out - ref).abs().max())}")
        log(f"[scale-out] 1x1 mesh, yelp graph: {sharded!r} equals DenseAdj int8 exactly "
            f"({k1_paths['sharded_1x1_nccl']} K1 launch)")
        del sharded, ref, out
        torch.cuda.empty_cache()
        ell = norm_adj_from_scipy(mat, device="cuda")
        ref = spmm(ell, x)
        hadj = halo.halo_from_ell(ell, mesh)
        ell_gather.ell_gather_sum.launches = 0
        out = spmm(hadj, x)
        torch.cuda.synchronize()
        k2_paths["halo_1x1_nccl"] = ell_gather.ell_gather_sum.launches
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=K2_RTOL, atol=K2_ATOL):
            raise RuntimeError(f"1x1 HaloAdj: differs from EllAdj by {err}")
        log(f"[scale-out] 1x1 mesh, yelp graph: {hadj!r} equals EllAdj within {K2_RTOL} "
            f"(max |err| {err:.3g}; {k2_paths['halo_1x1_nccl']} K2 launch)")
    finally:
        dist.destroy_process_group()
        mesh_lib._GROUPS.clear()


def nccl_two_ranks_one_card():
    """Two NCCL ranks on the one card: NCCL refuses a second rank on a
    device it already holds. Records what it says; not a gate."""
    code = (
        "import datetime, os, torch, torch.distributed as dist\n"
        "torch.cuda.set_device(0)\n"
        "dist.init_process_group('nccl', init_method=f\"tcp://127.0.0.1:{os.environ['PORT']}\","
        " rank=int(os.environ['RANK']), world_size=2,"
        " timeout=datetime.timedelta(seconds=30))\n"
        "t = torch.ones(4, device='cuda')\n"
        "dist.all_reduce(t)\n"
        "torch.cuda.synchronize()\n"
        "print('all_reduce gave', t.tolist(), flush=True)\n")
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code], env=dict(os.environ, PORT=port,
                                                                      RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=90)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0] + "\n(timed out after 90 s)")
    said = [line for out in outs for line in out.splitlines()
            if "Duplicate GPU" in line or "all_reduce gave" in line or "Error" in line]
    log(f"[scale-out] two NCCL ranks on one card: return codes "
        f"{[p.returncode for p in procs]}; " + (" | ".join(said[:4])[:600] or
                                                 outs[0][-400:].replace("\n", " | ")))


def replica_gate(tag, model):
    """The data replicas of every shard bit-equal, and the full params
    (gathered over model) equal on every rank."""
    import torch

    from selfrec_tpu_torch.parallel import mesh as mesh_lib

    mesh = model.mesh
    shards = torch.cat([v.detach().reshape(-1) for v in model.params.values()])
    full = torch.cat([v.reshape(-1) for v in model.gather_leaves(
        {k: v.detach() for k, v in model.params.items()}).values()])
    for what, t, axis in (("shards", shards, mesh_lib.DATA_AXIS), ("full params", full,
                                                                  mesh_lib.GRID)):
        got = mesh_lib.all_gather(t[None], mesh, axis)
        if not all(torch.equal(got[0], g) for g in got[1:]):
            raise RuntimeError(f"{tag}: the {what} differ between the ranks of {axis}")
    if not bool(torch.isfinite(full).all()):
        raise RuntimeError(f"{tag}: non-finite params")
    log(f"[scale-out {tag}] replicas bit-equal over data, full params equal on every rank "
        f"({full.numel()} values)")


def comm_per_step(model, adj, width, per_step):
    """Bytes a rank receives in one step: ``per_step`` propagations over
    ``adj`` at ``width`` by the layout's own count, plus the params' gathers
    over model and the gradient sums over the replicas (ring algorithms)."""
    from selfrec_tpu_torch.parallel import mesh as mesh_lib

    mesh = model.mesh
    nd, nm = mesh.shape[mesh_lib.DATA_AXIS], mesh.shape[mesh_lib.MODEL_AXIS]
    adj_b = adj.comm_bytes(width)
    if "fwd" in adj_b:  # a halo layout: forward and transpose plans
        prop = sum(adj_b["fwd"].values()) + sum(adj_b["bwd"].values())
        prop = prop * per_step // 2
    else:
        prop = sum(adj_b.values()) * per_step
    sharded = sum(v.numel() * 4 for k, v in model.params.items() if k in model._sharded)
    rest = sum(v.numel() * 4 for k, v in model.params.items() if k not in model._sharded)
    params = sharded * (nm - 1)            # gathered before the loss
    grads = 2 * sharded * (nd - 1) // nd + 2 * rest * (nd * nm - 1) // (nd * nm)
    return {"propagations": prop, "param_gathers": params, "grad_sums": grads}


def k1_slice_rows(tag, model, gen, rank, time_it):
    """K1 int8 on this rank's (U_pad, i_blk) slice and its kept transpose at
    the path's widths, exactly against its plain version; on rank 0 with
    ``time_it`` timed against its bound while rank 1 waits."""
    import torch
    import torch.distributed as dist

    from selfrec_tpu_torch.ops import dense_dual

    adj = model.adj
    for d in (192, 64):
        xu = torch.randint(-127, 128, (adj.u_pad, d), generator=gen, device="cuda",
                           dtype=torch.int8)
        xi = torch.randint(-127, 128, (adj.i_blk, d), generator=gen, device="cuda",
                           dtype=torch.int8)
        ou, oi = dense_dual.dual_matmul(adj.b, xu, xi, adj.bt)
        pu, pi = dense_dual.dual_matmul_plain(adj.b, xu, xi)
        if not (torch.equal(ou, pu) and torch.equal(oi, pi)):
            raise RuntimeError(f"{tag} rank {rank}: K1 on its slice differs from the plain "
                               f"version at D={d}")
        del ou, oi, pu, pi
    log(f"[scale-out {tag}] rank {rank}: K1 int8 on its slice {tuple(adj.b.shape)} exact "
        f"at D 192 and 64")
    torch.cuda.empty_cache()
    dist.barrier()
    row = None
    if time_it and rank == 0:
        row = k1_case(f"rank slice {tag}", adj.b, adj.bt, 192, gen)
    dist.barrier()
    return row


def k2_slice_rows(tag, model, gen, rank, time_it):
    """K2 on this rank's halo layout at the path's width (SGL's three views
    packed), within 2e-5 of its plain version; timed on rank 0 while rank 1
    waits."""
    import torch
    import torch.distributed as dist

    from selfrec_tpu_torch.ops import ell_gather
    from selfrec_tpu_torch.parallel.halo import _w_pad

    loc = model._view_template.fwd
    w_stack = torch.stack([model._w_clean, model.aux["w1"], model.aux["w2"]])
    w = _w_pad(w_stack).index_select(1, loc.slot_edge).reshape(
        3, loc.vmax, loc.layout.k).contiguous()
    x = torch.randn((loc.r_src + loc.grid[1] * loc.h, 192), generator=gen, device="cuda")
    out = ell_gather.ell_gather_sum(loc.layout, w, x)
    ref = ell_gather.ell_gather_sum_plain(loc.layout, w, x)
    if not torch.allclose(out, ref, rtol=K2_RTOL, atol=K2_ATOL):
        raise RuntimeError(f"{tag} rank {rank}: K2 on its halo layout differs from the "
                           f"plain version by {float((out - ref).abs().max())}")
    log(f"[scale-out {tag}] rank {rank}: K2 on its halo layout (Vmax {loc.vmax}, H {loc.h}, "
        f"{x.shape[0]} source rows) within {K2_RTOL}, max |err| "
        f"{float((out - ref).abs().max()):.3g}")
    dist.barrier()
    row = None
    if time_it and rank == 0:
        row = k2_case(f"rank halo {tag}", loc.layout, w, x)
    dist.barrier()
    return row


def int8_col_rel_gate(tag, model, rank):
    """The JAX package's int8 gate (tests/test_dense_shard.py:218-236) on
    the card over this mesh: on its shapes and inputs (41 users, 57 items,
    500 draws of edges, D 8, standard normal x) one sharded int8
    propagation within 0.02 of each column's largest value of the exact
    edge-list product. On the yelp graph, with the model's ego embeddings
    as x, where the single-device int8 block itself reads above 0.02, the
    sharded propagation's measure on every rank within
    ``1 + INT8_SHARDED_MARGIN`` of the block's (built on rank 0)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from selfrec_tpu_torch.ops.graph import spmm
    from selfrec_tpu_torch.ops.spmm_dense import dense_adj_from_edges
    from selfrec_tpu_torch.parallel.dense_shard import build_sharded_dense

    def col_rel(out, eu, ei, w, x, n_users):
        xu, xi = x[:n_users].double(), x[n_users:].double()
        w = w.double()[:, None]
        ref = torch.cat([torch.zeros_like(xu).index_add_(0, eu, w * xi[ei]),
                         torch.zeros_like(xi).index_add_(0, ei, w * xu[eu])])
        return float(((out.double() - ref).abs()
                      / ref.abs().amax(0, keepdim=True).clamp_min(1e-6)).max())

    rng = np.random.default_rng(7)
    u, i = 41, 57
    eu = rng.integers(0, u, 500)
    ei = rng.integers(0, i, 500)
    _, idx = np.unique(eu.astype(np.int64) * i + ei, return_index=True)
    eu, ei = eu[idx], ei[idx]
    du, di = np.bincount(eu, minlength=u), np.bincount(ei, minlength=i)
    w = (1.0 / np.sqrt(np.maximum(du[eu] * di[ei], 1))).astype(np.float32)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((u + i, 8)),
                        dtype=torch.float32, device="cuda")
    small = build_sharded_dense(eu, ei, w, u, i, model.mesh, device="cuda")
    dev = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    rel = col_rel(spmm(small, x), dev(eu), dev(ei), dev(w), x, u)
    if rel >= INT8_COL_REL:
        raise RuntimeError(f"{tag}: int8 propagation on the JAX test's inputs off by {rel} "
                           f"of a column's largest value (bound {INT8_COL_REL})")
    adj = model.adj
    with torch.no_grad():
        params = model.full_params()
        x = torch.cat([params["user_emb"], params["item_emb"]])
    edges = (adj.edge_users, adj.edge_items, adj.edge_w)
    yelp = col_rel(spmm(adj, x), *edges, x, adj.n_users)
    single = [None]
    if rank == 0:
        block = dense_adj_from_edges(*(e.cpu().numpy() for e in edges), adj.n_users,
                                     adj.n_items, device="cuda")
        single[0] = col_rel(spmm(block, x), *edges, x, adj.n_users)
        del block
        torch.cuda.empty_cache()
    dist.broadcast_object_list(single, src=0)
    single = single[0]
    if yelp > single * (1 + INT8_SHARDED_MARGIN):
        raise RuntimeError(f"{tag} rank {rank}: int8 propagation on the yelp graph off by "
                           f"{yelp} of a column's largest value, the single-device block "
                           f"by {single} (margin {INT8_SHARDED_MARGIN})")
    log(f"[scale-out {tag}] rank {rank}: int8 propagation on the JAX test's inputs within "
        f"{rel:.4f} of each column's largest value (bound {INT8_COL_REL}); on the yelp "
        f"graph {yelp!r} sharded against {single!r} on one device (margin "
        f"{INT8_SHARDED_MARGIN})")


def in_rank_order(rank, fn):
    """``fn()`` on each rank in turn, rank 0 first, while the others wait,
    so that what one rank times has the card to itself; returns this
    rank's result."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if r == rank:
            out = fn()
        dist.barrier()
    return out


def f32_mesh_gate(rank, mesh, gen):
    """SimGCL in the f32 dense mode (K1's float kernel) on a small graph:
    three sharded steps against the single-device card run, on rank 0,
    within rtol 2e-4 / atol 2e-5; then K1's float kernel, its backward and
    its operand pass on each rank's slice of that run at D 192 in f32
    against their plain versions (:func:`k1_float_case`), timed on rank 0.
    Returns the sharded run's K1 float launches and rank 0's row."""
    import torch

    from selfrec_tpu_torch.models.graph.simgcl import SimGCL
    from selfrec_tpu_torch.ops import dense_dual
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    train, test = synth_graph_mapped(600, 900, 12000, seed=5)
    runs = {}
    with knobs(SELFREC_TPU_DENSE="1", SELFREC_TPU_DENSE_DTYPE="float32"):
        for name, extra in (("sharded", {"mesh": mesh, "distributed": True}),
                            ("single", {})):
            if name == "single" and rank != 0:
                continue
            model = SimGCL(graph_conf("SimGCL", SIMGCL, **{"batch.size": 256, **extra}),
                           train, test, device="cuda")
            model.build()
            users, items, masks = model.epoch_batches(0)
            model.begin_epoch(0)
            dense_dual.float_products.launches = 0
            losses = model.train_batches(users[:3], items[:3], masks[:3])
            torch.cuda.synchronize()
            runs[name] = (model.gather_leaves({k: v.detach() for k, v in model.params.items()}),
                          losses, dense_dual.float_products.launches, model.adj)
    launches = runs["sharded"][2]
    if launches != 3 * 2 * SIMGCL["n_layer"]:
        raise RuntimeError(f"f32 mesh gate: {launches} K1 float launches in 3 steps")
    if rank == 0:
        for k, v in runs["single"][0].items():
            got = runs["sharded"][0][k]
            if not torch.allclose(got, v, rtol=PARALLEL_RTOL, atol=PARALLEL_ATOL):
                raise RuntimeError(f"f32 mesh gate: {k} after 3 sharded steps differs from "
                                   f"the single-device run by {float((got - v).abs().max())}")
        log(f"[scale-out f32 {mesh}] {runs['sharded'][3]!r}: 3 steps equal the single-device "
            f"card run within rtol {PARALLEL_RTOL} / atol {PARALLEL_ATOL} (losses "
            f"{runs['sharded'][1].tolist()} vs {runs['single'][1].tolist()})")
    adj = runs["sharded"][3]
    row = in_rank_order(rank, lambda: k1_float_case(
        "rank slice f32 SimGCL 1x2", adj.b, adj.bt, 192, torch.float32, gen, grad=True))
    log(f"[scale-out f32 {mesh}] rank {rank}: K1 float on its slice {tuple(adj.b.shape)} at "
        f"D 192, f32: operand pass exact, products and backward within rtol "
        f"{K1_FLOAT_RTOL} / atol {K1_FLOAT_ATOL} (max |err| {row['max_abs_err']:.3g})")
    return launches, row if rank == 0 else None


def scale_out_rank(rank, port, out_path):
    """One of two ranks on the one card, over gloo: SimGCL int8x8 at yelp
    scale on 1x2 and 2x1, the f32 gate, SGL's ELL arm on 1x2 (HaloAdj),
    SASRec at bench widths on 1x2 and MHCN on ShardedDenseMat at quarter
    douban. Writes its launch counts, timings and kernel rows to
    ``out_path`` as JSON."""
    import torch

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                      SELFREC_TPU_DENSE_DTYPE="int8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from selfrec_tpu_torch.device import disable_tf32
    from selfrec_tpu_torch.models import get_model_class
    from selfrec_tpu_torch.models.graph.mhcn import MHCN
    from selfrec_tpu_torch.models.graph.sgl import SGL
    from selfrec_tpu_torch.models.graph.simgcl import SimGCL
    from selfrec_tpu_torch.ops import dense_dual, ell_gather
    from selfrec_tpu_torch.parallel import distributed
    from selfrec_tpu_torch.parallel.dense_shard import ShardedDenseAdj, ShardedDenseMat
    from selfrec_tpu_torch.parallel.halo import HaloAdj
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped, synth_sequences

    disable_tf32()
    # two ranks on one card: the start-up shares it and takes gloo
    distributed.maybe_initialize({"distributed": True}, torch.device("cuda"))
    res = {"k1": {}, "k1f": {}, "k2": {}, "rows": {"k1f": []}, "ms": {}, "comm": {}}
    gen = torch.Generator(device="cuda").manual_seed(11 + rank)
    data = synth_graph_mapped()
    no_kernel = (dense_dual.dual_matmul, dense_dual.float_products, ell_gather.ell_gather_sum)

    # (a) SimGCL int8x8 at yelp2018 scale on 1x2 and 2x1 ----------------------------
    for nd, nm in ((1, 2), (2, 1)):
        tag = f"SimGCL int8x8 {nd}x{nm}"
        set_layout(True)
        t0 = time.time()
        model = SimGCL(graph_conf("SimGCL", SIMGCL, mesh={"data": nd, "model": nm},
                                  distributed=True), *data, device="cuda")
        model.build()
        torch.cuda.synchronize()
        if not isinstance(model.adj, ShardedDenseAdj):
            raise RuntimeError(f"{tag}: {model.adj!r}")
        log(f"[setup] rank {rank} {tag}: {model.adj!r}, {time.time() - t0:.1f} s")
        row = k1_slice_rows(f"{nd}x{nm}", model, gen, rank, time_it=(nd, nm) == (1, 2))
        if row is not None:
            res["rows"]["k1"] = row
        if (nd, nm) == (1, 2):
            # K1's float kernel on the yelp slice (the f32 mode's path at this
            # scale), each rank against the plain version, timed on rank 0
            adj = model.adj
            row = in_rank_order(rank, lambda: k1_float_case(
                "rank slice yelp 1x2", adj.b, adj.bt, 192, torch.float32, gen))
            log(f"[scale-out {tag}] rank {rank}: K1 float on its slice at D 192, f32, within "
                f"rtol {K1_FLOAT_RTOL} / atol {K1_FLOAT_ATOL} (max |err| "
                f"{row['max_abs_err']:.3g})")
            if rank == 0:
                res["rows"]["k1f"].append(row)
            del adj
            torch.cuda.empty_cache()
        int8_col_rel_gate(tag, model, rank)
        key = f"sharded_simgcl_{nd}x{nm}"
        res["k1"][key + "_train"], res["ms"][key + "_step"] = train_path(
            tag, model, dense_dual.dual_matmul, N_SHORT_BATCHES,
            per_step=2 * model.n_layers, profile_steps=3 if nm > 1 else 0)
        t0 = time.time()
        res["k1"][key + "_eval"] = eval_path(tag, model, dense_dual.dual_matmul)
        res["ms"][key + "_eval"] = 1e3 * (time.time() - t0)
        res["comm"][key] = comm_per_step(model, model.adj, 3 * 64, 2 * model.n_layers)
        if (model._sharded_topk_impl() is not None) != (nm > 1):
            raise RuntimeError(f"{tag}: the sharded top-k is on only with a model axis")
        log(f"[scale-out {tag}] sharded top-k: {nm > 1}; bytes a rank receives a step: "
            f"{res['comm'][key]}")
        replica_gate(tag, model)
        free(model)
        del model
        torch.cuda.empty_cache()

    res["k1f"]["sharded_simgcl_f32_small_train"], row = f32_mesh_gate(
        rank, {"data": 1, "model": 2}, gen)
    if row is not None:
        res["rows"]["k1f"].append(row)

    # (b) SGL's ELL arm with model 2: HaloAdj, K2 on every rank ----------------------
    set_layout(False)
    model = SGL(graph_conf("SGL", SGL_CONF, mesh={"data": 1, "model": 2}, distributed=True),
                *data, device="cuda")
    model.build()
    if not (isinstance(model.adj, HaloAdj) and isinstance(model._view_template, HaloAdj)):
        raise RuntimeError(f"SGL 1x2: {model.adj!r}, {model._view_template!r}")
    log(f"[setup] rank {rank} SGL ELL 1x2: {model._view_template!r}")
    model.begin_epoch(0)
    row = k2_slice_rows("1x2", model, gen, rank, time_it=True)
    if row is not None:
        res["rows"]["k2"] = row
    res["k2"]["halo_sgl_1x2_train"], res["ms"]["halo_sgl_1x2_step"] = train_path(
        "SGL ELL 1x2", model, ell_gather.ell_gather_sum, N_SHORT_BATCHES,
        per_step=2 * model.n_layers, profile_steps=3)
    res["k2"]["halo_sgl_1x2_eval"] = eval_path("SGL ELL 1x2", model, ell_gather.ell_gather_sum)
    res["comm"]["halo_sgl_1x2"] = comm_per_step(model, model._view_template, 3 * 64,
                                                2 * model.n_layers)
    log(f"[scale-out SGL ELL 1x2] bytes a rank receives a step (the template at P = 3): "
        f"{res['comm']['halo_sgl_1x2']}")
    replica_gate("SGL ELL 1x2", model)
    free(model)
    del model
    torch.cuda.empty_cache()

    # (c) SASRec at bench widths on 1x2 ---------------------------------------------
    train, test = synth_sequences()
    model = get_model_class("SASRec")(seq_conf("SASRec", SEQ_CONF["SASRec"],
                                               mesh={"data": 1, "model": 2},
                                               distributed=True), train, test, device="cuda")
    model.build()
    idx, row_mask = model.epoch_batches(0)
    for c in no_kernel:
        c.launches = 0
    torch.cuda.synchronize()
    first = model.train_batches(idx[:1], row_mask[:1])
    torch.cuda.synchronize()
    t0 = time.time()
    losses = torch.cat([first, model.train_batches(idx[1:6], row_mask[1:6])])
    torch.cuda.synchronize()
    res["ms"]["sasrec_1x2_step"] = 1e3 * (time.time() - t0) / 5
    if not bool(torch.isfinite(losses).all()) or any(c.launches for c in no_kernel):
        raise RuntimeError(f"SASRec 1x2: losses {losses.tolist()}, or a kernel launched")
    log(f"[train SASRec 1x2] 6 batches x {model.batch_size}: loss {float(losses[0]):.6f} -> "
        f"{float(losses[-1]):.6f}, steps 2..6: {res['ms']['sasrec_1x2_step']:.1f} ms/step; "
        f"sharded params {sorted(model._sharded)}")
    replica_gate("SASRec 1x2", model)
    free(model)
    del model
    torch.cuda.empty_cache()

    # (d) MHCN on ShardedDenseMat at quarter douban ---------------------------------
    with knobs(SELFREC_TPU_DENSE="1", SELFREC_TPU_DENSE_DTYPE=None):
        model = social_model(MHCN, "MHCN", MHCN_CONF, douban_data(div=4),
                             mesh={"data": 1, "model": 2}, distributed=True)
    if not all(isinstance(a, ShardedDenseMat) for a in model.H + [model.R, model.Rt]):
        raise RuntimeError("MHCN 1x2: not every adjacency is a ShardedDenseMat")
    res["k1"]["sharded_mhcn_1x2_train"], res["ms"]["sharded_mhcn_1x2_step"] = train_path(
        "MHCN ShardedDenseMat 1x2", model, no_kernel, 5, per_step=0)
    replica_gate("MHCN 1x2", model)
    free(model)
    del model

    with open(out_path, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def scale_out_phases(data, k1_paths, k1f_paths, k1_rows, k1f_rows, k2_paths, k2_rows):
    """NCCL at world size 1 in this process, NCCL's refusal of two ranks on
    one card, then two gloo ranks on the card (:func:`scale_out_rank`) as
    subprocesses, each with a timeout: a rank that fails or times out fails
    the script. Adds the sharded paths' launches (both ranks' counts
    summed) and the rank-slice kernel rows."""
    import tempfile

    nccl_world_one_phase(data, k1_paths, k2_paths)
    nccl_two_ranks_one_card()
    port = free_port()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--scale-out-rank", str(r), str(port), outs[r]],
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(2)]
        failed = []
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, SCALE_OUT_TIMEOUT_S - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} timed out after {SCALE_OUT_TIMEOUT_S} s")
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            for line in f.read().splitlines():
                log(f"[rank {r}] {line}")
            f.close()
            if p.returncode != 0:
                failed.append(f"rank {r} exited with {p.returncode}")
        if failed:
            raise RuntimeError("scale-out ranks: " + "; ".join(failed))
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
    log(f"[scale-out] two gloo ranks on one card: {time.time() - t0:.1f} s; ms/step "
        f"and ms/eval (rank 0): {res[0]['ms']}")
    for key, paths in (("k1", k1_paths), ("k1f", k1f_paths), ("k2", k2_paths)):
        for path in res[0][key]:
            paths[path] = res[0][key][path] + res[1][key][path]
    for path in ("sharded_simgcl_1x2_train", "sharded_simgcl_2x1_train",
                 "sharded_simgcl_1x2_eval", "sharded_simgcl_2x1_eval"):
        if k1_paths[path] <= 0:
            raise RuntimeError(f"scale-out: no K1 launch on {path}")
    if k2_paths["halo_sgl_1x2_train"] <= 0 or k1f_paths["sharded_simgcl_f32_small_train"] <= 0:
        raise RuntimeError("scale-out: no K2 or K1 float launch on the sharded paths")
    k1_rows.append(res[0]["rows"]["k1"])
    k1f_rows.extend(res[0]["rows"]["k1f"])
    k2_rows.append(res[0]["rows"]["k2"])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--scale-out-rank"]:
        return scale_out_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.environ["SELFREC_TPU_DENSE_DTYPE"] = "int8"
    from selfrec_tpu_torch.device import disable_tf32
    from selfrec_tpu_torch.models.graph.buir import BUIR
    from selfrec_tpu_torch.models.graph.directau import DirectAU
    from selfrec_tpu_torch.models.graph.lightgcn import LightGCN
    from selfrec_tpu_torch.models.graph.mf import MF
    from selfrec_tpu_torch.models.graph.mixgcf import MixGCF
    from selfrec_tpu_torch.models.graph.ncl import NCL
    from selfrec_tpu_torch.models.graph.selfcf import SelfCF
    from selfrec_tpu_torch.models.graph.sgl import SGL
    from selfrec_tpu_torch.models.graph.simgcl import SimGCL
    from selfrec_tpu_torch.models.graph.ssl4rec import SSL4Rec
    from selfrec_tpu_torch.models.graph.itemknn import ItemKNN
    from selfrec_tpu_torch.models.graph.userknn import UserKNN
    from selfrec_tpu_torch.models.graph.xsimgcl import XSimGCL
    from selfrec_tpu_torch.ops import cuda_build, dense_dual, ell_gather, ranking, spmm_ell
    from selfrec_tpu_torch.ops.graph import NormAdj
    from selfrec_tpu_torch.ops.spmm_ell import EllAdj
    from selfrec_tpu_torch.utils.synth import synth_graph_mapped

    disable_tf32()
    t_start = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    libs = cuda_build.build_all()
    log(f"[build] {sorted(libs.values())} in {time.time() - t0:.1f} s")
    for so in libs.values():
        kernel = "?"
        with open(so[:-3] + ".log") as f:
            for line in f:
                if "Compiling entry function" in line:
                    found = re.search(r"(dual_s8|dual_float|float_operand|ell_items|ell_long_rows|"
                                      r"rank_partial|rank_merge)_kernel(I\w+?EE)?", line)
                    kernel = found.group(0) if found else line.split("'")[1]
                elif "registers" in line or "spill" in line:
                    log(f"[build] {kernel}: "
                        f"{re.sub(r'^ptxas info\s*:\s*', '', line.strip())}")

    t0 = time.time()
    data = synth_graph_mapped()
    log(f"[setup] yelp2018-scale synthetic graph in {time.time() - t0:.1f} s")

    # SimGCL int8x8 on the dense layout --------------------------------------
    model = yelp_model(SimGCL, "SimGCL", SIMGCL, data, dense=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    small = (torch.rand((1000, 1337), generator=gen, device="cuda") < 0.3).to(torch.int8)
    # D 100 is padded to one 128-wide chunk (f32: two chunks of pieces)
    ragged = [(small, 64), (small[:517, :1029].contiguous(), 192),
              (small[:333, :1201].contiguous(), 100)]
    ragged = [(b, dense_dual.block_transpose(b), d) for b, d in ragged]
    yelp = [(model.adj.a_ui, model.adj.a_iu, d) for d in (64, 192, 100)]
    k1_rows = [k1_case(tag, b, bt, d, gen) for tag, cases in (("ragged", ragged),
                                                                ("yelp", yelp))
               for b, bt, d in cases]
    k1f_rows = [k1_float_case(tag, b, bt, d, dtype, gen, grad=tag == "ragged")
                for tag, cases in (("ragged", ragged), ("yelp", yelp))
                for b, bt, d in cases for dtype in (torch.bfloat16, torch.float32)]
    del small, ragged, yelp
    torch.cuda.empty_cache()
    simgcl_reference_phase()
    k1_paths = {}
    k1_paths["simgcl_train"], _ = train_path("SimGCL int8x8", model, dense_dual.dual_matmul,
                                             N_TRAIN_BATCHES, profile_steps=N_PROFILE_STEPS)
    k1_paths["simgcl_eval"] = eval_path("SimGCL int8x8", model, dense_dual.dual_matmul,
                                        profile=True)
    if RANK_LAUNCHES["SimGCL int8x8"] != 1:
        raise RuntimeError("SimGCL int8x8 eval: the dense-mask ranking did not take the "
                           "ranking kernels once")
    rank_row = rank_case(model)
    free(model)
    del model
    torch.cuda.empty_cache()

    # SGL's ELL arm and LightGCN on the ELL layout ------------------------------
    model = yelp_model(SGL, "SGL", SGL_CONF, data, dense=False)
    model.begin_epoch(0)
    k2_rows = k2_phase(model)
    torch.cuda.empty_cache()
    sgl_reference_phase()
    k2_paths = {}
    scattered = []  # the layouts that ell_weights scatters onto
    scatter = spmm_ell.ell_weights

    def counted(layout, edge_w):
        scattered.append(layout)
        return scatter(layout, edge_w)

    spmm_ell.ell_weights = counted
    try:
        k2_paths["sgl_ell_train"], _ = train_path(
            "SGL ELL", model, ell_gather.ell_gather_sum, N_TRAIN_BATCHES,
            per_step=2 * model.n_layers, profile_steps=N_PROFILE_STEPS)
    finally:
        spmm_ell.ell_weights = scatter
    tmpl = model._view_template
    if [id(layout) for layout in scattered] != [id(tmpl.fwd), id(tmpl.bwd)]:
        raise RuntimeError(f"SGL ELL train: {len(scattered)} slot-weight scatters over one "
                           f"epoch's set-up, warm-up, capture and replays, expected the "
                           f"template's two in its set-up")
    log("[k2] SGL ELL train: the slot weights scattered once a layout over the epoch "
        "(its set-up; warm-up, capture and replays none)")
    k2_paths["sgl_ell_eval"] = eval_path("SGL ELL", model, ell_gather.ell_gather_sum)
    free(model)
    del model
    torch.cuda.empty_cache()
    model = yelp_model(LightGCN, "LightGCN", {"n_layer": 3}, data, dense=False)
    k2_paths["lightgcn_ell_train"], _ = train_path(
        "LightGCN ELL", model, ell_gather.ell_gather_sum, N_SHORT_BATCHES,
        per_step=2 * model.n_layers)
    free(model)
    del model
    torch.cuda.empty_cache()

    # SGL's dense int8x8 arm: three views, each hop forward and backward ------
    model = yelp_model(SGL, "SGL", SGL_CONF, data, dense=True)
    k1_paths["sgl_dense_train"], _ = train_path(
        "SGL dense int8x8", model, dense_dual.dual_matmul, N_SHORT_BATCHES,
        per_step=3 * 2 * model.n_layers)
    free(model)
    del model
    torch.cuda.empty_cache()

    # XSimGCL, DirectAU and MixGCF on the dense int8x8 block: each hop one
    # K1 launch forward and one backward -----------------------------------
    xsimgcl_reference_phase()
    model = yelp_model(XSimGCL, "XSimGCL", XSIMGCL, data, dense=True)
    k1_paths["xsimgcl_train"], _ = train_path(
        "XSimGCL int8x8", model, dense_dual.dual_matmul, N_TRAIN_BATCHES,
        per_step=2 * model.n_layers, profile_steps=N_PROFILE_STEPS)
    k1_paths["xsimgcl_eval"] = eval_path("XSimGCL int8x8", model, dense_dual.dual_matmul)
    free(model)
    del model
    torch.cuda.empty_cache()
    model = yelp_model(DirectAU, "DirectAU", DIRECTAU, data, dense=True)
    k1_paths["directau_train"], _ = train_path(
        "DirectAU int8x8", model, dense_dual.dual_matmul, N_SHORT_BATCHES,
        per_step=2 * model.n_layers, profile_steps=N_PROFILE_STEPS)
    k1_paths["directau_eval"] = eval_path("DirectAU int8x8", model, dense_dual.dual_matmul)
    free(model)
    del model
    torch.cuda.empty_cache()
    model = yelp_model(MixGCF, "MixGCF", MIXGCF, data, dense=True)
    k1_paths["mixgcf_train"], _ = train_path(
        "MixGCF int8x8", model, dense_dual.dual_matmul, N_SHORT_BATCHES,
        per_step=2 * model.n_layers, profile_steps=N_PROFILE_STEPS)
    free(model)
    del model
    torch.cuda.empty_cache()

    # MF: no adjacency, so no K1 or K2 launch ------------------------------
    model = yelp_model(MF, "MF", {}, data, dense=True)
    no_kernel = (dense_dual.dual_matmul, ell_gather.ell_gather_sum)
    k1_paths["mf_train"], _ = train_path("MF", model, no_kernel, N_SHORT_BATCHES, per_step=0,
                                      profile_steps=N_PROFILE_STEPS)
    k1_paths["mf_eval"] = eval_path("MF", model, no_kernel, expect=0)
    free(model)
    del model
    torch.cuda.empty_cache()
    resume_phase()

    # SelfCF and BUIR in the dense bf16 mode: each hop one K1 float launch
    # forward (bf16 operands) and one backward (f32 cotangents) -----------
    k1_float = dense_dual.float_products
    k1f_paths = {}
    dense_float_reference_phase(k1_float)
    with pinned_bf16():
        model = yelp_model(SelfCF, "SelfCF", SELFCF, data, dense=True)
    k1f_paths["selfcf_train"], _ = train_path(
        "SelfCF bf16", model, k1_float, N_TRAIN_BATCHES, per_step=2 * model.n_layers,
        profile_steps=N_PROFILE_STEPS)
    k1f_paths["selfcf_eval"] = eval_path("SelfCF bf16", model, k1_float, width=128)
    free(model)
    del model
    torch.cuda.empty_cache()
    with pinned_bf16():
        model = yelp_model(BUIR, "BUIR", BUIR_CONF, data, dense=True)
    k1f_paths["buir_train"], _ = train_path(
        "BUIR bf16", model, k1_float, N_SHORT_BATCHES, per_step=3 * model.n_layers,
        profile_steps=N_PROFILE_STEPS)
    k1f_paths["buir_eval"] = eval_path("BUIR bf16", model, k1_float, width=128)
    free(model)
    del model
    torch.cuda.empty_cache()
    model = yelp_model(BUIR, "BUIR", BUIR_CONF, data, dense=False)
    k2_rows.append(buir_k2_row(model))
    k2_paths["buir_ell_train"], _ = train_path(
        "BUIR ELL", model, ell_gather.ell_gather_sum, N_SHORT_BATCHES,
        per_step=2 * model.n_layers)
    free(model)
    del model
    torch.cuda.empty_cache()

    # NCL int8x8: both phases and the E-step between them ---------------------
    model = yelp_model(NCL, "NCL", NCL_CONF, data, dense=True)
    k1_paths["ncl_warm_train"], _ = train_path(
        "NCL int8x8 warm-up", model, dense_dual.dual_matmul, N_SHORT_BATCHES,
        per_step=2 * model.n_layers)
    ncl_estep(model)
    k1_paths["ncl_proto_train"], _ = train_path(
        "NCL int8x8 prototype phase", model, dense_dual.dual_matmul, N_SHORT_BATCHES,
        per_step=2 * model.n_layers, profile_steps=N_PROFILE_STEPS)
    k1_paths["ncl_eval"] = eval_path("NCL int8x8", model, dense_dual.dual_matmul)
    free(model)
    del model
    torch.cuda.empty_cache()

    # SSL4Rec: two towers, no adjacency, so no K1 or K2 launch ----------------
    model = yelp_model(SSL4Rec, "SSL4Rec", SSL4REC, data, dense=True)
    no_kernel = (dense_dual.dual_matmul, k1_float, ell_gather.ell_gather_sum)
    k1_paths["ssl4rec_train"], _ = train_path("SSL4Rec", model, no_kernel, N_SHORT_BATCHES,
                                           per_step=0, profile_steps=N_PROFILE_STEPS)
    k1_paths["ssl4rec_eval"] = eval_path("SSL4Rec", model, no_kernel, expect=0, width=128)
    free(model)
    del model
    torch.cuda.empty_cache()

    # The budget fallbacks, forced on the yelp graph by lowering the budgets
    # SimGCL int8x8 with the CSR sampler (the 150 MB bitmap over 100 MB) and
    # the scatter-mask eval --------------------------------------------------
    with knobs(SELFREC_TPU_NEG_BITMAP_MB="100"):
        model = yelp_model(SimGCL, "SimGCL", SIMGCL, data, dense=True)
    sampler_gates(model)
    csr_on_card_gate(model)
    k1_paths["simgcl_csr_train"], _ = train_path(
        "SimGCL int8x8 CSR sampler", model, dense_dual.dual_matmul, N_SHORT_BATCHES,
        per_step=2 * model.n_layers, profile_steps=N_PROFILE_STEPS)
    with knobs(SELFREC_TPU_EVAL_MASK="scatter"):
        k1_paths["simgcl_scatter_eval"] = eval_path("SimGCL int8x8 scatter mask", model,
                                                    dense_dual.dual_matmul, profile=True)
        hit_gate("SimGCL int8x8 scatter mask", model)
    scatter_eval_gate("SimGCL int8x8", model)
    free(model)
    del model
    torch.cuda.empty_cache()

    # over budget under auto: the 1.205 GB block and mask over 1.0 GB, so
    # LightGCN lands on ELL (K2 at P = 1) and ranks through the scatter mask;
    # the epoch's batches shuffled on the host ----------------------------
    with knobs(SELFREC_TPU_DENSE="auto", SELFREC_TPU_DENSE_BUDGET_GB="1.0",
               SELFREC_TPU_HOST_BATCHES="1"):
        model = LightGCN(graph_conf("LightGCN", {"n_layer": 3}), *data, device="cuda")
        model.build()
        if not isinstance(model.adj, EllAdj) or ranking.get_rated_dense(model.data, "cuda") \
                is not None:
            raise RuntimeError(f"over-budget phase: {model.adj!r}, or a resident mask")
        log(f"[setup] LightGCN over budget under auto: {model.adj!r}, no resident mask")
        k2_paths["lightgcn_auto_ell_train"], _ = train_path(
            "LightGCN auto over budget (ELL, host batches)", model, ell_gather.ell_gather_sum,
            N_SHORT_BATCHES, per_step=2 * model.n_layers)
        k2_paths["lightgcn_auto_ell_eval"] = eval_path(
            "LightGCN auto over budget (ELL, scatter mask)", model, ell_gather.ell_gather_sum)
    free(model)
    del model
    torch.cuda.empty_cache()

    # SELFREC_TPU_ELL=0: LightGCN on the edge-list NormAdj, no kernel --------
    with knobs(SELFREC_TPU_ELL="0"):
        model = yelp_model(LightGCN, "LightGCN", {"n_layer": 3}, data, dense=False)
    if not isinstance(model.adj, NormAdj):
        raise RuntimeError(f"SELFREC_TPU_ELL=0 phase: {model.adj!r}")
    k1_paths["lightgcn_normadj_train"], _ = train_path(
        "LightGCN NormAdj", model, no_kernel, N_SHORT_BATCHES, per_step=0,
        profile_steps=N_PROFILE_STEPS, atomics="index_add_ in NormAdj's sums")
    k1_paths["lightgcn_normadj_eval"] = eval_path("LightGCN NormAdj", model, no_kernel,
                                                  expect=0)
    free(model)
    del model
    torch.cuda.empty_cache()

    # UserKNN and ItemKNN (bench.py:808-855: topK 50, shrinkage 100): card
    # against CPU on the small graph, then the yelp builds and evals --------
    knn_reference_phase()
    for cls in (UserKNN, ItemKNN):
        t0 = time.time()
        model = cls(graph_conf(cls.__name__, {}, **KNN_CONF), *data, device="cuda")
        log(f"[setup] {cls.__name__}: {time.time() - t0:.1f} s")
        k1_paths[f"{cls.__name__.lower()}"] = knn_path(cls.__name__, model, no_kernel)
        free(model)
        del model
        torch.cuda.empty_cache()

    social_phases(k1_paths, k1_rows, k1_float, k2_paths, k2_rows)

    # SASRec, CL4SRec and BERT4Rec: no kernel of the port runs -----------------
    sequential_phases({"K1 int8": (dense_dual.dual_matmul, k1_paths),
                       "K1 float": (k1_float, k1f_paths),
                       "K2": (ell_gather.ell_gather_sum, k2_paths)})

    # scale-out: NCCL at world size 1, then two gloo ranks sharing the card ----
    scale_out_phases(data, k1_paths, k1f_paths, k1_rows, k1f_rows, k2_paths, k2_rows)

    k1_main = next(r for r in k1_rows if r["tag"] == "yelp" and r["shape"][2] == 192)
    k1f_main = next(r for r in k1f_rows if r["tag"] == "yelp" and r["shape"][2] == 64
                    and r["x"] == "bf16")
    k2_main = next(r for r in k2_rows if r["tag"] == "yelp packed")
    kernels = []
    for name, source, replaces, paths, main_row, rows in (
            ("K1 dual_matmul (int8)", "selfrec_tpu_torch/csrc/dense_dual.cu",
             "selfrec_tpu/ops/dense_dual.py:174", k1_paths, k1_main, k1_rows),
            # SelfCF's and BUIR's dense bf16 mode: bf16 operands forward, f32 back
            ("K1 dual_matmul (bf16/f32 operands)", "selfrec_tpu_torch/csrc/dense_dual.cu",
             "selfrec_tpu/ops/dense_dual.py:174", k1f_paths, k1f_main, k1f_rows),
            ("K2 ell_gather_sum", "selfrec_tpu_torch/csrc/ell_gather.cu",
             "selfrec_tpu/ops/spmm_pallas.py:94", k2_paths, k2_main, k2_rows),
            # the eval's dense-mask ranking; no TPU kernel: lax.top_k there
            ("rank_topk (rank_partial + rank_merge)", "selfrec_tpu_torch/csrc/rank_topk.cu",
             None, {t: c for t, c in RANK_LAUNCHES.items() if c}, rank_row, [rank_row])):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: main_row[k] for k in ("ms", "ms_back_to_back", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            "shapes": rows})
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
