"""Plain float32 SGL (SELFRec model/graph/SGL.py), the reference of the
configuration ``SGL-amazon-book``.

The encoder is LightGCN propagation that averages layers 0..K, layer 0
included (SGL.py:100-111). Each epoch draws two views of the graph, each
keeping a random ``1 - drop_rate`` of the training edges (``aug_type`` 1)
and normalized again as D^-1/2 A D^-1/2 over what it keeps (SELFRec's
``edge_dropout`` and ``convert_to_laplacian_mat``, SGL.py:28-29). A step's
loss is BPR on the clean graph, plus L2 of the propagated user, positive
and negative rows, each norm over the batch size (SELFRec's
``l2_reg_loss``; not divided by the batch size again, SGL.py:36), plus
``lambda`` times InfoNCE at temperature ``temp`` between the two views,
over the batch's distinct users and distinct items stacked as one set of
anchors (SGL.py:115-127).

The random draws replay the program's, worked out here from their
definitions:
- the views' keep masks from ``numpy.random.default_rng((seed, epoch,
  1))``, view 1 then view 2, each a draw of ``int(E * (1 - drop_rate))``
  distinct edge positions in training order (the count of SELFRec's
  augmentor, which draws with ``random.sample``);
- a step's negatives from one generator seeded as the program's step
  generator: a candidate a row, then ``NEG_ROUNDS`` rounds that redraw a
  fresh candidate for every row and take it where the current one is
  rated.

Departures from SELFRec, as the program has them: ``aug_type`` 2 (random
walk) behaves as 1, because SELFRec's ``if self.aug_type==0 or 1``
(SGL.py:81) is always true; the views of epoch ``e`` come from the seeded
numpy generator above, where SELFRec draws them from Python's global
``random``; negatives are drawn uniformly and redrawn where rated, where
SELFRec's sampler loops on the host until it finds an unrated item.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import graph
from benchmark.reference.train import precision, replay

NEG_ROUNDS = 8


def make_params(seed: int, inputs, conf, device):
    """Xavier-uniform user and item tables (SELFRec's init), from one
    uniform draw of a generator on ``device`` seeded with ``seed``."""
    nu, ni, d = inputs["n_users"], inputs["n_items"], int(conf["embedding.size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(((nu + ni), d), generator=gen, device=device)
    bu, bi = math.sqrt(6.0 / (d + nu)), math.sqrt(6.0 / (d + ni))
    return {"user_emb": (u[:nu] * (2 * bu) - bu).contiguous(),
            "item_emb": (u[nu:] * (2 * bi) - bi).contiguous()}


def _args(conf):
    a = conf.get("SGL", {})
    return (int(a.get("n_layer", 2)), float(a.get("lambda", 0.1)),
            float(a.get("drop_rate", 0.1)), int(a.get("aug_type", 1)),
            float(a.get("temp", 0.2)))


def keep_masks(inputs, conf, epoch: int):
    """The two views' kept-edge masks of ``epoch``, each (E,) bool over the
    training edges in their order. Edge dropout only: node dropout
    (``aug_type`` 0) is no configuration's, and raises."""
    _, _, drop, aug, _ = _args(conf)
    if aug == 0:
        raise ValueError("the SGL reference draws edge dropout (aug_type 1 or 2), not 0")
    rng = np.random.default_rng((int(conf.get("seed", 0)), epoch, 1))
    n_edges = len(inputs["train_u"])
    masks = []
    for _ in range(2):
        keep = np.zeros(n_edges, bool)
        keep[rng.choice(n_edges, size=int(n_edges * (1 - drop)), replace=False)] = True
        masks.append(keep)
    return masks


def view_adj(inputs, keep: np.ndarray, device):
    """A view's adjacency: the kept edges, normalized over their own
    degrees (a node that keeps no edge gets none)."""
    u, i = np.asarray(inputs["train_u"]), np.asarray(inputs["train_i"])
    return graph.norm_adj(u[keep], i[keep], inputs["n_users"], inputs["n_items"], device)


def propagate(adj, ego: torch.Tensor, n_layers: int) -> torch.Tensor:
    """The mean of layers 0..K of ``x <- A x``."""
    e, acc = ego, ego
    for _ in range(n_layers):
        e = graph.spmm(adj, e)
        acc = acc + e
    return acc / (n_layers + 1)


def embeddings(adj, params, n_layers: int):
    ego = torch.cat([params["user_emb"], params["item_emb"]])
    out = propagate(adj, ego, n_layers)
    nu = params["user_emb"].shape[0]
    return out[:nu], out[nu:]


def infonce(a, b, temp: float):
    a, b = F.normalize(a, dim=1), F.normalize(b, dim=1)
    return -torch.mean(torch.diagonal(F.log_softmax(a @ b.T / temp, dim=1)))


def negatives(gen, keys, users, n_items: int, device):
    """One step's negatives, in the order the program draws them."""
    shape = users.shape
    cand = torch.randint(0, n_items, shape, generator=gen, device=device, dtype=torch.int64)
    for _ in range(NEG_ROUNDS):
        bad = graph.is_rated(keys, users, cand, n_items)
        fresh = torch.randint(0, n_items, shape, generator=gen, device=device, dtype=torch.int64)
        cand = torch.where(bad, fresh, cand)
    return cand


def loss(adjs, params, u, i, j, conf):
    """``adjs``: the clean graph's adjacency and the two views'."""
    n_layers, cl_rate, _, _, temp = _args(conf)
    reg = float(conf["reg.lambda"])
    nu = params["user_emb"].shape[0]
    ego = torch.cat([params["user_emb"], params["item_emb"]])
    clean, v1, v2 = (propagate(adj, ego, n_layers) for adj in adjs)
    ue, pe, ne = clean[u], clean[nu + i], clean[nu + j]
    rec = torch.mean(-torch.log(1e-5 + torch.sigmoid((ue * pe).sum(1) - (ue * ne).sum(1))))
    l2 = reg * (torch.linalg.norm(ue) + torch.linalg.norm(pe) + torch.linalg.norm(ne)) / u.shape[0]
    anchors = torch.cat([torch.unique(u), torch.unique(i) + nu])
    return rec + l2 + cl_rate * infonce(v1[anchors], v2[anchors], temp)


def train_readings(inputs, params0, batches, draw_seed: int, conf, device, n_steps: int,
                   half_batch: bool = False, tf32: bool = False):
    """The reference's first ``n_steps`` steps of epoch 0 over the
    program's batches (``batches``: (u, i) int64 tensor pairs, one a step).
    ``half_batch`` plants the fault that leaves out the second half of
    every batch; ``tf32`` computes the matrix products in TF32 (the
    control)."""
    nu, ni = inputs["n_users"], inputs["n_items"]
    adjs = [graph.norm_adj(inputs["train_u"], inputs["train_i"], nu, ni, device)]
    adjs += [view_adj(inputs, keep, device) for keep in keep_masks(inputs, conf, 0)]
    keys = graph.rated_keys(inputs["train_u"], inputs["train_i"], ni, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed)

    def step_loss(params, step):
        u, i = batches[step]
        j = negatives(gen, keys, u, ni, device)
        if half_batch:
            half = u.shape[0] // 2
            u, i, j = u[:half], i[:half], j[:half]
        return loss(adjs, params, u, i, j, conf)

    with precision(tf32):
        return replay(params0, step_loss, n_steps, float(conf["learning.rate"]))


class Scorer:
    """The reference's eval state: f32 embeddings of ``params0`` on the
    clean graph and, for a block of test rows, the scores of every item
    with the rated ones at ``-inf`` (SELFRec masks them before the
    top-N)."""

    def __init__(self, inputs, params0, conf, device, tf32: bool = False):
        nu, ni = inputs["n_users"], inputs["n_items"]
        adj = graph.norm_adj(inputs["train_u"], inputs["train_i"], nu, ni, device)
        self.tf32 = tf32
        with torch.no_grad(), precision(tf32):
            self.user_emb, self.item_emb = embeddings(adj, params0, _args(conf)[0])
        self.keys = graph.rated_keys(inputs["train_u"], inputs["train_i"], ni, device)
        self.rows = torch.as_tensor(inputs["test_u"], dtype=torch.int64, device=device)
        self.n_items = ni
        self.k = max(int(n) for n in conf["item.ranking.topN"])
        self.truth = [[int(x)] for x in inputs["test_i"]]
        self.device = device

    def scores(self, lo: int, hi: int) -> torch.Tensor:
        users = self.rows[lo:hi]
        with precision(self.tf32):
            s = self.user_emb[users] @ self.item_emb.T
        items = torch.arange(self.n_items, device=self.device)
        rated = graph.is_rated(self.keys, users[:, None].expand_as(s), items[None, :].expand_as(s),
                               self.n_items)
        return torch.where(rated, torch.full_like(s, -float("inf")), s)


def step_flops(inputs, conf) -> float:
    """A training step's model FLOPs, whatever the layout: each hop of each
    of the three propagations 2·nnz·D a direction, forward and backward,
    the views over the edges they keep (the augmentor's count); InfoNCE's
    similarity products (forward and two backward) over 2·B anchors, the
    batch's users and items, which the port's static step computes; BPR's
    scores forward and backward."""
    n_layers, _, drop, _, _ = _args(conf)
    d, b = int(conf["embedding.size"]), int(conf["batch.size"])
    nnz = len(inputs["train_u"])
    kept = int(nnz * (1 - drop))
    propagation = n_layers * 2 * 2 * (2 * (nnz + 2 * kept) * d)
    infonce_products = 3 * (2 * (2 * b) ** 2 * d)
    bpr = 3 * 2 * (2 * b * d)
    return float(propagation + infonce_products + bpr)
