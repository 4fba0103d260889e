"""Plain float32 SimGCL (SELFRec model/graph/SimGCL.py), the reference of
the configuration ``SimGCL-yelp2018``.

The encoder is LightGCN propagation that averages layers 1..K. Training
runs three propagations of the same tables: a clean one for the BPR and
L2 terms, and two whose every hop adds ``sign(e) * eps * u / |u|`` (u
uniform in [0, 1)) for InfoNCE at temperature 0.2 over the batch's
distinct users and distinct items. The L2 term is taken on the propagated
user and positive rows, over the batch size.

The random draws replay the port's order from one generator seeded as
the program's step generator: for each step the negatives (a candidate a
row, then ``NEG_ROUNDS`` rounds that redraw a fresh candidate for every
row and take it where the current one is rated), then the noise of view
1 and view 2 of every hop, hop by hop, each an (U+I, D) uniform draw.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import graph
from benchmark.reference.train import precision, replay

NEG_ROUNDS = 8
CL_TEMP = 0.2


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
    a = conf.get("SimGCL", {})
    return int(a.get("n_layer", 2)), float(a.get("eps", 0.1)), float(a.get("lambda", 0.5))


def embeddings(adj, params, n_layers: int):
    ego = torch.cat([params["user_emb"], params["item_emb"]])
    out = graph.propagate_mean(adj, ego, n_layers)
    nu = params["user_emb"].shape[0]
    return out[:nu], out[nu:]


def _perturbed(adj, ego, n_layers, eps, noise):
    e, acc = ego, torch.zeros_like(ego)
    for k in range(n_layers):
        e = graph.spmm(adj, e)
        u = noise[k]
        e = e + torch.sign(e) * eps * u / (torch.linalg.norm(u, dim=1, keepdim=True) + 1e-12)
        acc = acc + e
    return acc / n_layers


def infonce(a, b, temp: float):
    a, b = F.normalize(a, dim=1), F.normalize(b, dim=1)
    return -torch.mean(torch.diagonal(F.log_softmax(a @ b.T / temp, dim=1)))


def draws(gen, keys, users, n_users, n_items, n_layers, d, device):
    """One step's negatives and noise, in the order the port draws them."""
    shape = users.shape
    cand = torch.randint(0, n_items, shape, generator=gen, device=device, dtype=torch.int64)
    for _ in range(NEG_ROUNDS):
        bad = graph.is_rated(keys, users, cand, n_items)
        fresh = torch.randint(0, n_items, shape, generator=gen, device=device, dtype=torch.int64)
        cand = torch.where(bad, fresh, cand)
    n = n_users + n_items
    noise = [[torch.rand((n, d), generator=gen, device=device) for _ in range(2)]
             for _ in range(n_layers)]
    return cand, noise


def loss(adj, params, u, i, j, noise, conf):
    n_layers, eps, cl_rate = _args(conf)
    reg = float(conf["reg.lambda"])
    nu = params["user_emb"].shape[0]
    ego = torch.cat([params["user_emb"], params["item_emb"]])
    clean = graph.propagate_mean(adj, ego, n_layers)
    v1 = _perturbed(adj, ego, n_layers, eps, [nz[0] for nz in noise])
    v2 = _perturbed(adj, ego, n_layers, eps, [nz[1] for nz in noise])
    ue, pe, ne = clean[u], clean[nu + i], clean[nu + j]
    rec = torch.mean(-torch.log(1e-5 + torch.sigmoid((ue * pe).sum(1) - (ue * ne).sum(1))))
    l2 = reg * (torch.linalg.norm(ue) + torch.linalg.norm(pe)) / u.shape[0]
    uu, ii = torch.unique(u), torch.unique(i) + nu
    cl = infonce(v1[uu], v2[uu], CL_TEMP) + infonce(v1[ii], v2[ii], CL_TEMP)
    return rec + l2 + cl_rate * cl


def train_readings(inputs, params0, batches, draw_seed: int, conf, device, n_steps: int,
                   half_batch: bool = False):
    """The reference's first ``n_steps`` steps over the program's batches
    (``batches``: (u, i) int64 tensor pairs, one a step). ``half_batch``
    plants the fault that leaves out the second half of every batch."""
    nu, ni = inputs["n_users"], inputs["n_items"]
    adj = graph.norm_adj(inputs["train_u"], inputs["train_i"], nu, ni, device)
    keys = graph.rated_keys(inputs["train_u"], inputs["train_i"], ni, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed)
    n_layers, d = _args(conf)[0], int(conf["embedding.size"])

    def step_loss(params, step):
        u, i = batches[step]
        j, noise = draws(gen, keys, u, nu, ni, n_layers, d, device)
        if half_batch:
            half = u.shape[0] // 2
            u, i, j = u[:half], i[:half], j[:half]
        return loss(adj, params, u, i, j, noise, conf)

    with precision(False):
        return replay(params0, step_loss, n_steps, float(conf["learning.rate"]))


class Scorer:
    """The reference's eval state: f32 embeddings of ``params0`` and, for a
    block of test rows, the scores of every item with the rated ones at
    ``-inf`` (SELFRec masks them before the top-N)."""

    def __init__(self, inputs, params0, conf, device):
        nu, ni = inputs["n_users"], inputs["n_items"]
        adj = graph.norm_adj(inputs["train_u"], inputs["train_i"], nu, ni, device)
        with torch.no_grad(), precision(False):
            self.user_emb, self.item_emb = embeddings(adj, params0, _args(conf)[0])
        self.keys = graph.rated_keys(inputs["train_u"], inputs["train_i"], ni, device)
        self.rows = torch.as_tensor(inputs["test_u"], dtype=torch.int64, device=device)
        self.n_items = ni
        self.k = max(int(n) for n in conf["item.ranking.topN"])
        self.truth = [[int(x)] for x in inputs["test_i"]]
        self.device = device

    def scores(self, lo: int, hi: int) -> torch.Tensor:
        users = self.rows[lo:hi]
        with precision(False):
            s = self.user_emb[users] @ self.item_emb.T
        items = torch.arange(self.n_items, device=self.device)
        rated = graph.is_rated(self.keys, users[:, None].expand_as(s), items[None, :].expand_as(s),
                               self.n_items)
        return torch.where(rated, torch.full_like(s, -float("inf")), s)


def step_flops(inputs, conf) -> float:
    """A training step's model FLOPs, whatever the layout: each hop of each
    of the three propagations 2·nnz·D a direction, forward and backward;
    InfoNCE's similarity products (forward and two backward) over the
    batch's anchors, counted at the batch size, which the port's static
    step computes; BPR's scores forward and backward."""
    n_layers = _args(conf)[0]
    d, b = int(conf["embedding.size"]), int(conf["batch.size"])
    nnz = len(inputs["train_u"])
    propagation = n_layers * 2 * 2 * (2 * nnz * 3 * d)
    infonce_products = 2 * 3 * (2 * b * b * d)
    bpr = 3 * 2 * (2 * b * d)
    return float(propagation + infonce_products + bpr)
