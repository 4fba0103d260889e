"""Plain float32 SASRec (SELFRec model/sequential/SASRec.py), the reference
of the configuration ``SASRec-amazon-beauty``. TF32 stays off unless the
caller asks for it (the lower-precision control).

Windows follow SELFRec's sampler (util/sampler.py): a training window is
the sequence but its last item, right-anchored to the last ``max.len - 1``
positions, targets the next items; a test window is the whole sequence,
right-anchored to ``max.len``; positions count from 1, 0 pads.

The encoder: item rows times sqrt(D) plus position rows, dropout, pad
positions zeroed; each block layer-normalizes the query only (keys and
values are the block's input), adds the normalized query back after a
causal single-head-per-slice attention with dropout on its weights,
layer-normalizes, then Linear-ReLU-Linear with dropout and a residual, the
pads zeroed again; a last LayerNorm (eps 1e-8, population variance). The
loss is binary cross-entropy on the next item against one negative a
position, the two terms averaged apart over the valid positions, plus
``reg.lambda`` times the item table's Frobenius norm over its rows.

The random draws replay the port's order from one generator seeded as the
program's step generator: for each step the negatives
(``NEG_ROUNDS`` candidate sets of shape (B, L) drawn at once, each later
set taken where the current candidate lies in the row's window), then the
dropout keep masks: the embedding's, then each block's attention weights'
and feed-forward output's.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.train import precision, replay

NEG_ROUNDS = 4
LN_EPS = 1e-8


def _args(conf):
    a = conf.get("SASRec", {})
    return int(a.get("n_blocks", 2)), int(a.get("n_heads", 1)), float(a.get("drop_rate", 0.2))


def windows(inputs, max_len: int):
    """(train_seq, train_pos, train_y, test_seq, test_pos, test_len) int64."""
    lens, items = inputs["lengths"], inputs["items"]
    n = len(lens)
    tr = np.zeros((3, n, max_len), dtype=np.int64)
    te = np.zeros((2, n, max_len), dtype=np.int64)
    te_len = np.zeros(n, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for r in range(n):
        s = items[starts[r]:starts[r] + lens[r]]
        w = s[-max_len:]
        m = len(w) - 1
        tr[0, r, :m], tr[2, r, :m], tr[1, r, :m] = w[:-1], w[1:], np.arange(1, m + 1)
        te[0, r, :len(w)], te[1, r, :len(w)] = w, np.arange(1, len(w) + 1)
        te_len[r] = len(w)
    return tr[0], tr[1], tr[2], te[0], te[1], te_len


def make_params(seed: int, inputs, conf, device) -> Dict[str, torch.Tensor]:
    """The encoder's leaves, under the port's names, from one uniform draw
    of a generator on ``device`` seeded with ``seed``: tables and the
    packed attention in-projection xavier-uniform, the other linear layers
    torch's default U(-1/sqrt(D), 1/sqrt(D)), attention biases 0,
    LayerNorms 1 and 0."""
    d, max_len = int(conf["embedding.size"]), int(conf["max.len"])
    n_blocks = _args(conf)[0]
    vocab = inputs["n_items"] + 1
    lin = 1.0 / math.sqrt(d)
    shapes = [("item_emb", (vocab, d), math.sqrt(6.0 / (vocab + d))),
              ("pos_emb", (max_len + 1, d), math.sqrt(6.0 / (max_len + 1 + d)))]
    for b in range(n_blocks):
        p = f"blocks.{b}"
        shapes += [(f"{p}.attn.w_in", (d, 3 * d), math.sqrt(6.0 / (4 * d))),
                   (f"{p}.attn.out.w", (d, d), lin),
                   (f"{p}.ff1.w", (d, d), lin), (f"{p}.ff1.b", (d,), lin),
                   (f"{p}.ff2.w", (d, d), lin), (f"{p}.ff2.b", (d,), lin)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(sum(math.prod(s) for _, s, _ in shapes), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, bound in shapes:
        n = math.prod(shape)
        out[name] = (u[at:at + n].view(shape) * (2 * bound) - bound).contiguous()
        at += n
    ones, zeros = (lambda: torch.ones(d, device=device)), (lambda: torch.zeros(d, device=device))
    for b in range(n_blocks):
        p = f"blocks.{b}"
        out.update({f"{p}.attn_ln.scale": ones(), f"{p}.attn_ln.bias": zeros(),
                    f"{p}.attn.b_in": torch.zeros(3 * d, device=device),
                    f"{p}.attn.out.b": zeros(),
                    f"{p}.fwd_ln.scale": ones(), f"{p}.fwd_ln.bias": zeros()})
    out.update({"last_ln.scale": ones(), "last_ln.bias": zeros()})
    return out


def _ln(x, p, name):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p[f"{name}.scale"] + p[f"{name}.bias"]


def _drop(x, keep, rate):
    return x if keep is None else torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def encode(p, seq, pos, conf, keep=None):
    n_blocks, n_heads, rate = _args(conf)
    b, length = seq.shape
    d = p["item_emb"].shape[1]
    keep = keep or [None] * (2 * n_blocks + 1)
    x = p["item_emb"][seq] * math.sqrt(d) + p["pos_emb"][pos]
    x = _drop(x, keep[0], rate)
    pad = (seq != 0)[..., None].to(x.dtype)
    x = x * pad
    causal = torch.tril(torch.ones((length, length), dtype=torch.bool, device=seq.device))
    dh = d // n_heads
    for i in range(n_blocks):
        pre = f"blocks.{i}"
        q = _ln(x, p, f"{pre}.attn_ln")
        w, bias = p[f"{pre}.attn.w_in"], p[f"{pre}.attn.b_in"]

        def heads(t, j):
            return (t @ w[:, j * d:(j + 1) * d] + bias[j * d:(j + 1) * d]).view(
                b, length, n_heads, dh).transpose(1, 2)

        att = heads(q, 0) @ heads(x, 1).transpose(-1, -2) / math.sqrt(dh)
        att = torch.softmax(att.masked_fill(~causal, -float("inf")), dim=-1)
        att = _drop(att, keep[1 + 2 * i], rate)
        a = (att @ heads(x, 2)).transpose(1, 2).reshape(b, length, d)
        a = a @ p[f"{pre}.attn.out.w"] + p[f"{pre}.attn.out.b"]
        x = _ln(q + a, p, f"{pre}.fwd_ln")
        h = torch.relu(x @ p[f"{pre}.ff1.w"] + p[f"{pre}.ff1.b"])
        h = _drop(h @ p[f"{pre}.ff2.w"] + p[f"{pre}.ff2.b"], keep[2 + 2 * i], rate)
        x = (x + h) * pad
    return _ln(x, p, "last_ln")


def draws(gen, seq, n_items: int, conf, device):
    """One step's negatives and keep masks, in the order the port draws them."""
    n_blocks, n_heads, rate = _args(conf)
    b, length = seq.shape
    d = int(conf["embedding.size"])
    cand = torch.randint(1, n_items + 1, (NEG_ROUNDS, b, length), generator=gen, device=device)
    neg = cand[0]
    for r in range(1, NEG_ROUNDS):
        in_window = (neg[:, :, None] == seq[:, None, :]).any(-1)
        neg = torch.where(in_window, cand[r], neg)
    neg = torch.where(seq != 0, neg, torch.zeros_like(neg))
    keep = [torch.rand((b, length, d), generator=gen, device=device) < 1.0 - rate]
    for _ in range(n_blocks):
        keep.append(torch.rand((b, n_heads, length, length), generator=gen, device=device)
                    < 1.0 - rate)
        keep.append(torch.rand((b, length, d), generator=gen, device=device) < 1.0 - rate)
    return neg, keep


def loss(p, seq, pos, y, neg, valid, keep, conf):
    h = encode(p, seq, pos, conf, keep)
    item = p["item_emb"]
    pos_l = (h * item[y]).sum(-1)
    neg_l = (h * item[neg]).sum(-1)
    v = valid.to(h.dtype)
    denom = torch.clamp(v.sum(), min=1.0)
    rec = (F.softplus(-pos_l) * v).sum() / denom + (F.softplus(neg_l) * v).sum() / denom
    return rec + float(conf["reg.lambda"]) * torch.linalg.norm(item) / item.shape[0]


def train_readings(inputs, params0, batches, draw_seed: int, conf, device, n_steps: int,
                   half_batch: bool = False, tf32: bool = False):
    """The reference's first ``n_steps`` steps over the program's batches
    (``batches``: row-index tensors into the training windows, one a step,
    every row a real sequence). ``half_batch`` plants the fault that leaves
    out the second half of every batch; ``tf32`` computes in TF32."""
    seq, pos, y = (torch.as_tensor(a, device=device)
                   for a in windows(inputs, int(conf["max.len"]))[:3])
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed)

    def step_loss(p, step):
        rows = batches[step]
        s, ps, yy = seq[rows], pos[rows], y[rows]
        neg, keep = draws(gen, s, inputs["n_items"], conf, device)
        valid = ps != 0
        if half_batch:
            valid[rows.shape[0] // 2:] = False
        return loss(p, s, ps, yy, neg, valid, keep, conf)

    with precision(tf32):
        return replay(params0, step_loss, n_steps, float(conf["learning.rate"]))


class Scorer:
    """The reference's eval state: the last-position encoding of every test
    window under ``params0`` and the scores of the whole vocabulary, pad
    id included (SELFRec's sequential eval masks nothing)."""

    def __init__(self, inputs, params0, conf, device, tf32: bool = False, block: int = 1024):
        seq, pos, length = (torch.as_tensor(a, device=device)
                            for a in windows(inputs, int(conf["max.len"]))[3:])
        self.tf32 = tf32
        with torch.no_grad(), precision(tf32):
            last = []
            for lo in range(0, seq.shape[0], block):
                h = encode(params0, seq[lo:lo + block], pos[lo:lo + block], conf)
                idx = (length[lo:lo + block] - 1)[:, None, None].expand(-1, 1, h.shape[-1])
                last.append(torch.gather(h, 1, idx)[:, 0])
        self.last = torch.cat(last)
        self.item_emb = params0["item_emb"]
        self.n_items = inputs["n_items"]
        self.k = max(int(n) for n in conf["item.ranking.topN"])
        self.truth = [[int(t)] for t in inputs["test"]]

    def scores(self, lo: int, hi: int) -> torch.Tensor:
        with torch.no_grad(), precision(self.tf32):
            return self.last[lo:hi] @ self.item_emb.T


def step_flops(inputs, conf) -> float:
    """A training step's model FLOPs: each block's six D×D projections
    (query, key, value, output, two feed-forward) and its two L×L
    attention products, the next-item and negative logits, forward and
    backward (three times the forward); lookups count nothing."""
    n_blocks = _args(conf)[0]
    d, b, length = int(conf["embedding.size"]), int(conf["batch.size"]), int(conf["max.len"])
    block = 6 * 2 * b * length * d * d + 2 * 2 * b * length * length * d
    logits = 2 * 2 * b * length * d
    return float(3 * (n_blocks * block + logits))
