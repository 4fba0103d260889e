"""Transformer encoder of the sequential recommenders (counterpart of
``selfrec_tpu/ops/transformer.py``), as explicit tensor code.

The reference's torch encoders (reference/model/sequential/SASRec.py:63-114,
BERT4Rec.py:85-129), as the JAX package writes them: pre-LN blocks where
the attention QUERY is layer-normed but keys and values are the un-normed
input, the residual adds the normed query, a post-attention LayerNorm
then Linear->act->Linear->Dropout with a residual, the pad positions
zeroed after each block, a final LayerNorm (eps 1e-8, population
variance). SASRec: causal mask and relu; BERT4Rec: no mask and gelu in
its tanh form (``jax.nn.gelu``'s default). Not ``nn.MultiheadAttention``
or ``scaled_dot_product_attention``: the packed in-projection ``w_in`` is
stored (d, 3d) as the JAX package stores it, and the -inf mask, softmax
and dropout on the attention weights run in the JAX package's order.

The item table's lookups are ``F.embedding`` (no ``padding_idx``): its
backward sums each row's duplicates as sorted segments, where advanced
indexing's backward walks them one by one, and a batch of short sequences
repeats the pad row thousands of times. The position table's is a one-hot
product (:func:`position_rows`): on the card ``F.embedding``'s backward
summed its rows, each repeated about once a sequence, in an order that
changed from run to run, so two runs of one step differed in the last
bits; the product's sums run in a fixed order.

Params are one flat dict with the JAX tree's paths as dotted keys
(``blocks.0.attn.w_in``; :mod:`selfrec_tpu_torch.convert`). Dropout is
active only when a generator or fed keep masks are given: ``keep`` is the
list of ``2 * n_blocks + 1`` boolean masks in JAX's key order (the
embedding's, then each block's attention weights' and FFN output's).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from selfrec_tpu_torch.ops.init import torch_linear_params, xavier_uniform

LN_EPS = 1e-8  # reference LayerNorm eps (SASRec.py:80)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(x - mean) / sqrt(var + 1e-8) * scale + bias, population variance
    (transformer.py:30-36)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias


def _ln(params, name, x):
    return layer_norm(x, params[f"{name}.scale"], params[f"{name}.bias"])


def _linear(params, name, x):
    return x @ params[f"{name}.w"] + params[f"{name}.b"]


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``where(keep, x / (1 - rate), 0)`` (transformer.py:43-47), with the
    keep mask fed or drawn from ``generator``; identity when neither is
    given or ``rate`` is 0."""
    if rate <= 0.0 or (keep is None and generator is None):
        return x
    p = 1.0 - rate
    if keep is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < p
    return torch.where(keep, x / p, torch.zeros_like(x))


def n_blocks_of(params: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in params if k.endswith(".attn.w_in"))


def mha(params, prefix: str, q, kv, n_heads: int, causal: bool, drop_rate: float,
        generator=None, keep=None):
    """Multi-head attention, (B, L, D) in and out (transformer.py:61-78)."""
    b, l, d = q.shape
    dh = d // n_heads
    wq, wk, wv = torch.split(params[f"{prefix}.w_in"], d, dim=1)
    bq, bk, bv = torch.split(params[f"{prefix}.b_in"], d)

    def heads(x, w, bias):
        return (x @ w + bias).reshape(b, l, n_heads, dh).transpose(1, 2)

    qh, kh, vh = heads(q, wq, bq), heads(kv, wk, bk), heads(kv, wv, bv)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
    if causal:
        mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
        scores = torch.where(mask, scores, torch.full_like(scores, -float("inf")))
    attn = torch.softmax(scores, dim=-1)
    attn = dropout(attn, drop_rate, generator, keep)
    out = (attn @ vh).transpose(1, 2).reshape(b, l, d)
    return _linear(params, f"{prefix}.out", out)


def _ln_params(d, device):
    return {"scale": torch.ones((d,), device=device), "bias": torch.zeros((d,), device=device)}


def init_encoder_params(generator: torch.Generator, vocab_size: int, n_positions: int,
                        d: int, n_blocks: int, *, device) -> Dict[str, torch.Tensor]:
    """Item and position tables and each block's attention and FFN params,
    the JAX tree's keys in its order (transformer.py:81-107). The pad row
    of ``item_emb`` is drawn like the others and trained (no
    ``padding_idx``). The attention's in-projection is xavier on the packed
    (3d, d) weight stored transposed, its biases and the out-projection's
    bias zero (``init_mha_params``, :50-58)."""
    flat = {"item_emb": xavier_uniform(generator, (vocab_size, d), device=device),
            "pos_emb": xavier_uniform(generator, (n_positions, d), device=device)}
    for i in range(n_blocks):
        p = f"blocks.{i}"
        flat.update({f"{p}.attn_ln.{k}": v for k, v in _ln_params(d, device).items()})
        out = torch_linear_params(generator, d, d, device=device)
        flat.update({
            f"{p}.attn.w_in": xavier_uniform(generator, (3 * d, d), device=device).T.contiguous(),
            f"{p}.attn.b_in": torch.zeros((3 * d,), device=device),
            f"{p}.attn.out.w": out["w"],
            f"{p}.attn.out.b": torch.zeros((d,), device=device),
        })
        flat.update({f"{p}.fwd_ln.{k}": v for k, v in _ln_params(d, device).items()})
        for name in ("ff1", "ff2"):
            lin = torch_linear_params(generator, d, d, device=device)
            flat.update({f"{p}.{name}.w": lin["w"], f"{p}.{name}.b": lin["b"]})
    flat.update({f"last_ln.{k}": v for k, v in _ln_params(d, device).items()})
    return flat


def position_rows(pos: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[pos]`` as the product of ``pos``'s one-hot rows with the
    (max.len + 1 or + 2, D) position table: exact forward (one nonzero
    term a sum), and a backward that is a matrix product, whose sums run
    in a fixed order on the card."""
    ids = torch.arange(table.shape[0], device=pos.device)
    return (pos[..., None] == ids).to(table.dtype) @ table


def encode(params: Dict[str, torch.Tensor], seq: torch.Tensor, pos: torch.Tensor,
           n_heads: int, drop_rate: float, causal: bool, activation: str = "relu",
           generator: Optional[torch.Generator] = None,
           keep: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """(B, L) int ids -> (B, L, D) sequence embeddings (transformer.py:110-141)."""
    d = params["item_emb"].shape[1]
    n_blocks = n_blocks_of(params)
    keep = [None] * (2 * n_blocks + 1) if keep is None else keep
    x = (F.embedding(seq, params["item_emb"]) * math.sqrt(d)
         + position_rows(pos, params["pos_emb"]))
    x = dropout(x, drop_rate, generator, keep[0])
    timeline = (seq != 0)[..., None].to(x.dtype)
    x = x * timeline
    if activation == "relu":
        act = torch.relu
    else:
        def act(h):
            return F.gelu(h, approximate="tanh")
    for i in range(n_blocks):
        p = f"blocks.{i}"
        q = _ln(params, f"{p}.attn_ln", x)
        a = mha(params, f"{p}.attn", q, x, n_heads, causal, drop_rate, generator,
                keep[1 + 2 * i])
        x = _ln(params, f"{p}.fwd_ln", q + a)
        h = _linear(params, f"{p}.ff2", act(_linear(params, f"{p}.ff1", x)))
        h = dropout(h, drop_rate, generator, keep[2 + 2 * i])
        x = (x + h) * timeline
    return _ln(params, "last_ln", x)
