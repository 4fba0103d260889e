"""The (data, model) device mesh over ``torch.distributed`` (counterpart of
``selfrec_tpu/parallel/mesh.py``).

The JAX package runs one controller over a global ``jax.sharding.Mesh``;
the port runs one process per device (SPMD). Rank ``r`` sits at grid
position ``(d, s) = divmod(r, model)``:

- ``data``: the ranks with the same ``s`` (one group per model shard);
- ``model``: the ranks with the same ``d`` (one group per data replica);
  embedding tables are row-sharded here, rank ``s`` holding row block ``s``.

Every rank runs the same trainer loop and draws the same numbers from the
same seeded generators. The collectives (:func:`psum`,
:func:`psum_scatter`, :func:`all_gather`, :func:`all_to_all`, all tiled on
the first dimension as ``jax.lax``'s are with ``tiled=True``) are the
identity over an axis of one rank. Under ``gloo``, which moves host memory,
a CUDA tensor is staged through the host and back (:func:`_transport`);
the kernels still run on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
GRID = "grid"  # every rank of the mesh, in rank order (d major, s minor)

_GROUPS: Dict[Tuple[int, ...], object] = {}


def _group(ranks: Tuple[int, ...]):
    """The process group of ``ranks``, made once. Every rank of the world
    must ask for the same groups in the same order (``dist.new_group`` is
    collective over the world), which :func:`build_mesh` does."""
    if ranks not in _GROUPS:
        if len(ranks) == dist.get_world_size():
            _GROUPS[ranks] = dist.group.WORLD
        else:
            _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """A (data, model) grid of ranks and this rank's place in it.

    ``rank`` is None for a rank of the world that lies outside the grid
    (a mesh smaller than the world). ``groups`` maps each axis and
    :data:`GRID` to this rank's process group (None without a process
    group); ``backend`` is the process group's (None without one)."""

    def __init__(self, n_data: int, n_model: int, rank: Optional[int] = 0,
                 groups: Optional[dict] = None, backend: Optional[str] = None):
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        self.size = n_data * n_model
        self.rank = rank
        self.groups = groups or {}
        self.backend = backend

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.shape[MODEL_AXIS])

    def axis_size(self, axis: str) -> int:
        return self.size if axis == GRID else self.shape[axis]

    def axis_index(self, axis: str) -> int:
        d, s = self.coords
        return {DATA_AXIS: d, MODEL_AXIS: s, GRID: self.rank}[axis]

    def __repr__(self):
        where = "outside" if self.rank is None else f"rank {self.rank} at {self.coords}"
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"{where}, backend={self.backend})")


def build_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the processes of the world (mesh.py:33-52):
    by default all on ``data``; a missing size takes what is left. The
    world is one process without a process group. Raises ``ValueError``
    when ``data * model`` exceeds the world, with the JAX package's
    message. Collective over the world: every rank calls it alike."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs more than {n} devices")
    size = n_data * n_model
    if not dist.is_initialized() or size == 0:
        return Mesh(n_data, n_model, 0 if size else None)
    rank = dist.get_rank()
    mine = {}
    for d in range(n_data):
        g = _group(tuple(d * n_model + s for s in range(n_model)))
        if rank // n_model == d and rank < size:
            mine[MODEL_AXIS] = g
    for s in range(n_model):
        g = _group(tuple(d * n_model + s for d in range(n_data)))
        if rank % n_model == s and rank < size:
            mine[DATA_AXIS] = g
    grid = _group(tuple(range(size)))
    if rank < size:
        mine[GRID] = grid
    return Mesh(n_data, n_model, rank if rank < size else None, mine,
                dist.get_backend())


# -- collectives over an axis ----------------------------------------------------

def _transport(mesh: Mesh, op, out: torch.Tensor, inp: Optional[torch.Tensor] = None,
               sums: bool = False):
    """Run ``op(out, inp)`` and return ``out``; ``sums`` says that ``op``
    adds (``all_reduce``, ``reduce_scatter``). Under ``gloo`` a CUDA tensor
    goes to the host and back (the backend moves host memory), and bf16,
    which gloo does not carry, goes as its bytes for the ops that only move
    data; a bf16 sum under ``gloo`` raises, since bytes cannot be added.
    ``nccl`` takes every tensor as it is."""
    gloo = mesh.backend == "gloo"
    if gloo and sums and out.dtype == torch.bfloat16:
        raise TypeError("a bf16 sum over gloo: gloo cannot add bf16; sum in float32")
    staged = gloo and out.is_cuda
    if inp is None:
        o = out.cpu() if staged else out
        op(o)
    else:
        o = torch.empty(out.shape, dtype=out.dtype) if staged else out
        i = inp.cpu() if staged else inp
        if gloo and o.dtype == torch.bfloat16:
            o, i = o.view(torch.uint8), i.view(torch.uint8)
        op(o, i)
        o = o.view(out.dtype)
    if staged:
        out.copy_(o)
    return out


_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis``, on every rank of it."""
    if mesh.axis_size(axis) == 1:
        return x
    group = mesh.groups[axis]
    return _transport(mesh, lambda o: dist.all_reduce(o, group=group), x.contiguous().clone(),
                      sums=True)


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, of which rank ``i`` of the axis keeps
    row block ``i`` (``lax.psum_scatter(..., tiled=True)``)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    group = mesh.groups[axis]
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _transport(mesh, lambda o, i: _reduce_scatter(o, i, group=group), out,
                      x.contiguous(), sums=True)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The row blocks of every rank of ``axis`` stacked in its order
    (``lax.all_gather(..., tiled=True)``)."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    group = mesh.groups[axis]
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return _transport(mesh, lambda o, i: _all_gather(o, i, group=group), out,
                      x.contiguous())


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Row block ``j`` of ``x`` goes to rank ``j`` of ``axis``; the blocks
    received are stacked in the senders' order (``lax.all_to_all`` tiled,
    split and concat on the first dimension)."""
    if mesh.axis_size(axis) == 1:
        return x
    group = mesh.groups[axis]
    return _transport(mesh, lambda o, i: dist.all_to_all_single(o, i, group=group),
                      torch.empty_like(x), x.contiguous())


# -- parameters: row blocks over ``model`` --------------------------------------

def splits_rows(x: torch.Tensor, mesh: Mesh) -> bool:
    """Whether ``x`` is row-sharded over ``model`` (mesh.py:87-107): a 2-D
    leaf whose rows divide by a model axis of more than one rank."""
    n = mesh.shape[MODEL_AXIS]
    return n > 1 and x.dim() == 2 and x.shape[0] % n == 0


def row_block(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's row block of ``x`` over ``axis``."""
    n = mesh.axis_size(axis)
    r = x.shape[0] // n
    i = mesh.axis_index(axis)
    return x[i * r:(i + 1) * r]


def place_first_dim(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``x`` over ``axis`` when its first dimension
    divides by the axis, else all of ``x`` (mesh.py:80-84)."""
    if x.dim() >= 1 and x.shape[0] % mesh.axis_size(axis) == 0:
        return row_block(x, mesh, axis)
    return x


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Each 2-D leaf placed over ``model`` (:func:`place_first_dim`: this
    rank's row block when the rows divide), the other leaves whole."""
    return {k: place_first_dim(v, mesh, MODEL_AXIS) if v.dim() == 2 else v
            for k, v in params.items()}


class _GatherRows(torch.autograd.Function):
    """All-gather of the row blocks over ``model``. Every rank computes the
    same loss from the gathered table, so the backward is "take my row
    block" of the cotangent, not a reduce-scatter sum, which would
    multiply the gradient by the model size."""

    @staticmethod
    def forward(ctx, block, mesh):
        ctx.mesh = mesh
        return all_gather(block, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return row_block(g, ctx.mesh).contiguous(), None


def gather_rows(block: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full table from this rank's row block, differentiable."""
    return _GatherRows.apply(block, mesh)


def sync_replicas(grads, mesh: Mesh, axis: str) -> None:
    """Average the tensors ``grads`` over ``axis`` in place, in one
    all-reduce, so that replicas that apply them stay bit-identical
    whatever order the card's atomics summed each rank's in."""
    grads = [g for g in grads if g is not None]
    n = mesh.axis_size(axis)
    if n == 1 or not grads:
        return
    flat = psum(torch.cat([g.reshape(-1) for g in grads]), mesh, axis) / n
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
