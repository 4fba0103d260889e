"""Port cases in gloo process groups of CPU processes.

:class:`DistGroup` starts ``world_size`` processes of this file, each a
rank of one gloo process group on the CPU, and keeps them for many cases:
:meth:`DistGroup.run` sends one case (a function of this file, by name,
with keyword arguments) to every rank and returns every rank's result.
Each case has its own timeout; a case that fails or times out takes the
group down, and the next case starts a new one. The ranks import the port
only, never JAX: the tests hold their results against the JAX package in
the pytest process.

Run as a script, this file is one rank: ``python _torch_dist_worker.py
RANK WORLD_SIZE PORT``, reading framed pickled cases on stdin and writing
framed pickled results on stdout (prints go to stderr).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import select
import socket
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def _write_frame(f, payload: bytes):
    f.write(struct.pack("<Q", len(payload)) + payload)
    f.flush()


def _read_exact(f, n):
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _read_frame(f):
    head = _read_exact(f, 8)
    if head is None:
        return None
    return _read_exact(f, struct.unpack("<Q", head)[0])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class DistGroup:
    """``world_size`` gloo ranks on the CPU, started at the first case."""

    def __init__(self, world_size: int, timeout: float = 120.0):
        self.n = world_size
        self.timeout = timeout
        self.procs = None
        self.logs = None

    def _start(self):
        env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([REPO, HERE, os.environ.get("PYTHONPATH", "")]))
        port = free_port()
        self.logs = [tempfile.TemporaryFile() for _ in range(self.n)]
        self.procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                                        str(self.n), str(port)],
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                       stderr=self.logs[r], env=env, cwd=REPO)
                      for r in range(self.n)]

    def _log_tail(self, r, n_bytes=3000) -> str:
        f = self.logs[r]
        f.seek(0, 2)
        f.seek(max(0, f.tell() - n_bytes))
        return f.read().decode(errors="replace")

    def close(self):
        if self.procs is None:
            return
        for p in self.procs:
            with contextlib.suppress(Exception):
                p.stdin.close()
        deadline = time.time() + 5
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()
        self.procs = None

    def run(self, case: str, timeout: float = None, **kwargs):
        """Every rank's result of ``case(**kwargs)``, in rank order."""
        if self.procs is None:
            self._start()
        msg = pickle.dumps((case, kwargs))
        for p in self.procs:
            _write_frame(p.stdin, msg)
        results = {}
        deadline = time.time() + (timeout or self.timeout)
        fds = {p.stdout.fileno(): r for r, p in enumerate(self.procs)}
        try:
            while len(results) < self.n:
                left = deadline - time.time()
                ready, _, _ = select.select(list(set(fds) - {self.procs[r].stdout.fileno()
                                                             for r in results}), [], [],
                                            max(left, 0))
                if not ready:
                    raise TimeoutError(f"case {case} timed out after "
                                       f"{timeout or self.timeout} s; rank 0 log:\n"
                                       + self._log_tail(0))
                for fd in ready:
                    r = fds[fd]
                    frame = _read_frame(self.procs[r].stdout)
                    if frame is None:
                        raise RuntimeError(f"rank {r} ended during case {case}:\n"
                                           + self._log_tail(r))
                    ok, value = pickle.loads(frame)
                    if not ok:
                        raise RuntimeError(f"rank {r} failed case {case}:\n{value}")
                    results[r] = value
        except BaseException:
            self.close()
            raise
        return [results[r] for r in range(self.n)]


# -- the cases (run inside the ranks) ------------------------------------------------

@contextlib.contextmanager
def _env(env):
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mesh(shape):
    from selfrec_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(*shape)


class _Counter:
    """Counts the calls of a module-level function while it is patched."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = 0

    def __enter__(self):
        def counted(*a, **k):
            self.calls += 1
            return self.fn(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def case_collectives(shape):
    """psum, psum_scatter, all_gather and all_to_all over each axis, and
    whether a bf16 psum and psum_scatter raise."""
    import torch

    from selfrec_tpu_torch.parallel import mesh as m

    mesh = _mesh(shape)
    if mesh.rank is None:
        return None
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) * (mesh.rank + 1)
    out = {}
    for axis in (m.DATA_AXIS, m.MODEL_AXIS, m.GRID):
        n = mesh.axis_size(axis)
        rows = 2 * n
        y = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3) + 100 * mesh.rank
        out[axis] = {"psum": m.psum(x, mesh, axis).numpy(),
                     "psum_scatter": m.psum_scatter(y, mesh, axis).numpy(),
                     "all_gather": m.all_gather(x, mesh, axis).numpy(),
                     "all_to_all": m.all_to_all(y, mesh, axis).numpy(),
                     "all_gather_bf16": m.all_gather(x.to(torch.bfloat16), mesh,
                                                     axis).float().numpy()}
        raised = []
        for total in (m.psum, m.psum_scatter):
            try:
                total(y.to(torch.bfloat16), mesh, axis)
                raised.append(False)
            except TypeError:
                raised.append(True)
        out[axis]["bf16_sums_raise"] = raised
    return {"rank": mesh.rank, "coords": mesh.coords, "out": out}


def case_halo(shape, src, dst, w, n_rows, n_cols, x, g, k=4, w_stack=None,
              compute_dtype=None):
    """The halo layer's forward and x-gradient (packed when ``w_stack``
    is given), and K2's calls a rank a direction."""
    import torch

    from selfrec_tpu_torch.ops import precision
    from selfrec_tpu_torch.parallel import halo

    mesh = _mesh(shape)
    if mesh.rank is None:
        return None
    precision.set_compute_dtype(compute_dtype)
    try:
        adj = halo.build_halo_adj(src, dst, w, n_rows, n_cols, mesh, k=k, device="cpu")
        xt = torch.tensor(x, requires_grad=True)
        with _Counter(halo, "ell_gather_sum") as fwd:
            if w_stack is None:
                out = halo.halo_spmm(adj, xt)
            else:
                out = halo.halo_spmm_packed(adj, torch.tensor(w_stack), xt, len(w_stack))
        with _Counter(halo, "ell_gather_sum") as bwd:
            (out * torch.tensor(g)).sum().backward()
    finally:
        precision.set_compute_dtype(None)
    return {"out": out.detach().numpy(), "grad": xt.grad.numpy(),
            "k2_fwd": fwd.calls, "k2_bwd": bwd.calls,
            "comm": adj.comm_bytes(x.shape[1])}


def case_halo_views(shape, src, dst, w, n_rows, x, keep, rate):
    """A HaloAdj rebuilt from an EllAdj, reweighted and dropped."""
    import torch

    from selfrec_tpu_torch.ops import graph
    from selfrec_tpu_torch.ops.spmm_ell import ell_adj_from_edges
    from selfrec_tpu_torch.parallel import halo

    mesh = _mesh(shape)
    if mesh.rank is None:
        return None
    ell = ell_adj_from_edges(src, dst, w, n_rows=n_rows, k=4, device="cpu")
    adj = halo.halo_from_ell(ell, mesh)
    xt = torch.tensor(x)
    view = graph.adj_dropout(adj, torch.tensor(rate), keep=torch.tensor(keep))
    return {"from_ell": graph.spmm(adj, xt).numpy(),
            "ell": graph.spmm(ell, xt).numpy(),
            "dropped": graph.spmm(view, xt).numpy(),
            "dropped_ell": graph.spmm(graph.adj_dropout(ell, torch.tensor(rate),
                                                        keep=torch.tensor(keep)), xt).numpy(),
            "supports_packed": graph.supports_packed(adj)}


def case_dense(shape, eu, ei, w, n_users, n_items, x, g, dtype, keep=None, w2=None):
    """The sharded dense layer's forward and x-gradient in one matmul mode,
    each rank's local operands, its K1 calls a propagation, and the views."""
    import torch

    from selfrec_tpu_torch.ops import dense_dual
    from selfrec_tpu_torch.parallel import dense_shard as ds

    mesh = _mesh(shape)
    if mesh.rank is None:
        return None
    with _env({"SELFREC_TPU_DENSE_DTYPE": dtype}):
        adj = ds.build_sharded_dense(eu, ei, w, n_users, n_items, mesh, device="cpu")
        xt = torch.tensor(x, requires_grad=True)
        with _Counter(dense_dual, "dual_matmul") as s8, \
                _Counter(dense_dual, "float_products") as fl:
            out = ds.sharded_dense_spmm(adj, xt)
        (out * torch.tensor(g)).sum().backward()
        xu_full, xi_loc = ds.local_operands(adj, torch.tensor(x))
        (zq, zs), (yq, ys) = ds.local_quantized(xu_full, xi_loc)
        res = {"out": out.detach().numpy(), "grad": xt.grad.numpy(),
               "factored": adj.factored, "b_dtype": str(adj.b.dtype),
               "mm_dtype": str(adj.mm_dtype), "k1_calls": s8.calls + fl.calls,
               "coords": mesh.coords, "zq": zq.numpy(), "zs": zs.numpy(),
               "yq": yq.numpy(), "ys": ys.numpy(), "b": adj.b.float().numpy(),
               "bt_is_transpose": adj.bt is None or bool(torch.equal(adj.bt, adj.b.T)),
               "comm": adj.comm_bytes(x.shape[1])}
        if keep is not None:
            view = adj.refactor_view(torch.tensor(keep))
            res["view"] = ds.sharded_dense_spmm(view, torch.tensor(x)).numpy()
            res["view_factored"] = view.factored and view.b.dtype == torch.int8
            res["view_mm_dtype"] = str(view.mm_dtype)
        if w2 is not None:
            rw = adj.reweight(torch.tensor(w2))
            res["reweight"] = ds.sharded_dense_spmm(rw, torch.tensor(x)).numpy()
            res["reweight_dtype"] = (str(rw.b.dtype), str(rw.mm_dtype))
    return res


def case_dense_mat(shape, a, x, g, dtype):
    """ShardedDenseMat's forward and x-gradient."""
    import torch

    from selfrec_tpu_torch.ops.spmm_dense import DenseMat
    from selfrec_tpu_torch.parallel import dense_shard as ds

    mesh = _mesh(shape)
    if mesh.rank is None:
        return None
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    dm = ds.shard_dense_mat(DenseMat(torch.tensor(a).to(dt)), mesh)
    xt = torch.tensor(x, requires_grad=True)
    out = ds.sharded_dense_mat_spmm(dm, xt)
    (out * torch.tensor(g)).sum().backward()
    return {"out": out.detach().numpy(), "grad": xt.grad.numpy(), "rows": dm.a.shape[0]}


def case_topk(shape, u_block, item_emb, rows, cols, k):
    import torch

    from selfrec_tpu_torch.parallel.topk import make_sharded_topk

    mesh = _mesh(shape)
    if mesh.rank is None:
        return None
    fn = make_sharded_topk(mesh, item_emb.shape[0], k)
    s, i = fn(torch.tensor(u_block), torch.tensor(item_emb), torch.tensor(rows),
              torch.tensor(cols))
    return {"scores": s.numpy(), "ids": i.numpy()}


def _make_model(conf, train, test, social=None):
    from selfrec_tpu_torch.config import ModelConf
    from selfrec_tpu_torch.models import get_model_class

    kw = {"social.data": social} if social is not None else {}
    return get_model_class(conf["model"]["name"])(ModelConf(dict(conf)), train, test,
                                                  device="cpu", **kw)


def _state(model):
    """Full params (gathered) and this rank's shards, as numpy."""
    full = model.gather_leaves({k: v.detach() for k, v in model.params.items()})
    return ({k: v.numpy().copy() for k, v in full.items()},
            {k: v.detach().numpy().copy() for k, v in model.params.items()})


def case_train(conf, train, test, epochs, social=None, env=None, attrs=None):
    """``epochs`` epochs of a model under ``conf``'s mesh (``attrs`` set on
    the model first): losses, full params, this rank's shards, the
    layouts, and the rec-list ids of ``test()`` after them."""
    with _env(env):
        model = _make_model(conf, train, test, social)
        for k, v in (attrs or {}).items():
            setattr(model, k, v)
        model.build()
        losses = [np.asarray(model.run_epoch(e)) for e in range(epochs)]
        full, shards = _state(model)
        res = {"losses": np.concatenate(losses), "params": full, "shards": shards,
               "coords": model.mesh.coords if model.mesh is not None else None,
               "adj": type(getattr(model, "adj", None)).__name__}
        for name in ("_view1", "_view_template", "_social_d1", "_social_template"):
            if getattr(model, name, None) is not None:
                res[name] = type(getattr(model, name)).__name__
        if hasattr(model, "H"):
            res["H"] = [type(h).__name__ for h in model.H]
        if conf["model"]["type"] == "graph":
            model.user_emb, model.item_emb = model.embeddings()
            res["sharded_topk"] = model._sharded_topk_impl() is not None
            res["rec"] = {u: [i for i, _ in r] for u, r in model.test().items()}
    return res


def case_resume(conf, train, test, ckpt_dir, full_epochs, first_epochs):
    """Continuous training against training to ``first_epochs``, a
    checkpoint, and a resumed run to ``full_epochs``."""
    runs = {}
    for name, epochs, ckpt in (("full", full_epochs, ckpt_dir + "_full"),
                               ("first", first_epochs, ckpt_dir),
                               ("resumed", full_epochs, ckpt_dir)):
        c = dict(conf, **{"max.epoch": epochs, "checkpoint.dir": ckpt,
                          "checkpoint.interval": 1})
        model = _make_model(c, train, test)
        model.build()
        model.train()
        runs[name] = _state(model)
    return {k: v[0] for k, v in runs.items()}


if __name__ == "__main__":
    import datetime

    import torch
    import torch.distributed as dist

    rank, world, port = map(int, sys.argv[1:4])
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    cases = {k: v for k, v in globals().items() if k.startswith("case_")}
    while True:
        frame = _read_frame(sys.stdin.buffer)
        if frame is None:
            break
        name, kwargs = pickle.loads(frame)
        try:
            result = (True, cases[name](**kwargs))
        except Exception:
            import traceback

            result = (False, traceback.format_exc())
        _write_frame(out, pickle.dumps(result))
    dist.destroy_process_group()
