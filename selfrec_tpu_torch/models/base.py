"""Recommender runtime (counterpart of ``selfrec_tpu/models/base.py``).

Same template-method pipeline as the reference ``Recommender.execute()``
(reference/base/recommender.py:73-83: initializing_log →
print_model_info → build → train → test → evaluate) and the same
best-by-majority-vote ``fast_evaluation`` bookkeeping
(base/graph_recommender.py:81-104). The JAX package runs an epoch as one
jitted ``lax.scan``; here it is a Python loop over batches, each step in the
order of base.py:502-535: sample negatives, loss and grads, Adam step,
``step_update``. The sequential trainer (base.py:698-944) loops the same
way over padded sequence batches. Everything runs on one explicit
``device``.

``checkpoint.dir`` / ``checkpoint.interval`` (resume and periodic saves,
:mod:`selfrec_tpu_torch.utils.checkpoint`) and ``profile.dir`` (a
``torch.profiler`` trace of one epoch) act as in the JAX package
(base.py:624-690); the sequential trainer, like the JAX package's, has no
profiler hook.

``mesh: {data: D, model: M}`` and ``distributed: true`` run the trainers
over a (data, model) mesh of one process per device
(:mod:`selfrec_tpu_torch.parallel`). Each rank keeps its row block of the
row-sharded params (:func:`~selfrec_tpu_torch.parallel.mesh.shard_params`)
and the sharded adjacency's slice; every rank gathers the params over
``model`` and computes the same loss, the propagations run sharded, and the
gradients are averaged over the replicas before Adam, so that they stay
bit-identical.
"""

from __future__ import annotations

import os
from os.path import abspath
from time import localtime, strftime, time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from selfrec_tpu_torch.data import io
from selfrec_tpu_torch.data.interaction import Interaction
from selfrec_tpu_torch.data.sequence import Sequence
from selfrec_tpu_torch.device import resolve_device
from selfrec_tpu_torch.ops import ranking, sampling, seq_sampling
from selfrec_tpu_torch.ops.init import xavier_uniform
from selfrec_tpu_torch.ops.precision import set_compute_dtype
from selfrec_tpu_torch.parallel import distributed
from selfrec_tpu_torch.parallel import mesh as mesh_lib
from selfrec_tpu_torch.utils import metrics
from selfrec_tpu_torch.utils.logger import Log


class Recommender:
    """Base recommender: config parsing + run pipeline.

    Common hyperparameters mirror reference base/recommender.py:15-21.
    """

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        self.config = conf
        device = resolve_device(device)
        distributed.maybe_initialize(conf, device)
        self.device = distributed.rank_device(device)
        self.model_name = conf["model"]["name"]
        self.ranking_topns = conf["item.ranking.topN"]
        self.emb_size = int(conf["embedding.size"])
        self.max_epoch = int(conf["max.epoch"])
        self.batch_size = int(conf["batch.size"])
        self.lrate = float(conf["learning.rate"])
        self.reg = float(conf["reg.lambda"])
        self.output = conf["output"]
        self.seed = int(conf.get("seed", 0))

        current_time = strftime("%Y-%m-%d %H-%M-%S", localtime(time()))
        self.model_log = Log(self.model_name, f"{self.model_name} {current_time}")
        self.result = []
        self.rec_output = []

    def initializing_log(self):
        self.model_log.add("### model configuration ###")
        for k, v in self.config.config.items():
            self.model_log.add(f"{k}={v}")

    def print_model_info(self):
        print("Model:", self.model_name)
        if self.config.contain("training.set"):
            print("Training Set:", abspath(self.config["training.set"]))
        if self.config.contain("test.set"):
            print("Test Set:", abspath(self.config["test.set"]))
        print("Device:", self.device)
        print("Embedding Dimension:", self.emb_size)
        print("Maximum Epoch:", self.max_epoch)
        print("Learning Rate:", self.lrate)
        print("Batch Size:", self.batch_size)
        print("Regularization Parameter:", self.reg)
        if self.config.contain(self.model_name):
            args = self.config[self.model_name]
            par_str = "  ".join(f"{k}:{v}" for k, v in args.items())
            print("Specific parameters:", par_str)

    # template methods ------------------------------------------------------
    def build(self):
        pass

    def train(self):
        pass

    def test(self):
        pass

    def save(self):
        pass

    def load(self):
        pass

    def evaluate(self, rec_list):
        pass

    def execute(self):
        self.initializing_log()
        self.print_model_info()
        print("Initializing and building model...")
        self.build()
        print("Training Model...")
        self.train()
        print("Testing...")
        rec_list = self.test()
        print("Evaluating...")
        self.evaluate(rec_list)
        return rec_list


class _FastEvalMixin:
    """Shared fast_evaluation: per-epoch eval at max_N, keep best by
    majority-of-metrics vote, save() on improvement (reference
    base/graph_recommender.py:81-104)."""

    def _fast_measure(self):
        rec_list = self.test()
        return metrics.ranking_evaluation(
            self.data.test_set, rec_list, [self.max_N])

    def fast_evaluation(self, epoch: int):
        print("Evaluating the model...")
        measure = self._fast_measure()
        performance = metrics.parse_measure(measure)

        if self.best_performance:
            count = sum(
                1 if self.best_performance[1][k] > performance[k] else -1
                for k in performance
            )
            if count < 0:
                self.best_performance = [epoch + 1, performance]
                self.save()
        else:
            self.best_performance = [epoch + 1, performance]
            self.save()

        print("-" * 80)
        print(f"Real-Time Ranking Performance (Top-{self.max_N} Item Recommendation)")
        measure_str = ", ".join(f"{k}: {v}" for k, v in performance.items())
        print(f"*Current Performance*\nEpoch: {epoch + 1}, {measure_str}")
        bp = ", ".join(f"{k}: {v}" for k, v in self.best_performance[1].items())
        print(f"*Best Performance*\nEpoch: {self.best_performance[0]}, {bp}")
        print("-" * 80)
        return measure


class GraphRecommender(_FastEvalMixin, Recommender):
    """Graph (user-item) recommender base with blocked device evaluation."""

    eval_block_size = 1024

    def should_evaluate(self, epoch: int) -> bool:
        """fast_evaluation cadence. Reference default: EVERY epoch
        (e.g. SimGCL.py:40)."""
        return True

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        self.data = Interaction(conf, training_set, test_set)
        self.best_performance: list = []
        self.topN = [int(n) for n in self.ranking_topns]
        self.max_N = max(self.topN)
        self.user_emb: Optional[torch.Tensor] = None
        self.item_emb: Optional[torch.Tensor] = None
        self.best_user_emb = None
        self.best_item_emb = None

    def print_model_info(self):
        super().print_model_info()
        tr = self.data.training_size()
        te = self.data.test_size()
        print(
            f"Training Set Size: (user number: {tr[0]}, item number: {tr[1]}, interaction number: {tr[2]})"
        )
        print(
            f"Test Set Size: (user number: {te[0]}, item number: {te[1]}, interaction number: {te[2]})"
        )
        print("=" * 80)

    # evaluation ------------------------------------------------------------
    def current_embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.user_emb, self.item_emb

    def _sharded_topk_impl(self):
        """The per-shard top-k and merge when items split over a model axis
        of more than one rank (base.py:196-214); None otherwise, and when
        the items do not divide by the model size or a slice is shorter
        than max_N."""
        mesh = getattr(self, "mesh", None)
        if mesh is None or mesh.shape[mesh_lib.MODEL_AXIS] <= 1:
            return None
        n_items = self.data.item_num
        n_shards = mesh.shape[mesh_lib.MODEL_AXIS]
        if n_items % n_shards != 0 or self.max_N > n_items // n_shards:
            return None
        impl = getattr(self, "_sharded_topk_fn", None)
        if impl is None:
            from selfrec_tpu_torch.parallel.topk import make_sharded_topk

            impl = self._sharded_topk_fn = make_sharded_topk(mesh, n_items, self.max_N)
        return impl

    def test(self) -> Dict[str, list]:
        user_emb, item_emb = self.current_embeddings()
        return ranking.rec_list_from_embeddings(
            self.data, user_emb, item_emb, self.max_N,
            block_size=self.eval_block_size, topk_impl=self._sharded_topk_impl())

    def _fast_measure(self):
        """Id-array eval: device top-k -> vectorized metrics over int ids,
        exact-equal to the string path (base.py:226-244). The sharded top-k
        keeps the rec-list route, as in the JAX package."""
        if self._sharded_topk_impl() is not None:
            return super()._fast_measure()
        user_emb, item_emb = self.current_embeddings()
        if user_emb is None or item_emb is None:
            return super()._fast_measure()
        top_ids = ranking.topk_ids_from_embeddings(
            self.data, user_emb, item_emb, self.max_N,
            block_size=self.eval_block_size)
        offsets, items = self.data.test_gt_csr()
        return metrics.ranking_evaluation_ids(
            offsets, items, top_ids, [self.max_N], self.data.item_num,
            sorted_test_keys=self.data.test_gt_sorted_keys())

    def evaluate(self, rec_list):
        self.rec_output.append(
            "userId: recommendations in (itemId, ranking score) pairs, * means the item is hit.\n"
        )
        for user in self.data.test_set:
            line = user + ":" + "".join(
                f" ({item[0]},{item[1]}){'*' if item[0] in self.data.test_set[user] else ''}"
                for item in rec_list[user]
            )
            self.rec_output.append(line + "\n")
        current_time = strftime("%Y-%m-%d %H-%M-%S", localtime(time()))
        out_dir = self.output
        # one writer under a process group: every rank holds the same lists
        writes = distributed.is_main_process()
        file_name = f"{self.model_name}@{current_time}-top-{self.max_N}items.txt"
        if writes:
            io.write_file(out_dir, file_name, self.rec_output)
        print("The result has been output to ", abspath(out_dir), ".")
        file_name = f"{self.model_name}@{current_time}-performance.txt"
        self.result = metrics.ranking_evaluation(self.data.test_set, rec_list, self.topN)
        self.model_log.add("###Evaluation Results###")
        self.model_log.add(self.result)
        if writes:
            io.write_file(out_dir, file_name, self.result)
        print(f"The result of {self.model_name}:\n{''.join(self.result)}")


class _TrainStateMixin:
    """What both trainers share: the mesh, Adam over the flat params dict,
    the per-epoch host RNG, and checkpoint/resume (base.py:341-356,
    572-576, 624-646; the JAX package's sequential trainer borrows the
    graph trainer's hooks, base.py:808-809, 908, 925-927)."""

    mesh = None
    _sharded: frozenset = frozenset()  # params row-sharded over model

    def _build_mesh(self):
        """The (data, model) mesh of ``mesh: {data: D, model: M}``, or None
        (the single-device path) when the key is absent or the mesh has at
        most one device (base.py:341-356). A mesh above the world raises
        ``ValueError`` (:func:`~selfrec_tpu_torch.parallel.mesh.build_mesh`);
        so does a world larger than the mesh, whose extra processes would
        have nothing to do."""
        if not self.config.contain("mesh"):
            return None
        m = self.config["mesh"] or {}
        built = mesh_lib.build_mesh(int(m.get("data", 0)) or None,
                                    int(m.get("model", 0)) or None)
        if built.size <= 1:
            return None
        if built.rank is None or built.size != torch.distributed.get_world_size():
            raise ValueError(f"{built} does not cover the world of "
                             f"{torch.distributed.get_world_size()} processes; the "
                             "port runs one process per device of the mesh")
        return built

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The params as the model's code reads them: under a mesh the
        row-sharded leaves gathered over ``model``, differentiable (the
        backward keeps this rank's rows); ``self.params`` otherwise."""
        if not self._sharded:
            return self.params
        return {k: mesh_lib.gather_rows(v, self.mesh) if k in self._sharded else v
                for k, v in self.params.items()}

    def gather_leaves(self, tree: Dict[str, torch.Tensor], keys=None) -> Dict[str, torch.Tensor]:
        """Full copies, with no gradient, of a dict shaped like the params
        (``keys`` names its leaves in the params' terms when they differ)."""
        keys = list(tree) if keys is None else keys
        return {k: (mesh_lib.all_gather(v.detach(), self.mesh, mesh_lib.MODEL_AXIS)
                    if name in self._sharded and v.dim() == 2 else v)
                for (k, v), name in zip(tree.items(), keys)}

    def shard_leaves(self, tree: Dict[str, torch.Tensor], keys=None) -> Dict[str, torch.Tensor]:
        """The inverse of :meth:`gather_leaves`: this rank's row blocks."""
        keys = list(tree) if keys is None else keys
        return {k: (mesh_lib.row_block(v, self.mesh).clone()
                    if name in self._sharded and v.dim() == 2 else v)
                for (k, v), name in zip(tree.items(), keys)}

    def _optimizer_step(self):
        """Adam on this rank's params; under a mesh after averaging each
        gradient over the ranks that hold the same rows: the sharded leaves
        over ``data``, the replicated ones over the grid."""
        if self.mesh is not None:
            sharded = [k in self._sharded for k in self.params]
            grads = [p.grad for p in self.params.values()]
            mesh_lib.sync_replicas([g for g, sh in zip(grads, sharded) if sh], self.mesh,
                                   mesh_lib.DATA_AXIS)
            mesh_lib.sync_replicas([g for g, sh in zip(grads, sharded) if not sh],
                                   self.mesh, mesh_lib.GRID)
        self.optimizer.step()

    def make_optimizer(self, params: Dict[str, torch.Tensor]):
        return torch.optim.Adam(list(params.values()), lr=self.lrate,
                                betas=(0.9, 0.999), eps=1e-8)

    def epoch_rng(self, epoch: int, stream: int = 0) -> np.random.Generator:
        """Host RNG as a pure function of (seed, epoch, stream), the JAX
        package's (base.py:572-576): per-epoch draws such as SGL's keep
        masks and the sequential epoch's permutation are identical in both
        packages."""
        return np.random.default_rng((self.seed, epoch, stream))

    def set_params(self, params: Dict[str, torch.Tensor]):
        """Install the full ``params`` (copied to the device as trainable
        leaves; under a mesh this rank's row blocks of the row-sharded ones,
        base.py:445-449) and a fresh optimizer over them."""
        params = {k: v.detach().to(self.device, torch.float32) for k, v in params.items()}
        if self.mesh is not None:
            self._sharded = frozenset(k for k, v in params.items()
                                      if mesh_lib.splits_rows(v, self.mesh))
            params = mesh_lib.shard_params(params, self.mesh)
        self.params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        self.optimizer = self.make_optimizer(self.params)

    def _checkpoint_conf(self):
        ckpt_dir = self.config.get("checkpoint.dir")
        interval = int(self.config.get("checkpoint.interval", 5))
        return ckpt_dir, interval

    def _maybe_resume(self) -> int:
        """Restore the latest checkpoint under ``checkpoint.dir``, if any;
        returns the epoch to start from."""
        from selfrec_tpu_torch.utils import checkpoint as ckpt

        ckpt_dir, _ = self._checkpoint_conf()
        if not ckpt_dir:
            return 0
        step, state = ckpt.restore_checkpoint(ckpt_dir)
        if step is None:
            return 0
        ckpt.apply_train_state(self, state)
        print(f"Resumed from checkpoint step {step} in {ckpt_dir}")
        return step

    def _maybe_checkpoint(self, epoch: int):
        """Every rank gathers the state; rank 0 writes it."""
        from selfrec_tpu_torch.utils import checkpoint as ckpt

        ckpt_dir, interval = self._checkpoint_conf()
        if ckpt_dir and (epoch + 1) % interval == 0:
            state = ckpt.train_state(self)
            if distributed.is_main_process():
                ckpt.save_checkpoint(ckpt_dir, epoch + 1, state)
            if self.mesh is not None:
                torch.distributed.barrier()


class TorchGraphRecommender(_TrainStateMixin, GraphRecommender):
    """Shared training machinery for embedding-table graph models, on one
    device (the single-device counterpart of ``JAXGraphRecommender``).

    Subclasses implement:
      compute_embeddings(params) -> (user_emb, item_emb)
      batch_loss(params, batch, generator) -> scalar loss
    and may override ``init_params(generator)`` (default: the user and item
    embedding tables every ported model trains)
    ``params`` is a plain dict of tensors; ``torch.optim.Adam`` stands in
    for ``optax.adam`` (same defaults: betas (0.9, 0.999), eps 1e-8).
    """

    n_neg_rounds = 8
    n_negs = 1  # negatives per positive
    log_batch_interval = 100

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        if conf.contain("compute.dtype"):
            set_compute_dtype(conf["compute.dtype"])
        self._rated_items = self._rated_offsets = self._rated_bitmap = None
        self._n_search_steps = 1
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.optimizer = None
        self.aux: Dict[str, Any] = {}
        self._edges_dev = None
        self._trace = None  # the torch.profiler session profile.dir opened
        self.mesh = self._build_mesh()

    # -- subclass contract ---------------------------------------------------
    def init_params(self, generator) -> Dict[str, torch.Tensor]:
        """Xavier-uniform user and item tables, drawn from ``generator``
        (every reference graph model's init, e.g. reference MF.py:52-57)."""
        return {
            "user_emb": xavier_uniform(generator, (self.data.user_num, self.emb_size),
                                       device=self.device),
            "item_emb": xavier_uniform(generator, (self.data.item_num, self.emb_size),
                                       device=self.device),
        }

    def compute_embeddings(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def batch_loss(self, params, batch: Dict[str, torch.Tensor], generator):
        raise NotImplementedError

    def batch_loss_aux(self, params, batch: Dict[str, torch.Tensor], generator):
        """(loss, new_aux); default: plain batch_loss, aux unchanged."""
        return self.batch_loss(params, batch, generator), batch["aux"]

    def epoch_setup(self, epoch: int) -> Dict[str, Any]:
        return {}

    def step_update(self, params, aux, batch: Dict[str, torch.Tensor]):
        """Post-optimizer per-step aux update; default: aux unchanged.
        ``params`` are this rank's (row blocks under a mesh): an override
        that reads them gathers them with :meth:`gather_leaves`."""
        return aux

    def make_adj(self, scipy_norm_adj=None):
        """Device adjacency for the unified Laplacian (``data.norm_adj`` by
        default): the dense-bipartite block where ``SELFREC_TPU_DENSE`` and
        the budget allow it, else the ELL layout
        (:func:`selfrec_tpu_torch.ops.graph.norm_adj_from_scipy`). Under a
        mesh the dense block is sharded over the grid when its slice fits,
        else the ELL layout becomes a halo layout (base.py:358-384)."""
        from selfrec_tpu_torch.ops.graph import norm_adj_from_scipy

        mat = self.data.norm_adj if scipy_norm_adj is None else scipy_norm_adj
        if self.mesh is not None:
            sharded = self._try_sharded_dense(mat)
            if sharded is not None:
                return sharded
            return self.shard_adj(norm_adj_from_scipy(mat, device=self.device))
        return norm_adj_from_scipy(mat, self.data.user_num, device=self.device)

    def _try_sharded_dense(self, mat):
        """The ShardedDenseAdj when the matrix is symmetric-bipartite, the
        dense gate allows it (``SELFREC_TPU_DENSE``: ``0`` never, ``1``
        always, ``auto`` on CUDA) and one rank's slice fits the budget;
        None otherwise (base.py:386-411)."""
        from selfrec_tpu_torch.ops import spmm_dense
        from selfrec_tpu_torch.parallel import dense_shard

        dense_mode = os.environ.get("SELFREC_TPU_DENSE", "auto")
        if dense_mode == "0" or (dense_mode != "1" and self.device.type != "cuda"):
            return None
        n_users = self.data.user_num
        n_items = mat.shape[0] - n_users
        if (mat.shape[0] != mat.shape[1]
                or not dense_shard.fits_sharded_dense(n_users, n_items, self.mesh)):
            return None
        blocks = spmm_dense.bipartite_blocks(mat.tocoo(), n_users)
        if blocks is None:
            return None
        return dense_shard.build_sharded_dense(*blocks, n_users, n_items, self.mesh,
                                               device=self.device)

    def shard_adj(self, adj):
        """An adjacency placed on the mesh (base.py:413-441): a DenseAdj
        sharded over the grid, a DenseMat row-sharded over it, an EllAdj
        made a HaloAdj (with a model axis of one rank the data ranks split
        the virtual rows); a NormAdj, the edge-list fallback, is computed
        whole on every rank. The adjacency itself without a mesh."""
        if self.mesh is None:
            return adj
        from selfrec_tpu_torch.ops.spmm_dense import DenseAdj, DenseMat
        from selfrec_tpu_torch.ops.spmm_ell import EllAdj
        from selfrec_tpu_torch.parallel import dense_shard, halo

        if isinstance(adj, DenseAdj):
            return dense_shard.sharded_dense_from_dense(adj, self.mesh)
        if isinstance(adj, DenseMat):
            return dense_shard.shard_dense_mat(adj, self.mesh)
        if isinstance(adj, EllAdj):
            return halo.halo_from_ell(adj, self.mesh)
        return adj

    # -- machinery ------------------------------------------------------------
    def build(self):
        self.set_params(self.init_params(self.generator))
        # the rated CSR on the device, and the packed-bitmap sampler when
        # the (U, ceil(I/32)) uint32 bitmap fits SELFREC_TPU_NEG_BITMAP_MB
        # (base.py:453-471); else the CSR binary-search sampler
        self._rated_items = torch.as_tensor(self.data.rated_items, device=self.device)
        self._rated_offsets = torch.as_tensor(self.data.rated_offsets, device=self.device)
        max_deg = int(self.data.rated_counts().max()) if self.data.user_num else 1
        self._n_search_steps = max(1, int(np.ceil(np.log2(max_deg + 1))) + 1)
        self._rated_bitmap = None
        if self.data.user_num:
            words = (self.data.item_num + 31) // 32
            budget_mb = float(os.environ.get("SELFREC_TPU_NEG_BITMAP_MB", "512"))
            if self.data.user_num * words * 4 <= budget_mb * 1e6:
                self._rated_bitmap = sampling.bitmap_to_device(
                    sampling.pack_rated_bitmap(
                        self.data.rated_offsets, self.data.rated_items,
                        self.data.user_num, self.data.item_num), self.device)

    def sample_negatives(self, users: torch.Tensor) -> torch.Tensor:
        shape = (tuple(users.shape) if self.n_negs == 1
                 else (users.shape[0], self.n_negs))
        if self._rated_bitmap is not None:
            return sampling.sample_negatives_bitmap(
                self.generator, users, self._rated_bitmap, self.data.item_num,
                shape=shape, n_rounds=self.n_neg_rounds)
        return sampling.sample_negatives(
            self.generator, users, self._rated_items, self._rated_offsets,
            self.data.item_num, shape=shape, n_rounds=self.n_neg_rounds,
            n_search_steps=self._n_search_steps)

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step: negatives, loss and grads, Adam, step_update. Returns
        the loss (a device scalar, detached)."""
        neg = self.sample_negatives(batch["u"])
        full_batch = dict(batch, j=neg, aux=self.aux)
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.batch_loss_aux(self.full_params(), full_batch, self.generator)
        loss.backward()
        self._optimizer_step()
        with torch.no_grad():
            self.aux = self.step_update(self.params, aux, full_batch)
        return loss.detach()

    def train_batches(self, users, items, masks) -> torch.Tensor:
        """Run :meth:`train_step` over (n_batches, batch_size) tensors;
        returns the (n_batches,) losses on the device."""
        losses = [self.train_step({"u": u, "i": i, "mask": m})
                  for u, i, m in zip(users, items, masks)]
        return torch.stack(losses)

    def epoch_batches(self, epoch: int):
        """This epoch's shuffled batches, drawn on the device from a generator
        seeded as a pure function of (seed, epoch); with
        ``SELFREC_TPU_HOST_BATCHES=1`` shuffled on the host from
        :meth:`epoch_rng` and copied to the device, the JAX package's host
        path (base.py:583-592), whose batches they equal."""
        if os.environ.get("SELFREC_TPU_HOST_BATCHES") == "1":
            users, items, masks = sampling.epoch_pairwise_batches(
                self.epoch_rng(epoch), self.data.edge_users, self.data.edge_items,
                self.batch_size)
            return (torch.as_tensor(users, dtype=torch.int64, device=self.device),
                    torch.as_tensor(items, dtype=torch.int64, device=self.device),
                    torch.as_tensor(masks, device=self.device))
        if self._edges_dev is None:
            self._edges_dev = (
                torch.as_tensor(self.data.edge_users, device=self.device),
                torch.as_tensor(self.data.edge_items, device=self.device))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((self.seed ^ 0x5E1F) << 20) + epoch)
        return sampling.epoch_pairwise_batches_device(
            gen, *self._edges_dev, self.batch_size)

    def run_epoch(self, epoch: int) -> np.ndarray:
        users, items, masks = self.epoch_batches(epoch)
        self.aux = self.epoch_setup(epoch)
        return self.train_batches(users, items, masks).cpu().numpy()

    @torch.no_grad()
    def embeddings(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.compute_embeddings(self.full_params())

    # -- the profiler hook (base.py:648-666) ----------------------------------
    def _profiler_hook(self, epoch: int, start_epoch: int):
        """``torch.profiler`` trace of one steady-state epoch, the second of
        this process (the first pays the kernel builds and allocator
        warm-up), into ``profile.dir``: host activity, and the card's too
        when the model runs on one."""
        profile_dir = self.config.get("profile.dir")
        if not profile_dir:
            return
        if epoch == start_epoch + 1:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._trace = profile(activities=activities)
            self._trace.start()
            self._trace_epoch = epoch
        elif self._trace is not None:
            self._stop_trace(profile_dir)

    def _stop_trace(self, profile_dir):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._trace.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"{self.model_name}_epoch{self._trace_epoch + 1}"
                                         f"_{os.getpid()}.pt.trace.json")
        self._trace.export_chrome_trace(path)
        self._trace = None
        print(f"Profiler trace written to {path}")

    def train(self):
        """Resume, then per epoch: the profiler hook, the epoch, eval, and a
        checkpoint every ``checkpoint.interval`` epochs (base.py:668-690)."""
        start_epoch = self._maybe_resume()
        n_examples = self.data.n_edges
        for epoch in range(start_epoch, self.max_epoch):
            self._profiler_hook(epoch, start_epoch)
            t0 = time()
            losses = self.run_epoch(epoch)
            dt = time() - t0
            for n in range(0, len(losses), self.log_batch_interval):
                if n > 0:
                    print("training:", epoch + 1, "batch", n, "batch_loss:", float(losses[n]))
            print(
                f"epoch {epoch + 1}: {dt:.2f}s, {n_examples / max(dt, 1e-9):,.0f} examples/s"
            )
            self.user_emb, self.item_emb = self.embeddings()
            if self.should_evaluate(epoch):
                self.fast_evaluation(epoch)
            self._maybe_checkpoint(epoch)
        if self._trace is not None:
            self._stop_trace(self.config.get("profile.dir"))
        if self.best_user_emb is not None:
            self.user_emb, self.item_emb = self.best_user_emb, self.best_item_emb

    def save(self):
        """Snapshot the embeddings fast_evaluation just ranked: train() sets
        them from the current params right before evaluating, so this is the
        JAX package's recompute from params without a second propagation."""
        user_emb, item_emb = self.current_embeddings()
        self.best_user_emb = user_emb.clone()
        self.best_item_emb = item_emb.clone()


class SequentialRecommender(_FastEvalMixin, Recommender):
    """Sequential recommender base: padded-array data and blocked device
    eval (counterpart of base.py:698-790).

    Parity with reference base/seq_recommender.py:8-83: eval scores the
    LAST position of every training sequence against the whole vocabulary
    (no rated-item masking, SASRec.py:55-60), takes the top max_N, and
    filters pad and out-of-vocabulary ids AFTER the top-k
    (seq_recommender.py:47-50), so lists may be short; ``evaluate()``
    returns 0 (seq_recommender.py:57-58).
    """

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        self.data = Sequence(conf, training_set, test_set)
        self.max_len = int(conf["max.len"])
        self.best_performance: list = []
        self.topN = [int(n) for n in self.ranking_topns]
        self.max_N = max(self.topN)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self._test_dev = None  # the padded test windows on the device

    def print_model_info(self):
        super().print_model_info()
        print(
            f"Training Set Size: (sequence number: {self.data.raw_seq_num},"
            f" item number: {self.data.item_num})"
        )
        print("=" * 80)

    def predict_scores(self, params, seq, pos, seq_len) -> torch.Tensor:
        """(B, vocab) last-position scores; model-specific."""
        raise NotImplementedError

    def _test_windows(self):
        """The test windows in blocks of ``batch.size``, the last block
        padded with empty windows of length 1 (base.py:737-744), as int64
        on the device; built once."""
        if self._test_dev is None:
            seq, pos, seq_len = self.data.padded_test_arrays(self.max_len)
            n_pad = (-seq.shape[0]) % self.batch_size
            if n_pad:
                seq = np.concatenate([seq, np.zeros((n_pad, seq.shape[1]), seq.dtype)])
                pos = np.concatenate([pos, np.zeros((n_pad, pos.shape[1]), pos.dtype)])
                seq_len = np.concatenate([seq_len, np.ones(n_pad, seq_len.dtype)])
            self._test_dev = tuple(torch.as_tensor(a, dtype=torch.int64, device=self.device)
                                   for a in (seq, pos, seq_len))
        return self._test_dev

    @torch.no_grad()
    def top_items(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores, ids), each (sequences, max_N) on the device: every
        training sequence's next item ranked over the whole vocabulary, pad
        and mask ids included, one block of ``batch.size`` at a time
        (base.py:728-766)."""
        seq, pos, seq_len = self._test_windows()
        bs = self.batch_size
        params = self.full_params()
        tops = [ranking.topk_scores_unmasked(
                    self.predict_scores(params, seq[s:s + bs], pos[s:s + bs],
                                        seq_len[s:s + bs]), self.max_N)
                for s in range(0, seq.shape[0], bs)]
        n = len(self.data.original_seq)
        return torch.cat([t[0] for t in tops])[:n], torch.cat([t[1] for t in tops])[:n]

    def test(self) -> Dict[str, list]:
        """:meth:`top_items` as {sequence: [(item, score), ...]}, pad and
        out-of-vocabulary ids dropped (base.py:767-787)."""
        scores, ids = self.top_items()
        scores, ids = scores.double().cpu().numpy(), ids.cpu().numpy()
        n = ids.shape[0]
        # pad/oov ids are filtered AFTER top-k, so lists may be short
        # (reference quirk, base/seq_recommender.py:47-50)
        keep = (ids > 0) & (ids <= self.data.item_num)
        item_names = ranking._cached_names(
            self.data, "_item_names_arr", self.data.id2item, self.data.item_num + 1)
        name_rows = item_names[np.where(keep, ids, 0)].tolist()
        score_rows = scores.tolist()
        keep_rows = keep.tolist()
        rec_list: Dict[str, list] = {}
        for r in range(n):
            rec_list[self.data.original_seq[r][0]] = [
                (nm, sc) for nm, sc, kp in zip(name_rows[r], score_rows[r], keep_rows[r])
                if kp]
        return rec_list

    def evaluate(self, rec_list):
        return 0


class TorchSequentialRecommender(_TrainStateMixin, SequentialRecommender):
    """Training over padded sequence batches on one device (counterpart of
    ``JAXSequentialRecommender``, base.py:793-944).

    Subclasses implement:
      init_params(generator) -> params (flat dict of tensors)
      batch_loss(params, batch, generator, draws=None) -> scalar loss, with
        batch keys seq/pos/y/neg (B, max_len), seq_len and row_mask (B,);
        ``draws`` feeds the model's random draws (augmentations, dropout
        keep masks) in place of the generator's
      predict_scores(params, seq, pos, seq_len) -> (B, vocab)
    The padded arrays go to the device once; an epoch ships only its
    permutation. Each step gathers its batch on the device, draws the
    negatives and then the model's draws from the step generator, and
    takes one Adam step.
    """

    n_neg_rounds = 4
    log_batch_interval = 50

    def __init__(self, conf, training_set, test_set, device=None, **kwargs):
        super().__init__(conf, training_set, test_set, device=device, **kwargs)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self.optimizer = None
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self._train_arrays = self.data.padded_training_arrays(self.max_len)
        self._train_dev = None
        self.mesh = self._build_mesh()

    def init_params(self, generator) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def batch_loss(self, params, batch: Dict[str, torch.Tensor], generator, draws=None):
        raise NotImplementedError

    def build(self):
        self.set_params(self.init_params(self.generator))

    def epoch_batches(self, epoch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_batches, batch_size) row indices and row masks on the device:
        the permutation of ``epoch_rng(epoch)``, the last batch padded with
        row 0 and mask 0 (base.py:895-906)."""
        n = self._train_arrays[0].shape[0]
        perm = self.epoch_rng(epoch).permutation(n)
        bs = self.batch_size
        n_batches = -(-n // bs)
        pad = n_batches * bs - n
        idx = np.concatenate([perm, np.zeros(pad, dtype=perm.dtype)])
        row_mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        return (torch.as_tensor(idx.reshape(n_batches, bs), dtype=torch.int64,
                                device=self.device),
                torch.as_tensor(row_mask.reshape(n_batches, bs), device=self.device))

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step: negatives, loss and grads, Adam (base.py:844-855).
        Returns the loss (a device scalar, detached)."""
        neg = seq_sampling.sample_seq_negatives(
            self.generator, batch["seq"], self.data.item_num, self.n_neg_rounds)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.batch_loss(self.full_params(), dict(batch, neg=neg), self.generator)
        loss.backward()
        self._optimizer_step()
        return loss.detach()

    def train_batches(self, idx: torch.Tensor, row_masks: torch.Tensor) -> torch.Tensor:
        """:meth:`train_step` over the batches of rows ``idx`` gathered on
        the device; returns the (n_batches,) losses on the device."""
        if self._train_dev is None:
            self._train_dev = tuple(torch.as_tensor(a, dtype=torch.int64, device=self.device)
                                    for a in self._train_arrays)
        seq, pos, y, seq_len = self._train_dev
        return torch.stack([
            self.train_step({"seq": seq[i], "pos": pos[i], "y": y[i],
                             "seq_len": seq_len[i], "row_mask": m})
            for i, m in zip(idx, row_masks)])

    def run_epoch(self, epoch: int) -> np.ndarray:
        return self.train_batches(*self.epoch_batches(epoch)).cpu().numpy()

    def train(self):
        """Resume, then per epoch: the epoch, every 50th batch's loss, eval
        and a checkpoint every ``checkpoint.interval`` epochs; the best
        params at the end (base.py:929-941)."""
        start_epoch = self._maybe_resume()
        for epoch in range(start_epoch, self.max_epoch):
            losses = self.run_epoch(epoch)
            for b in range(0, len(losses), self.log_batch_interval):
                print("training:", epoch + 1, "batch", b, "rec_loss:", float(losses[b]))
            self.fast_evaluation(epoch)
            self._maybe_checkpoint(epoch)
        if self.best_params is not None:
            with torch.no_grad():
                for k, v in self.best_params.items():
                    self.params[k].copy_(v)

    def save(self):
        self.best_params = {k: v.detach().clone() for k, v in self.params.items()}
