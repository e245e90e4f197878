"""The transformer's training loop: optimizer, schedule, checkpoints
(counterpart of ``swiftmpi_tpu/models/trainer.py``).

* The optimizer is ``models/optim.py``: optax's clip + adamw/sgd +
  warmup-cosine arithmetic, its state in optax's pytree.
* :meth:`Trainer.step` runs eagerly: loss and grads by torch autograd,
  the update written into the parameters and the optimizer state in
  place (the JAX step donates them).  A ``mesh`` passes to the loss, so
  a ``seq`` or ``expert`` axis runs ring/Ulysses attention or
  expert-parallel MoE; ``data`` and ``model`` change no value on one
  card, and the trainer records the tensor-parallel specs
  (``param_specs``) without placing anything (ROADMAP A11d).
* :meth:`Trainer.run` consumes host batches, optionally through the
  port's ``PrefetchIterator`` with its CUDA transfer (``pipeline=K``),
  keeps a ``DispatchWindow`` and leaves the losses on the device.
* Checkpoints keep the JAX package's layout: ``leaf_i`` in JAX's flatten
  order of ``{"params", "opt_state", "step"}`` (bfloat16 leaves as the
  2-byte void arrays JAX's files hold), a ``treedef`` entry with JAX's
  ``repr(PyTreeDef)``, ``atomic_savez`` with CRCs, rotation and
  pruning; either package loads the other's file.

Across processes (``python -m swiftmpi_tpu_torch.launch -np N``) the
data axis spans them, as in the JAX trainer, whose ``step`` takes each
process's rows of the global batch
(``make_array_from_process_local_data``): :meth:`Trainer.step` takes this
process's local rows, computes its loss and grads, and sums the grads
and the loss over the processes in process order in one exchange
(``parallel.collectives.psum_many``: B5's cross-process form on the card,
gloo on the CPU), then divides by the process count: the global batch's
mean loss and grads, the same bits on every replica, so every replica
takes the same update.  Within a process the ``seq``, ``expert`` and
``stage`` axes stay ranks on the card (``cluster.mesh.Mesh``); an MoE
layer averages its densities over the processes too
(``parallel/moe.py``).  :meth:`Trainer.save` copies the leaves to the
host on every process and checks that the replicas agree, process 0
writes, and every process waits at a barrier; :meth:`Trainer.load` works
on every process.  ``run(pipeline=K)`` prefetches in one process only,
as in the JAX package.

The fault bus (``faults.step_event`` per consumed step), the throughput
meter (global tokens), ``obs.span("dispatch")``/``record_step``, a
serving publisher (params-only snapshots), the observe-only controller
and the numerics plane (on the summed grads) hook in as in the JAX
package, on every process.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from swiftmpi_tpu_torch import obs
from swiftmpi_tpu_torch.cluster import bootstrap
from swiftmpi_tpu_torch.cluster.bootstrap import process_count
from swiftmpi_tpu_torch.device import DeviceLike, resolve_device
from swiftmpi_tpu_torch.io.checkpoint import (atomic_savez, npz_path,
                                              prune_generations,
                                              rotate_before_write,
                                              verify_checkpoint)
from swiftmpi_tpu_torch.models.optim import Optimizer, apply_updates
from swiftmpi_tpu_torch.models.transformer import (TransformerConfig,
                                                   init_params, lm_loss,
                                                   param_shardings,
                                                   value_and_grad)
from swiftmpi_tpu_torch.parallel.collectives import host_agree, psum_many
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.utils import tree
from swiftmpi_tpu_torch.utils.logger import get_logger
from swiftmpi_tpu_torch.utils.pipeline import (DispatchWindow,
                                               resolve_dispatch_bound)
from swiftmpi_tpu_torch.utils.timers import Throughput

log = get_logger(__name__)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor       # int32 scalar on the device

    def tree(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "step": self.step}


def make_optimizer(name: str = "adamw", learning_rate: float = 3e-4,
                   warmup_steps: int = 100, decay_steps: int = 10_000,
                   weight_decay: float = 0.01,
                   grad_clip: float = 1.0) -> Optimizer:
    """Warmup-cosine schedule + global-norm clip around adamw/sgd."""
    return Optimizer(name, learning_rate, warmup_steps, decay_steps,
                     weight_decay, grad_clip)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A checkpoint leaf: bfloat16 as the 2-byte void array JAX's files
    hold (numpy has no bfloat16), anything else as it is."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def leaf_from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`leaf_to_numpy`, checked against ``dtype``: a
    2-byte void or ``ml_dtypes.bfloat16`` array is bfloat16 bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"checkpoint leaf of {a.dtype} is no bfloat16")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise ValueError(f"checkpoint leaf dtype {t.dtype} != model "
                         f"{dtype} (config mismatch?)")
    return t


def load_leaves(state: TrainState, arrays: Sequence[np.ndarray]) -> None:
    """Copy ``arrays`` into ``state``'s leaves, in flatten order, after
    checking their count, shapes and dtypes."""
    flat = tree.leaves(state.tree())
    if len(arrays) != len(flat):
        raise ValueError(f"checkpoint holds {len(arrays)} leaves, the model "
                         f"{len(flat)} (optimizer/config mismatch?)")
    for i, (have, want) in enumerate(zip(arrays, flat)):
        if tuple(have.shape) != tuple(want.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape {have.shape} != "
                f"model {tuple(want.shape)} (config mismatch?)")
    with torch.no_grad():
        for a, want in zip(arrays, flat):
            want.copy_(leaf_from_numpy(a, want.dtype))


class Trainer:
    """Owns the config, the optimizer and the step.  ``mesh`` (a
    :class:`~swiftmpi_tpu_torch.cluster.mesh.Mesh`) names the axes the
    loss runs over and the device; without one, ``device`` (the current
    CUDA card unless ``"cpu"``).  Tokens fed to :meth:`step` are ``(B,
    S)`` integers, ``B`` a multiple of a ``data`` axis's size."""

    def __init__(self, cfg: TransformerConfig, mesh=None,
                 optimizer: str = "adamw", aux_weight: float = 0.01,
                 device: DeviceLike = None, **opt_kwargs):
        # the launcher's process group first (a no-op in one process), as
        # Cluster.initialize joins it for the table models
        bootstrap.init_distributed()
        #: the data axis across processes: their count and this one's
        #: place (1 and 0 in a run of one process)
        self.dp = process_count()
        self.dp_rank = bootstrap.process_index()
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} != the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.optimizer = make_optimizer(optimizer, **opt_kwargs)
        self.aux_weight = aux_weight
        #: tensor-parallel specs of the params (``param_shardings``),
        #: recorded at ``init_state`` under a mesh
        self.param_specs = None
        # consumed steps for the fault bus: with the pipeline on, batches
        # rendered ahead do not advance it
        self._host_steps = 0
        self.meter = Throughput()
        self.pipeline_stats: dict = {}
        # serving plane: a serve.SnapshotPublisher here publishes a
        # params-only snapshot every K steps
        self.serve_publisher = None
        # control plane: an observe-only control.Controller (dense params
        # have no placement knobs) ticks once a step
        self.controller = None
        self._numerics = None

    # -- state ------------------------------------------------------------
    def init_state(self, key=0) -> TrainState:
        """Fresh params from ``key`` (a seed or a CPU ``torch.Generator``),
        the optimizer's zero state and step 0."""
        params = init_params(key, self.cfg, self.device)
        if self.mesh is not None:
            self.param_specs = param_shardings(params, self.cfg, self.mesh)
        return TrainState(params, self.optimizer.init(params),
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device))

    # -- numerics health plane (obs/numerics.py) --------------------------
    def arm_numerics(self, collector) -> None:
        """``collector`` (a ``NumericsCollector``) receives one dense
        bundle a step; None disarms."""
        self._numerics = collector

    # -- the step ---------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor) and tokens.device == self.device:
            t = tokens
        else:
            # a host batch: its copy to the device is host stall, the
            # transfer run(pipeline=K) does on its producer instead
            with self.meter.stalling():
                t = torch.as_tensor(np.asarray(tokens)).to(self.device)
        if self.mesh is not None and "data" in self.mesh.axis_names:
            dp = self.mesh.shape["data"]
            if t.shape[0] % dp:
                raise ValueError(f"batch {t.shape[0]} does not split over "
                                 f"the data axis's {dp} ranks")
        return t

    def _reduce(self, loss: torch.Tensor, grads):
        """The global batch's loss and grads from this process's: every
        process's summed in process order in one exchange (the loss rides
        with the grads), then divided by the process count."""
        flat = tree.leaves(grads)
        got = psum_many([loss.reshape(1)] + flat)
        with torch.no_grad():
            for g in got:
                g.div_(self.dp)
        return got[0].reshape(()), tree.unflatten(grads, got[1:])

    def step(self, state: TrainState, tokens) -> Tuple[TrainState,
                                                       torch.Tensor]:
        """One step over ``tokens``: the whole batch in one process, this
        process's local rows of the global batch across processes (JAX's
        ``make_array_from_process_local_data``).  Returns the new state
        and the global batch's loss, the same on every process."""
        faults.step_event(self._host_steps)
        self._host_steps += 1
        tokens = self._tokens(tokens)
        with obs.span("dispatch"):
            loss, grads = value_and_grad(
                lm_loss, state.params, tokens, self.cfg, self.mesh,
                aux_weight=self.aux_weight)
            if self.dp > 1:
                loss, grads = self._reduce(loss, grads)
            with torch.no_grad():
                updates, opt_state = self.optimizer.update(
                    grads, state.opt_state, state.params)
                if self._numerics is not None:
                    from swiftmpi_tpu_torch.obs import numerics
                    numerics.stage_dense(self._numerics, state.params,
                                         grads, updates, loss)
                apply_updates(state.params, updates)
                state.step.add_(1)
        self.meter.record(int(tokens.numel()) * self.dp)
        obs.record_step(1)
        out = TrainState(state.params, opt_state, state.step)
        if self.serve_publisher is not None:
            self.serve_publisher.on_steps(out.params, n=1)
        if self.controller is not None:
            self.controller.on_steps(1)
        return out, loss

    def run(self, state: TrainState, batches, pipeline: int = 0,
            dispatch_depth="auto") -> Tuple[TrainState, list]:
        """Consume an iterable of host token batches through :meth:`step`.

        ``pipeline=K`` renders K batches ahead on a producer thread and,
        on a card, copies them there (``CudaTransfer``: pinned memory, a
        side stream), so the copy overlaps the previous step and the
        step's own copy is skipped.  Batch order and values are
        untouched, so ``pipeline=0`` gives the same bits.  The losses
        stay device scalars; a ``DispatchWindow`` (``dispatch_depth``)
        bounds the steps in flight.  Across processes the batches are
        each process's local rows and ``pipeline`` is ignored, as in the
        JAX package."""
        pipelined = pipeline > 0 and self.dp == 1
        window = DispatchWindow(
            resolve_dispatch_bound(dispatch_depth, pipelined=pipelined),
            self.device)
        pipe = transfer = None
        it = batches
        if pipelined:
            from swiftmpi_tpu_torch.io.pipeline import (CudaTransfer,
                                                        PrefetchIterator)
            if self.device.type == "cuda":
                transfer = CudaTransfer(self.device)
            pipe = PrefetchIterator(it, depth=pipeline, transfer=transfer)
            it = pipe
        losses = []
        try:
            it = iter(it)
            while True:
                with self.meter.stalling():
                    tokens = next(it, None)
                if tokens is None:
                    break
                if transfer is not None:
                    tokens = transfer.ready(tokens)
                state, loss = self.step(state, tokens)
                losses.append(loss)
                window.push()
        finally:
            if pipe is not None:
                pipe.close()
                self.pipeline_stats = pipe.stats()
            if transfer is not None:
                transfer.close()
        return state, losses

    # -- checkpoints (atomic, CRC-validated) -------------------------------
    def save(self, state: TrainState, path: str, retain: int = 1) -> None:
        with obs.span("checkpoint_save"):
            self._save(state, path, retain)

    def _save(self, state: TrainState, path: str, retain: int) -> None:
        """Every process copies its leaves to the host (the gather of a
        replicated state) and checks that every replica holds the same
        bits; process 0 writes; every process then waits at a barrier,
        so the file is whole when ``save`` returns anywhere."""
        t = state.tree()
        flat = tree.leaves(t)
        payload = {f"leaf_{i}": leaf_to_numpy(v) for i, v in enumerate(flat)}
        if self.dp > 1:
            crc = 0
            for i in range(len(flat)):
                crc = zlib.crc32(payload[f"leaf_{i}"].tobytes(), crc)
            host_agree("the trainer's replicas at a checkpoint", crc)
        if bootstrap.is_writer():
            payload["treedef"] = np.frombuffer(
                tree.treedef_repr(t).encode(), dtype=np.uint8)
            dst = npz_path(path)
            rotate_before_write(dst, retain)
            atomic_savez(dst, payload)
            prune_generations(dst, retain)
            log.info("trainer checkpoint -> %s (step %d)", dst,
                     int(state.step))
            faults.checkpoint_event(dst)
        if self.dp > 1:
            bootstrap.barrier()

    def load(self, path: str, key=None, verify: bool = True) -> TrainState:
        """A TrainState from :meth:`save`'s file (or the JAX package's):
        the structure from a fresh :meth:`init_state`, which the file's
        ``treedef`` must match (a config or optimizer mismatch raises
        ``ValueError``), then every leaf by flatten order, its shape and
        dtype checked.  ``verify`` CRC-checks every array first."""
        state = self.init_state(key if key is not None else 0)
        want = tree.treedef_repr(state.tree())
        dst = npz_path(path)
        if verify:
            verify_checkpoint(dst)
        with np.load(dst) as z:
            saved = z["treedef"].tobytes().decode()
            if saved != want:
                raise ValueError(
                    "checkpoint state tree does not match this trainer "
                    "(optimizer/config mismatch?): saved "
                    f"{saved[:120]}... != {want[:120]}...")
            n = len(tree.leaves(state.tree()))
            arrays = [z[f"leaf_{i}"] for i in range(n)]
        load_leaves(state, arrays)
        return state
