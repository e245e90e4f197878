"""Child programs for runs of several processes under the port's launcher
(``python -m swiftmpi_tpu_torch.launch -np N -- python -m
swiftmpi_tpu_torch.testing.mp_child <mode> ...``).  The CPU tests and
``chip_smoke.py`` start them; they import only the port.

Modes (each process writes ``<out>/<mode>_r<rank>.json``, and rank-local
arrays beside it, then prints ``MP_CHILD_OK <mode> rank=<r>``):

* ``collectives -out DIR [-device cpu|cuda]``: ``all_gather``, ``psum``
  (held bit for bit against a numpy sum in process order of every
  process's seeded part), ``barrier``, ``all_to_all`` and the B5
  cross-process forms against numpy transposes of the seeded parts; on
  the CPU also a ``tpu`` pull and push with overflowing buckets
  (:func:`overflow_inputs`), whose rows, table and ``overflow_count()``
  go to ``overflow_r<rank>.npz``.
* ``progress -out DIR [-rounds R]``: whether a waiting process holds the
  card (``apps.process_ring_sweep.progress``): process 1's fixed work
  timed alone and while process 0 waits on its send.
* ``dead -out DIR``: a peer that never sends: process 0 waits in one
  all-gather with a deadline of ``DEAD_POLLS`` polls while process 1
  makes its ring and receive buffers and sends nothing for
  ``DEAD_HOLD_S``; process 0's wall seconds to its synchronize, and
  ``timeouts()``.
* ``exchange -out DIR -rounds R``: R back-to-back cross-process exchanges
  on the card, all-to-all and all-gather, float32, int32 and bfloat16,
  each payload distinct (seeded by round, process and form) and each
  result held against the numpy expectation; the rank-ordered ``psum``'s
  bits; ``timeouts()``.
* ``w2v -spec SPEC.json``: one data-parallel word2vec job through
  ``Word2Vec.train`` (a list of specs: their jobs one after the other in
  one process group).  The spec names the conf (section -> keys), the
  data npz (``corpus`` rows of keys, ``vocab_keys``, ``vocab_counts``,
  optional ``init__<field>`` rows that replace the initial table, and
  ``j<rank>``/``u<rank>`` draws, one ``(j, u)`` a step), ``batch_size``,
  ``niters``, ``device``, the ``out`` directory and optionally
  ``dump`` (``Word2Vec.save``), ``checkpoint`` (every iteration),
  ``state`` (process 0 writes its table as ``w2v_state_r0.npz``, and
  with draws its table after the first step as
  ``w2v_first_step_r0.npz``), ``stall`` (a forced ring timeout, see
  :func:`stall_process_ring`)
  and ``time_exchange`` (time B5's cross-process forms at the run's
  shapes after training, and whether a waiting process holds the card,
  ``apps.process_ring_sweep.progress``).  The JSON holds the losses,
  ``train_metrics``, each field's sha256, the kernels' launches in the
  run and ``ring.timeouts()``; with ``[serve] every`` also whether the
  last snapshot equals the table.

  A spec's ``job`` (default ``w2v``) names one of the data axis's other
  jobs, each writing ``<out>/<job>_r<rank>.json`` and, on process 0,
  ``<job>_state_r0.npz``:

  * ``window``: one transfer-level ``push_window`` through the cluster
    the spec's ``conf`` makes (``xla``, ``tpu`` or ``hybrid``; the
    ``knobs`` set on its transfer), from the data's ``init__<field>``
    table (the JAX package's layout) with ``slots<rank>`` ``(W, B)`` and
    ``grads<rank>__<field>`` ``(W, B, d)``; ``reference: true`` also runs
    the one-process push over the processes' windows concatenated in
    process order on a transfer with no data axis and ``dp`` times the
    shard ranks (the same rank slices), and reports its gap.
  * ``lr`` / ``glove``: ``LogisticRegression.train`` on the libSVM file
    ``dataset`` / ``GloVe.train`` on the data's ``corpus``, from the rows
    ``rows__<field>`` the data gives its ``keys`` (written at the keys'
    slots before training); the table is saved by key.
  * ``s2v``: ``Sent2Vec.infer_sentences`` over a word model on the
    conf's transfer built from the data's vocab and ``init__<field>``
    table (or, with ``over: previous``, the previous ``w2v`` job's
    trained model; ``s2v_conf`` is Sent2Vec's own config, default the
    word model's), with the data's ``lines`` and, when given, replayed
    draws ``s2v_sent0``/``s2v_b``/``s2v_j``/``s2v_u`` (one batch); the
    vectors' sha256, and the vectors on process 0.
  * ``trainer``: the transformer trainer across the processes
    (:func:`run_trainer`): the spec's ``cfg`` (``TransformerConfig``
    keys, ``dtype`` by name), ``optimizer`` and ``opt``, an optional
    ``mesh`` of in-process axes, ``init`` (a checkpoint to start from,
    either package's) or ``seed``, and the data's ``tokens`` ``(steps,
    B, S)`` global batches, each process stepping on its row block;
    ``hooks`` arms a serving publisher, an observe-only controller and
    the numerics plane and reports what each saw;
    ``checkpoint`` saves after the steps, ``state`` has process 0 write
    its leaves as ``trainer_state_r0.npz``, ``warmup`` steps stay out of
    the timing and ``time_exchange`` times B5's cross-process all-gather
    at the grads' packed shape.  The JSON holds the losses, each leaf's
    sha256, the launches, step ms and global tokens/s.
  * ``collectives``: ``reduce_scatter`` and ``pmean`` over the processes
    at the spec's ``shapes`` (:func:`run_collectives_job`), held against
    numpy and, on the card, against gloo, and timed there beside
    ``psum_many``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from swiftmpi_tpu_torch.cluster import bootstrap
from swiftmpi_tpu_torch.kernels import adagrad, gather, ring, scatter, stencil
from swiftmpi_tpu_torch.utils.cmdline import CMDLine

#: kernel module name -> module, for the launch counts
KERNELS = {"gather": gather, "scatter": scatter, "adagrad": adagrad,
           "stencil": stencil, "ring": ring}


def _write(out: str, mode: str, rank: int, payload: dict) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{mode}_r{rank}.json"), "w") as f:
        json.dump(payload, f)


def _part(seed: int, shape, dtype) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2 ** 31, 2 ** 31 - 1, size=shape,
                            dtype=np.int64).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


def _to(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"{what} differs from its numpy expectation")


def _bits(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def run_collectives(out: str, device: str) -> dict:
    from swiftmpi_tpu_torch.parallel import (all_gather, all_to_all,
                                             axis_index, axis_size, psum)
    dp, me = axis_size(), axis_index()
    parts = [_part(100 + r, (5, 3), np.float32) for r in range(dp)]
    mine = _to(parts[me], device)
    gathered = all_gather(mine).cpu().numpy()
    _check(np.array_equal(gathered, np.concatenate(parts)), "all_gather")
    stacked = all_gather(mine, tiled=False).cpu().numpy()
    _check(np.array_equal(stacked, np.stack(parts)), "all_gather untiled")
    want = parts[0].copy()
    for p in parts[1:]:
        want += p
    got = psum(mine).cpu().numpy()
    _check(np.array_equal(got.view(np.int32), want.view(np.int32)), "psum")
    # all_to_all: process r's block j is part(r, j); block j of the result
    # came from process j
    blocks = {(r, j): _part(1000 + 10 * r + j, (4, 2), np.float32)
              for r in range(dp) for j in range(dp)}
    x = _to(np.stack([blocks[me, j] for j in range(dp)]), device)
    got_a2a = all_to_all(x).cpu().numpy()
    _check(np.array_equal(got_a2a, np.stack([blocks[j, me]
                                             for j in range(dp)])), "a2a")
    ints = _to(_part(7 + me, (dp, 6), np.int32), device)
    got_ints = ring.process_all_to_all(ints).cpu().numpy()
    _check(np.array_equal(got_ints, np.stack(
        [_part(7 + j, (dp, 6), np.int32)[me] for j in range(dp)])),
        "the int32 exchange")
    _check_packed_psum(dp, me, device)
    bootstrap.barrier()
    if device == "cpu":
        np.savez(os.path.join(out, f"overflow_r{me}.npz"),
                 **overflow_push(dp, me))
    return {"psum_sha": _bits(psum(mine)), "dp": dp, "rank": me}


#: the overflow case: shard ranks a process, rows a shard, row width,
#: requests a process, the bucket capacity and the learning rate
OVF_SHARDS, OVF_CAP, OVF_D, OVF_B, OVF_C, OVF_LR = 2, 32, 8, 16, 2, 0.3


def _check_packed_psum(dp: int, me: int, device) -> None:
    """``psum_many`` over bfloat16 tensors of odd lengths, a float32 and
    an int32 one in one exchange, each held bit for bit against the sum
    in process order; ``process_pmean`` forward, and its backward against
    the mean of every process's incoming gradient."""
    from swiftmpi_tpu_torch.parallel.collectives import (process_pmean,
                                                         psum_many)
    shapes = [((3,), torch.bfloat16), ((2, 5), torch.float32),
              ((1,), torch.bfloat16), ((7,), torch.int32)]

    def part(r, i, shape, dtype):
        a = _part(200 + 10 * r + i, shape,
                  np.int32 if dtype == torch.int32 else np.float32)
        return torch.from_numpy(a).to(dtype)

    xs = [part(me, i, sh, dt).to(device)
          for i, (sh, dt) in enumerate(shapes)]
    for i, (got, (sh, dt)) in enumerate(zip(psum_many(xs), shapes)):
        want = part(0, i, sh, dt)
        for r in range(1, dp):
            want += part(r, i, sh, dt)
        _check(got.dtype == dt and torch.equal(got.cpu(), want),
               f"psum_many of {dt} {sh}")
    a = part(me, 0, (4,), torch.float32).to(device).requires_grad_(True)
    b = part(me, 1, (2,), torch.float32).to(device)
    ma, mb = process_pmean(a, b)
    want = sum(part(r, 0, (4,), torch.float32) for r in range(dp)) / dp
    _check(torch.equal(ma.detach().cpu(), want), "process_pmean")
    # d/da of sum(w_me * ma) is the mean over the processes of their w
    w = part(me, 2, (4,), torch.float32).to(device)
    (g,) = torch.autograd.grad((w * ma).sum() + 0 * mb.sum(), [a])
    want = sum(part(r, 2, (4,), torch.float32) for r in range(dp)) / dp
    _check(torch.equal(g.cpu(), want), "process_pmean's backward")


def overflow_inputs(dp: int) -> tuple:
    """The global batch of the overflow case (``OVF_B`` requests a
    process, process-major, every seventh a padding ``-1``; keys from 24,
    so the shards' buckets of ``OVF_C`` overflow), its h and v grads and
    the initial table: ``(slots, grads, init)`` as numpy."""
    from swiftmpi_tpu_torch.parameter import KeyIndex
    rng = np.random.default_rng(41)
    keys = rng.integers(0, 24, size=OVF_B * dp).astype(np.uint64)
    slots = KeyIndex(OVF_SHARDS, OVF_CAP).lookup(keys)
    slots[::7] = -1
    grads = {f: rng.normal(size=(OVF_B * dp, OVF_D)).astype(np.float32)
             for f in ("h", "v")}
    rows = OVF_SHARDS * OVF_CAP
    init = {f: (0.1 * rng.normal(size=(rows, OVF_D))).astype(np.float32)
            for f in ("h", "v")}
    init.update({f: np.zeros((rows, OVF_D), np.float32)
                 for f in ("h2sum", "v2sum")})
    return slots, grads, init


def overflow_push(dp: int, me: int) -> dict:
    """This process's slice of :func:`overflow_inputs` through a ``tpu``
    pull and a mean push at ``bucket_capacity = OVF_C``: the rows pulled,
    ``overflow_count()`` after the pull and after the push (``traffic()``'s
    ``overflow_dropped``), and the table."""
    from swiftmpi_tpu_torch.cluster import ps_mesh
    from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
    from swiftmpi_tpu_torch.parameter import w2v_access
    from swiftmpi_tpu_torch.transfer import ShardedTransfer
    slots, grads, init = overflow_inputs(dp)
    mine = slice(me * OVF_B, (me + 1) * OVF_B)
    layout = ps_mesh(OVF_SHARDS, ["cpu"])
    t = ShardedTransfer(layout, bucket_capacity=OVF_C)
    t.set_data_axis(dp, me)
    acc = w2v_access(OVF_LR, OVF_D)
    state = state_from_jax(init, "cpu", mesh=layout)
    pulled = t.pull(state, torch.from_numpy(slots[mine]), acc)
    after_pull = t.overflow_count()
    t.push(state, torch.from_numpy(slots[mine]),
           {f: torch.from_numpy(g[mine]) for f, g in grads.items()}, acc,
           mean=True)
    out = {f"pulled__{f}": v.numpy() for f, v in pulled.items()}
    out.update({f"table__{f}": v for f, v in state_to_numpy(state).items()})
    out["overflow"] = np.array([after_pull,
                                t.traffic()["overflow_dropped"]])
    return out


def stall_process_ring(stall: dict, rank: int) -> None:
    """A forced timeout of the cross-process exchange: every ring wait
    gives up after ``stall["max_polls"]`` polls (a cross-process wait is
    released that many ``ring._POLL_S`` after its send ran), and process
    ``stall["rank"]`` holds its stream ``stall["cycles"]`` clock cycles
    before each of its sends, so its peers' waits give up."""
    ring._MAX_POLLS = int(stall["max_polls"])
    if rank != int(stall["rank"]):
        return
    run = ring.ProcessRing._run

    def late(self, *args):
        torch.cuda._sleep(int(stall["cycles"]))
        return run(self, *args)
    ring.ProcessRing._run = late


#: ``dead``: process 0's wait deadline in polls (0.2 s) and how long
#: process 1 holds back
DEAD_POLLS = 800_000
DEAD_HOLD_S = 5.0


def run_dead() -> dict:
    me = bootstrap.process_index()
    dev = torch.device("cuda", torch.cuda.current_device())
    pr = ring.process_ring(dev)
    x = torch.ones((64, 8), device=dev)
    wall = None
    if me == 0:
        ring._MAX_POLLS = DEAD_POLLS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ring.process_all_gather(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check(torch.equal(got[0].cpu(), x.cpu()), "the sender's own block")
    else:
        # its receive buffers, whose handles process 0 maps, and no send
        pr._ensure(2 * x.numel() * x.element_size())
        time.sleep(DEAD_HOLD_S)
    bootstrap.barrier()
    return {"rank": me, "wall_s": wall, "timeouts": ring.timeouts(),
            "epoch": pr.epoch}


def run_exchange(out: str, rounds: int) -> dict:
    from swiftmpi_tpu_torch.parallel import psum
    dp, me = bootstrap.process_count(), bootstrap.process_index()
    dev = torch.device("cuda", torch.cuda.current_device())
    ring.process_launches = 0
    checked = 0
    forms = [("a2a", torch.float32), ("a2a", torch.int32),
             ("a2a", torch.bfloat16), ("gather", torch.float32),
             ("gather", torch.int32), ("gather", torch.bfloat16)]
    pending = []
    for i in range(rounds):
        form, dtype = forms[i % len(forms)]
        rows = 3 + (i % 5) * 17           # sizes change between rounds
        src = torch.float32 if dtype == torch.bfloat16 else dtype
        npdt = np.int32 if dtype == torch.int32 else np.float32

        def part(r, j=0):
            return _part(10_000 * i + 100 * r + j, (rows, 8), npdt)
        if form == "a2a":
            x = _to(np.stack([part(me, j) for j in range(dp)]), dev, dtype)
            got = ring.process_all_to_all(x)
            want = np.stack([part(j, me) for j in range(dp)])
        else:
            got = ring.process_all_gather(_to(part(me), dev, dtype))
            want = np.stack([part(j) for j in range(dp)])
        pending.append((got, torch.from_numpy(want).to(src).to(dtype)))
        if len(pending) >= 32 or i == rounds - 1:
            # read back in bunches: the exchanges run back to back
            for g, w in pending:
                _check(torch.equal(g.cpu(), w), f"exchange {checked}")
                checked += 1
            pending = []
    x = _to(_part(55 + me, (1000, 7), np.float32), dev)
    sha = _bits(psum(x))
    torch.cuda.synchronize()
    return {"rounds": rounds, "checked": checked,
            "launches": ring.process_launches, "timeouts": ring.timeouts(),
            "psum_sha": sha, "rank": me}


def _time_exchanges(model, device) -> list:
    """B5's cross-process forms timed at the run's shapes: the dense
    plane's all-gather (``xla``: capacity x (d + 1) words) and the sparse
    reconcile's (a batch's folded rows)."""
    cap = model.table.capacity
    d = model.len_vec
    B = model.train_metrics.get("batch_size", 0)
    return _time_shapes([("dense_plane", (cap, d + 1)),
                         ("sparse_rows", (max(B, 1) * 2 * model.window,
                                          d + 2))], device)


def _events_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls on the card,
    by CUDA events, after 3 warm calls; the processes start together."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    bootstrap.barrier()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    bootstrap.barrier()
    return s.elapsed_time(e) / reps


def _time_shapes(shapes, device) -> list:
    """B5's cross-process all-gather timed at each ``(label, (rows,
    words))`` shape, against gloo on the same words (the plain version)
    and the host route (device -> host, gloo, host -> device)."""
    dp = bootstrap.process_count()
    out = []
    for label, shape in shapes:
        x = torch.randn(shape, device=device)
        want = ring.process_all_gather_plain(x.cpu())
        got = ring.process_all_gather(x)
        err = float((got.cpu() - want).abs().max())
        reps = 20
        ms = _events_ms(lambda: ring.process_all_gather(x), reps)
        xc = x.cpu()
        t0 = time.perf_counter()
        for _ in range(reps):
            ring.process_all_gather_plain(xc)
        plain_ms = (time.perf_counter() - t0) * 1e3 / reps
        bootstrap.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            ring.process_all_gather_plain(x.cpu()).to(device)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        # every process reads its tensor once and writes dp of them
        nbytes = dp * x.numel() * 4 * (1 + dp)
        out.append({"label": label, "shape": list(shape), "dp": dp,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "host_route_ms": host_ms, "bytes": nbytes,
                    "bound_ms": nbytes / 3.35e12 * 1e3})
    return out


def lockstep_epochs(vocab, corpus, window, sample, B, nprocs, niters):
    """What the processes' ``DistributedBatcher``s yield, epoch by epoch:
    each process's shard and seed (``Word2Vec.train``'s), every process
    pulling one full batch a step until one runs dry.  Returns ``[[the
    processes' batches] a step]`` an epoch."""
    from swiftmpi_tpu_torch.data.distributed import shard_sentences
    from swiftmpi_tpu_torch.data.text import CBOWBatcher
    batchers = [CBOWBatcher(shard_sentences(corpus, r, nprocs), vocab,
                            window, sample, seed=2008 + r)
                for r in range(nprocs)]
    epochs = []
    for _ in range(niters):
        gens = [b.epoch(B) for b in batchers]
        steps = []
        while True:
            got = []
            for g in gens:
                x = next(g, None)
                while x is not None and len(x) != B:
                    x = next(g, None)
                got.append(x)
            if any(x is None for x in got):
                break
            steps.append(got)
        epochs.append(steps)
    return epochs


def first_step_rows(draws, model, into: dict, times=None):
    """``draws`` passed through, one ``(j, u)`` a step; when the second
    step asks for its draws, the table as the first step left it is
    copied into ``into`` (field -> host rows): the copy runs on the
    stream after the first step.  A run's one-step table, taken without
    another run.  ``times`` (a list) gets the host clock at every step's
    request."""
    from swiftmpi_tpu_torch.parameter.sparse_table import tensor_to_numpy
    for i, d in enumerate(draws):
        if times is not None:
            times.append(time.perf_counter())
        if i == 1:
            # a copy: on the CPU the host view would share the table
            into.update({f: np.array(tensor_to_numpy(
                model.table.global_rows(f), upcast=True))
                for f in model.table.state})
        yield d


def steady_step_ms(times: list, t_end: float):
    """Host ms a step over the run's second half: from the request of
    the middle step's draws to the end of the run (after its device
    synchronize), past the first steps' warm-up."""
    if len(times) < 4:
        return None
    k = len(times) // 2
    return 1e3 * (t_end - times[k]) / (len(times) - k)


def run_w2v(spec: dict, run: dict) -> dict:
    from swiftmpi_tpu_torch.convert import state_from_jax
    from swiftmpi_tpu_torch.data.text import Vocab
    from swiftmpi_tpu_torch.models.word2vec import Word2Vec
    from swiftmpi_tpu_torch.parameter.sparse_table import tensor_to_numpy
    from swiftmpi_tpu_torch.utils import ConfigParser
    os.makedirs(spec["out"], exist_ok=True)
    conf = ConfigParser().update(spec["conf"])
    device = spec.get("device", "cuda")
    model = Word2Vec(config=conf, device=device,
                     capacity_per_shard=spec.get("capacity_per_shard"))
    me, dp = model.cluster.dp_rank, model.cluster.dp
    z = np.load(spec["data"])
    model.build_from_vocab(Vocab(z["vocab_keys"], z["vocab_counts"]))
    init = {k[len("init__"):]: z[k] for k in z.files
            if k.startswith("init__")}
    if init:
        # the side planes the build made (``@ef``, ``@rowver``) stay unless
        # the data gives them
        model.table.state = {**model.table.state, **state_from_jax(
            init, model.device,
            mesh=model.cluster.mesh if model.transfer.name in ("tpu",
                                                               "hybrid")
            else None)}
    if spec.get("stall"):
        stall_process_ring(spec["stall"], me)
    draws, first, times = None, {}, []
    if f"j{me}" in z.files:
        # on the device before the run: a step reads no host draws
        draws = first_step_rows(zip(
            torch.from_numpy(z[f"j{me}"]).to(model.device),
            torch.from_numpy(z[f"u{me}"]).to(model.device)), model, first,
            times)
    _reset_launches()
    cuda = model.device.type == "cuda"
    losses, seconds = _timed(model.device, lambda: model.train(
        z["corpus"], niters=int(spec.get("niters", 1)),
        batch_size=int(spec["batch_size"]), draws=draws,
        checkpoint_path=spec.get("checkpoint")))
    t_end = time.perf_counter()
    launches = _launch_counts()
    metrics = {k: v for k, v in model.train_metrics.items()
               if isinstance(v, (int, float, str, bool, list, dict))}
    metrics["batch_size"] = int(spec["batch_size"])
    model.train_metrics["batch_size"] = int(spec["batch_size"])
    state = {f: model.table.global_rows(f) for f in model.table.state}
    result = {"rank": me, "dp": dp, "losses": losses, "seconds": seconds,
              "ef_nonzero": {f: int(torch.count_nonzero(t))
                             for f, t in state.items() if f.endswith("@ef")},
              "steady_step_ms": steady_step_ms(times, t_end),
              "metrics": metrics, "launches": launches,
              "timeouts": ring.timeouts() if cuda else 0,
              "sha": {f: _bits(t) for f, t in state.items()},
              "transfer": model.transfer.name,
              "traffic": model.transfer.traffic()
              if model.transfer.count_traffic else None}
    if spec.get("state") and me == 0:
        np.savez(os.path.join(spec["out"], f"w2v_state_r{me}.npz"),
                 **{f: tensor_to_numpy(t, upcast=True)
                    for f, t in state.items()})
        if first:
            np.savez(os.path.join(spec["out"], "w2v_first_step_r0.npz"),
                     **first)
    pub = model.serve_publisher
    if pub is not None:
        from swiftmpi_tpu_torch.convert import tensor_from_numpy
        snap = pub.latest()
        result["serve"] = {
            "version": snap.version, "step": snap.step,
            "equal": all(_bits(tensor_from_numpy(np.asarray(
                snap.state[f]))) == _bits(t)
                for f, t in state.items() if f in snap.state)}
    if spec.get("dump"):
        result["dumped"] = model.save(spec["dump"])
    if spec.get("time_exchange") and cuda:
        result["exchange"] = _time_exchanges(model, model.device)
        from swiftmpi_tpu_torch.apps.process_ring_sweep import progress
        result["progress"] = progress(model.device)
    if spec.get("time_shapes"):
        result["exchange"] = _time_shapes(spec["time_shapes"], model.device)
    run["w2v_model"] = model
    return result


def _launch_counts() -> dict:
    out = {name: mod.launches for name, mod in KERNELS.items()}
    out["ring_process"] = ring.process_launches
    return out


def _reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    ring.process_launches = 0


def _timed(device, fn):
    """``fn()`` between a barrier over the processes and the device's
    synchronize: ``(its value, wall seconds)``."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    bootstrap.barrier()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _common(spec, transfer, seconds: float) -> dict:
    cuda = torch.device(spec.get("device", "cuda")).type == "cuda"
    return {"rank": bootstrap.process_index(),
            "dp": bootstrap.process_count(), "seconds": seconds,
            "launches": _launch_counts(),
            "timeouts": ring.timeouts() if cuda else 0,
            "transfer": transfer.name,
            "traffic": (transfer.traffic() if transfer.count_traffic
                        else None)}


def _state_bits(state) -> dict:
    from swiftmpi_tpu_torch.parameter.sparse_table import shard_block
    return {f: _bits(shard_block(v) if isinstance(v, list) else v)
            for f, v in state.items()}


def run_window(spec: dict, run: dict) -> dict:
    from swiftmpi_tpu_torch.cluster import Cluster, ps_mesh
    from swiftmpi_tpu_torch.convert import state_from_jax, state_to_numpy
    from swiftmpi_tpu_torch.parameter import w2v_access
    from swiftmpi_tpu_torch.transfer import get_transfer
    from swiftmpi_tpu_torch.utils import ConfigParser
    device = spec.get("device", "cuda")
    conf = ConfigParser().update(spec["conf"])
    cl = Cluster(conf, devices=[device]).initialize()
    t, me, dp = cl.transfer, cl.dp_rank, cl.dp
    init, windows = _window_data(spec, dp)
    d = int(init["h"].shape[1])
    access = w2v_access(float(spec.get("lr", 0.3)), d)
    mean = bool(spec.get("mean", False))

    def transfer_of(tr):
        for k, v in spec.get("knobs", {}).items():
            setattr(tr, k, v)
        tr.count_traffic = True
        return tr

    def state_of(mesh):
        return state_from_jax(init, device, mesh=mesh)

    transfer_of(t)
    state = state_of(cl.mesh)

    def window(r):
        slots_r, grads_r = windows[r]
        return (torch.from_numpy(slots_r).to(device),
                {f: torch.from_numpy(g).to(device)
                 for f, g in grads_r.items()})
    slots, grads = window(me)
    _reset_launches()
    _, seconds = _timed(device, lambda: t.push_window(
        state, slots, grads, access, mean=mean))
    result = _common(spec, t, seconds)
    result["sha"] = _state_bits(state)
    got = state_to_numpy(state)
    if spec.get("reference"):
        # the one-process push over the global window: no data axis, and
        # dp x n shard ranks, so the window splits into the same rank
        # slices (JAX's (data, shard) devices) and the same rows dedup
        backend = spec["conf"]["cluster"]["transfer"]
        n = int(spec["conf"]["cluster"].get("server_num", 1))
        kw = ({} if backend == "xla"
              else {"mesh": ps_mesh(n * dp, [device])})
        ref_t = transfer_of(get_transfer(backend, **kw))
        ref_state = state_of(kw.get("mesh"))
        parts = [window(r) for r in range(dp)]
        ref_t.push_window(ref_state, torch.cat([p[0] for p in parts]),
                          {f: torch.cat([p[1][f] for p in parts])
                           for f in ("h", "v")}, access, mean=mean)
        want = state_to_numpy(ref_state)
        result["reference_gap"] = {f: _envelope_gap(got[f], want[f])
                                   for f in want}
    if spec.get("time_shapes"):
        result["exchange"] = _time_shapes(spec["time_shapes"], device)
    if me == 0:
        np.savez(os.path.join(spec["out"], "window_state_r0.npz"), **got)
    return result


def _envelope_gap(got: np.ndarray, want: np.ndarray) -> dict:
    """The largest gap, the share of elements outside |a-b| <= 1e-5 +
    1e-3|b| and the largest gap among those."""
    gap = np.abs(got.astype(np.float64) - want)
    out = gap > 1e-5 + 1e-3 * np.abs(want)
    return {"max_abs_gap": float(gap.max()),
            "share_outside_envelope": float(out.mean()),
            "max_gap_outside_envelope": float(gap[out].max())
            if out.any() else 0.0}


def _window_data(spec: dict, dp: int):
    """A window job's table (``{field: rows}``, the JAX package's layout)
    and each process's ``(slots (W, B), {"h", "v": (W, B, d)})``: from the
    data file, or made from the seeded shape ``gen`` (``rows``, ``d``,
    ``W``, ``B``, ``n_hot``, ``ef``, ``seed``): rows of 0.1 x N(0, 1),
    zero accumulators and residuals, slots Zipf(1.2) over the unified
    space, grads 0.01 x N(0, 1)."""
    g = spec.get("gen")
    if g is None:
        z = np.load(spec["data"])
        init = {k[len("init__"):]: z[k] for k in z.files
                if k.startswith("init__")}
        return init, [(z[f"slots{r}"], {f: z[f"grads{r}__{f}"]
                                        for f in ("h", "v")})
                      for r in range(dp)]
    rng = np.random.default_rng(int(g["seed"]))
    rows, d, n_hot = int(g["rows"]), int(g["d"]), int(g.get("n_hot", 0))

    def planes(n, prefix=""):
        out = {f + prefix: (0.1 * rng.standard_normal((n, d), np.float32))
               for f in ("h", "v")}
        out.update({f + prefix: np.zeros((n, d), np.float32)
                    for f in ("h2sum", "v2sum")})
        return out
    init = planes(rows)
    if n_hot:
        init.update(planes(n_hot, "@hot"))
    if g.get("ef"):
        init.update({f"{f}@ef": np.zeros((rows, d), np.float32)
                     for f in ("h", "v")})
    windows = []
    for r in range(dp):
        rr = np.random.default_rng([int(g["seed"]), r])
        shape = (int(g["W"]), int(g["B"]))
        slots = ((rr.zipf(1.2, size=shape) - 1) % (rows + n_hot)).astype(
            np.int32)
        windows.append((slots, {f: 0.01 * rr.standard_normal(
            shape + (d,), np.float32) for f in ("h", "v")}))
    return init, windows


def _rows_by_key(table, keys) -> dict:
    """Every field's rows of ``table`` at ``keys``' slots, upcast, host."""
    from swiftmpi_tpu_torch.parameter.sparse_table import tensor_to_numpy
    slots = table.key_index.lookup(keys, create=False)
    return {f: np.array(tensor_to_numpy(table.unified_rows(
        f, torch.from_numpy(slots.astype(np.int64))), upcast=True))
        for f in table.access.fields}


def _write_keyed_rows(table, z) -> np.ndarray:
    """The data's ``rows__<field>`` written at its ``keys``' slots (made
    now, in the keys' order); returns the keys."""
    keys = z["keys"].astype(np.uint64)
    slots = table.key_index.lookup(keys)
    for f in table.access.fields:
        if f"rows__{f}" in z.files:
            table.write_rows(f, slots, torch.from_numpy(z[f"rows__{f}"]))
    return keys


def run_lr(spec: dict, run: dict) -> dict:
    from swiftmpi_tpu_torch.models.logistic import LogisticRegression
    from swiftmpi_tpu_torch.utils import ConfigParser
    model = LogisticRegression(
        config=ConfigParser().update(spec["conf"]),
        capacity_per_shard=int(spec["capacity_per_shard"]),
        device=spec.get("device", "cuda"))
    keys = (_write_keyed_rows(model.table, np.load(spec["data"]))
            if spec.get("data") else None)
    _reset_launches()
    losses, seconds = _timed(spec.get("device", "cuda"), lambda: model.train(
        spec["dataset"], niters=int(spec.get("niters", 1))))
    return _keyed_result(spec, "lr", model, keys, losses, seconds,
                         "records")


def run_glove(spec: dict, run: dict) -> dict:
    from swiftmpi_tpu_torch.models.glove import GloVe
    from swiftmpi_tpu_torch.utils import ConfigParser
    z = np.load(spec["data"])
    model = GloVe(config=ConfigParser().update(spec["conf"]),
                  capacity_per_shard=spec.get("capacity_per_shard"),
                  device=spec.get("device", "cuda"))
    model.build(z["corpus"].tolist())
    keys = _write_keyed_rows(model.table, z) if "keys" in z.files else None
    _reset_launches()
    losses, seconds = _timed(spec.get("device", "cuda"), lambda: model.train(
        niters=int(spec.get("niters", 1))))
    return _keyed_result(spec, "glove", model, keys, losses, seconds,
                         "cells")


def _keyed_result(spec, job, model, keys, losses, seconds, unit) -> dict:
    """The job's JSON; process 0 saves every field's rows by key (``keys``,
    or every key in the key index's order)."""
    result = _common(spec, model.transfer, seconds)
    if keys is None:
        ki = model.table.key_index
        keys = np.fromiter(ki.keys(), np.uint64, len(ki))
    m = model.train_metrics
    result.update({"losses": losses, "sha": _state_bits(model.table.state),
                   "metrics": {k: v for k, v in m.items()
                               if isinstance(v, (int, float, str, dict))},
                   "units": m.get(unit)})
    if spec.get("time_shapes"):
        result["exchange"] = _time_shapes(spec["time_shapes"],
                                          model.device)
    if bootstrap.process_index() == 0:
        np.savez(os.path.join(spec["out"], f"{job}_state_r0.npz"),
                 keys=keys, **_rows_by_key(model.table, keys))
    return result


def run_s2v(spec: dict, run: dict) -> dict:
    from swiftmpi_tpu_torch.convert import state_from_jax
    from swiftmpi_tpu_torch.data.text import Vocab
    from swiftmpi_tpu_torch.models.sent2vec import Sent2Vec
    from swiftmpi_tpu_torch.models.word2vec import Word2Vec
    from swiftmpi_tpu_torch.utils import ConfigParser
    z = np.load(spec["data"])
    device = spec.get("device", "cuda")
    if spec.get("over") == "previous":
        wm = run["w2v_model"]
    else:
        wm = Word2Vec(config=ConfigParser().update(spec["conf"]),
                      device=device,
                      capacity_per_shard=spec.get("capacity_per_shard"))
        wm.build_from_vocab(Vocab(z["vocab_keys"], z["vocab_counts"]))
        init = {k[len("init__"):]: z[k] for k in z.files
                if k.startswith("init__")}
        if init:
            wm.table.state = state_from_jax(
                init, wm.device, mesh=wm.cluster.mesh
                if wm.transfer.name in ("tpu", "hybrid") else None)
    s2v = Sent2Vec(wm, config=(ConfigParser().update(spec["s2v_conf"])
                               if "s2v_conf" in spec else None),
                   seed=int(spec.get("seed", 0)))
    draws = None
    if "s2v_sent0" in z.files:
        passes = [(z["s2v_b"][i], z["s2v_j"][i], z["s2v_u"][i])
                  for i in range(z["s2v_b"].shape[0])]
        draws = iter([(z["s2v_sent0"], passes)])
    lines = [str(x) for x in z["lines"]]
    _reset_launches()
    out, seconds = _timed(device, lambda: s2v.infer_sentences(
        lines, niters=int(spec.get("niters", 1)), draws=draws))
    vecs = np.stack([v for _, v in out])
    result = _common(spec, wm.transfer, seconds)
    result.update({"sentences": len(out), "n_hot": int(wm.table.n_hot),
                   "sha": {"vectors": _bits(torch.from_numpy(vecs))}})
    if bootstrap.process_index() == 0:
        np.savez(os.path.join(spec["out"], "s2v_state_r0.npz"),
                 ids=np.array([i for i, _ in out], np.uint64),
                 vectors=vecs)
    return result


#: spec ``job`` -> its runner, ``(spec, run)``: ``run`` is one dict for
#: the launch's jobs (``w2v`` leaves its model there as ``w2v_model``)
def trainer_config(spec: dict):
    """The spec's ``cfg`` (``TransformerConfig`` keys, ``dtype`` by name)."""
    from swiftmpi_tpu_torch.models.transformer import TransformerConfig
    kw = dict(spec["cfg"])
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    return TransformerConfig(**kw)


def _leaf_bits(state) -> list:
    from swiftmpi_tpu_torch.utils import tree
    return [_bits(x) for x in tree.leaves(state.tree())]


def run_trainer(spec: dict, run: dict) -> dict:
    """The transformer trainer over the data axis: every global batch of
    the data's ``tokens`` ``(steps, B, S)`` cut into the processes' row
    blocks in process order, this process stepping on its own."""
    from swiftmpi_tpu_torch.cluster.mesh import Mesh
    from swiftmpi_tpu_torch.models.trainer import Trainer
    from swiftmpi_tpu_torch.models.trainer import leaf_to_numpy
    from swiftmpi_tpu_torch.utils import tree
    device = spec.get("device", "cuda")
    mesh = Mesh(spec["mesh"], device) if spec.get("mesh") else None
    tr = Trainer(trainer_config(spec), mesh=mesh,
                 optimizer=spec.get("optimizer", "adamw"),
                 device=None if mesh is not None else device,
                 **spec.get("opt", {}))
    me, dp = tr.dp_rank, tr.dp
    col = None
    if spec.get("hooks"):
        from swiftmpi_tpu_torch.control.controller import (ControlSettings,
                                                           Controller)
        from swiftmpi_tpu_torch.obs.numerics import NumericsCollector
        from swiftmpi_tpu_torch.serve import SnapshotPublisher
        tr.serve_publisher = SnapshotPublisher(every=1)
        tr.controller = Controller(ControlSettings(enabled=True, every=2))
        col = NumericsCollector()
        tr.arm_numerics(col)
    state = (tr.load(spec["init"]) if spec.get("init")
             else tr.init_state(spec.get("seed", 0)))
    tokens = np.load(spec["data"])["tokens"]
    rows = tokens.shape[1] // dp
    local = [torch.from_numpy(np.ascontiguousarray(
        t[me * rows:(me + 1) * rows])).to(tr.device) for t in tokens]
    warm = int(spec.get("warmup", 0))
    _reset_launches()
    losses, times = [], []
    for i, t in enumerate(local):
        (state, loss), sec = _timed(device, lambda: tr.step(state, t))
        losses.append(float(loss))
        if i >= warm:
            times.append(sec)
    launches = _launch_counts()
    steady = sum(times) / max(len(times), 1)
    if spec.get("checkpoint"):
        tr.save(state, spec["checkpoint"])
    out = {"rank": me, "dp": dp, "losses": losses,
           "leaf_sha": _leaf_bits(state), "launches": launches,
           "step_ms": 1e3 * steady,
           "tokens_per_s": tokens.shape[1] * tokens.shape[2] / steady
           if steady else 0.0,
           "timeouts": ring.timeouts()
           if torch.device(device).type == "cuda" else 0}
    if col is not None:
        snap = tr.serve_publisher.latest()
        out["hooks"] = {
            "snapshot": [snap.version, snap.step],
            "snapshot_equal": all(
                np.array_equal(a, leaf_to_numpy(b)) for a, b in zip(
                    tree.leaves(snap.state), tree.leaves(state.params))),
            "numerics": col.read(), "evaluations": tr.controller._evals}
    if spec.get("state") and me == 0:
        np.savez(os.path.join(spec["out"], "trainer_state_r0.npz"),
                 **{f"leaf_{i}": leaf_to_numpy(x)
                    for i, x in enumerate(tree.leaves(state.tree()))})
    if spec.get("time_exchange") and torch.device(device).type == "cuda":
        # the grads' packed words and the loss's: one word more than the
        # params' bytes / 4
        nbytes = sum(-(-x.numel() * x.element_size() // 4) * 4
                     for x in tree.leaves(state.params))
        out["exchange"] = _time_shapes(
            [("grads_packed", (nbytes // 4 + 1, 1))], device)
    return out


def run_collectives_job(spec: dict, run: dict) -> dict:
    """``reduce_scatter`` and ``pmean`` over the processes at each of the
    spec's ``shapes`` (``[label, shape, scatter_dimension]``), on every
    process's seeded float32 part: each held bit for bit against numpy's
    sum in process order; on the card also against the gloo route on the
    same parts (bit for bit), and timed beside ``psum_many``'s all-gather
    of the same tensor.  Each process writes its results as
    ``collectives_state_r<rank>.npz`` (``rs__<label>``, ``pm__<label>``)."""
    from swiftmpi_tpu_torch.parallel.collectives import (pmean, psum_many,
                                                         reduce_scatter)
    bootstrap.init_distributed()
    device = spec.get("device", "cuda")
    cuda = torch.device(device).type == "cuda"
    dp, me = bootstrap.process_count(), bootstrap.process_index()
    _reset_launches()
    arrays, timed = {}, []
    for label, shape, dim in spec["shapes"]:
        parts = [_part(300 + r, tuple(shape), np.float32)
                 for r in range(dp)]
        x = _to(parts[me], device)
        total = parts[0].copy()
        for p in parts[1:]:
            total += p
        block = total.shape[dim] // dp
        want_rs = np.take(total, np.arange(me * block, (me + 1) * block),
                          axis=dim)
        rs = reduce_scatter(x, scatter_dimension=dim)
        pm = pmean(x)
        _check(np.array_equal(rs.cpu().numpy(), want_rs),
               f"reduce_scatter of {label}")
        _check(np.array_equal(pm.cpu().numpy(), total / np.float32(dp)),
               f"pmean of {label}")
        arrays[f"rs__{label}"] = rs.cpu().numpy()
        arrays[f"pm__{label}"] = pm.cpu().numpy()
        if not cuda:
            continue
        xc = x.cpu()
        _check(torch.equal(reduce_scatter(xc, scatter_dimension=dim),
                           rs.cpu()), f"reduce_scatter of {label} on gloo")
        _check(torch.equal(pmean(xc), pm.cpu()), f"pmean of {label} on gloo")
        reps = int(spec.get("reps", 20))
        n = x.numel()
        rs_ms = _events_ms(lambda: reduce_scatter(x, scatter_dimension=dim),
                           reps)
        pm_ms = _events_ms(lambda: pmean(x), reps)
        ps_ms = _events_ms(lambda: psum_many([x]), reps)
        bootstrap.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            reduce_scatter(xc, scatter_dimension=dim)
        gloo_ms = (time.perf_counter() - t0) * 1e3 / reps
        bootstrap.barrier()
        # the least bytes: every process's part read once, every
        # process's n / dp result words written once
        rs_bytes = 4 * n * (dp + 1)
        # psum and pmean: every part read once, every process's n-word
        # result written once
        ps_bytes = 4 * n * 2 * dp
        timed.append({"label": label, "shape": list(shape), "dp": dp,
                      "scatter_dimension": dim, "reduce_scatter_ms": rs_ms,
                      "pmean_ms": pm_ms, "psum_many_ms": ps_ms,
                      "gloo_reduce_scatter_ms": gloo_ms,
                      "reduce_scatter_bytes": rs_bytes,
                      "reduce_scatter_bound_ms": rs_bytes / 3.35e12 * 1e3,
                      "psum_bytes": ps_bytes,
                      "psum_bound_ms": ps_bytes / 3.35e12 * 1e3,
                      "max_abs_err": 0.0})
    launches = _launch_counts()
    np.savez(os.path.join(spec["out"], f"collectives_state_r{me}.npz"),
             **arrays)
    return {"rank": me, "dp": dp, "launches": launches, "timed": timed,
            "timeouts": ring.timeouts() if cuda else 0}


JOBS = {"w2v": run_w2v, "window": run_window, "lr": run_lr,
        "glove": run_glove, "s2v": run_s2v, "trainer": run_trainer,
        "collectives": run_collectives_job}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    mode = argv[0]
    cmd = CMDLine(["mp_child"] + argv[1:])
    try:
        if mode == "w2v":
            with open(cmd.get_value("spec")) as f:
                specs = json.load(f)
            # one spec, or a list run one after the other in one group
            run: dict = {}
            for spec in specs if isinstance(specs, list) else [specs]:
                job = spec.get("job", "w2v")
                os.makedirs(spec["out"], exist_ok=True)
                payload = JOBS[job](spec, run)
                _write(spec["out"], job, bootstrap.process_index(),
                       payload)
        else:
            out = cmd.get_value("out")
            device = cmd.get_value("device", "cuda")
            if device == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "-device cpu")
            bootstrap.init_distributed()
            if mode == "collectives":
                payload = run_collectives(out, device)
            elif mode == "dead":
                payload = run_dead()
            elif mode == "progress":
                from swiftmpi_tpu_torch.apps.process_ring_sweep import \
                    progress
                payload = progress(
                    torch.device("cuda", torch.cuda.current_device()),
                    int(cmd.get_value("rounds", "3")))
                payload["timeouts"] = ring.timeouts()
            elif mode == "exchange":
                payload = run_exchange(out, int(cmd.get_value("rounds",
                                                              "500")))
            else:
                print(f"mp_child: unknown mode {mode!r}", file=sys.stderr)
                return 2
            _write(out, mode, bootstrap.process_index(), payload)
        print(f"MP_CHILD_OK {mode} rank={bootstrap.process_index()}",
              flush=True)
        return 0
    finally:
        bootstrap.shutdown_distributed()


if __name__ == "__main__":
    sys.exit(main())
