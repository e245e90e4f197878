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
  shapes after training).  The JSON holds the losses, ``train_metrics``,
  each field's sha256, the kernels' launches in the run and
  ``ring.timeouts()``.
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
    bootstrap.barrier()
    if device == "cpu":
        np.savez(os.path.join(out, f"overflow_r{me}.npz"),
                 **overflow_push(dp, me))
    return {"psum_sha": _bits(psum(mine)), "dp": dp, "rank": me}


#: the overflow case: shard ranks a process, rows a shard, row width,
#: requests a process, the bucket capacity and the learning rate
OVF_SHARDS, OVF_CAP, OVF_D, OVF_B, OVF_C, OVF_LR = 2, 32, 8, 16, 2, 0.3


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
    gives up after ``stall["max_polls"]`` polls, and process
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
    reconcile's (a batch's folded rows), each against gloo on the same
    words (the plain version) and the host route (device -> host, gloo,
    host -> device)."""
    dp = bootstrap.process_count()
    cap = model.table.capacity
    d = model.len_vec
    B = model.train_metrics.get("batch_size", 0)
    shapes = [("dense_plane", (cap, d + 1)),
              ("sparse_rows", (max(B, 1) * 2 * model.window, d + 2))]
    out = []
    for label, shape in shapes:
        x = torch.randn(shape, device=device)
        want = ring.process_all_gather_plain(x.cpu())
        got = ring.process_all_gather(x)
        err = float((got.cpu() - want).abs().max())
        torch.cuda.synchronize()
        bootstrap.barrier()
        reps = 20
        for _ in range(3):
            ring.process_all_gather(x)
        torch.cuda.synchronize()
        bootstrap.barrier()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        for _ in range(reps):
            ring.process_all_gather(x)
        e.record()
        torch.cuda.synchronize()
        ms = s.elapsed_time(e) / reps
        bootstrap.barrier()
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


def run_w2v(spec: dict) -> dict:
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
        model.table.state = state_from_jax(
            init, model.device,
            mesh=model.cluster.mesh if model.transfer.name == "tpu"
            else None)
    if spec.get("stall"):
        stall_process_ring(spec["stall"], me)
    draws, first, times = None, {}, []
    if f"j{me}" in z.files:
        # on the device before the run: a step reads no host draws
        draws = first_step_rows(zip(
            torch.from_numpy(z[f"j{me}"]).to(model.device),
            torch.from_numpy(z[f"u{me}"]).to(model.device)), model, first,
            times)
    for mod in KERNELS.values():
        mod.launches = 0
    ring.process_launches = 0
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    bootstrap.barrier()
    t0 = time.perf_counter()
    losses = model.train(z["corpus"], niters=int(spec.get("niters", 1)),
                         batch_size=int(spec["batch_size"]), draws=draws,
                         checkpoint_path=spec.get("checkpoint"))
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    seconds = t_end - t0
    launches = {name: mod.launches for name, mod in KERNELS.items()}
    launches["ring_process"] = ring.process_launches
    metrics = {k: v for k, v in model.train_metrics.items()
               if isinstance(v, (int, float, str, bool, list, dict))}
    metrics["batch_size"] = int(spec["batch_size"])
    model.train_metrics["batch_size"] = int(spec["batch_size"])
    state = {f: model.table.global_rows(f) for f in model.table.state}
    result = {"rank": me, "dp": dp, "losses": losses, "seconds": seconds,
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
    if spec.get("dump"):
        result["dumped"] = model.save(spec["dump"])
    if spec.get("time_exchange") and cuda:
        result["exchange"] = _time_exchanges(model, model.device)
    return result


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
            for spec in specs if isinstance(specs, list) else [specs]:
                payload = run_w2v(spec)
                _write(spec["out"], mode, bootstrap.process_index(),
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
