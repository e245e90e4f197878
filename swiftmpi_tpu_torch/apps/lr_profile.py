"""Time and profile logistic-regression training of the port on the card,
through ``LogisticRegression.train``, at the repository's two shapes:

* ``a9a`` (bench.py's ``_bench_lr``): ``synthetic_dataset(32_561, 123,
  14, seed=3)``, minibatch 8,192, server lr 0.05, capacity
  ``max(64, int(123 * 1.3) + 1)`` = 160: an epoch is 4 batches (the last
  padded), each pulling 114,688 width-1 rows and pushing them dense;
* ``wide`` (the url/kdd-scale feature space of the JAX docstring):
  ``synthetic_dataset(50_000, 3_231_961, 115, seed=5)`` (url's feature
  count and mean nnz, cut from 2,396,130 rows to 50,000), minibatch
  1,000, the table starting at 65,536 rows: the first epoch grows it six
  times, to 4,194,304, and its pushes go dense while the capacity is at
  most 230,000 slots, sparse above.

    python -m swiftmpi_tpu_torch.apps.lr_profile [-shape a9a|wide] \\
        [-dense 1] [-inner 4] [-shards 8] [-epochs 32] \\
        [-trace build/lr_trace.json]

``-dense 1`` sets ``[worker] dense_features: 1`` (the capacity-dense
rendering), ``-inner N`` ``[worker] inner_steps`` (CUDA graphs on
``transfer: xla``), ``-shards n`` the sharded parameter server with its n
ranks on the card.  One untimed epoch first (the build, the growths of
``wide``, the graph captures: ``first_epoch_s``, ``growths``), then:

* ``rows_per_sec``: real rows over the host clock of ``train(niters =
  epochs)``, which ends in a synchronize (an a9a epoch is only 4 batches:
  many epochs a run, as bench.py runs 128 an epoch dispatch);
* ``device_ms_per_step``: the card's busy time (the union of its kernels'
  and copies' intervals) in one more profiled epoch (``torch.profiler``),
  per step; ``idle_share`` ``1 - busy time / the timed run's time per
  epoch``;
* ``by_kernel_ms_per_step``, ``host_ops_per_step`` and
  ``by_host_op_ms_per_step`` as ``w2v_profile.py`` gives them;
* ``peak_device_mib`` over the timed epochs, ``table_mib``.

Prints one JSON object; ``-trace`` also writes the profiled epoch's Chrome
trace.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.apps.w2v_profile import (_device_busy,
                                                 _host_by_op, card_line)
from swiftmpi_tpu_torch.data.libsvm import synthetic_dataset, to_csr
from swiftmpi_tpu_torch.models.logistic import LogisticRegression
from swiftmpi_tpu_torch.utils import CMDLine, ConfigParser

#: shape -> (synthetic_dataset arguments, minibatch, capacity per shard)
SHAPES = {
    "a9a": (dict(n=32_561, dim=123, nnz=14, seed=3), 8_192,
            max(64, int(123 * 1.3) + 1)),
    "wide": (dict(n=50_000, dim=3_231_961, nnz=115, seed=5), 1_000,
             1 << 16),
}
#: bench.py's LR settings
LR_CONF = {
    "cluster": {"transfer": "xla", "server_num": 1},
    "server": {"initial_learning_rate": 0.05, "frag_num": 2000},
}


def lr_model(shape: str, dense: int = 0, inner: int = 1, shards: int = 0,
             device="cuda") -> tuple:
    """The model and CSR data of a shape: ``(model, data)``."""
    spec, minibatch, cap = SHAPES[shape]
    conf = ConfigParser().update(LR_CONF)
    conf.update({"worker": {"minibatch": minibatch, "inner_steps": inner,
                            "dense_features": dense}})
    if shards:
        conf.update({"cluster": {"transfer": "tpu", "server_num": shards}})
        cap = -(-cap // shards)
    model = LogisticRegression(config=conf, capacity_per_shard=cap,
                               device=device)
    return model, to_csr(synthetic_dataset(**spec))


def profile(shape: str = "a9a", dense: int = 0, inner: int = 1,
            shards: int = 0, epochs: int = 32, trace: str = "") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("lr_profile measures the card; no CUDA device "
                           "is available")
    t0 = time.perf_counter()
    model, data = lr_model(shape, dense, inner, shards)
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.train(data, niters=1)
    first_s = time.perf_counter() - t0
    first = dict(model.train_metrics)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    model.train(data, niters=epochs)
    m = model.train_metrics
    launches = kernels.launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        model.train(data, niters=1)
    steps = model.train_metrics["steps"]
    busy_ms, by_kernel = _device_busy(prof)
    host_by_op, host_calls = _host_by_op(prof)
    if trace:
        prof.export_chrome_trace(trace)
    epoch_ms = m["seconds"] / epochs * 1e3
    return {
        "card": card_line(), "shape": shape, "rendering": m["rendering"],
        "inner_steps": inner, "fused": m["fused"],
        "shards": model.cluster.n_servers, "rows": len(data),
        "minibatch": model.minibatch, "epochs": epochs,
        "steps_per_epoch": steps, "data_seconds": data_s,
        "first_epoch_s": first_s, "growths": first["growths"],
        "capacity": model.table.capacity,
        "first_epoch_push_paths": first["push_paths"],
        "seconds": m["seconds"], "rows_per_sec": m["records_per_sec"],
        "epoch_ms": epoch_ms, "graph_replays": m["graph_replays"],
        "launches_per_step": {k: v / m["steps"]
                              for k, v in launches.items()},
        "loss": model.train_metrics["epoch_err"][-1][0]
        / max(model.train_metrics["epoch_err"][-1][1], 1),
        "device_ms_per_step": busy_ms / steps if busy_ms
        else "not measured",
        "idle_share": (1 - busy_ms / epoch_ms) if busy_ms
        else "not measured",
        "by_kernel_ms_per_step": {k: v / steps for k, v in by_kernel.items()},
        "by_host_op_ms_per_step": {k: v / steps
                                   for k, v in host_by_op.items()},
        "host_ops_per_step": host_calls / steps,
        "table_mib": sum(t.numel() * t.element_size()
                         for v in model.table.state.values()
                         for t in (v if isinstance(v, list) else [v]))
        / 2 ** 20,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
    }


def main(argv=None) -> int:
    cmd = CMDLine(argv)
    cmd.registerParameter("shape", "a9a (default) | wide")
    cmd.registerParameter("dense", "1: [worker] dense_features: 1")
    cmd.registerParameter("inner", "[worker] inner_steps (default 1)")
    cmd.registerParameter("shards", "n: the sharded parameter server with "
                          "n ranks on the card")
    cmd.registerParameter("epochs", "timed epochs (default 32)")
    cmd.registerParameter("trace", "write the profiled epoch's Chrome "
                          "trace here")
    out = profile(cmd.getValue("shape", "a9a"),
                  int(cmd.getValue("dense", "0")),
                  int(cmd.getValue("inner", "1")),
                  int(cmd.getValue("shards", "0")),
                  int(cmd.getValue("epochs", "32")),
                  cmd.getValue("trace", ""))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
