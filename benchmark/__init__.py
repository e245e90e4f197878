"""The benchmark of ``swiftmpi_tpu_torch``: one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, the
configurations, the metrics and their bounds.  Everything else is found
by name under this folder: a configuration in ``configs/<name>.json``, a
traffic mix in ``workloads/<traffic>.json``, a per-layer metric's reader
in ``metrics/<metric>.py``, a kernel's byte or FLOP count in
``roofline/``, the limits of a cell's output check in
``limits/<cell>.json``, and the plain reference that decides ``correct``
in ``reference/``.  Nothing here imports ``jax`` or the JAX package.
"""
