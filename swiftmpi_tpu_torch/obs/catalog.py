"""Declared telemetry series catalog — the ONE list of metric names (the
port's copy of ``swiftmpi_tpu/obs/catalog.py``).

Every instrument registration in the port (``reg.counter(...)``,
``reg.gauge(...)``, ``reg.histogram(...)``, the transfer ledger's
registry mirror, the fault bus's ``_obs_count``) must use a name
declared here, so the port's streams speak the JAX package's names.
The TELEMETRY-CATALOG lint rule enforces the match in both packages
(the port's in ``swiftmpi_tpu_torch/analysis``), and
``tests/test_torch_obs.py`` also checks every series a run writes against
:func:`declared`.

Two declaration forms:

* :data:`SERIES` — exact names.  Labels are NOT part of the identity
  here (the registry's ``name{label=v}`` series keys stay free-form);
  the catalog pins the *name* half of the contract that
  docs/ARCHITECTURE.md "Telemetry plane" documents in prose.
* :data:`PREFIXES` — dynamic families built with f-strings whose
  stem is static (``control/<knob-name>`` gauges, the microbench
  ``micro_<gauge>`` context scalars).  The lint rule checks an
  f-string's leading literal chunk against these.

``transfer/`` series are declared via :data:`TRANSFER_KEYS` (the bare
ledger key, as the registry mirror names it) and expanded into
``SERIES`` below, so the ledger key list lives in exactly one place.
"""

from __future__ import annotations

#: Ledger keys mirrored into the registry as ``transfer/<key>``.
#: All four backends (local/xla/tpu/hybrid) — including the tpu
#: backend's eager-drain paths, which bypass ``_accum_*`` — must book
#: through keys declared here.
TRANSFER_KEYS = frozenset({
    "wire_bytes", "dispatches",
    "window_sparse", "window_dense",            # legacy 2-way decisions
    "window_fmt",                               # 5-way, fmt= label
    "collective",                               # psum|sparse_ar, kind=
    "hot_psum_bytes_saved",                     # sparse_ar wire delta
    "plan_compiles", "plan_cache_hits",         # TrafficPlan compiler
    "coalesced_rows_in", "coalesced_rows_out",
    "pull_bytes", "pull_rows", "pull_hot_rows",
    "pull_cache_hits", "pull_delta_rows",        # delta-pull cache plane
    "pull_bytes_saved",
    "pull_fmt",                                  # pull decisions, fmt=
    "routed_rows", "overflow_dropped",          # tpu routing ledger
    "hot_rows", "psum_bytes",                   # hybrid hot plane
    "membership_changes",                       # elastic epoch adoptions
})

SERIES = frozenset({
    # host phase spans (obs.span) + bench latency publish default
    "phase_ms", "step_ms",
    # input pipeline (io/pipeline.py)
    "pipeline/produced", "pipeline/consumed", "pipeline/queue_depth",
    # training loops (word2vec/glove via Throughput sampler bridge)
    "train/host_stall_ms_total", "train/unstalled_ms_total",
    "train/words_per_sec",
    # checkpoints (io/checkpoint.py)
    "checkpoint/saves", "checkpoint/restores",
    # health probes (utils/health.py)
    "health/probe_ok", "health/probe_fail", "health/probe_ms",
    # fault-injection bus (testing/faults.py)
    "faults/injected", "faults/step_events", "faults/checkpoint_events",
    # serving plane (serve/)
    "serve/queries", "serve/rows_read", "serve/hits", "serve/misses",
    "serve/topk_queries", "serve/latency_ms", "serve/snapshots",
    "serve/snapshot_version", "serve/staleness_steps",
    # snapshot shipping (serve/shipper.py, ISSUE 17): trainer-side
    # publish kind/byte counters (delta_fmt carries a fmt= label) and
    # the replica-side replay gauges ({replica=r<rank>} labeled)
    "serve/delta_publishes", "serve/delta_bytes", "serve/delta_fmt",
    "serve/full_publishes", "serve/full_bytes", "serve/ship_version",
    "serve/replica_version", "serve/replica_lag", "serve/staleness_s",
    # control plane (control/controller.py)
    "control/evaluations", "control/decisions",
    "control/decisions_applied", "control/sketch_observed",
    # fleet observability (obs/collector.py, obs/recorder.py heartbeats)
    "telemetry/heartbeats",
    "fleet/step_ms_skew", "fleet/wire_bytes_imbalance",
    "fleet/members_live", "fleet/members_stalled", "fleet/members_dead",
    "fleet/straggler_rank",
    # numerics health plane (obs/numerics.py, ISSUE 13): in-jit bundle
    # gauges mirrored by NumericsCollector.sampler plus the detector's
    # anomaly severity counter; ef_mass carries a field= label
    "numerics/grad_norm", "numerics/grad_norm_hot",
    "numerics/grad_norm_tail", "numerics/update_ratio", "numerics/loss",
    "numerics/ef_mass", "numerics/nonfinite", "numerics/quant_err",
    "numerics/anomalies",
    # fleet-level numerics mirror (obs/collector.py)
    "fleet/grad_norm_divergence", "fleet/anomalies",
    # compiler & device-cost plane (obs/costs.py, ISSUE 14): per-fn
    # compile/retrace counters and XLA cost/memory-analysis gauges,
    # all labeled fn=<catalog name>
    "compile/compiles", "compile/retraces", "compile/compile_ms",
    "compile/flops", "compile/bytes", "compile/peak_bytes",
    # triggered profiler windows (obs/profiler.py): capture counters
    # and per-phase device/host attribution from the trace parse
    "profile/sessions", "profile/steps",
    "profile/device_ms", "profile/host_ms", "profile/skew_ms",
    # wire-path tracing plane (obs/trace.py, ISSUE 15): flight-recorder
    # volume counters, the last-traced-window gauge smtpu_top's WIN
    # column reads, and the hot-key attribution gauges (key= label)
    "trace/windows", "trace/records", "trace/dumps",
    "trace/last_window_id",
    "trace/hot_key_touches", "trace/hot_key_bytes",
    # elastic membership plane (cluster/membership.py + elastic.py,
    # ISSUE 16): per-rank adopted epoch / workload gauges, the modeled
    # migration-delta traffic, and the fleet-level mirrors
    "elastic/epoch", "elastic/loss", "elastic/rows_owned",
    "elastic/migration_bytes",
    "fleet/epoch", "fleet/reconverge_steps", "fleet/migration_bytes",
    # serve-fleet mirrors (obs/collector.py serve_view, ISSUE 17)
    "fleet/serve_replicas", "fleet/serve_qps", "fleet/serve_lag_max",
    "fleet/serve_version",
}) | frozenset("transfer/" + k for k in TRANSFER_KEYS)

#: Dynamic-name families: an f-string series name passes the catalog
#: check when its leading literal chunk starts with one of these.
PREFIXES = (
    "control/",     # per-knob gauges: control/<knob.name>
    "micro_",       # microbench context gauges: micro_<key>{cell=}
)


def declared(name: str) -> bool:
    """True when ``name`` is a declared series (exact or prefix)."""
    return name in SERIES or any(name.startswith(p) for p in PREFIXES)


def declared_prefix(stem: str) -> bool:
    """True when an f-string whose literal stem is ``stem`` builds
    names inside a declared dynamic family."""
    return any(stem.startswith(p) for p in PREFIXES)
