"""Per-layer metric readers, one file a metric: ``read(ctx)`` returns the
metric from the traced run's context, or None where there is nothing to
read (then the harness leaves it out of the line).

``ctx`` holds ``train`` (the window call's ``train_metrics``),
``traffic`` (the transfer ledger's delta over a counted call and its
words), ``window`` (the reduced device trace of the profiled groups, a
``benchmark.trace.Window``, or None), ``steps``, ``flops`` and ``bytes``
(of the steps in that window, from ``benchmark/roofline``) and ``peaks``
(the card's row of ``benchmark/peaks.json``)."""
