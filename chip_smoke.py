#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (``swiftmpi_tpu_torch``) on one
CUDA card, at the full width of the reference word2vec configuration
and of bench.py's transformer cell (phases 17 and 18), and at the
reference's deployment width of 4 and 8 processes (phase 20).

    python3 chip_smoke.py          # from the repository root

The configuration is demo.conf's (len_vec 100, window 4, negative 20,
sample 1e-5, learning_rate 0.05, server lr 0.7, minibatch 5000, transfer
xla, one server) on the text8-shaped synthetic corpus
``synthetic_corpus_bulk(17_000, 70_000, 1_000, seed=42)``, vocab counted
over the whole corpus, in four renderings (``PATHS``): ``gather`` (the
default), ``stencil`` (``stencil: 1``), ``stencil_shared`` (+
``shared_negatives: 1``, pool 1024) and ``shared``; and the sharded
parameter server (``[cluster] transfer: tpu``, ``server_num: 8``: eight
logical ranks, each with its own table shard and buffers, all on the one
card) in the ``gather`` and ``shared`` renderings (``gather@8``,
``shared@8``); and with bf16 tables (``[server] dtype: bfloat16``: h and v
bfloat16, accumulators float32) in ``gather``, ``stencil`` and
``gather@8`` (``gather:bf16``, ``stencil:bf16``, ``gather@8:bf16``); and
word2vec's other training modes: skip-gram (``sg``, ``sg_shared``, also
``sg@8`` on the sharded server and ``sg:bf16``), ``dense_logits: 1``
(``dense``), the snapshot async mode (``async``: ``local_steps: 4``) and
hogwild (``hogwild``: 8 workers, the card eight times in the model's
cluster, x ``local_steps: 2``), the last two in the gather rendering.
Phases, each of which raises on a failed check:

1. setup: the card's name and power limit; build the CUDA kernels.
2. kernels: each kernel at the shapes one step of its path gives it —
   the gather path's pulls, push (sums and counts in one launch) and
   AdaGrad calls (over the table with the mean's divisor fused, and
   row-indexed on the sparse v push's rows), the stencil path's context
   sum from the stencil batch itself (a real stencil batch with extra pad
   centers and a shuffled block of centers), its mostly-padding h push
   and ``push_span``'s AdaGrad on the span's owner rows, and the sharded
   path's ring exchange of its request, row and odd-width buckets
   (stacked, one send and one wait launch), the eight owners' h pull, h
   push with counts and AdaGrad with the mean's reciprocal, each in one
   launch; and the bf16 forms the bf16 paths run (the pulls' bf16 rows,
   the mixed AdaGrad over the table, the block and the rows, the context
   sum over a bf16 table, the ring on bf16 row buckets); and skip-gram's
   h pull and push of B*2W*(K+1) = 840,000 rows (f32 and bf16 rows), on
   the sharded path its ring exchange at C = 105,000 slots a rank and
   the eight owners' pull and push of 840,000 rows each — against its
   plain PyTorch version on the card (bit for bit, except B3's float
   sums), timed with CUDA events (median of 25 launches, L2 flushed
   between launches, the host's enqueue not timed) beside the plain
   version and one library call.
3. step parity: one step on the card and the same step on the CPU from
   the same table and the same negative-sampling draws, for ``gather``,
   ``stencil``, ``stencil_shared``, ``gather:bf16`` and ``stencil:bf16``;
   and one sharded ``gather`` step, float32 and bf16, against the sharded
   CPU step and, row for row by key, against the one-shard ``xla`` step
   on the card; one step of ``sg``, ``sg_shared`` and ``dense``; one
   window of the snapshot mode (4 steps through ``train``); and one
   hogwild group (8 workers x 2 steps, then the 16 pushes worker-major),
   each on the card and on the CPU from the same table and draws, with
   exactly the path's launches.  float32 fields within 1e-5 + 1e-3|b|;
   bf16 fields within
   that envelope or one bfloat16 ulp of b, whichever is wider (the card
   sums some grads in another order, a float32 difference that can cross
   a rounding boundary; near zero a bfloat16 step is finer than 1e-5).
4. train: ``Word2Vec.train`` over a corpus prefix (>= 20 steps) for each
   rendering, every launch counter set to 0 just before; the run must have
   launched exactly the kernels of its path (the stencil kernel on every
   step of a stencil path) and the loss must be finite.
   A sharded run must launch the ring kernel once (one send, one wait)
   for every exchange of every step, the gather once per pull, the
   scatter-add and AdaGrad once per pushed family (each for all the
   card's ranks), overflow nothing and time out no wait.  The new modes'
   runs launch exactly steps x their path's launches a step
   (``PER_STEP``; hogwild's steps are whole groups, each batch applied
   on its worker's replica and again on the chain).  Then ``sg`` with
   ``inner_steps: 8``: graph replays, the same launches a step.
5. input: the whole text8-shaped corpus written as a token file and
   loaded by the native C++ loader (``data/native.py``, built with g++
   from ``native/*.cpp``; its vocab must equal ``build_vocab``'s), then
   one full epoch through ``Word2Vec.train`` in the five runs of
   ``apps/input_profile.py`` (``INPUT_RUNS``): (a) gather on the native
   ``PrefetchingCBOWBatcher`` with ``pipeline: 0``, ``inner_steps: 1``;
   (b) (a) with ``pipeline: 4``; (c) (b) with ``inner_steps: 8`` (one
   CUDA graph replay a group); (d) stencil with ``pipeline: 4``,
   ``inner_steps: 8``; (e) gather on the Python ``CBOWBatcher``, the
   baseline; and (a2), a rerun of (a).  (a2),
   (b) and (c) take (a)'s steps and words and reach its loss within 1e-4
   relative and its Σerr_cnt within 1e-6; every run launches its path's
   kernels exactly once per step (graph replays included,
   ``STEP_LAUNCHES``) and every loss is finite.  Their tables are
   reported against (a)'s, not held to the envelope: B3's and
   ``index_add_``'s float sums land in no fixed order, and the training
   carries that last-bit difference far past the envelope within tens of
   steps, so a rerun of (a) leaves it as far as (b) and (c) do (the card
   tests hold graph replays to plain steps exactly with deterministic
   sums).
6. CLI: ``apps.w2v_main.main`` on a small corpus with the gather conf,
   with ``stencil: 1``, with ``transfer: tpu``, ``server_num: 8``, with
   ``[server] dtype: bfloat16``, with ``[worker] pipeline: 2``,
   ``inner_steps: 4``, and with ``-variant async`` and ``-variant
   hogwild`` (BKDR keys); each run must load through the native loader
   and each dump must parse (the bf16 one into bfloat16 values) and hold
   one row per word of the vocab of its key mode.
7. checkpoints, resume and sent2vec: for ``gather``, ``gather:bf16`` and
   ``gather@8`` an npz checkpoint of a trained card table (save and load
   seconds, bytes) restores bit for bit into a fresh card model, in place,
   and into a CPU model, and one step after the resume agrees with the
   uninterrupted model's step to the envelope, with the path's launches;
   ``train_with_resume`` with ``crash_at_step(2)`` and
   ``corrupt_checkpoint(at_save=2)``, ``retain=3``, niters 4, CUDA graphs
   (``inner_steps: 8``) and the hang watchdog: 3 iterations rerun, the
   last loss within 20% of an uninterrupted run, the graphs kept across
   the resume; the CLI's ``-checkpoint`` crashing through
   ``SMTPU_FAULT_PLAN`` and then rerun to a full dump; and sent2vec over
   the card's dump, loaded into 65,536 rows and grown to 131,072, at
   bench.py's shape (1,024 sentences of 64 words, 10 passes) against the
   CPU with the same draws, with B2's launches per batch and its cases at
   sent2vec's shapes (timed as in phase 2).
8. logistic regression, GloVe and the embedding index: B1-B3 at their
   shapes, timed as in phase 2 — the a9a shape's (``lr_profile.SHAPES``:
   ``synthetic_dataset(32_561, 123, 14, seed=3)``, minibatch 8,192,
   capacity 160) pull of 114,688 width-1 rows, its dense push onto 160
   slots (~930 a slot) with counts and AdaGrad over the (160, 1) table
   with the counts' divisor; the wide shape's (3,231,961 features, 115 a
   row, minibatch 1,000) pull, dense push and table apply at 131,072 rows
   and its sparse push's rows at 4,194,304; GloVe's (bench.py's shape,
   ``glove_profile.py``) 8,192-row pulls of w and b and its pushes' rows;
   and B5 on LR's and GloVe's sharded buckets at width 1 (also with
   blocks that are not 16-byte aligned) and 100.  One LR step in each
   rendering and one GloVe step, card against CPU (the envelope).
   ``LogisticRegression.train`` at the a9a shape for 8 epochs in the
   sparse (``lr``) and dense (``lr_dense``) renderings with
   ``inner_steps: 4`` (an epoch one graph replay after the first), and on
   ``tpu@8``; one wide epoch with ``inner_steps: 4``, whose table grows six
   times mid-epoch (65,536 -> 4,194,304 rows; the graphs dropped and
   captured anew), against the same epoch one step at a time (the loss
   within 1e-4); ``GloVe.train`` with ``inner_steps: 8`` and
   ``pipeline: 4`` (two epochs, graph replays) and on ``tpu@8``.  Each
   run launches exactly its path's kernels a step (``LR_GLOVE_STEP``).
   The CLIs: ``lr_main`` train -> predict -> eval on a libSVM file the
   script writes (the native parser must read it), ``glove_main`` ->
   ``w2v_eval`` on its dump, and ``w2v_eval`` on a word2vec dump, its
   neighbours on the card against the CPU.

9. the hybrid transfer and the traffic ledger: bench.py's scale_hybrid
   shape (``w2v_profile.SCALE_CONF``: 1,000,000 keys with bench.py's
   counts, len_vec 100, stencil with a shared pool of 4,096, one shard;
   the head calibrated at minibatch 5,000) through ``Word2Vec.train`` for
   ``SCALE_STEPS`` steps of 16,384 centers, spans drawn from the
   vocabulary's counts; B2 (the hot pull of a reference step's h and v
   slots), B3 (their hot push onto ``(n_hot, 100)`` with counts), B1 over
   the reference and scale_hybrid hot planes with the mean's reciprocal,
   and B5 on the tail's rows, timed as in phase 2; one ``hybrid@8`` step
   (gather, and stencil with the span pulled through the transfer) on the
   card against the CPU, hot planes included, with ``HYBRID_STEP``'s
   launches; ``Word2Vec.train`` of the reference configuration on
   ``hybrid@8`` and on ``gather@8`` over the same batches with
   ``count_traffic``, the hybrid run launching exactly ``HYBRID_STEP`` a
   step and conserving rows (hybrid's ``routed_rows + hot_rows`` equals
   tpu's ``routed_rows``); the hybrid table's npz (``n_hot``, ``@hot``
   planes) reloaded on the card bit for bit, in place; and ``gather`` on
   ``xla`` with ``inner_steps: 8`` whose graph replays book exactly the
   ledger the plain loop books.
10. the window-coalesced push (``[cluster] push_window: 4``): B3 and B5
   at the shapes one window of four reference gather steps on ``tpu@8``
   gives them (the per-rank dedup's sums, 8 x 52,500 h rows onto as many
   slots with counts; the exchange of the deduplicated rows with their
   counts column, buckets of 52,500; the owners' sums; the dense rung's
   plane, 420,000 rows onto the global (90,512, 100) plane with counts),
   timed as in phase 2; one window (a group of four steps) on
   ``window@8`` (``tpu``) and ``hybrid_window@8`` on the card against the
   CPU from the same table and draws, with exactly ``WINDOW_GROUP``'s
   launches and the same ledger, whose window keys and coalesced rows the
   line prints; and ``Word2Vec.train`` with ``inner_steps: 8`` on both,
   on ``xla`` (``window:xla``, each group one graph replay) and on
   ``window_dense@8`` (``tpu`` without the expected-unique hint, so every
   window takes the dense rung), each launching exactly its path's
   kernels.

12. the telemetry plane (``obs/``): (a) the reference ``gather`` path on
   ``xla`` with ``inner_steps: 8`` (graph replays) through
   ``Word2Vec.train`` with ``[worker] telemetry``, ``[obs] numerics``,
   ``costs`` and ``profile_at: 4, profile_steps: 2``: exactly
   ``STEP_LAUNCHES`` a step, the registry's ``transfer/*`` equal to
   ``traffic()``, the JSONL read by ``scripts/telemetry_report.py``, one
   numerics bundle a dispatch, and a group's bundle against a plain-torch
   recomputation from its entry and exit tables (the envelope), the
   catalog's graph captures with no retrace, the profiler window's trace
   holding B1-B3 kernel events; (b) ``window_q@8`` with ``[obs] trace``
   and numerics: the window records' encoded bytes equal to the ledger's
   ``wire_bytes``, the quantization-error series finite and > 0; (c) the
   planes' cost at the reference shape: host ms and device ms a step and
   words/s with every plane off, telemetry on, + numerics and + trace, at
   ``telemetry_every`` 1 and 64 (printed on ``telemetry_cost`` lines).

13. serving and control in the training process: (a) ``hybrid@8`` at
   the reference shape with ``[control] control: on, every: 8, margin:
   0.02, consecutive: 2, decay: 0.3`` and ``[serve] every: 8`` over a
   corpus prefix whose second part swaps every other key of the hot head
   for a tail key (JAX's ``_drift_setup``), with two reader threads
   running ``read`` and ``topk`` while it trains: at least one ``hot_k``
   repartition with moved rows, every key's unified row right after it
   equal to its row right before it, bit for bit, read on the host by
   key (and its ms); every snapshot's planes equal, by a per-plane sum of
   their bits, to the trainer's table at its version, checked after
   training moved on; the readers saw numpy planes only (their p50/p99
   and queries/s printed); exactly ``HYBRID_STEP`` launches a step, and
   B1-B3 and B5 at the shapes a step gives them after the repartitions,
   timed as in phase 2; (b) ``xla`` with ``inner_steps: 8``,
   ``push_window: 4``, ``wire_quant: int8``: the controller widens the
   window during ``train`` and each apply is followed by one recapture
   of each group length run after it (its ms printed); two twins from one
   seed, one replaying graphs and one eager, a window-width apply between
   their groups, bit for bit (deterministic sums: lossless windows,
   ``TWIN_BATCH`` centers so every push is sparse; an int8 window folds
   its duplicates with B3's float atomics); an injected EF runaway demotes
   ``wire_quant`` to ``off`` at the next safe point and the next graphed
   run books no quantized window; (c) sent2vec at bench.py's shape over a
   snapshot of (b)'s table (its planes uploaded, the ms printed) equals
   sent2vec over the live table at that version, bit for bit with the
   same draws, with B2's launches; (d) ``snapshot_topk`` on the card
   against the host path over (a)'s last snapshot; (e) words/s of the
   graphed gather path with ``[serve] every`` 0, 8 and 64 and each
   publish's ms.

14. more than one rank process on the card: ``python -m
   swiftmpi_tpu_torch.launch -np 2 -- python -m
   swiftmpi_tpu_torch.testing.mp_child w2v`` trains the reference
   configuration as one data-parallel job (``BATCH / 2`` centers a
   process, each process's shard of the 800-sentence prefix, 2 epochs,
   numpy draws), (a) on ``xla`` and (b) on ``tpu`` with 4 shard ranks a
   process; a child's failure fails the launch and the phase.  Each run
   against a one-process run of the port over the same global batches
   and draws (run twice: the second, warm, gives the one-process times
   and shows how far two one-process runs drift apart): the replicas'
   per-field sha256 equal, ``timeouts() == 0`` on every process, rank
   0's table after the first step within the envelope, the loss
   trajectory within 1e-4 relative, exactly ``PROC_STEP`` launches a
   step (B5's cross-process form included); printed: global words/s
   and the host ms a step over the run's second half against the
   one-process run's, the lockstep's host ms a step, the final tables'
   gap.  (a) also times B5's cross-process all-gather (its wait a
   stream wait: no kernel polls) at the dense plane's and the sparse
   reconcile's shapes against its bound and the host route (device ->
   host, gloo, host -> device), and holds that a waiting process holds no
   SM: process 1's fixed work runs within ``PROGRESS_SLACK`` of its time
   alone while process 0 waits on its send.  (c) ``server_num:
   2`` on ``xla`` in one process: every key's rows after a step within
   the envelope of ``server_num: 1``'s, and after 4 steps no further from
   them than a second ``server_num: 1`` run drifts (B3's atomics).

15. fleets on the card, through the port's supervised launcher: (a)
   restart-the-world, ``launch -np 2 -max-restarts 1 -backoff 0.2
   -fleet-dir D -- w2v_main -checkpoint`` with phase 14's configuration
   (``xla``, 2,500 centers a process) on the 800-sentence prefix, 4
   iterations, rank 1 SIGKILLed once at the top of iteration 2
   (``SMTPU_FAULT_PLAN``, a marker file): the launcher returns 0, the
   supervisor log holds 4 spawns, rank 1's own exit (rc 137, not
   ``by_supervisor``) and one restart, the FleetCollector merges rank 1's
   two lives, both processes of the second life resume at iteration 2,
   only process 0 writes the dump, the final loss is within 20% of the
   same run unkilled, no ring wait timed out, and every kernel of the
   path launched; printed: the seconds from the kill to the restarted
   world's first step.  (b) elastic, ``launch -np 4 -elastic 1
   -dead-after 8`` over ``testing.fleet_child`` with 16 shards of 8,192
   rows of 100 floats on each rank's card tensor, rank 2 SIGKILLed at
   step 20: the epoch reaches 2 with a committed rejoin, the kill is
   organic, no death is unnoticed, no rank is killed as hung, every rank
   exits 0 with its rows on ``cuda``, every key in exactly one census,
   reconvergence, migration bytes; printed: death -> commit and join ->
   commit seconds, the migration bytes.  (c) the serve fleet, ``launch
   -serve 2`` over ``testing.serve_child`` with the trainer's planes on
   the card, replica 1 SIGKILLed at step 20: every replica life's
   versions monotone, the killed replica restarted and replayed to the
   manifest tail, the kill attributed, no death unnoticed; printed: its
   resync seconds, p50 and p99.  B1-B3 at the shapes of (a)'s step and
   B2 at an elastic export's shape, timed as in phase 2.

16. the rest of the data axis: one launch of ``python -m
   swiftmpi_tpu_torch.launch -np 2 -- mp_child w2v -spec`` runs every job
   of the JAX package's across-process hooks in one process group, at
   phase 14's configuration (2,500 centers a process, 1 epoch of the
   800-sentence prefix, numpy draws): (a) ``hybrid`` with 4 shard ranks
   a process and its hot head, ``collective: sparse_allreduce`` and
   ``push_window: 4`` armed (``train`` fuses no group across processes,
   so every push is the per-step hot psum, as in JAX); (b) ``xla`` with
   ``pull_quant: bf16``, ``pull_cache: 8`` and ``[serve] every: 8``; (c)
   ``tpu@4`` with ``push_window: 4, wire_quant: int8`` against the
   one-process ``push_window: 1`` run (its ``@ef`` planes zero), and two
   transfer-level window pushes of 4 x 20,000 rows a process (``tpu@4``
   with ``wire_quant: int8``, ``hybrid@4`` with ``collective:
   sparse_allreduce``), each held by the child against one process's push
   over the concatenated windows; (d) LR at the a9a shape and GloVe at
   phase 8's shape, on ``xla`` and ``tpu@4``; (e) sent2vec over (a)'s
   trained replica.  Every job's replicas equal to the bit and no ring
   wait timed out; (a)-(c)'s losses within 1e-4 relative of the
   one-process run over the same global batches and draws and their
   tables after the first step within the envelope; LR's and GloVe's
   tables by key within the envelope, their losses within 1e-4; the
   quantized window's fields with at most ``LOSSY_SHARE`` of their
   elements outside the envelope; the lossless window's tail fields
   within it, its ``@hot`` fields with at most ``DA_SUM_ORDER_SHARE``
   outside, none by more than ``DA_SUM_ORDER_GAP`` (a hot row sums ~700
   rows in another order); sent2vec's vectors within the envelope of one
   process's over the same table.  Printed: global words/s, rows/s,
   cells/s and sents/s beside the one-process run's, and B5's
   cross-process all-gather at the hot plane's, the dense plane's and
   the error-feedback window's shapes against its bound.  B1 and B3 at
   (a)'s hot push and hot plane and B3 at the error feedback's
   slice-by-slice bank (``PROCS`` x ``server_num`` slices onto the
   window's table) are each held against their plain versions on the
   card.  B1-B3 and B5 (both forms) must each have launched.
17. the transformer family (``models/{transformer,trainer}.py``,
   ``parallel/``), at bench.py's width (vocab 8,192, d_model 512, 8
   heads, d_ff 2,048, 512 tokens a sequence): (a) ``Trainer`` with 4
   layers in bf16 at batch 64 (~21.0 M parameters, AdamW), 1 warm step,
   5 timed through ``run(pipeline=2)`` (host batches prefetched and
   copied to the card by its producer), then one profiled step:
   tokens/s, step ms, peak memory, the
   share of the 989 TFLOP/s bf16 peak by bench.py's FLOP model, device
   time by kernel; before it, two float32 steps at 2 layers on the card
   against the CPU port's (losses within 1e-4, every leaf within the
   envelope but for at most ``TFM_OUTSIDE_SHARE`` of it); (b) Ulysses and
   (c) ring attention over ``seq`` = 4, 2 layers, float32: logits and
   every ``lm_loss`` gradient against full attention's within JAX's rtol
   2e-4, atol 2e-5, B5 launched 4 times a layer forward and as many
   backward in (b); (d) expert-parallel MoE, 8 experts over ``expert`` =
   4 at d 512, d_ff 2,048, 16 x 512 tokens, capacity factor 8, against
   the dense reference (output, aux, gradients), B5 launched twice
   forward and twice backward; (e) the pipelined trunk over ``stage`` = 4,
   8 microbatches, against the plain forward (within (b)'s tolerance:
   the microbatches' products sum in another order).  B5 is timed at (b)'s
   (float32 and bf16) and (d)'s exchange shapes against its byte bound,
   its plain version and ``x.transpose(0, 1).contiguous()``.
18. the trainer across processes and ``data_plane``: (a) one launch of
   ``PROCS`` processes (``launch -np 2 -- mp_child w2v`` with trainer
   jobs) trains bench.py's bf16 cell on 32 x 512 tokens each (64 x 512
   global; 1 warm step, 3 timed, B5's all-gather timed at the grads'
   packed shape against its bound and the host route) and its float32
   twin at 2 layers (8 x 512 global), (b) a small MoE model (4 experts
   over ``expert`` = 2 in each process, capacity factor 4), each held
   against one process on the card over the same global batches: the
   replicas equal by sha256, the losses within the trainer's bf16
   tolerance (bf16) or the envelope, the float32 and MoE checkpoints leaf
   by leaf within the envelope but for ``TFM_OUTSIDE_SHARE``, process 0's
   checkpoint loaded in one process holding the replicas' bits and
   stepping on as a second load does (deterministic kernels), B5 across
   processes once a step (MoE: also twice a layer for the densities,
   and in process four times a layer); (c) word2vec on ``tpu@8`` and with
   ``stencil`` under ``data_plane: xla`` and ``auto`` from one table: the
   losses within 1e-4, the ``tpu`` pulls bit for bit, B4 and B5 no launch
   under ``xla``; the ring and stencil sweeps record this card's verdicts
   into a temporary store, ``auto`` follows them, a planted library
   verdict and ignores one from another stack.
19. the JAX package's last names: (a) on ``gather`` (``inner_steps: 4``,
   graphed) and ``gather@8``, a model and its eager twin from one table
   train over a corpus prefix, both ``grow`` to twice their capacity a
   shard, the probe keys' ``embedding`` rows keep their bits, and both
   train over the next prefix: the graphs recaptured, B1-B3 (B5 on
   ``@8``) launched after the growth, the twin's losses within 1e-4 and
   each field's update after the growth within ``GROW_UPDATE_RTOL`` of
   the twin's (B3 sums in no fixed order; the card tests hold the
   growth bit for bit with deterministic sums), the drift from the twin
   before and after the growth reported, ``embedding_index`` built and
   queried; B1-B3
   (B5) timed at the grown table's shapes; (b) ``SGDAccess`` pulls and
   pushes a real batch's rows through ``xla`` and ``tpu@8`` on the card
   and on the CPU from the same table: the pull bit for bit, the tables
   within the envelope; (c) ``reduce_scatter`` and ``pmean`` across the
   processes, a ``collectives`` job in phase 18's launch, at xla's
   (90,516, 101) plane and the packed grads: bit for bit to numpy's
   process-order sum and to gloo, B5 across processes timed beside
   ``psum_many`` with the byte bound.
20. the reference's deployment width: (a) one launch of 4 processes
   (``BATCH / 4`` centers a process, 1 epoch of phase 14's prefix, numpy
   draws) over ``xla`` with float32 and with bf16 tables, ``tpu`` and
   ``hybrid`` with 2 shard ranks a process, and the trainer's float32
   twin (phase 18's, 8 x 512 tokens global); (b) one launch of 8
   processes over ``xla`` and a ``collectives`` job (``reduce_scatter``
   and ``pmean`` at xla's plane and the packed grads, cut to multiples of
   8 rows). Each word2vec job held as phase 14 holds 2 processes: the
   replicas' sha256 equal, ``timeouts() == 0``, rank 0's table after the
   first step within the envelope of the one-process run over the same
   global batches and draws (bf16: or one ulp), the losses within 1e-4,
   exactly ``PROC_STEP`` launches a step on every process (the table's
   entries do not depend on the process count), and every reconcile's
   exchange float32 or int32 (no bf16 on the wire); the trainer as phase
   18 holds its twin, B5 across processes once a step; the collectives
   bit for bit to numpy and to gloo. Printed: B5's cross-process
   all-gather at phase 14's shapes at 2, 4 and 8 processes against its
   bound, gloo and the host route; global words/s at 1, 2, 4 and 8
   processes beside ``os.cpu_count()``. (c) ``apps/async_envelope.py``
   over 8 processes, ``local_steps`` 1, 4 and 16, 4 epochs, both
   configurations in one launch: at the reference configuration on
   1,600 sentences with the whole vocab, every setting's losses finite
   and its last epoch under its first (the JAX package misses its
   child's 20% there too: ``tests/_envelope_witness.py``); at the JAX
   child's configuration, ``local_steps`` 4's final loss within 20% of
   sync's; both sweeps' gaps printed.

The line before the last is the ``{"kernels": [...]}`` summary, each
kernel's ``launches`` read from the train run of its path (the sent2vec
cases from the sent2vec inference run, phase 8's, 9's and 10's from
their paths' train runs, phase 13's from (a)'s run and (c)'s inference
over the snapshot, phase 14's from (a)'s and (b)'s processes, phase 15's
from the second life of (a)'s processes and from (b)'s elastic children,
as they log them, phase 16's from its jobs' processes, phase 17's from
(b)'s and (d)'s forward and backward passes, phase 18's from (a)'s bf16
job's processes, phase 19's from (a)'s train runs after the growth and
(c)'s job, phase 20's from its ``xla`` jobs' rank 0); the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints neither.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from swiftmpi_tpu_torch import kernels
from swiftmpi_tpu_torch.apps import glove_main, lr_main, w2v_eval, w2v_main
from swiftmpi_tpu_torch.apps.glove_profile import glove_model
from swiftmpi_tpu_torch.apps.lr_profile import SHAPES, lr_model
from swiftmpi_tpu_torch.cluster import Cluster
from swiftmpi_tpu_torch.apps.input_profile import (INPUT_RUNS, epoch_line,
                                                   load_native, run_batcher)
from swiftmpi_tpu_torch.apps.stencil_sweep import (batch_inputs,
                                                   context_sum_bytes)
from swiftmpi_tpu_torch.apps.w2v_profile import (BATCH, DEMO_CONF,
                                                 SCALE_BATCH, SCALE_CONF,
                                                 TEXT8_CORPUS, ZipfSpans,
                                                 card_line, scale_vocab)
from swiftmpi_tpu_torch.data import native
from swiftmpi_tpu_torch.data.libsvm import (iter_minibatches,
                                            synthetic_dataset, to_csr)
from swiftmpi_tpu_torch.io.checkpoint import (load_checkpoint, npz_path,
                                              save_checkpoint)
from swiftmpi_tpu_torch.io.resilience import train_with_resume
from swiftmpi_tpu_torch.data.text import (CBOWBatcher, StencilBatch,
                                          build_vocab, load_corpus,
                                          synthetic_corpus,
                                          synthetic_corpus_bulk,
                                          write_tokens_file)
from swiftmpi_tpu_torch.kernels import (adagrad, build, gather, ring,
                                        scatter, stencil)
from swiftmpi_tpu_torch.models.embedding import EmbeddingIndex
from swiftmpi_tpu_torch.models.glove import GloVe
from swiftmpi_tpu_torch.models.logistic import LogisticRegression
from swiftmpi_tpu_torch.models.sent2vec import (Sent2Vec,
                                                build_word_model_from_dump)
from swiftmpi_tpu_torch.ops.sampling import (build_unigram_alias,
                                             sample_alias_from_draws,
                                             sample_alias_slots_from_draws)
from swiftmpi_tpu_torch.models.word2vec import (Word2Vec, _batch_fields,
                                                _cbow_targets,
                                                _parity_targets, _sg_targets,
                                                w2v_parser)
from swiftmpi_tpu_torch.parameter.key_index import HotColdPartition, KeyIndex
from swiftmpi_tpu_torch.parameter.sparse_table import (shard_block,
                                                       split_rows)
from swiftmpi_tpu_torch.testing import faults
from swiftmpi_tpu_torch.testing.faults import FaultPlan
from swiftmpi_tpu_torch.testing.mp_child import (_rows_by_key, _window_data,
                                                 first_step_rows,
                                                 lockstep_epochs,
                                                 steady_step_ms)
from swiftmpi_tpu_torch.transfer.api import window_owners
from swiftmpi_tpu_torch.utils import ConfigParser, reset_global_config

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

#: rendering -> ([word2vec] keys, the kernels its train run launches, the
#: corpus prefix it trains over: >= 20 steps at sample 1e-5, where a
#: stencil span fills at about 800 real centers)
PATHS = {
    "gather": ({}, {"gather", "scatter", "adagrad"}, 800),
    "stencil": ({"stencil": 1}, {"stencil", "gather", "scatter", "adagrad"},
                200),
    "stencil_shared": ({"stencil": 1, "shared_negatives": 1},
                       {"stencil", "gather", "adagrad"}, 200),
    "shared": ({"shared_negatives": 1}, {"gather", "adagrad"}, 800),
    "sg": ({"sg": 1}, {"gather", "scatter", "adagrad"}, 800),
    "sg_shared": ({"sg": 1, "shared_negatives": 1}, {"gather", "adagrad"},
                  800),
    "dense": ({"dense_logits": 1}, {"gather", "adagrad"}, 800),
    # the async modes, in the gather rendering: the snapshot mode, and
    # hogwild with WORKERS workers (the card that many times in the
    # model's cluster) x 2 local steps, over two groups of 16 batches
    "async": ({"local_steps": 4}, {"gather", "scatter", "adagrad"}, 800),
    "hogwild": ({"async_mode": "hogwild", "local_steps": 2},
                {"gather", "scatter", "adagrad"}, 1100),
}
#: the rendering of the paths named for a mode
RENDERING_OF = {"async": "gather", "hogwild": "gather"}
#: hogwild workers, all on the one card
WORKERS = 8
#: ranks of the sharded parameter server, all on the one card
SHARDS = 8
#: sharded path -> launches a step on the card, each for all the card's
#: ranks: ring sends (one per exchange: two per pull, two per pushed
#: family), gathers (one per pull), scatter-adds (one per pushed family,
#: counts included), AdaGrad calls (one per pushed family, the mean's
#: reciprocal inside)
SHARDED = {
    f"gather@{SHARDS}": {"ring": 8, "gather": 2, "scatter": 2, "adagrad": 2},
    f"shared@{SHARDS}": {"ring": 10, "gather": 2, "scatter": 3,
                         "adagrad": 3},
    f"sg@{SHARDS}": {"ring": 8, "gather": 2, "scatter": 2, "adagrad": 2},
}
for _path in SHARDED:
    PATHS[_path] = (PATHS[_path.split("@")[0]][0], set(SHARDED[_path]), 800)
#: paths run with bf16 tables too (``[server] dtype: bfloat16``), named
#: ``<path>:bf16``: the kernels of the float32 path, in their bf16 forms
BF16 = ":bf16"
for _path in ("gather", "stencil", f"gather@{SHARDS}", "sg"):
    PATHS[_path + BF16] = PATHS[_path]
#: launches a batch of the one-shard paths held to exact counts, at the
#: reference shape (capacity 90,516: a push of >= 45,258 rows goes dense):
#: sg's h push of 840,000 rows dense (a scatter-add and AdaGrad over the
#: table), its v push of 40,000 sparse (AdaGrad on its rows); sg_shared's
#: three pushes sparse; dense's h applied to the table, its v sparse;
#: hogwild's batch applied twice, on its worker's replica and on the chain
PER_STEP = {
    "sg": {"gather": 2, "scatter": 1, "adagrad": 2},
    "sg_shared": {"gather": 2, "adagrad": 3},
    "dense": {"gather": 1, "adagrad": 2},
    "async": {"gather": 2, "scatter": 1, "adagrad": 2},
    "hogwild": {"gather": 2, "scatter": 2, "adagrad": 4},
}
PER_STEP["sg" + BF16] = PER_STEP["sg"]
MIN_TRAIN_STEPS = 20
#: the input phase's epochs (``apps/input_profile.py`` ``INPUT_RUNS``);
#: a2 reruns a
INPUT_ORDER = ("a", "a2", "b", "c", "d", "e")
#: launches and pushes of one step at the reference shape: the h pull
#: and the v pull (gather) or the context sum (stencil), the dense h push
#: (one scatter-add with its counts, one AdaGrad over the table) and the v
#: push (sparse: AdaGrad on its rows; span: AdaGrad on the owner rows)
STEP_LAUNCHES = {
    "gather": {"gather": 2, "scatter": 1, "adagrad": 2, "stencil": 0,
               "ring": 0},
    "stencil": {"gather": 1, "scatter": 1, "adagrad": 2, "stencil": 1,
                "ring": 0},
}
STEP_PUSHES = {"gather": ("h:dense", "v:sparse"),
               "stencil": ("h:dense", "v:span")}

#: published H100 SXM peaks (dense): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TIMED_RUNS = 25
#: about 50 us of the card's clock: longer than the host takes to enqueue
#: one wrapper call
SPIN_CYCLES = 100_000


def _json_line(obj) -> None:
    print(json.dumps(obj), flush=True)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


def _model(path: str, vocab, device: str, worker=None) -> Word2Vec:
    """The model of a path: a rendering, ``@n`` for the sharded parameter
    server with n ranks, ``:bf16`` for bf16 tables; ``worker``: more
    ``[worker]`` keys."""
    base, bf16, _ = path.partition(":")
    name, _, shards = base.partition("@")
    rendering = RENDERING_OF.get(name, name)
    conf = ConfigParser().update(DEMO_CONF)
    for k, v in PATHS[path][0].items():
        conf.set("word2vec", k, v)
    for k, v in (worker or {}).items():
        conf.set("worker", k, v)
    if shards:
        conf.set("cluster", "transfer", "tpu")
        conf.set("cluster", "server_num", int(shards))
    if bf16:
        conf.set("server", "dtype", "bfloat16")
    cluster = (Cluster(conf, devices=[device] * WORKERS).initialize()
               if name == "hogwild" else None)
    model = Word2Vec(config=conf, device=device, cluster=cluster)
    if model.param_dtype != (torch.bfloat16 if bf16 else torch.float32):
        raise AssertionError(f"{path} conf gave {model.param_dtype} tables")
    if shards and (model.transfer.name != "tpu"
                   or model.cluster.n_servers != int(shards)):
        raise AssertionError(f"{path} conf gave transfer "
                             f"{model.transfer.name} over "
                             f"{model.cluster.n_servers} shard(s)")
    if model.resolved_rendering != rendering:
        raise AssertionError(f"{rendering} conf resolved to "
                             f"{model.resolved_rendering}")
    return model.build_from_vocab(vocab)


def _draws(model: Word2Vec, B: int, rng: np.random.Generator):
    """``(j, u)`` for one step of ``model``'s rendering, from ``rng``."""
    shape = model.draw_shape(B)
    return (torch.as_tensor(rng.integers(0, len(model.vocab), shape),
                            device=model.device),
            torch.as_tensor(rng.random(shape, np.float32),
                            device=model.device))


def _time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over TIMED_RUNS launches, each after a
    read of a buffer twice the L2's size (the cold-L2 case: inside a step
    the table is partly L2-resident), from CUDA events.  A spin of
    SPIN_CYCLES on the card sits between the read and the start event, so
    the host has enqueued ``fn`` before the card reaches it: the host's
    enqueue time is not timed."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_RUNS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_RUNS)]
    for s, e in zip(starts, ends):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels at the main paths' shapes ------------------------------

def _step_inputs(model: Word2Vec, batch, rng: np.random.Generator):
    """The slots one gather-rendering step hands to its kernels: the h
    pull and push at B*(K+1) target slots, the v pull at B*2W context
    slots (as ``Word2Vec._grads`` forms them), with draws from ``rng``."""
    dev = model.device
    draws = _draws(model, len(batch.centers), rng)
    centers = torch.as_tensor(batch.centers, dtype=torch.int64, device=dev)
    contexts = torch.as_tensor(batch.contexts, dtype=torch.int64, device=dev)
    ctx_mask = torch.as_tensor(batch.ctx_mask, device=dev)
    t_slots, ctx_slots, t_valid = _cbow_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx, centers,
        contexts, ctx_mask, draws)
    h_slots = torch.where(t_valid, t_slots, -1).reshape(-1).contiguous()
    v_slots = ctx_slots.reshape(-1).contiguous()
    return h_slots, v_slots


def _stencil_h_slots(model: Word2Vec, sb: StencilBatch,
                     rng: np.random.Generator):
    """The h push's B*(K+1) target slots of one stencil-rendering step
    (``Word2Vec._grads_stencil``): padded centers give -1 rows, which are
    most of a batch at sample 1e-5."""
    dev = model.device
    tokens = torch.as_tensor(sb.tokens, dtype=torch.int64, device=dev)
    cpos = torch.as_tensor(sb.center_pos, dtype=torch.int64, device=dev)
    span_slots = torch.where(torch.as_tensor(sb.sent_id, device=dev) >= 0,
                             model._slot_of_vocab[tokens], -1)
    row_valid = cpos >= 0
    cp = cpos.clamp(0, sb.span - 1)
    t_slots, t_valid = _parity_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx,
        tokens[cp], torch.where(row_valid, span_slots[cp], -1), row_valid,
        _draws(model, len(sb), rng))
    slots = torch.where(t_valid, t_slots, -1).reshape(-1).contiguous()
    return slots, (slots >= 0).contiguous()


def _perturbed(slots: torch.Tensor, cap: int, rng: np.random.Generator):
    """``(slots, valid)`` with about 5% more rows marked invalid and a few
    valid rows out of range on either side (the kernels clip or drop
    them)."""
    s = slots.cpu().numpy().copy()
    valid = (s >= 0) & (rng.random(s.shape[0]) >= 0.05)
    pos = rng.choice(np.flatnonzero(valid), 8, replace=False)
    s[pos[:4]] = cap + 3
    s[pos[4:]] = -7
    dev = slots.device
    return (torch.as_tensor(s, device=dev).contiguous(),
            torch.as_tensor(valid, device=dev).contiguous())


def _gather_case(label, table, slots, valid, flush, path="gather"):
    """B2 on a ``(cap, d)`` table and ``(N,)`` slots, or a ``(R, cap, d)``
    block of shards and ``(R, N)`` slots in one launch: bit for bit
    against its plain version."""
    out_k = gather.masked_gather(table, slots, valid)
    out_p = gather.masked_gather_plain(table, slots, valid)
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs().max().item()
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"{label}: kernel != plain (max |err| {err})")
    n, (cap, d) = slots.numel(), table.shape[-2:]
    es = table.element_size()
    clipped = slots.clamp(0, cap - 1).long()
    if table.dim() == 3:
        clipped = clipped + torch.arange(
            table.shape[0], device=slots.device)[:, None] * cap
    rows_read = torch.unique(clipped[valid]).numel()
    nbytes = es * d * rows_read + 5 * n + es * n * d
    idx64 = clipped.reshape(-1).contiguous()
    flat = table.reshape(-1, d)
    rows = f"{slots.shape[0]} x {slots.shape[1]}" if slots.dim() == 2 \
        else f"{n}"
    return dict(
        name=f"masked_gather ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/gather.cu",
        replaces="swiftmpi_tpu/ops/pallas_gather.py:164",
        module=gather, shape=f"{rows} rows x {d} of a {tuple(table.shape)} "
        f"{_dtype_name(table)} table, {int((~valid).sum())} invalid, one "
        f"launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: gather.masked_gather(table, slots, valid),
                    flush),
        plain_ms=_time_ms(
            lambda: gather.masked_gather_plain(table, slots, valid), flush),
        library_ms=_time_ms(lambda: flat.index_select(0, idx64), flush),
        library="Tensor.index_select", bytes=nbytes, flops=0)


def _device_gen(dev, rng: np.random.Generator) -> torch.Generator:
    """A generator on ``dev`` seeded from ``rng``: operands of hundreds of
    millions of elements are drawn on the card, not on the host."""
    return torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))


def _scatter_case(label, path, slots, valid, cap, width, rng, flush,
                  counts=True):
    """B3 on ``(N,)`` or ``(R, N)`` slots and grads of ``width``, with the
    counts in the same launch unless ``counts`` is false: sums within
    1e-5 + 1e-3|b| of the plain version (float reductions in no fixed
    order), counts exact."""
    dev = slots.device
    g = torch.randn((*slots.shape, width), generator=_device_gen(dev, rng),
                    device=dev) * 1e-2
    got = scatter.masked_scatter_add(slots, valid, g, cap, counts=counts)
    want = scatter.masked_scatter_add_plain(slots, valid, g, cap,
                                            counts=counts)
    torch.cuda.synchronize()
    (acc_k, cnt_k), (acc_p, cnt_p) = (got, want) if counts else \
        ((got, None), (want, None))
    err = (acc_k - acc_p).abs().max().item()
    torch.testing.assert_close(acc_k, acc_p, rtol=1e-3, atol=1e-5)
    if counts and not torch.equal(cnt_k, cnt_p):
        raise AssertionError(f"{label}: counts != plain")
    ok = valid & (slots >= 0) & (slots < cap)
    R = slots.shape[0] if slots.dim() == 2 else 1
    # indices for every row, grads only for the rows that land
    n, n_ok = slots.numel(), int(ok.sum())
    nbytes = 5 * n + 4 * n_ok * width + 4 * R * cap * (width + int(counts))
    base = (torch.arange(R, device=dev)[:, None] * (cap + 1)
            if slots.dim() == 2 else 0)
    safe = (base + torch.where(ok, slots, cap)).reshape(-1).long()
    acc = torch.zeros((R * (cap + 1), width), device=dev)
    rows = f"{R} x {n // R}" if slots.dim() == 2 else f"{n}"
    return dict(
        name=f"masked_scatter_add ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/scatter.cu",
        replaces="swiftmpi_tpu/ops/pallas_scatter.py:77",
        module=scatter, shape=f"{rows} rows x {width} into {R} x ({cap}, "
        f"{width}){' + counts' if counts else ''}, {n - n_ok} invalid or "
        f"out of range, one launch",
        max_abs_err=err, tolerance="1e-5 + 1e-3|b| (reduction order), "
        "counts exact",
        ms=_time_ms(lambda: scatter.masked_scatter_add(
            slots, valid, g, cap, counts=counts), flush),
        plain_ms=_time_ms(lambda: scatter.masked_scatter_add_plain(
            slots, valid, g, cap, counts=counts), flush),
        library_ms=_time_ms(lambda: acc.index_add_(0, safe, g.view(-1, width)),
                            flush),
        library="Tensor.index_add_ (sums only)", bytes=nbytes,
        flops=n_ok * width)


#: why B1 has no library yardstick
ADAGRAD_LIBRARY = ("none: torch's Adagrad divides by sqrt(sum) + eps, not "
                   "rsqrt(sum + 1e-6)")


def _adagrad_case(label, path, param, accum, grad, lr, flush, rows=None,
                  **scale):
    """B1 in place, bit for bit against its plain version: dense over
    ``param`` (a table or a block of shards; ``mul``/``div`` a per-row
    operand), or row-indexed when ``rows`` is ``(slots, mask)``."""
    if rows is None:
        def kernel(p, a):
            adagrad.adagrad_update_(p, a, grad, lr, **scale)

        def plain(p, a):
            adagrad.adagrad_update_plain_(p, a, grad, lr, **scale)
        kept = param.numel() // param.shape[-1]
        what = f"{tuple(param.shape)} {_dtype_name(param)}"
    else:
        slots, mask = rows

        def kernel(p, a):
            adagrad.adagrad_update_rows_(p, a, slots, mask, grad, lr,
                                         **scale)

        def plain(p, a):
            adagrad.adagrad_update_rows_plain_(p, a, slots, mask, grad, lr,
                                               **scale)
        keep = (slots >= 0) & (slots < param.shape[0])
        kept = int((keep if mask is None else keep & mask).sum())
        what = (f"{kept} of {slots.shape[0]} rows x {param.shape[1]} "
                f"indexed into a {tuple(param.shape)} {_dtype_name(param)} "
                f"table")
    p1, a1, p2, a2 = (t.clone() for t in (param, accum, param, accum))
    kernel(p1, a1)
    plain(p2, a2)
    torch.cuda.synchronize()
    err = max((p1.float() - p2.float()).abs().max().item(),
              (a1 - a2).abs().max().item())
    if not (torch.equal(p1, p2) and torch.equal(a1, a2)):
        raise AssertionError(f"adagrad_update_ ({label}): kernel != plain "
                             f"(max |err| {err})")
    # every kept element: param, accum and grad read, param and accum
    # written (the param in its own dtype); per row: the scale, and the
    # slot and mask of an indexed row
    d, n_rows = param.shape[-1], grad.numel() // param.shape[-1]
    per_row = 4 * len(scale)
    if rows is not None:
        per_row += 4 + (rows[1] is not None)
    nbytes = (2 * param.element_size() + 12) * kept * d + per_row * n_rows
    pk, ak, pp, ap = (t.clone() for t in (param, accum, param, accum))
    op = (f", grad {'* mul' if 'mul' in scale else '/ div'} per row"
          if scale else "")
    if param.dtype == torch.bfloat16:
        op += ", float32 accum and grad (the mixed form)"
    return dict(
        name=f"adagrad_update_ ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/adagrad.cu",
        replaces="swiftmpi_tpu/ops/pallas_kernels.py:73",
        module=adagrad, shape=f"{what}, in place{op}, one launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: kernel(pk, ak), flush),
        plain_ms=_time_ms(lambda: plain(pp, ap), flush),
        library_ms=None, library=ADAGRAD_LIBRARY, bytes=nbytes,
        flops=(7 + bool(scale)) * kept * d)


def _span_owners(span_slots: torch.Tensor) -> torch.Tensor:
    """``push_span``'s owner rows: the first span position of each slot
    (JAX ``is_owner``)."""
    S, dev = span_slots.shape[0], span_slots.device
    valid = span_slots >= 0
    safe = torch.where(valid, span_slots, 0).long()
    pos = torch.arange(S, device=dev)
    first = torch.full((int(safe.max()) + 1,), S, device=dev)
    first.scatter_reduce_(0, safe, torch.where(valid, pos, S), "amin")
    return (valid & (first[safe] == pos)).contiguous()


def _stencil_inputs(model: Word2Vec, sb: StencilBatch,
                    rng: np.random.Generator):
    """``(span_slots, sent_id, center_pos, half)`` of a real stencil batch
    as the step hands them to the context sum, made harder: 64 more
    centers padded and a block of 256 real centers shuffled out of span
    order, so neighbouring centers reach span ranges far apart."""
    cpos, half = sb.center_pos.copy(), sb.half.copy()
    n = sb.n_words
    drop = rng.choice(n, 64, replace=False)
    cpos[drop], half[drop] = -1, 0
    blk = rng.permutation(min(256, n))
    cpos[:len(blk)], half[:len(blk)] = cpos[blk], half[blk]
    return batch_inputs(model, StencilBatch(
        tokens=sb.tokens, sent_id=sb.sent_id, center_pos=cpos, half=half,
        n_words=int((cpos >= 0).sum())))


def _stencil_case(label, path, table, args, window, flush):
    """B4 from the stencil batch itself (``args``: span slots, sent_id,
    center_pos, half) on a float32 or bf16 table, bit for bit against its
    plain version (the window inputs, then the k-order sum)."""
    out_k = stencil.stencil_context_sum(table, *args, window)
    out_p = stencil.stencil_context_sum_plain(table, *args, window)
    torch.cuda.synchronize()
    err = (out_k - out_p).abs().max().item()
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"stencil_context_sum ({label}): kernel != "
                             f"plain (max |err| {err})")
    nbytes, rows_read, src, wmask = context_sum_bytes(table, *args, window)
    (B, K), (cap, d), S = wmask.shape, table.shape, args[0].shape[0]
    on = wmask != 0
    wm_t = wmask.to(table.dtype)          # 0 and 1: exact in either dtype
    lib_out = F.embedding_bag(src, table, mode="sum",
                              per_sample_weights=wm_t)
    lib_err = (lib_out.float() - out_p).abs().max().item()
    n_real = int((args[2] >= 0).sum())
    return dict(
        name=f"stencil_context_sum ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/stencil.cu",
        replaces="swiftmpi_tpu/ops/pallas_stencil.py:126",
        module=stencil, shape=f"{B} centers ({n_real} real) x window {K} "
        f"over a {S}-row span of a {tuple(table.shape)} "
        f"{_dtype_name(table)} table, {rows_read} distinct rows reached, "
        f"from the batch's arrays, one launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: stencil.stencil_context_sum(table, *args,
                                                        window), flush),
        plain_ms=_time_ms(lambda: stencil.stencil_context_sum_plain(
            table, *args, window), flush),
        library_ms=_time_ms(lambda: F.embedding_bag(
            src, table, mode="sum", per_sample_weights=wm_t), flush),
        library=f"F.embedding_bag(mode='sum', per_sample_weights) over the "
        f"window rows (inputs made beforehand; max |diff| {lib_err:.3g})",
        bytes=nbytes, flops=int(on.sum()) * d)


def _ring_case(label, tail, dtype, rng, flush, dev,
               path=f"gather@{SHARDS}", n: int = SHARDS):
    """The ring exchange of ``n`` ranks' ``(n, *tail)`` operands, stacked
    as the transfer (or a rank-axis all-to-all) hands them over, against
    its plain version: a copy, so bit for bit; one send launch and one
    wait launch.  bf16 operands cross as 4-byte words."""
    gen = _device_gen(dev, rng)
    if dtype == torch.int32:
        x = torch.randint(-1, 11_000, (n, n, *tail), generator=gen,
                          dtype=torch.int32, device=dev)
    else:
        x = (torch.rand((n, n, *tail), generator=gen, device=dev)
             - 0.5).to(dtype)
    before = ring.launches
    out_k = ring.ring_exchange_stacked(x)
    launched = ring.launches - before
    out_p = ring.ring_exchange_stacked_plain(x)
    torch.cuda.synchronize()
    err = (out_k.double() - out_p.double()).abs().max().item()
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"ring_exchange ({label}): kernel != plain "
                             f"(max |err| {err})")
    if launched != 1:
        raise AssertionError(f"ring_exchange ({label}): {launched} "
                             "exchange launches, expected one")
    if ring.timeouts():
        raise AssertionError(f"ring_exchange ({label}): a wait timed out")
    if not torch.equal(x.transpose(0, 1).contiguous(), out_p):
        raise AssertionError(f"ring_exchange ({label}): the library "
                             "transpose != plain")
    del out_k, out_p
    nbytes = 2 * x.numel() * x.element_size()
    return dict(
        name=f"ring_exchange ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/ring.cu",
        replaces="swiftmpi_tpu/ops/pallas_ring.py:86",
        module=ring, shape=f"{n} ranks x {(n, *tail)} "
        f"{_dtype_name(x)}, stacked; 1 send launch + 1 wait launch",
        max_abs_err=err, tolerance="exact",
        ms=_time_ms(lambda: ring.ring_exchange_stacked(x), flush),
        plain_ms=_time_ms(lambda: ring.ring_exchange_stacked_plain(x), flush),
        library_ms=_time_ms(lambda: x.transpose(0, 1).contiguous(), flush),
        library="x.transpose(0, 1).contiguous()", bytes=nbytes, flops=0)


def phase_kernels(model: Word2Vec, batch, sbatch: StencilBatch) -> list:
    rng = np.random.default_rng(7)
    state = model.table.state
    cap, d = model.table.capacity, model.len_vec
    h_slots, v_slots = _step_inputs(model, batch, rng)
    # twice the card's 50 MB L2, in float32
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=model.device)
    cases = []
    hs, hv = _perturbed(h_slots, cap, rng)
    vs, vv = _perturbed(v_slots, cap, rng)
    cases.append(_gather_case("h pull", state["h"], hs, hv, flush))
    cases.append(_gather_case("v pull", state["v"], vs, vv, flush))
    cases.append(_scatter_case("h push", "gather", hs, hv, cap, d, rng,
                               flush))
    # PR 1-3's fused count column: 404-byte rows, the scalar path
    cases.append(_scatter_case("h push, d + 1 wide", "gather", hs, hv, cap,
                               d + 1, rng, flush, counts=False))
    ss, sv = _stencil_h_slots(model, sbatch, rng)
    cases.append(_scatter_case("stencil h push", "stencil", ss, sv, cap, d,
                               rng, flush))
    lr = model.access.learning_rate

    def grads_like(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               * 1e-2, device=model.device)

    accum = torch.as_tensor(rng.random((cap, d), np.float32) * 1e-3,
                            device=model.device)
    cases.append(_adagrad_case("h table", "gather", state["h"], accum,
                               grads_like((cap, d)), lr, flush))
    # the dense h push's mean, one family: the divisor inside the launch
    counts = torch.as_tensor(rng.integers(1, 9, cap).astype(np.float32),
                             device=model.device)
    cases.append(_adagrad_case("h table, / counts", "gather", state["h"],
                               accum, grads_like((cap, d)), lr, flush,
                               div=counts))
    rows = torch.unique(v_slots[v_slots >= 0]).long()
    cases.append(_adagrad_case(
        "v rows", "gather", state["v"].index_select(0, rows).contiguous(),
        accum.index_select(0, rows).contiguous(),
        grads_like((rows.numel(), d)), lr, flush))
    # the sparse v push as it runs now: the segment representatives'
    # rows updated in place, the mean's reciprocal inside the launch
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, rows.numel())
                                .astype(np.float32), device=model.device)
    cases.append(_adagrad_case(
        "v rows, row-indexed", "gather", state["v"], accum,
        grads_like((rows.numel(), d)), lr, flush,
        rows=(rows.to(torch.int32), None), mul=inv))
    sargs = _stencil_inputs(model, sbatch, rng)
    span_slots = sargs[0]
    cases.append(_stencil_case("v span", "stencil", state["v"], sargs,
                               model.window, flush))
    # push_span's apply: the S span rows gathered at their owners' slots
    span_rows = span_slots.clamp(min=0).long()
    cases.append(_adagrad_case(
        "push_span rows", "stencil",
        state["v"].index_select(0, span_rows).contiguous(),
        accum.index_select(0, span_rows).contiguous(),
        grads_like((span_rows.numel(), d)), lr, flush))
    # push_span as it runs now: the owner rows' slots updated in place
    S = span_slots.shape[0]
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, S).astype(np.float32),
                                device=model.device)
    owners = _span_owners(span_slots)
    cases.append(_adagrad_case(
        "push_span rows, row-indexed", "stencil", state["v"], accum,
        grads_like((S, d)), lr, flush, rows=(span_slots, owners), mul=inv))
    # bf16 tables: the same calls on bf16 h and v, float32 accumulators
    # and grads, as the bf16 gather and stencil paths make them
    hb, vb = state["h"].to(torch.bfloat16), state["v"].to(torch.bfloat16)
    gb, sb16 = "gather" + BF16, "stencil" + BF16
    cases.append(_gather_case("h pull, bf16", hb, hs, hv, flush, gb))
    cases.append(_gather_case("v pull, bf16", vb, vs, vv, flush, gb))
    cases.append(_adagrad_case("h table, bf16, / counts", gb, hb, accum,
                               grads_like((cap, d)), lr, flush, div=counts))
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, rows.numel())
                                .astype(np.float32), device=model.device)
    cases.append(_adagrad_case(
        "v rows, row-indexed, bf16", gb, vb, accum,
        grads_like((rows.numel(), d)), lr, flush,
        rows=(rows.to(torch.int32), None), mul=inv))
    cases.append(_stencil_case("bf16 v span", sb16, vb, sargs, model.window,
                               flush))
    inv = 1.0 / torch.as_tensor(rng.integers(1, 9, S).astype(np.float32),
                                device=model.device)
    cases.append(_adagrad_case(
        "push_span rows, row-indexed, bf16", sb16, vb, accum,
        grads_like((S, d)), lr, flush, rows=(span_slots, owners), mul=inv))
    return cases


def phase_kernels_sharded(model: Word2Vec, batch) -> list:
    """The sharded path's kernels at the shapes one of its gather steps
    gives them: the three ring exchanges of the h family; what rank 0 does
    as an owner with the ``SHARDS * C`` requests it receives (most of them
    padding: every sender pads its bucket to C) — the gather from its
    shard, the scatter-add of its received grads and, alone, of their
    counts (the per-rank launches of the first design), and AdaGrad over
    the shard; and, as the path now runs them, each in one launch for all
    ``SHARDS`` owners: the gather of their requests from the card's block
    of shards, the scatter-add of their received grads with their counts,
    and AdaGrad over the block with the mean's reciprocal."""
    rng = np.random.default_rng(17)
    dev, d = model.device, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    path = f"gather@{SHARDS}"
    state = model.table.state
    h_slots, _ = _step_inputs(model, batch, rng)
    # each rank's slice of the h pull and push is B*(K+1)/SHARDS slots,
    # the bucket capacity per destination
    C = h_slots.shape[0] // SHARDS
    cases = [
        _ring_case("h requests", (C,), torch.int32, rng, flush, dev),
        _ring_case("h rows", (C, d), torch.float32, rng, flush, dev),
        _ring_case("odd row width", (C, d + 1), torch.float32, rng, flush,
                   dev)]
    groups, C_routed, cap = model.transfer._route(state, h_slots)
    if C_routed != C or len(groups) != 1:
        raise AssertionError(f"bucket capacity {C_routed}, expected {C}, "
                             f"in {len(groups)} device group(s)")
    owners = ring.ring_exchange_stacked(groups[0].req).view(SHARDS, -1)
    got, ok = owners[0], owners[0] >= 0
    cases.append(_gather_case("shard h pull", state["h"][0], got, ok, flush,
                              path))
    block = shard_block(state["h"])
    cases.append(_gather_case(f"{SHARDS} owners' h pull", block, owners,
                              (owners >= 0).contiguous(), flush, path))
    cases.append(_scatter_case("shard h push", path, got, ok, cap, d, rng,
                               flush, counts=False))
    cases.append(_scatter_case("shard h counts", path, got, ok, cap, 1, rng,
                               flush, counts=False))
    cases.append(_scatter_case(f"{SHARDS} owners' h push", path, owners,
                               owners >= 0, cap, d, rng, flush))
    accum = torch.as_tensor(rng.random((cap, d), np.float32) * 1e-3,
                            device=dev)
    grad = torch.as_tensor(rng.normal(size=(cap, d)).astype(np.float32)
                           * 1e-2, device=dev)
    cases.append(_adagrad_case("h shard", path, state["h"][0].clone(), accum,
                               grad, model.access.learning_rate, flush))
    # the sharded mean push: one launch over the card's block of shards,
    # the reciprocal of each row's count inside it
    accum8 = torch.as_tensor(rng.random(block.shape, np.float32) * 1e-3,
                             device=dev)
    grad8 = torch.as_tensor(rng.normal(size=block.shape).astype(np.float32)
                            * 1e-2, device=dev)
    inv8 = 1.0 / torch.as_tensor(rng.integers(1, 9, block.shape[:2])
                                 .astype(np.float32), device=dev)
    cases.append(_adagrad_case(f"{SHARDS} shards, * 1/counts", path,
                               block.clone(), accum8, grad8,
                               model.access.learning_rate, flush, mul=inv8))
    # bf16 tables: the owners' pull from a bf16 block, the pulled rows'
    # exchange as 4-byte words, the mixed AdaGrad over the block
    pb = path + BF16
    blockb = block.to(torch.bfloat16)
    cases.append(_ring_case("h rows, bf16", (C, d), torch.bfloat16, rng,
                            flush, dev, path=pb))
    cases.append(_gather_case(f"{SHARDS} owners' h pull, bf16", blockb,
                              owners, (owners >= 0).contiguous(), flush, pb))
    cases.append(_adagrad_case(f"{SHARDS} shards, * 1/counts, bf16", pb,
                               blockb, accum8, grad8,
                               model.access.learning_rate, flush, mul=inv8))
    return cases


def _sg_h_slots(model: Word2Vec, batch, rng: np.random.Generator):
    """The h slots one sg step hands B2 and B3 (``Word2Vec._grads_sg``):
    B*2W*(K+1) pair-target slots, dead ones -1, draws from ``rng``."""
    dev = model.device
    t_slots, _, _ = _sg_targets(
        model._slot_of_vocab, model._alias_prob, model._alias_idx,
        torch.as_tensor(batch.centers, dtype=torch.int64, device=dev),
        torch.as_tensor(batch.contexts, dtype=torch.int64, device=dev),
        torch.as_tensor(batch.ctx_mask, device=dev),
        _draws(model, len(batch.centers), rng))
    return t_slots.reshape(-1).contiguous()


def phase_kernels_sg(vocab, batch) -> list:
    """B2 and B3 at skip-gram's shapes, 8x the rows of CBOW's h pull and
    push: the one-shard sg h pull of B*2W*(K+1) = 840,000 rows (float32
    and bf16 rows) and its push with counts (float32 grads, as the bf16
    path pushes them too); on the sharded path, the ring exchange of the
    h rows' buckets (C = 105,000 slots a rank) and the eight owners' h
    pull and push of n*C = 840,000 rows each, one launch each."""
    rng = np.random.default_rng(27)
    model = _model("sg", vocab, "cuda")
    dev, cap, d = model.device, model.table.capacity, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    state = model.table.state
    hs, hv = _perturbed(_sg_h_slots(model, batch, rng), cap, rng)
    cases = [
        _gather_case("sg h pull", state["h"], hs, hv, flush, "sg"),
        _gather_case("sg h pull, bf16", state["h"].to(torch.bfloat16), hs,
                     hv, flush, "sg" + BF16),
        _scatter_case("sg h push", "sg", hs, hv, cap, d, rng, flush),
        _scatter_case("sg h push, bf16 tables' float32 grads", "sg" + BF16,
                      hs, hv, cap, d, rng, flush)]
    del model, state
    path = f"sg@{SHARDS}"
    model = _model(path, vocab, "cuda")
    state = model.table.state
    h_slots = _sg_h_slots(model, batch, rng)
    C = h_slots.shape[0] // SHARDS
    cases.append(_ring_case("sg h rows", (C, d), torch.float32, rng, flush,
                            dev, path=path))
    groups, C_routed, cap8 = model.transfer._route(state, h_slots)
    if C_routed != C or len(groups) != 1:
        raise AssertionError(f"sg bucket capacity {C_routed}, expected {C}, "
                             f"in {len(groups)} device group(s)")
    owners = ring.ring_exchange_stacked(groups[0].req).view(SHARDS, -1)
    cases.append(_gather_case(f"{SHARDS} owners' sg h pull",
                              shard_block(state["h"]), owners,
                              (owners >= 0).contiguous(), flush, path))
    cases.append(_scatter_case(f"{SHARDS} owners' sg h push", path, owners,
                               owners >= 0, cap8, d, rng, flush))
    return cases


def report_cases(cases: list) -> None:
    for c in cases:
        c["bound_ms"], c["bound_by"] = _bound_ms(c["bytes"], c["flops"])
        _json_line({"kernel": c["name"], "shape": c["shape"],
                    "max_abs_err": c["max_abs_err"],
                    "tolerance": c["tolerance"], "ms": c["ms"],
                    "plain_ms": c["plain_ms"], "library": c["library"],
                    "library_ms": c["library_ms"],
                    "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                    "bytes": c["bytes"]})


# -- phase 3: one step on the card against the same step on the CPU ---------

def _cpu_state(state, cpu_model: Word2Vec):
    """A copy of a card table for ``cpu_model``: tensor by tensor (bf16
    bits unchanged), a sharded table's shards dealt as the CPU model deals
    them."""
    mesh = cpu_model.cluster.mesh
    return {f: (split_rows(torch.cat(v).cpu(), mesh)
                if isinstance(v, list) else v.cpu().clone())
            for f, v in state.items()}


def _global(v) -> torch.Tensor:
    """A field's global-row-order tensor on the CPU, either layout."""
    return torch.cat(v).cpu() if isinstance(v, list) else v.cpu()


def _ordinal(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 values as integers in the order of the reals: adjacent
    representable values differ by 1, +0 and -0 are both 0."""
    bits = t.contiguous().view(torch.int16).long() & 0xFFFF
    mag = bits & 0x7FFF
    return torch.where(bits >= 0x8000, -mag, mag)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The step from each bfloat16 value of ``t`` to the next one away
    from zero, in float32."""
    mag = t.abs()
    up = (mag.contiguous().view(torch.int16) + 1).view(torch.bfloat16)
    return up.float() - mag.float()


def _field_gap(what: str, got: torch.Tensor, want: torch.Tensor,
               pool_rows=None) -> dict:
    """float32 fields within |a-b| <= 1e-5 + 1e-3|b|.  bf16 fields within
    that envelope or one bfloat16 ulp of b, whichever is wider: one
    rounding step (2^-8 to 2^-7 relative) is wider than the envelope's
    1e-3 relative, and near zero the envelope's 1e-5 is wider than a step.
    ``pool_rows`` (a bool mask over the rows): the rows of a sum family
    whose every element sums up to B*2W = 40,000 pair contributions (the
    sg_shared pool), in another order on the card (cuBLAS) than on the
    CPU; where such a sum nearly cancels, AdaGrad's first update (g /
    sqrt(g^2 + 1e-6), g near 1e-4) carries its float32 rounding error
    ~700-fold.  Elements of those rows may leave the envelope, at most
    1e-4 of the field's elements and none by more than 1e-4; every other
    row is held to it.  Returns the largest gap (the count outside the
    envelope with ``pool_rows``), and for bf16 the largest gap in ulps
    and the share of bit-equal elements."""
    gap = (got.float() - want.float()).abs()
    limit = 1e-5 + 1e-3 * want.float().abs()
    out = {"max_abs_gap": gap.max().item()}
    if got.dtype == torch.bfloat16:
        limit = torch.maximum(limit, bf16_ulp(want))
        ulps = (_ordinal(got) - _ordinal(want)).abs()
        out.update(max_ulps=int(ulps.max()),
                   bit_equal_share=float((ulps == 0).float().mean()))
    bad = gap > limit
    if pool_rows is not None:
        rows = bad.reshape(bad.shape[0], -1).any(dim=1)
        out["outside_envelope_in_pool_rows"] = int(bad.sum())
        if not bool((rows & ~pool_rows).any()) and \
                int(bad.sum()) <= 1e-4 * bad.numel() and \
                gap.max().item() <= 1e-4:
            return out
    if bool(bad.any()):
        raise AssertionError(
            f"{what} leaves its tolerance (max gap {gap.max().item()}, "
            f"{int((gap > limit).sum())} elements; {out})")
    return out


def phase_step_parity(path: str, vocab, batch) -> None:
    """``batch``: a CBOW batch for the gather renderings, a stencil batch
    for the stencil ones."""
    model = _model(path, vocab, "cuda")
    cpu_model = _model(path, vocab, "cpu")
    B = len(batch)
    draws = _draws(model, B, np.random.default_rng(11))
    cpu_model.table.state = _cpu_state(model.table.state, cpu_model)
    pool_rows = None
    if model.resolved_rendering == "sg_shared":
        pool_rows = torch.zeros(model.table.capacity, dtype=torch.bool)
        pool_rows[model._slot_of_vocab[sample_alias_from_draws(
            *draws, model._alias_prob, model._alias_idx)].long().cpu()] = True
    kernels.reset_launches()
    es_c, ec_c = model.step_batch(batch, draws=draws)
    es_p, ec_p = cpu_model.step_batch(
        batch, draws=tuple(t.cpu() for t in draws))
    counts = kernels.launch_counts()
    if model.shared_negatives:
        if not math.isclose(ec_c, ec_p, rel_tol=1e-6):
            raise AssertionError(f"{path} err_cnt: card {ec_c} != cpu "
                                 f"{ec_p} (rel 1e-6)")
    elif ec_c != ec_p:
        raise AssertionError(f"{path} err_cnt: card {ec_c} != cpu {ec_p}")
    if not math.isclose(es_c, es_p, rel_tol=1e-4):
        raise AssertionError(f"{path} err_sum: card {es_c} != cpu {es_p}")
    worst = {f: _field_gap(f"{path} step parity: field {f}",
                           _global(v), _global(cpu_model.table.state[f]),
                           pool_rows)
             for f, v in model.table.state.items()}
    if model.stencil and counts["stencil"] != 1:
        raise AssertionError(f"{path} step launched the stencil kernel "
                             f"{counts['stencil']} times")
    _check_launches(path, counts, 1)
    _json_line({"phase": "step_parity", "rendering": path,
                "centers": B, "real_centers": batch.n_words,
                "err_sum": [es_c, es_p], "err_cnt": [ec_c, ec_p],
                "gap": worst, "envelope": "1e-5 + 1e-3*|cpu|; bf16 fields "
                "that or one ulp" + ("; sg_shared pool rows: at most 1e-4 "
                                     "of a field's elements outside, each "
                                     "within 1e-4" if pool_rows is not None
                                     else ""),
                "push_paths": dict(model.transfer.push_paths),
                "launches": counts})


def _check_launches(path: str, counts: dict, steps: int) -> None:
    """A path of ``PER_STEP``: exactly ``steps`` x its launches a step."""
    if path not in PER_STEP:
        return
    want = {**dict.fromkeys(counts, 0),
            **{k: v * steps for k, v in PER_STEP[path].items()}}
    if counts != want:
        raise AssertionError(f"{path}: {steps} step(s) launched {counts}, "
                             f"its path gives {want}")


def _batches(vocab, corpus, model, n: int) -> list:
    """The first ``n`` full batches of the corpus."""
    out = []
    for b in CBOWBatcher(corpus[:800], vocab, model.window, model.sample,
                         seed=2008).epoch(BATCH):
        if len(out) < n and b.n_words == BATCH:
            out.append(b)
    if len(out) < n:
        raise AssertionError(f"the corpus prefix gave {len(out)} full "
                             f"batches, {n} wanted")
    return out


def _hold_tables(what: str, card: Word2Vec, cpu: Word2Vec) -> dict:
    return {f: _field_gap(f"{what}: field {f}", _global(v),
                          _global(cpu.table.state[f]))
            for f, v in card.table.state.items()}


def phase_step_parity_async(vocab, corpus) -> None:
    """One window of the snapshot mode (``local_steps: 4``) through
    ``train`` on the card and on the CPU from the same table and draws:
    four steps whose grads read the window's snapshot while their pushes
    land on the table.  A snapshot that aliased the table would give the
    card the sync mode's result, steps 2-4 far outside the envelope."""
    model = _model("async", vocab, "cuda")
    cpu_model = _model("async", vocab, "cpu")
    cpu_model.table.state = _cpu_state(model.table.state, cpu_model)
    batches = _batches(vocab, corpus, model, model.local_steps)
    window = SimpleNamespace(epoch=lambda batch_size: iter(batches))
    rng = np.random.default_rng(12)
    draws = [_draws(model, BATCH, rng) for _ in batches]
    kernels.reset_launches()
    losses_c = model.train(batcher=window, niters=1, batch_size=BATCH,
                           draws=iter(draws))
    counts = kernels.launch_counts()
    losses_p = cpu_model.train(batcher=window, niters=1, batch_size=BATCH,
                               draws=iter([tuple(t.cpu() for t in d)
                                           for d in draws]))
    ec = [m.train_metrics["epoch_err"][0] for m in (model, cpu_model)]
    if round(ec[0][1]) != round(ec[1][1]) or not math.isclose(
            losses_c[0], losses_p[0], rel_tol=1e-4):
        raise AssertionError(f"async window: card {ec[0]} loss {losses_c}, "
                             f"cpu {ec[1]} loss {losses_p}")
    worst = _hold_tables("async window", model, cpu_model)
    _check_launches("async", counts, len(batches))
    _json_line({"phase": "step_parity", "rendering": "async",
                "local_steps": model.local_steps, "steps": len(batches),
                "loss": [losses_c[0], losses_p[0]],
                "err": ec, "gap": worst, "envelope": "1e-5 + 1e-3*|cpu|",
                "push_paths": dict(model.transfer.push_paths),
                "launches": counts})


def phase_step_parity_hogwild(vocab, corpus) -> None:
    """One hogwild group, ``WORKERS`` workers (the card that many times)
    x 2 local steps, on the card and on the CPU from the same table and
    draws (worker-major): each worker's 2 steps on its replica, then the
    16 pushes on the table."""
    model = _model("hogwild", vocab, "cuda")
    cpu_model = _model("hogwild", vocab, "cpu")
    cpu_model.table.state = _cpu_state(model.table.state, cpu_model)
    n = WORKERS * model.local_steps
    group = [_batch_fields(b) for b in _batches(vocab, corpus, model, n)]
    rng = np.random.default_rng(13)
    draws = [_draws(model, BATCH, rng) for _ in group]
    kernels.reset_launches()
    es_c, ec_c = (float(x) for x in model._hogwild_group(group, iter(draws)))
    counts = kernels.launch_counts()
    es_p, ec_p = (float(x) for x in cpu_model._hogwild_group(
        group, iter([tuple(t.cpu() for t in d) for d in draws])))
    if ec_c != ec_p or not math.isclose(es_c, es_p, rel_tol=1e-4):
        raise AssertionError(f"hogwild group: card ({es_c}, {ec_c}), cpu "
                             f"({es_p}, {ec_p})")
    worst = _hold_tables("hogwild group", model, cpu_model)
    _check_launches("hogwild", counts, n)
    _json_line({"phase": "step_parity", "rendering": "hogwild",
                "workers": len(model.cluster.devices),
                "local_steps": model.local_steps, "batches": n,
                "err_sum": [es_c, es_p], "err_cnt": [ec_c, ec_p],
                "gap": worst, "envelope": "1e-5 + 1e-3*|cpu|",
                "push_paths": dict(model.transfer.push_paths),
                "launches": counts})


def phase_step_parity_sharded(vocab, batch, dtype: str = "") -> None:
    """One ``gather`` step of the sharded parameter server on the card,
    against the same sharded step on the CPU (whole tables, each field
    within ``_field_gap``'s tolerance, ``err_cnt`` exact) and against the one-shard ``xla`` step on the card, row for row
    by key: the two lay the same words out in different slots.
    ``dtype``: ``""`` or ``BF16``."""
    path = f"gather@{SHARDS}{dtype}"
    model = _model(path, vocab, "cuda")
    cpu_model = _model(path, vocab, "cpu")
    single = _model("gather" + dtype, vocab, "cuda")
    B = len(batch)
    draws = _draws(model, B, np.random.default_rng(11))
    # every word starts from the row the one-shard model gives it
    at_single = single._slot_of_vocab.long().cpu()
    at_sharded = model._slot_of_vocab.long().cpu()
    start = {f: _global(v) for f, v in model.table.state.items()}
    for f in start:
        start[f][at_sharded] = single.table.state[f].cpu()[at_single]
    model.table.state = {f: split_rows(t, model.cluster.mesh)
                         for f, t in start.items()}
    cpu_model.table.state = {f: split_rows(t, cpu_model.cluster.mesh)
                             for f, t in start.items()}
    kernels.reset_launches()
    es_c, ec_c = model.step_batch(batch, draws=draws)
    counts = kernels.launch_counts()
    es_p, ec_p = cpu_model.step_batch(
        batch, draws=tuple(t.cpu() for t in draws))
    es_s, ec_s = single.step_batch(batch, draws=draws)
    if not ec_c == ec_p == ec_s:
        raise AssertionError(f"{path} err_cnt: card {ec_c}, cpu {ec_p}, "
                             f"one shard {ec_s}")
    if not (math.isclose(es_c, es_p, rel_tol=1e-4)
            and math.isclose(es_c, es_s, rel_tol=1e-4)):
        raise AssertionError(f"{path} err_sum: card {es_c}, cpu {es_p}, "
                             f"one shard {es_s}")
    card, cpu, one = ({f: _global(v) for f, v in m.table.state.items()}
                      for m in (model, cpu_model, single))
    worst_cpu = {f: _field_gap(f"{path} vs the CPU step, field {f},",
                               card[f], cpu[f]) for f in cpu}
    worst_one = {f: _field_gap(
        f"{path} vs the one-shard step by key, field {f},",
        card[f][at_sharded], one[f][at_single]) for f in one}
    moved = int((card["h"][at_sharded] != start["h"][at_sharded])
                .any(dim=1).sum())
    if not moved:
        raise AssertionError(f"{path}: the step moved no row")
    want = dict(SHARDED[f"gather@{SHARDS}"], stencil=0)
    if counts != want:
        raise AssertionError(f"{path} step launched {counts}, its path is "
                             f"{want}")
    if model.transfer.overflow_count() or ring.timeouts():
        raise AssertionError(f"{path}: overflow "
                             f"{model.transfer.overflow_count()}, wait "
                             f"timeouts {ring.timeouts()}")
    _json_line({"phase": "step_parity", "rendering": path, "centers": B,
                "real_centers": batch.n_words,
                "err_sum": [es_c, es_p, es_s], "err_cnt": [ec_c, ec_p, ec_s],
                "gap_vs_cpu": worst_cpu,
                "gap_vs_one_shard_by_key": worst_one,
                "rows_moved": moved, "envelope": "1e-5 + 1e-3*|b|; bf16 "
                "fields that or one ulp",
                "shard_fill": model.table.key_index.shard_fill().tolist(),
                "push_paths": dict(model.transfer.push_paths),
                "launches": counts})


# -- phase 4: training through the public entry point -----------------------

def phase_train(rendering: str, vocab, corpus: np.ndarray,
                card: str) -> dict:
    """``rendering``: a path of ``PATHS``."""
    model = _model(rendering, vocab, "cuda")
    expect, n_sent = PATHS[rendering][1], PATHS[rendering][2]
    sharded = rendering.split(":")[0]
    batcher = CBOWBatcher(corpus[:n_sent], vocab, model.window, model.sample,
                          seed=2008)
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
    counts = kernels.launch_counts()
    m = model.train_metrics
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{rendering}: non-finite loss {losses}")
    if m["steps"] < MIN_TRAIN_STEPS:
        raise AssertionError(f"{rendering}: only {m['steps']} steps; raise "
                             "its corpus prefix")
    launched = {k for k, n in counts.items() if n}
    if launched != expect:
        raise AssertionError(f"{rendering}: the train run launched "
                             f"{sorted(launched)}, its path is "
                             f"{sorted(expect)}")
    if model.stencil and (counts["stencil"] != m["steps"]
                          or "v:span" not in m["push_paths"]):
        raise AssertionError(f"{rendering}: {counts['stencil']} stencil "
                             f"launches in {m['steps']} steps, push paths "
                             f"{m['push_paths']}")
    extra = {"dtype": _dtype_name(_global(model.table.state["h"]))}
    _check_launches(rendering, counts, m["steps"])
    if rendering in ("async", "hogwild"):
        extra.update(local_steps=m["local_steps"], async_mode=m["async_mode"],
                     fused=m["fused"])
        if m["fused"] or m["local_steps"] != model.local_steps:
            raise AssertionError(f"{rendering}: {extra}")
    if rendering == "hogwild":
        extra.update(workers=len(model.cluster.devices),
                     skipped_tail_words=m["hogwild_skipped_tail_words"])
        if m["steps"] % (WORKERS * model.local_steps):
            raise AssertionError(f"hogwild ran {m['steps']} steps, not "
                                 f"whole groups")
    if sharded in SHARDED:
        # every step: one send and one wait launch for every exchange, one
        # gather per pull, one scatter-add and one AdaGrad per pushed
        # family
        want = {k: v * m["steps"] for k, v in SHARDED[sharded].items()}
        got = {k: counts[k] for k in want}
        extra.update(overflow_count=model.transfer.overflow_count(),
                     wait_timeouts=ring.timeouts(), shards=m["shards"])
        if got != want or extra["overflow_count"] or extra["wait_timeouts"] \
                or any(not k.endswith(":routed") for k in m["push_paths"]):
            raise AssertionError(
                f"{rendering}: launches {got} in {m['steps']} steps, its "
                f"path gives {want}; {extra}; push paths {m['push_paths']}")
    _json_line({"phase": "train", "rendering": rendering, "card": card,
                **extra,
                "loss": losses, "steps": m["steps"], "words": m["words"],
                "seconds": m["seconds"],
                "batcher_seconds": m["batcher_seconds"],
                "steps_per_sec": m["steps_per_sec"],
                "words_per_sec": m["words_per_sec"],
                "push_paths": m["push_paths"], "launches": counts})
    return counts


def phase_graph(vocab, corpus: np.ndarray, card: str) -> None:
    """``sg`` with ``[worker] inner_steps: 8``: groups of 8 steps as one
    CUDA graph replay each (the first group of a length is the capture's
    warm-up), launches still exactly steps x sg's."""
    model = _model("sg", vocab, "cuda", {"inner_steps": 8})
    batcher = CBOWBatcher(corpus[:PATHS["sg"][2]], vocab, model.window,
                          model.sample, seed=2008)
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
    counts = kernels.launch_counts()
    m = model.train_metrics
    if not all(math.isfinite(x) for x in losses) or not m["fused"] \
            or m["graph_replays"] < 1:
        raise AssertionError(f"sg graphs: loss {losses}, fused {m['fused']}, "
                             f"{m['graph_replays']} replays")
    _check_launches("sg", counts, m["steps"])
    _json_line({"phase": "graph", "rendering": "sg", "card": card,
                "inner_steps": 8, "graph_replays": m["graph_replays"],
                "loss": losses, "steps": m["steps"], "words": m["words"],
                "seconds": m["seconds"], "words_per_sec": m["words_per_sec"],
                "push_paths": m["push_paths"], "launches": counts})


# -- phase 5: the input path, one full epoch ---------------------------------

def _drift(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a table field lies from another run's: the largest gap and
    the share of elements outside 1e-5 + 1e-3|b|."""
    gap = (got.float() - want.float()).abs()
    out = (gap > 1e-5 + 1e-3 * want.float().abs()).float().mean()
    return {"max_abs_gap": gap.max().item(), "share_outside": out.item()}


def phase_input(corpus: np.ndarray, vocab, card: str) -> None:
    """The native loader on the whole corpus, then the epochs of
    ``INPUT_ORDER``."""
    nvocab, tokens, offsets, info = load_native(corpus)
    if not (np.array_equal(nvocab.keys, vocab.keys)
            and np.array_equal(nvocab.counts, vocab.counts)
            and len(tokens) == corpus.size
            and len(offsets) == len(corpus) + 1):
        raise AssertionError(
            f"native load: {len(nvocab)} words, {len(tokens)} tokens, "
            f"{len(offsets) - 1} sentences; build_vocab {len(vocab)} "
            f"words over {corpus.size} tokens")
    _json_line({"phase": "input_load", "card": card,
                "library": str(native.library_path().relative_to(ROOT)),
                "tokens": len(tokens), "sentences": len(offsets) - 1,
                "vocab": len(nvocab), **info})
    ref = None
    for run in INPUT_ORDER:
        rendering, loader, worker = INPUT_RUNS[run[0]]
        model = _model(rendering, vocab, "cuda", worker)
        batcher = run_batcher(run[0], model, corpus,
                              (nvocab, tokens, offsets))
        kernels.reset_launches()
        losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
        got = kernels.launch_counts()
        m = model.train_metrics
        steps = m["steps"]
        want = {k: v * steps for k, v in STEP_LAUNCHES[rendering].items()}
        pushes = {p: steps for p in STEP_PUSHES[rendering]}
        graphs = worker["inner_steps"] > 1
        if not all(math.isfinite(x) for x in losses) or got != want \
                or m["push_paths"] != pushes or m["loader"] != loader \
                or m["fused"] is not graphs \
                or (m["graph_replays"] > 0) is not graphs:
            raise AssertionError(
                f"input run {run}: loss {losses}, launches {got} in {steps} "
                f"steps (its path gives {want}), push paths "
                f"{m['push_paths']}, loader {m['loader']}, fused "
                f"{m['fused']}, {m['graph_replays']} graph replays")
        drift = None
        if run == "a":
            ref = (steps, m["words"], losses, m["epoch_err"][0][1],
                   {f: t.clone() for f, t in model.table.state.items()})
        elif run in ("a2", "b", "c"):
            if (steps, m["words"]) != ref[:2] or not math.isclose(
                    losses[0], ref[2][0], rel_tol=1e-4) or not math.isclose(
                    m["epoch_err"][0][1], ref[3], rel_tol=1e-6):
                raise AssertionError(
                    f"input run {run}: {steps} steps, {m['words']} words, "
                    f"loss {losses}, err {m['epoch_err']}; run a: {ref[:4]}")
            drift = {f: _drift(t, ref[4][f])
                     for f, t in model.table.state.items()}
        _json_line({"phase": "input", "card": card,
                    **epoch_line(run[0], model, losses), "run": run,
                    "drift_vs_a": drift, "push_paths": m["push_paths"],
                    "launches": got})
        del model, batcher


# -- phase 6: the CLI --------------------------------------------------------

def phase_cli(extra: str, expect: set, cluster: str = "server_num: 1\n"
              "transfer: xla\n", server: str = "", worker: str = "",
              variant: str = "sync") -> None:
    """``extra``: [word2vec] lines; ``server``, ``worker``: more [server]
    and [worker] lines; ``variant``: the CLI's ``-variant`` (async and
    hogwild key words by their BKDR hash).  The run must load through the
    native loader."""
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    data, conf, out = WORK / "corpus.txt", WORK / "w2v.conf", \
        WORK / "vectors.txt"
    write_tokens_file(synthetic_corpus(200, 500, 20, seed=1), str(data))
    conf.write_text("[cluster]\n" + cluster +
                    "[worker]\nminibatch: 512\n" + worker +
                    "[server]\ninitial_learning_rate: 0.7\n" + server +
                    "[word2vec]\nlen_vec: 100\nwindow: 4\nnegative: 20\n"
                    "sample: 0.001\nlearning_rate: 0.05\n" + extra)
    reset_global_config()
    models = []

    class Recording(Word2Vec):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            models.append(self)

    kernels.reset_launches()
    w2v_main.Word2Vec = Recording
    try:
        rc = w2v_main.main(["w2v_main", "-config", str(conf), "-data",
                            str(data), "-niters", "1", "-output", str(out),
                            "-variant", variant])
    finally:
        w2v_main.Word2Vec = Word2Vec
    counts = kernels.launch_counts()
    if rc != 0:
        raise AssertionError(f"w2v_main returned {rc}")
    m = models[0].train_metrics
    if m["loader"] != "native":
        raise AssertionError(f"the CLI trained through the {m['loader']} "
                             "loader; the native one builds here")
    vocab = build_vocab(load_corpus(
        str(data), mode="int" if variant == "sync" else "bkdr"))
    want_mode = {"sync": (1, ""), "async": (4, ""),
                 "hogwild": (1, "hogwild")}[variant]
    if (m["local_steps"], m["async_mode"]) != want_mode:
        raise AssertionError(f"-variant {variant} trained with local_steps "
                             f"{m['local_steps']}, async_mode "
                             f"{m['async_mode']!r}")
    keys = set()
    for line in out.read_text().splitlines():
        key, _, rest = line.partition("\t")
        row = w2v_parser(rest)
        if row["v"].shape != (100,) or row["h"].shape != (100,) \
                or not (np.isfinite(row["v"]).all()
                        and np.isfinite(row["h"]).all()):
            raise AssertionError(f"bad dump row for key {key}")
        if server and not all(torch.equal(
                torch.from_numpy(r).to(torch.bfloat16).float(),
                torch.from_numpy(r)) for r in (row["v"], row["h"])):
            raise AssertionError(f"dump row for key {key} holds values "
                                 f"that are not bf16")
        keys.add(int(key))
    if keys != set(vocab.keys.tolist()):
        raise AssertionError(f"dump has {len(keys)} keys, vocab "
                             f"{len(vocab)}")
    launched = {k for k, n in counts.items() if n}
    if launched != expect:
        raise AssertionError(f"the CLI run ({extra.strip() or 'gather'}; "
                             f"{cluster.split()}) launched "
                             f"{sorted(launched)}, expected "
                             f"{sorted(expect)}")
    _json_line({"phase": "cli", "variant": variant,
                "conf": extra.strip() or "gather",
                "cluster": " ".join(cluster.split()),
                "server": " ".join(server.split()),
                "worker": " ".join(worker.split()), "loader": m["loader"],
                "fused": m["fused"], "graph_replays": m["graph_replays"],
                "rows": len(keys), "launches": counts})
    shutil.rmtree(WORK)


# -- phase 7: checkpoints, resume and sent2vec ---------------------------------

#: the device of the checkpoint, resume and sent2vec phases
DEVICE = "cuda"
#: the paths whose table a checkpoint phase saves and restores
CKPT_PATHS = ("gather", "gather" + BF16, f"gather@{SHARDS}")
#: sent2vec at bench.py's shape (``_bench_s2v``): sentences of words
#: drawn over the word table's vocabulary, one batch, passes a sentence
S2V_SENTS, S2V_LEN, S2V_NITERS = 1024, 64, 10


def _one_step_launches(path: str) -> dict:
    """Launches of one step of a gather path at the reference shape."""
    sharded = path.split(":")[0]
    if sharded in SHARDED:
        return dict(SHARDED[sharded], stencil=0)
    return dict(STEP_LAUNCHES["gather"])


def _tensors(state) -> list:
    return [t for v in state.values()
            for t in (v if isinstance(v, list) else [v])]


def _hold_equal(what: str, got, want) -> None:
    """Two table states, field by field in global row order, bit for
    bit."""
    for f, v in want.items():
        if not torch.equal(_global(got[f]), _global(v)):
            raise AssertionError(f"{what}: field {f} differs")


def phase_checkpoint(path: str, vocab, corpus: np.ndarray, card: str) -> None:
    """A card model of ``path`` trains over a corpus prefix (AdaGrad sums
    non-zero), then its npz checkpoint is saved; a fresh card model
    resumes from it bit for bit, in place (no tensor moves), with the same
    key index; a CPU model resumes from the same file bit for bit; and one
    step of the resumed card model agrees with the same step of the
    uninterrupted one (same batch, same draws) to ``_field_gap``'s
    tolerance, launching exactly the path's kernels."""
    model = _model(path, vocab, DEVICE)
    model.train(batcher=CBOWBatcher(corpus[:200], vocab, model.window,
                                    model.sample, seed=2008),
                niters=1, batch_size=BATCH)
    ck = str(WORK / "checkpoint" / path.replace(":", "_").replace("@", "_"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(model.table, ck, extra={"iter": np.int64(1)})
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(npz_path(ck))
    resumed = _model(path, vocab, DEVICE)
    ptrs = [t.data_ptr() for t in _tensors(resumed.table.state)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it = resumed.resume(ck)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if it != 1 or ptrs != [t.data_ptr()
                           for t in _tensors(resumed.table.state)]:
        raise AssertionError(f"{path} resume: iter {it}; tensors moved")
    _hold_equal(f"{path} card save -> card load", resumed.table.state,
                model.table.state)
    if list(resumed.table.key_index.items()) != \
            list(model.table.key_index.items()):
        raise AssertionError(f"{path} resume: the key index differs")
    cpu = _model(path, vocab, "cpu")
    t0 = time.perf_counter()
    cpu.resume(ck)
    cpu_load_s = time.perf_counter() - t0
    _hold_equal(f"{path} card save -> cpu load", cpu.table.state,
                model.table.state)
    batch = _batches(vocab, corpus, model, 1)[0]
    draws = _draws(model, BATCH, np.random.default_rng(14))
    kernels.reset_launches()
    es_r, ec_r = resumed.step_batch(batch, draws=draws)
    counts = kernels.launch_counts()
    es_u, ec_u = model.step_batch(batch, draws=draws)
    if ec_r != ec_u or not math.isclose(es_r, es_u, rel_tol=1e-4):
        raise AssertionError(f"{path} step after resume: ({es_r}, {ec_r}), "
                             f"uninterrupted ({es_u}, {ec_u})")
    gap = {f: _field_gap(f"{path} step after resume, field {f}",
                         _global(v), _global(model.table.state[f]))
           for f, v in resumed.table.state.items()}
    want = _one_step_launches(path)
    if counts != want:
        raise AssertionError(f"{path} step after resume launched {counts}, "
                             f"its path gives {want}")
    _json_line({"phase": "checkpoint", "rendering": path, "card": card,
                "npz_bytes": nbytes, "save_seconds": save_s,
                "load_seconds": load_s, "cpu_load_seconds": cpu_load_s,
                "rows": len(model.table.key_index),
                "capacity": model.table.capacity,
                "round_trip": "bit-exact card -> card and card -> cpu",
                "step_after_resume_gap": gap, "err_cnt": [ec_r, ec_u],
                "envelope": "1e-5 + 1e-3*|b|; bf16 fields that or one ulp",
                "launches": counts})
    shutil.rmtree(WORK / "checkpoint")


def phase_resume(vocab, corpus: np.ndarray, card: str) -> dict:
    """``train_with_resume`` over a corpus prefix, niters 4, a checkpoint
    every iteration, ``retain=3``, with ``crash_at_step(2)`` and
    ``corrupt_checkpoint(at_save=2)``: the crash at the top of iteration
    2 finds the iteration-2 save corrupted and rewinds to the iteration-1
    generation, so 3 iterations rerun; the last loss lands within 20% of
    an uninterrupted run's.  ``inner_steps: 8`` (CUDA graphs) and the hang
    watchdog (each attempt on a worker thread): the graphs captured by the
    first attempt survive the in-place resume and are replayed by the
    last."""
    n_sent, worker = 400, {"inner_steps": 8}
    clean = _model("gather", vocab, DEVICE, worker)
    clean_losses = clean.train(corpus[:n_sent], niters=4, batch_size=BATCH)
    model = _model("gather", vocab, DEVICE, worker)
    at_resume = []
    resume = model.resume

    def spy(path):
        it = resume(path)
        at_resume.append((it, dict(model._fused_cache)))
        return it

    model.resume = spy
    ck = WORK / "resume" / "ck"
    shutil.rmtree(ck.parent, ignore_errors=True)
    plan = FaultPlan().crash_at_step(2).corrupt_checkpoint(at_save=2)
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = train_with_resume(model, corpus[:n_sent], niters=4,
                               checkpoint_path=str(ck), checkpoint_every=1,
                               retain=3, fault_plan=plan,
                               hang_timeout_s=300.0, batch_size=BATCH)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    m = model.train_metrics
    rel = abs(losses[-1] - clean_losses[-1]) / abs(clean_losses[-1])
    kept = all(model._fused_cache.get(L) is g
               for _, cache in at_resume for L, g in cache.items())
    if len(losses) != 3 or [it for it, _ in at_resume] != [1] \
            or not all(math.isfinite(x) for x in losses) or rel >= 0.2 \
            or not m["fused"] or m["graph_replays"] < 1 \
            or not at_resume[0][1] or not kept:
        raise AssertionError(
            f"resume: losses {losses} (uninterrupted {clean_losses}), "
            f"resumed at {[it for it, _ in at_resume]}, fused {m['fused']}, "
            f"{m['graph_replays']} replays, graphs kept {kept}")
    launched = {k for k, n in counts.items() if n}
    if launched != PATHS["gather"][1]:
        raise AssertionError(f"resume launched {sorted(launched)}")
    files = sorted(p.name for p in ck.parent.iterdir())
    _json_line({"phase": "resume", "card": card, "losses": losses,
                "uninterrupted": clean_losses, "last_loss_rel_gap": rel,
                "resumed_at_iter": [it for it, _ in at_resume],
                "graph_replays": m["graph_replays"], "graphs_kept": kept,
                "seconds": seconds, "files": files, "launches": counts})
    shutil.rmtree(ck.parent)
    return counts


def phase_cli_checkpoint(card: str) -> None:
    """``w2v_main -checkpoint``: with a crash at every top of iteration 1
    through ``SMTPU_FAULT_PLAN`` the command fails once the restarts are
    spent, leaving the iteration-1 checkpoint; the same command without
    the plan resumes there and writes a dump of one row per word."""
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    data, conf, out, ck = (WORK / "corpus.txt", WORK / "w2v.conf",
                           WORK / "vectors.txt", WORK / "ck")
    write_tokens_file(synthetic_corpus(200, 500, 20, seed=1), str(data))
    conf.write_text("[cluster]\nserver_num: 1\ntransfer: xla\n"
                    "[worker]\nminibatch: 512\n"
                    "[server]\ninitial_learning_rate: 0.7\n"
                    "[word2vec]\nlen_vec: 100\nwindow: 4\nnegative: 20\n"
                    "sample: 0.001\nlearning_rate: 0.05\n")
    argv = ["w2v_main", "-config", str(conf), "-data", str(data), "-niters",
            "3", "-output", str(out), "-checkpoint", str(ck), "-device",
            DEVICE]
    reset_global_config()
    os.environ[faults.ENV_FAULT_PLAN] = FaultPlan().crash_at_step(
        1, times=100).to_json()
    faults.clear()
    try:
        w2v_main.main(argv)
        raise AssertionError("the crashing -checkpoint run returned")
    except faults.InjectedFault:
        pass
    finally:
        del os.environ[faults.ENV_FAULT_PLAN]
        faults.clear()
    with np.load(npz_path(str(ck))) as z:
        crashed_at = int(z["extra__iter"])
    reset_global_config()
    kernels.reset_launches()
    rc = w2v_main.main(argv)
    counts = kernels.launch_counts()
    with np.load(npz_path(str(ck))) as z:
        done = int(z["extra__iter"])
    keys = {int(line.partition("\t")[0])
            for line in out.read_text().splitlines()}
    vocab = build_vocab(load_corpus(str(data)))
    launched = {k for k, n in counts.items() if n}
    if rc != 0 or crashed_at != 1 or done != 3 \
            or keys != set(vocab.keys.tolist()) \
            or launched != PATHS["gather"][1]:
        raise AssertionError(f"-checkpoint: rc {rc}, crashed at {crashed_at}"
                             f", done {done}, {len(keys)} rows for "
                             f"{len(vocab)} words, launched {launched}")
    _json_line({"phase": "cli", "flag": "-checkpoint", "card": card,
                "crashed_at_iter": crashed_at, "rerun_done_iter": done,
                "rows": len(keys), "launches": counts})
    shutil.rmtree(WORK)


def _s2v_lines(vocab_keys) -> tuple:
    """bench.py's sentences and the length their batch is bucketed to."""
    lines = [" ".join(map(str, s)) for s in synthetic_corpus(
        S2V_SENTS, 70_000, S2V_LEN, seed=21)]
    known = set(vocab_keys.tolist())
    longest = max(sum(int(w) in known for w in ln.split()) for ln in lines)
    return lines, 1 << (longest - 1).bit_length()


def phase_sent2vec(vocab, corpus: np.ndarray, card: str) -> tuple:
    """The word model comes from the card's dump: a card model trained
    over a corpus prefix and written by ``save``, loaded back by
    ``build_word_model_from_dump`` at its default 65,536 rows, which the
    69,627 words outgrow, so the table grows once, to 131,072 rows (its
    rows equal the trained model's, bit for bit).  Inference at bench.py's
    shape (1,024 sentences of 64 words, one batch, 10 passes) on the card
    with the sentence model's draws, against the CPU with the same draws
    (every element within 1e-5 + 1e-3|b|); B2 runs once per batch for the
    context rows and once per pass for the target rows.  Returns the B2
    cases at its shapes and the launches of the timed runs."""
    model = _model("gather", vocab, DEVICE)
    model.train(batcher=CBOWBatcher(corpus[:200], vocab, model.window,
                                    model.sample, seed=2008),
                niters=1, batch_size=BATCH)
    WORK.mkdir(parents=True, exist_ok=True)
    dump = str(WORK / "words.txt")
    t0 = time.perf_counter()
    model.save(dump)
    save_s = time.perf_counter() - t0
    conf = ConfigParser().update(DEMO_CONF)
    t0 = time.perf_counter()
    wm = build_word_model_from_dump(dump, conf, device=DEVICE)
    load_s = time.perf_counter() - t0
    cap, want_cap = wm.table.capacity, 1 << 16
    while want_cap < len(wm.vocab):
        want_cap *= 2
    if cap != want_cap:
        raise AssertionError(f"{len(wm.vocab)} words loaded into {cap} rows, "
                             f"not {want_cap}")
    at = wm._slot_of_vocab.long()
    src = model._slot_of_vocab.long()
    for f in ("h", "v"):
        if not torch.equal(wm.table.state[f][at], model.table.state[f][src]):
            raise AssertionError(f"sent2vec word table: {f} rows differ")
    del model
    s2v = Sent2Vec(wm, seed=1)
    s2v.batchsize = S2V_SENTS
    lines, L = _s2v_lines(wm.vocab.keys)
    draws = s2v.draw(S2V_SENTS, L, S2V_NITERS)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = s2v.infer_sentences(lines, niters=S2V_NITERS, draws=iter([draws]))
    first_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    t0 = time.perf_counter()
    again = s2v.infer_sentences(lines, niters=S2V_NITERS)
    second_s = time.perf_counter() - t0
    if counts != {**dict.fromkeys(counts, 0), "gather": 1 + S2V_NITERS} \
            or kernels.launch_counts()["gather"] != 2 * (1 + S2V_NITERS):
        raise AssertionError(f"sent2vec launched {counts}, then "
                             f"{kernels.launch_counts()}")
    cpu_s2v = Sent2Vec(build_word_model_from_dump(dump, conf, device="cpu"),
                       seed=1)
    cpu_s2v.batchsize = S2V_SENTS
    t0 = time.perf_counter()
    want = cpu_s2v.infer_sentences(
        lines, niters=S2V_NITERS,
        draws=iter([(draws[0].cpu(), [tuple(t.cpu() for t in p)
                                      for p in draws[1]])]))
    cpu_s = time.perf_counter() - t0
    a = np.stack([v for _, v in got])
    b = np.stack([v for _, v in want])
    gap = np.abs(a - b)
    if [s for s, _ in got] != [s for s, _ in want] or len(got) != len(again) \
            or not np.isfinite(a).all() \
            or (gap > 1e-5 + 1e-3 * np.abs(b)).any():
        raise AssertionError(f"sent2vec card vs cpu: max gap {gap.max()}, "
                             f"{len(got)} vs {len(want)} sentences")
    _json_line({"phase": "sent2vec", "card": card, "dump_rows": len(wm.vocab),
                "dump_save_seconds": save_s,
                "dump_load_seconds": load_s,
                "capacity_before": 1 << 16, "capacity_after": cap,
                "sentences": len(got), "L": L, "niters": S2V_NITERS,
                "seconds_replayed_draws": first_s, "seconds_own_draws":
                second_s, "sents_per_sec": len(got) / second_s,
                "cpu_seconds": cpu_s, "max_abs_gap_vs_cpu": float(gap.max()),
                "max_abs_value": float(np.abs(b).max()),
                "tolerance": "1e-5 + 1e-3*|cpu|",
                "b2_launches_per_batch": counts["gather"],
                "launches": counts})
    # B2 at the path's shapes: the context rows of the batch (masked by
    # the sentences) and the target rows of one pass (all valid)
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=DEVICE)
    index = {int(k): i for i, k in enumerate(wm.vocab.keys.tolist())}
    vocab_pos = np.zeros((S2V_SENTS, L), np.int64)
    mask = np.zeros((S2V_SENTS, L), bool)
    for i, ln in enumerate(lines):
        t = [index[int(w)] for w in ln.split() if int(w) in index]
        vocab_pos[i, :len(t)], mask[i, :len(t)] = t, True
    sov = wm._slot_of_vocab
    vp = torch.as_tensor(vocab_pos, device=DEVICE)
    word_slots = sov[vp]
    b_, j, u = draws[1][0]
    prob, alias = build_unigram_alias(wm.vocab.counts)
    _, neg_slots = sample_alias_slots_from_draws(
        j, u, torch.as_tensor(prob, device=DEVICE),
        torch.as_tensor(alias, dtype=torch.int64, device=DEVICE), sov)
    t_slots = torch.cat([word_slots[..., None], neg_slots], dim=2)
    t_flat = t_slots.transpose(0, 1).reshape(-1).contiguous()
    cases = [
        _gather_case("sent2vec context rows", wm.table.state["v"],
                     word_slots.reshape(-1).contiguous(),
                     torch.as_tensor(mask, device=DEVICE).reshape(-1),
                     flush, "sent2vec"),
        _gather_case("sent2vec target rows of a pass", wm.table.state["h"],
                     t_flat, torch.ones_like(t_flat, dtype=torch.bool),
                     flush, "sent2vec")]
    shutil.rmtree(WORK)
    return cases, counts


# -- phase 8: logistic regression, GloVe and the embedding index -------------

#: LR and GloVe paths -> the launches of one step on the card (the sharded
#: ones each for all the card's ranks): the a9a sparse rendering pulls the
#: weights once and pushes them dense (a scatter-add with its counts, then
#: AdaGrad over the table); its dense rendering is two products and one
#: AdaGrad over the table; a GloVe step pulls four fields (w, b at the
#: focus slots, wt, bt at the context slots) and pushes four families,
#: every push sparse (AdaGrad on the rows); on the sharded server a pull
#: is one request exchange and one row exchange a field, a push one
#: request exchange and one grad exchange a family
LR_GLOVE_STEP = {
    "lr": {"gather": 1, "scatter": 1, "adagrad": 1},
    "lr_dense": {"adagrad": 1},
    "glove": {"gather": 4, "adagrad": 4},
    f"lr@{SHARDS}": {"ring": 4, "gather": 1, "scatter": 1, "adagrad": 1},
    f"glove@{SHARDS}": {"ring": 12, "gather": 4, "scatter": 4,
                        "adagrad": 4},
}
#: a9a epochs of the LR train runs: the first captures the graph of its
#: one group of 4 batches, every later one replays it
LR_EPOCHS = 8
#: GloVe epochs: 12 groups of 8 steps each, the first group captured
GLOVE_EPOCHS = 2


def _exact(path: str, counts: dict, steps: int, per_step=None) -> None:
    """``counts`` is exactly ``steps`` x the path's launches a step."""
    per_step = per_step or LR_GLOVE_STEP[path]
    want = {**dict.fromkeys(counts, 0),
            **{k: v * steps for k, v in per_step.items()}}
    if counts != want:
        raise AssertionError(f"{path}: {steps} step(s) launched {counts}, "
                             f"its path gives {want}")


def _lr_batch(model, data):
    """The first minibatch of ``data`` as the sparse step takes it, on
    the model's device: ``(slots, vals, mask, targets)``."""
    batch = next(iter_minibatches(data, model.minibatch, data.max_feats))
    slots = model.table.key_index.lookup(np.where(batch.mask,
                                                  batch.feat_ids, 0))
    return tuple(torch.as_tensor(np.asarray(c), device=model.device)
                 for c in (slots, batch.feat_vals, batch.mask,
                           batch.targets))


def phase_kernels_lr_glove(lr, a9a_data, wide_data, glove) -> list:
    """B1-B3 at logistic regression's and GloVe's shapes, and B5 at their
    sharded width-1 and width-100 buckets, each against its plain version
    and timed as in phase 2: the a9a pull of 114,688 width-1 rows (the
    scalar form), its dense push onto 160 slots (~930 a slot) with counts
    and AdaGrad over the (160, 1) table with the counts' divisor; the wide
    shape's pull and dense push of 115,000 rows at 131,072 slots, and its
    sparse push's row form on the 4,194,304-row table; GloVe's pulls of
    8,192 rows x 100 and x 1 and its pushes' row forms."""
    rng = np.random.default_rng(17)
    dev = lr.device
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    cases = []
    slots, _, mask, _ = _lr_batch(lr, a9a_data)
    flat = torch.where(mask, slots, -1).reshape(-1).contiguous()
    valid = flat >= 0
    val, cap = lr.table.state["val"], lr.table.capacity
    cases.append(_gather_case("LR a9a pull, width 1", val, flat, valid,
                              flush, "lr"))
    cases.append(_scatter_case("LR a9a push, width 1, ~930 a slot", "lr",
                               flat, valid, cap, 1, rng, flush))
    accum = torch.as_tensor(rng.random((cap, 1), np.float32) * 1e-2,
                            device=dev)
    counts = torch.bincount(flat[valid].long(), minlength=cap).float()
    grad = torch.as_tensor(rng.normal(size=(cap, 1)).astype(np.float32),
                           device=dev)
    cases.append(_adagrad_case("LR a9a table (160, 1), / counts", "lr",
                               val, accum, grad, 0.05, flush,
                               div=counts.clamp(min=1.0)))
    # the wide shape: a batch's 115,000 slots in a 131,072-row table (its
    # push dense), and the rows of its sparse push at 4,194,304 rows
    ki = KeyIndex(1, 1 << 17)
    wb = next(iter_minibatches(wide_data, 1_000, wide_data.max_feats))
    wslots = ki.lookup(np.where(wb.mask, wb.feat_ids, 0))
    wflat = torch.as_tensor(np.where(wb.mask, wslots, -1).reshape(-1),
                            device=dev)
    wvalid = wflat >= 0
    wtable = torch.rand((1 << 17, 1), generator=_device_gen(dev, rng),
                        device=dev)
    cases.append(_gather_case("LR wide pull, width 1", wtable, wflat,
                              wvalid, flush, "lr_wide"))
    cases.append(_scatter_case("LR wide dense push, width 1", "lr_wide",
                               wflat, wvalid, 1 << 17, 1, rng, flush))
    waccum = torch.rand((1 << 17, 1), generator=_device_gen(dev, rng),
                        device=dev) * 1e-2
    wgrad = torch.randn((1 << 17, 1), generator=_device_gen(dev, rng),
                        device=dev)
    wcount = torch.bincount(wflat[wvalid].long(), minlength=1 << 17).float()
    cases.append(_adagrad_case("LR wide table (131072, 1), / counts",
                               "lr_wide", wtable, waccum, wgrad, 0.05, flush,
                               div=wcount.clamp(min=1.0)))
    big = 1 << 22
    btable = torch.rand((big, 1), generator=_device_gen(dev, rng),
                        device=dev)
    baccum = torch.rand((big, 1), generator=_device_gen(dev, rng),
                        device=dev) * 1e-2
    reps = torch.unique(wflat[wvalid]).to(torch.int32)
    inv = 1.0 / torch.as_tensor(rng.integers(1, 3, reps.numel())
                                .astype(np.float32), device=dev)
    cases.append(_adagrad_case(
        "LR wide sparse push rows, row-indexed", "lr_wide", btable, baccum,
        torch.randn((reps.numel(), 1), generator=_device_gen(dev, rng),
                    device=dev), 0.05, flush, rows=(reps, None), mul=inv))
    # GloVe: one batch's focus slots, its pulls and its pushes' rows
    n = len(glove._coo[2])
    fs, cs, _, _ = glove.stage(np.random.default_rng(0).permutation(n)
                               [:glove.minibatch], 1, glove.minibatch)
    fs = fs[0].contiguous()
    gstate = glove.table.state
    ok = torch.ones_like(fs, dtype=torch.bool)
    cases.append(_gather_case("GloVe w pull, 8,192 x 100", gstate["w"], fs,
                              ok, flush, "glove"))
    cases.append(_gather_case("GloVe b pull, 8,192 x 1", gstate["b"], fs,
                              ok, flush, "glove"))
    grows = torch.unique(fs).to(torch.int32)
    ginv = 1.0 / torch.as_tensor(rng.integers(1, 9, grows.numel())
                                 .astype(np.float32), device=dev)
    for f, d in (("w", glove.len_vec), ("b", 1)):
        cases.append(_adagrad_case(
            f"GloVe {f} push rows, row-indexed", "glove", gstate[f],
            gstate[f + "2sum"] + 1e-3,
            torch.randn((grows.numel(), d), generator=_device_gen(dev, rng),
                        device=dev) * 1e-2, glove.access.learning_rate,
            flush, rows=(grows, None), mul=ginv))
    # the sharded paths' buckets: LR's width-1 rows (C = 114,688 / 8 a
    # rank), the same at an odd C, whose blocks are not 16-byte aligned,
    # and GloVe's width-1 and width-100 rows (C = 8,192 / 8)
    C = flat.numel() // SHARDS
    for label, tail, path in (
            (f"LR@{SHARDS} val rows, width 1", (C, 1), f"lr@{SHARDS}"),
            (f"width 1, C = 1,001 (blocks not 16-byte aligned)", (1001, 1),
             f"lr@{SHARDS}"),
            (f"GloVe@{SHARDS} b rows, width 1",
             (glove.minibatch // SHARDS, 1), f"glove@{SHARDS}"),
            (f"GloVe@{SHARDS} w rows, width 100",
             (glove.minibatch // SHARDS, glove.len_vec), f"glove@{SHARDS}")):
        cases.append(_ring_case(label, tail, torch.float32, rng, flush, dev,
                                path=path))
    return cases


def phase_parity_lr_glove(glove) -> None:
    """One LR step at the a9a shape in each rendering, and one GloVe step
    at bench.py's shape, on the card and on the CPU from the same table:
    every field within 1e-5 + 1e-3|b| (B3's and ``index_add_``'s sums land
    in no fixed order), the loss within 1e-5 relative."""
    for dense in (0, 1):
        card, data = lr_model("a9a", dense=dense, device=DEVICE)
        cpu, _ = lr_model("a9a", dense=dense, device="cpu")
        cpu.table.state = _cpu_state(card.table.state, cpu)
        cols = _lr_batch(card, data)
        _lr_batch(cpu, data)
        kernels.reset_launches()
        if dense:
            X, cnt, t, v = card._densify(*(c.cpu().numpy() for c in cols))
            num_c, n_c = card._dense_core(*(torch.as_tensor(a, device=DEVICE)
                                            for a in (X, cnt, t, v)))
            counts = kernels.launch_counts()
            num_p, n_p = cpu._dense_core(*(torch.as_tensor(a)
                                           for a in (X, cnt, t, v)))
        else:
            num_c, n_c = card._step_core(*cols)
            counts = kernels.launch_counts()
            num_p, n_p = cpu._step_core(*(c.cpu() for c in cols))
        path = "lr_dense" if dense else "lr"
        _exact(path, counts, 1)
        if float(n_c) != float(n_p) or not math.isclose(
                float(num_c), float(num_p), rel_tol=1e-5):
            raise AssertionError(f"{path} step: card ({float(num_c)}, "
                                 f"{float(n_c)}), cpu ({float(num_p)}, "
                                 f"{float(n_p)})")
        gap = {f: _field_gap(f"{path} step, field {f}", _global(v),
                             _global(cpu.table.state[f]))
               for f, v in card.table.state.items()}
        _json_line({"phase": "step_parity", "rendering": path,
                    "rows": int(n_c), "slots": cols[0].numel(),
                    "loss": [float(num_c) / float(n_c),
                             float(num_p) / float(n_p)],
                    "gap": gap, "envelope": "1e-5 + 1e-3*|cpu|",
                    "push_paths": dict(card.transfer.push_paths),
                    "launches": counts})
    cpu = glove_model(device="cpu")
    cpu.table.state = _cpu_state(glove.table.state, cpu)
    sel = np.random.default_rng(1).permutation(len(glove._coo[2]))
    sel = sel[:glove.minibatch]
    fields = glove.stage(sel, 1, glove.minibatch)
    kernels.reset_launches()
    (loss_c,) = glove._step(*(f[0] for f in fields))
    counts = kernels.launch_counts()
    (loss_p,) = cpu._step(*(f[0].cpu() for f in fields))
    _exact("glove", counts, 1)
    if not math.isclose(float(loss_c), float(loss_p), rel_tol=1e-5):
        raise AssertionError(f"glove step: loss card {float(loss_c)}, cpu "
                             f"{float(loss_p)}")
    gap = {f: _field_gap(f"glove step, field {f}", _global(v),
                         _global(cpu.table.state[f]))
           for f, v in glove.table.state.items()}
    _json_line({"phase": "step_parity", "rendering": "glove",
                "cells": glove.minibatch,
                "loss": [float(loss_c), float(loss_p)], "gap": gap,
                "envelope": "1e-5 + 1e-3*|cpu|",
                "push_paths": dict(glove.transfer.push_paths),
                "launches": counts})


def phase_train_lr(path: str, card: str) -> dict:
    """``LogisticRegression.train`` at the a9a shape over ``LR_EPOCHS``
    epochs: ``lr`` (sparse rendering) and ``lr_dense`` with
    ``inner_steps: 4`` (each epoch one graph replay, the first epoch its
    capture), ``lr@8`` on the sharded server (steps one by one).  Exact
    launches a step, a finite loss that falls."""
    sharded = "@" in path
    model, data = lr_model("a9a", dense=int(path == "lr_dense"),
                           inner=1 if sharded else 4,
                           shards=SHARDS if sharded else 0, device=DEVICE)
    kernels.reset_launches()
    losses = model.train(data, niters=LR_EPOCHS)
    counts = kernels.launch_counts()
    m = model.train_metrics
    _exact(path, counts, m["steps"])
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"{path}: losses {losses}")
    want_replays = 0 if sharded else LR_EPOCHS - 1
    if m["graph_replays"] != want_replays or m["fused"] == sharded:
        raise AssertionError(f"{path}: fused {m['fused']}, "
                             f"{m['graph_replays']} replays")
    extra = {}
    if sharded:
        extra = {"overflow_count": model.transfer.overflow_count(),
                 "wait_timeouts": ring.timeouts(),
                 "shard_fill": model.table.key_index.shard_fill().tolist()}
        if extra["overflow_count"] or extra["wait_timeouts"]:
            raise AssertionError(f"{path}: {extra}")
    _json_line({"phase": "train", "rendering": path, "card": card,
                "shape": "a9a", "epochs": LR_EPOCHS, "loss": losses,
                "steps": m["steps"], "records": m["records"],
                "seconds": m["seconds"],
                "records_per_sec": m["records_per_sec"],
                "graph_replays": m["graph_replays"],
                "growths": m["growths"], "capacity": m["capacity"],
                "push_paths": m["push_paths"], "launches": counts, **extra})
    return counts


def phase_train_lr_wide(wide_data, card: str) -> dict:
    """One epoch at the wide shape with ``inner_steps: 4``: the table
    grows from 65,536 rows six times, to 4,194,304, mid-epoch (each growth
    flushes the queued group, drops the graphs and captures anew), its
    pushes dense at 131,072 rows and sparse above.  Held against the same
    epoch run one step at a time: the same steps, growths and push paths,
    the loss within 1e-4 relative, and the table's largest gap reported
    (the sums land in no fixed order).  A replay on a freed table would
    leave these far behind."""
    runs = []
    for inner in (4, 1):
        model, _ = lr_model("wide", inner=inner, device=DEVICE)
        kernels.reset_launches()
        losses = model.train(wide_data, niters=1)
        runs.append((model, losses, kernels.launch_counts()))
    (g, lg, counts), (e, le, counts_e) = runs
    mg, me = g.train_metrics, e.train_metrics
    dense = mg["push_paths"].get("val:dense", 0)
    per = {"gather": 1, "adagrad": 1}
    _exact("lr_wide", counts, mg["steps"], per_step={
        **per, "scatter": dense / max(mg["steps"], 1)})
    if counts != counts_e or mg["push_paths"] != me["push_paths"] \
            or (mg["steps"], mg["growths"], mg["capacity"]) != \
            (me["steps"], me["growths"], me["capacity"]) \
            or mg["growths"] != 6 or mg["capacity"] != 1 << 22 \
            or not dense or "val:sparse" not in mg["push_paths"] \
            or mg["graph_replays"] < 1 \
            or not math.isclose(lg[0], le[0], rel_tol=1e-4):
        raise AssertionError(f"wide: graphs {mg} {counts} loss {lg}; eager "
                             f"{me} {counts_e} loss {le}")
    gap = (g.table.state["val"] - e.table.state["val"]).abs().max().item()
    _json_line({"phase": "train", "rendering": "lr_wide", "card": card,
                "rows": len(wide_data), "features": SHAPES["wide"][0]["dim"],
                "loss": [lg[0], le[0]], "steps": mg["steps"],
                "growths": mg["growths"], "capacity": mg["capacity"],
                "graph_replays": mg["graph_replays"],
                "seconds": [mg["seconds"], me["seconds"]],
                "records_per_sec": [mg["records_per_sec"],
                                    me["records_per_sec"]],
                "val_max_gap_graphs_vs_eager": gap,
                "push_paths": mg["push_paths"], "launches": counts})
    return counts


def phase_train_glove(path: str, card: str) -> dict:
    """``GloVe.train`` at bench.py's shape with ``inner_steps: 8`` and
    ``pipeline: 4``: ``glove`` (a graph replay a group but the first,
    ``GLOVE_EPOCHS`` epochs) and ``glove@8`` (the sharded server, steps one
    by one, one epoch).  Exact launches a step, a finite loss."""
    sharded = "@" in path
    model = glove_model(shards=SHARDS if sharded else 0, device=DEVICE)
    epochs = 1 if sharded else GLOVE_EPOCHS
    kernels.reset_launches()
    losses = model.train(niters=epochs)
    counts = kernels.launch_counts()
    m = model.train_metrics
    _exact(path, counts, m["steps"])
    groups = m["steps"] // m["inner_steps"]
    if not all(math.isfinite(x) for x in losses) \
            or m["graph_replays"] != (0 if sharded else groups - 1) \
            or m["pipeline"]["produced"] != groups \
            or (epochs > 1 and losses[-1] >= losses[0]):
        raise AssertionError(f"{path}: losses {losses}, {m}")
    if sharded and (model.transfer.overflow_count() or ring.timeouts()):
        raise AssertionError(f"{path}: overflow or a wait timed out")
    _json_line({"phase": "train", "rendering": path, "card": card,
                "vocab": len(model.vocab), "cells": len(model._coo[2]),
                "capacity": model.table.capacity, "epochs": epochs,
                "loss": losses, "steps": m["steps"],
                "seconds": m["seconds"], "cells_per_sec": m["cells_per_sec"],
                "stall_ms_per_step": m["stall_ms_per_step"],
                "graph_replays": m["graph_replays"],
                "pipeline": m["pipeline"], "push_paths": m["push_paths"],
                "launches": counts})
    return counts


def _cli_lines(main, argv) -> list:
    """``main(argv)``'s standard output lines; raises on a non-zero exit."""
    buf = io.StringIO()
    reset_global_config()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{argv[0]} returned {rc}")
    return buf.getvalue().splitlines()


def phase_cli_lr_glove(vocab, corpus: np.ndarray) -> None:
    """The CLIs on the card: ``lr_main`` train -> predict -> eval on a
    libSVM file the script writes (read by the native parser), the a9a
    shape's first 4,096 rows; ``glove_main`` on a corpus prefix, then
    ``w2v_eval`` on its dump and on a word2vec dump (queries and an
    analogy through the product and top-k on the card)."""
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    data = synthetic_dataset(**SHAPES["a9a"][0])[:4096]
    svm = WORK / "a9a.svm"
    with open(svm, "w") as f:
        for y, feats in data:
            f.write(f"{1 if y > 0 else -1} "
                    + " ".join(f"{k}:{v:.6g}" for k, v in feats) + "\n")
    conf = WORK / "lr.conf"
    conf.write_text("[cluster]\ntransfer: xla\nserver_num: 1\n[worker]\n"
                    "minibatch: 1024\ninner_steps: 2\n[server]\n"
                    "initial_learning_rate: 0.5\n")
    models = []

    class Recording(LogisticRegression):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            models.append(self)

    weights, preds = WORK / "w.txt", WORK / "p.txt"
    common = ["lr", "-config", str(conf), "-dataset", str(svm), "-device",
              DEVICE]
    kernels.reset_launches()
    lr_main.LogisticRegression = Recording
    try:
        _cli_lines(lr_main.main, common + ["-mode", "train", "-niters", "10",
                                           "-output", str(weights)])
        _cli_lines(lr_main.main, common + ["-mode", "predict", "-param",
                                           str(weights), "-output",
                                           str(preds)])
        out = _cli_lines(lr_main.main, common + ["-mode", "eval", "-param",
                                                 str(weights)])
    finally:
        lr_main.LogisticRegression = LogisticRegression
    counts = kernels.launch_counts()
    err = float(out[-1].split()[-1])
    parsers = [m.parser for m in models]
    scores = np.loadtxt(preds)
    if parsers != ["native"] * 3 or scores.shape != (4096,) \
            or not ((scores >= 0) & (scores <= 1)).all() or not err < 0.3 \
            or models[0].train_metrics["graph_replays"] < 1:
        raise AssertionError(f"lr_main: parsers {parsers}, error rate "
                             f"{err}, {models[0].train_metrics}")
    _json_line({"phase": "cli", "app": "lr_main", "parser": parsers[0],
                "weights": len(weights.read_text().splitlines()),
                "predictions": len(scores), "error_rate": err,
                "launches": counts})
    # GloVe on a corpus prefix, then the eval CLI on its dump
    text = WORK / "corpus.txt"
    write_tokens_file(corpus[:40], str(text))
    gconf = WORK / "glove.conf"
    gconf.write_text("[cluster]\ntransfer: xla\nserver_num: 1\n[glove]\n"
                     "len_vec: 100\nwindow: 8\nminibatch: 8192\n[worker]\n"
                     "inner_steps: 4\npipeline: 2\n")
    emb, full = WORK / "glove.txt", WORK / "glove_full.txt"
    kernels.reset_launches()
    _cli_lines(glove_main.main, ["glove", "-config", str(gconf), "-data",
                                 str(text), "-niters", "2", "-output",
                                 str(emb), "-output-full", str(full),
                                 "-device", DEVICE])
    counts = kernels.launch_counts()
    rows = emb.read_text().splitlines()
    first = rows[0].split("\t")
    if len(first[1].split()) != 100 or len(full.read_text().splitlines()[0]
                                           .split("\t")) != 5 \
            or not counts["gather"] or not counts["adagrad"]:
        raise AssertionError(f"glove_main: {len(rows)} rows, {counts}")
    q = ",".join(r.split("\t")[0] for r in rows[:3])
    out = _cli_lines(w2v_eval.main, ["eval", "-embeddings", str(emb),
                                     "-query", q, "-topk", "5", "-device",
                                     DEVICE])
    if len(out) != 3 * 6 or not all(
            math.isfinite(float(ln.split("\t")[1])) for ln in out
            if ln.startswith("  ")):
        raise AssertionError(f"w2v_eval on the GloVe dump: {out}")
    # and on a word2vec dump of the card
    w2v = _model("gather", vocab, DEVICE)
    w2v.train(batcher=CBOWBatcher(corpus[:50], vocab, w2v.window,
                                  w2v.sample, seed=2008),
              niters=1, batch_size=BATCH)
    dump = WORK / "w2v.txt"
    w2v.save(str(dump))
    keys = [int(k) for k in vocab.keys[:3]]
    out2 = _cli_lines(w2v_eval.main, [
        "eval", "-embeddings", str(dump), "-query",
        ",".join(map(str, keys)), "-analogy",
        f"{keys[0]}:{keys[1]}::{keys[2]}", "-topk", "5", "-device", DEVICE])
    index = EmbeddingIndex.from_text(str(dump), device=DEVICE)
    want = index.neighbors(keys[0], 5)
    cpu_index = EmbeddingIndex.from_text(str(dump), device="cpu")
    got_cpu = cpu_index.neighbors(keys[0], 5)
    if len(out2) != 6 + 3 * 6 or not np.allclose(want[1], got_cpu[1],
                                                 rtol=1e-5, atol=1e-6):
        raise AssertionError(f"w2v_eval on the word2vec dump: {out2}; card "
                             f"{want}, cpu {got_cpu}")
    _json_line({"phase": "cli", "app": "glove_main -> w2v_eval",
                "glove_rows": len(rows), "glove_launches": counts,
                "w2v_eval_lines": len(out) + len(out2),
                "w2v_dump_rows": len(index),
                "neighbours_card_vs_cpu_max_gap":
                float(np.abs(want[1] - got_cpu[1]).max())})
    shutil.rmtree(WORK)


def phase_lr_glove(vocab, corpus: np.ndarray, card: str) -> tuple:
    """Phase 8: returns the kernel cases at the new paths' shapes and the
    launches of each path's train run."""
    t0 = time.perf_counter()
    lr, a9a = lr_model("a9a", device=DEVICE)
    glove = glove_model(device=DEVICE)
    wide = to_csr(synthetic_dataset(**SHAPES["wide"][0]))
    print(f"phase 8 set-up {time.perf_counter() - t0:.1f} s (a9a, GloVe "
          f"{len(glove.vocab)} words x {len(glove._coo[2])} cells, wide "
          f"{len(wide)} rows)", flush=True)
    cases = phase_kernels_lr_glove(lr, a9a, wide, glove)
    report_cases(cases)
    phase_parity_lr_glove(glove)
    del lr, glove
    counts = {p: phase_train_lr(p, card)
              for p in ("lr", "lr_dense", f"lr@{SHARDS}")}
    counts["lr_wide"] = phase_train_lr_wide(wide, card)
    for p in ("glove", f"glove@{SHARDS}"):
        counts[p] = phase_train_glove(p, card)
    phase_cli_lr_glove(vocab, corpus)
    return cases, counts


# -- phase 9: the hybrid transfer and the traffic ledger ---------------------

#: the hybrid paths: the reference configuration on ``transfer: hybrid``
#: over SHARDS ranks (the frequency head in hot planes, the tail routed as
#: on ``tpu``), and bench.py's scale_hybrid shape at one shard
HYBRID = f"hybrid@{SHARDS}"
SCALE = "scale_hybrid"
#: launches a step of ``HYBRID``: the tpu path's (``SHARDED``) plus, for
#: the head, one gather per pull, one scatter-add (counts included) and one
#: AdaGrad over the hot plane per pushed family
HYBRID_STEP = {k: v + (2 if k != "ring" else 0)
               for k, v in SHARDED[f"gather@{SHARDS}"].items()}
HYBRID_KERNELS = {"gather", "scatter", "adagrad", "ring"}
#: scale_hybrid steps through ``Word2Vec.train``
SCALE_STEPS = 6


def _hybrid_model(rendering: str, vocab, device: str, conf=None,
                  shards: int = SHARDS) -> Word2Vec:
    """A ``transfer: hybrid`` model on ``shards`` ranks: the reference
    configuration (``conf`` None) in ``rendering``, or ``conf``."""
    if conf is None:
        conf = ConfigParser().update(DEMO_CONF)
        conf.set("word2vec", "stencil", int(rendering == "stencil"))
    conf.set("cluster", "transfer", "hybrid")
    conf.set("cluster", "server_num", shards)
    model = Word2Vec(config=conf, device=device)
    if model.transfer.name != "hybrid" or \
            model.resolved_rendering != rendering:
        raise AssertionError(f"hybrid {rendering} conf gave transfer "
                             f"{model.transfer.name}, rendering "
                             f"{model.resolved_rendering}")
    model.build_from_vocab(vocab)
    if not model.table.n_hot:
        raise AssertionError("the hybrid model has no hot head")
    return model


def phase_kernels_hybrid(model: Word2Vec, batch, scale_n_hot: int) -> list:
    """B1-B3 and B5 at the shapes one ``HYBRID`` gather step gives the
    head and the tail: the hot pull of the h and v slots from the hot
    planes (hot rows valid, tail rows zero), the hot push of their grads
    onto ``(n_hot, 100)`` with counts (hundreds of contributions a slot),
    AdaGrad over the hot plane with the mean's reciprocal, also over
    scale_hybrid's ``(scale_n_hot, 100)`` plane, and the tail's row
    exchange; each against its plain version."""
    rng = np.random.default_rng(31)
    dev, d = model.device, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    n_hot = model.table.n_hot
    state = model.table.state
    h_slots, v_slots = _step_inputs(model, batch, rng)
    cases = []
    for fam, slots in (("h", h_slots), ("v", v_slots)):
        hot = ((slots >= 0) & (slots < n_hot)).contiguous()
        cases.append(_gather_case(f"hybrid {fam} hot pull", state[fam + "@hot"],
                                  slots, hot, flush, HYBRID))
        cases.append(_scatter_case(f"hybrid {fam} hot push", HYBRID, slots,
                                   hot, n_hot, d, rng, flush))
    for label, rows, path in (("hybrid hot plane", n_hot, HYBRID),
                              ("scale_hybrid hot plane", scale_n_hot, SCALE)):
        param = torch.as_tensor(rng.normal(size=(rows, d)).astype(np.float32)
                                * 0.1, device=dev)
        accum = torch.as_tensor(rng.random((rows, d), np.float32) * 1e-3,
                                device=dev)
        grad = torch.as_tensor(rng.normal(size=(rows, d)).astype(np.float32)
                               * 1e-2, device=dev)
        inv = 1.0 / torch.as_tensor(rng.integers(1, 400, rows)
                                    .astype(np.float32), device=dev)
        cases.append(_adagrad_case(f"{label}, * 1/counts", path, param,
                                   accum, grad, model.access.learning_rate,
                                   flush, mul=inv))
    C = h_slots.shape[0] // SHARDS
    cases.append(_ring_case("hybrid tail h rows", (C, d), torch.float32, rng,
                            flush, dev, path=HYBRID))
    return cases


def phase_step_parity_hybrid(rendering: str, vocab, batch) -> None:
    """One ``HYBRID`` step (gather, or stencil with the span pulled
    through the transfer) on the card against the same step on the CPU
    from the same table, hot planes included, and the same draws: err_cnt
    exact, err_sum within 1e-4, every field and hot plane within
    ``_field_gap``'s tolerance, the head's kernels launched and the
    stencil kernel not."""
    model = _hybrid_model(rendering, vocab, "cuda")
    cpu_model = _hybrid_model(rendering, vocab, "cpu")
    cpu_model.table.state = _cpu_state(model.table.state, cpu_model)
    B = len(batch)
    draws = _draws(model, B, np.random.default_rng(12))
    kernels.reset_launches()
    es_c, ec_c = model.step_batch(batch, draws=draws)
    counts = kernels.launch_counts()
    es_p, ec_p = cpu_model.step_batch(
        batch, draws=tuple(t.cpu() for t in draws))
    if ec_c != ec_p or not math.isclose(es_c, es_p, rel_tol=1e-4):
        raise AssertionError(f"hybrid {rendering} step: card ({es_c}, "
                             f"{ec_c}), cpu ({es_p}, {ec_p})")
    worst = {f: _field_gap(f"hybrid {rendering} step parity: field {f}",
                           _global(v), _global(cpu_model.table.state[f]))
             for f, v in model.table.state.items()}
    if rendering == "gather" and counts != dict(HYBRID_STEP, stencil=0):
        raise AssertionError(f"hybrid gather step launched {counts}, its "
                             f"path is {HYBRID_STEP}")
    if {k for k, n in counts.items() if n} != HYBRID_KERNELS:
        raise AssertionError(f"hybrid {rendering} step launched {counts}")
    if model.transfer.push_paths != cpu_model.transfer.push_paths:
        raise AssertionError(f"hybrid {rendering} push paths "
                             f"{model.transfer.push_paths} vs the CPU's "
                             f"{cpu_model.transfer.push_paths}")
    _json_line({"phase": "step_parity", "rendering": f"{rendering}:{HYBRID}",
                "n_hot": model.table.n_hot, "centers": B,
                "real_centers": batch.n_words, "err_sum": [es_c, es_p],
                "err_cnt": [ec_c, ec_p], "gap": worst,
                "envelope": "1e-5 + 1e-3*|cpu|",
                "push_paths": dict(model.transfer.push_paths),
                "launches": counts})


def _traffic_keys(tr: dict) -> dict:
    return {k: tr[k] for k in ("routed_rows", "hot_rows", "psum_bytes",
                               "wire_bytes", "dispatches", "pull_rows",
                               "pull_bytes", "pull_hot_rows")}


def phase_train_hybrid(vocab, corpus: np.ndarray, card: str) -> dict:
    """``Word2Vec.train`` of the reference configuration on ``HYBRID``
    over gather@8's corpus prefix with ``count_traffic``, launching exactly
    ``HYBRID_STEP`` a step, and ``gather@8`` (``tpu``) over the same
    batches: hybrid's ``routed_rows + hot_rows`` must equal tpu's
    ``routed_rows`` exactly.  Then (iv): the trained hybrid table's npz
    (with ``n_hot`` and the ``@hot`` planes) restores into a fresh card
    model bit for bit, in place."""
    runs = {}
    for path in (HYBRID, f"gather@{SHARDS}"):
        model = (_hybrid_model("gather", vocab, "cuda") if path == HYBRID
                 else _model(path, vocab, "cuda"))
        model.transfer.count_traffic = True
        batcher = CBOWBatcher(corpus[:PATHS[f"gather@{SHARDS}"][2]], vocab,
                              model.window, model.sample, seed=2008)
        kernels.reset_launches()
        losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
        runs[path] = (model, losses, kernels.launch_counts(),
                      model.train_metrics)
    hyb, losses, counts, m = runs[HYBRID]
    tpu_m = runs[f"gather@{SHARDS}"][3]
    want = {**dict.fromkeys(counts, 0),
            **{k: v * m["steps"] for k, v in HYBRID_STEP.items()}}
    if counts != want or not all(math.isfinite(x) for x in losses) \
            or m["steps"] < MIN_TRAIN_STEPS:
        raise AssertionError(f"{HYBRID} train: launches {counts} in "
                             f"{m['steps']} steps, its path gives {want}; "
                             f"loss {losses}")
    th, tt = m["transfer_traffic"], tpu_m["transfer_traffic"]
    if th["routed_rows"] + th["hot_rows"] != tt["routed_rows"] \
            or th["overflow_dropped"] or ring.timeouts():
        raise AssertionError(f"row conservation: hybrid {th}, tpu {tt}")
    _json_line({"phase": "train", "rendering": HYBRID, "card": card,
                "n_hot": hyb.table.n_hot, "loss": losses,
                "tpu_loss": runs[f"gather@{SHARDS}"][1],
                "steps": m["steps"], "words": m["words"],
                "seconds": m["seconds"], "words_per_sec": m["words_per_sec"],
                "tpu_words_per_sec": tpu_m["words_per_sec"],
                "traffic": _traffic_keys(th),
                "tpu_traffic": _traffic_keys(tt),
                "routed_rows_ratio": tt["routed_rows"] / th["routed_rows"],
                "push_paths": m["push_paths"], "launches": counts})
    del runs
    # (iv) the npz of a hybrid table, reloaded on the card
    ck = str(WORK / "checkpoint" / "hybrid")
    save_checkpoint(hyb.table, ck, extra={"iter": np.int64(1)})
    with np.load(npz_path(ck)) as z:
        saved = (int(z["n_hot"]), z["field__h@hot"].shape)
    fresh = _hybrid_model("gather", vocab, "cuda")
    ptrs = [t.data_ptr() for t in _tensors(fresh.table.state)]
    if fresh.resume(ck) != 1 or ptrs != [
            t.data_ptr() for t in _tensors(fresh.table.state)]:
        raise AssertionError("hybrid resume: iteration or tensors moved")
    _hold_equal("hybrid card save -> card load", fresh.table.state,
                hyb.table.state)
    if saved != (hyb.table.n_hot, (hyb.table.n_hot, hyb.len_vec)) or \
            list(fresh.table.key_index.items()) != \
            list(hyb.table.key_index.items()):
        raise AssertionError(f"hybrid npz: n_hot and hot plane {saved}, "
                             f"table n_hot {hyb.table.n_hot}")
    _json_line({"phase": "checkpoint", "rendering": HYBRID, "card": card,
                "n_hot": saved[0], "hot_plane": list(saved[1]),
                "npz_bytes": os.path.getsize(npz_path(ck)),
                "round_trip": "bit-exact card -> card, in place"})
    shutil.rmtree(WORK / "checkpoint")
    return counts


def phase_train_scale(card: str) -> tuple:
    """bench.py's scale_hybrid shape at one shard and full width
    (``w2v_profile.SCALE_CONF``: 1,000,000 keys, len_vec 100, stencil with
    a shared pool of 4,096) through ``Word2Vec.train`` for
    ``SCALE_STEPS`` steps of ``SCALE_BATCH`` centers with spans drawn from
    the vocabulary's counts (``ZipfSpans``), counting traffic: finite
    loss, the hybrid kernels each launched every step, the stencil kernel
    never.  Returns the launches and the head's size."""
    t0 = time.perf_counter()
    vocab = scale_vocab()
    conf = ConfigParser().update(SCALE_CONF)
    model = _hybrid_model("stencil_shared", vocab, "cuda", conf=conf,
                          shards=1)
    setup_s = time.perf_counter() - t0
    model.transfer.count_traffic = True
    batcher = ZipfSpans(vocab, model.window, SCALE_STEPS)
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=SCALE_BATCH)
    counts = kernels.launch_counts()
    m = model.train_metrics
    tr = m["transfer_traffic"]
    launched = {k for k, n in counts.items() if n}
    if m["steps"] != SCALE_STEPS or launched != HYBRID_KERNELS or \
            min(counts[k] for k in HYBRID_KERNELS) < SCALE_STEPS or \
            not all(math.isfinite(x) for x in losses) or \
            not tr["hot_rows"] or not tr["routed_rows"]:
        raise AssertionError(f"{SCALE}: {m['steps']} steps, launches "
                             f"{counts}, loss {losses}, traffic {tr}")
    _json_line({"phase": "train", "rendering": SCALE, "card": card,
                "vocab": len(vocab), "n_hot": model.table.n_hot,
                "head_mass": model.table.key_index.partition.head_mass,
                "capacity": model.table.capacity,
                "setup_seconds": setup_s, "loss": losses,
                "steps": m["steps"], "words": m["words"],
                "seconds": m["seconds"], "words_per_sec": m["words_per_sec"],
                "traffic": _traffic_keys(tr),
                "hot_share_of_rows": tr["hot_rows"] / (
                    tr["hot_rows"] + tr["routed_rows"]),
                "push_paths": m["push_paths"], "launches": counts})
    return counts, model.table.n_hot


def phase_ledger_graphs(vocab, corpus: np.ndarray, card: str) -> None:
    """(v) The ledger under CUDA graphs: ``gather`` on ``xla`` with
    ``inner_steps: 8`` (graph replays) books exactly what the plain loop
    books from the same table and generator seed."""
    out = []
    for worker in ({}, {"inner_steps": 8}):
        model = _model("gather", vocab, "cuda", worker)
        model.transfer.count_traffic = True
        batcher = CBOWBatcher(corpus[:PATHS["gather"][2]], vocab,
                              model.window, model.sample, seed=2008)
        model.train(batcher=batcher, niters=1, batch_size=BATCH)
        out.append(model.train_metrics)
    plain, graphed = out
    if not graphed["fused"] or graphed["graph_replays"] < 1 or \
            graphed["transfer_traffic"] != plain["transfer_traffic"] or \
            plain["transfer_traffic"]["dispatches"] != 2 * plain["steps"]:
        raise AssertionError(f"ledger under graphs: "
                             f"{graphed['transfer_traffic']} after "
                             f"{graphed['graph_replays']} replays, plain "
                             f"{plain['transfer_traffic']}")
    _json_line({"phase": "ledger_graphs", "rendering": "gather",
                "card": card, "inner_steps": 8,
                "graph_replays": graphed["graph_replays"],
                "steps": plain["steps"],
                "traffic": {k: v for k, v in
                            plain["transfer_traffic"].items() if v},
                "equal": True})


def phase_hybrid(vocab, corpus: np.ndarray, batch, sbatch,
                 card: str) -> tuple:
    """Phase 9: returns the kernel cases at the hybrid shapes and the
    launches of the hybrid paths' train runs."""
    t0 = time.perf_counter()
    scale_counts, scale_n_hot = phase_train_scale(card)
    torch.cuda.empty_cache()
    counts = {SCALE: scale_counts}
    ref = _hybrid_model("gather", vocab, "cuda")
    cases = phase_kernels_hybrid(ref, batch, scale_n_hot)
    del ref
    report_cases(cases)
    phase_step_parity_hybrid("gather", vocab, batch)
    phase_step_parity_hybrid("stencil", vocab, sbatch)
    counts[HYBRID] = phase_train_hybrid(vocab, corpus, card)
    phase_ledger_graphs(vocab, corpus, card)
    print(f"phase 9 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, counts


# -- phase 10: the window-coalesced push --------------------------------------

#: the window paths: the reference configuration with ``[cluster]
#: push_window: WINDOW`` in groups of ``inner_steps``, on the sharded
#: server (``tpu``), on ``hybrid`` (both SHARDS ranks) and on ``xla``
#: (each group one CUDA graph replay)
WINDOW = 4
WIN_TPU = f"window@{SHARDS}"
WIN_HYBRID = f"hybrid_window@{SHARDS}"
WIN_XLA = "window:xla"
#: WIN_TPU with no expected-unique hint: the pricer then takes the raw
#: rows (420,000 h rows a window, above half the 90,520) and every window
#: takes the dense rung
WIN_DENSE = f"window_dense@{SHARDS}"
#: the kernels each window path launches
WINDOW_KERNELS = {WIN_TPU: {"gather", "scatter", "adagrad", "ring"},
                  WIN_HYBRID: {"gather", "scatter", "adagrad", "ring"},
                  WIN_XLA: {"gather", "scatter", "adagrad"},
                  WIN_DENSE: {"gather", "scatter", "adagrad", "ring"}}
#: launches of one group of WINDOW steps (one window) at the reference
#: shape: per step two pulls (a gather each, and on the sharded paths two
#: ring exchanges, the hybrid's hot pull one more gather); per pushed
#: family one window: the dedup's scatter-add, the routed exchange of
#: the deduplicated rows with their counts (requests, grads, counts:
#: three ring exchanges, two owner scatter-adds) and AdaGrad over the
#: block, on hybrid also the hot push (grads and counts, AdaGrad over the
#: hot plane); on xla the window flattens into dense pushes (a
#: scatter-add with counts and AdaGrad over the table a family)
WINDOW_GROUP = {
    WIN_TPU: {"gather": 2 * WINDOW, "ring": 4 * WINDOW + 6, "scatter": 6,
              "adagrad": 2},
    WIN_HYBRID: {"gather": 4 * WINDOW, "ring": 4 * WINDOW + 6,
                 "scatter": 10, "adagrad": 4},
    WIN_XLA: {"gather": 2 * WINDOW, "scatter": 2, "adagrad": 2},
}
#: the ledger keys the window lines print
WINDOW_KEYS = ("window_sparse", "window_dense", "window_fmt_sparse",
               "window_fmt_dense", "coalesced_rows_in",
               "coalesced_rows_out", "routed_rows", "hot_rows", "wire_bytes",
               "dispatches", "collective_psum", "plan_compiles",
               "plan_cache_hits")


#: the losses of the train runs, by path (phase 11 holds a lossy window's
#: against its lossless base's)
TRAIN_LOSSES = {}


def _window_model(path: str, vocab, device: str,
                  inner: int = 2 * WINDOW) -> Word2Vec:
    """The model of a window path with ``inner_steps: inner``; a wire path
    (``WIRE_PATHS``) is its base path with its ``[cluster]`` knobs."""
    base, knobs = WIRE_PATHS.get(path, (path, {}))
    conf = ConfigParser().update(DEMO_CONF)
    conf.set("cluster", "push_window", WINDOW)
    conf.set("worker", "inner_steps", inner)
    for k, v in knobs.items():
        conf.set("cluster", k, v)
    path = base
    if path == WIN_HYBRID:
        return _hybrid_model("gather", vocab, device, conf=conf)
    sharded = path in (WIN_TPU, WIN_DENSE)
    if sharded:
        conf.set("cluster", "transfer", "tpu")
        conf.set("cluster", "server_num", SHARDS)
    model = Word2Vec(config=conf, device=device).build_from_vocab(vocab)
    if path == WIN_DENSE:
        model.transfer.window_expected_unique = None
    if model.push_window_size != WINDOW or model.transfer.name != (
            "tpu" if sharded else "xla"):
        raise AssertionError(f"{path}: push_window "
                             f"{model.push_window_size}, transfer "
                             f"{model.transfer.name}")
    return model


def _window_traffic(tr: dict) -> dict:
    return {k: tr.get(k, 0) for k in WINDOW_KEYS}


def phase_kernels_window(model: Word2Vec, batches) -> list:
    """B3 and B5 at the shapes one window of WINDOW gather steps on
    ``tpu@8`` gives them: the per-rank dedup's sums (each rank's W*B*(K+1)
    / SHARDS h rows onto as many representative slots, with counts), the
    routed exchange of the deduplicated h rows with their counts column
    (buckets of W*B*(K+1) / SHARDS slots), the owners' sums of what they
    receive, and the dense rung's plane (every window row onto the global
    ``(SHARDS * cap, 100)`` plane with counts); each against its plain
    version."""
    rng = np.random.default_rng(37)
    dev, d = model.device, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    state = model.table.state
    flat = torch.cat([_step_inputs(model, b, rng)[0] for b in batches])
    L = flat.shape[0] // SHARDS
    capacity = model.table.capacity
    owner, valid = window_owners(flat.view(SHARDS, L), capacity)
    cases = [_scatter_case("window dedup, h", WIN_TPU, owner,
                           valid.contiguous(), L, d, rng, flush)]
    ded = model.transfer._prim_window_dedup(
        flat, {"h": torch.zeros((flat.shape[0], 1), device=dev)}, None,
        capacity)[0]
    cases.append(_ring_case("window h rows + counts", (L, d + 1),
                            torch.float32, rng, flush, dev, path=WIN_TPU))
    groups, C, cap = model.transfer._route(state, ded)
    if C != L or len(groups) != 1:
        raise AssertionError(f"window buckets of {C} slots, expected {L}")
    owners = ring.ring_exchange_stacked(groups[0].req).view(SHARDS, -1)
    cases.append(_scatter_case(f"{SHARDS} owners' window h push", WIN_TPU,
                               owners, (owners >= 0).contiguous(), cap, d,
                               rng, flush, counts=False))
    cases.append(_scatter_case("window dense rung plane, h", WIN_DENSE,
                               flat, (flat >= 0).contiguous(), capacity, d,
                               rng, flush))
    return cases


def phase_window_parity(path: str, vocab, batches) -> dict:
    """One group of WINDOW steps (one window) at the reference shape on the
    card against the same group on the CPU from the same table and draws:
    err_cnt exact, err_sum within 1e-4, every field (hot planes included)
    within ``_field_gap``'s tolerance, the same ledger; exactly
    ``WINDOW_GROUP``'s launches."""
    model = _window_model(path, vocab, "cuda", inner=WINDOW)
    cpu_model = _window_model(path, vocab, "cpu", inner=WINDOW)
    cpu_model.table.state = _cpu_state(model.table.state, cpu_model)
    rng = np.random.default_rng(13)
    draws = [_draws(model, BATCH, rng) for _ in batches]
    fields = [torch.as_tensor(np.stack([np.asarray(f) for f in fs]),
                              device=model.device)
              for fs in zip(*map(_batch_fields, batches))]
    for m in (model, cpu_model):
        m.transfer.count_traffic = True
    t0 = time.perf_counter()
    kernels.reset_launches()
    es_c, ec_c = model._window_group(tuple(fields), draws)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    es_p, ec_p = cpu_model._window_group(
        tuple(f.cpu() for f in fields),
        [tuple(t.cpu() for t in d) for d in draws])
    cpu_s = time.perf_counter() - t0
    es_c, ec_c, es_p, ec_p = (float(x) for x in (es_c, ec_c, es_p, ec_p))
    if ec_c != ec_p or not math.isclose(es_c, es_p, rel_tol=1e-4):
        raise AssertionError(f"{path} window: card ({es_c}, {ec_c}), cpu "
                             f"({es_p}, {ec_p})")
    worst = _hold_tables(f"{path} window parity", model, cpu_model)
    tc = _window_traffic(model.transfer.traffic())
    tp = _window_traffic(cpu_model.transfer.traffic())
    want = {**dict.fromkeys(counts, 0), **WINDOW_GROUP[path]}
    # the plan cache is global: the card's model compiled the plans the
    # CPU's then found
    plans = ("plan_compiles", "plan_cache_hits")
    if counts != want or any(tc[k] != tp[k] for k in tc
                             if k not in plans) or \
            tc["window_sparse"] + tc["window_dense"] != 2:
        raise AssertionError(f"{path} window launched {counts} (its path "
                             f"gives {want}); ledger card {tc}, cpu {tp}")
    if model.transfer.overflow_count() or ring.timeouts():
        raise AssertionError(f"{path} window: overflow or wait timeout")
    _json_line({"phase": "window_parity", "rendering": path,
                "push_window": WINDOW, "steps": len(batches),
                "centers": BATCH, "err_sum": [es_c, es_p],
                "err_cnt": [ec_c, ec_p], "gap": worst,
                "envelope": "1e-5 + 1e-3*|cpu|", "traffic": tc,
                "window_expected_unique":
                model.transfer.window_expected_unique,
                "push_paths": dict(model.transfer.push_paths),
                "card_seconds": card_s, "cpu_seconds": cpu_s,
                "launches": counts})
    return counts


def phase_train_window(path: str, vocab, corpus: np.ndarray,
                       card: str) -> dict:
    """``Word2Vec.train`` of a window path over gather@8's corpus prefix
    with ``count_traffic`` (inner_steps 8, two windows a group): finite
    loss, exactly the path's kernels launched, window decisions booked
    (on xla, where windows flatten into the per-step push, none) and
    graph replays on xla."""
    model = _window_model(path, vocab, "cuda")
    model.transfer.count_traffic = True
    batcher = CBOWBatcher(corpus[:PATHS[f"gather@{SHARDS}"][2]], vocab,
                          model.window, model.sample, seed=2008)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
    counts = kernels.launch_counts()
    TRAIN_LOSSES[path] = losses
    m = model.train_metrics
    tr = _window_traffic(m["transfer_traffic"])
    launched = {k for k, n in counts.items() if n}
    graphs = path == WIN_XLA
    decided = tr["window_sparse"] + tr["window_dense"]
    if (path == WIN_DENSE) is not (tr["window_dense"] == decided > 0):
        raise AssertionError(f"{path} train: window decisions {tr}")
    if launched != WINDOW_KERNELS[path] or m["steps"] < MIN_TRAIN_STEPS \
            or not all(math.isfinite(x) for x in losses) \
            or m["fused"] is not graphs or (graphs and
                                            m["graph_replays"] < 1) \
            or (decided == 0) is not graphs or ring.timeouts() or \
            (not graphs and model.transfer.overflow_count()):
        raise AssertionError(f"{path} train: launches {counts}, "
                             f"{m['steps']} steps, loss {losses}, fused "
                             f"{m['fused']}, replays {m['graph_replays']}, "
                             f"ledger {tr}")
    _json_line({"phase": "train", "rendering": path, "card": card,
                "push_window": m["push_window"],
                "inner_steps": m["inner_steps"], "fused": m["fused"],
                "graph_replays": m["graph_replays"], "loss": losses,
                "steps": m["steps"], "words": m["words"],
                "seconds": m["seconds"], "words_per_sec": m["words_per_sec"],
                "traffic": tr,
                "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
                "push_paths": m["push_paths"], "launches": counts})
    return counts


def phase_window(vocab, corpus: np.ndarray, card: str) -> tuple:
    """Phase 10: returns the kernel cases at the window shapes and the
    launches of the window paths' train runs."""
    t0 = time.perf_counter()
    ref = _window_model(WIN_TPU, vocab, "cuda")
    batches = _batches(vocab, corpus, ref, WINDOW)
    cases = phase_kernels_window(ref, batches)
    del ref
    torch.cuda.empty_cache()
    report_cases(cases)
    for path in (WIN_TPU, WIN_HYBRID):
        phase_window_parity(path, vocab, batches)
    counts = {path: phase_train_window(path, vocab, corpus, card)
              for path in (WIN_TPU, WIN_HYBRID, WIN_XLA, WIN_DENSE)}
    print(f"phase 10 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, counts


# -- phase 11: the wire stack ----------------------------------------------------

WIN_Q = f"window_q@{SHARDS}"
HYB_Q = f"hybrid_window_q@{SHARDS}"
WIN_SKETCH = f"window_sketch@{SHARDS}"
HYB_SAR = f"hybrid_sar@{SHARDS}"
PULL_XLA = "pull:xla"
CKPT_WIRE = f"checkpoint_wire@{SHARDS}"
#: the wire paths: a window path of phase 10 with ``[cluster]`` knobs
#: (PULL_XLA is the gather path, not a window one)
WIRE_PATHS = {
    WIN_Q: (WIN_TPU, {"wire_quant": "int8"}),
    HYB_Q: (WIN_HYBRID, {"wire_quant": "bf16"}),
    WIN_SKETCH: (WIN_TPU, {"wire_sketch": 1}),
    HYB_SAR: (WIN_HYBRID, {"collective": "sparse_allreduce"}),
    CKPT_WIRE: (WIN_TPU, {"wire_quant": "int8", "pull_cache": 4096}),
}
#: the pull path's knobs: the gather path's pulls int8 on the wire and
#: through a versioned cache of 4,096 lines
PULL_KNOBS = {"pull_quant": "int8", "pull_cache": 4096}
#: launches of one window on the wire paths: a quantized family's window
#: adds the drain's gather of its ``@ef`` rows and the bank's scatter-add
#: to the lossless window's launches (WINDOW_GROUP); the sketch and the
#: sparse hot reconcile change only what is booked
WIRE_GROUP = {
    WIN_Q: {**WINDOW_GROUP[WIN_TPU],
            "gather": WINDOW_GROUP[WIN_TPU]["gather"] + 2,
            "scatter": WINDOW_GROUP[WIN_TPU]["scatter"] + 2},
    HYB_Q: {**WINDOW_GROUP[WIN_HYBRID],
            "gather": WINDOW_GROUP[WIN_HYBRID]["gather"] + 2,
            "scatter": WINDOW_GROUP[WIN_HYBRID]["scatter"] + 2},
    WIN_SKETCH: WINDOW_GROUP[WIN_TPU],
    HYB_SAR: WINDOW_GROUP[WIN_HYBRID],
}
#: launches of one step of PULL_XLA: each pull gathers its rows and their
#: ``@rowver`` versions (the gather kernel's int32 form), the pushes as
#: the gather path's
PULL_STEP = {"gather": 4, "scatter": 1, "adagrad": 2}
#: the share of a lossy window's field elements allowed outside the
#: envelope: an element of a quantized sum the card adds in another order
#: than the CPU can round to the neighbouring int8 (or bfloat16) step
LOSSY_SHARE = 1e-3
#: the ledger keys the wire lines print
WIRE_KEYS = WINDOW_KEYS + ("window_fmt_q", "window_fmt_bitmap",
                           "window_fmt_sketch", "collective_sparse_ar",
                           "hot_psum_bytes_saved", "psum_bytes")
PULL_LEDGER = ("pull_bytes", "pull_rows", "pull_cache_hits",
               "pull_delta_rows", "pull_bytes_saved", "pull_fmt_full",
               "pull_fmt_q", "plan_compiles", "plan_cache_hits")


def _wire_traffic(tr: dict) -> dict:
    return {k: tr.get(k, 0) for k in WIRE_KEYS}


def _record_quanta(transfer) -> dict:
    """Wrap ``transfer``'s EF drain to sum, per slot, the int8 step of
    every row it ships (``max|row| / 127``, which bounds a bfloat16 step
    of the row too): ``{field: (capacity,) plane}``, filled as windows
    run."""
    quanta, drain = {}, transfer._prim_ef_drain

    def recording(state, ded_slots, ded_grads, capacity, quant):
        state, out = drain(state, ded_slots, ded_grads, capacity, quant)
        ok = ded_slots >= 0
        for f, g in out.items():
            plane = quanta.setdefault(f, torch.zeros(capacity))
            plane.index_add_(0, ded_slots[ok].long().cpu(),
                             (g.abs().amax(dim=1) / 127.0)[ok].cpu())
        return state, out
    transfer._prim_ef_drain = recording
    return quanta


def _lossy_gap(what: str, got: torch.Tensor, want: torch.Tensor,
               quanta=None) -> dict:
    """A lossy window's fields.  ``@ef`` planes (``quanta``: each row's
    summed int8 steps): every element within its row's steps of the CPU's.
    Other fields: within the envelope except at most LOSSY_SHARE of the
    elements (a quantized element one step apart moves its AdaGrad
    update)."""
    gap = (got.float() - want.float()).abs()
    if quanta is not None:
        bound = quanta.to(gap.device)[:, None] + 1e-6
        if bool((gap > bound).any()):
            raise AssertionError(f"{what}: {int((gap > bound).sum())} "
                                 f"elements more than one step apart")
        return {"max_abs_gap": gap.max().item(),
                "max_step": quanta.max().item()}
    bad = gap > 1e-5 + 1e-3 * want.float().abs()
    share = float(bad.float().mean())
    if share > LOSSY_SHARE:
        raise AssertionError(f"{what}: {share:.2e} of the elements outside "
                             f"the envelope (limit {LOSSY_SHARE})")
    return {"max_abs_gap": gap.max().item(), "outside_envelope": int(
        bad.sum()), "share": share}


def phase_kernels_wire(q_model: Word2Vec, sar_model: Word2Vec,
                       pull_model: Word2Vec, batches) -> list:
    """B2 and B3 at the shapes the wire paths give them: the ``@rowver``
    gather of a PULL_XLA h pull (B*(K+1) slots of the int32 ``(capacity,
    1)`` plane), the EF drain's gather of ``@ef`` rows at WIN_Q's
    deduplicated window h rows (valid: first occurrences) and its bank of
    the errors onto the ``(capacity, 100)`` plane with counts, and HYB_SAR's
    sparse hot reconcile (every rank's deduplicated hot h rows onto the
    ``(n_hot, 100)`` head with counts)."""
    rng = np.random.default_rng(41)
    dev, d = q_model.device, q_model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    h_slots = _step_inputs(pull_model, batches[0], rng)[0]
    cases = [_gather_case("@rowver versions, h pull",
                          pull_model.table.state["@rowver"], h_slots,
                          (h_slots >= 0).contiguous(), flush,
                          path=PULL_XLA)]
    capacity = q_model.table.capacity
    flat = torch.cat([_step_inputs(q_model, b, rng)[0] for b in batches])
    ded = q_model.transfer._prim_window_dedup(
        flat, {"h": torch.zeros((flat.shape[0], 1), device=dev)}, None,
        capacity)[0]
    first = (window_owners(ded[None], capacity)[0][0] == torch.arange(
        ded.shape[0], dtype=torch.int32, device=dev)) & (ded >= 0)
    ef = q_model.transfer._side_plane(q_model.table.state, "h@ef")
    ef.normal_(generator=_device_gen(dev, rng)).mul_(1e-3)
    cases.append(_gather_case("@ef rows at the window's h rows", ef, ded,
                              first.contiguous(), flush, path=WIN_Q))
    cases.append(_scatter_case("EF bank, h", WIN_Q, ded,
                               (ded >= 0).contiguous(), capacity, d, rng,
                               flush))
    ef.zero_()
    t = sar_model.transfer
    n_hot = sar_model.table.n_hot
    hflat = torch.cat([_step_inputs(sar_model, b, rng)[0] for b in batches])
    hflat = t._pad_batch(hflat)[0]
    tail_cap = sar_model.table.capacity - n_hot
    hded = t.tail._prim_window_dedup(
        hflat, {"h": torch.zeros((hflat.shape[0], 1), device=dev)}, None,
        n_hot + tail_cap)[0]
    is_hot = ((hded >= 0) & (hded < n_hot)).contiguous()
    cases.append(_scatter_case("sparse hot reconcile, h", HYB_SAR, hded,
                               is_hot, n_hot, d, rng, flush))
    return cases


def phase_wire_parity(path: str, vocab, batches) -> dict:
    """One window of a wire path at the reference shape on the card
    against the same window on the CPU from the same table and draws:
    err_cnt exact, err_sum within 1e-4, the lossless paths' fields within
    ``_field_gap``'s tolerance and the lossy ones' within
    ``_lossy_gap``'s, the same ledger, exactly ``WIRE_GROUP``'s
    launches."""
    model = _window_model(path, vocab, "cuda", inner=WINDOW)
    cpu_model = _window_model(path, vocab, "cpu", inner=WINDOW)
    cpu_model.table.state = _cpu_state(model.table.state, cpu_model)
    lossy = model.wire_quant != "off"
    tail = cpu_model.transfer.tail if cpu_model.transfer.name == "hybrid" \
        else cpu_model.transfer
    quanta = _record_quanta(tail) if lossy else {}
    rng = np.random.default_rng(13)
    draws = [_draws(model, BATCH, rng) for _ in batches]
    fields = [torch.as_tensor(np.stack([np.asarray(f) for f in fs]),
                              device=model.device)
              for fs in zip(*map(_batch_fields, batches))]
    for m in (model, cpu_model):
        m.transfer.count_traffic = True
    t0 = time.perf_counter()
    kernels.reset_launches()
    es_c, ec_c = model._window_group(tuple(fields), draws)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    card_s = time.perf_counter() - t0
    es_p, ec_p = cpu_model._window_group(
        tuple(f.cpu() for f in fields),
        [tuple(t.cpu() for t in d) for d in draws])
    es_c, ec_c, es_p, ec_p = (float(x) for x in (es_c, ec_c, es_p, ec_p))
    if ec_c != ec_p or not math.isclose(es_c, es_p, rel_tol=1e-4):
        raise AssertionError(f"{path} window: card ({es_c}, {ec_c}), cpu "
                             f"({es_p}, {ec_p})")
    gaps = {}
    for f, v in model.table.state.items():
        got, want = _global(v), _global(cpu_model.table.state[f])
        if not lossy:
            gaps[f] = _field_gap(f"{path}: field {f}", got, want)
        elif f.endswith("@ef"):
            gaps[f] = _lossy_gap(f"{path}: plane {f}", got, want,
                                 quanta[f[:-len("@ef")]])
        else:
            gaps[f] = _lossy_gap(f"{path}: field {f}", got, want)
    tc = _wire_traffic(model.transfer.traffic())
    tp = _wire_traffic(cpu_model.transfer.traffic())
    want = {**dict.fromkeys(counts, 0), **WIRE_GROUP[path]}
    plans = ("plan_compiles", "plan_cache_hits")
    decided = tc["window_sparse"] + tc["window_dense"]
    if counts != want or any(tc[k] != tp[k] for k in tc if k not in plans) \
            or decided != 2:
        raise AssertionError(f"{path} window launched {counts} (its path "
                             f"gives {want}); ledger card {tc}, cpu {tp}")
    if lossy and tc["window_fmt_q"] != 2 or path == HYB_SAR and \
            tc["collective_sparse_ar"] < 1:
        raise AssertionError(f"{path} window: decisions {tc}")
    if model.transfer.overflow_count() or ring.timeouts():
        raise AssertionError(f"{path} window: overflow or wait timeout")
    _json_line({"phase": "wire_parity", "rendering": path,
                "push_window": WINDOW, "steps": len(batches),
                "centers": BATCH, "err_sum": [es_c, es_p],
                "err_cnt": [ec_c, ec_p], "gap": gaps,
                "tolerance": ("lossy: @ef within the summed int8 steps of "
                              "its rows, fields within 1e-5 + 1e-3*|cpu| "
                              f"but at most {LOSSY_SHARE} of them" if lossy
                              else "1e-5 + 1e-3*|cpu|"),
                "traffic": tc, "push_paths": dict(model.transfer.push_paths),
                "card_seconds": card_s, "launches": counts})
    return counts


def _pull_model(vocab, device: str, inner: int = 4) -> Word2Vec:
    conf = ConfigParser().update(DEMO_CONF)
    conf.set("worker", "inner_steps", inner)
    for k, v in PULL_KNOBS.items():
        conf.set("cluster", k, v)
    model = Word2Vec(config=conf, device=device).build_from_vocab(vocab)
    if "@rowver" not in model.table.state or model.transfer.name != "xla":
        raise AssertionError(f"{PULL_XLA}: no @rowver plane armed")
    return model


def phase_train_wire(path: str, vocab, corpus: np.ndarray,
                     card: str) -> dict:
    """``Word2Vec.train`` of a wire path over phase 10's corpus prefix
    with ``count_traffic``: finite loss, exactly the path's kernels;
    WIN_Q's loss within JAX's trajectory envelope ``|a - b| <= 1e-5 +
    1e-3|b|`` of the lossless WIN_TPU run over the same batches, its
    windows ``sparse_q``; HYB_SAR's hot reconciles sparse; PULL_XLA's
    pulls int8 through the cache, every group step by step (a cached
    pull reads back to the host), exactly PULL_STEP's launches a step."""
    pull = path == PULL_XLA
    model = (_pull_model(vocab, "cuda") if pull
             else _window_model(path, vocab, "cuda"))
    model.transfer.count_traffic = True
    batcher = CBOWBatcher(corpus[:PATHS[f"gather@{SHARDS}"][2]], vocab,
                          model.window, model.sample, seed=2008)
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
    counts = kernels.launch_counts()
    m = model.train_metrics
    tr = m["transfer_traffic"]
    launched = {k for k, n in counts.items() if n}
    expect = {"gather", "scatter", "adagrad"} if pull \
        else WINDOW_KERNELS[WIRE_PATHS[path][0]]
    bad = (launched != expect or m["steps"] < MIN_TRAIN_STEPS
           or not all(math.isfinite(x) for x in losses) or ring.timeouts())
    if path == WIN_Q:
        base = TRAIN_LOSSES[WIN_TPU]
        bad |= tr["window_fmt_q"] == 0 or any(
            abs(a - b) > 1e-5 + 1e-3 * abs(b) for a, b in zip(losses, base))
    if path == HYB_SAR:
        bad |= tr["collective_sparse_ar"] == 0
    if pull:
        want = {k: v * m["steps"] for k, v in PULL_STEP.items()}
        bad |= ({k: counts[k] for k in want} != want or m["fused"]
                or tr["pull_fmt_q"] != 2 * m["steps"]
                or tr["pull_cache_hits"] == 0)
    if bad:
        raise AssertionError(f"{path} train: launches {counts}, "
                             f"{m['steps']} steps, loss {losses} (lossless "
                             f"{TRAIN_LOSSES.get(WIN_TPU)}), fused "
                             f"{m['fused']}, ledger {tr}")
    line = {"phase": "train", "rendering": path, "card": card,
            "inner_steps": m["inner_steps"], "fused": m["fused"],
            "loss": losses, "steps": m["steps"], "words": m["words"],
            "seconds": m["seconds"], "words_per_sec": m["words_per_sec"],
            "push_paths": m["push_paths"], "launches": counts}
    if pull:
        line.update(pull={k: tr[k] for k in PULL_LEDGER},
                    pull_bytes_a_step=tr["pull_bytes"] / m["steps"],
                    hit_share=tr["pull_cache_hits"] / max(tr["pull_rows"],
                                                          1))
    else:
        line.update(push_window=m["push_window"], traffic=_wire_traffic(tr),
                    wire_bytes_a_step=tr["wire_bytes"] / m["steps"],
                    lossless_loss=TRAIN_LOSSES.get(WIN_TPU))
    _json_line(line)
    return counts


def phase_checkpoint_wire(vocab, corpus: np.ndarray) -> None:
    """CKPT_WIRE (``tpu@8`` windows, int8 with ``@ef`` planes, the pull
    cache's ``@rowver`` plane through the routed int32 pull): train over a
    short prefix, save the npz, reload it into a fresh model on the card:
    every field and plane bit for bit, the npz's planes at their dtypes."""
    model = _window_model(CKPT_WIRE, vocab, "cuda")
    model.transfer.count_traffic = True
    batcher = CBOWBatcher(corpus[:300], vocab, model.window, model.sample,
                          seed=2008)
    model.train(batcher=batcher, niters=1, batch_size=BATCH)
    path = str(WORK / "ckpt_wire")
    torch.cuda.synchronize()
    save_checkpoint(model.table, path)
    with np.load(npz_path(path)) as z:
        dtypes = {f: str(z["field__" + f].dtype) for f in
                  ("h@ef", "v@ef", "@rowver")}
        stamped = int(z["field__@rowver"].max())
    if dtypes != {"h@ef": "float32", "v@ef": "float32",
                  "@rowver": "int32"} or not stamped:
        raise AssertionError(f"{CKPT_WIRE} npz planes {dtypes}, max "
                             f"version {stamped}")
    back = _window_model(CKPT_WIRE, vocab, "cuda")
    load_checkpoint(back.table, path)
    _hold_equal(f"{CKPT_WIRE} reload", back.table.state, model.table.state)
    tr = model.transfer.traffic()
    _json_line({"phase": "checkpoint", "rendering": CKPT_WIRE,
                "planes": dtypes, "max_version": stamped,
                "pull_cache_hits": tr["pull_cache_hits"],
                "window_fmt_q": tr["window_fmt_q"], "bit_equal": True})


def phase_wire(vocab, corpus: np.ndarray, card: str) -> tuple:
    """Phase 11: the kernel cases at the wire paths' shapes, one window of
    each window wire path against the CPU, the train runs and the
    checkpoint; returns the cases and the train runs' launches."""
    t0 = time.perf_counter()
    q_model = _window_model(WIN_Q, vocab, "cuda")
    sar_model = _window_model(HYB_SAR, vocab, "cuda")
    pull_model = _pull_model(vocab, "cuda")
    batches = _batches(vocab, corpus, q_model, WINDOW)
    cases = phase_kernels_wire(q_model, sar_model, pull_model, batches)
    del q_model, sar_model, pull_model
    torch.cuda.empty_cache()
    report_cases(cases)
    for path in (WIN_Q, HYB_Q, WIN_SKETCH, HYB_SAR):
        phase_wire_parity(path, vocab, batches)
    counts = {path: phase_train_wire(path, vocab, corpus, card)
              for path in (WIN_Q, HYB_SAR, PULL_XLA)}
    phase_checkpoint_wire(vocab, corpus)
    print(f"phase 11 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, counts


# -- phase 12: the telemetry plane ------------------------------------------

#: the telemetry phase's corpus prefix (the gather path's: >= 20 steps)
TEL_SENTS = 800
#: B1-B3's kernels, by a substring of their names in a chrome trace
TEL_KERNELS = {"adagrad": "adagrad_update", "gather": "masked_gather",
               "scatter": "scatter_"}
#: the cost runs: (name, [obs]/[worker] keys); each at telemetry_every 1
#: and 64 but the first
TEL_VARIANTS = (
    ("off", {}),
    ("telemetry", {"worker": {"telemetry": 1}}),
    ("numerics", {"worker": {"telemetry": 1}, "obs": {"numerics": 1}}),
    ("trace", {"worker": {"telemetry": 1},
               "obs": {"numerics": 1, "trace": 1}}))
#: groups of 8 steps a cost run times (after two warm-up groups)
TEL_GROUPS = 6


def _obs_conf(model: Word2Vec, keys: dict) -> None:
    for sec, kv in keys.items():
        for k, v in kv.items():
            model.config.set(sec, k, v)
    model.numerics_on = bool(keys.get("obs", {}).get("numerics"))


def _registry_traffic(reg) -> dict:
    """The registry's ``transfer/*`` series summed over backend labels,
    as ``traffic()`` keys."""
    from swiftmpi_tpu_torch.obs.registry import parse_series_key
    out = {}
    for skey, v in reg.snapshot()["counters"].items():
        name, labels = parse_series_key(skey)
        if not name.startswith("transfer/"):
            continue
        key = name[len("transfer/"):]
        for lab in ("fmt", "kind"):
            if lab in labels:
                key = f"{key}_{labels[lab]}"
        out[key] = out.get(key, 0) + v
    return out


def _trace_kernel_events(run_dir: str) -> dict:
    """Kernel events by B1-B3 in a profiler window's chrome trace."""
    import glob
    import gzip
    found = dict.fromkeys(TEL_KERNELS, 0)
    for path in glob.glob(os.path.join(run_dir, "*.trace.json.gz")):
        with gzip.open(path, "rt") as f:
            events = json.load(f).get("traceEvents") or []
        for ev in events:
            if ev.get("cat") != "kernel":
                continue
            for k, sub in TEL_KERNELS.items():
                if sub in str(ev.get("name", "")):
                    found[k] += 1
    return found


def phase_telemetry_train(vocab, corpus: np.ndarray, card: str) -> dict:
    """(a): see the module docstring."""
    from swiftmpi_tpu_torch import obs
    from swiftmpi_tpu_torch.utils.pipeline import LossAccum
    work = WORK / "telemetry"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tel = str(work / "telemetry.jsonl")
    model = _model("gather", vocab, "cuda", {"inner_steps": 8})
    _obs_conf(model, {
        "worker": {"telemetry": 1, "telemetry_path": tel},
        "obs": {"numerics": 1, "costs": 1,
                "costs_path": str(work / "compile_catalog.json"),
                "profile_at": 4, "profile_steps": 2,
                "profile_dir": str(work / "profiles")}})
    model.transfer.count_traffic = True
    batcher = CBOWBatcher(corpus[:TEL_SENTS], vocab, model.window,
                          model.sample, seed=2008)
    obs.reset_for_tests()
    kernels.reset_launches()
    losses = model.train(batcher=batcher, niters=1, batch_size=BATCH)
    counts = kernels.launch_counts()
    m = model.train_metrics
    steps = m["steps"]
    want = {k: v * steps for k, v in STEP_LAUNCHES["gather"].items()}
    reg = obs.get_registry()
    tr = m["transfer_traffic"]
    mirrored = _registry_traffic(reg)
    dispatches = reg.snapshot()["hists"]["phase_ms{phase=dispatch}"]["count"]
    bundles = m["numerics"]["bundles"]
    cat_path = work / "compile_catalog.json"
    entry = (json.load(open(cat_path))["fns"].get("w2v_multi", {})
             if cat_path.exists() else {})
    sess = obs.get_profiler()
    captures = sess.captures if sess is not None else []
    in_trace = (_trace_kernel_events(captures[0]["run_dir"])
                if captures else {})
    rep = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "telemetry_report.py"), tel],
        capture_output=True, text=True, timeout=120)
    bad = (counts != want or not m["fused"] or m["graph_replays"] < 1
           or not all(math.isfinite(x) for x in losses)
           or {k: v for k, v in tr.items() if v} != mirrored
           or bundles != dispatches or bundles < 2
           or entry.get("compiles", 0) < 1 or entry.get("retraces") != 0
           or len(captures) != 1 or not all(in_trace.values())
           or rep.returncode != 0 or "dispatch" not in rep.stdout)
    if bad:
        raise AssertionError(
            f"telemetry train: launches {counts} (want {want}), fused "
            f"{m['fused']} {m['graph_replays']} replays, loss {losses}, "
            f"ledger {tr} vs registry {mirrored}, {bundles} bundles in "
            f"{dispatches} dispatches, catalog {entry}, {len(captures)} "
            f"capture(s) with kernel events {in_trace}, report rc "
            f"{rep.returncode} {rep.stderr[-400:]}")
    # one more group, replayed, against a plain recomputation from its
    # entry and exit tables
    groups = _tel_groups(model, vocab, corpus, 1)
    before = {f: model.table.state[f].float().clone() for f in ("h", "v")}
    es_q, ec_q = LossAccum(None, model.device), LossAccum(None, model.device)
    with obs.span("dispatch"):
        replayed = model._run_group(groups[0][0], True, None, es_q, ec_q)
    torch.cuda.synchronize()
    after = {f: model.table.state[f].float() for f in ("h", "v")}
    got = model._numerics.read()["latest"]
    plain = {
        "upd_sq": sum(float((after[f].double() - before[f].double())
                            .square().sum()) for f in after),
        "par_sq": sum(float(before[f].double().square().sum())
                      for f in before),
        "loss_sum": es_q.total(), "loss_n": ec_q.total()}
    gaps = {k: abs(got[k] - v) for k, v in plain.items()}
    if not replayed or any(gaps[k] > 1e-5 + 1e-3 * abs(plain[k])
                           for k in plain) or not got["gsq"] > 0:
        raise AssertionError(f"numerics bundle {got} against the plain "
                             f"recomputation {plain} (replayed {replayed})")
    obs.reset_for_tests()
    _json_line({"phase": "telemetry", "part": "train", "card": card,
                "rendering": "gather", "inner_steps": 8, "steps": steps,
                "graph_replays": m["graph_replays"], "loss": losses,
                "words_per_sec": m["words_per_sec"], "launches": counts,
                "registry_equals_traffic": True,
                "traffic": {k: v for k, v in tr.items() if v},
                "bundles": bundles, "dispatches": dispatches,
                "bundle_vs_plain": {k: [got[k], plain[k]] for k in plain},
                "catalog": entry, "profile": {
                    k: captures[0][k] for k in
                    ("reason", "start_step", "steps", "events",
                     "device_ms", "host_ms")},
                "profile_kernel_events": in_trace})
    return counts


def _tel_groups(model: Word2Vec, vocab, corpus: np.ndarray, n: int,
                group: int = 8, B: Optional[int] = None) -> list:
    """``n`` groups of ``group`` full batches of ``B`` (default BATCH)
    centers on the model's device, with their words: ``[(fields,
    words)]``."""
    from swiftmpi_tpu_torch.models.word2vec import _stack_group_host
    B = B or BATCH
    out, buf = [], []
    for b in CBOWBatcher(corpus[:6 * TEL_SENTS], vocab, model.window,
                         model.sample, seed=7).epoch(B):
        if b.n_words and len(b.centers) == B:
            buf.append(b)
        if len(buf) == group:
            out.append((tuple(torch.from_numpy(f).to(model.device)
                              for f in _stack_group_host(buf)),
                        sum(x.n_words for x in buf)))
            buf = []
            if len(out) == n:
                return out
    raise AssertionError(f"the corpus gave {len(out)} groups of {group}")


def phase_telemetry_window(vocab, corpus: np.ndarray, card: str) -> dict:
    """(b): WIN_Q with the tracer and numerics armed, full groups of 8
    steps (two windows a family each, run eagerly as a tracer needs)."""
    from swiftmpi_tpu_torch import obs
    from swiftmpi_tpu_torch.utils.pipeline import LossAccum
    from swiftmpi_tpu_torch.utils.timers import Throughput
    obs.reset_for_tests()
    model = _window_model(WIN_Q, vocab, "cuda")
    _obs_conf(model, {"worker": {"telemetry": 1, "telemetry_path": ""},
                      "obs": {"numerics": 1, "trace": 1,
                              "trace_dir": str(WORK / "traces")}})
    rec, owns = model._arm_telemetry(Throughput(), True)
    tracer = obs.get_tracer()
    groups = _tel_groups(model, vocab, corpus, 3)
    es_q, ec_q = LossAccum(None, model.device), LossAccum(None, model.device)
    kernels.reset_launches()
    before = model.transfer.traffic()
    try:
        for fields, _ in groups:
            model._run_group(fields, False, None, es_q, ec_q)
            obs.record_step(8)
        torch.cuda.synchronize()
        tr = model.transfer.traffic_delta(before)
        counts = kernels.launch_counts()
        model._close_telemetry(rec, owns)
        recs = tracer.records()
        q = model._numerics.read()
    finally:
        obs.reset_for_tests()
    enc = sum(r["enc_bytes"] for r in recs)
    want = {k: v * len(groups) * 2 for k, v in WIRE_GROUP[WIN_Q].items()}
    if (enc != tr["wire_bytes"] or len(recs) != 4 * len(groups)
            or tr["window_fmt_q"] == 0 or not math.isfinite(q["quant_err"])
            or not q["quant_err"] > 0 or q["nonfinite"]
            or {k: counts[k] for k in want} != want):
        raise AssertionError(
            f"{WIN_Q} traced: records' bytes {enc} vs wire_bytes "
            f"{tr['wire_bytes']}, {len(recs)} records, window_fmt_q "
            f"{tr['window_fmt_q']}, quant_err {q['quant_err']}, nonfinite "
            f"{q['nonfinite']}, launches {counts} (want {want})")
    _json_line({"phase": "telemetry", "part": "window_q", "card": card,
                "rendering": WIN_Q, "groups": len(groups),
                "records": len(recs), "records_enc_bytes": enc,
                "wire_bytes": tr["wire_bytes"],
                "decisions": sorted({r["decision"] for r in recs}),
                "quant_err": q["quant_err"], "bundles": q["bundles"],
                "launches": counts})
    return counts


def phase_telemetry_cost(vocab, corpus: np.ndarray, card: str) -> list:
    """(c): each TEL_VARIANTS run on the same groups from a fresh model:
    two warm-up groups (the capture), then TEL_GROUPS groups timed by the
    host clock to a synchronize (host ms a step, words/s) and, after
    them, two groups in a ``torch.profiler`` window (device ms a step:
    the kernels' and copies' summed time)."""
    from swiftmpi_tpu_torch import obs
    from swiftmpi_tpu_torch.apps.w2v_profile import _device_busy
    from swiftmpi_tpu_torch.utils.pipeline import LossAccum
    from swiftmpi_tpu_torch.utils.timers import Throughput
    probe = _model("gather", vocab, "cuda", {"inner_steps": 8})
    groups = _tel_groups(probe, vocab, corpus, TEL_GROUPS + 4)
    del probe
    lines = []
    for name, keys in TEL_VARIANTS:
        for every in ((1,) if name == "off" else (1, 64)):
            obs.reset_for_tests()
            model = _model("gather", vocab, "cuda", {"inner_steps": 8})
            conf = {s: dict(kv) for s, kv in keys.items()}
            if keys:
                conf["worker"].update(telemetry_every=every,
                                      telemetry_path="")
                conf.setdefault("obs", {})["trace_dir"] = str(
                    WORK / "traces")
            _obs_conf(model, conf)
            rec, owns = model._arm_telemetry(Throughput(), True)
            graphs = obs.get_tracer() is None
            es_q, ec_q = (LossAccum(None, model.device),
                          LossAccum(None, model.device))

            def run(gs):
                for fields, _ in gs:
                    with obs.span("dispatch"):
                        model._run_group(fields, graphs, None, es_q, ec_q)
                    obs.record_step(8)
            run(groups[:2])
            torch.cuda.synchronize()
            kernels.reset_launches()
            timed = groups[2:2 + TEL_GROUPS]
            t0 = time.perf_counter()
            run(timed)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                run(groups[2 + TEL_GROUPS:])
                torch.cuda.synchronize()
            busy, _ = _device_busy(prof)
            model._close_telemetry(rec, owns)
            obs.reset_for_tests()
            n_steps = 8 * len(timed)
            words = sum(w for _, w in timed)
            want = {k: v * n_steps for k, v in STEP_LAUNCHES["gather"].items()}
            if counts != want or not all(
                    math.isfinite(x) for x in (es_q.total(), ec_q.total())):
                raise AssertionError(f"telemetry cost {name}@{every}: "
                                     f"launches {counts}, want {want}")
            line = {"phase": "telemetry_cost", "card": card,
                    "variant": name, "telemetry_every": every,
                    "graphs": graphs, "steps": n_steps,
                    "host_ms_per_step": host_s / n_steps * 1e3,
                    "device_ms_per_step": busy / (8 * 2) if busy
                    else "not measured",
                    "words_per_sec": words / host_s, "launches": counts}
            _json_line(line)
            lines.append(line)
            del model
            torch.cuda.empty_cache()
    return lines


def phase_telemetry(vocab, corpus: np.ndarray, card: str) -> dict:
    """Phase 12: (a), (b), (c); returns the runs' launches by path."""
    t0 = time.perf_counter()
    counts = {"telemetry:gather": phase_telemetry_train(vocab, corpus, card),
              f"telemetry:{WIN_Q}": phase_telemetry_window(vocab, corpus,
                                                            card)}
    phase_telemetry_cost(vocab, corpus, card)
    print(f"phase 12 {time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# -- phase 13: serving and control ------------------------------------------

SERVE_HYB = f"serve:{HYBRID}"
SERVE_XLA = "serve:window_q:xla"
SERVE_S2V = "serve:sent2vec"
#: (a)'s corpus prefixes: phase A as it is, then phase B with half of the
#: hot head's keys swapped for tail keys (about 26 + 35 steps)
SERVE_SENTS = (800, 400)
#: (a)'s [control] and [serve] sections
SERVE_CONTROL = {"control": "on", "every": 8, "margin": 0.02,
                 "consecutive": 2, "decay": 0.3}
SERVE_READERS = 2
#: (b)'s path: xla, groups of 8 as graphs, windows of 4, int8 wire
XLA_Q = {"worker": {"inner_steps": 8},
         "cluster": {"push_window": 4, "wire_quant": "int8"}}
#: (b)'s training: a margin the push_window knob clears at once
XLA_Q_CONTROL = {"control": "on", "every": 8, "margin": 0.01,
                 "consecutive": 1, "decay": 0.3}
#: (b)'s bit-for-bit groups: centers a batch, at which every push of a
#: lossless window is sparse (deterministic sums)
TWIN_BATCH = 64
#: (d): queries of the top-k
TOPK_Q, TOPK_K = 256, 10
#: (e): [serve] every against off, over groups of 8 replayed graphs
SERVE_EVERY = (0, 8, 64)
SERVE_COST_GROUPS = 8


def _conf(base: dict, sections: dict) -> ConfigParser:
    conf = ConfigParser().update(base)
    for sec, kv in sections.items():
        for k, v in kv.items():
            conf.set(sec, k, v)
    return conf


def _checksum(planes) -> dict:
    """Per plane, the int64 sum of its elements' bits (an order-free sum,
    so a device tensor, a sharded field's shards and a host copy in
    global row order all give the same number)."""
    out = {}
    for f, v in sorted(planes.items()):
        parts = v if isinstance(v, (list, tuple)) else [v]
        total = 0
        for t in parts:
            if isinstance(t, np.ndarray):
                bits = t.view(np.int16 if t.itemsize == 2 else np.int32)
                total += int(bits.astype(np.int64).sum())
            else:
                bits = t.contiguous().view(
                    torch.int16 if t.element_size() == 2 else torch.int32)
                total += int(bits.long().sum())
        out[f] = total
    return out


def _timed_publishes(pub, table=None) -> list:
    """Time every publish of ``pub`` (from a synchronize, so the copy
    alone is timed): ``[(snapshot, ms, checksum)]``, with ``table`` the
    trainer's table's device checksum right after the publish."""
    out, publish = [], pub.publish

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = publish(*a, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        out.append((snap, ms, None if table is None
                    else _checksum(table.state)))
        return snap

    pub.publish = timed
    return out


def _quantiles(ms: list) -> dict:
    a = np.sort(np.asarray(ms, np.float64))
    if not a.size:
        return {"p50_ms": "not measured", "p99_ms": "not measured"}
    return {f"p{q}_ms": float(a[min(int(q / 100 * a.size), a.size - 1)])
            for q in (50, 99)}


class _Readers:
    """SERVE_READERS query threads over a publisher: each alternates a
    ``read`` of 16 keys and a ``topk`` of 4, and checks that every
    snapshot it sees holds numpy planes only."""

    def __init__(self, pub, keys):
        import threading
        self.pub, self.keys = pub, keys
        self.stop = threading.Event()
        self.failures, self.readers = [], []
        self.threads = [threading.Thread(target=self._run, args=(i,),
                                         daemon=True)
                        for i in range(SERVE_READERS)]

    def _run(self, seed: int) -> None:
        from swiftmpi_tpu_torch.serve import EmbeddingReader
        rng = np.random.default_rng(seed)
        reader = EmbeddingReader(self.pub, field="v", cache_rows=4096)
        self.readers.append(reader)
        if self.pub.wait_for_version(1, timeout=300) is None:
            self.failures.append("no snapshot within 300 s")
            return
        try:
            while not self.stop.is_set():
                snap = self.pub.require()
                if not all(isinstance(v, np.ndarray)
                           for v in snap.state.values()):
                    self.failures.append(f"v{snap.version}: a plane that "
                                         "is not a numpy array")
                rows = reader.read(rng.choice(self.keys, 16))
                reader.topk(rng.choice(self.keys, 4), k=10)
                if not np.isfinite(rows).all():
                    self.failures.append(f"v{snap.version}: non-finite")
        except Exception as e:               # noqa: BLE001 (reported)
            self.failures.append(repr(e))

    def __enter__(self):
        self.t0 = time.perf_counter()
        for t in self.threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=60)
        self.seconds = time.perf_counter() - self.t0
        if any(t.is_alive() for t in self.threads):
            self.failures.append("a reader thread did not stop")

    def summary(self) -> dict:
        lat = [x for r in self.readers for x in r._lat_ms]
        queries = sum(r.stats["queries"] for r in self.readers)
        return {"threads": SERVE_READERS, "queries": queries,
                "topk_queries": sum(r.stats["topk_queries"]
                                    for r in self.readers),
                "queries_per_sec": queries / self.seconds,
                "hit_ratio": [r.hit_ratio() for r in self.readers],
                **_quantiles(lat)}


def _drifted(model: Word2Vec, vocab, corpus: np.ndarray) -> tuple:
    """(a)'s phase A and phase B: B's sentences with every other key of
    the hot head swapped for a tail key (ranks n_hot + 2,000 on), as
    JAX's ``_drift_setup`` rotates half of the head."""
    sa, sb = SERVE_SENTS
    hot = model.table.key_index.partition.hot_keys.astype(np.int64)
    order = np.argsort(-vocab.counts, kind="stable")
    head = hot[::2]
    n = model.table.n_hot + 2000
    tail = vocab.keys[order[n:n + head.size]].astype(np.int64)
    perm = np.arange(int(corpus.max()) + 1)
    perm[head], perm[tail] = tail, head
    return corpus[:sa], perm[corpus[sa:sa + sb]].astype(corpus.dtype)


def phase_serve_hybrid(vocab, corpus: np.ndarray, card: str) -> tuple:
    """(a): ``hybrid@8`` with the controller and the publisher on, two
    reader threads: see the module docstring.  Returns the model, its
    launches, and its last snapshot."""
    model = _hybrid_model("gather", vocab, DEVICE, _conf(DEMO_CONF, {
        "control": SERVE_CONTROL, "serve": {"every": 8}}))
    fields = sorted(model.access.fields)
    pub = model.serving_publisher()
    table = model.table
    published, reps = _timed_publishes(pub, table), []
    repartition = table.repartition

    def held_repartition(part):
        keys = model.vocab.keys
        before = {f: table.unified_rows_host(f)[
            table.key_index.lookup(keys, create=False)] for f in fields}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = repartition(part)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        slots = table.key_index.lookup(keys, create=False)
        same = all(np.array_equal(
            before[f].view(np.int32),
            table.unified_rows_host(f)[slots].view(np.int32))
            for f in fields)
        reps.append({"ms": ms, "moved_rows": plan.moved_rows,
                     "n_hot": [plan.old_n_hot, plan.new_n_hot],
                     "rows_kept_bit_for_bit": same})
        return plan

    table.repartition = held_repartition
    phase_a, phase_b = _drifted(model, vocab, corpus)
    losses, steps, words, seconds = [], 0, 0, 0.0
    kernels.reset_launches()
    with _Readers(pub, vocab.keys) as readers:
        for sents in (phase_a, phase_b):
            losses += model.train(batcher=CBOWBatcher(
                sents, vocab, model.window, model.sample, seed=2008),
                niters=1, batch_size=BATCH)
            m = model.train_metrics
            steps, words = steps + m["steps"], words + m["words"]
            seconds += m["seconds"]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {**dict.fromkeys(counts, 0),
            **{k: v * steps for k, v in HYBRID_STEP.items()}}
    applies = [d for d in model.controller.decisions
               if d.knob == "hot_k" and d.action == "apply"]
    sums_ok = [_checksum(snap.state) == dev for snap, _, dev in published]
    if (counts != want or not all(math.isfinite(x) for x in losses)
            or not applies or len(reps) != len(applies)
            or not all(r["rows_kept_bit_for_bit"] for r in reps)
            or not all(d.evidence["moved_rows"] > 0 for d in applies)
            or not all(sums_ok) or len(published) < 3
            or readers.failures or not readers.summary()["queries"]):
        raise AssertionError(
            f"{SERVE_HYB}: launches {counts} (want {want}), loss {losses}, "
            f"decisions {model.controller.decisions}, repartitions {reps}, "
            f"snapshot checksums {sums_ok}, readers {readers.failures} "
            f"{readers.summary()}")
    pub_ms = [ms for _, ms, _ in published]
    _json_line({"phase": "serve_control", "part": "hybrid", "card": card,
                "rendering": SERVE_HYB, "steps": steps, "loss": losses,
                "words_per_sec_with_readers": words / seconds,
                "decisions": [
                    {"knob": d.knob, "action": d.action,
                     "evaluation": d.evaluation, "win": d.win,
                     "n_hot": [d.evidence.get("old_n_hot"),
                               d.evidence.get("new_n_hot")],
                     "moved_rows": d.evidence.get("moved_rows")}
                    for d in model.controller.decisions],
                "repartitions": reps,
                "publishes": len(published),
                "snapshot_bytes": sum(v.nbytes for v in
                                      published[-1][0].state.values()),
                "publish_ms": {"min": min(pub_ms), "median": float(
                    np.median(pub_ms)), "max": max(pub_ms)},
                "snapshots_equal_trainer_checksums": len(sums_ok),
                "readers": readers.summary(), "launches": counts})
    return model, counts, published[-1][0]


def _serve_kernel_cases(model: Word2Vec, batch) -> list:
    """B1-B3 and B5 at the shapes a step of (a)'s model gives them after
    its repartitions (the head grown to the controller's ``n_hot``)."""
    rng = np.random.default_rng(41)
    dev, d = model.device, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    n_hot, state = model.table.n_hot, model.table.state
    h_slots, _ = _step_inputs(model, batch, rng)
    hot = ((h_slots >= 0) & (h_slots < n_hot)).contiguous()
    param = state["h@hot"].clone()
    accum = state["h2sum@hot"].clone()
    grad = torch.as_tensor(rng.normal(size=(n_hot, d)).astype(np.float32)
                           * 1e-2, device=dev)
    inv = 1.0 / torch.as_tensor(rng.integers(1, 400, n_hot)
                                .astype(np.float32), device=dev)
    return [
        _gather_case("serve hybrid h hot pull", state["h@hot"], h_slots,
                     hot, flush, SERVE_HYB),
        _scatter_case("serve hybrid h hot push", SERVE_HYB, h_slots, hot,
                      n_hot, d, rng, flush),
        _adagrad_case("serve hybrid hot plane, * 1/counts", SERVE_HYB,
                      param, accum, grad, model.access.learning_rate, flush,
                      mul=inv),
        _ring_case("serve hybrid tail h rows", (h_slots.shape[0] // SHARDS,
                                                d), torch.float32, rng,
                   flush, dev, path=SERVE_HYB)]


def phase_serve_topk(snap, card: str) -> None:
    """(d): ``snapshot_topk`` on the card against the host path over
    (a)'s last snapshot (hot head and tail): scores within 1e-5, the same
    neighbours wherever the gap to the next score exceeds 1e-5."""
    from swiftmpi_tpu_torch.serve.query import snapshot_topk
    rng = np.random.default_rng(5)
    keys = snap.keys[rng.choice(snap.keys.size, TOPK_Q, replace=False)]
    slots = snap.lookup(keys)
    qv = np.concatenate([snap.hot_host("v"), snap.tail_array("v")]
                        )[slots].astype(np.float32)
    runs = {}
    for name, dev in (("host", False), ("device", DEVICE)):
        snapshot_topk(snap, qv[:4], k=TOPK_K, device=dev)    # warm up
        t0 = time.perf_counter()
        # one neighbour more than is held: the gap after the k-th
        runs[name] = snapshot_topk(snap, qv, k=TOPK_K + 1,
                                   exclude_slots=slots, device=dev)
        runs[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    (_, hs, hsc), (_, ds, dsc) = runs["host"], runs["device"]
    gap = float(np.abs(dsc - hsc)[:, :TOPK_K].max())
    mismatched = 0
    for qi in range(TOPK_Q):
        for n in range(1, TOPK_K + 1):
            if hsc[qi, n - 1] - hsc[qi, n] > 1e-5 and \
                    set(hs[qi, :n]) != set(ds[qi, :n]):
                mismatched += 1
    if gap > 1e-5 or mismatched:
        raise AssertionError(f"device top-k: score gap {gap}, "
                             f"{mismatched} neighbour sets differ")
    _json_line({"phase": "serve_control", "part": "topk", "card": card,
                "queries": TOPK_Q, "k": TOPK_K, "rows": int(
                    snap.total_capacity), "max_score_gap": gap,
                "host_ms": runs["host_ms"], "device_ms": runs["device_ms"],
                "tolerance": "scores 1e-5; neighbour sets where the gap "
                "exceeds 1e-5"})


def _xla_q_model(vocab, sections=None, seed: int = 0) -> Word2Vec:
    conf = _conf(DEMO_CONF, XLA_Q)
    for sec, kv in (sections or {}).items():
        for k, v in kv.items():
            conf.set(sec, k, v)
    return Word2Vec(config=conf, device=DEVICE, seed=seed).build_from_vocab(
        vocab)


class _Captures:
    """Records every graph capture of ``word2vec._FusedSteps`` (its group
    length, the model's window width, its ms) and every applied knob
    change and group between them."""

    def __init__(self, model: Word2Vec):
        import swiftmpi_tpu_torch.models.word2vec as w2v
        self.w2v, self.log = w2v, []
        self.orig = w2v._FusedSteps
        log = self.log

        class Timed(self.orig):
            def __init__(inner, m, fields):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                super().__init__(m, fields)
                torch.cuda.synchronize()
                log.append(("capture", fields[0].shape[0],
                            m.push_window_size,
                            (time.perf_counter() - t0) * 1e3))

        w2v._FusedSteps = Timed
        rebuild, run_group = model._rebuild_step, model._run_group

        def logged_rebuild():
            rebuild()
            log.append(("apply", model.push_window_size))

        def logged_group(fields, *a, **kw):
            log.append(("group", fields[0].shape[0]))
            return run_group(fields, *a, **kw)

        model._rebuild_step, model._run_group = logged_rebuild, logged_group

    def close(self) -> None:
        self.w2v._FusedSteps = self.orig

    def segments_ok(self) -> bool:
        """Between two applies (and before the first), one capture for
        each group length run there, none for the others."""
        seg, ok = [], True
        for ev in self.log + [("apply", None)]:
            if ev[0] != "apply":
                seg.append(ev)
                continue
            run = {e[1] for e in seg if e[0] == "group"}
            caps = [e[1] for e in seg if e[0] == "capture"]
            ok &= sorted(caps) == sorted(run)
            seg = []
        return ok


def phase_serve_xla(vocab, corpus: np.ndarray, card: str) -> tuple:
    """(b): see the module docstring.  Returns the trained model and its
    launches."""
    from swiftmpi_tpu_torch import obs
    from swiftmpi_tpu_torch.utils.pipeline import LossAccum
    # (b1) the controller widens the window during training: each apply
    # drops the graphs, the next group of each length recaptures
    model = _xla_q_model(vocab, {"control": XLA_Q_CONTROL})
    caps = _Captures(model)
    kernels.reset_launches()
    try:
        losses = model.train(batcher=CBOWBatcher(
            corpus[:TEL_SENTS], vocab, model.window, model.sample,
            seed=2008), niters=1, batch_size=BATCH)
    finally:
        caps.close()
    counts = kernels.launch_counts()
    m = model.train_metrics
    applied = [d for d in model.controller.decisions if d.action == "apply"]
    recaptures = [e[3] for i, e in enumerate(caps.log) if e[0] == "capture"
                  and any(x[0] == "apply" for x in caps.log[:i])]
    if (not any(d.knob == "push_window" for d in applied)
            or not caps.segments_ok() or not recaptures or not m["fused"]
            or not all(math.isfinite(x) for x in losses)
            or not all(counts[k] for k in ("gather", "scatter", "adagrad"))):
        raise AssertionError(f"{SERVE_XLA} train: decisions "
                             f"{model.controller.decisions}, log {caps.log}, "
                             f"fused {m['fused']} {m['graph_replays']}, "
                             f"loss {losses}, launches {counts}")
    _json_line({"phase": "serve_control", "part": "xla_window_q",
                "card": card, "rendering": SERVE_XLA, "steps": m["steps"],
                "loss": losses, "graph_replays": m["graph_replays"],
                "decisions": [{"knob": d.knob, "action": d.action,
                               "evaluation": d.evaluation, "win": d.win,
                               "new": d.new} for d in applied],
                "push_window": model.push_window_size,
                "captures": [e[1:] for e in caps.log if e[0] == "capture"],
                "recapture_ms": recaptures,
                "words_per_sec": m["words_per_sec"], "launches": counts})
    # (b2) twins from one seed: one replays graphs, one runs eagerly; a
    # window-width apply between them; bit for bit with deterministic
    # sums: lossless windows of sparse pushes (an int8 window folds its
    # duplicate rows with B3's float atomics, in no fixed order)
    twin_conf = {"control": {"control": "on", "every": 10 ** 6},
                 "worker": {"minibatch": TWIN_BATCH},
                 "cluster": {"wire_quant": "off"}}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graph_m = _xla_q_model(vocab, twin_conf, seed=5)
        eager_m = _xla_q_model(vocab, twin_conf, seed=5)
        groups = _tel_groups(graph_m, vocab, corpus, 4, B=TWIN_BATCH)
        caps = _Captures(graph_m)
        outs = {}
        try:
            for x, graphs in ((graph_m, True), (eager_m, False)):
                es_q = LossAccum(None, x.device)
                ec_q = LossAccum(None, x.device)
                replays = []
                for i, (fields, _) in enumerate(groups):
                    if i == 2:
                        knob = next(k for k in x.controller.knobs
                                    if k.name == "push_window")
                        knob.apply(8, {})
                    replays.append(x._run_group(fields, graphs, None,
                                                es_q, ec_q))
                torch.cuda.synchronize()
                outs[graphs] = (es_q.total(), ec_q.total(), replays)
        finally:
            caps.close()
    finally:
        torch.use_deterministic_algorithms(False)
    equal = {f: bool(torch.equal(t, eager_m.table.state[f]))
             for f, t in graph_m.table.state.items()}
    log = [e[:3] for e in caps.log if e[0] == "capture"]
    if (not all(equal.values()) or outs[True][:2] != outs[False][:2]
            or outs[True][2] != [False, True, False, True]
            or log != [("capture", 8, 4), ("capture", 8, 8)]):
        raise AssertionError(f"twins: tables equal {equal}, sums "
                             f"{outs}, captures {caps.log}")
    _json_line({"phase": "serve_control", "part": "recapture_vs_eager",
                "card": card, "batch": TWIN_BATCH, "push_window": [4, 8],
                "captures": log, "replayed": outs[True][2],
                "tables_bit_for_bit": equal,
                "err": [outs[True][:2], outs[False][:2]]})
    del graph_m, eager_m
    # (b3) an injected EF runaway demotes the wire at the next safe point
    obs.reset_for_tests()
    demo = _xla_q_model(vocab, {
        "control": {"control": "on", "every": 10 ** 6},
        "worker": {"telemetry": 1, "telemetry_path": ""},
        "obs": {"numerics": 1}})
    demo.transfer.count_traffic = True
    demo.train(batcher=CBOWBatcher(corpus[:TEL_SENTS // 2], vocab,
                                   demo.window, demo.sample, seed=2008),
               niters=1, batch_size=BATCH)
    q_before = demo.transfer.traffic()["window_fmt_q"]
    det, ctl = demo._numerics.detector, demo.controller
    det.warmup, det.patience = 2, 2
    series = "numerics/ef_mass{field=synthetic}"
    for v in (1.0, 1.0, 1.0, 1.0, 500.0, 500.0):
        det.observe(series, v)
    parked = ctl._numerics_pending is not None and \
        demo.wire_quant == "int8"
    ctl.on_steps(1)
    before = demo.transfer.traffic()
    demo.train(batcher=CBOWBatcher(corpus[:TEL_SENTS // 2], vocab,
                                   demo.window, demo.sample, seed=2008),
               niters=1, batch_size=BATCH)
    tr = demo.transfer.traffic_delta(before)
    d = ctl.decisions[-1] if ctl.decisions else None
    obs.reset_for_tests()
    # int8 windows before, none after: on xla a lossless window is the
    # per-step push, which books no window decision (as in JAX)
    if (not parked or q_before < 1 or demo.wire_quant != "off"
            or demo.transfer.wire_quant != "off" or d is None
            or (d.knob, d.action, d.old, d.new)
            != ("wire_quant", "apply", "int8", "off")
            or tr.get("window_fmt_q", 0) or not demo.train_metrics["fused"]):
        raise AssertionError(f"EF runaway demote: parked {parked}, "
                             f"wire_quant {demo.wire_quant}, decision {d}, "
                             f"traffic after {tr}")
    _json_line({"phase": "serve_control", "part": "ef_demote", "card": card,
                "decision": d.to_payload(),
                "window_fmt_q_before": q_before, "window_fmt_after": {
                    k: tr.get(k, 0) for k in ("window_fmt_q",
                                              "window_fmt_sparse",
                                              "window_fmt_dense")},
                "graph_replays_after": demo.train_metrics["graph_replays"]})
    return model, counts


def phase_serve_sent2vec(model: Word2Vec, card: str) -> tuple:
    """(c): sent2vec over (b)'s table, live and over a snapshot published
    from it, with the same draws: bit for bit, the snapshot's run reading
    its uploaded planes after the live table moved on.  Returns the B2
    cases at its shapes and the snapshot run's launches."""
    from swiftmpi_tpu_torch.convert import tensor_from_numpy
    pub = model.serving_publisher()
    model._serve_publish()
    snap = pub.latest()
    s2v = Sent2Vec(model, seed=1)
    s2v.batchsize = S2V_SENTS
    lines, L = _s2v_lines(model.vocab.keys)
    draws = s2v.draw(S2V_SENTS, L, S2V_NITERS)
    live = s2v.infer_sentences(lines, niters=S2V_NITERS, draws=iter([draws]))
    for f in ("h", "v"):
        model.table.state[f].add_(1.0)          # training moves on
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    planes = {f: tensor_from_numpy(np.asarray(snap.tail_array(f))).to(
        DEVICE) for f in ("h", "v")}
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    kernels.reset_launches()
    t0 = time.perf_counter()
    s2v = Sent2Vec(model, seed=1)
    s2v.batchsize = S2V_SENTS
    over = s2v.infer_sentences(lines, niters=S2V_NITERS, snapshot=snap,
                               draws=iter([draws]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    same = [sa == sb and np.array_equal(a, b)
            for (sa, a), (sb, b) in zip(over, live)]
    if len(over) != len(live) or not all(same) or counts != {
            **dict.fromkeys(counts, 0), "gather": 1 + S2V_NITERS}:
        raise AssertionError(f"sent2vec over a snapshot: {sum(same)} of "
                             f"{len(live)} vectors equal, launches {counts}")
    _json_line({"phase": "serve_control", "part": "sent2vec_snapshot",
                "card": card, "sentences": len(over), "L": L,
                "niters": S2V_NITERS, "snapshot_version": snap.version,
                "upload_ms": upload_ms, "snapshot_rows": int(
                    snap.tail_capacity), "seconds": seconds,
                "bit_for_bit_vs_live": True, "launches": counts})
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=DEVICE)
    index = {int(k): i for i, k in enumerate(model.vocab.keys.tolist())}
    vocab_pos = np.zeros((S2V_SENTS, L), np.int64)
    mask = np.zeros((S2V_SENTS, L), bool)
    for i, ln in enumerate(lines):
        t = [index[int(w)] for w in ln.split() if int(w) in index]
        vocab_pos[i, :len(t)], mask[i, :len(t)] = t, True
    sov = torch.as_tensor(snap.lookup(model.vocab.keys).astype(np.int32),
                          device=DEVICE)
    word_slots = sov[torch.as_tensor(vocab_pos, device=DEVICE)]
    cases = [_gather_case("sent2vec context rows of a snapshot", planes["v"],
                          word_slots.reshape(-1).contiguous(),
                          torch.as_tensor(mask, device=DEVICE).reshape(-1),
                          flush, SERVE_S2V)]
    return cases, counts


def phase_serve_cost(vocab, corpus: np.ndarray, card: str) -> list:
    """(e): the gather path on ``xla``, groups of 8 replayed as graphs,
    with ``[serve] every`` 0 (off), 8 and 64: two warm-up groups, then
    SERVE_COST_GROUPS groups timed by the host clock to a synchronize,
    each followed by the publisher's safe point."""
    from swiftmpi_tpu_torch.utils.pipeline import LossAccum
    probe = _model("gather", vocab, DEVICE, {"inner_steps": 8})
    groups = _tel_groups(probe, vocab, corpus, SERVE_COST_GROUPS + 2)
    del probe
    lines = []
    for every in SERVE_EVERY:
        model = _model("gather", vocab, DEVICE, {"inner_steps": 8})
        published = []
        if every:
            model.serve_every = every
            published = _timed_publishes(model.serving_publisher())
        es_q, ec_q = (LossAccum(None, model.device),
                      LossAccum(None, model.device))
        for fields, _ in groups[:2]:
            model._run_group(fields, True, None, es_q, ec_q)
            model._serve_on_steps(8)
        torch.cuda.synchronize()
        timed = groups[2:]
        t0 = time.perf_counter()
        for fields, _ in timed:
            model._run_group(fields, True, None, es_q, ec_q)
            model._serve_on_steps(8)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        pub = model.serve_publisher
        line = {"phase": "serve_cost", "card": card, "serve_every": every,
                "steps": 8 * len(timed),
                "publishes": pub.version if pub else 0,
                "publish_ms": [ms for _, ms, _ in published],
                "host_ms_per_step": host_s / (8 * len(timed)) * 1e3,
                "words_per_sec": sum(w for _, w in timed) / host_s}
        if not math.isfinite(es_q.total()):
            raise AssertionError(f"serve cost every {every}: loss "
                                 f"{es_q.total()}")
        _json_line(line)
        lines.append(line)
        if every == SERVE_EVERY[-1]:
            _json_line({"phase": "serve_cost", "part": "copy_rates",
                        "card": card, **_copy_rates(model.table)})
        del model
        torch.cuda.empty_cache()
    return lines


def _copy_rates(table) -> dict:
    """GB/s of the table's planes copied to the host: ``.cpu()`` into
    pageable memory (what a publish does, then numpy), and one
    ``copy_`` into pinned buffers made beforehand, each from a
    synchronize."""
    planes = [table.state[f] for f in sorted(table.state)]
    nbytes = sum(t.numel() * t.element_size() for t in planes)
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
              for t in planes]
    out = {"bytes": nbytes}
    for name, copy in (
            ("pageable", lambda: [t.cpu() for t in planes]),
            ("pinned", lambda: [p.copy_(t, non_blocking=True)
                                for p, t in zip(pinned, planes)])):
        copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[name] = {"ms": ms, "gb_per_s": nbytes / ms / 1e6}
    return out


def phase_serve(vocab, corpus: np.ndarray, card: str) -> tuple:
    """Phase 13: (a)-(e); returns its kernel cases and the runs'
    launches by path."""
    t0 = time.perf_counter()
    hyb, hyb_counts, snap = phase_serve_hybrid(vocab, corpus, card)
    batch = next(iter(CBOWBatcher(corpus[:100], vocab, hyb.window,
                                  hyb.sample, seed=2008).epoch(BATCH)))
    cases = _serve_kernel_cases(hyb, batch)
    del hyb
    phase_serve_topk(snap, card)
    del snap
    torch.cuda.empty_cache()
    xla, xla_counts = phase_serve_xla(vocab, corpus, card)
    s2v_cases, s2v_counts = phase_serve_sent2vec(xla, card)
    cases += s2v_cases
    del xla
    torch.cuda.empty_cache()
    phase_serve_cost(vocab, corpus, card)
    report_cases(cases)
    print(f"phase 13 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, {SERVE_HYB: hyb_counts, SERVE_XLA: xla_counts,
                   SERVE_S2V: s2v_counts}


# -- phase 14: more than one rank process on the card -------------------------

#: the processes of phase 14, all on the one card, and the shard ranks of
#: each in its (b) run
PROCS = 2
PROC_SHARDS = 4
#: phase 14's corpus prefix and epochs (each process a shard of it)
PROC_SENTS = 800
PROC_ITERS = 2
#: launches a step of a run across processes, each kernel's (and B5's
#: cross-process form, ``ring_process``): (a) ``xla``: the h push dense
#: (B3 with counts, one exchange of planes + counts, B1 over the table),
#: the v push sparse (B3 folds each process's rows, one exchange, B3 sums
#: them in process order, B1 on the rows); (b) ``tpu`` at 4 shards a
#: process: phase 4's sharded step plus one exchange of the owners' sums
#: a pushed family (both dense at this shape)
PROC_STEP = {
    "xla": {"gather": 2, "scatter": 3, "adagrad": 2, "stencil": 0,
            "ring": 0, "ring_process": 2},
    "tpu": {"gather": 2, "scatter": 2, "adagrad": 2, "stencil": 0,
            "ring": 8, "ring_process": 2},
    # ``hybrid`` (phase 20): each family's hot pull, push and apply and
    # the tail's routed one (phase 16's hybrid@4 at dp 2), one exchange
    # across processes for the hot planes and one for the tail's owners a
    # push
    "hybrid": {"gather": 4, "scatter": 4, "adagrad": 4, "stencil": 0,
               "ring": 8, "ring_process": 4},
}
PROC_PATH = "processes"
#: (c): how far ``server_num: 2``'s share of elements outside the
#: envelope after its steps may exceed a second ``server_num: 1`` run's
#: (both drift by B3's summation order): a factor, and an absolute share
#: (1e-5 of a field's 9.05 M elements is 90) for a witness that happens
#: to drift little
SERVER_NUM_DRIFT = 4
SERVER_NUM_SLACK = 1e-5


class _GlobalBatches:
    """The one-process reference's batcher: each step the processes'
    batches concatenated, ``n_words`` summed."""

    def __init__(self, epochs, vocab):
        self.epochs = iter(epochs)
        self.vocab = vocab

    def epoch(self, batch_size):
        for parts in next(self.epochs):
            yield SimpleNamespace(
                centers=np.concatenate([b.centers for b in parts]),
                contexts=np.concatenate([b.contexts for b in parts]),
                ctx_mask=np.concatenate([b.ctx_mask for b in parts]),
                n_words=sum(b.n_words for b in parts))


def _proc_run(label: str, conf: dict, data: Path, time_exchange: bool):
    """``launch -np PROCS -- mp_child w2v`` on the card; returns every
    process's JSON, rank 0's table, the launcher's output and its wall
    seconds.  A failed child fails the launch, and the launch the
    phase."""
    out = WORK / "phase14" / label
    shutil.rmtree(out, ignore_errors=True)
    spec = {"conf": conf, "data": str(data), "device": DEVICE,
            "batch_size": BATCH // PROCS, "niters": PROC_ITERS,
            "out": str(out), "state": True, "time_exchange": time_exchange}
    spec_path = WORK / "phase14" / f"{label}.json"
    spec_path.write_text(json.dumps(spec))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np",
         str(PROCS), "--", sys.executable, "-m",
         "swiftmpi_tpu_torch.testing.mp_child", "w2v", "-spec",
         str(spec_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, SMTPU_DIST_TIMEOUT="120"))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 14 {label}: the launch failed with "
                             f"rc {res.returncode}:\n{res.stdout[-6000:]}"
                             f"\n{res.stderr[-3000:]}")
    got = [json.loads((out / f"w2v_r{r}.json").read_text())
           for r in range(PROCS)]
    state = dict(np.load(out / "w2v_state_r0.npz"))
    first = dict(np.load(out / "w2v_first_step_r0.npz"))
    return got, (first, state), wall


def _hold_processes(label: str, got: list, tables: tuple, ref: Word2Vec,
                    ref_first: dict, ref_losses: list, steps: int,
                    transfer: str, phase: str = "phase 14") -> dict:
    """The replicas bit-identical, ``timeouts() == 0`` on every process,
    rank 0's table after the first step within the envelope of the
    one-process run's (a bfloat16 field: or one bfloat16 ulp), the loss
    trajectory within 1e-4 relative, the launches exact
    (``PROC_STEP[transfer]`` a step on every process).  The final tables'
    gap is reported: over dozens of steps AdaGrad carries the last bits
    of two summation orders apart (as between two runs of one process,
    whose atomics sum in no fixed order), so the losses, not the tables,
    are held there."""
    first, state = tables
    shas = [g["sha"] for g in got]
    if any(s != shas[0] for s in shas):
        raise AssertionError(f"{phase} {label}: the replicas differ: "
                             f"{shas}")
    if any(g["timeouts"] for g in got):
        raise AssertionError(f"{phase} {label}: ring waits timed out: "
                             f"{[g['timeouts'] for g in got]}")
    losses = got[0]["losses"]
    for a, b in zip(losses, ref_losses):
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"{phase} {label}: loss {losses} vs the "
                                 f"one-process run's {ref_losses}")
    gaps, bit_equal = {}, {}
    for f, v in ref.table.state.items():
        # host rows come upcast: a bfloat16 field's values are exact
        dtype = (v[0] if isinstance(v, list) else v).dtype
        want = torch.from_numpy(ref_first[f]).to(dtype)
        have = torch.from_numpy(first[f]).to(dtype)
        gaps[f] = _field_gap(f"{phase} {label}: field {f} after the "
                             "first step", have, want)
        bit_equal[f] = float((torch.from_numpy(first[f]).view(torch.int32)
                              == torch.from_numpy(ref_first[f]).view(
                                  torch.int32)).float().mean())

    want_launches = {k: v * steps for k, v in PROC_STEP[transfer].items()}
    for g in got:
        if g["launches"] != want_launches:
            raise AssertionError(f"{phase} {label}: rank {g['rank']} "
                                 f"launched {g['launches']}, the path "
                                 f"gives {want_launches}")
    return {"first_step_gap": gaps, "first_step_bit_equal_share":
            bit_equal, "final_gap": _final_gap(state, ref)}


def _final_gap(state: dict, ref: Word2Vec) -> dict:
    """Per field, the largest gap of host rows ``state`` to ``ref``'s
    table and the share of elements outside the envelope."""
    out = {}
    for f, v in ref.table.state.items():
        want = _global(v)
        end = (torch.from_numpy(state[f]) - want).abs()
        out[f] = {"max_abs_gap": end.max().item(),
                  "share_outside_envelope": float(
                      (end > 1e-5 + 1e-3 * want.abs()).float().mean())}
    return out


def phase_processes(vocab, corpus: np.ndarray, card: str) -> tuple:
    """Phase 14: (a) ``xla`` and (b) ``tpu`` (4 shard ranks a process) at
    ``dp = PROCS`` processes on the card through the launcher, each held
    against a one-process run of the port over the same global batches
    and draws; (c) ``server_num: 2`` on ``xla`` against ``server_num: 1``
    by key.  Returns the cross-process B5 case, its launches and the
    ``xla`` run's figures phase 20 prints beside its wider runs
    (``{"exchange": B5's times at its shapes, "run": its line}``)."""
    t0 = time.perf_counter()
    (WORK / "phase14").mkdir(parents=True, exist_ok=True)
    prefix = np.ascontiguousarray(corpus[:PROC_SENTS])
    probe = _model("gather", vocab, "cpu")
    Bl = BATCH // PROCS
    epochs = lockstep_epochs(vocab, prefix, probe.window, probe.sample, Bl,
                             PROCS, PROC_ITERS)
    steps = sum(len(e) for e in epochs)
    del probe
    rng = np.random.default_rng(14)
    data = {"corpus": prefix, "vocab_keys": vocab.keys,
            "vocab_counts": vocab.counts}
    draws_cat = []
    per_rank = [([], []) for _ in range(PROCS)]
    for _ in range(steps):
        js, us = [], []
        for r in range(PROCS):
            j = rng.integers(0, len(vocab), (Bl, DEMO_CONF["word2vec"][
                "negative"]))
            u = rng.random(j.shape, np.float32)
            per_rank[r][0].append(j)
            per_rank[r][1].append(u)
            js.append(j)
            us.append(u)
        draws_cat.append((torch.from_numpy(np.concatenate(js)).to(DEVICE),
                          torch.from_numpy(np.concatenate(us)).to(DEVICE)))
    for r in range(PROCS):
        data[f"j{r}"] = np.stack(per_rank[r][0])
        data[f"u{r}"] = np.stack(per_rank[r][1])
    data_path = WORK / "phase14" / "data.npz"
    np.savez(data_path, **data)
    print(f"phase 14 set-up {time.perf_counter() - t0:.1f} s ({steps} "
          f"steps of {PROCS} x {Bl} centers)", flush=True)

    runs, launches = {}, {k: 0 for k in PROC_STEP["xla"]}
    exchange = progress = None
    for label, transfer, shards in (("xla", "xla", 1),
                                    ("tpu", "tpu", PROC_SHARDS)):
        conf = {**DEMO_CONF, "cluster": {"transfer": transfer,
                                         "server_num": shards}}
        got, tables, wall = _proc_run(f"{label}@dp{PROCS}", conf,
                                      data_path,
                                      time_exchange=label == "xla")
        # the one-process run, twice: the second shows how far two runs
        # of one process drift apart (B3 sums in no fixed order)
        refs = []
        for _ in range(2):
            ref = Word2Vec(config=ConfigParser().update(conf),
                           device=DEVICE)
            ref.build_from_vocab(vocab)
            torch.cuda.synchronize()
            ref_first, times = {}, []
            ref_losses = ref.train(
                batcher=_GlobalBatches(epochs, vocab), batch_size=BATCH,
                niters=PROC_ITERS, draws=first_step_rows(
                    iter(draws_cat), ref, ref_first, times))
            refs.append((ref, ref_first, ref_losses, steady_step_ms(
                times, time.perf_counter())))
        ref, ref_first, ref_losses, _ = refs[0]
        # the second run is warm (the first pays the process's first
        # launches): its times are the one-process figures
        warm, ref_steady = refs[1][0], refs[1][3]
        held = _hold_processes(label, got, tables, ref, ref_first,
                               ref_losses, steps, transfer)
        held["one_process_rerun_final_gap"] = _final_gap(
            {f: _global(v).numpy() for f, v in refs[1][0].table.state.items()},
            ref)
        del refs
        m = got[0]["metrics"]
        steady = max(g["steady_step_ms"] for g in got)
        words_step = m["words"] / max(m["steps"], 1)
        for k, v in got[0]["launches"].items():
            launches[k] += v
        if label == "xla":
            exchange = got[0].get("exchange")
            progress = [g.get("progress") for g in got]
        runs[label] = {
            "transfer": transfer, "shards_per_process": shards,
            "processes": PROCS, "steps": m["steps"],
            # the second half of the run, past the warm-up
            "steady_step_ms": steady,
            "one_process_steady_step_ms": ref_steady,
            "global_words_per_sec": 1e3 * words_step / steady,
            "one_process_words_per_sec": 1e3 * words_step / ref_steady,
            # whole runs, warm-up included
            "run_words_per_sec": m["words_per_sec"],
            "one_process_run_words_per_sec":
                warm.train_metrics["words_per_sec"],
            "lockstep_host_ms_per_step": [g["metrics"][
                "lockstep_ms_per_step"] for g in got],
            "losses": got[0]["losses"], "one_process_losses": ref_losses,
            "push_paths": m["push_paths"],
            "launches_per_step": {k: v / max(m["steps"], 1)
                                  for k, v in got[0]["launches"].items()},
            "timeouts": [g["timeouts"] for g in got],
            "launch_wall_s": wall, **held}
        _json_line({"phase": "processes", "card": card, "run": label,
                    **runs[label]})
        del ref, warm
        torch.cuda.empty_cache()
    xla = {"exchange": exchange, "run": runs["xla"]}
    phase_server_num_xla(vocab, corpus, card)
    if exchange is None:
        # only a rehearsal on the CPU has no card to time
        if DEVICE == "cuda":
            raise AssertionError("phase 14: the xla run timed no exchange")
        return [], {PROC_PATH: launches}, xla
    for e in exchange:
        _json_line({"phase": "processes", "card": card,
                    "exchange": e["label"], "shape": e["shape"],
                    "kernel_ms": e["ms"], "bound_ms": e["bound_ms"],
                    "host_route_ms": e["host_route_ms"],
                    "gloo_cpu_ms": e["plain_ms"],
                    "max_abs_err": e["max_abs_err"],
                    "wait": "stream (cuStreamWaitValue64)",
                    "launches_in_xla_run": runs["xla"]["launches_per_step"][
                        "ring_process"] * runs["xla"]["steps"]})
    if any(e["max_abs_err"] != 0 for e in exchange):
        raise AssertionError(f"phase 14: the cross-process exchange is not "
                             f"a copy: {exchange}")
    _hold_progress(progress, card)
    dense = exchange[0]
    case = {"name": "ring_exchange (across processes, all-gather of the "
                    "dense plane)",
            "route": "cuda", "source": "swiftmpi_tpu_torch/kernels/csrc/"
                                       "ring.cu",
            "replaces": "swiftmpi_tpu/ops/pallas_ring.py:86",
            "module": ring, "counter": "ring_process", "path": PROC_PATH,
            "shape": dense["shape"], "max_abs_err": dense["max_abs_err"],
            "tolerance": "bit for bit (a copy)", "ms": dense["ms"],
            "plain_ms": dense["plain_ms"], "bytes": dense["bytes"],
            "flops": 0, "library": "none: NCCL runs no two ranks on one "
            "card; the host route's ms is on the processes line",
            "library_ms": None}
    report_cases([case])
    print(f"phase 14 {time.perf_counter() - t0:.1f} s", flush=True)
    return [case], {PROC_PATH: launches}, xla


#: how much slower process 1's fixed work may run while process 0 waits
#: on its send than alone (a waiter kernel made it ~2.2x: the card
#: time-sliced the two contexts)
PROGRESS_SLACK = 1.3


def _hold_progress(progress: list, card: str) -> None:
    """Phase 14: a waiting process holds no SM.  Process 1's fixed work
    (``apps.process_ring_sweep.progress``) while process 0 waits on its
    send runs within ``PROGRESS_SLACK`` of its time alone (medians of 3
    rounds); every exchange an exact copy."""
    p0, p1 = progress
    alone = float(np.median(p1["work_alone_ms"]))
    during = float(np.median(p1["work_during_wait_ms"]))
    _json_line({"phase": "processes", "card": card,
                "wait_progress": {"work_alone_ms": p1["work_alone_ms"],
                                  "work_during_wait_ms":
                                      p1["work_during_wait_ms"],
                                  "wait_ms": p0["wait_ms"],
                                  "during_over_alone": during / alone}})
    if not (p0["exact"] and p1["exact"]):
        raise AssertionError("phase 14: the progress drill's exchange is "
                             "not a copy")
    if during > PROGRESS_SLACK * alone:
        raise AssertionError(
            f"phase 14: process 1's work took {during:.2f} ms while "
            f"process 0 waited, {alone:.2f} ms alone: the wait holds the "
            "card")


def phase_server_num_xla(vocab, corpus: np.ndarray, card: str) -> None:
    """(c) ``server_num: 2`` on ``xla`` in one process: the (2 * cap, d)
    model-axis table, started from ``server_num: 1``'s rows by key and
    stepped over the same batches and draws, holds every key's rows
    within the envelope of ``server_num: 1``'s after the first step.
    Later steps carry B3's summation order (float atomics, no fixed
    order) through AdaGrad, so after the last step the gap is held to a
    witness: a second ``server_num: 1`` run from the same table over the
    same steps.  Per field, the share of elements outside the envelope
    may be at most ``SERVER_NUM_DRIFT`` times the witness's, plus
    ``SERVER_NUM_SLACK``; a fault in the slot layout moves whole rows."""
    models = []
    for n in (1, 1, 2):
        conf = {**DEMO_CONF, "cluster": {"transfer": "xla",
                                         "server_num": n}}
        models.append(Word2Vec(config=ConfigParser().update(conf),
                               device=DEVICE).build_from_vocab(vocab))
    one, again, two = models
    slots1 = torch.from_numpy(one.table.key_index.lookup(
        vocab.keys)).long().to(one.device)
    slots2 = torch.from_numpy(two.table.key_index.lookup(
        vocab.keys)).long().to(two.device)
    for f in one.table.state:
        again.table.state[f].copy_(one.table.state[f])
        two.table.state[f][slots2] = one.table.state[f][slots1]
    batches = _batches(vocab, corpus, one, 4)
    rng = np.random.default_rng(15)
    gaps = None
    for b in batches:
        d = _draws(one, len(b), rng)
        for m in models:
            m.step_batch(b, draws=d)
        if gaps is None:
            gaps = {f: _field_gap(f"phase 14 (c): field {f}",
                                  two.table.state[f][slots2].cpu(),
                                  one.table.state[f][slots1].cpu())
                    for f in one.table.state}
    torch.cuda.synchronize()

    def gap(a, b) -> dict:
        return {"max_abs_gap": (a - b).abs().max().item(),
                "share_outside_envelope": float(
                    ((a - b).abs() > 1e-5 + 1e-3 * b.abs()).float().mean())}
    final, witness = {}, {}
    for f in one.table.state:
        b = one.table.state[f][slots1].cpu()
        final[f] = gap(two.table.state[f][slots2].cpu(), b)
        witness[f] = gap(again.table.state[f][slots1].cpu(), b)
    _json_line({"phase": "processes", "card": card, "run": "server_num_2",
                "table_rows": [one.table.capacity, two.table.capacity],
                "shards": [1, two.table.key_index.num_shards],
                "steps": len(batches), "first_step_gap_by_key": gaps,
                "final_gap_by_key": final,
                "server_num_1_rerun_final_gap": witness,
                "push_paths": dict(two.transfer.push_paths)})
    for f in final:
        share = final[f]["share_outside_envelope"]
        limit = (SERVER_NUM_DRIFT * witness[f]["share_outside_envelope"]
                 + SERVER_NUM_SLACK)
        if share > limit:
            raise AssertionError(
                f"phase 14 (c): field {f} after {len(batches)} steps: "
                f"{share:.3g} of the elements outside the envelope, above "
                f"{limit:.3g} ({SERVER_NUM_DRIFT} x a second server_num: "
                f"1 run's {witness[f]['share_outside_envelope']:.3g} + "
                f"{SERVER_NUM_SLACK})")


# -- phase 15: fleets on the card ---------------------------------------------

#: (a): the corpus prefix the supervised job trains on, its iterations and
#: the iteration at whose top rank 1 is killed; the conf's minibatch makes
#: each process's default batch phase 14's (BATCH // PROCS centers)
FLEET_SENTS = 800
FLEET_ITERS = 4
FLEET_KILL_ITER = 2
FLEET_PATH = "fleet_restart"
#: the restarted world's losses against the job stopped after the kill's
#: iteration and launched again, relative
RELAUNCH_RTOL = 1e-3
#: (b): the elastic world at the table's real width: 16 shards of 8,192
#: rows of 100 floats, a (131,072, 100) float32 tensor on each rank
ELASTIC_NP = 4
ELASTIC_ENV = {"SMTPU_ELASTIC": "1", "SMTPU_ELASTIC_SHARDS": "16",
               "SMTPU_ELASTIC_ROWS": "8192", "SMTPU_ELASTIC_DIM": "100",
               "SMTPU_ELASTIC_DUMP_EVERY": "5",
               "SMTPU_ELASTIC_JOIN_TIMEOUT_S": "60",
               "SMTPU_FLEET_STEPS": "60", "SMTPU_FLEET_STEP_S": "0.02",
               "SMTPU_FLEET_HB_S": "0.25"}
ELASTIC_KILL = (2, 20)            # rank, step
ELASTIC_PATH = "fleet_elastic"
#: (c): the serve fleet: a trainer on the card and 2 replicas over the
#: reference table's shape, 90,516 rows of 100 floats (phase 13's table;
#: a 36.2 MB plane), each step touching one minibatch's 5,000 Zipf draws
SERVE_ENV = {"SMTPU_SERVE_STEPS": "60", "SMTPU_SERVE_STEP_S": "0.05",
             "SMTPU_FLEET_HB_S": "0.25", "SMTPU_SERVE_EVERY": "4",
             "SMTPU_SERVE_VOCAB": "90516", "SMTPU_SERVE_DIM": "100",
             "SMTPU_SERVE_TOUCH": "5000"}
SERVE_KILL = (1, 20)              # replica rank, step
#: seconds a supervised launch may take before the phase fails
FLEET_TIMEOUT_S = 300


def _device_args() -> list:
    """The children's device flag: none on the card (their default), the
    CPU only when this script runs there (a rehearsal)."""
    return [] if DEVICE == "cuda" else ["-device", DEVICE]


def _fleet_launch(label: str, args: list, env: dict):
    """``python -m swiftmpi_tpu_torch.launch *args`` from the repository
    root; its output goes to ``build/chip_smoke/phase15/<label>.log``.
    Returns the result and its wall seconds."""
    t0 = time.perf_counter()
    log = WORK / "phase15" / f"{label}.log"
    try:
        res = subprocess.run(
            [sys.executable, "-m", "swiftmpi_tpu_torch.launch", *args],
            cwd=ROOT, capture_output=True, text=True,
            timeout=FLEET_TIMEOUT_S,
            env=dict(os.environ, SMTPU_DIST_TIMEOUT="120", **env))
    except subprocess.TimeoutExpired as e:
        log.write_text(f"{e.stdout or ''}\n{e.stderr or ''}")
        raise
    wall = time.perf_counter() - t0
    log.write_text(res.stdout + res.stderr)
    return res, wall


def _sup_events(fleet_dir: Path) -> list:
    with open(fleet_dir / "supervisor.jsonl") as f:
        return [json.loads(line) for line in f]


def _fail(what: str, res, failures: list) -> None:
    if failures:
        raise AssertionError(f"phase 15 {what}: " + "; ".join(failures)
                             + f"\n{res.stdout[-5000:]}\n{res.stderr[-2000:]}")


def _fleet_collector(fleet_dir: Path):
    from swiftmpi_tpu_torch.obs.collector import FleetCollector
    fc = FleetCollector(str(fleet_dir), stall_after_s=0.8, dead_after_s=8.0)
    fc.poll(final=True)
    return fc


def _rank_lines(stdout: str, rank: int, needle: str) -> list:
    return [ln for ln in stdout.splitlines()
            if ln.startswith(f"[rank {rank}] ") and needle in ln]


def _w2v_launches(stdout: str) -> tuple:
    """The kernel launches, steps and ring wait timeouts each process of
    a w2v_main run logged at its end, summed over the processes."""
    total, steps, timeouts = {}, [], []
    for ln in stdout.splitlines():
        if "kernel launches {" not in ln:
            continue
        blob = ln[ln.index("{"):ln.index("}") + 1]
        for k, v in json.loads(blob).items():
            total[k] = total.get(k, 0) + v
        tail = ln.split(" over ")[1]
        steps.append(int(tail.split()[0]))
        timeouts.append(int(tail.rsplit(" ", 1)[1]))
    return total, steps, timeouts


def phase_fleet_restart(corpus: np.ndarray, card: str) -> tuple:
    """(a) restart-the-world: ``launch -np 2 -max-restarts 1 -fleet-dir D
    -- w2v_main -checkpoint`` at the reference width on ``xla``, rank 1
    SIGKILLed at the top of iteration FLEET_KILL_ITER (once: a marker
    file), against the same run unkilled (phase 9's 20% rule) and, loss
    by loss, against the job stopped after iteration FLEET_KILL_ITER and
    launched again on its checkpoint (a resume from another generation or
    on other streams would differ).  Returns its line, its kernel
    launches and the data and conf the kernel cases read."""
    out = WORK / "phase15" / "restart"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    data, conf = out / "corpus.txt", out / "w2v.conf"
    write_tokens_file(np.ascontiguousarray(corpus[:FLEET_SENTS]), str(data))
    w = DEMO_CONF["word2vec"]
    conf.write_text(
        "[cluster]\ntransfer: xla\nserver_num: 1\n"
        f"[worker]\nminibatch: {2 * w['window'] * (BATCH // PROCS)}\n"
        f"[server]\ninitial_learning_rate: "
        f"{DEMO_CONF['server']['initial_learning_rate']}\n"
        "[word2vec]\n" + "".join(f"{k}: {v}\n" for k, v in w.items()))
    runs = {}
    # the killed world, the job unkilled, and the job stopped after the
    # kill's iteration and launched again on its checkpoint (what a
    # correct resume replays: the same generation, streams started anew)
    for label, kill, niters in (
            ("unkilled", False, FLEET_ITERS), ("killed", True, FLEET_ITERS),
            ("stopped", False, FLEET_KILL_ITER),
            ("relaunched", False, FLEET_ITERS)):
        d = out / ("stopped" if label == "relaunched" else label)
        d.mkdir(exist_ok=True)
        env, sup = {}, ["-np", str(PROCS), "-fleet-dir", str(d / "fleet")]
        if kill:
            env["SMTPU_FAULT_PLAN"] = FaultPlan().kill_rank(
                1, at_step=FLEET_KILL_ITER,
                marker=str(d / "kill_marker")).to_json()
            sup += ["-max-restarts", "1", "-backoff", "0.2"]
        res, wall = _fleet_launch(f"restart_{label}", sup + [
            "--", sys.executable, "-m", "swiftmpi_tpu_torch.apps.w2v_main",
            "-config", str(conf), "-data", str(data), "-niters",
            str(niters), "-checkpoint", str(d / "ck"), "-output",
            str(d / "vectors.txt"), *_device_args()], env)
        if res.returncode != 0:
            raise AssertionError(f"phase 15 (a) {label}: the launch failed "
                                 f"with rc {res.returncode}\n"
                                 f"{res.stdout[-6000:]}\n{res.stderr[-2000:]}")
        runs[label] = (res, wall, d)
    res, wall, d = runs["killed"]
    failures = []
    events = _sup_events(d / "fleet")
    kinds = [e["kind"] for e in events]
    if kinds.count("spawn") != 2 * PROCS or kinds.count("restart") != 1:
        failures.append(f"supervisor events {kinds}")
    organic = [e for e in events if e["kind"] == "exit" and e["rank"] == 1
               and e["attempt"] == 0]
    if [(e["rc"], e["by_supervisor"]) for e in organic] != [(137, False)]:
        failures.append(f"rank 1's first exit {organic}, not rc 137 on "
                        "its own")
    fc = _fleet_collector(d / "fleet")
    members = fc.members()
    if members.get("1", {}).get("restarts") != 1 \
            or len(set(members["1"]["pids"])) != 2:
        failures.append(f"rank 1's lives {members.get('1')}")
    if fc.summary()["unnoticed_deaths"]:
        failures.append(f"unnoticed deaths {fc.summary()['unnoticed_deaths']}")
    resumed = [ln for ln in res.stdout.splitlines()
               if "found valid checkpoint" in ln]
    if sorted(ln[:8] for ln in resumed) != ["[rank 0]", "[rank 1]"] \
            or not all(f"at iter {FLEET_KILL_ITER};" in ln
                       for ln in resumed):
        failures.append(f"the restarted world resumed as {resumed}")
    wrote = [ln for ln in res.stdout.splitlines() if "wrote " in ln]
    if len(wrote) != 1 or not wrote[0].startswith("[rank 0]"):
        failures.append(f"dump writers {wrote}")

    def iters(stdout):
        return [float(ln.split(": error ")[1].split()[0])
                for ln in _rank_lines(stdout, 0, ": error ")
                if "] iter " in ln]
    losses = iters(res.stdout)
    loss, want = losses[-1], iters(runs["unkilled"][0].stdout)[-1]
    if not (math.isfinite(loss) and abs(loss - want) <= 0.2 * abs(want)):
        failures.append(f"final loss {loss} vs the unkilled run's {want}")
    # the second life against the relaunched job, iteration by iteration
    # (B3's float atomics order sums differently run to run)
    again = iters(runs["relaunched"][0].stdout)
    second = losses[FLEET_KILL_ITER:]
    if len(second) != len(again) or not all(
            abs(a - b) <= RELAUNCH_RTOL * abs(b)
            for a, b in zip(second, again)):
        failures.append(f"the second life's losses {second} vs the "
                        f"relaunched job's {again}")
    launches, steps, timeouts = _w2v_launches(res.stdout)
    if len(steps) != PROCS or any(timeouts):
        failures.append(f"the second life's processes logged steps "
                        f"{steps}, ring wait timeouts {timeouts}")
    for k in ("gather", "scatter", "adagrad", "ring_process"):
        if not launches.get(k):
            failures.append(f"the restarted world launched no {k}")
    _fail("(a)", res, failures)
    # the time to get back: the kill (rank 1's exit, seen within one poll)
    # to the restarted world's first step, over its processes
    kill_ts = organic[0]["ts"]
    firsts = [m["_streams"][-1].records[0]["t_abs"] for m in members.values()]
    line = {"phase": "fleet", "card": card, "run": "restart_the_world",
            "processes": PROCS, "niters": FLEET_ITERS,
            "killed": f"rank 1 at iteration {FLEET_KILL_ITER}",
            "seconds_to_get_back": max(firsts) - kill_ts,
            "resumed_at_iter": FLEET_KILL_ITER, "final_loss": loss,
            "unkilled_final_loss": want, "losses": losses,
            "unkilled_losses": iters(runs["unkilled"][0].stdout),
            "relaunched_losses": again,
            "launch_wall_s": wall,
            "unkilled_launch_wall_s": runs["unkilled"][1],
            "second_life_steps": steps, "second_life_launches": launches,
            "launches_per_step": {k: v / max(sum(steps), 1)
                                  for k, v in launches.items()},
            "ring_wait_timeouts": timeouts}
    _json_line(line)
    return line, launches, (data, conf)


def _restart_cases(data: Path, conf: Path, flush) -> list:
    """B1-B3 at the shapes one step of (a)'s job gives them on a process:
    the model as w2v_main builds it, one batch of rank 0's sentences."""
    reset_global_config()
    model = Word2Vec(config=ConfigParser(str(conf)), device=DEVICE)
    sents = load_corpus(str(data),
                        min_sentence_length=model.min_sentence_length)
    model.build(sents)
    batcher = CBOWBatcher(sents[0::PROCS], model.vocab, model.window,
                          model.sample, seed=2008)
    batch = next(iter(batcher.epoch(BATCH // PROCS)))
    rng = np.random.default_rng(15)
    cap, d = model.table.capacity, model.len_vec
    h_slots, v_slots = _step_inputs(model, batch, rng)
    hs, hv = _perturbed(h_slots, cap, rng)
    vs, vv = _perturbed(v_slots, cap, rng)
    state = model.table.state
    counts = torch.as_tensor(rng.integers(1, 9, cap).astype(np.float32),
                             device=model.device)
    accum = torch.as_tensor(rng.random((cap, d), np.float32) * 1e-3,
                            device=model.device)
    grad = torch.as_tensor(rng.normal(size=(cap, d)).astype(np.float32)
                           * 1e-2, device=model.device)
    cases = [
        _gather_case("h pull, restarted world", state["h"], hs, hv, flush,
                     FLEET_PATH),
        _gather_case("v pull, restarted world", state["v"], vs, vv, flush,
                     FLEET_PATH),
        _scatter_case("h push, restarted world", FLEET_PATH, hs, hv, cap, d,
                      rng, flush),
        _adagrad_case("h table, / counts, restarted world", FLEET_PATH,
                      state["h"], accum, grad,
                      model.access.learning_rate, flush, div=counts)]
    reset_global_config()
    return cases


def phase_fleet_elastic(card: str, flush) -> tuple:
    """(b) ``launch -np 4 -elastic 1 -dead-after 8`` over the elastic
    child with its rows on the card, rank 2 SIGKILLed at step 20:
    ``fleet_smoke.py --elastic``'s checks.  Returns its line, its B2
    launches and B2's case at an export's shape."""
    d = WORK / "phase15" / "elastic"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    rank, step = ELASTIC_KILL
    env = {**ELASTIC_ENV, "SMTPU_FAULT_PLAN": FaultPlan().kill_rank(
        rank, at_step=step, marker=str(d / "kill_marker")).to_json()}
    res, wall = _fleet_launch("elastic", [
        "-np", str(ELASTIC_NP), "-elastic", "1", "-fleet-dir", str(d),
        "-dead-after", "8", "-max-restarts", "2", "-backoff", "0.2",
        "-join-timeout", "30", "--", sys.executable, "-m",
        "swiftmpi_tpu_torch.testing.fleet_child", *_device_args()], env)
    failures = [] if res.returncode == 0 else [f"rc {res.returncode}"]
    fc = _fleet_collector(d)
    s = fc.summary()
    events = fc.supervisor_events
    epochs = [e for e in events if e["kind"] == "epoch"]
    if s.get("fleet_epoch", 0) < 2:
        failures.append(f"fleet_epoch {s.get('fleet_epoch')}")
    commits = [e for e in epochs if str(e["reason"]).startswith("commit")]
    deaths = [e for e in epochs if e["reason"] == f"death:r{rank}"]
    prepares = [e for e in epochs if e["state"] == "prepare"]
    if not (commits and deaths and prepares):
        failures.append(f"epochs {[e['reason'] for e in epochs]}")
    organic = [e for e in events if e["kind"] == "exit"
               and e["rank"] == rank and e["rc"] not in (0, None)
               and not e["by_supervisor"]]
    if [e["rc"] for e in organic] != [137]:
        failures.append(f"rank {rank}'s organic exits {organic}")
    if s["unnoticed_deaths"]:
        failures.append(f"unnoticed deaths {s['unnoticed_deaths']}")
    if any(e["kind"] == "hang_kill" for e in events):
        failures.append("a rank was killed as hung")
    if set(s["health"].values()) != {"exited"} \
            or len(s["health"]) != ELASTIC_NP:
        failures.append(f"health {s['health']}")
    if s.get("fleet_reconverge_steps") is None:
        failures.append("no reconvergence on the final epoch")
    if not s.get("migration_bytes"):
        failures.append("migration_bytes 0")
    n_keys = int(ELASTIC_ENV["SMTPU_ELASTIC_SHARDS"]) \
        * int(ELASTIC_ENV["SMTPU_ELASTIC_ROWS"])
    keys = []
    for r in range(ELASTIC_NP):
        keys += json.loads((d / f"census_r{r}.json").read_text())["keys"]
    if len(keys) != n_keys or set(keys) != set(range(n_keys)):
        failures.append(f"the census holds {len(keys)} keys, "
                        f"{len(set(keys))} distinct, of {n_keys}")
    ok = [ln for ln in res.stdout.splitlines() if "ELASTIC_CHILD_OK" in ln]
    if len(ok) != ELASTIC_NP \
            or not all(f"device={DEVICE}" in ln for ln in ok):
        failures.append(f"child lines {ok}")
    launches = sum(int(ln.rsplit("launches=", 1)[1]) for ln in ok)
    if not launches:
        failures.append("no masked gather launch in the elastic children")
    _fail("(b)", res, failures)
    line = {"phase": "fleet", "card": card, "run": "elastic",
            "ranks": ELASTIC_NP, "rows_device": DEVICE,
            "table": [n_keys, int(ELASTIC_ENV["SMTPU_ELASTIC_DIM"])],
            "killed": f"rank {rank} at step {step}",
            "fleet_epoch": s["fleet_epoch"],
            "death_to_commit_s": deaths[0]["ts"] - organic[0]["ts"],
            "join_to_commit_s": commits[-1]["ts"] - prepares[-1]["ts"],
            "migration_bytes": s["migration_bytes"],
            "reconverge_steps": s["fleet_reconverge_steps"],
            "restarts": s["restarts"], "gather_launches": launches,
            "launch_wall_s": wall}
    _json_line(line)
    cap = n_keys
    dim = int(ELASTIC_ENV["SMTPU_ELASTIC_DIM"])
    n_shards = int(ELASTIC_ENV["SMTPU_ELASTIC_SHARDS"])
    table = torch.randn((cap, dim), device=DEVICE)
    # a handback's export: n_shards // ELASTIC_NP shards, shard by shard
    shards = range(0, n_shards, ELASTIC_NP)
    slots = torch.as_tensor([s + i * n_shards for s in shards
                             for i in range(cap // n_shards)],
                            dtype=torch.int32, device=DEVICE)
    valid = torch.ones(slots.numel(), dtype=torch.bool, device=DEVICE)
    case = _gather_case(f"elastic export, {len(shards)} shards of "
                        f"{cap // n_shards} rows", table, slots, valid, flush,
                        ELASTIC_PATH)
    return line, launches, case


def phase_fleet_serve(card: str) -> dict:
    """(c) ``launch -serve 2`` over the serve child, the trainer's planes
    on the card, replica 1 SIGKILLed at step 20: ``fleet_smoke.py
    --serve``'s checks."""
    from swiftmpi_tpu_torch.obs.registry import parse_series_key
    from swiftmpi_tpu_torch.serve.shipper import read_manifest
    d = WORK / "phase15" / "serve"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    rank, step = SERVE_KILL
    env = {**SERVE_ENV, "SMTPU_FAULT_PLAN": FaultPlan().kill_rank(
        rank, at_step=step, marker=str(d / "kill_marker")).to_json()}
    res, wall = _fleet_launch("serve", [
        "-serve", "2", "-fleet-dir", str(d), "-max-restarts", "3",
        "-backoff", "0.2", "--", sys.executable, "-m",
        "swiftmpi_tpu_torch.testing.serve_child", *_device_args()], env)
    failures = [] if res.returncode == 0 else [f"rc {res.returncode}"]
    fc = _fleet_collector(d)
    s, sv = fc.summary(), fc.serve_view()
    manifest = read_manifest(str(d / "ship"))
    members = fc.members()

    def versions(key):
        return [[int(v) for r in st.records
                 for g, v in (r.get("gauges") or {}).items()
                 if parse_series_key(g)[0] == "serve/replica_version"]
                for st in members[key]["_streams"]]
    if sv is None or sv["serve_replicas"] != 2 or not manifest:
        failures.append(f"serve view {sv}, manifest {len(manifest)}")
    for key in ("1", "2"):
        for life, vals in enumerate(versions(key) if key in members
                                    else [[]]):
            if vals != sorted(vals):
                failures.append(f"rank {key} life {life} rewound: {vals}")
    lives = versions(str(rank)) if str(rank) in members else []
    tail = manifest[-1]["version"] if manifest else 0
    if len(lives) != 2 or max(lives[1] or [0]) < tail:
        failures.append(f"replica {rank}'s lives {lives} vs the tail v{tail}")
    organic = [e for e in fc.supervisor_events if e["kind"] == "exit"
               and e["rank"] == rank and e["rc"] not in (0, None)
               and not e["by_supervisor"]]
    if [e["rc"] for e in organic] != [137]:
        failures.append(f"replica {rank}'s organic exits {organic}")
    if s["unnoticed_deaths"]:
        failures.append(f"unnoticed deaths {s['unnoticed_deaths']}")
    if set(s["health"].values()) != {"exited"}:
        failures.append(f"health {s['health']}")
    trainer = _rank_lines(res.stdout, 0, "SERVE_CHILD_OK role=trainer")
    if len(trainer) != 1 or f"device={DEVICE}" not in trainer[0]:
        failures.append(f"trainer line {trainer}")
    back = _rank_lines(res.stdout, rank, "SERVE_CHILD_OK role=replica")
    fields = dict(kv.split("=", 1) for kv in back[0].split()
                  if "=" in kv) if len(back) == 1 else {}
    # the restarted replica replayed the reference-shaped base: at least
    # its int8-or-wider rows
    vocab, dim = (int(SERVE_ENV[k]) for k in ("SMTPU_SERVE_VOCAB",
                                              "SMTPU_SERVE_DIM"))
    if int(fields.get("base_bytes", 0)) < vocab * dim:
        failures.append(f"replica {rank}'s lines {back}")
    _fail("(c)", res, failures)
    first = members[str(rank)]["_streams"][-1].records[0]["t_abs"]
    line = {"phase": "fleet", "card": card, "run": "serve",
            "replicas": 2, "killed": f"replica {rank} at step {step}",
            "manifest_tail": tail,
            "deltas": sum(m["kind"] == "delta" for m in manifest),
            "table": [vocab, dim],
            "replica_resync_s": float(fields["resync_s"]),
            "resync_base_bytes": int(fields["base_bytes"]),
            "resync_delta_bytes": int(fields["delta_bytes"]),
            "resync_deltas": int(fields["deltas"]),
            "kill_to_serving_s": first - organic[0]["ts"],
            "replica_p50_ms": float(fields["p50"]),
            "replica_p99_ms": float(fields["p99"]),
            "qps_total": sv["serve_qps_total"],
            "staleness_max_s": sv["serve_staleness_max_s"],
            "launch_wall_s": wall}
    _json_line(line)
    return line


def phase_fleet(corpus: np.ndarray, card: str) -> tuple:
    """Phase 15: (a) restart-the-world, (b) the elastic world, (c) the
    serve fleet, each through the port's supervised launcher on the card;
    B1-B3 at (a)'s shapes and B2 at (b)'s export.  Returns the cases and
    their paths' launches."""
    t0 = time.perf_counter()
    (WORK / "phase15").mkdir(parents=True, exist_ok=True)
    _, restart_launches, (data, conf) = phase_fleet_restart(corpus, card)
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=DEVICE)
    _, elastic_launches, export_case = phase_fleet_elastic(card, flush)
    phase_fleet_serve(card)
    cases = _restart_cases(data, conf, flush) + [export_case]
    report_cases(cases)
    del flush
    torch.cuda.empty_cache()
    print(f"phase 15 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, {FLEET_PATH: restart_launches,
                   ELASTIC_PATH: {"gather": elastic_launches}}


# -- phase 16: the rest of the data axis on the card --------------------------

#: phase 16's epochs over phase 14's prefix (each process a shard of it)
DA_ITERS = 1
#: its transfer-level windows: steps a window and rows a step and process
#: (the v push's 2,500 x 8 rows of a step)
DA_WINDOW, DA_WIN_ROWS = 4, 20_000
#: its LR and GloVe epochs
DA_LR_ITERS, DA_GLOVE_ITERS = 2, 1
#: the launch counts' path on the kernels line
DA_PATH = "data_axis"
#: the lossless window's hot planes against the one-process push: a hot
#: row sums ~700 of the window's rows in another order (B3's atomics), and
#: where such a sum nearly cancels, AdaGrad's first update (g / sqrt(g^2 +
#: 1e-6)) carries its float32 rounding far (phase 3's pool rows; on an
#: H100, 1 of the hot plane's 22,200 elements, by 5.2e-5).  Elements of the
#: ``@hot`` fields may leave the envelope, at most this share of a field's
#: and none by more than DA_SUM_ORDER_GAP; the tail's fields may not.
DA_SUM_ORDER_SHARE, DA_SUM_ORDER_GAP = 1e-4, 1e-4
DA_KERNELS = ("gather", "scatter", "adagrad", "ring", "ring_process")


def _da_launch(specs: list, out: Path, phase: str = "phase 16",
               nprocs: int = PROCS) -> tuple:
    """One ``launch -np nprocs -- mp_child w2v -spec`` over every job, in
    one process group: each job's JSON by process and rank 0's arrays,
    the launcher's output and its wall seconds."""
    spec_path = out / "specs.json"
    spec_path.write_text(json.dumps(specs))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.launch", "-np",
         str(nprocs), "--", sys.executable, "-m",
         "swiftmpi_tpu_torch.testing.mp_child", "w2v", "-spec",
         str(spec_path)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, SMTPU_DIST_TIMEOUT="180"))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{phase}: the launch failed with rc "
                             f"{res.returncode}:\n{res.stdout[-6000:]}\n"
                             f"{res.stderr[-3000:]}")
    got = {}
    for spec in specs:
        job, d = spec.get("job", "w2v"), Path(spec["out"])
        arrays = {}
        for name in (f"{job}_state_r0.npz", "w2v_first_step_r0.npz"):
            if (d / name).exists():
                arrays[name.split("_r0")[0]] = dict(np.load(d / name))
        got[d.name] = ([json.loads((d / f"{job}_r{r}.json").read_text())
                        for r in range(nprocs)], arrays)
    return got, res.stdout, wall


def _da_replicas(label: str, got: list) -> None:
    """The processes' replicas equal to the bit; no ring wait gave up."""
    shas = [g["sha"] for g in got]
    if any(s != shas[0] for s in shas):
        raise AssertionError(f"phase 16 {label}: the replicas differ: "
                             f"{shas}")
    if any(g["timeouts"] for g in got):
        raise AssertionError(f"phase 16 {label}: ring waits timed out: "
                             f"{[g['timeouts'] for g in got]}")


def _da_losses(label: str, got: list, want: list) -> None:
    have = got[0]["losses"]
    if len(have) != len(want) or not all(
            math.isclose(a, b, rel_tol=1e-4) for a, b in zip(have, want)):
        raise AssertionError(f"phase 16 {label}: losses {have} vs the "
                             f"one-process run's {want}")


def _da_gap(label: str, have: dict, want: dict, share: float = 0.0) -> dict:
    """Every field of ``have`` (host rows) against ``want``: the largest
    gap and the share of elements outside the envelope, which may not
    pass ``share``."""
    out = {}
    for f, w in want.items():
        w = np.asarray(w, np.float32)
        gap = np.abs(np.asarray(have[f], np.float32) - w)
        outside = float((gap > 1e-5 + 1e-3 * np.abs(w)).mean())
        out[f] = {"max_abs_gap": float(gap.max()) if gap.size else 0.0,
                  "share_outside_envelope": outside}
        if outside > share:
            raise AssertionError(f"phase 16 {label}: field {f}: {out[f]} "
                                 f"(allowed share {share})")
    return out


def _da_ref_w2v(conf: dict, vocab, epochs, draws_cat) -> tuple:
    """The one-process port run over the global batches and draws: the
    model, its table after the first step, its losses."""
    ref = Word2Vec(config=ConfigParser().update(conf), device=DEVICE)
    ref.build_from_vocab(vocab)
    first = {}
    losses = ref.train(batcher=_GlobalBatches(epochs, vocab),
                       batch_size=BATCH, niters=DA_ITERS,
                       draws=first_step_rows(iter(draws_cat), ref, first))
    return ref, first, losses


def _da_exchanges(label: str, got: list, card: str) -> None:
    for e in got[0].get("exchange", []):
        if e["max_abs_err"] != 0:
            raise AssertionError(f"phase 16 {label}: the cross-process "
                                 f"exchange is not a copy: {e}")
        _json_line({"phase": "data_axis", "card": card, "job": label,
                    "exchange": e["label"], "shape": e["shape"],
                    "kernel_ms": e["ms"], "bound_ms": e["bound_ms"],
                    "host_route_ms": e["host_route_ms"],
                    "gloo_cpu_ms": e["plain_ms"],
                    "wait": "stream (cuStreamWaitValue64)",
                    "launches_in_job": got[0]["launches"].get(
                        "ring_process")})


def _ef_bank_case(label, path, ded, cap, width, rng, flush):
    """B3 as ``ef_quantize_window`` banks a window's errors: ``ded``'s
    ``(S, L)`` slices, each of distinct slots, one launch each with
    ``out=`` into one zeroed ``(cap, width)`` plane and its counts, bit for
    bit against the plain version's slices added in the same order."""
    dev = ded.device
    valid = (ded >= 0).contiguous()
    g = torch.randn((*ded.shape, width), generator=_device_gen(dev, rng),
                    device=dev) * 1e-2

    def bank(fn):
        acc = torch.zeros((cap, width), device=dev)
        cnt = torch.zeros(cap, device=dev)
        for s in range(ded.shape[0]):
            fn(ded[s], valid[s], g[s], cap, counts=True, out=(acc, cnt))
        return acc, cnt
    (acc_k, cnt_k), (acc_p, cnt_p) = (bank(scatter.masked_scatter_add),
                                      bank(scatter.masked_scatter_add_plain))
    torch.cuda.synchronize()
    err = (acc_k - acc_p).abs().max().item()
    if not (torch.equal(acc_k, acc_p) and torch.equal(cnt_k, cnt_p)):
        raise AssertionError(f"masked_scatter_add ({label}): kernel != "
                             f"plain (max |err| {err})")
    (S, L), n_ok = ded.shape, int(valid.sum())
    safe = torch.where(valid, ded, cap).reshape(-1).long()
    lib = torch.zeros((cap + 1, width), device=dev)
    return dict(
        name=f"masked_scatter_add ({label})", route="cuda", path=path,
        source="swiftmpi_tpu_torch/kernels/csrc/scatter.cu",
        replaces="swiftmpi_tpu/ops/pallas_scatter.py:77",
        module=scatter, shape=f"{S} slices x {L} rows x {width}, each of "
        f"distinct slots, into one ({cap}, {width}) plane + counts, "
        f"{S * L - n_ok} invalid, {S} launches",
        max_abs_err=err, tolerance="exact (one addition an element a "
        "launch, launches in order)",
        ms=_time_ms(lambda: bank(scatter.masked_scatter_add), flush),
        plain_ms=_time_ms(lambda: bank(scatter.masked_scatter_add_plain),
                          flush),
        library_ms=_time_ms(lambda: lib.index_add_(0, safe,
                                                   g.view(-1, width)),
                            flush),
        library="Tensor.index_add_ (sums only, one call)",
        bytes=5 * S * L + 4 * n_ok * width + 4 * cap * (width + 1),
        flops=n_ok * width)


def _da_kernel_cases(model: Word2Vec, batch, q_spec: dict,
                     shards: int) -> list:
    """B1 and B3 at the shapes phase 16's jobs give them and no other
    phase checks: (a)'s hot push of one process's h rows onto the
    ``(n_hot, 100)`` head with counts, AdaGrad over the hot plane once
    the processes' sums are in (the mean's reciprocal of up to two
    processes' counts), and the error feedback's bank of (c)'s quantized
    window (``PROCS`` x ``shards`` rank slices of the gathered window,
    each deduplicated, onto the window's table)."""
    rng = np.random.default_rng(161)
    dev, d = model.device, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    n_hot, state = model.table.n_hot, model.table.state
    h_slots = model.transfer._pad_batch(_step_inputs(model, batch,
                                                     rng)[0])[0]
    hot = ((h_slots >= 0) & (h_slots < n_hot)).contiguous()
    grad = torch.as_tensor(rng.normal(size=(n_hot, d)).astype(np.float32)
                           * 1e-2, device=dev)
    inv = 1.0 / torch.as_tensor(rng.integers(1, 800, n_hot)
                                .astype(np.float32), device=dev)
    init, wins = _window_data(q_spec, PROCS)
    slices = np.concatenate([w[0].ravel() for w in wins]).reshape(
        PROCS * shards, -1)
    ded = np.full_like(slices, -1)
    for row, s in zip(ded, slices):
        u, first = np.unique(s, return_index=True)
        row[first] = u
    return [
        _scatter_case("data axis, hybrid@4 hot push of one process's h "
                      "rows", DA_PATH, h_slots, hot, n_hot, d, rng, flush),
        _adagrad_case("data axis, hybrid@4 hot plane after the processes' "
                      "sum, * 1/counts", DA_PATH, state["h@hot"].clone(),
                      state["h2sum@hot"].clone(), grad,
                      model.access.learning_rate, flush, mul=inv),
        _ef_bank_case("data axis, EF bank of tpu@4's int8 window", DA_PATH,
                      torch.from_numpy(ded).to(dev), init["h"].shape[0], d,
                      rng, flush)]


def phase_data_axis(vocab, corpus: np.ndarray, card: str,
                    sents: int = PROC_SENTS, shards: int = PROC_SHARDS,
                    lr_shape: str = "a9a", glove_corpus=None) -> tuple:
    """Phase 16: every hook the JAX package runs across processes, in one
    launch of ``PROCS`` processes on the card at phase 14's reference
    configuration: (a) ``hybrid`` with ``shards`` ranks a process and its
    hot head, ``collective: sparse_allreduce`` and ``push_window: 4``
    armed (``train`` fuses no group across processes, as JAX's does not,
    so every push is the per-step hot psum); (b) ``xla`` with ``pull_quant:
    bf16``, ``pull_cache: 8`` and ``[serve] every: 8``; (c) ``tpu`` with
    ``push_window: 4, wire_quant: int8`` against the ``push_window: 1``
    one-process run, and transfer-level window pushes on ``tpu`` (int8)
    and ``hybrid`` (``collective: sparse_allreduce``) against a
    one-process push over the concatenated windows; (d) LR at ``lr_shape``
    and GloVe at phase 8's shape, on ``xla`` and ``tpu``; (e) sent2vec over
    (a)'s trained model against one process's sent2vec over the same
    table.  Returns the B5 case of (a)'s hot plane and the launches."""
    t0 = time.perf_counter()
    out = WORK / "phase16"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    prefix = np.ascontiguousarray(corpus[:sents])
    probe = _model("gather", vocab, "cpu")
    Bl = BATCH // PROCS
    epochs = lockstep_epochs(vocab, prefix, probe.window, probe.sample, Bl,
                             PROCS, DA_ITERS)
    steps = sum(len(e) for e in epochs)
    d, K = probe.len_vec, probe.negative
    del probe
    rng = np.random.default_rng(16)
    data = {"corpus": prefix, "vocab_keys": vocab.keys,
            "vocab_counts": vocab.counts}
    draws_cat, per_rank = [], [([], []) for _ in range(PROCS)]
    for _ in range(steps):
        js, us = [], []
        for r in range(PROCS):
            j = rng.integers(0, len(vocab), (Bl, K))
            u = rng.random(j.shape, np.float32)
            per_rank[r][0].append(j)
            per_rank[r][1].append(u)
            js.append(j)
            us.append(u)
        draws_cat.append((torch.from_numpy(np.concatenate(js)).to(DEVICE),
                          torch.from_numpy(np.concatenate(us)).to(DEVICE)))
    for r in range(PROCS):
        data[f"j{r}"] = np.stack(per_rank[r][0])
        data[f"u{r}"] = np.stack(per_rank[r][1])
    np.savez(out / "w2v.npz", **data)
    n_hot = HotColdPartition.from_counts(
        vocab.keys, vocab.counts,
        batch_rows=DEMO_CONF["worker"]["minibatch"]).n_hot
    cuda = DEVICE == "cuda"

    def w2v(name, cluster, sections=None, shapes=()):
        conf = {**DEMO_CONF, **(sections or {}),
                "cluster": {**DEMO_CONF["cluster"], **cluster}}
        return conf, {"conf": conf, "data": str(out / "w2v.npz"),
                      "device": DEVICE, "batch_size": Bl,
                      "niters": DA_ITERS, "out": str(out / name),
                      "state": True,
                      "time_shapes": list(shapes) if cuda else []}
    hyb = {"transfer": "hybrid", "server_num": shards}
    tpu = {"transfer": "tpu", "server_num": shards}
    a_conf, a_spec = w2v("hybrid", {**hyb, "push_window": 4,
                                    "collective": "sparse_allreduce"},
                         shapes=[("hot_plane", (n_hot, d + 1))])
    b_conf, b_spec = w2v("xla_pull_serve", {"pull_quant": "bf16",
                                            "pull_cache": 8},
                         {"serve": {"every": 8}},
                         shapes=[("dense_plane", (len(vocab) * 13 // 10,
                                                  d + 1))])
    c_conf, c_spec = w2v("tpu_w4q", {**tpu, "push_window": 4,
                                     "wire_quant": "int8"},
                         {"worker": {**DEMO_CONF["worker"],
                                     "inner_steps": 4}})
    # the table's rows split over the shards of one process and over the
    # one-process reference's PROCS x as many
    rows = PROCS * shards * (len(vocab) * 13 // (10 * PROCS * shards) + 1)

    def window(name, cluster, knobs, **gen):
        spec = {"job": "window", "device": DEVICE, "out": str(out / name),
                "conf": {"cluster": cluster}, "knobs": knobs,
                "reference": True, "lr": 0.7,
                "gen": {"rows": rows, "d": d, "W": DA_WINDOW,
                        "B": DA_WIN_ROWS, "seed": len(name), **gen},
                "time_shapes": [("ef_window", (DA_WINDOW * DA_WIN_ROWS,
                                               1 + 2 * d))] if cuda else []}
        # the plan prices the window's distinct rows, as a model's
        # window_expected_unique does from its vocab's counts
        wins = _window_data(spec, PROCS)[1]
        slots = np.concatenate([w[0].ravel() for w in wins])
        knobs["window_expected_unique"] = float(
            np.unique(slots[slots >= 0]).size)
        return spec
    lr_spec, lr_mb, lr_cap = SHAPES[lr_shape]
    lr_path = out / "lr.svm"
    with open(lr_path, "w") as f:
        for y, feats in synthetic_dataset(**lr_spec):
            f.write(f"{int(y)} " + " ".join(f"{k}:{v!r}" for k, v in feats)
                    + "\n")
    from swiftmpi_tpu_torch.apps.glove_profile import (GLOVE_CONF,
                                                       GLOVE_CORPUS)
    g_corpus = (synthetic_corpus(**GLOVE_CORPUS) if glove_corpus is None
                else glove_corpus)
    np.savez(out / "glove.npz", corpus=np.asarray(g_corpus, np.int64))
    from swiftmpi_tpu_torch.apps.lr_profile import LR_CONF

    def lr_conf(n):
        c = {**LR_CONF, "worker": {"minibatch": lr_mb}}
        return ({**c, "cluster": {"transfer": "tpu", "server_num": n}}
                if n else c), (-(-lr_cap // n) if n else lr_cap)

    def glove_conf(n):
        c = {**GLOVE_CONF, "worker": {"inner_steps": 8, "pipeline": 4}}
        return ({**c, "cluster": {"transfer": "tpu", "server_num": n}}
                if n else c)
    q_spec = window("win_tpu_q", tpu, {"wire_quant": "int8"}, ef=True)
    specs = [a_spec,
             {"job": "s2v", "over": "previous", "device": DEVICE,
              "data": str(out / "s2v.npz"), "niters": S2V_NITERS,
              "out": str(out / "s2v")},
             b_spec, c_spec,
             q_spec,
             window("win_hybrid_sar", hyb,
                    {"collective_mode": "sparse_allreduce"}, n_hot=n_hot)]
    for n in (0, shards):
        conf, cap = lr_conf(n)
        specs.append({"job": "lr", "conf": conf, "device": DEVICE,
                      "capacity_per_shard": cap, "dataset": str(lr_path),
                      "niters": DA_LR_ITERS,
                      "out": str(out / f"lr@{n or 1}")})
        specs.append({"job": "glove", "conf": glove_conf(n),
                      "device": DEVICE, "data": str(out / "glove.npz"),
                      "niters": DA_GLOVE_ITERS,
                      "out": str(out / f"glove@{n or 1}")})
    lines, _ = _s2v_lines(vocab.keys)
    np.savez(out / "s2v.npz", lines=np.array(lines))
    print(f"phase 16 set-up {time.perf_counter() - t0:.1f} s ({steps} "
          f"steps of {PROCS} x {Bl} centers, {n_hot} hot keys, "
          f"{len(specs)} jobs)", flush=True)

    got, stdout, wall = _da_launch(specs, out)
    print(f"phase 16 launch {wall:.1f} s", flush=True)
    launches = {k: 0 for k in ("gather", "scatter", "adagrad", "stencil",
                               "ring", "ring_process")}
    runs = {}
    for name, (per_proc, _) in got.items():
        _da_replicas(name, per_proc)
        for k, v in per_proc[0]["launches"].items():
            launches[k] += v
    # (a), (b), (c): each against the one-process run over the global
    # batches (c: its push_window 1 run)
    for name, conf in (("hybrid", a_conf), ("xla_pull_serve", b_conf),
                       ("tpu_w4q", {**DEMO_CONF, "cluster": tpu})):
        per_proc, arrays = got[name]
        ref, first, losses = _da_ref_w2v(conf, vocab, epochs, draws_cat)
        _da_losses(name, per_proc, losses)
        gap = {}
        for f, v in ref.table.state.items():
            gap[f] = _field_gap(f"phase 16 {name}: field {f} after the "
                                "first step",
                                torch.from_numpy(arrays["w2v_first_step"][f]),
                                torch.from_numpy(first[f]))
        m = per_proc[0]["metrics"]
        rec = {"phase": "data_axis", "card": card, "job": name,
               "processes": PROCS, "steps": m["steps"],
               "global_words_per_sec": m["words_per_sec"],
               "one_process_words_per_sec":
                   ref.train_metrics["words_per_sec"],
               "losses": per_proc[0]["losses"],
               "one_process_losses": losses, "first_step_gap": gap,
               "final_gap": _final_gap(arrays["w2v_state"], ref)
               if name != "tpu_w4q" else None,
               "push_paths": m["push_paths"],
               "launches": per_proc[0]["launches"]}
        if name == "hybrid":
            if not int(ref.table.n_hot) == n_hot \
                    or not any(k.endswith(":hot") for k in m["push_paths"]):
                raise AssertionError(f"phase 16 hybrid: no hot head ran: "
                                     f"{m['push_paths']}")
            hybrid_ref = ref
        if name == "xla_pull_serve":
            serve = [g["serve"] for g in per_proc]
            if not all(s["equal"] for s in serve) or serve[0] != serve[1]:
                raise AssertionError(f"phase 16 {name}: snapshots {serve}")
            rec["serve"] = serve[0]
        if name == "tpu_w4q":
            ef = per_proc[0]["ef_nonzero"]
            if sorted(ef) != ["h@ef", "v@ef"] or any(ef.values()) \
                    or m["fused"]:
                raise AssertionError(f"phase 16 {name}: the @ef planes "
                                     f"{ef}, fused {m['fused']}")
            rec["ef_nonzero"] = ef
        _json_line(rec)
        _da_exchanges(name, per_proc, card)
        runs[name] = rec
        if name != "hybrid":
            del ref
    # (e) sent2vec over (a)'s trained replica, against one process's
    per_proc, arrays = got["s2v"]
    for f, v in got["hybrid"][1]["w2v_state"].items():
        rows = torch.from_numpy(v)
        if "@hot" in f:
            hybrid_ref.table.state[f].copy_(rows.to(DEVICE))
        else:
            hybrid_ref.table.assign(f, rows)
    s2v = Sent2Vec(hybrid_ref)
    t1 = time.perf_counter()
    want = s2v.infer_sentences(lines, niters=S2V_NITERS)
    one_s = time.perf_counter() - t1
    vecs = arrays["s2v_state"]
    gap = _da_gap("s2v", {"vectors": vecs["vectors"]},
                  {"vectors": np.stack([v for _, v in want])})
    rec = {"phase": "data_axis", "card": card, "job": "s2v",
           "sentences": per_proc[0]["sentences"],
           "sents_per_sec": per_proc[0]["sentences"]
           / per_proc[0]["seconds"],
           "one_process_sents_per_sec": len(want) / one_s, "gap": gap,
           "launches": per_proc[0]["launches"]}
    _json_line(rec)
    runs["s2v"] = rec
    cases = (_da_kernel_cases(hybrid_ref, epochs[0][0][0], q_spec, shards)
             if cuda else [])
    del hybrid_ref, s2v
    # (c) the transfer-level windows: the child held each against the
    # one-process push over the concatenated windows
    for name in ("win_tpu_q", "win_hybrid_sar"):
        per_proc, _ = got[name]
        g = per_proc[0]
        for f, v in g["reference_gap"].items():
            if "_q" in name:
                ok = v["share_outside_envelope"] <= LOSSY_SHARE
            elif "@hot" in f:
                ok = (v["share_outside_envelope"] <= DA_SUM_ORDER_SHARE
                      and v["max_gap_outside_envelope"] <= DA_SUM_ORDER_GAP)
            else:
                ok = v["share_outside_envelope"] == 0
            if not ok:
                raise AssertionError(f"phase 16 {name}: field {f}: {v}")
        tr = g["traffic"]
        rec = {"phase": "data_axis", "card": card, "job": name,
               "rows": PROCS * DA_WINDOW * DA_WIN_ROWS,
               "ms": 1e3 * g["seconds"],
               "global_rows_per_sec": PROCS * DA_WINDOW * DA_WIN_ROWS
               / g["seconds"], "reference_gap": g["reference_gap"],
               "psum_bytes": tr["psum_bytes"],
               "decisions": {k: tr[k] for k in (
                   "window_fmt_q", "window_fmt_sparse", "window_fmt_dense",
                   "collective_sparse_ar", "collective_psum")},
               "launches": g["launches"]}
        if ("_q" in name and not tr["window_fmt_q"]) or (
                "sar" in name and not tr["collective_sparse_ar"]):
            raise AssertionError(f"phase 16 {name}: the plan did not take "
                                 f"its rung: {rec['decisions']}")
        _json_line(rec)
        _da_exchanges(name, per_proc, card)
        runs[name] = rec
    # (d) LR and GloVe against their one-process runs
    for n in (0, shards):
        conf, cap = lr_conf(n)
        one = LogisticRegression(config=ConfigParser().update(conf),
                                 capacity_per_shard=cap, device=DEVICE)
        losses = one.train(str(lr_path), niters=DA_LR_ITERS)
        per_proc, arrays = got[f"lr@{n or 1}"]
        _da_losses(f"lr@{n or 1}", per_proc, losses)
        keyed = arrays["lr_state"]
        want = _rows_by_key(one.table, keyed["keys"])
        rec = {"phase": "data_axis", "card": card, "job": f"lr@{n or 1}",
               "records_per_sec": per_proc[0]["metrics"]["records_per_sec"],
               "one_process_records_per_sec":
                   one.train_metrics["records_per_sec"],
               "losses": per_proc[0]["losses"], "one_process_losses": losses,
               "final_gap": _da_gap(f"lr@{n or 1}", keyed, want),
               "launches": per_proc[0]["launches"]}
        _json_line(rec)
        runs[rec["job"]] = rec
        del one
        g1 = GloVe(config=ConfigParser().update(glove_conf(n)),
                   device=DEVICE).build(g_corpus)
        losses = g1.train(niters=DA_GLOVE_ITERS)
        per_proc, arrays = got[f"glove@{n or 1}"]
        _da_losses(f"glove@{n or 1}", per_proc, losses)
        keyed = arrays["glove_state"]
        want = _rows_by_key(g1.table, keyed["keys"])
        rec = {"phase": "data_axis", "card": card,
               "job": f"glove@{n or 1}",
               "cells_per_sec": per_proc[0]["metrics"]["cells_per_sec"],
               "one_process_cells_per_sec": g1.train_metrics[
                   "cells_per_sec"],
               "losses": per_proc[0]["losses"], "one_process_losses": losses,
               "final_gap": _da_gap(f"glove@{n or 1}", keyed, want),
               "launches": per_proc[0]["launches"]}
        _json_line(rec)
        runs[rec["job"]] = rec
        del g1
        torch.cuda.empty_cache() if cuda else None
    missing = [k for k in DA_KERNELS if not launches[k]]
    if missing and cuda:
        raise AssertionError(f"phase 16: {missing} never launched: "
                             f"{launches}")
    _json_line({"phase": "data_axis", "card": card, "launches": launches,
                "launch_wall_s": wall})
    hot = got["hybrid"][0][0].get("exchange", [])
    if not hot:
        if cuda:
            raise AssertionError("phase 16: the hybrid run timed no "
                                 "exchange")
        print(f"phase 16 {time.perf_counter() - t0:.1f} s", flush=True)
        return cases, {DA_PATH: launches}
    e = hot[0]
    cases.append({"name": "ring_exchange (across processes, all-gather of the "
                    "hybrid hot plane)",
            "route": "cuda", "source": "swiftmpi_tpu_torch/kernels/csrc/"
                                       "ring.cu",
            "replaces": "swiftmpi_tpu/ops/pallas_ring.py:86",
            "module": ring, "counter": "ring_process", "path": DA_PATH,
            "shape": e["shape"], "max_abs_err": e["max_abs_err"],
            "tolerance": "bit for bit (a copy)", "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bytes": e["bytes"], "flops": 0,
            "library": "none: NCCL runs no two ranks on one card; the host "
                       "route's ms is on the data_axis line",
            "library_ms": None})
    report_cases(cases)
    print(f"phase 16 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, {DA_PATH: launches}


# -- phase 17: the transformer family ----------------------------------------

#: bench.py's transformer cell (``bench.py:1993-2027``): ~21.0 M
#: parameters in bf16, one AdamW step a batch of 64 x 512 tokens
TFM_WIDTH = dict(vocab_size=8192, d_model=512, n_heads=8, d_ff=2048,
                 max_seq=512)
TFM_LAYERS, TFM_BATCH, TFM_SEQ, TFM_LR = 4, 64, 512, 1e-3
TFM_TIMED = 5
#: (a)'s float32 step on the card against the CPU port: 2 layers of the
#: full width, 4 sequences, two steps (warmup 1: the second has the peak
#: rate); AdamW's m / sqrt(v) may move a param whose gradient is noise
#: by up to the rate, so a leaf's share outside the envelope is bounded
TFM_PARITY_LAYERS, TFM_PARITY_BATCH = 2, 4
TFM_OUTSIDE_SHARE = 1e-3
#: (b), (c): seq = 4 ranks at full width, 2 layers, 8 sequences, float32
TFM_SEQ_RANKS, TFM_CP_LAYERS, TFM_CP_BATCH = 4, 2, 8
#: JAX's own tolerance for the context-parallel variants
TFM_CP_TOL = dict(rtol=2e-4, atol=2e-5)
#: (d): 8 experts over expert = 4 at d 512, d_ff 2048, 16 x 512 tokens,
#: capacity factor 8 (no token drops: C = 4,096 >= a rank's 2,048)
MOE_EXPERTS, MOE_RANKS, MOE_TOKENS, MOE_K, MOE_CF = 8, 4, 16 * 512, 2, 8.0
#: (e): stage = 4 (one block a stage), 8 microbatches of 2 sequences
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH = 4, 8, 16
#: published H100 SXM dense bf16 tensor-core peak
PEAK_BF16_FLOPS = 989e12
TFM_ULYSSES, TFM_RING, TFM_MOE = "tfm:ulysses", "tfm:ring", "tfm:moe"


def _tfm_cfg(layers: int, dtype, **kw):
    from swiftmpi_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(n_layers=layers, dtype=dtype, **TFM_WIDTH, **kw)


def _tfm_tokens(rng, batch: int, seq: int = TFM_SEQ) -> np.ndarray:
    return rng.integers(0, TFM_WIDTH["vocab_size"],
                        (batch, seq)).astype(np.int32)


def _outside_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of elements outside |a - b| <= 1e-5 + 1e-3 |b|."""
    a, b = got.detach().double().cpu(), want.detach().double().cpu()
    return float(((a - b).abs() > 1e-5 + 1e-3 * b.abs()).double().mean())


def _close(what: str, got: torch.Tensor, want: torch.Tensor, rtol, atol):
    a, b = got.detach().double().cpu(), want.detach().double().cpu()
    bad = (a - b).abs() > atol + rtol * b.abs()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {b.numel()} elements outside "
            f"rtol {rtol}, atol {atol} (max |diff| "
            f"{float((a - b).abs().max()):.3g})")
    return float((a - b).abs().max())


def _tfm_flops(n_params: int, layers: int, seq: int, tokens: int) -> float:
    """bench.py's training FLOP model: 6 P + 12 L S d a token."""
    return (6.0 * n_params + 12.0 * layers * seq
            * TFM_WIDTH["d_model"]) * tokens


def phase_tfm_trainer(card: str) -> None:
    """(a): the float32 step on the card against the CPU port at 2 layers,
    then bench.py's cell in bf16: 1 warm step, TFM_TIMED timed steps, one
    profiled step."""
    from swiftmpi_tpu_torch.apps.w2v_profile import _device_busy
    from swiftmpi_tpu_torch.models.trainer import Trainer
    from swiftmpi_tpu_torch.utils import tree
    rng = np.random.default_rng(17)
    cfg = _tfm_cfg(TFM_PARITY_LAYERS, torch.float32)
    toks = [_tfm_tokens(rng, TFM_PARITY_BATCH) for _ in range(2)]
    runs = {}
    for dev in (DEVICE, "cpu"):
        tr = Trainer(cfg, device=dev, learning_rate=TFM_LR, warmup_steps=1)
        state = tr.init_state(0)
        losses = [float(tr.step(state, t)[1]) for t in toks]
        runs[dev] = (losses, tree.leaves(state.tree()))
    (lc, fc), (lh, fh) = runs[DEVICE], runs["cpu"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    if gap > 1e-4:
        raise AssertionError(f"tfm (a): card losses {lc} vs CPU {lh}")
    worst = max(_outside_share(a, b) for a, b in zip(fc, fh)
                if b.dtype != torch.int32)
    if worst > TFM_OUTSIDE_SHARE:
        raise AssertionError(f"tfm (a): a leaf has {worst:.3g} of its "
                             "elements outside the envelope")
    _json_line({"tfm_parity": "trainer 2 steps, card vs CPU, float32",
                "layers": TFM_PARITY_LAYERS, "batch": TFM_PARITY_BATCH,
                "losses": lc, "loss_rel_gap": gap,
                "worst_leaf_share_outside": worst})
    del runs

    cfg = _tfm_cfg(TFM_LAYERS, torch.bfloat16)
    tr = Trainer(cfg, device=DEVICE, learning_rate=TFM_LR)
    state = tr.init_state(0)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    host = [_tfm_tokens(rng, TFM_BATCH) for _ in range(TFM_TIMED + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the steps as a user runs them: host batches through run()'s
    # prefetching producer and its copies to the card; the warm step
    # pays for the pinned buffers' first allocation
    state, _ = tr.run(state, host[:1], pipeline=2)
    torch.cuda.synchronize()
    host = host[1:]
    batch = torch.from_numpy(host[0]).to(DEVICE)
    t0 = time.perf_counter()
    state, losses = tr.run(state, host, pipeline=2)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TFM_TIMED
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if len(losses) != TFM_TIMED or not all(map(math.isfinite, losses)) \
            or tr.pipeline_stats["consumed"] != TFM_TIMED:
        raise AssertionError(f"tfm (a): losses {losses}, pipeline "
                             f"{tr.pipeline_stats}")
    tokens = TFM_BATCH * (TFM_SEQ - 1)
    flops = _tfm_flops(n_params, TFM_LAYERS, TFM_SEQ - 1, tokens)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tr.step(state, batch)
        torch.cuda.synchronize()
    busy_ms, busy = _device_busy(prof)
    top = dict(list(busy.items())[:8])
    _json_line({"tfm_train": card, "params": n_params, "dtype": "bfloat16",
                "batch": TFM_BATCH, "seq": TFM_SEQ, "tokens_a_step": tokens,
                "step_ms": dt * 1e3, "tokens_per_s": tokens / dt,
                "peak_memory_bytes": peak, "flops_a_step": flops,
                "tflop_per_s": flops / dt / 1e12,
                "bf16_peak_share": flops / dt / PEAK_BF16_FLOPS,
                "losses": losses,
                "device_busy_ms": busy_ms,
                "device_idle_share": 1 - busy_ms / (dt * 1e3),
                "busy_ms_by_kind": _kernel_kinds(busy),
                "launches_a_step": _kernel_launches(prof),
                "top_kernels_ms": top})
    with open(WORK / "phase17_kernels.json", "w") as f:
        json.dump(busy, f, indent=1)
    del state, tr


def _kernel_kinds(busy: dict) -> dict:
    """Device ms of a profiled step by kind of kernel: the products on the
    tensor cores (bf16), the float32 products on the CUDA cores, the
    softmax kernels, the other elementwise passes and copies, the
    reductions, and the rest."""
    out = {}
    for name, ms in busy.items():
        low = name.lower()
        if "f32f32" in low or "sgemm" in low or "ffma" in low:
            kind = "products_f32"
        elif any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma")):
            kind = "products_bf16"
        elif "softmax" in low:
            kind = "softmax"
        elif "reduce" in low:
            kind = "reductions"
        elif "elementwise" in low or "copy" in low:
            kind = "elementwise"
        else:
            kind = "other"
        out[kind] = out.get(kind, 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _kernel_launches(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def _lm_grads(params, toks, cfg, mesh=None):
    """The logits of a forward pass (its launches: ``fwd``) and lm_loss
    with its grads (a training step's forward and backward: ``both``)."""
    from swiftmpi_tpu_torch.models.transformer import (forward, lm_loss,
                                                       value_and_grad)
    from swiftmpi_tpu_torch.utils import tree
    kernels.reset_launches()
    with torch.no_grad():
        logits, _ = forward(params, toks[:, :-1], cfg, mesh)
    fwd = kernels.launch_counts()
    kernels.reset_launches()
    loss, grads = value_and_grad(lm_loss, params, toks, cfg, mesh)
    torch.cuda.synchronize()
    both = kernels.launch_counts()
    return logits, loss, tree.leaves(grads), fwd, both


def phase_tfm_seq() -> dict:
    """(b), (c): Ulysses and ring over seq = 4 at full width in float32:
    logits and every lm_loss gradient against full attention's within
    JAX's tolerance; B5 must launch for Ulysses, forward and backward."""
    import dataclasses
    from swiftmpi_tpu_torch.cluster.mesh import Mesh
    from swiftmpi_tpu_torch.models.transformer import init_params
    rng = np.random.default_rng(171)
    cfg = _tfm_cfg(TFM_CP_LAYERS, torch.float32)
    params = init_params(1, cfg, DEVICE)
    # S + 1 tokens: lm_loss trains on S positions, which split over 4
    toks = torch.from_numpy(_tfm_tokens(rng, TFM_CP_BATCH,
                                        TFM_SEQ + 1)).to(DEVICE)
    want_logits, want_loss, want_grads, _, _ = _lm_grads(params, toks, cfg)
    mesh = Mesh({"seq": TFM_SEQ_RANKS}, DEVICE)
    counts = {}
    for mode, path in (("ulysses", TFM_ULYSSES), ("ring", TFM_RING)):
        c = dataclasses.replace(cfg, attention=mode)
        t0 = time.perf_counter()
        logits, loss, grads, fwd, both = _lm_grads(params, toks, c, mesh)
        secs = time.perf_counter() - t0
        err = _close(f"tfm {mode} logits", logits, want_logits, **TFM_CP_TOL)
        gerr = max(_close(f"tfm {mode} grad leaf {i}", g, w, **TFM_CP_TOL)
                   for i, (g, w) in enumerate(zip(grads, want_grads)))
        want_ring = 4 * TFM_CP_LAYERS if mode == "ulysses" else 0
        if fwd["ring"] != want_ring or both["ring"] != 2 * fwd["ring"]:
            raise AssertionError(
                f"tfm {mode}: B5 launched {fwd['ring']} times forward and "
                f"{both['ring'] - fwd['ring']} backward, expected "
                f"{want_ring} each (q, k, v and the output a layer)")
        if ring.timeouts():
            raise AssertionError(f"tfm {mode}: a ring wait timed out")
        counts[path] = both
        _json_line({"tfm_seq": mode, "ranks": TFM_SEQ_RANKS,
                    "layers": TFM_CP_LAYERS, "batch": TFM_CP_BATCH,
                    "max_abs_err_logits": err, "max_abs_err_grads": gerr,
                    "loss": float(loss), "loss_full": float(want_loss),
                    "b5_forward": fwd["ring"],
                    "b5_backward": both["ring"] - fwd["ring"],
                    "fwd_and_grad_s": secs})
    return counts


def phase_tfm_moe() -> dict:
    """(d): expert-parallel MoE (8 experts over expert = 4) at d 512,
    d_ff 2048 and 16 x 512 tokens against the dense reference, output,
    aux and gradients; B5 must launch forward and backward."""
    from swiftmpi_tpu_torch.cluster.mesh import Mesh
    from swiftmpi_tpu_torch.parallel.moe import (init_moe_params, moe_ffn,
                                                 moe_ffn_reference)
    d, dff = TFM_WIDTH["d_model"], TFM_WIDTH["d_ff"]
    gen = torch.Generator().manual_seed(172)
    params = init_moe_params(gen, d, dff, MOE_EXPERTS, device=DEVICE)
    x = torch.randn((MOE_TOKENS, d), generator=gen).to(DEVICE)
    w = torch.randn((MOE_TOKENS, d), generator=gen).to(DEVICE) / MOE_TOKENS

    def run(fn):
        ps = [p.detach().requires_grad_(True) for p in params]
        xs = x.detach().requires_grad_(True)
        kernels.reset_launches()
        y, aux = fn(type(params)(*ps), xs)
        fwd = kernels.launch_counts()["ring"]
        ((y * w).sum() + aux).backward()
        torch.cuda.synchronize()
        return (y.detach(), aux.detach(), [p.grad for p in ps] + [xs.grad],
                fwd, kernels.launch_counts())

    mesh = Mesh({"expert": MOE_RANKS}, DEVICE)
    t0 = time.perf_counter()
    y, aux, grads, fwd, both = run(lambda p, x: moe_ffn(
        p, x, mesh, k=MOE_K, capacity_factor=MOE_CF))
    secs = time.perf_counter() - t0
    y_ref, aux_ref, grads_ref, _, _ = run(
        lambda p, x: moe_ffn_reference(p, x, k=MOE_K))
    err = _close("tfm moe output", y, y_ref, **TFM_CP_TOL)
    if abs(float(aux) - float(aux_ref)) > 1e-5 * abs(float(aux_ref)):
        raise AssertionError(f"tfm moe: aux {float(aux)} vs reference "
                             f"{float(aux_ref)}")
    gerr = max(_close(f"tfm moe grad {i}", g, r, 1e-3, 1e-5)
               for i, (g, r) in enumerate(zip(grads, grads_ref)))
    if fwd != 2 or both["ring"] != 4:
        raise AssertionError(f"tfm moe: B5 launched {fwd} times forward and "
                             f"{both['ring'] - fwd} backward, expected 2 "
                             "each (dispatch and return)")
    if ring.timeouts():
        raise AssertionError("tfm moe: a ring wait timed out")
    t_local = MOE_TOKENS // MOE_RANKS
    _json_line({"tfm_moe": f"{MOE_EXPERTS} experts over expert = "
                f"{MOE_RANKS}", "tokens": MOE_TOKENS, "d": d, "d_ff": dff,
                "capacity": math.ceil(t_local * MOE_K / MOE_EXPERTS
                                      * MOE_CF),
                "max_abs_err": err, "max_abs_err_grads": gerr,
                "aux": float(aux), "b5_forward": fwd,
                "b5_backward": both["ring"] - fwd, "fwd_and_grad_s": secs})
    return {TFM_MOE: both}


def phase_tfm_pipeline() -> None:
    """(e): the trunk as a GPipe pipeline over stage = 4, 8 microbatches,
    against the plain forward, float32."""
    from swiftmpi_tpu_torch.cluster.mesh import Mesh
    from swiftmpi_tpu_torch.models.transformer import (forward,
                                                       forward_pipelined,
                                                       init_params)
    rng = np.random.default_rng(173)
    cfg = _tfm_cfg(PIPE_STAGES, torch.float32)
    params = init_params(2, cfg, DEVICE)
    toks = torch.from_numpy(_tfm_tokens(rng, PIPE_BATCH)).to(DEVICE)
    with torch.no_grad():
        want, _ = forward(params, toks, cfg)
        t0 = time.perf_counter()
        got, _ = forward_pipelined(params, toks, cfg,
                                   Mesh({"stage": PIPE_STAGES}, DEVICE),
                                   num_microbatches=PIPE_MICRO)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    # the microbatches' products run at other shapes than the whole
    # batch's, so the card sums them in another order: (b)'s tolerance
    err = _close("tfm pipeline logits", got, want, **TFM_CP_TOL)
    _json_line({"tfm_pipeline": f"stage = {PIPE_STAGES}",
                "microbatches": PIPE_MICRO, "batch": PIPE_BATCH,
                "max_abs_err": err, "forward_s": secs})


def phase_transformer(card: str) -> tuple:
    """Phase 17: the transformer family.  Returns B5's cases at (b)'s and
    (d)'s exchange shapes and the launches of (b), (c) and (d)."""
    t0 = time.perf_counter()
    WORK.mkdir(parents=True, exist_ok=True)
    phase_tfm_trainer(card)
    counts = phase_tfm_seq()
    counts.update(phase_tfm_moe())
    phase_tfm_pipeline()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(174)
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=DEVICE)
    n, H, D = TFM_SEQ_RANKS, TFM_WIDTH["n_heads"], 64
    E, d = MOE_EXPERTS, TFM_WIDTH["d_model"]
    cap = math.ceil(MOE_TOKENS // MOE_RANKS * MOE_K / E * MOE_CF)
    # Ulysses' q, k, v and output exchanges: (n, n, B, S/n, H/n, D)
    ulysses = (TFM_CP_BATCH, TFM_SEQ // n, H // n, D)
    cases = [
        _ring_case("ulysses q, k, v, out", ulysses, torch.float32, rng,
                   flush, DEVICE, path=TFM_ULYSSES, n=n),
        _ring_case("ulysses q, k, v, out, bf16", ulysses, torch.bfloat16,
                   rng, flush, DEVICE, path=TFM_ULYSSES, n=n),
        # MoE's dispatch and return: (n, n, E/n, C, d)
        _ring_case("moe expert buffers", (E // MOE_RANKS, cap, d),
                   torch.float32, rng, flush, DEVICE, path=TFM_MOE,
                   n=MOE_RANKS)]
    del flush
    report_cases(cases)
    print(f"phase 17 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, counts


# -- phase 18: the trainer across processes, data_plane, the verdicts --------

#: (a) bench.py's cell across PROCS processes: 1 warm step and 3 timed
#: bf16 steps of 64 x 512 global tokens (32 x 512 a process)
DP_BF16_STEPS, DP_WARM = 4, 1
#: (a)'s float32 twin: full width, 2 layers, 8 x 512 global tokens
DP_F32_LAYERS, DP_F32_BATCH, DP_F32_STEPS = 2, 8, 2
#: the trainer's bf16 tolerance on a loss (tests/test_torch_trainer.py)
DP_BF16_LOSS_RTOL = 2e-3
#: (b) a small MoE model: 4 experts (top 2) over expert = 2 in each
#: process, capacity factor 4 (no token dropped on either side), float32
DP_MOE = dict(vocab_size=8192, d_model=256, n_heads=4, d_ff=512,
              n_layers=2, max_seq=128, n_experts=4,
              moe_capacity_factor=4.0)
DP_MOE_RANKS, DP_MOE_BATCH, DP_MOE_SEQ, DP_MOE_STEPS = 2, 8, 128, 2
DP_PATH, DP_MOE_PATH = "tfm@dp2", "tfm_moe@dp2"
#: (c) word2vec's data_plane runs: the corpus prefix and the labels
DPL_SENTS = 200
DPL_TPU, DPL_STENCIL = f"w2v:tpu@{SHARDS}", "w2v:stencil"


def _dp_spec(label: str, cfg: dict, tokens: np.ndarray,
             phase: str = "phase18", **extra) -> dict:
    out = WORK / phase / label
    shutil.rmtree(out, ignore_errors=True)
    np.savez(WORK / phase / f"{label}.npz", tokens=tokens)
    return {"job": "trainer", "cfg": cfg, "device": DEVICE,
            "data": str(WORK / phase / f"{label}.npz"),
            "out": str(out), "checkpoint": str(out / "ck"), **extra}


def _dp_one_process(spec: dict, tokens: np.ndarray):
    """The one-process run over the same global batches on the card:
    the losses and the final state."""
    from swiftmpi_tpu_torch.cluster.mesh import Mesh
    from swiftmpi_tpu_torch.models.trainer import Trainer
    from swiftmpi_tpu_torch.testing.mp_child import trainer_config
    mesh = Mesh(spec["mesh"], DEVICE) if spec.get("mesh") else None
    tr = Trainer(trainer_config(spec), mesh=mesh,
                 device=None if mesh else DEVICE, **spec.get("opt", {}))
    state = tr.init_state(spec.get("seed", 0))
    losses = [float(tr.step(state, t)[1]) for t in tokens]
    return losses, state


def _dp_hold(label: str, got: list, spec: dict, tokens: np.ndarray,
             rtol: float, leaves: bool, phase: str = "phase 18") -> dict:
    """Replicas equal by sha256 on every leaf; the losses against one
    process's within ``rtol`` (plus 1e-5); with ``leaves``, process 0's
    checkpoint leaf by leaf within the envelope of one process's, AdamW
    allowed TFM_OUTSIDE_SHARE outside; the checkpoint loaded in one
    process holds the replicas' bits and steps on as a second load
    does."""
    from swiftmpi_tpu_torch.models.trainer import Trainer, leaf_from_numpy
    from swiftmpi_tpu_torch.testing.mp_child import _leaf_bits, trainer_config
    from swiftmpi_tpu_torch.utils import tree
    a = got[0]
    if any(g["leaf_sha"] != a["leaf_sha"] or g["losses"] != a["losses"]
           for g in got):
        raise AssertionError(f"{phase} {label}: the replicas differ")
    if any(g["timeouts"] for g in got):
        raise AssertionError(f"{phase} {label}: a ring wait timed out")
    ref_losses, ref = _dp_one_process(spec, tokens)
    gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], ref_losses))
    for x, y in zip(a["losses"], ref_losses):
        if abs(x - y) > 1e-5 + rtol * abs(y):
            raise AssertionError(f"{phase} {label}: losses {a['losses']} "
                                 f"vs one process's {ref_losses}")
    out = {"losses": a["losses"], "one_process_losses": ref_losses,
           "loss_rel_gap": gap}
    ck = Path(spec["checkpoint"] + ".npz")
    flat = tree.leaves(ref.tree())
    if leaves:
        with np.load(ck) as z:
            worst = 0.0
            for i, want in enumerate(flat):
                have = leaf_from_numpy(z[f"leaf_{i}"], want.dtype)
                if want.dtype == torch.int32:
                    if not torch.equal(have, want.cpu()):
                        raise AssertionError(f"{phase} {label}: leaf {i}")
                    continue
                worst = max(worst, _outside_share(have, want))
        if worst > TFM_OUTSIDE_SHARE:
            raise AssertionError(f"{phase} {label}: a leaf has {worst:.3g}"
                                 " of its elements outside the envelope")
        out["worst_leaf_share_outside"] = worst
    del ref, flat
    tr = Trainer(trainer_config(spec), device=DEVICE, **spec.get("opt", {}))
    loaded = tr.load(spec["checkpoint"])
    if _leaf_bits(loaded) != a["leaf_sha"]:
        raise AssertionError(f"{phase} {label}: the checkpoint loaded in "
                             "one process is not the replicas' bits")
    twin = tr.load(spec["checkpoint"])
    t = torch.from_numpy(tokens[0]).to(DEVICE)
    # the embedding's backward sums repeated tokens in no fixed order
    # unless torch picks its deterministic kernels
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        la = float(tr.step(loaded, t)[1])
        lb = float(Trainer(trainer_config(spec), device=DEVICE,
                           **spec.get("opt", {})).step(twin, t)[1])
    finally:
        torch.use_deterministic_algorithms(prev)
    if la != lb or _leaf_bits(loaded) != _leaf_bits(twin):
        raise AssertionError(f"{phase} {label}: two loads of the "
                             "checkpoint stepped on to different bits")
    out["checkpoint_step_loss"] = la
    return out


def phase_tfm_processes(card: str) -> tuple:
    """(a) and (b): one launch of PROCS processes over three trainer
    jobs: bench.py's bf16 cell (timed, with B5's all-gather at the
    grads' packed shape), its float32 twin at 2 layers and the small MoE
    model over expert = 2 ranks in each process; each held against one
    process on the card over the same global batches."""
    (WORK / "phase18").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(18)
    opt = {"learning_rate": TFM_LR}
    bf16 = _dp_spec("tfm_bf16", dict(TFM_WIDTH, n_layers=TFM_LAYERS,
                                     dtype="bfloat16"),
                    np.stack([_tfm_tokens(rng, TFM_BATCH)
                              for _ in range(DP_BF16_STEPS)]),
                    opt=opt, warmup=DP_WARM, time_exchange=True)
    f32 = _dp_spec("tfm_f32", dict(TFM_WIDTH, n_layers=DP_F32_LAYERS,
                                   dtype="float32"),
                   np.stack([_tfm_tokens(rng, DP_F32_BATCH)
                             for _ in range(DP_F32_STEPS)]), opt=opt)
    moe = _dp_spec("tfm_moe", dict(DP_MOE, dtype="float32"),
                   np.stack([rng.integers(0, DP_MOE["vocab_size"], (
                       DP_MOE_BATCH, DP_MOE_SEQ)).astype(np.int32)
                       for _ in range(DP_MOE_STEPS)]),
                   opt=opt, mesh={"expert": DP_MOE_RANKS})
    # phase 19 (c) rides this launch: reduce_scatter and pmean across
    # the processes, no start-up of its own
    coll = {"job": "collectives", "device": DEVICE,
            "out": str(WORK / "phase18" / "collectives"),
            "shapes": COLL_SHAPES}
    specs = [bf16, f32, moe]
    torch.cuda.empty_cache()
    got, _, wall = _da_launch(specs + [coll], WORK / "phase18", "phase 18")
    res = {k: v[0] for k, v in got.items()}
    collectives = res.pop("collectives")
    toks = {s["out"]: np.load(s["data"])["tokens"] for s in specs}
    held = {}
    for label, spec, rtol, leaves in (
            ("tfm_bf16", bf16, DP_BF16_LOSS_RTOL, False),
            ("tfm_f32", f32, 1e-3, True), ("tfm_moe", moe, 1e-3, True)):
        held[label] = _dp_hold(label, res[label], spec, toks[spec["out"]],
                               rtol, leaves)
        torch.cuda.empty_cache()
    a = res["tfm_bf16"][0]
    tokens = TFM_BATCH * (TFM_SEQ - 1)
    step_s = max(g["step_ms"] for g in res["tfm_bf16"]) / 1e3
    _json_line({"phase": "tfm_processes", "card": card, "run": DP_PATH,
                "processes": PROCS, "dtype": "bfloat16",
                "global_batch": [TFM_BATCH, TFM_SEQ],
                "tokens_a_step": tokens, "steps_timed":
                DP_BF16_STEPS - DP_WARM,
                "step_ms": [g["step_ms"] for g in res["tfm_bf16"]],
                "tokens_per_s": tokens / step_s,
                "launches": a["launches"], "launch_wall_s": wall,
                **held["tfm_bf16"]})
    for label in ("tfm_f32", "tfm_moe"):
        _json_line({"phase": "tfm_processes", "card": card, "run": label,
                    "launches": res[label][0]["launches"],
                    "step_ms": res[label][0]["step_ms"], **held[label]})
    counts = {DP_PATH: dict(res["tfm_bf16"][0]["launches"]),
              DP_MOE_PATH: dict(res["tfm_moe"][0]["launches"])}
    if counts[DP_PATH]["ring_process"] != DP_BF16_STEPS:
        raise AssertionError(f"phase 18: the bf16 job launched B5 "
                             f"{counts[DP_PATH]['ring_process']} times "
                             f"across processes, expected one a step")
    want_moe = DP_MOE_STEPS * (1 + 2 * DP_MOE["n_layers"])
    if counts[DP_MOE_PATH]["ring_process"] != want_moe or \
            counts[DP_MOE_PATH]["ring"] != DP_MOE_STEPS * 4 \
            * DP_MOE["n_layers"]:
        raise AssertionError(f"phase 18: the MoE job's B5 launches "
                             f"{counts[DP_MOE_PATH]}")
    exchange = a.get("exchange")
    if not exchange:
        if DEVICE == "cuda":
            raise AssertionError("phase 18: the bf16 job timed no exchange")
        return [], counts, collectives
    e = exchange[0]
    if e["max_abs_err"] != 0:
        raise AssertionError(f"phase 18: the cross-process exchange is not "
                             f"a copy: {e}")
    _json_line({"phase": "tfm_processes", "card": card,
                "exchange": e["label"], "shape": e["shape"],
                "kernel_ms": e["ms"], "bound_ms": e["bound_ms"],
                "host_route_ms": e["host_route_ms"],
                "gloo_cpu_ms": e["plain_ms"],
                "wait": "stream (cuStreamWaitValue64)",
                "launches_in_job": a["launches"].get("ring_process")})
    case = {"name": "ring_exchange (across processes, all-gather of the "
                    "trainer's packed grads)",
            "route": "cuda", "source": "swiftmpi_tpu_torch/kernels/csrc/"
                                       "ring.cu",
            "replaces": "swiftmpi_tpu/ops/pallas_ring.py:86",
            "module": ring, "counter": "ring_process", "path": DP_PATH,
            "shape": e["shape"], "max_abs_err": e["max_abs_err"],
            "tolerance": "bit for bit (a copy)", "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bytes": e["bytes"], "flops": 0,
            "library": "none: NCCL runs no two ranks on one card; the host "
            "route's ms is on the tfm_processes line",
            "library_ms": None}
    report_cases([case])
    return [case], counts, collectives


def _dpl_model(conf: dict, vocab, data_plane: str) -> Word2Vec:
    c = ConfigParser().update(conf)
    c.set("cluster", "data_plane", data_plane)
    m = Word2Vec(config=c, device=DEVICE, seed=5)
    m.build_from_vocab(vocab)
    return m


def _dpl_pair(conf: dict, vocab, corpus, planes) -> dict:
    """One epoch of the corpus prefix from one table on each route of
    ``planes``: ``(losses, launches, routes, model)`` by route."""
    prefix = np.ascontiguousarray(corpus[:DPL_SENTS])
    runs, first = {}, None
    for plane in planes:
        m = _dpl_model(conf, vocab, plane)
        flat = {f: (v if isinstance(v, list) else [v])
                for f, v in m.table.state.items()}
        if first is None:
            first = {f: [t.clone() for t in v] for f, v in flat.items()}
        else:
            # the first model's initial table, into this one's layout
            for f, v in flat.items():
                for t, src in zip(v, first[f]):
                    t.copy_(src)
        kernels.reset_launches()
        losses = m.train(prefix, niters=1, batch_size=BATCH)
        torch.cuda.synchronize()
        runs[plane] = (losses, kernels.launch_counts(),
                       m.data_plane_routes, m)
    return runs


def phase_data_plane(vocab, corpus: np.ndarray, card: str) -> dict:
    """(c): word2vec on ``tpu@8`` and with ``stencil`` under
    ``data_plane: xla`` and ``auto``: the losses agree (``tpu``: the
    exchange moves the same bits, so the losses and a pull are equal bit
    for bit; ``stencil``: within 1e-4, since B4 sums a context in
    another order than the chain), B4 and B5 launch no time under
    ``xla``; the sweep apps record verdicts into a temporary store,
    ``auto`` follows a planted library verdict, ignores one from another
    stack, and reads none once no store is named."""
    from swiftmpi_tpu_torch.apps import ring_sweep, stencil_sweep
    from swiftmpi_tpu_torch.ops import calibration as cal
    counts = {}
    tpu_conf = {**DEMO_CONF, "cluster": {"transfer": "tpu",
                                         "server_num": SHARDS}}
    sten_conf = {**DEMO_CONF, "word2vec": {**DEMO_CONF["word2vec"],
                                           "stencil": 1}}
    store = WORK / "phase18" / "calibration.json"
    store.unlink(missing_ok=True)
    prev = cal.use_store(str(store))
    cal.reset_cache()
    try:
        for label, conf, name, kernel in (
                (DPL_TPU, tpu_conf, "ring_push", "ring"),
                (DPL_STENCIL, sten_conf, "stencil_fused", "stencil")):
            runs = _dpl_pair(conf, vocab, corpus, ("auto", "xla"))
            (la, ca, ra, _), (lx, cx, rx, _) = runs["auto"], runs["xla"]
            if ra != {name: "kernel"} or rx != {name: "library"}:
                raise AssertionError(f"phase 18 {label}: routes {ra}, {rx}")
            if ca[kernel] == 0 or cx["stencil"] or cx["ring"]:
                raise AssertionError(f"phase 18 {label}: launches auto "
                                     f"{ca}, xla {cx}")
            gap = max(abs(a - b) / abs(b) for a, b in zip(la, lx))
            if (la != lx) if label == DPL_TPU else gap > 1e-4:
                raise AssertionError(f"phase 18 {label}: losses auto {la} "
                                     f"vs xla {lx}")
            counts[label + ":auto"], counts[label + ":xla"] = ca, cx
            _json_line({"phase": "data_plane", "card": card, "run": label,
                        "losses_auto": la, "losses_xla": lx,
                        "loss_rel_gap": gap, "launches_auto": ca,
                        "launches_xla": cx})
            del runs
        # the tpu route's exchange moves the same bits: one pull each way
        m = _dpl_model(tpu_conf, vocab, "auto")
        lib = _dpl_model(tpu_conf, vocab, "xla")
        lib.table.state = m.table.state
        slots = torch.arange(0, BATCH, device=DEVICE, dtype=torch.int32) % \
            m.table.capacity
        pa = m.transfer.pull(m.table.state, slots, m.access)
        px = lib.transfer.pull(lib.table.state, slots, lib.access)
        if any(not torch.equal(pa[f], px[f]) for f in pa):
            raise AssertionError("phase 18: the library exchange's pull "
                                 "differs from B5's")
        del m, lib
        torch.cuda.empty_cache()
        # the sweeps record this card's verdicts
        ring_rows = ring_sweep.sweep(SHARDS, 13125, store=str(store))
        sten_rows = stencil_sweep.sweep(store=str(store), corpus=corpus,
                                        vocab=vocab)
        kind = cal.device_key()
        recorded = {n: cal.lookup(n, kind) for n in ("ring_push",
                                                     "stencil_fused")}
        if None in recorded.values():
            raise AssertionError(f"phase 18: the sweeps recorded "
                                 f"{recorded}")
        measured = _dpl_model(tpu_conf, vocab, "auto").data_plane_routes
        status = cal.kernel_status(kind)
        want = "library" if recorded["ring_push"]["library_win"] \
            else "kernel"
        if measured != {"ring_push": want}:
            raise AssertionError(f"phase 18: auto took {measured} on the "
                                 f"verdict {recorded['ring_push']}")
        planted = cal.ab_verdict("ring_push", 0.1, 1.0, True,
                                 record_it=False)
        for n in ("ring_push", "stencil_fused"):
            cal.record(n, kind, planted)
        follows = {**_dpl_model(tpu_conf, vocab, "auto").data_plane_routes,
                   **_dpl_model(sten_conf, vocab, "auto").data_plane_routes}
        stale = dict(planted, stack=dict(cal.stack_key(), torch="0.0"))
        for n in ("ring_push", "stencil_fused"):
            cal.record(n, kind, stale)
        ignores = {**_dpl_model(tpu_conf, vocab, "auto").data_plane_routes,
                   **_dpl_model(sten_conf, vocab, "auto").data_plane_routes}
        # the planted library verdict again, in a store no one names
        for n in ("ring_push", "stencil_fused"):
            cal.record(n, kind, planted)
        cal.use_store(None)
        unnamed = {**_dpl_model(tpu_conf, vocab, "auto").data_plane_routes,
                   **_dpl_model(sten_conf, vocab, "auto").data_plane_routes}
        kernel_routes = {"ring_push": "kernel", "stencil_fused": "kernel"}
        if follows != {"ring_push": "library", "stencil_fused": "library"} \
                or ignores != kernel_routes or unnamed != kernel_routes:
            raise AssertionError(f"phase 18: auto on a planted verdict "
                                 f"{follows}, on a stale one {ignores}, "
                                 f"with no store named {unnamed}")
        _json_line({"phase": "data_plane", "card": card, "verdicts": {
            n: {k: v for k, v in recorded[n].items() if k != "stack"}
            for n in recorded}, "auto_on_measured": measured,
            "auto_on_planted_library": follows,
            "auto_on_stale_stack": ignores,
            "auto_with_no_store_named": unnamed,
            "status": status,
            "ring_sweep_ms": ring_rows[0]["ms"],
            "stencil_sweep_ms": sten_rows[0]["ms"]})
    finally:
        cal.use_store(prev)
        cal.reset_cache()
    return counts


def phase_tfm_dp(vocab, corpus: np.ndarray, card: str) -> tuple:
    """Phase 18: (a), (b) the transformer trainer across processes, (c)
    ``data_plane`` and the verdict store.  Returns B5's case at the
    grads' packed shape, the launches, and the processes' JSON of phase
    19 (c)'s ``collectives`` job, which rides (a)'s launch."""
    t0 = time.perf_counter()
    cases, counts, collectives = phase_tfm_processes(card)
    counts.update(phase_data_plane(vocab, corpus, card))
    print(f"phase 18 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, counts, collectives


# -- phase 19: the JAX package's last names: grow, SGDAccess, reduce-scatter --

#: (a): the paths grown mid-run (``grow:<path>``), the corpus prefix of
#: each of the two ``train`` calls around the growth, and the probe keys
GROW_PATHS = ("gather", f"gather@{SHARDS}")
GROW_SENTS = 300
GROW_PROBES = 64
#: B3 sums in no fixed order and AdaGrad's first update carries a near-
#: cancelling sum's last bit far, so at the full width a run and its
#: eager twin part over tens of steps (a full epoch never matches a
#: rerun): each field's update over the second ``train`` call (its table
#: after it less its table after the growth) must lie within this
#: relative norm of the twin's; a stale graph (one replaying into the
#: pre-growth tensors) updates nothing, a ratio of 1
GROW_UPDATE_RTOL = 0.2
#: (b): SGDAccess's learning rate (the JAX default of the apps' server)
SGD_LR = 0.7
#: (c): the collectives job's shapes, ``[label, shape, scatter_dimension]``:
#: xla's dense plane with its counts column (capacity x (d + 1)) and the
#: trainer's packed grads (phase 18's 10,488,065 words, one more so they
#: split over the 2 processes, as JAX's psum_scatter needs)
COLL_SHAPES = [["xla_plane", [90_516, 101], 0],
               ["grads_packed", [10_488_066], 0]]


def _copy_state(dst: Word2Vec, src: Word2Vec) -> None:
    for f, v in src.table.state.items():
        for t, u in zip(*((x if isinstance(x, list) else [x]) for x in (
                dst.table.state[f], v))):
            t.copy_(u)


def _grow_cases(path: str, model: Word2Vec, batch) -> list:
    """The kernels at the shapes the grown table gives them: on ``gather``
    the h pull, the h push with counts and AdaGrad over the grown table;
    on the sharded path one exchange of h rows, the owners' pull and push
    on the grown block of shards and AdaGrad over it."""
    rng = np.random.default_rng(19)
    dev, d = model.device, model.len_vec
    flush = torch.zeros(2 * 50 * 2 ** 20 // 4, device=dev)
    label = f"grow:{path}"
    state, lr = model.table.state, model.access.learning_rate
    h_slots, _ = _step_inputs(model, batch, rng)
    if "@" not in path:
        cap = model.table.capacity
        hs, hv = _perturbed(h_slots, cap, rng)
        accum = torch.as_tensor(rng.random((cap, d), np.float32) * 1e-3,
                                device=dev)
        grad = torch.as_tensor(rng.normal(size=(cap, d)).astype(np.float32)
                               * 1e-2, device=dev)
        counts = torch.as_tensor(rng.integers(1, 9, cap).astype(np.float32),
                                 device=dev)
        return [_gather_case("h pull, grown table", state["h"], hs, hv,
                             flush, label),
                _scatter_case("h push, grown table", label, hs, hv, cap, d,
                              rng, flush),
                _adagrad_case("grown h table, / counts", label,
                              state["h"].clone(), accum, grad, lr, flush,
                              div=counts)]
    C = h_slots.shape[0] // SHARDS
    groups, _, cap = model.transfer._route(state, h_slots)
    owners = ring.ring_exchange_stacked(groups[0].req).view(SHARDS, -1)
    block = shard_block(state["h"])
    accum8 = torch.as_tensor(rng.random(block.shape, np.float32) * 1e-3,
                             device=dev)
    grad8 = torch.as_tensor(rng.normal(size=block.shape).astype(np.float32)
                            * 1e-2, device=dev)
    inv8 = 1.0 / torch.as_tensor(rng.integers(1, 9, block.shape[:2])
                                 .astype(np.float32), device=dev)
    return [_ring_case("h rows, grown table", (C, d), torch.float32, rng,
                       flush, dev, path=label),
            _gather_case(f"{SHARDS} owners' h pull, grown block", block,
                         owners, (owners >= 0).contiguous(), flush, label),
            _scatter_case(f"{SHARDS} owners' h push, grown block", label,
                          owners, owners >= 0, cap, d, rng, flush),
            _adagrad_case(f"{SHARDS} grown shards, * 1/counts", label,
                          block.clone(), accum8, grad8, lr, flush,
                          mul=inv8)]


def phase_grow(path: str, vocab, corpus: np.ndarray, batch,
               card: str) -> tuple:
    """(a) on one path: a model and its twin from one table train over a
    corpus prefix, both grow to twice their capacity a shard, the probe
    keys' ``embedding`` rows keep their bits, and both train over the next
    prefix; the model's groups are graphed on ``gather``
    (``inner_steps: 4``: the growth must recapture them), the twin's
    eager.  The twin's losses and updates hold the model's; B1-B3 (and B5
    on the sharded path) launch after the growth; ``embedding_index`` is
    built and queried."""
    graphs = "@" not in path
    worker = {"inner_steps": 4} if graphs else {}
    model = _model(path, vocab, DEVICE, worker)
    twin = _model(path, vocab, DEVICE, worker)
    _copy_state(twin, model)
    twin._run_group = lambda fields, _graphs, *a: Word2Vec._run_group(
        twin, fields, False, *a)

    def batcher(lo):
        return CBOWBatcher(corpus[lo:lo + GROW_SENTS], vocab, model.window,
                           model.sample, seed=2008)

    for x in (model, twin):
        x.train(batcher=batcher(0), niters=1, batch_size=BATCH)
    replays_before = model.train_metrics.get("graph_replays", 0)
    captured = dict(model._fused_cache)
    probe = [int(k) for k in vocab.keys[:GROW_PROBES]]
    before = [np.stack([x.embedding(k) for k in probe])
              for x in (model, twin)]
    cap = model.table.key_index.capacity_per_shard
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.grow(2 * cap)
    torch.cuda.synchronize()
    grow_s = time.perf_counter() - t0
    twin.grow(2 * cap)
    for x, b in zip((model, twin), before):
        if not np.array_equal(np.stack([x.embedding(k) for k in probe]), b):
            raise AssertionError(f"phase 19 {path}: the probe rows moved "
                                 "across the growth")
    drift_before = {f: _drift(_global(v), _global(twin.table.state[f]))
                    for f, v in model.table.state.items()}
    grown = [{f: _global(v).clone() for f, v in x.table.state.items()}
             for x in (model, twin)]
    kernels.reset_launches()
    losses = model.train(batcher=batcher(GROW_SENTS), niters=1,
                         batch_size=BATCH)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    m = dict(model.train_metrics)
    twin_losses = twin.train(batcher=batcher(GROW_SENTS), niters=1,
                             batch_size=BATCH)
    want = {"gather", "scatter", "adagrad"} | (set() if graphs
                                               else {"ring"})
    if {k for k, n in counts.items() if n} != want:
        raise AssertionError(f"phase 19 {path}: launches after the growth "
                             f"{counts}, the path's kernels are {want}")
    if graphs and not (replays_before > 0 and m["graph_replays"] > 0
                       and model._fused_cache and not any(
                           model._fused_cache.get(L) is g
                           for L, g in captured.items())):
        raise AssertionError(f"phase 19 {path}: graphs not recaptured after "
                             f"the growth ({replays_before} replays before, "
                             f"{m['graph_replays']} after)")
    if not np.allclose(losses, twin_losses, rtol=1e-4, atol=0):
        raise AssertionError(f"phase 19 {path}: losses {losses} against the "
                             f"eager twin's {twin_losses}")
    drift, update_gap = {}, {}
    for f, v in model.table.state.items():
        now = [_global(v), _global(twin.table.state[f])]
        drift[f] = _drift(*now)
        dm, dt = (n.float() - g[f].float() for n, g in zip(now, grown))
        update_gap[f] = ((dm - dt).norm() / dt.norm().clamp(min=1e-30)
                         ).item()
        if not dt.norm() > 0 or update_gap[f] > GROW_UPDATE_RTOL:
            raise AssertionError(f"phase 19 {path}: {f}'s update after the "
                                 f"growth against the eager twin's: "
                                 f"{update_gap[f]} of its norm ({drift[f]})")
    t0 = time.perf_counter()
    index = model.embedding_index()
    keys, scores = index.neighbors(probe[0], 10)
    index_s = time.perf_counter() - t0
    if len(keys) != 10 or not np.isfinite(scores).all() or \
            not (scores <= 1.0 + 1e-5).all():
        raise AssertionError(f"phase 19 {path}: embedding_index gave "
                             f"{keys}, {scores}")
    _json_line({"phase": "grow", "path": path, "card": card,
                "capacity_before": cap * model.cluster.n_servers,
                "capacity_after": model.table.capacity,
                "generation": model.table.generation, "grow_s": grow_s,
                "graphed": graphs, "graph_replays_before": replays_before,
                "graph_replays_after": m.get("graph_replays", 0),
                "loss": losses, "twin_loss": twin_losses,
                "steps": m["steps"],
                "drift_vs_eager_twin_before_growth": drift_before,
                "drift_vs_eager_twin": drift,
                "update_gap_vs_eager_twin": update_gap,
                "launches": counts, "index_build_and_query_s": index_s,
                "probe_rows_bit_equal": True})
    cases = _grow_cases(path, model, batch)
    report_cases(cases)
    return cases, {f"grow:{path}": counts}


def phase_sgd(vocab, batch, card: str) -> tuple:
    """(b): ``SGDAccess`` (h and v, float32, no accumulator) over the
    text8-shaped table on ``xla`` and on ``tpu@8``: one step's h pull,
    its h push (a mean) and its v push, at the slots a real batch gives,
    on the card and on the CPU's plain path from the same rows: the pull
    bit for bit, the tables within 1e-5 + 1e-3 |b|."""
    from swiftmpi_tpu_torch.cluster import ps_mesh
    from swiftmpi_tpu_torch.parameter import FieldSpec, SGDAccess
    from swiftmpi_tpu_torch.transfer import get_transfer
    out = {}
    for path in ("gather", f"gather@{SHARDS}"):
        model = _model(path, vocab, DEVICE)
        d = model.len_vec
        acc = SGDAccess(SGD_LR, {"h": FieldSpec(d), "v": FieldSpec(d)},
                        ("h", "v"), ("h", "v"))
        rng = np.random.default_rng(23)
        h_slots, v_slots = _step_inputs(model, batch, rng)
        grads = {"h": rng.normal(size=(h_slots.shape[0], d)).astype(
            np.float32) * 1e-2,
            "v": rng.normal(size=(v_slots.shape[0], d)).astype(
                np.float32) * 1e-2}
        rows = {f: _global(model.table.state[f]) for f in "hv"}
        res = {}
        for where in (DEVICE, "cpu"):
            sharded = "@" in path
            mesh = ps_mesh(SHARDS, [where]) if sharded else None
            state = {f: (split_rows(r, mesh) if sharded else r.clone()
                         .to(where)) for f, r in rows.items()}
            t = get_transfer("tpu" if sharded else "xla",
                             **({"mesh": mesh} if sharded else {}))
            kernels.reset_launches()
            t0 = time.perf_counter()
            pulled = t.pull(state, h_slots.to(where), acc, fields=("h",))
            t.push(state, h_slots.to(where), {"h": torch.as_tensor(
                grads["h"], device=where)}, acc, mean=True)
            t.push(state, v_slots.to(where), {"v": torch.as_tensor(
                grads["v"], device=where)}, acc)
            if where != "cpu":
                torch.cuda.synchronize()
            res[where] = (pulled["h"].cpu(), {f: _global(v) for f, v in
                                              state.items()},
                          kernels.launch_counts(), time.perf_counter() - t0,
                          dict(t.push_paths))
        card_res, cpu_res = res[DEVICE], res["cpu"]
        if not torch.equal(card_res[0], cpu_res[0]):
            raise AssertionError(f"phase 19 SGD {path}: the pull differs")
        gaps = {}
        for f in "hv":
            gaps[f] = _drift(card_res[1][f], cpu_res[1][f])
            if gaps[f]["share_outside"]:
                raise AssertionError(f"phase 19 SGD {path}: {f} outside the "
                                     f"envelope: {gaps[f]}")
        counts = card_res[2]
        want = {"gather", "scatter"} | ({"ring"} if "@" in path else set())
        if DEVICE == "cuda" and {k for k, n in counts.items() if n} != want:
            raise AssertionError(f"phase 19 SGD {path}: launches {counts}, "
                                 f"expected {want}")
        _json_line({"phase": "sgd", "path": path, "card": card,
                    "h_rows": int(h_slots.shape[0]),
                    "v_rows": int(v_slots.shape[0]),
                    "push_paths": card_res[4], "launches": counts,
                    "wall_s_card": card_res[3], "wall_s_cpu": cpu_res[3],
                    "gap_vs_cpu": gaps})
        out[f"sgd:{path}"] = counts
    return [], out


def phase_collectives(got: list, card: str) -> tuple:
    """(c): the ``collectives`` job of phase 18's launch: ``reduce_scatter``
    and ``pmean`` across the processes at ``COLL_SHAPES``, held bit for
    bit (in each process) to numpy's sum in process order and to the gloo
    route; B5 across processes launched; each one's ms beside
    ``psum_many``'s at the same shape."""
    path = f"collectives@dp{len(got)}"
    if any(g["timeouts"] for g in got):
        raise AssertionError(f"phase 19 (c): ring waits timed out: {got}")
    counts = dict(got[0]["launches"])
    if DEVICE == "cpu":
        return [], {path: counts}
    if counts["ring_process"] <= 0 or len(got[0]["timed"]) != \
            len(COLL_SHAPES):
        raise AssertionError(f"phase 19 (c): launches {counts}, timed "
                             f"{got[0]['timed']}")
    cases = []
    for i, t in enumerate(got[0]["timed"]):
        _json_line({"phase": "collectives", "card": card,
                    "by_process": [g["timed"][i] for g in got]})
        cases.append({
            "name": f"ring_exchange (across processes, reduce_scatter of "
                    f"{t['label']})", "route": "cuda",
            "source": "swiftmpi_tpu_torch/kernels/csrc/ring.cu",
            "replaces": "swiftmpi_tpu/ops/pallas_ring.py:86",
            "module": ring, "counter": "ring_process", "path": path,
            "shape": f"{t['shape']} float32 a process over {t['dp']}, "
                     f"scattered on dim {t['scatter_dimension']}",
            "max_abs_err": t["max_abs_err"],
            "tolerance": "bit for bit (a sum in process order)",
            "ms": t["reduce_scatter_ms"],
            "plain_ms": t["gloo_reduce_scatter_ms"],
            "bytes": t["reduce_scatter_bytes"], "flops": 0,
            "library": "none: NCCL runs no two ranks on one card",
            "library_ms": None})
    report_cases(cases)
    return cases, {path: counts}


def phase_public(vocab, corpus: np.ndarray, batch, collectives: list,
                 card: str) -> tuple:
    """Phase 19: (a) ``Word2Vec.grow`` mid-run, ``embedding`` and
    ``embedding_index`` on ``gather`` (graphed) and ``gather@8``, (b)
    ``SGDAccess`` through ``xla`` and ``tpu@8``, (c) ``reduce_scatter``
    and ``pmean`` across the processes (run in phase 18's launch)."""
    t0 = time.perf_counter()
    cases, counts = [], {}
    for path in GROW_PATHS:
        c, n = phase_grow(path, vocab, corpus, batch, card)
        cases += c
        counts.update(n)
        torch.cuda.empty_cache()
    counts.update(phase_sgd(vocab, batch, card)[1])
    c, n = phase_collectives(collectives, card)
    cases += c
    counts.update(n)
    print(f"phase 19 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, counts


# -- phase 20: the reference's deployment width: 4 and 8 processes ------------

#: the process counts of (a) and (b), all on the one card
WIDE_NP = (4, 8)
#: their epochs over phase 14's prefix, and the shard ranks a process of
#: (a)'s ``tpu`` and ``hybrid`` jobs
WIDE_ITERS, WIDE_SHARDS = 1, 2
#: (b)'s collectives across 8 processes: xla's plane and the trainer's
#: packed grads, each cut to a multiple of 8 rows (phase 19's 90,516 and
#: 10,488,066 do not split over 8), and the timed calls of each
WIDE_COLL_SHAPES = [["xla_plane", [90_520, 101], 0],
                    ["grads_packed", [10_488_064], 0]]
WIDE_COLL_REPS = 5
#: (c) the envelope: processes, ``local_steps`` sweep and epochs (the JAX
#: package's ``scripts/async_envelope.py`` defaults); the reference
#: configuration's corpus prefix (1,600 sentences: ~52 global steps of
#: 5,000 centers an epoch, so 4 stale steps are a small share of it, as
#: the JAX child wants: its 4 of ~45); the JAX child's own configuration
#: (``mp_child async -shape small``: its model, 400 sentences of 12 words
#: over 80, 64 centers a process) and its envelope there, ``local_steps``
#: 4's final loss against sync's, relative
ENV_NP, ENV_SWEEP, ENV_EPOCHS = 8, "1,4,16", 4
ENV_SENTS = 1_600
ENV_SMALL_SENTS = 400
ENV_LIMIT = 0.2
#: the dtypes a data-axis reconcile may put on the exchange, bf16 tables
#: included: float32 planes, grads and counts, int32 slots
WIRE_DTYPES = {"float32", "int32"}


def _wide_draws(vocab, prefix: np.ndarray, nprocs: int, out: Path):
    """The lockstep epochs of ``nprocs`` processes over the prefix and
    numpy draws for every step: each process's slice in the data npz,
    their concatenation on the device for the one-process run.  Returns
    ``(epochs, steps, draws_cat, data_path)``."""
    w2v = DEMO_CONF["word2vec"]
    Bl = BATCH // nprocs
    epochs = lockstep_epochs(vocab, prefix, w2v["window"], w2v["sample"],
                             Bl, nprocs, WIDE_ITERS)
    steps = sum(len(e) for e in epochs)
    rng = np.random.default_rng(20 + nprocs)
    data = {"corpus": prefix, "vocab_keys": vocab.keys,
            "vocab_counts": vocab.counts}
    draws_cat, per_rank = [], [([], []) for _ in range(nprocs)]
    for _ in range(steps):
        js, us = [], []
        for r in range(nprocs):
            j = rng.integers(0, len(vocab), (Bl, w2v["negative"]))
            u = rng.random(j.shape, np.float32)
            per_rank[r][0].append(j)
            per_rank[r][1].append(u)
            js.append(j)
            us.append(u)
        draws_cat.append((torch.from_numpy(np.concatenate(js)).to(DEVICE),
                          torch.from_numpy(np.concatenate(us)).to(DEVICE)))
    for r in range(nprocs):
        data[f"j{r}"] = np.stack(per_rank[r][0])
        data[f"u{r}"] = np.stack(per_rank[r][1])
    path = out / f"w2v@dp{nprocs}.npz"
    np.savez(path, **data)
    return epochs, steps, draws_cat, path


def _wide_w2v(name: str, cluster: dict, data: Path, nprocs: int, out: Path,
              server: Optional[dict] = None, shapes=()) -> tuple:
    """A ``w2v`` job of (a) or (b): ``(conf, spec)``."""
    conf = {**DEMO_CONF, "cluster": cluster}
    if server:
        conf["server"] = {**DEMO_CONF["server"], **server}
    return conf, {"conf": conf, "data": str(data), "device": DEVICE,
                  "batch_size": BATCH // nprocs, "niters": WIDE_ITERS,
                  "out": str(out / name), "state": True, "wire": True,
                  "time_shapes": list(shapes)}


def _wide_hold(label: str, nprocs: int, per_proc: list, arrays: dict,
               conf: dict, step_key: str, vocab, epochs, steps: int,
               draws_cat, card: str) -> dict:
    """One word2vec job of ``nprocs`` processes against the one-process
    run of the port over the same global batches and draws
    (``_hold_processes``), its reconciles' wire dtypes held to
    ``WIRE_DTYPES``; prints and returns its line."""
    ref = Word2Vec(config=ConfigParser().update(conf), device=DEVICE)
    ref.build_from_vocab(vocab)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    ref_first, times = {}, []
    ref_losses = ref.train(
        batcher=_GlobalBatches(epochs, vocab), batch_size=BATCH,
        niters=WIDE_ITERS, draws=first_step_rows(iter(draws_cat), ref,
                                                 ref_first, times))
    ref_steady = steady_step_ms(times, time.perf_counter())
    held = _hold_processes(f"{label}@dp{nprocs}", per_proc,
                           (arrays["w2v_first_step"], arrays["w2v_state"]),
                           ref, ref_first, ref_losses, steps, step_key,
                           phase="phase 20")
    wire = per_proc[0]["wire"]
    shipped = set().union(*map(set, wire.values()))
    if not shipped <= WIRE_DTYPES:
        raise AssertionError(f"phase 20 {label}@dp{nprocs}: the exchanges "
                             f"carried {wire}")
    m = per_proc[0]["metrics"]
    words_step = m["words"] / max(m["steps"], 1)
    steady = max(g["steady_step_ms"] for g in per_proc)
    line = {"phase": "wide", "card": card, "run": label,
            "processes": nprocs, "steps": m["steps"],
            "centers_a_process": BATCH // nprocs,
            "steady_step_ms": steady,
            "one_process_steady_step_ms": ref_steady,
            "global_words_per_sec": 1e3 * words_step / steady,
            "one_process_words_per_sec": 1e3 * words_step / ref_steady,
            "lockstep_host_ms_per_step": [g["metrics"][
                "lockstep_ms_per_step"] for g in per_proc],
            "losses": per_proc[0]["losses"],
            "one_process_losses": ref_losses,
            "push_paths": m["push_paths"], "wire": wire,
            "launches_per_step": {k: v / max(m["steps"], 1) for k, v in
                                  per_proc[0]["launches"].items()},
            "timeouts": [g["timeouts"] for g in per_proc], **held}
    _json_line(line)
    del ref
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return line


def phase_wide(vocab, corpus: np.ndarray, proc_xla: dict,
               card: str) -> tuple:
    """Phase 20: (a) one launch of 4 processes over ``xla`` (float32 and
    bf16 tables), ``tpu`` and ``hybrid`` (``WIDE_SHARDS`` ranks a process)
    and the trainer's float32 twin; (b) one launch of 8 processes over
    ``xla`` and a ``collectives`` job; each word2vec job held as phase 14
    holds 2 processes, the trainer as phase 18 does; B5's cross-process
    all-gather at phase 14's shapes at 2, 4 and 8 processes against its
    bound, and global words/s at 1, 2, 4 and 8; (c) the bounded-staleness
    envelope over 8 processes (``apps/async_envelope.py``).  ``proc_xla``
    is phase 14's ``xla`` figures (``phase_processes``): its exchange's
    shapes and times, and its run's words/s, at ``PROCS`` processes.
    Returns B5's cases at 4 and 8 processes and their launches."""
    t0 = time.perf_counter()
    out = WORK / "phase20"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    prefix = np.ascontiguousarray(corpus[:PROC_SENTS])
    cuda = DEVICE == "cuda"
    if cuda and not (proc_xla.get("exchange") and proc_xla.get("run")):
        raise AssertionError(f"phase 20: phase 14's xla figures are "
                             f"missing: {sorted(proc_xla)}")
    # phase 14's shapes, to time the exchange at every width alike
    shapes = [(e["label"], tuple(e["shape"]))
              for e in proc_xla["exchange"]] if cuda else []
    shards = {"server_num": WIDE_SHARDS}
    lines, exchange, counts, cases = {}, {}, {}, []
    for nprocs in WIDE_NP:
        epochs, steps, draws_cat, data = _wide_draws(vocab, prefix, nprocs,
                                                     out)
        jobs = [("xla", "xla", _wide_w2v(
            "xla", DEMO_CONF["cluster"], data, nprocs, out, shapes=shapes))]
        extra = []
        if nprocs == 4:
            jobs += [
                ("xla_bf16", "xla", _wide_w2v(
                    "xla_bf16", DEMO_CONF["cluster"], data, nprocs, out,
                    server={"dtype": "bfloat16"})),
                (f"tpu@{WIDE_SHARDS}", "tpu", _wide_w2v(
                    f"tpu@{WIDE_SHARDS}", {"transfer": "tpu", **shards},
                    data, nprocs, out)),
                (f"hybrid@{WIDE_SHARDS}", "hybrid", _wide_w2v(
                    f"hybrid@{WIDE_SHARDS}", {"transfer": "hybrid",
                                              **shards}, data, nprocs, out))]
            rng = np.random.default_rng(20)
            tokens = np.stack([_tfm_tokens(rng, DP_F32_BATCH)
                               for _ in range(DP_F32_STEPS)])
            extra.append(_dp_spec(
                "tfm_f32", dict(TFM_WIDTH, n_layers=DP_F32_LAYERS,
                                dtype="float32"), tokens, phase="phase20",
                opt={"learning_rate": TFM_LR}))
        else:
            extra.append({"job": "collectives", "device": DEVICE,
                          "out": str(out / "collectives"),
                          "shapes": WIDE_COLL_SHAPES,
                          "reps": WIDE_COLL_REPS})
        if cuda:
            torch.cuda.empty_cache()
        print(f"phase 20 set-up at dp {nprocs}: {steps} steps of "
              f"{nprocs} x {BATCH // nprocs} centers, "
              f"{len(jobs) + len(extra)} jobs", flush=True)
        got, _, wall = _da_launch([j[2][1] for j in jobs] + extra, out,
                                  "phase 20", nprocs=nprocs)
        print(f"phase 20 launch of {nprocs} processes {wall:.1f} s",
              flush=True)
        for label, key, (conf, _) in jobs:
            per_proc, arrays = got[label]
            lines[label, nprocs] = _wide_hold(
                label, nprocs, per_proc, arrays, conf, key, vocab, epochs,
                steps, draws_cat, card)
        xla = got["xla"][0][0]
        exchange[nprocs] = xla.get("exchange") or []
        path = f"processes@dp{nprocs}"
        counts[path] = dict(xla["launches"])
        if nprocs == 4:
            spec = extra[0]
            per_proc = got["tfm_f32"][0]
            held = _dp_hold("tfm_f32@dp4", per_proc, spec, tokens, 1e-3,
                            True, phase="phase 20")
            if cuda and any(g["launches"]["ring_process"] != DP_F32_STEPS
                            for g in per_proc):
                raise AssertionError(
                    f"phase 20 tfm_f32@dp4: B5 across processes "
                    f"{[g['launches'] for g in per_proc]}, expected one "
                    "a step")
            _json_line({"phase": "wide", "card": card, "run": "tfm_f32",
                        "processes": nprocs,
                        "launches": per_proc[0]["launches"],
                        "step_ms": [g["step_ms"] for g in per_proc],
                        **held})
        else:
            coll = got["collectives"][0]
            if any(g["timeouts"] for g in coll) or (
                    cuda and coll[0]["launches"]["ring_process"] <= 0):
                raise AssertionError(f"phase 20 collectives@dp8: {coll[0]}")
            for i in range(len(coll[0]["timed"])):
                _json_line({"phase": "wide", "card": card,
                            "collectives": coll[0]["timed"][i]["label"],
                            "by_process": [g["timed"][i] for g in coll]})
        if cuda:
            torch.cuda.empty_cache()
    # B5's all-gather at phase 14's shapes by width, and words/s by width
    base = proc_xla["run"]
    for i, (label, shape) in enumerate(shapes):
        by_dp = {PROCS: proc_xla["exchange"][i],
                 **{n: exchange[n][i] for n in WIDE_NP}}
        if any(e["max_abs_err"] != 0 for e in by_dp.values()):
            raise AssertionError(f"phase 20: an exchange is not a copy: "
                                 f"{by_dp}")
        _json_line({"phase": "wide", "card": card, "exchange": label,
                    "shape": list(shape),
                    "ms": {n: e["ms"] for n, e in by_dp.items()},
                    "bound_ms": {n: e["bound_ms"] for n, e in by_dp.items()},
                    "bytes": {n: e["bytes"] for n, e in by_dp.items()},
                    "host_route_ms": {n: e["host_route_ms"]
                                      for n, e in by_dp.items()},
                    "gloo_cpu_ms": {n: e["plain_ms"]
                                    for n, e in by_dp.items()},
                    "wait": "stream (cuStreamWaitValue64)"})
    _json_line({"phase": "wide", "card": card, "cpu_count": os.cpu_count(),
                "global_words_per_sec": {
                    1: lines["xla", 4]["one_process_words_per_sec"],
                    PROCS: base["global_words_per_sec"],
                    **{n: lines["xla", n]["global_words_per_sec"]
                       for n in WIDE_NP}},
                "steady_step_ms": {
                    1: lines["xla", 4]["one_process_steady_step_ms"],
                    PROCS: base["steady_step_ms"],
                    **{n: lines["xla", n]["steady_step_ms"]
                       for n in WIDE_NP}}})
    phase_envelope(vocab, np.ascontiguousarray(corpus[:ENV_SENTS]), out,
                   card)
    for nprocs in WIDE_NP if cuda else ():
        dense = exchange[nprocs][0]
        cases.append({
            "name": f"ring_exchange (across {nprocs} processes, all-gather "
                    "of the dense plane)",
            "route": "cuda", "source": "swiftmpi_tpu_torch/kernels/csrc/"
                                       "ring.cu",
            "replaces": "swiftmpi_tpu/ops/pallas_ring.py:86",
            "module": ring, "counter": "ring_process",
            "path": f"processes@dp{nprocs}", "shape": dense["shape"],
            "max_abs_err": dense["max_abs_err"],
            "tolerance": "bit for bit (a copy)", "ms": dense["ms"],
            "plain_ms": dense["plain_ms"], "bytes": dense["bytes"],
            "flops": 0, "library": "none: NCCL runs no two ranks on one "
            "card; the host route's ms is on the wide line",
            "library_ms": None})
    report_cases(cases)
    print(f"phase 20 {time.perf_counter() - t0:.1f} s", flush=True)
    return cases, counts


def phase_envelope(vocab, prefix: np.ndarray, out: Path, card: str) -> None:
    """(c) the bounded-staleness envelope over ``ENV_NP`` processes on the
    card: one launch of ``apps/async_envelope.py`` over two shapes.  The
    reference configuration, on the corpus's first ``ENV_SENTS`` sentences
    with the whole vocab, is the held run: every setting's losses finite
    and its last epoch under its first (the JAX child's check on
    ``hybrid``).  The JAX child's 20% envelope is not held there, since
    the JAX package misses it too at this configuration in one process on
    the CPU (``tests/_envelope_witness.py``), and the port's snapshot
    mode follows JAX's step by step at this width with JAX's draws
    (``tests/test_torch_envelope.py``).  It is held at the JAX child's own
    configuration: ``local_steps`` 4's final loss within ``ENV_LIMIT`` of
    sync's.  Both sweeps' gaps to sync are printed."""
    data = out / "envelope.npz"
    np.savez(data, corpus=prefix, vocab_keys=vocab.keys,
             vocab_counts=vocab.counts)
    shapes = {"reference": ("reference", len(prefix)),
              "jax_child": ("small", ENV_SMALL_SENTS)}
    # -data feeds the reference shape, -sents the small one
    args = ["-np", str(ENV_NP), "-sweep", ENV_SWEEP, "-epochs",
            str(ENV_EPOCHS), "-shape", ",".join(s for s, _ in
                                                shapes.values()),
            "-sents", str(ENV_SMALL_SENTS), "-data", str(data),
            "-out", str(out / "envelope.jsonl"), *_device_args()]
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "swiftmpi_tpu_torch.apps.async_envelope",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, SMTPU_DIST_TIMEOUT="180"))
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"phase 20 (c): the envelope failed with rc "
                             f"{res.returncode}:\n{res.stdout[-4000:]}\n"
                             f"{res.stderr[-4000:]}")
    got = {(ln["shape"], ln["local_steps"]): ln for ln in map(
        json.loads, (x for x in res.stdout.splitlines()
                     if x.startswith("{")))}
    settings = [int(x) for x in ENV_SWEEP.split(",")]
    for label, (shape, sents) in shapes.items():
        lines = {ls: got.get((shape, ls)) for ls in settings}
        if not all(ln and np.isfinite(ln["losses"]).all()
                   for ln in lines.values()):
            raise AssertionError(f"phase 20 (c) {label}: {lines}")
        _json_line({"phase": "wide", "card": card, "envelope": label,
                    "by_local_steps": {
                        ls: {k: lines[ls][k] for k in (
                            "final_loss", "vs_sync_pct", "wall_s",
                            "global_words_per_s", "losses", "steps")}
                        for ls in settings},
                    "processes": ENV_NP, "epochs": ENV_EPOCHS,
                    "sentences": sents, "cpu_count": lines[1]["cpu_count"],
                    "launch_wall_s": wall})
    for ls in settings:
        losses = got["reference", ls]["losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"phase 20 (c) reference: local_steps "
                                 f"{ls}'s losses {losses} do not fall")
    gap4 = got["small", 4]["vs_sync_pct"] / 100
    if not abs(gap4) < ENV_LIMIT:
        raise AssertionError(f"phase 20 (c) jax_child: local_steps 4's "
                             f"final loss is {100 * gap4:+.2f}% from sync's, "
                             f"outside {100 * ENV_LIMIT:.0f}%")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc, sm_90a, {len(build.SOURCES)} sources in parallel)",
          flush=True)
    for name, log in build.build_logs.items():
        print(f"== nvcc {name}\n{log}", file=sys.stderr)

    t0 = time.perf_counter()
    corpus = synthetic_corpus_bulk(**TEXT8_CORPUS)
    vocab = build_vocab(corpus)
    model = _model("gather", vocab, "cuda")

    def first(epoch):
        return next(iter(epoch(BATCH)))

    def prefix_batcher():
        return CBOWBatcher(corpus[:100], vocab, model.window, model.sample,
                           seed=2008)

    batch = first(prefix_batcher().epoch)
    sbatch = first(prefix_batcher().epoch_stencil)
    print(f"corpus {corpus.size} tokens, vocab {len(vocab)}, table "
          f"capacity {model.table.capacity} x {model.len_vec}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        print(f"{name} {time.perf_counter() - t_phase:.1f} s", flush=True)
        t_phase = time.perf_counter()

    cases = phase_kernels(model, batch, sbatch)
    del model
    cases += phase_kernels_sharded(_model(f"gather@{SHARDS}", vocab, "cuda"),
                                   batch)
    cases += phase_kernels_sg(vocab, batch)
    torch.cuda.empty_cache()
    report_cases(cases)
    phase_done("phase 2")
    phase_step_parity("gather", vocab, batch)
    phase_step_parity("stencil", vocab, sbatch)
    phase_step_parity("stencil_shared", vocab, sbatch)
    phase_step_parity_sharded(vocab, batch)
    phase_step_parity("gather" + BF16, vocab, batch)
    phase_step_parity("stencil" + BF16, vocab, sbatch)
    phase_step_parity_sharded(vocab, batch, BF16)
    for path in ("sg", "sg_shared", "dense"):
        phase_step_parity(path, vocab, batch)
    phase_step_parity_async(vocab, corpus)
    phase_step_parity_hogwild(vocab, corpus)
    phase_done("phase 3")
    counts = {r: phase_train(r, vocab, corpus, card) for r in PATHS}
    phase_graph(vocab, corpus, card)
    phase_done("phase 4")
    phase_input(corpus, vocab, card)
    phase_done("phase 5")
    phase_cli("", PATHS["gather"][1])
    phase_cli("stencil: 1\n", PATHS["stencil"][1])
    phase_cli("", PATHS[f"gather@{SHARDS}"][1],
              cluster=f"server_num: {SHARDS}\ntransfer: tpu\n")
    phase_cli("", PATHS["gather" + BF16][1], server="dtype: bfloat16\n")
    phase_cli("", PATHS["gather"][1], worker="pipeline: 2\ninner_steps: 4\n")
    phase_cli("", PATHS["async"][1], variant="async")
    phase_cli("", PATHS["hogwild"][1], variant="hogwild")
    phase_done("phase 6")
    for path in CKPT_PATHS:
        phase_checkpoint(path, vocab, corpus, card)
    counts["resume"] = phase_resume(vocab, corpus, card)
    phase_cli_checkpoint(card)
    s2v_cases, counts["sent2vec"] = phase_sent2vec(vocab, corpus, card)
    report_cases(s2v_cases)
    cases += s2v_cases
    phase_done("phase 7")
    lr_cases, lr_counts = phase_lr_glove(vocab, corpus, card)
    cases += lr_cases
    counts.update(lr_counts)
    hybrid_cases, hybrid_counts = phase_hybrid(vocab, corpus, batch, sbatch,
                                               card)
    cases += hybrid_cases
    counts.update(hybrid_counts)
    window_cases, window_counts = phase_window(vocab, corpus, card)
    cases += window_cases
    counts.update(window_counts)
    wire_cases, wire_counts = phase_wire(vocab, corpus, card)
    cases += wire_cases
    counts.update(wire_counts)
    counts.update(phase_telemetry(vocab, corpus, card))
    serve_cases, serve_counts = phase_serve(vocab, corpus, card)
    cases += serve_cases
    counts.update(serve_counts)
    proc_cases, proc_counts, proc_xla = phase_processes(vocab, corpus,
                                                        card)
    cases += proc_cases
    counts.update(proc_counts)
    fleet_cases, fleet_counts = phase_fleet(corpus, card)
    cases += fleet_cases
    counts.update(fleet_counts)
    da_cases, da_counts = phase_data_axis(vocab, corpus, card)
    cases += da_cases
    counts.update(da_counts)
    tfm_cases, tfm_counts = phase_transformer(card)
    cases += tfm_cases
    counts.update(tfm_counts)
    dp_cases, dp_counts, collectives = phase_tfm_dp(vocab, corpus, card)
    cases += dp_cases
    counts.update(dp_counts)
    pub_cases, pub_counts = phase_public(vocab, corpus, batch, collectives,
                                         card)
    cases += pub_cases
    counts.update(pub_counts)
    wide_cases, wide_counts = phase_wide(vocab, corpus, proc_xla, card)
    cases += wide_cases
    counts.update(wide_counts)

    summary = []
    for c in cases:
        name = c.get("counter", c["module"].__name__.rsplit(".", 1)[-1])
        summary.append({
            "name": c["name"], "route": c["route"], "source": c["source"],
            "replaces": c["replaces"], "launches": counts[c["path"]][name],
            "path": c["path"], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    print(card, flush=True)
    _json_line({"kernels": summary})
    _json_line({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
