#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the card.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports the port (``flink_jpmml_tpu_torch``) and nothing of JAX or the
JAX package, and prints one JSON line per phase:

1. card — the ``nvidia-smi`` name / power-limit line and the torch device;
2. build — compiles ``flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu`` (the
   leaf-rows kernel, one instance per class bucket) with nvcc for sm_90a
   (into ``build/``), binds it, and prints what ptxas reported for each
   instance (registers, static shared memory, stack, spills); any spill
   fails the phase;
3. kernel — the kernel (one f32 row per leaf: the GBM's leaf values)
   against its plain PyTorch version on the card, bit for bit, at the main
   path's shape (the 500-tree, depth-6, 32-feature GBM, [262144, 32] uint8
   codes with about 20% missing cells), on a 19-tree model, and on a batch
   whose length is not a multiple of a block's records;
4. walk kernel — the same check on seeded forests the fixtures lack
   (``ragged_forest``: 200 trees of depths 1-12 with single-leaf trees and
   padded split and leaf slots, at C = 1 and C = 3, and at C = 16 over 256
   fields, where a block shrinks to 64 threads; ``caterpillar_forest``: a
   64-split chain of depth 64 and 65 leaves, at C = 1 and C = 16), over
   random codes with 20% missing and ragged batch lengths;
5. timing — CUDA-event medians of the kernel and of the plain version at
   the main path's shape, beside the least time the card could take for
   the work these inputs need (``ops``: one integer step per split on each
   tree's hit path, C f32 adds per tree; ``bytes``: codes, the kernel's
   table and output once); beside them ``design_int_steps``, N × Σ
   depth[t] from the table's headers: the steps the walk is built to take,
   a count from the design, not a reading of the card;
6. main path — ``gen_gbm`` → ``parse_pmml_file`` → ``compile_pmml``
   (batch 16384, default device: the card) → ``BlockPipeline`` over a
   ``CyclingBlockSource`` in dispatches of 262,144 records, for at least
   16 dispatches; the kernel's launch count is reset just before and read
   just after, and a 4,096-record sample is scored again on the CPU
   (``device="cpu"``, the kernel's plain version) and, on the card, by the
   torch twin of the XLA scorer from the unpacked path matrix (``P_i8`` /
   ``count_i8``), which does not go through the kernel's table packer;
7. vote kernel — the same kernel with the class rows of a vote forest
   against its plain version on the card, bit for bit: the 500-tree,
   depth-6, 32-feature, 3-class majorityVote forest (``gen_vote_forest``)
   at [262144, 32] with about 20% missing cells, its weightedMajorityVote
   twin, a 19-tree forest, a 10-class forest and a 100,003-row batch;
8. vote timing — as 5, for the vote forest;
9. vote main path — as 6, over the majorityVote forest, with a sink that
   takes the (value, shares, label) triple. The 4,096-record head is held
   to the CPU port and to the torch twin at rtol 1e-4 / atol 1e-5 for
   shares and values; labels must be equal on rows whose classes do not
   tie on vote count, and on a tied row the kernel path's label is the
   lowest tied class and the other's one of the tied classes (the twin's
   f32 contraction rounds tied totals in an order of its own). Ties are
   found from exact integer vote counts.

10. native — builds the C++ host data plane
    (``flink_jpmml_tpu_torch/_native/fjt_native.cpp``, g++) and prints its
    build seconds and the host's core count; holds the C++ bucketizer
    (``QuantizedWire.encode``) byte for byte to its plain version
    (``encode_reference``, numpy) on the GBM's uint8 lockstep tables, a
    skewed uint8 wire that takes the ragged branch, a uint16 model
    (``gen_gbm(hist_bins=None)``) and a skewed uint16 wire, over cells
    with NaN, ±inf, exact cut values and ±0.0 (``edge_cells``); and
    times both at [262144, 32] on the host (median ms);
11. encode stage — the device encode stage (``encode_device``) on the
    card against the host encode, byte for byte and dtype for dtype, on
    the GBM, the vote forest and the uint16 model, with the same cells;
    its CUDA-event median ms per 262,144 records; and the uint16 model
    scored on the card host-encoded and fused (the torch twin over a
    staged uint16 batch) against the CPU port;
12. fused main path / vote fused main path — 6 and 9 again with no
    ``encode_mode`` set, so the scorer takes its own placement on the
    card, which must be fused: raw f32 ships (128 bytes a record) and the
    encode stage runs on the card in front of the kernel; the heads are
    held to the CPU port as in 6 and 9;
13. kafka wire — a port ``MiniKafkaBroker`` on loopback holding 1,048,576
    rows of the GBM's feature stream (the main paths' generator, seed 0;
    128 MiB of values) appended with ``append_rows`` (the C++ encoder);
    read back through ``KafkaClient`` and ``decode_record_batches_rows``,
    rows and offsets byte-identical to the appended array; the C++,
    vectorized and Python row decoders equal on the log's first 20,480
    records; the append seconds, and the C++ and vectorized decoders'
    host ms per 262,144 rows beside the host's core count;
14. kafka main path — the fused GBM scored by ``BlockPipeline`` (as in
    6, no ``encode_mode`` set) from a ``KafkaBlockSource`` over that
    broker, which seeks back to 0 at the high watermark (``max_wait_ms``
    20, the default ``max_bytes``: about 30,000 records a fetch), through
    the prefetch sidecar, with one registry shared by the source and the
    pipeline, until 19 × 262,144 records reached the sink; the first
    4,096-record head is held to the CPU port at rtol 1e-4 / atol 1e-5;
    its dispatches are deadline drains, yet only their live rows cross
    the bus, so it must ship 128 bytes a record like 12; it prints the
    decode and fetch times, the prefetch counters, the ``kafka_lag``
    gauge and its age, the lag forecaster, the pressure score and the
    record count of every dispatch;
15. kafka main path serial — 14 again with ``prefetch=False``: fetch and
    decode on the pipeline's ingest thread, the sidecar's ablation; then
    kafka keyed topic (``kafka_keyed_topic``) — 262,144 rows of the
    feature stream keyed by 10,000 users over 3 partitions
    (``append_rows_keyed``), each partition compacted by a run of 4,096
    offsets from its middle, consumed by the fused GBM's checkpointed
    ``BlockPipeline`` through a ``KafkaBlockSource`` on the three
    partitions (``interleave="auto"``), stopped at a third of the
    survivors and resumed by a fresh pipeline from the checkpointed
    offset vector: every survivor scored exactly once, the scores bit
    equal to the plain walk's on the same rows, one kernel launch a
    dispatch in each life;
16. device shares — for each main path, the kernel's, the encode
    stage's and the H2D copy's timed milliseconds times the dispatches,
    over the wall: an estimate of the card's idle share (the H2D copies
    of 262,144 records' codes and f32 cells from pinned memory are timed
    in phase 11); for the Kafka paths, whose dispatches hold what the
    ring held, the kernel, the encode stage and the H2D copy are timed at
    each dispatch size the path ran (K compile batches) and weighted by
    its dispatches and live rows;
17. family paths — the dense families on ``BlockPipeline``'s f32 backend
    (no kernel is on these paths; their products are ``torch.matmul`` with
    TF32 off, which the phase asserts): ``gen_iris_lr(seed=7)`` (4 fields,
    3 classes, softmax) at compile batch 16,384 for at least 1,048,576
    records; ``gen_mlp()`` (784→256→10, rectifier, softmax) at 16,384 for
    262,144; ``gen_kmeans()`` (k = 5, 4 fields) with ``entityId`` /
    ``affinity`` outputs at 16,384 for 1,048,576; ``gen_stacked(n_trees=50,
    depth=4, n_features=10_000, wide_lr=True)`` at 2,048 for 131,072; and
    a probit GeneralRegressionModel (``glm_probit_xml``) at 16,384 for
    262,144. Each line: records/s, batch latency p50 / p99, H2D bytes a
    record, the backend tag (``f32``), the model function's and the H2D
    copy's CUDA-event ms a dispatch and the idle share they imply, the
    stage ledger; the first 4,096 records (2,048 for the stacked chain)
    held to the CPU port at rtol 1e-4 / atol 1e-5 with labels equal, and
    ``score_records`` on 16 records (outputs decoded) too.
18. tree shapes — the tree shapes and rule families the rank wire
    declines (``quantized_scorer()`` must be None), on the f32 backend
    (no kernel; torch gathers, ``torch.where`` and float32 products with
    TF32 off): ``deep_rf_xml()`` (a RandomForestRegressor export: 100
    trees of 1,024–2,048 leaves, depth 11–24, 32 fields; the node hop)
    with ``defaultChild`` and again with ``lastPrediction`` (the halt
    carry), at 16 compile batches a dispatch for at least 1,048,576
    records;
    ``general_forest_xml()`` (rpart-style surrogate splits, a set split in
    four over 8-valued categorical fields; the general scan) at 8 for
    262,144 (the other counts are minimums too); ``select_first_xml()`` (4 quartile-gated 100-tree GBMs) at 4
    for 262,144; ``iforest_xml()`` (an AnomalyDetectionModel over 100
    isolation trees of depth ≤ 8) at 1 for 262,144; ``scorecard_xml()``
    (10 × 5, reason codes 1–3) and ``ruleset_xml()`` under each of its
    three criteria at 16 for 262,144; and the JAX tests' weightedConfidence
    / aggregateNodes trees and selectAll fixture at 4 for 65,536, the first
    dispatch held whole. Each line as in 17, plus the card's peak
    allocated memory; heads held to the CPU port as in 17, and
    ``score_records`` (reason codes, segment maps) on 4,096 records for
    the scorecard and rulesets, 16 otherwise, with its own records/s.
19. more families — the last nine families on the f32 backend (no kernel
    either: ``torch.matmul`` with TF32 off, ``torch.sort(stable=True)``
    for the neighbours), each compiled on the card and warmed with
    ``warmup()``, at the widths their exporters write:
    ``naive_bayes_xml()`` (GaussianNB with categorical inputs: 3 classes,
    24 continuous and 8 ten-valued fields) at 16 compile batches a
    dispatch for 1,048,576 records; ``svm_xml()`` (an SVC(kernel="rbf")
    export: OneAgainstOne, 4 classes, 2,000 support vectors × 32 fields)
    and ``svm_xml("poly", n_vectors=1000)`` (an SVR, degree 3) at 4 for
    262,144; ``knn_xml()`` (a KNeighborsClassifier: 10,000 instances × 16
    fields, 5% duplicated rows, k = 5, ``entityId`` outputs at ranks 1–5)
    and its median twin (k = 4) at 4,096 records a dispatch for 65,536;
    ``gp_xml()`` (ARD squared exponential, 2,000 rows × 8 fields) at 4 for
    262,144 and ``gp_xml("absexp", n_rows=1000)`` at 1; ``bayesnet_xml()``
    (a 4-state target, 10 observed children of 3–5 states, 3 with a
    second parent) and ``baseline_xml()`` at 16 for 1,048,576;
    ``assoc_xml()`` (arules Apriori: 200 items, 1,000 rules,
    recommendation, ``ruleValue`` outputs; baskets at 5% density) at 4
    for 262,144; ``text_xml()`` (1,000 terms × 2,000 documents, tf·idf,
    cosine) at 1 for 131,072; ``arima_xml()`` (ARIMA(2,1,1), 200 points)
    and ``holt_winters_xml()`` (damped additive trend, multiplicative
    seasonality of 12) at 16 for 1,048,576 over horizons 1–48. Records
    are N(0, 1.5) (numpy, seed 10), with 20% missing cells only where the
    family routes them (NaiveBayes, baskets, term counts). Each line as in
    18; heads held to the CPU port (KNN neighbour ids and the fired-rule
    mask exactly) and ``score_records`` on 4,096 records, outputs
    decoded. Last, ``verify()`` on the card over the JAX tests'
    ModelVerification documents returns ``[]``, and a copy of each with
    one expected value altered reports the CPU port's mismatch.
20. record api — the record engine and dynamic serving on the card, with
    the main path's GBM (compile batch 16,384) and 3-class vote forest,
    over N(0, 1.5) vectors with 20% missing cells (seed 0): ``static``,
    ``StreamEnvironment().from_collection(vectors).evaluate(
    ModelReader(gbm))`` over 262,144 dense vectors; ``quick``, the same
    through ``quick_evaluate`` ((prediction, vector) pairs in order);
    ``dicts``, 65,536 dict records through ``evaluate``; ``dynamic``,
    ``with_control_stream(ctrl).evaluate(ModelReader(gbm))`` over 262,144
    events (45% gbm, 45% votes, 10% an unserved name): Add gbm v1 and
    votes v1 before the run, Add gbm v2 (``gen_gbm(seed=12)``, the same
    width) once the first quarter is submitted, Del gbm v1 once the first
    half is submitted and v2 is warm, and after it a quarter of the gbm
    events pinned to v1; ``kafka``, a port ``MiniKafkaBroker`` holding
    65,536 JSON records of the GBM's 32 fields →
    ``from_source(KafkaRecordSource(...))`` → ``evaluate``, through the
    prefetch sidecar; and ``verify``, ``ModelReader(path).load()`` on the
    card over the ModelVerification documents (an altered copy raises the
    CPU port's ``ModelVerificationException``). Each run's first 4,096
    outputs are held to the CPU port at rtol 1e-4 / atol 1e-5 (vote
    labels equal); the dynamic run's empty lanes must be exactly the
    unserved and the v1-pinned-after-Del events, each vote event and each
    unpinned gbm event is held to the card's direct run of its model (v1
    before the swap, v2 after, and v2 after the Del), each micro-batch
    makes one dispatch a served model present, and the kernel's launches
    equal the rank-wire dispatches (plus, in the dynamic run, v2's warm).
    Each part prints records/s, ``record_latency_s`` (and
    ``score_latency_s``) p50 / p99, the ``StageTimer`` stages, the stage
    ledger, the launches; the dynamic part ``cold_start_s`` and the warm
    pool's hits and misses; the Kafka part the sidecar's counters.
21. recovery — checkpoints, the DLQ, the device-fault ladder and
    ``DynamicBlockPipeline`` on the card, with the main path's GBM and
    the 3-class vote forest over 1,048,576 N(0, 1.5) vectors (20% missing
    cells, seed 13); every delivery is held to the card's direct run of
    the same records (host encode, ``predict_padded``) at rtol 1e-4 /
    atol 1e-5, vote labels equal, and every part holds the kernel's
    launches to the window's ``dispatches`` plus the ``redispatches``
    the ladder and the suspect scan made plus the registry's warms.
    ``checkpoint``: a ``BlockPipeline`` (dispatches of 65,536, a snapshot
    after every one) stopped after two snapshots committed, later ones
    skipped as if the worker died, then a fresh pipeline ``restore()``s
    and runs to the end: every offset sunk, each duplicate at or after
    the restored offset. ``poison``: poison at offsets 12,345, 400,000
    and 1,000,000 through the ``score_batch`` site, the DLQ beside the
    checkpoints: the DLQ holds exactly those, every other record is sunk
    once, and the suspect scan's bisection launches on the card.
    ``device_fault``: over 2,097,152 records, ``InjectedDeviceError`` on
    two dispatches and ``InjectedDeviceOOM`` on one (at its dispatch and
    its first full redispatch), armed from the sink: five redispatches,
    one OOM shrink, ``fallback_records`` 0. ``real_errors``: a real
    ``torch.cuda.OutOfMemoryError`` classifies as ``device_oom`` and the
    card scores after it; a child process (``CHILD_STICKY``, the 19-tree
    GBM) scores one block, trips a device-side assert with an
    out-of-range index, and its pipeline must classify the next dispatch's
    error as ``chip_loss`` and escalate with a raise and no redispatch.
    ``dynamic``: ``DynamicBlockPipeline`` serving the GBM (Add v1, Add v2
    at a quarter, Del v1 once v2 is warm, checkpointed; a fresh pipeline
    restores and serves v2 on 65,536 more records), a second one serving
    the vote forest over 262,144 records, a default ``DynamicScorer``
    with one injected device error on a group's readback over 65,536
    events, and the record engine's
    ``evaluate(...).with_checkpointing(dir)`` with
    ``execute(restore=True)`` twice (32,768 events, then a fresh
    environment resuming over 16,384 more). ``cost``: the fused GBM's
    ``BlockPipeline`` records/s over 16 dispatches of 262,144 plain and
    with checkpoints (every second) plus the DLQ armed, twice in the
    order plain, armed, armed, plain.
22. serving edge — overload control, SLO burn rate, journeys, span files,
    the framed-TCP feed and a remote model path, on the card, with the
    main path's GBM on the fused placement and the 3-class vote forest;
    every delivery is held to the card's direct run and every part holds
    the kernel's launches to the dispatches it counted. ``overload``: the
    JAX package's overload drill (``bench.run_overload_drill``) with an
    ``AdaptiveBatcher`` (its capacity model in the port's cache, keyed by
    the card's name) and an ``AdmissionController`` on the ``block``
    lane, over a paced source of 131,072-record blocks (one aggregated
    dispatch each) cycling a 262,144-record pool, through a ring of 8
    blocks: capacity measured unpaced over 5 s (a paced phase's length),
    each measured phase started with nothing queued, the gate open and
    the batcher's cap where it was before the surge, the deadline 5 × the
    predicted single-batch latency clamped to [100 ms, 2 s], then 80% of
    capacity (p99 ≤ deadline), 150% (``shed_records`` > 0, p99 ≤ 10 ×
    max(deadline, base p99)) and 80% again (p99 < max(1.05 × base, base
    + 10 ms)); the sink's ranges and the shed batches tile the committed
    offsets exactly, and launches equal the accounted dispatches.
    ``scorer``: a ``DynamicScorer(admission=, lane_fn=)`` serving the GBM
    and the vote forest over 3 micro-batches of 16,384 dict events with
    the "low" lane held shed (the last micro-batch all "low"): shed
    events empty, launches equal the groups dispatched, and with
    ``FJT_SLO_TARGET_MS`` set the SLO gauges in its registry.
    ``oom_cap``: ``device_oom`` at the ``device_dispatch`` site three
    times into a checkpointed pipeline with a batcher: ``adaptive_batch``
    pins at the largest size the OOM bisection proved, and every later
    delivery stays at or under it. ``journey``: a Kafka-fed,
    checkpointed pipeline with ``FJT_JOURNEY_DIR`` armed and a poison at
    offset 300,000: its rows show ``ingest``, ``dispatch``,
    ``suspect_scan`` and a ``dlq`` terminal with ``reason=score``, and the
    DLQ envelope carries the terminal's ids; ``journey_cost``: the fused
    GBM plain against journey-armed, four runs each. ``spans``: with
    ``FJT_TRACE_DIR`` set the span file parses and holds one
    ``h2d_dispatch``, one ``readback`` and one ``sink`` span a dispatch.
    ``net_remote``: ``BlockFrameServer`` → ``TcpBlockSource`` →
    ``BlockPipeline``, and the GBM loaded from a loopback ``http.server``
    through ``ModelReader("http://...")``, its second load a 304 with no
    recompile.
23. kernel search — ``compile/autotune.py`` on the card over fresh builds
    of the main path's GBM and the 3-class vote forest at 262,144 rows:
    every candidate of the space (the kernel's launch shape × the walk
    layout, ``ref`` / ``bfs``) launched on 16,384 records and held bit for
    bit to today's launch and to the plain version; the sweep (the GBM
    bootstraps, 8 candidates timed on a cold ledger; the vote forest
    ranks by the fit that gave, top 5), the winner stored in the port's
    cache under the run's scratch HOME and adopted by a second build with
    no launch; then the tuned GBM through ``BlockPipeline`` for 19
    dispatches with the profiler sampling every 50 ms: ``device_samples``,
    ``device_mfu`` (the walk's path steps against the H100's INT32 rate),
    ``device_membw_util`` and the cost ledger's row.
24. zoo_state — multi-tenant and stateful scoring. ``packed_kernel``:
    the packed launch (``qtrees_leaf_rows_packed``) against each member's
    solo launch and its plain version, bit for bit: 16 zoo members at 256
    rows, packs mixing C = 1 with 3- and 16-class vote forests, ragged row
    counts (0 to 256), row counts one short of, at and one over the
    launch's tiles, the soak's six zoo tenants, and eight members of the
    main path's shape (``gen_gbm(500, depth=6, n_features=32)``, seeds
    11-18, compiled in worker processes on the host) at tile-edge rows and
    at 16,384 rows each. The latter, 16 zoo members at 256 rows and the
    soak's pack are timed in CUDA-event medians (the wrapper's host work
    included) beside their bound and share of it, the launch's threads,
    records a thread, blocks, shared memory and resident blocks an SM (the
    runtime's occupancy calculator's, and the shape rule's); the eight
    members also against their eight solo launches back to back. ``zoo``: the JAX zoo
    drill's geometry (1,000 registered tenants cycling 10 ``gen_gbm``
    documents of 6-15 trees, depth 3, 4 features, seeds 100-109; 100 hot
    with 1,024 records each, 1% missing, batch 256): a one-tenant
    baseline, the solo oracle and ``DynamicScorer(zoo=True)``; every
    (tenant, record) equal to the oracle's, pack dispatches and packed
    launches counted (the counts zeroed just before the zoo run), then a
    ``device_error`` at a pack's readback re-dispatched with parity held;
    ``zoo_rps`` against the baseline is printed beside the JAX drill's
    0.75, not gated. ``stateful``: the JAX stateful drill's geometry
    (``gen_gbm(20, depth=4, 8 features, seed 29)``, batch 8,192, a 2^21-row
    table, 10,000,000 keys, a sweep and a zipf a = 1.1 mix of 10,485,760
    records each) against the stateless loop; the zipf stream run twice
    more must give the same table bytes; a 2,048-key sample of a
    262,144-record prefix held to the CPU port (count, last-seen, min, max
    exact; sums rtol 1e-5 / atol 1e-6); then the JAX SIGKILL replay at its
    sizes (49,152 records, 16,384 keys, capacity 32,768, batch 1,024, two
    SIGKILLs) with the workers on the card: the final table the same bytes
    as an uninterrupted life's.
25. rollout_drift — the data-drift plane and staged rollouts, with the
    main path's GBM (BASELINE config 2: ``gen_gbm(500, depth=6,
    n_features=32, seed=11, hist_bins=254)``) on the fused placement over
    N(0, 1.5) records with 20% missing cells. ``drift_drill``: the JAX
    drift drill (``bench.run_drift_drill``) at this width: two registries
    share the scorer and score alternating batches of 16,384 through
    ``dispatch_quantized`` with the plane armed at interval 0; 262,144
    records (seed 31) snapshotted as the baseline through a
    ``BaselineStore`` on disk, then 262,144 more (seed 32) with feature 1
    shifted by 4 sigmas: a fleet ``DriftMonitor`` over the merged structs
    alarms on feature 1 and no other feature, the merged sketch's
    quantiles equal those of merging the worker states directly, and
    every armed batch gives the same bytes as the same batch unarmed.
    ``drift_cost``: the fused GBM's ``drive`` (19 dispatches of 262,144)
    unarmed and armed (interval 0, the 2% ``FJT_DRIFT_BUDGET``), three
    alternating pairs: outputs sampled every 4,096 records equal in all
    six, records/s, the plane's ``overhead_fraction`` (within its budget
    plus one sample's cost, the most its gate admits) and its claimed
    batches. ``rollout``: the JAX rollout drill and the
    tests/test_rollout.py scenarios through ``DynamicScorer`` (batch
    16,384, 131,072 keyed dict events a run, seed 33): v1 alone; a byte
    copy as v2 in shadow (two launches a batch, nothing of it emitted,
    0 disagreements), promoted to canary by a controller tick; the canary
    split at 0.2 within 1% absolute, a scorer restored from the
    checkpoint mid-canary resuming the stage and giving the same bytes,
    promoted to full; then on a fresh scorer ``gen_gbm(seed=12)`` as v3 in
    canary beside v1, every emitted prediction within rtol 1e-4 / atol
    1e-5 of its serving version's direct launch, rolled back for
    disagreement. ``state``: one stateful
    fused ``BlockPipeline`` run (8 batches of 16,384, a 2^16-slot table)
    unarmed and armed: the armed run sketches ``<model_hash>#state``,
    and outputs and table bytes are equal. The zoo drill of 24 also runs
    the JAX zoo bench's rollout and drift parts.
26. mesh — the parallel plane on the card's 1×1 mesh (``make_mesh()``
    over every card; the line prints ``torch.cuda.device_count()``; no
    kernel runs here: a sharded model scores on the f32 path). BASELINE
    config 5 at its published widths (``gen_stacked(n_trees=50, depth=4,
    n_features=10_000, wide_lr=True)``, batch 2,048, 131,072 records, as
    ``family_configs`` builds it) compiled with ``mesh=`` and driven
    through ``BlockPipeline(mesh=)`` beside the unsharded model on the
    same data, in turns (unsharded, sharded, sharded, unsharded): every
    head equal to the unsharded runs' (the same ops on the same batch),
    within rtol 1e-4 / atol 1e-5 of the CPU port, no model-axis leaf at
    1×1, records/s, batch p50 / p99 and peak allocated bytes of each run
    printed. The main-path GBM (``gen_gbm(500)``) on
    the f32 path through ``BlockPipeline(mesh=)`` held to the CPU port.
    ``TpLinearScorer`` (10,000 × 2) and ``mp_gp`` (the 2,000-row GP) at
    1×1 against the plain product on the card with TF32 off.
    ``DynamicBlockPipeline(mesh=)`` warms config 5 sharded and delivers
    outputs equal to the direct sharded run. An injected ``chip_loss`` on
    the 1×1 mesh escalates with the raise: no mesh rebuild, no record
    delivered twice. A keyed state table sharded on the 1×1 mesh stays
    one tensor and gives the unsharded table's bytes after the same
    stream.
27. fleet — the supervised fleet (``runtime/supervisor.py``,
    ``obs/server.py``, ``obs/history.py``) with its workers on the card.
    ``kill_resume``: the JAX kill -9 drill at config 2 — one supervised
    worker scores the fused GBM through a checkpointed ``BlockPipeline``
    (batch 16,384) from a port ``MiniKafkaBroker`` holding 1,048,576 rows
    of the main paths' generator, is SIGKILLed once a checkpoint has
    committed a third of the stream and restarted by the supervisor
    alone: no gap, exactly once below the restore point, at most twice in
    the replay window, every score within rtol 1e-4 / atol 1e-5 of the
    direct run. ``rollout``: two workers serve the GBM as v1 through
    ``DynamicScorer`` with the seed-12 candidate at canary 0.2; the
    supervisor's ``rollout_controller()`` judges the merged heartbeat
    structs and ``broadcast_rollout`` carries the rollback; one worker is
    SIGKILLed and its next incarnation converges on its first beat; every
    worker's answers after convergence equal v1's direct scores. While
    both run, the supervisor's obs server is scraped (``/metrics``
    aggregate = sum of the worker series, ``/varz`` quantiles = the
    merge, ``/healthz``, ``/history?source=_fleet``), the killed
    incarnation's history frames are read back, and downsample(merge)
    equals merge(downsample) as strings on the run's frames. Each
    incarnation's start seconds (spawn to first beat) and largest beat gap
    are printed, and no worker pid may be alive at the end. Workers send
    stdout to ``/dev/null`` and stderr to a file per incarnation, whose
    tails a failure prints.
28. cli — the operator's entry points (``cli.py``, ``utils/demo.py``,
    ``examples_torch/``), each in a subprocess whose stdout and stderr go
    to files in the run's temporary directory. ``score``: ``python -m
    flink_jpmml_tpu_torch.cli`` (``fjt-score``) over a CSV of 65,536 rows
    of the main paths' generator (missing cells empty) against
    ``gbm_500.pmml`` at ``--batch 16384`` on the card, every line within
    rtol 1e-4 / atol 1e-5 of this process's ``score_records``, the empty
    records empty, the stderr count 65,536. ``redrive``: 64 main-path rows
    quarantined with trace contexts (plus one duplicate envelope),
    redriven by ``fjt-dlq redrive`` in a process that sees no card into a
    port ``MiniKafkaBroker``, consumed by a ``KafkaBlockSource`` feeding
    a ``BlockPipeline`` over the fused GBM: exactly 64 records, scores
    equal to the direct run's, each ``traceparent`` read back as its
    envelope's. ``examples``: ``examples_torch/gbm_throughput.py
    --seconds 2`` and ``examples_torch/kafka_stream.py`` on the card, each
    run by ``runpy`` in a child that sets the kernel's count to 0 and
    prints it after the job; that count, held to the dispatches and
    redispatches of the metrics the job printed (plus gbm_throughput's
    one warm launch), is the kernel's launches on this path beside part
    b's own. The kernel is also held bit for bit to its plain version at
    ``kafka_stream``'s shape (50 trees of depth 5 over 8 fields, blocks
    of 256 rows), which no other phase gives it.
29. soak — the random-model parity soak and the chaos soaks
    (``flink_jpmml_tpu_torch/tools/fuzz_soak.py``) on the card: the seven
    families, 8 seeds each from 100,000, each seed's model compiled on
    the card and held lane by lane to the oracle at the JAX bar (rel 2e-4
    / abs 2e-5; its line has the seeds clean and the largest value error
    of each family); ``--chaos`` for 3 seeds over the tool's own model
    and 1 seed over config 2's GBM (``gen_gbm`` 500 trees, depth 6, 32
    fields, seed 11) at compile batch 32; ``--zoo`` for 2 seeds (its
    packs through ``qtrees_leaf_rows_packed``); ``--stateful`` for 1 seed,
    its workers on the card, beside the others in a thread; and the
    ``--mesh`` profile, which must refuse a one-card host, naming the
    count. The kernels' counts are set to 0 before the chaos and zoo
    profiles and read after them (the stateful workers launch in their
    own processes: their last incarnation's count is printed apart), and
    each kernel is held bit for bit to its plain version at the
    profiles' shapes. A cut seed is listed in the line's ``cuts``.

Every main path runs the C++ ring, and its line carries the stage ledger
of its registry (``attribution``: per stage the count, total ms, p50 /
p99 ms and share of ``obs.attr.summary``; on the card ``h2d`` is host
staging plus the issue of the copy, and the card's time shows up as
``queue_wait`` and ``readback``). Phases 6 and 9 set the scorer's
``encode_mode = "host"`` (the C++ bucketizer); each main path prints the
encode placement that ran (``encode_mode``), with ``h2d_bytes`` per
record: 32 host-encoded, 128 fused.

The generators (``ragged_forest``, ``caterpillar_forest``,
``random_codes``, ``edge_cells``, ``synthetic_wire``) import nothing
beyond numpy and torch and the port; the CPU tests import them too, so
the card and the CPU see the same trees and cells.

Then the kernels line, the ``nvidia-smi`` line, and last the contract
line ``{"ok": true, "device": {...}}``. ``python3 chip_smoke.py --ab
OTHER_CHECKOUT`` instead times the fused GBM's block path in child
processes alternating between another checkout and this one
(``ab_main``); ``--ab OTHER_CHECKOUT packed`` times the packed launch at
the three timed packs the same way (``ab_packed_main``); ``--ab
OTHER_CHECKOUT state`` the stateful drill's zipf mix and its state step
(``ab_state_main``);
``--packed-sweep`` times the packed launch at every block its shape rule
chooses from (``packed_sweep_main``); and ``python3 chip_smoke.py
--phase NAME`` runs one phase alone (``serving_edge``, ``kernel_search``, ``zoo_state``,
``rollout_drift``, ``kafka_keyed_topic``, ``mesh``, ``fleet``, ``cli`` or
``soak``) with what it
needs built
(``run_phase_alone``). After the last phase a ``run`` line prints the
whole run's seconds. Any failed phase raises, and the
script exits non-zero without printing the last line. Without a CUDA
device, or without the port beside it, it exits 1 at once. The flight
recorder's directory and the generated model files live in a temporary
directory that the run removes, as do the autotune cache, the kernel
cost ledger and the cost model (``FJT_AUTOTUNE_CACHE`` there; the kernel
search phase's own cache under a scratch HOME); the broker, the source
and the pipelines' threads are stopped whether a phase passes or fails.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np

RTOL, ATOL = 1e-4, 1e-5  # the repo's rank-wire bar (tests/test_qtrees_pallas.py)
BATCH = 16384  # compile batch (bench.py --chunk)
DISPATCH = 262144  # records per dispatch (bench.py --batch)
MIN_DISPATCHES = 16
MISSING = 0.2
# H100 SXM peaks: HBM bytes/s (data sheet), and the issue rate of the
# INT32 pipe that runs the kernel's integer compare/select/and steps:
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost (the data sheet's 67 TFLOP/s
# float32 figure is the FP32 pipe, 128 lanes, with an FMA as two ops).
# Each step is taken as at least one instruction, so the bound is a floor.
# f32 adds run on the FP32 pipe, at the data sheet's 67 TFLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 132 * 64 * 1.98e9
PEAK_F32_FLOP_S = 67e12


def _grow(rng, depth: int, n_splits: int) -> list:
    """A random full binary tree of exactly ``depth`` levels and
    ``n_splits`` splits, as its leaves' paths: lists of (split, +1 left /
    -1 right) from the root, splits numbered as they were made."""
    paths = [[]]
    made = 0
    while made < n_splits:
        deep = [i for i, p in enumerate(paths) if len(p) < depth]
        longest = max(len(p) for p in paths)
        if longest < depth:  # first reach the depth, then grow at random
            deep = [i for i in deep if len(paths[i]) == longest]
        p = paths.pop(deep[int(rng.integers(len(deep)))])
        paths += [p + [(made, 1)], p + [(made, -1)]]
        made += 1
    return paths


def _caterpillar_paths(n_splits: int) -> list:
    """Split k's left child is leaf k, its right one split k + 1; the last
    split's right child is the last leaf: ``n_splits + 1`` leaves, one of
    them at depth ``n_splits``."""
    return ([[(j, -1) for j in range(k)] + [(k, 1)] for k in range(n_splits)]
            + [[(j, -1) for j in range(n_splits)]])


def _single_leaf_paths() -> list:
    """A one-leaf tree as the compiler packs it: a manufactured no-op split
    (feature 0, the top rank, missing → left) with the leaf on both sides
    (flink_jpmml_tpu_torch/compile/trees.py pack_ensemble)."""
    return [[(0, 1)], [(0, -1)]]


def forest_inputs(trees: list, n_fields: int, n_classes: int, seed: int,
                  pad_splits: int = 0, pad_leaves: int = 0,
                  single: tuple = ()) -> dict:
    """``qtrees_cuda.pack_tables``'s keyword arguments for trees given as
    leaf paths: split and leaf slots in a random order per tree (so the
    walk cannot lean on preorder numbering), ``pad_*`` unused slots beyond
    the largest tree (padded leaves carry count -5), random features,
    thresholds, missing directions and leaf rows (a bf16 hi/lo pair). The
    trees numbered in ``single`` are single-leaf trees
    (``_single_leaf_paths``): their split is the no-op one and both
    leaves carry the same row."""
    import torch

    rng = np.random.default_rng(seed)
    n_split = [1 + max(s for p in paths for s, _ in p) for paths in trees]
    S = max(n_split) + pad_splits
    L = max(len(paths) for paths in trees) + pad_leaves
    T = len(trees)
    feat = rng.integers(0, n_fields, size=(T, S))
    qthr = rng.integers(0, 255, size=(T, S)).astype(np.uint8)
    dleft = rng.random(size=(T, S)) < 0.5
    P = np.zeros((T, S, L), np.int8)
    count = np.full((T, L), -5, np.int8)
    vals = rng.normal(0.0, 1.0, size=(T, L, n_classes)).astype(np.float32)
    for t, paths in enumerate(trees):
        slot = rng.permutation(S)[: n_split[t]]
        leaf = rng.permutation(L)[: len(paths)]
        if t in single:
            feat[t, slot[0]], qthr[t, slot[0]], dleft[t, slot[0]] = 0, 254, True
            vals[t, leaf[1]] = vals[t, leaf[0]]
        for l, path in zip(leaf, paths):
            count[t, l] = len(path)
            for s, go in path:
                P[t, slot[s], l] = go
    v = torch.from_numpy(vals if n_classes > 1 else vals[..., 0])
    hi = v.to(torch.bfloat16)
    lo = (v - hi.float()).to(torch.bfloat16)
    return dict(feat=feat, qthr=qthr, dleft=dleft, P=P, count=count, hi=hi,
                lo=lo, n_fields=n_fields)


def ragged_forest(seed: int, n_trees: int, n_fields: int,
                  n_classes: int) -> dict:
    """``pack_tables``'s inputs for a seeded forest of mixed depths 1-12
    (up to 60 splits a tree), with single-leaf trees among them and padded
    split and leaf slots."""
    rng = np.random.default_rng(seed)
    # every depth once in each 12 trees, in a shuffled order
    depths = rng.permutation(np.resize(np.arange(1, 13), n_trees))
    single = tuple(range(3, n_trees, 17))
    trees = []
    for t, depth in enumerate(depths.tolist()):
        if t in single:
            trees.append(_single_leaf_paths())
            continue
        hi = min(60, 2 ** depth - 1)
        trees.append(_grow(rng, depth, int(rng.integers(depth, hi + 1))))
    return forest_inputs(trees, n_fields, n_classes, seed + 1,
                         pad_splits=2, pad_leaves=3, single=single)


def caterpillar_forest(seed: int, n_fields: int, n_classes: int) -> dict:
    """``pack_tables``'s inputs for three trees: the 64-split caterpillar
    (depth 64, 65 leaves: every split and leaf slot of the kernel's widest
    tree), a complete depth-2 tree and a single-leaf tree."""
    rng = np.random.default_rng(seed)
    trees = [_caterpillar_paths(64), _grow(rng, 2, 3), _single_leaf_paths()]
    out = forest_inputs(trees, n_fields, n_classes, seed + 1, single=(2,))
    # low thresholds and missing → right, so that records go deep: each
    # split sends ~3% of the uniform codes and ~5% of the missing ones left
    out["qthr"][0] = rng.integers(0, 16, size=64)
    out["dleft"][0] = rng.random(size=64) < 0.05
    return out


def random_codes(seed: int, n: int, n_fields: int, missing: float):
    """u8[n, F] rank codes: uniform over 0..254, ``missing`` of them the
    sentinel 255."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 255, size=(n, n_fields)).astype(np.uint8)
    codes[rng.random(size=codes.shape) < missing] = 255
    return codes


def edge_cells(rng, cuts, n: int) -> np.ndarray:
    """f32[n, F] cells for the encode checks: N(0, 1.5) values, with 20%
    NaN, 2% +inf, 2% -inf, 3% -0.0, 3% +0.0 and 10% exact cut values of
    the cell's own feature (where it has cuts)."""
    F = len(cuts)
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    u = rng.random(size=(n, F))
    for j, c in enumerate(cuts):
        sel = (u[:, j] >= 0.30) & (u[:, j] < 0.40)
        if len(c):
            X[sel, j] = c[rng.integers(0, len(c), size=int(sel.sum()))]
    X[u < MISSING] = np.nan
    X[(u >= 0.20) & (u < 0.22)] = np.inf
    X[(u >= 0.22) & (u < 0.24)] = -np.inf
    X[(u >= 0.24) & (u < 0.27)] = -0.0
    X[(u >= 0.27) & (u < 0.30)] = 0.0
    return X


def synthetic_wire(seed: int, sizes, dtype):
    """A rank wire over made-up cut tables of the given sizes (0.0 among
    each non-empty table, so ±0.0 cells meet a cut), uint8 or uint16,
    with a missingValueReplacement on every third field."""
    from flink_jpmml_tpu_torch.compile.qtrees import QuantizedWire

    rng = np.random.default_rng(seed)
    cuts = tuple(
        np.unique(np.concatenate([[0.0], rng.normal(0.0, 1.5, size=k - 1)])
                  .astype(np.float32)) if k else np.empty(0, np.float32)
        for k in sizes)
    F = len(sizes)
    has_repl = np.arange(F) % 3 == 1
    repl = np.where(has_repl, rng.normal(0.0, 1.0, size=F), 0.0)
    return QuantizedWire(
        fields=tuple(f"x{j}" for j in range(F)), cuts=cuts, dtype=dtype,
        sentinel=int(np.iinfo(dtype).max), repl=repl.astype(np.float32),
        has_repl=has_repl)


def skewed_sizes(n_fields: int, long: int) -> list:
    """Cut-table sizes with one long table among short ones, so that the
    padding blowup sends the host encode down the ragged branch."""
    return [long] + [4, 0, 7] * ((n_fields - 1) // 3) + [3] * ((n_fields - 1) % 3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, repeats: int) -> float:
    """Median milliseconds of ``fn()`` on the current stream (CUDA events
    around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def model_tables(workdir: str, n_trees: int, name: str, votes=None):
    """gen_gbm (or, with ``votes`` = gen_vote_forest's keywords, a vote
    forest) → parse → compile on the card → (doc, compiled, rank-wire
    scorer)."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm, gen_vote_forest
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    if votes is None:
        path = gen_gbm(workdir, n_trees=n_trees, name=name)
    else:
        path = gen_vote_forest(workdir, n_trees=n_trees, name=name, **votes)
    doc = parse_pmml_file(path)
    cm = compile_pmml(doc, batch_size=BATCH)
    q = cm.quantized_scorer()
    if q is None or q.backend != "cuda":
        raise RuntimeError(f"{name}: rank-wire scorer not on the kernel "
                           f"({None if q is None else q.backend})")
    return doc, cm, q


def features(rng, n: int, F: int) -> np.ndarray:
    X = rng.normal(0.0, 1.5, size=(n, F)).astype(np.float32)
    X[rng.random(size=X.shape) < MISSING] = np.nan
    return X


def check_kernel(q, X: np.ndarray, label: str, phase: str) -> dict:
    """Kernel vs plain version on the card for one model's tables and the
    wire's codes of ``X``, bit for bit."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    codes = torch.from_numpy(q.wire.encode(X)).cuda()
    return check_tables(tables, codes, label, phase)


def check_tables(tables: dict, codes, label: str, phase: str) -> dict:
    """Kernel vs plain version on the card, bit for bit: the walk and the
    masks select the same leaf, whose row both add in ascending tree
    order."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    got = qtrees_cuda.leaf_rows(codes, tables, codes.shape[1])
    ref = qtrees_cuda.leaf_rows_reference(codes, tables)
    torch.cuda.synchronize()
    N = codes.shape[0]
    T, _, C = tables["rows"].shape
    if got.shape != (N, C) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: bad kernel output {tuple(got.shape)}")
    depth = (tables["walk"][:, 0] >> 8) & 0xFF
    row = {
        "case": label, "rows": N, "trees": T, "classes": C,
        "depth_min": int(depth.min()), "depth_max": int(depth.max()),
        "missing_share": float((codes == qtrees_cuda.SENTINEL).float().mean()),
        "max_abs_err": float((got - ref).abs().max()),
        "ok": bool(torch.equal(got, ref)),
    }
    if not row["ok"]:
        emit({"phase": phase, **row})
        raise RuntimeError(f"{label}: kernel differs from its plain version")
    return row


def check_walk_cases(rng) -> list:
    """The kernel on forests the fixtures lack, bit for bit against its
    plain version: ragged depths 1-12 with single-leaf trees and padded
    slots (C = 1 and C = 3, and C = 16 over 256 fields: 64-thread blocks),
    and the 64-split caterpillar (depth 64, 65 leaves), each over a batch
    that is no multiple of a block's records."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    cases = [
        ("ragged200_c1_100003", ragged_forest(5, 200, 32, 1), 100_003),
        ("ragged200_c3_100003", ragged_forest(6, 200, 32, 3), 100_003),
        ("caterpillar64_c1_65537", caterpillar_forest(7, 32, 1), 65_537),
        ("caterpillar64_c16_4099", caterpillar_forest(8, 32, 16), 4_099),
        ("ragged60_f256_c16_5003", ragged_forest(9, 60, 256, 16), 5_003),
    ]
    rows = []
    for label, inputs, n in cases:
        tables = {k: torch.from_numpy(v).cuda()
                  for k, v in qtrees_cuda.pack_tables(**inputs).items()}
        codes = torch.from_numpy(random_codes(
            int(rng.integers(1 << 30)), n, inputs["n_fields"], MISSING)).cuda()
        rows.append(check_tables(tables, codes, label, "walk_kernel"))
    return rows


def vote_counts(q, codes) -> np.ndarray:
    """Exact integer vote counts i64[N, C] of a majorityVote forest: each
    tree's hit leaf label, from the front half and the leaf labels (not
    from the f32 class rows)."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    lab = q.params["lab"].long()
    n = codes.shape[0]
    counts = torch.zeros((n, len(q.labels)), dtype=torch.int64,
                         device=codes.device)
    rows = torch.arange(n, device=codes.device)
    ones = torch.ones(n, dtype=torch.int64, device=codes.device)
    for t, hit in qtrees_cuda._leaf_hits(codes, tables):
        if not bool((hit.sum(dim=1) == 1).all()):
            raise RuntimeError(f"tree {t}: not exactly one leaf hit")
        leaf = hit.long().argmax(dim=1)
        counts.index_put_((rows, lab[t, leaf]), ones, accumulate=True)
    return counts.cpu().numpy()


def check_votes(got, ref, counts: np.ndarray, label: str) -> dict:
    """(value, shares, label) triples ``got`` (the kernel path) against
    ``ref``: shares and values at the rank-wire bar, labels by the tie rule
    of the module docstring → errors and the number of tied rows."""
    gv, gp, gl = (np.asarray(a) for a in got)
    rv, rp, rl = (np.asarray(a) for a in ref)
    n = counts.shape[0]
    if gp.shape != rp.shape or not np.isfinite(gp).all():
        raise RuntimeError(f"{label}: shares {gp.shape} vs {rp.shape}")
    if not (np.allclose(gp, rp, rtol=RTOL, atol=ATOL)
            and np.allclose(gv, rv, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"{label}: shares or values differ: "
                           f"{float(np.abs(gp - rp).max())}")
    top = counts == counts.max(axis=1, keepdims=True)
    tied = top.sum(axis=1) > 1
    rows = np.arange(n)
    if not (np.array_equal(gl[~tied], rl[~tied])
            and np.array_equal(gl[tied], top.argmax(axis=1)[tied])
            and top[rows, rl][tied].all()):
        raise RuntimeError(f"{label}: labels break the tie rule")
    return {"max_abs_err": float(np.abs(gp - rp).max()),
            "value_max_abs_err": float(np.abs(gv - rv).max()),
            "tied_rows": int(tied.sum()),
            "tied_label_differs": int((gl != rl)[tied].sum())}


def needed_ops(codes, tables) -> dict:
    """The operations these inputs need: per record and tree, one integer
    step for each split on the hit leaf's path (the bits of its ``on``
    mask) and C f32 adds for its row; found with the plain front half."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    bits = torch.arange(64, device=codes.device)
    depth = ((tables["on"][..., None] >> bits) & 1).sum(dim=-1)  # [T, L]
    steps = hits = 0
    for t, hit in qtrees_cuda._leaf_hits(codes, tables):
        steps += int((hit * depth[t]).sum())
        hits += int(hit.sum())
    return {"int_steps": steps, "f32_adds": hits * tables["rows"].shape[2]}


def time_kernel(q, X: np.ndarray) -> dict:
    """CUDA-event medians of the kernel and its plain version on one batch,
    beside the least time the card could take: each input read once and
    the output written once over HBM's rate, or the needed integer steps
    and f32 adds over their pipes' rates, whichever is longer."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    codes = torch.from_numpy(q.wire.encode(X)).cuda()
    F = codes.shape[1]
    kern_ms = cuda_ms(lambda: qtrees_cuda.leaf_rows(codes, tables, F), 3, 20)
    plain_ms = cuda_ms(
        lambda: qtrees_cuda.leaf_rows_reference(codes, tables), 1, 3)
    N = codes.shape[0]
    T, S = tables["split"].shape
    _, L, C = tables["rows"].shape
    # what the kernel reads and writes: codes, the walk table, the output
    walk = tables["walk"]
    n_bytes = codes.numel() + 4 * N * C + walk.numel() * walk.element_size()
    ops = needed_ops(codes, tables)
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = max(ops["int_steps"] / PEAK_INT32_OPS_S,
                 ops["f32_adds"] / PEAK_F32_FLOP_S) * 1e3
    return {
        "rows": N, "trees": T, "splits": S, "leaves": L, "classes": C,
        "kernel_ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "bytes": n_bytes, "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms,
        # the walk's trip counts, depth[t] per record and tree, from the
        # headers: what the design executes, not measured on the card
        "design_int_steps": N * int(((walk[:, 0] >> 8) & 0xFF).sum()),
        "kernel_records_per_s": N / (kern_ms * 1e-3),
        "library_ms": None,
    }


def host_ms(fn, repeats: int) -> float:
    """Median host milliseconds of ``fn()`` (one warm-up call first)."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_codes(got: np.ndarray, ref: np.ndarray, label: str,
                phase: str) -> dict:
    """Rank codes against the plain version: dtype for dtype, byte for
    byte."""
    row = {"case": label, "rows": int(ref.shape[0]), "fields": int(ref.shape[1]),
           "dtype": str(got.dtype),
           "sentinel_share": float((ref == np.iinfo(ref.dtype).max).mean()),
           "mismatches": int((got != ref).sum()) if got.shape == ref.shape
           else -1,
           "ok": bool(got.dtype == ref.dtype and np.array_equal(got, ref))}
    if not row["ok"]:
        emit({"phase": phase, **row, "ref_dtype": str(ref.dtype)})
        raise RuntimeError(f"{label}: codes differ from the plain version")
    return row


def check_native(rng, wires) -> dict:
    """Build the C++ host plane; hold its bucketizer to the numpy plain
    version on each ``(label, wire, branch, rows)`` and time both on the
    first wire at DISPATCH rows."""
    from flink_jpmml_tpu_torch.runtime import native

    built_before = native.lib_path().exists()
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    cases = []
    for label, wire, branch, rows in wires:
        taken = "lockstep" if wire._pow2_tables()[0] is not None else "ragged"
        if taken != branch:
            raise RuntimeError(f"{label}: takes the {taken} branch, "
                               f"not {branch}")
        X = edge_cells(rng, wire.cuts, rows)
        row = check_codes(wire.encode(X), wire.encode_reference(X), label,
                          "native")
        cases.append({**row, "branch": taken})
    wire = wires[0][1]
    X = edge_cells(rng, wire.cuts, DISPATCH)
    native_ms = host_ms(lambda: wire.encode(X), 7)
    plain_ms = host_ms(lambda: wire.encode_reference(X), 3)
    return {
        "source": "flink_jpmml_tpu_torch/_native/fjt_native.cpp",
        "build_s": build_s, "built_before": built_before,
        "host_cpus": os.cpu_count(),
        "host_cpus_usable": len(os.sched_getaffinity(0)),
        "cases": cases, "timed_case": wires[0][0],
        "timed_rows": DISPATCH, "native_ms": native_ms, "plain_ms": plain_ms,
        "native_records_per_s": DISPATCH / (native_ms * 1e-3),
    }


def check_encode_stage(rng, scorers, q16_cpu) -> dict:
    """The device encode stage on the card against the host encode, byte
    for byte, on each ``(label, scorer, rows)``; its CUDA-event time at
    DISPATCH rows on the first scorer; and the uint16 scorer (the last)
    scored host-encoded and fused on the card against the CPU port."""
    import torch

    cases = []
    for label, q, rows in scorers:
        X = edge_cells(rng, q.wire.cuts, rows)
        got = q.encode_device(X)
        if got.device.type != "cuda":
            raise RuntimeError(f"{label}: encode stage ran on {got.device}")
        cases.append(check_codes(got.cpu().numpy(), q.wire.encode(X), label,
                                 "encode_stage"))
    q = scorers[0][1]
    X = edge_cells(rng, q.wire.cuts, DISPATCH)
    Xd = torch.from_numpy(X).cuda()
    stage_ms = cuda_ms(lambda: q.encode_device(Xd), 3, 20)
    F = Xd.shape[1]
    # what each placement copies to the card a dispatch, from pinned memory
    pinned_f32 = torch.from_numpy(X).pin_memory()
    pinned_codes = torch.from_numpy(q.wire.encode(X)).pin_memory()
    h2d_f32_ms = cuda_ms(lambda: pinned_f32.to("cuda", non_blocking=True), 3, 20)
    h2d_codes_ms = cuda_ms(
        lambda: pinned_codes.to("cuda", non_blocking=True), 3, 20)
    # the stage reads the f32 batch and writes the codes once
    n_bytes = Xd.numel() * 4 + Xd.numel() * np.dtype(q.wire.dtype).itemsize
    label16, q16, _ = scorers[-1]
    X = edge_cells(rng, q16.wire.cuts, q16.batch_size)
    ref = q16_cpu.predict_wire(q16_cpu.wire.encode(X)).numpy()
    host = q16.predict_wire(q16.wire.encode(X)).cpu().numpy()
    fused = q16.predict_fused(X).cpu().numpy()
    errs = {"host_vs_cpu": float(np.abs(host - ref).max()),
            "fused_vs_cpu": float(np.abs(fused - ref).max()),
            "fused_vs_host": float(np.abs(fused - host).max())}
    if not (np.isfinite(host).all() and np.allclose(host, ref, rtol=RTOL, atol=ATOL)
            and np.allclose(fused, ref, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"{label16} scored on the card differs from the "
                           f"CPU port: {errs}")
    return {
        "cases": cases, "timed_case": scorers[0][0], "timed_rows": DISPATCH,
        "fields": F, "stage_ms": stage_ms,
        "stage_records_per_s": DISPATCH / (stage_ms * 1e-3),
        "h2d_f32_ms": h2d_f32_ms, "h2d_codes_ms": h2d_codes_ms,
        "bytes": n_bytes, "bytes_ms": n_bytes / PEAK_BYTES_S * 1e3,
        "uint16_scoring": {"case": label16, "backend": q16.backend,
                           "rows": int(X.shape[0]), **errs},
    }


def device_shares(run: dict, kernel_ms: float, stage_ms: float = 0.0,
                  h2d_ms: float = 0.0) -> dict:
    """The kernel's, the encode stage's and the H2D copies' shares of a
    main path's wall, from their timed milliseconds a dispatch: an
    estimate of the card's busy share, not a profiler trace."""
    n, wall_ms = run["dispatches"], run["seconds"] * 1e3
    busy = n * (kernel_ms + stage_ms + h2d_ms) / wall_ms
    return {"kernel_share": n * kernel_ms / wall_ms,
            "stage_share": n * stage_ms / wall_ms,
            "h2d_share": n * h2d_ms / wall_ms,
            "device_idle_share_est": 1.0 - busy}


def drive(cm, source, sink, count: list, counter, *, metrics=None,
          prefetch=None, target: int = MIN_DISPATCHES * DISPATCH,
          checkpoint_dir=None, restore: bool = False) -> dict:
    """BlockPipeline over ``source`` until ``target`` records reached the
    sink, in dispatches of up to DISPATCH records; ``counter`` (a kernel
    wrapper) is reset just before and read just after. The line carries
    the pipeline's stage ledger (``attribution``: ``obs.attr.summary`` of
    its registry). ``checkpoint_dir`` arms checkpoints every second there,
    and with them the DLQ beside them and the device-fault ladder (each
    batch retained past its dispatch). ``restore`` resumes from that
    directory's latest checkpoint first: ``count`` then starts at the
    restored offset (``restored_at``), and ``records`` counts this run's."""
    from flink_jpmml_tpu_torch.obs import attr
    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    pipe = BlockPipeline(
        source,
        cm,
        sink,
        recovery_config(1.0),
        metrics=metrics,
        max_dispatch_chunks=DISPATCH // BATCH,
        prefetch=prefetch,
        checkpoint=(CheckpointManager(checkpoint_dir)
                    if checkpoint_dir else None),
    )
    if pipe.backend != "rank_wire_cuda":
        raise RuntimeError(f"pipeline backend {pipe.backend}")
    q = cm.quantized_scorer()
    placement = q.encode_placement
    restored_at = 0
    if restore:
        pipe.restore()
        restored_at = count[0] = pipe.committed_offset
    counter.launches = 0
    t0 = time.perf_counter()
    pipe.start()
    deadline = t0 + 600
    try:
        while (count[0] < target and pipe.error is None
               and time.perf_counter() < deadline):
            time.sleep(0.01)
    finally:
        pipe.stop()
        pipe.join(timeout=60)
    dt = time.perf_counter() - t0
    launches = counter.launches
    snap = pipe.metrics.snapshot()
    dispatches = int(snap["batches"])
    if count[0] < target:
        raise RuntimeError(f"main path scored {count[0]} < {target} records")
    if launches < dispatches or launches == 0:
        raise RuntimeError(f"{launches} kernel launches for {dispatches} "
                           "dispatches")
    if snap.get(f"encode_{placement}") != dispatches:
        raise RuntimeError(f"{snap.get(f'encode_{placement}')} of "
                           f"{dispatches} dispatches encoded by {placement}")
    # only live rows cross the bus (a deadline drain's alignment rows
    # are zeroed on the card), so every path ships exactly its bytes
    h2d_per_record = snap["h2d_bytes"] / snap["batch_fill_records"]
    if h2d_per_record != q.staged_bytes_per_record:
        raise RuntimeError(f"{h2d_per_record} H2D bytes a record, expected "
                           f"{q.staged_bytes_per_record} ({placement})")
    encode_s = snap.get("encode_s", 0.0)
    records = count[0] - restored_at
    return {
        "backend": pipe.backend, "encode_mode": placement,
        "checkpointed": checkpoint_dir is not None,
        "source": type(pipe._source).__name__,
        "host_cpus": os.cpu_count(),
        **({"restored_at": restored_at} if restore else {}),
        "records": records, "seconds": dt, "records_per_s": records / dt,
        "dispatches": dispatches, "launches": launches,
        "launches_per_dispatch": launches / dispatches,
        "records_per_dispatch": snap["batch_fill_records"] / max(dispatches, 1),
        "h2d_bytes_per_record": h2d_per_record,
        "encode_s": encode_s, "encode_share": encode_s / dt,
        "encode_ms_per_dispatch": 1e3 * encode_s / dispatches,
        "h2d_stall_s": snap.get("h2d_stall_s"),
        "batch_latency_p50_s": snap.get("batch_latency_s_p50"),
        "batch_latency_p99_s": snap.get("batch_latency_s_p99"),
        "attribution": attr.summary(pipe.metrics),
    }


def kafka_wire(rows: np.ndarray) -> tuple:
    """A port ``MiniKafkaBroker`` holding ``rows`` (appended with the C++
    encoder), read back through ``KafkaClient`` and
    ``decode_record_batches_rows``: rows and offsets byte-identical to the
    appended array, and the C++, vectorized and Python row decoders
    equal on the log's head. → (broker, phase line); the caller closes
    the broker."""
    from flink_jpmml_tpu_torch.runtime import kafka

    n = rows.shape[0]
    broker = kafka.MiniKafkaBroker(topic="smoke")
    try:
        t0 = time.perf_counter()
        broker.append_rows(rows)
        append_s = time.perf_counter() - t0
        client = kafka.KafkaClient(broker.host, broker.port)
        try:
            t0 = time.perf_counter()
            pos, fetches, offs, got = 0, 0, [], []
            while pos < n:
                hw, raw = client.fetch_raw("smoke", 0, pos)
                o, r = kafka.decode_record_batches_rows(raw, rows.shape[1])
                keep = o >= pos
                offs.append(o[keep])
                got.append(r[keep])
                pos = int(o[-1]) + 1
                fetches += 1
            read_s = time.perf_counter() - t0
        finally:
            client.close()
        offs, got = np.concatenate(offs), np.concatenate(got)
        if (hw != n or offs.tobytes() != np.arange(n, dtype=np.int64).tobytes()
                or got.tobytes() != rows.tobytes()):
            raise RuntimeError("rows read back from the broker differ from "
                               "the appended rows")
        # one record set of the log's first DISPATCH rows, as stored
        segs = broker._segs[0]
        head = b"".join(b for base, _, b in segs if base < DISPATCH)
        prefix = b"".join(b for base, _, b in segs if base < 20_000)
        F = rows.shape[1]
        tiers = {}
        for name, fn in (("cpp", kafka.decode_record_batches_rows),
                         ("vectorized", kafka.decode_record_batches_rows_vec),
                         ("python", kafka.decode_record_batches_rows_py)):
            o, r = fn(prefix, F)
            tiers[name] = (o.tobytes(), r.tobytes())
        if len({v for v in tiers.values()}) != 1:
            raise RuntimeError("the row decoders disagree on the log's head")
        n_prefix = len(tiers["python"][0]) // 8
        if tiers["python"][1] != rows[:n_prefix].tobytes():
            raise RuntimeError("the Python row decoder differs from the rows")
        cpp_ms = host_ms(lambda: kafka.decode_record_batches_rows(head, F), 7)
        vec_ms = host_ms(lambda: kafka.decode_record_batches_rows_vec(head, F),
                         1)
        py_ms = host_ms(lambda: kafka.decode_record_batches_rows_py(prefix, F),
                        1)
    except BaseException:
        broker.close()
        raise
    return broker, {
        "rows": n, "fields": F, "value_bytes": rows.nbytes,
        "log_bytes": sum(len(b) for _, _, b in segs),
        "append_s": append_s, "read_back_s": read_s, "fetches": fetches,
        "rows_per_fetch": n / fetches, "read_back_identical": True,
        "host_cpus": os.cpu_count(),
        "host_cpus_usable": len(os.sched_getaffinity(0)),
        "decode_rows": DISPATCH, "cpp_decode_ms": cpp_ms,
        "vectorized_decode_ms": vec_ms,
        "python_check_rows": n_prefix, "python_decode_ms": py_ms,
        "python_ms_per_dispatch_rows": py_ms * DISPATCH / n_prefix,
        "tiers_identical": True,
    }


def kafka_main_path(cm, broker, n_cols: int, counter, prefetch,
                    sample: int, ref: np.ndarray) -> dict:
    """``drive`` over a ``KafkaBlockSource`` reading ``broker`` on
    loopback that seeks back to 0 at the high watermark (a finite log
    sustains the run), with one registry shared by the source, the
    sidecar (``prefetch``: None = auto, on for the Kafka source; False =
    the serial ablation) and the pipeline. After a seek the offsets
    restart and the sink sees ``first_off == 0`` again: only the first
    head is kept. The port's pipeline has no checkpoints yet, so the
    committed offset going back is harmless here. The sink keeps every
    dispatch's record count: ``dispatch_shapes`` maps K compile batches
    to ``[dispatches, live records]``, what ``kafka_device_shares``
    times."""
    from flink_jpmml_tpu_torch.runtime import prefetch as prefetch_mod
    from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    hw = broker.high_watermark

    class CyclingKafka(KafkaBlockSource):
        def poll(self):
            if self._next >= hw:
                self.seek(0)
            return super().poll()

    reg = MetricsRegistry()
    src = CyclingKafka(broker.host, broker.port, broker.topic, n_cols=n_cols,
                       max_wait_ms=20, metrics=reg)
    kept, count, sizes = {}, [0], []

    def sink(out, n, first_off):
        vals = np.asarray(out)
        if vals.ndim != 1 or vals.shape[0] < n:
            raise RuntimeError(f"sink got {vals.shape} for {n} records")
        if first_off == 0 and "head" not in kept:
            kept["head"] = vals[:sample].copy()
        count[0] += n
        sizes.append(n)

    try:
        run = drive(cm, src, sink, count, counter, metrics=reg,
                    prefetch=prefetch, target=19 * DISPATCH)
    finally:
        src.close()
    if (run["encode_mode"] != "fused"
            or run["h2d_bytes_per_record"] != 4 * n_cols):
        raise RuntimeError(f"Kafka path ran {run['encode_mode']} with "
                           f"{run['h2d_bytes_per_record']} bytes a record")
    if len(sizes) != run["dispatches"] or sum(sizes) != run["records"]:
        raise RuntimeError(f"{len(sizes)} sink calls with {sum(sizes)} "
                           f"records for {run['dispatches']} dispatches of "
                           f"{run['records']}")
    shapes = {}
    for n in sizes:
        k = -(-n // BATCH)
        row = shapes.setdefault(k, [0, 0])
        row[0] += 1
        row[1] += n
    head = kept["head"]
    err = float(np.abs(head - ref).max())
    if (head.shape != (sample,) or not np.isfinite(head).all()
            or not np.allclose(head, ref, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"Kafka path disagrees with the CPU port: {err}")
    st = reg.struct_snapshot()
    cs, gs, hs = st["counters"], st["gauges"], reg.snapshot()
    sidecar = run["source"] == "PrefetchedBlockSource"
    if sidecar != (prefetch is None):
        raise RuntimeError(f"source {run['source']} with prefetch={prefetch}")
    return {
        **run, "log_records": hw, "cpu_check_rows": sample,
        "cpu_check_max_abs_err": err,
        "dispatch_records": {"min": min(sizes),
                             "p50": float(np.median(sizes)),
                             "max": max(sizes)},
        "dispatch_shapes": dict(sorted(shapes.items())),
        "kafka_decode_s": cs.get("kafka_decode_s", 0.0),
        "kafka_decode_ms_per_dispatch_rows":
            1e3 * cs.get("kafka_decode_s", 0.0) * DISPATCH / run["records"],
        "kafka_fetch_s_p50": hs.get("kafka_fetch_s_p50"),
        "kafka_fetch_s_p99": hs.get("kafka_fetch_s_p99"),
        "prefetch": {
            "enabled": True, "depth": prefetch_mod.env_depth(),
            "batches": int(cs.get("prefetch_batches", 0)),
            "records": int(cs.get("prefetch_records", 0)),
            "depth_max": gs.get("prefetch_depth", {}).get("max", 0.0),
            "occupancy_max": gs.get("prefetch_occupancy", {}).get("max", 0.0),
            "stall_ms": 1000 * cs.get("prefetch_stall_s", 0.0),
            "block_ms": 1000 * cs.get("prefetch_block_s", 0.0),
        } if sidecar else {"enabled": False},
        "kafka_lag": {k: v["value"] for k, v in gs.items()
                      if k.startswith("kafka_lag{")},
        # the per-registry planes the source and the score loop tick:
        # the lag forecaster (no backlog grows on a cycling log, so the
        # drain ETA and the trend read 0), the lag readings' age, and
        # the composite backpressure score
        "lag_forecast": {k: gs[k]["value"] for k in
                         ("lag_drain_eta_s", "lag_trend", "lag_diverging")
                         if k in gs},
        "kafka_lag_age_s": {k: v["value"] for k, v in gs.items()
                            if k.startswith("kafka_lag_age_s{")},
        "pressure": {k: gs[k]["value"] for k in
                     ("pressure", "pressure_ring", "pressure_window",
                      "pressure_wait", "pressure_prefetch") if k in gs},
    }


# the keyed, compacted topic config 2 is scored from: 262,144 rows of the
# feature stream (32 MiB of values) keyed by 10,000 users over 3
# partitions, each partition compacted by a run of 4,096 offsets from its
# middle
KEYED_ROWS = 262_144
KEYED_USERS = 10_000
KEYED_PARTITIONS = 3
KEYED_GAP = 4096


def plain_walk_scores(q, X: np.ndarray) -> np.ndarray:
    """``q``'s fused scores of ``X`` on the card, with the walk's plain
    version (``leaf_rows_reference``) in the kernel's place: the same
    encode stage and epilogue, in dispatches of DISPATCH rows. Launches
    no kernel."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    kernel = qtrees_cuda.leaf_rows
    qtrees_cuda.leaf_rows = (
        lambda codes, tables, F, *a: qtrees_cuda.leaf_rows_reference(
            codes, tables))
    try:
        return np.concatenate([
            np.asarray(q.predict_fused(X[i:i + DISPATCH]).cpu())[
                :X[i:i + DISPATCH].shape[0]]
            for i in range(0, X.shape[0], DISPATCH)])
    finally:
        qtrees_cuda.leaf_rows = kernel


def kafka_keyed_topic(workdir: str, cm, q, counter) -> dict:
    """Config 2 scored from a keyed, compacted topic (KEYED_*): the fused
    rank-wire ``BlockPipeline`` with checkpoints over a
    ``KafkaBlockSource`` on all three partitions in the default
    ``interleave="auto"`` (a per-partition offset vector), stopped at
    about a third of the surviving rows; a fresh pipeline restores the
    checkpointed vector and drains the topic. Every surviving row is
    scored exactly once (the multiset of the rows below the restore point
    in the first life and of the second life's rows is the broker's
    survivors, so no compacted offset is scored), the scores equal the
    plain walk's on the same rows bit for bit, and in each life the walk
    kernel launched once a dispatch."""
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.kafka import (
        KafkaBlockSource,
        MiniKafkaBroker,
    )
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    F = len(q.wire.fields)
    t0 = time.perf_counter()
    data = features(np.random.default_rng(0), KEYED_ROWS, F)
    broker = MiniKafkaBroker(topic="keyed", n_partitions=KEYED_PARTITIONS)
    try:
        broker.append_rows_keyed(
            data, [f"user-{i % KEYED_USERS}" for i in range(KEYED_ROWS)])
        with broker._mu:
            sizes = [len(v) for v in broker._vals]
        gaps = []
        for p, size in enumerate(sizes):
            lo = size // 2 - KEYED_GAP // 2
            broker.compact(p, range(lo, lo + KEYED_GAP))
            gaps.append([lo, lo + KEYED_GAP])
        with broker._mu:
            kept_offs = [np.asarray(o, np.int64) for o in broker._offs]
            survivors = np.frombuffer(
                b"".join(v for vals in broker._vals for v in vals),
                np.float32).reshape(-1, F)
        n = survivors.shape[0]
        for p, (lo, hi) in enumerate(gaps):
            offs = kept_offs[p]
            if (offs.size != sizes[p] - KEYED_GAP
                    or ((offs >= lo) & (offs < hi)).any()
                    or int(offs[-1]) != sizes[p] - 1):
                raise RuntimeError(f"partition {p}: compaction kept "
                                   f"{offs.size} of {sizes[p]} offsets")
        build_s = time.perf_counter() - t0
        ckdir = os.path.join(workdir, "keyed-ck")
        lives = []
        for life, target in (("first", n // 3), ("resumed", n)):
            polled = np.zeros((n, F), np.float32)
            scores = np.full(n, np.nan, np.float32)
            hits = np.zeros(n, np.int32)

            class RecordingSource(KafkaBlockSource):
                """Keeps each polled block's rows at its global offsets."""

                def poll(self):
                    got = super().poll()
                    if got is not None:
                        off, blk = got
                        polled[off:off + blk.shape[0]] = blk
                    return got

            count = [0]

            def sink(out, k, first_off):
                vals = np.asarray(out)
                scores[first_off:first_off + k] = vals[:k]
                hits[first_off:first_off + k] += 1
                count[0] += k

            if life == "resumed":
                state = CheckpointManager(ckdir).load_latest() or {}
            reg = MetricsRegistry()
            src = RecordingSource(broker.host, broker.port, broker.topic,
                                  partitions=list(range(KEYED_PARTITIONS)),
                                  n_cols=F, max_wait_ms=20, metrics=reg)
            try:
                run = drive(cm, src, sink, count, counter, metrics=reg,
                            target=target, checkpoint_dir=ckdir,
                            restore=life == "resumed")
            finally:
                src.close()
            if run["launches"] != run["dispatches"]:
                raise RuntimeError(f"keyed topic, {life} life: "
                                   f"{run['launches']} kernel launches for "
                                   f"{run['dispatches']} dispatches")
            lo = run.get("restored_at", 0)
            hi = lo + run["records"]
            if (hits[lo:hi] != 1).any() or hits[:lo].any() or hits[hi:].any():
                raise RuntimeError(f"keyed topic, {life} life: the sink "
                                   f"did not cover [{lo}, {hi}) once")
            lives.append({"life": life, "run": run, "lo": lo, "hi": hi,
                          "polled": polled, "scores": scores})
        first, resumed = lives
        R = resumed["lo"]
        if not 0 < R <= first["hi"] or resumed["hi"] != n:
            raise RuntimeError(f"keyed topic: restored at {R} after "
                               f"{first['hi']} scored, drained to "
                               f"{resumed['hi']} of {n}")
        rows = np.concatenate([first["polled"][:R], resumed["polled"][R:]])
        scored = np.concatenate([first["scores"][:R], resumed["scores"][R:]])

        def multiset(a):
            return np.sort(np.ascontiguousarray(a).view(
                np.dtype((np.void, 4 * F))).ravel())

        if not np.array_equal(multiset(rows), multiset(survivors)):
            raise RuntimeError("keyed topic: the scored rows are not the "
                               "broker's survivors, each once")
        plain = plain_walk_scores(q, rows)
        if not np.array_equal(scored.view(np.uint32), plain.view(np.uint32)):
            bad = int((scored.view(np.uint32) != plain.view(np.uint32)).sum())
            raise RuntimeError(f"keyed topic: {bad} scores differ from the "
                               "plain walk's")
    finally:
        broker.close()
    return {
        "rows": KEYED_ROWS, "users": KEYED_USERS,
        "partitions": KEYED_PARTITIONS, "partition_rows": sizes,
        "gaps": gaps, "survivors": n, "build_s": build_s,
        "restore_offset": R,
        "restore_vector": state.get("source_state"),
        "scored_exactly_once": True, "plain_walk_bit_equal": True,
        "lives": [{"life": lv["life"], "records": lv["run"]["records"],
                   "records_per_s": lv["run"]["records_per_s"],
                   "dispatches": lv["run"]["dispatches"],
                   "launches": lv["run"]["launches"],
                   "source": lv["run"]["source"],
                   "encode_mode": lv["run"]["encode_mode"]}
                  for lv in lives],
        "seconds": time.perf_counter() - t0,
    }


def kafka_device_shares(run: dict, q, rng) -> dict:
    """A Kafka path's card busy share from its own dispatch shapes: for
    each size of K compile batches, the kernel and the encode stage timed
    at K × BATCH rows times the dispatches of that size, and the H2D copy
    timed at K × BATCH rows scaled by the live rows those dispatches
    shipped. An estimate of the card's busy share, not a profiler
    trace."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
    F = len(q.wire.fields)
    kern = stage = h2d = 0.0
    timed = {}
    for k, (n_disp, live) in run["dispatch_shapes"].items():
        X = features(rng, k * BATCH, F)
        Xd = torch.from_numpy(X).cuda()
        codes = q.encode_device(Xd)
        pinned = torch.from_numpy(X).pin_memory()
        t = {"kernel_ms": cuda_ms(
                 lambda: qtrees_cuda.leaf_rows(codes, tables, F), 3, 20),
             "stage_ms": cuda_ms(lambda: q.encode_device(Xd), 3, 20),
             "h2d_f32_ms": cuda_ms(
                 lambda: pinned.to("cuda", non_blocking=True), 3, 20)}
        timed[k] = t
        kern += n_disp * t["kernel_ms"]
        stage += n_disp * t["stage_ms"]
        h2d += live / (k * BATCH) * t["h2d_f32_ms"]
    wall_ms = run["seconds"] * 1e3
    return {"kernel_share": kern / wall_ms, "stage_share": stage / wall_ms,
            "h2d_share": h2d / wall_ms,
            "device_idle_share_est": 1.0 - (kern + stage + h2d) / wall_ms,
            "timed_by_batches": timed}


# -- the dense families (BASELINE configs 1, 3, 4, 5 and a GLM) -------------

WIDE = 16  # fields past which missing cells are confined to some records
ENTITY_OUTPUTS = ('<Output><OutputField name="cluster" feature="entityId"/>'
                  '<OutputField name="dist" feature="affinity"/></Output>')


def glm_probit_xml(n_fields: int = 8, seed: int = 29) -> str:
    """A probit GeneralRegressionModel (generalizedLinear) over ``n_fields``
    continuous covariates: an intercept, a slope each, x0 squared and the
    x1·x2 interaction (two PPCells on one parameter), β from the seed."""
    rng = np.random.default_rng(seed)
    fields = [f"x{i}" for i in range(n_fields)]
    params = ["p0"] + [f"p{i + 1}" for i in range(n_fields)] + ["pq", "px"]
    cells = [(f, f"p{i + 1}", "1") for i, f in enumerate(fields)]
    cells += [("x0", "pq", "2"), ("x1", "px", "1"), ("x2", "px", "1")]
    beta = rng.normal(0.0, 0.3, size=len(params))
    return (
        '<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3"><Header/>'
        "<DataDictionary>" + "".join(
            f'<DataField name="{f}" optype="continuous" dataType="double"/>'
            for f in fields)
        + '<DataField name="y" optype="continuous" dataType="double"/>'
        "</DataDictionary>"
        '<GeneralRegressionModel functionName="regression" '
        'modelType="generalizedLinear" linkFunction="probit">'
        '<MiningSchema><MiningField name="y" usageType="target"/>'
        + "".join(f'<MiningField name="{f}"/>' for f in fields)
        + "</MiningSchema><ParameterList>"
        + "".join(f'<Parameter name="{q}"/>' for q in params)
        + "</ParameterList><CovariateList>"
        + "".join(f'<Predictor name="{f}"/>' for f in fields)
        + "</CovariateList><PPMatrix>" + "".join(
            f'<PPCell value="{v}" predictorName="{f}" parameterName="{q}"/>'
            for f, q, v in cells)
        + "</PPMatrix><ParamMatrix>" + "".join(
            f'<PCell parameterName="{q}" beta="{b!r}"/>'
            for q, b in zip(params, beta.tolist()))
        + "</ParamMatrix></GeneralRegressionModel></PMML>"
    )


def family_configs(workdir: str) -> list:
    """(name, PMML path, compile batch, records to score) of the dense
    families' configurations, at their published widths."""
    from flink_jpmml_tpu_torch import assets_gen as ag

    def written(name, xml):
        path = os.path.join(workdir, name)
        with open(path, "w") as f:
            f.write(xml)
        return path

    with open(ag.gen_kmeans(workdir)) as f:
        kmeans = f.read().replace("</MiningSchema>",
                                  "</MiningSchema>" + ENTITY_OUTPUTS, 1)
    return [
        ("iris_lr", ag.gen_iris_lr(workdir, seed=7), BATCH, 1_048_576),
        ("mlp", ag.gen_mlp(workdir), BATCH, 262_144),
        ("kmeans", written("kmeans_out.pmml", kmeans), BATCH, 1_048_576),
        ("stacked", ag.gen_stacked(workdir, n_trees=50, depth=4,
                                   n_features=10_000, wide_lr=True),
         2048, 131_072),
        ("glm_probit", written("glm.pmml", glm_probit_xml()), BATCH,
         262_144),
    ]


def check_outputs(got, ref, label: str) -> dict:
    """A dense path's (value, valid, probs, label_idx) against the CPU
    port's: validity equal, values and rows within the bar on valid lanes,
    labels equal there."""
    g = [None if t is None else np.asarray(t) for t in got]
    r = [None if t is None else t.numpy() for t in ref]
    valid = r[1]
    if not np.array_equal(g[1], valid):
        raise RuntimeError(f"{label}: validity differs from the CPU port on "
                           f"{int((g[1] != valid).sum())} rows")
    errs = {"rows": int(valid.shape[0]), "valid_rows": int(valid.sum())}
    for name, i in (("value", 0), ("probs", 2)):
        if (g[i] is None) != (r[i] is None):
            raise RuntimeError(f"{label}: {name} present on one side only")
        if g[i] is None:
            continue
        a, b = g[i][valid], r[i][valid]
        if not (np.isfinite(a).all()
                and np.allclose(a, b, rtol=RTOL, atol=ATOL)):
            raise RuntimeError(f"{label}: {name} differs from the CPU port")
        errs[f"{name}_max_abs_err"] = float(np.abs(a - b).max(initial=0.0))
    if (g[3] is None) != (r[3] is None):
        raise RuntimeError(f"{label}: labels present on one side only")
    if g[3] is not None and not np.array_equal(g[3][valid], r[3][valid]):
        raise RuntimeError(f"{label}: labels differ from the CPU port")
    return errs


def _close_outputs(w, v) -> bool:
    """Two decoded output values equal: floats within the bar, maps key
    by key (selectAll's per-segment map), the rest exactly."""
    if isinstance(v, dict):
        return (isinstance(w, dict) and w.keys() == v.keys()
                and all(_close_outputs(w[k], v[k]) for k in v))
    if isinstance(v, float):
        return isinstance(w, float) and bool(
            np.isclose(w, v, rtol=RTOL, atol=ATOL))
    return w == v


def records_of(cm, X: np.ndarray) -> list:
    """Records from rows of ``X`` (NaN → absent); a string-categorical
    field's code becomes its category."""
    fields = cm.field_space.fields
    names = {f: {c: v for v, c in codec.items()}
             for f, codec in cm.field_space.codecs.items()}
    return [{f: (names[f][float(v)] if f in names else float(v))
             for f, v in zip(fields, row) if not np.isnan(v)} for row in X]


def check_decoded(cm, cm_cpu, X: np.ndarray, label: str) -> dict:
    """``score_records`` on the card and on the CPU port over records made
    from ``X`` (``records_of``): the same empties, labels and outputs
    (reason codes and segment maps included), and values within the
    bar."""
    records = records_of(cm, X)
    outs = 0
    for g, r in zip(cm.score_records(records), cm_cpu.score_records(records)):
        same = g.is_empty == r.is_empty and (g.is_empty or (
            np.isclose(g.score.value, r.score.value, rtol=RTOL, atol=ATOL)
            and (g.target is None) == (r.target is None)
            and (g.target is None or g.target.label == r.target.label)
            and set(g.outputs or {}) == set(r.outputs or {})))
        for k, v in (r.outputs or {}).items():
            same = same and _close_outputs((g.outputs or {}).get(k), v)
            outs += 1
        if not same:
            raise RuntimeError(f"{label}: score_records differs from the CPU "
                               f"port: {g} vs {r}")
    return {"records": len(records), "outputs_checked": outs}


def drive_f32(cm, data: np.ndarray, target: int, sample: int,
              chunks=None, mesh=None) -> tuple:
    """BlockPipeline on the f32 backend over a ``CyclingBlockSource`` of
    ``data`` until ``target`` records reached the sink; dispatches of
    ``chunks`` compile batches, by default up to 16, fewer where a
    dispatch would pass 64 MiB of values. The line carries the model
    function's (on the data's first rows) and the H2D copy's CUDA-event ms
    at the dispatch shape and, from them, an estimate of the card's idle
    share (not a trace), the card's peak allocated memory over the run
    and the timing, and the stage ledger. ``mesh`` drives
    ``BlockPipeline(mesh=)``, and the model function timed is the sharded
    model's ``predict``.
    → (the run's line, the head's outputs)."""
    import torch

    from flink_jpmml_tpu_torch.obs import attr
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        CyclingBlockSource,
    )
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    batch, F = cm.batch_size, cm.field_space.arity
    if chunks is None:
        chunks = max(1, min(DISPATCH // BATCH, 2 ** 26 // (batch * 4 * F)))
    kept, count = {}, [0]

    def sink(out, n, first_off):
        if out.value.shape[0] < n:
            raise RuntimeError(f"sink got {out.value.shape} for {n} records")
        if first_off == 0:
            kept["head"] = tuple(None if t is None else t[:sample].clone()
                                 for t in out)
        count[0] += n

    pipe = BlockPipeline(
        CyclingBlockSource(data, block_size=min(len(data), batch * chunks)),
        cm, sink,
        RuntimeConfig(batch=BatchConfig(size=batch, deadline_us=5000,
                                        queue_capacity=4 * batch * chunks)),
        max_dispatch_chunks=chunks,
        mesh=mesh,
    )
    if pipe.backend != "f32":
        raise RuntimeError(f"dense pipeline backend {pipe.backend}")
    scorer = pipe._bound.model
    metrics = pipe.metrics
    torch.cuda.reset_peak_memory_stats(cm.device)
    t0 = time.perf_counter()
    pipe.start()
    try:
        while (count[0] < target and pipe.error is None
               and time.perf_counter() < t0 + 300):
            time.sleep(0.005)
    finally:
        pipe.stop()
        pipe.join(timeout=60)
    dt = time.perf_counter() - t0
    if count[0] < target:
        raise RuntimeError(f"dense path scored {count[0]} < {target} records")
    snap = metrics.snapshot()
    dispatches = int(snap["batches"])
    fill = snap["batch_fill_records"] / dispatches
    # the card's share: the model function at the dispatch shape on the
    # data's first rows (a tree walk's gathers depend on them), and the
    # pageable H2D copy of X and M, timed alone (CUDA events)
    rows = int(round(fill))
    Xh = np.resize(data, (rows, F))
    Mh = np.isnan(Xh)
    Xh = np.where(Mh, 0.0, Xh).astype(np.float32)
    Xd = torch.from_numpy(Xh).to(cm.device)
    Md = torch.from_numpy(Mh).to(cm.device)
    with torch.no_grad():
        model_ms = cuda_ms(
            (lambda: scorer.predict(Xd, Md)) if mesh is not None
            else (lambda: cm._fn(cm.params, Xd, Md)), 2, 10)
    h2d_ms = cuda_ms(lambda: (torch.from_numpy(Xh).to(cm.device),
                              torch.from_numpy(Mh).to(cm.device)), 2, 10)
    return {
        "backend": pipe.backend, "compile_batch": batch, "fields": F,
        "records": count[0], "seconds": dt, "records_per_s": count[0] / dt,
        "dispatches": dispatches,
        "records_per_dispatch": snap["batch_fill_records"] / dispatches,
        "h2d_bytes_per_record": snap["h2d_bytes"] / snap["batch_fill_records"],
        "batch_latency_p50_s": snap.get("batch_latency_s_p50"),
        "batch_latency_p99_s": snap.get("batch_latency_s_p99"),
        "model_ms_per_dispatch": model_ms, "h2d_ms_per_dispatch": h2d_ms,
        "device_idle_share_est":
            1.0 - dispatches * (model_ms + h2d_ms) / (dt * 1e3),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(cm.device),
        "attribution": attr.summary(metrics),
    }, kept["head"]


def family_paths(workdir: str) -> list:
    """Each dense configuration compiled on the card (the default device)
    and scored through BlockPipeline's f32 backend, its head held to the
    CPU port and its ``score_records`` (outputs decoded) too. Records are
    N(0, 1.5) with 20% missing cells (numpy, seed 6) — past ``WIDE`` fields
    in 20% of the records only; a configuration's records cycle over one
    block of at most 64 MiB of values (one compile batch where that is
    less)."""
    import torch

    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    lines = []
    t0 = time.perf_counter()
    configs = family_configs(workdir)
    write_s = time.perf_counter() - t0
    for name, path, batch, target in configs:
        t0 = time.perf_counter()
        doc = parse_pmml_file(path)
        cm = compile_pmml(doc, batch_size=batch)
        cm_cpu = compile_pmml(doc, batch_size=batch, device="cpu")
        setup_s = time.perf_counter() - t0
        F = cm.field_space.arity
        if cm.quantized_scorer() is not None:
            raise RuntimeError(f"{name}: a rank wire for a dense family")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError("TF32 is on for float32 matmuls")
        rows = max(batch, min(DISPATCH, 2 ** 26 // (4 * F)) // batch * batch)
        rng = np.random.default_rng(6)
        data = rng.standard_normal(size=(rows, F), dtype=np.float32) * 1.5
        miss = rng.random(size=data.shape, dtype=np.float32) < MISSING
        if F > WIDE:
            # a record missing any input of these families scores empty:
            # at 20% of cells none would survive, so the missing cells
            # fall in 20% of the records, and the rest are complete
            miss &= (rng.random(size=(rows, 1)) < MISSING)
        data[miss] = np.nan
        sample = min(4096, batch)
        cm.predict(np.zeros((batch, F), np.float32),
                   np.zeros((batch, F), bool))  # warm the card's path
        run, head = drive_f32(cm, data, target, sample)
        t0 = time.perf_counter()
        Xh = data[:sample]
        Mh = np.isnan(Xh)
        ref = cm_cpu.predict(np.where(Mh, 0.0, Xh).astype(np.float32), Mh)
        lines.append({
            "config": name, **run, "parse_compile_s": setup_s,
            "missing": ("20% of cells in 20% of records" if F > WIDE
                        else "20% of cells"),
            "cpu_check": check_outputs(head, ref, name),
            "score_records_check": check_decoded(cm, cm_cpu, data[:16],
                                                 name),
        })
        lines[-1]["check_s"] = time.perf_counter() - t0
    lines[0]["documents_written_s"] = write_s
    return lines


# -- the tree shapes real exporters write (no kernel on these paths) ---------

_XML_HEAD = '<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3"><Header/>'


def _data_dictionary(continuous, categorical=(), n_values=0, target=None):
    """A DataDictionary: continuous double fields, string categorical
    fields of values v0..v{n-1}, and an optional continuous target."""
    values = "".join(f'<Value value="v{i}"/>' for i in range(n_values))
    return ("<DataDictionary>" + "".join(
        f'<DataField name="{f}" optype="continuous" dataType="double"/>'
        for f in continuous) + "".join(
        f'<DataField name="{f}" optype="categorical" dataType="string">'
        f"{values}</DataField>" for f in categorical)
        + (f'<DataField name="{target}" optype="continuous" '
           'dataType="double"/>' if target else "")
        + "</DataDictionary>")


def _schema(fields, target=None) -> str:
    return ("<MiningSchema>" + (
        f'<MiningField name="{target}" usageType="target"/>'
        if target else "") + "".join(
        f'<MiningField name="{f}"/>' for f in fields) + "</MiningSchema>")


def _grow_shape(rng, n_leaves: int, min_depth: int, max_depth: int) -> list:
    """A random binary tree shape as child pairs (``None`` for a leaf),
    node 0 the root: a spine of ``min_depth`` splits first, so the tree is
    at least that deep, then splits of random leaves shallower than
    ``max_depth`` until it holds ``n_leaves`` leaves."""
    kids, depth = [None], [0]
    open_leaves = [0]  # leaves that may still split
    n = 1

    def split(i):
        nonlocal n
        a, b = len(kids), len(kids) + 1
        kids[i] = (a, b)
        kids.extend([None, None])
        depth.extend([depth[i] + 1, depth[i] + 1])
        n += 1
        return a, b

    leaf = 0
    for _ in range(min_depth):
        a, b = split(leaf)
        open_leaves.append(b)
        leaf = a
    open_leaves.remove(0)
    open_leaves.append(leaf)
    while n < n_leaves and open_leaves:
        j = int(rng.integers(len(open_leaves)))
        i = open_leaves[j]
        open_leaves[j] = open_leaves[-1]
        open_leaves.pop()
        for c in split(i):
            if depth[c] < max_depth:
                open_leaves.append(c)
    return kids


def deep_rf_xml(n_trees: int = 100, n_fields: int = 32,
                max_leaves: int = 2048, max_depth: int = 24,
                min_depth: int = 11, seed: int = 41) -> str:
    """A sklearn-style RandomForestRegressor export: a MiningModel averaging
    ``n_trees`` regression TreeModels grown ragged (between half of
    ``max_leaves`` and ``max_leaves`` leaves, depth in [``min_depth``,
    ``max_depth``]). Each split is ``lessOrEqual`` with a ``<True/>``
    second child and names a ``defaultChild``; every node carries a score
    (the mean of its leaves, as a non-compact export writes), so the
    ``lastPrediction`` variant (``with_strategy``) returns interior scores
    when it halts."""
    rng = np.random.default_rng(seed)
    fields = [f"f{i}" for i in range(n_fields)]
    segs = []
    for t in range(n_trees):
        kids = _grow_shape(rng, int(rng.integers(max_leaves // 2,
                                                 max_leaves + 1)),
                           min_depth, max_depth)
        col = rng.integers(n_fields, size=len(kids))
        thr = rng.normal(0.0, 1.2, size=len(kids))
        go_left = rng.random(len(kids)) < 0.5
        leaf_val = rng.normal(0.0, 1.0, size=len(kids))
        score = np.zeros(len(kids))
        for i in range(len(kids) - 1, -1, -1):  # children follow parents
            score[i] = (leaf_val[i] if kids[i] is None
                        else 0.5 * (score[kids[i][0]] + score[kids[i][1]]))

        def node(i, pred):
            if kids[i] is None:
                return f'<Node id="{i}" score="{score[i]:.6g}">{pred}</Node>'
            a, b = kids[i]
            d = a if go_left[i] else b
            return (f'<Node id="{i}" score="{score[i]:.6g}" '
                    f'defaultChild="{d}">{pred}' + node(
                        a, f'<SimplePredicate field="f{col[i]}" '
                        f'operator="lessOrEqual" value="{thr[i]:.6g}"/>')
                    + node(b, "<True/>") + "</Node>")

        segs.append(
            f'<Segment id="{t}"><True/><TreeModel functionName="regression" '
            'missingValueStrategy="defaultChild">' + _schema(fields)
            + node(0, "<True/>") + "</TreeModel></Segment>")
    return (_XML_HEAD + _data_dictionary(fields)
            + '<MiningModel functionName="regression">' + _schema(fields)
            + '<Segmentation multipleModelMethod="average">' + "".join(segs)
            + "</Segmentation></MiningModel></PMML>")


def with_strategy(doc, strategy: str):
    """The parsed document with every segment tree's
    ``missingValueStrategy`` set to ``strategy`` (no second parse)."""
    import dataclasses

    mm = doc.model
    segs = tuple(dataclasses.replace(s, model=dataclasses.replace(
        s.model, missing_value_strategy=strategy))
        for s in mm.segmentation.segments)
    return dataclasses.replace(doc, model=dataclasses.replace(
        mm, segmentation=dataclasses.replace(mm.segmentation,
                                             segments=segs)))


def general_forest_xml(n_trees: int = 100, n_continuous: int = 32,
                       n_categorical: int = 4, n_values: int = 8,
                       max_leaves: int = 256, max_depth: int = 12,
                       seed: int = 43) -> str:
    """An rpart-style forest (a MiningModel averaging ``n_trees``
    regression TreeModels, ``missingValueStrategy="defaultChild"``): each
    split's two children carry ``surrogate`` CompoundPredicates — the
    primary split and 2 surrogates on other continuous fields, the right
    child's the complements of the left's. One primary in four is a
    SimpleSetPredicate (isIn / isNotIn) over a categorical field of
    ``n_values`` values; the rest are ``lessThan`` / ``greaterOrEqual``.
    Only one node in two names a ``defaultChild``: where a record misses
    all three fields of a split without one, the tree's result is null."""
    rng = np.random.default_rng(seed)
    cont = [f"x{i}" for i in range(n_continuous)]
    cats = [f"c{i}" for i in range(n_categorical)]
    fields = cont + cats

    def simple(f, op, v):
        return f'<SimplePredicate field="{f}" operator="{op}" value="{v:.6g}"/>'

    def sset(f, values, op):
        return (f'<SimpleSetPredicate field="{f}" booleanOperator="{op}">'
                f'<Array type="string" n="{len(values)}">'
                + " ".join(values) + "</Array></SimpleSetPredicate>")

    segs = []
    for t in range(n_trees):
        kids = _grow_shape(rng, int(rng.integers(max_leaves // 2,
                                                 max_leaves + 1)),
                           3, max_depth)
        leaf_val = rng.normal(0.0, 1.0, size=len(kids))

        def node(i, pred):
            if kids[i] is None:
                return (f'<Node id="{i}" score="{leaf_val[i]:.6g}">{pred}'
                        "</Node>")
            a, b = kids[i]
            f3 = rng.choice(n_continuous, size=3, replace=False)
            thr = rng.normal(0.0, 1.2, size=3)
            if cats and rng.random() < 0.25:
                cat = cats[int(rng.integers(n_categorical))]
                members = [f"v{k}" for k in sorted(rng.choice(
                    n_values, size=int(rng.integers(1, n_values)),
                    replace=False))]
                prim = (sset(cat, members, "isIn"),
                        sset(cat, members, "isNotIn"))
            else:
                prim = (simple(cont[f3[0]], "lessThan", thr[0]),
                        simple(cont[f3[0]], "greaterOrEqual", thr[0]))
            sur_l = [simple(cont[f3[k]], "lessThan", thr[k]) for k in (1, 2)]
            sur_r = [simple(cont[f3[k]], "greaterOrEqual", thr[k])
                     for k in (1, 2)]
            comp = '<CompoundPredicate booleanOperator="surrogate">'
            dflt = (f' defaultChild="{a if rng.random() < 0.5 else b}"'
                    if rng.random() < 0.5 else "")
            return (f'<Node id="{i}"{dflt}>{pred}'
                    + node(a, comp + prim[0] + "".join(sur_l)
                           + "</CompoundPredicate>")
                    + node(b, comp + prim[1] + "".join(sur_r)
                           + "</CompoundPredicate>") + "</Node>")

        segs.append(
            f'<Segment id="{t}"><True/><TreeModel functionName="regression" '
            'missingValueStrategy="defaultChild">' + _schema(fields)
            + node(0, "<True/>") + "</TreeModel></Segment>")
    return (_XML_HEAD + _data_dictionary(cont, cats, n_values)
            + '<MiningModel functionName="regression">' + _schema(fields)
            + '<Segmentation multipleModelMethod="average">' + "".join(segs)
            + "</Segmentation></MiningModel></PMML>")


def select_first_xml(workdir: str, n_trees: int = 100, depth: int = 6,
                     n_fields: int = 32, seed: int = 11) -> str:
    """"One model per segment": a MiningModel (``selectFirst``) of 4
    ``gen_gbm`` GBMs (seeds ``seed`` … ``seed + 3``), gated by f0 against
    the quartiles of N(0, 1.5) (lessThan q1, q2, q3; greaterOrEqual q3): a
    record with f0 missing matches no segment and scores empty."""
    import re

    from flink_jpmml_tpu_torch import assets_gen as ag

    q = 1.5 * 0.6744897501960817  # the upper quartile of N(0, 1.5)
    gates = [("lessThan", -q), ("lessThan", 0.0), ("lessThan", q),
             ("greaterOrEqual", q)]
    fields = [f"f{i}" for i in range(n_fields)]
    segs = []
    for k, (op, v) in enumerate(gates):
        with open(ag.gen_gbm(workdir, n_trees=n_trees, depth=depth,
                             n_features=n_fields, seed=seed + k,
                             name=f"select_first_{k}.pmml")) as f:
            xml = f.read()
        inner = xml[xml.index("<MiningModel"):
                    xml.index("</MiningModel>") + len("</MiningModel>")]
        inner = re.sub(r"<Targets>.*?</Targets>", "", inner, flags=re.S)
        segs.append(f'<Segment id="q{k}"><SimplePredicate field="f0" '
                    f'operator="{op}" value="{v!r}"/>{inner}</Segment>')
    return (_XML_HEAD + _data_dictionary(fields)
            + '<MiningModel functionName="regression">' + _schema(fields)
            + '<Segmentation multipleModelMethod="selectFirst">'
            + "".join(segs) + "</Segmentation></MiningModel></PMML>")


def iforest_xml(n_trees: int = 100, n_fields: int = 32, sample: int = 256,
                max_depth: int = 8, seed: int = 47) -> str:
    """A sklearn IsolationForest export: an AnomalyDetectionModel
    (``iforest``, ``sampleDataSize`` = ``sample``) over a MiningModel
    averaging ``n_trees`` isolation trees, each grown on ``sample`` N(0,
    1.5) points by random splits (a random field, a threshold uniform in
    the node's range) to depth ``max_depth``, with ``lessOrEqual`` /
    ``<True/>`` children; a leaf scores its depth plus c(points left)."""
    from flink_jpmml_tpu_torch.compile.anomaly import iforest_c

    rng = np.random.default_rng(seed)
    fields = [f"f{i}" for i in range(n_fields)]

    def leaf(pts, d, ident, pred):
        c = iforest_c(len(pts)) if len(pts) > 1 else 0.0
        return f'<Node id="{ident}" score="{d + c:.6g}">{pred}</Node>'

    def node(pts, d, ident, pred):
        if d >= max_depth or len(pts) <= 1:
            return leaf(pts, d, ident, pred)
        j = int(rng.integers(n_fields))
        lo, hi = pts[:, j].min(), pts[:, j].max()
        if lo == hi:
            return leaf(pts, d, ident, pred)
        thr = float(rng.uniform(lo, hi))
        left = pts[:, j] <= thr
        return (f'<Node id="{ident}">{pred}' + node(
            pts[left], d + 1, ident + "l",
            f'<SimplePredicate field="f{j}" operator="lessOrEqual" '
            f'value="{thr!r}"/>')
            + node(pts[~left], d + 1, ident + "r", "<True/>") + "</Node>")

    segs = []
    for t in range(n_trees):
        pts = rng.normal(0.0, 1.5, size=(sample, n_fields))
        segs.append('<Segment><True/><TreeModel functionName="regression">'
                    + _schema(fields, "s") + node(pts, 0, "n", "<True/>")
                    + "</TreeModel></Segment>")
    return (_XML_HEAD.replace('4_3" version="4.3"', '4_4" version="4.4"')
            + _data_dictionary(fields, target="s")
            + '<AnomalyDetectionModel functionName="regression" '
            f'algorithmType="iforest" sampleDataSize="{sample}">'
            + _schema(fields, "s") + '<MiningModel functionName="regression">'
            + _schema(fields, "s")
            + '<Segmentation multipleModelMethod="average">' + "".join(segs)
            + "</Segmentation></MiningModel></AnomalyDetectionModel></PMML>")


def scorecard_xml(n_chars: int = 10, n_attrs: int = 5, seed: int = 53) -> str:
    """A credit scorecard: ``n_chars`` characteristics (one continuous
    field each), each with an isMissing bin, ``n_attrs`` − 2 ``lessThan``
    bins at rising thresholds and a ``<True/>`` catch-all; a reasonCode on
    every attribute and a baselineScore on every characteristic
    (``pointsBelow``), and ``<Output>`` of the score and reason codes 1–3."""
    rng = np.random.default_rng(seed)
    fields = [f"f{i}" for i in range(n_chars)]
    chars = []
    for c, f in enumerate(fields):
        thr = np.sort(rng.normal(0.0, 1.5, size=n_attrs - 2))
        pts = rng.integers(0, 60, size=n_attrs)
        attrs = [f'<Attribute partialScore="{pts[0]}" reasonCode="RC{c}m">'
                 f'<SimplePredicate field="{f}" operator="isMissing"/>'
                 "</Attribute>"]
        attrs += [f'<Attribute partialScore="{pts[a + 1]}" '
                  f'reasonCode="RC{c}b{a}"><SimplePredicate field="{f}" '
                  f'operator="lessThan" value="{v:.6g}"/></Attribute>'
                  for a, v in enumerate(thr)]
        attrs.append(f'<Attribute partialScore="{pts[-1]}" '
                     f'reasonCode="RC{c}t"><True/></Attribute>')
        chars.append(f'<Characteristic name="ch{c}" '
                     f'baselineScore="{int(rng.integers(10, 50))}">'
                     + "".join(attrs) + "</Characteristic>")
    return (_XML_HEAD + _data_dictionary(fields, target="score")
            + '<Scorecard functionName="regression" initialScore="100" '
            'useReasonCodes="true" reasonCodeAlgorithm="pointsBelow">'
            + _schema(fields, "score")
            + '<Output><OutputField name="points" feature="predictedValue"/>'
            + "".join(f'<OutputField name="rc{r}" feature="reasonCode" '
                      f'rank="{r}"/>' for r in (1, 2, 3))
            + "</Output><Characteristics>" + "".join(chars)
            + "</Characteristics></Scorecard></PMML>")


def ruleset_xml(criterion: str, n_rules: int = 50, n_fields: int = 32,
                seed: int = 59) -> str:
    """A classification RuleSetModel of ``n_rules`` SimpleRules over
    ``n_fields`` continuous fields, each a SimplePredicate or an ``and`` of
    two, scoring one of 3 classes with a weight and a confidence, a
    defaultScore, selected by ``criterion`` (firstHit, weightedSum or
    weightedMax)."""
    rng = np.random.default_rng(seed)
    fields = [f"f{i}" for i in range(n_fields)]
    ops = ("lessThan", "greaterThan", "lessOrEqual", "greaterOrEqual")

    def simple():
        return (f'<SimplePredicate field="{fields[int(rng.integers(n_fields))]}" '
                f'operator="{ops[int(rng.integers(4))]}" '
                f'value="{rng.normal(0.0, 1.5):.6g}"/>')

    rules = []
    for r in range(n_rules):
        pred = (simple() if rng.random() < 0.5 else
                '<CompoundPredicate booleanOperator="and">' + simple()
                + simple() + "</CompoundPredicate>")
        rules.append(f'<SimpleRule id="r{r}" score="c{int(rng.integers(3))}" '
                     f'weight="{rng.uniform(0.5, 3.0):.4g}" '
                     f'confidence="{rng.uniform(0.3, 1.0):.4g}">{pred}'
                     "</SimpleRule>")
    return (_XML_HEAD + "<DataDictionary>" + "".join(
        f'<DataField name="{f}" optype="continuous" dataType="double"/>'
        for f in fields)
        + '<DataField name="cls" optype="categorical" dataType="string">'
        '<Value value="c0"/><Value value="c1"/><Value value="c2"/>'
        "</DataField></DataDictionary>"
        '<RuleSetModel functionName="classification">'
        + _schema(fields, "cls")
        + '<RuleSet defaultScore="c0" defaultConfidence="0.1">'
        f'<RuleSelectionMethod criterion="{criterion}"/>' + "".join(rules)
        + "</RuleSet></RuleSetModel></PMML>")


# the fixtures of the JAX package's tests (tests/test_tree_halt.py
# WEIGHTED_CONF / AGG_NODES, tests/test_trees_extended.py SELECT_ALL),
# copied: the card holds them without importing the JAX package's tests
WEIGHTED_CONF = """<PMML version="4.3"><DataDictionary>
  <DataField name="x" optype="continuous" dataType="double"/>
  <DataField name="cls" optype="categorical" dataType="string">
    <Value value="a"/><Value value="b"/></DataField>
  </DataDictionary>
  <TreeModel functionName="classification"
      missingValueStrategy="weightedConfidence">
  <MiningSchema><MiningField name="cls" usageType="target"/>
    <MiningField name="x"/></MiningSchema>
  <Node id="0" recordCount="100"><True/>
    <Node id="L" recordCount="60" score="a">
      <SimplePredicate field="x" operator="lessThan" value="0"/>
      <ScoreDistribution value="a" recordCount="45"/>
      <ScoreDistribution value="b" recordCount="15"/>
    </Node>
    <Node id="R" recordCount="40" score="b">
      <SimplePredicate field="x" operator="greaterOrEqual" value="0"/>
      <ScoreDistribution value="a" recordCount="8"/>
      <ScoreDistribution value="b" recordCount="32"/>
    </Node>
  </Node></TreeModel></PMML>"""

AGG_NODES = """<PMML version="4.3"><DataDictionary>
  <DataField name="x" optype="continuous" dataType="double"/>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <TreeModel functionName="regression"
      missingValueStrategy="aggregateNodes">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="x"/></MiningSchema>
  <Node id="0" recordCount="10"><True/>
    <Node id="L" recordCount="7" score="2.0">
      <SimplePredicate field="x" operator="lessThan" value="1"/></Node>
    <Node id="R" recordCount="3" score="10.0">
      <SimplePredicate field="x" operator="greaterOrEqual" value="1"/></Node>
  </Node></TreeModel></PMML>"""

SELECT_ALL = """<PMML version="4.3"><DataDictionary>
  <DataField name="x" optype="continuous" dataType="double"/>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <MiningModel functionName="regression">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="x"/></MiningSchema>
  <Segmentation multipleModelMethod="selectAll">
    <Segment id="lo"><SimplePredicate field="x" operator="lessThan"
        value="5"/>
      <TreeModel functionName="regression">
        <MiningSchema><MiningField name="y" usageType="target"/>
          <MiningField name="x"/></MiningSchema>
        <Node id="0" score="1.5"><True/></Node></TreeModel></Segment>
    <Segment id="hi"><SimplePredicate field="x" operator="greaterOrEqual"
        value="2"/>
      <TreeModel functionName="regression">
        <MiningSchema><MiningField name="y" usageType="target"/>
          <MiningField name="x"/></MiningSchema>
        <Node id="0" score="7.25"><True/></Node></TreeModel></Segment>
  </Segmentation></MiningModel></PMML>"""


def tree_shape_configs(workdir: str) -> list:
    """The ``tree_shapes`` phase's configurations: (name, parsed port
    document, compile batch, compile batches a dispatch, records to
    score, records held to the CPU port through ``predict``, records held
    through ``score_records``, the columns that hold categorical codes)."""
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    deep = parse_pmml(deep_rf_xml())
    K = 4 * DISPATCH
    configs = [
        ("deep_rf_default_child", deep, BATCH, 16, K, 4096, 16, 0),
        ("deep_rf_last_prediction", with_strategy(deep, "lastPrediction"),
         BATCH, 16, K, 4096, 16, 0),
        # the [B, T, K, KS] set-membership cube: 131,072 records a
        # dispatch; a 2,048-record head (the CPU takes 2.5 s a 4,096)
        ("general_forest", parse_pmml(general_forest_xml()), BATCH, 8,
         2 * 131_072, 2048, 16, 4),
        # four dense 100-tree path matrices: [B, T, S] per segment
        ("select_first", parse_pmml(select_first_xml(workdir)), BATCH, 4,
         DISPATCH, 2048, 16, 0),
        # the dense path over up to 255 splits a tree: one compile batch
        ("iforest", parse_pmml(iforest_xml()), BATCH, 1, DISPATCH, 4096, 16,
         0),
        ("scorecard", parse_pmml(scorecard_xml()), BATCH, 16, DISPATCH, 4096,
         4096, 0),
    ]
    configs += [(f"ruleset_{c}", parse_pmml(ruleset_xml(c)), BATCH, 16,
                 DISPATCH, 4096, 4096, 0)
                for c in ("firstHit", "weightedSum", "weightedMax")]
    configs += [(name, parse_pmml(xml), BATCH, 4, 65_536, 65_536, 16, 0)
                for name, xml in (("wtrees_weighted_confidence",
                                   WEIGHTED_CONF),
                                  ("wtrees_aggregate_nodes", AGG_NODES),
                                  ("select_all", SELECT_ALL))]
    return configs


def tree_shapes(workdir: str) -> list:
    """Each tree-shape configuration compiled on the card (the default
    device) and scored through BlockPipeline's f32 backend: the rank wire
    must decline every one of them (``quantized_scorer()`` is None). Records
    are N(0, 1.5) with 20% missing cells (numpy, seed 8); a categorical
    column holds codes 0–7 instead. The head is held to the CPU port
    through ``predict`` (rtol 1e-4 / atol 1e-5, labels equal), records
    through ``score_records`` (reason codes and segment maps equal), and
    ``score_records``' own records/s on the card is printed beside the
    pipeline's."""
    import torch

    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml

    lines = []
    t0 = time.perf_counter()
    configs = tree_shape_configs(workdir)
    write_s = time.perf_counter() - t0
    for name, doc, batch, chunks, target, sample, n_rec, n_cat in configs:
        t0 = time.perf_counter()
        cm = compile_pmml(doc, batch_size=batch)
        # no compile batch: its score_records scores the records alone, not
        # padded to 16,384 rows
        cm_cpu = compile_pmml(doc, device="cpu")
        setup_s = time.perf_counter() - t0
        if cm.quantized_scorer() is not None:
            raise RuntimeError(f"{name}: the rank wire took a tree shape it "
                               "declines")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError("TF32 is on for float32 matmuls")
        F = cm.field_space.arity
        rows = max(target // 4, min(target, DISPATCH))
        rng = np.random.default_rng(8)
        data = rng.standard_normal(size=(rows, F), dtype=np.float32) * 1.5
        if n_cat:
            data[:, F - n_cat:] = rng.integers(0, 8, size=(rows, n_cat))
        data[rng.random(size=data.shape, dtype=np.float32) < MISSING] = np.nan
        cm.predict(np.zeros((batch, F), np.float32),
                   np.zeros((batch, F), bool))  # warm the card's path
        run, head = drive_f32(cm, data, target, sample, chunks=chunks)
        t0 = time.perf_counter()
        Xh = data[:head[0].shape[0]]  # the first dispatch may hold fewer
        Mh = np.isnan(Xh)
        ref = cm_cpu.predict(np.where(Mh, 0.0, Xh).astype(np.float32), Mh)
        cpu_check = check_outputs(head, ref, name)
        recs = records_of(cm, data[:n_rec])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cm.score_records(recs)
        sr_s = time.perf_counter() - t1
        lines.append({
            "config": name, **run, "parse_compile_s": setup_s,
            "cpu_check": cpu_check,
            "score_records_check": check_decoded(cm, cm_cpu, data[:n_rec],
                                                 name),
            "score_records_per_s": n_rec / sr_s,
        })
        lines[-1]["check_s"] = time.perf_counter() - t0
    lines[0]["documents_written_s"] = write_s
    return lines


# -- the last nine families: what exporters write (no kernel on these paths) -

def _fields_dd(continuous, categorical=(), target=None, classes=None) -> str:
    """A DataDictionary of continuous double fields, string categorical
    fields (``(name, values)`` pairs) and a target: categorical over
    ``classes``, continuous without them."""
    def cat(name, values):
        return (f'<DataField name="{name}" optype="categorical" '
                'dataType="string">' + "".join(
                    f'<Value value="{v}"/>' for v in values) + "</DataField>")

    return ("<DataDictionary>" + "".join(
        f'<DataField name="{f}" optype="continuous" dataType="double"/>'
        for f in continuous) + "".join(cat(n, v) for n, v in categorical)
        + ((cat(target, classes) if classes else
            f'<DataField name="{target}" optype="continuous" '
            'dataType="double"/>') if target else "")
        + "</DataDictionary>")


def _reals(a) -> str:
    return " ".join(f"{v:.7g}" for v in np.ravel(a))


def naive_bayes_xml(n_classes: int = 3, n_continuous: int = 24,
                    n_categorical: int = 8, n_values: int = 10,
                    seed: int = 61) -> str:
    """A NaiveBayesModel as JPMML-SkLearn writes a GaussianNB with
    categorical inputs: TargetValueStats (a Gaussian per class) on each
    continuous field, PairCounts on each categorical field (some counts
    zero, so the threshold applies), and the class counts."""
    rng = np.random.default_rng(seed)
    classes = [f"k{i}" for i in range(n_classes)]
    cont = [f"x{i}" for i in range(n_continuous)]
    values = [f"v{i}" for i in range(n_values)]
    cat = [(f"c{i}", values) for i in range(n_categorical)]
    inputs = []
    for f in cont:
        stats = "".join(
            f'<TargetValueStat value="{k}"><GaussianDistribution '
            f'mean="{m:.7g}" variance="{v:.7g}"/></TargetValueStat>'
            for k, m, v in zip(classes, rng.normal(0.0, 1.0, n_classes),
                               rng.uniform(0.5, 4.0, n_classes)))
        inputs.append(f'<BayesInput fieldName="{f}"><TargetValueStats>'
                      f"{stats}</TargetValueStats></BayesInput>")
    for f, _ in cat:
        pairs = "".join(
            f'<PairCounts value="{v}"><TargetValueCounts>' + "".join(
                f'<TargetValueCount value="{k}" count="{int(c)}"/>'
                for k, c in zip(classes, rng.integers(0, 200, n_classes)))
            + "</TargetValueCounts></PairCounts>" for v in values)
        inputs.append(f'<BayesInput fieldName="{f}">{pairs}</BayesInput>')
    out = "".join(f'<TargetValueCount value="{k}" count="{int(c)}"/>'
                  for k, c in zip(classes,
                                  rng.integers(500, 5000, n_classes)))
    return (_XML_HEAD + _fields_dd(cont, cat, "y", classes)
            + '<NaiveBayesModel functionName="classification" '
            'threshold="0.001">' + _schema(cont + [f for f, _ in cat], "y")
            + "<BayesInputs>" + "".join(inputs) + "</BayesInputs>"
            f'<BayesOutput fieldName="y"><TargetValueCounts>{out}'
            "</TargetValueCounts></BayesOutput></NaiveBayesModel></PMML>")


def svm_xml(kernel: str = "rbf", n_classes: int = 4, n_vectors: int = 2000,
            n_fields: int = 32, seed: int = 67) -> str:
    """A SupportVectorMachineModel as JPMML-SkLearn writes an sklearn
    ``SVC(kernel="rbf")`` (``kernel="rbf"``: OneAgainstOne, one machine a
    class pair over the two classes' support vectors, γ = 1/fields) or an
    ``SVR(kernel="poly", degree=3)`` (``kernel="poly"``: one regression
    machine over every vector, γ = 1/fields, coef0 = 1)."""
    rng = np.random.default_rng(seed)
    fields = [f"x{i}" for i in range(n_fields)]
    vecs = rng.normal(0.0, 1.5, size=(n_vectors, n_fields))
    vd = (f'<VectorDictionary numberOfVectors="{n_vectors}">'
          f'<VectorFields numberOfFields="{n_fields}">' + "".join(
              f'<FieldRef field="{f}"/>' for f in fields) + "</VectorFields>"
          + "".join(f'<VectorInstance id="{i}"><Array n="{n_fields}" '
                    f'type="real">{_reals(v)}</Array></VectorInstance>'
                    for i, v in enumerate(vecs)) + "</VectorDictionary>")

    def machine(ids, attrs=""):
        return (f"<SupportVectorMachine{attrs}><SupportVectors "
                f'numberOfSupportVectors="{len(ids)}">' + "".join(
                    f'<SupportVector vectorId="{i}"/>' for i in ids)
                + "</SupportVectors><Coefficients "
                f'absoluteValue="{rng.normal(0.0, 0.5):.7g}">' + "".join(
                    f'<Coefficient value="{a:.7g}"/>'
                    for a in rng.uniform(-1.0, 1.0, len(ids)))
                + "</Coefficients></SupportVectorMachine>")

    gamma = 1.0 / n_fields
    if kernel == "poly":
        return (_XML_HEAD + _fields_dd(fields, target="y")
                + '<SupportVectorMachineModel functionName="regression">'
                + _schema(fields, "y")
                + f'<PolynomialKernelType gamma="{gamma:.7g}" coef0="1" '
                'degree="3"/>' + vd + machine(range(n_vectors))
                + "</SupportVectorMachineModel></PMML>")
    classes = [f"k{i}" for i in range(n_classes)]
    owner = np.arange(n_vectors) % n_classes  # each vector's class
    machines = "".join(
        machine(np.flatnonzero((owner == a) | (owner == b)).tolist(),
                f' targetCategory="{classes[a]}" '
                f'alternateTargetCategory="{classes[b]}"')
        for a in range(n_classes) for b in range(a + 1, n_classes))
    return (_XML_HEAD + _fields_dd(fields, target="y", classes=classes)
            + '<SupportVectorMachineModel functionName="classification" '
            'classificationMethod="OneAgainstOne">' + _schema(fields, "y")
            + f'<RadialBasisKernelType gamma="{gamma:.7g}"/>' + vd + machines
            + "</SupportVectorMachineModel></PMML>")


def knn_xml(n_instances: int = 10_000, n_fields: int = 16, k: int = 5,
            n_classes: int = 3, duplicated: float = 0.05,
            scoring: str = "majorityVote", seed: int = 71) -> str:
    """A NearestNeighborModel as JPMML-SkLearn writes a
    ``KNeighborsClassifier`` (euclidean, ``scoring`` majorityVote) or, with
    ``scoring="median"``, a ``KNeighborsRegressor``-style median over the
    same table: an InlineTable of the training set with instance ids
    (``instanceIdVariable``), a ``duplicated`` share of its rows copies of
    earlier rows (exact distance ties, each copy with a label of its own),
    and ``entityId`` outputs at ranks 1..k."""
    rng = np.random.default_rng(seed)
    fields = [f"x{i}" for i in range(n_fields)]
    X = rng.normal(0.0, 1.5, size=(n_instances, n_fields)).astype(np.float32)
    for r in np.sort(rng.choice(np.arange(1, n_instances),
                                int(duplicated * n_instances),
                                replace=False)):
        X[r] = X[rng.integers(0, r)]
    classification = scoring != "median"
    classes = [f"k{i}" for i in range(n_classes)]
    targets = ([classes[i] for i in rng.integers(0, n_classes, n_instances)]
               if classification else
               [f"{v:.7g}" for v in rng.normal(0.0, 2.0, n_instances)])
    rows = "".join(
        "<row>" + "".join(f"<{f}>{v:.7g}</{f}>" for f, v in zip(fields, x))
        + f"<y>{t}</y><rid>i{r}</rid></row>"
        for r, (x, t) in enumerate(zip(X.tolist(), targets)))
    method = ("categoricalScoringMethod" if classification
              else "continuousScoringMethod")
    return (_XML_HEAD + _fields_dd(fields, target="y",
                                   classes=classes if classification else None)
            + '<NearestNeighborModel functionName="'
            + ("classification" if classification else "regression")
            + f'" numberOfNeighbors="{k}" {method}="{scoring}" '
            'instanceIdVariable="rid">' + _schema(fields, "y")
            + "<Output>" + "".join(
                f'<OutputField name="nb{r}" feature="entityId" rank="{r}"/>'
                for r in range(1, k + 1))
            + '</Output><ComparisonMeasure kind="distance"><euclidean/>'
            "</ComparisonMeasure><KNNInputs>" + "".join(
                f'<KNNInput field="{f}"/>' for f in fields)
            + "</KNNInputs><TrainingInstances><InstanceFields>"
            '<InstanceField field="rid" column="rid"/>' + "".join(
                f'<InstanceField field="{f}" column="{f}"/>'
                for f in fields + ["y"])
            + f"</InstanceFields><InlineTable>{rows}</InlineTable>"
            "</TrainingInstances></NearestNeighborModel></PMML>")


def gp_xml(kernel: str = "ard", n_rows: int = 2000, n_fields: int = 8,
           seed: int = 73) -> str:
    """A GaussianProcessModel as JPMML-SkLearn writes a
    ``GaussianProcessRegressor``: an ARDSquaredExponentialKernel
    (``kernel="ard"``) or an AbsoluteExponentialKernel (``"absexp"``) with
    a length scale a field (1–2.5), noise 0.1, and the training rows
    inline."""
    rng = np.random.default_rng(seed)
    fields = [f"x{i}" for i in range(n_fields)]
    X = rng.normal(0.0, 1.5, size=(n_rows, n_fields))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] + rng.normal(0.0, 0.1, n_rows)
    tag = ("ARDSquaredExponentialKernel" if kernel == "ard"
           else "AbsoluteExponentialKernel")
    rows = "".join("<row>" + "".join(
        f"<{f}>{v:.7g}</{f}>" for f, v in zip(fields, x))
        + f"<y>{t:.7g}</y></row>" for x, t in zip(X.tolist(), y.tolist()))
    return (_XML_HEAD + _fields_dd(fields, target="y")
            + '<GaussianProcessModel functionName="regression">'
            + _schema(fields, "y")
            + f'<{tag} gamma="1.0" noiseVariance="0.1"><Lambda>'
            f'<Array n="{n_fields}" type="real">'
            f"{_reals(rng.uniform(1.0, 2.5, n_fields))}"
            f"</Array></Lambda></{tag}>"
            f'<TrainingInstances recordCount="{n_rows}"><InstanceFields>'
            + "".join(f'<InstanceField field="{f}" column="{f}"/>'
                      for f in fields + ["y"])
            + f"</InstanceFields><InlineTable>{rows}</InlineTable>"
            "</TrainingInstances></GaussianProcessModel></PMML>")


def bayesnet_xml(n_states: int = 4, n_nodes: int = 10, n_coparents: int = 3,
                 seed: int = 79) -> str:
    """A discrete BayesianNetworkModel: a target of ``n_states`` states
    with a prior, and ``n_nodes`` observed nodes of 3–5 states, each a
    child of the target; the last ``n_coparents`` of them have a second,
    observed parent (one of the first nodes). CPT rows are Dirichlet
    draws."""
    rng = np.random.default_rng(seed)
    states = [f"s{i}" for i in range(n_states)]
    nodes = [(f"o{j}", [f"o{j}v{v}" for v in range(int(rng.integers(3, 6)))])
             for j in range(n_nodes)]

    def probs(values, parents):
        return ("<DiscreteConditionalProbability>" + "".join(
            f'<ParentValue parent="{p}" value="{v}"/>' for p, v in parents)
            + "".join(f'<ValueProbability value="{v}" probability="{q:.7g}"/>'
                      for v, q in zip(values,
                                      rng.dirichlet(np.ones(len(values)))))
            + "</DiscreteConditionalProbability>")

    body = ['<DiscreteNode name="t">' + "".join(
        f'<ValueProbability value="{v}" probability="{q:.7g}"/>'
        for v, q in zip(states, rng.dirichlet(np.ones(n_states) * 4)))
        + "</DiscreteNode>"]
    for j, (name, values) in enumerate(nodes):
        co = nodes[j - (n_nodes - n_coparents)] if (
            j >= n_nodes - n_coparents) else None
        rows = [probs(values, [("t", s)] + ([(co[0], cv)] if co else []))
                for s in states for cv in (co[1] if co else [None])]
        body.append(f'<DiscreteNode name="{name}">' + "".join(rows)
                    + "</DiscreteNode>")
    return (_XML_HEAD + _fields_dd((), nodes, "t", states)
            + '<BayesianNetworkModel functionName="classification">'
            + _schema([n for n, _ in nodes], "t")
            + "<BayesianNetworkNodes>" + "".join(body)
            + "</BayesianNetworkNodes></BayesianNetworkModel></PMML>")


def baseline_xml(mean: float = 0.25, variance: float = 2.25) -> str:
    """A BaselineModel: the zValue of one field against a Gaussian
    baseline."""
    return (_XML_HEAD + _fields_dd(["x"])
            + '<BaselineModel functionName="regression">'
            '<MiningSchema><MiningField name="x"/></MiningSchema>'
            '<TestDistributions field="x" testStatistic="zValue"><Baseline>'
            f'<GaussianDistribution mean="{mean}" variance="{variance}"/>'
            "</Baseline></TestDistributions></BaselineModel></PMML>")


def assoc_xml(n_items: int = 200, n_rules: int = 1000, seed: int = 83) -> str:
    """An AssociationModel as R ``arules`` → ``pmml`` writes Apriori rules:
    ``n_items`` items (one basket field each), ``n_rules`` rules of 1–3
    antecedent items and one consequent item, support, confidence and
    lift, the ``recommendation`` criterion and ``ruleValue`` outputs
    (rule id, consequent and confidence at ranks 1–3)."""
    rng = np.random.default_rng(seed)
    items = [f"i{j}" for j in range(n_items)]
    sets, rules = [], []
    for r in range(n_rules):
        pick = rng.choice(n_items, int(rng.integers(1, 4)) + 1, replace=False)
        sets.append(f'<Itemset id="a{r}">' + "".join(
            f'<ItemRef itemRef="{j + 1}"/>' for j in pick[:-1]) + "</Itemset>"
            f'<Itemset id="c{r}"><ItemRef itemRef="{pick[-1] + 1}"/>'
            "</Itemset>")
        rules.append(f'<AssociationRule id="r{r}" '
                     f'support="{rng.uniform(0.01, 0.2):.4g}" '
                     f'confidence="{rng.uniform(0.1, 1.0):.4g}" '
                     f'lift="{rng.uniform(0.8, 3.0):.4g}" '
                     f'antecedent="a{r}" consequent="c{r}"/>')
    outputs = "".join(
        f'<OutputField name="{f}{k}" feature="ruleValue" '
        f'ruleFeature="{rf}" rank="{k}" algorithm="recommendation"/>'
        for k in (1, 2, 3)
        for f, rf in (("id", "ruleId"), ("rec", "consequent"),
                      ("conf", "confidence")))
    return (_XML_HEAD + _fields_dd(items)
            + '<AssociationModel functionName="associationRules" '
            f'numberOfTransactions="100000" numberOfItems="{n_items}" '
            'minimumSupport="0.01" minimumConfidence="0.1" '
            f'numberOfItemsets="{2 * n_rules}" numberOfRules="{n_rules}">'
            + _schema(items) + f"<Output>{outputs}</Output>" + "".join(
                f'<Item id="{j + 1}" value="{v}"/>'
                for j, v in enumerate(items))
            + "".join(sets) + "".join(rules) + "</AssociationModel></PMML>")


def text_xml(n_terms: int = 1000, n_docs: int = 2000, seed: int = 89) -> str:
    """A TextModel: ``n_terms`` terms (one count field each), ``n_docs``
    documents whose term counts are Poisson(2) at 5% density,
    termFrequency × inverseDocumentFrequency weights, cosine
    similarity."""
    rng = np.random.default_rng(seed)
    terms = [f"t{j}" for j in range(n_terms)]
    dtm = rng.poisson(2.0, size=(n_docs, n_terms)) * (
        rng.random((n_docs, n_terms)) < 0.05)
    return (_XML_HEAD + _fields_dd(terms)
            + '<TextModel functionName="classification" '
            f'numberOfTerms="{n_terms}" numberOfDocuments="{n_docs}">'
            + _schema(terms) + f'<TextDictionary><Array n="{n_terms}" '
            f'type="string">{" ".join(terms)}</Array></TextDictionary>'
            "<TextCorpus>" + "".join(f'<TextDocument id="d{i}"/>'
                                     for i in range(n_docs))
            + "</TextCorpus><DocumentTermMatrix><Matrix>" + "".join(
                f'<Array n="{n_terms}" type="real">'
                + " ".join(map(str, row)) + "</Array>" for row in dtm.tolist())
            + "</Matrix></DocumentTermMatrix>"
            '<TextModelNormalization localTermWeights="termFrequency" '
            'globalTermWeights="inverseDocumentFrequency" '
            'documentNormalization="none"/>'
            '<TextModelSimilarity similarityType="cosine"/></TextModel></PMML>')


def _ts_doc(body: str, version: str = "4.4") -> str:
    return (f'<PMML xmlns="http://www.dmg.org/PMML-{version.replace(".", "_")}"'
            f' version="{version}"><Header/><DataDictionary>'
            '<DataField name="h" optype="continuous" dataType="integer"/>'
            '<DataField name="y" optype="continuous" dataType="double"/>'
            "</DataDictionary>" + body + "</PMML>")


def arima_xml(n_history: int = 200, seed: int = 97) -> str:
    """A TimeSeriesModel holding ARIMA(2,1,1) (conditional least squares,
    a constant) over an ``n_history``-point history with its residuals."""
    rng = np.random.default_rng(seed)
    hist = 100.0 + np.cumsum(rng.normal(0.2, 1.0, n_history))
    tv = "".join(f'<TimeValue index="{i + 1}" value="{v:.7g}"/>'
                 for i, v in enumerate(hist))
    return _ts_doc(
        '<TimeSeriesModel functionName="timeSeries" bestFit="ARIMA">'
        '<MiningSchema><MiningField name="y" usageType="target"/>'
        '<MiningField name="h"/></MiningSchema>'
        f'<TimeSeries usage="original">{tv}</TimeSeries>'
        '<ARIMA constantTerm="0.05" transformation="none" '
        'predictionMethod="conditionalLeastSquares">'
        '<NonseasonalComponent p="2" d="1" q="1">'
        '<AR><Array type="real" n="2">0.45 -0.2</Array></AR>'
        '<MA><MACoefficients><Array type="real" n="1">0.3</Array>'
        '</MACoefficients><Residuals><Array type="real" n="4">'
        f"{_reals(rng.normal(0.0, 0.5, 4))}</Array></Residuals></MA>"
        "</NonseasonalComponent></ARIMA></TimeSeriesModel>")


def holt_winters_xml(period: int = 12, seed: int = 101) -> str:
    """A TimeSeriesModel holding Holt-Winters exponential smoothing: a
    damped additive trend (φ = 0.9) and multiplicative seasonality of
    ``period``."""
    rng = np.random.default_rng(seed)
    return _ts_doc(
        '<TimeSeriesModel functionName="timeSeries" '
        'bestFit="ExponentialSmoothing"><MiningSchema>'
        '<MiningField name="y" usageType="target"/><MiningField name="h"/>'
        "</MiningSchema><ExponentialSmoothing>"
        '<Level alpha="0.3" smoothedValue="120.5"/>'
        '<Trend_ExpoSmooth trend="damped_additive" gamma="0.1" '
        'smoothedValue="2.5" phi="0.9"/>'
        f'<Seasonality_ExpoSmooth type="multiplicative" period="{period}" '
        f'gamma="0.2"><Array n="{period}" type="real">'
        f"{_reals(rng.uniform(0.8, 1.2, period))}</Array>"
        "</Seasonality_ExpoSmooth></ExponentialSmoothing></TimeSeriesModel>",
    )


def more_family_rows(cm, rng, n: int, kind: str = "normal",
                     missing: float = 0.0) -> np.ndarray:
    """``n`` records for ``cm``'s field space, NaN where missing: N(0, 1.5)
    cells (``kind="normal"``), 0/1 baskets at 5% density (``"basket"``)
    or integer horizons 1–48 (``"horizon"``); a string-categorical column
    holds its declared codes. ``missing`` cells are NaN."""
    F = cm.field_space.arity
    if kind == "basket":
        data = (rng.random(size=(n, F), dtype=np.float32) < 0.05).astype(
            np.float32)
    elif kind == "horizon":
        data = rng.integers(1, 49, size=(n, F)).astype(np.float32)
    else:
        data = rng.standard_normal(size=(n, F), dtype=np.float32) * 1.5
    for j, f in enumerate(cm.field_space.fields):
        codec = cm.field_space.codecs.get(f)
        if codec:
            data[:, j] = rng.integers(0, len(codec), size=n)
    data[rng.random(size=data.shape, dtype=np.float32) < missing] = np.nan
    return data


def more_family_configs() -> list:
    """The ``more_families`` phase's configurations at full width: (name,
    parsed port document, compile batch, compile batches a dispatch,
    records to score, rows kind, missing share). Only families with
    missing-value routing (NaiveBayes drops the term, a basket or term
    count reads 0) get missing cells; the others empty such a record.
    Widths are the exporters'; the record count is the one cut (no family
    here has a depth), and ``CUTS`` says so on each line."""
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    K = 4 * DISPATCH
    return [
        ("naive_bayes", parse_pmml(naive_bayes_xml()), BATCH, 16, K,
         "normal", MISSING),
        # a [65,536, 2,000] kernel block is 0.5 GB
        ("svm_rbf", parse_pmml(svm_xml()), BATCH, 4, DISPATCH, "normal", 0.0),
        ("svr_poly", parse_pmml(svm_xml("poly", n_vectors=1000)), BATCH, 4,
         DISPATCH, "normal", 0.0),
        # one [4,096, 10,000, 16] f32 cube would be 2.6 GB: chunked inside
        ("knn", parse_pmml(knn_xml()), 4096, 1, 65_536, "normal", 0.0),
        ("knn_median", parse_pmml(knn_xml(k=4, scoring="median")), 4096, 1,
         65_536, "normal", 0.0),
        ("gp_ard", parse_pmml(gp_xml()), BATCH, 4, DISPATCH, "normal", 0.0),
        ("gp_absexp", parse_pmml(gp_xml("absexp", n_rows=1000)), BATCH, 1,
         DISPATCH, "normal", 0.0),
        ("bayesnet", parse_pmml(bayesnet_xml()), BATCH, 16, K, "normal", 0.0),
        ("baseline", parse_pmml(baseline_xml()), BATCH, 16, K, "normal", 0.0),
        ("assoc", parse_pmml(assoc_xml()), BATCH, 4, DISPATCH, "basket",
         MISSING),
        # 82 MB of X and M a dispatch
        ("textmodel", parse_pmml(text_xml()), BATCH, 1, 131_072, "normal",
         MISSING),
        ("arima", parse_pmml(arima_xml()), BATCH, 16, K, "horizon", 0.0),
        ("holt_winters", parse_pmml(holt_winters_xml()), BATCH, 16, K,
         "horizon", 0.0),
    ]


CUTS = ("widths as exported, no depth to cut; the stream cut to the "
        "records scored")


def exact_columns(cm) -> int:
    """Where a head's ``probs`` stop being shares: KNN neighbour indices
    after the labels, an association's fired-rule mask from column 0;
    -1 where every column is a share."""
    if cm._neighbor_meta is not None:
        return len(cm.labels)
    return 0 if cm._rule_meta is not None else -1


def more_families(workdir: str) -> list:
    """Each of the last nine families compiled on the card (the default
    device, ``warmup()`` first) and scored through BlockPipeline's f32
    backend at its published widths; the head is held to the CPU port
    through ``predict`` (rtol 1e-4 / atol 1e-5, labels equal, KNN
    neighbour ids and the fired-rule mask exactly equal) and 4,096
    records through ``score_records`` (rank-k ``entityId`` and
    ``ruleValue`` outputs equal). Records are made with numpy, seed 10.
    Then the ModelVerification documents of the JAX tests replay on the
    card: ``verify()`` returns ``[]``, and a copy with one expected value
    altered reports the same mismatch as the CPU port."""
    import torch

    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml

    lines = []
    t0 = time.perf_counter()
    configs = more_family_configs()
    write_s = time.perf_counter() - t0
    for name, doc, batch, chunks, target, kind, missing in configs:
        t0 = time.perf_counter()
        cm = compile_pmml(doc, batch_size=batch).warmup()
        cm_cpu = compile_pmml(doc, device="cpu")
        setup_s = time.perf_counter() - t0
        if cm.quantized_scorer() is not None:
            raise RuntimeError(f"{name}: a rank wire for a dense family")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError("TF32 is on for float32 matmuls")
        rng = np.random.default_rng(10)
        rows = max(target // 4, min(target, batch * chunks))
        data = more_family_rows(cm, rng, rows, kind, missing)
        run, head = drive_f32(cm, data, target, min(4096, batch),
                              chunks=chunks)
        t0 = time.perf_counter()
        Xh = data[:head[0].shape[0]]
        Mh = np.isnan(Xh)
        ref = cm_cpu.predict(np.where(Mh, 0.0, Xh).astype(np.float32), Mh)
        cpu_check = check_outputs(head, ref, name)
        ex = exact_columns(cm)
        if ex >= 0:
            valid = ref.valid.numpy()
            got = np.asarray(head[2])[valid, ex:]
            if not np.array_equal(got, ref.probs.numpy()[valid, ex:]):
                raise RuntimeError(f"{name}: neighbour ids / fired rules "
                                   "differ from the CPU port")
            cpu_check["exact_columns_checked"] = int(got.size)
        n_rec = min(4096, batch)
        recs = records_of(cm, data[:n_rec])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cm.score_records(recs)
        sr_s = time.perf_counter() - t1
        lines.append({
            "config": name, **run, "parse_compile_s": setup_s,
            "cuts": CUTS, "missing": missing, "rows": kind,
            "cpu_check": cpu_check,
            "score_records_check": check_decoded(cm, cm_cpu, data[:n_rec],
                                                 name),
            "score_records_per_s": len(recs) / sr_s,
        })
        lines[-1]["check_s"] = time.perf_counter() - t0
    lines[0]["documents_written_s"] = write_s
    lines.append(check_verification())
    return lines


# the ModelVerification documents of the JAX package's tests
# (tests/test_verification.py REG, CLS, CAT and NUMLABEL), copied: the
# card replays them without importing the JAX package's tests
VERIFY_REG = """<PMML version="4.3" xmlns:data="http://example.com/data">
  <DataDictionary>
  <DataField name="x1" optype="continuous" dataType="double"/>
  <DataField name="x2" optype="continuous" dataType="double"/>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <RegressionModel functionName="regression">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="x1"/><MiningField name="x2"/></MiningSchema>
  <RegressionTable intercept="0.5">
    <NumericPredictor name="x1" coefficient="2.0"/>
    <NumericPredictor name="x2" coefficient="-3.0"/>
  </RegressionTable>
  <ModelVerification recordCount="2" fieldCount="3">
    <VerificationFields>
      <VerificationField field="x1" column="data:x1"/>
      <VerificationField field="x2" column="data:x2"/>
      <VerificationField field="y" column="data:y" precision="1E-5"/>
    </VerificationFields>
    <InlineTable>
      <row><data:x1>1.0</data:x1><data:x2>2.0</data:x2>
        <data:y>{y1}</data:y></row>
      <row><data:x1>-0.5</data:x1><data:x2>0.25</data:x2>
        <data:y>{y2}</data:y></row>
    </InlineTable>
  </ModelVerification>
  </RegressionModel></PMML>"""

VERIFY_CLS = """<PMML version="4.3"><DataDictionary>
  <DataField name="x" optype="continuous" dataType="double"/>
  <DataField name="cls" optype="categorical" dataType="string">
    <Value value="pos"/><Value value="neg"/></DataField>
  </DataDictionary>
  <RegressionModel functionName="classification"
      normalizationMethod="softmax">
  <MiningSchema><MiningField name="cls" usageType="target"/>
    <MiningField name="x"/></MiningSchema>
  <RegressionTable intercept="0.0" targetCategory="pos">
    <NumericPredictor name="x" coefficient="1.0"/>
  </RegressionTable>
  <RegressionTable intercept="0.0" targetCategory="neg"/>
  <ModelVerification recordCount="1" fieldCount="3">
    <VerificationFields>
      <VerificationField field="x" column="x"/>
      <VerificationField field="cls" column="cls"/>
      <VerificationField field="probability(pos)" column="p_pos"
          precision="1E-4"/>
    </VerificationFields>
    <InlineTable>
      <row><x>2.0</x><cls>{label}</cls><p_pos>{p}</p_pos></row>
    </InlineTable>
  </ModelVerification>
  </RegressionModel></PMML>"""

VERIFY_CAT = """<PMML version="4.3"><DataDictionary>
  <DataField name="grade" optype="categorical" dataType="string">
    <Value value="2"/><Value value="4"/></DataField>
  <DataField name="y" optype="continuous" dataType="double"/>
  </DataDictionary>
  <RegressionModel functionName="regression">
  <MiningSchema><MiningField name="y" usageType="target"/>
    <MiningField name="grade"/></MiningSchema>
  <RegressionTable intercept="1.0">
    <CategoricalPredictor name="grade" value="4" coefficient="10.0"/>
  </RegressionTable>
  <ModelVerification recordCount="2" fieldCount="2">
    <VerificationFields>
      <VerificationField field="grade" column="grade"/>
      <VerificationField field="y" column="y"/>
    </VerificationFields>
    <InlineTable>
      <row><grade>4</grade><y>{y}</y></row>
      <row><grade>2</grade><y>1.0</y></row>
    </InlineTable>
  </ModelVerification>
  </RegressionModel></PMML>"""

VERIFY_NUMLABEL = """<PMML version="4.3"><DataDictionary>
  <DataField name="x" optype="continuous" dataType="double"/>
  <DataField name="cls" optype="categorical" dataType="string">
    <Value value="0"/><Value value="1"/></DataField>
  </DataDictionary>
  <RegressionModel functionName="classification"
      normalizationMethod="softmax">
  <MiningSchema><MiningField name="cls" usageType="target"/>
    <MiningField name="x"/></MiningSchema>
  <RegressionTable intercept="0.0" targetCategory="1">
    <NumericPredictor name="x" coefficient="1.0"/>
  </RegressionTable>
  <RegressionTable intercept="0.0" targetCategory="0"/>
  <ModelVerification recordCount="1" fieldCount="2">
    <VerificationFields>
      <VerificationField field="x" column="x"/>
      <VerificationField field="cls" column="cls"/>
    </VerificationFields>
    <InlineTable><row><x>3.0</x><cls>{label}</cls></row></InlineTable>
  </ModelVerification>
  </RegressionModel></PMML>"""

_P_POS = "0.880797"  # 1 / (1 + e^-2), six places


def verify_docs() -> dict:
    """name → (the document as embedded, a copy with one expected value
    altered)."""
    return {
        "regression": (VERIFY_REG.format(y1="-3.5", y2="-1.25"),
                       VERIFY_REG.format(y1="-3.5", y2="7.0")),
        "classification": (VERIFY_CLS.format(label="pos", p=_P_POS),
                            VERIFY_CLS.format(label="neg", p=_P_POS)),
        "numeric_looking_category": (VERIFY_CAT.format(y="11.0"),
                                     VERIFY_CAT.format(y="12.0")),
        "numeric_class_label": (VERIFY_NUMLABEL.format(label="1"),
                                VERIFY_NUMLABEL.format(label="0")),
    }


def check_verification() -> dict:
    """``verify()`` on the card over each document: ``[]`` as embedded;
    on the altered copy, one mismatch, the CPU port's message exactly."""
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    out = {}
    for name, (good, bad) in verify_docs().items():
        cm = compile_pmml(parse_pmml(good))
        if cm.device.type != "cuda" or not cm.has_verification:
            raise RuntimeError(f"verify {name}: not on the card")
        if cm.verify() != []:
            raise RuntimeError(f"verify {name}: {cm.verify()}")
        got = compile_pmml(parse_pmml(bad)).verify()
        want = compile_pmml(parse_pmml(bad), device="cpu").verify()
        if len(got) != 1 or got != want:
            raise RuntimeError(f"verify {name} (altered): {got} vs {want}")
        out[name] = got[0]
    return {"config": "verify", "documents": len(out), "mismatches": out}


# -- the record API and dynamic serving -------------------------------------

RECORD_VECTORS = DISPATCH  # dense vectors through evaluate / quick_evaluate
RECORD_DICTS = 65536  # dict records through evaluate
RECORD_EVENTS = DISPATCH  # events through the dynamic scorer
RECORD_KAFKA = 65536  # JSON records from the broker


def dict_rows(X: np.ndarray, fields) -> list:
    """Dict records of ``X`` over ``fields``, NaN cells left out."""
    return [{f: v for f, v in zip(fields, row) if v == v}
            for row in X.tolist()]


def record_stats(metrics, seconds: float, n: int) -> dict:
    """One record-engine run's line: rate, latencies, the StageTimer
    stages and the stage ledger of its registry."""
    from flink_jpmml_tpu_torch.obs import attr

    snap = metrics.snapshot()
    batches = int(snap.get("batches", 0))
    return {
        "records": n, "seconds": seconds, "records_per_s": n / seconds,
        "batches": batches,
        "records_per_batch": snap.get("batch_fill_records", 0) / max(batches, 1),
        "record_latency_p50_s": snap.get("record_latency_s_p50"),
        "record_latency_p99_s": snap.get("record_latency_s_p99"),
        "stages_s": {s: snap.get(f"stage_{s}_s")
                     for s in ("featurize_dispatch", "readback", "sink")},
        "attribution": attr.summary(metrics),
    }


def check_values(got, ref: np.ndarray, label: str) -> float:
    """Regression predictions against reference values at the rank-wire
    bar → the largest difference."""
    vals = np.array([np.nan if p.is_empty else p.score.value for p in got])
    if (vals.shape != ref.shape or not np.isfinite(vals).all()
            or not np.allclose(vals, ref, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"{label}: {vals.shape} values differ from the "
                           f"reference (or are not finite)")
    return float(np.abs(vals - ref).max())


def check_vote_preds(got, ref, labels, label: str) -> float:
    """Vote-forest predictions against (value, shares, label index) rows of
    the same kernel path: values and shares at the bar, labels equal."""
    rv, rp, rl = (np.asarray(a) for a in ref)
    gv = np.array([p.score.value for p in got])
    gp = np.array([[p.target.probabilities[c] for c in labels] for p in got])
    gl = [p.target.label for p in got]
    if not (np.allclose(gv, rv, rtol=RTOL, atol=ATOL)
            and np.allclose(gp, rp, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"{label}: vote values or shares differ")
    if gl != [labels[i] for i in rl]:
        raise RuntimeError(f"{label}: vote labels differ")
    return float(np.abs(gp - rp).max())


def wire_rows(q, X: np.ndarray):
    """The rank-wire scorer's output on ``X`` (encoded on the host), as
    host arrays."""
    out = q.predict_padded(*q.pad_wire(q.wire.encode(X)))
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy()[: X.shape[0]] for o in out)
    return out.cpu().numpy()[: X.shape[0]]


class ScriptedEvents:
    """A finite record source whose ``marks`` — ``(offset, action)`` in
    offset order — run on the ingest thread before the records from that
    offset on are handed out: control messages land exactly between two
    stretches of the stream."""

    event_time_fn = None

    def __init__(self, events: list, marks: list):
        self._events = events
        self._marks = list(marks)
        self._pos = 0

    def poll(self, max_n: int):
        if self._marks and self._pos == self._marks[0][0]:
            self._marks.pop(0)[1]()
        end = min(self._pos + max_n, len(self._events))
        if self._marks:
            end = min(end, self._marks[0][0])
        out = [(i + 1, self._events[i]) for i in range(self._pos, end)]
        self._pos = end
        return out

    def seek(self, offset: int) -> None:
        self._pos = offset

    @property
    def exhausted(self) -> bool:
        return self._pos >= len(self._events) and not self._marks

    def close(self) -> None:
        pass


def wait_for(pred, what: str, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.002)


def record_static(reader, records, ref: np.ndarray, counter, quick=False,
                  sample: int = 4096) -> dict:
    """``StreamEnvironment().from_collection(records).evaluate(reader)``
    (or ``quick_evaluate``) on the card; the launches of its run against
    its dispatches; its head against ``ref``."""
    from flink_jpmml_tpu_torch.api import StreamEnvironment
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    env = StreamEnvironment(RuntimeConfig(batch=BatchConfig(
        size=BATCH, deadline_us=5000)))
    if env.device.type != "cuda":
        raise RuntimeError(f"StreamEnvironment() chose {env.device}")
    stream = env.from_collection(records)
    sink = (stream.quick_evaluate if quick else stream.evaluate)(
        reader).collect()
    counter.launches = 0
    t0 = time.perf_counter()
    env.execute(timeout=900.0)
    dt = time.perf_counter() - t0
    launches = counter.launches
    items = sink.items
    if len(items) != len(records):
        raise RuntimeError(f"{len(items)} of {len(records)} records sunk")
    preds = [p for p, _ in items] if quick else items
    if quick and any(r is not rec for (_, r), rec in zip(items, records)):
        raise RuntimeError("quick_evaluate pairs out of order")
    run = record_stats(env.metrics, dt, len(records))
    snap = env.metrics.snapshot()
    if snap.get("scorer_backend_rank_wire_cuda") != 1:
        raise RuntimeError("the static scorer is not on the kernel")
    if launches != run["batches"]:
        raise RuntimeError(f"{launches} launches for {run['batches']} "
                           "rank-wire dispatches")
    run.update(launches=launches, check_rows=sample,
               max_abs_err=check_values(preds[:sample], ref[:sample],
                                        "record_api head"))
    return run


def record_dynamic(gbm: str, gbm2: str, votes: str, X: np.ndarray, counter,
                   refs: dict, sample: int = 4096) -> dict:
    """``with_control_stream(ctrl).evaluate(ModelReader(gbm))`` on the card
    over events for ``gbm``, ``votes`` and an unserved name: Add gbm v1 and
    votes v1 before the run; Add gbm v2 at a quarter of the stream; once
    v2 is warm, Del gbm v1 at half, with a quarter of the later gbm events
    pinned to v1."""
    from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
    from flink_jpmml_tpu_torch.models.control import AddMessage, DelMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    n = X.shape[0]
    k1, k2 = n // 4, n // 2
    rng = np.random.default_rng(7)
    kind = rng.choice(3, p=[0.45, 0.45, 0.10], size=n)  # gbm, votes, ghost
    pinned = (np.arange(n) >= k2) & (kind == 0) & (rng.random(n) < 0.25)
    names = ("gbm", "votes", "ghost")
    events = [{"_model": "gbm", "_version": 1, "row": i} if pinned[i]
              else (names[kind[i]], X[i]) for i in range(n)]
    env = StreamEnvironment(RuntimeConfig(batch=BatchConfig(
        size=BATCH, deadline_us=5000)))
    ctrl = ControlSource()
    fill = env.metrics.counter("batch_fill_records")
    holder = {"wait_s": 0.0}

    def add_v2():
        t = time.perf_counter()
        wait_for(lambda: fill.get() >= k1, "the first quarter's submit")
        holder["wait_s"] += time.perf_counter() - t
        ctrl.push(AddMessage("gbm", 2, gbm2, 2.0))

    def del_v1():
        reg = holder["scorer"].registry
        t = time.perf_counter()
        wait_for(lambda: fill.get() >= k2
                 and reg.model_if_warm(ModelId("gbm", 2)) is not None,
                 "gbm v2's warm")
        holder["wait_s"] += time.perf_counter() - t
        ctrl.push(DelMessage("gbm", 1, 3.0))

    ev = env.from_source(ScriptedEvents(events, [(k1, add_v2), (k2, del_v1)])
                         ).with_control_stream(ctrl).evaluate(ModelReader(gbm))
    scorer = holder["scorer"] = ev.scorer
    sink = ev.collect()
    # Add v1 of both before the run; an empty batch drains them, and the
    # run starts once both are warm
    ctrl.push(AddMessage("gbm", 1, gbm, 1.0))
    ctrl.push(AddMessage("votes", 1, votes, 1.5))
    scorer.finish(scorer.submit([]))
    for name in ("gbm", "votes"):
        if scorer.registry.model(ModelId(name, 1)).device.type != "cuda":
            raise RuntimeError(f"{name} v1 not on the card")
    # each batch's groups: one dispatch a served model present
    groups = []
    submit = scorer.submit

    def logged_submit(records):
        ticket = submit(records)
        present = {e[0] for e in records
                   if isinstance(e, tuple) and e[0] != "ghost"}
        groups.append((len(ticket[2]), "gbm" in present, "votes" in present))
        return ticket

    scorer.submit = logged_submit
    cold = env.metrics.histogram("cold_start_s")
    warms0 = cold.count()
    counter.launches = 0
    counter.launches_by_classes = {}
    t0 = time.perf_counter()
    env.execute(timeout=900.0)
    dt = time.perf_counter() - t0
    launches = counter.launches
    # the kernel's own count by class count: C = 1 is the GBM, C > 1 the
    # vote forest
    by_c = dict(counter.launches_by_classes)
    launches_gbm = by_c.get(1, 0)
    launches_votes = sum(k for c, k in by_c.items() if c > 1)
    warms = cold.count() - warms0
    snap = env.metrics.snapshot()
    dispatches = int(snap["dispatches"])
    items = sink.items
    if len(items) != n or any(e is not ev_ for (_, e), ev_ in zip(items, events)):
        raise RuntimeError("dynamic stream lost or reordered events")
    if any(g != h + v for g, h, v in groups) or sum(
            g for g, _, _ in groups) != dispatches:
        raise RuntimeError(f"groups {groups[:8]}... against {dispatches} "
                           "dispatches")
    if (launches != dispatches + warms
            or launches_gbm + launches_votes != launches):
        raise RuntimeError(f"{launches} launches ({by_c} by class count) for "
                           f"{dispatches} dispatches and {warms} warms")
    # cross-check: the models present in each batch, v2's warm a GBM's
    if (launches_gbm != sum(h for _, h, _ in groups) + warms
            or launches_votes != sum(v for _, _, v in groups)):
        raise RuntimeError(f"launches by class count {by_c} against the "
                           f"groups {groups[:8]}... and {warms} warms")
    preds = [p for p, _ in items]
    empty = np.array([p.is_empty for p in preds])
    if not np.array_equal(empty, (kind == 2) | pinned):
        raise RuntimeError("empty lanes are not exactly the unserved and the "
                           "deleted version's")
    # the head: every event before v2's Add, held to the CPU port
    head = np.arange(sample)
    g_idx, v_idx = head[kind[:sample] == 0], head[kind[:sample] == 1]
    err = check_values([preds[i] for i in g_idx], refs["gbm_cpu"][g_idx],
                       "dynamic head, gbm")
    verr = check_vote_preds([preds[i] for i in v_idx],
                            [a[v_idx] for a in refs["votes_cpu"]],
                            refs["labels"], "dynamic head, votes")
    # the rest against the card's direct runs: every vote event; each
    # unpinned gbm event is v1's until the swap, v2's after, and v2's
    # after the Del
    cards = {k: ModelReader(p).load(batch_size=BATCH).quantized_scorer()
             for k, p in (("v1", gbm), ("v2", gbm2), ("votes", votes))}
    vi = np.flatnonzero(kind == 1)
    check_vote_preds([preds[i] for i in vi], wire_rows(cards["votes"], X[vi]),
                     refs["labels"], "dynamic votes")
    gi = np.flatnonzero((kind == 0) & ~pinned)
    vals = np.array([preds[i].score.value for i in gi])
    is1 = np.isclose(vals, wire_rows(cards["v1"], X[gi]), rtol=RTOL, atol=ATOL)
    is2 = np.isclose(vals, wire_rows(cards["v2"], X[gi]), rtol=RTOL, atol=ATOL)
    if not (is1 | is2).all():
        raise RuntimeError("a gbm event matches neither version")
    only2 = is2 & ~is1
    swap = int(np.argmax(only2)) if only2.any() else len(gi)
    if not (is1[:swap].all() and is2[swap:].all()
            and (swap == len(gi) or gi[swap] >= k1)
            and swap <= np.searchsorted(gi, k2)):
        raise RuntimeError(f"the latest-wins swap (gbm event {swap}) breaks "
                           "the v1 → v2 order")
    scorer.submit = submit
    run = record_stats(env.metrics, dt, n)
    run.update(
        # the ingest thread's waits at the two marks (the second one for
        # v2's warm) are in the wall; the rate without them beside it
        mark_wait_s=holder["wait_s"],
        records_per_s_without_mark_waits=n / (dt - holder["wait_s"]),
        launches=launches, dispatches=dispatches, warm_launches=warms,
        launches_gbm=launches_gbm, launches_votes=launches_votes,
        score_latency_p50_s=snap.get("score_latency_s_p50"),
        score_latency_p99_s=snap.get("score_latency_s_p99"),
        cold_start_s=cold.sum(), cold_starts=cold.count(),
        warm_pool_hits=snap.get("warm_pool_hits"),
        warm_pool_misses=snap.get("warm_pool_misses"),
        empty_lanes=int(empty.sum()),
        swap_event=int(gi[swap]) if swap < len(gi) else None,
        add_v2_event=k1, del_v1_event=k2,
        h2d_bytes_per_record=snap.get("h2d_bytes", 0) / max(n - int(empty.sum()), 1),
        check_rows=sample, max_abs_err=max(err, verr))
    return run


def record_kafka(gbm: str, X: np.ndarray, fields, counter, ref: np.ndarray,
                 sample: int = 4096) -> dict:
    """A port ``MiniKafkaBroker`` holding one JSON record of the GBM's
    fields a message → ``from_source(KafkaRecordSource(...))`` →
    ``evaluate`` on the card, through the prefetch sidecar."""
    from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
    from flink_jpmml_tpu_torch.runtime.kafka import (
        KafkaRecordSource,
        MiniKafkaBroker,
    )
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    n = X.shape[0]
    vals = [json.dumps(r).encode() for r in dict_rows(X, fields)]
    broker = MiniKafkaBroker(topic="records")
    src = None
    try:
        for i in range(0, n, 1024):
            broker.append(*vals[i:i + 1024])
        env = StreamEnvironment(RuntimeConfig(batch=BatchConfig(
            size=BATCH, deadline_us=5000)))
        src = KafkaRecordSource(broker.host, broker.port, "records",
                                max_wait_ms=20, metrics=env.metrics)
        sink = env.from_source(src).evaluate(ModelReader(gbm)).collect()
        pipe = env._pipelines[0]
        fill = env.metrics.counter("batch_fill_records")
        counter.launches = 0
        t0 = time.perf_counter()
        env.start()
        try:
            # every record submitted; stop() then finishes the window
            wait_for(lambda: fill.get() >= n or pipe._error is not None,
                     "the Kafka records", timeout=600.0)
        finally:
            env.stop()
        dt = time.perf_counter() - t0
        launches = counter.launches
    finally:
        if src is not None:
            src.close()
        broker.close()
    items = sink.items
    if len(items) != n:
        raise RuntimeError(f"{len(items)} of {n} Kafka records sunk")
    run = record_stats(env.metrics, dt, n)
    if launches != run["batches"]:
        raise RuntimeError(f"{launches} launches for {run['batches']} "
                           "rank-wire dispatches")
    s = env.metrics.struct_snapshot()
    cs, gs = s["counters"], s["gauges"]
    snap = env.metrics.snapshot()
    run.update(
        launches=launches, source=type(pipe._source).__name__,
        message_bytes=sum(map(len, vals)) / n,
        kafka_fetch_p50_s=snap.get("kafka_fetch_s_p50"),
        kafka_fetch_p99_s=snap.get("kafka_fetch_s_p99"),
        prefetch={
            "batches": int(cs.get("prefetch_batches", 0)),
            "records": int(cs.get("prefetch_records", 0)),
            "depth_max": gs.get("prefetch_depth", {}).get("max", 0.0),
            "stall_ms": 1000 * cs.get("prefetch_stall_s", 0.0),
            "block_ms": 1000 * cs.get("prefetch_block_s", 0.0),
        },
        check_rows=sample,
        max_abs_err=check_values(items[:sample], ref[:sample],
                                 "Kafka record head"))
    if run["source"] != "PrefetchedRecordSource":
        raise RuntimeError(f"the Kafka source ran as {run['source']}")
    return run


def record_verify(workdir: str) -> dict:
    """``ModelReader(path).load()`` on the card over the ModelVerification
    documents: each loads as embedded; each altered copy raises the CPU
    port's ``ModelVerificationException``."""
    from flink_jpmml_tpu_torch.api import ModelReader
    from flink_jpmml_tpu_torch.utils.exceptions import (
        ModelVerificationException,
    )

    out = {}
    for name, (good, bad) in verify_docs().items():
        paths = []
        for tag, xml in (("good", good), ("bad", bad)):
            paths.append(os.path.join(workdir, f"verify_{name}_{tag}.pmml"))
            with open(paths[-1], "w") as f:
                f.write(xml)
        cm = ModelReader(paths[0]).load()
        if cm.device.type != "cuda" or not cm.has_verification:
            raise RuntimeError(f"verify {name}: not loaded on the card")
        msgs = []
        for device in (None, "cpu"):
            try:
                ModelReader(paths[1]).load(device=device)
            except ModelVerificationException as e:
                msgs.append(str(e))
        if len(msgs) != 2 or msgs[0] != msgs[1]:
            raise RuntimeError(f"verify {name} (altered): {msgs}")
        out[name] = msgs[0].split(": ", 1)[1]
    return {"documents": len(out), "refused": out}


def record_api(workdir: str, counter, q_cpu, vq_cpu) -> dict:
    """The phase: the GBM through ``evaluate``, ``quick_evaluate`` and dict
    records; the dynamic join; the Kafka record stream; the verify gate."""
    from flink_jpmml_tpu_torch.api import ModelReader
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm

    n_vec, n_dict, n_ev, n_kafka = (
        RECORD_VECTORS, RECORD_DICTS, RECORD_EVENTS, RECORD_KAFKA)
    t_phase = time.perf_counter()
    gbm = os.path.join(workdir, "gbm_500.pmml")
    votes = os.path.join(workdir, "votes_500.pmml")
    gbm2 = gen_gbm(workdir, n_trees=500, seed=12, name="gbm_v2_500.pmml")
    F = len(q_cpu.wire.fields)
    X = features(np.random.default_rng(0), max(n_vec, n_ev, n_dict, n_kafka),
                 F)
    sample = min(4096, n_dict, n_kafka)
    ref = wire_rows(q_cpu, X[:sample])
    refs = {"gbm_cpu": ref, "votes_cpu": wire_rows(vq_cpu, X[:sample]),
            "labels": vq_cpu.labels}
    reader = ModelReader(gbm)
    out = {
        "static": record_static(reader, list(X[:n_vec]), ref, counter,
                                sample=sample),
        "quick": record_static(reader, list(X[:n_vec]), ref, counter,
                               quick=True, sample=sample),
        "dicts": record_static(
            reader, dict_rows(X[:n_dict], q_cpu.wire.fields), ref, counter,
            sample=sample),
        "dynamic": record_dynamic(gbm, gbm2, votes, X[:n_ev], counter, refs,
                                  sample=sample),
        "kafka": record_kafka(gbm, X[:n_kafka], q_cpu.wire.fields, counter,
                              ref, sample=sample),
        "verify": record_verify(workdir),
    }
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- recovery (phase 21) -------------------------------------------------------

RECOVERY_RECORDS = 4 * DISPATCH  # the checkpoint, poison and dynamic parts
POISON_OFFSETS = (12_345, 400_000, 1_000_000)
SCORER_EVENTS = 4 * BATCH  # events through the DynamicScorer
ENGINE_EVENTS = (2 * BATCH, BATCH)  # the checkpointed run, then the restore

# the sticky-error child: a BlockPipeline (checkpoints armed, so the ladder
# is too) scores one block, then a device-side assert (an out-of-range
# index on the card) kills the CUDA context; the next dispatch must
# classify as chip_loss and escalate with a raise, making no retry
CHILD_STICKY = r"""
import json, os, sys, tempfile
import numpy as np
import torch
from flink_jpmml_tpu_torch.api import ModelReader
from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.runtime import devfault
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

path, batch = sys.argv[1], int(sys.argv[2])
cm = ModelReader(path).load(batch_size=batch)
F = cm.field_space.arity
X = np.random.default_rng(0).normal(0, 1.5, (4 * batch, F)).astype(np.float32)
state = {}
holder = {}

class Tripping(FiniteBlockSource):
    def poll(self):
        if self._pos == batch and "trip" not in state:
            t0 = __import__("time").monotonic()
            while holder["pipe"].committed_offset < batch:
                if __import__("time").monotonic() - t0 > 60:
                    break
                __import__("time").sleep(0.001)
            state["committed_before"] = holder["pipe"].committed_offset
            try:
                t = torch.zeros(2, device="cuda")
                t[torch.tensor([7], device="cuda")]
                torch.cuda.synchronize()
                state["trip"] = None
            except Exception as e:
                state["trip"] = devfault.classify(e)
                state["trip_error"] = repr(e)[:200]
        return super().poll()

pipe = holder["pipe"] = BlockPipeline(
    Tripping(X, batch), cm, lambda out, n, off: None,
    RuntimeConfig(batch=BatchConfig(size=batch, deadline_us=5000)),
    checkpoint=CheckpointManager(tempfile.mkdtemp()))
qtrees_cuda.leaf_rows.launches = 0
err = None
try:
    pipe.run_until_exhausted(timeout=120)
except BaseException as e:
    err = e
snap = pipe.metrics.snapshot()
print(json.dumps({
    "trip_kind": state.get("trip"), "trip_error": state.get("trip_error"),
    "committed_before_trip": state.get("committed_before"),
    "escalated": err is not None,
    "error_kind": None if err is None else devfault.classify(err),
    "error": None if err is None else repr(err)[:200],
    "committed_offset": pipe.committed_offset,
    "launches": qtrees_cuda.leaf_rows.launches,
    "dispatches": snap.get("dispatches", 0),
    "redispatches": snap.get("redispatches", 0),
    "redispatch_records": snap.get("redispatch_records", 0),
    "chip_loss_faults": snap.get('device_fault_total{kind="chip_loss"}', 0),
}), flush=True)
os._exit(0)
"""


def recovery_config(interval_s: float = 30.0):
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    return RuntimeConfig(
        batch=BatchConfig(size=BATCH, deadline_us=5000,
                          queue_capacity=4 * DISPATCH),
        checkpoint_interval_s=interval_s,
    )


class HeldSink:
    """A block sink that holds each delivery to the card's direct run of
    the same records (``refs``: model key → f32[N], or the vote forest's
    (value, shares, label) arrays) at the bar, labels equal, and counts
    how often each offset arrived; a mismatch raises on the score thread,
    so the pipeline fails."""

    def __init__(self, refs: dict, n: int, label: str, key: str = "static"):
        self.refs = refs
        self.seen = np.zeros(n, np.int32)
        self.key = key
        self.label = label
        self.calls = []  # (first offset, n, model key) per delivery
        self.max_abs_err = 0.0
        self.hooks = {}  # delivery index → callable run after it

    def __call__(self, out, n, first, decode=None):
        key = getattr(decode, "model_key", self.key)
        ref = self.refs[key]
        sl = slice(first, first + n)
        if isinstance(ref, tuple):
            v, p, lab = (np.asarray(o)[:n] for o in out)
            ok = (np.allclose(v, ref[0][sl], rtol=RTOL, atol=ATOL)
                  and np.allclose(p, ref[1][sl], rtol=RTOL, atol=ATOL)
                  and np.array_equal(lab, ref[2][sl]))
            err = float(np.abs(p - ref[1][sl]).max())
        else:
            v = np.asarray(out)[:n]
            ok = np.allclose(v, ref[sl], rtol=RTOL, atol=ATOL)
            err = float(np.abs(v - ref[sl]).max())
        if not ok or v.shape[0] != n:
            raise RuntimeError(f"{self.label}: records {first}..{first + n} "
                               f"of {key} differ from the card's direct run")
        self.max_abs_err = max(self.max_abs_err, err)
        self.seen[sl] += 1
        self.calls.append((first, n, key))
        hook = self.hooks.pop(len(self.calls), None)
        if hook is not None:
            hook()


def direct_rows(q, X: np.ndarray):
    """The card's direct run of ``X`` through ``q`` (host encode, one
    launch per DISPATCH records) as host arrays."""
    parts = [wire_rows(q, X[i:i + DISPATCH])
             for i in range(0, X.shape[0], DISPATCH)]
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate([p[j] for p in parts])
                     for j in range(len(parts[0])))
    return np.concatenate(parts)


def held_launches(counter, snap: dict, label: str, warms: int = 0,
                  windowed: bool = False) -> dict:
    """The kernel's count against what the pipeline counted: the window's
    dispatches, the ladder's and the suspect scan's redispatches, and the
    registry's warms (one launch each). ``windowed``: the redispatches
    went through the window, so ``dispatches`` holds them already (the
    dynamic scorer's)."""
    launches = counter.launches
    dispatches = int(snap.get("dispatches", 0))
    redispatches = int(snap.get("redispatches", 0))
    if launches != dispatches + (0 if windowed else redispatches) + warms:
        raise RuntimeError(f"{label}: {launches} launches for {dispatches} "
                           f"dispatches + {redispatches} redispatches + "
                           f"{warms} warms")
    return {"launches": launches, "dispatches": dispatches,
            "redispatches": redispatches, "warm_launches": warms,
            "launches_by_classes": dict(counter.launches_by_classes)}


def reset(counter) -> None:
    counter.launches = 0
    counter.launches_by_classes = {}


def ladder_counts(snap: dict) -> dict:
    return {
        "device_fault_total": {
            k: snap.get(f'device_fault_total{{kind="{k}"}}', 0)
            for k in ("device_error", "device_oom", "chip_loss")},
        "redispatch_records": snap.get("redispatch_records", 0),
        "oom_shrinks": snap.get("oom_shrinks", 0),
        "fallback_records": snap.get("fallback_records", 0),
    }


def recovery_checkpoint(cm, X, direct, counter, workdir) -> dict:
    """A checkpointed BlockPipeline stopped after two committed snapshots
    (later snapshots skipped, as if the worker died there), then a fresh
    pipeline that ``restore()``s and runs to the end."""
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    n = X.shape[0]
    ck = tempfile.mkdtemp(dir=workdir)
    mgr = CheckpointManager(ck)
    real_save = mgr.save
    saves = []
    holder = {}

    def save(state, probe=False):
        if len(saves) >= 2:
            return None  # the worker "died" after its second snapshot
        path = real_save(state, probe)
        saves.append(int(state["source_offset"]))
        if len(saves) == 2:
            holder["pipe"].stop()
        return path

    mgr.save = save
    sink = HeldSink({"static": direct}, n, "recovery checkpoint")
    # dispatches of 65,536 records, so the run spans 16 of them
    kw = dict(max_dispatch_chunks=4)
    reset(counter)
    t0 = time.perf_counter()
    pipe = holder["pipe"] = BlockPipeline(
        FiniteBlockSource(X, BATCH), cm, sink, recovery_config(0.0),
        checkpoint=mgr, **kw)
    pipe.start()
    try:
        wait_for(lambda: len(saves) >= 2 or pipe.error is not None,
                 "two checkpoints")
    finally:
        pipe.stop()
        pipe.join(timeout=60)
    first = held_launches(counter, pipe.metrics.snapshot(), "first run")
    sunk_before = int(sink.seen.sum())
    if len(saves) != 2:
        raise RuntimeError(f"{len(saves)} checkpoints committed, not 2")
    reset(counter)
    pipe2 = BlockPipeline(FiniteBlockSource(X, BATCH), cm, sink,
                          recovery_config(0.0),
                          checkpoint=CheckpointManager(ck), **kw)
    if not pipe2.restore() or pipe2.committed_offset != saves[1]:
        raise RuntimeError(f"restore resumed at {pipe2.committed_offset}, "
                           f"the second checkpoint holds {saves[1]}")
    pipe2.run_until_exhausted(timeout=300)
    dt = time.perf_counter() - t0
    second = held_launches(counter, pipe2.metrics.snapshot(), "restored run")
    dup = np.flatnonzero(sink.seen > 1)
    if (sink.seen < 1).any() or (sink.seen > 2).any():
        raise RuntimeError("an offset never reached the sink (or thrice)")
    if dup.size and dup.min() < saves[1]:
        raise RuntimeError(f"duplicate at {dup.min()} before the committed "
                           f"offset {saves[1]}")
    if pipe2.committed_offset != n:
        raise RuntimeError(f"restored run committed {pipe2.committed_offset}")
    return {"records": n, "seconds": dt, "checkpoints": saves,
            "sunk_before_stop": sunk_before, "duplicates": int(dup.size),
            "first_run": first, "restored_run": second,
            "launches": first["launches"] + second["launches"],
            "max_abs_err": sink.max_abs_err}


def recovery_poison(cm, X, direct, counter, workdir) -> dict:
    """Poison at three offsets through the ``score_batch`` site, with the
    checkpoints' DLQ beside them: the suspect scan bisects on the card."""
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    n = X.shape[0]
    sink = HeldSink({"static": direct}, n, "recovery poison")
    pipe = BlockPipeline(
        FiniteBlockSource(X, BATCH), cm, sink, recovery_config(1.0),
        checkpoint=CheckpointManager(tempfile.mkdtemp(dir=workdir)),
        max_dispatch_chunks=DISPATCH // BATCH)
    for off in POISON_OFFSETS:
        faults.inject("poison_record", offset=off)
    reset(counter)
    t0 = time.perf_counter()
    try:
        pipe.run_until_exhausted(timeout=300)
    finally:
        faults.clear()
    dt = time.perf_counter() - t0
    snap = pipe.metrics.snapshot()
    run = held_launches(counter, snap, "poison")
    dlq = sorted(int(e["offset"]) for e in pipe._dlq.scan())
    want = np.ones(n, np.int32)
    want[list(POISON_OFFSETS)] = 0
    if dlq != sorted(POISON_OFFSETS):
        raise RuntimeError(f"the DLQ holds {dlq}, not {POISON_OFFSETS}")
    if not np.array_equal(sink.seen, want):
        raise RuntimeError("poison part: a clean record missed the sink, or "
                           "a poisoned one reached it")
    if run["redispatches"] == 0:
        raise RuntimeError("the suspect scan launched nothing on the card")
    return {"records": n, "seconds": dt, "dlq_offsets": dlq,
            "quarantined": len(dlq), **run, **ladder_counts(snap),
            "max_abs_err": sink.max_abs_err}


def recovery_device_fault(cm, X, direct, counter, workdir) -> dict:
    """``InjectedDeviceError`` on two dispatches and ``InjectedDeviceOOM``
    on one (twice: the dispatch and its first full redispatch, so the
    ladder halves), each armed from the sink between dispatches."""
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    n = X.shape[0]
    sink = HeldSink({"static": direct}, n, "recovery device_fault")
    sink.hooks = {
        1: lambda: faults.inject("device_error", n=1),
        3: lambda: faults.inject("device_error", n=1),
        5: lambda: faults.inject("device_oom", n=2),
    }
    pipe = BlockPipeline(
        FiniteBlockSource(X, BATCH), cm, sink, recovery_config(1.0),
        checkpoint=CheckpointManager(tempfile.mkdtemp(dir=workdir)),
        max_dispatch_chunks=DISPATCH // BATCH)
    reset(counter)
    t0 = time.perf_counter()
    try:
        pipe.run_until_exhausted(timeout=300)
        fired = faults.stats()
    finally:
        faults.clear()
    dt = time.perf_counter() - t0
    snap = pipe.metrics.snapshot()
    run = held_launches(counter, snap, "device_fault")
    lad = ladder_counts(snap)
    if fired != {"device_error": 2, "device_oom": 2}:
        raise RuntimeError(f"faults fired {fired}")
    if (lad["device_fault_total"] != {"device_error": 2, "device_oom": 2,
                                      "chip_loss": 0}
            or lad["oom_shrinks"] != 1 or lad["fallback_records"] != 0
            or run["redispatches"] != 5):
        raise RuntimeError(f"the ladder ran {lad}, {run}")
    if not (sink.seen == 1).all() or list(pipe._dlq.scan()):
        raise RuntimeError("device faults lost, repeated or quarantined "
                           "records")
    return {"records": n, "seconds": dt, **run, **lad,
            "max_abs_err": sink.max_abs_err}


def recovery_real_oom(q, X, direct) -> dict:
    """A real ``torch.cuda.OutOfMemoryError``: asking for more than the
    card holds classifies as ``device_oom``, and the card scores after."""
    import torch

    from flink_jpmml_tpu_torch.runtime import devfault

    try:
        torch.empty((1 << 46,), dtype=torch.uint8, device="cuda")
    except torch.cuda.OutOfMemoryError as e:
        kind = devfault.classify(e)
    else:
        raise RuntimeError("a 64 TiB allocation succeeded")
    if kind != devfault.KIND_OOM:
        raise RuntimeError(f"a real OOM classified as {kind}")
    torch.cuda.empty_cache()
    after = wire_rows(q, X[:BATCH])
    if not np.allclose(after, direct[:BATCH], rtol=RTOL, atol=ATOL):
        raise RuntimeError("the card scores differently after the OOM")
    return {"kind": kind, "scores_after": True,
            "max_abs_err": float(np.abs(after - direct[:BATCH]).max())}


def sticky_child(path: str):
    """Start the sticky-error child (``CHILD_STICKY``) on ``path``."""
    return subprocess.Popen(
        [sys.executable, "-c", CHILD_STICKY, path, str(BATCH)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def sticky_result(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if not lines:
        raise RuntimeError(f"the sticky-error child printed no result "
                           f"(rc {proc.returncode}): {err[-2000:]}")
    res = json.loads(lines[-1])
    if (res["trip_kind"] != "chip_loss" or res["error_kind"] != "chip_loss"
            or not res["escalated"] or res["redispatches"]
            or res["redispatch_records"] or res["chip_loss_faults"] != 1
            or res["launches"] != res["dispatches"]
            or res["committed_before_trip"] != BATCH):
        raise RuntimeError(f"the sticky-error child: {res}")
    return res


class MarkedBlocks:
    """A finite block source whose ``marks`` — ``(offset, action)`` in
    offset order — run on the ingest thread before the block from that
    offset on is handed out."""

    def __init__(self, data: np.ndarray, block: int, marks: list):
        from flink_jpmml_tpu_torch.runtime.block import FiniteBlockSource

        self._src = FiniteBlockSource(data, block)
        self._marks = list(marks)

    def poll(self):
        if self._marks and self._src._pos >= self._marks[0][0]:
            self._marks.pop(0)[1]()
        return self._src.poll()

    def seek(self, offset: int) -> None:
        self._src.seek(offset)

    @property
    def exhausted(self) -> bool:
        return self._src.exhausted and not self._marks


def recovery_dynamic_block(gbm, gbm2, X, refs, counter, workdir) -> dict:
    """``DynamicBlockPipeline`` serving the GBM: Add v1, Add v2 once a
    quarter of the records is in, Del v1 once v2 is warm; checkpointed,
    then a fresh pipeline restores and serves v2 on more records."""
    from flink_jpmml_tpu_torch.models.control import AddMessage, DelMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime.block import FiniteBlockSource
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.block import DynamicBlockPipeline

    n = X.shape[0]
    extra = features(np.random.default_rng(17), DISPATCH // 4, X.shape[1])
    ext = np.concatenate([X, extra])
    refs = dict(refs)
    refs["gbm_2"] = np.concatenate([refs["gbm_2"], refs["gbm_2_extra"]])
    ck = tempfile.mkdtemp(dir=workdir)
    ctrl = ControlSource()
    holder = {}

    # each mark waits for the records before it to be sunk, so the
    # messages land between two stretches of the scored stream
    def add_v2():
        wait_for(lambda: holder["pipe"].committed_offset >= n // 4,
                 "the first quarter")
        ctrl.push(AddMessage("gbm", 2, gbm2, 2.0))

    def del_v1():
        wait_for(lambda: holder["pipe"].committed_offset >= n // 2
                 and holder["pipe"].registry.model_if_warm(
                     ModelId("gbm", 2)) is not None, "gbm v2's warm")
        ctrl.push(DelMessage("gbm", 1, 3.0))

    marks = [(n // 4, add_v2), (n // 2, del_v1)]
    sink = HeldSink(refs, ext.shape[0], "dynamic block gbm")
    ctrl.push(AddMessage("gbm", 1, gbm, 1.0))
    pipe = holder["pipe"] = DynamicBlockPipeline(
        MarkedBlocks(X, BATCH, marks), ctrl, sink, "gbm", X.shape[1], BATCH,
        recovery_config(1.0), checkpoint=CheckpointManager(ck),
        max_dispatch_chunks=DISPATCH // BATCH)
    cold = pipe.metrics.histogram("cold_start_s")
    reset(counter)
    t0 = time.perf_counter()
    pipe.run_until_exhausted(timeout=300)
    run = held_launches(counter, pipe.metrics.snapshot(), "dynamic gbm",
                        warms=cold.count())
    keys = [k for _, _, k in sink.calls]
    swap = keys.index("gbm_2") if "gbm_2" in keys else len(keys)
    if (set(keys[:swap]) != {"gbm_1"} or set(keys[swap:]) != {"gbm_2"}
            or sink.calls[swap][0] < n // 4):
        raise RuntimeError(f"the v1 → v2 swap broke: {keys}")
    if not (sink.seen[:n] == 1).all() or pipe.serving_key != "gbm_2":
        raise RuntimeError("dynamic gbm: records lost or repeated, or v2 "
                           "not serving")
    # a fresh pipeline, no control messages: the checkpoint serves v2
    reset(counter)
    pipe2 = DynamicBlockPipeline(
        FiniteBlockSource(ext, BATCH), ControlSource(), sink, "gbm",
        X.shape[1], BATCH, recovery_config(1.0),
        checkpoint=CheckpointManager(ck),
        max_dispatch_chunks=DISPATCH // BATCH)
    cold2 = pipe2.metrics.histogram("cold_start_s")
    if not pipe2.restore() or pipe2.committed_offset != n:
        raise RuntimeError(f"dynamic restore resumed at "
                           f"{pipe2.committed_offset}, not {n}")
    if set(pipe2.registry.state()["served"]) != {"gbm_2"}:
        raise RuntimeError(f"restored registry {pipe2.registry.state()}")
    pipe2.run_until_exhausted(timeout=300)
    dt = time.perf_counter() - t0
    restored = held_launches(counter, pipe2.metrics.snapshot(),
                             "dynamic restore", warms=cold2.count())
    if not (sink.seen == 1).all() or pipe2.serving_key != "gbm_2":
        raise RuntimeError("the restored pipeline did not serve v2 on the "
                           "rest")
    return {"records": int(ext.shape[0]), "seconds": dt,
            "swap_offset": sink.calls[swap][0], "add_v2_offset": n // 4,
            "del_v1_offset": n // 2, "run": run, "restored_run": restored,
            "restored_serving_key": pipe2.serving_key,
            "launches": run["launches"] + restored["launches"],
            "max_abs_err": sink.max_abs_err}


def recovery_dynamic_votes(votes, X, vref, counter) -> dict:
    """A second ``DynamicBlockPipeline``, serving the 3-class vote
    forest."""
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.runtime.block import FiniteBlockSource
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.block import DynamicBlockPipeline

    n = X.shape[0]
    ctrl = ControlSource()
    ctrl.push(AddMessage("votes", 1, votes, 1.0))
    sink = HeldSink({"votes_1": vref}, n, "dynamic block votes")
    pipe = DynamicBlockPipeline(
        FiniteBlockSource(X, BATCH), ctrl, sink, "votes", X.shape[1], BATCH,
        recovery_config(), max_dispatch_chunks=DISPATCH // BATCH)
    cold = pipe.metrics.histogram("cold_start_s")
    reset(counter)
    t0 = time.perf_counter()
    pipe.run_until_exhausted(timeout=300)
    dt = time.perf_counter() - t0
    run = held_launches(counter, pipe.metrics.snapshot(), "dynamic votes",
                        warms=cold.count())
    if not (sink.seen == 1).all() or pipe.backend != "rank_wire_cuda":
        raise RuntimeError(f"dynamic votes: records lost or repeated "
                           f"({pipe.backend})")
    if set(run["launches_by_classes"]) != {3}:
        raise RuntimeError(f"vote launches {run['launches_by_classes']}")
    return {"records": n, "seconds": dt, **run,
            "max_abs_err": sink.max_abs_err}


def recovery_scorer(gbm, X, direct, counter) -> dict:
    """A ``DynamicScorer`` with default arguments (``device_retry`` unset)
    and one injected device error on a group's readback: the group is
    re-dispatched and every event scored."""
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    n = X.shape[0]
    ctrl = ControlSource()
    sc = DynamicScorer(control=ctrl, batch_size=BATCH)
    ctrl.push(AddMessage("gbm", 1, gbm, 1.0))
    sc.finish(sc.submit([]))  # applies the Add; its warm runs on the pool
    wait_for(lambda: sc.registry.model_if_warm(ModelId("gbm", 1))
             is not None, "gbm v1's warm")
    cold = sc.metrics.histogram("cold_start_s")
    cold0 = cold.count()
    reset(counter)
    preds = []
    t0 = time.perf_counter()
    try:
        for i in range(0, n, BATCH):
            if i == BATCH:
                faults.inject("device_error", n=1)
            preds += sc.finish(sc.submit(
                [("gbm", X[j]) for j in range(i, min(i + BATCH, n))]))
        fired = faults.stats()
    finally:
        faults.clear()
    dt = time.perf_counter() - t0
    snap = sc.metrics.snapshot()
    run = held_launches(counter, snap, "dynamic scorer",
                        warms=cold.count() - cold0, windowed=True)
    err = check_values([p for p, _ in preds], direct, "dynamic scorer")
    if (fired != {"device_error": 1} or run["redispatches"] != 1
            or snap.get("redispatch_records") != BATCH):
        raise RuntimeError(f"the scorer's group redispatch: {fired}, {run}, "
                           f"{ladder_counts(snap)}")
    return {"events": n, "seconds": dt, **run, **ladder_counts(snap),
            "max_abs_err": err}


def recovery_engine(gbm, X, direct, counter, workdir) -> dict:
    """The record engine: ``evaluate(...).with_checkpointing(dir)`` over a
    control stream, run with ``execute(restore=True)`` (nothing to resume
    yet); then a fresh environment over the same events and more,
    ``execute(restore=True)`` again — it resumes at the checkpoint with
    the checkpointed registry and scores only the rest."""
    from flink_jpmml_tpu_torch.api import ModelReader, StreamEnvironment
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource

    n1, n2 = ENGINE_EVENTS
    events = [("gbm", X[i]) for i in range(n1 + n2)]
    ck = tempfile.mkdtemp(dir=workdir)
    out = {}
    t0 = time.perf_counter()
    for label, evs, want in (("first", events[:n1], range(n1)),
                             ("restored", events, range(n1, n1 + n2))):
        env = StreamEnvironment(recovery_config())
        ctrl = ControlSource()
        if label == "first":
            ctrl.push(AddMessage("gbm", 1, gbm, 1.0))
        sink = (env.from_collection(evs).with_control_stream(ctrl)
                .evaluate(ModelReader(gbm)).with_checkpointing(ck)
                .collect())
        cold = env.metrics.histogram("cold_start_s")
        reset(counter)
        env.execute(timeout=300.0, restore=True)
        run = held_launches(counter, env.metrics.snapshot(),
                            f"engine {label}", warms=cold.count())
        items = sink.items
        if len(items) != len(want) or any(
                r is not events[i] for (_, r), i in zip(items, want)):
            raise RuntimeError(f"engine {label}: {len(items)} events sunk, "
                               f"expected {len(want)} from {want.start}")
        idx = np.asarray(want)
        err = check_values([p for p, _ in items], direct[idx],
                           f"engine {label}")
        out[label] = {"events": len(items), **run, "max_abs_err": err}
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = out["first"]["launches"] + out["restored"]["launches"]
    out["max_abs_err"] = max(out["first"]["max_abs_err"],
                             out["restored"]["max_abs_err"])
    return out


def recovery_cost(cm, X, counter, workdir) -> list:
    """The fused GBM's BlockPipeline over the same 16 dispatches of
    262,144 with and without checkpoints + DLQ armed (armed: a copy of
    each batch retained past its dispatch, a snapshot every second),
    twice in the order plain, armed, armed, plain."""
    from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource

    runs = []
    for armed in (False, True, True, False) * 2:
        count = [0]

        def sink(out, n, first_off, count=count):
            count[0] += n

        r = drive(cm, CyclingBlockSource(X, block_size=DISPATCH), sink,
                  count, counter,
                  checkpoint_dir=(tempfile.mkdtemp(dir=workdir)
                                  if armed else None))
        runs.append({k: r[k] for k in (
            "checkpointed", "records", "seconds", "records_per_s",
            "dispatches", "launches", "encode_mode",
            "batch_latency_p50_s", "batch_latency_p99_s")})
    return runs


def recovery(workdir: str, counter, q, vq, cm, smi: str) -> dict:
    """The phase: checkpoint, poison, device_fault, real_errors, dynamic
    and cost, at the main path's width (the 500-tree GBM, the 3-class
    vote forest), each part's outputs held to the card's direct run."""
    from flink_jpmml_tpu_torch.api import ModelReader
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm

    t_phase = time.perf_counter()
    gbm = os.path.join(workdir, "gbm_500.pmml")
    votes = os.path.join(workdir, "votes_500.pmml")
    gbm2 = os.path.join(workdir, "gbm_v2_500.pmml")
    if not os.path.exists(gbm2):
        gen_gbm(workdir, n_trees=500, seed=12, name="gbm_v2_500.pmml")
    # the child runs beside the untimed parts and is joined before the
    # timed one
    child = sticky_child(os.path.join(workdir, "gbm_19.pmml"))
    try:
        F = len(q.wire.fields)
        X = features(np.random.default_rng(13), RECOVERY_RECORDS, F)
        q2 = ModelReader(gbm2).load(batch_size=BATCH).quantized_scorer()
        direct = direct_rows(q, X)
        extra = features(np.random.default_rng(17), DISPATCH // 4, F)
        refs = {"gbm_1": direct, "gbm_2": direct_rows(q2, X),
                "gbm_2_extra": direct_rows(q2, extra)}
        vX = X[:DISPATCH]
        vref = direct_rows(vq, vX)
        parts = {
            "checkpoint": recovery_checkpoint(cm, X, direct, counter,
                                              workdir),
            "poison": recovery_poison(cm, X, direct, counter, workdir),
            "device_fault": recovery_device_fault(
                cm, np.concatenate([X, X]), np.concatenate([direct, direct]),
                counter, workdir),
            "real_errors": {"oom": recovery_real_oom(q, X, direct)},
            "dynamic": {
                "block_gbm": recovery_dynamic_block(gbm, gbm2, X, refs,
                                                    counter, workdir),
                "block_votes": recovery_dynamic_votes(votes, vX, vref,
                                                      counter),
                "scorer": recovery_scorer(gbm, X[:SCORER_EVENTS],
                                          direct[:SCORER_EVENTS], counter),
                "engine": recovery_engine(gbm, X, direct, counter, workdir),
            },
        }
        parts["real_errors"]["sticky_child"] = sticky_result(child)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    parts["cost"] = recovery_cost(cm, X, counter, workdir)
    plain = [r["records_per_s"] for r in parts["cost"] if not r["checkpointed"]]
    armed = [r["records_per_s"] for r in parts["cost"] if r["checkpointed"]]
    parts["cost_summary"] = {
        "plain_records_per_s": plain, "armed_records_per_s": armed,
        "fraction_lost": 1.0 - statistics.mean(armed) / statistics.mean(plain),
    }
    c1 = sum(p["launches"] for p in (
        parts["checkpoint"], parts["poison"], parts["device_fault"],
        parts["dynamic"]["block_gbm"], parts["dynamic"]["scorer"],
        parts["dynamic"]["engine"])) + sum(
        r["launches"] for r in parts["cost"])
    return {"nvidia_smi": smi, "seconds": time.perf_counter() - t_phase,
            "parts": parts, "launches_c1": c1,
            "launches_c3": parts["dynamic"]["block_votes"]["launches"],
            "recovery_launches": (
                parts["poison"]["redispatches"]
                + parts["device_fault"]["redispatches"]
                + parts["dynamic"]["scorer"]["redispatches"]),
            "max_abs_err": max(
                parts["checkpoint"]["max_abs_err"],
                parts["poison"]["max_abs_err"],
                parts["device_fault"]["max_abs_err"],
                parts["dynamic"]["block_gbm"]["max_abs_err"],
                parts["dynamic"]["scorer"]["max_abs_err"],
                parts["dynamic"]["engine"]["max_abs_err"])}


EDGE_RECORDS = 4 * DISPATCH  # the oom_cap, spans and TCP parts
EDGE_BLOCK = 8 * BATCH  # the overload drill's paced block: one dispatch
EDGE_POOL = 2 * EDGE_BLOCK  # the overload drill's cycling pool
# seconds a paced phase of the drill lasts (the JAX drill's 2.5 s): its
# p99 is over one sample a block, ~60 blocks a second at 80%, so a
# longer phase keeps one host hiccup from being the p99
EDGE_PHASE_S = 5.0
EDGE_SCORER_BATCHES = 3  # micro-batches of BATCH events through the scorer
EDGE_POISON = 300_000  # the journey part's poisoned offset K
EDGE_KAFKA_ROWS = 2 * DISPATCH


def edge_overload(cm, q, counter, workdir) -> dict:
    """The overload drill of the JAX package's ``bench.run_overload_drill``
    on the card, with its four checks: capacity measured unpaced over a
    window as long as a paced phase, and the batcher fitted; a paced
    source at 80% of it (p99 ≤ deadline); 150%
    (``shed_records{lane="block"}`` > 0, p99 bounded by 10 × max(deadline,
    base p99)); back at 80% (p99 < max(1.05 × base, base + 10 ms)). The
    deadline is the drill's rule: 5 × the predicted single-batch latency,
    clamped to [100 ms, 2 s]. Every delivery is held to the card's direct
    run in the sink as it arrives (no copy is kept), the sink's ranges and
    the shed records must tile the committed offsets exactly, and the
    kernel's launches must equal the accounted dispatches (a shed batch
    launches nothing). Each measured phase starts from steady state
    (``drained``). Each phase's readings include the mean ms of the host
    stages and of a dispatch, the process's CPU seconds a wall second and
    its full garbage collections. A failed check raises with the drill's
    readings."""
    import collections
    import gc

    import torch

    from flink_jpmml_tpu_torch.obs import attr
    from flink_jpmml_tpu_torch.obs.slo import SLOTracker
    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, BlockSource
    from flink_jpmml_tpu_torch.serving import overload
    from flink_jpmml_tpu_torch.utils import cache
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry, _nearest_rank

    F = len(q.wire.fields)
    pool = features(np.random.default_rng(31), EDGE_POOL, F)
    direct = direct_rows(q, pool)
    km = MetricsRegistry()
    # the batcher's default path: the port's cache, keyed by the card
    # (under this run's scratch HOME, removed with it)
    home = os.environ.get("HOME")
    os.environ["HOME"] = workdir
    try:
        batcher = overload.AdaptiveBatcher(
            metrics=km, min_records=BATCH, max_records=8 * BATCH,
            model="gbm_500", backend="rank_wire_cuda")
        cap_path = overload.capacity_model_path()
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
    batcher.deadline_s = None  # capacity is measured uncapped
    admission = overload.AdmissionController(
        km, lanes=("block",), interval_s=0.1, dwell_s=0.4,
        on_threshold=0.7, off_threshold=0.35)
    admission.enabled = False  # the capacity phase measures, not sheds
    arrivals = collections.deque()  # (offset, arrival time) a block
    cur_lats = [None]
    rate_now = [None]  # None: unpaced
    sunk = []  # (first offset, records) a delivery
    n_sunk = [0]
    max_err = [0.0]

    class Paced(BlockSource):
        def __init__(self):
            self._pos = 0
            self._off = 0
            self._next = None

        def poll(self):
            now = time.monotonic()
            rate = rate_now[0]
            if rate is not None:
                if self._next is None:
                    self._next = now
                if now < self._next:
                    # sleep to the block's time (at most 5 ms, so a rate
                    # change is seen) instead of waking the ingest thread
                    # every half millisecond to take the GIL for nothing
                    time.sleep(min(self._next - now, 0.005))
                    return None
            blk = pool[self._pos:self._pos + EDGE_BLOCK]
            self._pos = (self._pos + EDGE_BLOCK) % EDGE_POOL
            off = self._off
            self._off += EDGE_BLOCK
            arrivals.append((off, time.monotonic()))
            if rate is not None:
                # a late block does not buy a burst: the JAX drill lets
                # 5 of its 64-record blocks catch up, which is a sixth of
                # its ring; 5 of these would overfill this ring, so at
                # most one block catches up
                interval = EDGE_BLOCK / rate
                self._next = max(self._next + interval, now - interval)
            return off, blk

    def ref_rows(first, n):
        """The direct run's values of offsets [first, first + n): slices
        of the cycled pool (a delivery is at most half of it, so it wraps
        at most once)."""
        i = first % EDGE_POOL
        if i + n <= EDGE_POOL:
            return direct[i:i + n]
        return np.concatenate([direct[i:], direct[:i + n - EDGE_POOL]])

    def sink(out, n, first_off):
        t = time.monotonic()
        # held to the card's direct run here, in place: a kept copy of
        # each delivery would cost the score thread page faults and a
        # copy a dispatch and grow the process all drill
        v = np.asarray(out)[:n]
        ref = ref_rows(first_off, n)
        if v.shape != ref.shape or not np.array_equal(v, ref):
            if v.shape != ref.shape or not np.allclose(v, ref, rtol=RTOL,
                                                       atol=ATOL):
                raise RuntimeError(f"overload: records {first_off}.."
                                   f"{first_off + n} differ from the "
                                   "card's direct run")
            max_err[0] = max(max_err[0], float(np.abs(v - ref).max()))
        sunk.append((first_off, n))
        n_sunk[0] += n
        while arrivals and arrivals[0][0] < first_off:
            arrivals.popleft()  # shed: no latency sample
        lats = cur_lats[0]
        while arrivals and arrivals[0][0] + EDGE_BLOCK <= first_off + n:
            _, t_arr = arrivals.popleft()
            if lats is not None:
                lats.append(t - t_arr)

    # blocks of 8 batches, a full aggregated dispatch each: on the card a
    # dispatch's fixed host cost is a large share of a single batch's, so
    # single-batch blocks at 80% of the (aggregated) capacity would load
    # the pipeline near 100%. The ring holds 8 blocks, so the
    # on-threshold (70% full) is ~5 blocks of queueing, near the deadline
    # at the base rate: a host stall of a block or two is not read as
    # saturation, a sustained backlog is
    pipe = BlockPipeline(
        Paced(), cm, sink,
        RuntimeConfig(batch=BatchConfig(size=BATCH, deadline_us=2000,
                                        queue_capacity=8 * EDGE_BLOCK)),
        metrics=km, in_flight=1, max_dispatch_chunks=8,
        batcher=batcher, admission=admission)
    if pipe.backend != "rank_wire_cuda" or q.encode_placement != "fused":
        raise RuntimeError(f"overload: {pipe.backend}, {q.encode_placement}")
    # the three suspects of a failed recovery check, read a phase: the
    # ring's push (its lock held over a block's copy) and drain, timed on
    # the host clock as each call returns; the host's other load (all
    # cores' busy time from /proc/stat less this process's); h2d staging
    # is the ledger's ``h2d`` stage in mean_ms
    ring_calls = {"push": [], "drain": []}

    def timed(kind, fn):
        calls = ring_calls[kind]

        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                now = time.perf_counter()
                calls.append((now, now - t))
        return call

    pipe._ring.push_block = timed("push", pipe._ring.push_block)
    pipe._ring.drain = timed("drain", pipe._ring.drain)
    clk = os.sysconf("SC_CLK_TCK")

    def host_cpu():
        """(busy core-seconds of the whole host, steal core-seconds)."""
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        steal = v[7] if len(v) > 7 else 0
        return (sum(v[:8]) - v[3] - v[4]) / clk, steal / clk

    def ring_ms(kind, t0, t1):
        d = sorted(1e3 * dt for t, dt in ring_calls[kind] if t0 <= t < t1)
        if not d:
            return {"n": 0}
        return {"n": len(d), "mean": sum(d) / len(d),
                "p99": d[min(len(d) - 1, int(0.99 * len(d)))],
                "max": d[-1], "sum": sum(d)}
    for k in (1, 2, 4, 8):  # every aggregation shape once, uncounted
        q.predict_fused(pool[:k * BATCH])
    torch.cuda.synchronize()
    samples = []
    phases = {}

    def sample(tag):
        samples.append({"t": time.monotonic(), "tag": tag, **{
            k: km.gauge(k).get() for k in (
                "pressure", "shed_level", "ring_occupancy",
                "adaptive_batch")}})

    stage_hists = {"batch": "batch_latency_s", **{
        st: attr.stage_metric_name(st) for st in (
            "encode", "h2d", "queue_wait", "readback", "sink")}}

    def counts():
        snap = km.snapshot()
        hists = km.struct_snapshot()["histograms"]
        busy, steal = host_cpu()
        return {"t": time.monotonic(), "pc": time.perf_counter(),
                "busy": busy, "steal": steal, "sunk": n_sunk[0],
                "dispatches": snap.get("dispatches", 0),
                "records": snap.get("batch_fill_records", 0),
                "shed": sum(admission.counts()["shed"].values()),
                "cpu": time.process_time(),
                "gc2": gc.get_stats()[2]["collections"],
                "hists": {k: (hists.get(h) or {}) for k, h in
                          stage_hists.items()}}

    def stage_ms(c0, c1):
        """Per phase, the mean ms of each host stage and of a dispatch's
        drain → sink (batch latency): where a phase's time went."""
        out = {}
        for k in stage_hists:
            a, b = c0["hists"][k], c1["hists"][k]
            n = b.get("n", 0) - a.get("n", 0)
            out[k] = (1e3 * (b.get("sum", 0.0) - a.get("sum", 0.0)) / n
                      if n else None)
        return out

    def run_phase(seconds, tag, lats=None):
        c0 = counts()
        cur_lats[0] = lats
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            if pipe.error is not None:
                raise RuntimeError(f"overload: {pipe.error!r}")
            sample(tag)
            time.sleep(0.1)
        cur_lats[0] = None
        c1 = counts()
        dt = c1["t"] - c0["t"]
        d = {k: c1[k] - c0[k] for k in ("sunk", "dispatches", "records",
                                         "shed")}
        phases[tag] = {
            "seconds": dt, "sunk_per_s": d["sunk"] / dt,
            "offered_per_s": (d["records"] + d["shed"]) / dt,
            "shed": d["shed"], "dispatches": d["dispatches"],
            "records_per_dispatch": d["records"] / max(1, d["dispatches"]),
            "p99_ms": None if not lats else 1e3 * p99(lats),
            "p50_ms": None if not lats else 1e3 * sorted(lats)[
                len(lats) // 2],
            "mean_ms": stage_ms(c0, c1),
            "cpu_per_wall": (c1["cpu"] - c0["cpu"]) / dt,
            "gc_gen2": c1["gc2"] - c0["gc2"],
            # cores busy on the whole host a wall second, and those not
            # this process's (other tenants of the host, the kernel)
            "host_busy_cores": (c1["busy"] - c0["busy"]) / dt,
            "host_other_cores": ((c1["busy"] - c0["busy"])
                                 - (c1["cpu"] - c0["cpu"])) / dt,
            "host_steal_cores": (c1["steal"] - c0["steal"]) / dt,
            "ring_push_ms": ring_ms("push", c0["pc"], c1["pc"]),
            "ring_drain_ms": ring_ms("drain", c0["pc"], c1["pc"])}

    def p99(lats):
        s = sorted(lats)
        return s[_nearest_rank(0.99, len(s))] if s else None

    drill = {"phases": phases}
    failed = []
    reset(counter)
    t_phase = time.perf_counter()
    pipe.start()
    try:
        run_phase(0.7, "capacity-ramp")
        # as long as a paced phase: the sustained rate the paced phases
        # are fractions of, not a short burst's
        run_phase(EDGE_PHASE_S, "capacity")
        capacity = phases["capacity"]["sunk_per_s"]
        if capacity <= 0:
            raise RuntimeError("overload: the capacity phase scored nothing")
        drill["capacity_records_per_s"] = capacity
        drill["coefficients"] = batcher.coefficients()
        pred = batcher.predicted_latency(BATCH)
        drill["predicted_batch_ms"] = None if pred is None else 1e3 * pred
        deadline_s = min(max(5.0 * (pred or 0.01), 0.1), 2.0)
        drill["deadline_ms"] = 1e3 * deadline_s
        batcher.deadline_s = deadline_s
        pipe._slo = SLOTracker(km, source="batch_latency_s",
                               deadline_s=deadline_s, windows=((5.0, 10.0),))
        admission.enabled = True

        def paced(frac, seconds, tag):
            rate_now[0] = frac * capacity
            lats = []
            run_phase(seconds, tag, lats)
            return lats

        steady_cap = [None]

        def drained(tag):
            """Settle at 80% until the previous phase is gone, as the JAX
            drill's ``wait_drained`` (at most 12 s): nothing queued in
            the ring (its "less than a block" is half a compile batch
            there: here less than one batch, so no part of a block is
            left and the next block goes out whole in one dispatch), the
            gate open, and the batcher's cap where it was before the
            surge."""
            rate_now[0] = 0.8 * capacity
            t_d = time.monotonic()
            settled = False
            while not settled and time.monotonic() - t_d < 12.0:
                sample(tag)
                settled = (len(pipe._ring) < BATCH
                           and not admission.shedding
                           and steady_cap[0] in (None,
                                                 batcher.max_records()))
                if not settled:
                    time.sleep(0.1)
            drill.setdefault("settled", {})[tag] = {
                "seconds": time.monotonic() - t_d, "settled": settled}

        drained("settle")
        base = paced(0.8, EDGE_PHASE_S, "base")
        for retry in (1, 2):
            if p99(base) is not None and p99(base) <= deadline_s:
                break
            base = paced(0.8, EDGE_PHASE_S, f"base-retry{retry}")
        p99_base = p99(base)
        drill["p99_base_ms"] = None if p99_base is None else 1e3 * p99_base
        if p99_base is None or p99_base > deadline_s:
            failed.append("p99 over the deadline at 80% of capacity")
            p99_base = p99_base or deadline_s
        shed0 = sum(admission.counts()["shed"].values())
        steady_cap[0] = batcher.max_records()
        surge = paced(1.5, EDGE_PHASE_S, "surge")
        shed = sum(admission.counts()["shed"].values()) - shed0
        p99_surge = p99(surge)
        bound = 10.0 * max(deadline_s, p99_base)
        drill.update(shed_records=int(shed), surge_all_shed=not surge,
                     p99_surge_ms=None if p99_surge is None
                     else 1e3 * p99_surge)
        if shed <= 0:
            failed.append("150% of capacity shed nothing")
        if surge and p99_surge > bound:
            failed.append(f"surge p99 not bounded by {bound}")
        drained("drain")
        allowed = max(1.05 * p99_base, p99_base + 0.010)
        rec = paced(0.8, EDGE_PHASE_S, "recovery")
        for retry in (1, 2):
            if p99(rec) is not None and p99(rec) < allowed:
                break
            rec = paced(0.8, EDGE_PHASE_S, f"recovery-retry{retry}")
        p99_rec = p99(rec)
        drill["p99_recovery_ms"] = None if p99_rec is None else 1e3 * p99_rec
        if p99_rec is None or p99_rec >= allowed:
            failed.append(f"p99 did not recover below {allowed}")
    finally:
        pipe.stop()
        pipe.join(timeout=60)
    dt = time.perf_counter() - t_phase
    if failed:
        raise RuntimeError(f"overload: {failed}: " + json.dumps(
            {**drill, "capacity_model": batcher.state(),
             "samples": samples[-60:]}, default=str))
    snap = pipe.metrics.snapshot()
    run = held_launches(counter, snap, "overload")
    counts_ = admission.counts()
    shed_total = int(sum(counts_["shed"].values()))
    # every delivery was held to the direct run in the sink; the sink's
    # ranges and the shed batches tile [0, committed) exactly: ranges
    # never overlap, and every gap is a shed batch's
    pos, gaps, err = 0, 0, max_err[0]
    for first, n in sunk:
        if first < pos:
            raise RuntimeError(f"overload: offset {first} sunk twice")
        gaps += first - pos
        pos = first + n
    committed = pipe.committed_offset
    gaps += committed - pos
    if gaps != shed_total or n_sunk[0] + shed_total != committed:
        raise RuntimeError(f"overload: sunk + shed != committed ({gaps} gap "
                           f"records, {shed_total} shed, {committed})")
    if int(snap.get("records_out", 0)) != n_sunk[0]:
        raise RuntimeError("overload: records_out != the sink's records")
    batcher.flush()
    surge_samples = [x for x in samples if x["tag"] == "surge"]
    return {
        "seconds": dt, **drill, "capacity_model": batcher.state(),
        "capacity_model_path": os.path.relpath(cap_path, workdir),
        "capacity_model_written": os.path.exists(cap_path),
        "device_tag": cache.device_tag(),
        "shed_total": shed_total, "admitted_records": int(
            counts_["admitted"]),
        "shed_share_surge": (phases["surge"]["shed"]
                             / max(1.0, phases["surge"]["offered_per_s"]
                                   * phases["surge"]["seconds"])),
        "surge_max_pressure": max(
            (x["pressure"] or 0.0) for x in surge_samples)
        if surge_samples else None,
        "adaptive_max_records": batcher.max_records(),
        "committed_offset": committed, "records_sunk": n_sunk[0],
        "slo": pipe._slo.health(),
        "summary": overload.summary(km.struct_snapshot()),
        **run, "max_abs_err": err,
    }


def edge_scorer(gbm, votes, q, vq, counter) -> dict:
    """A ``DynamicScorer(admission=, lane_fn=)`` serving the GBM and the
    vote forest with the "low" lane held shed: shed events come back
    empty, the rest equal the card's direct run, the kernel's launches
    equal the groups dispatched, and with ``FJT_SLO_TARGET_MS`` set the
    registry carries the SLO gauges."""
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.overload import AdmissionController
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    F = len(q.wire.fields)
    n = EDGE_SCORER_BATCHES * BATCH
    X = features(np.random.default_rng(37), n, F)
    refs = {"gbm": direct_rows(q, X), "votes": direct_rows(vq, X)}
    rng = np.random.default_rng(38)
    names = np.where(rng.random(n) < 0.5, "gbm", "votes")
    lanes = rng.choice(["low", "normal", "high"], n)
    lanes[2 * BATCH:] = "low"  # the last micro-batch is shed whole
    fields = q.wire.fields
    events = [dict({f: float(v) for f, v in zip(fields, X[i])
                    if not np.isnan(v)}, _model=str(names[i]),
                   _lane=str(lanes[i])) for i in range(n)]
    m = MetricsRegistry()
    # the lowest lane held shed: the level set by hand, and a pressure
    # inside the hysteresis band, so the controller's ticks hold it there
    adm = AdmissionController(m, lanes=("low", "normal", "high"),
                              on_threshold=0.85, off_threshold=0.55,
                              pressure_fn=lambda: 0.7)
    adm._level = 1
    old = os.environ.get("FJT_SLO_TARGET_MS")
    os.environ["FJT_SLO_TARGET_MS"] = "500"
    try:
        ctrl = ControlSource()
        sc = DynamicScorer(control=ctrl, batch_size=BATCH, metrics=m,
                           admission=adm,
                           lane_fn=lambda p: p.get("_lane", "normal"))
    finally:
        if old is None:
            os.environ.pop("FJT_SLO_TARGET_MS", None)
        else:
            os.environ["FJT_SLO_TARGET_MS"] = old
    ctrl.push(AddMessage("gbm", 1, gbm, 1.0))
    ctrl.push(AddMessage("votes", 1, votes, 1.0))
    sc.finish(sc.submit([]))
    for name in ("gbm", "votes"):
        wait_for(lambda: sc.registry.model_if_warm(ModelId(name, 1))
                 is not None, f"{name}'s warm")
    cold = m.histogram("cold_start_s")
    cold0 = cold.count()
    reset(counter)
    groups = 0
    preds = []
    t0 = time.perf_counter()
    for i in range(0, n, BATCH):
        batch = events[i:i + BATCH]
        groups += len({e["_model"] for e in batch if e["_lane"] != "low"})
        preds += sc.finish(sc.submit(batch))
    dt = time.perf_counter() - t0
    snap = m.snapshot()
    run = held_launches(counter, snap, "edge scorer",
                        warms=cold.count() - cold0, windowed=True)
    if run["dispatches"] != groups or run["launches"] != groups:
        raise RuntimeError(f"edge scorer: {run} for {groups} groups")
    shed_idx = np.flatnonzero(lanes == "low")
    err = 0.0
    for name in ("gbm", "votes"):
        idx = np.flatnonzero((names == name) & (lanes != "low"))
        got = [preds[i][0] for i in idx]
        if name == "gbm":
            err = max(err, check_values(got, refs[name][idx], "edge gbm"))
        else:
            err = max(err, check_vote_preds(
                got, tuple(r[idx] for r in refs[name]), vq.labels,
                "edge votes"))
    if not all(preds[i][0].is_empty for i in shed_idx):
        raise RuntimeError("edge scorer: a shed event came back scored")
    counts = adm.counts()
    if counts["shed"] != {"low": float(shed_idx.size)}:
        raise RuntimeError(f"edge scorer: shed counts {counts}")
    gauges = m.struct_snapshot()["gauges"]
    slo_gauges = sorted(g for g in gauges if g.startswith("slo_"))
    if not sc.slo.enabled or not {"slo_ok", "slo_deadline_ms"} <= set(
            slo_gauges):
        raise RuntimeError(f"edge scorer: SLO gauges {slo_gauges}")
    return {"events": n, "seconds": dt, "groups": groups,
            "shed_events": int(shed_idx.size), "admission": counts,
            "slo_gauges": slo_gauges,
            "score_latency_p99_s": snap.get("score_latency_s_p99"),
            **run, "max_abs_err": err}


def edge_oom_cap(cm, X, direct, counter, workdir) -> dict:
    """``device_oom:site=device_dispatch:n=3`` into a checkpointed
    pipeline with a batcher, armed from the sink after two deliveries:
    the next launch fails, its full redispatch and its first half fail,
    the ladder delivers the quarters and the other half, and
    ``adaptive_batch`` pins at the largest size that fit; every delivery
    of a dispatch made after that stays at or under it."""
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.serving.overload import AdaptiveBatcher
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    n = X.shape[0]
    held = HeldSink({"static": direct}, n, "edge oom_cap")
    held.hooks = {2: lambda: faults.inject("device_oom",
                                           site="device_dispatch", n=3)}
    m = MetricsRegistry()
    batcher = AdaptiveBatcher(m, min_records=BATCH,
                              path=os.path.join(workdir, "oom_cap.json"))
    sizes = []  # (records, the batcher's OOM cap when they arrived)

    def sink(out, k, first):
        sizes.append((k, batcher._oom_cap))
        held(out, k, first)

    pipe = BlockPipeline(
        FiniteBlockSource(X, BATCH), cm, sink, recovery_config(1.0),
        metrics=m, batcher=batcher,
        checkpoint=CheckpointManager(tempfile.mkdtemp(dir=workdir)),
        max_dispatch_chunks=DISPATCH // BATCH)
    reset(counter)
    t0 = time.perf_counter()
    try:
        pipe.run_until_exhausted(timeout=300)
        fired = faults.stats()
    finally:
        faults.clear()
    dt = time.perf_counter() - t0
    cap = batcher.max_records()
    snap = pipe.metrics.snapshot()
    run = held_launches(counter, snap, "edge oom_cap")
    lad = ladder_counts(snap)
    before = max(k for k, c in sizes if c is None)
    after = [k for k, c in sizes if c is not None]
    if (fired != {"device_oom": 3} or lad["oom_shrinks"] != 1
            or cap is None or snap.get("adaptive_batch") != cap
            or not (held.seen == 1).all()):
        raise RuntimeError(f"edge oom_cap: {fired}, {lad}, cap {cap}")
    if cap >= before or not after or max(after) > cap:
        raise RuntimeError(f"edge oom_cap: cap {cap} against deliveries "
                           f"{sizes}")
    return {"records": n, "seconds": dt, "cap_records": cap,
            "largest_before": before, "largest_after": max(after),
            "deliveries_after": len(after), **run, **lad,
            "max_abs_err": held.max_abs_err}


def edge_journey(cm, q, counter, workdir) -> dict:
    """A Kafka-fed, checkpointed ``BlockPipeline`` (loopback broker, the
    DLQ beside the checkpoints) with ``FJT_JOURNEY_DIR`` armed and a
    poison at offset K: K's journey rows show ``ingest``, ``dispatch``,
    ``suspect_scan`` and a ``dlq`` terminal with ``reason=score``, and
    the envelope carries the terminal's ``trace_id`` / ``span_id``."""
    from flink_jpmml_tpu_torch.obs import trace
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.kafka import (
        KafkaBlockSource,
        MiniKafkaBroker,
    )
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    F = len(q.wire.fields)
    X = features(np.random.default_rng(41), EDGE_KAFKA_ROWS, F)
    direct = direct_rows(q, X)
    jdir = os.path.join(workdir, "journeys")
    ck = tempfile.mkdtemp(dir=workdir)
    sink = HeldSink({"static": direct}, X.shape[0], "edge journey")
    m = MetricsRegistry()
    broker = MiniKafkaBroker(topic="edge")
    src = pipe = None
    os.environ["FJT_JOURNEY_DIR"] = jdir
    try:
        broker.append_rows(X)
        src = KafkaBlockSource(broker.host, broker.port, "edge", n_cols=F,
                               metrics=m, max_wait_ms=20)
        pipe = BlockPipeline(src, cm, sink, recovery_config(1.0), metrics=m,
                             max_dispatch_chunks=DISPATCH // BATCH,
                             checkpoint=CheckpointManager(ck))
        faults.inject("poison_record", offset=EDGE_POISON)
        reset(counter)
        t0 = time.perf_counter()
        pipe.start()
        wait_for(lambda: pipe.committed_offset >= X.shape[0]
                 or pipe.error is not None, "the Kafka journey run")
    finally:
        os.environ.pop("FJT_JOURNEY_DIR", None)
        faults.clear()
        if pipe is not None:
            pipe.stop()
            pipe.join(timeout=60)
        if src is not None:
            src.close()
        broker.close()
    dt = time.perf_counter() - t0
    if pipe.error is not None:
        raise RuntimeError(f"edge journey: {pipe.error!r}")
    run = held_launches(counter, pipe.metrics.snapshot(), "edge journey")
    rows = trace.read_rows(jdir, limit=1_000_000)
    tid = trace.trace_id_for(EDGE_POISON)
    kinds = set()
    for r in rows:
        lo, k = r.get("first_off"), r.get("n")
        if (r["trace_id"] == tid or r.get("offset") == EDGE_POISON
                or (lo is not None and k is not None
                    and lo <= EDGE_POISON < lo + k)):
            kinds.add(r["kind"])
    dlq_rows = [r for r in rows if r["kind"] == "dlq"]
    envs = list(pipe._dlq.scan())
    want = np.ones(X.shape[0], np.int32)
    want[EDGE_POISON] = 0
    if not {"ingest", "dispatch", "suspect_scan", "dlq"} <= kinds:
        raise RuntimeError(f"edge journey: K's hops {sorted(kinds)}")
    if ([(r["offset"], r["reason"]) for r in dlq_rows]
            != [(EDGE_POISON, "score")] or len(envs) != 1
            or (envs[0]["trace_id"], envs[0]["span_id"])
            != (dlq_rows[0]["trace_id"], dlq_rows[0]["span_id"])
            or dlq_rows[0]["trace_id"] != tid):
        raise RuntimeError(f"edge journey: dlq rows {dlq_rows}, envelopes "
                           f"{envs}")
    if not np.array_equal(sink.seen, want):
        raise RuntimeError("edge journey: a clean record missed the sink, or "
                           "the poisoned one reached it")
    snap = m.snapshot()
    return {"records": int(X.shape[0]), "seconds": dt,
            "poison_offset": EDGE_POISON, "k_hops": sorted(kinds),
            "rows": len(rows), "journeys_sampled": snap.get(
                "journeys_sampled"),
            "journeys_dropped": {k: v for k, v in snap.items()
                                 if k.startswith("journeys_dropped")
                                 and not k.endswith("_per_s")},
            "envelope_trace_id": envs[0]["trace_id"], **run,
            "max_abs_err": sink.max_abs_err}


def edge_journey_cost(cm, X, counter, workdir) -> list:
    """The fused GBM's BlockPipeline over 16 dispatches of 262,144 plain
    and with ``FJT_JOURNEY_DIR`` armed, twice in the order plain, armed,
    armed, plain."""
    from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource

    runs = []
    for armed in (False, True, True, False) * 2:
        count = [0]

        def sink(out, n, first_off, count=count):
            count[0] += n

        if armed:
            os.environ["FJT_JOURNEY_DIR"] = tempfile.mkdtemp(dir=workdir)
        try:
            r = drive(cm, CyclingBlockSource(X, block_size=DISPATCH), sink,
                      count, counter)
        finally:
            os.environ.pop("FJT_JOURNEY_DIR", None)
        runs.append({"journeys": armed, **{k: r[k] for k in (
            "records", "seconds", "records_per_s", "dispatches",
            "launches", "encode_mode", "batch_latency_p50_s",
            "batch_latency_p99_s")}})
    return runs


def edge_spans(cm, X, direct, counter, workdir) -> dict:
    """With ``FJT_TRACE_DIR`` set, the span file parses and holds one
    ``h2d_dispatch`` and one ``readback`` span a dispatch."""
    from flink_jpmml_tpu_torch.obs import spans
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )

    sdir = os.path.join(workdir, "spans")
    sink = HeldSink({"static": direct}, X.shape[0], "edge spans")
    os.environ["FJT_TRACE_DIR"] = sdir
    try:
        pipe = BlockPipeline(FiniteBlockSource(X, BATCH), cm, sink,
                             recovery_config(),
                             max_dispatch_chunks=DISPATCH // BATCH)
        reset(counter)
        t0 = time.perf_counter()
        pipe.run_until_exhausted(timeout=300)
        dt = time.perf_counter() - t0
        w = spans.writer()
        w.flush()
        path = w.path
        w.close()
    finally:
        os.environ.pop("FJT_TRACE_DIR", None)
    raw = open(path, encoding="utf-8").read()
    events = json.loads(raw.rstrip().rstrip(",") + "]")
    run = held_launches(counter, pipe.metrics.snapshot(), "edge spans")
    by = {}
    for e in events:
        if e.get("ph") != "X" or e.get("dur", -1) < 0:
            raise RuntimeError(f"edge spans: bad event {e}")
        by[e["name"]] = by.get(e["name"], 0) + 1
    d = run["dispatches"]
    if not (by.get("h2d_dispatch") == by.get("readback") == d
            == by.get("sink")) or not (sink.seen == 1).all():
        raise RuntimeError(f"edge spans: {by} for {d} dispatches")
    return {"records": int(X.shape[0]), "seconds": dt, "span_counts": by,
            "span_file_bytes": len(raw), **run,
            "max_abs_err": sink.max_abs_err}


def edge_net_remote(cm, q, X, direct, counter, workdir) -> dict:
    """``BlockFrameServer`` → ``TcpBlockSource`` → ``BlockPipeline`` on the
    card, held to the direct run; then the GBM loaded through
    ``ModelReader("http://127.0.0.1:<port>/gbm_500.pmml")`` from a
    loopback ``http.server`` scores equal to the local file, and the
    second load is a 304 with no recompile."""
    import http.server
    import threading

    from flink_jpmml_tpu_torch.api import ModelReader
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.net import (
        BlockFrameServer,
        TcpBlockSource,
    )

    F = len(q.wire.fields)
    n = X.shape[0]
    sink = HeldSink({"static": direct}, n, "edge tcp")
    srv = BlockFrameServer(X, block_size=BATCH)
    src = TcpBlockSource("127.0.0.1", srv.port, arity=F)
    try:
        pipe = BlockPipeline(src, cm, sink, recovery_config(),
                             max_dispatch_chunks=DISPATCH // BATCH)
        reset(counter)
        t0 = time.perf_counter()
        pipe.run_until_exhausted(timeout=300)
        dt_tcp = time.perf_counter() - t0
    finally:
        src.close()
        srv.stop()
    tcp = held_launches(counter, pipe.metrics.snapshot(), "edge tcp")
    if not (sink.seen == 1).all() or pipe.committed_offset != n:
        raise RuntimeError("edge tcp: records lost or repeated")
    tcp.update(records=n, seconds=dt_tcp, records_per_s=n / dt_tcp,
               max_abs_err=sink.max_abs_err)

    stats = {"GET": 0, "304": 0}

    class Handler(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            stats["GET"] += 1
            super().do_GET()

        def send_response(self, code, *a, **kw):
            if code == 304:
                stats["304"] += 1
            super().send_response(code, *a, **kw)

    os.environ["FJT_MODEL_CACHE"] = os.path.join(workdir, "model-cache")
    srv_http = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0),
        lambda *a, **kw: Handler(*a, directory=workdir, **kw))
    th = threading.Thread(target=srv_http.serve_forever, daemon=True)
    th.start()
    try:
        uri = f"http://127.0.0.1:{srv_http.server_address[1]}/gbm_500.pmml"
        t0 = time.perf_counter()
        rcm = ModelReader(uri).load(batch_size=BATCH)
        t_first = time.perf_counter() - t0
        gets = stats["GET"]
        t0 = time.perf_counter()
        rcm2 = ModelReader(uri).load(batch_size=BATCH)
        t_second = time.perf_counter() - t0
        if rcm2 is not rcm or stats["GET"] != gets + 1 or stats["304"] != 1:
            raise RuntimeError(f"edge remote: second load {stats}, same "
                               f"model {rcm2 is rcm}")
        rq = rcm.quantized_scorer()
        rsink = HeldSink({"static": direct}, DISPATCH, "edge remote")
        rpipe = BlockPipeline(FiniteBlockSource(X[:DISPATCH], BATCH), rcm,
                              rsink, recovery_config(),
                              max_dispatch_chunks=DISPATCH // BATCH)
        reset(counter)
        rpipe.run_until_exhausted(timeout=300)
    finally:
        os.environ.pop("FJT_MODEL_CACHE", None)
        srv_http.shutdown()
        srv_http.server_close()
        th.join(timeout=30)
    remote = held_launches(counter, rpipe.metrics.snapshot(), "edge remote")
    if (rq is None or rq.backend != "cuda" or not (rsink.seen == 1).all()
            or rpipe.backend != "rank_wire_cuda"):
        raise RuntimeError("edge remote: the remote model did not score on "
                           "the kernel")
    remote.update(records=DISPATCH, first_load_s=t_first,
                  second_load_s=t_second, http=dict(stats),
                  recompiled=False, max_abs_err=rsink.max_abs_err)
    return {"tcp": tcp, "remote": remote,
            "launches": tcp["launches"] + remote["launches"],
            "max_abs_err": max(tcp["max_abs_err"], remote["max_abs_err"])}


def serving_edge(workdir: str, counter, q, vq, cm, smi: str) -> dict:
    """The phase: overload, scorer, oom_cap, journey (with its cost part),
    spans and net_remote, at the main path's width (the 500-tree GBM on
    the fused placement, the 3-class vote forest), each part's outputs
    held to the card's direct run."""
    t_phase = time.perf_counter()
    gbm = os.path.join(workdir, "gbm_500.pmml")
    votes = os.path.join(workdir, "votes_500.pmml")
    F = len(q.wire.fields)
    X = features(np.random.default_rng(43), EDGE_RECORDS, F)
    direct = direct_rows(q, X)
    parts = {
        "overload": edge_overload(cm, q, counter, workdir),
        "scorer": edge_scorer(gbm, votes, q, vq, counter),
        "oom_cap": edge_oom_cap(cm, np.concatenate([X, X]),
                                np.concatenate([direct, direct]), counter,
                                workdir),
        "journey": edge_journey(cm, q, counter, workdir),
        "spans": edge_spans(cm, X, direct, counter, workdir),
        "net_remote": edge_net_remote(cm, q, X, direct, counter, workdir),
    }
    parts["journey_cost"] = edge_journey_cost(cm, X, counter, workdir)
    plain = [r["records_per_s"] for r in parts["journey_cost"]
             if not r["journeys"]]
    armed = [r["records_per_s"] for r in parts["journey_cost"]
             if r["journeys"]]
    parts["journey_cost_summary"] = {
        "plain_records_per_s": plain, "armed_records_per_s": armed,
        "fraction_lost": 1.0 - statistics.mean(armed) / statistics.mean(plain),
    }
    by_classes = {}
    for part in ("overload", "scorer", "oom_cap", "journey", "spans"):
        for c, k in parts[part]["launches_by_classes"].items():
            by_classes[c] = by_classes.get(c, 0) + k
    for sub in ("tcp", "remote"):
        for c, k in parts["net_remote"][sub]["launches_by_classes"].items():
            by_classes[c] = by_classes.get(c, 0) + k
    c1 = by_classes.get(1, 0) + sum(r["launches"]
                                    for r in parts["journey_cost"])
    return {"nvidia_smi": smi, "seconds": time.perf_counter() - t_phase,
            "parts": parts, "launches_c1": c1,
            "launches_c3": by_classes.get(3, 0),
            "max_abs_err": max(parts[p]["max_abs_err"] for p in (
                "overload", "scorer", "oom_cap", "journey", "spans",
                "net_remote"))}


# -- the kernel search: launch shapes, walk layouts, the profiler ---------

KS_SLICE = BATCH  # rows of the every-candidate check
KS_DISPATCHES = 19  # the profiled drive's dispatches of DISPATCH records


def check_candidates(q, codes, counter) -> dict:
    """Every candidate of ``q``'s search space (``autotune.candidate_space``)
    built and launched on ``codes``: each one's raw rows bit-equal to
    today's launch (the built default) and to the plain version on the
    same codes. → the candidates' names, and the launches the check made
    (not the path's)."""
    import torch

    from flink_jpmml_tpu_torch.compile import autotune, qtrees_cuda

    F = len(q.wire.fields)

    def tables(params):
        return {k: params[k] for k in qtrees_cuda.TABLE_KEYS}

    before = counter.launches
    today = qtrees_cuda.leaf_rows(codes, tables(q.params), F)
    plain = qtrees_cuda.leaf_rows_reference(codes, tables(q.params))
    torch.cuda.synchronize()
    if not torch.equal(today, plain):
        raise RuntimeError("kernel_search: today's launch differs from the "
                           "plain version")
    names = []
    for c in autotune.candidate_space(q):
        name = autotune._cand_name(q, c)
        built = q.build_variant(c["layout"], c["threads"], c["chunk_bytes"])
        if built is None:
            raise RuntimeError(f"kernel_search: candidate {name} not built")
        got = qtrees_cuda.leaf_rows(codes, tables(built["params"]), F,
                                    c["threads"], c["chunk_bytes"])
        torch.cuda.synchronize()
        if not torch.equal(got, today):
            raise RuntimeError(f"kernel_search: candidate {name} differs "
                               "from today's launch")
        names.append(name)
    return {"candidates": names, "rows": int(codes.shape[0]),
            "check_launches": counter.launches - before}


def kernel_search(workdir: str, counter, smi: str) -> dict:
    """The kernel search on the card (``compile/autotune.py``): the main
    path's 500-tree GBM (bootstrap, the first 8 candidates timed on a cold
    ledger) and then the 3-class vote forest (learned, ranked by the fit
    the GBM's timings gave), each from a fresh build of its PMML file, at
    the main path's 262,144 rows. Every candidate of each space is held
    bit-equal to today's launch and to the plain version on a
    16,384-record slice; the sweep itself holds each timed one to the
    default on its own rows. The winner is stored in the port's cache
    under this run's scratch HOME, and a second build adopts it with no
    kernel launch. Then the tuned GBM drives 19 dispatches through
    ``BlockPipeline`` with the profiler sampling every 50 ms; the line
    holds ``device_samples``, ``device_mfu`` / ``device_membw_util`` (the
    walk's path steps against the H100's INT32 rate, bytes against HBM3)
    and the cost ledger's row."""
    import torch

    from flink_jpmml_tpu_torch.compile import autotune, costmodel
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.obs import profiler
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file
    from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    t_phase = time.perf_counter()
    keys = ("HOME", "FJT_AUTOTUNE_CACHE", "FJT_PROF_SAMPLE")
    saved = {k: os.environ.get(k) for k in keys}
    # the port's default cache path, under this run's scratch HOME
    os.environ["HOME"] = workdir
    os.environ.pop("FJT_AUTOTUNE_CACHE", None)
    try:
        cache_file = str(autotune.cache_path())
        if not cache_file.startswith(os.path.join(workdir, ".cache") + os.sep):
            raise RuntimeError(f"kernel_search: cache at {cache_file}")
        models = {}
        by_classes = {}
        for name, file, top_k in (("gbm500", "gbm_500.pmml", 8),
                                  ("votes500", "votes_500.pmml", None)):
            doc = parse_pmml_file(os.path.join(workdir, file))
            q = compile_pmml(doc, batch_size=BATCH).quantized_scorer()
            if q.backend != "cuda" or q.tuned is not None:
                raise RuntimeError(f"kernel_search: {name} built "
                                   f"{q.backend}, tuned {q.tuned}")
            F = len(q.wire.fields)
            X = features(np.random.default_rng(61), DISPATCH, F)
            checked = check_candidates(q, torch.from_numpy(
                q.wire.encode(X[:KS_SLICE])).cuda(), counter)
            before = (q.encode_placement, q.layout, q.launch)
            reset(counter)
            cfg = autotune.ensure_tuned(q, X, repeats=3, top_k=top_k)
            torch.cuda.synchronize()
            sweep_launches = counter.launches
            C = len(q.labels) if q.labels else 1
            by_classes[C] = by_classes.get(C, 0) + sweep_launches
            if cfg.source != "sweep" or sweep_launches == 0:
                raise RuntimeError(f"kernel_search: {name} did not sweep")
            stored = autotune.lookup(q.model_hash, autotune.backend_key(q))
            if stored is None or not os.path.exists(cache_file):
                raise RuntimeError(f"kernel_search: {name}'s winner not in "
                                   f"{cache_file}")
            # a second build adopts the stored winner, with no sweep
            reset(counter)
            q2 = compile_pmml(doc, batch_size=BATCH).quantized_scorer()
            build_launches = counter.launches
            if (build_launches or q2.tuned is None
                    or q2.tuned.source != "cache"
                    or q2.layout != cfg.layout
                    or q2.launch != (cfg.threads, cfg.chunk_bytes)
                    or q2.encode_placement != cfg.encode):
                raise RuntimeError(
                    f"kernel_search: {name}'s second build ran "
                    f"{build_launches} launches, tuned {q2.tuned}, layout "
                    f"{q2.layout}, launch {q2.launch}, encode "
                    f"{q2.encode_placement}")
            codes = torch.from_numpy(q.wire.encode(X[:KS_SLICE])).cuda()
            with torch.no_grad():
                a, b = q._fn(q.params, codes), q2._fn(q2.params, codes)
            same = (all(torch.equal(x, y) for x, y in zip(a, b))
                    if isinstance(a, tuple) else torch.equal(a, b))
            if not same:
                raise RuntimeError(f"kernel_search: {name}'s adopted build "
                                   "scores differently")
            search = cfg.search or {}
            models[name] = {
                "classes": C, **checked, "before": {
                    "encode": before[0], "layout": before[1],
                    "launch": list(before[2])},
                "chosen": {"variant": search.get("chosen"),
                           "layout": cfg.layout, "threads": cfg.threads,
                           "chunk_bytes": cfg.chunk_bytes,
                           "encode": cfg.encode},
                "mode": search.get("mode"), "timed": search.get("timed"),
                "candidates_total": search.get("candidates_total"),
                "sweep_rows": search.get("rows"),
                # per candidate: the sweep's best-of ms at its rows
                "ms": {k: 1e3 * search.get("rows", DISPATCH) / v
                       for k, v in cfg.rates.items()
                       if not k.startswith("encode_")},
                "encode_records_per_s": {
                    k: v for k, v in cfg.rates.items()
                    if k.startswith("encode_")},
                "predicted_s_per_record": search.get("predicted"),
                "pred_abs_log_err": search.get("pred_abs_log_err"),
                "fit": search.get("model"),
                "sweep_launches": sweep_launches,
                "second_build_launches": build_launches,
                "cache_file": os.path.relpath(cache_file, workdir),
            }

        # the tuned GBM through BlockPipeline, profiled
        os.environ["FJT_PROF_SAMPLE"] = "0.05"
        cm = compile_pmml(parse_pmml_file(os.path.join(workdir,
                                                       "gbm_500.pmml")),
                          batch_size=BATCH)
        q = cm.quantized_scorer()
        if q.tuned is None or q.tuned.source != "cache":
            raise RuntimeError("kernel_search: the profiled drive's scorer "
                               "did not adopt the cached winner")
        F = len(q.wire.fields)
        data = features(np.random.default_rng(0), 4 * DISPATCH, F)
        if q.encode_placement == "fused":
            q.predict_fused(data[:BATCH])
        else:
            q.predict_wire(q.wire.encode(data[:BATCH]))
        torch.cuda.synchronize()
        reg = MetricsRegistry()
        count = [0]
        # every sample the pipeline's profiler takes, in s a record
        prof = profiler.profiler_for(reg)
        per_record = []
        record_sample = prof.record_sample

        def keep(device_s, profile, overhead_s=None):
            per_record.append(device_s / profile["records"])
            record_sample(device_s, profile, overhead_s)

        prof.record_sample = keep

        def sink(out, n, first_off):
            vals = np.asarray(out)
            if vals.ndim != 1 or vals.shape[0] < n or not np.isfinite(
                    vals[:n]).all():
                raise RuntimeError(f"kernel_search sink got {vals.shape}")
            count[0] += n

        run = drive(cm, CyclingBlockSource(data, block_size=DISPATCH), sink,
                    count, counter, metrics=reg,
                    target=KS_DISPATCHES * DISPATCH)
        by_classes[1] = by_classes.get(1, 0) + run["launches"]
        samples = int(reg.counter("device_samples").get())
        mfu = reg.gauge("device_mfu").get()
        membw = reg.gauge("device_membw_util").get()
        ops = reg.gauge("flops_per_record").get()
        steps = q._meta["path_steps"]
        if samples <= 0 or not mfu or not membw or ops != steps:
            raise RuntimeError(f"kernel_search: {samples} device samples, "
                               f"mfu {mfu}, membw {membw}, {ops} operations "
                               f"a record against {steps} path steps")
        rows = {k: v for k, v in profiler._COST_LEDGER.entries().items()
                if v.get("model") == "static" and v.get("backend") == "cuda"}
        if not rows:
            raise RuntimeError("kernel_search: no cost ledger row for the "
                               "profiled drive")
        # a sample times what the sweep timed for the serving variant
        # (the scorer's function on codes on the card): its median sits
        # inside the drift band of the sweep's reading of the winner
        gbm = models["gbm500"]
        sweep_s = gbm["ms"][gbm["chosen"]["variant"]] / 1e3 / gbm[
            "sweep_rows"]
        sample_s = float(np.median(per_record))
        band = profiler._PRED_BAND
        if not sweep_s / band <= sample_s <= sweep_s * band:
            raise RuntimeError(
                f"kernel_search: sampled {sample_s:.4g} s a record against "
                f"the sweep's {sweep_s:.4g} for {gbm['chosen']['variant']}")
        profiler._COST_LEDGER.flush()
        device_stage = (run["attribution"] or {}).get("device")
        return {
            "nvidia_smi": smi, "seconds": time.perf_counter() - t_phase,
            "models": models,
            "profiled_drive": {
                **{k: run[k] for k in ("records", "records_per_s",
                                       "dispatches", "launches",
                                       "encode_mode")},
                "device_samples": samples, "device_mfu": mfu,
                "device_membw_util": membw, "flops_per_record": ops,
                "path_steps_per_record": steps,
                "device_ns_per_record": reg.gauge(
                    "device_ns_per_record").get(),
                "peaks": profiler.chip_peaks(torch.cuda.get_device_name(0),
                                             strict=True),
                "device_stage": device_stage,
                "sample_ns_per_record": [1e9 * v for v in per_record],
                "sweep_ns_per_record": 1e9 * sweep_s,
                "sample_over_sweep": sample_s / sweep_s,
                "cost_ledger": rows,
            },
            "cost_model_rows": len(costmodel.training_rows(
                platform=autotune.platform_key())),
            "launches_c1": by_classes.get(1, 0),
            "launches_c3": by_classes.get(3, 0),
        }
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- multi-tenant and stateful scoring (the zoo_state phase) ---------------

ZOO_DOCS = 10  # distinct documents the zoo cycles (bench.py run_zoo_bench)
ZOO_REGISTERED = 1000
ZOO_HOT = 100
ZOO_PER_HOT = 1024  # records per hot tenant
ZOO_BATCH = 256
ZOO_PER_ROUND = 256
PACK_ROWS = 16384  # rows a main-path-shaped member in the timed pack
PACK_SEEDS = tuple(range(11, 19))
PACK_TREES = 500
STATE_KEYS = 10_000_000
STATE_RECORDS = 10_485_760
STATE_CAPACITY = 1 << 21
STATE_BATCH = 8192
STATE_CPU_BATCHES = 32  # the stream prefix the CPU port replays
STATE_GROUP = 4  # batches a dispatch in the grouping check
KILL_RECORDS, KILL_KEYS, KILL_CAPACITY, KILL_BATCH, KILLS = (
    49_152, 16_384, 32_768, 1024, 2)
_PERM = 2654435761  # 0x9E3779B1: offset → key, a permutation of the domain


def zoo_doc_paths(workdir: str) -> list:
    """The JAX zoo drill's documents: gen_gbm of 6-15 trees, depth 3, 4
    features, seeds 100-109."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm

    return [gen_gbm(workdir, n_trees=6 + d, depth=3, n_features=4,
                    seed=100 + d, name=f"zoo{d}.pmml")
            for d in range(ZOO_DOCS)]


def _main_member(seed: int) -> tuple:
    """(walk tables as numpy, codes of PACK_ROWS records) of the main
    path's GBM shape at ``seed``, compiled on the CPU: run in a worker
    process, so the eight members compile side by side."""
    import tempfile as _tf

    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    d = _tf.mkdtemp(prefix="fjt-pack-")
    try:
        path = gen_gbm(d, n_trees=PACK_TREES, depth=6, n_features=32,
                       seed=seed,
                       name=f"pack{seed}.pmml")
        q = compile_pmml(parse_pmml_file(path), batch_size=PACK_ROWS,
                         device="cpu").quantized_scorer()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    X = features(np.random.default_rng(seed), PACK_ROWS, 32)
    return ({k: q.params[k].numpy() for k in qtrees_cuda.TABLE_KEYS},
            q.wire.encode(X))


def check_packed(label: str, members: list, rows: list,
                 phase: str = "zoo_state") -> dict:
    """The packed launch against each member's solo launch and against
    its plain version on the card, bit for bit. ``members`` are (tables on
    the card, codes u8[n, F] on the card)."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    codes = packed_codes(members, rows)
    tables = [t for t, _ in members]
    fields = [c.shape[1] for _, c in members]
    got = qtrees_cuda.leaf_rows_packed(codes, rows, tables, fields)
    ref = qtrees_cuda.leaf_rows_packed_reference(codes, rows, tables, fields)
    solo = [qtrees_cuda.leaf_rows(c[: rows[m]].contiguous(), tables[m],
                                  fields[m]) if rows[m] else None
            for m, (_, c) in enumerate(members)]
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for m in range(len(members)):
        if rows[m]:
            ok &= bool(torch.equal(got[m], solo[m]))
            err = max(err, float((got[m] - ref[m]).abs().max()))
        ok &= bool(torch.equal(got[m], ref[m]))
        ok &= got[m].shape == (rows[m], tables[m]["rows"].shape[2])
    row = {"case": label, "members": len(members), "rows": list(rows),
           "classes": sorted({int(t["rows"].shape[2]) for t in tables}),
           "max_abs_err": err, "ok": ok}
    if not ok:
        emit({"phase": phase, "packed_kernel": row})
        raise RuntimeError(f"{label}: the packed launch differs from a "
                           f"member's solo launch or its plain version")
    return row


# row counts about the packed launch's tiles (32 to 1,024 rows a block):
# each member's last block one row short of full, full, or one row over
PACK_EDGE_ROWS_ZOO = (31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 1)
PACK_EDGE_ROWS_MAIN = (255, 256, 257, 511, 512, 513, 1023, 1025)
# the packed launches timed in the zoo_state phase (and paired by --ab
# packed): the main path's shape, the JAX zoo drill's and the soak's
PACK_TIMED = ("main8_16384", "zoo16_256", "soak_zoo_6")


def pack_members(workdir: str, zoo_paths: list) -> dict:
    """The packs the packed launch is checked on, label → (members, rows),
    each member (tables on the card, codes u8[n, F] on the card): 16 zoo
    members at 256 rows, a mixed pack with 3- and 16-class vote forests,
    ragged and tile-edge row counts, the soak's six zoo tenants, and eight
    members of the main path's shape at 16,384 rows each (compiled in
    worker processes on the host) and at tile-edge rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from flink_jpmml_tpu_torch.assets_gen import gen_vote_forest
    from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    # the eight main-path-shaped members compile on the host, side by side
    pool = ProcessPoolExecutor(
        max_workers=min(len(PACK_SEEDS), os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(_main_member, s) for s in PACK_SEEDS]
        rng = np.random.default_rng(41)

        def small(path, n):
            q = compile_pmml(parse_pmml_file(path),
                             batch_size=ZOO_BATCH).quantized_scorer()
            if q.backend != ("cuda" if q.device.type == "cuda"
                             else "cuda_plain"):
                raise RuntimeError(f"{path}: backend {q.backend}")
            tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
            codes = torch.from_numpy(q.wire.encode(
                features(rng, n, len(q.wire.fields)))).cuda()
            return tables, codes

        zoo = [small(p, ZOO_BATCH) for p in zoo_paths]
        vote = small(gen_vote_forest(workdir, n_trees=8, depth=3,
                                     n_features=4, n_classes=3, seed=42,
                                     name="zoo_votes.pmml"), ZOO_BATCH)
        vote16 = small(gen_vote_forest(workdir, n_trees=7, depth=4,
                                       n_features=6, n_classes=16, seed=43,
                                       name="zoo_votes16.pmml"), ZOO_BATCH)
        mains = [f.result() for f in futures]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    members = [({k: torch.from_numpy(v).cuda() for k, v in t.items()},
                torch.from_numpy(c).cuda()) for t, c in mains]
    edge_zoo = [zoo[i % ZOO_DOCS] for i in range(len(PACK_EDGE_ROWS_ZOO))]
    return {
        "zoo16_256": ([zoo[i % ZOO_DOCS] for i in range(16)],
                      [ZOO_BATCH] * 16),
        "mixed_c_votes3": ([zoo[0], vote, zoo[1], vote], [ZOO_BATCH] * 4),
        "mixed_c1_c3_c16": ([zoo[2], vote, vote16, zoo[3], vote16],
                            [ZOO_BATCH, 129, 255, 1, 64]),
        "ragged": (zoo[:8], [1, 255, 0, 256, 129, 7, 256, 64]),
        "edges_zoo": (edge_zoo, list(PACK_EDGE_ROWS_ZOO)),
        "soak_zoo_6": (zoo[:6], list(SOAK_PACK_ROWS)),
        "edges_main8": (members, list(PACK_EDGE_ROWS_MAIN)),
        "main8_16384": (members, [PACK_ROWS] * len(members)),
    }


def pack_shape_of(members: list, rows: list):
    """The packed launch's shape (``qtrees_cuda.packed_shape``) for a pack
    of ``members`` at their default launch shapes."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    return qtrees_cuda.packed_shape(
        [(c.shape[1], t["walk"].shape[0], t["walk"].shape[1], None, None)
         for t, c in members], rows,
        max(int(t["rows"].shape[2]) for t, _ in members))


def packed_codes(members: list, rows: list):
    """The packed buffer u8[N, B, F_max] of ``members``' first rows."""
    import torch

    B = max(max(rows), 1)
    F = max(c.shape[1] for _, c in members)
    codes = torch.zeros((len(members), B, F), dtype=torch.uint8,
                        device=members[0][1].device)
    for m, (_, c) in enumerate(members):
        codes[m, : rows[m], : c.shape[1]] = c[: rows[m]]
    return codes


def time_packed(label: str, members: list, rows: list) -> dict:
    """CUDA-event median of one packed launch over ``members`` (the
    wrapper's host work included, as a caller meets it), beside its shape
    (threads, records a thread, blocks, shared memory, the resident blocks
    an SM that the shape rule counts on and that the runtime's occupancy
    calculator reads) and the least time the card could take: the live
    codes, the tables and the sums moved once over HBM's rate, or the
    needed integer steps and f32 adds over their pipes' rates."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    codes = packed_codes(members, rows)
    tables = [t for t, _ in members]
    fields = [c.shape[1] for _, c in members]
    shape = pack_shape_of(members, rows)
    classes = max(int(t["rows"].shape[2]) for t in tables)
    ms = cuda_ms(lambda: qtrees_cuda.leaf_rows_packed(
        codes, rows, tables, fields), 5, 40)
    steps = adds = 0
    for m, r in enumerate(rows):
        if r:
            ops = needed_ops(codes[m, :r, : fields[m]], tables[m])
            steps += ops["int_steps"]
            adds += ops["f32_adds"]
    n_bytes = sum(r * f + 4 * r * int(t["rows"].shape[2])
                  for r, f, t in zip(rows, fields, tables)) + sum(
        t["walk"].numel() * t["walk"].element_size() for t in tables)
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = max(steps / PEAK_INT32_OPS_S, adds / PEAK_F32_FLOP_S) * 1e3
    bound = max(bytes_ms, ops_ms)
    return {
        "shape": label, "members": len(members), "rows": sum(rows),
        "packed_ms": ms, "bound_ms": bound,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "share_of_bound": bound / ms,
        "threads": shape.threads,
        "records_per_thread": shape.records_per_thread,
        "blocks": shape.n_blocks, "smem_bytes": shape.smem,
        "resident_blocks_per_sm": qtrees_cuda.packed_resident_on_card(
            shape, classes),
        "resident_blocks_per_sm_rule": shape.resident,
        "ops": {"int_steps": steps, "f32_adds": adds},
        "bytes": n_bytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
    }


def packed_kernel(workdir: str, zoo_paths: list) -> dict:
    """The packed launch on the card, bit for bit against each member's
    solo launch and its plain version on every pack of ``pack_members``;
    timed (``time_packed``) at ``PACK_TIMED``, and the eight main-path
    members also against their eight solo launches."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    t0 = time.perf_counter()
    packs = pack_members(workdir, zoo_paths)
    cases = []
    for label, (members, rows) in packs.items():
        row = check_packed(label, members, rows)
        shape = pack_shape_of(members, rows)
        row.update(threads=shape.threads,
                   records_per_thread=shape.records_per_thread,
                   blocks=shape.n_blocks)
        cases.append(row)
    shapes = [time_packed(label, *packs[label]) for label in PACK_TIMED]
    # the eight-member pack against its members' solo launches
    members, rows = packs["main8_16384"]
    F = 32
    codes = packed_codes(members, rows)
    tables = [t for t, _ in members]
    fields = [F] * len(members)

    def solos():
        for m in range(len(members)):
            qtrees_cuda.leaf_rows(codes[m], tables[m], F)

    solo_seq_ms = cuda_ms(solos, 3, 20)
    solo_each_ms = [cuda_ms(lambda m=m: qtrees_cuda.leaf_rows(
        codes[m], tables[m], F), 3, 20) for m in range(len(members))]
    plain_ms = cuda_ms(lambda: qtrees_cuda.leaf_rows_packed_reference(
        codes, rows, tables, fields), 1, 3)
    torch.cuda.synchronize()
    main = shapes[0]
    return {
        "seconds": time.perf_counter() - t0,
        "cases": cases,
        "shapes": shapes,
        "timing": {
            "members": len(members), "rows_per_member": PACK_ROWS,
            "threads": main["threads"],
            "records_per_thread": main["records_per_thread"],
            "smem_bytes": main["smem_bytes"], "blocks": main["blocks"],
            "resident_blocks_per_sm": main["resident_blocks_per_sm"],
            "launches_packed": 1, "launches_solo": len(members),
            "packed_ms": main["packed_ms"], "solo_sequence_ms": solo_seq_ms,
            "solo_sum_ms": sum(solo_each_ms), "solo_each_ms": solo_each_ms,
            "packed_vs_solo_sequence": solo_seq_ms / main["packed_ms"],
            "plain_ms": plain_ms,
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "share_of_bound": main["share_of_bound"],
            "ops": main["ops"], "bytes": main["bytes"],
            "bytes_ms": main["bytes_ms"], "ops_ms": main["ops_ms"],
            "library_ms": None,
        },
    }


def _zoo_events(data: np.ndarray, fields: list, name: str, lo: int,
                n: int) -> list:
    return [(name, dict(zip(fields, data[i % len(data)].tolist()),
                        _key=f"k{i}")) for i in range(lo, lo + n)]


def zoo_drill(workdir: str, zoo_paths: list) -> dict:
    """The JAX zoo drill's geometry (bench.py run_zoo_bench) on the card:
    1,000 registered tenants cycling 10 documents, 100 hot with 1,024
    records each (1% missing), batch 256; a one-tenant baseline, the solo
    oracle (zoo off) and ``zoo=True`` over the same stream; every
    (tenant, record) equal to the oracle's; then a device fault injected
    at a pack's readback; then the JAX drill's rollout and drift parts:
    a hot tenant's canary (a byte copy of its document at 30%) books
    candidate records, and with the drift plane installed one round
    sketches the predictions of at least two served documents."""
    import gc

    from flink_jpmml_tpu_torch.compile import qtrees_cuda
    from flink_jpmml_tpu_torch.models.control import AddMessage, RolloutMessage
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.obs import drift
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    t0 = time.perf_counter()
    fields = [f"f{j}" for j in range(4)]
    names = [f"t{i:04d}" for i in range(ZOO_REGISTERED)]
    hot = names[:ZOO_HOT]
    rng = np.random.default_rng(23)
    data = rng.normal(0.0, 1.5, (ZOO_HOT * ZOO_PER_HOT, 4)).astype(
        np.float32)
    data[rng.random(size=data.shape) < 0.01] = np.nan
    rounds = []
    cursor = 0
    for _ in range(ZOO_PER_HOT // ZOO_PER_ROUND):
        ev = []
        for name in hot:
            ev.extend(_zoo_events(data, fields, name, cursor, ZOO_PER_ROUND))
            cursor += ZOO_PER_ROUND
        rounds.append(ev)
    total = sum(len(ev) for ev in rounds)

    def scorer(tenants, zoo):
        ctrl = ControlSource()
        sc = DynamicScorer(control=ctrl, batch_size=ZOO_BATCH, zoo=zoo)
        for name, path in tenants:
            ctrl.push(AddMessage(name, 1, path, timestamp=time.time()))
        sc._drain_control()
        return sc

    def wait_warm(sc, keys):
        for name in keys:
            wait_for(lambda: sc.registry.model_if_warm(ModelId(name, 1))
                     is not None, f"{name} warm", timeout=600.0)

    def sig(p):
        if p.is_empty:
            return None
        return (p.score.value, None if p.target is None else repr(p.target))

    def run(sc, batches):
        out = []
        for ev in batches:
            out.extend(sig(p) for p, _ in sc.finish(sc.submit(ev)))
        return out

    sc_b = scorer([("base", zoo_paths[ZOO_DOCS // 2])], False)
    sc_s = scorer([(n, zoo_paths[i % ZOO_DOCS])
                   for i, n in enumerate(hot)], False)
    sc_z = scorer([(n, zoo_paths[i % ZOO_DOCS])
                   for i, n in enumerate(names)], True)
    wait_warm(sc_b, ["base"])
    wait_warm(sc_s, hot)
    wait_warm(sc_z, names)
    t_warm = time.perf_counter() - t0

    def settle():
        gc.collect()
        gc.freeze()

    base_batches = [_zoo_events(data, fields, "base", i, ZOO_BATCH)
                    for i in range(0, total, ZOO_BATCH)]
    run(sc_b, base_batches[:4])
    settle()
    tb = time.perf_counter()
    run(sc_b, base_batches)
    base_rps = total / (time.perf_counter() - tb)

    run(sc_s, rounds[:1])
    settle()
    ts = time.perf_counter()
    solo = run(sc_s, rounds)
    solo_rps = total / (time.perf_counter() - ts)

    run(sc_z, rounds[:1])  # plan, pack builds and warm launches
    settle()
    packed0 = qtrees_cuda.leaf_rows_packed.launches
    solo0 = qtrees_cuda.leaf_rows.launches_by_classes.get(1, 0)
    # the main path of this phase: counts zeroed just before it
    qtrees_cuda.leaf_rows_packed.launches = 0
    qtrees_cuda.leaf_rows_packed.launches_by_classes = {}
    qtrees_cuda.leaf_rows.launches = 0
    qtrees_cuda.leaf_rows.launches_by_classes = {}
    tz = time.perf_counter()
    zoo = run(sc_z, rounds)
    zoo_rps = total / (time.perf_counter() - tz)
    packed_launches = qtrees_cuda.leaf_rows_packed.launches
    solo_launches = qtrees_cuda.leaf_rows.launches_by_classes.get(1, 0)
    c = sc_z.metrics.struct_snapshot()["counters"]
    if len(zoo) != total or len(solo) != total:
        raise RuntimeError(f"zoo drill lost records: {len(zoo)}, "
                           f"{len(solo)} of {total}")
    mismatches = sum(1 for a, b in zip(zoo, solo) if a != b)
    empties = sum(1 for a in zoo if a is None)
    if mismatches or not c.get("pack_dispatches") or not packed_launches:
        raise RuntimeError(f"zoo drill: {mismatches} of {total} differ from "
                           f"the solo oracle, pack_dispatches "
                           f"{c.get('pack_dispatches')}, packed launches "
                           f"{packed_launches}")
    # a device fault at a pack's readback: every member re-dispatches
    # and the round still equals the oracle
    before = c.get("redispatch_records", 0)
    faults.inject("device_error", site="device_readback", n=1)
    try:
        fault_sigs = run(sc_z, rounds[:1])
        fired = faults.stats()
    finally:
        faults.clear()
    after = sc_z.metrics.struct_snapshot()["counters"].get(
        "redispatch_records", 0)
    n0 = len(rounds[0])
    if fired != {"device_error": 1} or after <= before or \
            fault_sigs != solo[:n0]:
        raise RuntimeError(f"zoo drill fault: fired {fired}, redispatched "
                           f"{after - before}, parity "
                           f"{fault_sigs == solo[:n0]}")
    # the rollout plane keyed per tenant: one hot tenant's canary (a byte
    # copy of its document, 30% of its keys) books candidate records
    rt = hot[0]
    cand = os.path.join(workdir, "zoo_canary.pmml")
    shutil.copyfile(zoo_paths[0], cand)
    sc_z._control.push(RolloutMessage(rt, 2, "canary", time.time(),
                                      path=cand, fraction=0.3))
    sc_z._drain_control()
    wait_for(lambda: sc_z.registry.model_if_warm(ModelId(rt, 2)) is not None,
             f"{rt} v2 warm", timeout=600.0)
    canary_sigs = run(sc_z, [_zoo_events(data, fields, rt, i * ZOO_BATCH,
                                         ZOO_BATCH) for i in range(4)])
    cand_records = sc_z.metrics.struct_snapshot()["counters"].get(
        f'rollout_candidate_records{{model="{rt}"}}', 0)
    if not cand_records or any(v is None for v in canary_sigs):
        raise RuntimeError(f"zoo canary: {cand_records} candidate records")
    sc_z._control.push(RolloutMessage(rt, 2, "rollback", time.time()))
    sc_z._drain_control()
    # the drift plane keyed per served document, on the same scorer
    drift.install(sc_z.metrics, interval_s=0.0, budget_frac=0)
    run(sc_z, rounds[:1])
    sketches = sc_z.metrics.struct_snapshot().get("sketches") or {}
    drift_docs = {m.group(1) for m in (drift._PRED_SKETCH.match(k)
                                       for k in sketches) if m}
    if len(drift_docs) < 2:
        raise RuntimeError(f"zoo drift: {len(drift_docs)} documents sketched")
    gauges = sc_z.metrics.struct_snapshot().get("gauges") or {}
    snap = sc_z._zoo.snapshot()
    return {
        "seconds": time.perf_counter() - t0, "warm_seconds": t_warm,
        "registered": ZOO_REGISTERED, "hot": ZOO_HOT,
        "distinct_documents": ZOO_DOCS, "records": total,
        "batch": ZOO_BATCH,
        "baseline_rps": base_rps, "solo_multi_rps": solo_rps,
        "zoo_rps": zoo_rps, "zoo_vs_baseline": zoo_rps / base_rps,
        # the JAX drill asserts >= 0.75; printed beside it, not a gate
        "jax_gate_zoo_vs_baseline": 0.75,
        "parity_mismatches": mismatches, "empty_predictions": empties,
        "pack_dispatches": int(c.get("pack_dispatches", 0)),
        "launches_packed": packed_launches,
        "launches_solo_c1": solo_launches,
        "launches_before_drill": {"packed": packed0, "solo_c1": solo0},
        "pack_occupancy": (gauges.get("pack_occupancy") or {}).get("value"),
        "pack_pad_waste": (gauges.get("pack_pad_waste") or {}).get("value"),
        "resident_packs": snap["resident_packs"],
        "zoo_tenants": snap["tenants"],
        "fault_redispatched": after - before,
        "rollout_candidate_records": cand_records,
        "drift_documents": len(drift_docs),
    }


STATE_WORKER = r"""
import os, sys, time
import numpy as np
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline, FiniteBlockSource
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.state import StateSpec
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

pmml, ckdir, outpath = sys.argv[1:4]
seed, records, keys, capacity, B, feats = map(int, sys.argv[4:10])
# every incarnation makes the same stream from the seed
rng = np.random.default_rng(seed)
data = rng.normal(0.0, 1.0, size=(records, feats)).astype(np.float32)
data[:, 0] = ((rng.zipf(1.3, size=records) - 1) % keys).astype(np.float32)
cm = compile_pmml(parse_pmml_file(pmml), batch_size=B)
pipe = BlockPipeline(
    # one B-record block a dispatch: a restore at a committed offset
    # replays the batches of the single life
    FiniteBlockSource(data, block_size=B), cm, lambda out, n, off: None,
    RuntimeConfig(batch=BatchConfig(size=B, deadline_us=5_000_000),
                  checkpoint_interval_s=0.05),
    checkpoint=CheckpointManager(ckdir), max_dispatch_chunks=1,
    state=StateSpec(capacity=capacity, key_col=0))
pipe.restore()
pipe.start()
while pipe.committed_offset < records and pipe.error is None:
    time.sleep(0.02)
pipe.stop()
pipe.join(timeout=60.0)
tbl = pipe._state
np.savez(outpath + ".tmp", values=tbl.host_values(),
         applied_hi=np.int64(tbl.applied_hi), device=str(tbl.device))
os.replace(outpath + ".tmp.npz", outpath)
"""


def kill_parity(workdir: str, pmml: str, seed: int) -> dict:
    """The JAX ``_stateful_kill_parity`` at its sizes, with the workers on
    the card: the same keyed stream through a checkpointed, state-armed
    ``BlockPipeline`` once uninterrupted and once SIGKILLed twice, each
    incarnation restoring from the newest checkpoint; the two final tables
    must be the same bytes. A 20 ms ``dispatch_delay`` a dispatch keeps
    the stream long enough for the kills to land mid-stream."""
    import signal

    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager

    here = os.path.dirname(os.path.abspath(__file__))

    def committed(ckdir) -> int:
        try:
            st = CheckpointManager(ckdir).load_latest()
            return int(st["source_offset"]) if st else 0
        except Exception:
            return 0

    def spawn(tag):
        ckdir = os.path.join(workdir, f"ck-{tag}")
        out = os.path.join(workdir, f"state-{tag}.npz")
        env = dict(os.environ, FJT_FAULTS="dispatch_delay:delay_ms=20")
        argv = [sys.executable, "-c", STATE_WORKER, pmml, ckdir, out,
                str(seed), str(KILL_RECORDS), str(KILL_KEYS),
                str(KILL_CAPACITY), str(KILL_BATCH), "8"]
        err = os.path.join(workdir, f"worker-{tag}.err")

        def start():
            # stderr to a file: a pipe left unread could fill and stall
            # the worker
            with open(err, "ab") as f:
                return subprocess.Popen(argv, cwd=here, env=env,
                                        stdout=subprocess.DEVNULL, stderr=f)
        return ckdir, out, start

    procs = []
    try:
        ref_ck, ref_out, ref_start = spawn("ref")
        ref = ref_start()
        procs.append(ref)
        kill_ck, kill_out, kill_start = spawn("kill")
        targets = [KILL_RECORDS * (i + 1) // (KILLS + 1)
                   for i in range(KILLS)]
        incarnations = kills = 0
        deadline = time.monotonic() + 300.0
        while True:
            proc = kill_start()
            procs.append(proc)
            incarnations += 1
            if targets:
                while (proc.poll() is None
                       and committed(kill_ck) < targets[0]
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                if proc.poll() is None and time.monotonic() < deadline:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=30)
                    kills += 1
                    targets.pop(0)
                    continue
            proc.wait(timeout=max(deadline - time.monotonic(), 5.0))
            break
        ref.wait(timeout=max(deadline - time.monotonic(), 5.0))
        for p, tag in ((ref, "ref"), (proc, "kill")):
            if p.returncode != 0:
                with open(os.path.join(workdir, f"worker-{tag}.err")) as f:
                    tail = f.read()[-1500:]
                raise RuntimeError(f"stateful worker ({tag}) rc "
                                   f"{p.returncode}: {tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    a, b = np.load(ref_out), np.load(kill_out)
    same = a["values"].tobytes() == b["values"].tobytes()
    if (kills != KILLS or not same or int(a["applied_hi"]) != KILL_RECORDS
            or int(b["applied_hi"]) != KILL_RECORDS
            or not str(a["device"]).startswith("cuda")):
        raise RuntimeError(f"kill parity: kills {kills}, same bytes {same}, "
                           f"applied_hi {int(a['applied_hi'])} / "
                           f"{int(b['applied_hi'])}, device {a['device']}")
    return {"records": KILL_RECORDS, "keys": KILL_KEYS,
            "capacity": KILL_CAPACITY, "batch": KILL_BATCH, "kills": kills,
            "incarnations": incarnations, "device": str(a["device"]),
            "parity_mismatch_bytes": 0}


def stateful_drill(workdir: str) -> dict:
    """The JAX stateful drill's geometry (bench.py run_stateful_bench) on
    the card: gen_gbm(20, depth=4, 8 features, seed 29), batch 8,192, a
    2^21-row table (64 MiB on the card), 10,000,000 keys, a sweep and a
    zipf a = 1.1 mix of 10,485,760 records each through
    ``dispatch_quantized(state=)``, against the stateless loop; the zipf
    stream twice more, the two tables the same bytes; a 262,144-record
    prefix in batches and in dispatches of STATE_GROUP batches, both
    tables the same bytes as each other and as the CPU port's (the fold
    runs in record order and the routing a compile batch at a time,
    whatever the grouping); then the SIGKILL replay."""
    import torch

    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file
    from flink_jpmml_tpu_torch.runtime.engine import new_staging
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized
    from flink_jpmml_tpu_torch.runtime.state import (
        COL_COUNT,
        KeyedStateTable,
        StateSpec,
    )
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    t0 = time.perf_counter()
    pmml = gen_gbm(workdir, n_trees=20, depth=4, n_features=8, seed=29,
                   name="stateful.pmml")
    doc = parse_pmml_file(pmml)
    q = compile_pmml(doc, batch_size=STATE_BATCH).quantized_scorer()
    rng = np.random.default_rng(29)
    pool_n = 64 * STATE_BATCH
    pool = rng.normal(0.0, 1.0, (pool_n, 8)).astype(np.float32)
    n_batches = STATE_RECORDS // STATE_BATCH
    zipf = ((rng.zipf(1.1, size=STATE_RECORDS) - 1) % STATE_KEYS).astype(
        np.int64)

    def sweep(off):
        return (np.arange(off, off + STATE_BATCH, dtype=np.int64)
                * _PERM) % STATE_KEYS

    spec = StateSpec(capacity=STATE_CAPACITY, key_col=0)
    stream = torch.cuda.Stream()
    staging = new_staging(q.device)

    def run_mix(key_fn, table, batches=n_batches) -> float:
        with torch.cuda.stream(stream):
            window = []
            t = time.perf_counter()
            for b in range(batches):
                off = b * STATE_BATCH
                X = pool[off % pool_n: off % pool_n + STATE_BATCH]
                kw = {} if table is None else {
                    "state": table, "state_keys": key_fn(off),
                    "offsets": np.arange(off, off + STATE_BATCH,
                                         dtype=np.int64)}
                window.append(dispatch_quantized(q, X, staging=staging, **kw))
                if len(window) > 2:  # two batches in flight
                    window.pop(0).synchronize()
            for w in window:
                w.synchronize()
            return batches * STATE_BATCH / (time.perf_counter() - t)

    warm = KeyedStateTable(spec)
    run_mix(sweep, warm, 2)
    run_mix(None, None, 2)
    del warm
    stateless = run_mix(None, None)
    reg_s, reg_z = MetricsRegistry(), MetricsRegistry()
    t_sweep = KeyedStateTable(spec, metrics=reg_s)
    sweep_rps = run_mix(sweep, t_sweep)
    t_zipf = KeyedStateTable(spec, metrics=reg_z)
    zipf_rps = run_mix(lambda off: zipf[off: off + STATE_BATCH], t_zipf)
    del t_sweep
    # the determinism check on the card: the zipf stream again, the same
    # bytes (every key repeats within its batches, so the sums' order
    # of adds is exercised)
    t_again = KeyedStateTable(spec)
    run_mix(lambda off: zipf[off: off + STATE_BATCH], t_again)
    first, again = t_zipf.host_values(), t_again.host_values()
    deterministic = (first.tobytes() == again.tobytes()
                     and np.array_equal(t_zipf._keys, t_again._keys))
    del t_again
    if not deterministic:
        raise RuntimeError("the zipf stream run twice on the card gave "
                           "two different tables")
    cs = reg_s.struct_snapshot()
    cz = reg_z.struct_snapshot()
    if (cs["counters"].get("state_records") != STATE_RECORDS
            or cz["counters"].get("state_records") != STATE_RECORDS
            or cs["gauges"]["state_occupancy_frac"]["value"] <= 0.95
            or not cs["counters"].get("state_evictions")):
        raise RuntimeError(f"stateful mixes: {cs['counters']} / "
                           f"{cz['counters']}")
    # a prefix of the zipf stream on the card in batches and in dispatches
    # of STATE_GROUP batches, and on the CPU port in batches: three tables
    # of the same bytes
    q_cpu = compile_pmml(doc, batch_size=STATE_BATCH,
                         device="cpu").quantized_scorer()
    card = KeyedStateTable(spec)
    grouped = KeyedStateTable(spec)
    cpu = KeyedStateTable(spec, device="cpu")
    run_mix(lambda off: zipf[off: off + STATE_BATCH], card,
            STATE_CPU_BATCHES)
    rows = STATE_GROUP * STATE_BATCH
    with torch.cuda.stream(stream):
        for off in range(0, STATE_CPU_BATCHES * STATE_BATCH, rows):
            dispatch_quantized(
                q, pool[off % pool_n: off % pool_n + rows], staging=staging,
                state=grouped, state_keys=zipf[off: off + rows],
                offsets=np.arange(off, off + rows, dtype=np.int64),
            ).synchronize()
    for b in range(STATE_CPU_BATCHES):
        off = b * STATE_BATCH
        dispatch_quantized(
            q_cpu, pool[off % pool_n: off % pool_n + STATE_BATCH],
            state=cpu, state_keys=zipf[off: off + STATE_BATCH],
            offsets=np.arange(off, off + STATE_BATCH, dtype=np.int64))
    cv, gv, pv = (t.host_values() for t in (card, grouped, cpu))
    repeats = int(np.count_nonzero(cv[:, COL_COUNT] > STATE_GROUP))
    tables_equal = {
        "grouped_vs_batches": bool(
            np.array_equal(grouped._keys, card._keys)
            and gv.tobytes() == cv.tobytes()),
        "cpu_vs_card": bool(np.array_equal(card._keys, cpu._keys)
                            and np.array_equal(card._occ, cpu._occ)
                            and cv.tobytes() == pv.tobytes()),
    }
    cpu_err = float(np.abs(np.nan_to_num(cv - pv, posinf=0.0,
                                         neginf=0.0)).max())
    if not all(tables_equal.values()):
        raise RuntimeError(f"state tables differ: {tables_equal}, largest "
                           f"card/CPU difference {cpu_err}")
    del grouped
    # where a state-armed batch's time goes: the host's slot routing of
    # one zipf batch, and one step on the card at the table's full size
    # (its operands' copies included), issued alone
    from flink_jpmml_tpu_torch.compile import statekernel

    probe = KeyedStateTable(spec)
    n_route = min(64, n_batches)
    t = time.perf_counter()
    for b in range(n_route):
        off = b * STATE_BATCH
        routed = probe.assign_slots(
            zipf[off: off + STATE_BATCH].astype(np.uint32),
            np.arange(off, off + STATE_BATCH, dtype=np.int64))
    route_ms = 1e3 * (time.perf_counter() - t) / n_route
    score = torch.zeros(STATE_BATCH, device=q.device)
    slots, reset, rel, w = routed
    step_ms = cuda_ms(lambda: statekernel._state_step(
        probe.values, score, slots, rel, w, reset, probe.scratch,
        spec.decay), 3, 20)
    del probe
    kill = kill_parity(workdir, pmml, 30)
    gs = {k: v.get("value") for k, v in cs["gauges"].items()}
    gz = {k: v.get("value") for k, v in cz["gauges"].items()}
    return {
        "seconds": time.perf_counter() - t0,
        "records_per_mix": STATE_RECORDS, "key_domain": STATE_KEYS,
        "capacity": STATE_CAPACITY, "table_bytes": STATE_CAPACITY * 32,
        "batch": STATE_BATCH, "trees": 20,
        "stateless_rps": stateless, "sweep_rps": sweep_rps,
        "zipf_rps": zipf_rps,
        "state_overhead_frac": max(0.0, 1.0 - zipf_rps / stateless),
        "sweep_overhead_frac": max(0.0, 1.0 - sweep_rps / stateless),
        "occupancy_frac": gs.get("state_occupancy_frac"),
        "zipf_hit_ratio": gz.get("state_hit_ratio"),
        "sweep_evictions": int(cs["counters"].get("state_evictions", 0)),
        "zipf_collisions": int(cz["counters"].get("state_collisions", 0)),
        "deterministic_bytes": deterministic,
        "split": {"host_route_ms_per_batch": route_ms,
                  "card_step_ms_per_batch": step_ms,
                  "stateless_ms_per_batch": 1e3 * STATE_BATCH / stateless,
                  "zipf_ms_per_batch": 1e3 * STATE_BATCH / zipf_rps},
        "cpu_check": {"records": STATE_CPU_BATCHES * STATE_BATCH,
                      "group_batches": STATE_GROUP,
                      "keys_past_group_size": repeats,
                      "bytes_equal": tables_equal,
                      "max_abs_diff": cpu_err},
        "kill_parity": kill,
    }


def zoo_state(workdir: str, smi: str) -> dict:
    """The ``zoo_state`` phase: the packed launch, the zoo drill and the
    stateful drill."""
    t0 = time.perf_counter()
    paths = zoo_doc_paths(workdir)
    pk = packed_kernel(workdir, paths)
    zoo = zoo_drill(workdir, paths)
    st = stateful_drill(workdir)
    return {"nvidia_smi": smi, "seconds": time.perf_counter() - t0,
            "packed_kernel": pk, "zoo": zoo, "stateful": st}


# -- the data-drift plane and staged rollouts (the kernel on both scorers) ----

RD_PHASE_RECORDS = 262_144  # records a drift-drill phase, in BATCH batches
RD_SHIFT_SIGMAS = 4.0  # the drift drill's shift of feature 1, in sigmas
RD_SIGMA = 1.5  # the records' N(0, 1.5)
RD_MIN_N = 500  # the fleet monitor's sample floor (the JAX drill's)
RD_PSI_ALARM = 0.25
RD_COST_DISPATCHES = 19  # the drift-cost drives' dispatches of DISPATCH
RD_COST_PAIRS = 3  # unarmed / armed pairs, alternating
RD_EVENTS = 131_072  # keyed events a rollout run
RD_FRACTION = 0.2  # the canary's share
RD_STATE_BATCHES = 8  # batches of BATCH through the stateful pipeline
RD_STATE_CAPACITY = 1 << 16
RD_STATE_KEYS = 50_000
# the guardrails of the rollout drill: every window the whole run, the
# spec's default sample floor (100: met by the records of a run; a run's 8
# to 24 latency observations a role stay under it, so the latency
# guardrail, a max of a few device spans, does not vote), no dwell (the
# drill ticks the controller by hand after each run)
RD_MIN_SAMPLES = 100
RD_WINDOW_S = 600.0


def rd_records(seed: int, n: int, F: int) -> np.ndarray:
    """N(0, 1.5) records with 20% missing cells (``features``), seeded."""
    return features(np.random.default_rng(seed), n, F)


def drift_drill(q, workdir: str) -> dict:
    """The JAX drift drill (bench.py run_drift_drill) at the main path's
    width on the card: two registries share the fused GBM scorer and
    score alternating batches of BATCH records through
    ``dispatch_quantized`` with the plane armed at interval 0 (budget
    off); phase 1 (262,144 records, seed 31) is snapshotted as the
    baseline through a ``BaselineStore`` on disk; phase 2 (262,144 more,
    seed 32) shifts feature 1 by 4 sigmas while a fleet ``DriftMonitor``
    windows the merged worker structs after every batch. Every armed
    batch is dispatched again unarmed and must give the same bytes."""
    import torch

    from flink_jpmml_tpu_torch.obs import drift
    from flink_jpmml_tpu_torch.runtime.engine import new_staging
    from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized
    from flink_jpmml_tpu_torch.utils.metrics import (
        MetricsRegistry,
        QuantileSketch,
        merge_structs,
    )

    t0 = time.perf_counter()
    if q.encode_placement != "fused":
        raise RuntimeError(f"drift drill on {q.encode_placement}, not fused")
    F = len(q.wire.fields)
    label = q.model_hash
    f_perturb, f_control = q.wire.fields[1], q.wire.fields[0]
    store = drift.BaselineStore(os.path.join(workdir, "drift_baselines"))
    regs = [MetricsRegistry(), MetricsRegistry()]
    planes = [drift.install(r, interval_s=0.0, budget_frac=0, store=store)
              for r in regs]
    for p in planes:
        p.monitor.min_n = RD_MIN_N

    def fleet_struct() -> dict:
        return merge_structs([r.struct_snapshot() for r in regs])

    fleet_gauges = MetricsRegistry()
    monitor = drift.DriftMonitor(
        struct_fn=fleet_struct, store=store, psi_alarm=RD_PSI_ALARM,
        psi_clear=RD_PSI_ALARM / 2.0, min_n=RD_MIN_N, window_s=300.0,
        dwell_s=0.0, interval_s=0.0, gauge_metrics=fleet_gauges)
    staging = new_staging(q.device)
    stream = torch.cuda.Stream()
    n_batches = RD_PHASE_RECORDS // BATCH
    compared = [0]

    def score_phase(seed: int, perturbed: bool, tick: bool):
        data = rd_records(seed, RD_PHASE_RECORDS, F)
        if perturbed:
            data[:, 1] += RD_SHIFT_SIGMAS * RD_SIGMA
        alarm_at = None
        with torch.cuda.stream(stream):
            for b in range(n_batches):
                reg = regs[b % len(regs)]
                X = data[b * BATCH:(b + 1) * BATCH]
                armed = dispatch_quantized(q, X, metrics=reg,
                                           staging=staging).result()
                armed = armed.numpy().copy()
                plain = dispatch_quantized(q, X, staging=staging).result()
                if armed.tobytes() != plain.numpy().tobytes():
                    raise RuntimeError(f"drift drill: armed batch {b} "
                                       "differs from the unarmed dispatch")
                compared[0] += 1
                # sink-side prediction sketching, as the pipelines do it
                drift.plane_for(reg).record_predictions(q, armed, BATCH)
                if tick:
                    for tr in monitor.tick():
                        if (alarm_at is None and tr["transition"] == "alarm"
                                and tr["feature"] == f_perturb):
                            alarm_at = b
        return alarm_at

    score_phase(31, False, tick=False)
    fleet = fleet_struct()
    payloads = drift.snapshot_from_struct(fleet)
    if label not in payloads or len(payloads[label]["features"]) != F:
        raise RuntimeError(f"drift drill: baseline incomplete {list(payloads)}")
    path = store.save(label, payloads[label])
    loaded = store.load(label)
    if loaded is None:
        raise RuntimeError("drift drill: baseline save / load failed")
    monitor.set_baseline(label, loaded)
    # the fleet merge equals merging the workers' states directly, bit
    # for bit
    states = [r.struct_snapshot().get("sketches") or {} for r in regs]
    checked = 0
    for name in sorted(set().union(*states)):
        per_worker = [s[name] for s in states if name in s]
        direct = QuantileSketch.from_state(per_worker[0])
        for st in per_worker[1:]:
            direct.merge(QuantileSketch.from_state(st))
        merged = QuantileSketch.from_state(fleet["sketches"][name])
        for qq in (0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99):
            if merged.quantile(qq) != direct.quantile(qq):
                raise RuntimeError(f"drift drill: fleet merge inexact for "
                                   f"{name} at q={qq}")
        checked += 1
    if checked < F + 1:
        raise RuntimeError(f"drift drill: {checked} sketches merged")

    alarm_batch = score_phase(32, True, tick=True)
    alarmed = {(a["model"], a["feature"]) for a in monitor.alarms()}
    feature_alarms = {f for (_, f) in alarmed if f is not None}
    scores = {f: s for (lbl, f), s in monitor.scores().items()
              if lbl == label}
    quiet = {f: scores.get(f) for f in q.wire.fields if f != f_perturb}
    if (label, f_perturb) not in alarmed or feature_alarms != {f_perturb}:
        raise RuntimeError(f"drift drill: alarms {sorted(feature_alarms)}, "
                           f"expected only {f_perturb}; scores {scores}")
    if any(s is None or s >= RD_PSI_ALARM for s in quiet.values()):
        raise RuntimeError(f"drift drill: an unshifted feature drifted "
                           f"{quiet}")
    return {
        "seconds": time.perf_counter() - t0, "model": label,
        "records_per_phase": RD_PHASE_RECORDS, "batch": BATCH,
        "shift": f"{RD_SHIFT_SIGMAS} sigma of feature {f_perturb}",
        "perturbed_feature": f_perturb, "control_feature": f_control,
        "alarm_batch": alarm_batch, "psi_perturbed": scores[f_perturb],
        "psi_control": scores[f_control],
        "psi_quiet_max": max(quiet.values()),
        "merge_exact": True, "sketches_checked": checked,
        "armed_batches_byte_equal": compared[0],
        "baseline_file": os.path.basename(path),
        "drift": drift.artifact_fields(fleet_gauges),
    }


def drift_cost(cm, q) -> dict:
    """The fused GBM's ``drive`` (19 dispatches of DISPATCH records, the
    main path's data) unarmed and with the drift plane installed on its
    registry (interval 0, the ``FJT_DRIFT_BUDGET`` budget: 2% unless set),
    in RD_COST_PAIRS alternating pairs. Each run samples its outputs at
    every 4,096th record offset below the target; every run's samples
    must be equal. The rate gap is a reading, not a gate; the plane's
    overhead must stay within its budget plus the one sample the gate can
    let through past it (the budget is checked before a sample, charged
    after)."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda
    from flink_jpmml_tpu_torch.obs import drift
    from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    F = len(q.wire.fields)
    data = rd_records(0, 4 * DISPATCH, F)
    target = RD_COST_DISPATCHES * DISPATCH
    step = 4096
    runs, samples = [], []
    for i in range(2 * RD_COST_PAIRS):
        armed = i % 2 == 1
        reg = MetricsRegistry()
        plane = None
        costs = []
        if armed:
            plane = drift.install(reg, interval_s=0.0)
            charge = plane._charge

            def _charge(cost, charge=charge):
                costs.append(cost)
                charge(cost)

            plane._charge = _charge
        seen = {}
        count = [0]

        def sink(out, n, first_off, seen=seen, count=count):
            vals = np.asarray(out)
            lo = -(-first_off // step) * step
            for off in range(lo, min(first_off + n, target), step):
                seen[off] = vals[off - first_off]
            count[0] += n

        run = drive(cm, CyclingBlockSource(data, block_size=DISPATCH), sink,
                    count, qtrees_cuda.leaf_rows, metrics=reg, target=target)
        row = {"armed": armed, "records": run["records"],
               "records_per_s": run["records_per_s"],
               "dispatches": run["dispatches"], "launches": run["launches"],
               "encode_ms_per_dispatch": run["encode_ms_per_dispatch"]}
        if armed:
            st = plane.stats()
            frac = plane.overhead_fraction()
            budget = plane.budget_frac
            elapsed = st["spent_s"] / frac if frac else float("inf")
            slack = max(costs) / elapsed if costs else 0.0
            row.update(overhead_fraction=frac, budget=budget,
                       claimed_batches=st["sampled"], skipped=st["skipped"],
                       spent_s=st["spent_s"],
                       max_sample_ms=1e3 * max(costs) if costs else None,
                       one_sample_slack=slack)
            if not st["sampled"] or frac > budget + slack:
                raise RuntimeError(f"drift cost: overhead {frac} over the "
                                   f"budget {budget} + one sample {slack}")
        runs.append(row)
        samples.append(seen)
    want = set(range(0, target, step))
    for i, s in enumerate(samples):
        if set(s) != want:
            raise RuntimeError(f"drift cost: run {i} sampled "
                               f"{len(s)} of {len(want)} offsets")
        if any(s[k].tobytes() != samples[0][k].tobytes() for k in want):
            raise RuntimeError(f"drift cost: run {i} outputs differ")
    plain = [r["records_per_s"] for r in runs if not r["armed"]]
    armed = [r["records_per_s"] for r in runs if r["armed"]]
    return {"runs": runs, "sampled_offsets": len(want),
            "plain_records_per_s_median": statistics.median(plain),
            "armed_records_per_s_median": statistics.median(armed),
            "armed_over_plain": statistics.median(armed)
            / statistics.median(plain)}


def rollout_drill(workdir: str, gbm: str, q1, counter) -> dict:
    """The JAX rollout drill (bench.py run_rollout_drill) and the
    tests/test_rollout.py scenarios through ``DynamicScorer`` on the card
    at batch BATCH, each run RD_EVENTS keyed dict events (the main path's
    32 fields, N(0, 1.5), 20% missing left out, seed 33). ``v2`` is a
    byte copy of the served GBM (bit-identical outputs), ``v3`` the same
    generator at seed 12. Runs: ``plain`` (v1 alone), ``shadow`` (v2 in
    shadow: one more launch a batch, nothing emitted from it), then a
    controller tick must promote to canary; ``canary`` (the split at
    RD_FRACTION within 1% absolute), then a fresh scorer restored from
    the checkpoint mid-canary must resume the stage and give the same
    bytes; a tick promotes to full; ``rollback``, on a fresh scorer
    serving v1 (the controller's counters are per model name, and a
    window still holding v2's canary would judge v3 on them): v3 in
    canary, every emitted prediction equal to its serving version's
    direct launch, then a tick rolls it back for disagreement, and one
    more batch is all v1. The controller is ticked by hand
    (``auto_rollout=False``) where a live one would tick: once when a
    rollout starts (the window's baseline) and after each run (the
    verdict), on the guardrails RD_MIN_SAMPLES / RD_WINDOW_S with no
    dwell, so each verdict reads its own run. In shadow the two roles'
    median latency spans must agree within 2x: the mirror is the same
    document on the same rows."""
    import torch

    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.models.control import (
        AddMessage,
        RolloutMessage,
    )
    from flink_jpmml_tpu_torch.models.core import ModelId
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file
    from flink_jpmml_tpu_torch.rollout import split as rsplit
    from flink_jpmml_tpu_torch.rollout.state import GuardrailSpec
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

    t0 = time.perf_counter()
    v2 = os.path.join(workdir, "rollout_v2.pmml")
    shutil.copyfile(gbm, v2)
    v3 = gen_gbm(workdir, n_trees=500, seed=12, name="rollout_v3.pmml")
    q3 = compile_pmml(parse_pmml_file(v3), batch_size=BATCH).quantized_scorer()
    spec = GuardrailSpec(min_samples=RD_MIN_SAMPLES, window_s=RD_WINDOW_S,
                         promote_after_s=0.0, canary_fraction=RD_FRACTION)
    fields = [f"f{j}" for j in range(32)]
    X = rd_records(33, RD_EVENTS, 32)
    events = [("gbm", dict(r, _key=f"k{i}"))
              for i, r in enumerate(dict_rows(X, fields))]
    keys = [e[1]["_key"] for e in events]

    def scorer():
        ctrl = ControlSource()
        return ctrl, DynamicScorer(control=ctrl, batch_size=BATCH,
                                   auto_rollout=False, guardrails=spec)

    def warm(sc, version):
        wait_for(lambda: sc.registry.model_if_warm(ModelId("gbm", version))
                 is not None, f"gbm v{version} warm")

    def run(sc, evs=events):
        t = time.perf_counter()
        vals = []
        for off in range(0, len(evs), BATCH):
            out = sc.finish(sc.submit(evs[off:off + BATCH]))
            vals.extend(np.nan if p.is_empty else p.score.value
                        for p, _ in out)
        dt = time.perf_counter() - t
        vals = np.asarray(vals, np.float32)
        if vals.shape != (len(evs),) or not np.isfinite(vals).all():
            raise RuntimeError(f"rollout drill: {vals.shape} outputs for "
                               f"{len(evs)} events, or empty lanes")
        return vals, len(evs) / dt

    def counters(sc):
        c = sc.metrics.struct_snapshot()["counters"]
        return {k: c.get(f'rollout_{k}{{model="gbm"}}', 0.0) for k in (
            "candidate_records", "incumbent_records", "shadow_compared",
            "shadow_disagree", "candidate_errors")}

    def baseline_tick(sc):
        # the tick a live controller makes at the next submit: no verdict
        # on an empty window, its frame the baseline of the next one
        d = sc.rollout_controller.tick()
        if d:
            raise RuntimeError(f"rollout drill: a verdict on no traffic {d}")

    def latencies(sc):
        h = sc.metrics.snapshot()
        return {f"{r}_{t}": h.get(f'rollout_{r}_latency_s{{model="gbm"}}_{t}')
                for r in ("candidate", "incumbent") for t in ("p50", "p99")}

    # the serving versions' direct launches on the card (host encode, one
    # launch per DISPATCH records), before the counted runs
    direct1 = direct_rows(q1, X).astype(np.float32)
    direct3 = direct_rows(q3, X).astype(np.float32)

    def held(vals, ref, label):
        err = float(np.abs(vals - ref).max())
        if not np.allclose(vals, ref, rtol=RTOL, atol=ATOL):
            raise RuntimeError(f"rollout drill {label}: outputs differ from "
                               f"the direct launch by {err}")
        return err

    ctrl, sc = scorer()
    ctrl.push(AddMessage("gbm", 1, gbm, timestamp=time.time()))
    sc.finish(sc.submit([]))
    warm(sc, 1)
    run(sc, events[:BATCH])  # first launches outside the timed runs
    out = {}
    base = counter.launches_by_classes.get(1, 0)

    # -- plain: v1 alone ------------------------------------------------
    l0 = counter.launches
    vals, rate = run(sc)
    out["plain"] = {"records_per_s": rate,
                    "launches": counter.launches - l0,
                    "max_abs_err": held(vals, direct1, "plain")}

    # -- shadow: v2 mirrored, never emitted -----------------------------
    ctrl.push(RolloutMessage("gbm", 2, "shadow", time.time(), path=v2))
    sc.finish(sc.submit([]))
    warm(sc, 2)
    baseline_tick(sc)
    c0, l0 = counters(sc), counter.launches
    vals, rate = run(sc)
    c1 = counters(sc)
    launches = counter.launches - l0
    batches = RD_EVENTS // BATCH
    if (c1["candidate_records"] != c0["candidate_records"]
            or c1["shadow_compared"] - c0["shadow_compared"] != RD_EVENTS
            or c1["shadow_disagree"] or launches != 2 * batches):
        raise RuntimeError(f"rollout drill shadow: {c0} -> {c1}, "
                           f"{launches} launches for {batches} batches")
    d1 = sc.rollout_controller.tick()
    if [d["stage"] for d in d1] != ["canary"]:
        raise RuntimeError(f"rollout drill: shadow did not promote: {d1}")
    # both roles on one bracket: the mirror is the same document on the
    # same rows, so the two roles' median spans read the same device work
    lat = latencies(sc)
    if not (0.5 <= lat["candidate_p50"] / lat["incumbent_p50"] <= 2.0):
        raise RuntimeError(f"rollout drill: the roles' spans disagree {lat}")
    out["shadow"] = {"records_per_s": rate, "launches": launches,
                     "shadow_compared": c1["shadow_compared"]
                     - c0["shadow_compared"], "shadow_disagree": 0,
                     "leakage": 0, "latency_s": latencies(sc),
                     "max_abs_err": held(vals, direct1, "shadow"),
                     "decision": d1[0]["reason"]}

    # -- canary: the split, then a restore mid-canary --------------------
    st = sc.registry.rollout("gbm")
    c0 = counters(sc)
    vals, rate = run(sc)
    c1 = counters(sc)
    cand = c1["candidate_records"] - c0["candidate_records"]
    share = cand / RD_EVENTS
    expect = sum(rsplit.assign_candidate("gbm", 2, RD_FRACTION, k)
                 for k in keys)
    if abs(share - RD_FRACTION) > 0.01 or cand != expect:
        raise RuntimeError(f"rollout drill canary: share {share}, "
                           f"{cand} candidate records, {expect} expected")
    if c1["shadow_disagree"] != c0["shadow_disagree"]:
        raise RuntimeError("rollout drill canary: a byte copy disagreed")
    canary_err = held(vals, direct1, "canary")
    state = sc.state()
    ctrl2, sc2 = scorer()
    sc2.restore(state)
    st2 = sc2.registry.rollout("gbm")
    if (st2 is None or st2.stage != "canary" or st2.fraction != st.fraction
            or st2.stage_since != st.stage_since):
        raise RuntimeError(f"rollout drill restore: {st2} vs {st}")
    warm(sc2, 1)
    warm(sc2, 2)
    vals2, _ = run(sc2)
    if (vals2.tobytes() != vals.tobytes()
            or counters(sc2)["candidate_records"] != cand):
        raise RuntimeError("rollout drill restore: the restored scorer "
                           "routed or scored differently")
    del sc2
    d2 = sc.rollout_controller.tick()
    if ([d["stage"] for d in d2] != ["full"]
            or sc.registry.resolve("gbm") != ModelId("gbm", 2)):
        raise RuntimeError(f"rollout drill: canary did not promote: {d2}")

    out["canary"] = {"records_per_s": rate, "fraction": RD_FRACTION,
                     "candidate_records": cand, "share": share,
                     "latency_s": latencies(sc), "max_abs_err": canary_err,
                     "restored_stage_since": st2.stage_since,
                     "restored_byte_equal": True,
                     "decision": d2[0]["reason"]}

    # -- rollback: a disagreeing candidate under canary, on a fresh scorer:
    # the controller's counters are per model name, so a window that
    # still held v2's canary records would judge v3 on them
    ctrl, sc = scorer()
    ctrl.push(AddMessage("gbm", 1, gbm, timestamp=time.time()))
    sc.finish(sc.submit([]))
    warm(sc, 1)
    ctrl.push(RolloutMessage("gbm", 3, "canary", time.time(), path=v3,
                             fraction=RD_FRACTION))
    sc.finish(sc.submit([]))
    warm(sc, 3)
    baseline_tick(sc)
    vals, rate = run(sc)
    side = np.array([rsplit.assign_candidate("gbm", 3, RD_FRACTION, k)
                     for k in keys])
    err = held(vals, np.where(side, direct3, direct1), "rollback canary")
    d3 = sc.rollout_controller.tick()
    if ([d["action"] for d in d3] != ["rollback"]
            or "disagreement" not in d3[0]["reason"]
            or sc.registry.resolve("gbm") != ModelId("gbm", 1)
            or sc.registry.resolve("gbm", 3) is not None):
        raise RuntimeError(f"rollout drill: v3 not rolled back: {d3}")
    after, _ = run(sc, events[:BATCH])
    held(after, direct1[:BATCH], "after rollback")
    out["rollback"] = {"records_per_s": rate, "max_abs_err": err,
                       "candidate_share": float(side.mean()),
                       "latency_s": latencies(sc),
                       "decision": d3[0]["reason"]}
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, events_per_run=RD_EVENTS,
               launches=counter.launches_by_classes.get(1, 0) - base,
               guardrails={"min_samples": RD_MIN_SAMPLES,
                           "window_s": RD_WINDOW_S, "promote_after_s": 0.0,
                           "max_disagree_rate": spec.max_disagree_rate,
                           "max_latency_ratio": spec.max_latency_ratio})
    return out


def drift_state(q, cm) -> dict:
    """One stateful fused GBM ``BlockPipeline`` run (RD_STATE_BATCHES
    batches of BATCH records, a 2^16-slot table keyed by feature 0, which
    holds integer keys) unarmed and again with the drift plane armed: the
    armed run sketches ``<model_hash>#state`` and both leave the same
    table bytes and outputs."""
    from flink_jpmml_tpu_torch.obs import drift
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.state import StateSpec
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    F = len(q.wire.fields)
    rng = np.random.default_rng(34)
    data = rd_records(34, RD_STATE_BATCHES * BATCH, F)
    data[:, 0] = rng.integers(0, RD_STATE_KEYS, len(data)).astype(np.float32)
    label = f"{q.model_hash}#state"

    def one(armed: bool):
        reg = MetricsRegistry()
        if armed:
            drift.install(reg, interval_s=0.0, budget_frac=0)
        outs = []
        pipe = BlockPipeline(
            FiniteBlockSource(data, block_size=BATCH), cm,
            lambda out, n, off: outs.append(np.asarray(out)[:n].copy()),
            metrics=reg, max_dispatch_chunks=1,
            state=StateSpec(capacity=RD_STATE_CAPACITY, key_col=0))
        pipe.run_until_exhausted(timeout=120.0)
        if pipe.error is not None:
            raise RuntimeError(f"stateful run failed: {pipe.error!r}")
        return (np.concatenate(outs), pipe._state.host_values(),
                reg.struct_snapshot().get("sketches") or {})

    out0, table0, sk0 = one(False)
    out1, table1, sk1 = one(True)
    series = sorted(k for k in sk1 if f'model="{label}"' in k)
    if (out0.tobytes() != out1.tobytes()
            or table0.tobytes() != table1.tobytes()):
        raise RuntimeError("stateful run: the armed plane changed the "
                           "outputs or the table")
    if len(series) != 8 or sk0:
        raise RuntimeError(f"stateful run: {len(series)} #state sketches, "
                           f"{len(sk0)} unarmed")
    return {"records": len(data), "batches": RD_STATE_BATCHES,
            "capacity": RD_STATE_CAPACITY, "label": label,
            "state_sketches": len(series),
            "state_count_n": sk1[series[0]]["n"],
            "table_bytes_equal": True, "outputs_byte_equal": True}


def rollout_drift(workdir: str, cm, q, smi: str) -> dict:
    """The ``rollout_drift`` phase: the drift drill, its cost on the fused
    main path, the rollout drill and the stateful run. The launches of
    ``qtrees_leaf_rows`` (C = 1) are counted from zero over the drills'
    dispatches, the reference launches they are held to left out."""
    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    t0 = time.perf_counter()
    counter = qtrees_cuda.leaf_rows
    reset(counter)
    dd = drift_drill(q, workdir)
    dd["launches"] = counter.launches_by_classes.get(1, 0)
    dc = drift_cost(cm, q)
    rd = rollout_drill(workdir, os.path.join(workdir, "gbm_500.pmml"), q,
                       counter)
    before = counter.launches_by_classes.get(1, 0)
    ds = drift_state(q, cm)
    ds["launches"] = counter.launches_by_classes.get(1, 0) - before
    launches = (dd["launches"] + sum(r["launches"] for r in dc["runs"])
                + rd["launches"] + ds["launches"])
    if not (dd["launches"] and rd["launches"] and ds["launches"]):
        raise RuntimeError("rollout_drift: a part launched no kernel")
    return {"nvidia_smi": smi, "seconds": time.perf_counter() - t0,
            "drift_drill": dd, "drift_cost": dc, "rollout": rd,
            "state": ds, "launches_c1": launches}


# -- the parallel plane on the card's 1x1 mesh (no kernel on these paths) ----

MESH_GBM_RECORDS = 16 * BATCH  # the main-path GBM on the f32 path
MESH_DYN_BATCHES = 8  # config 5 batches through the dynamic pipeline
MESH_STATE_BATCHES = 32
MESH_STATE_CAPACITY = 1 << 20


def _same_outputs(a, b) -> bool:
    """Two ModelOutputs with the same fields, tensor for tensor equal."""
    import torch

    return all((x is None) == (y is None)
               and (x is None or torch.equal(x.cpu(), y.cpu()))
               for x, y in zip(a, b))


def mesh_config5(workdir: str, mesh) -> dict:
    """BASELINE config 5 through ``BlockPipeline`` unsharded and with
    ``mesh=`` on the same data (``family_paths``' records): heads equal,
    both held to the CPU port."""
    from flink_jpmml_tpu_torch import assets_gen as ag
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.parallel.sharding import ShardedModel
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    name, path, batch, target = next(
        c for c in family_configs(workdir) if c[0] == "stacked")
    t0 = time.perf_counter()
    doc = parse_pmml_file(path)
    cm = compile_pmml(doc, batch_size=batch)
    sm = compile_pmml(doc, batch_size=batch, mesh=mesh)
    cm_cpu = compile_pmml(doc, batch_size=batch, device="cpu")
    setup_s = time.perf_counter() - t0
    if not isinstance(sm, ShardedModel) or sm.tp_sharded_leaves != ():
        raise RuntimeError(f"config 5 on the 1x1 mesh: {type(sm).__name__}, "
                           f"TP leaves {sm.tp_sharded_leaves}")
    if sm.quantized_scorer() is not None or sm.batch_divisor != 1:
        raise RuntimeError("config 5 sharded: a rank wire or a data axis")
    F = cm.field_space.arity
    rng = np.random.default_rng(6)
    rows = max(batch, min(DISPATCH, 2 ** 26 // (4 * F)) // batch * batch)
    data = rng.standard_normal(size=(rows, F), dtype=np.float32) * 1.5
    miss = rng.random(size=data.shape, dtype=np.float32) < MISSING
    miss &= (rng.random(size=(rows, 1)) < MISSING)
    data[miss] = np.nan
    sample = min(4096, batch)
    Z = (np.zeros((batch, F), np.float32), np.zeros((batch, F), bool))
    cm.predict(*Z)  # warm the card's path
    sm.predict(*Z)
    # in turns (unsharded, sharded, sharded, unsharded): one call's
    # host moves from run to run, so the pairs bracket each other
    runs = {"unsharded": [], "sharded": []}
    heads = []
    for key in ("unsharded", "sharded", "sharded", "unsharded"):
        run, head = (drive_f32(cm, data, target, sample) if key ==
                     "unsharded" else drive_f32(sm, data, target, sample,
                                                mesh=mesh))
        runs[key].append(run)
        heads.append(head)
    if not all(_same_outputs(h, heads[0]) for h in heads[1:]):
        raise RuntimeError("config 5 on the 1x1 mesh differs from the "
                           "unsharded model on the card")
    head = heads[1]
    Xh = data[:sample]
    Mh = np.isnan(Xh)
    ref = cm_cpu.predict(np.where(Mh, 0.0, Xh).astype(np.float32), Mh)
    return {"config": name, "parse_compile_s": setup_s,
            "tp_sharded_leaves": list(sm.tp_sharded_leaves),
            "heads_equal_unsharded": True,
            "cpu_check": check_outputs(head, ref, name), **runs}


def mesh_gbm(workdir: str, mesh) -> dict:
    """The main-path GBM on the f32 path through ``BlockPipeline(mesh=)``,
    its head held to the CPU port."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    doc = parse_pmml_file(gen_gbm(workdir, n_trees=500,
                                  name="gbm_500_mesh.pmml"))
    cm = compile_pmml(doc, batch_size=BATCH)
    cm_cpu = compile_pmml(doc, batch_size=BATCH, device="cpu")
    F = cm.field_space.arity
    data = features(np.random.default_rng(0), 4 * BATCH, F)
    sample = 2048
    run, head = drive_f32(cm, data, MESH_GBM_RECORDS, sample, chunks=1,
                          mesh=mesh)
    Xh = data[:sample]
    Mh = np.isnan(Xh)
    ref = cm_cpu.predict(np.where(Mh, 0.0, Xh).astype(np.float32), Mh)
    return {"config": "gbm_500_f32", **run,
            "cpu_check": check_outputs(head, ref, "gbm_500 on the mesh")}


def mesh_tp(workdir: str, mesh) -> dict:
    """``TpLinearScorer`` and ``mp_gp`` at 1x1 against the plain product on
    the card (TF32 off)."""
    import torch

    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.parallel.sharding import TpLinearScorer, mp_gp
    from flink_jpmml_tpu_torch.pmml import parse_pmml

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on for float32 matmuls")
    rng = np.random.default_rng(21)
    W = rng.normal(0, 0.01, size=(10_000, 2)).astype(np.float32)
    b = rng.normal(0, 0.1, size=2).astype(np.float32)
    X = rng.normal(size=(2048, 10_000)).astype(np.float32)
    dev = mesh.primary
    Xd = torch.from_numpy(X).to(dev)
    plain = Xd @ torch.from_numpy(W).to(dev) + torch.from_numpy(b).to(dev)
    got = TpLinearScorer(mesh=mesh, W=W, b=b, link="identity").predict(X)
    if not torch.equal(got, plain):
        raise RuntimeError("TpLinearScorer at 1x1 differs from the plain "
                           "product on the card")
    logit = TpLinearScorer(mesh=mesh, W=W, b=b).predict(X).cpu().numpy()
    ref = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ W + b)))
    if not np.allclose(logit, ref, rtol=RTOL, atol=ATOL):
        raise RuntimeError("TpLinearScorer logit differs from float64")
    doc = parse_pmml(gp_xml())
    cm = compile_pmml(doc, batch_size=2048)
    Xg = rng.normal(0.0, 1.5, size=(2048, 8)).astype(np.float32)
    gp = mp_gp(mesh, doc.model)(Xg)
    want = cm.predict(Xg, np.zeros_like(Xg, bool)).value
    gp_err = float((gp - want).abs().max())
    if not torch.allclose(gp, want, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"mp_gp at 1x1 differs from the GP on the card: "
                           f"{gp_err}")
    return {"tp_linear_equal_plain": True,
            "tp_linear_logit_max_abs_err_f64":
                float(np.abs(logit - ref).max()),
            "mp_gp_max_abs_err": gp_err, "tf32": False}


def mesh_dynamic(workdir: str, mesh) -> dict:
    """``DynamicBlockPipeline(mesh=)`` warms config 5 sharded; every
    delivered batch equals the direct sharded run on the same rows."""
    import torch

    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.models.control import AddMessage
    from flink_jpmml_tpu_torch.parallel.sharding import ShardedModel
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file
    from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource
    from flink_jpmml_tpu_torch.runtime.sources import ControlSource
    from flink_jpmml_tpu_torch.serving.block import DynamicBlockPipeline
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    _, path, batch, _ = next(
        c for c in family_configs(workdir) if c[0] == "stacked")
    sm = compile_pmml(parse_pmml_file(path), batch_size=batch, mesh=mesh)
    F = sm.field_space.arity
    X = np.random.default_rng(31).normal(
        0.0, 1.5, size=(batch, F)).astype(np.float32)
    direct = sm.predict(X, np.zeros_like(X, bool))
    got, lock = [], threading.Lock()

    def sink(out, n, first_off, decode):
        with lock:
            got.append((first_off, n, decode.model_key, out))

    ctrl = ControlSource()
    pipe = DynamicBlockPipeline(
        CyclingBlockSource(X, block_size=batch), ctrl, sink, name="c5",
        arity=F, batch_size=batch,
        config=RuntimeConfig(batch=BatchConfig(
            size=batch, deadline_us=5_000_000, queue_capacity=4 * batch)),
        max_dispatch_chunks=1, mesh=mesh)
    t0 = time.perf_counter()
    ctrl.push(AddMessage("c5", 1, path, timestamp=1.0))
    pipe.start()
    try:
        wait_for(lambda: len(got) >= MESH_DYN_BATCHES or pipe.error,
                 "the dynamic pipeline's batches", timeout=300.0)
    finally:
        pipe.stop()
        pipe.join(timeout=60)
    dt = time.perf_counter() - t0
    if pipe.error is not None:
        raise pipe.error
    served = pipe._current.model
    if not isinstance(served, ShardedModel) or pipe.backend != "f32":
        raise RuntimeError(f"dynamic pipeline served {type(served)} on "
                           f"{pipe.backend}")
    for first_off, n, key, out in got:
        if first_off % batch or n != batch or key != "c5_1":
            raise RuntimeError(f"dynamic batch at {first_off} of {n} ({key})")
        if not _same_outputs(out, direct):
            raise RuntimeError(f"dynamic batch at {first_off} differs from "
                               "the direct sharded run")
    return {"batches": len(got), "records": sum(n for _, n, _, _ in got),
            "seconds_with_warm": dt, "served": type(served).__name__,
            "equal_direct": True,
            "cold_start_s": pipe.metrics.snapshot().get("cold_start_s_p50")}


def mesh_chip_loss(workdir: str, mesh) -> dict:
    """An injected ``chip_loss`` on the 1x1 mesh escalates with the raise:
    one data row, nothing to shrink onto (the single-chip contract)."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file
    from flink_jpmml_tpu_torch.runtime import faults
    from flink_jpmml_tpu_torch.runtime.block import (
        BlockPipeline,
        FiniteBlockSource,
    )
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig

    doc = parse_pmml_file(gen_gbm(workdir, n_trees=20, depth=4,
                                  name="gbm_20_mesh.pmml"))
    cm = compile_pmml(doc, batch_size=1024)
    X = features(np.random.default_rng(41), 16 * 1024,
                 cm.field_space.arity)
    delivered = []
    pipe = BlockPipeline(
        FiniteBlockSource(X, 1024), cm,
        lambda out, n, off: delivered.append((off, n)),
        RuntimeConfig(batch=BatchConfig(size=1024, deadline_us=5000),
                      checkpoint_interval_s=0.05),
        checkpoint=CheckpointManager(os.path.join(workdir, "mesh_ck")),
        max_dispatch_chunks=1, mesh=mesh)
    faults.clear()
    faults.inject("chip_loss", n=1)
    raised = None
    try:
        pipe.run_until_exhausted(timeout=120)
    except faults.InjectedChipLoss as e:
        raised = e
    finally:
        faults.clear()
    if raised is None:
        raise RuntimeError("chip_loss on the 1x1 mesh did not escalate")
    counters = pipe.metrics.struct_snapshot()["counters"]
    rebuilds = counters.get("mesh_rebuilds", 0)
    offs = [o + i for o, n in delivered for i in range(n)]
    if rebuilds != 0 or len(offs) != len(set(offs)):
        raise RuntimeError(f"chip_loss on the 1x1 mesh: {rebuilds} rebuilds, "
                           f"{len(offs) - len(set(offs))} duplicates")
    return {"escalated": type(raised).__name__, "mesh_rebuilds": rebuilds,
            "delivered_records": len(offs), "duplicates": 0}


def mesh_state(mesh) -> dict:
    """A keyed state table sharded on the 1x1 mesh against an unsharded
    one over the same stream: one tensor, the same bytes."""
    import torch

    from flink_jpmml_tpu_torch.compile import statekernel
    from flink_jpmml_tpu_torch.runtime.state import KeyedStateTable, StateSpec

    spec = StateSpec(capacity=MESH_STATE_CAPACITY)
    plain = KeyedStateTable(spec)
    sharded = KeyedStateTable(spec)
    sharded.shard(mesh)
    if not isinstance(sharded.values, torch.Tensor):
        raise RuntimeError("the 1x1 mesh split the state table")
    for t, seed in ((plain, 51), (sharded, 51)):
        rng = np.random.default_rng(seed)
        for b in range(MESH_STATE_BATCHES):
            keys = rng.zipf(1.1, STATE_BATCH) % (4 * MESH_STATE_CAPACITY)
            offs = np.arange(b * STATE_BATCH, (b + 1) * STATE_BATCH)
            slots, reset, rel, w = t.assign_slots(t.hash_keys(keys), offs)
            score = torch.from_numpy(rng.normal(
                size=STATE_BATCH).astype(np.float32)).to(t.device)
            _, _, S2 = statekernel.step_after(score, t, slots, rel, w, reset)
            t.commit(S2)
    a, b = plain.host_values(), sharded.host_values()
    if a.tobytes() != b.tobytes():
        raise RuntimeError("the sharded state table differs from the "
                           "unsharded one")
    return {"capacity": spec.capacity, "rows": int(a.shape[0]),
            "batches": MESH_STATE_BATCHES, "batch": STATE_BATCH,
            "resident": sharded.resident, "same_bytes": True}


def mesh_phase(workdir: str, smi: str) -> dict:
    """The ``mesh`` phase (module docstring, 25)."""
    import torch

    from flink_jpmml_tpu_torch.parallel.mesh import make_mesh
    from flink_jpmml_tpu_torch.utils.config import MeshConfig

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    mesh = (make_mesh() if count == 1
            else make_mesh(MeshConfig(1, 1), allow_subset=True))
    if (mesh.shape != {"data": 1, "model": 1}
            or mesh.devices[0, 0] != torch.device("cuda", 0)):
        raise RuntimeError(f"the card's mesh is {mesh}")
    out = {"nvidia_smi": smi, "device_count": count,
           "mesh": dict(mesh.shape),
           "devices": [str(d) for d in mesh.devices.flat]}
    out["config5"] = mesh_config5(workdir, mesh)
    out["gbm_f32"] = mesh_gbm(workdir, mesh)
    out["tp"] = mesh_tp(workdir, mesh)
    out["dynamic"] = mesh_dynamic(workdir, mesh)
    out["chip_loss"] = mesh_chip_loss(workdir, mesh)
    out["state"] = mesh_state(mesh)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- A/B of the fused block path against another checkout ---------------

# -- the supervised fleet: kill -9 restart, the rollout broadcast, obs + history

FLEET_RECORDS = 4 * DISPATCH  # part a: the broker's rows (the main paths' generator, seed 0)
FLEET_EVENTS = 2 * BATCH  # part b: the keyed events a worker cycles through
FLEET_EVENT_SEED = 41
FLEET_FRACTION = 0.2  # the seed-12 candidate's canary share
FLEET_WORKERS = ("w0", "w1")
# The supervisor's first-beat deadline for the drill's workers: a card
# worker imports torch, makes its CUDA context, loads the kernel's library
# and compiles one or two 500-tree models before its first beat, which took
# 9.8-18.9 s in this phase on an H100 80GB HBM3 (700 W) host against the
# 30 s default; 60 s, as the JAX tests give workers that import jax. The
# 2 s silence deadline stays the default (the largest beat gap read 0.50 s).
FLEET_FIRST_BEAT_S = 60.0
# seconds-scale history: a 0.25 s frame every 0.25 s, cascaded into 1 s;
# the recorder's overhead budget at a quarter of the wall, not 2%: a
# worker's capture thread waits on the GIL behind its scoring loop, and at
# 2% the budget drops most of a busy worker's frames (the drops are
# printed, history_dropped{reason="budget"})
FLEET_HISTORY_ENV = {"FJT_HISTORY_INTERVAL_S": "0.25",
                     "FJT_HISTORY_RES": "0.25,1",
                     "FJT_HISTORY_BUDGET": "0.25"}

# Every worker starts with these lines. Its stdout goes nowhere and its
# stderr to a file of this incarnation's own, before anything else runs:
# no byte of a worker reaches this script's standard output. Then the
# checkout goes on sys.path, the CUDA context is made (no card: the port's
# DeviceUnavailableError, a non-zero exit) and the kernel's library loaded,
# so that a slow start falls under the supervisor's first-beat deadline and
# not under its 2 s silence deadline.
FLEET_PRELUDE = r"""
import os, sys
os.dup2(os.open(os.devnull, os.O_WRONLY), 1)
os.dup2(os.open(os.path.join(sys.argv[2], "fleet-%s-%d.err" % (
    os.environ["FJT_WORKER_ID"], os.getpid())),
    os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644), 2)
sys.path.insert(0, sys.argv[1])
import json, threading, time
import numpy as np
import torch
from flink_jpmml_tpu_torch.utils.device import resolve_device
torch.zeros(1, device=resolve_device(None))
from flink_jpmml_tpu_torch.compile import qtrees_cuda
qtrees_cuda.build()
from flink_jpmml_tpu_torch.runtime.supervisor import reporter_from_env
OUT, PID = sys.argv[2], os.getpid()


def launches():
    return qtrees_cuda.leaf_rows.launches_by_classes.get(1, 0)


def write_json(name, obj):
    path = os.path.join(OUT, name)
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)
"""

# Part a: the JAX TestKillResumeDrill's worker at the main path's widths.
# Each delivery is appended to emit-<pid>.bin as (first offset, count) and
# the count's float32 scores; restore-<pid>.json holds the offset this
# incarnation restored from.
FLEET_KILL_WORKER = FLEET_PRELUDE + r"""
import struct
from flink_jpmml_tpu_torch.compile import compile_pmml
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
from flink_jpmml_tpu_torch.runtime.kafka import KafkaBlockSource
from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

pmml, host, port, topic, ckdir = sys.argv[3:8]
total, B = int(sys.argv[8]), int(sys.argv[9])
cm = compile_pmml(parse_pmml_file(pmml), batch_size=B)
F = len(cm.quantized_scorer().wire.fields)
reg = MetricsRegistry()
reg.gauge("fleet_pid").set(PID)
rep = reporter_from_env(metrics=reg)
assert rep is not None, "not under supervision"
out = open(os.path.join(OUT, "emit-%d.bin" % PID), "ab")


def sink(o, n, first_off):
    vals = np.asarray(o, np.float32)[:n]
    out.write(struct.pack("<qq", first_off, n) + vals.tobytes())
    out.flush()


src = KafkaBlockSource(host, int(port), topic, n_cols=F, max_wait_ms=20,
                       metrics=reg)
pipe = BlockPipeline(
    src, cm, sink,
    RuntimeConfig(batch=BatchConfig(size=B, deadline_us=2000),
                  checkpoint_interval_s=0.05),
    checkpoint=CheckpointManager(ckdir), metrics=reg, max_dispatch_chunks=1)
restored = pipe.restore()
write_json("restore-%d.json" % PID,
           {"offset": pipe.committed_offset if restored else 0})
pipe.start()
while pipe.committed_offset < total and pipe.error is None:
    reg.gauge("fleet_leaf_rows_launches").set(launches())
    time.sleep(0.01)
pipe.stop()
pipe.join(timeout=60.0)
src.close()
out.close()
if pipe.error is not None:
    raise pipe.error
write_json("done-%d.json" % PID, {"launches": launches()})
"""

# Part b: a DynamicScorer serving config 2's GBM as v1 with the seed-12
# candidate at canary from the worker's own control stream (so a restarted
# incarnation comes back mid-canary, as one restoring a checkpoint taken
# mid-canary would), beating with reporter_from_env(metrics=,
# rollout_registry=). It scores keyed dict events in batches of B for as
# long as it lives. A thread watches the reporter's beat count and the
# registry: once the rollout is gone the worker scores its first B events
# once more and writes vals-<pid>.npy and result-<pid>.json (the beat that
# carried the decision, its time, the beats' times, the registry's state).
FLEET_ROLLOUT_WORKER = FLEET_PRELUDE + r"""
from flink_jpmml_tpu_torch.models.control import AddMessage, RolloutMessage
from flink_jpmml_tpu_torch.models.core import ModelId
from flink_jpmml_tpu_torch.rollout.state import GuardrailSpec
from flink_jpmml_tpu_torch.runtime.sources import ControlSource
from flink_jpmml_tpu_torch.serving.scorer import DynamicScorer

v1, v3 = sys.argv[3:5]
seed, n, B = map(int, sys.argv[5:8])
fraction, spec = float(sys.argv[8]), GuardrailSpec.from_dict(
    json.loads(sys.argv[9]))
ctrl = ControlSource()
sc = DynamicScorer(control=ctrl, batch_size=B, auto_rollout=False,
                   guardrails=spec)
ctrl.push(AddMessage("gbm", 1, v1, timestamp=1.0))
ctrl.push(RolloutMessage("gbm", 3, "canary", 2.0, path=v3,
                         fraction=fraction, guardrails=spec))
sc.finish(sc.submit([]))
for v in (1, 3):
    while sc.registry.model_if_warm(ModelId("gbm", v)) is None:
        err = sc.registry.warm_error(ModelId("gbm", v))
        if err is not None:
            raise err
        time.sleep(0.005)
if sc.registry.rollout("gbm") is None:
    raise RuntimeError("the candidate is not at canary")
rng = np.random.default_rng(seed)
X = rng.normal(0.0, 1.5, size=(n, 32)).astype(np.float32)
X[rng.random(size=X.shape) < 0.2] = np.nan
fields = ["f%d" % j for j in range(32)]
events = [("gbm", dict({f: v for f, v in zip(fields, row) if v == v},
                       _key="k%d" % i)) for i, row in enumerate(X.tolist())]
sc.metrics.gauge("fleet_pid").set(PID)
rep = reporter_from_env(metrics=sc.metrics, rollout_registry=sc.registry)
assert rep is not None, "not under supervision"
beats, conv = [], {}


def watch():
    seen = 0
    while True:
        s = rep._seq
        if s != seen:
            seen = s
            beats.append([time.time(), s])
            del beats[:-400]
        if not conv and sc.registry.rollout("gbm") is None:
            conv.update(t=time.time(), beat=rep._seq)
        time.sleep(0.002)


threading.Thread(target=watch, daemon=True).start()
i, written = 0, False
while True:
    lo = (i % (n // B)) * B
    sc.finish(sc.submit(events[lo:lo + B]))
    i += 1
    sc.metrics.gauge("fleet_leaf_rows_launches").set(launches())
    if conv and not written:
        got = [np.nan if p.is_empty else p.score.value
               for p, _ in sc.finish(sc.submit(events[:B]))]
        np.save(os.path.join(OUT, "vals-%d.npy" % PID),
                np.asarray(got, np.float32))
        r = sc.registry
        write_json("result-%d.json" % PID, {
            "t_conv": conv["t"], "beat_conv": conv["beat"],
            "beats": list(beats), "resolves": str(r.resolve("gbm")),
            "resolves_v1": r.resolve("gbm") == ModelId("gbm", 1),
            "no_rollout": r.rollout("gbm") is None,
            "candidate_dropped": r.resolve("gbm", 3) is None,
            "batches": i})
        written = True
"""


class FleetWatch:
    """Polls a supervisor every 10 ms on a thread of its own. For each
    incarnation (worker, pid): seconds from spawn to its first beat that
    the coordinator received, the largest gap between two of its beats,
    and the largest ``fleet_leaf_rows_launches`` its beats carried (a
    lower bound for an incarnation killed between two beats). It reads the
    supervisor's spawn times and its coordinator's receive times, both on
    the monotonic clock."""

    def __init__(self, sup):
        self.sup = sup
        self.inc = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        coord = self.sup._coord
        while not self._stop.wait(0.01):
            snaps = self.sup.metrics_snapshots()
            with self.sup._mu:  # a spawn sets the pid and its time together
                live = [(wid, st.proc.pid, st.spawned_at)
                        for wid, st in self.sup._workers.items()
                        if st.proc is not None]
            for wid, pid, spawned in live:
                rec = self.inc.setdefault((wid, pid), {
                    "worker": wid, "pid": pid, "spawned": spawned,
                    "first_beat": None, "last_beat": None, "max_gap_s": 0.0,
                    "launches": 0})
                last = coord.last_seen(wid)
                if last is not None and last >= rec["spawned"]:
                    if rec["first_beat"] is None:
                        rec["first_beat"] = last
                    elif last != rec["last_beat"]:
                        rec["max_gap_s"] = max(rec["max_gap_s"],
                                               last - rec["last_beat"])
                    rec["last_beat"] = last
                g = (snaps.get(wid) or {}).get("gauges") or {}
                if g.get("fleet_pid", {}).get("value") == pid:
                    rec["launches"] = max(rec["launches"], int(
                        g.get("fleet_leaf_rows_launches", {}).get("value",
                                                                  0)))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    def rows(self) -> list:
        return [{"worker": r["worker"], "pid": r["pid"],
                 "start_s": (None if r["first_beat"] is None
                             else r["first_beat"] - r["spawned"]),
                 "max_beat_gap_s": r["max_gap_s"],
                 "launches_seen": r["launches"]}
                for r in self.inc.values()]


def file_tails(paths: list, n: int = 1500) -> str:
    """The last ``n`` bytes of each file in ``paths``."""
    parts = []
    for path in paths:
        try:
            with open(path, "rb") as f:
                f.seek(max(os.path.getsize(path) - n, 0))
                tail = f.read().decode(errors="replace")
        except OSError as e:
            tail = repr(e)
        parts.append(f"--- {os.path.basename(path)}:\n{tail}")
    return "\n".join(parts) or "(no output files)"


def fleet_tails(outdir: str) -> str:
    """The tails of every worker incarnation's stderr file."""
    return file_tails([os.path.join(outdir, name)
                       for name in sorted(os.listdir(outdir))
                       if name.startswith("fleet-") and name.endswith(".err")])


def fleet_extra_restarts(seq0: int, kills: dict) -> list:
    """Spawns of the workers named in ``kills`` beyond one a worker plus
    the drill's own kills, each with the supervisor's flight events that
    say why (deaths, wedge kills)."""
    from flink_jpmml_tpu_torch.obs import recorder as flight

    evs = [e for e in flight.events() if e.get("seq", 0) > seq0]
    out = []
    for wid in sorted(kills):
        spawns = sum(1 for e in evs if e["kind"] == "worker_spawn"
                     and e.get("worker") == wid)
        extra = spawns - 1 - kills.get(wid, 0)
        if extra > 0:
            out.append({"worker": wid, "extra_restarts": extra, "causes": [
                {k: e.get(k) for k in ("kind", "pid", "returncode", "t")}
                for e in evs if e.get("worker") == wid and e["kind"] in (
                    "worker_death", "worker_wedged_kill",
                    "worker_spawn_failed")]})
    return out


def pid_alive(pid: int) -> bool:
    """A pid that still runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def fleet_wait(pred, what: str, gave_up: list, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if gave_up:
            raise RuntimeError(f"fleet: the supervisor gave up on "
                               f"{gave_up} waiting for {what}")
        if time.monotonic() > deadline:
            raise RuntimeError(f"fleet: timed out waiting for {what}")
        time.sleep(0.01)


def read_emissions(outdir: str):
    """Every delivery of every part-a incarnation: (first offset,
    scores). A SIGKILL may tear the last record of the killed
    incarnation's file; a torn record is left out."""
    import struct

    got = []
    for name in sorted(os.listdir(outdir)):
        if not (name.startswith("emit-") and name.endswith(".bin")):
            continue
        with open(os.path.join(outdir, name), "rb") as f:
            raw = f.read()
        pos = 0
        while pos + 16 <= len(raw):
            off, n = struct.unpack_from("<qq", raw, pos)
            end = pos + 16 + 4 * n
            if end > len(raw):
                break
            got.append((off, np.frombuffer(raw[pos + 16:end], np.float32)))
            pos = end
    return got


def fleet_kill_resume(workdir: str, rows: np.ndarray, direct: np.ndarray,
                      pmml: str, gave_up: list) -> dict:
    """Part a, the JAX TestKillResumeDrill at config 2: one supervised
    worker scores the fused 500-tree GBM through a checkpointed
    ``BlockPipeline`` (batch 16,384, one batch a dispatch) from a port
    ``MiniKafkaBroker`` holding FLEET_RECORDS rows of the main paths'
    generator (seed 0), each dispatch delayed 20 ms by ``FJT_FAULTS``.
    Once a checkpoint has committed a third of the stream the worker is
    SIGKILLed; from then on nothing is done until the supervisor reports
    it finished. No gap, exactly once below the restore point, at most
    twice in the replay window, every delivered score within rtol 1e-4 /
    atol 1e-5 of the direct run of the same rows on the card. Its worker
    writes no history (that is part c's)."""
    import signal

    from flink_jpmml_tpu_torch.obs import recorder as flight
    from flink_jpmml_tpu_torch.runtime import kafka
    from flink_jpmml_tpu_torch.runtime.checkpoint import CheckpointManager
    from flink_jpmml_tpu_torch.runtime.supervisor import (
        RestartPolicy,
        Supervisor,
        WorkerSpec,
    )

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(workdir, "fleet-a")
    ckdir = os.path.join(outdir, "ck")
    os.makedirs(outdir)
    N = len(rows)
    broker = kafka.MiniKafkaBroker(topic="fleet")
    sup = watch = None
    seq0 = flight.DEFAULT._seq
    try:
        broker.append_rows(rows)
        spec = WorkerSpec("scorer", [
            sys.executable, "-c", FLEET_KILL_WORKER, here, outdir, pmml,
            broker.host, str(broker.port), "fleet", ckdir, str(N),
            str(BATCH)], env={"FJT_FAULTS": "dispatch_delay:delay_ms=20",
                              "FJT_HISTORY_DIR": ""}, cwd=outdir)
        sup = Supervisor([spec], policy=RestartPolicy(max_restarts=3,
                                                      backoff_s=0.05),
                         first_beat_timeout_s=FLEET_FIRST_BEAT_S,
                         on_give_up=gave_up.append)
        sup.start()
        watch = FleetWatch(sup)

        def committed() -> int:
            try:
                st = CheckpointManager(ckdir).load_latest()
                return int(st["source_offset"]) if st else 0
            except Exception:
                return 0

        fleet_wait(lambda: committed() >= N // 3, "a third committed",
                   gave_up, 120.0)
        killed_at = committed()
        if killed_at >= N or sup.status()["scorer"]["finished"]:
            raise RuntimeError(f"fleet: the stream ended ({killed_at}) "
                               f"before the kill")
        killed_pid = sup.status()["scorer"]["pid"]
        os.kill(killed_pid, signal.SIGKILL)
        fleet_wait(lambda: sup.status()["scorer"]["finished"],
                   "the restarted worker to finish", gave_up, 180.0)
        status = sup.status()["scorer"]
    finally:
        if watch is not None:
            watch.close()
        if sup is not None:
            sup.stop()
        broker.close()
    if status["restarts"] < 1 or status["gave_up"] or gave_up:
        raise RuntimeError(f"fleet kill: {status}, gave up {gave_up}")
    restores = {}
    for name in os.listdir(outdir):
        if name.startswith("restore-"):
            with open(os.path.join(outdir, name)) as f:
                restores[int(name[8:-5])] = json.load(f)["offset"]
    c = restores[max(restores, key=lambda p: restores[p])]
    if restores.get(killed_pid) != 0 or not 0 < c < N:
        raise RuntimeError(f"fleet kill: restore points {restores}")
    covered = np.zeros(N, np.int32)
    err = 0.0
    for off, vals in read_emissions(outdir):
        covered[off:off + len(vals)] += 1
        ref = direct[off:off + len(vals)]
        if not np.allclose(vals, ref, rtol=RTOL, atol=ATOL):
            raise RuntimeError(f"fleet kill: scores at {off} differ from the "
                               f"direct run by {np.abs(vals - ref).max()}")
        err = max(err, float(np.abs(vals - ref).max()))
    gaps = np.flatnonzero(covered == 0)
    dups_below = np.flatnonzero(covered[:c] > 1)
    if len(gaps) or len(dups_below) or covered.max() > 2:
        raise RuntimeError(f"fleet kill: gaps {gaps[:5]}, duplicates below "
                           f"the restore point {dups_below[:5]}, most "
                           f"deliveries of a record {covered.max()}")
    incs = watch.rows()
    done = {}
    for name in os.listdir(outdir):
        if name.startswith("done-"):
            with open(os.path.join(outdir, name)) as f:
                done[int(name[5:-5])] = json.load(f)["launches"]
    launches = sum(done.get(r["pid"], r["launches_seen"]) for r in incs)
    if not all(done.get(r["pid"], r["launches_seen"]) for r in incs):
        raise RuntimeError(f"fleet kill: an incarnation reported no "
                           f"launches: {incs}, {done}")
    return {"seconds": time.perf_counter() - t0, "records": N,
            "batch": BATCH, "killed_at_committed": killed_at,
            "restore_point": c, "restarts": status["restarts"],
            "gave_up": False, "gaps": 0, "dups_below_restore": 0,
            "replay_window_records": int((covered[c:] == 2).sum()),
            "max_deliveries": int(covered.max()), "max_abs_err": err,
            "incarnations": incs, "launches": launches,
            "launches_exact_pids": sorted(done),
            "extra_restarts": fleet_extra_restarts(seq0, {"scorer": 1}),
            "pids": [r["pid"] for r in incs]}


def prom_samples(text: str):
    """/metrics text → ({series: value}, {family: type})."""
    samples, types = {}, {}
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            types[name] = kind
        elif ln and not ln.startswith("#"):
            key, val = ln.rsplit(" ", 1)
            samples[key] = float(val)
    return samples, types


def check_fleet_scrape(text: str, varz: dict, sup_before: dict,
                       sup_after: dict) -> dict:
    """The JAX TestFleetMetricsDrill contract on one live scrape: every
    unlabeled counter equals the sum of its ``worker="…"`` series plus
    the supervisor's own registry (read before and after the scrape;
    the page renders 10 significant digits), and every aggregate
    histogram's quantiles and count equal the merge of the workers'."""
    import re

    from flink_jpmml_tpu_torch.utils.metrics import Histogram

    samples, types = prom_samples(text)
    per = {}
    for key, v in samples.items():
        name = key.split("{", 1)[0]
        if types.get(name) != "counter":
            continue
        m = re.search(r',?worker="([^"]*)"', key)
        if m is None:
            per.setdefault(key, [None, 0.0, 0])[0] = v
            continue
        base = key[:m.start()] + key[m.end():]
        base = base.replace("{,", "{").replace("{}", "")
        row = per.setdefault(base, [None, 0.0, 0])
        row[1] += v
        row[2] += 1
    checked = 0
    for key, (agg, wsum, nw) in per.items():
        if not nw:
            continue
        raw = key[len("fjt_"):]
        lo = sup_before.get("counters", {}).get(raw, 0.0)
        hi = sup_after.get("counters", {}).get(raw, 0.0)
        tol = 1e-9 * max(abs(agg or 0.0), 1.0)
        if agg is None or not (wsum + lo - tol <= agg <= wsum + hi + tol):
            raise RuntimeError(f"fleet /metrics: {key} aggregate {agg} vs "
                               f"workers {wsum} + supervisor {lo}..{hi}")
        checked += 1
    hchecked = 0
    sup_h = sup_after.get("histograms", {})
    for name, st in (varz.get("") or {}).get("histograms", {}).items():
        parts = [Histogram.from_state(varz[w]["histograms"][name])
                 for w in varz if w and name in varz[w].get("histograms", {})]
        if name in sup_h:
            parts.append(Histogram.from_state(sup_h[name]))
        merged = parts[0]
        for h in parts[1:]:
            merged = merged.merge(h)
        agg = Histogram.from_state(st)
        if agg.count() != merged.count() or any(
                agg.quantile(x) != merged.quantile(x)
                for x in (0.5, 0.99, 0.999)):
            raise RuntimeError(f"fleet /varz: histogram {name} aggregate "
                               f"differs from the merge of its workers")
        hchecked += 1
    if not checked or not hchecked:
        raise RuntimeError(f"fleet scrape: {checked} counters, {hchecked} "
                           f"histograms with worker series")
    return {"counters_checked": checked, "histograms_checked": hchecked}


def fleet_rollout(workdir: str, X: np.ndarray, direct1: np.ndarray,
                  gbm: str, gave_up: list, started: threading.Event) -> dict:
    """Parts b and c. Two supervised workers on the card each serve config
    2's GBM as v1 through a ``DynamicScorer`` with the seed-12 candidate
    at canary 0.2 (FLEET_ROLLOUT_WORKER). The supervisor's obs server
    (127.0.0.1, port 0) and its history (``FJT_HISTORY_DIR`` under the
    run's scratch directory) are live. Once both workers' beats carry
    candidate records, the canary goes into the supervisor's book, its
    ``rollout_controller()`` judges the merged heartbeat structs, and
    ``broadcast_rollout`` carries the rollback. Scraped while both run:
    ``/metrics`` (aggregate = sum of the workers' series), ``/varz``
    (quantiles of the merge), ``/healthz`` (200) and
    ``/history?source=_fleet``. Then w1 is SIGKILLed; its next
    incarnation comes back mid-canary and must converge on its first
    beat. Every worker's answers after convergence equal v1's direct
    scores; the killed incarnation's history frames read back, and on the
    run's own frames downsample(merge) equals merge(downsample) as
    strings. ``started`` is set once the supervisor runs and the
    environment it armed its history from is restored."""
    import signal
    import urllib.request

    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.models.control import RolloutMessage
    from flink_jpmml_tpu_torch.obs import history
    from flink_jpmml_tpu_torch.obs import recorder as flight
    from flink_jpmml_tpu_torch.obs.trace import iter_jsonl
    from flink_jpmml_tpu_torch.rollout.state import GuardrailSpec
    from flink_jpmml_tpu_torch.runtime.supervisor import (
        RestartPolicy,
        Supervisor,
        WorkerSpec,
    )

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(workdir, "fleet-b")
    hdir = os.path.join(workdir, "fleet-history")
    os.makedirs(outdir)
    v3 = os.path.join(workdir, "rollout_v3.pmml")
    if not os.path.exists(v3):
        gen_gbm(workdir, n_trees=500, seed=12, name="rollout_v3.pmml")
    # no promotion within the drill: the candidate can only be rolled back
    spec = GuardrailSpec(min_samples=RD_MIN_SAMPLES, window_s=RD_WINDOW_S,
                         promote_after_s=3600.0,
                         canary_fraction=FLEET_FRACTION)
    argv = [sys.executable, "-c", FLEET_ROLLOUT_WORKER, here, outdir, gbm,
            v3, str(FLEET_EVENT_SEED), str(FLEET_EVENTS), str(BATCH),
            str(FLEET_FRACTION), json.dumps(spec.as_dict())]
    hist_env = dict(FLEET_HISTORY_ENV, FJT_HISTORY_DIR=hdir)
    seq0 = flight.DEFAULT._seq
    sup = watch = None

    def get(url):
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()

    def results():
        got = {}
        for name in os.listdir(outdir):
            if name.startswith("result-") and name.endswith(".json"):
                with open(os.path.join(outdir, name)) as f:
                    got[int(name[7:-5])] = json.load(f)
        return got

    def cand_records(wid) -> float:
        s = sup.metrics_snapshots().get(wid) or {}
        return (s.get("counters") or {}).get(
            'rollout_candidate_records{model="gbm"}', 0.0)

    try:
        sup = Supervisor([WorkerSpec(w, argv, env=hist_env, cwd=outdir)
                          for w in FLEET_WORKERS],
                         policy=RestartPolicy(max_restarts=3, backoff_s=0.05),
                         first_beat_timeout_s=FLEET_FIRST_BEAT_S,
                         on_give_up=gave_up.append)
        # the supervisor arms its _fleet recorder from the environment in
        # start(); nothing else of the phase runs until it is restored
        saved = {k: os.environ.get(k) for k in hist_env}
        os.environ.update(hist_env)
        try:
            sup.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            started.set()
        srv = sup.start_obs_server(host="127.0.0.1", port=0)
        watch = FleetWatch(sup)
        fleet_wait(lambda: all(cand_records(w) > 0 for w in FLEET_WORKERS),
                   "both workers scoring at canary", gave_up, 120.0)
        ctl = sup.rollout_controller(interval_s=0.25)
        ctl._book.apply(RolloutMessage(
            "gbm", 3, "canary", time.time(), path=v3,
            fraction=FLEET_FRACTION, guardrails=spec))
        fleet_wait(lambda: not ctl._book.rollouts(), "the rollback",
                   gave_up, 60.0)
        evs = [e for e in flight.events() if e.get("seq", 0) > seq0]
        decision = [e for e in evs if e["kind"] == "rollout_rollback"][-1]
        t_bc = [e for e in evs if e["kind"] == "rollout_broadcast"
                and e.get("stage") == "rollback"][-1]["t"]

        # part c: one live scrape of every route while both workers run
        sup_before = sup.metrics.struct_snapshot()
        st_m, text = get(srv.url + "/metrics")
        st_v, varz = get(srv.url + "/varz")
        sup_after = sup.metrics.struct_snapshot()
        st_h, health = get(srv.url + "/healthz")
        st_f, fleet_hist = get(srv.url + "/history?source=_fleet&step=1")
        varz, health, fleet_hist = (json.loads(varz), json.loads(health),
                                    json.loads(fleet_hist))
        if (st_m, st_v, st_h, st_f) != (200,) * 4 or not health["ok"]:
            raise RuntimeError(f"fleet scrape: {st_m} {st_v} {st_h} {st_f} "
                               f"{health}")
        if set(varz) != {"", *FLEET_WORKERS}:
            raise RuntimeError(f"fleet /varz sources {sorted(varz)}")
        scrape = check_fleet_scrape(text, varz, sup_before, sup_after)
        agg = varz[""]["counters"]
        scrape["history_frames"] = agg.get("history_frames", 0.0)
        scrape["history_dropped_budget"] = agg.get(
            'history_dropped{reason="budget"}', 0.0)
        ff = fleet_hist["frames"]
        if not ff or any(f["src"] != history.FLEET_SRC for f in ff):
            raise RuntimeError(f"fleet /history?source=_fleet: "
                               f"{[f['src'] for f in ff]}")

        fleet_wait(lambda: len(results()) == 2, "both workers converged",
                   gave_up, 60.0)
        first = results()
        victim = sup.status()["w1"]["pid"]
        os.kill(victim, signal.SIGKILL)
        fleet_wait(lambda: len(results()) == 3, "the restarted w1 converged",
                   gave_up, 120.0)
        status = sup.status()
        res = results()
        live = {w: status[w]["pid"] for w in FLEET_WORKERS}
        if not all(status[w]["alive"] for w in FLEET_WORKERS):
            raise RuntimeError(f"fleet: a worker is down: {status}")
        st_h2, _ = get(srv.url + "/healthz")
    finally:
        if watch is not None:
            watch.close()
        if sup is not None:
            sup.stop()
    if gave_up or st_h2 != 200:
        raise RuntimeError(f"fleet rollout: gave up {gave_up}, /healthz "
                           f"{st_h2}")
    converged = []
    err = 0.0
    pid2wid = {r["pid"]: r["worker"] for r in watch.rows()}
    for pid, r in sorted(res.items()):
        vals = np.load(os.path.join(outdir, f"vals-{pid}.npy"))
        if not (r["resolves_v1"] and r["no_rollout"]
                and r["candidate_dropped"]):
            raise RuntimeError(f"fleet: worker {pid} did not converge on v1:"
                               f" {r}")
        if not np.allclose(vals, direct1, rtol=RTOL, atol=ATOL):
            raise RuntimeError(f"fleet: worker {pid}'s answers after the "
                               f"rollback differ from v1's by "
                               f"{np.abs(vals - direct1).max()}")
        err = max(err, float(np.abs(vals - direct1).max()))
        restarted = pid not in first
        row = {"worker": pid2wid[pid], "pid": pid, "restarted": restarted,
               "beat_of_convergence": r["beat_conv"],
               "batches_scored": r["batches"]}
        if restarted:
            spawn = [e["t"] for e in flight.events()
                     if e["kind"] == "worker_spawn" and e.get("pid") == pid]
            row["beats"] = r["beat_conv"]
            row["seconds_from_spawn"] = r["t_conv"] - spawn[0]
            if r["beat_conv"] != 1:
                raise RuntimeError(f"fleet: the restarted worker converged "
                                   f"on beat {r['beat_conv']}, not its first")
        else:
            row["beats"] = sum(1 for t, _ in r["beats"]
                               if t_bc < t <= r["t_conv"])
            row["seconds"] = r["t_conv"] - t_bc
        converged.append(row)
    # the killed incarnation's frames, read back from its own segments
    killed_frames = []
    for name in sorted(os.listdir(hdir)):
        if name.startswith("frames-") and f"-{victim}-" in name:
            killed_frames += list(iter_jsonl(os.path.join(hdir, name)))
    if not killed_frames or any(f["src"] != "w1" for f in killed_frames):
        raise RuntimeError(f"fleet history: {len(killed_frames)} frames of "
                           f"the killed incarnation {victim}")
    fine = history.read_frames(hdir, res=0.25, sources=list(FLEET_WORKERS))
    direct_ds = [history.canonical(f) for f in history.downsample(fine, 1.0)]
    per = [f for w in FLEET_WORKERS for f in history.downsample(
        [f for f in fine if f["src"] == w], 1.0)]
    merged_ds = [history.canonical(f) for f in history.downsample(per, 1.0)]
    if direct_ds != merged_ds or not direct_ds:
        raise RuntimeError("fleet history: downsample(merge) differs from "
                           "merge(downsample) on the run's frames")
    incs = watch.rows()
    return {
        "seconds": time.perf_counter() - t0, "workers": len(FLEET_WORKERS),
        "events_per_batch": BATCH, "fraction": FLEET_FRACTION,
        "decision": {k: decision.get(k) for k in (
            "action", "reason", "compared", "disagree", "disagree_rate",
            "candidate_records")},
        "converged": converged, "max_abs_err": err,
        "scrape": {**scrape, "healthz": st_h, "healthz_after_kill": st_h2,
                   "fleet_history_frames": len(ff)},
        "history": {"killed_pid": victim,
                    "killed_incarnation_frames": len(killed_frames),
                    "fine_frames": len(fine), "coarse_slots": len(direct_ds),
                    "downsample_merge_string_equal": True},
        "incarnations": incs,
        "launches": sum(r["launches_seen"] for r in incs),
        "extra_restarts": fleet_extra_restarts(seq0, {"w0": 0, "w1": 1}),
        "pids": [r["pid"] for r in incs], "live_pids_at_end": live}


def fleet(workdir: str, q, smi: str) -> dict:
    """The ``fleet`` phase: the supervised fleet on the card (parts a, b
    and c above). Parts b and c run on a thread of their own beside part
    a, each under its own supervisor: the workers' cold starts, not the
    drills, take most of the phase. The direct runs the parts are held to
    are made first, on this thread. The parent frees its cached card
    memory before the workers start; every supervisor is stopped in a
    ``finally``, and no worker pid may be alive when the phase returns.
    The kernel's launches on this path are the workers' own counts,
    carried in their beats (a lower bound for an incarnation killed
    between two beats)."""
    import torch

    t0 = time.perf_counter()
    rows = features(np.random.default_rng(0), FLEET_RECORDS,
                    len(q.wire.fields))
    direct = direct_rows(q, rows).astype(np.float32)
    X = features(np.random.default_rng(FLEET_EVENT_SEED), FLEET_EVENTS, 32)
    direct1 = direct_rows(q, X[:BATCH]).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    gbm = os.path.join(workdir, "gbm_500.pmml")
    got, started = {}, threading.Event()

    def parts_bc():
        try:
            got["b"] = fleet_rollout(workdir, X, direct1, gbm, [], started)
        except BaseException as e:
            got["b_error"] = e
        finally:
            started.set()

    thread = threading.Thread(target=parts_bc, name="fleet-bc", daemon=True)
    thread.start()
    started.wait()
    try:
        got["a"] = fleet_kill_resume(workdir, rows, direct, gbm, [])
    except Exception as e:
        got["a_error"] = e
    thread.join()
    errors = [got[k] for k in ("a_error", "b_error") if k in got]
    if errors:
        # every worker incarnation's stderr, part by part
        raise RuntimeError("\n".join(
            [repr(e) for e in errors]
            + [fleet_tails(os.path.join(workdir, d))
               for d in ("fleet-a", "fleet-b")
               if os.path.isdir(os.path.join(workdir, d))])) from errors[0]
    a, b = got["a"], got["b"]
    alive = [p for p in a["pids"] + b["pids"] if pid_alive(p)]
    if alive:
        raise RuntimeError(f"fleet: worker pids alive at the end: {alive}")
    seconds = time.perf_counter() - t0
    return {"nvidia_smi": smi, "seconds": seconds,
            "parent_mem_free_bytes": free, "parent_mem_total_bytes": total,
            "kill_resume": a, "rollout": b, "live_worker_pids": [],
            "heartbeat_timeout_s": 2.0,
            "first_beat_timeout_s": FLEET_FIRST_BEAT_S,
            "launches_c1": a["launches"] + b["launches"],
            "launches_lower_bound": True}


# -- the operator's entry points (phase "cli") -------------------------------

CLI_ROWS = 4 * BATCH  # part a: the CSV's rows (the main paths' generator, seed 0)
CLI_DLQ_ROWS = 64  # part b: the quarantined main-path rows
CLI_GBM_SECONDS = "2"  # part c: gbm_throughput's --seconds
CLI_TIMEOUT_S = 300.0  # a subprocess's wall limit
CLI_KAFKA_ROWS = 20_000  # kafka_stream's log (its N, rows from seed 11)
CLI_KAFKA_BLOCK = 256  # kafka_stream's batch

# part c: an example job run by runpy in a child that sets the kernel's
# count to 0 first and prints it, after the job, as its last line
CLI_EXAMPLE = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
from flink_jpmml_tpu_torch.compile import qtrees_cuda
qtrees_cuda.leaf_rows.launches = 0
qtrees_cuda.leaf_rows.launches_by_classes = {}
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
print("launches: " + json.dumps({
    "launches": qtrees_cuda.leaf_rows.launches,
    "launches_by_classes": qtrees_cuda.leaf_rows.launches_by_classes,
}), flush=True)
"""

# part b's redrive: the port's fjt-dlq in a process that sees no card
CLI_REDRIVE = r"""
import sys
sys.path.insert(0, sys.argv[1])
from flink_jpmml_tpu_torch.cli import dlq_main
sys.exit(dlq_main(sys.argv[2:]))
"""


def cli_spawn(workdir: str, name: str, argv: list, env=None) -> dict:
    """Start ``argv`` from the checkout's root with its stdout and stderr
    in ``cli-<name>.out`` / ``.err`` under ``workdir``: nothing of it
    reaches this script's standard output."""
    here = os.path.dirname(os.path.abspath(__file__))
    paths = {k: os.path.join(workdir, f"cli-{name}.{k}") for k in ("out", "err")}
    with open(paths["out"], "wb") as out, open(paths["err"], "wb") as err:
        proc = subprocess.Popen(argv, cwd=here, stdout=out, stderr=err,
                                stdin=subprocess.DEVNULL,
                                env=dict(os.environ, **(env or {})))
    return {"name": name, "proc": proc, "t0": time.perf_counter(), **paths}


def cli_tails(jobs: list) -> str:
    return file_tails([job[k] for job in jobs for k in ("out", "err")], 3000)


def cli_wait(jobs: list) -> list:
    """Wait for every job in one polling loop → their stdouts. Each job's
    ``seconds`` run from its start to the poll that saw it exit (a job
    that ended while this process was busy elsewhere is stamped when the
    loop starts). Raises on a non-zero exit or past ``CLI_TIMEOUT_S``
    from a job's start; the caller kills what is left."""
    pending = list(jobs)
    while pending:
        now = time.perf_counter()
        for job in list(pending):
            rc = job["proc"].poll()
            if rc is None:
                if now - job["t0"] > CLI_TIMEOUT_S:
                    raise RuntimeError(f"cli: {job['name']} ran past "
                                       f"{CLI_TIMEOUT_S} s")
                continue
            job["seconds"] = now - job["t0"]
            pending.remove(job)
            if rc != 0:
                raise RuntimeError(f"cli: {job['name']} exited {rc}")
        if pending:
            time.sleep(0.02)
    outs = []
    for job in jobs:
        with open(job["out"], encoding="utf-8") as f:
            outs.append(f.read())
    return outs


def cli_launches(text: str, label: str, warms: int) -> dict:
    """Part c: the kernel's count the ``CLI_EXAMPLE`` child printed last,
    held (``held_launches``) against the dispatches and redispatches of
    every metrics snapshot the job printed plus its ``warms`` direct
    launches. Each snapshot must come from the kernel's rank-wire
    backend, so a fall-back dispatch shows as a missing launch."""
    lines = text.splitlines()
    snaps = [ln for ln in lines if "metrics: {" in ln]
    if not snaps or any("'scorer_backend_rank_wire_cuda': 1.0" not in s
                        for s in snaps):
        raise RuntimeError(f"cli: {label} printed no rank_wire_cuda metrics")
    if not lines or not lines[-1].startswith("launches: "):
        raise RuntimeError(f"cli: {label} printed no launch count")

    def total(key: str) -> int:
        return sum(int(float(m.group(1))) for m in (
            re.search(rf"'{key}': ([\d.]+)", s) for s in snaps) if m)

    counted = json.loads(lines[-1][len("launches: "):])
    counter = types.SimpleNamespace(**counted)
    return held_launches(counter, {"dispatches": total("dispatches"),
                                   "redispatches": total("redispatches")},
                         f"cli {label}", warms=warms)


def cli_kafka_kernel(workdir: str) -> list:
    """The kernel at ``kafka_stream``'s shape, which no other phase gives
    it: its model (``gen_gbm(50, depth=5, n_features=8)``) and its own
    rows, as one full block of 256, a partial block and the whole log,
    bit for bit against the plain version."""
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile import compile_pmml
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    path = gen_gbm(workdir, n_trees=50, depth=5, n_features=8,
                   name="cli_kafka_stream.pmml")
    q = compile_pmml(parse_pmml_file(path),
                     batch_size=CLI_KAFKA_BLOCK).quantized_scorer()
    if q is None or q.backend != "cuda":
        raise RuntimeError("cli: kafka_stream's model is not on the kernel")
    X = np.random.default_rng(11).normal(
        0.0, 1.5, size=(CLI_KAFKA_ROWS, 8)).astype(np.float32)
    return [check_kernel(q, X[lo:hi], f"kafka_stream_50x5_f8_{hi - lo}",
                         "cli")
            for lo, hi in ((0, CLI_KAFKA_BLOCK), (CLI_KAFKA_BLOCK, 353),
                           (0, CLI_KAFKA_ROWS))]


def cli_score_check(out_path: str, err_text: str, preds) -> dict:
    """Part a: fjt-score's lines against the parent's ``score_records``."""
    with open(out_path, encoding="utf-8") as f:
        lines = [json.loads(ln) for ln in f]
    if len(lines) != len(preds):
        raise RuntimeError(f"cli: fjt-score wrote {len(lines)} lines for "
                           f"{len(preds)} records")
    if err_text.strip().splitlines()[-1:] != [f"scored {len(preds)} records"]:
        raise RuntimeError(f"cli: fjt-score's count reads {err_text[-200:]!r}")
    got, want, empty = [], [], 0
    for line, p in zip(lines, preds):
        if p.is_empty or line.get("empty"):
            if not (p.is_empty and line == {"empty": True}):
                raise RuntimeError(f"cli: {line} against empty={p.is_empty}")
            empty += 1
            continue
        got.append(line["value"])
        want.append(p.score.value)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if not np.isfinite(got).all() or not np.allclose(got, want, rtol=RTOL,
                                                     atol=ATOL):
        raise RuntimeError(f"cli: fjt-score disagrees with score_records by "
                           f"{err}")
    return {"records": len(lines), "empty": empty, "max_abs_err": err}


def cli_redrive(workdir: str, q, cm, counter) -> dict:
    """Part b: 64 main-path rows quarantined with their trace contexts
    (and one duplicate envelope), redriven by the port's ``fjt-dlq`` in a
    process that sees no card, consumed by a ``KafkaBlockSource`` feeding
    a ``BlockPipeline`` over the fused GBM on the card."""
    from flink_jpmml_tpu_torch.obs import trace as trace_mod
    from flink_jpmml_tpu_torch.runtime.block import BlockPipeline
    from flink_jpmml_tpu_torch.runtime.dlq import DeadLetterQueue
    from flink_jpmml_tpu_torch.runtime.kafka import (
        KafkaBlockSource, KafkaClient, MiniKafkaBroker,
        record_batch_traceparents,
    )
    from flink_jpmml_tpu_torch.utils.config import BatchConfig, RuntimeConfig
    from flink_jpmml_tpu_torch.utils.metrics import MetricsRegistry

    F = len(q.wire.fields)
    rows = features(np.random.default_rng(0), CLI_DLQ_ROWS, F)
    ckdir = os.path.join(workdir, "cli-ck")
    dlq = DeadLetterQueue(os.path.join(ckdir, "dlq"))
    want_tp = {}
    for i in range(CLI_DLQ_ROWS):
        ctx = trace_mod.context_for(1000 + i)
        dlq.quarantine(rows[i].tobytes(), offset=1000 + i, reason="score",
                       partition=0, trace_id=ctx.trace_id,
                       span_id=ctx.span_id)
        want_tp[i] = ctx.to_traceparent()
    ctx = trace_mod.context_for(1005)  # a replayed quarantine of one row
    dlq.quarantine(rows[5].tobytes(), offset=1005, reason="score",
                   partition=0, trace_id=ctx.trace_id, span_id=ctx.span_id)
    direct = direct_rows(q, rows).astype(np.float32)
    broker = MiniKafkaBroker(topic="redrive")
    job = None
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        job = cli_spawn(workdir, "dlq-redrive", [
            sys.executable, "-c", CLI_REDRIVE, here, "redrive", ckdir,
            "--host", broker.host, "--port", str(broker.port),
            "--topic", "redrive"], env={"CUDA_VISIBLE_DEVICES": ""})
        out, = cli_wait([job])
        if (out.count("redrove offset") != CLI_DLQ_ROWS
                or broker.high_watermark != CLI_DLQ_ROWS):
            raise RuntimeError(f"cli: the redrive produced "
                               f"{broker.high_watermark} records")
        c = KafkaClient(broker.host, broker.port)
        try:
            _, raw = c.fetch_raw("redrive", 0, 0)
        finally:
            c.close()
        tps = record_batch_traceparents(bytes(raw))
        if tps != want_tp:
            raise RuntimeError(f"cli: traceparents read back {len(tps)} of "
                               f"{CLI_DLQ_ROWS}, equal: {tps == want_tp}")
        reg = MetricsRegistry()
        src = KafkaBlockSource(broker.host, broker.port, "redrive",
                               n_cols=F, max_wait_ms=20, metrics=reg)
        got = {}

        def sink(o, n, first_off):
            vals = np.asarray(o, np.float32)[:n]
            for k in range(n):
                got[first_off + k] = vals[k]

        reset(counter)
        pipe = BlockPipeline(
            src, cm, sink,
            RuntimeConfig(batch=BatchConfig(size=BATCH, deadline_us=5000)),
            metrics=reg)
        try:
            pipe.start()
            deadline = time.monotonic() + 60.0
            while (pipe.committed_offset < CLI_DLQ_ROWS
                   and pipe._error is None and time.monotonic() < deadline):
                time.sleep(0.01)
            pipe.stop()
            pipe.join(timeout=30.0)
        finally:
            src.close()
        held = held_launches(counter, reg.snapshot(), "cli redrive")
        backend = pipe.backend
    finally:
        broker.close()
        if job is not None and job["proc"].poll() is None:
            job["proc"].kill()
    if backend != "rank_wire_cuda" or sorted(got) != list(range(CLI_DLQ_ROWS)):
        raise RuntimeError(f"cli: {len(got)} redriven records scored on "
                           f"{backend}")
    vals = np.asarray([got[k] for k in range(CLI_DLQ_ROWS)], np.float32)
    err = float(np.abs(vals - direct).max())
    if not np.allclose(vals, direct, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"cli: redriven scores disagree by {err}")
    return {"envelopes": CLI_DLQ_ROWS + 1, "redriven": CLI_DLQ_ROWS,
            "traceparents": len(tps), "max_abs_err": err,
            "redrive_seconds": job["seconds"], "backend": backend, **held}


def cli_phase(workdir: str, cm, q, counter, smi: str) -> dict:
    """The ``cli`` phase: the operator's entry points on the card. Part a
    runs ``python -m flink_jpmml_tpu_torch.cli`` (``fjt-score``) over a
    CSV of the main paths' rows against ``gbm_500.pmml``, held to this
    process's ``ModelReader(...).load(batch_size=BATCH).score_records``
    on the card; part b is ``cli_redrive``; part c runs
    ``examples_torch/gbm_throughput.py --seconds 2`` and
    ``examples_torch/kafka_stream.py`` on the card, each in a
    ``CLI_EXAMPLE`` child whose kernel count is held to the dispatches
    its printed metrics carry, and checks the kernel at
    ``kafka_stream``'s shape (``cli_kafka_kernel``). The three
    subprocesses of parts a and c start together and run beside parts b
    and c's kernel check. On a failure every subprocess's output tails
    are raised."""
    from flink_jpmml_tpu_torch.api import ModelReader

    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    pmml = os.path.join(workdir, "gbm_500.pmml")
    names = list(q.wire.fields)
    X = features(np.random.default_rng(0), CLI_ROWS, len(names))
    cells = np.char.mod("%.9g", X)
    cells[np.isnan(X)] = ""
    csv_path = os.path.join(workdir, "cli-records.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write(",".join(names) + "\n")
        f.writelines(",".join(r) + "\n" for r in cells.tolist())
    scored = os.path.join(workdir, "cli-scored.jsonl")
    tmp = os.path.join(workdir, "cli-tmp")
    os.makedirs(tmp, exist_ok=True)
    env = {"TMPDIR": tmp}
    jobs = [
        cli_spawn(workdir, "fjt-score", [
            sys.executable, "-m", "flink_jpmml_tpu_torch.cli", pmml,
            csv_path, "-o", scored, "--batch", str(BATCH)], env),
        cli_spawn(workdir, "gbm_throughput", [
            sys.executable, "-c", CLI_EXAMPLE, here,
            os.path.join(here, "examples_torch", "gbm_throughput.py"),
            "--seconds", CLI_GBM_SECONDS], env),
        cli_spawn(workdir, "kafka_stream", [
            sys.executable, "-c", CLI_EXAMPLE, here,
            os.path.join(here, "examples_torch", "kafka_stream.py")], env),
    ]
    try:
        ref_cm = ModelReader(pmml).load(batch_size=BATCH)
        recs = [{n: v for n, v in zip(names, row) if v == v}
                for row in X.tolist()]
        preds = []
        for i in range(0, len(recs), BATCH):
            preds += ref_cm.score_records(recs[i:i + BATCH])
        # before the redrive, which sets the count to 0 for its pipeline
        kernel_cases = cli_kafka_kernel(workdir)
        b = cli_redrive(workdir, q, cm, counter)
        _, gbm_out, kafka_out = cli_wait(jobs)
        with open(jobs[0]["err"], encoding="utf-8") as f:
            a = cli_score_check(scored, f.read(), preds)
        m = re.search(r"scored ([\d,]+) records", gbm_out)
        gbm_records = int(m.group(1).replace(",", "")) if m else 0
        if gbm_records <= 0:
            raise RuntimeError("cli: gbm_throughput scored no records")
        if (f"scored all {CLI_KAFKA_ROWS} records exactly once"
                not in kafka_out):
            raise RuntimeError("cli: kafka_stream did not score its log")
        # gbm_throughput warms with one direct predict_wire launch
        c = {"gbm_throughput": {
                 "records": gbm_records, "seconds": jobs[1]["seconds"],
                 **cli_launches(gbm_out, "gbm_throughput", warms=1)},
             "kafka_stream": {
                 "records": CLI_KAFKA_ROWS, "seconds": jobs[2]["seconds"],
                 **cli_launches(kafka_out, "kafka_stream", warms=0)},
             "kernel_cases": kernel_cases}
    except BaseException as e:
        raise RuntimeError(f"{e!r}\n{cli_tails(jobs)}") from e
    finally:
        for job in jobs:
            if job["proc"].poll() is None:
                job["proc"].kill()
                job["proc"].wait()
    a["seconds"] = jobs[0]["seconds"]
    launches = (b["launches"] + c["gbm_throughput"]["launches"]
                + c["kafka_stream"]["launches"])
    return {"nvidia_smi": smi, "seconds": time.perf_counter() - t0,
            "score": a, "redrive": b, "examples": c,
            "launches_c1": launches}


# -- the parity soak and the chaos soaks (phase "soak") -----------------------

SOAK_START = 100_000  # the tool's default --start
SOAK_FAMILY_SEEDS = 8
SOAK_CHAOS_SEEDS = 3  # over the tool's own model
SOAK_CHAOS_FULL_SEEDS = 1  # over config 2's GBM at compile batch 32
SOAK_ZOO_SEEDS = 2
SOAK_STATEFUL_SEEDS = 1
SOAK_CUTS: list = []  # seeds cut to keep the phase within its time
SOAK_CHAOS_ROWS = (1, 17, 32, 128, 1500)  # a dispatch's rows: OOM halves,
# one to four compile batches of 32, and the whole stream
SOAK_PACK_ROWS = (8, 0, 63, 17, 64, 1)  # a zoo round's rows a tenant (0: a
# churned-out tenant)


def soak_kernel_checks(models: dict, zoo_paths: list, dev) -> list:
    """Each kernel the soak launches, bit for bit against its plain
    version at the soak's shapes: ``qtrees_leaf_rows`` on the chaos
    models' tables, ``qtrees_leaf_rows_packed`` over the zoo's six
    tenants."""
    import torch

    from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    rng = np.random.default_rng(23)
    cases = []
    for label, cm in models.items():
        q = cm.quantized_scorer()
        tables = {k: q.params[k] for k in qtrees_cuda.TABLE_KEYS}
        F = len(q.wire.fields)
        for n in SOAK_CHAOS_ROWS:
            codes = torch.from_numpy(q.wire.encode(features(rng, n, F)))
            cases.append(check_tables(tables, codes.to(dev),
                                      f"soak_{label}_{n}", "soak"))
    members = []
    for path, n in zip(zoo_paths, SOAK_PACK_ROWS):
        q = compile_pmml(parse_pmml_file(path), batch_size=128,
                         device=dev).quantized_scorer()
        codes = q.wire.encode(features(rng, max(n, 1), len(q.wire.fields)))
        members.append(({k: q.params[k] for k in qtrees_cuda.TABLE_KEYS},
                        torch.from_numpy(codes).to(dev)))
    cases.append(check_packed("soak_zoo_6", members, list(SOAK_PACK_ROWS),
                              "soak"))
    return cases


def soak_phase(workdir: str, smi: str, dev=None) -> dict:
    """The ``soak`` phase: ``tools/fuzz_soak.py``'s profiles on the card
    (docstring item 29). The stateful profile's workers are processes of
    their own, so it runs in a thread beside the in-process profiles,
    and the phase waits for it whether they pass or fail. ``dev``: the
    card (default: the current one)."""
    import torch

    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.compile import compile_pmml, qtrees_cuda
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file
    from flink_jpmml_tpu_torch.tools import fuzz_soak as fs
    from flink_jpmml_tpu_torch.utils.exceptions import DeviceUnavailableError

    t0 = time.perf_counter()
    dev = dev or torch.device("cuda", torch.cuda.current_device())
    lines = []
    stateful = {}

    def run_stateful():
        try:
            stateful["r"] = fs.soak(
                "stateful-chaos", fs.soak_stateful_chaos,
                SOAK_STATEFUL_SEEDS, SOAK_START, dev, log=lines.append)
        except BaseException as e:  # raised in the phase's thread below
            stateful["error"] = e

    side = threading.Thread(target=run_stateful, name="soak-stateful",
                            daemon=True)
    side.start()
    try:
        reset(qtrees_cuda.leaf_rows)
        qtrees_cuda.leaf_rows_packed.launches = 0
        qtrees_cuda.leaf_rows_packed.launches_by_classes = {}
        runs = {fam: fs.soak(fam, fn, SOAK_FAMILY_SEEDS, SOAK_START, dev,
                             log=lines.append)
                for fam, fn in fs.FAMILIES.items()}
        full = compile_pmml(parse_pmml_file(gen_gbm(
            workdir, n_trees=500, depth=6, n_features=32, seed=11,
            name="soak_gbm_500.pmml")), batch_size=32, device=dev)
        if full.quantized_scorer().backend != "cuda":
            raise RuntimeError("soak: config 2's GBM not on the kernel")
        runs["chaos"] = fs.soak("chaos", fs.soak_chaos, SOAK_CHAOS_SEEDS,
                                SOAK_START, dev, log=lines.append)
        runs["chaos_config2"] = fs.soak(
            "chaos-config2", fs.soak_chaos, SOAK_CHAOS_FULL_SEEDS,
            SOAK_START, dev, log=lines.append, model=full)
        runs["zoo"] = fs.soak("zoo-chaos", fs.soak_zoo_chaos,
                              SOAK_ZOO_SEEDS, SOAK_START, dev,
                              log=lines.append)
        launches_c1 = qtrees_cuda.leaf_rows.launches
        by_classes = dict(qtrees_cuda.leaf_rows.launches_by_classes)
        launches_packed = qtrees_cuda.leaf_rows_packed.launches
        # the mesh profile needs four cards: on one it must refuse
        try:
            fs.main(["--chaos", "--mesh", "--seeds", "1", "--platform",
                     "cuda"])
        except DeviceUnavailableError as e:
            refusal = str(e)
        else:
            raise RuntimeError("soak: the mesh profile ran on "
                               f"{torch.cuda.device_count()} card(s)")
        if f"found {torch.cuda.device_count()}" not in refusal:
            raise RuntimeError(f"soak: the mesh refusal names no count: "
                               f"{refusal}")
        cases = soak_kernel_checks(
            {"chaos_gbm4": fs.chaos_model(dev), "config2_gbm500": full},
            fs.zoo_docs(), dev)
    finally:
        side.join()
    if "error" in stateful:
        raise RuntimeError(f"soak: stateful profile: "
                           f"{stateful['error']!r}") from stateful["error"]
    runs["stateful"] = stateful["r"]
    failed = {k: r["failed"] for k, r in runs.items() if r["failed"]}
    if failed:
        raise RuntimeError(f"soak: failed seeds {failed}:\n"
                           + "\n".join(lines[-40:]))
    if launches_c1 <= 0 or launches_packed <= 0:
        raise RuntimeError(f"soak: {launches_c1} leaf_rows and "
                           f"{launches_packed} packed launches")
    return {
        "nvidia_smi": smi, "seconds": time.perf_counter() - t0,
        "start": SOAK_START, "cuts": SOAK_CUTS,
        "families": {fam: {"clean": runs[fam]["ok"],
                           "seeds": runs[fam]["seeds"],
                           "max_abs_err": max(runs[fam]["results"]),
                           "seconds": runs[fam]["seconds"]}
                     for fam in fs.FAMILIES},
        **{k: runs[k]["results"] for k in
           ("chaos", "chaos_config2", "zoo", "stateful")},
        "profile_seconds": {k: runs[k]["seconds"] for k in
                            ("chaos", "chaos_config2", "zoo", "stateful")},
        "mesh_refusal": refusal, "lines": lines,
        "launches_c1": launches_c1, "launches_by_classes": by_classes,
        "launches_packed": launches_packed, "kernel_cases": cases,
    }


AB_CHILD = r"""
import json, os, shutil, sys, tempfile
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np
import chip_smoke as cs
from flink_jpmml_tpu_torch.compile import qtrees_cuda
from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource
assert os.path.dirname(os.path.abspath(cs.__file__)) == tree
scratch = tempfile.mkdtemp(prefix="fjt-ab-")
os.environ["FJT_FLIGHT_DIR"] = os.path.join(scratch, "flight")
try:
    qtrees_cuda.build()
    _, cm, q = cs.model_tables(scratch, 500, "gbm_500.pmml")
    data = cs.features(np.random.default_rng(0), 4 * cs.DISPATCH, 32)
    q.predict_fused(data[:cs.BATCH])
    runs = []
    for _ in range(int(sys.argv[2])):
        count = [0]
        def sink(out, n, first, count=count):
            count[0] += n
        r = cs.drive(cm, CyclingBlockSource(data, block_size=cs.DISPATCH),
                     sink, count, qtrees_cuda.leaf_rows)
        runs.append(r["records_per_s"])
    print(json.dumps({"records_per_s": runs}), flush=True)
finally:
    shutil.rmtree(scratch, ignore_errors=True)
"""


def ab_main(other: str, rounds: int = 2, runs: int = 5) -> int:
    """``python3 chip_smoke.py --ab OTHER_CHECKOUT``: the fused GBM's
    ``BlockPipeline`` (``drive``: 16 dispatches of 262,144, the main
    path's model) in child processes alternating between another
    checkout and this one, in the order other, this, this, other, each
    ``rounds`` times, ``runs`` runs a child; prints each child's
    records/s, then a line with both sides' medians and quartiles and
    the pairs this checkout won (run i of a child against run i of its
    neighbour in the order)."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    print(nvidia_smi_line(), flush=True)
    order = [other, here, here, other] * rounds
    got = []
    for tree in order:
        res = subprocess.run(
            [sys.executable, "-c", AB_CHILD, tree, str(runs)], cwd=tree,
            capture_output=True, text=True, timeout=600)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        if res.returncode or not lines:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        rps = json.loads(lines[-1])["records_per_s"]
        side = "this" if tree == here else "other"
        got.append((side, rps))
        emit({"ab": side, "tree": tree, "records_per_s": rps})
    wins = pairs = 0
    for (sa, ra), (sb, rb) in zip(got[0::2], got[1::2]):
        this, oth = (ra, rb) if sa == "this" else (rb, ra)
        pairs += len(this)
        wins += sum(t > o for t, o in zip(this, oth))

    def quart(side):
        v = sorted(x for sd, r in got if sd == side for x in r)
        q = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}

    emit({"ab_summary": {"this": quart("this"), "other": quart("other"),
                         "pairs": pairs, "this_won": wins}})
    return 0


AB_PACKED_CHILD = r"""
import json, os, statistics, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import numpy as np
import torch
from flink_jpmml_tpu_torch.compile import qtrees_cuda
assert os.path.abspath(qtrees_cuda.__file__).startswith(tree + os.sep)
qtrees_cuda.build()
data = np.load(sys.argv[2])
reps = int(sys.argv[3])
out = {}
for label in sys.argv[4].split(","):
    n = int(data[label + "/n"])
    rows = [int(r) for r in data[label + "/rows"]]
    fields = [int(f) for f in data[label + "/fields"]]
    codes = torch.from_numpy(data[label + "/codes"]).cuda()
    tables = [{k: torch.from_numpy(data[f"{label}/{m}/{k}"]).cuda()
               for k in qtrees_cuda.TABLE_KEYS} for m in range(n)]
    got = qtrees_cuda.leaf_rows_packed(codes, rows, tables, fields)
    ref = qtrees_cuda.leaf_rows_packed_reference(codes, rows, tables, fields)
    ok = all(torch.equal(g, r) for g, r in zip(got, ref))
    for _ in range(5):
        qtrees_cuda.leaf_rows_packed(codes, rows, tables, fields)
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        qtrees_cuda.leaf_rows_packed(codes, rows, tables, fields)
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    out[label] = {"ok": ok, "median_ms": statistics.median(times)}
print(json.dumps(out), flush=True)
"""


AB_STATE_CHILD = r"""
import json, sys, tempfile, time
tree, batches = sys.argv[1], int(sys.argv[2])
B, keys, capacity = (int(v) for v in sys.argv[3:6])
sys.path.insert(0, tree)
import numpy as np
import torch
from flink_jpmml_tpu_torch.assets_gen import gen_gbm
from flink_jpmml_tpu_torch.compile import compile_pmml, statekernel
from flink_jpmml_tpu_torch.pmml import parse_pmml_file
from flink_jpmml_tpu_torch.runtime.engine import new_staging
from flink_jpmml_tpu_torch.runtime.pipeline import dispatch_quantized
from flink_jpmml_tpu_torch.runtime.state import KeyedStateTable, StateSpec
pmml = gen_gbm(tempfile.mkdtemp(), n_trees=20, depth=4, n_features=8,
               seed=29, name="stateful.pmml")
q = compile_pmml(parse_pmml_file(pmml), batch_size=B).quantized_scorer()
rng = np.random.default_rng(29)
pool = rng.normal(0.0, 1.0, (batches * B, 8)).astype(np.float32)
zipf = ((rng.zipf(1.1, size=batches * B) - 1) % keys).astype(np.int64)
spec = StateSpec(capacity=capacity, key_col=0)
stream = torch.cuda.Stream()
staging = new_staging(q.device)

def run(n):
    t = KeyedStateTable(spec)
    with torch.cuda.stream(stream):
        window = []
        t0 = time.perf_counter()
        for b in range(n):
            off = b * B
            window.append(dispatch_quantized(
                q, pool[off:off + B], staging=staging, state=t,
                state_keys=zipf[off:off + B],
                offsets=np.arange(off, off + B, dtype=np.int64)))
            if len(window) > 2:
                window.pop(0).synchronize()
        for w in window:
            w.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n, t

run(2)
zipf_ms, t = run(batches)
slots, reset, rel, w = t.assign_slots(zipf[:B].astype(np.uint32),
                                      np.arange(B, dtype=np.int64))
score = torch.zeros(B, device=q.device)
times = []
for i in range(23):
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    statekernel._state_step(t.values, score, slots, rel, w, reset,
                            t.scratch, spec.decay)
    e1.record()
    e1.synchronize()
    if i >= 3:
        times.append(e0.elapsed_time(e1))
print(json.dumps({"zipf_ms_per_batch": zipf_ms,
                  "step_ms": float(np.median(times))}))
"""


def ab_state_main(other: str, rounds: int = 3, batches: int = 64) -> int:
    """``python3 chip_smoke.py --ab OTHER_CHECKOUT state``: the stateful
    drill's zipf mix (``stateful_drill``'s model, table and key stream,
    ``batches`` batches of STATE_BATCH, two in flight) and one state step
    of it (CUDA events, the median of 20, the operands' copies included,
    as ``split.card_step_ms_per_batch``) in child processes alternating
    between another checkout and this one, in the order other, this,
    this, other, ``rounds`` times; then a line with both sides' medians
    and the pairs this checkout won."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    got = []
    for tree in [other, here, here, other] * rounds:
        res = subprocess.run(
            [sys.executable, "-c", AB_STATE_CHILD, tree, str(batches),
             str(STATE_BATCH), str(STATE_KEYS), str(STATE_CAPACITY)],
            cwd=tree, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        if res.returncode or not lines:
            print(res.stderr[-2000:], file=sys.stderr)
            return 1
        side = "this" if tree == here else "other"
        run = json.loads(lines[-1])
        got.append((side, run))
        emit({"ab_state": side, "tree": tree, **run})
    summary = {}
    for key in ("zipf_ms_per_batch", "step_ms"):
        ms = {sd: [r[key] for s2, r in got if s2 == sd]
              for sd in ("this", "other")}
        wins = pairs = 0
        for (sa, ra), (sb, rb) in zip(got[0::2], got[1::2]):
            this, oth = (ra, rb) if sa == "this" else (rb, ra)
            pairs += 1
            wins += this[key] < oth[key]
        med = {sd: statistics.median(v) for sd, v in ms.items()}
        summary[key] = {"this": med["this"], "other": med["other"],
                        "this_over_other": med["this"] / med["other"],
                        "runs": ms, "pairs": pairs, "this_won": wins}
    emit({"ab_state_summary": summary, "nvidia_smi": smi})
    return 0


def ab_packed_main(other: str, rounds: int = 3, reps: int = 60) -> int:
    """``python3 chip_smoke.py --ab OTHER_CHECKOUT packed``: the packed
    launch at ``PACK_TIMED`` (inputs built once here from the seeds of
    ``pack_members`` and handed to both sides in a file) in child
    processes alternating between another checkout and this one, in the
    order other, this, this, other, ``rounds`` times. Each child checks
    its sums bit for bit against its plain version and prints the
    CUDA-event median of ``reps`` launches a shape; then a line with
    both sides' medians a shape, this side's over the other's, and the
    pairs this checkout won."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    scratch = tempfile.mkdtemp(prefix="fjt-ab-packed-")
    try:
        packs = pack_members(scratch, zoo_doc_paths(scratch))
        arrays = {}
        for label in PACK_TIMED:
            members, rows = packs[label]
            arrays[label + "/n"] = np.array(len(members))
            arrays[label + "/rows"] = np.array(rows)
            arrays[label + "/fields"] = np.array(
                [c.shape[1] for _, c in members])
            arrays[label + "/codes"] = packed_codes(members, rows).cpu(
                ).numpy()
            for m, (t, _) in enumerate(members):
                for k in qtrees_cuda.TABLE_KEYS:
                    arrays[f"{label}/{m}/{k}"] = t[k].cpu().numpy()
        inputs = os.path.join(scratch, "packs.npz")
        np.savez(inputs, **arrays)
        got = []
        for tree in [other, here, here, other] * rounds:
            res = subprocess.run(
                [sys.executable, "-c", AB_PACKED_CHILD, tree, inputs,
                 str(reps), ",".join(PACK_TIMED)], cwd=tree,
                capture_output=True, text=True, timeout=600)
            lines = [ln for ln in res.stdout.splitlines()
                     if ln.startswith("{")]
            if res.returncode or not lines:
                print(res.stderr[-2000:], file=sys.stderr)
                return 1
            side = "this" if tree == here else "other"
            run = json.loads(lines[-1])
            if not all(r["ok"] for r in run.values()):
                emit({"ab_packed": side, "tree": tree, "shapes": run})
                print("chip_smoke: a packed launch differs from its plain "
                      "version", file=sys.stderr)
                return 1
            got.append((side, run))
            emit({"ab_packed": side, "tree": tree, "shapes": run})
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    summary = {}
    for label in PACK_TIMED:
        ms = {sd: [r[label]["median_ms"] for s2, r in got if s2 == sd]
              for sd in ("this", "other")}
        wins = pairs = 0
        for (sa, ra), (sb, rb) in zip(got[0::2], got[1::2]):
            this, oth = (ra, rb) if sa == "this" else (rb, ra)
            pairs += 1
            wins += this[label]["median_ms"] < oth[label]["median_ms"]
        med = {sd: statistics.median(v) for sd, v in ms.items()}
        summary[label] = {"this_ms": med["this"], "other_ms": med["other"],
                          "this_over_other": med["this"] / med["other"],
                          "runs": ms, "pairs": pairs, "this_won": wins}
    emit({"ab_packed_summary": summary, "nvidia_smi": smi})
    return 0


def back_to_back_ms(fn, warmup: int, repeats: int) -> float:
    """Milliseconds a call of ``fn()`` when ``repeats`` calls are queued
    back to back between two CUDA events: the device's time a launch
    wherever it exceeds the host's."""
    import torch

    for _ in range(warmup):
        fn()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(repeats):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / repeats


def packed_sweep_main() -> int:
    """``python3 chip_smoke.py --packed-sweep``: the packed launch at every
    block of ``qtrees_cuda.PACKED_BLOCKS`` (the shape rule held to one
    candidate at a time) over the packs of ``PACK_TIMED`` and the eight
    main-path members at 4,096 rows each. Each shape is checked bit for
    bit against the plain version and timed as ``cuda_ms`` times it (one
    launch between events, the wrapper's host work included) and back to
    back (``back_to_back_ms``); a line a pack lists them fastest first
    beside the shape the rule picks, then the solo launch at 262,144 rows
    of the first main-path member is timed the same two ways, and last
    comes the ``nvidia-smi`` line."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    qtrees_cuda.build()
    scratch = tempfile.mkdtemp(prefix="fjt-packed-sweep-")
    every = qtrees_cuda.PACKED_BLOCKS
    ok = True
    try:
        packs = pack_members(scratch, zoo_doc_paths(scratch))
        mains = packs["main8_16384"][0]
        packs["main8_4096"] = (mains, [4096] * len(mains))
        for label in PACK_TIMED + ("main8_4096",):
            members, rows = packs[label]
            codes = packed_codes(members, rows)
            tables = [t for t, _ in members]
            fields = [c.shape[1] for _, c in members]
            classes = max(int(t["rows"].shape[2]) for t in tables)
            ref = qtrees_cuda.leaf_rows_packed_reference(codes, rows, tables,
                                                         fields)
            chosen = pack_shape_of(members, rows)
            runs = []
            for block in every:
                qtrees_cuda._PLANS.clear()
                qtrees_cuda.PACKED_BLOCKS = (block,)
                qtrees_cuda._packed_shape.cache_clear()
                try:
                    shape = pack_shape_of(members, rows)
                    # the plan this launch builds keeps the candidate's
                    # shape for the timed launches below
                    got = qtrees_cuda.leaf_rows_packed(codes, rows, tables,
                                                       fields)
                except ValueError:
                    continue
                finally:
                    qtrees_cuda.PACKED_BLOCKS = every
                    qtrees_cuda._packed_shape.cache_clear()

                def fn():
                    return qtrees_cuda.leaf_rows_packed(codes, rows, tables,
                                                        fields)

                same = all(torch.equal(g, r) for g, r in zip(got, ref))
                ok &= same
                runs.append({
                    "threads": shape.threads,
                    "records_per_thread": shape.records_per_thread,
                    "blocks": shape.n_blocks, "smem_bytes": shape.smem,
                    "resident_blocks_per_sm":
                        qtrees_cuda.packed_resident_on_card(shape, classes),
                    "ok": same, "ms": cuda_ms(fn, 5, 40),
                    "back_to_back_ms": back_to_back_ms(fn, 5, 40)})
                qtrees_cuda._PLANS.clear()
            runs.sort(key=lambda r: r["back_to_back_ms"])
            emit({"packed_sweep": label, "rows": sum(rows),
                  "members": len(members),
                  "rule": [chosen.threads, chosen.records_per_thread],
                  "shapes": runs})
        t0m, c0 = mains[0]
        big = c0.repeat(-(-262144 // c0.shape[0]), 1)[:262144].contiguous()
        solo = (lambda: qtrees_cuda.leaf_rows(big, t0m, c0.shape[1]))
        emit({"packed_sweep": "solo_262144", "ms": cuda_ms(solo, 3, 20),
              "back_to_back_ms": back_to_back_ms(solo, 3, 20)})
    finally:
        qtrees_cuda.PACKED_BLOCKS = every
        qtrees_cuda._packed_shape.cache_clear()
        qtrees_cuda._PLANS.clear()
        shutil.rmtree(scratch, ignore_errors=True)
    print(smi, flush=True)
    if not ok:
        print("chip_smoke: a packed launch differs from its plain version",
              file=sys.stderr)
        return 1
    return 0


def main(phase: str = None) -> int:
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if importlib.util.find_spec("flink_jpmml_tpu_torch") is None:
        print("chip_smoke: the port (flink_jpmml_tpu_torch) is not beside "
              "this script; run it from the root of a checkout",
              file=sys.stderr)
        return 1
    # the flight recorder, the model files and the autotune cache (with
    # the kernel cost ledger and the cost model beside it) live in
    # temporary directories that the run removes
    scratch = tempfile.mkdtemp(prefix="fjt-smoke-")
    os.environ["FJT_FLIGHT_DIR"] = os.path.join(scratch, "flight")
    os.environ["FJT_AUTOTUNE_CACHE"] = os.path.join(scratch, "autotune",
                                                    "autotune.json")
    try:
        if phase is not None:
            return run_phase_alone(scratch, phase)
        return run_phases(scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def run_phase_alone(workdir: str, phase: str) -> int:
    """``python3 chip_smoke.py --phase NAME``: one phase of the whole
    run, alone in a fresh process. It builds what the phase needs (the
    kernel; the 500-tree GBM and the 3-class vote forest compiled on the
    card, each with the scorer's own encode placement, fused on the card,
    as the whole run leaves them), prints the card's line and the phase's
    line as the whole run does, and exits 0 only if the phase passed."""
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda

    smi = nvidia_smi_line()
    emit({"phase": "card", "nvidia_smi": smi,
          "torch_device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if phase == "mesh":  # no kernel runs on the mesh's f32 paths
        emit({"phase": "mesh", **mesh_phase(workdir, smi)})
        print(smi, flush=True)
        return 0
    qtrees_cuda.build()
    if phase == "fleet":  # the workers compile their own models
        _, _, q = model_tables(workdir, 500, "gbm_500.pmml")
        emit({"phase": "fleet", **fleet(workdir, q, smi)})
        print(smi, flush=True)
        return 0
    if phase == "soak":  # the soak compiles its own models
        emit({"phase": "soak", **soak_phase(workdir, smi)})
        print(smi, flush=True)
        return 0
    if phase == "cli":  # no vote forest on this path
        _, cm, q = model_tables(workdir, 500, "gbm_500.pmml")
        q.predict_fused(features(np.random.default_rng(0), BATCH,
                                 len(q.wire.fields)))
        torch.cuda.synchronize()
        emit({"phase": "cli",
              **cli_phase(workdir, cm, q, qtrees_cuda.leaf_rows, smi)})
        print(smi, flush=True)
        return 0
    _, cm, q = model_tables(workdir, 500, "gbm_500.pmml")
    _, _, vq = model_tables(workdir, 500, "votes_500.pmml", votes=dict(
        depth=6, n_features=32, n_classes=3, seed=0))
    F = len(q.wire.fields)
    for s in (q, vq):
        s.predict_fused(features(np.random.default_rng(0), BATCH, F))
    torch.cuda.synchronize()
    if phase == "serving_edge":
        edge = serving_edge(workdir, qtrees_cuda.leaf_rows, q, vq, cm, smi)
        emit({"phase": "serving_edge", **edge})
    elif phase == "kernel_search":
        ks = kernel_search(workdir, qtrees_cuda.leaf_rows, smi)
        emit({"phase": "kernel_search", **ks})
    elif phase == "zoo_state":
        zs = zoo_state(workdir, smi)
        emit({"phase": "zoo_state", **zs})
    elif phase == "rollout_drift":
        rd = rollout_drift(workdir, cm, q, smi)
        emit({"phase": "rollout_drift", **rd})
    elif phase == "kafka_keyed_topic":
        kk = kafka_keyed_topic(workdir, cm, q, qtrees_cuda.leaf_rows)
        emit({"phase": "kafka_keyed_topic", **kk})
    else:
        raise ValueError(f"no phase {phase!r} runs alone")
    print(smi, flush=True)
    return 0


def run_phases(workdir: str) -> int:
    import torch

    from flink_jpmml_tpu_torch.compile import qtrees_cuda
    from flink_jpmml_tpu_torch.compile.compiler import compile_pmml
    from flink_jpmml_tpu_torch.compile.qtrees import _match_ensemble, _torch_qfn
    from flink_jpmml_tpu_torch.runtime.block import CyclingBlockSource

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "torch_device": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t_run = t0 = time.perf_counter()
    qtrees_cuda.build()
    ptxas = qtrees_cuda.ptxas_report()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
          "arch": "sm_90a", "ptxas": ptxas})
    if not ptxas or any(k.get("spill_stores", 1) or k.get("spill_loads", 1)
                        for k in ptxas):
        raise RuntimeError("ptxas reported spills (or no report)")

    rng = np.random.default_rng(0)
    doc, cm, q = model_tables(workdir, 500, "gbm_500.pmml")
    _, _, q19 = model_tables(workdir, 19, "gbm_19.pmml")
    F = len(q.wire.fields)

    # -- the C++ host plane (before anything else encodes) -------------------
    from flink_jpmml_tpu_torch.assets_gen import gen_gbm
    from flink_jpmml_tpu_torch.pmml import parse_pmml_file

    doc16 = parse_pmml_file(gen_gbm(workdir, n_trees=500, name="gbm_u16.pmml",
                                    hist_bins=None))
    q16 = compile_pmml(doc16, batch_size=1024).quantized_scorer()
    q16_cpu = compile_pmml(doc16, batch_size=1024,
                           device="cpu").quantized_scorer()
    if q16.wire.dtype is not np.uint16 or not q16.supports_fused:
        raise RuntimeError(f"gbm_u16: wire {q16.wire.dtype}, fused "
                           f"{q16.supports_fused}")
    nat = check_native(np.random.default_rng(2), [
        ("gbm500_u8_lockstep", q.wire, "lockstep", DISPATCH),
        ("skewed_u8_ragged", synthetic_wire(3, skewed_sizes(F, 200), np.uint8),
         "ragged", 100_003),
        ("gbm500_u16_lockstep", q16.wire, "lockstep", 100_003),
        ("skewed_u16_ragged",
         synthetic_wire(4, skewed_sizes(F, 3000), np.uint16), "ragged",
         100_003),
    ])
    emit({"phase": "native", **nat})
    X_main = features(rng, DISPATCH, F)
    rows = [
        check_kernel(q, X_main, "gbm500_262144", "kernel"),
        check_kernel(q19, features(rng, 65536, F), "gbm19_65536", "kernel"),
        check_kernel(q, features(rng, 100_003, F), "gbm500_ragged_100003",
                     "kernel"),
    ]
    emit({"phase": "kernel", "cases": rows})
    # its own generator, so the main paths' data stay as they were
    wrows = check_walk_cases(np.random.default_rng(1))
    emit({"phase": "walk_kernel", "cases": wrows})
    timing = time_kernel(q, X_main)
    emit({"phase": "timing", **timing})

    # -- main path ---------------------------------------------------------
    data = features(rng, 4 * DISPATCH, F)
    sample = 4096
    kept = {}
    count = [0]

    def sink(out, n, first_off):
        vals = np.asarray(out)
        if vals.ndim != 1 or vals.shape[0] < n:
            raise RuntimeError(f"sink got {vals.shape} for {n} records")
        if first_off == 0:
            kept["head"] = vals[:sample].copy()
        count[0] += n

    # warm the path once outside the counted window; the host encode is
    # asked for by hand (the card's default is the fused placement)
    q.encode_mode = "host"
    q.predict_wire(q.wire.encode(data[:BATCH]))
    torch.cuda.synchronize()
    run = drive(cm, CyclingBlockSource(data, block_size=DISPATCH), sink, count,
                qtrees_cuda.leaf_rows)

    cm_cpu = compile_pmml(doc, batch_size=BATCH, device="cpu")
    q_cpu = cm_cpu.quantized_scorer()
    ref = np.asarray(q_cpu.predict_padded(q_cpu.wire.encode(data[:sample])))
    head = kept["head"]
    if head.shape != (sample,) or not np.isfinite(head).all():
        raise RuntimeError(f"main path output {head.shape} not finite")
    err = float(np.abs(head - ref).max())
    if not np.allclose(head, ref, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"main path disagrees with the CPU port: {err}")
    # the torch twin reads P_i8 / count_i8, not the packed masks, so a
    # packing fault that shows only at 500 trees / depth 6 fails here
    twin = _torch_qfn(_match_ensemble(doc)[2], False, True,
                      q.wire.sentinel, doc.targets)
    with torch.no_grad():
        twin_out = twin(q.params, torch.from_numpy(
            q.wire.encode(data[:sample])).cuda()).cpu().numpy()
    twin_err = float(np.abs(head - twin_out).max())
    if not np.allclose(head, twin_out, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"main path disagrees with the torch twin on the "
                           f"unpacked tables: {twin_err}")
    emit({
        "phase": "main_path", **run,
        "cpu_backend": f"rank_wire_{q_cpu.backend}",
        "cpu_check_rows": sample, "cpu_check_max_abs_err": err,
        "twin_check_max_abs_err": twin_err,
    })

    # -- vote forest: kernel -----------------------------------------------
    vote_kw = dict(depth=6, n_features=32, n_classes=3, seed=0)
    vdoc, vcm, vq = model_tables(workdir, 500, "votes_500.pmml",
                                 votes=vote_kw)
    _, _, vq_w = model_tables(workdir, 500, "votes_w500.pmml",
                              votes=dict(vote_kw, weighted=True))
    _, _, vq19 = model_tables(workdir, 19, "votes_19.pmml", votes=vote_kw)
    _, _, vq_c10 = model_tables(workdir, 500, "votes_c10.pmml",
                                votes=dict(vote_kw, n_classes=10))
    vrows = [
        check_kernel(vq, X_main, "votes500_262144", "vote_kernel"),
        check_kernel(vq_w, X_main, "weighted500_262144", "vote_kernel"),
        check_kernel(vq19, features(rng, 65536, F), "votes19_65536",
                     "vote_kernel"),
        check_kernel(vq_c10, features(rng, 65536, F), "votes500_c10_65536",
                     "vote_kernel"),
        check_kernel(vq, features(rng, 100_003, F), "votes500_ragged_100003",
                     "vote_kernel"),
    ]
    emit({"phase": "vote_kernel", "cases": vrows})
    vtiming = time_kernel(vq, X_main)
    emit({"phase": "vote_timing", **vtiming})

    # -- vote forest: main path ----------------------------------------------
    vkept = {}
    vcount = [0]
    C = len(vq.labels)

    def vote_sink(out, n, first_off):
        value, probs, lab = (np.asarray(o) for o in out)
        if (value.ndim != 1 or value.shape[0] < n
                or probs.shape != (value.shape[0], C)
                or lab.shape != value.shape):
            raise RuntimeError(f"vote sink got {value.shape} / {probs.shape}"
                               f" / {lab.shape} for {n} records")
        if first_off == 0:
            vkept["head"] = tuple(a[:sample].copy()
                                  for a in (value, probs, lab))
        vcount[0] += n

    vq.encode_mode = "host"
    vq.predict_wire(vq.wire.encode(data[:BATCH]))
    torch.cuda.synchronize()
    vrun = drive(vcm, CyclingBlockSource(data, block_size=DISPATCH), vote_sink,
                 vcount, qtrees_cuda.leaf_rows)

    head_codes = vq.wire.encode(data[:sample])
    counts = vote_counts(vq, torch.from_numpy(head_codes).cuda())
    vq_cpu = compile_pmml(vdoc, batch_size=BATCH,
                          device="cpu").quantized_scorer()
    cpu_ref = [o.numpy()[:sample] for o in vq_cpu.predict_padded(
        *vq_cpu.pad_wire(head_codes))]
    cpu_check = check_votes(vkept["head"], cpu_ref, counts, "CPU port")
    vtwin = _torch_qfn(_match_ensemble(vdoc)[2], True, False,
                       vq.wire.sentinel, vdoc.targets)
    with torch.no_grad():
        twin_ref = [o.cpu().numpy() for o in vtwin(
            vq.params, torch.from_numpy(head_codes).cuda())]
    twin_check = check_votes(vkept["head"], twin_ref, counts, "torch twin")
    emit({
        "phase": "vote_main_path", **vrun,
        "cpu_backend": f"rank_wire_{vq_cpu.backend}",
        "check_rows": sample, "cpu_check": cpu_check,
        "twin_check": twin_check,
    })

    # -- the device encode stage ----------------------------------------------
    enc = check_encode_stage(np.random.default_rng(3), [
        ("gbm500_u8", q, DISPATCH), ("votes500_u8", vq, 100_003),
        ("gbm500_u16", q16, 100_003),
    ], q16_cpu)
    emit({"phase": "encode_stage", **enc})

    # -- the main paths again, fused: raw f32 ships, encoded on the card -----
    # (the scorer's own choice on the card, with no encode_mode set)
    q.encode_mode = None
    fkept = {}
    fcount = [0]

    def fused_sink(out, n, first_off):
        vals = np.asarray(out)
        if vals.ndim != 1 or vals.shape[0] < n:
            raise RuntimeError(f"sink got {vals.shape} for {n} records")
        if first_off == 0:
            fkept["head"] = vals[:sample].copy()
        fcount[0] += n

    q.predict_fused(data[:BATCH])
    torch.cuda.synchronize()
    frun = drive(cm, CyclingBlockSource(data, block_size=DISPATCH),
                 fused_sink, fcount, qtrees_cuda.leaf_rows)
    if frun["encode_mode"] != "fused" or frun["h2d_bytes_per_record"] != 4 * F:
        raise RuntimeError(f"fused main path ran {frun['encode_mode']} with "
                           f"{frun['h2d_bytes_per_record']} bytes a record")
    fhead = fkept["head"]
    ferr = float(np.abs(fhead - ref).max())
    if (fhead.shape != (sample,) or not np.isfinite(fhead).all()
            or not np.allclose(fhead, ref, rtol=RTOL, atol=ATOL)):
        raise RuntimeError(f"fused main path disagrees with the CPU port: "
                           f"{ferr}")
    emit({"phase": "fused_main_path", **frun, "cpu_check_rows": sample,
          "cpu_check_max_abs_err": ferr,
          "host_path_max_abs_diff": float(np.abs(fhead - head).max())})

    vq.encode_mode = None
    vfkept = {}

    def vote_fused_sink(out, n, first_off):
        if first_off == 0:
            vfkept["head"] = tuple(np.asarray(o)[:sample].copy() for o in out)
        vote_sink(out, n, first_off)

    vq.predict_fused(data[:BATCH])
    torch.cuda.synchronize()
    vcount[0] = 0
    vfrun = drive(vcm, CyclingBlockSource(data, block_size=DISPATCH),
                  vote_fused_sink, vcount, qtrees_cuda.leaf_rows)
    if (vfrun["encode_mode"] != "fused"
            or vfrun["h2d_bytes_per_record"] != 4 * F):
        raise RuntimeError(f"vote fused path ran {vfrun['encode_mode']} with "
                           f"{vfrun['h2d_bytes_per_record']} bytes a record")
    vf_check = check_votes(vfkept["head"], cpu_ref, counts, "CPU port, fused")
    emit({"phase": "vote_fused_main_path", **vfrun, "check_rows": sample,
          "cpu_check": vf_check})
    # -- the GBM fed from a Kafka stream on loopback, fused ------------------
    # 1,048,576 rows of the feature stream (128 MiB of values), the same
    # generator as the main paths' data, seed 0
    kdata = features(np.random.default_rng(0), 4 * DISPATCH, F)
    kref = np.asarray(q_cpu.predict_padded(q_cpu.wire.encode(kdata[:sample])))
    broker, wire = kafka_wire(kdata)
    try:
        emit({"phase": "kafka_wire", **wire})
        krun = kafka_main_path(cm, broker, F, qtrees_cuda.leaf_rows, None,
                               sample, kref)
        emit({"phase": "kafka_main_path", **krun})
        ksrun = kafka_main_path(cm, broker, F, qtrees_cuda.leaf_rows, False,
                                sample, kref)
        emit({"phase": "kafka_main_path_serial", **ksrun})
    finally:
        broker.close()
    # -- the GBM over a keyed, compacted topic, resumed from its offset
    # vector ----------------------------------------------------------------
    kk = kafka_keyed_topic(workdir, cm, q, qtrees_cuda.leaf_rows)
    emit({"phase": "kafka_keyed_topic", **kk})
    emit({"phase": "device_shares",
          "main_path": device_shares(run, timing["kernel_ms"], 0.0,
                                     enc["h2d_codes_ms"]),
          "vote_main_path": device_shares(vrun, vtiming["kernel_ms"], 0.0,
                                          enc["h2d_codes_ms"]),
          "fused_main_path": device_shares(frun, timing["kernel_ms"],
                                           enc["stage_ms"], enc["h2d_f32_ms"]),
          "vote_fused_main_path": device_shares(
              vfrun, vtiming["kernel_ms"], enc["stage_ms"],
              enc["h2d_f32_ms"]),
          # timed at the Kafka paths' own dispatch shapes
          "kafka_main_path": kafka_device_shares(
              krun, q, np.random.default_rng(5)),
          "kafka_main_path_serial": kafka_device_shares(
              ksrun, q, np.random.default_rng(5))})

    # -- the dense families on the f32 backend (no kernel on these paths) ---
    t0 = time.perf_counter()
    fam = family_paths(workdir)
    emit({"phase": "family_paths", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "configs": fam})

    # -- every tree shape real exporters write (no kernel on these paths) --
    t0 = time.perf_counter()
    shapes = tree_shapes(workdir)
    emit({"phase": "tree_shapes", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "configs": shapes})

    # -- the last nine families, the oracle's replay (no kernel either) -----
    t0 = time.perf_counter()
    more = more_families(workdir)
    emit({"phase": "more_families", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "configs": more})

    # -- the record API and dynamic serving (the kernel on both scorers) ----
    rec = record_api(workdir, qtrees_cuda.leaf_rows, q_cpu, vq_cpu)
    emit({"phase": "record_api", "nvidia_smi": smi, **rec})

    # -- recovery on both hot paths (the kernel in every part) --------------
    rcv = recovery(workdir, qtrees_cuda.leaf_rows, q, vq, cm, smi)
    emit({"phase": "recovery", **rcv})

    # -- the serving edge: overload, SLO, journeys, spans, TCP and HTTP ----
    edge = serving_edge(workdir, qtrees_cuda.leaf_rows, q, vq, cm, smi)
    emit({"phase": "serving_edge", **edge})

    # -- the kernel search, and the profiler on a tuned main path ---------
    ks = kernel_search(workdir, qtrees_cuda.leaf_rows, smi)
    emit({"phase": "kernel_search", **ks})

    # -- multi-tenant and stateful scoring: packs, the zoo, keyed state -----
    zs = zoo_state(workdir, smi)
    emit({"phase": "zoo_state", **zs})

    # -- the drift plane and staged rollouts (the kernel on both scorers) ---
    rdp = rollout_drift(workdir, cm, q, smi)
    emit({"phase": "rollout_drift", **rdp})

    # -- the parallel plane on the card's 1x1 mesh (no kernel here) ---------
    emit({"phase": "mesh", **mesh_phase(workdir, smi)})

    # -- the supervised fleet: workers on the card, the rollout broadcast ---
    flt = fleet(workdir, q, smi)
    emit({"phase": "fleet", **flt})

    # -- the operator's entry points: fjt-score, the redrive, two examples --
    cl = cli_phase(workdir, cm, q, qtrees_cuda.leaf_rows, smi)
    emit({"phase": "cli", **cl})

    # -- the parity soak and the chaos soaks, on the card -------------------
    sk = soak_phase(workdir, smi)
    emit({"phase": "soak", **sk})
    zoo_launches = zs["zoo"]["launches_solo_c1"]
    packed_checked = zs["packed_kernel"]["cases"]
    pt = zs["packed_kernel"]["timing"]

    def kernel_entry(name, replaces, runs, checked, t):
        return {
            "name": name, "route": "cuda",
            "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
            "replaces": replaces,
            "launches": sum(r["launches"] for r in runs.values()),
            "launches_by_path": {k: r["launches"] for k, r in runs.items()},
            # a path whose count can miss launches (a worker killed
            # between two of its beats) is named here
            "launches_lower_bound_paths": [
                k for k, r in runs.items() if r.get("lower_bound")],
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "ops": t["ops"],
        }

    emit({"phase": "run", "seconds": time.perf_counter() - t_run})
    # one kernel, four paths: each entry reads its own paths' launches
    emit({"kernels": [
        kernel_entry("qtrees_leaf_rows (regression sum, C=1)",
                     "flink_jpmml_tpu/compile/qtrees_pallas.py:170 and :218",
                     {"main_path": run, "fused_main_path": frun,
                      "kafka_main_path": krun,
                      "kafka_main_path_serial": ksrun,
                      "kafka_keyed_topic": {"launches": sum(
                          lv["launches"] for lv in kk["lives"])},
                      "record_static": rec["static"],
                      "record_quick": rec["quick"],
                      "record_dicts": rec["dicts"],
                      "record_dynamic": {
                          "launches": rec["dynamic"]["launches_gbm"]},
                      "record_kafka": rec["kafka"],
                      "recovery": {"launches": rcv["launches_c1"]},
                      "serving_edge": {"launches": edge["launches_c1"]},
                      "kernel_search": {"launches": ks["launches_c1"]},
                      "zoo_state": {"launches": zoo_launches},
                      "rollout_drift": {"launches": rdp["launches_c1"]},
                      "fleet": {"launches": flt["launches_c1"],
                                "lower_bound": True},
                      "cli": {"launches": cl["launches_c1"]},
                      "soak": {"launches": sk["launches_c1"]}},
                     rows + [r for r in wrows if r["classes"] == 1]
                     + cl["examples"]["kernel_cases"]
                     + [r for r in sk["kernel_cases"]
                        if r.get("classes") == 1], timing),
        kernel_entry("qtrees_leaf_rows (vote shares)",
                     "flink_jpmml_tpu/compile/qtrees_pallas.py:187 and :238",
                     {"vote_main_path": vrun, "vote_fused_main_path": vfrun,
                      "record_dynamic": {
                          "launches": rec["dynamic"]["launches_votes"]},
                      "recovery": {"launches": rcv["launches_c3"]},
                      "serving_edge": {"launches": edge["launches_c3"]},
                      "kernel_search": {"launches": ks["launches_c3"]}},
                     vrows + [r for r in wrows if r["classes"] > 1], vtiming),
        {
            "name": "qtrees_leaf_rows_packed (cross-model pack)",
            "route": "cuda",
            "source": "flink_jpmml_tpu_torch/csrc/qtrees_ensemble.cu",
            "replaces": "flink_jpmml_tpu/compile/qtrees_pallas.py:170 and "
                        ":218 (each member; flink_jpmml_tpu/compile/"
                        "packs.py:150 packs them in one program)",
            "launches": zs["zoo"]["launches_packed"] + sk["launches_packed"],
            "launches_by_path": {"zoo_state": zs["zoo"]["launches_packed"],
                                 "soak": sk["launches_packed"]},
            "max_abs_err": max(r["max_abs_err"] for r in packed_checked
                               + [r for r in sk["kernel_cases"]
                                  if "members" in r]),
            "ms": pt["packed_ms"], "plain_ms": pt["plain_ms"],
            "bound_ms": pt["bound_ms"], "bound_by": pt["bound_by"],
            "library_ms": None, "ops": pt["ops"],
            "solo_sequence_ms": pt["solo_sequence_ms"],
            "blocks": pt["blocks"], "threads": pt["threads"],
            "records_per_thread": pt["records_per_thread"],
            "smem_bytes": pt["smem_bytes"],
            "resident_blocks_per_sm": pt["resident_blocks_per_sm"],
            "share_of_bound": pt["share_of_bound"],
            # main8_16384 (131,072 rows) against the C = 1 launch at
            # 262,144 rows, both timed in this run
            "ms_over_c1_kernel_ms": pt["packed_ms"] / timing["kernel_ms"],
            # each timed pack: packed_ms, bound, share of bound and shape
            "shapes": [{k: v for k, v in sh.items()
                        if k not in ("ops", "bytes", "bytes_ms", "ops_ms")}
                       for sh in zs["packed_kernel"]["shapes"]],
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--packed-sweep"]:
        sys.exit(packed_sweep_main())
    if len(sys.argv) > 3 and sys.argv[1] == "--ab" and (
            sys.argv[3] == "packed"):
        sys.exit(ab_packed_main(sys.argv[2]))
    if len(sys.argv) > 3 and sys.argv[1] == "--ab" and (
            sys.argv[3] == "state"):
        sys.exit(ab_state_main(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--ab":
        sys.exit(ab_main(sys.argv[2]))
    if len(sys.argv) > 2 and sys.argv[1] == "--phase":
        sys.exit(main(sys.argv[2]))
    sys.exit(main())
