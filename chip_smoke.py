#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every CUDA kernel of the port from ``hdbscan_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) and print the card and its
   power limit;
2. hold each kernel against its plain PyTorch version on the card, bitwise
   (tolerance 0: the kernels are built with ``-fmad=false`` and repeat the
   plain versions' operation order): the segment-min (K1) and k-best (K2)
   kernels at 16,384 x 3 integer-grid points in both euclidean forms (K2 at
   min_pts 2, 16 and 129, i.e. k = 1, 15, 128) and at 8,192 x 7 continuous
   points, the union-find scan (K3) on a 16k-edge pool; and the four
   rp-forest kernels (B5 leaf top-k, B6 cross-tree fold, B7 rescan top-k,
   B8 candidate segment-min) at f32 on 16,384 x 3 integer-grid points,
   8,192 x 7 continuous points and 5,003 x 3 grid points with duplicates
   (uneven leaves), k = 1, 15 and 128, B5, B7 and B8 in bf16 as well, B6
   on the trees' bf16 leaf lists too (one pair's copies in two trees then
   differ), B8 with random, round-1, spatial-cell and single components,
   with exact weight ties and at row counts that cut the candidates into 3,
   13 and 64 spans; B6 on stacks whose cross-tree copies differ, with
   unequal sentinel tails and +inf entries with real ids, at 1, 3 and 65
   trees and kk 1, 15, 30 and 129, at every kk where a segment's width
   changes, and at kk 4,100 (lists in device memory); a bf16 forest query
   and a 65-tree rp-forest fit on the card equal to the same on the CPU; the
   segment-min compared bit for bit (weights as int32 patterns): equal
   weights on both sides of a column-split boundary, all-zero cores on a
   grid with duplicates, d from 1 to 200 in every metric, square and panel;
   the k-best body (K2, the rectangular B2, B3) bit for bit: equal
   distances on both sides of a column-split boundary, points duplicated
   more than k times, a split with fewer than k admissible columns, nx < k,
   nq below one block, every d instantiation boundary (1 to 128) at k = 1,
   7, 8, 9, 15, 16, 17, 32, 33 and 128 on every metric and form;
   every wide mode (K2, B2, B4 in both contracts, B5-B8) at d = 129 and 200
   and k = 129 and 200 on grids with duplicate ties and continuous points,
   and B3's refusal past 128; the rescan top-k (B7) bit for bit: exact
   ties at the k-th slot on integer grids (the lower id must win), one id
   copied many times inside a span and across spans, spans and rows with
   fewer live candidates than k and all-sentinel rows, k = 1 to 200, m
   below one block and at one row, every d instantiation boundary (1 to
   200) in f32 (both forms, manhattan, supremum) and bf16, and lists and
   query rows past their shared-memory budgets; the window k-best (B4)
   bit for bit: ``bnd`` at +inf, at 0 and equal to exact grid distances (a
   guard must not fire on equality), windows past n, k above a window's
   columns, k = 1 to 128 and row tiles of 1, 33 and 512 in every contract,
   and every d instantiation boundary; the union-find scan (K3, the batched
   replay) bit for bit on adversarial pools up to 1,048,576 vertices (a
   path whose every edge hangs the growing component under a fresh vertex,
   stars with the hub as u and as v, only padding self-loops, n = 1,
   m = 0, m >> n with duplicates, a random multigraph, a spanning path
   followed by only cycle edges, a shuffled tree with a padding tail),
   which cross up to ~2,000 of its 1,024-edge batches; the leaf top-k
   (B5) bit for bit: exact grid ties on both sides of the step and tile
   edges at the 3b and 3c batch shapes, masked columns in every metric and form,
   kk = the leaf width, leaves of one real member, bf16, every d
   instantiation boundary, lists in shared memory and in the output rows
   (kk 1,600), kk = 129 and 200 and d = 129 and 200;
3. run the exact fit (``hdbscan_tpu_torch.models.exact.fit``) on a seeded
   Skin-shaped set — 245,057 x 3 integer RGB values in [0, 255] — with
   min_points=16, min_cluster_size=3000: first check that the fit on the
   card equals the fit on the CPU (plain versions) on a 4,096-point subset,
   then run the full fit with the launch counters zeroed just before and
   read just after; check n - 1 MST edges under the round cap, finite core
   distances, and that every kernel of the path ran;
3b. the same data through the rp-forest tier (``knn_index=rpforest``,
   ``knn_backend=fused``, 4 trees, leaf 1024, one rescan round, f32 — the
   reference benchmark's forest config): the card's fit equals the CPU fit
   on a 4,096-point subset, then the full fit with counters must give n - 1
   edges, finite values and launches of B5, B6, B7 and B1; it prints the
   trace walls, ``recall_at_k`` (the query's, before the rescan) and the
   recall of the final lists, the share of rows whose core distance equals
   the exact tier's (and within 1e-4 relative: the exact tier may take the
   dot form) and the ARI of the labels against the exact fit;
3c. 1,048,576 x 8 blobs (6 centres x 6.0, unit normal, seed 0) with
   ``knn_index=auto``, which must resolve to the forest, min_points=16,
   min_cluster_size=5000: the same checks and lines, against the exact
   tier's core distances and the exact fit of the same data;
3d. the MR-HDBSCAN* pipeline (``hdbscan_tpu_torch.models.mr_hdbscan.fit``,
   data bubbles) in boundary mode, the reference's own boundary benchmark
   (``benchmarks/boundary_eval.py`` mode ``bound05``): the B4 window kernel
   against its plain version on the card first, bitwise, at 16,384 x 3
   integer-grid and 8,192 x 10 continuous points, k = 1, 7, 15 and 128, in
   the fused contract's dot form, the XLA contract's form and manhattan,
   with infinite and finite priming bounds; then the MR fit on 6,000
   ``make_gauss`` points (processing_units=1,024) on the card equal to the
   same fit on the CPU, in the default mode and in boundary mode; then
   ``make_gauss(1,000,000, dims=10, n_clusters=30, separation=9.0, seed=2)``
   with min_points=8, min_cluster_size=n/200, processing_units=16,384,
   k=0.01, seed 0, boundary_quality=0.05, knn_backend=fused, the launch
   counters zeroed just before and read just after: B4 must have launched,
   every core distance must be finite and the ARI against the truth and
   against the port's exact fit of the same data must reach 0.99; it
   prints the fit wall, each level's stats and the boundary phases' walls;
3e. the default mode (global core distances, per-level glue, one refine
   round) at 200,000 points of the same generator: K2 and B1 must have
   launched; the same lines;
3f. the high-dimension exact fit, the reference's own high-d leg
   (``benchmarks/highdim_eval.py``): B3 (the no-ids k-smallest kernel,
   which ``knn_backend=auto`` takes on the card for euclidean d >= 24)
   against its plain version first, bitwise, in both forms at d = 24, 28,
   90 and 128 and k = 1, 7, 15 and 128; then a 4,096 x 28 card fit with
   ``auto`` equal to the CPU fit with ``knn_backend=pallas``; then
   ``make_gauss(500,000, dims=28, n_clusters=8, separation=3 sqrt(28),
   seed=4)`` with min_points=8, min_cluster_size=2500: B3, B1 and K3 must
   launch; it prints the stage walls, the ARI against the truth and the core
   distances' error against a float64 oracle on 512 rows, and the same
   error for B3's core distances alone at 500,000 x 90;
3g. the sharded exact fit (``fit_sharding=sharded``) over a mesh of four
   shards (one per card from four cards on, else four on the first card):
   B9 (the panel segment-min) and the rectangular B2 against their plain
   versions first, bitwise; an 8,000-point sharded card fit equal to the
   same fit over four CPU shards; then the 245,057 x 3 Skin-shaped fit,
   whose labels, core distances, MST, outlier scores and condensed tree
   must equal the single-device fit of phase 3, with one host sync, 16 ring
   B2 launches and 16 B9 launches per Borůvka round;
K3 is then held bit for bit to its plain version on the fits' own pools:
   the Skin-shaped fit's MST, the 3c exact twin's, the 3f fit's and the 3d
   MR fit's host edge pool (with its cycle and duplicate edges), each in
   the scan's (w, u, v) order;
3h. past k or d = 128, where every kernel but B3 runs its wide mode
   (features in chunks, lists in device memory): fits on the card equal to
   the same fits on the CPU -- exact at 2,000 x 129 and at min_points=200,
   the rp-forest tier at k = 129, the sharded fit at 4,000 x 129, the MR
   boundary fit at 3,000 x 130 -- with the launch counters zeroed just
   before the first and read just after the last; every wide mode a fit
   path runs must have launched;
3i. cosine and pearson (metric code 6; pearson's rows centred by the
   wrappers): after ``parity_metrics`` held B1, B9, K2 and the rectangular
   B2 at both metrics, and B5-B8 at cosine, bit for bit to their plain
   versions (NaN patterns included) on grid, continuous and collinear
   points, zero-norm rows and d = 129 (phase 2), the cells skin_cosine,
   highd_cosine, highd_pearson, 3b_cosine, 3e_cosine and 3g_cosine each
   equal their CPU fits on a 4,096-row slice, and 3g_cosine the
   single-device fit (``metric_phase``); with three zero rows added, the
   dense fit and the MR fit with global_cores=false (block cores over NaN
   distances) equal their CPU fits at both metrics (``zero_row_blocks``);
   their kernels are timed as rows
   ``<kernel>_cosine`` and ``<kernel>_3f_{cosine,pearson}``, K2, B5 and B7
   beside ``F.normalize`` + ``torch.mm`` / ``torch.bmm`` + ``torch.topk``;
3j. the command line (``python -m hdbscan_tpu_torch fit``) on phase 3's
   Skin-shaped set, written as a tab-separated file like
   ``Skin_NonSkin.txt``, in its three routes: ``cli_mr`` (the command a user
   types, run as a subprocess: minPts=16 minClSize=3000
   processing_units=16384 k=0.01 seed=0 --trace-out, the MR route),
   ``cli_exact_sharded`` (``cli.main`` in this process with
   fit_sharding=sharded processing_units=245057: the exact fit on a
   one-card mesh) and ``cli_dense`` (in this process, the first 30,000
   rows with processing_units=30000 minClSize=367: the dense single-block
   fit at its real upper size; its peak device memory is printed). Each
   leg must exit 0 with the stdout line naming its route, write five files
   byte-identical to the in-process fit of the same file and flags on the
   card (``mr_hdbscan.fit``, ``exact.fit``, ``models/hdbscan.fit``, then
   ``write_outputs``) and a trace that passes ``scripts/check_trace.py``;
   its 4,096-row leg (processing_units 1,024 for ``cli_mr``, else 4,096;
   minClSize=50) must write the same files on the card and with ``--device
   cpu``. The launch counters, zeroed just before each in-process run and
   read just after, must show the route's kernels: the rectangular B2, B9
   and K3 for ``cli_exact_sharded``; K3 for ``cli_dense`` (its dense block
   is plain PyTorch ops, as the reference's is XLA; K3 runs in the
   finalize's device forest build); ``cli_mr``'s K2 and B1 are counted on
   its in-process twin. Each leg prints its
   wall, its ``phases:`` summary and its file sizes beside the card's name
   and power limit;
3k. the host-round routes on phase 3's Skin-shaped set, each cell's
   4,096-row fit on the card equal to the same fit on the CPU (CPU shards
   for a mesh) and each full fit run with the launch counters zeroed just
   before and read just after, printing its wall, stage walls, per-round
   (scan, fetch, contraction) walls and launches: ``skin_host_rounds``
   (``mst_backend=host``: K2, B1 once a round; MST edge set and labels
   equal to phase 3's device-route fit), ``skin_ring_1`` and
   ``skin_ring_4`` (``scan_backend=ring`` on a one-card mesh and on four
   shards of one card: the rectangular B2 and B9; MST equal to
   ``skin_host_rounds``'), ``skin_shard_host`` (``fit_sharding=sharded
   mst_backend=host`` on four shards: the same), ``skin_dedup``
   (``dedup_points=True`` on 245,057 rows drawn from 51,433 unique grid
   points with three groups of at least 3,000 rows: K2 with ids, B1, K3;
   ARI 1.0 and equal core distances against the full-row device fit of the
   same rows) with its command-line leg ``cli_dedup_sharded`` (``dedup=true
   fit_sharding=sharded processing_units=245057``: the rectangular B2, B9
   and K3; the checks of a 3j leg), and ``skin_rb``
   (``mst_edges_random_blocks(n_parts=64, seed=0)``, BASELINE.json config
   5: K2 and the plain block ops; its 4,096-row run equal card against
   CPU, its sorted MST weights equal to ``skin_host_rounds``' and its
   ``tree.extract_clusters`` labels the same partition as its labels (the
   same noise rows and clusters, cluster ids renamed: another tie-broken
   MST of the same weights numbers the clusters in another order); blocks,
   launches and the
   block and ``pool_mst`` walls printed). ``python3 chip_smoke.py 3k``
   builds the kernels and runs phases 3 and 3k alone;
3l. the rest of the MR pipeline: first the 6,000-point card-vs-CPU checks
   of phase 3d gain ``variant=rs``, ``dedup_points`` (every third row
   repeated 1-6 more times), ``consensus_draws=2``, ``compat_cf_int_math``,
   the unpruned boundary (``boundary_block_pruning=False``, at cosine, over
   the rp-forest) and a checkpoint interrupted after level 0 then resumed,
   each bitwise (``mr_variants_card_vs_cpu``); then the cells, each with the
   launch counters zeroed just before its fit and read just after, its
   wall, level stages, trace walls and launches printed: ``skin_mr_dedup``
   (the reference bench's mr-db leg, ``bench.py:1638-1645``: min_points 8,
   min_cluster_size 3000, processing_units 8192, k 0.03, dedup_points on
   3k's 245,057 rows over 51,433 unique points: K2 with ids and B1; the
   ``dedup`` event's counts, two levels or more, ARI against the full-row
   exact fit and the MR fit without dedup, both timed), and on 3e's data
   ``3e_rs`` (``variant=rs``: K2, B1; ARI against the truth and 3e's db
   fit), ``3e_consensus`` (two draws: K2, B1; two ``consensus_draw``
   events, the reference's provenance keys, labels equal
   ``consensus_labels`` of the draws' labels), ``3e_checkpoint`` (stopped
   by ``max_levels=1`` after K2, resumed with B1 and no K2: labels, cores,
   level stats and edge pool equal the uninterrupted fit's) and the
   unpruned boundary cells ``3e_boundary_unpruned``,
   ``3e_boundary_cosine`` (the rows scan on the rectangular K2, B1) and
   ``3e_boundary_forest`` (B5-B7, B1), where B4 must not launch; each
   prints ``m``, the ``boundary_cores`` and glue walls and the ARI against
   the truth. ``python3 chip_smoke.py 3l`` builds the kernels and runs
   phases 3 and 3l alone;
3m. serving (``hdbscan_tpu_torch/serve``): (a) the rectangular B2 and B7
   against their plain versions, bitwise, at the predictor's shapes: every
   bucket of 8 to 256 query rows against the 245,057 x 3 training set at
   k = 15 in the ``xla`` backend's form, the ``fused`` dot form and cosine
   (also over a training set with three zero rows, and a bucket of zero
   query rows), and B7 on each bucket's routed candidate lists of the 3b
   forest, whole and cut short with sentinel padding; (b) ``serve_skin``:
   phase 3's fit saved with ``to_cluster_model(...).save``, reloaded and
   served (``auto``, the dot form on the card): all 245,057 training rows
   must reproduce the fit's labels, and 20,000 novel queries in the bench
   sampler's shape (training rows, every fourth a bitwise duplicate, the
   rest jittered by a rounded N(0, 1)) are timed, also on the ``xla``
   backend; on a 4,096-row model the card's labels, probabilities and
   outlier scores must equal a CPU ``Predictor``'s on every backend
   (membership within 1e-6 relative); (c) ``serve_skin_rpf``: 3b's fit,
   whose artifact carries the forest, served with ``predict_backend=
   rpforest``: the training rows must reproduce that fit's labels, and the
   ARI against the exact backend is printed; (d) ``serve_http``: a
   ``ClusterServer`` on 127.0.0.1, port 0: ``POST /predict`` of 1, 7, 256
   and 1,000 rows and one with membership equal to the in-process predict,
   ``/healthz``, two ``/metrics`` scrapes, ``POST /swap`` to the 3b model
   (generation 2), then 4 client threads in a closed loop for 5 s at
   batch sizes 1-256, every response equal to the sequential predict of
   its rows (p50, p99 and rows/s printed, not gated), the trace
   and scrapes through ``scripts/check_trace.py`` and
   ``scripts/check_metrics.py``; (e) ``cli_predict``: ``fit --model-out``
   on the first 30,000 rows, then ``predict`` of 20,000 queries, both as
   subprocesses, whose file must equal the in-process predict. The launch
   counters, zeroed just before each cell and read just after, must show
   B2 and no B7 in the exact cells and B7 and no B2 in the rp-forest
   cells; in ``serve_http`` every answer the responses are held against
   is computed before the server starts, and the counters are zeroed just
   before the requests and again just before the closed loop, so each
   window counts the server's own launches. ``python3 chip_smoke.py 3m`` builds the kernels and runs phases
   3 and 3m alone;
3n. multi-GPU fits from one process, on the sharded fit's mesh (four
   shards of the first card, or one a card from four cards on): first each
   configuration on the card equal to the same over four CPU shards, bitwise
   (the MR cells on 6,000 rows of 3e's shape, the forest cells on the first
   4,096 Skin-shaped rows); then, each with the launch counters zeroed just
   before its fit and read just after and gated on the kernels it must
   launch and on those it must not, on 3e's 200,000 rows ``3n_mr_sharded``
   and ``3n_mr_ring`` (ring cores on the rectangular B2, B9 glue; equal to
   the one-device 3e fit), ``3n_mr_sharded_boundary`` (the ring rows scan,
   the full-sweep B9 glue; equal to the one-device unpruned boundary fit,
   3l's ``3e_boundary_unpruned``) and ``3n_mr_ring_boundary`` (B4, the
   pruned glue with ring dense rounds; equal to the one-device pruned
   boundary fit), and on the Skin-shaped set ``3n_skin_shard_forest`` (the
   sharded rp-forest: per-shard trees, B7 a shard visit, then B9 and K3;
   its recall and ARI against 3b printed) and ``3n_skin_ring_forest`` (B5
   and B6 over the shards' leaf batches, B7 rescans on row shards, B9
   rounds; equal to 3b). The kernels line gains
   ``forest_rescan_topk_shard``, B7 at one recorded shard visit. ``python3
   chip_smoke.py 3n`` builds the kernels and runs phases 3 and 3n alone;
3o. streaming ingest and incremental maintenance
   (``hdbscan_tpu_torch/stream``, ``incremental``): ``3o_stream_skin``,
   the 3m serve_skin model served with ``ingest=True`` and a WAL, one
   client's ``POST /ingest`` batches of 256 rows: 128 novel queries of
   the bench sampler's shape, then rows moved off the grid until the
   drift they flag has kicked one background re-fit on the card, it has
   published, and 64 batches more; ``POST /swap`` swaps it in; each
   batch's labels equal the sequential predict of the generation that
   served it, the window launches B2 and no B7, and the ``/ingest`` p50,
   p99 and rows/s (the requests with the re-fit running apart from the
   rest), WAL append time, re-fit wall and swap wall are printed;
   ``3o_stream_card_vs_cpu``, a 4,096-row model under the ``xla``,
   ``fused`` and ``rpforest`` backends, one ingest script on the card and
   on the CPU with equal responses, buffer and drift state;
   ``3o_maintain``, ``stream_maintain=incremental`` on a 4,096-row model
   (the host bootstrap timed), the maintained model (padded to its
   capacity with sentinel rows) swapping in, its MST digests and its
   predict after every batch equal to a CPU-only server's fed the same
   rows, the card server reopened on its WAL verifying the watermark, and
   a ``serve --ingest`` subprocess killed with SIGKILL and restarted
   recovering its acknowledged state. B2 and B7 are held against their
   plain versions on the ingest path's own recorded calls, every B2 call
   of the maintained cell's card server among them. ``python3
   chip_smoke.py 3o`` builds the kernels and runs phases 3 and 3o alone;
3p. the observability layer (``hdbscan_tpu_torch/obs``) around the card's
   paths, each command run in this process with the launch counters zeroed
   just before and read just after: ``3p_cli_skin_obs``, 3j's cli_mr
   command on the Skin-shaped file once without and once with
   ``--trace-out --report --flight-dir --assert-not-replicated
   heartbeat=0.2 watchdog=30``: the five files equal, the traces and reports pass
   ``scripts/check_trace.py`` and the empty flight directory
   ``check_flight.py --allow-empty``; it prints the per-phase watermarks
   (``memory_stats``: the card's allocator) and the median fit wall with
   and without the layer; ``3p_cli_sharded_obs``, the same over
   ``--device cuda:0,cuda:0,cuda:0,cuda:0`` (3j's cli_exact_sharded
   flags): the report's timeline and roofline sections, valid
   ``device_timeline`` rows, the gate's single-device answer, the roofline
   rows printed; ``3p_watchdog``, a ``phase_stall`` fault in a 4,096-row
   card fit with ``watchdog=1``: a ``watchdog_stall`` event and bundle
   (``check_flight.py``); ``3p_serve_obs``, a process that fits the first
   30,000 rows with the memory auditor installed and serves the fit with
   ``watchdog_s``: 300 ``/predict`` requests equal to the in-process
   predict, two ``/metrics`` scrapes (``check_metrics.py``, a non-zero
   ``hdbscan_tpu_device_peak_bytes``), ``/healthz``'s watchdog block, the
   serving report's ``predict_latency`` through ``check_trace.py``, then
   ``predict --report``. The kept calls of B1, K2, the rectangular B2, B9
   and K3 on these paths are held against their plain versions, bitwise.
   The kernels line gains ``launches_3p``. ``python3 chip_smoke.py 3p``
   builds the kernels and runs phases 3 and 3p alone;
3q. the fleet (``hdbscan_tpu_torch/fleet``) on the card, over three
   uncompressed Skin-shaped artifacts (phase 3's exact fit, a second
   seed's, and phase 3's fit carrying the 3b forest). One fleet, the port's
   router in this process over ``serve`` replica processes sharing
   ``cuda:0`` (``consistent_hash``, ``--tenants-dir`` of 8 tenants cycling
   the three models, ``tenant_lru=2``, ``artifact_store=shared``,
   ``--ingest`` with a WAL a replica, every replica trace kept), runs three
   cells: ``3q_fleet_scale``, one replica, then a scale-up whose standby's
   ``/healthz`` reads 0 builds and more than 0 build-directory loads and
   answers identically (its time to ready printed), drained back down at
   the end; ``3q_fleet_tenants``, 300 ``/predict`` requests of 1-256 rows
   cycling the tenants in runs of five, each equal to the in-process predict on its
   artifact and each tenant on one replica, the aggregated ``/metrics``
   through ``check_metrics.py`` with evictions counted, p50 and p99, each
   replica's allocator bytes, and the card's free memory with no, one and
   two replicas up; ``3q_fleet_chaos``, ingest acknowledged on both
   replicas, then SIGKILL of one under a two-client load: the next request
   re-routes, the replica respawns and replays its WAL to the acknowledged
   rows, and no request fails. The router's and the replicas' traces pass
   ``check_trace.py`` and ``--join``. A replica's launches are its
   ``/healthz`` counts read just before and just after a cell.
   ``3q_fit_service``, in this process: a ``TenantRegistry`` on the card
   over four tenants hammered by three threads while a ``FitScheduler``
   (two workers) runs two rounds of dense fits of 16,384 rows a tenant on
   the card and publishes through the registry's swap, plus one poisoned
   job: no request error, no generation regression, the poison fails
   alone, each tenant answers as its last job's artifact; p50 and p99 with
   and without fits beside; then eight ``rpforest`` tenants through an LRU
   of two, the allocator's allocated bytes back to two tenants' worth. The
   in-process B2, B7 and K3 calls are held against their plain versions,
   bitwise. The kernels line gains ``launches_3q``. ``python3
   chip_smoke.py 3q`` builds the kernels and runs phases 3 and 3q alone;
3r. multi-process fits (``clusterName=``, ``parallel/distributed``): the
   command line as rank processes sharing ``cuda:0``, each with its own
   CUDA context, the hand-overs between them over gloo (the backend rule
   for ranks that share a card; NCCL between distinct cards is not
   exercised on one card, and the phase says so: see ``3r4`` below).
   ``3r_cli_exact_2proc``:
   3j's ``cli_exact_sharded`` flags on the Skin-shaped file as 2 ranks x
   ``--device cuda:0,cuda:0``, its five files byte-identical to one
   process over ``--device cuda:0,cuda:0,cuda:0,cuda:0`` (3p's run of that
   command when 3p ran, else a run here);
   ``3r_cli_mr_2proc``: 3j's ``cli_mr`` flags with ``fit_sharding=sharded``,
   the same layout and twin; ``3r_ring_4proc``: ``scan_backend=ring`` on
   the first 4,096 rows as 4 ranks x ``--device cuda:0``, equal to the same
   command's 4 ranks x ``--device cpu``, run beside it;
   ``3r_cli_forest_2proc``: ``3r_cli_exact_2proc``'s flags with
   ``knn_index=rpforest`` (the sharded forest: each rank builds its own
   shards' trees, the visiting panels of rows, leaf members and thresholds
   cross ranks by ``ring_shift``), the same layout and twin;
   ``3r_ring_forest_4proc``: ``3r_ring_4proc``'s flags with
   ``knn_index=rpforest`` (the forest over the mesh: every rank builds the
   same forest, the leaf lists and the rescans' id lists are all-gathered)
   as 4 ranks x ``--device cuda:0``, against one process over four
   ``cuda:0`` shards. Each leg prints
   the ranks' fit walls, each rank's launches and hand-overs (bytes, calls, wall; its
   trace's ``rank_summary``), the backend and rank 0's mesh line; every
   rank must launch the rectangular B2 and B9 (and K3 on the exact leg; on
   the forest legs B7, B9 and K3, and B5, B6 and B7), every trace pass
   ``check_trace.py`` and the report name every rank. The kernels line
   gains ``launches_3r``: each rank's launches of the kernel beside its
   hand-overs (bytes, calls, wall s by helper). ``python3 chip_smoke.py 3r`` builds
   the kernels and runs phases 3 and 3r alone; ``python3 chip_smoke.py
   3r4``, on four cards, builds them and runs 3r's legs over the cards
   instead: 2 ranks x 2 cards (gloo) and 4 ranks x 1 card (NCCL), each
   against one process over the four cards;
4. time each kernel at the fit's shapes with CUDA events beside its plain
   version and its bound (the larger of bytes over the memory rate and
   float operations over the FP32 rate of an H100 SXM: 3.35 TB/s, 67
   TFLOP/s; the segment-min and k-best rows add ``bound_separate_ms``, the
   operations at half that rate, since -fmad=false issues multiplies and
   adds separately, and the k-best rows their grid): the exact tier's
   kernels at the exact fit's shapes, B1 also at one round of the 3f fit
   (``segmin_3f``; the k-best rows, B4, B5 and B7 count their bound with no
   root a pair, and B4, B5 and B7 time the two-call yardstick
   ``torch.cdist`` + ``torch.topk`` as ``library_ms``; B7's rows give their
   grid in ``blocks``), K2 also at the 3c exact twin's launch (``knn_kbest_3c``,
   its plain version on 16,384 rows, scaled), the forest kernels at the 3b
   fit's (one leaf batch, the merge, one rescan chunk, B8 on that chunk's
   panel with round-1 components; B6 and B8 with their device time a
   call), B4 at the largest main-phase rescan
   chunk of the 3d fit, B3 at the 3f fit's launch (its plain version on
   16,384 rows, scaled), B9 and the rectangular B2 at one panel launch of
   the 3g fit's first round, and every wide mode at the 3h fits' shapes
   (rows named ``<kernel>_wide``). It also prints the share of segment-min
   tiles whose rows and columns lie in one component, at round 1 and the
   last round of the Skin-shaped fit. K3's row adds its latency floor
   (``latency_floor_ms``: the replay's dependent chain, counted by the
   kernel's ``prof`` counters as shared-memory loads and shuffle rounds,
   each at its round trip timed in this run by ``uf_probe_launch``) and,
   from the same counters, its phases' shares of the block's cycles and
   the hops per find; B5's row its grid
   (``blocks``); both rows the kernel's device time a call from
   ``torch.profiler`` (``device_ms``, without the wrapper's host gaps).
   The serving rows time the rectangular B2 on one 256-row bucket against
   the 245,057 x 3 training set (``knn_kbest_panel_predict``) and B7 on
   one 256-row bucket of routed candidates (``forest_rescan_topk_predict``),
   with ``torch.cdist`` + ``torch.topk`` as ``library_ms`` and each call's
   device time from ``torch.profiler`` (``device_ms``).

The second line before the last is the card's name and power limit, the
line before the last the ``kernels`` JSON, the last line the device JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_SKIN = 245_057
MIN_PTS = 16
MIN_CL_SIZE = 3000
SEED = 0
N_BLOBS = 1 << 20
BLOBS_MIN_CL_SIZE = 5000
#: The reference benchmark's forest configuration (bench.py rpforest leg).
FOREST = dict(knn_index="rpforest", knn_backend="fused", rpf_trees=4,
              rpf_leaf_size=1024, rpf_rescan_rounds=1)
EXACT_KERNELS = ("knn_kbest", "segmin", "uf_scan")
HIGHD_KERNELS = ("knn_smallest", "segmin", "uf_scan")
SHARDED_KERNELS = ("knn_kbest_panel", "segmin_panel", "uf_scan")
FOREST_FIT_KERNELS = ("forest_leaf_topk", "forest_merge", "forest_rescan_topk",
                      "segmin", "uf_scan")
#: The boundary benchmark's data and parameters (benchmarks/boundary_eval.py).
N_MR = 1_000_000
N_FULLQ = 200_000
MR_DATA = dict(dims=10, n_clusters=30, separation=9.0, seed=2)
MR_PARAMS = dict(min_points=8, processing_units=16384, k=0.01, seed=0)
BOUND05 = dict(boundary_quality=0.05, knn_backend="fused")
#: The reference's high-d leg (benchmarks/highdim_eval.py): d = 28 is the
#: HEPMASS/HIGGS width, d = 90 YearPrediction's.
N_HIGHD = 500_000
HIGHD_DIMS = (24, 28, 90, 128)
HIGHD_PARAMS = dict(min_points=8, min_cluster_size=2500, processing_units=16384, seed=0,
                    k=0.01)
#: Shards of the sharded fit: one per card from four cards on, else four on
#: the first card.
N_SHARDS = 4
SHARDED = dict(fit_sharding="sharded", mst_backend="device", knn_index="exact")
#: Phase 3j, the command line: its legs (name, rows of the Skin-shaped set,
#: key=value flags, processing_units of the 4,096-row leg, the kernels the
#: route must launch, whether the full-size leg runs as a subprocess, the
#: route its stdout line names). cli_dense's minClSize is 3000 scaled by
#: 30,000 / 245,057; the 4,096-row legs take minClSize=50.
CLI_SUB_ROWS = 4096
CLI_DENSE_ROWS = 30_000
CLI_LEGS = (
    ("cli_mr", N_SKIN, ["minPts=16", "minClSize=3000", "processing_units=16384", "k=0.01",
                        "seed=0"], 1024, ("knn_kbest", "segmin"), True, ", mr ("),
    ("cli_exact_sharded", N_SKIN, ["minPts=16", "minClSize=3000", "fit_sharding=sharded",
                                   f"processing_units={N_SKIN}"], 4096,
     ("knn_kbest_panel", "segmin_panel", "uf_scan"), False, ", exact-sharded, "),
    ("cli_dense", CLI_DENSE_ROWS, ["minPts=16", "minClSize=367",
                                   f"processing_units={CLI_DENSE_ROWS}"], 4096, ("uf_scan",),
     False, ", exact, "),
)
#: Phase 3k, the host-round routes: the dedup cell's unique points (the
#: real Skin set's count), its heavy groups (rows each, past minClSize) and
#: the Random Blocks cell's parts (BASELINE.json config 5).
N_SKIN_UNIQUE = 51_433
HEAVY_GROUPS = (3500, 3200, 3000)
RB_PARTS = 64
#: Its command-line leg (the 3j leg tuple): dedup on the exact-sharded route.
CLI_DEDUP_LEG = ("cli_dedup_sharded", N_SKIN,
                 ["minPts=16", "minClSize=3000", "dedup=true", "fit_sharding=sharded",
                  f"processing_units={N_SKIN}"], 4096,
                 ("knn_kbest_panel", "segmin_panel", "uf_scan"), False, ", exact-sharded, ")
#: Phase 3l, the rest of the MR pipeline. The consensus fits' draws (two,
#: to keep the whole script inside its time limit: the 6,000-point CPU
#: twin takes ~10 s a draw), then the 6,000-point card-vs-CPU
#: configurations (label, parameters beyond phase 3d's):
CONSENSUS_DRAWS = 2
MR_VARIANTS = (
    ("variant=rs", {"variant": "rs"}),
    ("dedup_points", {"dedup_points": True}),
    (f"consensus_draws={CONSENSUS_DRAWS}", {"consensus_draws": CONSENSUS_DRAWS}),
    ("compat_cf_int_math", {"compat_cf_int_math": True}),
    ("boundary unpruned", {"boundary_quality": 0.05, "boundary_block_pruning": False}),
    ("boundary cosine", {"boundary_quality": 0.05, "dist_function": "cosine"}),
    ("boundary rp-forest", {"boundary_quality": 0.05, "boundary_block_pruning": False,
                            **FOREST}),
)
#: The reference bench's mr-db leg (bench.py:1638-1645; BASELINE.json config
#: 3's calibrated leg, benchmarks/run_configs.py:149-158).
MR_DB_LEG = dict(min_points=8, min_cluster_size=3000, processing_units=8192, k=0.03, seed=0,
                 dedup_points=True)
#: The unpruned boundary cells on 3e's data: (label, parameters, kernels).
MR_BOUNDARY_CELLS = (
    ("3e_boundary_unpruned", {"boundary_quality": 0.05, "boundary_block_pruning": False},
     ("knn_kbest_panel", "segmin")),
    ("3e_boundary_cosine", {"boundary_quality": 0.05, "dist_function": "cosine"},
     ("knn_kbest_panel", "segmin")),
    ("3e_boundary_forest", {"boundary_quality": 0.05, "boundary_block_pruning": False,
                            **FOREST},
     ("forest_leaf_topk", "forest_merge", "forest_rescan_topk", "segmin")),
)
#: Phase 3m, serving: the predictor's bucket ladder, the novel queries of
#: the bench sampler's shape, the HTTP leg's request sizes and closed loop.
SERVE_BUCKETS = (8, 16, 32, 64, 128, 256)
N_NOVEL = 20_000
HTTP_SIZES = (1, 7, 256, 1000)
HTTP_LOOP_S = 5.0
HTTP_CLIENTS = 4
#: Phase 3n, multi-GPU fits from one process (four shards of one card, or
#: one a card from four cards on). The MR cells on 3e's data: (label,
#: parameters beyond 3e's, kernels it must launch, kernels it must not).
#: BOUNDARY is 3l's unpruned cells' mode without the fused backend, so the
#: sharded boundary fit's single-device twin is ``3e_boundary_unpruned``.
BOUNDARY = dict(boundary_quality=0.05)
_NO_SINGLE = ("knn_kbest", "segmin", "knn_smallest", "forest_leaf_topk", "forest_merge",
              "forest_rescan_topk")
MESH_MR_CELLS = (
    ("3n_mr_sharded", dict(fit_sharding="sharded"), ("knn_kbest_panel", "segmin_panel"),
     _NO_SINGLE + ("knn_window",)),
    ("3n_mr_ring", dict(scan_backend="ring"), ("knn_kbest_panel", "segmin_panel"),
     _NO_SINGLE + ("knn_window",)),
    ("3n_mr_sharded_boundary", dict(fit_sharding="sharded", **BOUNDARY),
     ("knn_kbest_panel", "segmin_panel"), _NO_SINGLE + ("knn_window",)),
    ("3n_mr_ring_boundary", dict(scan_backend="ring", **BOUNDARY), ("knn_window",),
     _NO_SINGLE + ("knn_kbest_panel",)),
)
#: The forest cells on phase 3's Skin-shaped set, 3b's forest parameters.
MESH_FOREST_CELLS = (
    ("3n_skin_shard_forest", dict(fit_sharding="sharded"),
     ("forest_rescan_topk", "segmin_panel", "uf_scan"),
     ("forest_leaf_topk", "forest_merge", "knn_kbest", "knn_kbest_panel", "segmin")),
    ("3n_skin_ring_forest", dict(scan_backend="ring"),
     ("forest_leaf_topk", "forest_merge", "forest_rescan_topk", "segmin_panel", "uf_scan"),
     ("knn_kbest", "knn_kbest_panel", "segmin")),
)
MESH_SUB_MR = 6000
#: Phase 3o, streaming: the Skin stream's batches in distribution, then
#: shifted ones (moved off the 0-255 grid) until the drift-kicked re-fit
#: has published and STREAM_TAIL more (at most STREAM_SHIFT_MAX). The drift
#: sketch counts every row since the last swap, so the shifted stretch
#: flags at about an eighth of the rows, and the re-fit pool holds every
#: novel row (about 70% of an in-distribution batch): 128 batches give a
#: pool near 38,000 rows, whose dense (n, n) float32 matrices take 5.8 GB
#: each; 256 would near 65,000 rows and 17 GB a matrix. The maintenance
#: cell's model rows (its host bootstrap is O(n^2 d): 8,192 rows take ~20 s
#: a bootstrap, and the cell bootstraps five times) and novel batches.
STREAM_IN = 128
STREAM_TAIL = 64
STREAM_SHIFT_MAX = 1024
STREAM_ROWS = 256
STREAM_SHIFT = 300.0
N_MAINTAIN = 4096
MAINTAIN_BATCHES = 8
MAINTAIN_ROWS = 48
#: Phase 3p, observability: the flags every 3p command-line cell adds
#: beside ``--trace-out --report --flight-dir``, the watchdog cell's rows
#: and injected stall, and the serving cell's model rows and requests.
OBS_FLAGS = ["--assert-not-replicated", "heartbeat=0.2", "watchdog=30"]
#: The Skin cell's runs without (False) and with (True) the layer: one a
#: side, to keep the whole script inside its time limit (the overhead is
#: within run-to-run noise at any count this script can afford, PERF.md);
#: the sharded cell runs each once too.
OBS_TURNS = (False, True)
OBS_SUB_ROWS = 4096
OBS_STALL_S = 3.0
OBS_SERVE_ROWS = 30_000
OBS_REQUESTS = 300
#: Phase 3q, the fleet: tenants (cycling phase 3's exact model, a second
#: seed's and the forest-carrying one) over two replicas with an LRU of two
#: each, the single client's requests (1-256 rows each, in runs of
#: FLEET_RUN a tenant, so a run's first request pays its load), and the fit
#: service's tenants, workers, job rows (a dense fit's float32 (n, n) block
#: is 1 GiB at 16,384 rows), rounds of jobs and its window without fits.
#: minClSize is 3000 scaled by 16,384 / 245,057.
FLEET_TENANTS = 8
FLEET_LRU = 2
FLEET_REQUESTS = 300
FLEET_RUN = 5
FIT_JOB_TENANTS = 4
FIT_JOB_WORKERS = 2
FIT_JOB_ROWS = 16_384
FIT_JOB_MIN_CL = 200
FIT_JOB_ROUNDS = 2
FIT_SERVICE_BASE_S = 3.0
#: Phase 3r, multi-process fits: the command line as rank processes that
#: share ``cuda:0`` (each its own CUDA context; hand-overs over gloo). A leg:
#: (label, rows of the Skin-shaped set, flags, ranks, each rank's
#: ``--device`` (one string for every rank, or one a rank), the twin's
#: (ranks, ``--device``; one rank: in this process), the kernels every rank
#: must launch, the route rank 0 names, the backend the rule must choose).
_CARDS4 = ",".join(f"cuda:{i}" for i in range(4))
RANK_LEGS_RING_FLAGS = ["minPts=16", "minClSize=50", "processing_units=1024", "k=0.01", "seed=0",
                        "scan_backend=ring"]
RANK_LEGS = (
    ("3r_cli_exact_2proc", N_SKIN, CLI_LEGS[1][2], 2, "cuda:0,cuda:0",
     (1, ",".join(["cuda:0"] * N_SHARDS)), ("knn_kbest_panel", "segmin_panel", "uf_scan"),
     ", exact-sharded, ", "gloo"),
    ("3r_cli_mr_2proc", N_SKIN, [*CLI_LEGS[0][2], "fit_sharding=sharded"], 2, "cuda:0,cuda:0",
     (1, ",".join(["cuda:0"] * N_SHARDS)), ("knn_kbest_panel", "segmin_panel"),
     ", mr-sharded (", "gloo"),
    ("3r_ring_4proc", CLI_SUB_ROWS, RANK_LEGS_RING_FLAGS, 4, "cuda:0",
     (4, "cpu"), ("knn_kbest_panel", "segmin_panel"), ", mr (", "gloo"),
    # The forest over ranks: the sharded forest's panels through ring_shift
    # (B7 a visit), then B9 and K3; the ring forest's leaf scans (B5), folds
    # (B6) and rescans (B7) with the leaf and id lists all-gathered.
    ("3r_cli_forest_2proc", N_SKIN, [*CLI_LEGS[1][2], "knn_index=rpforest"], 2,
     "cuda:0,cuda:0", (1, ",".join(["cuda:0"] * N_SHARDS)),
     ("forest_rescan_topk", "segmin_panel", "uf_scan"), ", exact-sharded, ", "gloo"),
    ("3r_ring_forest_4proc", CLI_SUB_ROWS, [*RANK_LEGS_RING_FLAGS, "knn_index=rpforest"], 4,
     "cuda:0", (1, ",".join(["cuda:0"] * N_SHARDS)),
     ("forest_leaf_topk", "forest_merge", "forest_rescan_topk"), ", mr (", "gloo"),
)
#: ``python3 chip_smoke.py 3r4`` on four cards: ranks over two cards each
#: (gloo, the rule for a rank over several cards) and one card a rank
#: (NCCL), each against one process over the four cards.
RANK_LEGS_4CARDS = (
    ("3r4_exact_2x2cards", N_SKIN, CLI_LEGS[1][2], 2, ("cuda:0,cuda:1", "cuda:2,cuda:3"),
     (1, _CARDS4), RANK_LEGS[0][6], RANK_LEGS[0][7], "gloo"),
    ("3r4_exact_4x1card", N_SKIN, CLI_LEGS[1][2], 4, tuple(_CARDS4.split(",")),
     (1, _CARDS4), RANK_LEGS[0][6], RANK_LEGS[0][7], "nccl"),
    ("3r4_mr_4x1card", N_SKIN, RANK_LEGS[1][2], 4, tuple(_CARDS4.split(",")),
     (1, _CARDS4), RANK_LEGS[1][6], RANK_LEGS[1][7], "nccl"),
    # Over distinct cards ``auto`` takes the sharded engine (the reference's
    # multi-device rule), so this leg's route is named mr-sharded.
    ("3r4_ring_4x1card", CLI_SUB_ROWS, RANK_LEGS[2][2], 4, tuple(_CARDS4.split(",")),
     (1, _CARDS4), RANK_LEGS[2][6], RANK_LEGS[1][7], "nccl"),
    ("3r4_forest_2x2cards", N_SKIN, RANK_LEGS[3][2], 2, ("cuda:0,cuda:1", "cuda:2,cuda:3"),
     (1, _CARDS4), RANK_LEGS[3][6], RANK_LEGS[3][7], "gloo"),
    ("3r4_forest_4x1card", N_SKIN, RANK_LEGS[3][2], 4, tuple(_CARDS4.split(",")),
     (1, _CARDS4), RANK_LEGS[3][6], RANK_LEGS[3][7], "nccl"),
    # ``fit_sharding=replicated`` keeps the ring forest over distinct cards.
    ("3r4_ring_forest_2x2cards", CLI_SUB_ROWS, [*RANK_LEGS[4][2], "fit_sharding=replicated"], 2,
     ("cuda:0,cuda:1", "cuda:2,cuda:3"), (1, _CARDS4), RANK_LEGS[4][6], RANK_LEGS[4][7], "gloo"),
    ("3r4_ring_forest_4x1card", CLI_SUB_ROWS, [*RANK_LEGS[4][2], "fit_sharding=replicated"], 4,
     tuple(_CARDS4.split(",")), (1, _CARDS4), RANK_LEGS[4][6], RANK_LEGS[4][7], "nccl"),
)
#: The key of a rank's hand-overs (bytes, calls, wall s by helper) in its
#: 3r launch counts, carried into ``launches_3r`` on the kernels line.
HANDOVER_KEY = "handovers"
#: Five-file digests of one-process command runs an earlier phase already
#: made, by (rows, flags, ``--device``): 3p's exact fit over four shards is
#: 3r's exact twin, so the whole script does not run it twice.
TWIN_FILES: dict = {}
#: Rows on which the slowest plain versions are timed, scaled to all rows.
PLAIN_ROWS = 16384
H100_BYTES_PER_S = 3.35e12
H100_FP32_PER_S = 67e12
#: Separate FP32 multiplies and adds (-fmad=false, the bitwise rule) issue
#: as one instruction each: half the FMA pipe's 67 TFLOP/s.
H100_FP32_INSTR_PER_S = H100_FP32_PER_S / 2
#: The yardstick of the k-best rows (B4, B5, B7): ``library_ms`` times it.
TWO_CALLS = ("two library calls (torch.cdist + torch.topk(largest=False), TF32 off), "
             "other rounding, tie order and no dedup")
#: The cosine rows' yardstick (K2, B5, B7).
COSINE_CALLS = ("library calls: torch.nn.functional.normalize, then torch.mm / torch.bmm "
                "(TF32 off) and torch.topk(largest=True) of the similarities; other "
                "rounding, tie order and no dedup")
NO_SEGMIN_CALL = "none: no PyTorch call takes a segment minimum over a candidate panel"


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm run."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 3, per_call: bool = False) -> float | None:
    """Device time a launch of the kernel whose name contains ``kernel``
    (``torch.profiler`` over ``reps`` calls after one warm run, averaged
    over the launches it recorded; with ``per_call``, the time of every
    matching kernel summed and averaged over the calls): the kernel without
    the wrapper's host gaps, which ``cuda_ms`` includes. A trace that
    records no device time for it (the profiler drops one now and then) is
    taken again, up to three times; None when none records it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                 for e in events)
        if us > 0:
            return us / 1e3 / (reps if per_call else max(1, sum(e.count for e in events)))
    return None


def uf_round_trip_ms(kind: int) -> float:
    """One dependent round of a K3 replay latency unit, ms, timed on the
    card (``uf_probe_launch`` of ``csrc/uf_scan.cu``; kind 0 a shuffle, 1 a
    shared-memory load): two chain lengths timed, their difference over
    the difference of their rounds, so the launch drops out."""
    import ctypes

    import torch

    from hdbscan_tpu_torch.ops import cuda_build

    fn = cuda_build.function("uf_scan.cu", "uf_probe_launch",
                             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty(32, dtype=torch.int32, device="cuda")

    def run(steps):
        rc = fn(steps, kind, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"uf_probe_launch failed: cudaError {rc}")

    few, many = 1 << 18, 1 << 20
    return (cuda_ms(lambda: run(many), 3) - cuda_ms(lambda: run(few), 3)) / (many - few)


def host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_FP32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pair_ops(d: int, form: str, root: bool = True) -> int:
    """Float operations of one pair distance: diff form d sub + d mul +
    (d - 1) add + sqrt; dot form d mul + (d - 1) add + 3 (norm sums,
    doubling, subtract) + max + sqrt. ``root=False`` leaves the sqrt out,
    for a k-best: it needs a root only for the about k (1 + ln(n / k))
    candidates a row admits, as csrc/knn_kbest.cu takes them. ``form``
    "cosine" (cosine and pearson, no root): d mul + (d - 1) add, then the
    norms' product, the division and the subtraction from 1, and one more
    for the rooted norms' share of a pair: 2d + 3."""
    if form == "cosine":
        return 2 * d + 3
    return (3 * d if form == "diff" else 2 * d + 4) - (0 if root else 1)


def metric_form(metric: str, form):
    """The form ``pair_ops`` counts for a metric: the euclidean form, else
    "cosine" for cosine and pearson, "diff" for manhattan and supremum."""
    if metric == "euclidean":
        return form
    return "cosine" if metric in ("cosine", "pearson") else "diff"


def parity() -> list[str]:
    """Kernel vs plain version on the card; returns failure messages."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin, tiled

    errors = []
    print("kernel vs plain version on the card, tolerance 0 (bitwise):")
    rng = np.random.default_rng(SEED)
    cases = [
        ("grid 16384x3", rng.integers(0, 256, size=(16384, 3)).astype(np.float32)),
        ("continuous 8192x7", rng.normal(size=(8192, 7)).astype(np.float32)),
    ]
    for label, x in cases:
        n = len(x)
        xg = torch.as_tensor(x, device="cuda")
        core = torch.as_tensor(rng.integers(0, 40, n).astype(np.float32), device="cuda")
        comp = torch.as_tensor(rng.integers(0, 64, n).astype(np.int32), device="cuda")
        valid = torch.as_tensor(rng.random(n) < 0.97, device="cuda")
        for form in ("diff", "dot"):
            for min_pts in (2, 16, 129):
                k = max(min_pts - 1, 1)
                a = cuda_knn.knn_kbest(xg, k, "euclidean", form)
                torch.cuda.synchronize()
                b = cuda_knn.knn_kbest_plain(xg, k, "euclidean", form)
                ok = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                print(f"parity K2 knn_kbest {label} {form} k={k}: {'bitwise' if ok else 'MISMATCH'}")
                if not ok:
                    errors.append(f"K2 {label} {form} k={k}")
            a = cuda_segmin.segmin(xg, core, comp, valid, "euclidean", form)
            torch.cuda.synchronize()
            b = tiled._min_outgoing_scan(xg, core, comp, valid, "euclidean", form)
            ok = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            print(f"parity K1 segmin {label} {form}: {'bitwise' if ok else 'MISMATCH'}")
            if not ok:
                errors.append(f"K1 {label} {form}")
    m, n = 16384, 8192
    su = torch.as_tensor(rng.integers(0, n, m).astype(np.int32), device="cuda")
    sv = torch.as_tensor(rng.integers(0, n, m).astype(np.int32), device="cuda")
    a = mst_device.uf_scan(su, sv, n)
    torch.cuda.synchronize()
    b = mst_device.uf_scan_plain(su, sv, n)
    ok = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    print(f"parity K3 uf_scan {m} edges: {'bitwise' if ok else 'MISMATCH'}")
    if not ok:
        errors.append("K3")
    return errors


def uf_pairs_check(label, su, sv, n, errors):
    """K3 against its plain version on one pool (int32 numpy endpoints in
    scan order), bitwise."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core import mst_device

    gu = torch.as_tensor(np.asarray(su, np.int32), device="cuda")
    gv = torch.as_tensor(np.asarray(sv, np.int32), device="cuda")
    want = mst_device.uf_scan_plain(gu, gv, n)
    got = mst_device.uf_scan(gu, gv, n)
    torch.cuda.synchronize()
    ok = _same(got, want)
    tag = f"K3 uf_scan {label} ({len(su)} edges, n {n})"
    print(f"parity {tag}: {'bitwise' if ok else 'MISMATCH'}")
    if not ok:
        errors.append(tag)
    return int((want[0] != want[1]).sum())


def parity_ufscan() -> list[str]:
    """K3 against its plain version on the card, bitwise, on adversarial
    pools up to 1,048,576 vertices (up to ~2,000 batches of the replay's
    1,024 edges): a path in the order that hangs the
    growing component under a fresh vertex at every edge (the longest link
    chains) and in the other order, a star whose hub is u in every edge and
    one whose hub is v, only padding self-loops, n = 1, m = 0, m >> n with
    heavy duplicates, a random multigraph with self-loops, a spanning path
    followed by batches of only cycle edges, and a shuffled tree with a
    padding tail."""
    import numpy as np

    errors = []
    rng = np.random.default_rng(SEED + 11)
    big = 1 << 20
    p = rng.permutation(big)
    tree = 300_000
    tu = np.arange(1, tree)
    tv = (rng.random(tree - 1) * tu).astype(np.int64)  # vertex i's parent lies below i
    shuf = rng.permutation(tree - 1)
    cyc = rng.integers(0, 100_000, size=(400_000, 2))
    dup = rng.integers(0, 1000, size=(1_000_000, 2))
    mu = rng.integers(0, big, 2 * big)
    mv = np.where(rng.random(2 * big) < 0.1, mu, rng.integers(0, big, 2 * big))
    pools = [
        ("path, fresh vertex as u", p[1:], p[:-1], big),
        ("path, fresh vertex as v", p[:-1], p[1:], big),
        ("star, hub as u", np.zeros(big - 1, np.int64), np.arange(1, big), big),
        ("star, hub as v", np.arange(1, big), np.zeros(big - 1, np.int64), big),
        ("only padding self-loops", np.zeros(100_000, np.int64), np.zeros(100_000, np.int64),
         1000),
        ("n = 1", np.zeros(50, np.int64), np.zeros(50, np.int64), 1),
        ("m = 0", np.zeros(0, np.int64), np.zeros(0, np.int64), 10),
        ("m >> n, duplicates", dup[:, 0], dup[:, 1], 1000),
        ("random multigraph with self-loops", mu, mv, big),
        ("spanning path, then only cycle edges",
         np.concatenate([np.arange(99_999), cyc[:, 0]]),
         np.concatenate([np.arange(1, 100_000), cyc[:, 1]]), 100_000),
        ("shuffled tree, padding tail", np.concatenate([tu[shuf], np.zeros(50_000, np.int64)]),
         np.concatenate([tv[shuf], np.zeros(50_000, np.int64)]), tree),
    ]
    for label, su, sv, n in pools:
        uf_pairs_check(label, su, sv, n, errors)
    return errors


def parity_leaf() -> list[str]:
    """B5 against its plain version on the card, bitwise, on leaf batches
    built directly: exact ties on integer grids at the 3b and 3c batch
    shapes (36 leaves of 958, 32 of 1,024; the same point on both sides of
    every 32-position step and tile edge), random masked columns in every
    metric and form, kk = the leaf width, leaves of one real member, bf16,
    every d instantiation boundary, lists in shared memory (kk 33 to 800)
    and past its budget (kk 1,600: the output rows), and the wide cases:
    kk = 129 and 200 at d = 3, and d = 129 and 200 (no staged tile)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_forest as cf

    errors = []
    rng = np.random.default_rng(SEED + 13)

    def check(tag, x, members, mask, kk, metric="euclidean", form="diff", prec="f32"):
        n = x.shape[0]
        args = (torch.as_tensor(x.astype(np.float32), device="cuda"),
                torch.as_tensor(members.astype(np.int32), device="cuda"),
                torch.as_tensor(mask, device="cuda"), kk, metric,
                form if metric == "euclidean" else None, prec, n)
        a = cf.forest_leaf_topk(*args)
        torch.cuda.synchronize()
        ok = _same(a, cf.forest_leaf_topk_plain(*args))
        b, ell = members.shape
        label = (f"B5 forest_leaf_topk {tag} ({b} x {ell}, d {x.shape[1]}, kk {kk}, {metric}"
                 f"{' ' + form if metric == 'euclidean' else ''} {prec})")
        print(f"parity {label}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(label)

    def leaves(n, b, ell, tie_steps=False):
        members = np.stack([rng.choice(n, ell, replace=False) for _ in range(b)])
        if tie_steps:  # one point on both sides of every 32-position step and tile edge
            members[:, 32::32] = members[:, 31:-1:32][:, :members[:, 32::32].shape[1]]
        return members

    full = lambda b, ell: np.ones((b, ell), bool)  # noqa: E731
    for ell, b in ((958, 36), (1024, 32)):
        x = rng.integers(0, 12, size=(40_000, 3)).astype(np.float64)
        members = leaves(len(x), b, ell, tie_steps=True)
        mask = full(b, ell)
        mask[:, -1] = False
        for kk in (1, 15, 16, 33):
            for form in ("diff", "dot"):
                check("grid ties at step and tile edges", x, members, mask, kk, form=form)
        check("grid ties at step and tile edges", x, members, mask, 15, form="dot", prec="bf16")
    x = rng.normal(size=(20_000, 7))
    members = leaves(len(x), 12, 500)
    mask = rng.random((12, 500)) < 0.8
    for metric, form in (("euclidean", "diff"), ("euclidean", "dot"), ("manhattan", None),
                         ("supremum", None)):
        for kk in (7, 64):
            check("masked columns", x, members, mask, kk, metric, form)
    check("masked columns", x, members, mask, 15, form="diff", prec="bf16")
    xg = rng.integers(0, 6, size=(5000, 4)).astype(np.float64)
    for ell in (40, 300):
        members = leaves(len(xg), 9, ell)
        for form in ("diff", "dot"):
            check("kk = leaf width", xg, members, full(9, ell), ell, form=form)
    one = np.zeros((20, 64), bool)
    one[np.arange(20), rng.integers(0, 64, 20)] = True
    check("one real member", xg, leaves(len(xg), 20, 64), one, 5)
    check("one real member", xg, leaves(len(xg), 20, 64), one, 5, form="dot", prec="bf16")
    for d in (1, 4, 5, 8, 9, 32, 33, 128):
        xd = rng.integers(0, 4, size=(3000, d)).astype(np.float64)
        members = leaves(len(xd), 6, 257)
        mask = rng.random((6, 257)) < 0.9
        for form in ("diff", "dot"):
            check("d boundary", xd, members, mask, 17, form=form)
        check("d boundary", xd, members, mask, 17, form="dot", prec="bf16")
        check("d boundary", xd, members, mask, 9, "manhattan", None)
    xw = rng.integers(0, 5, size=(4000, 3)).astype(np.float64)
    members = leaves(len(xw), 3, 900)
    check("lists in shared memory", xw, members, full(3, 900), 800)
    members = leaves(len(xw), 3, 1700)
    check("lists in the output rows", xw, members, full(3, 1700), 1600)
    check("lists in the output rows", xw, members, rng.random((3, 1700)) < 0.95, 1600,
          form="dot")
    members = leaves(len(xw), 16, 375)
    for kk in (129, 200):
        for form in ("diff", "dot"):
            check("wide kk", xw, members, rng.random((16, 375)) < 0.97, kk, form=form)
    for d, kk in ((129, 15), (129, 129), (200, 200)):
        xd = rng.integers(0, 3, size=(3000, d)).astype(np.float64)
        members = leaves(len(xd), 8, 375)
        mask = rng.random((8, 375)) < 0.97
        for metric, form in (("euclidean", "diff"), ("euclidean", "dot"), ("manhattan", None)):
            check("wide d", xd, members, mask, kk, metric, form)
    return errors


def _same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def parity_forest() -> list[str]:
    """The four rp-forest kernels against their plain versions on the card,
    bitwise; returns failure messages."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import euclidean_form
    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import rpforest

    errors = []

    def check(label, a, b):
        torch.cuda.synchronize()
        ok = _same(a, b)
        print(f"parity {label}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(label)

    rng = np.random.default_rng(SEED + 1)
    dup = rng.integers(0, 64, size=(2501, 3)).astype(np.float32)
    cases = [
        ("grid 16384x3", rng.integers(0, 256, size=(16384, 3)).astype(np.float32)),
        ("continuous 8192x7", rng.normal(size=(8192, 7)).astype(np.float32)),
        ("grid 5003x3 duplicates, uneven leaves", np.concatenate([dup, dup, dup[:1]])),
    ]
    for label, x in cases:
        n, d = x.shape
        xg = torch.as_tensor(x, device="cuda")
        forest = rpforest.build_forest(x, trees=3, leaf_size=300, seed=SEED)
        members = torch.as_tensor(forest.members, device="cuda")
        mask = torch.as_tensor(forest.leaf_mask, device="cuda")
        lmax = forest.max_leaf
        form = euclidean_form(lmax, lmax, d)
        core = torch.as_tensor(rng.integers(0, 40, n).astype(np.float32), device="cuda")
        ties = core.clone()
        ties[::3] = 1000.0  # the row's own core dominates: its outgoing weights all tie
        comps = {
            "64 random components": torch.as_tensor(rng.integers(0, 64, n).astype(np.int32),
                                                    device="cuda"),
            "round 1": torch.arange(n, dtype=torch.int32, device="cuda"),
            "later round": cell_components(xg),
            "one component": torch.zeros(n, dtype=torch.int32, device="cuda"),
        }
        for k in (1, 15, 128):
            kk = min(k, lmax)
            for prec in ("f32", "bf16"):
                args = (xg, members[0], mask, kk, "euclidean", form, prec, n)
                check(f"B5 forest_leaf_topk {label} k={kk} {prec}",
                      cf.forest_leaf_topk(*args), cf.forest_leaf_topk_plain(*args))
                # B6 on the trees' B5 lists; in bf16 one pair's copies in two
                # trees carry two distances (each leaf its own centre).
                sd, si = leaf_stacks(cf.forest_leaf_topk_plain, xg, forest, members, mask, kk,
                                     form, prec)
                check(f"B6 forest_merge {label} k={kk} {prec} stacks",
                      cf.forest_merge(sd, si, kk, n), cf.forest_merge_plain(sd, si, kk, n))
                if prec == "f32":
                    _, best_i = cf.forest_merge_plain(sd, si, kk, n)
            m = n if kk < 128 else 2048  # the k=128 panel is 16,384 wide
            cand = rpforest._expand(best_i, best_i[:m], kk, n)
            for prec in ("f32", "bf16"):
                args = (xg[:m], xg, cand, kk, "euclidean", prec, n)
                check(f"B7 forest_rescan_topk {label} k={kk} {prec}",
                      cf.forest_rescan_topk(*args), cf.forest_rescan_topk_plain(*args))
            # B8: every component pattern in f32 and bf16, exact weight ties,
            # and at k=128 row counts whose launches cut the candidates into
            # 3, 13 and 64 spans.
            for cname, comp in comps.items():
                for prec in ("f32", "bf16"):
                    args = (xg[:m], xg, cand, core[:m], core, comp[:m], comp, "euclidean", n,
                            prec)
                    check(f"B8 forest_min_outgoing {label} k={kk} {cname} {prec}",
                          cf.forest_min_outgoing(*args), cf.forest_min_outgoing_plain(*args))
            comp = comps["64 random components"]
            rows = (m, 336, 8) if kk == 128 else (m,)
            for r in rows:
                args = (xg[:r], xg, cand[:r], ties[:r], ties, comp[:r], comp, "euclidean", n)
                check(f"B8 forest_min_outgoing {label} k={kk} ties m={r} "
                      f"({cf.minout_splits(r, cand.shape[1])} spans)",
                      cf.forest_min_outgoing(*args), cf.forest_min_outgoing_plain(*args))
    return errors


def cell_components(x):
    """Later-round components: each point's cell of an 8 x 8 x 8 grid over
    its first three features' range (neighbors mostly share a cell)."""
    import torch

    f = x[:, :3]
    lo, hi = f.min(0).values, f.max(0).values
    cell = ((f - lo) / (hi - lo).clamp_min(1e-30) * 8).floor().clamp(0, 7).long()
    scale = torch.tensor([1, 8, 64][: f.shape[1]], device=x.device)
    return (cell * scale).sum(1).to(torch.int32)


def leaf_stacks(leaf_fn, x, forest, members, mask, kk, form, prec, metric="euclidean"):
    """(T, n, kk) per-tree lists of B5's (``leaf_fn``) leaf lists, scattered
    to point-major rows as ``rpforest.forest_knn_shards`` does."""
    import torch

    n = x.shape[0]
    sd = torch.full((forest.trees, n, kk), float("inf"), device=x.device)
    si = torch.full((forest.trees, n, kk), n, dtype=torch.int32, device=x.device)
    real = mask.reshape(-1)
    for t in range(forest.trees):
        nd, ni = leaf_fn(x, members[t], mask, kk, metric, form, prec, n)
        rows = members[t].reshape(-1)[real].long()
        sd[t, rows] = nd.reshape(-1, kk)[real]
        si[t, rows] = ni.reshape(-1, kk)[real]
    return sd, si


def fold_stacks(rng, n: int, trees: int, kk: int, sentinel: int | None = None):
    """(T, n, kk) per-tree lists on the card as B6 takes them, ascending by
    (distance, id) with (+inf, sentinel) tails (``sentinel`` defaults to n):
    each list holds between 0 and kk distinct ids from a pool of about 2 kk,
    so ids recur across trees, each copy with its own integer distance in
    [0, 8) (exact ties, and copies that differ as bf16 leaves make them); a
    fifth of the lists end their real entries at +inf. Where it fits, row 0
    holds the two-tree example whose fold keeps id 4 twice ((1, 1) (5, 4)
    (6, 2) then (2, 3) (3, 4) (7, 5): the fold gives ids 1, 3, 4, 4, 2), its
    other trees' lists empty."""
    import numpy as np
    import torch

    sentinel = n if sentinel is None else sentinel
    pool = min(sentinel, max(2 * kk, 8))
    width = min(kk, pool)
    ids = np.argsort(rng.random((trees, n, pool), dtype=np.float32), axis=2)[:, :, :width]
    m = rng.integers(0, kk + 1, size=(trees, n, 1))
    slot = np.arange(width)[None, None, :]
    live = slot < m
    at_inf = (rng.random((trees, n, 1)) < 0.2) & (slot == np.minimum(m, width) - 1)
    dkey = np.where(live, np.where(at_inf, 8, rng.integers(0, 8, size=ids.shape)), 9)
    key = np.sort(dkey * (sentinel + 1) + np.where(live, ids, sentinel), axis=2)
    sd = np.full((trees, n, kk), np.inf, np.float32)
    si = np.full((trees, n, kk), sentinel, np.int32)
    dk = key // (sentinel + 1)
    sd[:, :, :width] = np.where(dk >= 8, np.inf, dk)
    si[:, :, :width] = key % (sentinel + 1)
    if trees >= 2 and kk >= 3 and n > 5:
        sd[:, 0], si[:, 0] = np.inf, sentinel  # the other trees' row 0 empty
        sd[:2, 0, :3] = [[1, 5, 6], [2, 3, 7]]
        si[:2, 0, :3] = [[1, 4, 2], [3, 4, 5]]
    return (torch.as_tensor(sd, device="cuda"), torch.as_tensor(si, device="cuda"))


def parity_fold() -> list[str]:
    """B6 against its plain version on the card, bitwise, on stacks whose
    copies of one id differ across trees (the fold keeps a later, smaller
    copy beside the earlier one), with sentinel tails of unequal length and
    +inf entries with real ids: 1, 3 and 65 trees at kk 1, 15, 30 and 129;
    4 trees at every kk where a segment's width changes (2 to 64); and
    kk 4,100, whose lists lie in device memory. Returns failure messages."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_forest as cf

    errors = []
    rng = np.random.default_rng(SEED + 9)

    def check(tag, sd, si, kk, sentinel):
        a = cf.forest_merge(sd, si, kk, sentinel)
        b = cf.forest_merge_plain(sd, si, kk, sentinel)
        torch.cuda.synchronize()
        ok = _same(a, b)
        print(f"parity B6 forest_merge {tag}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(f"B6 {tag}")
        return a

    for trees in (1, 3, 65):
        for kk in (1, 15, 30, 129):
            n = 4001 if kk <= 15 else 1501
            sd, si = fold_stacks(rng, n, trees, kk)
            got = check(f"F2 stacks T={trees} kk={kk} n={n}", sd, si, kk, n)
            if trees >= 2 and kk >= 5:
                want = torch.tensor([1, 3, 4, 4, 2], dtype=torch.int32, device="cuda")
                if not torch.equal(got[1][0, :5], want):
                    errors.append(f"B6 the fold's example row at T={trees} kk={kk}")
    for kk in (2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 64):
        sd, si = fold_stacks(rng, 777, 4, kk)
        check(f"F2 stacks T=4 kk={kk} n=777", sd, si, kk, 777)
    sd, si = fold_stacks(rng, 24, 2, 4100, sentinel=10_000)
    check(f"F2 stacks T=2 kk=4100 n=24 ({cf.merge_slots(24, 4100)} warp slots in device "
          "memory)", sd, si, 4100, 10_000)
    return errors


def fold_fits() -> list[str]:
    """B6 through its callers, card against CPU: the bf16 forest query
    (``rpforest_core_distances``, ``knn_backend=fused``,
    ``knn_precision=bf16``), whose trees' copies of one pair differ, and a
    65-tree rp-forest fit, whose one B6 launch folds all 65 trees. Returns
    failure messages."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build, rpforest

    errors = []
    rng = np.random.default_rng(SEED + 10)
    x = rng.normal(size=(20_000, 5))
    kw = dict(min_pts=16, trees=4, leaf_size=512, rescan_rounds=1, knn_backend="fused",
              knn_precision="bf16", return_indices=True)
    card = rpforest.rpforest_core_distances(x, **kw)
    cpu = rpforest.rpforest_core_distances(x, device="cpu", **kw)
    same = all(np.array_equal(a, b) for a, b in zip(card, cpu))
    print(f"bf16 forest query 20000x5 (fused, bf16): card vs CPU "
          f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        errors.append("bf16 forest query card vs CPU")
    g = rng.integers(0, 64, size=(3000, 3)).astype(np.float64)
    params = HDBSCANParams(min_points=8, min_cluster_size=40, knn_index="rpforest",
                           knn_backend="fused", rpf_trees=65, rpf_leaf_size=128)
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    card = exact.fit(g, params)
    torch.cuda.synchronize()
    merges = cuda_build.LAUNCHES["forest_merge"]
    same = fits_equal(card, exact.fit(g, params, device="cpu"))
    print(f"rp-forest fit 3000x3 with 65 trees: card vs CPU {'identical' if same else 'DIFFERENT'}"
          f", B6 launches {merges}")
    if not same or merges != 1:
        errors.append("65-tree forest fit card vs CPU")
    return errors


def blobs(n: int, seed: int, d: int = 8):
    """The rp-forest tier's test blobs: 6 centres x 6.0, unit normal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(6, d)) * 6.0
    per = n // 6 + 1
    return np.concatenate([c + rng.normal(size=(per, d)) for c in centers])[:n]


def ari(a, b) -> float:
    """Adjusted Rand index of two labelings."""
    import numpy as np

    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    table = np.zeros((ia.max() + 1, ib.max() + 1), np.int64)
    np.add.at(table, (ia, ib), 1)

    def comb(x):
        return (x * (x - 1) / 2.0).sum()

    s, sa, sb = comb(table), comb(table.sum(1)), comb(table.sum(0))
    expected = sa * sb / comb(np.array([len(a)]))
    return float((s - expected) / (0.5 * (sa + sb) - expected))


def fits_equal(a, b) -> bool:
    """Two fit results with bitwise-equal labels, core distances, MST and
    outlier scores."""
    import numpy as np

    return (
        np.array_equal(a.labels, b.labels)
        and np.array_equal(a.core_distances, b.core_distances)
        and all(np.array_equal(x, y) for x, y in zip(a.mst, b.mst))
        and np.array_equal(a.outlier_scores, b.outlier_scores)
    )


def run_fit(data, params, **kw):
    """One fit on the card with the launch counters zeroed just before and
    read just after: (result, launches, events by stage, wall s); ``kw``
    goes to ``exact.fit`` (the sharded fit's ``mesh``)."""
    import torch

    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build

    events = []
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = exact.fit(data, params, trace=lambda stage, **f: events.append((stage, f)), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)
    ev = {}
    for stage, f in events:
        ev.setdefault(stage, []).append(f)
    return res, launches, ev, wall


def fit_walls(ev, wall) -> str:
    """The stage walls of one exact fit, as one line."""
    mst = ev["boruvka_mst"][0]
    finalize_s = sum(e[0]["wall_s"] for s, e in ev.items() if s.startswith("tree_"))
    return (f"core_distances {ev['core_distances'][0]['wall_s']}, boruvka_rounds "
            f"{mst['rounds_wall_s']} ({mst['rounds']} rounds), forest_events "
            f"{ev['forest_events'][0]['wall_s']}, fetch {ev['host_sync'][0]['wall_s']}, "
            f"host_finalize {finalize_s:.6f}, total {wall:.3f}")


def oracle_core_err(data, core, min_pts: int, sample: int = 512, seed: int = 0):
    """Max abs and rel error of core distances against a float64 oracle on
    ``sample`` rows, as the reference's ``oracle_core_check``
    (``benchmarks/highdim_eval.py``) computes it; the oracle's products run
    on the card in float64."""
    import numpy as np
    import torch

    rows = np.random.default_rng(seed).choice(len(data), min(sample, len(data)), replace=False)
    x = torch.as_tensor(np.asarray(data, np.float64), device="cuda")
    xr = x[torch.as_tensor(rows, device="cuda")]
    d2 = (xr * xr).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * (xr @ x.T)
    kth = torch.kthvalue(d2, min_pts - 1, dim=1).values
    want = torch.sqrt(torch.clamp_min(kth, 0.0)).cpu().numpy()
    err = np.abs(np.asarray(core)[rows] - want)
    return float(err.max()), float((err / np.maximum(want, 1e-30)).max())


def highd_data(dims: int):
    """The reference's high-d leg data: 8 clusters, separation 3 sqrt(d)."""
    import numpy as np

    from hdbscan_tpu_torch.utils.datasets import make_gauss

    return make_gauss(N_HIGHD, dims=dims, n_clusters=8, separation=3 * np.sqrt(dims), seed=4)


def check_fit(label, res, launches, ev, n, kernels, n_rows=None) -> str | None:
    """The checks every fit passes (``n`` vertices, ``n_rows`` rows when a
    dedup fit's vertices are fewer); a failure message or None."""
    import numpy as np

    from hdbscan_tpu_torch.core import mst_device

    mst = ev["boruvka_mst"][0]
    u, v, w = res.mst
    if mst["edges"] != n - 1 or len(u) != n - 1:
        return f"{label}: MST has {len(u)} edges, expected {n - 1}"
    if mst["rounds"] >= mst_device.DEFAULT_MAX_ROUNDS:
        return f"{label}: Borůvka hit the round cap ({mst['rounds']})"
    if not (np.all(np.isfinite(res.core_distances)) and np.all(np.isfinite(w))):
        return f"{label}: non-finite core distances or MST weights"
    n_rows = n if n_rows is None else n_rows
    if res.labels.shape != (n_rows,) or res.outlier_scores.shape != (n_rows,):
        return f"{label}: result arrays have the wrong shape"
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        return f"{label}: kernels of the path never launched: {missing} ({launches})"
    return None


def report_forest_fit(label, data, params, res, launches, ev, wall, exact_core,
                      exact_labels) -> None:
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.knn import resolve_index_for
    from hdbscan_tpu_torch.ops import rpforest

    mst = ev["boruvka_mst"][0]
    walls = {s: round(sum(e["wall_s"] for e in ev[s]), 6) for s in (
        "knn_index_build", "knn_index_query", "knn_index_rescan", "knn_fused_forest",
        "core_distances", "forest_events", "host_sync")}
    walls["boruvka_rounds"] = mst["rounds_wall_s"]
    walls["host_finalize"] = round(sum(e[0]["wall_s"] for s, e in ev.items()
                                       if s.startswith("tree_")), 6)
    print(f"{label} fit walls (s): {walls}, total {wall:.3f}")
    q = ev["knn_index_query"][0]
    print(f"{label} recall_at_k {q['recall_at_k']} over {q['recall_rows']} rows (k={q['k']}); "
          f"rescan improved {[e['improved'] for e in ev['knn_index_rescan']]}")
    # The final lists (after the rescan rounds), recomputed outside the
    # counted fit: the fit keeps only the core distances.
    _, opts = resolve_index_for(params, len(data))
    _, _, idx = rpforest.rpforest_core_distances(data, params.min_points, params.dist_function,
                                                 k=q["k"], return_indices=True, **opts)
    final, rows = rpforest._sampled_recall(
        torch.as_tensor(data.astype(np.float32), device="cuda"),
        idx[rpforest.recall_rows(len(data), 256)], q["k"], params.dist_function, 256)
    print(f"{label} recall@{q['k']} of the final lists {final} over {rows} rows")
    same = float(np.mean(res.core_distances == exact_core))
    near = float(np.mean(np.isclose(res.core_distances, exact_core, rtol=1e-4, atol=0)))
    print(f"{label} core distance equal to the exact tier's on {same:.6f} of rows, within "
          f"1e-4 relative on {near:.6f}; ARI vs the exact fit {ari(res.labels, exact_labels):.6f}")
    counts = np.bincount(res.labels)
    print(f"{label} rounds {mst['rounds']}, edges {mst['edges']}, labels: {len(counts) - 1} "
          f"clusters, histogram {dict((int(i), int(c)) for i, c in enumerate(counts) if c)}")
    print(f"{label} launches on the fit: {launches}")


def max_err(a, b, ia=None, ib=None) -> float:
    """Largest absolute difference of two value tensors (equal infinities
    count as 0); +inf when the id tensors differ."""
    import torch

    if ia is not None and not torch.equal(ia, ib):
        return float("inf")
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def forest_times(data, fres, launches, k=MIN_PTS - 1, trees=FOREST["rpf_trees"],
                 leaf_size=FOREST["rpf_leaf_size"], suffix="", metric="euclidean",
                 launch_suffix=None) -> list[dict]:
    """The forest kernels timed at a forest fit's shapes (the 3b fit's by
    default) beside their plain versions and bounds: B5 on the first leaf
    batch, B6 on the trees' lists, B7 on the first rescan chunk, B8 on that
    chunk's panel with the fit's core distances and round-1 components.
    ``suffix`` names the rows "_wide" for the wide fit's, or "_cosine" for
    the 3b cosine fit's (``metric``); ``launch_suffix`` (default
    ``suffix``) picks their launch counts. At cosine the yardstick of B5
    and B7 is ``F.normalize``, ``torch.mm`` / ``torch.bmm`` (TF32 off) and
    ``torch.topk``."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import euclidean_form
    from hdbscan_tpu_torch.ops import cuda_build
    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import rpforest

    n, d = data.shape
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    forest = rpforest.build_forest(data, trees=trees, leaf_size=max(leaf_size, 2 * k + 2),
                                   seed=SEED)
    lmax = forest.max_leaf
    kk = min(k, lmax)
    launch_suffix = suffix if launch_suffix is None else launch_suffix
    cosine = metric != "euclidean"
    form = euclidean_form(lmax, lmax, d) if not cosine else None
    pform = metric_form(metric, form)
    members = torch.as_tensor(forest.members, device="cuda")
    mask = torch.as_tensor(forest.leaf_mask, device="cuda")
    batches = rpforest.leaf_batches(forest, "cuda")
    rows = []

    def row(name, source, replaces, launch, args, kernel, plain, nbytes, ops, library=None,
            **extra):
        ms = cuda_ms(lambda: kernel(*args), 5)
        plain_ms = host_ms(lambda: plain(*args))
        a, b = kernel(*args), plain(*args)
        b_ms, by = bound_ms(nbytes, ops)
        if library is not None:
            extra.update(library_ms=cuda_ms(library, 2),
                         library_call=COSINE_CALLS if cosine else TWO_CALLS)
        else:
            extra.setdefault("library_ms", None)
        rows.append(dict(
            name=name + suffix, route="cuda", source=f"hdbscan_tpu_torch/csrc/{source}",
            replaces=f"hdbscan_tpu/ops/pallas_forest.py:{replaces}",
            launches=launches[launch + launch_suffix],
            max_abs_err=max_err(a[0], b[0], a[1], b[1]),
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
            bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3, **extra,
        ))

    a0, b0, _ = batches[0]
    widths = forest.leaf_mask[a0:b0].sum(axis=1).astype(np.float64)
    nb, ell = b0 - a0, lmax

    def leaf_two_calls():
        pts = x[members[0, a0:b0].long()]
        if cosine:
            pn = torch.nn.functional.normalize(pts, dim=2)
            torch.topk(torch.bmm(pn, pn.transpose(1, 2)), kk, dim=2, largest=True)
        else:
            torch.topk(torch.cdist(pts, pts), kk, dim=2, largest=False)

    row("forest_leaf_topk", "forest_leaf_topk.cu", 273, "forest_leaf_topk",
        (x, members[0, a0:b0], mask[a0:b0], kk, metric, form, "f32", n),
        cf.forest_leaf_topk, cf.forest_leaf_topk_plain,
        nb * ell * (4 + 1 + d * 4) + nb * ell * kk * 8,
        float(ell * widths.sum()) * pair_ops(d, pform, root=False), library=leaf_two_calls,
        blocks=cf.leaf_blocks(nb, ell), device_ms=device_ms(
            lambda: cf.forest_leaf_topk(x, members[0, a0:b0], mask[a0:b0], kk, metric,
                                        form, "f32", n), "leaf_topk"))

    sd = torch.full((forest.trees, n, kk), float("inf"), device="cuda")
    si = torch.full((forest.trees, n, kk), n, dtype=torch.int32, device="cuda")
    for t in range(forest.trees):
        for a, b, real in batches:
            nd, ni = cf.forest_leaf_topk(x, members[t, a:b], mask[a:b], kk, metric,
                                         form, "f32", n)
            idx = members[t, a:b].reshape(-1)[real].long()
            sd[t, idx] = nd.reshape(-1, kk)[real]
            si[t, idx] = ni.reshape(-1, kk)[real]
    row("forest_merge", "forest_merge.cu", 344, "forest_merge", (sd, si, kk, n),
        cf.forest_merge, cf.forest_merge_plain,
        forest.trees * n * kk * 8 + n * kk * 8, 0.0,
        library_note="none: no PyTorch call folds sorted lists under a per-id drop rule",
        device_ms=device_ms(lambda: cf.forest_merge(sd, si, kk, n), "merge_"))

    best_d, best_i = cf.forest_merge(sd, si, kk, n)
    chunk = min(n, max(64, rpforest._RESCAN_ELEM_BUDGET // (kk * kk * d)))
    cand = rpforest._expand(best_i, best_i[:chunk], kk, n)
    live = cand[cand != n]
    cands, uniq = float(live.numel()), int(torch.unique(live).numel())

    def rescan_two_calls():
        rows_ = max(1, (1 << 26) // (cand.shape[1] * d))
        xn = torch.nn.functional.normalize(x, dim=1) if cosine else x
        for a in range(0, chunk, rows_):
            b = min(a + rows_, chunk)
            pts = xn[cand[a:b].clamp(max=n - 1).long()]
            if cosine:
                torch.topk(torch.bmm(pts, xn[a:b, :, None])[:, :, 0], kk, dim=1, largest=True)
            else:
                torch.topk(torch.cdist(x[a:b, None, :], pts), kk, dim=2, largest=False)

    row("forest_rescan_topk", "forest_rescan.cu", 411, "forest_rescan_topk",
        (x[:chunk], x, cand, kk, metric, "f32", n),
        cf.forest_rescan_topk, cf.forest_rescan_topk_plain,
        chunk * d * 4 + chunk * kk * kk * 4 + uniq * d * 4 + chunk * kk * 8,
        cands * pair_ops(d, metric_form(metric, "diff"), root=False), library=rescan_two_calls,
        blocks=cf.rescan_blocks(chunk, cand.shape[1], d, kk))

    if suffix != "_wide" or d > cuda_build.WIDE:  # B8's wide mode is d past 128 only
        core = torch.as_tensor(fres.core_distances.astype(np.float32), device="cuda")
        comp = torch.arange(n, dtype=torch.int32, device="cuda")
        margs = (x[:chunk], x, cand, core[:chunk], core, comp[:chunk], comp, metric, n)
        row("forest_min_outgoing", "forest_rescan.cu", 476, "forest_min_outgoing", margs,
            cf.forest_min_outgoing, cf.forest_min_outgoing_plain,
            chunk * (d * 4 + 8) + chunk * kk * kk * 4 + uniq * (d * 4 + 8) + chunk * 8,
            cands * (pair_ops(d, metric_form(metric, "diff")) + 2), library_note=NO_SEGMIN_CALL,
            device_ms=device_ms(lambda: cf.forest_min_outgoing(*margs), "min_outgoing"),
            spans=cf.minout_splits(chunk, cand.shape[1]))
    print(f"forest kernel{suffix} shapes: {n} x {d}, leaf batch {nb} x {ell}, kk {kk}; merge "
          f"{forest.trees} x {n} x {kk}; rescan chunk {chunk} rows x {kk * kk} candidates "
          f"({uniq} distinct)")
    return rows


def parity_window() -> list[str]:
    """B4 against its plain version on the card, bitwise; returns failure
    messages. 32 row tiles of 512 rows, windows of 4 column tiles of 2,048
    (the last tile's window at the last column tile), the last 123 columns
    masked."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import euclidean_form
    from hdbscan_tpu_torch.ops import cuda_knn_window as cw

    errors = []
    rng = np.random.default_rng(SEED + 2)
    cases = [
        ("grid 16384x3", rng.integers(0, 256, size=(16384, 3)).astype(np.float32), 20.0),
        ("continuous 8192x10", rng.normal(size=(8192, 10)).astype(np.float32), 4.0),
    ]
    col_tile, n_win, tiles, rt = 2048, 4, 32, 512
    for label, x, bnd_hi in cases:
        n_all, d = x.shape
        n = n_all - 123
        xg = torch.as_tensor(x, device="cuda")
        ids = torch.as_tensor(rng.integers(0, n, size=(tiles, rt)).astype(np.int32), device="cuda")
        ws = rng.integers(0, n_all // col_tile - n_win + 1, size=tiles)
        ws[-1] = n_all // col_tile - n_win
        wst = torch.as_tensor(ws.astype(np.int32), device="cuda")
        bounds = {
            "bnd inf": torch.full((tiles, rt), float("inf"), device="cuda"),
            "bnd finite": torch.as_tensor(
                rng.uniform(1.0, bnd_hi, size=(tiles, rt)).astype(np.float32), device="cuda"),
        }
        contracts = (("fused", "euclidean", "dot"),
                     ("xla", "euclidean", euclidean_form(512, 8192, d)),
                     ("manhattan", "manhattan", None))
        for bname, bnd in bounds.items():
            for cname, metric, form in contracts:
                for k in (1, 7, 15, 128):
                    args = (xg, n, ids, wst, bnd, k, col_tile, n_win, metric, form)
                    a = cw.knn_window(*args)
                    torch.cuda.synchronize()
                    ok = _same(a, cw.knn_window_plain(*args))
                    tag = f"B4 knn_window {label} {cname} k={k} {bname}"
                    print(f"parity {tag}: {'bitwise' if ok else 'MISMATCH'}")
                    if not ok:
                        errors.append(tag)
    return errors


def parity_highd() -> list[str]:
    """B3 against its plain version on the card, bitwise: both forms, d =
    24, 28, 90 and 128, k = 1, 7, 15 and 128, on 4,099 continuous points
    (a ragged count) and at d = 28 on 4,099 integer-grid points."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_knn_smallest as ks

    errors = []
    rng = np.random.default_rng(SEED + 3)
    cases = [(f"continuous 4099x{d}", rng.normal(size=(4099, d))) for d in HIGHD_DIMS]
    cases.append(("grid 4099x28", rng.integers(0, 16, size=(4099, 28))))
    for label, x in cases:
        xg = torch.as_tensor(x.astype(np.float32), device="cuda")
        for form in ("diff", "dot"):
            for k in (1, 7, 15, 128):
                a = ks.knn_smallest(xg, k, form)
                torch.cuda.synchronize()
                ok = torch.equal(a, ks.knn_smallest_plain(xg, k, form))
                tag = f"B3 knn_smallest {label} {form} k={k}"
                print(f"parity {tag}: {'bitwise' if ok else 'MISMATCH'}")
                if not ok:
                    errors.append(tag)
    return errors


def parity_panels() -> list[str]:
    """B9 and the rectangular B2 against their plain versions on the card,
    bitwise: 5,000 resident rows against a 3,001-column panel at a global
    offset, random components and validity, every metric the kernels take
    (euclidean in both forms), k = 1, 15 and 128, the panel's last columns
    masked as padding."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin

    errors = []

    def check(tag, a, b):
        torch.cuda.synchronize()
        ok = _same(a, b)
        print(f"parity {tag}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(tag)

    rng = np.random.default_rng(SEED + 4)
    r, c, off = 5000, 3001, 12_345
    cases = [
        ("grid", rng.integers(0, 64, size=(r + c, 3)).astype(np.float32)),
        ("continuous", rng.normal(size=(r + c, 7)).astype(np.float32)),
    ]
    for label, x in cases:
        xg = torch.as_tensor(x, device="cuda")
        rows, panel = xg[:r], xg[r:]
        core = torch.as_tensor(rng.integers(0, 8, r + c).astype(np.float32), device="cuda")
        comp = torch.as_tensor(rng.integers(0, 50, r + c).astype(np.int32), device="cuda")
        valid = torch.as_tensor(rng.random(r + c) < 0.95, device="cuda")
        args = (rows, core[:r], comp[:r], valid[:r], panel, core[r:], comp[r:], valid[r:])
        for metric, form in (("euclidean", "diff"), ("euclidean", "dot"),
                             ("manhattan", None), ("supremum", None)):
            check(f"B9 segmin_panel {label} {r}x{c} {metric} {form}",
                  cuda_segmin.min_outgoing_panel(*args, metric, form=form),
                  cuda_segmin.min_outgoing_panel_plain(*args, metric, form))
            for k in (1, 15, 128):
                kw = dict(metric=metric, form=form, id_offset=off)
                check(f"B2 knn_kbest_panel {label} {r}x{c} {metric} {form} k={k}",
                      cuda_knn.knn_kbest_panel(rows, panel, k, n_cols=off + c - 37, **kw),
                      cuda_knn.knn_kbest_panel_plain(rows, panel[: c - 37], k, **kw))
    return errors


def _bits(t):
    """A tensor's bits: float32 as int32 patterns (so +0.0 and -0.0 differ)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _bits_same(a, b) -> bool:
    import torch

    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def metric_cases():
    """The inputs of the cosine and pearson checks (``parity_metrics``):
    (label, float32 points, metrics). Collinear rows (integer multiples of
    a few directions) give negative cosine distances and exact ties; a zero
    row has NaN cosine distances to every row, a constant row NaN pearson
    ones; d = 129 runs the wide modes."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    grid = rng.integers(0, 256, size=(16384, 3)).astype(np.float32)
    cont = rng.normal(size=(8192, 7)).astype(np.float32)
    dirs = rng.integers(1, 5, size=(40, 3)) * rng.choice([-1, 1], size=(40, 3))
    collinear = (dirs[rng.integers(0, 40, 3000)] * rng.integers(1, 6, size=(3000, 1)))
    zero = grid.copy()
    zero[[5, 9000, 9001]] = 0.0  # zero rows in two of the reference's 8,192-column tiles
    const = cont.copy()
    const[[5, 7000]] = 2.5
    both = ("cosine", "pearson")
    return [
        ("grid 16384x3", grid, both),
        ("continuous 8192x7", cont, both),
        ("collinear 3000x3", collinear.astype(np.float32), both),
        ("zero rows 16384x3", zero, ("cosine",)),
        ("constant rows 8192x7", const, ("pearson",)),
        ("wide 2000x129", rng.integers(0, 3, size=(2000, 129)).astype(np.float32), both),
    ]


def parity_metrics() -> list[str]:
    """Cosine and pearson (metric code 6, pearson's rows centred by the
    wrappers) against the plain versions on the card, bit for bit, NaN
    patterns included (``metric_cases``): B1 and B9 (random and round-1
    components, the reference's tile rule at zero-norm rows), K2 and the
    rectangular B2 at k = 1, 15 and 129 (the zero-norm pieces and their
    merge pass where a tile holds such rows), and at cosine B5, B6 (on the
    trees' B5 stacks, with negative distances), B7 and B8; returns failure
    messages."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin, rpforest, tiled

    errors = []

    def check(label, a, b):
        torch.cuda.synchronize()
        ok = _bits_same(a, b)
        print(f"parity {label}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(label)

    rng = np.random.default_rng(SEED + 8)
    for label, x, metrics in metric_cases():
        n, d = x.shape
        xg = torch.as_tensor(x, device="cuda")
        ct = tiled._tile_sizes(n, 1024, 8192)[1]
        core = torch.as_tensor((rng.random(n) * 0.3).astype(np.float32), device="cuda")
        core[::5] = 0.0
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        valid[::97] = False
        comps = {"64 random components": torch.as_tensor(rng.integers(0, 64, n).astype(np.int32),
                                                         device="cuda"),
                 "round 1": torch.arange(n, dtype=torch.int32, device="cuda")}
        r = 1024  # the panel launches: rows [0, r) against columns [r, n)
        for metric in metrics:
            for cname, comp in comps.items():
                args = (xg, core, comp, valid, metric, None, ct)
                check(f"B1 segmin {metric} {label} {cname}", cuda_segmin.segmin(*args),
                      cuda_segmin.min_outgoing_plain(*args))
                pargs = (xg[:r], core[:r], comp[:r], valid[:r], xg[r:], core[r:], comp[r:],
                         valid[r:], metric)
                check(f"B9 segmin_panel {metric} {label} {cname}",
                      cuda_segmin.min_outgoing_panel(*pargs, 1024, r, col_offset=r),
                      cuda_segmin.min_outgoing_panel_plain(*pargs, None, r, r))
            for k in (1, 15, 129):
                check(f"K2 knn_kbest {metric} {label} k={k}",
                      cuda_knn.knn_kbest(xg, k, metric, None, ct),
                      cuda_knn.knn_kbest_plain(xg, k, metric, None, ct))
                check(f"B2 knn_kbest_panel {metric} {label} k={k}",
                      cuda_knn.knn_kbest_panel(xg[:r], xg[r:], k, metric, None, r, col_tile=r),
                      cuda_knn.knn_kbest_panel_plain(xg[:r], xg[r:], k, metric, None, r, r))
        if "cosine" not in metrics:
            continue
        forest = rpforest.build_forest(x, trees=3, leaf_size=300, seed=SEED)
        members = torch.as_tensor(forest.members, device="cuda")
        mask = torch.as_tensor(forest.leaf_mask, device="cuda")
        for k in (1, 15, 129):
            kk = min(k, forest.max_leaf)
            args = (xg, members[0], mask, kk, "cosine", None, "f32", n)
            check(f"B5 forest_leaf_topk cosine {label} k={kk}", cf.forest_leaf_topk(*args),
                  cf.forest_leaf_topk_plain(*args))
            sd, si = leaf_stacks(cf.forest_leaf_topk_plain, xg, forest, members, mask, kk, None,
                                 "f32", "cosine")
            neg = int((sd < 0).sum())
            check(f"B6 forest_merge cosine {label} k={kk} stacks ({neg} negative entries)",
                  cf.forest_merge(sd, si, kk, n), cf.forest_merge_plain(sd, si, kk, n))
            _, best_i = cf.forest_merge_plain(sd, si, kk, n)
            m = min(n, max(64, (1 << 22) // (kk * kk)))
            cand = rpforest._expand(best_i, best_i[:m], kk, n)
            args = (xg[:m], xg, cand, kk, "cosine", "f32", n)
            check(f"B7 forest_rescan_topk cosine {label} k={kk}", cf.forest_rescan_topk(*args),
                  cf.forest_rescan_topk_plain(*args))
            for cname, comp in comps.items():
                args = (xg[:m], xg, cand, core[:m], core, comp[:m], comp, "cosine", n)
                check(f"B8 forest_min_outgoing cosine {label} k={kk} {cname}",
                      cf.forest_min_outgoing(*args), cf.forest_min_outgoing_plain(*args))
    return errors


def parity_segmin() -> list[str]:
    """The redesigned segment-min (K1/B1, B9) against its plain version,
    bit for bit (weights as int32 patterns): equal-weight winners on both
    sides of a column-split boundary, all-zero cores on a grid with
    duplicates, every register instantiation's d and the wide mode (d =
    129, 200), every metric, square and panel launches."""
    import ctypes

    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_build, cuda_segmin

    errors = []

    def check(tag, a, b):
        torch.cuda.synchronize()
        ok = _bits_same(a, b)
        print(f"parity {tag}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(tag)

    rng = np.random.default_rng(SEED + 6)
    splits_of = cuda_build.function("segmin.cu", "segmin_splits", [ctypes.c_int] * 3)
    # Ties across a split boundary: identical points, zero cores, and only
    # the columns just before and after the boundary in another component.
    n = 1 << 16
    splits = splits_of(n, n, 3)
    span = -(-n // splits)
    x = torch.zeros((n, 3), device="cuda")
    zero = torch.zeros(n, device="cuda")
    comp = torch.zeros(n, dtype=torch.int32, device="cuda")
    comp[span - 1: span + 1] = 1
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    for form in ("diff", "dot"):
        a = cuda_segmin.segmin(x, zero, comp, valid, "euclidean", form)
        check(f"K1 segmin split-boundary ties ({splits} splits, span {span}) {form}", a,
              cuda_segmin.min_outgoing_plain(x, zero, comp, valid, "euclidean", form))
        if int(a[1][0]) != span - 1:
            errors.append(f"K1 split-boundary tie went to column {int(a[1][0])}")
    side = (x, zero, comp, valid)
    check("B9 segmin_panel split-boundary ties",
          cuda_segmin.min_outgoing_panel(*side, *side, "euclidean", form="diff"),
          cuda_segmin.min_outgoing_panel_plain(*side, *side, "euclidean", "diff"))
    # All-zero cores on a small grid: many zero weights, many exact ties.
    g = torch.as_tensor(rng.integers(0, 4, size=(20000, 3)).astype(np.float32), device="cuda")
    z = torch.zeros(20000, device="cuda")
    gc = torch.as_tensor(rng.integers(0, 50, 20000).astype(np.int32), device="cuda")
    gv = torch.as_tensor(rng.random(20000) < 0.9, device="cuda")
    for metric, form in (("euclidean", "diff"), ("euclidean", "dot"), ("manhattan", None),
                         ("supremum", None)):
        check(f"K1 segmin zero cores grid 20000x3 {metric} {form}",
              cuda_segmin.segmin(g, z, gc, gv, metric, form),
              cuda_segmin.min_outgoing_plain(g, z, gc, gv, metric, form))
    # Every instantiation's d, and the wide mode.
    for d in (1, 2, 4, 5, 8, 9, 28, 32, 33, 128, 129, 200):
        grid = d in (28, 129, 200)
        n = 3000 if d > 128 else 5000
        xs = rng.integers(0, 3, size=(n, d)) if grid else rng.normal(size=(n, d))
        xg = torch.as_tensor(xs.astype(np.float32), device="cuda")
        core = torch.as_tensor(rng.integers(0, 6, n).astype(np.float32), device="cuda")
        comp = torch.as_tensor(rng.integers(0, 40, n).astype(np.int32), device="cuda")
        valid = torch.as_tensor(rng.random(n) < 0.95, device="cuda")
        r = n // 2
        args = (xg[:r], core[:r], comp[:r], valid[:r], xg[r:], core[r:], comp[r:], valid[r:])
        for metric, form in (("euclidean", "diff"), ("euclidean", "dot"), ("manhattan", None),
                             ("supremum", None)):
            tag = f"{'grid' if grid else 'continuous'} {n}x{d} {metric} {form}"
            check(f"K1 segmin {tag}", cuda_segmin.segmin(xg, core, comp, valid, metric, form),
                  cuda_segmin.min_outgoing_plain(xg, core, comp, valid, metric, form))
            check(f"B9 segmin_panel {tag}",
                  cuda_segmin.min_outgoing_panel(*args, metric, form=form),
                  cuda_segmin.min_outgoing_panel_plain(*args, metric, form))
    return errors


def parity_kbest() -> list[str]:
    """The k-best body (K2, the rectangular B2, B3) against its plain
    versions, bit for bit (distances as int32 patterns, ids): equal
    distances on both sides of a column-split boundary (the lower ids must
    win) among points duplicated more than k times; a split with fewer than
    k columns it can admit (the others infinitely far; a span is never
    shorter than 1,024 columns); nx < k; nq below one block; every d
    instantiation boundary at every k bucket boundary, on every metric and
    form, B3's codes 4/5 and the rectangular entry with ``id_offset`` and
    ``n_cols`` padding. One line per group; each mismatch on its own."""
    import ctypes

    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_build, cuda_knn
    from hdbscan_tpu_torch.ops import cuda_knn_smallest as ks

    errors = []
    counts = {}

    def check(group, tag, a, b):
        torch.cuda.synchronize()
        ok = _bits_same(a, b)
        counts[group] = counts.get(group, 0) + 1
        if not ok:
            print(f"parity kbest {tag}: MISMATCH")
            errors.append(tag)

    def k2(group, tag, x, k, metric, form):
        check(group, f"K2 {tag} {metric} {form} k={k}", cuda_knn.knn_kbest(x, k, metric, form),
              cuda_knn.knn_kbest_plain(x, k, metric, form))

    def b3(group, tag, x, k, form):
        check(group, f"B3 {tag} {form} k={k}", (ks.knn_smallest(x, k, form),),
              (ks.knn_smallest_plain(x, k, form),))

    def b2(group, tag, q, panel, k, metric, form, off, pad):
        kw = dict(metric=metric, form=form, id_offset=off)
        check(group, f"B2 {tag} {metric} {form} k={k}",
              cuda_knn.knn_kbest_panel(q, panel, k, n_cols=off + len(panel) - pad, **kw),
              cuda_knn.knn_kbest_panel_plain(q, panel[: len(panel) - pad], k, **kw))

    forms = (("euclidean", "diff"), ("euclidean", "dot"), ("manhattan", None),
             ("supremum", None))
    splits_of = cuda_build.function("knn_kbest.cu", "knn_kbest_splits", [ctypes.c_int] * 5)
    rng = np.random.default_rng(SEED + 8)

    # Ties across a split boundary: eight points at the origin around the
    # first boundary, every other point duplicated at (0, 0, 3).
    n, k = 6000, 6
    span = -(-n // splits_of(n, n, 3, k, 1))
    x = torch.zeros((n, 3), device="cuda")
    x[:, 2] = 3.0
    x[span - 4: span + 4] = 0.0
    for metric, form in forms:
        k2("split-boundary ties", f"ties at {span}", x, k, metric, form)
        ids = cuda_knn.knn_kbest(x, k, metric, form)[1][span - 4]
        if ids.tolist() != list(range(span - 4, span + 2)):
            errors.append(f"K2 split-boundary tie {metric} {form}: ids {ids.tolist()}")
    for form in ("diff", "dot"):
        b3("split-boundary ties", f"ties at {span}", x, k, form)
    q = torch.zeros((300, 3), device="cuda")
    span = -(-n // splits_of(300, n, 3, k, 1))
    panel = torch.full((n, 3), 3.0, device="cuda")
    panel[span - 4: span + 4] = 0.0
    for metric, form in forms:
        b2("split-boundary ties", f"ties at {span} of a panel", q, panel, k, metric, form,
           50_000, 0)
        ids = cuda_knn.knn_kbest_panel(q, panel, k, metric, form, id_offset=50_000)[1][0]
        if ids.tolist() != list(range(50_000 + span - 4, 50_000 + span + 2)):
            errors.append(f"B2 split-boundary tie {metric} {form}: ids {ids.tolist()}")

    # A split with fewer than k columns it can admit: split 1's columns lie
    # infinitely far (3e38 overflows the diff form and manhattan), but 3.
    n = 4096
    span = -(-n // splits_of(n, n, 3, 15, 1))
    x = rng.integers(0, 8, size=(n, 3)).astype(np.float32)
    x[span: 2 * span] = 3e38
    x[span + 100: span + 103] = 2.0
    xg = torch.as_tensor(x, device="cuda")
    for metric, form in (("euclidean", "diff"), ("manhattan", None)):
        k2("short split", "3 admissible columns in split 1", xg, 15, metric, form)
    b3("short split", "3 admissible columns in split 1", xg, 15, "diff")

    # nx < k, and nq below one block.
    tiny = torch.as_tensor(rng.integers(0, 4, size=(5, 3)).astype(np.float32), device="cuda")
    small = torch.as_tensor(rng.integers(0, 4, size=(50, 3)).astype(np.float32), device="cuda")
    for k in (15, 128):
        for metric, form in forms:
            k2("nx < k, small nq", "5 points", tiny, k, metric, form)
            k2("nx < k, small nq", "50 points", small, k, metric, form)
            b2("nx < k, small nq", "5 rows x 5 columns", tiny, tiny, k, metric, form, 9, 0)
        for form in ("diff", "dot"):
            b3("nx < k, small nq", "5 points", tiny, k, form)

    # Every d boundary at every k bucket boundary: 2,500 points (two splits)
    # on an integer grid with duplicate ties; the rectangular entry at 100
    # query rows (below one block) against the other 2,400, 37 padding.
    for d in (1, 3, 4, 5, 8, 9, 24, 28, 32, 33, 64, 90, 128):
        x = torch.as_tensor(rng.integers(0, 3, size=(2500, d)).astype(np.float32),
                            device="cuda")
        group = f"d={d}"
        for k in (1, 7, 8, 9, 15, 16, 17, 32, 33, 128):
            for metric, form in forms:
                k2(group, f"grid 2500x{d}", x, k, metric, form)
            for form in ("diff", "dot"):
                b3(group, f"grid 2500x{d}", x, k, form)
            if k in (7, 16, 33):
                for metric, form in (("euclidean", "diff"), ("manhattan", None)):
                    b2(group, f"grid 100x2400x{d}", x[:100], x[100:], k, metric, form,
                       12_345, 37)
    for d in (3, 8, 28):
        x = torch.as_tensor(rng.normal(size=(3000, d)).astype(np.float32), device="cuda")
        for metric, form in forms:
            k2("continuous", f"continuous 3000x{d}", x, 15, metric, form)
        b3("continuous", f"continuous 3000x{d}", x, 7, "dot")
    for group, c in counts.items():
        print(f"parity kbest {group}: {c} checks")
    print(f"parity kbest: {sum(counts.values())} checks, "
          f"{'all bitwise' if not errors else f'{len(errors)} MISMATCHES'}")
    return errors


def parity_rescan() -> list[str]:
    """B7 (the rescan top-k) against its plain version, bit for bit
    (distances as int32 patterns, ids), one line per group: exact ties at
    the k-th slot on integer grids (the lower id must win); one id copied
    many times, inside one span and across spans; rows and spans with fewer
    live candidates than k, all-sentinel rows; k from 1 to 200 in f32 and
    bf16; m below one block and at one row; d at every instantiation
    boundary (1 to 200) in f32 (diff form, manhattan, supremum), bf16, and
    the dot form (C d past the diff form's budget); and the budget cuts
    (lists past 32 KB a block, query rows past 16 KB)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_forest as cf

    errors, counts = [], {}

    def check(group, tag, q, x, cand, k, metric="euclidean", prec="f32"):
        args = (q, x, cand, k, metric, prec, len(x))
        a = cf.forest_rescan_topk(*args)
        torch.cuda.synchronize()
        ok = _bits_same(a, cf.forest_rescan_topk_plain(*args))
        counts[group] = counts.get(group, 0) + 1
        if not ok:
            print(f"parity rescan {tag}: MISMATCH")
            errors.append(f"B7 {tag}")
        return a

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a).astype(dtype), device="cuda")

    rng = np.random.default_rng(SEED + 9)
    # Exact ties at the k-th slot: 3,000 points of a 3 x 3 x 3 grid (every
    # distance many times over), 64 rows of max(k^2, 64) random candidates.
    g = dev(rng.integers(0, 3, size=(3000, 3)))
    for k in (1, 7, 15, 16, 17, 32, 33, 63, 127, 128, 129, 200):
        c = max(k * k, 64)
        cand = dev(rng.integers(0, 3000, size=(64, c)), np.int32)
        for prec in ("f32", "bf16") if k <= 128 else ("f32",):
            check("k-th ties", f"grid 64 rows x {c} k={k} {prec}", g[:64], g, cand, k,
                  prec=prec)
        if k in (15, 129):
            for metric in ("manhattan", "supremum"):
                check("k-th ties", f"grid 64 rows x {c} k={k} {metric}", g[:64], g, cand, k,
                      metric)
    # 40 points at distance 1 from the query, met in descending id among
    # 8,192 slots (32 spans): the 15 lowest ids must win.
    x = np.full((60, 3), 5.0)
    x[0] = 0.0
    x[1:41] = (1.0, 0.0, 0.0)
    row = np.full(8192, 60)
    row[np.sort(rng.choice(8192, 40, replace=False))] = np.arange(40, 0, -1)
    xt, rt_ = dev(x), dev(row[None], np.int32)
    for prec in ("f32", "bf16"):
        got = check("k-th ties", f"40 ties across spans {prec}", xt[:1], xt, rt_, 15,
                    prec=prec)
        if got[1][0].tolist() != list(range(1, 16)):
            errors.append(f"B7 tie at the k-th slot {prec}: ids {got[1][0].tolist()}")
    print(f"B7 spans of a 1-row launch of 8,192 candidates: {cf.rescan_splits(1, 8192, 3, 15)}")

    # One id copied many times: inside span 0 and on both sides of every span
    # boundary of 8 rows x 4,096 candidates.
    m, c = 8, 4096
    for k in (15, 33, 129):
        splits = cf.rescan_splits(m, c, 3, k)
        span = -(-c // splits)
        cand = rng.integers(0, 3000, size=(m, c))
        cand[:, rng.choice(span, 50, replace=False)] = 7
        for y in range(1, splits):
            cand[:, y * span - 1: y * span + 1] = 7
        for prec in ("f32", "bf16") if k <= 128 else ("f32",):
            got = check("copies", f"id 7 copied {50 + 2 * (splits - 1)} times over {splits} "
                        f"spans k={k} {prec}", g[:m], g, dev(cand, np.int32), k, prec=prec)
            if int((got[1] == 7).sum(dim=1).max()) > 1:
                errors.append(f"B7 copies of id 7 kept twice at k={k} {prec}")

    # Fewer live candidates than k: 3 live slots in three spans, an
    # all-sentinel row, a whole span of sentinels, rows 90% sentinel.
    for k in (15, 129):
        splits = cf.rescan_splits(m, c, 3, k)
        span = -(-c // splits)
        cand = rng.integers(0, 3000, size=(m, c))
        cand[0] = 3000
        cand[0, [0, span, c - 1]] = (11, 12, 13)
        cand[1] = 3000
        cand[2, span: 2 * span] = 3000
        cand[3:][rng.random((m - 3, c)) < 0.9] = 3000
        for prec in ("f32", "bf16") if k <= 128 else ("f32",):
            check("few live", f"short rows and spans k={k} {prec}", g[:m], g,
                  dev(cand, np.int32), k, prec=prec)

    # m below one block (four rows) and at one row.
    for m in (1, 2, 3):
        for k in (15, 129):
            cand = dev(rng.integers(0, 3000, size=(m, k * k)), np.int32)
            check("small m", f"{m} rows x {k * k} k={k}", g[:m], g, cand, k)

    # Every d boundary: 2,000 points of a 0..2 grid, 40 rows x 600 candidates.
    for d in (1, 2, 3, 4, 5, 8, 9, 31, 32, 33, 64, 128, 129, 200):
        x = dev(rng.integers(0, 3, size=(2000, d)))
        cand = dev(rng.integers(0, 2000, size=(40, 600)), np.int32)
        for k in (7, 33):
            for metric in ("euclidean", "manhattan", "supremum"):
                check("d boundaries", f"grid 2000x{d} {metric} k={k}", x[:40], x, cand, k,
                      metric)
            if d <= 128:
                check("d boundaries", f"grid 2000x{d} bf16 k={k}", x[:40], x, cand, k,
                      prec="bf16")
    for d in (3, 8, 33, 128, 129):
        c = (1 << 25) // d + 1  # one row's panel past the diff form's budget
        if cf.euclid_form(1, c, d) != "dot":
            errors.append(f"B7 dot-form check at d={d} is not in the dot form")
        x = dev(rng.integers(0, 3, size=(3000, d)))
        cand = dev(rng.integers(0, 3000, size=(2, c)), np.int32)
        check("d boundaries", f"grid 2 rows x {c} x {d} dot k=15", x[:2], x, cand, 15)

    # The budget cuts: k = 1,100 (lists in device memory), d = 1,100 (rows
    # read from device memory).
    cand = dev(rng.integers(0, 3000, size=(8, 3000)), np.int32)
    check("budget cuts", "k=1100 lists in device memory", g[:8], g, cand, 1100)
    x = dev(rng.integers(0, 3, size=(500, 1100)))
    cand = dev(rng.integers(0, 500, size=(6, 300)), np.int32)
    check("budget cuts", "d=1100 rows in device memory", x[:6], x, cand, 33)

    for group, n in counts.items():
        print(f"parity rescan {group}: {n} checks")
    print(f"parity rescan: {sum(counts.values())} checks, "
          f"{'all bitwise' if not errors else f'{len(errors)} MISMATCHES'}")
    return errors


def parity_window_guard() -> list[str]:
    """B4 (the window body) against its plain version, bit for bit: on a
    0..3 integer grid (exact ties everywhere), row tiles of 1, 33 and 512
    slots, k = 1, 7, 8, 9, 15, 16, 17, 33 and 128 (lists in shared memory up
    to 64 KB a tile, in device memory above), the fused (dot), XLA (diff),
    manhattan and supremum contracts, with ``bnd`` at +inf, at 0 and equal
    to exact grid distances (each slot's nearest column in its window's
    first tile, or a random column of its second: a guard must not fire on
    equality); windows past n (one partly, one wholly); k above a window's
    columns; and every d instantiation boundary."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import pairwise_distance
    from hdbscan_tpu_torch.ops import cuda_knn_window as cw

    errors, counts = [], {}

    def check(group, tag, args):
        a = cw.knn_window(*args)
        torch.cuda.synchronize()
        ok = _bits_same(a, cw.knn_window_plain(*args))
        counts[group] = counts.get(group, 0) + 1
        if not ok:
            print(f"parity window {tag}: MISMATCH")
            errors.append(f"B4 {tag}")

    rng = np.random.default_rng(SEED + 10)
    contracts = (("fused", "euclidean", "dot"), ("xla", "euclidean", "diff"),
                 ("manhattan", "manhattan", None), ("supremum", "supremum", None))

    def window(x, n, tiles, rt, col_tile, n_win):
        ids = torch.as_tensor(rng.integers(0, n, size=(tiles, rt)).astype(np.int32),
                              device="cuda")
        n_tiles = -(-len(x) // col_tile)
        ws = rng.integers(0, n_tiles - n_win + 1, size=tiles)
        ws[-2:] = (n_tiles - n_win, n_tiles - 1)  # partly, then wholly past n
        return ids, torch.as_tensor(ws.astype(np.int32), device="cuda")

    def grid_bnd(x, n, ids, wst, col_tile, metric, form):
        """Each slot's distance to its nearest column of its window's first
        tile; odd slots instead to a random column of the second."""
        xr = x[ids.long()]
        cols = torch.clamp(wst[:, None].long() * col_tile + torch.arange(col_tile, device="cuda"),
                           max=n - 1)
        near = pairwise_distance(xr, x[cols], metric, form).amin(dim=2)
        pick = torch.clamp(wst[:, None].long() * col_tile + col_tile + torch.as_tensor(
            rng.integers(0, col_tile, size=ids.shape), device="cuda"), max=n - 1)
        other = pairwise_distance(xr[..., None, :], x[pick][..., None, :], metric,
                                  form)[..., 0, 0]
        odd = torch.arange(ids.shape[1], device="cuda") % 2 == 1
        return torch.where(odd, other, near).contiguous()

    x = torch.as_tensor(rng.integers(0, 4, size=(4000, 3)).astype(np.float32), device="cuda")
    n, col_tile, n_win, tiles = 3950, 256, 3, 6
    for rt in (1, 33, 512):
        ids, wst = window(x, n, tiles, rt, col_tile, n_win)
        for cname, metric, form in contracts:
            bounds = {"bnd inf": torch.full((tiles, rt), float("inf"), device="cuda"),
                      "bnd 0": torch.zeros((tiles, rt), device="cuda"),
                      "bnd grid distances": grid_bnd(x, n, ids, wst, col_tile, metric, form)}
            for bname, bnd in bounds.items():
                for k in (1, 7, 8, 9, 15, 16, 17, 33, 128):
                    check(f"row tile {rt}", f"grid 4000x3 rt={rt} {cname} k={k} {bname}",
                          (x, n, ids, wst, bnd, k, col_tile, n_win, metric, form))
    # k above a window's columns: windows of 2 x 16 columns.
    ids, wst = window(x, n, tiles, 33, 16, 2)
    inf = torch.full((tiles, 33), float("inf"), device="cuda")
    for k in (33, 128):
        for cname, metric, form in contracts:
            check("k above the window", f"windows of 32 columns {cname} k={k}",
                  (x, n, ids, wst, inf, k, 16, 2, metric, form))
    # Every d instantiation boundary, continuous and grid points.
    for d in (1, 4, 5, 8, 9, 32, 33, 128):
        xd = rng.normal(size=(3000, d)) if d % 2 else rng.integers(0, 3, size=(3000, d))
        xd = torch.as_tensor(xd.astype(np.float32), device="cuda")
        for rt in (33, 512):
            ids, wst = window(xd, 2990, 4, rt, 512, 2)
            bnd = torch.as_tensor(rng.uniform(0.5, 3.0, size=(4, rt)).astype(np.float32),
                                  device="cuda")
            for cname, metric, form in contracts[:3]:
                for k in (7, 33):
                    check(f"d={d}", f"3000x{d} rt={rt} {cname} k={k}",
                          (xd, 2990, ids, wst, bnd, k, 512, 2, metric, form))
    for group, c in counts.items():
        print(f"parity window {group}: {c} checks")
    print(f"parity window: {sum(counts.values())} checks, "
          f"{'all bitwise' if not errors else f'{len(errors)} MISMATCHES'}")
    return errors


def parity_wide() -> list[str]:
    """Every wide mode (k or d past 128) against its plain version on the
    card, bit for bit: the k-best kernel square and rectangular (K2, B2),
    the window kernel (B4) in both contracts, the forest kernels (B5-B8),
    at d = 129 and 200 and k = 129 and 200, on integer grids with
    duplicate ties and on continuous points; and B3's refusal past 128."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import euclidean_form
    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import cuda_knn
    from hdbscan_tpu_torch.ops import cuda_knn_smallest as ks
    from hdbscan_tpu_torch.ops import cuda_knn_window as cw
    from hdbscan_tpu_torch.ops import rpforest

    errors = []

    def check(tag, a, b):
        torch.cuda.synchronize()
        ok = _bits_same(a, b)
        print(f"parity {tag}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(tag)

    rng = np.random.default_rng(SEED + 7)
    dup = rng.integers(0, 8, size=(1500, 3))
    cases = [
        ("grid 3000x129", rng.integers(0, 3, size=(3000, 129)), (15, 129, 200)),
        ("grid 3000x200", rng.integers(0, 3, size=(3000, 200)), (15, 200)),
        ("continuous 2500x129", rng.normal(size=(2500, 129)), (15, 129)),
        ("grid 3000x3 duplicates", np.concatenate([dup, dup]), (129, 200)),
    ]
    for label, xs, kvals in cases:
        x = torch.as_tensor(xs.astype(np.float32), device="cuda")
        n, d = x.shape
        for k in kvals:
            for form in ("diff", "dot"):
                check(f"K2 knn_kbest wide {label} {form} k={k}",
                      cuda_knn.knn_kbest(x, k, "euclidean", form),
                      cuda_knn.knn_kbest_plain(x, k, "euclidean", form))
            kw = dict(metric="manhattan", form=None, id_offset=777)
            check(f"B2 knn_kbest_panel wide {label} manhattan k={k}",
                  cuda_knn.knn_kbest_panel(x[:1000], x[1000:], k, n_cols=777 + n - 1000 - 5,
                                           **kw),
                  cuda_knn.knn_kbest_panel_plain(x[:1000], x[1000: n - 5], k, **kw))
            # B4: 8 row tiles of 256 slots, windows of 2 column tiles of 512.
            tiles, rt, col_tile, n_win = 8, 256, 512, 2
            ids = torch.as_tensor(rng.integers(0, n, size=(tiles, rt)).astype(np.int32),
                                  device="cuda")
            last = (n - 1) // col_tile
            ws = rng.integers(0, last, size=tiles)
            ws[-1] = last - 1
            wst = torch.as_tensor(ws.astype(np.int32), device="cuda")
            for bname, bnd in (("bnd inf", torch.full((tiles, rt), float("inf"), device="cuda")),
                               ("bnd finite", torch.as_tensor(rng.uniform(
                                   1.0, 12.0, size=(tiles, rt)).astype(np.float32),
                                   device="cuda"))):
                for cname, form in (("fused", "dot"),
                                    ("xla", euclidean_form(rt, col_tile, d))):
                    args = (x, n - 3, ids, wst, bnd, k, col_tile, n_win, "euclidean", form)
                    check(f"B4 knn_window wide {label} {cname} k={k} {bname}",
                          cw.knn_window(*args), cw.knn_window_plain(*args))
        # The forest kernels: one tree's leaves, its merge, a rescan panel.
        forest = rpforest.build_forest(xs.astype(np.float32), trees=2, leaf_size=450,
                                       seed=SEED)
        members = torch.as_tensor(forest.members, device="cuda")
        mask = torch.as_tensor(forest.leaf_mask, device="cuda")
        lmax = forest.max_leaf
        form = euclidean_form(lmax, lmax, d)
        core = torch.as_tensor(rng.integers(0, 6, n).astype(np.float32), device="cuda")
        comp = torch.as_tensor(rng.integers(0, 40, n).astype(np.int32), device="cuda")
        for k in kvals:
            kk = min(k, lmax)
            args = (x, members[0], mask, kk, "euclidean", form, "f32", n)
            check(f"B5 forest_leaf_topk wide {label} k={kk}",
                  cf.forest_leaf_topk(*args), cf.forest_leaf_topk_plain(*args))
            sd, si = leaf_stacks(cf.forest_leaf_topk_plain, x, forest, members, mask, kk, form,
                                 "f32")
            check(f"B6 forest_merge wide {label} k={kk}",
                  cf.forest_merge(sd, si, kk, n), cf.forest_merge_plain(sd, si, kk, n))
            _, best_i = cf.forest_merge_plain(sd, si, kk, n)
            m = 32
            cand = rpforest._expand(best_i, best_i[:m], kk, n)
            args = (x[:m], x, cand, kk, "euclidean", "f32", n)
            check(f"B7 forest_rescan_topk wide {label} k={kk}",
                  cf.forest_rescan_topk(*args), cf.forest_rescan_topk_plain(*args))
            if d > 128:
                args = (x[:m], x, cand, core[:m], core, comp[:m], comp, "euclidean", n)
                check(f"B8 forest_min_outgoing wide {label} k={kk}",
                      cf.forest_min_outgoing(*args), cf.forest_min_outgoing_plain(*args))
    x = torch.zeros((300, 129), device="cuda")
    for k, xx in ((15, x), (129, x[:, :3].contiguous())):
        try:
            ks.knn_smallest(xx, k, "dot")
            errors.append(f"B3 ran past 128 lanes (k={k}, d={xx.shape[1]})")
        except ValueError as e:
            print(f"B3 knn_smallest refuses k={k}, d={xx.shape[1]}: {e}")
    return errors


def trees_equal(a, b) -> bool:
    """Two condensed trees with bitwise-equal fields."""
    import dataclasses

    import numpy as np

    return all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def highd_card_vs_cpu() -> list[str]:
    """The high-d fit on 4,096 points of the path's generator: the card's
    fit with ``knn_backend=auto`` (which must take B3) equals the CPU fit
    with ``knn_backend=pallas`` (B3's plain version); failure messages."""
    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    data, _ = make_gauss(4096, dims=28, n_clusters=8, separation=3 * np.sqrt(28), seed=4)
    small = dict(HIGHD_PARAMS, min_cluster_size=50)
    cuda_build.reset_launches()
    card = exact.fit(data, HDBSCANParams(**small))
    b3 = cuda_build.LAUNCHES["knn_smallest"]
    cpu = exact.fit(data, HDBSCANParams(**small, knn_backend="pallas"), device="cpu")
    same = fits_equal(card, cpu) and trees_equal(card.tree, cpu.tree)
    print(f"high-d card fit (auto, B3 launches {b3}) vs CPU fit (pallas) on 4096 x 28: "
          f"{'identical' if same else 'DIFFERENT'}")
    return [] if same and b3 > 0 else ["high-d 4096 card vs CPU"]


def shard_mesh():
    """The sharded fit's mesh: one shard per card from four cards on, else
    four shards on the first card."""
    import torch

    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    if torch.cuda.device_count() >= N_SHARDS:
        return get_mesh([torch.device("cuda", i) for i in range(N_SHARDS)])
    return get_mesh([torch.device("cuda", 0)] * N_SHARDS)


def sharded_card_vs_cpu(mesh) -> list[str]:
    """The sharded fit on 8,000 Skin-shaped points (all four shards hold
    rows) over ``mesh`` equals the same fit over four CPU shards."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    data = np.random.default_rng(SEED + 5).integers(0, 256, size=(8000, 3)).astype(np.float64)
    p = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50, **SHARDED)
    card = exact.fit(data, p, mesh=mesh)
    cpu = exact.fit(data, p, mesh=get_mesh([torch.device("cpu")] * N_SHARDS))
    same = fits_equal(card, cpu) and trees_equal(card.tree, cpu.tree)
    print(f"sharded card fit vs sharded CPU fit on 8000 points, {N_SHARDS} shards: "
          f"{'identical' if same else 'DIFFERENT'}")
    return [] if same else ["sharded 8000 card vs CPU"]


def mr_fits_equal(a, b) -> bool:
    """Two MR fit results with equal labels, level stats, core distances,
    outlier scores, condensed-tree fields, consensus provenance and kept
    edge pools (bitwise)."""
    import dataclasses

    import numpy as np

    def stats(r):
        return [{k: v for k, v in dataclasses.asdict(lv).items() if k != "wall_s"}
                for lv in r.levels]

    pools = (a.edge_pool is None) == (b.edge_pool is None) and (
        a.edge_pool is None or all(np.array_equal(x, y) for x, y in zip(a.edge_pool, b.edge_pool)))
    return (
        a.n_levels == b.n_levels and stats(a) == stats(b) and trees_equal(a.tree, b.tree)
        and np.array_equal(a.labels, b.labels)
        and np.array_equal(a.core_distances, b.core_distances)
        and np.array_equal(a.outlier_scores, b.outlier_scores)
        and a.consensus_info == b.consensus_info and pools
    )


def run_mr(data, params, **kw):
    """One MR fit on the card with the launch counters zeroed just before
    and read just after: (result, launches, events by stage, wall s, peak
    device bytes); ``kw`` goes to ``mr_hdbscan.fit``."""
    import torch

    from hdbscan_tpu_torch.models import mr_hdbscan
    from hdbscan_tpu_torch.ops import cuda_build

    events = []
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = mr_hdbscan.fit(data, params, trace=lambda stage, **f: events.append((stage, f)), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)
    ev = {}
    for stage, kw in events:
        ev.setdefault(stage, []).append(kw)
    return res, launches, ev, wall, torch.cuda.max_memory_allocated()


def report_mr(label, res, launches, ev, wall, peak) -> None:
    def walls(stage):
        return [e["wall_s"] for e in ev.get(stage, [])]

    print(f"{label} fit wall {wall:.3f} s, levels {res.n_levels}, edges {res.n_edges}, "
          f"peak device memory {peak / 2**30:.2f} GiB")
    stages = ev.get("level_stages", [])  # a resumed fit reports its new levels
    for lv, st in zip(res.levels[len(res.levels) - len(stages):], stages):
        print(f"{label} level {lv.level}: active {lv.n_active}, small {lv.n_small_subsets}, "
              f"large {lv.n_large_subsets}, processed {lv.n_processed}, bubbles {lv.n_bubbles}, "
              f"inter edges {lv.n_inter_edges}, forced {lv.forced_splits}, wall {lv.wall_s:.3f} s "
              f"{ {k: v for k, v in st.items() if k != 'level'} }")
    totals = {k: round(sum(st[k] for st in stages), 6)
              for k in (stages[0] if stages else {}) if k != "level"}
    print(f"{label} level stages summed over levels (s): {totals}")
    for stage in ("global_cores", "boundary_select", "boundary_cores", "knn_probe_scan",
                  "knn_window_scan", "boundary_reweight", "boundary_phase", "refine",
                  "refine_flat"):
        if stage in ev:
            extra = {k: v for k, v in ev[stage][0].items() if k in (
                "m", "m_glue", "chunks", "tiles", "pad_tiles", "edges", "new_edges", "n_blocks")}
            print(f"{label} {stage} wall_s {walls(stage)} {extra}")
    for e in ev.get("glue_round", []):
        print(f"{label} glue_round {e['round']}: components {e['n_comp']}, pairs {e['pairs']}, "
              f"dense {e['dense']}, wall {e['wall_s']} s")
    blocks = sum(walls("block_fit"))
    finalize = sum(sum(walls(s)) for s in ev if s.startswith("tree_"))
    print(f"{label} block fits {blocks:.3f} s in {len(walls('block_fit'))} calls; "
          f"host finalize {finalize:.3f} s over {len(walls('tree_condense'))} tree builds")
    print(f"{label} launches on the fit: {launches}")


def mr_card_vs_cpu() -> list[str]:
    """The MR fit on 6,000 points on the card equals the CPU fit, in the
    default mode and in boundary mode; returns failure messages."""
    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import mr_hdbscan
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    data, _ = make_gauss(6000, **MR_DATA)
    errors = []
    base = dict(MR_PARAMS, min_cluster_size=30, processing_units=1024)
    for label, extra in (("default", {}), ("boundary fused", BOUND05)):
        p = HDBSCANParams(**base, **extra)
        same = mr_fits_equal(mr_hdbscan.fit(data, p), mr_hdbscan.fit(data, p, device="cpu"))
        print(f"MR card fit vs CPU fit on 6000 points, {label}: "
              f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            errors.append(f"MR {label}")
    return errors


class CallRecorder:
    """Wraps ``mod.name`` during a window to count its calls and keep the
    arguments ``(args, kw)`` of the first ``keep`` (of every call when
    None); the wrapped call runs (and launches and counts) as before."""

    def __init__(self, mod, name: str, keep: int | None = None):
        self.mod, self.name, self.keep = mod, name, keep
        self.orig = getattr(mod, name)
        self.calls, self.count = [], 0

    def __enter__(self):
        def rec(*args, **kw):
            self.count += 1
            if self.keep is None or len(self.calls) < self.keep:
                self.calls.append((args, kw))
            return self.orig(*args, **kw)

        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


class WindowRecorder(CallRecorder):
    """Keeps the arguments of every B4 call during a fit."""

    def __init__(self):
        from hdbscan_tpu_torch.ops import cuda_knn_window

        super().__init__(cuda_knn_window, "knn_window")

    def main_chunk(self, ev):
        """The largest (most row tiles) chunk of the rescan's main phase:
        its calls are the last ``chunks`` of the ``knn_window_scan`` event."""
        main = [args for args, _ in self.calls[-ev["knn_window_scan"][0]["chunks"]:]]
        return max(main, key=lambda args: args[2].shape[0])


def window_time(args, launches, name="knn_window") -> dict:
    """B4 timed on one recorded rescan chunk beside its plain version and
    its bound: the pairs it must scan (each slot against its window's
    unmasked columns) times the dot form's operations, or the bytes (ids,
    bounds and window origins read, the scanned columns read once, the lists
    written), whichever is larger."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_knn_window as cw

    x, n, ids, wst, bnd, k, col_tile, n_win, metric, form = args
    tiles, rt = ids.shape
    d = x.shape[1]
    ms = cuda_ms(lambda: cw.knn_window(*args), 3)
    plain = host_ms(lambda: cw.knn_window_plain(*args))
    a, b = cw.knn_window(*args), cw.knn_window_plain(*args)
    lo = wst.cpu().numpy().astype(np.int64) * col_tile
    hi = np.minimum(lo + n_win * col_tile, n)
    pairs = float(rt * np.maximum(hi - lo, 0).sum())
    cols = np.zeros(n + 1, np.int64)
    np.add.at(cols, np.minimum(lo, n), 1)
    np.add.at(cols, hi, -1)
    scanned = int((np.cumsum(cols)[:n] > 0).sum())
    nbytes = tiles * rt * 8 + tiles * 4 + scanned * d * 4 + tiles * rt * k * 8
    ops = pairs * pair_ops(d, form if metric == "euclidean" else "diff", root=False)
    b_ms, by = bound_ms(nbytes, ops)
    print(f"{name} timing chunk: {tiles} row tiles of {rt}, d {d}, k {k}, windows of {n_win} x "
          f"{col_tile} columns, {pairs:.0f} pairs, {scanned} distinct columns")
    ar = torch.arange(n_win * col_tile, device=x.device)
    group = max(1, (1 << 28) // (rt * n_win * col_tile))

    def two_calls():
        for g0 in range(0, tiles, group):
            cols = torch.clamp(wst[g0:g0 + group, None].long() * col_tile + ar, max=n - 1)
            torch.topk(torch.cdist(x[ids[g0:g0 + group].long()], x[cols]), min(k, len(ar)),
                       dim=2, largest=False)

    return dict(
        name=name, route="cuda", source="hdbscan_tpu_torch/csrc/knn_window.cu",
        replaces="hdbscan_tpu/ops/pallas_knn.py:640", launches=launches[name],
        max_abs_err=max_err(a[0], b[0], a[1], b[1]), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=by, bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3,
        library_ms=cuda_ms(two_calls, 1), library_call=TWO_CALLS,
    )


def timed_plain(fn):
    """(host ms of one synchronised call, its result): the plain versions
    are too slow at full size to run twice."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def highd_times(hdata, launches) -> list[dict]:
    """B3 timed at the 3f fit's launch — all 500,000 Morton-ordered rows,
    k = 7, dot form — beside its plain version and its bound (n^2 pairs at
    the dot form's operations less the root; each point read once, the
    (n, k) values written once)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_knn_smallest as ks

    k = HIGHD_PARAMS["min_points"] - 1
    x = torch.as_tensor(hdata[ks.morton_order(hdata)].astype(np.float32), device="cuda")
    n, d = x.shape
    ms = cuda_ms(lambda: ks.knn_smallest(x, k, "dot"), 2)
    a = ks.knn_smallest(x, k, "dot")
    # The plain version on all rows takes ~3 minutes: it runs on the first
    # PLAIN_ROWS query rows against all columns (the same per-row work),
    # scaled to all rows, and its values are held against those rows.
    plain_ms, b = timed_plain(lambda: ks.knn_smallest_plain(x, k, "dot", q=x[:PLAIN_ROWS]))
    ops = float(n) * n * pair_ops(d, "dot", root=False)
    b_ms, by = bound_ms(n * d * 4 + n * k * 4, ops)
    return [dict(
        name="knn_smallest", route="cuda", source="hdbscan_tpu_torch/csrc/knn_kbest.cu",
        replaces="hdbscan_tpu/ops/pallas_knn.py:198", launches=launches["knn_smallest"],
        max_abs_err=max_err(a[:PLAIN_ROWS], b), ms=ms, plain_ms=plain_ms * n / PLAIN_ROWS,
        plain_ms_scaled_from_rows=PLAIN_ROWS, bound_ms=b_ms, bound_by=by, library_ms=None,
        bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3,
    )]


def panel_times(data, sres, launches, mesh, k=MIN_PTS - 1, suffix="", metric="euclidean",
                launch_suffix=None) -> list[dict]:
    """B9 and the ring's rectangular B2 timed at one launch of a sharded
    fit's first round (the 3g fit's by default): shard 0's rows against
    shard 1's panel, round-1 components, the ring tiles' form; bounds from
    the pairs and the bytes of both sides. ``suffix``, ``metric`` and
    ``launch_suffix`` as in :func:`forest_times`."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import euclidean_form
    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin
    from hdbscan_tpu_torch.parallel.ring import _ring_geometry

    n, d = data.shape
    rt, ct, shard, _ = _ring_geometry(n, N_SHARDS, 1024, 8192)
    form = euclidean_form(rt, ct, d) if metric == "euclidean" else None
    pform = metric_form(metric, form)
    launch_suffix = suffix if launch_suffix is None else launch_suffix
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    core = torch.as_tensor(sres.core_distances.astype(np.float32), device="cuda")
    comp = torch.arange(n, dtype=torch.int32, device="cuda")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    r, c = slice(0, shard), slice(shard, 2 * shard)
    args = (x[r], core[r], comp[r], valid[r], x[c], core[c], comp[c], valid[c])
    rows = []

    def row(name, replaces, kernel, plain, nbytes, ops, **extra):
        ms = cuda_ms(kernel, 3)
        a = kernel()
        plain_ms, b = timed_plain(plain)
        b_ms, by = bound_ms(nbytes, ops)
        rows.append(dict(
            name=name + suffix, route="cuda", source=f"hdbscan_tpu_torch/csrc/{replaces[0]}",
            replaces=replaces[1], launches=launches[name + launch_suffix],
            max_abs_err=max_err(a[0], b[0], a[1], b[1]), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=by, library_ms=None, **extra,
        ))

    pairs = float(shard) * shard
    ops = pairs * (pair_ops(d, pform) + 2)
    row("segmin_panel", ("segmin.cu", "hdbscan_tpu/ops/pallas_segmin.py:127"),
        lambda: cuda_segmin.min_outgoing_panel(*args, metric, rt, ct, form=form, col_offset=shard),
        lambda: cuda_segmin.min_outgoing_panel_plain(*args, metric, form, ct, shard),
        2 * shard * (d * 4 + 4 + 4 + 1) + shard * 8, ops,
        bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3)
    ops = pairs * pair_ops(d, pform, root=False)
    row("knn_kbest_panel", ("knn_kbest.cu", "hdbscan_tpu/ops/pallas_knn.py:453"),
        lambda: cuda_knn.knn_kbest_panel(x[r], x[c], k, metric, form, id_offset=shard,
                                         col_tile=ct),
        lambda: cuda_knn.knn_kbest_panel_plain(x[r], x[c], k, metric, form, shard, ct),
        2 * shard * d * 4 + shard * k * 8, ops,
        bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3,
        blocks=kbest_blocks(shard, shard, d, k))
    print(f"panel kernel{suffix} shapes: {shard} resident rows x {shard}-column panel, d {d}, "
          f"k {k}, form {form}, mesh {[str(dev) for dev in mesh.devices]}")
    return rows


def kbest_blocks(nq: int, nx: int, d: int, k: int) -> str:
    """A k-best launch's grid: row blocks x column splits, and blocks per SM
    on the card's 132 SMs."""
    import ctypes

    from hdbscan_tpu_torch.ops import cuda_build

    args = [ctypes.c_int] * 5
    blocks = cuda_build.function("knn_kbest.cu", "knn_kbest_row_blocks", args)(nq, nx, d, k, 1)
    splits = cuda_build.function("knn_kbest.cu", "knn_kbest_splits", args)(nq, nx, d, k, 1)
    return (f"{blocks} row blocks x {splits} splits = {blocks * splits} "
            f"({blocks * splits / 132:.2f} an SM)")


def kbest_3c_row(blob, launches) -> dict:
    """K2 at the 1M x 8 exact twin's launch (3c): all rows, k = 15, the
    form the exact tier takes there, beside its plain version on the first
    PLAIN_ROWS rows (scaled) and its bounds."""
    return kbest_metric_row("knn_kbest_3c", blob, MIN_PTS - 1, launches, "euclidean", PLAIN_ROWS)


def kbest_metric_row(name, data, k, launches, metric, plain_rows=None) -> dict:
    """K2 at a fit's launch: all rows, the cell's k, the distance form the
    exact tier takes there, beside its plain version (on ``plain_rows``
    leading rows, scaled, where the whole takes minutes) and its bounds;
    at cosine and pearson also the library yardstick (``F.normalize``,
    ``torch.mm`` with TF32 off and ``torch.topk`` over row blocks)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_build, cuda_knn, tiled

    n, d = data.shape
    ct = tiled._tile_sizes(n, 1024, 8192)[1]
    form = tiled.scan_form(n, d, metric, 1024, 8192)
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    ms = cuda_ms(lambda: cuda_knn.knn_kbest(x, k, metric, form, ct), 2)
    a = cuda_knn.knn_kbest(x, k, metric, form, ct)
    r = slice(0, plain_rows or n)
    plain_ms, b = timed_plain(lambda: cuda_knn.knn_kbest_panel_plain(
        x[r], x, k, metric, form, 0, ct))
    err = max_err(a[0][r], b[0], a[1][r], b[1])
    if not _bits_same((a[0][r], a[1][r]), b):
        err = float("inf")
    ops = float(n) * n * pair_ops(d, metric_form(metric, form), root=False)
    b_ms, by = bound_ms(n * d * 4 + n * k * 8, ops)
    extra = {"plain_ms_scaled_from_rows": plain_rows} if plain_rows else {}
    if metric in ("cosine", "pearson"):
        xc, _ = cuda_build.kernel_points(x, metric)
        rows_ = max(1, (1 << 28) // n)

        def library():
            xn = torch.nn.functional.normalize(xc, dim=1)
            for a0 in range(0, n, rows_):
                torch.topk(torch.mm(xn[a0:a0 + rows_], xn.t()), k, dim=1, largest=True)

        extra.update(library_ms=cuda_ms(library, 1), library_call=COSINE_CALLS)
    else:
        extra["library_ms"] = None
    return dict(
        name=name, route="cuda", source="hdbscan_tpu_torch/csrc/knn_kbest.cu",
        replaces="hdbscan_tpu/ops/pallas_knn.py:453", launches=launches["knn_kbest"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms * n / (plain_rows or n), bound_ms=b_ms,
        bound_by=by, bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3,
        blocks=kbest_blocks(n, n, d, k), shape=f"{n} x {d}, k {k}, {metric} {form or ''}",
        **extra,
    )


def kbest_merge_row(data, launches) -> dict:
    """K2's merge pass (``knn_kbest_merge``) on the lists of the Skin-shaped
    cosine launch with rows 5 and n / 2 set to zero: the pieces the
    reference's tile rule cuts the columns into, merged; beside the plain
    fold of stable merges. No fit of the main path holds a zero-norm row,
    so its launches there are 0; the parity phase runs it."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_knn, tiled

    x = data.astype(np.float32).copy()
    x[[5, len(x) // 2]] = 0.0
    n, d = x.shape
    k = MIN_PTS - 1
    ct = tiled._tile_sizes(n, 1024, 8192)[1]
    xg = torch.as_tensor(x, device="cuda")
    pieces = cuda_knn._zero_pieces(xg, "cosine", k, ct, 0)
    lists = []
    for a0, b0, slots in pieces:
        td, ti = cuda_knn.knn_kbest_panel(xg, xg[a0:b0], slots, "cosine", None, a0)
        pad = (n, k - slots)
        lists.append((torch.cat([td, torch.full(pad, float("inf"), device="cuda")], 1),
                      torch.cat([ti, torch.full(pad, -1, dtype=torch.int32, device="cuda")], 1)))
    ms = cuda_ms(lambda: cuda_knn._merge_lists(lists, k, plain=False), 5)
    a = cuda_knn._merge_lists(lists, k, plain=False)
    plain_ms, b = timed_plain(lambda: cuda_knn._merge_lists(lists, k, plain=True))
    b_ms, by = bound_ms(len(lists) * n * k * 8 + n * k * 8, 0.0)
    return dict(
        name="knn_kbest_merge", route="cuda", source="hdbscan_tpu_torch/csrc/knn_kbest.cu",
        replaces="hdbscan_tpu/ops/tiled.py:88 (_merge_sorted_k of the XLA scan, no Pallas call)",
        launches=launches["knn_kbest_merge"],
        max_abs_err=max_err(a[0], b[0], a[1], b[1]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=by, library_ms=None,
        library_note="none: no PyTorch call merges sorted (distance, id) lists",
        shape=f"{len(lists)} lists of {n} x {k}",
    )


def tile_shares(data, core_np, form) -> tuple[float, float, int]:
    """The share of (row block x column tile) pairs of the segment-min's
    launch (1,024 rows x 512 columns at d = 3) whose rows and columns all
    lie in one component -- the tiles ROADMAP R1 direction (c) could skip
    -- at round 1 and at the last round of a replay of the fit's Borůvka
    rounds (the kernel, then the host contraction the device rounds
    mirror). Returns (round-1 share, last-round share, rounds)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_segmin
    from hdbscan_tpu_torch.utils.unionfind import contract_min_edges

    n = len(data)
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    core = torch.as_tensor(core_np.astype(np.float32), device="cuda")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")

    def share(comp):
        c = torch.as_tensor(comp, device="cuda")

        def extent(width):
            pad = (-n) % width
            blocks = torch.cat([c, c[-1:].expand(pad)]).view(-1, width)
            return blocks.amin(1), blocks.amax(1)

        rmin, rmax = extent(1024)
        cmin, cmax = extent(512)
        one = ((rmin == rmax)[:, None] & (cmin == cmax)[None, :]
               & (rmin[:, None] == cmin[None, :]))
        return float(one.float().mean())

    comp = np.arange(n)
    n_comp, shares = n, []
    while n_comp > 1:
        shares.append(share(comp))
        bw, bj = cuda_segmin.segmin(x, core, torch.as_tensor(comp.astype(np.int32),
                                                             device="cuda"), valid,
                                    "euclidean", form)
        _, comp, n_comp = contract_min_edges(comp, bj.cpu().numpy().astype(np.int64),
                                             bw.cpu().numpy().astype(np.float64))
    return shares[0], shares[-1], len(shares)


def segmin_row(name, x, core, comp, valid, form, launches, plain_rows=None, kernel=None,
               metric="euclidean", **extra) -> dict:
    """The segment-min kernel timed on one round's inputs beside its plain
    version and its bounds (every pair of the round crosses components:
    round 1). ``plain_rows`` times (and checks) the plain version on that
    many leading rows only, scaled to all rows, where the whole would take
    minutes; the row then says so. ``kernel`` is the launch counter's name
    where the row's name differs."""
    import torch

    from hdbscan_tpu_torch.ops import cuda_segmin

    n, d = x.shape
    ms = cuda_ms(lambda: cuda_segmin.segmin(x, core, comp, valid, metric, form), 3)
    a = cuda_segmin.segmin(x, core, comp, valid, metric, form)
    r = slice(0, plain_rows or n)
    plain_ms, b = timed_plain(lambda: cuda_segmin.min_outgoing_panel_plain(
        x[r], core[r], comp[r], valid[r], x, core, comp, valid, metric, form))
    if plain_rows:
        plain_ms *= n / plain_rows
        extra["plain_ms_scaled_from_rows"] = plain_rows
    err = max_err(a[0][r], b[0], a[1][r], b[1])
    if not _bits_same((a[0][r], a[1][r]), b):
        err = float("inf")
    ops = float(n) * (n - 1) * (pair_ops(d, metric_form(metric, form)) + 2)
    b_ms, by = bound_ms(n * (d * 4 + 4 + 4 + 1) + n * 8, ops)
    return dict(
        name=name, route="cuda", source="hdbscan_tpu_torch/csrc/segmin.cu",
        replaces="hdbscan_tpu/ops/pallas_segmin.py:79", launches=launches[kernel or name],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
        library_ms=None, bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3,
        shape=f"{n} x {d}, {metric} {form or ''} form, round 1", **extra,
    )


def metric_cell(label, x, params, kernels, fit=None, sub_kw=None, **fit_kw):
    """A cell at cosine or pearson through the exact fit's checks: the
    card's fit equal to the CPU's on a 4,096-row slice of the cell's data
    (``sub_kw``: the two sides' extra arguments, default the card and
    ``device="cpu"``), then the whole fit with the launch counters zeroed
    just before and read just after, its walls and launches printed and
    ``check_fit`` applied. Returns (error or None, result, launches,
    events, wall)."""
    import dataclasses

    import numpy as np

    from hdbscan_tpu_torch.models import exact

    fit = fit or exact.fit
    card_kw, cpu_kw = sub_kw or ({}, {"device": "cpu"})
    sub = x[np.random.default_rng(SEED).choice(len(x), 4096, replace=False)]
    small = dataclasses.replace(params, min_cluster_size=50)
    a, b = fit(sub, small, **card_kw), fit(sub, small, **cpu_kw)
    same = fits_equal(a, b) and trees_equal(a.tree, b.tree)
    print(f"{label} card fit vs CPU fit on 4096 rows: {'identical' if same else 'DIFFERENT'}")
    res, launches, ev, wall = run_fit(x, params, **fit_kw)
    print(f"{label} {len(x)} x {x.shape[1]} fit walls (s): {fit_walls(ev, wall)}")
    counts = np.bincount(res.labels)
    print(f"{label} labels: {len(counts) - 1} clusters, noise {int(counts[0])}; "
          f"launches on the fit: {launches}")
    msg = None if same else f"{label}: the card's fit differs from the CPU's on 4096 rows"
    return msg or check_fit(label, res, launches, ev, len(x), kernels), res, launches, ev, wall


def zero_row_blocks() -> list[str]:
    """The dense core distances with NaN distances on the card: three zero
    rows before the data of ``tests/test_torch_dense.py``'s MR zero-row
    test (integer blobs at cosine, continuous blobs at pearson), through
    the dense fit (one block) and the MR fit with global_cores=false
    (processing_units=200, seed 1: each block's own cores,
    ``parallel/blocks.block_mst_batch``, with the zero rows in blocks of
    other rows); each equal to its CPU fit (NaN equal to NaN), with NaN
    cores on the zero rows. Returns failure messages."""
    import dataclasses

    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import hdbscan, mr_hdbscan

    def same(a, b):
        if dataclasses.is_dataclass(a):
            return all(same(getattr(a, f.name), getattr(b, f.name))
                       for f in dataclasses.fields(a) if f.name != "wall_s")
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        return a == b

    rng = np.random.default_rng(6)
    centres = rng.uniform(3, 14, size=(4, 3))
    grid = np.round(centres[rng.integers(0, 4, 480)] + rng.normal(0, 1.2, size=(480, 3)))
    grid = np.clip(np.concatenate([grid, rng.integers(1, 17, size=(60, 3))]), 1, None)
    rng = np.random.default_rng(1)
    centres = rng.normal(0, 4, size=(4, 5))
    cont = centres[rng.integers(0, 4, 600)] + rng.normal(0, 0.6, size=(600, 5)) + 3.0
    errors = []
    for metric, pts in (("cosine", grid), ("pearson", cont)):
        x = np.concatenate([np.zeros((3, pts.shape[1])), pts])
        p = HDBSCANParams(min_points=8, min_cluster_size=20, dist_function=metric,
                          processing_units=200, seed=1, global_core_distances=False)
        a, b = hdbscan.fit(x, p), hdbscan.fit(x, p, device="cpu")
        ma, mb = mr_hdbscan.fit(x, p), mr_hdbscan.fit(x, p, device="cpu")
        dense, mr = same(a, b), same(ma, mb)
        nan = np.isnan(a.core_distances[:3]).all() and np.isnan(ma.core_distances[:3]).all()
        print(f"zero rows at {metric}: dense fit card vs CPU "
              f"{'identical' if dense else 'DIFFERENT'}, MR fit (global_cores=false, "
              f"{ma.n_levels} levels) card vs CPU {'identical' if mr else 'DIFFERENT'}, "
              f"zero rows' cores NaN: {nan}")
        if not (dense and mr and nan):
            errors.append(f"zero rows at {metric}: dense {dense}, MR {mr}, NaN cores {nan}")
    return errors


def metric_phase(data, hdata, fdata, mesh) -> tuple[list[str], list[dict]]:
    """The cosine and pearson cells (metric code 6 in K2, B1, B9, the
    rectangular B2 and B5-B8), each equal to its CPU fit on a 4,096-row
    slice: skin_cosine (the Skin-shaped exact fit: K2, B1, K3),
    highd_cosine and highd_pearson (the 3f data, 500,000 x 28: K2 at d =
    28, not B3), 3b_cosine (the reference's forest on the Skin-shaped data:
    B5, B6, B7, B1, K3), 3e_cosine (default MR at 200,000: K2 and B1 in the
    glue) and 3g_cosine (four shards, equal to skin_cosine's fit: B9 and
    the rectangular B2); then each cosine mode timed at its fit's shapes
    (rows ``<kernel>_cosine``, ``<kernel>_3f_cosine``,
    ``<kernel>_3f_pearson``; their launches are the cell's). Returns
    (failure messages, kernel rows)."""
    import dataclasses

    import numpy as np
    import torch

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact, mr_hdbscan
    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    errors, rows = [], []
    zero = np.flatnonzero((data == 0).all(axis=1))
    print(f"skin_cosine: the seeded Skin-shaped data holds {len(zero)} zero rows {zero.tolist()}"
          " (a zero row's cosine is NaN to every row: the fit then follows the reference's "
          "tile rule, tests/test_torch_metrics.py)")
    skin = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE, knn_index="exact",
                         dist_function="cosine")
    msg, cres, claunches, _, _ = metric_cell("skin_cosine", data, skin, EXACT_KERNELS)
    errors += [msg] if msg else []

    hcells = {}
    for metric in ("cosine", "pearson"):
        p = HDBSCANParams(**HIGHD_PARAMS, dist_function=metric)
        label = f"highd_{metric}"
        msg, hres, hl, _, _ = metric_cell(label, hdata, p, ("knn_kbest", "segmin", "uf_scan"))
        if hl["knn_smallest"]:
            msg = msg or f"{label}: B3 launched at {metric} ({hl})"
        errors += [msg] if msg else []
        hcells[metric] = (hres, hl)

    fp = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE,
                       **dict(FOREST, dist_function="cosine"))
    msg, fres, fl, fev, fwall = metric_cell("3b_cosine", data, fp, FOREST_FIT_KERNELS)
    errors += [msg] if msg else []
    report_forest_fit("3b_cosine", data, fp, fres, fl, fev, fwall, cres.core_distances,
                      cres.labels)

    qp = HDBSCANParams(**MR_PARAMS, min_cluster_size=max(64, N_FULLQ // 200),
                       dist_function="cosine")
    sub = fdata[np.random.default_rng(SEED).choice(len(fdata), 4096, replace=False)]
    small = dataclasses.replace(qp, min_cluster_size=50, processing_units=1024)
    same = mr_fits_equal(mr_hdbscan.fit(sub, small), mr_hdbscan.fit(sub, small, device="cpu"))
    print(f"3e_cosine card MR fit vs CPU MR fit on 4096 rows: "
          f"{'identical' if same else 'DIFFERENT'}")
    qres, ql, qev, qwall, qpeak = run_mr(fdata, qp)
    report_mr("3e_cosine", qres, ql, qev, qwall, qpeak)
    if not same:
        errors.append("3e_cosine: the card's MR fit differs from the CPU's on 4096 rows")
    if not np.all(np.isfinite(qres.core_distances)) or not (ql["knn_kbest"] and ql["segmin"]):
        errors.append(f"3e_cosine: non-finite cores or K2/B1 never launched ({ql})")
    errors += zero_row_blocks()

    sp = dataclasses.replace(skin, **SHARDED)
    cpu_mesh = get_mesh([torch.device("cpu")] * N_SHARDS)
    msg, sres, sl, sev, _ = metric_cell("3g_cosine", data, sp, SHARDED_KERNELS,
                                        sub_kw=({"mesh": mesh}, {"mesh": cpu_mesh}), mesh=mesh)
    rounds = sev["boruvka_mst"][0]["rounds"]
    same = fits_equal(sres, cres) and trees_equal(sres.tree, cres.tree)
    print(f"3g_cosine sharded fit vs skin_cosine's single-device fit: "
          f"{'identical' if same else 'DIFFERENT'}; ring B2 launches {sl['knn_kbest_panel']}, "
          f"B9 launches {sl['segmin_panel']} ({rounds} rounds), host syncs {len(sev['host_sync'])}")
    if not same:
        msg = msg or "3g_cosine: the sharded fit differs from the single-device fit"
    if (sl["knn_kbest_panel"] != N_SHARDS ** 2 or sl["segmin_panel"] != N_SHARDS ** 2 * rounds
            or sl["knn_kbest"] or sl["segmin"]):
        msg = msg or f"3g_cosine: unexpected launches {sl}"
    errors += [msg] if msg else []
    if errors:
        return errors, rows

    # --- the cosine and pearson modes timed at their fits' shapes --------
    n = len(data)
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    rows.append(kbest_metric_row("knn_kbest_cosine", data, MIN_PTS - 1, claunches, "cosine",
                                 PLAIN_ROWS))
    rows.append(segmin_row(
        "segmin_cosine", x, torch.as_tensor(cres.core_distances.astype(np.float32),
                                            device="cuda"),
        torch.arange(n, dtype=torch.int32, device="cuda"), ones, None, claunches,
        kernel="segmin", metric="cosine"))
    hx = torch.as_tensor(hdata.astype(np.float32), device="cuda")
    hn = len(hdata)
    for metric, (hres, hl) in hcells.items():
        rows.append(kbest_metric_row(f"knn_kbest_3f_{metric}", hdata,
                                     HIGHD_PARAMS["min_points"] - 1, hl, metric, 4096))
        rows.append(segmin_row(
            f"segmin_3f_{metric}", hx,
            torch.as_tensor(hres.core_distances.astype(np.float32), device="cuda"),
            torch.arange(hn, dtype=torch.int32, device="cuda"),
            torch.ones(hn, dtype=torch.bool, device="cuda"), None, hl, plain_rows=4096,
            kernel="segmin", metric=metric))
    del hx
    rows += forest_times(data, fres, fl, suffix="_cosine", metric="cosine", launch_suffix="")
    rows += panel_times(data, sres, sl, mesh, suffix="_cosine", metric="cosine",
                        launch_suffix="")
    rows.append(kbest_merge_row(data, claunches))
    return errors, rows


def wide_phase(launches_out: dict) -> tuple[list[str], list[dict]]:
    """3h: the fits past k or d = 128, where every kernel runs its wide mode.
    Each fit on the card equals the same fit on the CPU (plain versions):
    exact at 2,000 x 129 and at min_points=200, the rp-forest tier at
    k = 129, the sharded exact fit at 4,000 x 129 over four shards, and the
    MR fit in boundary mode at 3,000 x 130 (its window rescan takes the XLA
    chunk's contract past the fused gate). The launch counters are zeroed
    just before the first card fit and read just after the last; every wide
    mode a fit path runs must have launched. Then each wide kernel is timed
    at those fits' shapes. Returns (failures, kernel rows)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact, mr_hdbscan
    from hdbscan_tpu_torch.ops import cuda_build, cuda_knn, rpforest, tiled
    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.parallel.mesh import get_mesh
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    def lattice(n, dims, seed):  # Gaussian clusters rounded to a grid: exact ties
        return np.round(make_gauss(n, dims=dims, n_clusters=6, separation=8.0, seed=seed)[0])

    g129, g3, f3 = lattice(2000, 129, 1), lattice(2000, 3, 2), lattice(3000, 3, 3)
    s129, m130 = lattice(4000, 129, 4), make_gauss(3000, dims=130, n_clusters=6,
                                                   separation=8.0, seed=5)[0]
    forest_kw = dict(knn_index="rpforest", knn_backend="fused", rpf_trees=2,
                     rpf_leaf_size=300, rpf_rescan_rounds=1)
    mesh = shard_mesh()
    fits = [
        ("exact 2000x129", g129, dict(min_points=16, min_cluster_size=40), {}),
        ("exact 2000x3 min_points=200", g3, dict(min_points=200, min_cluster_size=40), {}),
        ("rp-forest 3000x3 k=129", f3, dict(min_points=130, min_cluster_size=40, **forest_kw),
         {}),
        ("sharded 4000x129", s129, dict(min_points=16, min_cluster_size=40, **SHARDED),
         {"mesh": mesh}),
    ]
    errors, cards = [], {}
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for label, data, kw, extra in fits:
        cards[label] = exact.fit(data, HDBSCANParams(**kw), **extra)
    mparams = HDBSCANParams(**dict(MR_PARAMS, processing_units=1024), min_cluster_size=30,
                            **BOUND05)
    with WindowRecorder() as recorder:
        mcard = mr_hdbscan.fit(m130, mparams)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(cuda_build.LAUNCHES)
    launches_out.update(launches)
    print(f"3h wide fits on the card: {wall:.3f} s; launches {launches}")
    for label, data, kw, extra in fits:
        cpu_extra = {"mesh": get_mesh([torch.device("cpu")] * N_SHARDS)} if extra else {
            "device": "cpu"}
        cpu = exact.fit(data, HDBSCANParams(**kw), **cpu_extra)
        same = fits_equal(cards[label], cpu) and trees_equal(cards[label].tree, cpu.tree)
        print(f"3h {label}: card fit vs CPU fit {'identical' if same else 'DIFFERENT'}, "
              f"{len(np.unique(cpu.labels)) - 1} clusters")
        if not same:
            errors.append(f"3h {label}")
    same = mr_fits_equal(mcard, mr_hdbscan.fit(m130, mparams, device="cpu"))
    print(f"3h MR boundary 3000x130: card fit vs CPU fit {'identical' if same else 'DIFFERENT'}")
    if not same:
        errors.append("3h MR boundary 3000x130")
    ran = [k for k in cuda_build.WIDE_KERNELS if k != "forest_min_outgoing"]
    missing = [k for k in ran if launches[f"{k}_wide"] == 0]
    if missing:
        errors.append(f"3h: wide modes never launched: {missing}")
    if errors:
        return errors, []

    # Timings at the fits' shapes.
    rows = []
    k = 15
    x = torch.as_tensor(g129.astype(np.float32), device="cuda")
    n, d = x.shape
    form = tiled.scan_form(n, d, "euclidean", 1024, 8192)
    ms = cuda_ms(lambda: cuda_knn.knn_kbest(x, k, "euclidean", form), 3)
    a = cuda_knn.knn_kbest(x, k, "euclidean", form)
    plain_ms, b = timed_plain(lambda: cuda_knn.knn_kbest_plain(x, k, "euclidean", form))
    b_ms, by = bound_ms(n * d * 4 + n * k * 8, float(n) * n * pair_ops(d, form, root=False))
    rows.append(dict(
        name="knn_kbest_wide", route="cuda", source="hdbscan_tpu_torch/csrc/knn_kbest.cu",
        replaces="hdbscan_tpu/ops/pallas_knn.py:453", launches=launches["knn_kbest_wide"],
        max_abs_err=max_err(a[0], b[0], a[1], b[1]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=by, library_ms=None, shape=f"{n} x {d}, k {k}, {form} form",
    ))
    core = torch.as_tensor(cards["exact 2000x129"].core_distances.astype(np.float32),
                           device="cuda")
    rows.append(segmin_row("segmin_wide", x, core, torch.arange(n, dtype=torch.int32,
                                                                  device="cuda"),
                           torch.ones(n, dtype=torch.bool, device="cuda"), form, launches))
    rows += forest_times(f3, cards["rp-forest 3000x3 k=129"], launches, k=129, trees=2,
                         leaf_size=300, suffix="_wide")
    # B8's wide mode is d past 128 and no fit path calls B8: the 2,000 x 129
    # fit's points, each row's candidates the 15 nearest of its 15 nearest
    # (the rescan's k^2 panel), the fit's cores, round-1 components.
    nn = cuda_knn.knn_kbest(x, k, "euclidean", form)[1]
    cand = rpforest._expand(nn, nn, k, n)
    live = cand[cand != n]
    uniq = int(torch.unique(live).numel())
    comp = torch.arange(n, dtype=torch.int32, device="cuda")
    args = (x, x, cand, core, core, comp, comp, "euclidean", n)
    ms = cuda_ms(lambda: cf.forest_min_outgoing(*args), 3)
    a, (plain_ms, b) = cf.forest_min_outgoing(*args), timed_plain(
        lambda: cf.forest_min_outgoing_plain(*args))
    b_ms, by = bound_ms(n * (d * 4 + 8) + cand.numel() * 4 + uniq * (d * 4 + 8) + n * 8,
                        float(live.numel()) * (pair_ops(d, "diff") + 2))
    rows.append(dict(
        name="forest_min_outgoing_wide", route="cuda",
        source="hdbscan_tpu_torch/csrc/forest_rescan.cu",
        replaces="hdbscan_tpu/ops/pallas_forest.py:476",
        launches=launches["forest_min_outgoing_wide"],
        max_abs_err=max_err(a[0], b[0], a[1], b[1]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=by, library_ms=None, library_note=NO_SEGMIN_CALL,
        shape=f"{n} rows x {cand.shape[1]} candidates, d {d}",
    ))
    rows += panel_times(s129, cards["sharded 4000x129"], launches, mesh, k=15, suffix="_wide")
    # The largest recorded window call (at this size the probe phase's).
    rows.append(window_time(max((args for args, _ in recorder.calls),
                                key=lambda args: args[2].shape[0]), launches, "knn_window_wide"))
    return errors, rows


def file_digests(out_dir) -> dict:
    """{file name: (bytes, sha256)} of the files a run wrote."""
    import hashlib

    out = {}
    for name in sorted(os.listdir(out_dir)):
        h = hashlib.sha256()
        with open(os.path.join(out_dir, name), "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                h.update(block)
        out[name] = (os.path.getsize(os.path.join(out_dir, name)), h.hexdigest())
    return out


def run_cli(argv, here, as_subprocess: bool):
    """One command line run on the card (or where ``--device`` says):
    ``python -m hdbscan_tpu_torch`` in a subprocess, or ``cli.main`` in this
    process with the launch counters zeroed just before and read just
    after. Returns (exit code, stdout, stderr, wall s, launches or None,
    peak device bytes or None)."""
    import contextlib
    import io

    import torch

    from hdbscan_tpu_torch import cli
    from hdbscan_tpu_torch.ops import cuda_build

    if as_subprocess:
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "hdbscan_tpu_torch", *argv], cwd=here,
                             capture_output=True, text=True, timeout=900)
        return out.returncode, out.stdout, out.stderr, time.perf_counter() - t, None, None
    so, se = io.StringIO(), io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return (rc, so.getvalue(), se.getvalue(), wall, dict(cuda_build.LAUNCHES),
            torch.cuda.max_memory_allocated())


def cli_twin(name, path, flags, out_dir, device):
    """The fit the leg's route runs, called in this process on the same
    file and flags (``mr_hdbscan.fit``, ``exact.fit`` or ``models/hdbscan.fit``),
    then ``write_outputs``: its launches."""
    import dataclasses

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact, hdbscan, mr_hdbscan
    from hdbscan_tpu_torch.ops import cuda_build
    from hdbscan_tpu_torch.utils.io import load_points

    params = dataclasses.replace(HDBSCANParams.from_args([f"file={path}", *flags]),
                                 out_dir=out_dir)
    data = load_points(path)
    fit = {"cli_mr": mr_hdbscan.fit, "cli_exact_sharded": exact.fit,
           "cli_dedup_sharded": exact.fit}.get(name, hdbscan.fit)
    cuda_build.reset_launches()
    hdbscan.write_outputs(fit(data, params, device=device), params)
    return dict(cuda_build.LAUNCHES)


def cli_leg(here, root, data, card, leg, phase="3j") -> list[str]:
    """One leg of phase 3j (see the module docstring); ``phase`` prefixes
    its lines."""
    import numpy as np

    name, rows, flags, sub_pu, kernels, as_subprocess, mode = leg
    x = data[:rows]
    path = os.path.join(root, f"{name}.tsv")
    sub_path = os.path.join(root, f"{name}_{CLI_SUB_ROWS}.tsv")
    np.savetxt(path, x, delimiter="\t", fmt="%d")
    np.savetxt(sub_path, x[:CLI_SUB_ROWS], delimiter="\t", fmt="%d")
    errors = []

    def run(tag, file, leg_flags, subproc, device=()):
        out_dir, trace = os.path.join(root, tag), os.path.join(root, f"{tag}.jsonl")
        argv = ["fit", f"file={file}", *leg_flags, f"out_dir={out_dir}", "--trace-out", trace,
                *device]
        rc, out, err, wall, launches, peak = run_cli(argv, here, subproc)
        first = out.splitlines()[0] if out else ""
        print(f"{phase} {tag} ({card}): exit {rc}, wall {wall:.3f} s; {first}")
        phases = err.split("phases:\n", 1)[-1] if "phases:\n" in err else ""
        print(f"{phase} {tag} phases: {'; '.join(p.strip() for p in phases.splitlines())}")
        if rc != 0:
            errors.append(f"{tag}: exit {rc}: {err[-2000:]}")
            return None, launches, peak
        if mode not in first:
            errors.append(f"{tag}: the stdout line does not name the route {mode!r}: {first}")
        bad = validator(here, "check_trace.py", trace)
        if bad:
            errors.append(f"{tag}: check_trace.py failed: {bad}")
        digests = file_digests(out_dir)
        print(f"{phase} {tag} files (bytes): { {k: v[0] for k, v in digests.items()} }")
        return digests, launches, peak

    files, launches, peak = run(name, path, flags, as_subprocess)
    if files is None:
        return errors
    twin_launches = cli_twin(name, path, flags, os.path.join(root, f"{name}_twin"), None)
    twin_same = file_digests(os.path.join(root, f"{name}_twin")) == files
    if not twin_same:
        errors.append(f"{name}: the files differ from the in-process fit's on the card")
    if as_subprocess:
        launches = twin_launches  # counted on the in-process twin
    print(f"{phase} {name} launches ({'the in-process twin' if as_subprocess else 'the CLI run'}): "
          f"{ {k: v for k, v in launches.items() if v} }")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        errors.append(f"{name}: kernels of the route never launched: {missing}")
    if peak is not None:
        print(f"{phase} {name} peak device memory {peak / 2**30:.3f} GiB")
    sub_flags = [f for f in flags if not f.startswith(("processing_units=", "minClSize="))]
    sub_flags += [f"processing_units={sub_pu}", "minClSize=50"]
    card_files, _, _ = run(f"{name}_{CLI_SUB_ROWS}_card", sub_path, sub_flags, False)
    cpu_files, _, _ = run(f"{name}_{CLI_SUB_ROWS}_cpu", sub_path, sub_flags, False,
                          ("--device", "cpu"))
    if card_files is None or card_files != cpu_files:
        errors.append(f"{name}: the {CLI_SUB_ROWS}-row files differ card against CPU")
    print(f"{phase} {name}: files vs the in-process fit {'identical' if twin_same else 'DIFFERENT'}; "
          f"{CLI_SUB_ROWS}-row leg card vs CPU "
          f"{'identical' if card_files and card_files == cpu_files else 'DIFFERENT'}")
    return errors


def cli_phase(here, data, card) -> list[str]:
    """Phase 3j: the command line's three routes on the Skin-shaped set,
    written as a tab-separated file like ``Skin_NonSkin.txt``; the files go
    to the git-ignored ``.torch_build/cli`` and are removed after."""
    import shutil

    root = os.path.join(here, ".torch_build", "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    errors = []
    try:
        for leg in CLI_LEGS:
            errors += cli_leg(here, root, data, card, leg)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return errors


def sorted_mst(mst):
    """An MST as (w, lo, hi) rows in (w, lo, hi) order: edge sets compared
    whatever order and orientation a route emits them in."""
    import numpy as np

    u, v, w = (np.asarray(a) for a in mst)
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    order = np.lexsort((hi, lo, w))
    return np.stack([w[order], lo[order].astype(np.float64), hi[order].astype(np.float64)])


def same_partition(a, b) -> bool:
    """Two labelings with the same noise rows (label 0) and the same
    clusters under a renaming of their ids: the condensed tree of another
    tie-broken MST of the same weights numbers its clusters in another
    order."""
    import numpy as np

    if not np.array_equal(a == 0, b == 0):
        return False
    pairs = np.unique(np.stack([a, b]), axis=1)
    return pairs.shape[1] == len(np.unique(a)) == len(np.unique(b))


def dedup_rows(seed: int):
    """245,057 rows drawn from 51,433 unique Skin-shaped grid points (the
    real Skin set's counts): every point at least once, three of them
    :data:`HEAVY_GROUPS` times (past minClSize, so the heavy-group expansion
    runs), the rest of the rows spread at random; rows shuffled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    codes = rng.choice(256 ** 3, N_SKIN_UNIQUE, replace=False)
    pts = np.stack([codes // 65536, (codes // 256) % 256, codes % 256], 1).astype(np.float64)
    reps = np.ones(N_SKIN_UNIQUE, np.int64)
    reps[: len(HEAVY_GROUPS)] = HEAVY_GROUPS
    rest = N_SKIN - int(reps.sum())
    np.add.at(reps, rng.integers(len(HEAVY_GROUPS), N_SKIN_UNIQUE, rest), 1)
    rows = np.repeat(pts, reps, axis=0)
    return rows[rng.permutation(len(rows))]


def host_cell(label, data, params, want, kernels, card, cpu_mesh=None, **fit_kw):
    """One cell of phase 3k: the fit on ``CLI_SUB_ROWS`` rows on the card
    equal to the same fit on the CPU (``cpu_mesh``: the CPU shards standing
    in for ``fit_kw``'s mesh), then the full fit with the launch counters
    zeroed just before and read just after; checks its MST against
    ``want`` (a fit whose edge set it must equal, or None) and the kernels.
    Returns (errors, result, launches, events, wall)."""
    import dataclasses

    import numpy as np

    from hdbscan_tpu_torch.models import exact

    small = dataclasses.replace(params, min_cluster_size=50)
    sub = data[:CLI_SUB_ROWS]
    cpu_kw = {"mesh": cpu_mesh} if cpu_mesh is not None else {"device": "cpu"}
    a, b = exact.fit(sub, small, **fit_kw), exact.fit(sub, small, **cpu_kw)
    same_sub = fits_equal(a, b) and trees_equal(a.tree, b.tree)
    res, launches, ev, wall = run_fit(data, params, **fit_kw)
    errors = [] if same_sub else [f"{label}: the {CLI_SUB_ROWS}-row fit differs card vs CPU"]
    # A dedup fit's MST spans the unique points.
    n_mst = ev["dedup"][0]["unique"] if "dedup" in ev else len(data)
    msg = check_fit(label, res, launches, ev, n_mst, kernels, n_rows=len(data))
    if msg:
        errors.append(msg)
    mst_same = want is None or np.array_equal(sorted_mst(res.mst), sorted_mst(want.mst))
    if not mst_same:
        errors.append(f"{label}: the MST differs from the reference route's")
    rounds = ev.get("boruvka_round", [])
    print(f"3k {label} ({card}): wall {wall:.3f} s, core_distances "
          f"{ev['core_distances'][-1]['wall_s']}, boruvka_mst {ev['boruvka_mst'][0]['wall_s']} "
          f"in {ev['boruvka_mst'][0]['rounds']} rounds, host finalize "
          f"{sum(e[0]['wall_s'] for s, e in ev.items() if s.startswith('tree_')):.6f}; "
          f"{CLI_SUB_ROWS}-row card vs CPU {'identical' if same_sub else 'DIFFERENT'}"
          + ("" if want is None else f"; MST {'identical' if mst_same else 'DIFFERENT'}"))
    print(f"3k {label} rounds (scan s, fetch s, contract s): "
          f"{[(r['scan_s'], r['fetch_s'], r['contract_s']) for r in rounds]}")
    print(f"3k {label} launches: { {k: v for k, v in launches.items() if v} }")
    return errors, res, launches, ev, wall


def host_round_phase(here, data, res, card) -> tuple[list[str], dict]:
    """Phase 3k: the host-round exact route, its two sharded scanners,
    dedup and Random Blocks on phase 3's Skin-shaped set (module
    docstring). ``res`` is phase 3's device-route fit. Returns failure
    messages and each cell's launches."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.core import tree as tree_mod
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build
    from hdbscan_tpu_torch.parallel.mesh import get_mesh

    errors, launches = [], {}
    base = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE)

    # skin_host_rounds: K2, then B1 once a round and the host contraction.
    p = dataclasses.replace(base, mst_backend="host")
    e, hres, launches["skin_host_rounds"], hev, _ = host_cell(
        "skin_host_rounds", data, p, res, ("knn_kbest", "segmin"), card)
    errors += e
    if not np.array_equal(hres.labels, res.labels):
        errors.append("skin_host_rounds: labels differ from phase 3's device-route fit")

    # skin_ring: a one-card mesh, then four shards on one card.
    one = get_mesh([torch.device("cuda", 0)])
    four = get_mesh([torch.device("cuda", 0)] * N_SHARDS)
    p = dataclasses.replace(base, scan_backend="ring")
    for tag, mesh, cpu in (("1", one, 1), ("4", four, N_SHARDS)):
        e, _, launches[f"skin_ring_{tag}"], _, _ = host_cell(
            f"skin_ring_{tag}", data, p, hres, ("knn_kbest_panel", "segmin_panel"), card,
            cpu_mesh=get_mesh([torch.device("cpu")] * cpu), mesh=mesh)
        errors += e

    # skin_shard_host: the sharded scanner with host contraction.
    p = dataclasses.replace(base, fit_sharding="sharded", mst_backend="host")
    e, _, launches["skin_shard_host"], _, _ = host_cell(
        "skin_shard_host", data, p, hres, ("knn_kbest_panel", "segmin_panel"), card,
        cpu_mesh=get_mesh([torch.device("cpu")] * N_SHARDS), mesh=four)
    errors += e

    # skin_dedup: 51,433 unique points under 245,057 rows.
    rows = dedup_rows(SEED + 7)
    p = dataclasses.replace(base, dedup_points=True)
    e, dres, launches["skin_dedup"], dev_, _ = host_cell(
        "skin_dedup", rows, p, None, ("knn_kbest", "segmin", "uf_scan"), card)
    errors += e
    full, _, _, fwall = run_fit(rows, base)
    a = ari(dres.labels, full.labels)
    cores = np.array_equal(dres.core_distances, full.core_distances)
    heavy = int(np.sum(np.unique(rows, axis=0, return_counts=True)[1] >= MIN_CL_SIZE))
    print(f"3k skin_dedup: {dev_['dedup'][0]['unique']} unique of {len(rows)} rows, {heavy} "
          f"groups of >= {MIN_CL_SIZE} rows; vs the full-row device fit ({fwall:.3f} s): ARI "
          f"{a:.6f}, core distances {'equal' if cores else 'DIFFERENT'}")
    if a != 1.0 or not cores or heavy < 3:
        errors.append(f"skin_dedup: ARI {a}, cores equal {cores}, heavy groups {heavy}")
    root = os.path.join(here, ".torch_build", "cli3k")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        cuda_build.reset_launches()
        errors += cli_leg(here, root, rows, card, CLI_DEDUP_LEG, phase="3k")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # skin_rb: Random Blocks, BASELINE.json config 5.
    t = time.perf_counter()
    cuda_build.reset_launches()
    a4 = exact.mst_edges_random_blocks(data[:CLI_SUB_ROWS], MIN_PTS, n_parts=RB_PARTS, seed=0)
    b4 = exact.mst_edges_random_blocks(data[:CLI_SUB_ROWS], MIN_PTS, n_parts=RB_PARTS, seed=0,
                                       device="cpu")
    same_sub = all(np.array_equal(x, y) for x, y in zip(a4, b4))
    sub_s = time.perf_counter() - t
    ev = []
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rb = exact.mst_edges_random_blocks(data, MIN_PTS, n_parts=RB_PARTS, seed=0,
                                       trace=lambda st, **f: ev.append((st, f)))
    rb_wall = time.perf_counter() - t
    launches["skin_rb"] = dict(cuda_build.LAUNCHES)
    fits = [f for st, f in ev if st == "block_fit"]
    msts = [f for st, f in ev if st == "block_msts"]
    _, rb_labels = tree_mod.extract_clusters(N_SKIN, *rb[:3], MIN_CL_SIZE, self_levels=rb[3])
    w_same = np.array_equal(np.sort(rb[2]), np.sort(hres.mst[2]))
    l_same = same_partition(rb_labels, hres.labels)
    print(f"3k skin_rb ({card}): wall {rb_wall:.3f} s = core_distances "
          f"{[f['wall_s'] for st, f in ev if st == 'core_distances'][0]} + blocks "
          f"{sum(f['block_s'] for f in msts):.3f} + pool_mst {sum(f['pool_s'] for f in msts):.3f}; "
          f"{msts[-1]['total_blocks']} blocks of cap {fits[0]['cap']} in {len(msts)} chunks, "
          f"{sum(f['launches'] for f in fits)} block launches, pool edges "
          f"{[f['pool_edges'] for f in msts]}; {CLI_SUB_ROWS}-row card vs CPU "
          f"{'identical' if same_sub else 'DIFFERENT'} ({sub_s:.3f} s)")
    print(f"3k skin_rb: sorted MST weights vs skin_host_rounds "
          f"{'equal' if w_same else 'DIFFERENT'}, labels (extract_clusters) "
          f"{'the same partition' if l_same else 'DIFFERENT'} (bitwise: "
          f"{np.array_equal(rb_labels, hres.labels)}); launches "
          f"{ {k: v for k, v in launches['skin_rb'].items() if v} }")
    if not (same_sub and w_same and l_same and launches["skin_rb"]["knn_kbest"] == 1):
        errors.append(f"skin_rb: sub {same_sub}, weights {w_same}, labels {l_same}")
    return errors, launches


def mr_variants_card_vs_cpu() -> list[str]:
    """The MR fit's variants on phase 3d's 6,000 points
    (processing_units=1,024), each fit on the card equal to the same fit on
    the CPU, bitwise: ``variant=rs``, ``dedup_points`` (every third row
    repeated 1-6 more times), ``consensus_draws=2``, ``compat_cf_int_math``,
    the unpruned boundary (``boundary_block_pruning=False``, at cosine, and
    over the rp-forest), and a checkpoint interrupted after the first level
    then resumed on the card; returns failure messages."""
    import tempfile

    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import mr_hdbscan
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    data, _ = make_gauss(6000, **MR_DATA)
    rng = np.random.default_rng(1)
    idx = np.arange(0, len(data), 3)
    dups = np.concatenate([data, np.repeat(data[idx], rng.integers(1, 7, len(idx)), axis=0)])
    base = dict(MR_PARAMS, min_cluster_size=30, processing_units=1024)
    errors = []
    for label, extra in MR_VARIANTS:
        x = dups if extra.get("dedup_points") else data
        p = HDBSCANParams(**base, **extra)
        t = time.perf_counter()
        card = mr_hdbscan.fit(x, p, keep_edge_pool=True)
        card_s = time.perf_counter() - t
        cpu = mr_hdbscan.fit(x, p, device="cpu", keep_edge_pool=True)
        same = mr_fits_equal(card, cpu)
        print(f"3l MR card fit vs CPU fit on {len(x)} rows, {label}: "
              f"{'identical' if same else 'DIFFERENT'} (card {card_s:.3f} s, CPU "
              f"{time.perf_counter() - t - card_s:.3f} s)")
        if not same:
            errors.append(f"MR {label}")
    p = HDBSCANParams(**base)
    cpu = mr_hdbscan.fit(data, p, device="cpu", keep_edge_pool=True)
    with tempfile.TemporaryDirectory() as ckpt:
        try:
            mr_hdbscan.fit(data, p, max_levels=1, checkpoint_dir=ckpt)
            errors.append("MR checkpoint: max_levels=1 did not interrupt the fit")
        except RuntimeError:
            pass
        card = mr_hdbscan.fit(data, p, checkpoint_dir=ckpt, keep_edge_pool=True)
    same = mr_fits_equal(card, cpu)
    print(f"3l MR card fit interrupted after level 0 and resumed vs the CPU fit on 6000 "
          f"points: {'identical' if same else 'DIFFERENT'}")
    if not same:
        errors.append("MR checkpoint resume")
    return errors


class ResultRecorder(CallRecorder):
    """Keeps the result of every call of ``mod.name`` during a fit."""

    def __enter__(self):
        def rec(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append(out)
            return out

        setattr(self.mod, self.name, rec)
        return self


def mr_cell(label, data, params, kernels, card, absent=(), **fit_kw):
    """One cell of phase 3l: the MR fit on the card with the launch counters
    zeroed just before and read just after, its report (wall, level
    stages, trace walls, launches) and the checks every cell passes
    (finite cores, a label a row, the named kernels launched and those in
    ``absent`` not). Returns (errors, result, launches, events, wall)."""
    import numpy as np

    res, launches, ev, wall, peak = run_mr(data, params, **fit_kw)
    report_mr(f"3l {label}", res, launches, ev, wall, peak)
    print(f"3l {label} ({card}): wall {wall:.3f} s")
    errors = []
    if not np.all(np.isfinite(res.core_distances)):
        errors.append(f"{label}: non-finite core distances")
    if res.labels.shape != (len(data),):
        errors.append(f"{label}: {res.labels.shape} labels for {len(data)} rows")
    missing = [k for k in kernels if launches[k] == 0]
    extra = [k for k in absent if launches[k] != 0]
    if missing or extra:
        errors.append(f"{label}: kernels missing {missing}, unexpected {extra} ({launches})")
    return errors, res, launches, ev, wall


def mr_variant_phase(card) -> tuple[list[str], dict]:
    """Phase 3l: the rest of the MR pipeline (module docstring). Returns
    failure messages and each cell's launches."""
    import dataclasses
    import tempfile

    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import consensus, mr_hdbscan
    from hdbscan_tpu_torch.ops import cuda_build
    from hdbscan_tpu_torch.utils.datasets import make_gauss
    from hdbscan_tpu_torch.utils.evaluation import adjusted_rand_index

    errors = mr_variants_card_vs_cpu()
    launches = {}

    # skin_mr_dedup: the reference bench's mr-db leg on 3k's dedup rows.
    rows = dedup_rows(SEED + 7)
    p = HDBSCANParams(**MR_DB_LEG)
    e, dres, launches["skin_mr_dedup"], dev_, dwall = mr_cell(
        "skin_mr_dedup", rows, p, ("knn_kbest", "segmin"), card)
    errors += e
    dd = dev_.get("dedup", [{}])[0]
    if (dd.get("rows"), dd.get("unique")) != (N_SKIN, N_SKIN_UNIQUE) or dres.n_levels < 2:
        errors.append(f"skin_mr_dedup: dedup event {dd}, levels {dres.n_levels}")
    full, _, _, fwall = run_fit(rows, HDBSCANParams(min_points=MR_DB_LEG["min_points"],
                                                    min_cluster_size=MIN_CL_SIZE))
    plain = dataclasses.replace(p, dedup_points=False)
    nres, _, _, nwall, _ = run_mr(rows, plain)
    print(f"3l skin_mr_dedup: {dd.get('unique')} unique of {dd.get('rows')} rows, "
          f"{dres.n_levels} levels, {dwall:.3f} s; ARI vs the full-row exact fit ({fwall:.3f} s) "
          f"{adjusted_rand_index(dres.labels, full.labels):.6f}, vs the MR fit without dedup "
          f"({nwall:.3f} s, {nres.n_levels} levels) "
          f"{adjusted_rand_index(dres.labels, nres.labels):.6f}")

    # The 3e cells: 200,000 x 10, the default mode's parameters.
    fdata, ftruth = make_gauss(N_FULLQ, **MR_DATA)
    fq = HDBSCANParams(**MR_PARAMS, min_cluster_size=max(64, N_FULLQ // 200))
    qres, _, _, qwall, _ = run_mr(fdata, fq, keep_edge_pool=True)
    print(f"3l 3e db fit (uninterrupted, edge pool kept): {qwall:.3f} s")

    e, rres, launches["3e_rs"], _, _ = mr_cell(
        "3e_rs", fdata, dataclasses.replace(fq, variant="rs"), ("knn_kbest", "segmin"), card)
    errors += e
    print(f"3l 3e_rs ARI vs truth {adjusted_rand_index(rres.labels, ftruth):.6f}, vs the db fit "
          f"{adjusted_rand_index(rres.labels, qres.labels):.6f}")

    with ResultRecorder(mr_hdbscan, "fit") as draws:
        e, cres, launches["3e_consensus"], cev, _ = mr_cell(
            "3e_consensus", fdata, dataclasses.replace(fq, consensus_draws=CONSENSUS_DRAWS),
            ("knn_kbest", "segmin"), card)
    errors += e
    labs = [r.labels for r in draws.calls if r.consensus_info is None]
    want = (consensus.consensus_labels(np.stack(labs)) if len(labs) == CONSENSUS_DRAWS
            else None)
    keys = {"draws", "cells", "clusters", "representative_draw", "representative_seed",
            "representative_agreement_ari", "labels", "outlier_scores", "tree_and_hierarchy"}
    ok = (len(cev.get("consensus_draw", [])) == CONSENSUS_DRAWS and want is not None
          and np.array_equal(cres.labels, want) and set(cres.consensus_info or {}) == keys)
    print(f"3l 3e_consensus: {len(cev.get('consensus_draw', []))} draws, info "
          f"{cres.consensus_info}; labels equal consensus_labels of the draws: {ok}; ARI vs "
          f"truth {adjusted_rand_index(cres.labels, ftruth):.6f}")
    if not ok:
        errors.append("3e_consensus: draws, provenance or labels wrong")

    with tempfile.TemporaryDirectory() as ckpt:
        try:
            run_mr(fdata, fq, max_levels=1, checkpoint_dir=ckpt)
            errors.append("3e_checkpoint: max_levels=1 did not interrupt the fit")
            first = {}
        except RuntimeError:
            first = dict(cuda_build.LAUNCHES)
        e, kres, kl, kev, _ = mr_cell("3e_checkpoint", fdata, fq, ("segmin",), card,
                                      absent=("knn_kbest",), checkpoint_dir=ckpt,
                                      keep_edge_pool=True)
    errors += e
    launches["3e_checkpoint"] = {k: first.get(k, 0) + kl[k] for k in kl}
    same = mr_fits_equal(kres, qres)
    print(f"3l 3e_checkpoint: interrupted run's launches "
          f"{ {k: v for k, v in first.items() if v} }; resumed "
          f"{'resume_from_checkpoint' in kev}; resumed fit vs the uninterrupted fit "
          f"{'identical' if same else 'DIFFERENT'}")
    if not (same and first.get("knn_kbest") and "resume_from_checkpoint" in kev):
        errors.append("3e_checkpoint: interrupt, resume or equality failed")

    for label, extra, kernels in MR_BOUNDARY_CELLS:
        e, bres, launches[label], bev, _ = mr_cell(
            label, fdata, dataclasses.replace(fq, **extra), kernels, card,
            absent=("knn_window",))
        errors += e
        print(f"3l {label}: m {bev['boundary_select'][0]['m']}, boundary_cores "
              f"{bev['boundary_cores'][0]['wall_s']} s, glue (boundary_phase) "
              f"{bev['boundary_phase'][0]['wall_s']} s, refine "
              f"{[r['wall_s'] for r in bev.get('refine', [])]}; ARI vs truth "
              f"{adjusted_rand_index(bres.labels, ftruth):.6f}")
    return errors, launches


def novel_queries(data, rows: int, seed: int):
    """Queries in the bench sampler's shape (``bench.py:187-193``) on the
    Skin-shaped grid: training rows, every fourth a bitwise duplicate, the
    rest jittered by a rounded N(0, 1) and kept on the 0-255 grid."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = data[rng.integers(0, len(data), rows)]
    jitter = np.round(rng.normal(0, 1, (rows, data.shape[1])))
    jitter[::4] = 0.0
    return np.clip(q + jitter, 0, 255)


def serve_parity(data, forest) -> list[str]:
    """Phase 3m (a): the rectangular B2 and B7 against their plain versions
    on the card, bitwise, at the predictor's shapes: every bucket (8 ... 256
    query rows) against the 245,057 x 3 training set at k = 15 in the
    ``xla`` backend's form (the reference's tile rule), the ``fused`` dot
    form and cosine (with the column tile's zero-norm rule), a bucket of
    zero-norm query rows, and a training set with zero-norm rows; B7 on
    each bucket's routed candidate lists of the 3b forest (ids repeated
    across trees and inside padded leaves), and on the same lists cut short
    and padded with the sentinel."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.core.distances import euclidean_form
    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import cuda_knn
    from hdbscan_tpu_torch.ops.rpforest import route_queries
    from hdbscan_tpu_torch.ops.tiled import _tile_sizes

    errors = []

    def check(tag, a, b):
        torch.cuda.synchronize()
        ok = _bits_same(a, b)
        print(f"parity {tag}: {'bitwise' if ok else 'MISMATCH'}")
        if not ok:
            errors.append(tag)

    n, d = data.shape
    k = MIN_PTS - 1
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    zx = x.clone()
    zx[[5, n // 2, n - 7]] = 0.0  # zero-norm training rows in three column tiles
    _, ct, _ = _tile_sizes(n, 128, 8192)
    q_all = torch.as_tensor(novel_queries(data, 256, SEED + 30).astype(np.float32),
                            device="cuda")
    normals, thresholds, members = (torch.as_tensor(a, device="cuda") for a in (
        forest.normals, forest.thresholds, forest.members))
    tree = torch.arange(forest.trees, device="cuda")[:, None]
    for bucket in SERVE_BUCKETS:
        q = q_all[:bucket].clone()
        form = euclidean_form(min(bucket, 128), ct, d)
        cases = [("xla", x, "euclidean", form), ("fused", x, "euclidean", "dot"),
                 ("cosine", x, "cosine", None), ("cosine zero-norm columns", zx, "cosine", None)]
        for tag, cols, metric, f in cases:
            check(f"B2 predict bucket {bucket} {tag}",
                  cuda_knn.knn_kbest_panel(q, cols, k, metric, f, col_tile=ct),
                  cuda_knn.knn_kbest_panel_plain(q, cols, k, metric, f, col_tile=ct))
        leaves = route_queries(q, normals, thresholds, forest.depth)
        cand = members[tree, leaves].permute(1, 0, 2).reshape(bucket, -1).to(torch.int32)
        check(f"B7 predict bucket {bucket} routed ({cand.shape[1]} candidates)",
              cf.forest_rescan_topk(q, x, cand, k, "euclidean", "f32", n),
              cf.forest_rescan_topk_plain(q, x, cand, k, "euclidean", "f32", n))
        short = cand.clone()
        cut = torch.arange(bucket, device="cuda")[:, None] % 7 * 3  # 0 ... 18 live ids
        short[torch.arange(cand.shape[1], device="cuda")[None, :] >= cut] = n
        check(f"B7 predict bucket {bucket} short sentinel-padded lists",
              cf.forest_rescan_topk(q, x, short, k, "euclidean", "f32", n),
              cf.forest_rescan_topk_plain(q, x, short, k, "euclidean", "f32", n))
    zq = q_all[:64].clone()
    zq[::2] = 0.0
    check("B2 predict bucket 64 zero-norm query rows cosine",
          cuda_knn.knn_kbest_panel(zq, zx, k, "cosine", None, col_tile=ct),
          cuda_knn.knn_kbest_panel_plain(zq, zx, k, "cosine", None, col_tile=ct))
    return errors


def serve_cell(label, predictor, queries, kernels, absent=(), membership=False):
    """One serving cell on the card: the launch counters zeroed just before
    the predict and read just after; returns (outputs, launches, wall s)
    and prints the wall, rows/s and launches."""
    import torch

    from hdbscan_tpu_torch.ops import cuda_build

    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = predictor.predict(queries, with_membership=membership)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {name: c for name, c in cuda_build.LAUNCHES.items() if c}
    print(f"3m {label}: {len(queries)} rows, backend {predictor.backend}, wall {wall:.3f} s, "
          f"{len(queries) / wall:.0f} rows/s, launches {launches}")
    missing = [name for name in kernels if not launches.get(name)]
    extra = [name for name in absent if launches.get(name)]
    errors = []
    if missing or extra:
        errors.append(f"{label}: kernels not launched {missing}, launched but not of the "
                      f"path {extra}")
    return out, launches, wall, errors


def http_leg(here, model, model_b, card, tmp) -> tuple[list[str], dict]:
    """Phase 3m (d), ``serve_http``: a ``ClusterServer`` on 127.0.0.1, port
    0, over ``model``: ``POST /predict`` of 1, 7, 256 and 1,000 rows and
    one with membership, each equal to the in-process predict; ``GET
    /healthz`` and two ``GET /metrics`` scrapes; ``POST /swap`` to
    ``model_b`` (generation 2); a closed loop of 4 client threads for 5 s
    at batch sizes 1-256, each response equal to the sequential predict of
    its rows (p50/p99 latency and rows/s printed, not gated);
    the trace and the scrapes through ``scripts/check_trace.py`` and
    ``scripts/check_metrics.py``.

    Every in-process answer the responses are held against is computed
    before the server starts, so the launch counters, zeroed just before
    the requests and again just before the closed loop and read just after
    each, count the server's own launches and nothing else; the swap's
    warmup falls between the two windows."""
    import json
    import threading
    import urllib.request

    import numpy as np

    from hdbscan_tpu_torch.ops import cuda_build
    from hdbscan_tpu_torch.serve import ClusterModel, ClusterServer, Predictor
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    errors = []
    # The answers, from the card's in-process predictor, before any window.
    want = Predictor(model, device="cuda")
    asks = [novel_queries(model.data, rows, SEED + 40 + rows) for rows in HTTP_SIZES]
    answers = [want.predict(q) for q in asks]
    mq = novel_queries(model.data, 33, SEED + 50)
    mvec = want.predict(mq, with_membership=True)[3]
    pool = novel_queries(model.data, 4096, SEED + 61)
    # The swapped-in model's sequential predict of the pool (the server's
    # backend, ``auto``): every concurrent response must equal its slice.
    pool_labels = Predictor(ClusterModel.load(model_b)).predict(pool)[0].tolist()

    trace = os.path.join(tmp, "serve_http.jsonl")
    tracer = Tracer(sinks=[JsonlSink(trace, static={"process": 0})])
    t = time.perf_counter()
    srv = ClusterServer(model, port=0, tracer=tracer)
    start_s = time.perf_counter() - t
    url = f"http://{srv.host}:{srv.port}"

    def call(path, obj=None):
        data = None if obj is None else json.dumps(obj).encode()
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=120) as r:
            return r.status, r.read().decode()

    def window_launches(label):
        got = {name: c for name, c in cuda_build.LAUNCHES.items() if c}
        if not got.get("knn_kbest_panel") or got.get("forest_rescan_topk"):
            errors.append(f"{label}: the server's launches {got} are not B2 alone")
        return got

    loop = {"lat": [], "rows": 0, "bad": 0}
    scrapes = []
    try:
        srv.start()
        cuda_build.reset_launches()
        for rows, q, (labels, prob, score) in zip(HTTP_SIZES, asks, answers):
            status, body = call("/predict", {"points": q.tolist()})
            out = json.loads(body)
            ok = (status == 200 and out["labels"] == labels.tolist()
                  and out["probabilities"] == [round(p, 6) for p in prob.tolist()]
                  and out["outlier_scores"] == [round(s, 6) for s in score.tolist()])
            print(f"3m serve_http POST /predict {rows} rows: "
                  f"{'equal to the in-process predict' if ok else 'DIFFERENT'}")
            if not ok:
                errors.append(f"serve_http: /predict of {rows} rows differs")
        status, body = call("/predict", {"points": mq.tolist(), "membership": True})
        if status != 200 or json.loads(body)["membership"] != np.round(mvec, 6).tolist():
            errors.append("serve_http: the membership response differs")
        health = json.loads(call("/healthz")[1])
        print(f"3m serve_http /healthz: backend {health['backend']}, device {health['device']}, "
              f"warmup {health['warmup']}, batcher {health['batcher']}")
        for i in range(2):
            scrapes.append(os.path.join(tmp, f"scrape{i}.txt"))
            with open(scrapes[-1], "w") as f:
                f.write(call("/metrics")[1])
            call("/predict", {"points": mq[:5].tolist()})
        requests_launches = window_launches("serve_http requests")
        swap = json.loads(call("/swap", {"path": model_b})[1])
        print(f"3m serve_http POST /swap: {swap}")
        if swap.get("generation") != 2:
            errors.append(f"serve_http: swap gave {swap}")
        rng = np.random.default_rng(SEED + 60)
        stop = time.perf_counter() + HTTP_LOOP_S
        lock = threading.Lock()

        def client(seed):
            r = np.random.default_rng(seed)
            while time.perf_counter() < stop:
                b = int(r.integers(1, 257))
                a = int(r.integers(0, len(pool) - b))
                t0 = time.perf_counter()
                status, body = call("/predict", {"points": pool[a : a + b].tolist()})
                same = status == 200 and json.loads(body)["labels"] == pool_labels[a : a + b]
                with lock:
                    loop["lat"].append(time.perf_counter() - t0)
                    loop["rows"] += b if status == 200 else 0
                    loop["bad"] += not same

        threads = [threading.Thread(target=client, args=(int(rng.integers(1 << 30)),))
                   for _ in range(HTTP_CLIENTS)]
        cuda_build.reset_launches()
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        loop_wall = time.perf_counter() - t
        loop_launches = window_launches("serve_http closed loop")
    finally:
        srv.close()
        tracer.close()
    lat = np.sort(np.array(loop["lat"]))
    p50 = float(lat[int(0.5 * (len(lat) - 1))]) * 1e3
    p99 = float(lat[int(np.ceil(0.99 * len(lat))) - 1]) * 1e3
    stats = dict(requests=len(lat), p50_ms=p50, p99_ms=p99, rows_per_s=loop["rows"] / loop_wall,
                 server_start_s=start_s, launches=requests_launches,
                 loop_launches=loop_launches)
    print(f"3m serve_http requests window: launches {requests_launches}")
    print(f"3m serve_http closed loop ({HTTP_CLIENTS} clients x {HTTP_LOOP_S:.0f} s, batch "
          f"1-256): {len(lat)} requests, p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
          f"{stats['rows_per_s']:.0f} rows/s; server start (warmup) {start_s:.3f} s; "
          f"launches {loop_launches}; {card}")
    print(f"3m serve_http closed loop: {loop['bad']} responses differ from the sequential "
          "predict of the same rows")
    if loop["bad"]:
        errors.append(f"serve_http: {loop['bad']} concurrent responses differ")
    msg = validator(here, "check_trace.py", trace)
    out = subprocess.run([sys.executable, os.path.join(here, "scripts", "check_metrics.py"),
                          *scrapes], capture_output=True, text=True, timeout=300)
    print(f"3m serve_http trace: {'passes' if msg is None else msg}; scrapes: "
          f"{out.stdout.strip().splitlines()[-1] if out.stdout.strip() else out.stderr[-300:]}")
    if msg is not None or out.returncode != 0:
        errors.append("serve_http: the trace or the scrapes fail their checkers")
    return errors, stats


def cli_predict_leg(here, data, card, tmp) -> list[str]:
    """Phase 3m (e), ``cli_predict``: ``fit --model-out`` on the first
    30,000 rows of the Skin-shaped set (the dense route), then ``predict
    --points`` of 20,000 novel queries, both as subprocesses on the card;
    the prediction file must equal the in-process predict on the saved
    model, written the same way."""
    import numpy as np

    from hdbscan_tpu_torch.serve import ClusterModel, Predictor
    from hdbscan_tpu_torch.utils.io import load_points

    path, qpath = os.path.join(tmp, "train.tsv"), os.path.join(tmp, "queries.tsv")
    model, pred = os.path.join(tmp, "cli_model.npz"), os.path.join(tmp, "cli_pred.csv")
    train = data[:CLI_DENSE_ROWS]
    np.savetxt(path, train, delimiter="\t", fmt="%d")
    q = novel_queries(train, N_NOVEL, SEED + 70)
    np.savetxt(qpath, q, delimiter="\t", fmt="%d")
    walls = []
    for argv in (["fit", f"file={path}", "minPts=16", "minClSize=367",
                  f"processing_units={CLI_DENSE_ROWS}", f"out_dir={tmp}/cli_out",
                  "--model-out", model],
                 ["predict", "--model", model, "--points", qpath, "--out", pred]):
        rc, so, se, wall, _, _ = run_cli(argv, here, as_subprocess=True)
        walls.append(wall)
        if rc != 0:
            return [f"cli_predict: {argv[0]} exited {rc}: {se[-1500:]}"]
        print(f"3m cli_predict {argv[0]}: {so.splitlines()[0] if so else ''} ({wall:.3f} s)")
    labels, prob, score = Predictor(ClusterModel.load(model)).predict(load_points(qpath))
    want = "label,probability,outlier_score\n" + "".join(
        f"{a},{b:.6f},{c:.6f}\n" for a, b, c in zip(labels, prob, score))
    with open(pred, encoding="utf-8") as f:
        same = f.read() == want
    print(f"3m cli_predict: prediction file {'equal to' if same else 'DIFFERENT from'} the "
          f"in-process predict; fit {walls[0]:.3f} s, predict {walls[1]:.3f} s of command; "
          f"{card}")
    return [] if same else ["cli_predict: the prediction file differs"]


def predict_times(data, model, forest, launches) -> list[dict]:
    """The kernels line's serving rows: the rectangular B2 on one 256-row
    bucket against the 245,057 x 3 training set at k = 15 in the form the
    ``serve_skin`` cell ran (``knn_kbest_panel_predict``), and B7 on one
    256-row bucket of the 3b forest's routed candidates
    (``forest_rescan_topk_predict``), each beside its plain version, its
    bound and ``torch.cdist`` + ``torch.topk`` (TF32 off)."""
    import numpy as np
    import torch

    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import cuda_knn
    from hdbscan_tpu_torch.ops.rpforest import route_queries

    n, d = data.shape
    k = MIN_PTS - 1
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    q = torch.as_tensor(novel_queries(data, 256, SEED + 80).astype(np.float32), device="cuda")
    rows = []

    def row(name, source, replaces, launch, kernel, plain, library, nbytes, ops, **extra):
        ms = cuda_ms(kernel, 10)
        plain_ms, b = timed_plain(plain)
        a = kernel()
        b_ms, by = bound_ms(nbytes, ops)
        rows.append(dict(
            name=name, route="cuda", source=f"hdbscan_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches.get(launch, 0),
            max_abs_err=max_err(a[0], b[0], a[1], b[1]), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=by, bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3,
            library_ms=cuda_ms(library, 5), library_call=TWO_CALLS, **extra,
        ))

    form = "dot"  # serve_skin's backend: auto -> fused on the card
    row("knn_kbest_panel_predict", "knn_kbest.cu", "hdbscan_tpu/ops/pallas_knn.py:453",
        "knn_kbest_panel",
        lambda: cuda_knn.knn_kbest_panel(q, x, k, "euclidean", form),
        lambda: cuda_knn.knn_kbest_panel_plain(q, x, k, "euclidean", form),
        lambda: torch.topk(torch.cdist(q, x), k, dim=1, largest=False),
        (256 + n) * d * 4 + 256 * k * 8, 256.0 * n * pair_ops(d, form, root=False),
        blocks=kbest_blocks(256, n, d, k), form=form,
        device_ms=device_ms(lambda: cuda_knn.knn_kbest_panel(q, x, k, "euclidean", form),
                            "knn_kbest", per_call=True))
    normals, thresholds, members = (torch.as_tensor(a, device="cuda") for a in (
        forest.normals, forest.thresholds, forest.members))
    tree = torch.arange(forest.trees, device="cuda")[:, None]
    leaves = route_queries(q, normals, thresholds, forest.depth)
    cand = members[tree, leaves].permute(1, 0, 2).reshape(256, -1).to(torch.int32)
    uniq = int(torch.unique(cand).numel())

    def rescan_two_calls():
        torch.topk(torch.cdist(q[:, None, :], x[cand.long()])[:, 0, :], k, dim=1,
                   largest=False)

    row("forest_rescan_topk_predict", "forest_rescan.cu", "hdbscan_tpu/ops/pallas_forest.py:411",
        "forest_rescan_topk",
        lambda: cf.forest_rescan_topk(q, x, cand, k, "euclidean", "f32", n),
        lambda: cf.forest_rescan_topk_plain(q, x, cand, k, "euclidean", "f32", n),
        rescan_two_calls,
        256 * d * 4 + cand.numel() * 4 + uniq * d * 4 + 256 * k * 8,
        float(cand.numel()) * pair_ops(d, "diff", root=False),
        blocks=cf.rescan_blocks(256, cand.shape[1], d, k), candidates=int(cand.shape[1]),
        distinct_ids=uniq,
        device_ms=device_ms(lambda: cf.forest_rescan_topk(q, x, cand, k, "euclidean", "f32", n),
                            "rescan_", per_call=True))
    print(f"predict kernel shapes: 256-row bucket x {n} columns, d {d}, k {k}, form {form}; "
          f"B7 256 rows x {cand.shape[1]} routed candidates ({uniq} distinct)")
    return rows


def serve_phase(here, data, res, fres, card) -> tuple[list[str], dict, list[dict]]:
    """Phase 3m, serving (module docstring). ``res`` is phase 3's exact fit
    and ``fres`` 3b's rp-forest fit (fitted here when None). Returns failure
    messages, each cell's launches and the kernels line's serving rows."""
    import shutil
    import tempfile

    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import rpforest
    from hdbscan_tpu_torch.serve import ClusterModel, Predictor

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hdbscan_serve_")
    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE)
    fparams = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE, **FOREST)
    launches = {}

    # (a) the kernels at the predictor's shapes, against the 3b forest.
    forest = rpforest.build_forest(data, trees=FOREST["rpf_trees"],
                                   leaf_size=FOREST["rpf_leaf_size"], seed=SEED)
    errors = serve_parity(data, forest)

    # (b) serve_skin: phase 3's fit saved, reloaded and served.
    t = time.perf_counter()
    path = res.to_cluster_model(data, params).save(os.path.join(tmp, "skin.npz"))
    model = ClusterModel.load(path)
    print(f"3m serve_skin model: save + load {time.perf_counter() - t:.3f} s, "
          f"{os.path.getsize(path)} bytes, {model.summary()}")
    pred = Predictor(model)
    info = pred.warmup()
    print(f"3m serve_skin warmup: {info}")
    out, launches["serve_skin_train"], _, e = serve_cell(
        "serve_skin training rows", pred, data, ("knn_kbest_panel",), ("forest_rescan_topk",))
    errors += e
    diff = int(np.sum(out[0] != res.labels))
    print(f"3m serve_skin round trip: {diff} of {N_SKIN} training labels differ from the fit")
    if diff:
        errors.append(f"serve_skin: {diff} training labels differ from the fit's")
    queries = novel_queries(data, N_NOVEL, SEED + 20)
    novel, launches["serve_skin"], _, e = serve_cell(
        "serve_skin novel", pred, queries, ("knn_kbest_panel",), ("forest_rescan_topk",))
    errors += e
    xla = Predictor(model, backend="xla")
    xnovel, launches["serve_skin_xla"], _, e = serve_cell(
        "serve_skin novel (xla)", xla, queries, ("knn_kbest_panel",), ("forest_rescan_topk",))
    errors += e
    print(f"3m serve_skin novel: {np.bincount(novel[0]).tolist()[:8]} ... label counts; "
          f"labels fused vs xla equal {np.array_equal(novel[0], xnovel[0])}; {card}")

    # The card against the CPU on a 4,096-row model, each backend.
    rng = np.random.default_rng(SEED + 21)
    sub = data[rng.choice(N_SKIN, 4096, replace=False)]
    small = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50)
    sres = exact.fit(sub, small)
    sforest = rpforest.build_forest(sub, trees=4, leaf_size=1024, seed=SEED)
    smodel = ClusterModel.from_fit_result(sres, sub, small, forest=sforest)
    sq = np.concatenate([novel_queries(sub, 3000, SEED + 22), np.zeros((5, 3))])
    for backend in ("xla", "fused", "rpforest"):
        card_out = Predictor(smodel, backend=backend).predict(sq, with_membership=True)
        cpu_out = Predictor(smodel, backend=backend, device="cpu").predict(
            sq, with_membership=True)
        same = all(np.array_equal(a, b, equal_nan=True) for a, b in zip(card_out[:3],
                                                                          cpu_out[:3]))
        merr = float(np.max(np.abs(card_out[3] - cpu_out[3]) / np.maximum(np.abs(cpu_out[3]),
                                                                          1e-30)))
        print(f"3m 4,096-row model {backend}: card vs CPU labels, probabilities, scores "
              f"{'identical' if same else 'DIFFERENT'}; membership max rel err {merr:.3e}")
        if not same or merr > 1e-6:
            errors.append(f"card vs CPU predict differs on the 4,096-row model ({backend})")

    # (c) serve_skin_rpf: 3b's fit, its artifact carrying the forest.
    if fres is None:
        fres, _, _, _ = run_fit(data, fparams)
    rpath = fres.to_cluster_model(data, fparams).save(os.path.join(tmp, "skin_rpf.npz"))
    rmodel = ClusterModel.load(rpath)
    rpred = Predictor(rmodel, backend="rpforest")
    print(f"3m serve_skin_rpf warmup: {rpred.warmup()}, forest {rmodel.summary()['rpf']}")
    rout, launches["serve_skin_rpf_train"], _, e = serve_cell(
        "serve_skin_rpf training rows", rpred, data, ("forest_rescan_topk",),
        ("knn_kbest_panel",))
    errors += e
    diff = int(np.sum(rout[0] != fres.labels))
    print(f"3m serve_skin_rpf round trip: {diff} of {N_SKIN} training labels differ from the "
          "rp-forest fit")
    if diff:
        errors.append(f"serve_skin_rpf: {diff} training labels differ from the fit's")
    rnovel, launches["serve_skin_rpf"], _, e = serve_cell(
        "serve_skin_rpf novel", rpred, queries, ("forest_rescan_topk",), ("knn_kbest_panel",))
    errors += e
    exact_on_rpf = Predictor(rmodel, backend="xla").predict(queries)[0]
    print(f"3m serve_skin_rpf: ARI of the rpforest backend's labels against the exact backend "
          f"on the same model {ari(rnovel[0], exact_on_rpf):.6f}, against serve_skin's "
          f"{ari(rnovel[0], novel[0]):.6f}")

    # (d) serve_http and (e) cli_predict.
    e, http_stats = http_leg(here, model, rpath, card, tmp)
    errors += e
    launches["serve_http"] = http_stats["launches"]
    launches["serve_http_loop"] = http_stats["loop_launches"]
    errors += cli_predict_leg(here, data, card, tmp)

    rows = predict_times(data, model, forest, {
        "knn_kbest_panel": launches["serve_skin"].get("knn_kbest_panel", 0),
        "forest_rescan_topk": launches["serve_skin_rpf"].get("forest_rescan_topk", 0)})
    for r in rows:
        r["launches_3m"] = {cell: got[r["name"][: -len("_predict")]] for cell, got in
                            launches.items() if got.get(r["name"][: -len("_predict")])}
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"3m serving phase: {time.perf_counter() - t_phase:.1f} s; {card}")
    return errors, launches, rows


class ShardVisitRecorder(CallRecorder):
    """Keeps the arguments of the sharded forest's first B7 call on another
    shard's panel (the query rows and the panel in different storage): the
    first chunk of shard 0's rows visiting shard 3's panel."""

    def __init__(self):
        from hdbscan_tpu_torch.ops import cuda_forest

        super().__init__(cuda_forest, "forest_rescan_topk")
        self.kept = None

    def __enter__(self):
        def rec(*args, **kw):
            q, panel = args[0], args[1]
            if (self.kept is None and q.untyped_storage().data_ptr()
                    != panel.untyped_storage().data_ptr()):
                self.kept = (args, kw)
            return self.orig(*args, **kw)

        setattr(self.mod, self.name, rec)
        return self


def shard_visit_row(visit, launches) -> dict:
    """The kernels line's ``forest_rescan_topk_shard`` row: B7 on one
    recorded visit of the sharded forest (a shard's rows against another
    shard's panel, T x max-leaf panel-local candidates a row) beside its
    plain version, its bound and ``torch.cdist`` + ``torch.topk``."""
    import torch

    from hdbscan_tpu_torch.ops import cuda_forest as cf

    (q, panel, cids, k, metric), kw = visit
    m, d = q.shape
    sentinel = kw["sentinel"]
    live = cids[cids != sentinel]
    uniq = int(torch.unique(live).numel())

    def kernel():
        return cf.forest_rescan_topk(q, panel, cids, k, metric, "f32", sentinel)

    def two_calls():
        step = max(1, (1 << 26) // (cids.shape[1] * d))
        for a in range(0, m, step):
            pts = panel[cids[a : a + step].clamp(max=sentinel - 1).long()]
            torch.topk(torch.cdist(q[a : a + step, None, :], pts), k, dim=2, largest=False)

    ms = cuda_ms(kernel, 3)
    plain_ms, b = timed_plain(lambda: cf.forest_rescan_topk_plain(q, panel, cids, k, metric,
                                                                  "f32", sentinel))
    a = kernel()
    ops = float(live.numel()) * pair_ops(d, metric_form(metric, "diff"), root=False)
    b_ms, by = bound_ms(m * d * 4 + cids.numel() * 4 + uniq * d * 4 + m * k * 8, ops)
    print(f"3n B7 shard visit: {m} rows x {cids.shape[1]} candidates ({live.numel()} live, "
          f"{uniq} distinct panel rows), d {d}, k {k}")
    return dict(
        name="forest_rescan_topk_shard", route="cuda",
        source="hdbscan_tpu_torch/csrc/forest_rescan.cu",
        replaces="hdbscan_tpu/ops/pallas_forest.py:411", launches=launches,
        max_abs_err=max_err(a[0], b[0], a[1], b[1]), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=by, bound_separate_ms=ops / H100_FP32_INSTR_PER_S * 1e3,
        library_ms=cuda_ms(two_calls, 2), library_call=TWO_CALLS,
        blocks=cf.rescan_blocks(m, cids.shape[1], d, k), candidates=int(cids.shape[1]),
        device_ms=device_ms(kernel, "rescan_", per_call=True),
    )


def mesh_cell(label, fit, data, params, need, absent, card, mesh):
    """One cell of phase 3n: ``fit`` ("mr" or "exact") over ``mesh`` with
    the launch counters zeroed just before and read just after; checks
    finite cores, a label a row, the kernels in ``need`` launched and those
    in ``absent`` not. Returns (errors, result, launches, events, wall)."""
    import numpy as np
    import torch

    if fit == "mr":
        res, launches, ev, wall, peak = run_mr(data, params, mesh=mesh)
        report_mr(label, res, launches, ev, wall, peak)
    else:
        torch.cuda.reset_peak_memory_stats()
        res, launches, ev, wall = run_fit(data, params, mesh=mesh)
        peak = torch.cuda.max_memory_allocated()
        print(f"{label} walls (s): " + (fit_walls(ev, wall) if "forest_events" in ev else
              f"core_distances {ev['core_distances'][-1]['wall_s']}, boruvka_mst "
              f"{ev['boruvka_mst'][0]['wall_s']} in {ev['boruvka_mst'][0]['rounds']} rounds, "
              f"total {wall:.3f}"))
    print(f"{label} ({card}, {len(mesh.devices)} shards on "
          f"{sorted({str(d) for d in mesh.devices})}): wall {wall:.3f} s, peak device "
          f"memory {peak / 2**30:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    errors = []
    if not np.all(np.isfinite(res.core_distances)):
        errors.append(f"{label}: non-finite core distances")
    if res.labels.shape != (len(data),):
        errors.append(f"{label}: {res.labels.shape} labels for {len(data)} rows")
    missing = [k for k in need if launches[k] == 0]
    extra = [k for k in absent if launches[k] != 0]
    if missing or extra:
        errors.append(f"{label}: kernels missing {missing}, unexpected {extra}")
    return errors, res, launches, ev, wall


def mesh_phase(data, card, fres=None, qres=None) -> tuple[list[str], dict, list[dict]]:
    """Phase 3n, multi-GPU fits from one process (module docstring).
    ``data`` is phase 3's Skin-shaped set; ``fres`` and ``qres`` are 3b's
    forest fit and 3e's default MR fit (fitted here when None). Returns
    failure messages, each cell's launches and the ``forest_rescan_topk_
    shard`` kernel row."""
    import dataclasses

    import numpy as np
    import torch

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact, mr_hdbscan
    from hdbscan_tpu_torch.parallel.mesh import get_mesh
    from hdbscan_tpu_torch.utils.datasets import make_gauss
    from hdbscan_tpu_torch.utils.evaluation import adjusted_rand_index

    t_phase = time.perf_counter()
    mesh = shard_mesh()
    cpu = get_mesh([torch.device("cpu")] * N_SHARDS)
    errors, launches = [], {}

    # (a) Each configuration on the card equal to the same over CPU shards.
    mdata, _ = make_gauss(MESH_SUB_MR, **MR_DATA)
    msmall = HDBSCANParams(**dict(MR_PARAMS, min_cluster_size=30, processing_units=1024))
    for label, extra, _, _ in MESH_MR_CELLS:
        p = dataclasses.replace(msmall, **extra)
        same = mr_fits_equal(mr_hdbscan.fit(mdata, p, mesh=mesh),
                             mr_hdbscan.fit(mdata, p, mesh=cpu))
        print(f"3n {label} on {MESH_SUB_MR} rows, card vs CPU shards: "
              f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            errors.append(f"{label}: the {MESH_SUB_MR}-row fit differs card vs CPU")
    fsmall = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50, **FOREST)
    for label, extra, _, _ in MESH_FOREST_CELLS:
        p = dataclasses.replace(fsmall, **extra)
        a, b = exact.fit(data[:CLI_SUB_ROWS], p, mesh=mesh), exact.fit(data[:CLI_SUB_ROWS], p,
                                                                       mesh=cpu)
        same = fits_equal(a, b) and trees_equal(a.tree, b.tree)
        print(f"3n {label} on {CLI_SUB_ROWS} rows, card vs CPU shards: "
              f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            errors.append(f"{label}: the {CLI_SUB_ROWS}-row fit differs card vs CPU")
    print(f"3n card-vs-CPU slices: {time.perf_counter() - t_phase:.1f} s")

    # (b) The MR cells on 3e's 200,000 rows, each against its one-device twin.
    fdata, ftruth = make_gauss(N_FULLQ, **MR_DATA)
    fq = HDBSCANParams(**MR_PARAMS, min_cluster_size=max(64, N_FULLQ // 200))
    if qres is None:
        qres, _, _, qwall, _ = run_mr(fdata, fq)
        print(f"3n 3e default, one device: {qwall:.3f} s")
    twins = {"": qres}
    for tag, extra in (("pruned", BOUNDARY),
                       ("unpruned", dict(BOUNDARY, boundary_block_pruning=False))):
        twins[tag], _, _, twall, _ = run_mr(fdata, dataclasses.replace(fq, **extra))
        print(f"3n 3e boundary {tag}, one device: {twall:.3f} s")
    for label, extra, need, absent in MESH_MR_CELLS:
        e, mres, launches[label], mev, _ = mesh_cell(
            label, "mr", fdata, dataclasses.replace(fq, **extra), need, absent, card, mesh)
        errors += e
        twin = ("" if "boundary" not in label else
                "unpruned" if "sharded" in label else "pruned")
        same = mr_fits_equal(mres, twins[twin])
        print(f"{label} vs the one-device fit (3e{' boundary ' + twin if twin else ''}): "
              f"{'identical' if same else 'DIFFERENT'}; ARI vs truth "
              f"{adjusted_rand_index(mres.labels, ftruth):.6f}")
        if not same:
            errors.append(f"{label}: differs from its one-device twin")
    del twins, fdata

    # (c) The forest cells on the Skin-shaped set.
    fparams = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE, **FOREST)
    if fres is None:
        fres, _, _, bwall = run_fit(data, fparams)
        print(f"3n 3b rp-forest fit, one device: {bwall:.3f} s")
    rows = []
    for label, extra, need, absent in MESH_FOREST_CELLS:
        with ShardVisitRecorder() as visit:
            e, sres, launches[label], sev, _ = mesh_cell(
                label, "exact", data, dataclasses.replace(fparams, **extra), need, absent,
                card, mesh)
        errors += e
        if "shard" in label:
            ex = sev["shard_knn_exchange"][0]
            print(f"{label}: shard_knn_build {sev['shard_knn_build'][0]['wall_s']} s (depth "
                  f"{sev['shard_knn_build'][0]['depth']}, max leaf "
                  f"{sev['shard_knn_build'][0]['max_leaf']}), shard_panel_sweep "
                  f"{sev['shard_panel_sweep'][0]['wall_s']} s, recall@{ex['k']} "
                  f"{ex['recall_at_k']:.6f} on {ex['recall_rows']} rows; ARI vs 3b "
                  f"{adjusted_rand_index(sres.labels, fres.labels):.6f}, core distances equal "
                  f"3b's on {np.mean(sres.core_distances == fres.core_distances):.4f} of rows")
            rows.append(shard_visit_row(visit.kept, launches[label]["forest_rescan_topk"]))
        else:
            same = (np.array_equal(sres.core_distances, fres.core_distances)
                    and np.array_equal(sorted_mst(sres.mst), sorted_mst(fres.mst))
                    and np.array_equal(sres.labels, fres.labels)
                    and np.array_equal(sres.outlier_scores, fres.outlier_scores))
            print(f"{label} vs 3b (one device): {'identical' if same else 'DIFFERENT'} "
                  f"(cores, MST edge set, labels, outlier scores)")
            if not same:
                errors.append(f"{label}: differs from 3b")
    print(f"3n multi-GPU phase: {time.perf_counter() - t_phase:.1f} s; {card}")
    return errors, launches, rows


def ingest_kernels_check(label, recorders, required, phase="3o") -> list[str]:
    """Each kept call of B2 (``knn_kbest_panel``), B7
    (``forest_rescan_topk``) and K3 (``uf_scan``, a re-fit's or a fit job's
    finalize) on a ``phase`` path again through the kernel and through its
    plain version on the same card tensors: bitwise equal, or an error; an
    error too when the recorder of a kernel in ``required`` kept no call."""
    import torch

    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.ops import cuda_forest as cf
    from hdbscan_tpu_torch.ops import cuda_knn

    plain = {"knn_kbest_panel": cuda_knn.knn_kbest_panel_plain,
             "forest_rescan_topk": cf.forest_rescan_topk_plain,
             "uf_scan": mst_device.uf_scan_plain}
    errors, held = [], 0
    for rec in recorders:
        for args, kw in rec.calls:
            got = rec.orig(*args, **kw)
            want = plain[rec.name](*args, **kw)
            torch.cuda.synchronize()
            held += 1
            if not _bits_same(got, want):
                errors.append(f"{label}: {rec.name} differs from its plain version on a "
                              f"{phase} path call ({tuple(args[0].shape)})")
    errors += [f"{label}: no {r.name} call recorded on the {phase} path" for r in recorders
               if r.name in required and not r.calls]
    names = ", ".join(f"{r.name} {len(r.calls)} of {r.count} calls" for r in recorders)
    print(f"{phase} {label}: kernel vs plain on the path's own calls ({names}): "
          f"{'bitwise' if not errors else 'FAILED'} ({held} held)")
    return errors


def _json_state(obj) -> str:
    return json.dumps(obj.state_dict(), sort_keys=True)


def latency_stats(lat, rows: int) -> dict:
    """One stretch of sequential single-client requests: its count, p50 and
    nearest-rank p99 (the maximum when fewer than 100 requests), and rows
    a second over the summed request walls."""
    import numpy as np

    ms = np.sort(np.array(lat)) * 1e3
    n = len(ms)
    if not n:
        return dict(requests=0)
    return dict(requests=n, p50_ms=float(ms[int(0.5 * (n - 1))]),
                p99_ms=float(ms[int(np.ceil(0.99 * n)) - 1]),
                p99_is_max=n < 100, rows_per_s=n * rows / float(np.sum(lat)))


def _lat_text(st) -> str:
    if not st["requests"]:
        return "no requests"
    tail = f"max of {st['requests']}" if st["p99_is_max"] else "p99"
    return (f"{st['requests']} requests, p50 {st['p50_ms']:.3f} ms, {tail} "
            f"{st['p99_ms']:.3f} ms, {st['rows_per_s']:.0f} rows/s")


def stream_skin_cell(here, data, res, card, tmp) -> tuple[list[str], dict]:
    """Phase 3o (a), ``3o_stream_skin``: the 3m serve_skin model served
    with ``ingest=True``, a WAL and ``stream_reload=manual`` over HTTP, one
    client sending 256-row ``POST /ingest`` batches one at a time:
    STREAM_IN novel queries of the bench sampler's shape, then the same
    shape moved off the grid (+300 on every axis), which flags drift and
    kicks one background re-fit (the dense fit of the re-fit pool on the
    card, beside the ingest traffic) that publishes into ``model_dir`` and
    is staged; the shifted batches go on until the re-fit has published
    and STREAM_TAIL more. ``POST /swap`` then swaps it in. Latency and
    rows a second are reported for the requests with the re-fit running
    and for the rest. Every batch's labels (kept at the buffer's absorb)
    must equal the sequential predict of the served model, and a ``POST
    /predict`` after the swap the re-fit artifact's; the launch window (the
    stream, the re-fit and the swap) must launch B2 and K3 (the re-fit's
    finalize builds its merge forest on the card) and no B7; B2's own
    ingest calls and K3's call on the re-fit's pool are held against their
    plain versions."""
    import urllib.request

    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.ops import cuda_build, cuda_forest, cuda_knn
    from hdbscan_tpu_torch.serve import ClusterModel, ClusterServer, Predictor
    from hdbscan_tpu_torch.utils.tracing import Tracer

    errors = []
    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE,
                           stream_refit_budget=10**9, stream_reload="manual")
    model = ClusterModel.load(res.to_cluster_model(data, params).save(
        os.path.join(tmp, "skin.npz")))
    ins = np.split(novel_queries(data, STREAM_IN * STREAM_ROWS, SEED + 90), STREAM_IN)
    shifted = np.split(novel_queries(data, STREAM_SHIFT_MAX * STREAM_ROWS, SEED + 94)
                       + STREAM_SHIFT, STREAM_SHIFT_MAX)
    tracer = Tracer()
    t = time.perf_counter()
    srv = ClusterServer(model, port=0, tracer=tracer, ingest=True, params=params,
                        model_dir=os.path.join(tmp, "skin_models"),
                        wal_dir=os.path.join(tmp, "skin_wal"))
    start_s = time.perf_counter() - t
    kept, wal_s, span, snaps = [], [], [], []
    absorb, append = srv.buffer.absorb, srv.journal.append_ingest
    snapshot = srv.journal.maybe_snapshot
    request, on_publish = srv.refitter.request, srv.refitter.on_publish

    def absorb_kept(points, labels, prob):
        kept.append((np.array(points), np.array(labels), np.array(prob)))
        return absorb(points, labels, prob)

    def append_timed(*a):
        t0 = time.perf_counter()
        out = append(*a)
        wal_s.append(time.perf_counter() - t0)
        return out

    def snapshot_timed(*a, **kw):
        t0 = time.perf_counter()
        took = snapshot(*a, **kw)
        if took:
            snaps.append((len(outs), time.perf_counter() - t0))
        return took

    def request_timed(*a):
        started = request(*a)
        if started:
            span.append(time.perf_counter())
        return started

    def publish_timed(*a):
        out = on_publish(*a)
        span.append(time.perf_counter())
        return out

    srv.buffer.absorb, srv.journal.append_ingest = absorb_kept, append_timed
    srv.journal.maybe_snapshot = snapshot_timed
    srv.refitter.request, srv.refitter.on_publish = request_timed, publish_timed
    url = f"http://{srv.host}:{srv.port}"

    def post(route, obj):
        req = urllib.request.Request(url + route, data=json.dumps(obj).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    lat, when, outs = [], [], []
    probe = ins[0] + STREAM_SHIFT

    def send(pts):
        t0 = time.perf_counter()
        outs.append(post("/ingest", {"points": pts.tolist()}))
        lat.append(time.perf_counter() - t0)
        when.append((t0, t0 + lat[-1]))

    try:
        srv.start()
        with CallRecorder(cuda_knn, "knn_kbest_panel", keep=4) as b2, \
                CallRecorder(cuda_forest, "forest_rescan_topk", keep=4) as b7, \
                CallRecorder(mst_device, "uf_scan", keep=1) as k3:
            cuda_build.reset_launches()
            t_all = time.perf_counter()
            for pts in ins:
                send(pts)
            tail = 0
            for pts in shifted:
                send(pts)
                if span and not srv.refitter.busy:
                    tail += 1
                    if tail == STREAM_TAIL:
                        break
            wall = time.perf_counter() - t_all
            t0 = time.perf_counter()
            srv.refitter.join(timeout=300)
            refit_tail_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            swap = post("/swap", {})
            swap_s = time.perf_counter() - t0
            after = post("/predict", {"points": probe.tolist()})
            torch_sync()
            launches = {name: c for name, c in cuda_build.LAUNCHES.items() if c}
        errors += ingest_kernels_check("3o_stream_skin", [b2, b7, k3],
                                       ("knn_kbest_panel", "uf_scan"))
    finally:
        srv.close()
    kicks = [i for i, o in enumerate(outs) if o["refit_started"]]
    psi = [o["drift"]["value"] for o in outs]
    print(f"3o_stream_skin: server start {start_s:.3f} s; {len(outs)} batches of {STREAM_ROWS} "
          f"rows ({STREAM_IN} in distribution, then {len(outs) - STREAM_IN} shifted), absorbed "
          f"a batch in distribution {np.mean([o['absorbed'] for o in outs[:STREAM_IN]]):.1f}, "
          f"shifted {np.mean([o['absorbed'] for o in outs[STREAM_IN:]]):.1f}; drift psi at "
          f"the last in-distribution batch {psi[STREAM_IN - 1]}, then "
          f"{psi[STREAM_IN:STREAM_IN + 32]}; re-fit kicked at batch {kicks}; "
          f"POST /swap {swap}")
    if (len(kicks) != 1 or kicks[0] < STREAM_IN or len(span) != 2
            or srv.refitter.refits_ok != 1 or swap.get("generation") != 2
            or after.get("generation") != 2):
        errors.append(f"3o_stream_skin: expected one re-fit in the shifted stretch and one "
                      f"swap, got kicks {kicks}, re-fits {srv.refitter.refits_ok} "
                      f"({srv.refitter.last_error}), swap {swap}")
    # Every batch's answer against the sequential predict of the served
    # model, and the swapped-in model's against the re-fit artifact's.
    pred = Predictor(model)
    bad = sum(not (np.array_equal(w[0], labels) and np.array_equal(w[1], prob))
              for pts, labels, prob in kept for w in [pred.predict(pts)])
    swapped = Predictor(ClusterModel.load(srv.refitter.last_path)).predict(probe)[0]
    same_after = after.get("labels") == swapped.tolist()
    print(f"3o_stream_skin: {len(kept)} batches' labels and probabilities vs the sequential "
          f"predict: {bad} differ; after the swap /predict "
          f"{'equals' if same_after else 'DIFFERS from'} the re-fit artifact's predict")
    if bad or not same_after or len(kept) != len(outs):
        errors.append(f"3o_stream_skin: {bad} of {len(kept)} ingest batches differ from the "
                      f"sequential predict, after the swap equal {same_after}")
    if (not launches.get("knn_kbest_panel") or not launches.get("uf_scan")
            or launches.get("forest_rescan_topk")):
        errors.append(f"3o_stream_skin: launches {launches} are not B2 and K3 alone")
    # A request ran beside the re-fit when its wall overlaps the re-fit's,
    # from the kick to the staged publish.
    t0, t1 = (span + [float("inf")] * 2)[:2]
    beside = [(a < t1 and b > t0) for a, b in when]
    refit = next((e for e in tracer.events if e.name == "model_refit"), None)
    wal = np.sort(np.array(wal_s)) * 1e3
    stats = dict(in_distribution=latency_stats(lat[:STREAM_IN], STREAM_ROWS),
                 no_refit=latency_stats([x for x, b in zip(lat, beside) if not b], STREAM_ROWS),
                 refit_running=latency_stats([x for x, b in zip(lat, beside) if b],
                                             STREAM_ROWS),
                 window_rows_per_s=len(outs) * STREAM_ROWS / wall,
                 wal_append_ms=float(np.median(wal)),
                 wal_append_p99_ms=float(wal[int(np.ceil(0.99 * len(wal))) - 1]),
                 wal_snapshots_ms={i: w * 1e3 for i, w in snaps},
                 refit_wall_s=refit.wall_s if refit else None,
                 refit_rows=refit.fields.get("rows") if refit else None,
                 swap_wall_s=swap_s, swap_pause_s=swap.get("pause_s"), launches=launches)
    print(f"3o_stream_skin /ingest, one client, one request at a time: in distribution "
          f"{_lat_text(stats['in_distribution'])}; every request without the re-fit "
          f"{_lat_text(stats['no_refit'])}; with the re-fit running "
          f"{_lat_text(stats['refit_running'])}; the whole window {len(outs)} requests, "
          f"{stats['window_rows_per_s']:.0f} rows/s; WAL append {stats['wal_append_ms']:.3f} ms "
          f"a batch (median of {len(wal)}), p99 {stats['wal_append_p99_ms']:.3f} ms; WAL "
          f"snapshots (every {srv.journal.snapshot_every} appends, the buffer's whole state) "
          f"at batch: ms {({i: round(w, 3) for i, w in stats['wal_snapshots_ms'].items()})}; "
          f"re-fit "
          f"{stats['refit_rows']} rows in {stats['refit_wall_s']} s (its tail after the last "
          f"batch {refit_tail_s:.3f} s); POST /swap {swap_s:.3f} s (build + warm + install + "
          f"re-key), pause {swap.get('pause_s')} s; launches {launches}; {card}")
    return errors, stats


def stream_card_vs_cpu_cell(data, card, tmp) -> tuple[list[str], dict]:
    """Phase 3o (b), ``3o_stream_card_vs_cpu``: a 4,096-row integer-grid
    model with a forest, one ingest script (novel queries, then shifted
    rows) on the card and on ``device="cpu"`` under the ``xla``, ``fused``
    and ``rpforest`` backends: every response, the buffer's and the drift
    detector's state equal; the card's window launches B2 (B7 under
    ``rpforest``) alone, each kernel's ingest calls held against its plain
    version."""
    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build, cuda_forest, cuda_knn, rpforest
    from hdbscan_tpu_torch.serve import ClusterModel, ClusterServer

    errors, launches = [], {}
    rng = np.random.default_rng(SEED + 91)
    sub = data[rng.choice(N_SKIN, 4096, replace=False)]
    small = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50,
                          stream_refit_budget=10**9, stream_drift_threshold=1e9)
    sforest = rpforest.build_forest(sub, trees=4, leaf_size=1024, seed=SEED)
    smodel = ClusterModel.from_fit_result(exact.fit(sub, small), sub, small, forest=sforest)
    ins = novel_queries(sub, 6 * STREAM_ROWS, SEED + 92)
    batches = np.split(np.concatenate([ins, ins + STREAM_SHIFT]), 12)
    for backend in ("xla", "fused", "rpforest"):
        want_k = "forest_rescan_topk" if backend == "rpforest" else "knn_kbest_panel"
        other = "knn_kbest_panel" if backend == "rpforest" else "forest_rescan_topk"
        servers = []
        try:
            for device in ("cuda", "cpu"):
                servers.append(ClusterServer(
                    smodel, backend=backend, port=0, ingest=True, params=small, device=device,
                    model_dir=os.path.join(tmp, f"cvc_{backend}_{device}")))
            card_srv, cpu_srv = servers
            with CallRecorder(cuda_knn, "knn_kbest_panel", keep=2) as b2, \
                    CallRecorder(cuda_forest, "forest_rescan_topk", keep=2) as b7:
                cuda_build.reset_launches()
                card_out = [card_srv.ingest(pts) for pts in batches]
                torch_sync()
                got = {name: c for name, c in cuda_build.LAUNCHES.items() if c}
            cpu_out = [cpu_srv.ingest(pts) for pts in batches]
            errors += ingest_kernels_check(f"3o_stream_card_vs_cpu {backend}",
                                           [b7 if backend == "rpforest" else b2], (want_k,))
            same = (card_out == cpu_out
                    and _json_state(card_srv.buffer) == _json_state(cpu_srv.buffer)
                    and _json_state(card_srv.drift) == _json_state(cpu_srv.drift))
        finally:
            for s in servers:
                s.close()
        launches[f"3o_stream_card_vs_cpu_{backend}"] = got
        print(f"3o_stream_card_vs_cpu {backend}: {len(batches)} batches, responses, buffer and "
              f"drift state card vs CPU {'identical' if same else 'DIFFERENT'}; absorbed "
              f"{[o['absorbed'] for o in card_out]}; card launches {got}")
        if not same:
            errors.append(f"3o_stream_card_vs_cpu: card and CPU differ under {backend}")
        if not got.get(want_k) or got.get(other):
            errors.append(f"3o_stream_card_vs_cpu {backend}: launches {got}, want {want_k} "
                          f"alone")
    print(f"3o_stream_card_vs_cpu: {card}")
    return errors, launches


def _restored(health) -> dict:
    """The /healthz stream fields the WAL restores."""
    st = health["stream"]
    return dict({k: st[k] for k in ("rows_seen", "absorbed_exact", "absorbed_near", "buffered",
                                    "bubbles", "drift_rows")},
                maintain={k: st["maintain"][k] for k in ("active", "fallbacks", "n", "inserts",
                                                         "splices", "pending_edges")})


def maintain_cell(here, data, card, tmp) -> tuple[list[str], dict]:
    """Phase 3o (c), ``3o_maintain``: ``stream_maintain=incremental`` on a
    model of N_MAINTAIN Skin-shaped rows (its O(n^2 d) host bootstrap
    timed), fed batches of novel rows off the grid, each in a region of its
    own: the maintained model
    swaps in, the maintainer's digests after every batch equal a CPU-only
    port server's fed the same rows, and so does the served predict of
    the batch and a fixed probe (labels, probabilities and scores,
    bitwise) on the model padded to the maintainer's capacity with
    sentinel rows; every B2 call of the card server's ingests (their
    predicts, the refreshes' warmups) and of those predicts is held
    against its plain version; the card server closed and reopened
    on its WAL verifies the watermark, and a ``serve --ingest`` subprocess
    of the command line on the card, killed with SIGKILL and restarted on
    its WAL, recovers to the state it acknowledged."""
    import signal
    import urllib.request

    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build, cuda_knn
    from hdbscan_tpu_torch.serve import ClusterServer

    errors = []
    rng = np.random.default_rng(SEED + 93)
    sub = data[rng.choice(N_SKIN, N_MAINTAIN, replace=False)]
    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50,
                           stream_maintain="incremental", maintain_refresh_every=64,
                           stream_snapshot_every=4, stream_drift_threshold=1e9)
    path = exact.fit(sub, params).to_cluster_model(sub, params).save(
        os.path.join(tmp, "maintain.npz"))
    # Each batch a 40-wide cube of its own off the grid, so each stays novel
    # after the last refresh took in the ones before it.
    batches = [(rng.integers(0, 40, (MAINTAIN_ROWS, 3)) + STREAM_SHIFT + 50 * i).astype(
        np.float64) for i in range(MAINTAIN_BATCHES)]
    from hdbscan_tpu_torch.serve import ClusterModel

    def server(device, wal):
        t0 = time.perf_counter()
        srv = ClusterServer(ClusterModel.load(path), port=0, ingest=True, params=params,
                            device=device, model_dir=os.path.join(tmp, f"mm_{device}"),
                            wal_dir=os.path.join(tmp, wal))
        return srv, time.perf_counter() - t0

    card_srv, boot_s = server("cuda", "m_card_wal")
    cpu_srv = None
    stats = {"bootstrap_s": boot_s}
    probe = novel_queries(sub, 64, SEED + 95)
    b2 = CallRecorder(cuda_knn, "knn_kbest_panel")
    try:
        cpu_srv, _ = server("cpu", "m_cpu_wal")
        cuda_build.reset_launches()
        same, same_pred, walls = True, True, []
        for pts in batches:
            # Only the card server's calls are recorded: the CPU server's
            # predict reaches the same wrapper with host tensors.
            with b2:
                t0 = time.perf_counter()
                got = card_srv.ingest(pts)
                walls.append(time.perf_counter() - t0)
                card_pred = card_srv.predictor.predict(np.concatenate([pts, probe]))
            want = cpu_srv.ingest(pts)
            same &= (got == want
                     and card_srv.maintainer.state_dict() == cpu_srv.maintainer.state_dict())
            cpu_pred = cpu_srv.predictor.predict(np.concatenate([pts, probe]))
            same_pred &= all(np.array_equal(a, b, equal_nan=True)
                              for a, b in zip(card_pred, cpu_pred))
        torch_sync()
        stats["launches"] = {name: c for name, c in cuda_build.LAUNCHES.items() if c}
        mark = card_srv.maintainer.state_dict()
        ms = card_srv.maintain_stats()
        gen = card_srv.generation
        padded = len(card_srv.model.data)
        errors += ingest_kernels_check("3o_maintain", [b2], ("knn_kbest_panel",))
    finally:
        card_srv.close()
        if cpu_srv is not None:
            cpu_srv.close()
    print(f"3o_maintain: {N_MAINTAIN}-row model, bootstrap (host k-NN + Prim) in server start "
          f"{boot_s:.3f} s; {len(batches)} batches of {MAINTAIN_ROWS} novel rows, ingest wall "
          f"a batch {[round(w, 4) for w in walls]} s; maintain {ms}; generation {gen}; "
          f"digests card vs CPU after every batch {'identical' if same else 'DIFFERENT'}; "
          f"predict of each batch and a {len(probe)}-row probe on the served model "
          f"({padded} rows with the sentinels) card vs CPU "
          f"{'identical' if same_pred else 'DIFFERENT'}; mst_sha {mark['mst_sha'][:16]}; "
          f"launches {stats['launches']}; {card}")
    if not same:
        errors.append("3o_maintain: the card server's maintainer differs from the CPU's")
    if not same_pred:
        errors.append("3o_maintain: the card server's predict differs from the CPU's")
    if gen < 2 or ms["refreshes"] < 2 or ms["fallbacks"]:
        errors.append(f"3o_maintain: the maintained model did not swap in ({ms}, gen {gen})")
    if not stats["launches"].get("knn_kbest_panel"):
        errors.append(f"3o_maintain: launches {stats['launches']} lack B2")
    reopened, reopen_s = server("cuda", "m_card_wal")
    try:
        ok = (reopened.maintainer is not None and reopened.maintainer.state_dict() == mark)
    finally:
        reopened.close()
    print(f"3o_maintain reopen on the WAL: {reopen_s:.3f} s, watermark "
          f"{'verified' if ok else 'NOT verified'}")
    if not ok:
        errors.append("3o_maintain: the reopened server did not verify the watermark")

    # The command line on the card: SIGKILL mid-stream, restart on the WAL.
    port_file = os.path.join(tmp, "maintain_port.txt")
    argv = [sys.executable, "-m", "hdbscan_tpu_torch", "serve", "--model", path, "--ingest",
            "--model-dir", os.path.join(tmp, "mm_cli"), f"wal_dir={tmp}/m_cli_wal",
            "maintain=incremental", "maintain_refresh=64", "snapshot_every=4",
            "drift_threshold=1e9", "--port", "0", "--port-file", port_file]

    def start():
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        while not os.path.exists(port_file):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                proc.kill()
                raise RuntimeError(f"serve --ingest did not start: {proc.communicate()[1][-1500:]}")
            time.sleep(0.05)
        time.sleep(0.05)
        with open(port_file) as f:
            return proc, f"http://127.0.0.1:{int(f.read())}", time.perf_counter() - t0

    def call(url, route, obj=None):
        data_ = None if obj is None else json.dumps(obj).encode()
        with urllib.request.urlopen(urllib.request.Request(url + route, data=data_),
                                    timeout=300) as r:
            return json.loads(r.read())

    procs = []
    try:
        proc, url, cli_s = start()
        procs.append(proc)
        for pts in batches:
            call(url, "/ingest", {"points": pts.tolist()})
        before = _restored(call(url, "/healthz"))
        proc.send_signal(signal.SIGKILL)
        proc.communicate(timeout=60)
        os.unlink(port_file)
        proc, url, restart_s = start()
        procs.append(proc)
        health = call(url, "/healthz")
        after = _restored(health)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
        rc = proc.returncode
    except Exception as e:  # noqa: BLE001 - the cell's failure, reported below
        errors.append(f"3o_maintain CLI: {type(e).__name__}: {e}")
        return errors, stats
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ok = (after == before and after["maintain"]["active"]
          and after["maintain"]["inserts"] == mark["inserts"] and rc == 0
          and health["stream"]["wal"]["last_recover"]["snapshot"])
    print(f"3o_maintain CLI serve --ingest on the card: start {cli_s:.3f} s, SIGKILL after "
          f"{len(batches)} batches, restart {restart_s:.3f} s, recovered "
          f"{'the acknowledged state' if ok else 'ANOTHER state'} ({after}); SIGTERM exit {rc}")
    if not ok:
        errors.append(f"3o_maintain CLI: recovery {after} != {before} or exit {rc}: "
                      f"{err[-800:]}")
    stats.update(cli_start_s=cli_s, cli_restart_s=restart_s)
    return errors, stats


def validator(here, script, *args) -> str | None:
    """One of ``scripts/``' stdlib validators as a subprocess: None when it
    passes, else the end of its output."""
    out = subprocess.run([sys.executable, os.path.join(here, "scripts", script), *args],
                         capture_output=True, text=True, timeout=300)
    return None if out.returncode == 0 else (out.stdout + out.stderr)[-2000:]


def obs_kernels_check(label, recorders, required) -> list[str]:
    """Each kept call of B1 (``segmin``), K2 (``knn_kbest``), the
    rectangular B2 (``knn_kbest_panel``), B9 (``min_outgoing_panel``) and
    K3 (``uf_scan``) on a 3p path again through the kernel and through its
    plain version on the same card tensors: bitwise equal, or an error; an
    error too when a recorder of a kernel in ``required`` kept no call."""
    import inspect

    import torch

    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin

    def plain(name, a):
        if name == "segmin":
            return cuda_segmin.min_outgoing_plain(a["data"], a["core"], a["comp"], a["valid"],
                                                  a["metric"], a["form"], a["col_tile"])
        if name == "knn_kbest":
            return cuda_knn.knn_kbest_plain(a["x"], a["k"], a["metric"], a["form"],
                                            a["col_tile"])
        if name == "knn_kbest_panel":
            x = a["x"]
            if a["n_cols"] is not None:
                x = x[: max(0, min(x.shape[0], a["n_cols"] - a["id_offset"]))]
            return cuda_knn.knn_kbest_panel_plain(a["q"], x, a["k"], a["metric"], a["form"],
                                                  a["id_offset"], a["col_tile"])
        if name == "min_outgoing_panel":
            form = a["form"]
            if form is None:
                form = cuda_segmin.panel_form(a["rows"].shape[1], a["metric"], a["row_tile"],
                                              a["col_tile"])
            return cuda_segmin.min_outgoing_panel_plain(
                a["rows"], a["core_r"], a["comp_r"], a["valid_r"], a["panel"], a["core_c"],
                a["comp_c"], a["valid_c"], a["metric"], form, a["col_tile"], a["col_offset"])
        return mst_device.uf_scan_plain(a["su"], a["sv"], a["n"])

    errors, held = [], 0
    for rec in recorders:
        for args, kw in rec.calls:
            bound = inspect.signature(rec.orig).bind(*args, **kw)
            bound.apply_defaults()
            got = rec.orig(*args, **kw)
            want = plain(rec.name, bound.arguments)
            torch.cuda.synchronize()
            held += 1
            if not _bits_same(got, want):
                errors.append(f"{label}: {rec.name} differs from its plain version on a "
                              f"3p call ({tuple(args[0].shape)})")
    errors += [f"{label}: no {r.name} call recorded on the path" for r in recorders
               if r.name in required and not r.calls]
    names = ", ".join(f"{r.name} {len(r.calls)} of {r.count} calls" for r in recorders)
    print(f"3p {label}: kernel vs plain on the path's own calls ({names}): "
          f"{'bitwise' if not errors else 'FAILED'} ({held} held)")
    return errors


def obs_recorders(names, keep):
    """CallRecorders of the 3p kernels' wrappers, by kernel name."""
    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.ops import cuda_knn, cuda_segmin

    mods = {"segmin": cuda_segmin, "min_outgoing_panel": cuda_segmin, "knn_kbest": cuda_knn,
            "knn_kbest_panel": cuda_knn, "uf_scan": mst_device}
    return [CallRecorder(mods[n], n, keep=keep) for n in names]


def fit_wall(err: str) -> float | None:
    """The ``fit`` event's wall from a command's ``phases:`` summary."""
    for line in err.split("phases:\n", 1)[-1].splitlines():
        if line.strip().startswith("fit: n=1 wall_s="):
            return float(line.split("wall_s=")[1])
    return None


def obs_cli_cell(here, root, label, path, flags, kernels, keep, card) -> tuple[list[str], dict]:
    """One 3p command-line cell: the fit without the observability flags
    and with every one (``--trace-out --report --flight-dir`` and
    :data:`OBS_FLAGS`), as :data:`OBS_TURNS` says, each in this
    process with the launch counters zeroed just before and read just
    after; the overhead compares the sides' median fit walls. The five
    files must be equal across the runs, each trace and report pass
    ``check_trace.py``, the empty flight directories ``check_flight.py
    --allow-empty``, the gate pass, and the first traced run's kept kernel
    calls equal their plain versions. Returns (errors, stats)."""
    from contextlib import ExitStack

    errors, runs = [], []
    argv = ["fit", f"file={path}", *flags]
    recorders = obs_recorders(kernels, keep)
    for i, traced in enumerate(OBS_TURNS):
        tag = f"{label}_{i}"
        extra = [f"out_dir={root}/{tag}"]
        if traced:
            extra += ["--trace-out", f"{root}/{tag}.jsonl", "--report", f"{root}/{tag}.json",
                      "--flight-dir", f"{root}/{tag}_flight", *OBS_FLAGS]
        with ExitStack() as stack:
            if traced and not any(r["traced"] for r in runs):
                for rec in recorders:
                    stack.enter_context(rec)
            rc, out, err, wall, launches, peak = run_cli(argv + extra, here, False)
        if rc != 0:
            return [f"{tag}: exit {rc}: {err[-2000:]}"], {}
        runs.append(dict(tag=tag, traced=traced, out=out, fit=fit_wall(err), wall=wall,
                         launches=launches, peak=peak, files=file_digests(f"{root}/{tag}")))
    if any(r["files"] != runs[0]["files"] for r in runs):
        errors.append(f"{label}: the five files differ with the observability flags")
    for r in (r for r in runs if r["traced"]):
        tag = r["tag"]
        bad = validator(here, "check_trace.py", f"{root}/{tag}.jsonl", f"{root}/{tag}.json")
        if bad:
            errors.append(f"{tag}: check_trace.py failed on the trace and report: {bad}")
        flight = f"{root}/{tag}_flight"
        os.makedirs(flight, exist_ok=True)
        bad = validator(here, "check_flight.py", "--allow-empty", flight)
        if bad or os.listdir(flight):
            errors.append(f"{tag}: the healthy run left flight bundles or failed "
                          f"check_flight.py: {bad or os.listdir(flight)}")
    first = next(r for r in runs if r["traced"])
    with open(f"{root}/{first['tag']}.json") as f:
        rep = json.load(f)
    with open(f"{root}/{first['tag']}.jsonl") as f:
        events = [json.loads(line) for line in f]
    gate = [e for e in events if e["stage"] == "replication_gate"]
    if len(gate) != 1 or not gate[0]["ok"]:
        errors.append(f"{label}: no passing replication_gate event")
    plain = [r["fit"] for r in runs if not r["traced"]]
    traced = [r["fit"] for r in runs if r["traced"]]
    print(f"3p {label} ({card}): {first['out'].splitlines()[0] if first['out'] else ''}")
    if None not in plain + traced:
        import statistics

        med_p, med_t = round(statistics.median(plain), 6), round(statistics.median(traced), 6)
        print(f"3p {label}: fit walls in turns {[r['fit'] for r in runs]} s "
              f"({'/'.join('with' if t else 'without' for t in OBS_TURNS)}); median without "
              f"the layer {med_p} s, with it {med_t} s (overhead "
              f"{(med_t / med_p - 1) * 100:+.2f}%); commands "
              f"{[round(r['wall'], 3) for r in runs]} s; files "
              f"{'identical' if not errors else 'see errors'}; peak allocated "
              f"{[round(r['peak'] / 2**30, 3) for r in runs]} GiB; launches "
              f"{ {k: v for k, v in first['launches'].items() if v} }")
    wm = rep.get("memory", {}).get("watermarks", {})
    print(f"3p {label} watermarks (bytes, source, samples, devices): "
          f"{ {k: (v['max_device_bytes'], v['source'], v['samples'], v['devices'])
               for k, v in wm.items()} }")
    mem = rep.get("memory", {})
    print(f"3p {label} memory start/end: {mem.get('start')} / {mem.get('end')}")
    missing = [k for k in kernels if first["launches"].get(k if k != "min_outgoing_panel"
                                                           else "segmin_panel", 0) == 0]
    if missing:
        errors.append(f"{label}: kernels of the path never launched: {missing}")
    errors += obs_kernels_check(label, recorders, kernels)
    return errors, dict(launches=first["launches"], report=rep, events=events, gate=gate,
                        files=first["files"])


def obs_phase(here, data, card) -> tuple[list[str], dict]:
    """Phase 3p, the observability layer (module docstring): its four
    cells. Returns failure messages and each cell's launches."""
    import shutil
    import tempfile

    import numpy as np

    from hdbscan_tpu_torch import obs

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="hdbscan_obs_")
    errors, launches = [], {}
    try:
        path = os.path.join(root, "skin.tsv")
        np.savetxt(path, data, delimiter="\t", fmt="%d")
        # (a) the CLI's Skin fit, the MR route of 3j's cli_mr.
        e, skin = obs_cli_cell(here, root, "3p_cli_skin_obs", path, CLI_LEGS[0][2],
                               ("knn_kbest", "segmin"), 1, card)
        errors += e
        launches["3p_cli_skin_obs"] = skin.get("launches", {})
        # (b) the exact fit over four shards of the card.
        e, shard = obs_cli_cell(
            here, root, "3p_cli_sharded_obs", path,
            [*CLI_LEGS[1][2], "--device", ",".join(["cuda:0"] * N_SHARDS)],
            ("knn_kbest_panel", "min_outgoing_panel", "uf_scan"), 2, card)
        errors += e
        launches["3p_cli_sharded_obs"] = shard.get("launches", {})
        if shard:
            TWIN_FILES[(N_SKIN, tuple(CLI_LEGS[1][2]), ",".join(["cuda:0"] * N_SHARDS))] = \
                shard["files"]
        if shard:
            rep, gate = shard["report"], shard["gate"]
            tl = [ev for ev in shard["events"] if ev["stage"] == "device_timeline"]
            wm = rep.get("memory", {}).get("watermarks", {})
            single = (bool(gate) and gate[0]["worst_fraction"] == 0.0
                      and all(row["devices"] == 1 for row in wm.values()))
            print(f"3p 3p_cli_sharded_obs: {len(tl)} device_timeline rows over devices "
                  f"{sorted({ev['device'] for ev in tl})}; gate single_device: {single}")
            print(f"3p 3p_cli_sharded_obs timeline: {rep.get('timeline')}")
            print(f"3p 3p_cli_sharded_obs roofline: {rep.get('roofline')}")
            if "timeline" not in rep or "roofline" not in rep or not tl:
                errors.append("3p_cli_sharded_obs: the report lacks its timeline or roofline")
            if not single:
                errors.append("3p_cli_sharded_obs: the gate did not answer single_device on "
                              "one card")
        e, launches["3p_watchdog"] = obs_watchdog_cell(here, root, data, card)
        errors += e
        e, launches["3p_serve_obs"] = obs_serve_cell(here, root, data, card)
        errors += e
    finally:
        obs.clear()
        shutil.rmtree(root, ignore_errors=True)
    print(f"3p observability phase: {time.perf_counter() - t_phase:.1f} s; {card}")
    return errors, launches


def obs_watchdog_cell(here, root, data, card) -> tuple[list[str], dict]:
    """``3p_watchdog``: a ``phase_stall`` fault (OBS_STALL_S) in the level
    beat of an MR fit of OBS_SUB_ROWS Skin-shaped rows on the card with
    ``watchdog=1``: a ``watchdog_stall`` event and bundle, valid under
    ``check_flight.py``, and the fit still exits 0."""
    import numpy as np

    from hdbscan_tpu_torch.fault import inject

    path = os.path.join(root, "watchdog.tsv")
    np.savetxt(path, data[:OBS_SUB_ROWS], delimiter="\t", fmt="%d")
    trace, flight = os.path.join(root, "watchdog.jsonl"), os.path.join(root, "watchdog_flight")
    inject.install(f"phase_stall:count=1,delay_s={OBS_STALL_S}")
    try:
        rc, out, err, wall, launches, _ = run_cli(
            ["fit", f"file={path}", "minPts=16", "minClSize=50", "processing_units=1024",
             "k=0.01", "seed=0", "watchdog=1", "heartbeat=0.1", f"out_dir={root}/watchdog",
             "--trace-out", trace, "--flight-dir", flight], here, False)
    finally:
        inject.clear()
    if rc != 0:
        return [f"3p_watchdog: exit {rc}: {err[-2000:]}"], launches or {}
    errors = []
    with open(trace) as f:
        stalls = [json.loads(line) for line in f if '"watchdog_stall"' in line]
    bundles = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
    bad = validator(here, "check_flight.py", flight) if bundles else "no bundle"
    if not stalls or not bundles or bad or not all(b.endswith("-watchdog_stall.json")
                                                   for b in bundles):
        errors.append(f"3p_watchdog: stall events {len(stalls)}, bundles {bundles}: {bad}")
    bad = validator(here, "check_trace.py", trace)
    if bad:
        errors.append(f"3p_watchdog: check_trace.py failed: {bad}")
    missing = [k for k in ("knn_kbest", "segmin") if launches.get(k, 0) == 0]
    if missing:
        errors.append(f"3p_watchdog: kernels of the fit never launched: {missing}")
    print(f"3p 3p_watchdog ({card}): exit {rc}, wall {wall:.3f} s; {len(stalls)} stall(s) "
          f"({[s.get('stalled_s') for s in stalls]} s), bundles {bundles}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return errors, launches


def obs_serve_cell(here, root, data, card) -> tuple[list[str], dict]:
    """``3p_serve_obs``: a process that fits (the dense fit of the first
    OBS_SERVE_ROWS Skin-shaped rows, its phases audited through the card's
    allocator) then serves the fit with ``watchdog_s`` set (the server
    arms its heartbeat hub): OBS_REQUESTS ``POST /predict`` of 1-256
    novel rows, each answer equal to the in-process predict, two
    ``/metrics`` scrapes (``check_metrics.py``, a non-zero
    ``hdbscan_tpu_device_peak_bytes``) and ``/healthz`` with its
    ``watchdog`` block; the run report ``serve --report`` writes
    (``cli._write_serving_report``) recomputes its ``predict_latency`` from
    the trace; then ``predict --report`` of 20,000 queries. B2's kept calls
    equal their plain versions."""
    import urllib.request

    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams, cli, obs
    from hdbscan_tpu_torch.models import hdbscan
    from hdbscan_tpu_torch.obs.audit import MemoryAuditor
    from hdbscan_tpu_torch.ops import cuda_build, cuda_knn
    from hdbscan_tpu_torch.serve import ClusterModel, ClusterServer, Predictor
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    errors = []
    x = data[:OBS_SERVE_ROWS]
    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=367, watchdog_s=30.0,
                           heartbeat_s=1.0)
    obs.install(auditor=MemoryAuditor())
    try:
        res = hdbscan.fit(x, params)
        path = res.to_cluster_model(x, params).save(os.path.join(root, "serve.npz"))
        model = ClusterModel.load(path)
        rng = np.random.default_rng(SEED + 30)
        sizes = [int(s) for s in rng.integers(1, 257, OBS_REQUESTS)]
        queries = novel_queries(x, sum(sizes), SEED + 31)
        want = Predictor(model).predict(queries)[0]
        trace, report = os.path.join(root, "serve.jsonl"), os.path.join(root, "serve.json")
        tracer = Tracer(sinks=[JsonlSink(trace, static={"process": 0})],
                        counters=cli._telemetry_counters())
        b2 = CallRecorder(cuda_knn, "knn_kbest_panel", keep=4)
        srv = ClusterServer(model, port=0, tracer=tracer, params=params)
        scrapes, lat = [], []
        try:
            srv.start()
            url = f"http://{srv.host}:{srv.port}"

            def call(route, obj=None):
                body = None if obj is None else json.dumps(obj).encode()
                with urllib.request.urlopen(urllib.request.Request(url + route, data=body),
                                            timeout=120) as r:
                    return r.status, r.read().decode()

            torch_sync()
            cuda_build.reset_launches()
            off = 0
            with b2:
                for i, rows in enumerate(sizes):
                    t = time.perf_counter()
                    status, body = call("/predict", {"points": queries[off:off + rows].tolist()})
                    lat.append(time.perf_counter() - t)
                    if status != 200 or json.loads(body)["labels"] != want[off:off + rows].tolist():
                        errors.append(f"3p_serve_obs: request {i} ({rows} rows) answered "
                                      f"{status} or other labels")
                        break
                    off += rows
                    if i in (OBS_REQUESTS // 2, OBS_REQUESTS - 1):
                        scrapes.append(os.path.join(root, f"scrape{len(scrapes)}.txt"))
                        with open(scrapes[-1], "w") as f:
                            f.write(call("/metrics")[1])
            torch_sync()
            launches = dict(cuda_build.LAUNCHES)
            health = json.loads(call("/healthz")[1])
        finally:
            srv.close()
            tracer.close()
        cli._write_serving_report(report, tracer, params, ["serve", "--model", path])
    finally:
        obs.clear()
    bad = validator(here, "check_metrics.py", *scrapes)
    with open(scrapes[-1]) as f:
        peaks = [line for line in f if line.startswith("hdbscan_tpu_device_peak_bytes{")]
    peak_ok = any(float(p.rsplit(" ", 1)[1]) > 0 for p in peaks)
    if bad or not peak_ok:
        errors.append(f"3p_serve_obs: check_metrics.py {bad}; device peaks {peaks}")
    if "watchdog" not in health:
        errors.append("3p_serve_obs: /healthz carries no watchdog block")
    bad = validator(here, "check_trace.py", trace, report)
    if bad:
        errors.append(f"3p_serve_obs: check_trace.py failed on the trace and report: {bad}")
    with open(report) as f:
        latency = json.load(f).get("predict_latency", {})
    st = latency_stats(lat, sum(sizes))
    print(f"3p 3p_serve_obs ({card}): {len(lat)} requests, {_lat_text(st)}; report "
          f"predict_latency {latency}; device peaks {[p.strip() for p in peaks]}; healthz "
          f"watchdog {health.get('watchdog')}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if launches.get("knn_kbest_panel", 0) == 0:
        errors.append("3p_serve_obs: B2 never launched while serving")
    errors += obs_kernels_check("3p_serve_obs", [b2], ("knn_kbest_panel",))
    qpath = os.path.join(root, "queries.tsv")
    np.savetxt(qpath, novel_queries(x, N_NOVEL, SEED + 32), delimiter="\t", fmt="%d")
    ptrace, preport = os.path.join(root, "predict.jsonl"), os.path.join(root, "predict.json")
    rc, out, err, wall, plaunches, _ = run_cli(
        ["predict", "--model", path, "--points", qpath, "--out", os.path.join(root, "p.csv"),
         "--trace-out", ptrace, "--report", preport], here, False)
    bad = validator(here, "check_trace.py", ptrace, preport) if rc == 0 else err[-2000:]
    if bad:
        errors.append(f"3p_serve_obs predict --report: {bad}")
    print(f"3p predict --report ({card}): exit {rc}, {wall:.3f} s; "
          f"{out.splitlines()[0] if out else ''}")
    return errors, launches


def fleet_http(url, route, obj=None, headers=None, timeout=120):
    """One HTTP call: (status, lower-cased headers, JSON body or text); a
    POST when ``obj`` is given; 4xx/5xx answers are returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(url + route, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, hdr, body = r.status, r.headers, r.read().decode()
    except urllib.error.HTTPError as e:
        status, hdr, body = e.code, e.headers, e.read().decode()
    try:
        body = json.loads(body)
    except ValueError:
        pass
    return status, {k.lower(): v for k, v in hdr.items()}, body


def replica_health(router, rid) -> dict:
    """A fleet replica's own ``/healthz`` (on the card it carries the
    process's kernel launch counts and its allocator's bytes)."""
    return fleet_http(f"http://127.0.0.1:{router._by_rid[rid].port}", "/healthz")[2]


def launches_since(before: dict, after: dict) -> dict:
    """Kernel launches between two readings of replicas' ``/healthz``
    (``{rid: health}``), summed over the replicas: each replica's counts
    read just before and just after a cell are its counts zeroed at the
    start of the cell."""
    out = {}
    for rid, h in after.items():
        then = before.get(rid, {}).get("kernels", {}).get("launches", {})
        for name, n in h.get("kernels", {}).get("launches", {}).items():
            if n - then.get(name, 0):
                out[name] = out.get(name, 0) + n - then.get(name, 0)
    return out


def compute_apps() -> str:
    """Each process's memory on the card as ``nvidia-smi`` reports it (one
    CUDA context each), or why it could not be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or "not reported (no process listed)"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not measured ({type(e).__name__})"


def fleet_models(data, res, tmp):
    """Phase 3q's three Skin-shaped artifacts, saved uncompressed (what the
    fit jobs publish and the artifact store maps): phase 3's exact fit, the
    exact fit of a second seed's rows, and phase 3's fit carrying the 3b
    forest (``rpforest`` serving). Returns ({name: path}, {name: rows})."""
    import numpy as np

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import rpforest
    from hdbscan_tpu_torch.serve import ClusterModel

    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE)
    data2 = np.random.default_rng(SEED + 40).integers(0, 256, size=(N_SKIN, 3)).astype(
        np.float64)
    t = time.perf_counter()
    res2 = exact.fit(data2, params)
    fit2 = time.perf_counter() - t
    forest = rpforest.build_forest(data, trees=FOREST["rpf_trees"],
                                   leaf_size=FOREST["rpf_leaf_size"], seed=SEED)
    paths = {
        "exact": res.to_cluster_model(data, params).save(
            os.path.join(tmp, "exact.npz"), compress=False),
        "seed2": res2.to_cluster_model(data2, params).save(
            os.path.join(tmp, "seed2.npz"), compress=False),
        "forest": ClusterModel.from_fit_result(res, data, params, forest=forest).save(
            os.path.join(tmp, "forest.npz"), compress=False),
    }
    print(f"3q models: second seed's exact fit {fit2:.3f} s; artifact bytes "
          f"{ {k: os.path.getsize(p) for k, p in paths.items()} }")
    return paths, {"exact": data, "seed2": data2, "forest": data}


def fleet_cells(here, paths, rows, card, tmp) -> tuple[list[str], dict]:
    """``3q_fleet_scale``, ``3q_fleet_tenants`` and ``3q_fleet_chaos`` on one
    fleet (module docstring): the port's router in this process over
    ``serve`` replica processes on the card."""
    import shutil
    import threading

    import numpy as np
    import torch

    from hdbscan_tpu_torch.fleet import FleetRouter
    from hdbscan_tpu_torch.ops import cuda_knn
    from hdbscan_tpu_torch.serve import ClusterModel, Predictor
    from hdbscan_tpu_torch.utils.tracing import JsonlSink, Tracer

    errors, launches = [], {}
    tenants = {f"t{i}": ("exact", "seed2", "forest")[i % 3] for i in range(FLEET_TENANTS)}
    tdir = os.path.join(tmp, "tenants")
    os.makedirs(tdir)
    for t, m in tenants.items():
        os.link(paths[m], os.path.join(tdir, f"{t}.npz"))
    rng = np.random.default_rng(SEED + 41)
    sizes = [int(s) for s in rng.integers(1, 257, FLEET_REQUESTS)]
    # Runs of FLEET_RUN requests a tenant, cycling the tenants through the LRUs.
    order = [f"t{i // FLEET_RUN % FLEET_TENANTS}" for i in range(FLEET_REQUESTS)]
    queries = novel_queries(rows["exact"], sum(sizes), SEED + 42)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    # The in-process answers on the card, request by request (each in its
    # own bucket, as a replica predicts it), the rectangular B2's calls held.
    preds = {m: Predictor(ClusterModel.load(p), max_batch=256) for m, p in paths.items()}
    b2 = CallRecorder(cuda_knn, "knn_kbest_panel", keep=4)
    with b2:
        want = [preds[tenants[t]].predict(queries[a:b])
                for t, a, b in zip(order, starts[:-1], starts[1:])]
        standby_want = preds["exact"].predict(queries[:256])[0].tolist()
        chaos_want = preds["exact"].predict(queries[:64])[0].tolist()
    errors += ingest_kernels_check("3q in-process answers", [b2], ("knn_kbest_panel",),
                                   phase="3q")
    router_trace = os.path.join(tmp, "router.jsonl")
    rdir = os.path.join(tmp, "replicas")
    tracer = Tracer(sinks=[JsonlSink(router_trace, static={"process": 0})])
    router = FleetRouter(
        paths["exact"], replicas=1, policy="consistent_hash", health_interval_s=2.0,
        tenants_dir=tdir, ingest=True, wal_root=os.path.join(tmp, "wal"),
        replica_args=["predict_batch=256", f"tenant_lru={FLEET_LRU}", "artifact_store=shared",
                      "refit_budget=1000000"],
        replica_env={"HDBSCAN_TPU_ARTIFACT_SPOOL": os.path.join(tmp, "spool")},
        replica_trace_dir=rdir, tracer=tracer, startup_timeout_s=300.0, run_dir=tmp)
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    t = time.perf_counter()
    router.start()
    up1 = time.perf_counter() - t
    try:
        time.sleep(1.0)
        free1 = torch.cuda.mem_get_info()[0]
        h0 = replica_health(router, "0")
        # --- 3q_fleet_scale: a warm standby from one replica --------------
        t = time.perf_counter()
        rid = router.scale_up(reason="manual", timeout=300)
        ready = time.perf_counter() - t
        time.sleep(1.0)
        free2 = torch.cuda.mem_get_info()[0]
        h1 = replica_health(router, rid) if rid else {}
        warm = h1.get("warmup", {})
        base = f"http://{router.host}:{router.port}"
        status, _, out = fleet_http(f"http://127.0.0.1:{router._by_rid[rid].port}"
                                    if rid else base, "/predict",
                                    {"points": queries[:256].tolist()})
        same = status == 200 and out["labels"] == standby_want
        print(f"3q 3q_fleet_scale ({card}): replica 0 up in {up1:.3f} s (warmup {h0['warmup']}); "
              f"standby {rid} ready in {ready:.3f} s (spawn, every bucket warmed, healthy "
              f"probe), warmup {warm}; its answers identical: {same}")
        print(f"3q card memory (mem_get_info free bytes, this process's context included): "
              f"no replica {free0}, 1 replica {free1}, 2 replicas {free2}; per replica "
              f"{free0 - free1} and {free1 - free2}; nvidia-smi per process: {compute_apps()}")
        if rid != "1" or warm.get("jit_compiles") != 0 or not warm.get("cache_hits") or not same:
            errors.append(f"3q_fleet_scale: standby {rid} warmup {warm}, answers same {same}")
        # --- 3q_fleet_tenants: eight tenants over two replicas ------------
        before = {r.rid: replica_health(router, r.rid) for r in router.replicas}
        lat, homes, bad = [], {}, []
        for i, (tenant, a, b) in enumerate(zip(order, starts[:-1], starts[1:])):
            t = time.perf_counter()
            # "tenant" first: the router's ring reads it from the body's
            # first 4 KiB (past that it hashes the body, as the reference's).
            status, hdr, out = fleet_http(base, "/predict", {
                "tenant": tenant, "points": queries[a:b].tolist()})
            lat.append(time.perf_counter() - t)
            w = want[i]
            same = status == 200 and (
                out["labels"] == w[0].tolist(),
                out["probabilities"] == [round(p, 6) for p in w[1].tolist()],
                out["outlier_scores"] == [round(s, 6) for s in w[2].tolist()])
            if not (same and all(same)) or homes.setdefault(
                    tenant, hdr.get("x-replica")) != hdr.get("x-replica"):
                bad.append((i, tenant, status, hdr.get("x-replica"), same))
        after = {r.rid: replica_health(router, r.rid) for r in router.replicas}
        # The router-replica join over the traces so far (a replica killed
        # below starts its trace afresh when it respawns).
        time.sleep(0.5)
        jdir = os.path.join(tmp, "join")
        os.makedirs(jdir)
        for path in [router_trace, *(os.path.join(rdir, f) for f in os.listdir(rdir))]:
            shutil.copy(path, jdir)
        bad_join = validator(here, "check_trace.py", "--join", os.path.join(jdir, "router.jsonl"),
                             *sorted(os.path.join(jdir, f) for f in os.listdir(jdir)
                                     if f != "router.jsonl"))
        launches["3q_fleet_tenants"] = launches_since(before, after)
        scrape = fleet_http(base, "/metrics")[2]
        spath = os.path.join(tmp, "fleet_scrape.txt")
        with open(spath, "w") as f:
            f.write(scrape)
        evictions = sum(float(line.rsplit(" ", 1)[1]) for line in scrape.splitlines()
                        if line.startswith("hdbscan_tpu_tenant_evictions_total{"))
        peaks = [line for line in scrape.splitlines()
                 if line.startswith("hdbscan_tpu_device_peak_bytes{")]
        st = latency_stats(lat, sum(sizes) // len(sizes))
        print(f"3q 3q_fleet_tenants ({card}): {FLEET_TENANTS} tenants, LRU {FLEET_LRU} a "
              f"replica, homes {homes}; {_lat_text(st)}; {len(bad)} answers off "
              f"{bad[:5]}; evictions {evictions:.0f}; launches "
              f"{launches['3q_fleet_tenants']}")
        for r in sorted(after):
            print(f"3q replica {r}: device_memory {after[r].get('device_memory')}; "
                  f"kernels builds {after[r].get('kernels', {}).get('builds')} cache_hits "
                  f"{after[r].get('kernels', {}).get('cache_hits')}")
        print(f"3q hdbscan_tpu_device_peak_bytes in the aggregated scrape: "
              f"{peaks or 'absent (no audited fit phase in a serving replica)'}")
        bad_metrics = validator(here, "check_metrics.py", spath)
        if bad or not evictions or bad_metrics or not launches["3q_fleet_tenants"].get(
                "knn_kbest_panel"):
            errors.append(f"3q_fleet_tenants: answers off {bad[:5]}, evictions {evictions}, "
                          f"check_metrics {bad_metrics}, launches {launches['3q_fleet_tenants']}")
        # --- 3q_fleet_chaos: SIGKILL a replica under load ------------------
        before = {r.rid: replica_health(router, r.rid) for r in router.replicas}
        acked = {r.rid: 0 for r in router.replicas}
        crng = np.random.default_rng(SEED + 43)

        def ingest():
            pts = novel_queries(rows["exact"], 256, int(crng.integers(1 << 30)))
            status, hdr, out = fleet_http(base, "/ingest", {"points": pts.tolist()})
            if status == 200:
                acked[hdr["x-replica"]] += out["rows"]
            return status

        codes = [ingest() for _ in range(8)]
        outcomes = {"served": 0, "other": 0, "failed": 0}
        lock, stop = threading.Lock(), threading.Event()
        q = queries[:64].tolist()

        def hammer():
            while not stop.is_set():
                status, _, out = fleet_http(base, "/predict", {"points": q})
                with lock:
                    if status != 200:
                        outcomes["failed"] += 1
                    elif out["labels"] != chaos_want:
                        outcomes["other"] += 1
                    else:
                        outcomes["served"] += 1

        load = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
        for th in load:
            th.start()
        time.sleep(0.5)
        victim = max(acked, key=lambda r: (acked[r], r))
        acked_at_kill = acked[victim]
        proc = router._by_rid[victim].proc
        t = time.perf_counter()
        os.kill(proc.pid, 9)
        proc.wait(timeout=30)  # gone: a request now finds its port refused
        status, hdr, _ = fleet_http(base, "/predict", {"points": q})
        reroute = time.perf_counter() - t
        codes.append(ingest())
        deadline, back = time.monotonic() + 180, None
        while time.monotonic() < deadline:
            h = router.health()["replicas"][victim]
            if h["restarts"] >= 1 and h["up"]:
                back = time.perf_counter() - t
                break
            time.sleep(0.1)
        recovered = replica_health(router, victim).get("stream", {}).get("wal", {}).get(
            "last_recover", {}) if back else {}
        codes.append(ingest())
        stop.set()
        for th in load:
            th.join(timeout=60)
        after = {r.rid: replica_health(router, r.rid) for r in router.replicas}
        launches["3q_fleet_chaos"] = launches_since(
            {k: v for k, v in before.items() if k != victim}, after)
        print(f"3q 3q_fleet_chaos ({card}): acked rows {acked}; SIGKILL replica {victim}: the "
              f"next request {status} from replica {hdr.get('x-replica')} in {reroute:.3f} s; "
              f"respawned and healthy in {back} s; WAL replayed {recovered.get('rows')} rows "
              f"(acked before the kill {acked_at_kill}); load {outcomes}; ingest codes {codes}; "
              f"launches "
              f"(the respawned replica's from its start) {launches['3q_fleet_chaos']}")
        if (status != 200 or back is None or recovered.get("rows") != acked_at_kill
                or outcomes["failed"] or outcomes["other"] or set(codes) != {200}):
            errors.append(f"3q_fleet_chaos: reroute {status}, back {back}, recovered "
                          f"{recovered}, acked {acked}, load {outcomes}, codes {codes}")
        # --- 3q_fleet_scale: drain back down -------------------------------
        t = time.perf_counter()
        down = router.scale_down(rid, reason="manual", timeout=120) if rid else False
        print(f"3q 3q_fleet_scale: drained replica {rid} back down: {down} in "
              f"{time.perf_counter() - t:.3f} s; replicas {[r.rid for r in router.replicas]}")
        if not down:
            errors.append(f"3q_fleet_scale: scale-down of {rid} failed")
    finally:
        drained = router.close()
        tracer.close()
    traces = sorted(os.path.join(rdir, f) for f in os.listdir(rdir))
    for path in [router_trace, *traces]:
        bad_trace = validator(here, "check_trace.py", path)
        if bad_trace:
            errors.append(f"3q: check_trace.py failed on {os.path.basename(path)}: {bad_trace}")
    print(f"3q fleet traces: {len(traces)} replica traces valid; check_trace.py --join over "
          f"the tenants cell {'OK' if not bad_join else bad_join}; drained clean {drained}")
    if bad_join or not drained:
        errors.append(f"3q: the join or the drain failed: {bad_join}, drained {drained}")
    return errors, launches


def fit_service_cell(paths, rows, card, tmp) -> tuple[list[str], dict]:
    """``3q_fit_service`` (module docstring): in this process, a
    ``TenantRegistry`` on the card over four tenants and a ``FitScheduler``
    with two workers fitting on the card; then eight rpforest tenants
    through an LRU of two, the allocator's bytes read before and after."""
    import threading

    import numpy as np
    import torch

    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.fleet import ArtifactStore, FitScheduler, TenantRegistry
    from hdbscan_tpu_torch.ops import cuda_build, cuda_forest, cuda_knn
    from hdbscan_tpu_torch.serve import ClusterModel, Predictor

    errors, launches = [], {}
    tenants = [f"t{i}" for i in range(FIT_JOB_TENANTS)]
    store = ArtifactStore(spool_dir=os.path.join(tmp, "spool_fit"))
    reg = TenantRegistry({t: paths[("exact", "seed2")[i % 2]] for i, t in enumerate(tenants)},
                         max_batch=256, lru_size=FIT_JOB_TENANTS, artifact_store=store)
    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=FIT_JOB_MIN_CL,
                           processing_units=FIT_JOB_ROWS)
    sched = FitScheduler(os.path.join(tmp, "jobs"), params=params,
                         publish=lambda tenant, path, model: reg.swap(tenant, path),
                         workers=FIT_JOB_WORKERS)
    q = novel_queries(rows["exact"], 64, SEED + 50)
    for t in tenants:
        reg.predict(t, q)
    recs = [CallRecorder(cuda_knn, "knn_kbest_panel", keep=4),
            CallRecorder(mst_device, "uf_scan", keep=4)]
    lat = {"without": [], "with": []}
    gens = {(t, w): [] for t in tenants for w in range(3)}
    errs, phase = [], ["without"]
    stop = threading.Event()

    def hammer(w):
        hrng = np.random.default_rng(w)
        while not stop.is_set():
            t = tenants[int(hrng.integers(len(tenants)))]
            t0 = time.perf_counter()
            try:
                out, info = reg.predict(t, q)
                lat[phase[0]].append(time.perf_counter() - t0)
                gens[(t, w)].append(info["generation"])
            except Exception as e:  # noqa: BLE001 — a request error is the failure
                errs.append(f"{t}: {type(e).__name__}: {e}")

    torch_sync()
    cuda_build.reset_launches()
    rng = np.random.default_rng(SEED + 51)
    with recs[0], recs[1]:
        threads = [threading.Thread(target=hammer, args=(w,), daemon=True) for w in range(3)]
        for th in threads:
            th.start()
        time.sleep(FIT_SERVICE_BASE_S)
        phase[0] = "with"
        t = time.perf_counter()
        jobs = [sched.submit(tn, rows[("exact", "seed2")[i % 2]][
            rng.choice(N_SKIN, FIT_JOB_ROWS, replace=False)], reason="drift")
            for _ in range(FIT_JOB_ROUNDS) for i, tn in enumerate(tenants)]
        poison = sched.submit("t0", np.array([["nope"] * 3] * 360))
        joined = sched.join(timeout=600)
        fits_s = time.perf_counter() - t
        stop.set()
        for th in threads:
            th.join(timeout=60)
        torch_sync()
        sched.close()
    launches["3q_fit_service"] = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    regress = [k for k, g in gens.items() if g != sorted(g)]
    states = [j.state for j in jobs]
    final = {t: reg.generation(t) for t in tenants}
    peak = torch.cuda.max_memory_allocated()
    wo, wi = latency_stats(lat["without"], 64), latency_stats(lat["with"], 64)
    print(f"3q 3q_fit_service ({card}): {len(jobs)} jobs of {FIT_JOB_ROWS} rows on "
          f"{FIT_JOB_WORKERS} workers in {fits_s:.3f} s (joined {joined}), states "
          f"{sorted(set(states))}, poison {poison.state} ({(poison.error or '')[:80]}); final "
          f"generations {final}; request errors {len(errs)} {errs[:3]}; regressions {regress}; "
          f"predict without fits {_lat_text(wo)}; beside fits {_lat_text(wi)}; "
          f"process peak allocated {peak} bytes; launches (B1 is segmin) "
          f"{launches['3q_fit_service']}")
    if (not joined or set(states) != {"published"} or poison.state != "failed" or errs
            or regress or any(g != 1 + FIT_JOB_ROUNDS for g in final.values())):
        errors.append(f"3q_fit_service: joined {joined}, states {states}, poison "
                      f"{poison.state}, errors {errs[:3]}, regressions {regress}, final {final}")
    for t in tenants:  # the served generation answers as the job that published it
        j = max((j for j in jobs if j.tenant == t), key=lambda j: j.generation or 0)
        got = reg.predict(t, q)[0][0]
        if not np.array_equal(got, Predictor(ClusterModel.load(j.path)).predict(q)[0]):
            errors.append(f"3q_fit_service: {t} answers other than {j.path}")
    errors += ingest_kernels_check("3q_fit_service", recs, ("knn_kbest_panel", "uf_scan"),
                                   phase="3q")
    # Eight rpforest tenants through an LRU of two: an evicted tenant's
    # tables go back to the allocator.
    rq = novel_queries(rows["forest"], 256, SEED + 52)
    want = Predictor(ClusterModel.load(paths["forest"]), backend="rpforest").predict(rq)
    freg = TenantRegistry({f"f{i}": paths["forest"] for i in range(8)}, backend="rpforest",
                          max_batch=256, lru_size=FLEET_LRU, artifact_store=store)
    b7 = CallRecorder(cuda_forest, "forest_rescan_topk", keep=4)
    torch_sync()
    cuda_build.reset_launches()
    base = torch.cuda.memory_allocated()
    held, same = [], True
    with b7:
        for i in range(8):
            out, _ = freg.predict(f"f{i}", rq)
            same &= all(np.array_equal(a, b) for a, b in zip(out, want))
            torch_sync()
            held.append(torch.cuda.memory_allocated() - base)
    launches["3q_fit_service_rpforest"] = {k: v for k, v in cuda_build.LAUNCHES.items() if v}
    print(f"3q 3q_fit_service rpforest tenants ({card}): allocated bytes above the start after "
          f"each of 8 tenants (LRU {FLEET_LRU}): {held}; answers equal the in-process "
          f"predictor: {same}; launches {launches['3q_fit_service_rpforest']}")
    if not same or held[-1] > 1.25 * max(held[1], 1) + (1 << 20):
        errors.append(f"3q_fit_service: rpforest tenants answer {same}, allocated {held}")
    errors += ingest_kernels_check("3q_fit_service rpforest", [b7], ("forest_rescan_topk",),
                                   phase="3q")
    return errors, launches


def fleet_phase(here, data, res, card) -> tuple[list[str], dict]:
    """Phase 3q, the fleet (module docstring): its four cells. Returns
    failure messages and each cell's launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hdbscan_fleet_")
    try:
        paths, rows = fleet_models(data, res, tmp)
        errors, launches = fleet_cells(here, paths, rows, card, tmp)
        e, fit_launches = fit_service_cell(paths, rows, card, tmp)
        errors += e
        launches.update(fit_launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"3q fleet phase: {time.perf_counter() - t_phase:.1f} s; {card}")
    return errors, launches


def rank_start(here, root, tag, argv, n_ranks, device):
    """Start ``argv`` as ``n_ranks`` rank processes of the port's command
    line on a local coordinator, rank r with ``--device device`` (or
    ``device[r]`` given one a rank; ranks naming one card share it, each
    with its own CUDA context) and ``--trace-out`` / ``--report`` under
    ``root``. Returns (processes, start time); :func:`rank_wait` ends them."""
    from hdbscan_tpu_torch.parallel.distributed import free_local_port, hermetic_child_env

    port = free_local_port()
    devs = [device] * n_ranks if isinstance(device, str) else list(device)
    env = hermetic_child_env(here, cpu=devs[0].startswith("cpu"))
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hdbscan_tpu_torch", *argv, f"out_dir={root}/{tag}",
         f"clusterName=127.0.0.1:{port},{r},{n_ranks}", "--device", devs[r],
         "--trace-out", f"{root}/{tag}.jsonl", "--report", f"{root}/{tag}.json"],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n_ranks)]
    return procs, t


def rank_wait(procs, t, timeout=300):
    """(wall s since ``t``, [(exit code, stdout, stderr)] in rank order) of
    :func:`rank_start`'s ranks; the whole set is killed past ``timeout``."""
    from hdbscan_tpu_torch.parallel.distributed import communicate_all

    outs = communicate_all(procs, timeout=timeout)
    return time.perf_counter() - t, [(p.returncode, so, se) for p, (so, se) in zip(procs, outs)]


def rank_check(here, root, tag, n_ranks, ranks, mode, backend) -> tuple[list[str], dict]:
    """The checks of one multi-process run: every rank exits 0, rank 0
    alone prints the result and names the global mesh and the ``backend``
    hand-overs on stderr, every rank's trace passes ``check_trace.py``
    (rank 0's with the report), the report's ``per_host`` holds every rank.
    Prints each rank's fit wall, launches and hand-overs (its trace's
    ``rank_summary``). Returns (errors, {rank: launches})."""
    errors, launches = [], {}
    for r, (rc, _, se) in enumerate(ranks):
        if rc != 0:
            errors.append(f"{tag} rank {r}: exit {rc}: {se[-2000:]}")
    if errors:
        return errors, launches
    first = ranks[0][1].splitlines()[0] if ranks[0][1] else ""
    mesh_line = next((ln for ln in ranks[0][2].splitlines() if "(global mesh)" in ln), "")
    print(f"3r {tag}: {first}")
    print(f"3r {tag} rank 0 stderr: {mesh_line}")
    if mode not in first:
        errors.append(f"{tag}: rank 0's stdout does not name the route {mode!r}: {first}")
    if f"{n_ranks} processes" not in mesh_line or f"{backend} hand-overs" not in mesh_line:
        errors.append(f"{tag}: rank 0 does not name {n_ranks} processes over {backend}: "
                      f"{mesh_line}")
    if any("hdbscan-tpu" in so for _, so, _ in ranks[1:]):
        errors.append(f"{tag}: a rank other than 0 printed the result")
    for r in range(n_ranks):
        trace = f"{root}/{tag}.{r}.jsonl"
        bad = validator(here, "check_trace.py", trace, *([f"{root}/{tag}.json"] if r == 0 else []))
        if bad:
            errors.append(f"{tag} rank {r}: check_trace.py failed: {bad}")
        with open(trace) as f:
            events = [json.loads(line) for line in f]
        summ = next((e for e in events if e["stage"] == "rank_summary"), None)
        fit = next((e["wall_s"] for e in events if e["stage"] == "fit"), None)
        if summ is None:
            errors.append(f"{tag} rank {r}: no rank_summary event")
            continue
        counts = {k.removeprefix("launches_"): v for k, v in summ.items()
                  if k.startswith("launches_")}
        moved = {k: (summ[f"handover_{k}_bytes"], summ[f"handover_{k}_calls"],
                     summ[f"handover_{k}_wall_s"]) for k in ("ring", "all_reduce", "gather")}
        print(f"3r {tag} rank {r}: fit wall {fit} s, {summ['shards']} shards, backend "
              f"{summ['backend']}; launches {counts}; hand-overs (bytes, calls, wall s) "
              f"{moved}")
        walls = {}
        for e in events:
            if e["stage"] not in ("fit", "ring_device_wall", "heartbeat", "rank_summary"):
                walls[e["stage"]] = walls.get(e["stage"], 0.0) + e.get("wall_s", 0.0)
        top = sorted(walls.items(), key=lambda kv: -kv[1])[:8]
        print(f"3r {tag} rank {r} stages (wall s): "
              f"{', '.join(f'{k} {v:.3f}' for k, v in top)}")
        launches[r] = {**counts, HANDOVER_KEY: moved}
        if summ["backend"] != backend:
            errors.append(f"{tag} rank {r}: backend {summ['backend']}, not {backend}")
    with open(f"{root}/{tag}.json") as f:
        rep = json.load(f)
    hosts = sorted(rep.get("per_host", {}))
    topo = rep.get("manifest", {}).get("topology", {})
    print(f"3r {tag} report: per_host {hosts}; topology process_count "
          f"{topo.get('process_count')}, device owners "
          f"{[d['process_index'] for d in topo.get('devices', [])]}")
    if hosts != [str(r) for r in range(n_ranks)] or topo.get("process_count") != n_ranks:
        errors.append(f"{tag}: the report's per_host or topology does not name every rank")
    return errors, launches


def rank_phase(here, data, card, legs=RANK_LEGS, timeout=300) -> tuple[list[str], dict]:
    """Phase 3r, multi-process fits (module docstring): each leg of
    ``legs`` (:data:`RANK_LEGS`: rank processes sharing ``cuda:0`` over
    gloo) against its twin: a one-process twin an earlier phase already
    ran (:data:`TWIN_FILES`) is not run again, and a twin of rank processes
    runs beside its leg. Returns failure messages and each rank's launches
    (``<leg>_rank<r>``)."""
    import shutil

    import numpy as np

    t_phase = time.perf_counter()
    root = os.path.join(here, ".torch_build", "ranks")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    errors, launches = [], {}
    try:
        for label, rows, flags, n_ranks, device, (twin_ranks, twin_device), kernels, mode, \
                backend in legs:
            # The Skin-sized legs share one file, named as 3p's (the output
            # files carry the input's name).
            path = os.path.join(root, "skin.tsv" if rows == N_SKIN else f"skin_{rows}.tsv")
            if not os.path.exists(path):
                np.savetxt(path, data[:rows], delimiter="\t", fmt="%d")
            argv = ["fit", f"file={path}", *flags]
            twin = f"{label}_twin"
            side = (rank_start(here, root, twin, argv, twin_ranks, twin_device)
                    if twin_ranks > 1 else None)
            wall, ranks = rank_wait(*rank_start(here, root, label, argv, n_ranks, device),
                                    timeout=timeout)
            shown = device if isinstance(device, str) else " / ".join(device)
            print(f"3r {label} ({card}): {n_ranks} ranks x --device {shown}, command wall "
                  f"{wall:.3f} s{' (its twin ranks beside it)' if side else ''}")
            e, got = rank_check(here, root, label, n_ranks, ranks, mode, backend)
            errors += e
            for r, counts in got.items():
                launches[f"{label}_rank{r}"] = counts
                missing = [k for k in kernels if not counts.get(k)]
                if missing:
                    errors.append(f"{label} rank {r}: kernels never launched: {missing}")
            key = (rows, tuple(flags), twin_device)
            if side is not None:
                twall, tranks = rank_wait(*side, timeout=timeout)
                print(f"3r {twin}: {twin_ranks} ranks x --device {twin_device}, command wall "
                      f"{twall:.3f} s (beside its leg)")
                errors += rank_check(here, root, twin, twin_ranks, tranks, mode, "gloo")[0]
                if os.path.isdir(f"{root}/{twin}"):
                    TWIN_FILES[key] = file_digests(f"{root}/{twin}")
            elif key in TWIN_FILES:
                print(f"3r {twin}: one process x --device {twin_device}: its files taken "
                      "from the earlier run of the same command")
            else:
                rc, out, err, twall, tl, _ = run_cli(
                    argv + [f"out_dir={root}/{twin}", "--device", twin_device], here, False)
                print(f"3r {twin}: one process x --device {twin_device}: exit {rc}, wall "
                      f"{twall:.3f} s; {out.splitlines()[0] if out else ''}; launches "
                      f"{ {k: v for k, v in (tl or {}).items() if v} }")
                if rc != 0:
                    errors.append(f"{twin}: exit {rc}: {err[-2000:]}")
                else:
                    TWIN_FILES[key] = file_digests(f"{root}/{twin}")
            same = (os.path.isdir(f"{root}/{label}") and key in TWIN_FILES
                    and file_digests(f"{root}/{label}") == TWIN_FILES[key]
                    and len(os.listdir(f"{root}/{label}")) == 5)
            print(f"3r {label}: files vs {twin} {'identical' if same else 'DIFFERENT'}")
            if not same:
                errors.append(f"{label}: the five files differ from {twin}'s")
        if all(leg[8] == "gloo" for leg in legs):
            print("3r NCCL between distinct cards: not exercised here (one card; ranks that "
                  "share a card take gloo by the backend rule; ``chip_smoke.py 3r4`` on four "
                  "cards runs it)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"3r multi-process phase: {time.perf_counter() - t_phase:.1f} s; {card}")
    return errors, launches


def add_launches(rows, phases) -> None:
    """Each kernel row's launches in the cells of each phase that ran it
    (``phases``: key -> {cell: launches}); the serving rows (``_predict``)
    take their kernel's launches in the streaming and fleet cells, and keep
    the 3m launches their phase set."""
    for row in rows:
        for key, cells in phases.items():
            name = (row["name"].removesuffix("_predict") if key in ("launches_3o", "launches_3q")
                    else row["name"])
            # A rank's cell carries its hand-overs beside its launches.
            hits = {cell: ({"launches": n, "handovers": got[HANDOVER_KEY]}
                           if HANDOVER_KEY in got else n)
                    for cell, got in cells.items() if (n := got.get(name))}
            if hits and key not in row:
                row[key] = hits


def torch_sync():
    import torch

    torch.cuda.synchronize()


def stream_phase(here, data, res, card) -> tuple[list[str], dict]:
    """Phase 3o, streaming ingest and incremental maintenance (module
    docstring): its three cells. Returns failure messages and each cell's
    launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hdbscan_stream_")
    try:
        errors, skin = stream_skin_cell(here, data, res, card, tmp)
        e, launches = stream_card_vs_cpu_cell(data, card, tmp)
        errors += e
        e, maintain = maintain_cell(here, data, card, tmp)
        errors += e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches["3o_stream_skin"] = skin["launches"]
    launches["3o_maintain"] = maintain.get("launches", {})
    print(f"3o streaming phase: {time.perf_counter() - t_phase:.1f} s; {card}")
    return errors, launches


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "hdbscan_tpu_torch")):
        return fail("hdbscan_tpu_torch/ is not beside chip_smoke.py")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardsticks' cdist at full f32
    sys.path.insert(0, here)
    from hdbscan_tpu_torch import HDBSCANParams
    from hdbscan_tpu_torch.core import mst_device
    from hdbscan_tpu_torch.models import exact
    from hdbscan_tpu_torch.ops import cuda_build, tiled
    from hdbscan_tpu_torch.utils.evaluation import adjusted_rand_index

    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    cuda_build.build_all()
    print(f"kernel build: {time.perf_counter() - t:.1f} s")
    if sys.argv[1:] == ["3r4"]:  # ``python3 chip_smoke.py 3r4``: 3r over four cards
        if torch.cuda.device_count() < 4:
            return fail(f"3r4 needs four cards, not {torch.cuda.device_count()}")
        data = np.random.default_rng(SEED).integers(0, 256, size=(N_SKIN, 3)).astype(np.float64)
        errors, _ = rank_phase(here, data, card, RANK_LEGS_4CARDS, timeout=150)
        print(card)
        return fail(f"the four-card multi-process phase failed: {errors}") if errors else 0
    only_3k = sys.argv[1:] == ["3k"]
    only_3l = sys.argv[1:] == ["3l"]
    only_3m = sys.argv[1:] == ["3m"]
    only_3n = sys.argv[1:] == ["3n"]
    only_3o = sys.argv[1:] == ["3o"]
    only_3p = sys.argv[1:] == ["3p"]
    only_3q = sys.argv[1:] == ["3q"]
    only_3r = sys.argv[1:] == ["3r"]

    only_phase = (only_3k or only_3l or only_3m or only_3n or only_3o or only_3p or only_3q
                  or only_3r)
    errors = [] if only_phase else (parity() + parity_forest() + parity_fold() + fold_fits() + parity_window()
              + parity_highd() + parity_panels() + parity_segmin() + parity_kbest()
              + parity_wide() + parity_rescan() + parity_window_guard() + parity_ufscan()
              + parity_leaf() + parity_metrics())
    if errors:
        return fail(f"kernel/plain mismatches: {errors}")

    # --- the slice: the exact fit at Skin scale ---------------------------
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, size=(N_SKIN, 3)).astype(np.float64)
    params = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE)
    # The card's fit equals the plain versions' fit on a subset (this also
    # warms PyTorch's own CUDA kernels before the timed fit).
    sub = data[rng.choice(N_SKIN, 4096, replace=False)]
    small = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50)
    same = fits_equal(exact.fit(sub, small), exact.fit(sub, small, device="cpu"))
    print(f"card fit vs CPU fit on 4096 points: {'identical' if same else 'DIFFERENT'}")
    if not same:
        return fail("the card's fit differs from the plain versions' fit")

    res, launches, ev, fit_wall = run_fit(data, params)
    mst = ev["boruvka_mst"][0]
    finalize_s = sum(e[0]["wall_s"] for s, e in ev.items() if s.startswith("tree_"))
    print(
        "fit walls (s): "
        f"core_distances {ev['core_distances'][0]['wall_s']}, "
        f"boruvka_rounds {mst['rounds_wall_s']}, "
        f"forest_events {ev['forest_events'][0]['wall_s']}, "
        f"fetch {ev['host_sync'][0]['wall_s']}, "
        f"host_finalize {finalize_s:.6f}, total {fit_wall:.3f}"
    )
    print(f"rounds {mst['rounds']}, round_syncs {mst['round_syncs']}, edges {mst['edges']}, "
          f"components per round {[e['components'] for e in ev['mst_round']]}")
    counts = np.bincount(res.labels)
    print(f"labels: {len(counts) - 1} clusters, histogram (label 0 = noise) "
          f"{dict((int(i), int(c)) for i, c in enumerate(counts) if c)}")
    print(f"launches on the fit: {launches}")
    msg = check_fit("exact", res, launches, ev, N_SKIN, EXACT_KERNELS)
    if msg:
        return fail(msg)
    if only_3k:  # ``python3 chip_smoke.py 3k``: phase 3 and 3k alone
        errors, _ = host_round_phase(here, data, res, card)
        print(card)
        return fail(f"the host-round routes failed: {errors}") if errors else 0
    if only_3l:  # ``python3 chip_smoke.py 3l``: phase 3 and 3l alone
        errors, _ = mr_variant_phase(card)
        print(card)
        return fail(f"the MR pipeline's variant cells failed: {errors}") if errors else 0
    if only_3m:  # ``python3 chip_smoke.py 3m``: phase 3 and 3m alone
        errors, _, serve_rows = serve_phase(here, data, res, None, card)
        print(card)
        print(json.dumps({"kernels": serve_rows}))
        return fail(f"the serving phase failed: {errors}") if errors else 0
    if only_3n:  # ``python3 chip_smoke.py 3n``: phase 3 and 3n alone
        errors, _, mesh_rows = mesh_phase(data, card)
        print(card)
        print(json.dumps({"kernels": mesh_rows}))
        return fail(f"the multi-GPU phase failed: {errors}") if errors else 0
    if only_3r:  # ``python3 chip_smoke.py 3r``: phase 3 and 3r alone
        errors, _ = rank_phase(here, data, card)
        print(card)
        return fail(f"the multi-process phase failed: {errors}") if errors else 0
    if only_3p:  # ``python3 chip_smoke.py 3p``: phase 3 and 3p alone
        errors, _ = obs_phase(here, data, card)
        print(card)
        return fail(f"the observability phase failed: {errors}") if errors else 0
    if only_3q:  # ``python3 chip_smoke.py 3q``: phase 3 and 3q alone
        from hdbscan_tpu_torch.ops import rpforest

        errors, fleet_launches = fleet_phase(here, data, res, card)
        forest = rpforest.build_forest(data, trees=FOREST["rpf_trees"],
                                       leaf_size=FOREST["rpf_leaf_size"], seed=SEED)
        rows = predict_times(data, None, forest, {
            "knn_kbest_panel": fleet_launches["3q_fleet_tenants"].get("knn_kbest_panel", 0),
            "forest_rescan_topk": fleet_launches["3q_fit_service_rpforest"].get(
                "forest_rescan_topk", 0)})
        add_launches(rows, {"launches_3q": fleet_launches})
        print(card)
        print(json.dumps({"kernels": rows}))
        return fail(f"the fleet phase failed: {errors}") if errors else 0
    if only_3o:  # ``python3 chip_smoke.py 3o``: phase 3 and 3o alone
        from hdbscan_tpu_torch.ops import rpforest

        errors, stream_launches = stream_phase(here, data, res, card)
        forest = rpforest.build_forest(data, trees=FOREST["rpf_trees"],
                                       leaf_size=FOREST["rpf_leaf_size"], seed=SEED)
        rows = predict_times(data, None, forest, {
            "knn_kbest_panel": stream_launches["3o_stream_skin"].get("knn_kbest_panel", 0),
            "forest_rescan_topk": stream_launches["3o_stream_card_vs_cpu_rpforest"].get(
                "forest_rescan_topk", 0)})
        add_launches(rows, {"launches_3o": stream_launches})
        print(card)
        print(json.dumps({"kernels": rows}))
        return fail(f"the streaming phase failed: {errors}") if errors else 0

    # --- 3b: the rp-forest tier on the same data --------------------------
    fparams = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE, **FOREST)
    fsmall = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=50, **FOREST)
    same = fits_equal(exact.fit(sub, fsmall), exact.fit(sub, fsmall, device="cpu"))
    print(f"rp-forest card fit vs CPU fit on 4096 points: {'identical' if same else 'DIFFERENT'}")
    if not same:
        return fail("the card's rp-forest fit differs from the plain versions' fit")
    fres, flaunches, fev, fwall = run_fit(data, fparams)
    report_forest_fit("3b skin rp-forest", data, fparams, fres, flaunches, fev, fwall,
                      res.core_distances, res.labels)
    msg = check_fit("3b skin rp-forest", fres, flaunches, fev, N_SKIN, FOREST_FIT_KERNELS)
    if msg:
        return fail(msg)

    # --- 3c: the tier where knn_index=auto picks it -----------------------
    from hdbscan_tpu_torch.core.knn import resolve_index_for

    blob = blobs(N_BLOBS, SEED)
    bparams = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=BLOBS_MIN_CL_SIZE,
                            knn_index="auto", knn_backend="fused")
    if resolve_index_for(bparams, N_BLOBS)[0] != "rpforest":
        return fail("knn_index=auto does not resolve to the forest at 1,048,576 points")
    bres, blaunches, bev, bwall = run_fit(blob, bparams)
    eres, elaunches, eev, ewall = run_fit(blob, HDBSCANParams(
        min_points=MIN_PTS, min_cluster_size=BLOBS_MIN_CL_SIZE, knn_index="exact"))
    print(f"3c blobs exact fit: total {ewall:.3f} s, core_distances "
          f"{eev['core_distances'][0]['wall_s']}, boruvka_rounds "
          f"{eev['boruvka_mst'][0]['rounds_wall_s']} ({eev['boruvka_mst'][0]['rounds']} rounds)")
    report_forest_fit("3c blobs rp-forest (auto)", blob, bparams, bres, blaunches, bev, bwall,
                      eres.core_distances, eres.labels)
    msg = check_fit("3c blobs rp-forest", bres, blaunches, bev, N_BLOBS, FOREST_FIT_KERNELS)
    if msg:
        return fail(msg)

    # --- 3d: the MR pipeline in boundary mode at the benchmark's size ----
    from hdbscan_tpu_torch.utils.datasets import make_gauss

    errors = mr_card_vs_cpu()
    if errors:
        return fail(f"the card's MR fits differ from the CPU fits: {errors}")
    mdata, truth = make_gauss(N_MR, **MR_DATA)
    mcs = max(64, N_MR // 200)
    mparams = HDBSCANParams(**MR_PARAMS, min_cluster_size=mcs, **BOUND05)
    from hdbscan_tpu_torch.models import _finalize

    with WindowRecorder() as recorder, CallRecorder(_finalize, "finalize_clustering") as mr_pools:
        mres, mlaunches, mev, mwall, mpeak = run_mr(mdata, mparams)
    report_mr("3d boundary", mres, mlaunches, mev, mwall, mpeak)
    xres, _, xev, xwall = run_fit(mdata, HDBSCANParams(
        min_points=MR_PARAMS["min_points"], min_cluster_size=mcs, knn_index="exact"))
    ari_truth = adjusted_rand_index(mres.labels, truth)
    ari_exact = adjusted_rand_index(mres.labels, xres.labels)
    xmst = xev["boruvka_mst"][0]
    print(f"3d exact fit of the same data: {xwall:.3f} s (core_distances "
          f"{xev['core_distances'][0]['wall_s']}, boruvka_rounds {xmst['rounds_wall_s']} in "
          f"{xmst['rounds']} rounds), ARI vs truth {adjusted_rand_index(xres.labels, truth):.6f}")
    print(f"3d boundary ARI vs truth {ari_truth:.6f}, vs the exact fit {ari_exact:.6f}")
    if mlaunches["knn_window"] == 0:
        return fail("3d: the B4 window kernel never launched in the boundary fit")
    if not np.all(np.isfinite(mres.core_distances)):
        return fail("3d: non-finite core distances")
    if min(ari_truth, ari_exact) < 0.99:
        return fail(f"3d: ARI below 0.99 (truth {ari_truth}, exact {ari_exact})")

    # --- 3e: the default mode at 200,000 points ---------------------------
    fdata, ftruth = make_gauss(N_FULLQ, **MR_DATA)
    fq = HDBSCANParams(**MR_PARAMS, min_cluster_size=max(64, N_FULLQ // 200))
    qres, qlaunches, qev, qwall, qpeak = run_mr(fdata, fq)
    report_mr("3e default", qres, qlaunches, qev, qwall, qpeak)
    print(f"3e default ARI vs truth {adjusted_rand_index(qres.labels, ftruth):.6f}")
    if not np.all(np.isfinite(qres.core_distances)):
        return fail("3e: non-finite core distances")
    missing = [k for k in ("knn_kbest", "segmin") if qlaunches[k] == 0]
    if missing:
        return fail(f"3e: kernels of the path never launched: {missing}")

    # --- 3f: the high-dimension exact fit, B3 in the core distances -------
    errors = highd_card_vs_cpu()
    if errors:
        return fail(f"the card's high-d fit differs from the CPU fit: {errors}")
    hdata, htruth = highd_data(28)
    hres, hlaunches, hev, hwall = run_fit(hdata, HDBSCANParams(**HIGHD_PARAMS))
    print(f"3f high-d {N_HIGHD} x 28 fit walls (s): {fit_walls(hev, hwall)}")
    print(f"3f high-d ARI vs truth {adjusted_rand_index(hres.labels, htruth):.6f}, "
          f"{len(np.unique(hres.labels)) - 1} clusters")
    print(f"3f high-d launches on the fit: {hlaunches}")
    msg = check_fit("3f high-d", hres, hlaunches, hev, N_HIGHD, HIGHD_KERNELS)
    if msg:
        return fail(msg)
    abs28, rel28 = oracle_core_err(hdata, hres.core_distances, HIGHD_PARAMS["min_points"])
    print(f"3f core distances vs a float64 oracle on 512 rows, d=28: max abs {abs28:.3e}, "
          f"max rel {rel28:.3e}")
    x90, _ = highd_data(90)
    cuda_build.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    core90, _ = tiled.knn_core_distances(x90, HIGHD_PARAMS["min_points"], fetch_knn=False)
    wall90 = time.perf_counter() - t
    abs90, rel90 = oracle_core_err(x90, core90, HIGHD_PARAMS["min_points"])
    print(f"3f B3 core distances alone at {N_HIGHD} x 90: {wall90:.3f} s "
          f"(B3 launches {cuda_build.LAUNCHES['knn_smallest']}); vs a float64 oracle on 512 "
          f"rows: max abs {abs90:.3e}, max rel {rel90:.3e}")
    if cuda_build.LAUNCHES["knn_smallest"] != 1 or not np.all(np.isfinite(core90)):
        return fail("3f: the d=90 core distances did not run B3 once or are not finite")
    del x90, core90

    # --- K3 on the fits' own pools ----------------------------------------
    errors = []
    fit_pools = [("Skin exact fit MST", N_SKIN, *res.mst),
                 ("3c 1M x 8 exact fit MST", N_BLOBS, *eres.mst),
                 ("3f 500k x 28 fit MST", N_HIGHD, *hres.mst)]
    fit_pools += [("3d MR host pool (cycle and duplicate edges)", int(a[0]), a[1], a[2], a[3])
                  for a, _ in mr_pools.calls]
    for label, pn, u, v, w in fit_pools:
        order = np.lexsort((np.asarray(v), np.asarray(u), np.asarray(w)))  # the scan's order
        merges = uf_pairs_check(label, np.asarray(u)[order], np.asarray(v)[order], pn, errors)
        print(f"K3 pool {label}: {len(order)} edges, {merges} merges")
    if errors or not mr_pools.calls:
        return fail(f"K3 differs from its plain version on the fits' pools: {errors}"
                    if errors else "3d: no MR pool recorded for the K3 check")

    # --- 3g: the sharded exact fit, B9 and the ring's rectangular B2 ------
    mesh = shard_mesh()
    errors = sharded_card_vs_cpu(mesh)
    if errors:
        return fail(f"the card's sharded fit differs from the CPU's: {errors}")
    sparams = HDBSCANParams(min_points=MIN_PTS, min_cluster_size=MIN_CL_SIZE, **SHARDED)
    sres, slaunches, sev, swall = run_fit(data, sparams, mesh=mesh)
    devices = [str(dev) for dev in mesh.devices]
    print(f"3g sharded fit on {devices}: walls (s): {fit_walls(sev, swall)}")
    print(f"3g ring_knn_scan {sev['ring_knn_scan'][0]['wall_s']} s, shard_mst_device "
          f"{sev['shard_mst_device'][0]['wall_s']} s, host syncs {len(sev['host_sync'])}")
    print(f"3g launches on the fit: {slaunches}")
    msg = check_fit("3g sharded", sres, slaunches, sev, N_SKIN, SHARDED_KERNELS)
    if msg:
        return fail(msg)
    rounds = sev["boruvka_mst"][0]["rounds"]
    same = (fits_equal(sres, res) and trees_equal(sres.tree, res.tree))
    print(f"3g sharded fit vs the single-device fit of the same data: "
          f"{'identical' if same else 'DIFFERENT'}; ring B2 launches "
          f"{slaunches['knn_kbest_panel']} (expect {N_SHARDS ** 2}), B9 launches "
          f"{slaunches['segmin_panel']} (expect {N_SHARDS ** 2} x {rounds} rounds)")
    if not same:
        return fail("3g: the sharded fit differs from the single-device fit")
    if (len(sev["host_sync"]) != 1 or slaunches["knn_kbest_panel"] != N_SHARDS ** 2
            or slaunches["segmin_panel"] != N_SHARDS ** 2 * rounds
            or slaunches["knn_kbest"] or slaunches["segmin"]):
        return fail(f"3g: unexpected host syncs or launches {slaunches}")

    # --- 3h: past k or d = 128, every kernel's wide mode ------------------
    wlaunches = {}
    errors, wide_rows = wide_phase(wlaunches)
    if errors:
        return fail(f"the wide fits failed: {errors}")

    # --- 3i: cosine and pearson on the card ------------------------------
    errors, metric_rows = metric_phase(data, hdata, fdata, mesh)
    if errors:
        return fail(f"the cosine and pearson cells failed: {errors}")

    # --- 3j: the command line's three routes ------------------------------
    errors = cli_phase(here, data, card)
    if errors:
        return fail(f"the command line failed: {errors}")

    # --- 3k: the host-round routes, dedup and Random Blocks --------------
    errors, host_launches = host_round_phase(here, data, res, card)
    if errors:
        return fail(f"the host-round routes failed: {errors}")

    # --- 3l: the rest of the MR pipeline ----------------------------------
    errors, mr_launches = mr_variant_phase(card)
    if errors:
        return fail(f"the MR pipeline's variant cells failed: {errors}")

    # --- 3m: serving, model artifacts, the server and the CLI -----------
    errors, serve_launches, serve_rows = serve_phase(here, data, res, fres, card)
    if errors:
        return fail(f"the serving phase failed: {errors}")

    # --- 3n: multi-GPU fits from one process -----------------------------
    errors, mesh_launches, mesh_rows = mesh_phase(data, card, fres, qres)
    if errors:
        return fail(f"the multi-GPU phase failed: {errors}")

    # --- 3o: streaming ingest and incremental maintenance -----------------
    errors, stream_launches = stream_phase(here, data, res, card)
    if errors:
        return fail(f"the streaming phase failed: {errors}")

    # --- 3p: the observability layer on the card --------------------------
    errors, obs_launches = obs_phase(here, data, card)
    if errors:
        return fail(f"the observability phase failed: {errors}")

    # --- 3q: the fleet on the card ----------------------------------------
    errors, fleet_launches = fleet_phase(here, data, res, card)
    if errors:
        return fail(f"the fleet phase failed: {errors}")

    # --- 3r: multi-process fits, ranks sharing the card ------------------
    errors, rank_launches = rank_phase(here, data, card)
    if errors:
        return fail(f"the multi-process phase failed: {errors}")

    # --- kernel times at the fit's shapes ---------------------------------
    n, d, k = N_SKIN, 3, MIN_PTS - 1
    form = tiled.scan_form(n, d, "euclidean", 1024, 8192)
    x = torch.as_tensor(data.astype(np.float32), device="cuda")
    core = torch.as_tensor(res.core_distances.astype(np.float32), device="cuda")
    comp = torch.arange(n, dtype=torch.int32, device="cuda")  # round 1
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    rows = []

    rows.append(kbest_metric_row("knn_kbest", data, k, launches, "euclidean"))
    rows.append(kbest_3c_row(blob, elaunches))

    rows.append(segmin_row("segmin", x, core, comp, valid, form, launches))
    first, last, replay = tile_shares(data, res.core_distances, form)
    print(f"segmin single-component (1024-row x 512-column) tiles at the skin shape: round 1 "
          f"{first:.6f}, last round {last:.6f} ({replay} rounds replayed)")
    # B1 at one 3f round: the 3f fit's Morton-free input order, its cores,
    # round-1 components, the dot form; the plain version on 4,096 rows.
    hx = torch.as_tensor(hdata.astype(np.float32), device="cuda")
    hn = len(hdata)
    rows.append(segmin_row(
        "segmin_3f", hx, torch.as_tensor(hres.core_distances.astype(np.float32), device="cuda"),
        torch.arange(hn, dtype=torch.int32, device="cuda"),
        torch.ones(hn, dtype=torch.bool, device="cuda"),
        tiled.scan_form(hn, 28, "euclidean", 1024, 8192), hlaunches, plain_rows=4096,
        kernel="segmin"))
    del hx

    u, v, w = res.mst
    order = np.lexsort((v, u, w))  # the (w, u, v) order the fit scans in
    eu = torch.as_tensor(u[order].astype(np.int32), device="cuda")
    evv = torch.as_tensor(v[order].astype(np.int32), device="cuda")
    uf_ms = cuda_ms(lambda: mst_device.uf_scan(eu, evv, n), 3)
    uf_plain = host_ms(lambda: mst_device.uf_scan_plain(eu, evv, n))
    ra, rb = mst_device.uf_scan(eu, evv, n)
    qa, qb = mst_device.uf_scan_plain(eu, evv, n)
    uf_err = 0.0 if torch.equal(ra, qa) and torch.equal(rb, qb) else float("inf")
    m = len(u)
    b, by = bound_ms(m * 4 * 4, 0.0)  # read u, v; write ra, rb
    prof = torch.zeros(len(mst_device.UF_PROF_FIELDS), dtype=torch.int64, device="cuda")
    mst_device.uf_scan_launch(eu, evv, n, prof=prof)
    prof = dict(zip(mst_device.UF_PROF_FIELDS, prof.tolist()))
    cycles = sum(prof[f] for f in ("find_cycles", "compact_cycles", "replay_cycles",
                                   "apply_cycles"))
    shfl_ms, lds_ms = uf_round_trip_ms(0), uf_round_trip_ms(1)
    chain_lds = prof["replay_groups"] + 2 * prof["replay_find_rounds"]
    rows.append(dict(
        name="uf_scan", route="cuda", source="hdbscan_tpu_torch/csrc/uf_scan.cu",
        replaces="hdbscan_tpu/core/mst_device.py:177 (lax.scan, not a Pallas kernel)",
        launches=launches["uf_scan"], max_abs_err=uf_err, ms=uf_ms, plain_ms=uf_plain,
        bound_ms=b, bound_by=by, library_ms=None,
        library_note="none: no PyTorch call runs a sequential union-find over an edge list",
        # The replay's dependent chain at this run's round trips: a
        # shared-memory load a group and two a find round, a shuffle a
        # shuffle round.
        latency_floor_ms=chain_lds * lds_ms + prof["replay_shuffle_rounds"] * shfl_ms,
        shuffle_round_trip_ms=shfl_ms, shared_load_round_trip_ms=lds_ms,
        replay_shared_loads=chain_lds, replay_shuffle_rounds=prof["replay_shuffle_rounds"],
        replay_steps=prof["replay_steps"],
        phase_shares={f: prof[f] / max(1, cycles) for f in (
            "find_cycles", "compact_cycles", "replay_cycles", "apply_cycles")},
        hops_per_find=prof["hops"] / max(1, prof["finds"]),
        device_ms=device_ms(lambda: mst_device.uf_scan(eu, evv, n), "uf_scan"),
        max_find_rounds=prof["max_find_rounds"], batches=prof["batches"],
    ))
    rows += forest_times(data, fres, flaunches)
    rows.append(window_time(recorder.main_chunk(mev), mlaunches))
    rows += highd_times(hdata, hlaunches)
    rows += panel_times(data, sres, slaunches, mesh)
    rows += wide_rows
    rows += metric_rows
    rows += serve_rows
    rows += mesh_rows
    bad = [r["name"] for r in rows if r["max_abs_err"] != 0.0]
    if bad:
        return fail(f"kernels disagree with their plain versions at the fit's shapes: {bad}")
    add_launches(rows, {"launches_3k": host_launches, "launches_3l": mr_launches,
                        "launches_3m": serve_launches, "launches_3n": mesh_launches,
                        "launches_3o": stream_launches, "launches_3p": obs_launches,
                        "launches_3q": fleet_launches, "launches_3r": rank_launches})

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
