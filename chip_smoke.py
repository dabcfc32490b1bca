#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and hold every CUDA
kernel against its plain PyTorch version.

Run from the root of the checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (``$CUDA_HOME``, default ``/usr/local/cuda``), builds
the kernels from ``src/repro_torch/kernels/csrc`` into ``build/kernels/``,
and never falls back: without a card, or outside a checkout, it exits
non-zero and prints no result. Phases, one line each:

1. device — the card's name, count, and ``nvidia-smi`` name and power limit;
2. build — nvcc's seconds and its ``-Xptxas -v`` register/spill lines;
   for the tensor-core landmark-summary kernel, per route (bf16, f32) and
   head dim, and for d1's tensor-core moments kernel, per load width:
   registers, static shared memory, spills, and the HGMMA (wgmma)
   instructions that ``cuobjdump -sass`` counts in it
   (``wgmma.mma_async`` in its PTX where the toolkit has no
   ``cuobjdump``) — none is a failure; for the fused IVF probe kernel, per
   padded row width, for the top-k scan kernel, per tile variant and
   measure, and for the Lloyd kernel, per register row width, its
   registers, static shared memory and spills;
3. kernels — each kernel against its plain version on the card, at the
   main-path shapes, at ragged shapes, on duplicated rows and (the top-k
   scan) at the paper tables' widest representation, 100 landmarks, all
   three measures; the top-k kernels bitwise (values and ids), or the
   run fails; d1 on both routes, the tensor-core route bitwise the f32
   route, also at 128 landmarks (the cluster kernel) and at the guard's
   limits (|v| = 8: half stars at P = 65,535, integers at P = 262,140),
   and off the guard (1.1-star steps; half stars at P = 65,536) the f32
   route's result;
4. main path — MovieLens-1M-shaped synthetic ratings (seed 0), fold 0:
   fit on all users but the last 64, predict the test pairs, top-10 for
   256 users, fold in the last 64 users and predict theirs; run (a) with
   the kernels and (b) with the plain d1 and the streaming graph, and
   compared; d1's result by route for each call of (a) (each must be the
   tensor-core route's), and (c) (a) again with d1 on its f32 route, every
   output bitwise (a)'s;
5. serve CLI — ``repro_torch.launch.serve`` at U=6040, P=3952, two waves;
6. times — each kernel and its plain version (CUDA events, which include
   the host's launch cost), the kernel's own device time (profiler), its
   launches on its path and its bound (d1's tensor-core route and the
   fused IVF probe count every kernel of their call: the workspace memset,
   planes, moments and finalize; the order, then the probe); d1 as two
   rows, the tensor-core route and the f32 route forced, each also at the
   fold-in shape; the fused
   probe again at the lifecycle's batch sizes (64 and 256 queries), with
   the groups of the graph build's call (queries a block, union cells,
   rows staged against rows probed); kernel 4 as the whole ``kmeans()``
   call (one launch) for each measure at the IVF shape and, cosine, at the
   lifecycle's capacity bucket, beside the assignment alone and
   ``build_index``; a profiler breakdown of one fit →
   fold-in → predict (device time by kernel, idle share); wall times of
   fit, fold-in and a 256-pair predict, and peak device memory.

The IVF retrieval slice adds, each with its own time:

7a. IVF kernels — the Lloyd kernel (the assignment alone, and a whole
    k-means: 0, 1 and 8 steps at the IVF shape, (1001, 13, 64), (37, 300, 33), (9, 1, 1) and (300, 7,
    25), so every register width, the lifecycle's capacity bucket with
    n_valid < U, and with an empty cell; two launches bitwise equal), the
    fused IVF probe and the
    gathered-candidate scorer against their plain versions, bitwise, at the
    IVF path's shapes (the index over the fitted ML-1M representation:
    C=77 cells, cap=104, nprobe=19, k=13) and on edge cases (empty cells,
    k above the live candidates, self ids, probe masks, bf16 and int8
    payloads, C not a multiple of 8, all three measures), and at a 64-row
    batch and on the graph build's queries shuffled (whose lists must be
    the unshuffled ones moved);
7b. IVF path — the same data: ``fit(..., backend="ivf")`` at the default
    nprobe (recall@13 against the kernel graph), at nprobe == C (equal to
    the streaming backend under the tie rule), a 64-user ivf fold-in, and
    ``search(scorer="kernel")`` against ``scorer="fused"``; the index
    that ``fit`` built and the one built again from the same seed bitwise
    equal (centroids, lists, rows, fill); kernels 4–6 must launch, and
    every d1 call must keep the tensor-core route's result;
7c. lifecycle CLI — ``serve --lifecycle --retrieval ivf --early-exit``,
    once at smoke size (a refresh fires, gen 1 swaps in oracle-exact, the
    geometries stay within the buckets, mean recall >= 0.95) and once at
    full width (U=6040, P=3952, 64 arrivals and a 64-row fold-in batch per
    wave, 8 waves); every kernel must launch in each run, and every d1
    call must keep the tensor-core route's result.

The LM slice adds, each with its own time:

8a. landmark summary kernels — both routes (bf16 inputs on the tensor-core
    loop as they are, f32 inputs split into bf16 terms first and run
    through the same loop) against the plain version (dense f32 softmax) at
    the reference tests' shapes (n, S, D) = (64, 1024, 64),
    (128, 2048, 128), (32, 512, 256), a ragged (16, 777, 32), ragged S and
    n with P > 1 at D = 128 and 256, S below one key tile, phase 15's
    DeepSeek-MoE-16B shape (32 problems, B=2 × 16 kv heads, of n = 512
    against S = 4096, D = 128, G = 1), and the
    SmolLM-360M landmark shape: 10 problems (B=2 × 5 kv heads) of
    G·n = 1536 landmark queries against S = 4096, D = 64; rtol=1e-4,
    atol=1e-5 (the reference's kernel-vs-oracle tolerance); and the f32
    route's split pass bitwise against the same rounding in torch there;
8b. landmark-attention forward — SmolLM-360M at full width (32 layers,
    random weights from seed 0), ``attn_backend="landmark"``, B = 2,
    S = 4096, tokens ``lm_batch(0, 0, 2, 4096, 49152)``: once through the
    kernel (which must launch 32 times, one per layer, all on the
    tensor-core route) and once with the plain B̃V; logits within 5% of
    the largest logit (bf16), both CE losses printed; then the same forward
    in f32 with the depth cut to 2 layers, through the f32_split route (2
    launches, 6 split passes) and the plain B̃V, held to the same bounds;
8c. LM serve CLI — ``serve --workload lm --arch smollm-360m`` with the
    exact KV cache and with ``--landmark``, full width; and one exact
    decode step's logits against ``lm_forward``'s last position within
    0.15, the reference's bf16 bound.

The engine slice adds:

9.  engine CLI — ``serve --workload cf --engine``, once ``--smoke`` and once
    at full width (U=6040, P=3952, 128-row batches, 64-row folds, 8 s of
    open-loop load, ``--retrieval ivf --early-exit``) with ``--trace-dir``,
    ``--metrics-json`` and ``--torch-profile`` under ``build/phase9/``:
    each run's bitwise-vs-solo audit must re-run N > 0 requests with 0
    mismatches, with no non-finite prediction, at least one fold, the read
    geometries within |batch shapes| x |capacities|, every d1 call on the
    tensor-core route; at full width also d1, the fold-in scan and kernels
    4-6 launched, the exports through ``benchmarks/check_obs.py``
    (read/fold overlap required), and, in the profiler trace of the load
    window, the fold lane's d1 and scan kernels on a stream no read batch
    ran on, launched by the fold lane's thread. Prints sustained QPS, read
    p50/p95/p99, shed and pad fractions, fold p50/p99 and the device's
    busy and idle share of the load window; the kernel table gains each
    row's launches in the full run (``launches_engine``).

The mutation slice adds:

10. mutation — at the main-path fit (users 0..5975, MODEL), for all three
    d2 measures, after an 8-user update (no tombstone) and an 8-user
    removal: the repair rescan on the scan kernel (live rows gathered,
    top-(k+1), ids mapped back, self dropped) bitwise the same pipeline
    with the kernel's plain version, and within the tie rule of the
    streaming rescan (euclidean at B3's 2e-3); the drop-row scatters with
    ineffective ids; the IVF-backed repair at partial probe (the gathered
    scorer) bitwise the plain scorer's lists; then the full-width oracle: 8 updates (one a landmark
    user) and 8 removals drained, against the port's own kernel build over
    the mutated matrix with the frozen basis (ratings and representation
    bitwise, the graph under the tie rule, the weights differing in any bit
    counted), and again after ``compact_tombstones`` over the survivors, no
    live row citing a dead one; the device time of a drain of 8 dirty
    rows. Then ``serve --engine --mutations``, ``--smoke`` and at full
    width (obs exports and a profiler capture under ``build/phase10/``):
    audit N > 0 with 0 mismatches, no non-finite prediction, at least one
    update and one removal, the pre-compaction bar, repair rescans on the
    scan kernel, the smoke's compacting swap, and at full width every
    write-lane kernel on a stream no read batch ran on. Prints QPS, read
    p50/p95/p99, write-lane p50/p99 per kind, mutated and repaired rows
    and the tombstone fraction; the kernel table gains each row's launches
    in the full run (``launches_mutations``).

The paper-comparison slice adds:

11. paper comparison — (a) each MF baseline (RSVD, IRSVD, PMF, SVD++), one
    epoch at the ML-1M fold-0 shape, on the card and on the CPU from the
    same initial parameters and permutation: the largest parameter
    difference and the MAE difference, held to ``MF_PARAM_ATOL`` and
    ``MF_MAE_ATOL``; (b) one BPMF Gibbs sweep there, card against CPU on
    the same draws, held to ``BPMF_ATOL``; (c) Table 15
    (``tools/paper_tables_torch.py::tab15_comparative``) on the card, every
    row (algorithm, MAE, seconds, ×-slower than landmarks), held to the
    reference's bars (landmark MAE < 1.1, every other row < 1.2, landmark
    within 0.02 of cosine kNN), d1 and the d2 scan launched; (d) compact
    serving: the main-path fit's uint16/bf16 graph read against the
    widened graph within 2e-2 (the uint16 gather bitwise), then ``serve
    --compact`` at ML-1M width (stored compact) and ``serve --lifecycle
    --retrieval ivf --smoke --compact-serving`` (a compacted wave, an
    oracle-exact swap), with d1, the fold-in scan, the Lloyd kernel and
    the fused probe launched. The kernel table gains each row's launches
    in (c) and (d) (``launches_paper``).

The mesh slice adds:

12. sharded lifecycle — ``serve --workload cf --lifecycle --mesh`` on the
    card, every shard a block of its own on CUDA: once at full width
    (``--mesh pod=2,data=2``, U=6040, P=3952, 8 waves of 64 arrivals, the
    stream of 7c, ``--retrieval ivf --early-exit``) and once as the
    reference's smoke (``--smoke --mesh pod=2,data=4``, U=128, P=64, 6
    waves of 32), both under ``build/phase12/``. Each run's predictions
    equal the single-device shadow's bit for bit in every wave, no fold-in
    tensor has S·C rows, the checkpoint holds ``row_shards`` = S, every
    state block is on the card; on the mesh path alone (the shadow's and
    the checks' launches left out) kernels 1-2 launch once a shard a fit,
    3 and 6 (the back-patch) once a shard a fold-in batch, and 4-5 in the
    full run; the smoke fires a distributed refresh whose
    artifact is the one-device fit's (oracle-exact). Then ``search_sharded``
    at full probe on the main path's representation over the 4-shard mesh,
    bitwise ``search`` on one device. Prints each run's wall time per wave
    on the mesh path and beside it, and peak device memory; the kernel
    table gains each row's mesh-path launches in the two runs
    (``launches_mesh``). 7a's wide-row line holds kernels 2-6 at n = 100,
    104, 105, 128 and 256 bitwise their plain versions (past 104 their
    wide routes) and times them at n = 100 and 128 beside their bounds
    (the kernel rows' ``n=100 ms`` and ``n=128 ms``); 7a's back-patch line
    gives kernel 6's shared form its device time from a profiler trace
    (``kernel_device_ms``) beside its events time (row 6's
    ``shared_form``).

The sharded engine slice adds:

13. engine on a mesh — first ``update_ratings``' back-patch block on the
    card (the main path's fit in the 8192-row bucket, 8, 16 and 64
    updated users): one launch of kernel 6's shared form, bitwise
    ``ref.gathered_sims``. Then ``serve --workload cf --engine --mesh``:
    at full width on 4 shards (``pod=2,data=2``, phase 9's settings with
    ``--retrieval ivf --early-exit``, and phase 10's with
    ``--mutations``; the load window cut to 4 s, a profiler capture of
    it) and the 8-shard smoke with ``--mutations`` (``pod=2,data=4``,
    whose compacting refresh fires), under ``build/phase13/``. Each run:
    every shard block on the card, the router's check with 0 offenders,
    routed reads bitwise the one-device backend's at every warm batch
    shape, the audit N > 0 with 0 mismatches, every d1 call on the
    tensor-core route; on the mesh path alone (the router checks' and
    the one-device shadow's launches left out) kernel 3 once a shard a
    fold batch, kernels 1 and 6 once a fold batch and an update, kernels
    4-5 with the sidecar; with ``--mutations`` a sample of up to 256 live
    users' pairs and top-N bitwise a one-device ``MutableLocalBackend``
    fed the same writes in the same order, before the compaction and
    after it. Prints QPS, read p50/p95/p99, the shed fraction, fold
    p50/p99, write p50/p99 per kind, repaired rows, the device's busy and
    idle share of the load window and peak memory; the kernel table gains
    each row's mesh-path launches in the three runs
    (``launches_engine_mesh``).

The any-landmark-count slice adds:

14. n = 128 landmarks, the width of the reference registry's ``web_fit``
    cell, ``LandmarkSpec(128, popularity, cosine, cosine, k=13)``: (a)
    the main path at the ML-1M shape (fit → fold-in of 64 → 256-pair
    predict and top-N), kernels 1-3 launched and each result on the path
    bitwise its plain version on the path's inputs (the representation,
    the fit's graph, the fold-in rows' lists); (b) ``build_index``, a
    search at partial probe through ``scorer="kernel"`` and through the
    fused probe, and one bucketed fold-in whose back-patch runs kernel
    6's shared form: kernels 4-6 launched (kernel 6 in both forms, by
    tally) and each bitwise its plain version on those inputs; (c) fit →
    fold-in at ``web_fit``'s P = 65,536 items and n = 128, U cut from
    1,048,576 to 32,768 users (dense f32 ratings of all users take 275
    GB) made on the card from a seeded generator in 4096-row blocks:
    every d1 call on the tensor-core route with its result kept; the cut,
    fit and fold-in seconds and peak memory printed. The kernel table
    gains each row's launches in (a) and (b) (``launches_wide``).

The MoE slice adds:

15. MoE serving — (a) ``serve --workload lm --arch deepseek-moe-16b``,
    exact KV and ``--landmark``, at full width and depth (28 layers, 64
    routed + 2 shared experts, top 6, bf16, random weights from seed 0):
    the three lines, ms/token beside the exact decode floor (every weight
    read once at 3.35 TB/s: GShard's single-token decode groups run the
    expert products over all 64 experts), peak memory; (b) its landmark
    forward, B = 2, S = 4096, through kernel 7 (28 launches, all on the
    tensor-core route, at P = 32, n = 512, D = 128) and through the plain
    B̃V, the kernel forward on the plain one's routing: logits within 5%
    of the largest, router logits within 5% of the largest and every
    flipped expert a near-tie (relative probability gap within 2^-3, the
    gap of ``layers.route_flips``), CE near ln V, a profile
    (busy/idle, top kernels) and the MoE FFN's share of device time (its
    calls inside a ``record_function`` range); (c) one exact decode step
    after an 8-token prefill against the forward's last position:
    correlation > 0.8 at the config's capacity (the reference's check),
    and within 0.15 at a capacity where nothing drops, the step routed as
    the forward routed that token under (b)'s two router checks;
    ``moe_ffn_ragged`` against
    ``moe_ffn`` at ample capacity on layer 0's experts (the same routing,
    outputs within (K + 2)·2^-8 of the largest), with both timed on a
    group of 512 tokens and at a decode step's 4 tokens; (d)
    ``dbrx-132b`` at full width with the depth cut from 40 to 2 layers
    (263 GB of bf16 weights at full depth): the landmark forward (kernel 7
    at G = 6: 2 launches), the decode checks and the ragged check. The
    kernel table gains each row's launches in (a), (b) and (d)
    (``launches_moe``), and row 7 its time, device time, bound, plain
    time and bf16 SDPA time at the DeepSeek shape (``moe_*``).

The training slice adds:

16. LM training — (a) kernel 7's backward (``landmark_summary_bwd``, two
    launches a call) against its plain version with TF32 off, within
    ``BWD_REL`` of max |plain| per gradient, two launches bitwise equal:
    at the training shape (P = 8 · 5, n = 1536, S = 4096, D = 64, bf16 and
    f32 inputs), DeepSeek's and DBRX's phase-15 shapes, D = 32 and 256, a
    ragged S (777) and an n off the 64-row query tile; the autograd
    ``LandmarkSummary`` (forward kernel, backward kernel) against
    ``torch.autograd`` through the plain f32 forward; (b) SmolLM-360M at
    full width and depth trained through ``launch/steps.py::build_cell``
    and ``train/trainer.py::train_loop`` (train_4k's batch of 256 cut to
    ``TRAIN_BATCH``; AdamW, remat) for ``TRAIN_STEPS`` steps with full and
    with landmark attention from seed-0 weights and ``lm_batch`` batches:
    each landmark step launches kernel 7 2·L times on the tensor-core
    route (the forward and its remat recompute) and its backward L times,
    the full-attention steps neither, and no plain version runs; losses
    finite, the first within 2 of ln V; step ms, tokens/s, peak memory and
    a profiled step (busy/idle, top kernels) per backend; step 1's
    gradients through the kernels against the plain B̃V, over the whole
    model and over each of wq, wk, wv, within ``GRAD_FLOOR_FACTOR`` × the
    plain path against itself over reversed keys, and each planted fault
    of the backward (``PLANTED``) outside it; (c) ``launch.train --smoke --steps 6
    --ckpt-dir build/phase16``, then ``--steps 10``, which resumes at 6;
    (d) SmolLM-360M at full width with the depth cut to 2 layers, f32
    weights, landmark attention, B = ``TRAIN_BATCH``, S = 4096, AdamW,
    remat, ``F32_TRAIN_STEPS`` steps through ``build_cell`` and
    ``train_loop``: each step launches kernel 7 2·L times and its backward
    L times, all on ``f32_split`` (four split passes a backward call,
    three a forward), none on ``fma``; step ms, peak memory, a profiled
    step with the backward's device ms in it; step 1's gradients by the
    rule of (b), the backward isolated (kernel forward and backward
    against the kernel forward and the plain backward), with the whole
    path against the plain forward and backward printed beside it. 16a
    counts the backward's three routes and its split passes (one a call
    on ``tensor_core``, four on ``f32_split``). The kernel table gains
    the backward's rows: bf16 inputs on ``tensor_core`` (event and device
    ms at the training shape, bound, plain ms, bf16 SDPA's backward
    alone), f32 inputs on ``f32_split`` (the same with the split passes'
    share, the 27-product floor and f32 SDPA's backward, launches from
    16d) and the FMA route at D = 256 (16a's (2, 130, 500, 256)); each
    row its launches on the landmark training run (``launches_train``)
    and on 16d (``launches_train_f32``).

The GNN slice adds:

17. GNN training — (a) the fixed-order segment sum (``segment_sum``,
    ``csrc/segment_sum.cu``, no TPU kernel: the reference's
    ``jax.ops.segment_sum``) at the CSRs by destination and by source of
    ``full_graph_sm``, ``minibatch_lg`` and ``molecule`` (and molecule's
    by graph id), f32 and bf16: bitwise its plain version, two launches
    bitwise, empty segments 0, 1024 padded edges at node 0 changing
    nothing (masked, or live with zero rows); one line a CSR with its live
    edges, largest segment, heavy segments (more than ``segsum.HEAVY``
    members) and, in f32 (bf16 too at minibatch_lg), the kernel's event
    and device ms, its bound and one ``index_add_`` call's ms; the same
    checks at the card tests' schedule cases (each width class H = 1, 31,
    32, 33, 128, a segment of 5,000, degrees at the heavy threshold −1, 0,
    +1, every edge masked, no edge); (b) GatedGCN at full width
    and depth (16 layers, d_hidden 70, f32, seed-0 weights, AdamW, remat)
    trained ``GNN_STEPS`` steps on each of the three shapes through
    ``build_cell`` and ``train_loop`` on the shape's own generator: every
    step launches the kernel 8·L times (+2 for the molecule readout) and
    nothing else, losses finite; step ms, peak memory and a profiled step
    (busy/idle, top kernels, the segment sum's device ms); step 1's loss
    and gradients from the seed-0 weights twice bitwise on the kernel
    path and within ``GNN_GRAD_REL`` of each leaf's largest |gradient| of
    the plain path; (c) the mesh form on a single-process mesh (data=2,
    model=4) on the card: its logits against the one-device forward, at
    the reference test's configuration and at full width on a
    dst-partitioned ``full_graph_sm``, within ``MESH_REL`` of the largest
    |logit| (the absolute error printed beside the reference's 2e-2), and
    one train step of the ``comm`` cell. The kernel table
    gains row 8 (events and device ms at minibatch_lg's CSR by
    destination, bound, plain ms, one ``index_add_`` call and whether it
    is bitwise, and 17a's times at every CSR, the plain version's too,
    as ``per_csr``) and each row
    its launches on the GNN runs (``launches_gnn``).

The recsys slice adds:

18. recsys — (b) FM, BERT4Rec, MIND and DIEN at full width (f32,
    seed-0 weights, AdamW) through ``build_cell`` and ``train_loop`` for
    ``REC_STEPS`` steps at train_batch or, where one forward and backward
    runs out of memory, the largest power of two below it (the batches
    that ran out printed), each lookup's backward on the segment-sum
    kernel: launches a step, step ms, peak memory, a profiled step (no
    atomic scatter kernel, ``REC_ATOMIC``), step 1's gradients and updated
    parameters twice bitwise and its gradients bitwise the plain sum's;
    (a) the segment sum at FM's CSR by field id (train_batch, 41,689,088
    segments, H = 10 and 1) and BERT4Rec's by item id (18b's batch, the
    Zipf head), bitwise its plain version and itself, with event and
    device ms, bound and ``index_add_``; the lookup's mesh form
    (model = 4 row shards) bitwise the plain form; (c) the scores cells
    at serve_p99 and serve_bulk (or a printed cut) and the retrieval cell
    at retrieval_cand: ms a call, peak memory, the top-100 ids equal to a
    CPU run of the port under the tie rule; (d) the landmark-retrieval
    example's kernels (d1 over the item × user matrix, kernel 7's
    ``f32_split`` route) against their plain versions at its shapes, then
    the example. Row 8 gains the two CSRs in ``per_csr`` and each row its
    launches on 18b–18d (``launches_recsys``).

The cells slice adds:

19. cells — (a) the registry's ``landmark_cf`` cells
    (``launch/steps.py::_cf_cell``) on the card: ``ml1m_fit`` and
    ``netflix1m_fit`` on ``data.synthesize("movielens1m"/"netflix1m")``
    (every rating; users padded to 8), ``ml1m_predict``'s 131,072 pairs
    over the ml1m_fit graph, and ``web_fit`` with U cut to the most one
    card holds (``tools/profile_web_fit.py::web_users``: the largest
    multiple of ``WEB_STEP`` whose dry-run argument and temp bytes fit
    ``WEB_HEADROOM`` of the card; ratings made on the card as 14c's):
    kernels 1 and 2 launched in each fit, d1 once on its tensor-core route
    with its result kept (web_fit's past 65,535 items on the cluster
    kernel), bitwise ``route="f32"`` on the same rows, cosine bitwise the
    plain version, the outputs equal to the plain path's (popularity
    landmarks, the plain d1, the streaming graph; web_fit on ``CF_SAMPLE``
    rows) under the tie rule, the predictions to a CPU run's within the
    parity tolerance; times printed, and web_fit's step split by kernel
    from a profiled step (d1, kernel 2's wide prep and scan, the popularity
    count, everything else); (b) ``launch.dryrun --all --family F`` on meta
    for the GNN, recsys and CF families, a line per cell, then the CF cells and four smoke cells (SmolLM's with full
    and with landmark attention, GatedGCN's, FM's) counted on the card by
    ``launch/step_costs.py::measure``: FLOPs and kernel calls equal to the
    dry run's count of the same cell, and the card's peak allocated bytes
    beyond what it held within ``TEMP_REL`` of the dry run's temp bytes
    plus ``TEMP_ABS``; (c) ``distributed/compression.py`` on the card: the
    quantizers, error feedback and ``tree_compress`` bitwise the CPU's over
    3 steps, ``psum_compressed`` on ``make_debug_mesh()`` (8 positions
    round robin on one card) bitwise the CPU mesh's and within the
    reference test's bound. The kernel table gains each row's launches in
    (a) (``launches_cells``).
20. dist — the multi-process launcher and the logical-axis rules
    (``phase_dist``): SmolLM-360M at full width and depth (32 layers,
    d = 960, 512 landmarks, S = 4096), landmark attention, AdamW, remat,
    global batch 4 (the 8 ranks share the card's 80 GB): (a) 2 steps in
    one process, (b) the dry run of the same cell on an 8-position fake
    group (``launch/dist.py::fake_group``, a mesh of the card's type), (c)
    8 ranks spawned (``launch/dist.py::spawn``) on data=2, model=4, gloo
    on the one card (NCCL refuses two ranks of one communicator on one
    device; gloo's all-gather of CUDA tensors is built from its
    all-to-all), parameters, state and batch placed by the rules
    (``launch/steps.py``): each rank's loss within the bf16 bound of (a),
    kernel 7 and its backward launched in every rank, each rank's
    collectives (count and bytes by kind, step 2) equal to (b)'s, step ms
    (gloo over host memory on one shared card), peak memory beside (b)'s
    argument + temp bytes. The kernel table gains rank 0's launches
    (``launches_dist``).
21. dist families — the recsys family and GatedGCN on the same layer
    (``phase_dist_families``): 8 ranks spawned on data=2, model=4 (gloo on
    the one card, as 20c), tables' rows over ``model`` and the batch over
    every axis (``launch/steps.py::rec_batch_specs``), GatedGCN's nodes
    over ``data`` and its dst-partitioned edges over every axis. FM at
    full width (a 41,689,088 × 10 table) at ``train_batch`` (65,536), MIND,
    DIEN and BERT4Rec at full width, each at the largest power-of-two batch
    up to 65,536 whose 8 ranks' dry-run argument + temp bytes stay under
    ``P21_HEADROOM`` of the card (the cuts printed), and GatedGCN's
    ``comm`` variant at full width (16 × 70, f32) on ``minibatch_lg``, 2
    AdamW steps each. Checks: every rank's loss equal, and within its bound
    (:data:`P21_LOSS_RTOL`) of the one-process run of the same steps (for
    the comm form the single-process mesh form on the same axes); row 8
    launched exactly as the step's lookups and layers imply in every rank
    and step (:data:`P21_ROW8`), and no atomic
    scatter kernel (``REC_ATOMIC``) in a rank's profiled first step, whose
    profile must have seen kernels; each rank's collectives (count and
    bytes by kind, step 2) equal to the dry run of the same cell on a fake
    group of 8; :data:`P21_LEAVES` (every table and a dense leaf;
    GatedGCN's first layer's U and V and its head): the step-1 gradient
    and the update over the 2 steps, each rank's blocks held against the
    one-process run's leaves (saved whole), within their bounds over
    every copy of a leaf; peak memory a rank beside the dry run's
    argument + temp; step ms a rank (gloo over host memory on one shared
    card). The kernel table's row 8 gains rank 0's launches over the five
    runs (``launches_dist``).

The last two lines are the kernel table and
``{"ok": true, "device": {"platform": "gpu", ...}}``. TF32 is off for
matmul and cuDNN throughout: the reference scores in full f32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import landmark_cf as cfg  # noqa: E402
from repro_torch.core import (RatingMatrix, fit, fold_in, knn,  # noqa: E402
                              predict)
from repro_torch.core import similarity as sim  # noqa: E402
from repro_torch.core.graph import (build_neighbor_graph,  # noqa: E402
                                    filter_self_from_topk, kernel_rows)
from repro_torch.core import selection  # noqa: E402
from repro_torch.core.selection import popularity_landmarks  # noqa: E402
from repro_torch.core.topk import canonical_topk, list_mismatches  # noqa: E402
from repro_torch.data import ratings as data  # noqa: E402
from repro_torch import retrieval as rt  # noqa: E402
from repro_torch.core.graph import finalize_topk  # noqa: E402
from repro_torch.kernels import (assign_clusters, build, ivf_probe,  # noqa: E402
                                 knn_topk, ops, ref, score_candidates)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import landmark_attention as lsum  # noqa: E402
from repro_torch.kernels import masked_similarity as ms  # noqa: E402
from repro_torch.kernels import segment_sum as segsum  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.lifecycle import buckets  # noqa: E402
from repro_torch import mutation  # noqa: E402
from repro_torch.baselines import bpmf, mf  # noqa: E402
from repro_torch.distributed import embedding  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import steps as cells  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_mesh  # noqa: E402
from repro_torch.launch import dryrun, step_costs  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.obs import profile as obs_profile  # noqa: E402
from repro_torch.train import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import paper_tables_torch as paper  # noqa: E402
import time_segment_sum as segsum_tool  # noqa: E402
import profile_web_fit as web_tool  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "landmark_retrieval_torch",
    ROOT / "examples" / "landmark_retrieval_torch.py")
ex_retrieval = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ex_retrieval)

DEVICE = "cuda"
RTOL, ATOL = 1e-5, 1e-6
FOLD_IN = 64  # users held out of the fit and folded in
TOPN_USERS = 256
# the H100's published peaks and each kernel's operations and bytes: one
# formula a kernel in kernels/cost.py (kcost), which the dry run counts too

KERNELS = {
    # d1's two routes: bf16 wgmma moments (exact on ratings, guarded), and
    # f32 FMAs on the CUDA cores
    "masked_similarity": dict(
        source="src/repro_torch/kernels/csrc/masked_similarity.cu",
        replaces="src/repro/kernels/masked_similarity.py:72"),
    "masked_similarity_f32": dict(
        source="src/repro_torch/kernels/csrc/masked_similarity.cu",
        replaces="src/repro/kernels/masked_similarity.py:72"),
    "topk_sim": dict(
        source="src/repro_torch/kernels/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn_topk.py:114"),
    "foldin_topk": dict(
        source="src/repro_torch/kernels/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn_topk.py:235"),
    "assign_clusters": dict(
        source="src/repro_torch/kernels/csrc/assign_clusters.cu",
        replaces="src/repro/retrieval/kmeans.py:74"),
    "fused_probe_topk": dict(
        source="src/repro_torch/kernels/csrc/ivf_probe.cu",
        replaces="src/repro/kernels/ivf_probe.py:135"),
    "score_candidates": dict(
        source="src/repro_torch/kernels/csrc/score_candidates.cu",
        replaces="src/repro/retrieval/index.py:519"),
    # kernel 7's two routes, both on the tensor cores: bf16 inputs as they
    # are, f32 inputs split into bf16 terms first
    "landmark_summary": dict(
        source="src/repro_torch/kernels/csrc/landmark_summary.cu",
        replaces="src/repro/kernels/landmark_attention.py:51"),
    "landmark_summary_f32": dict(
        source="src/repro_torch/kernels/csrc/landmark_summary.cu",
        replaces="src/repro/kernels/landmark_attention.py:51"),
    # kernel 7's backward (phase 16): no TPU kernel of its own
    "landmark_summary_bwd": dict(
        source="src/repro_torch/kernels/csrc/landmark_summary_bwd.cu",
        replaces="src/repro/kernels/landmark_attention.py:51",
        replaces_note="the backward of kernel 7's function; the reference "
        "has no backward kernel (autodiff of plain jnp, "
        "src/repro/models/layers.py:170)"),
    # its f32_split route (f32 inputs at D <= 128) and its FMA route
    # (D = 256), sub-rows
    "landmark_summary_bwd_f32": dict(
        source="src/repro_torch/kernels/csrc/landmark_summary_bwd.cu",
        replaces="src/repro/kernels/landmark_attention.py:51",
        replaces_note="the backward of kernel 7's function; the reference "
        "has no backward kernel (autodiff of plain jnp, "
        "src/repro/models/layers.py:170)"),
    "landmark_summary_bwd_fma": dict(
        source="src/repro_torch/kernels/csrc/landmark_summary_bwd.cu",
        replaces="src/repro/kernels/landmark_attention.py:51",
        replaces_note="the backward of kernel 7's function; the reference "
        "has no backward kernel (autodiff of plain jnp, "
        "src/repro/models/layers.py:170)"),
    # the GNN's message passing (phase 17): no TPU kernel of its own
    "segment_sum": dict(
        source="src/repro_torch/kernels/csrc/segment_sum.cu",
        replaces="src/repro/models/gnn.py:129",
        replaces_note="no TPU kernel: the reference's jax.ops.segment_sum "
        "(an XLA scatter-add) at src/repro/models/gnn.py:129,134,144-145"),
}
GRAPH_KERNELS = ("masked_similarity", "topk_sim", "foldin_topk")
IVF_KERNELS = ("assign_clusters", "fused_probe_topk", "score_candidates")
CF_KERNELS = GRAPH_KERNELS + IVF_KERNELS
# the landmark-attention forward of phase 8b: SmolLM-360M at full width
LM_ARCH, LM_BATCH, LM_SEQ = "smollm-360m", 2, 4096
LM_RTOL, LM_ATOL = 1e-4, 1e-5  # kernel 7 vs its plain version
LM_LOGIT_REL = 0.05  # bf16 forward, kernel vs plain B̃V, of max |logit|
DECODE_ATOL = 0.15  # bf16 decode step vs forward (tests/test_archs_smoke.py)
# an MoE expert flip between two bf16 runs of phase 15 (kernel vs plain
# B̃V, decode vs forward): the first run's relative probability gap of the
# two experts. 2^-3 is a router-logit gap of ln(8/7) = 0.134: a near-tie
# at 28 layers, where the two runs' rounding moves a router logit by up
# to 0.101 (router_logit_abs of DeepSeek's landmark forward on the H100),
# so two logits 0.2 apart can cross; the largest gap seen there was 0.108
ROUTER_TIE_REL = 2 ** -3


def sync():
    torch.cuda.synchronize()


def _counts():
    """Every wrapper's launches since the last reset, with d1's f32-route
    launches as ``masked_similarity_f32``."""
    counts = ops.launch_counts()
    counts["masked_similarity_f32"] = ms.masked_similarity.route_launches[
        "f32"]
    return counts


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} "
          f"capability={torch.cuda.get_device_capability(0)} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    return card


def phase_build():
    _, log, seconds = build.build()
    build.library()
    keep = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"phase 2 build: {seconds:.1f}s -> {build.BUILD_DIR / build.LIB_NAME}"
          f" | ptxas: " + " ; ".join(keep))
    print("phase 2 tensor-core kernel: " + json.dumps(_wgmma_report(
        log, "landmark_summary", _wgmma_name, 8,
        "2 routes x 4 head dims")))
    print("phase 2 backward tensor-core kernels: " + json.dumps(
        _wgmma_report(log, "landmark_summary_bwd", _bwd_name, 12,
                      "2 forms x 2 passes x 3 head dims")))
    print("phase 2 d1 tensor-core kernel: " + json.dumps(_wgmma_report(
        log, "masked_similarity", _d1_name, 6,
        "16-byte and 4-byte loads and the cluster kernel, each for half "
        "stars and for integers")))
    print("phase 2 fused probe kernel: " + json.dumps(_ptxas(log, _probe_name)))
    print("phase 2 top-k scan kernel: " + json.dumps(_ptxas(log, _scan_name)))
    print("phase 2 Lloyd kernel: " + json.dumps(_ptxas(log, _lloyd_name)))
    print("phase 2 scorer kernel: " + json.dumps(_ptxas(log, _scorer_name)))


def _wgmma_name(line):
    """'bf16 D=64' / 'f32 D=64' for a line naming an instantiation of the
    tensor-core summary kernel (template <int D, bool F32>), else None."""
    import re

    m = re.search(r"summary_wgmma_kernelILi(\d+)ELb([01])E", line)
    return f"{('bf16', 'f32')[int(m.group(2))]} D={m.group(1)}" if m else None


def _bwd_name(line):
    """'bf16 dq D=64' / 'f32 dkv D=64' for a line naming an instantiation
    of kernel 7's backward on the tensor cores (template <int D, bool F32>),
    else None."""
    import re

    m = re.search(r"bwd_(dq|dkv)_wgmma_kernelILi(\d+)ELb([01])E", line)
    return (f"{('bf16', 'f32')[int(m.group(3))]} {m.group(1)} "
            f"D={m.group(2)}" if m else None)


def _d1_name(line):
    """'16-byte loads, half stars' / '4-byte loads, integers' / 'cluster,
    half stars' ... for a line naming an instantiation of d1's tensor-core
    moments kernel (template <bool VEC, bool HALF>) or of its cluster
    kernel (22..128 landmarks, TMA multicast; template <bool HALF>), else
    None."""
    import re

    values = ("integers", "half stars")
    m = re.search(r"moments_cluster_kernelILb([01])E", line)
    if m:
        return f"cluster, {values[int(m.group(1))]}"
    m = re.search(r"moments_wgmma_kernelILb([01])ELb([01])E", line)
    return (f"{(4, 16)[int(m.group(1))]}-byte loads, "
            f"{values[int(m.group(2))]}" if m else None)


def _probe_name(line):
    """'n<=20' for a line naming an instantiation of the fused probe
    kernel (template <int NV4>: rows padded to 4·NV4), 'wide' for its wide
    route (n > 104), else None."""
    import re

    if "probe_wide_kernel" in line:
        return "wide"
    m = re.search(r"probe_group_kernelILi(\d+)E", line)
    return f"n<={4 * int(m.group(1))}" if m else None


def _lloyd_name(line):
    """'n<=20' for a line naming an instantiation of the Lloyd kernel
    (template <int NMAX>: a register row of NMAX floats), 'wide' for its
    wide route (n > 104), else None."""
    import re

    if "lloyd_wide_kernel" in line:
        return "wide"
    m = re.search(r"lloyd_kernelILi(\d+)E", line)
    return f"n<={m.group(1)}" if m else None


def _scorer_name(line):
    """'per-query' / 'shared' for a line naming one of kernel 6's two
    forms, else None."""
    if "per_query_kernel" in line:
        return "per-query"
    return "shared" if "shared_kernel" in line else None


def _scan_name(line):
    """'R=2 S=4 W=8 stages=4 cosine' for a line naming an instantiation of
    the top-k scan kernel (template <class T, int M>: T a Tile<R, S, W,
    STAGES, MINB>, M the measure), else None."""
    import re

    m = re.search(r"topk_scan_(wide_)?kernelI\w*?TileILi(\d+)ELi(\d+)ELi"
                  r"(\d+)ELi(\d+)ELi\d+EEELi(\d)E", line)
    if not m:
        return None
    wide, r, s, w, stages, measure = m.groups()
    return (f"{'wide ' if wide else ''}R={r} S={s} W={w} stages={stages} "
            f"{sim.MEASURES[int(measure)]}")


def _ptxas(log, name_of):
    """The ``-Xptxas -v`` registers, static shared memory and spill bytes
    of each kernel instantiation that ``name_of`` names."""
    import re

    report, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = name_of(ln)
        elif name and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            report.setdefault(name, {})["spill_bytes"] = [int(m.group(1)),
                                                          int(m.group(2))]
        elif name and "Used" in ln and "registers" in ln:
            entry = report.setdefault(name, {})
            entry["registers"] = int(re.search(r"Used (\d+) registers",
                                               ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            entry["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return report


def _wgmma_report(log, stem, name_of, want, what):
    """Per instantiation of a tensor-core kernel in ``csrc/<stem>.cu`` that
    ``name_of`` names: the ``-Xptxas -v`` registers, static shared memory
    and spill bytes, and the wgmma instructions in its machine code. Raises
    unless ``want`` instantiations (``what``) each have some."""
    report = _ptxas(log, name_of)
    obj = build.BUILD_DIR / f"{stem}.o"
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        count, name = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                name = name_of(ln)
            elif name and "HGMMA" in ln:
                count[name] = count.get(name, 0) + 1
        how = "HGMMA in cuobjdump -sass"
    else:
        ptx = subprocess.run(
            [build.nvcc(), build.ARCH, "-std=c++17", "-O3", "-ptx", "-o", "-",
             str(build.CSRC / f"{stem}.cu")],
            capture_output=True, text=True, check=True).stdout
        count = {"all": ptx.count("wgmma.mma_async")}
        how = "wgmma.mma_async in the PTX"
    if not count or min(count.values()) == 0 or (
            "all" not in count and len(count) != want):
        raise AssertionError(f"{stem}: not {want} instantiations ({what}) "
                             f"each with wgmma ({how}: {count})")
    return {"instructions": how, "count": count, "ptxas": report}


def _topk_err(want, got):
    """Largest |Δ| over slots that hold a value in both (0 when none)."""
    wv, gv = want[0], got[0]
    finite = torch.isfinite(wv)
    if not torch.equal(finite, torch.isfinite(gv)):
        raise AssertionError("empty slots differ")
    return float((gv[finite] - wv[finite]).abs().max()) if finite.any() else 0.0


def _check_topk(name, want, got, strict=False):
    """Kernel lists against the plain version's: ids equal up to ties at the
    cut within rtol=1e-5/atol=1e-6, weights of matched ids within that
    tolerance; ``strict`` demands bitwise equality. Returns (max |Δ|,
    bitwise)."""
    sync()
    bitwise = torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    if strict and not bitwise:
        raise AssertionError(f"{name}: not bitwise equal to its plain version")
    bad = list_mismatches(want[0], want[1], got[0], got[1], RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"{name}: rows {bad[:8].tolist()} disagree with "
                             f"the plain version beyond the tie rule")
    return _topk_err(want, got), bitwise


def _ratings(u, p, seed, density=0.08):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return torch.as_tensor(r * (rng.random((u, p)) < density), device=DEVICE)


def phase_kernels(train):
    """Each kernel against its plain version. Returns the largest error at
    the main-path shapes per kernel."""
    fit_r, new_r = train[:-FOLD_IN], train[-FOLD_IN:]
    lm = fit_r[popularity_landmarks(fit_r, cfg.MODEL.n_landmarks)]
    ra = _ratings(1130, 777, seed=11)
    err = {name: 0.0 for name in GRAPH_KERNELS}
    notes = []

    def d1(tag, a, b, main):
        """Both routes against the plain version; the tensor-core route
        (guard on) bitwise the f32 route for every measure."""
        for measure in sim.MEASURES:
            want = ref.masked_similarity_ref(a, b, measure)
            f32 = ops.masked_similarity(a, b, measure, route="f32")
            for route, got in (("tensor_core", ops.masked_similarity(
                    a, b, measure)), ("f32", f32)):
                sync()
                if measure == "cosine" and not torch.equal(got, want):
                    raise AssertionError(f"masked_similarity {tag} {route}: "
                                         f"cosine on integer ratings is not "
                                         f"bitwise equal")
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                if not torch.equal(got, f32):
                    raise AssertionError(f"masked_similarity {tag} "
                                         f"{measure}: the tensor-core route "
                                         f"is not bitwise the f32 route")
                e = float((got - want).abs().max())
                if main:
                    key = "masked_similarity" + (
                        "_f32" if route == "f32" else "")
                    err[key] = max(err[key], e)
        notes.append(f"d1 {tag} {tuple(a.shape)}x{tuple(b.shape)} ok")

    err["masked_similarity_f32"] = 0.0
    ops.reset_launches()
    d1("fit", fit_r, lm, True)
    d1("fold-in", new_r, lm, True)
    d1("ragged", ra[:1000], ra[1000:], False)
    # the cluster kernel at 4 N tiles of 32 (128 landmarks) and at 3 (80:
    # ranks multicast 3, 3 and 2 of a stage's 8 boxes, and guard uneven
    # shares of its chunks)
    for n in (WEB_N, 80):
        d1(f"n={n}", fit_r, fit_r[popularity_landmarks(fit_r, n)], False)
    # the guard's limits: ±8, ±7.5 and ½ at the largest P the route takes
    # half stars at (every x and y up to 64·P, just under 2^22); ±8 and 5
    # integers at the largest P it takes with 16-byte loads (64·P just
    # under 2^24; the cluster kernel at B = 128), bitwise the f32 route
    rng = np.random.default_rng(13)
    for tag, vals, p, b in (
            ("half-star limit", [-8.0, -7.5, 0.5, 7.5, 8.0],
             ref.D1_HALF_ITEMS, 25),
            ("integer limit", [-8.0, -5.0, 5.0, 8.0], ref.D1_MAX_ITEMS - 3,
             128)):
        big = rng.choice(vals, (130 + b, p))
        big *= rng.random(big.shape) < 0.7
        big[:3] = 8.0
        big[130:133] = -8.0
        big = torch.as_tensor(big.astype(np.float32), device=DEVICE)
        if not ref.d1_guard_ref(big):
            raise AssertionError(f"d1 {tag}: the values fail the guard")
        d1(tag, big[:130], big[130:], False)
        del big
    results = ms.route_results()
    if results != {"tensor_core": 21, "f32_fallback": 0}:
        raise AssertionError(f"d1 on ratings: results {results}, not 21 "
                             f"tensor-core results")
    # off the guard (1.1-star steps): the f32 route's result, bitwise
    off = ra[:1000] * 1.1
    for measure in sim.MEASURES:
        got = ops.masked_similarity(off, ra[1000:], measure)
        want = ops.masked_similarity(off, ra[1000:], measure, route="f32")
        sync()
        if not torch.equal(got, want):
            raise AssertionError("d1 off the guard: not the f32 route's "
                                 "result")
    # half stars past the half-star limit: the f32 result, counted
    rng = np.random.default_rng(16)
    half = rng.integers(1, 11, (300, ref.D1_HALF_ITEMS + 1)) / 2
    half *= rng.random(half.shape) < 0.05
    half = torch.as_tensor(half.astype(np.float32), device=DEVICE)
    got = ops.masked_similarity(half[:172], half[172:])
    want = ops.masked_similarity(half[:172], half[172:], route="f32")
    sync()
    if not torch.equal(got, want):
        raise AssertionError("d1 half stars at P = 65,536: not the f32 "
                             "route's result")
    results = ms.route_results()
    if results != {"tensor_core": 21, "f32_fallback": 4}:
        raise AssertionError(f"d1 off the guard: results {results}")
    notes.append(f"d1 guard: P={ref.D1_HALF_ITEMS} at |v| <= 8 and "
                 f"P={ref.D1_MAX_ITEMS - 3} on integers bitwise; 1.1-steps "
                 f"and half stars at P={ref.D1_HALF_ITEMS + 1} take the f32 "
                 f"result ({results})")

    rep = sim.masked_similarity(train, lm)  # (U, n) as the main path makes it
    rag = sim.masked_similarity(ra[:1001], ra[:20])
    # the paper tables' widest representation: 100 landmarks
    wide = sim.masked_similarity(train[:2000], train[:100])
    dup = rep[:300].repeat_interleave(3, dim=0)
    ints = torch.as_tensor(np.random.default_rng(12).integers(
        0, 4, (150, 20)).astype(np.float32), device=DEVICE)
    ints = ints.repeat_interleave(3, dim=0)
    exact = []
    for measure in sim.MEASURES:
        rows = kernel_rows(rep, measure)
        u = rows.shape[0] - FOLD_IN
        cases = [
            ("topk_sim", "fit", True, lambda f: f(rows[:u], rows[:u], 13,
                                                  exclude_self=True, n_valid=u,
                                                  measure=measure)),
            ("foldin_topk", "fold-in", True,
             lambda f: f(rows[u:].contiguous(), rows, 13, self_offset=u,
                         measure=measure)),
        ]
        rg = kernel_rows(rag, measure)
        cases += [
            ("topk_sim", "ragged", False, lambda f: f(
                rg, rg, 13, exclude_self=True, n_valid=990, measure=measure)),
            ("foldin_topk", "ragged", False, lambda f: f(
                rg[-37:].contiguous(), rg, 13, self_offset=1001 - 37,
                measure=measure)),
        ]
        dp = kernel_rows(dup, measure)
        cases.append(("topk_sim", "duplicated", False, lambda f: f(
            dp, dp, 13, exclude_self=True, measure=measure)))
        wd = kernel_rows(wide, measure)
        cases += [
            ("topk_sim", "n=100", False, lambda f: f(
                wd, wd, 13, exclude_self=True, measure=measure)),
            ("foldin_topk", "n=100", False, lambda f: f(
                wd[-64:].contiguous(), wd, 13, self_offset=2000 - 64,
                measure=measure)),
        ]
        for name, tag, main, call in cases:
            plain = ref.topk_sim_ref if name == "topk_sim" else \
                ref.foldin_topk_ref
            kern = getattr(knn_topk, name)
            e, bitwise = _check_topk(f"{name} {tag} {measure}", call(plain),
                                     call(kern), strict=True)
            exact.append(bitwise)
            if main:
                err[name] = max(err[name], e)
        if measure != "pearson":  # integer rows: every score exact
            _check_topk(f"topk_sim integer duplicates {measure}",
                        ref.topk_sim_ref(ints, ints, 13, exclude_self=True,
                                         measure=measure),
                        knn_topk.topk_sim(ints, ints, 13, exclude_self=True,
                                          measure=measure), strict=True)
    notes.append(f"top-k cases bitwise equal {sum(exact)}/{len(exact)}")
    print("phase 3 kernels: " + "; ".join(notes) + " | max |err| at main-path "
          "shapes " + json.dumps(err))
    return err


def _pairs(test_idx, d, lo, hi):
    keep = (d.users[test_idx] >= lo) & (d.users[test_idx] < hi)
    sel = test_idx[keep]
    return (torch.as_tensor(d.users[sel].astype(np.int64), device=DEVICE),
            torch.as_tensor(d.items[sel].astype(np.int64), device=DEVICE),
            d.ratings[sel])


def _d1_f32(r_a, r_b, measure="cosine"):
    """d1 forced onto its f32 route (the kernel before the tensor-core
    route existed)."""
    return ops.masked_similarity(r_a, r_b, measure, route="f32")


def run_main_path(train, d, test_idx, kernels, sim_fn=None):
    """fit → predict → top-N → fold-in → predict, on the card. ``kernels``
    False forces the plain d1 and the streaming graph; ``sim_fn`` replaces
    the default d1. Returns the outputs, the launch counts of this run (d1's
    f32-route launches as ``masked_similarity_f32``), d1's results by route
    after fit and after fold-in, and its wall times."""
    spec = cfg.MODEL
    u_fit = train.shape[0] - FOLD_IN
    sim_fn = sim_fn if kernels else sim.masked_similarity
    backend = "auto" if kernels else "streaming"
    fit_pairs = _pairs(test_idx, d, 0, u_fit)
    new_pairs = _pairs(test_idx, d, u_fit, train.shape[0])
    rec_users = torch.arange(0, u_fit, u_fit // TOPN_USERS,
                             device=DEVICE)[:TOPN_USERS]
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    st = fit(RatingMatrix(train[:u_fit], u_fit, train.shape[1]), spec, sim_fn,
             backend=backend)
    sync()
    t_fit = time.perf_counter() - t0
    d1_fit = ms.route_results()
    pred_fit = predict(st, fit_pairs[0], fit_pairs[1], spec)
    top_i, top_s = knn.recommend_topn_graph(st.graph, st.ratings, rec_users,
                                            n=10)
    sync()
    t0 = time.perf_counter()
    st2 = fold_in(st, train[u_fit:], spec, sim_fn, backend=backend)
    sync()
    t_fold = time.perf_counter() - t0
    pred_new = predict(st2, new_pairs[0], new_pairs[1], spec)
    sync()
    counts = _counts()
    d1_all = ms.route_results()
    d1 = {"fit": d1_fit, "fold-in": {k: d1_all[k] - d1_fit[k]
                                     for k in d1_all}}
    return dict(state=st, folded=st2, pred_fit=pred_fit, pred_new=pred_new,
                top=(top_i, top_s), rec_users=rec_users, fit_pairs=fit_pairs,
                new_pairs=new_pairs, counts=counts, d1=d1, t_fit=t_fit,
                t_fold=t_fold)


def _check_d1_routes(where, counts, results):
    """Every d1 call of a run took the tensor-core route and kept its
    result: none went to the f32 route, none had its result replaced."""
    n = counts["masked_similarity"]
    if not (n > 0 and counts["masked_similarity_f32"] == 0
            and results == {"tensor_core": n, "f32_fallback": 0}):
        raise AssertionError(f"{where}: d1 calls {n}, f32-route launches "
                             f"{counts['masked_similarity_f32']}, results "
                             f"{results}: not every call took the "
                             f"tensor-core route's result")


def _same_sets(ga, gb):
    return (torch.sort(ga.indices, dim=1).values
            == torch.sort(gb.indices, dim=1).values).all(dim=1)


def phase_main_path(train, d, test_idx):
    torch.cuda.reset_peak_memory_stats()
    a = run_main_path(train, d, test_idx, kernels=True)
    peak = torch.cuda.max_memory_allocated()
    b = run_main_path(train, d, test_idx, kernels=False)
    if not all(a["counts"][name] > 0 for name in GRAPH_KERNELS):
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{a['counts']}")
    if any(b["counts"].values()):
        raise AssertionError(f"plain run launched kernels: {b['counts']}")
    for step, results in a["d1"].items():
        if results != {"tensor_core": 1, "f32_fallback": 0}:
            raise AssertionError(f"main path {step}: d1 results {results}, "
                                 f"not one tensor-core result")
    _check_d1_routes("main path", a["counts"], {
        k: a["d1"]["fit"][k] + a["d1"]["fold-in"][k]
        for k in a["d1"]["fit"]})
    # (c): the same run with d1 on its f32 route, the kernel the tensor-core
    # route replaced on this path: every output bitwise equal
    c = run_main_path(train, d, test_idx, kernels=True, sim_fn=_d1_f32)
    same_c = {
        "representation": torch.equal(a["state"].representation,
                                       c["state"].representation),
        "folded representation": torch.equal(
            a["folded"].representation, c["folded"].representation),
        "graph": all(torch.equal(x, y) for x, y in (
            (a["state"].graph.weights, c["state"].graph.weights),
            (a["state"].graph.indices, c["state"].graph.indices),
            (a["folded"].graph.weights, c["folded"].graph.weights),
            (a["folded"].graph.indices, c["folded"].graph.indices))),
        "predictions": torch.equal(a["pred_fit"], c["pred_fit"])
        and torch.equal(a["pred_new"], c["pred_new"]),
        "top-N": all(torch.equal(x, y) for x, y in zip(a["top"], c["top"]))}
    if not all(same_c.values()) or c["counts"]["masked_similarity_f32"] != 2:
        raise AssertionError(f"main path, d1 tensor-core vs f32 route: "
                             f"bitwise {same_c}, f32 launches "
                             f"{c['counts']['masked_similarity_f32']}")
    sa, sb = a["state"], b["state"]
    if not torch.equal(sa.landmark_idx, sb.landmark_idx):
        raise AssertionError("landmark ids differ")
    for x, y in ((sa, sb), (a["folded"], b["folded"])):
        if not torch.equal(x.representation, y.representation):
            raise AssertionError("cosine d1 representation not bitwise equal")
        bad = list_mismatches(y.graph.weights, y.graph.indices,
                              x.graph.weights, x.graph.indices, RTOL, ATOL)
        if bad.size:
            raise AssertionError(f"graph rows {bad[:8].tolist()} disagree "
                                 f"beyond the tie rule")
    out = {}
    for key, pairs, ga, gb in (
            ("fit", a["fit_pairs"], sa.graph, sb.graph),
            ("fold-in", a["new_pairs"], a["folded"].graph,
             b["folded"].graph)):
        pa = a["pred_fit" if key == "fit" else "pred_new"]
        pb = b["pred_fit" if key == "fit" else "pred_new"]
        same = _same_sets(ga, gb)
        keep = same[pairs[0]]
        torch.testing.assert_close(pa[keep], pb[keep], rtol=RTOL, atol=ATOL)
        keep_np = keep.cpu().numpy()
        truth = pairs[2]
        mae_a = data.mae(pa.cpu().numpy(), truth)
        mae_b = data.mae(pb.cpu().numpy(), truth)
        mae_same = abs(data.mae(pa.cpu().numpy()[keep_np], truth[keep_np])
                       - data.mae(pb.cpu().numpy()[keep_np], truth[keep_np]))
        if mae_same > RTOL:
            raise AssertionError(f"{key}: MAE differs by {mae_same} on rows "
                                 f"with equal neighbor sets")
        if not (torch.isfinite(pa).all() and pa.shape == (len(truth),)):
            raise AssertionError(f"{key}: predictions not finite / shaped")
        out[key] = dict(pairs=len(truth), mae_kernels=mae_a, mae_plain=mae_b,
                        rows_tie_swapped=int((~same).sum()),
                        pairs_on_swapped_rows=int((~keep_np).sum()))
    same = _same_sets(sa.graph, sb.graph)[a["rec_users"]]
    ia, sa_ = a["top"]
    ib, sb_ = b["top"]
    if ia.shape != (TOPN_USERS, 10) or (ia < 0).any():
        raise AssertionError("top-N shape or sentinel")
    bad = list_mismatches(sb_[same], ib[same], sa_[same], ia[same], RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"top-N rows {bad[:8].tolist()} disagree")
    print(f"phase 4 main path: U={train.shape[0]} P={train.shape[1]} "
          f"n={cfg.MODEL.n_landmarks} k={cfg.MODEL.k_neighbors} "
          f"launches(a)={a['counts']} launches(b)={b['counts']} "
          f"d1 results by call (a) {json.dumps(a['d1'])}; (c) d1 on the "
          f"f32 route: every output bitwise (a)'s ({', '.join(same_c)}) | "
          f"fit(a)={a['t_fit']:.3f}s fold-in(a)={a['t_fold']:.4f}s | "
          + json.dumps(out))
    return a, peak


def phase_serve():
    t0 = time.perf_counter()
    serve.main(["--workload", "cf", "--users", "6040", "--items", "3952",
                "--waves", "2", "--foldin", "64"])
    print(f"phase 5 serve CLI: {time.perf_counter() - t0:.1f}s")


def _event_ms(fn, iters):
    for _ in range(3):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


# the device functions of each wrapper, as the profiler names them
DEVICE_FUNCS = {
    # the tensor-core route: every kernel of the call (the workspace memset,
    # the planes, the moments, the finalize launch)
    "masked_similarity": None,
    "masked_similarity_f32": ("masked_similarity_kernel",),
    # the prep pass, the scan, and the merge of the candidate splits (the
    # wide routes' prep and scan past n = 104)
    "topk_sim": ("topk_prep_kernel", "topk_scan_kernel", "topk_merge_kernel",
                 "topk_prep_wide_kernel", "topk_scan_wide_kernel"),
    "foldin_topk": ("topk_prep_kernel", "topk_scan_kernel",
                    "topk_merge_kernel", "topk_prep_wide_kernel",
                    "topk_scan_wide_kernel"),
    "assign_clusters": ("lloyd_kernel", "lloyd_wide_kernel"),
    # None: every kernel of the call (the argsort that groups the queries,
    # then the probe kernel)
    "fused_probe_topk": None,
    "score_candidates": ("per_query_kernel", "shared_kernel"),
    "landmark_summary": ("summary_wgmma_kernel",),
    "landmark_summary_f32": ("summary_wgmma_kernel", "split_terms_kernel"),
    "split_terms": ("split_terms_kernel",),  # the f32 route's split pass
    # kernel 7's backward on its tensor-core routes: the split passes (dO;
    # and q, k, v on f32_split), the dq pass, then the dk/dv pass; on its
    # FMA route (D = 256) the two passes of scalar FMAs
    "landmark_summary_bwd": ("split_terms_kernel", "bwd_dq_wgmma_kernel",
                             "bwd_dkv_wgmma_kernel"),
    "landmark_summary_bwd_f32": ("split_terms_kernel", "bwd_dq_wgmma_kernel",
                                 "bwd_dkv_wgmma_kernel"),
    "landmark_summary_bwd_fma": ("bwd_dq_kernel", "bwd_dkv_kernel"),
    "repair_drain": None,  # every kernel of a drain (phase 10)
    "segment_sum": ("segment_sum_kernel",),
}


# Once a session in the process has traced many kernels, torch.profiler
# drops the first device records of later sessions (on an H100 up to 87
# records a session over the whole script). Every session here (obs.profile.profiled, which the
# engine's --torch-profile trace uses too) therefore begins with
# PROFILE_MARKERS spin kernels and a sync, and counts only when at least
# one marker survived: the drop is a prefix of the session, so the run's
# own records are then whole. PROFILE_DROPS keeps the markers lost a
# session.
PROFILE_MARKERS = obs_profile.PROFILE_MARKERS
PROFILE_DROPS = []


def _kernels(prof):
    """The device records of a ``profiled`` session less its markers, or
    None when every marker was dropped (and so maybe some of the run's)."""
    from torch.autograd import DeviceType

    kept, lost = obs_profile.strip_markers(
        e for e in prof.events() if e.device_type == DeviceType.CUDA)
    PROFILE_DROPS.append(lost)
    return kept


def _device_ms(fn, name, iters=20):
    """Device time per call of ``name``'s own kernels, from a
    ``torch.profiler`` trace of ``iters`` calls (the event time of
    ``_event_ms`` includes the host's launch cost whenever the kernel is
    shorter than it); None when the trace holds no device events or the
    profiler dropped its markers."""
    fn()
    sync()
    with obs_profile.profiled() as prof:
        for _ in range(iters):
            fn()
        sync()
    funcs = DEVICE_FUNCS[name]
    total = sum(e.time_range.end - e.time_range.start
                for e in _kernels(prof) or ()
                if funcs is None or any(f in e.name for f in funcs))
    return total / 1e3 / iters if total else None


def _wall_s(fn, reps=5):
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _profile(run, ranges=(), warm=True, sums=()):
    """Device time by kernel and the device's busy share over one run of
    ``run`` under ``torch.profiler`` (CUPTI), after one unprofiled run when
    ``warm``. The share is the union of kernel intervals over the span
    from the first kernel's start to the last one's end; the profiler's
    own host cost widens the gaps. For each ``record_function`` range
    named in ``ranges``, the device time of the kernels launched inside it
    and their share of all kernel time; for each name in ``sums``, the
    device ms and count of the kernels whose name holds it."""
    from torch.autograd import DeviceType

    if warm:
        run()
    sync()
    with obs_profile.profiled() as prof:
        run()
        sync()
    kernels = _kernels(prof)
    if kernels is None:
        return {"device_time": "not measured (the profiler dropped the "
                "session's first records)"}
    spans, by_name, inside = [], {}, dict.fromkeys(ranges, 0.0)
    summed = {name: [0.0, 0] for name in sums}
    for e in prof.events():
        if e.name in inside and e.device_type == DeviceType.CPU:
            inside[e.name] += e.device_time_total
    for e in kernels:
        # a range's own span on the device timeline is not a kernel
        if e.name in inside:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        for key in summed:
            if key in e.name:
                summed[key][0] += (t1 - t0) / 1e3
                summed[key][1] += 1
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:72]
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    if not spans:
        return {"device_time": "not measured (no device events)"}
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = end - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    total = sum(by_name.values())
    return {"kernels_launched": len(spans), "device_busy_ms": busy / 1e3,
            "window_ms": window / 1e3, "idle_share": 1 - busy / window,
            "top_ms": dict(top), **{f"{key} (ms, launches)": val
                                    for key, val in summed.items()},
            **{name: {
                f"{name}_device_ms": us / 1e3, "device_ms": total,
                f"{name}_share": us / 1e3 / total}
                for name, us in inside.items()}}


def _bound(bytes_moved, flops):
    """(least ms, what sets it) of a yardstick that is no kernel's: bytes
    at the HBM rate, operations at the f32 rate."""
    t_bytes = bytes_moved / kcost.HBM_BYTES_PER_S * 1e3
    t_ops = flops / kcost.F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _ivf_rows(ivf, ivf_counts, life_counts, err):
    """Rows 4–6 of the kernel table at the IVF path's shapes.

    Row 4 is the whole ``kmeans()`` call of the IVF build (one launch of
    the Lloyd kernel), bounded by its nine assignments' products (the
    update's adds are U·n a step) or by its rows and centroids read once
    and its outputs written once. The other operation counts are the least
    work each function needs on these inputs: a dot product (2n) and a
    3-op epilogue (multiply, max, divide) per scored pair, and a squared
    norm (2n) once per distinct row."""
    import torch.nn.functional as F

    index, probe = ivf["index"], ivf["probe"]
    rows_all = ivf["all_rows"]
    u, n = rows_all.shape
    c, cap = index.lists.shape
    spec = rt.resolve_ivf(None, u)
    init = rt.init_centroids(torch.Generator().manual_seed(spec.seed),
                             rows_all, c)
    live = int(index.fill[probe.long()].sum())  # (query, live slot) pairs
    stored = int(index.fill.sum())  # live rows in the index
    b, nprobe = probe.shape
    q, cand = ivf["q"], ivf["cand"]
    qb, m = cand.shape[:2]
    args = (rows_all, probe, index.lists, index.rows, index.scale, index.fill)
    kw = dict(k=13, self_ids=ivf["self_ids"])
    calls = {
        "assign_clusters": (
            lambda: rt.kmeans(rows_all, c, "cosine", iters=spec.iters,
                              init=init),
            lambda: ref.kmeans_lloyd_ref(rows_all, init, spec.iters),
            None, kcost.kmeans(u, c, n, spec.iters),
            f"kmeans() U={u} C={c} n={n} {spec.iters} steps, cosine, from "
            f"given centroids: the whole call"),
        "fused_probe_topk": (
            lambda: ivf_probe.fused_probe_topk(*args, **kw),
            lambda: ref.fused_probe_topk_ref(*args, **kw),
            None,
            kcost.fused_probe(b, nprobe, c, cap, n, 13, live, stored),
            f"b={b} nprobe={nprobe} C={c} cap={cap} n={n} k=13 f32, "
            f"{live} live (query, slot) pairs"),
        "score_candidates": (
            lambda: score_candidates.score_candidates(q, cand),
            lambda: ref.score_candidates_ref(q, cand),
            lambda: F.cosine_similarity(q[:, None, :], cand, dim=-1),
            # every gathered candidate is a row of its own: its norm too
            kcost.score_candidates(qb, m, n, False),
            f"b={qb} m={m} n={n}"),
    }
    table = []
    for name, (kern, plain, lib, work, shape) in calls.items():
        bound_ms, bound_by = work.bound()
        table.append(dict(
            name=name, route="cuda", **KERNELS[name], shape=shape,
            launches=ivf_counts[name], launches_lifecycle=life_counts[name],
            max_abs_err=err[name], max_err=err[name], ms=_event_ms(kern, 50),
            plain_ms=_event_ms(plain, 3), bound_ms=bound_ms,
            bound_us=bound_ms * 1e3, bound_by=bound_by,
            library_ms=None if lib is None else _event_ms(lib, 50),
            device_ms=_device_ms(kern, name)))
    table[0].update(_kmeans_times(ivf, init, spec))
    print("phase 6 fused probe: " + json.dumps(_probe_shapes(ivf)))
    return table


def _device_calls(fn, iters=20):
    """(device ms, device operations) per call of ``fn``: every kernel and
    copy it runs, from a ``torch.profiler`` trace of ``iters`` calls."""
    fn()
    sync()
    with obs_profile.profiled() as prof:
        for _ in range(iters):
            fn()
        sync()
    spans = [e.time_range.end - e.time_range.start
             for e in _kernels(prof) or ()]
    return (sum(spans) / 1e3 / iters if spans else None), len(spans) / iters


def _kmeans_times(ivf, init, spec):
    """Row 4's other numbers: the launches per ``kmeans()`` call, the
    Lloyd kernel's time for each measure at the IVF shape and, cosine, at
    the lifecycle's capacity bucket; the assignment alone (the earlier row
    4); ``build_index`` at the IVF shape."""
    rows_all, index = ivf["all_rows"], ivf["index"]
    c = index.n_clusters
    _, launches = _device_calls(
        lambda: rt.kmeans(rows_all, c, "cosine", iters=spec.iters, init=init))
    cap, nv = ivf["capacity"]
    c_life = rt.resolve_ivf(None, nv).n_clusters
    init_life = rt.init_centroids(torch.Generator().manual_seed(0), cap,
                                  c_life, nv)
    cells = {}
    for measure in sim.MEASURES:
        call = lambda m=measure: assign_clusters.kmeans_lloyd(
            rows_all, init, spec.iters, None, m)
        cells[measure] = dict(ms=_event_ms(call, 50),
                              device_ms=_device_calls(call)[0])
    call = lambda: assign_clusters.kmeans_lloyd(cap, init_life, spec.iters,
                                                nv, "cosine")
    cells[f"capacity U={cap.shape[0]} n_valid={nv} C={c_life}"] = dict(
        ms=_event_ms(call, 50), device_ms=_device_calls(call)[0])
    xr, cr = kernel_rows(rows_all, "cosine"), kernel_rows(init, "cosine")
    alone = lambda: assign_clusters.assign_clusters(xr, cr)
    build = lambda: rt.build_index(rows_all, spec, "cosine")
    build_dev, build_ops = _device_calls(build)
    out = dict(launches_per_call=launches, lloyd_kernel=cells,
               assign_alone=dict(ms=_event_ms(alone, 50),
                                 device_ms=_device_ms(alone,
                                                      "assign_clusters")),
               build_index=dict(ms=_event_ms(build, 20),
                                device_ms=build_dev,
                                device_ops_per_call=build_ops))
    print("phase 6 kmeans: " + json.dumps(out))
    return out


def _probe_shapes(ivf):
    """Row 5 at the lifecycle's batch sizes on phase 6's index (a 64-row
    fold-in and the 256-query recall probes at nprobe 19 and C), and the
    groups the graph build's call runs in: queries a block, union cells a
    group, and rows staged against rows probed."""
    index, probe, u_ids = ivf["index"], ivf["probe"], ivf["self_ids"]
    rows_all = ivf["all_rows"]
    c, cap = index.lists.shape
    nprobe = probe.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for bq, npr in ((64, nprobe), (256, nprobe), (256, c)):
        q = rows_all[:bq].contiguous()
        pr = rt.probe_cells(index, q, npr, "cosine")
        sid = u_ids[:bq]

        def call(q=q, pr=pr, sid=sid):
            return ivf_probe.fused_probe_topk(
                q, pr, index.lists, index.rows, index.scale, index.fill,
                k=13, self_ids=sid)

        out[f"b={bq} nprobe={npr}"] = dict(
            group=ivf_probe.plan_group(bq, sms, c), ms=_event_ms(call, 50),
            device_ms=_device_ms(call, "fused_probe_topk"))
    b = probe.shape[0]
    group = ivf_probe.plan_group(b, sms, c)
    order = ivf_probe.group_order(probe, group)
    live = index.fill.clamp(max=cap)
    pad = -b % group
    cells = torch.cat([probe[order], probe[order[-1:].expand(pad)]]).long()
    cells = torch.sort(cells.reshape(-1, group * nprobe), dim=1).values
    first = torch.ones_like(cells, dtype=torch.bool)
    first[:, 1:] = cells[:, 1:] != cells[:, :-1]
    union = first.sum(1)
    staged = int((live[cells] * first).sum())
    out[f"b={b} nprobe={nprobe} groups"] = dict(
        group=group, union_cells_mean=float(union.float().mean()),
        union_cells_max=int(union.max()), rows_staged=staged,
        rows_probed=int(live[probe.long()].sum()))
    return out


def phase_times(train, a, err, peak, life_counts):
    st = a["state"]
    u_fit, p = st.ratings.shape
    n, k = st.representation.shape[1], st.graph.k
    lm = st.ratings[st.landmark_idx]
    rows = kernel_rows(st.representation, "cosine")
    new = kernel_rows(a["folded"].representation[u_fit:], "cosine")
    cand = torch.cat([rows, new])
    b = new.shape[0]
    c = cand.shape[0]
    new_r = train[u_fit:]
    calls = {
        "masked_similarity": (
            lambda: ops.masked_similarity(st.ratings, lm),
            lambda: ref.masked_similarity_ref(st.ratings, lm),
            *kcost.masked_similarity(u_fit, n, p, True).bound(),
            f"A={u_fit} B={n} P={p} (fit), tensor-core route; every kernel "
            f"of the call (workspace memset, planes, moments, finalize)"),
        "masked_similarity_f32": (
            lambda: _d1_f32(st.ratings, lm),
            lambda: ref.masked_similarity_ref(st.ratings, lm),
            *kcost.masked_similarity(u_fit, n, p, False).bound(),
            f"A={u_fit} B={n} P={p} (fit), f32 route forced"),
        "topk_sim": (
            lambda: knn_topk.topk_sim(rows, rows, k, exclude_self=True),
            lambda: ref.topk_sim_ref(rows, rows, k, exclude_self=True),
            *kcost.topk(u_fit, u_fit, n, k).bound(),
            f"U=C={u_fit} n={n} k={k}"),
        "foldin_topk": (
            lambda: knn_topk.foldin_topk(new, cand, k, self_offset=u_fit),
            lambda: ref.foldin_topk_ref(new, cand, k, self_offset=u_fit),
            *kcost.topk(b, c, n, k).bound(),
            f"b={b} C={c} n={n} k={k}"),
    }
    launches = a["counts"]
    table = []
    for name, (kern, plain, bound_ms, bound_by, shape) in calls.items():
        table.append(dict(
            name=name, route="cuda", **KERNELS[name], shape=shape,
            launches=launches[name], launches_lifecycle=life_counts[name],
            max_abs_err=err[name], max_err=err[name],
            ms=_event_ms(kern, 50), plain_ms=_event_ms(plain, 10),
            bound_ms=bound_ms, bound_us=bound_ms * 1e3, bound_by=bound_by,
            library_ms=None, device_ms=_device_ms(kern, name)))
    # rows 2 and 3 also beside their no-FMA floor: every product and sum
    # rounded on its own (bitwise the plain version), 2n instructions a
    # pair at one instruction a lane a clock
    for row, pairs in zip(table[2:4], (u_fit * u_fit, b * c)):
        row["no_fma_floor_ms"] = pairs * 2 * n / (kcost.F32_FLOPS / 2) * 1e3
    # d1 at the fold-in shape, both routes, beside rows 1 and 1′
    for row, fn in zip(table[:2], (ops.masked_similarity, _d1_f32)):
        call = lambda fn=fn: fn(new_r, lm)
        row.update(foldin_shape=f"A={b} B={n} P={p}",
                   foldin_ms=_event_ms(call, 50),
                   foldin_device_ms=_device_ms(call, row["name"]),
                   foldin_bound_ms=kcost.masked_similarity(
                       b, n, p, row["name"] == "masked_similarity").bound()[0])
    spec = cfg.MODEL
    users, items = (x[:256] for x in a["fit_pairs"][:2])
    print("phase 6 profile: " + json.dumps(_profile(
        lambda: predict(fold_in(fit(RatingMatrix(train[:u_fit], u_fit, p),
                                    spec), train[u_fit:], spec),
                        users, items, spec))))
    walls = dict(
        fit_s=_wall_s(lambda: fit(RatingMatrix(train[:u_fit], u_fit, p),
                                  spec)),
        fold_in_s=_wall_s(lambda: fold_in(st, train[u_fit:], spec)),
        predict_256_pairs_s=_wall_s(lambda: predict(st, users, items, spec)),
        peak_device_bytes_main_path=peak)
    print("phase 6 times: " + json.dumps(walls))
    return table


# ----------------------------------------------------------- IVF retrieval
def _bitwise(name, got, want):
    sync()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: not bitwise equal to its plain "
                                 f"version")


def _quantized(index, payload):
    """The index's payload stored as ``payload`` (same lists and fills)."""
    rows = rt.dequantize_payload(index.rows, index.scale)
    stored, scale = rt.quantize_payload(rows.reshape(-1, rows.shape[-1]),
                                        payload)
    return rt.IVFIndex(index.centroids, index.lists,
                       stored.reshape(rows.shape[:2] + (-1,)).contiguous(),
                       index.fill, None if scale is None
                       else scale.reshape(index.lists.shape).contiguous())


def _edge_index(c, cap, n, seed):
    """Ragged fills with empty cells, ids a permutation."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(1, cap + 1, c)
    fill[::4] = 0
    ids = rng.permutation(int(fill.sum()))
    lists = np.zeros((c, cap), np.int32)
    rows = np.zeros((c, cap, n), np.float32)
    o = 0
    for j in range(c):
        lists[j, :fill[j]] = ids[o:o + fill[j]]
        rows[j, :fill[j]] = rng.normal(size=(fill[j], n))
        o += fill[j]
    return rt.IVFIndex(torch.as_tensor(rng.normal(size=(c, n)).astype(
        np.float32), device=DEVICE), torch.as_tensor(lists, device=DEVICE),
        torch.as_tensor(rows, device=DEVICE),
        torch.as_tensor(fill.astype(np.int32), device=DEVICE))


def phase_ivf_kernels(a):
    """7a: kernels 4–6 against their plain versions, bitwise. Returns the
    main-path inputs (for the times) and the largest error per kernel."""
    t0 = time.perf_counter()
    rep = a["state"].representation  # (5976, 20) as the main path made it
    u = rep.shape[0]
    spec = rt.resolve_ivf(None, u)
    index = rt.build_index(rep, spec, "cosine")
    notes = []
    # kernel 4: the Lloyd assignment at the k-means shape, every measure,
    # plus a tiled (C > 256) and a wide (n = 64) case
    wide = torch.as_tensor(np.random.default_rng(21).normal(
        size=(3001, 64)).astype(np.float32), device=DEVICE)
    for measure in sim.MEASURES:
        for tag, x, cent in (("main", rep, index.centroids),
                             ("C=300", rep, rep[::19][:300]),
                             ("n=64", wide, wide[7::11][:77])):
            xr, cr = kernel_rows(x, measure), kernel_rows(cent, measure)
            _bitwise(f"assign_clusters {tag} {measure}",
                     [assign_clusters.assign_clusters(xr, cr, measure)],
                     [ref.assign_clusters_ref(xr, cr, measure)])
    notes.append("assign 9/9 bitwise")
    capacity = _capacity_rows(a["folded"].representation)
    notes.append(_check_lloyd(rep, capacity))
    # kernel 5: the graph-build search through the index (every row a
    # query, its own id excluded), all payloads and measures
    probe = rt.probe_cells(index, rep, spec.nprobe, "cosine")
    self_ids = torch.arange(u, dtype=torch.int32, device=DEVICE)
    n_ok = 0
    for payload in rt.PAYLOAD_DTYPES:
        idx = index if payload == "f32" else _quantized(index, payload)
        for measure in sim.MEASURES:
            args = (rep, probe, idx.lists, idx.rows, idx.scale, idx.fill)
            kw = dict(k=13, measure=measure, self_ids=self_ids)
            _bitwise(f"fused_probe_topk main {payload} {measure}",
                     ivf_probe.fused_probe_topk(*args, **kw),
                     ref.fused_probe_topk_ref(*args, **kw))
            n_ok += 1
    # edge cases: empty cells, k above the live candidates, masked probes,
    # C = 13 and n = 64, self ids that sit in the probed cells
    g = torch.Generator().manual_seed(22)
    for c, cap, n, k, nprobe in ((13, 40, 64, 32, 5), (6, 3, 7, 13, 4)):
        e = _edge_index(c, cap, n, seed=c)
        q = torch.randn((300, n), generator=g).to(DEVICE)
        pr = torch.stack([torch.randperm(c, generator=g)[:nprobe]
                          for _ in range(300)]).to(torch.int32).to(DEVICE)
        sid = e.lists[pr[:, 0].long(), 0].contiguous()
        ok = (torch.rand((300, nprobe), generator=g) > 0.3).to(
            torch.int32).to(DEVICE)
        for payload in rt.PAYLOAD_DTYPES:
            ee = e if payload == "f32" else _quantized(e, payload)
            for measure in sim.MEASURES:
                args = (q, pr, ee.lists, ee.rows, ee.scale, ee.fill)
                kw = dict(k=k, measure=measure, self_ids=sid, probe_ok=ok)
                got = ivf_probe.fused_probe_topk(*args, **kw)
                _bitwise(f"fused_probe_topk C={c} {payload} {measure}", got,
                         ref.fused_probe_topk_ref(*args, **kw))
                if nprobe * cap < k and not torch.isinf(got[0][:, -1]).all():
                    raise AssertionError("k above the live candidates: "
                                         "the tail must be empty")
                n_ok += 1
    # the lifecycle's batch sizes (one query a block, its rows split over
    # the block's warps) and the graph build's queries shuffled (other
    # groups, other unions): bitwise the plain version, and the shuffled
    # lists the unshuffled ones moved
    perm = torch.randperm(u, generator=g).to(DEVICE)
    full = (rep, probe, index.lists, index.rows, index.scale, index.fill)
    base = ivf_probe.fused_probe_topk(*full, k=13, self_ids=self_ids)
    for tag, sel in (("b=64", torch.arange(u - 64, u, device=DEVICE)),
                     ("permuted", perm)):
        for payload in rt.PAYLOAD_DTYPES:
            idx = index if payload == "f32" else _quantized(index, payload)
            for measure in sim.MEASURES:
                args = (rep[sel], probe[sel], idx.lists, idx.rows, idx.scale,
                        idx.fill)
                kw = dict(k=13, measure=measure, self_ids=self_ids[sel])
                got = ivf_probe.fused_probe_topk(*args, **kw)
                _bitwise(f"fused_probe_topk {tag} {payload} {measure}", got,
                         ref.fused_probe_topk_ref(*args, **kw))
                if payload == "f32" and measure == "cosine":
                    _bitwise(f"fused_probe_topk {tag}: moved lists", got,
                             [x[sel] for x in base])
                n_ok += 1
    notes.append(f"fused probe {n_ok}/{n_ok} bitwise (b=64 and permuted "
                 f"queries among them)")
    # kernel 6: one partial-probe query block of the scorer
    qb = 256
    m = spec.nprobe * index.capacity
    cand = index.rows[probe[:qb].long()].reshape(qb, m, -1).contiguous()
    q = rep[:qb].contiguous()
    for measure in sim.MEASURES:
        _bitwise(f"score_candidates {measure}",
                 [score_candidates.score_candidates(q, cand, measure)],
                 [ref.score_candidates_ref(q, cand, measure)])
    notes.append("scorer 3/3 bitwise")
    patch, patch_ms = _check_backpatch(a)
    notes.append(patch)
    print("phase 7a back-patch (ms): " + json.dumps(patch_ms))
    wide, wide_ms = _check_wide()
    notes.append(wide)
    print("phase 7a wide rows (ms): " + json.dumps(wide_ms))
    print(f"phase 7a IVF kernels: index C={index.n_clusters} "
          f"cap={index.capacity} nprobe={spec.nprobe} over U={u} n="
          f"{rep.shape[1]}; " + "; ".join(notes)
          + f" | {time.perf_counter() - t0:.1f}s")
    return dict(index=index, probe=probe, self_ids=self_ids, cand=cand, q=q,
                all_rows=rep, capacity=capacity, wide_ms=wide_ms,
                patch_ms=patch_ms)


def _check_backpatch(a):
    """Kernel 6's shared form at the back-patch's shape — the lifecycle's
    8192-row bucket of the main path's representation against its 64
    folded rows, n = 20 — bitwise its plain version for every measure.
    Then, cosine, its time beside the two other ways to score the
    back-patch: the plain version's left-to-right sums on the card, and the
    library product of ``dense_similarity`` (whose bits follow the shape);
    and the wall time (median of 5) of one bucketed fold-in of the 64 rows
    (``buckets.fold_in_rows``, the lifecycle's and the engine's) with each
    of the three as ``core/graph.py::backpatch_sims``."""
    rep, _ = _capacity_rows(a["state"].representation)
    new = a["folded"].representation[-FOLD_IN:].contiguous()
    for measure in sim.MEASURES:
        _bitwise(f"score_candidates shared {measure}",
                 [score_candidates.score_candidates(rep, new, measure)],
                 [ref.gathered_sims(rep, new, measure)])
    c, n = rep.shape
    bound_ms, bound_by = kcost.score_candidates(c, FOLD_IN, n, True).bound()
    ways = {"kernel": None, "plain": ref.gathered_sims,
            "library": sim.dense_similarity}
    out = dict(shape=f"C={c} bq={FOLD_IN} n={n} cosine", bound_ms=bound_ms,
               bound_by=bound_by)
    bst = buckets.from_state(a["state"], LIFECYCLE_CAPACITY)
    rows = a["folded"].ratings[-FOLD_IN:]
    out["kernel_device_ms"] = _device_ms(
        lambda: score_candidates.score_candidates(rep, new, "cosine"),
        "score_candidates")
    for way, fn in ways.items():
        score = fn or score_candidates.score_candidates
        out[f"{way}_ms"] = _event_ms(lambda: score(rep, new, "cosine"), 20)
        with contextlib.ExitStack() as stack:
            if fn is not None:
                stack.enter_context(mock.patch(
                    "repro_torch.core.graph.backpatch_sims", fn))
            out[f"fold_in_{way}_ms"] = 1e3 * _wall_s(
                lambda: buckets.fold_in_rows(bst, rows, FOLD_IN, cfg.MODEL))
    return "back-patch scorer 3/3 bitwise (shared form)", out


# kernels 2-6 past n = 64: the narrow routes up to 104, the wide routes
# past it (ROADMAP A6); the times at n = 100 and at web_fit's 128
WIDE_WIDTHS = (100, 104, 105, 128, 256)
WIDE_TIMED = (100, 128)


def _wide_times(n, rows):
    """Kernels 2-6 at width n on the IVF build's shape (6040 rows, C = 78,
    8 Lloyd steps, the graph-build probe at nprobe 19, a 256-query scorer
    block), the graph build and a 64-row fold-in search over the same rows,
    and the back-patch's shared form (C = 8192, bq = 64): events ms over 20
    calls beside each bound (the operation and byte counts of _ivf_rows and
    phase_times)."""
    rng = np.random.default_rng(n)
    u = 6040
    x = rows(u, n)
    spec = rt.resolve_ivf(None, u)
    init = x[torch.as_tensor(rng.permutation(u)[:spec.n_clusters],
                             device=DEVICE)].contiguous()
    index = rt.build_index(x, spec, "cosine", centroids=init)
    c, cap = index.lists.shape
    probe = rt.probe_cells(index, x, spec.nprobe, "cosine")
    b, nprobe = probe.shape
    live = int(index.fill[probe.long()].sum())
    stored = int(index.fill.sum())
    sids = torch.arange(u, dtype=torch.int32, device=DEVICE)
    qb, m = 256, nprobe * cap
    cand = index.rows[probe[:qb].long()].reshape(qb, m, -1).contiguous()
    xr = kernel_rows(x, "cosine")
    new, k = xr[-FOLD_IN:].contiguous(), 13
    bucket, bq = torch.cat([x, rows(LIFECYCLE_CAPACITY - u, n)]), x[:FOLD_IN]
    cb = LIFECYCLE_CAPACITY
    cases = {
        "topk_sim": (
            lambda: knn_topk.topk_sim(xr, xr, k, exclude_self=True),
            kcost.topk(u, u, n, k)),
        "foldin_topk": (
            lambda: knn_topk.foldin_topk(new, xr, k, self_offset=u - FOLD_IN),
            kcost.topk(FOLD_IN, u, n, k)),
        "assign_clusters": (
            lambda: assign_clusters.kmeans_lloyd(x, init, spec.iters),
            kcost.kmeans(u, c, n, spec.iters)),
        "fused_probe_topk": (
            lambda: ivf_probe.fused_probe_topk(
                x, probe, index.lists, index.rows, None, index.fill, k=k,
                self_ids=sids),
            kcost.fused_probe(b, nprobe, c, cap, n, k, live, stored)),
        "score_candidates": (
            lambda: score_candidates.score_candidates(x[:qb], cand),
            kcost.score_candidates(qb, m, n, False)),
        "score_candidates shared": (
            lambda: score_candidates.score_candidates(bucket, bq),
            kcost.score_candidates(cb, FOLD_IN, n, True)),
    }
    times = {}
    for name, (fn, work) in cases.items():
        bound_ms, bound_by = work.bound()
        times[name] = dict(ms=_event_ms(fn, 20), bound_ms=bound_ms,
                           bound_by=bound_by)
    times["shape"] = (f"U={u} n={n} C={c} nprobe={nprobe} cap={cap} "
                      f"{spec.iters} Lloyd steps, {live} live probe pairs, "
                      f"scorer b={qb} m={m}, shared C={cb} bq={FOLD_IN}, "
                      f"top-k U=C={u} and b={FOLD_IN} k={k}")
    return times


def _check_wide():
    """Kernels 2–6 at n = 100, 104, 105, 128 and 256 against their plain
    versions, bitwise (every measure; the scan's graph build with a ragged
    n_valid and a fold-in search; the probe on every payload with masked
    probes and self ids; the Lloyd kernel at 0 and 8 steps, launched twice;
    the scorer in both forms), and their times at n = 100 and 128
    (``_wide_times``)."""
    rng = np.random.default_rng(24)
    g = torch.Generator().manual_seed(25)
    n_ok, times = 0, {}

    def rows(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=DEVICE)

    for n in WIDE_WIDTHS:
        x = rows(2000, n)
        for measure in sim.MEASURES:
            xr = kernel_rows(x, measure)
            _bitwise(f"topk_sim n={n} {measure}",
                     knn_topk.topk_sim(xr, xr, 13, exclude_self=True,
                                       n_valid=1990, measure=measure),
                     ref.foldin_topk_ref(xr, xr, 13, 0, 1990, measure))
            _bitwise(f"foldin_topk n={n} {measure}",
                     knn_topk.foldin_topk(xr[-64:].contiguous(), xr, 13,
                                          self_offset=1936, measure=measure),
                     ref.foldin_topk_ref(xr[-64:].contiguous(), xr, 13, 1936,
                                         None, measure))
            n_ok += 2
        init = x[torch.as_tensor(rng.permutation(2000)[:40],
                                 device=DEVICE)].contiguous()
        for measure in sim.MEASURES:
            for iters in (0, 8):
                want = ref.kmeans_lloyd_ref(x, init, iters, None, measure)
                for _ in range(2):
                    got = assign_clusters.kmeans_lloyd(x, init, iters, None,
                                                       measure)
                    sync()
                    if not all(torch.equal(_bits(a), _bits(b))
                               for a, b in zip(got, want)):
                        raise AssertionError(f"kmeans_lloyd n={n} {measure} "
                                             f"iters={iters}: not bitwise")
                    n_ok += 1
        e = _edge_index(13, 40, n, seed=n)
        q = torch.randn((300, n), generator=g).to(DEVICE)
        pr = torch.stack([torch.randperm(13, generator=g)[:5]
                          for _ in range(300)]).to(torch.int32).to(DEVICE)
        sid = e.lists[pr[:, 0].long(), 0].contiguous()
        ok = (torch.rand((300, 5), generator=g) > 0.3).to(torch.int32).to(
            DEVICE)
        for payload in rt.PAYLOAD_DTYPES:
            ee = e if payload == "f32" else _quantized(e, payload)
            for measure in sim.MEASURES:
                args = (q, pr, ee.lists, ee.rows, ee.scale, ee.fill)
                kw = dict(k=13, measure=measure, self_ids=sid, probe_ok=ok)
                _bitwise(f"fused_probe_topk n={n} {payload} {measure}",
                         ivf_probe.fused_probe_topk(*args, **kw),
                         ref.fused_probe_topk_ref(*args, **kw))
                n_ok += 1
        cand, qs = rows(64, 300, n), rows(64, n)
        for measure in sim.MEASURES:
            _bitwise(f"score_candidates n={n} {measure}",
                     [score_candidates.score_candidates(qs, cand, measure)],
                     [ref.score_candidates_ref(qs, cand, measure)])
            _bitwise(f"score_candidates shared n={n} {measure}",
                     [score_candidates.score_candidates(cand[0], qs,
                                                        measure)],
                     [ref.gathered_sims(cand[0], qs, measure)])
            n_ok += 2
    for n in WIDE_TIMED:
        times[f"n={n}"] = _wide_times(n, rows)
    return (f"n={'/'.join(map(str, WIDE_WIDTHS))} {n_ok}/{n_ok} bitwise",
            times)


LIFECYCLE_CAPACITY = 8192  # the lifecycle's bucket for 6040 rows


def _capacity_rows(rep):
    """``rep`` padded with zero rows to the lifecycle's capacity bucket, and
    its live-row count."""
    rows = torch.zeros((LIFECYCLE_CAPACITY, rep.shape[1]), device=DEVICE)
    rows[:rep.shape[0]] = rep
    return rows, rep.shape[0]


def _bits(t):
    """A tensor compared bit for bit (f32 as its int32 pattern)."""
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def _check_lloyd(rep, capacity):
    """Kernel 4 as a whole k-means against its plain version, bitwise, and
    a second launch against the first: 0, 1 and 8 steps, every measure."""
    rng = np.random.default_rng(23)

    def rows(u, n):
        return torch.as_tensor(rng.normal(size=(u, n)).astype(np.float32),
                               device=DEVICE)

    def first(x, c, nv):
        return (x[torch.as_tensor(rng.permutation(nv)[:c], device=DEVICE)]
                if c <= nv else x[:1].repeat(c, 1)).contiguous()

    cap, nv = capacity
    x500 = rows(500, 20)
    cases = [("IVF", rep, 77, None), ("n=64", rows(1001, 64), 13, None),
             ("C>U", rows(37, 33), 300, None), ("tiny", rows(9, 1), 1, None),
             ("n=25", rows(300, 25), 7, None),
             ("capacity", cap, 78, nv),
             ("empty cell", x500, None, None)]
    n_ok = 0
    for tag, x, c, n_valid in cases:
        if c is None:  # a far centroid no row is nearest to (euclidean)
            init = torch.cat([x[:5], torch.full((1, 20), 50.0,
                                                device=DEVICE)])
        else:
            init = first(x, c, x.shape[0] if n_valid is None else n_valid)
        for measure in sim.MEASURES:
            for iters in (0, 1, 8):
                want = ref.kmeans_lloyd_ref(x, init, iters, n_valid, measure)
                for _ in range(2):  # a second launch: the same bits
                    got = assign_clusters.kmeans_lloyd(x, init, iters,
                                                       n_valid, measure)
                    sync()
                    if not all(torch.equal(_bits(g), _bits(w))
                               for g, w in zip(got, want)):
                        raise AssertionError(
                            f"kmeans_lloyd {tag} {measure} iters={iters}: "
                            f"not bitwise its plain version")
                    n_ok += 1
                if c is None and measure == "euclidean" and iters == 8 and (
                        (want[1] == 5).any()
                        or not torch.equal(want[0][5], init[5])):
                    raise AssertionError("empty cell: not kept")
    return f"Lloyd {n_ok}/{n_ok} bitwise (two launches each)"


def phase_ivf_path(train, a):
    """7b: the IVF path at the ML-1M shape through the user's entry points.
    Returns this path's launch counts."""
    t0 = time.perf_counter()
    spec = cfg.MODEL
    u_fit = train.shape[0] - FOLD_IN
    matrix = RatingMatrix(train[:u_fit], u_fit, train.shape[1])
    kernel_graph = a["state"].graph
    c = rt.resolve_ivf(None, u_fit).n_clusters
    sync()
    ops.reset_launches()
    built, real_build = [], rt.build_index

    def keep(*args, **kw):  # the index fit builds, kept
        built.append(real_build(*args, **kw))
        return built[-1]

    with mock.patch.object(rt, "build_index", keep):
        st = fit(matrix, spec, backend="ivf")
    rec_fit = rt.recall_at_k(st.graph.indices, kernel_graph.indices)
    index = rt.build_index(st.representation, rt.resolve_ivf(None, u_fit),
                           spec.d2)
    if len(built) != 1 or not all(
            torch.equal(_bits(x), _bits(y)) for x, y in zip(
                (built[0].centroids, built[0].lists, built[0].rows,
                 built[0].fill),
                (index.centroids, index.lists, index.rows, index.fill))):
        raise AssertionError("IVF path: the index fit built and the one "
                             "built again from the same seed differ")
    folded = fold_in(st, train[u_fit:], spec, backend="ivf",
                     ivf_index=index)
    rec_fold = rt.recall_at_k(folded.graph.indices[u_fit:],
                              a["folded"].graph.indices[u_fit:])
    rep = st.representation
    sids = torch.arange(u_fit, dtype=torch.int32, device=DEVICE)
    nprobe = rt.resolve_ivf(None, u_fit).nprobe
    kv, ki = rt.search(index, rep, 13, nprobe, spec.d2, self_ids=sids,
                       scorer="kernel")
    fv, fi = rt.search(index, rep, 13, nprobe, spec.d2, self_ids=sids,
                       scorer="fused")
    sync()
    counts = _counts()
    d1 = ms.route_results()
    if not all(counts[name] > 0 for name in IVF_KERNELS):
        raise AssertionError(f"an IVF kernel did not launch: {counts}")
    _check_d1_routes("IVF path", counts, d1)
    if not torch.equal(st.representation, a["state"].representation):
        raise AssertionError("IVF path: the fit's representation differs "
                             "from the main path's")
    # the two scorers score with one algebra in one order: equal values
    # slot by slot; ids differ only in the order of exact ties
    if not torch.equal(kv, fv):
        raise AssertionError("kernel and fused scorers: values differ")
    bad = list_mismatches(kv, ki, fv, fi, RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"kernel vs fused scorer rows {bad[:8]}")
    # full probe: exact — the streaming backend under the tie rule, and the
    # fused kernel bitwise equal to its plain version there too
    full = rt.IVFSpec(nprobe=c)
    g_full = fit(matrix, spec, backend="ivf", ivf=full).graph
    g_str = fit(matrix, spec, backend="streaming").graph
    bad = list_mismatches(g_str.weights, g_str.indices, g_full.weights,
                          g_full.indices, RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"full-probe ivf vs streaming rows {bad[:8]}")
    pr = rt.probe_cells(index, rep, c, spec.d2)
    args = (rep, pr, index.lists, index.rows, index.scale, index.fill)
    _bitwise("fused_probe_topk full probe",
             ivf_probe.fused_probe_topk(*args, k=13, self_ids=sids),
             ref.fused_probe_topk_ref(*args, k=13, self_ids=sids))
    swapped = int((g_full.indices != g_str.indices).any(dim=1).sum())
    print(f"phase 7b IVF path: fit(backend=ivf) C={c} nprobe={nprobe} "
          f"recall@13 vs kernel graph {rec_fit:.4f}; the index fit built "
          f"and build_index again from its seed bitwise equal; 64-user ivf "
          f"fold-in "
          f"recall@13 {rec_fold:.4f}; nprobe=C equals streaming under the "
          f"tie rule ({swapped} of {u_fit} rows with a tie swapped at the "
          f"cut); kernel vs fused "
          f"scorer equal; launches {counts}; d1 results {d1}, the "
          f"representation bitwise the main path's | "
          f"{time.perf_counter() - t0:.1f}s")
    return counts


def phase_lifecycle():
    """7c: the lifecycle serve CLI with IVF retrieval, smoke and full
    width. Every kernel must launch in each run. Returns the full-width
    run's launch counts."""
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    out = {}
    for tag, argv in (
            ("smoke", ["--smoke", "--users", "128", "--items", "64",
                       "--waves", "6", "--arrivals", "32", "--requests",
                       "2", "--batch", "32", "--min-bucket", "128"]),
            ("full", ["--users", "6040", "--items", "3952", "--arrivals",
                      "64", "--foldin", "64", "--waves", "8"])):
        shutil.rmtree(ckpt, ignore_errors=True)
        buf = io.StringIO()
        t0 = time.perf_counter()
        ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            serve.main(["--workload", "cf", "--lifecycle", "--retrieval",
                        "ivf", "--early-exit", "--ckpt", str(ckpt)] + argv)
        sync()
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        idle = [name for name in CF_KERNELS if not counts[name] > 0]
        if idle:
            raise AssertionError(f"lifecycle {tag}: {idle} never launched "
                                 f"({counts})")
        _check_d1_routes(f"lifecycle {tag}", counts, d1)
        for want in ("cf lifecycle: done", "geometries per request-path"):
            if want not in text:
                raise AssertionError(f"lifecycle {tag}: missing {want!r}")
        if tag == "smoke":
            for want in ("refresh -> gen 1 launched in background",
                         "swapped in gen 1",
                         "swap oracle-exact vs from-scratch fit (gen 1): "
                         "True", "wave 5: gen 1"):
                if want not in text:
                    raise AssertionError(f"lifecycle smoke: missing {want!r}")
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("ivf retrieval: recall@k per wave"))
        mean = float(line.split("(mean ")[1].split(",")[0])
        if tag == "smoke" and mean < serve.IVF_RECALL_SLO:
            raise AssertionError(f"lifecycle smoke recall {mean}")
        out[tag] = counts
        print(f"phase 7c lifecycle CLI ({tag}): mean recall {mean:.3f}, "
              f"launches {counts}, d1 results {d1} | "
              f"{time.perf_counter() - t0:.1f}s")
    shutil.rmtree(ckpt, ignore_errors=True)
    return out["full"]


# ------------------------------------------------------------- LM slice
def _lm_inputs(p, n, s, d, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn((p, rows, d), generator=g, device=DEVICE).to(
        dtype) for rows in (n, s, s))


def _lm_model_shape():
    """(P, n, S, D) of phase 8b's summary launches: one problem per
    (batch, kv head), G·n_landmarks landmark queries each."""
    cfg = registry.get(LM_ARCH).model
    g = cfg.n_heads // cfg.n_kv_heads
    return (LM_BATCH * cfg.n_kv_heads, g * cfg.n_landmarks, LM_SEQ,
            cfg.head_dim)


def phase_lm_kernel():
    """8a: both routes of kernel 7 against the plain version, and the f32
    route's split pass bitwise against its plain version at the model
    shape, and at phase 15's DBRX and DeepSeek shapes. Returns the
    model-shape inputs and the largest error there, per dtype, and the same
    at the DeepSeek shape (bf16)."""
    t0 = time.perf_counter()
    notes, model_in, model_err = [], {}, {}
    shapes = [(1, 64, 1024, 64), (1, 128, 2048, 128), (1, 32, 512, 256),
              (1, 16, 777, 32), (2, 130, 300, 128), (2, 200, 777, 256),
              (1, 100, 60, 256), _moe_model_shape(DBRX_ARCH),
              _moe_model_shape(), _lm_model_shape()]
    ops.reset_launches()
    for i, (p, n, s_, d) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _lm_inputs(p, n, s_, d, dtype, seed=30 + i)
            got = ops.landmark_summary(q, k, v)
            want = ref.landmark_summary_ref(q, k, v, 1.0 / np.sqrt(d))
            sync()
            torch.testing.assert_close(got, want, rtol=LM_RTOL, atol=LM_ATOL)
            e = float((got - want).abs().max())
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            notes.append(f"P={p} n={n} S={s_} D={d} {tag} max|err| {e:.3g}")
            if i == len(shapes) - 1:
                model_err[dtype], model_in[dtype] = e, (q, k, v)
            elif (p, n, s_, d) == _moe_model_shape() and dtype == (
                    torch.bfloat16):
                moe_err, moe_in = e, (q, k, v)
    routes = dict(lsum.landmark_summary.route_launches)
    if routes != {"tensor_core": len(shapes), "f32_split": len(shapes)}:
        raise AssertionError(f"8a: launches by route {routes}, not "
                             f"{len(shapes)} each")
    for t, terms in zip(model_in[torch.float32],
                        (lsum.QK_TERMS, lsum.QK_TERMS, lsum.V_TERMS)):
        got, want = lsum.bf16_terms(t, terms), ref.bf16_terms(t, terms)
        sync()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"8a: split pass of {tuple(t.shape)} into "
                                 f"{terms} terms differs from its plain "
                                 f"version")
    print(f"phase 8a landmark summary kernels (rtol={LM_RTOL}, "
          f"atol={LM_ATOL}; launches by route {routes}): " + "; ".join(notes)
          + f"; split pass at the model shape bitwise equal | "
          f"{time.perf_counter() - t0:.1f}s")
    return model_in, model_err, moe_in, moe_err


def _smollm(**over):
    cfg = dataclasses.replace(registry.get(LM_ARCH).model, **over)
    return lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                      DEVICE)


def _forward_variants(model, batch, variants):
    """One landmark forward per (tag, summary function): the model's B̃V
    calls ops.landmark_summary, swapped for each function in turn. The
    counts are read from the timed run alone. ``ce`` is the loss without
    its MoE term (``lm_loss`` adds 0.01 · aux; aux is 0 for a dense
    model)."""
    out = {}
    with torch.inference_mode():
        for tag, fn in variants:
            with mock.patch.object(ops, "landmark_summary", fn):
                lm.lm_forward(model, batch["tokens"][
                    :, :2 * model.cfg.n_landmarks])
                sync()  # warm
                ops.reset_launches()
                lsum.bf16_terms.launches = 0
                t1 = time.perf_counter()
                logits, aux = lm.lm_forward(model, batch["tokens"])
                sync()
                wall = time.perf_counter() - t1
                counts = ops.launch_counts()
                routes = dict(lsum.landmark_summary.route_launches)
                splits = lsum.bf16_terms.launches
                loss = float(lm.lm_loss(model, batch))
            out[tag] = dict(logits=logits, counts=counts, routes=routes,
                            splits=splits, wall=wall, loss=loss,
                            aux=float(aux), ce=loss - 0.01 * float(aux))
    return out


def _check_forward(out, cfg, route, batch_size, tag_dtype):
    """The kernel forward launched kernel 7 once per layer, all on `route`
    (with three split passes each on the f32_split route); the plain one
    launched nothing; logits finite, shaped, within
    LM_LOGIT_REL of the plain forward's; both CE (the loss less its MoE
    term) near ln V. Returns the relative logit difference."""
    ka, pa = out["kernel"], out["plain"]
    want_routes = {r: cfg.n_layers if r == route else 0
                   for r in lsum.landmark_summary.route_launches}
    want_splits = 3 * cfg.n_layers if route == "f32_split" else 0
    if (ka["counts"]["landmark_summary"] != cfg.n_layers
            or ka["routes"] != want_routes or ka["splits"] != want_splits):
        raise AssertionError(f"{tag_dtype} landmark forward: kernel 7 "
                             f"launched {ka['counts']['landmark_summary']} "
                             f"times by route {ka['routes']} with "
                             f"{ka['splits']} split passes, not once per "
                             f"layer ({cfg.n_layers}) on {route}")
    if any(pa["counts"].values()) or pa["splits"]:
        raise AssertionError(f"plain forward launched kernels: "
                             f"{pa['counts']}")
    logits, want = ka["logits"], pa["logits"]
    if logits.shape != (batch_size, LM_SEQ, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{tag_dtype} landmark forward: logits not "
                             f"finite / shaped")
    rel = float((logits - want).abs().max() / want.abs().max())
    if rel > LM_LOGIT_REL:
        raise AssertionError(f"{tag_dtype} landmark forward: kernel vs plain "
                             f"logits differ by {rel:.4f} of max |logit|")
    for tag in ("kernel", "plain"):
        if not abs(out[tag]["ce"] - np.log(cfg.vocab)) < 2.0:
            raise AssertionError(f"{tag_dtype} {tag} CE {out[tag]['ce']} "
                                 f"is not near uniform "
                                 f"({np.log(cfg.vocab):.3f})")
    return rel


def phase_lm_forward():
    """8b: the landmark-attention forward at full SmolLM-360M width, with
    the kernel and with the plain B̃V, in bf16 (the tensor-core route), then
    in f32 at 2 layers (the f32_split route). Returns the launches of each
    route's kernel forward."""
    t0 = time.perf_counter()
    model = _smollm(attn_backend="landmark")
    cfg = model.cfg
    batch = {key: torch.as_tensor(val, device=DEVICE) for key, val in
             synthetic.lm_batch(0, 0, LM_BATCH, LM_SEQ, cfg.vocab).items()}

    def reversed_keys(q, k, v, scale):  # the same sum, in reverse key order
        return ref.landmark_summary_ref(q, k.flip(-2), v.flip(-2), scale)

    out = _forward_variants(model, batch, (
        ("kernel", ops.landmark_summary), ("plain", ref.landmark_summary_ref),
        ("reversed", reversed_keys)))
    rel = _check_forward(out, cfg, "tensor_core", LM_BATCH, "bf16")
    ka, pa = out["kernel"], out["plain"]
    want = pa["logits"]
    floor = float((out["reversed"]["logits"] - want).abs().max()
                  / want.abs().max())
    print(f"phase 8b landmark forward: {LM_ARCH} L={cfg.n_layers} "
          f"d={cfg.d_model} B={LM_BATCH} S={LM_SEQ} n={cfg.n_landmarks} "
          f"bf16, launches {ka['counts']} by route {ka['routes']} | CE "
          f"kernel {ka['loss']:.6f} plain {pa['loss']:.6f} (uniform "
          f"{np.log(cfg.vocab):.6f}); logits max|Δ|/max|logit| {rel:.5f} "
          f"(limit {LM_LOGIT_REL}; plain vs plain over reversed keys, the "
          f"bf16 floor: {floor:.5f}); forward wall kernel "
          f"{ka['wall'] * 1e3:.1f} ms, plain {pa['wall'] * 1e3:.1f} ms | "
          f"{time.perf_counter() - t0:.1f}s")
    launches = {"tensor_core": ka["routes"]["tensor_core"]}
    del out, want
    with torch.inference_mode():
        print("phase 8b profile (one landmark forward, kernel path): "
              + json.dumps(_profile(lambda: lm.lm_forward(
                  model, batch["tokens"]))))
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = _smollm(attn_backend="landmark", dtype=torch.float32, n_layers=2)
    cfg = model.cfg
    out = _forward_variants(model, batch, (
        ("kernel", ops.landmark_summary), ("plain", ref.landmark_summary_ref)))
    rel = _check_forward(out, cfg, "f32_split", LM_BATCH, "f32")
    ka, pa = out["kernel"], out["plain"]
    print(f"phase 8b f32 landmark forward: {LM_ARCH} full width, L cut to "
          f"{cfg.n_layers}, B={LM_BATCH} S={LM_SEQ}, f32, launches by route "
          f"{ka['routes']}, split passes {ka['splits']} | CE kernel {ka['loss']:.6f} plain "
          f"{pa['loss']:.6f}; logits max|Δ|/max|logit| {rel:.3g} (limit "
          f"{LM_LOGIT_REL}); forward wall kernel {ka['wall'] * 1e3:.1f} ms, "
          f"plain {pa['wall'] * 1e3:.1f} ms | "
          f"{time.perf_counter() - t0:.1f}s")
    launches["f32_split"] = ka["routes"]["f32_split"]
    del out, model
    torch.cuda.empty_cache()
    return launches


def phase_lm_serve():
    """8c: the LM serve CLI at full width, exact and landmark decode, and
    one exact decode step against the forward pass."""
    t0 = time.perf_counter()
    for extra in ([], ["--landmark"]):
        buf = io.StringIO()
        t1 = time.perf_counter()
        ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            serve.main(["--workload", "lm", "--arch", LM_ARCH] + extra)
        sync()
        lines = buf.getvalue().strip().splitlines()
        print("\n".join(lines))
        if not (lines[-3].startswith("prefill 4x32: ")
                and lines[-2].startswith("decode 16 tokens (")
                and lines[-1].startswith("sample ids: [")):
            raise AssertionError(f"lm serve {extra}: unexpected output")
        print(f"phase 8c lm serve CLI {' '.join(extra) or '(exact KV)'}: "
              f"{lines[-3]} | {lines[-2]} | launches {ops.launch_counts()} "
              f"| {time.perf_counter() - t1:.1f}s")
    model = _smollm()
    toks = torch.as_tensor(synthetic.lm_batch(0, 0, 2, 16, model.cfg.vocab)[
        "tokens"], device=DEVICE)
    with torch.inference_mode():
        logits_pre, cache = lm.lm_prefill(model, toks[:, :8], max_seq=16)
        dec, cache = lm.lm_decode_step(model, cache, toks[:, 8:9])
        full, _ = lm.lm_forward(model, toks[:, :9])
        served = lm.make_cache(model.cfg, 4, 48, DEVICE)
        served["length"].fill_(32)
        tok = toks[:, :1].repeat(2, 1)
        print("phase 8c profile (one exact decode step, B=4, cache 33/48): "
              + json.dumps(_profile(lambda: lm.lm_decode_step(
                  model, dict(served, length=served["length"].clone()),
                  tok))))
    err = float((dec[:, 0] - full[:, -1]).abs().max())
    if logits_pre.shape != (2, 1, model.cfg.vocab) or int(
            cache["length"]) != 9 or not err < DECODE_ATOL:
        raise AssertionError(f"exact decode vs forward: max|Δ| {err}, "
                             f"length {int(cache['length'])}")
    print(f"phase 8c decode vs forward: {LM_ARCH} full width, one exact "
          f"decode step after an 8-token prefill, max|Δ logits| {err:.4f} "
          f"(limit {DECODE_ATOL}) | {time.perf_counter() - t0:.1f}s")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ engine slice
# the kernels the engine CLI must launch at full width: d1 and the fold-in
# scan on the fold lane, the IVF sidecar's build (kernel 4), fused probe and
# candidate scorer
ENGINE_KERNELS = ("masked_similarity", "foldin_topk", "assign_clusters",
                  "fused_probe_topk", "score_candidates")
# the fold lane's device functions, as the profiler names them: d1 (planes,
# moments, finalize) and the fold-in top-k scan (prep, scan, merge)
FOLD_FUNCS = {"d1": ("planes_kernel", "moments_wgmma_kernel",
                     "masked_similarity_kernel"),
              "scan": ("topk_prep_kernel", "topk_scan_kernel",
                       "topk_merge_kernel")}
ENGINE_DIR = ROOT / "build" / "phase9"


def _thread_ids(lane):
    """The ids a profiler trace may give a lane's thread: its OS thread id
    (threads the profiler knows), or the low 32 bits of its pthread handle
    (CUPTI's default thread id), as unsigned, signed, or the magnitude of
    the signed value — the last is what torch 2.11's trace writes."""
    low = lane["ident"] & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= 1 << 31 else low
    return {lane["native_id"], low, signed, abs(signed)}


def _lane_streams(path, lanes):
    """Read the ``torch.profiler`` Chrome trace of the engine's load window
    (``obs.profile.profile_trace``: it opens with PROFILE_MARKERS spin
    kernels, dropped here): the streams of the fold lane's d1 and scan
    kernels and of the kernels the read lane's thread launched (each
    kernel's launch, by correlation id, names its thread), the launching
    threads of the fold lane's kernels, kernel counts by (lane, stream), the
    markers the profiler lost, and, when one survived, the device's busy
    share of the window (the union of kernel, copy and memset intervals from
    the last marker's end to the trace's end; None when every marker was
    lost, since the window's first records may be lost too)."""
    doc = json.loads(Path(path).read_text())
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    kernel = lambda e: e["name"] if e.get("cat") == "kernel" else ""
    kept, lost = obs_profile.strip_markers(evs, kernel)
    # the window opens where the last surviving marker ends
    opened = None if kept is None else max(
        e["ts"] + e["dur"] for e in evs if obs_profile.MARKER in kernel(e))
    evs = evs if kept is None else kept
    launcher = {e["args"]["correlation"]: e["tid"] for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    lane_of = {tid: name for name, lane in lanes.items()
               for tid in _thread_ids(lane)}
    fold = {lane: set() for lane in FOLD_FUNCS}
    lanes_by_kind = {kind: set() for kind in FOLD_FUNCS}
    fold_lanes, by_lane, spans = set(), {}, []
    for e in evs:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] != "kernel":
            continue
        stream = e["args"].get("stream")
        lane = lane_of.get(launcher.get(e["args"].get("correlation")),
                           "other")
        key = f"{lane}@{stream}"
        by_lane[key] = by_lane.get(key, 0) + 1
        for kind, funcs in FOLD_FUNCS.items():
            if any(f in e["name"] for f in funcs):
                fold[kind].add(stream)
                fold_lanes.add(lane)
                lanes_by_kind[kind].add(lane)
    t0 = min(e["ts"] for e in evs) if opened is None else opened
    t1 = max(e["ts"] + e["dur"] for e in evs)
    spans.sort()
    busy, end = 0.0, t0
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    share = None if opened is None else busy / (t1 - t0)
    read_streams = sorted({int(k.split("@")[1]) for k in by_lane
                           if k.startswith("engine-reads@")})
    write_streams = sorted({int(k.split("@")[1]) for k in by_lane
                            if k.startswith("engine-folds@")})
    return dict(fold_streams={k: sorted(v) for k, v in fold.items()},
                fold_lanes=sorted(fold_lanes), read_streams=read_streams,
                write_streams=write_streams,
                lanes_by_kind={k: sorted(v) for k, v in
                               lanes_by_kind.items()},
                kernels_by_lane_stream=by_lane, window_ms=(t1 - t0) / 1e3,
                markers_lost=lost, busy_share=share,
                idle_share=None if share is None else 1 - share,
                device_ops=len(spans),
                trace_mb=Path(path).stat().st_size / 2 ** 20)


def phase_engine():
    """9: the engine serve CLI, ``--smoke`` and at full width with the IVF
    sidecar, the obs exports and a torch.profiler capture of the load
    window. Each run: a bitwise-vs-solo audit with N > 0 re-runs and 0
    mismatches, no non-finite prediction, at least one fold, the read
    geometries within budget, every d1 call on the tensor-core route; at
    full width also every engine kernel launched, the exports through
    ``benchmarks/check_obs.py`` (read/fold overlap required), and the fold
    lane's d1 and scan kernels on a stream no read batch used. Returns the
    full run's launch counts."""
    from benchmarks import check_obs

    shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    trace, metrics, prof = (ENGINE_DIR / "trace", ENGINE_DIR / "metrics.json",
                            ENGINE_DIR / "profile")
    out = {}
    for tag, argv in (
            ("smoke", ["--smoke"]),
            ("full", ["--users", "6040", "--items", "3952", "--batch", "128",
                      "--foldin", "64", "--duration", "8", "--retrieval",
                      "ivf", "--early-exit", "--trace-dir", str(trace),
                      "--metrics-json", str(metrics), "--torch-profile",
                      str(prof)])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            res = serve.main(["--workload", "cf", "--engine"] + argv)
        sync()
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        want = (f"bitwise vs solo replay: {res['checked']} requests re-run, "
                f"0 mismatches | non-finite predictions: 0")
        if not (res["checked"] > 0 and res["mismatches"] == 0
                and want in text and res["nonfinite"] == 0):
            raise AssertionError(f"engine {tag}: audit {res['checked']} "
                                 f"re-run, {res['mismatches']} mismatches, "
                                 f"{res['nonfinite']} non-finite")
        if res["completed"]["fold"] < 1:
            raise AssertionError(f"engine {tag}: no fold batch completed")
        if max(res["geometries"].values()) > res["geometry_budget"]:
            raise AssertionError(f"engine {tag}: geometries "
                                 f"{res['geometries']} over budget "
                                 f"{res['geometry_budget']}")
        if not text.rstrip().endswith("cf engine: done"):
            raise AssertionError(f"engine {tag}: missing 'cf engine: done'")
        _check_d1_routes(f"engine {tag}", counts, d1)
        lanes = {}
        if tag == "full":
            idle = [k for k in ENGINE_KERNELS if not counts[k] > 0]
            if idle:
                raise AssertionError(f"engine full: {idle} never launched "
                                     f"({counts})")
            check_obs.check_trace(str(trace / "trace.json"),
                                  require_overlap=True)
            check_obs.check_metrics(str(metrics))
            lanes = _lane_streams(prof / "torch_trace.json", res["lane_ids"])
            fold = set().union(*lanes["fold_streams"].values())
            if not (all(lanes["fold_streams"].values())
                    and lanes["read_streams"]
                    and not fold & set(lanes["read_streams"])
                    and lanes["fold_lanes"] == ["engine-folds"]):
                raise AssertionError(f"engine full: the fold lane's kernels "
                                     f"do not run on a stream of their own: "
                                     f"{lanes}, lane ids {res['lane_ids']}")
        rl, fl = res["read_latency"], res["fold_latency"]
        print(f"phase 9 engine CLI ({tag}): sustained {res['qps']:.1f} QPS, "
              f"read p50/p95/p99 {rl.p50_ms:.3f}/{rl.p95_ms:.3f}/"
              f"{rl.p99_ms:.3f} ms ({rl.count} reads), shed_frac "
              f"{res['shed_frac']:.4f}, pad_frac {res['pad_frac']:.4f}, fold "
              f"p50/p99 {fl.p50_ms:.3f}/{fl.p99_ms:.3f} ms "
              f"({res['completed']['fold']} folds), audit {res['checked']} "
              f"re-run 0 mismatches, geometries {res['geometries']} (budget "
              f"{res['geometry_budget']}), launches {counts}, d1 results "
              f"{d1}" + (f", load window {json.dumps(lanes)}" if lanes else "")
              + f" | {time.perf_counter() - t0:.1f}s")
        out[tag] = counts
    return out["full"]


# ---------------------------------------------------------- mutation slice
MUTATION_DIR = ROOT / "build" / "phase10"
# the streaming rescan's euclidean epilogue |u|² − 2z + |v|² cancels between
# close rows, where the scan kernel sums (u − v)² in one fixed order: B3's
# bound of ROADMAP.md, as tests/test_torch_graph.py holds exact copies
EUCLID_ATOL = 2e-3
DEAD_ROWS = (100, 250, 999, 1500, 2000, 3001, 4500, 5975)
UPDATED_ROWS = (7, 300, 1234, 2500, 3999, 5000, 5900)  # + a landmark user


def _mutable(state, measure):
    """A MutableState over the main-path fit, its graph built under d2
    ``measure`` by the kernel backend (the fit's own graph for cosine)."""
    if measure != "cosine":
        state = dataclasses.replace(state, graph=build_neighbor_graph(
            state.representation, measure, cfg.MODEL.k_neighbors, "kernel"))
    return mutation.from_bucketed(buckets.from_state(state))


def _dirty_rows(mst):
    return torch.nonzero(mst.dirty & ~mst.tomb & (torch.arange(
        mst.capacity, device=mst.tomb.device) < mst.n_valid)).flatten()


def _rescan_plain(mst, measure):
    """The kernel rescan's pipeline — live rows gathered, top-(k+1), ids
    mapped back, self dropped — with the scan kernel's plain version on the
    same tensors: the graph rows the repair must write, bitwise."""
    rep, tomb = mst.bstate.state.representation, mst.tomb
    k = mst.bstate.state.graph.k
    sel = _dirty_rows(mst)
    live = torch.nonzero(~tomb[:mst.n_valid]).flatten()
    v, i = ref.foldin_topk_ref(kernel_rows(rep[sel], measure),
                               kernel_rows(rep[live], measure), k + 1, None,
                               live.numel(), measure)
    ids = torch.where(torch.isfinite(v), live[i.long()],
                      torch.zeros_like(live[i.long()])).to(torch.int32)
    return sel, finalize_topk(*filter_self_from_topk(v, ids, sel, k))


def _cites_dead(mst):
    """Citations of tombstoned rows in live rows' lists (inert slots
    excepted)."""
    g = mst.bstate.state.graph
    live = (torch.arange(mst.capacity, device=mst.tomb.device) < mst.n_valid
            ) & ~mst.tomb
    cited = mst.tomb[g.indices.long()] & ~((g.indices == 0) & (g.weights == 0))
    return int(cited[live].sum())


def _update_batch(state, p):
    ids = np.array((int(state.landmark_idx[0]),) + UPDATED_ROWS, np.int64)
    rows = _ratings(8, p, seed=31).cpu().numpy()
    return ids, rows


def _phase10_rescans(state):
    """10 (1): the kernel rescan bitwise its plain pipeline, and within the
    tie rule of the streaming rescan, for all three measures, after an
    8-user update (no tombstone) and after an 8-user removal; the drop-row
    scatters on the card with filler, out-of-range, negative and
    tombstoned ids. Returns notes."""
    p = state.ratings.shape[1]
    ids, rows = _update_batch(state, p)
    dead = np.array(DEAD_ROWS, np.int64)
    notes = []
    for measure in sim.MEASURES:
        spec = dataclasses.replace(cfg.MODEL, d2=measure)
        base = _mutable(state, measure)
        for tag, mst in (
                ("no tomb", mutation.update_ratings(base, ids, rows, 8, spec)),
                ("8 dead", mutation.remove_users(base, dead, 8))):
            sel, want = _rescan_plain(mst, measure)
            n0 = knn_topk.foldin_topk.launches
            kern, done = mutation.repair(mst, sel.numel(), spec,
                                         backend="kernel")
            sync()
            if knn_topk.foldin_topk.launches != n0 + 1 or done != sel.numel():
                raise AssertionError(f"rescan {measure} {tag}: launches "
                                     f"{knn_topk.foldin_topk.launches - n0}")
            stream, _ = mutation.repair(mst, sel.numel(), spec,
                                        backend="streaming")
            gk, gs = kern.bstate.state.graph, stream.bstate.state.graph
            if not (torch.equal(gk.indices[sel], want.indices)
                    and torch.equal(gk.weights[sel], want.weights)):
                raise AssertionError(f"rescan {measure} {tag}: not bitwise "
                                     f"its plain pipeline")
            atol = EUCLID_ATOL if measure == "euclidean" else ATOL
            bad = list_mismatches(gs.weights[sel], gs.indices[sel],
                                  gk.weights[sel], gk.indices[sel], RTOL, atol)
            if bad.size:
                raise AssertionError(f"rescan {measure} {tag}: rows "
                                     f"{sel[bad[:8]].tolist()} disagree with "
                                     f"the streaming rescan")
            diff = float((gk.weights[sel] - gs.weights[sel]).abs().max())
            notes.append(f"{measure} {tag}: {sel.numel()} rows bitwise, "
                         f"max |Δw| vs streaming {diff:.3g}")
    # the drop-row scatters: a noisy batch is bitwise its one effective row
    spec = cfg.MODEL
    base = mutation.remove_users(_mutable(state, "cosine"), dead, 8)
    noisy = np.array([DEAD_ROWS[0], 10 ** 6, -3, 7, DEAD_ROWS[1], 0, 0, 0])
    clean = np.array([7, -1, -1, -1, -1, -1, -1, -1])
    row = np.repeat(rows[:1], 8, axis=0)
    for tag, a_, b_ in (
            ("update", mutation.update_ratings(base, noisy, row, 5, spec),
             mutation.update_ratings(base, clean, row, 1, spec)),
            ("remove", mutation.remove_users(base, noisy, 5),
             mutation.remove_users(base, clean, 1))):
        got, want = _mutation_tensors(a_), _mutation_tensors(b_)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{tag}: ineffective ids changed the state")
    sync()
    notes.append("drop-row scatters: filler, out-of-range, negative and "
                 "tombstoned ids bitwise no-ops (update, remove)")
    # the IVF-backed repair at partial probe: the tombstone-masked search on
    # the gathered scorer (kernel 6), bitwise the plain scorer's lists
    n_valid, k = base.n_valid, base.bstate.state.graph.k
    rep = base.bstate.state.representation
    ivf = rt.resolve_ivf(rt.IVFSpec(), n_valid)
    index = rt.build_index(rep, ivf, "cosine", n_valid=n_valid)
    sel = _dirty_rows(base)
    n0 = ops.score_candidates.launches
    got, _ = mutation.repair(base, sel.numel(), spec, ivf_index=index,
                             nprobe=ivf.nprobe)
    sync()
    launched = ops.score_candidates.launches - n0
    v, i = rt.search(index, rep[sel], k, ivf.nprobe, "cosine", self_ids=sel,
                     tomb=base.tomb, scorer="plain")
    v, si = canonical_topk(v.masked_fill(i >= n_valid, float("-inf")), k)
    want = finalize_topk(v, i.gather(1, si))
    g = got.bstate.state.graph
    if not (launched > 0 and torch.equal(g.indices[sel], want.indices)
            and torch.equal(g.weights[sel], want.weights)
            and not _cites_dead(got)):
        raise AssertionError(f"ivf repair: {launched} gathered-scorer "
                             f"launches, not bitwise the plain scorer's, or "
                             f"a dead row cited")
    notes.append(f"ivf repair (C={index.n_clusters}, nprobe={ivf.nprobe}): "
                 f"{sel.numel()} rows bitwise the plain scorer's, {launched} "
                 f"gathered-scorer launches")
    return notes


def _mutation_tensors(mst):
    st = mst.bstate.state
    return (st.representation, st.ratings, st.graph.indices, st.graph.weights,
            mst.landmarks, mst.tomb, mst.dirty)


def _oracle_check(tag, mst, ratings, landmarks, live, spec):
    """The state's live rows against the port's own from-scratch build
    (kernel backend) over ``ratings[live]`` with the frozen basis: ratings
    and representation bitwise, the graph under the tie rule. Returns the
    count of graph weights that differ in any bit."""
    st = mst.bstate.state
    u = ratings.shape[0]
    rep = ops.masked_similarity(ratings, landmarks, spec.d1)
    if not (torch.equal(st.ratings[:u], ratings)
            and torch.equal(st.representation[:u], rep)):
        raise AssertionError(f"oracle {tag}: ratings or representation not "
                             f"bitwise the from-scratch ones")
    g = build_neighbor_graph(rep[live], spec.d2, spec.k_neighbors, "kernel")
    inert = (g.indices == 0) & (g.weights == 0)
    oi = torch.where(inert, torch.zeros_like(g.indices),
                     live[g.indices.long()].to(torch.int32))
    gi, gw = st.graph.indices[live], st.graph.weights[live]
    bad = list_mismatches(g.weights, oi, gw, gi, RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"oracle {tag}: rows {live[bad[:8]].tolist()} "
                             f"disagree beyond the tie rule")
    return int((gw.view(torch.int32) != g.weights.view(torch.int32)).sum())


def _phase10_oracle(state):
    """10 (2): update 8 users (one a landmark user) and remove 8 at full
    width, drain, compare with the port's own build over the mutated
    matrix; then compact and compare with a build over the survivors."""
    spec = cfg.MODEL
    u, p = state.ratings.shape
    mst0 = _mutable(state, "cosine")
    ids, rows = _update_batch(state, p)
    dead = torch.as_tensor(DEAD_ROWS, device=DEVICE)
    mst = mutation.update_ratings(mst0, ids, rows, 8, spec)
    mst = mutation.remove_users(mst, np.array(DEAD_ROWS), 8)
    cites = [_cites_dead(mst)]
    n0 = knn_topk.foldin_topk.launches
    dirty0 = mst.dirty_count()
    mst = mutation.drain_repairs(mst, spec)
    sync()
    rescans = knn_topk.foldin_topk.launches - n0
    cites.append(_cites_dead(mst))
    if any(cites) or mst.dirty_count() or not rescans:
        raise AssertionError(f"oracle: citations of dead rows {cites}, "
                             f"{mst.dirty_count()} dirty after the drain, "
                             f"{rescans} rescan launches")
    ratings = state.ratings.clone()
    ratings[torch.as_tensor(ids, device=DEVICE)] = torch.as_tensor(
        rows, device=DEVICE)
    ratings[dead] = 0.0
    live = torch.nonzero(~mst.tomb[:u]).flatten()
    bits = {"drained": _oracle_check("drained", mst, ratings, mst.landmarks,
                                     live, spec)}
    comp = mutation.compact_tombstones(mst)
    n = live.numel()
    if comp.n_valid != n or comp.tombstone_frac() != 0.0:
        raise AssertionError("compaction left tombstones")
    bits["compacted"] = _oracle_check(
        "compacted", comp, ratings[live], mst.landmarks,
        torch.arange(n, device=DEVICE), spec)
    # device time of one drain of 8 dirty rows
    eight = torch.zeros_like(mst0.dirty)
    eight[torch.as_tensor(UPDATED_ROWS + (0,), device=DEVICE)] = True
    mst8 = dataclasses.replace(mst0, dirty=eight)
    drain = lambda: mutation.drain_repairs(mst8, spec)
    times = dict(drain8_device_ms=_device_ms(drain, "repair_drain"),
                 drain8_event_ms=_event_ms(drain, 20))
    return dict(dirty_rows=dirty0, rescan_launches=rescans,
                live_rows=n, weights_differing_in_any_bit=bits, **times)


def phase_mutation(state, card):
    """10: the write path on the card — the rescan and scatter checks and
    the full-width oracle, then ``serve --engine --mutations`` ``--smoke``
    and at full width (obs exports and a torch.profiler capture under
    ``build/phase10/``): each run's audit N > 0 with 0 mismatches, no
    non-finite prediction, the pre-compaction bar, the repair rescans on
    the scan kernel, every write-lane kernel on the fold lane's stream;
    the smoke's compacting swap; at full width at least one update and
    one removal. Returns the full run's launch counts."""
    from benchmarks import check_obs

    t0 = time.perf_counter()
    notes = _phase10_rescans(state)
    print("phase 10 rescans: " + "; ".join(notes))
    oracle = _phase10_oracle(state)
    print(f"phase 10 oracle ({card}): {json.dumps(oracle)}")
    shutil.rmtree(MUTATION_DIR, ignore_errors=True)
    trace, metrics, prof = (MUTATION_DIR / "trace",
                            MUTATION_DIR / "metrics.json",
                            MUTATION_DIR / "profile")
    rescans = {"n": 0}
    real_repair = mutation.mutate.repair

    def counted_repair(*a, **kw):  # the rescans' launches, counted apart
        n0 = knn_topk.foldin_topk.launches
        out = real_repair(*a, **kw)
        rescans["n"] += knn_topk.foldin_topk.launches - n0
        return out

    out = {}
    for tag, argv in (
            ("smoke", ["--smoke"]),
            ("full", ["--users", "6040", "--items", "3952", "--batch", "128",
                      "--foldin", "64", "--duration", "8", "--trace-dir",
                      str(trace), "--metrics-json", str(metrics),
                      "--torch-profile", str(prof)])):
        buf = io.StringIO()
        t1 = time.perf_counter()
        rescans["n"] = 0
        ops.reset_launches()
        with contextlib.redirect_stdout(buf), \
                mock.patch.object(mutation.mutate, "repair", counted_repair):
            res = serve.main(["--workload", "cf", "--engine", "--mutations"]
                             + argv)
        sync()
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        mut = res["mutations"]
        want = (f"bitwise vs solo replay: {res['checked']} requests re-run, "
                f"0 mismatches | non-finite predictions: 0")
        if not (res["checked"] > 0 and res["mismatches"] == 0
                and want in text and res["nonfinite"] == 0):
            raise AssertionError(f"mutations {tag}: audit {res['checked']} "
                                 f"re-run, {res['mismatches']} mismatches, "
                                 f"{res['nonfinite']} non-finite")
        if not text.rstrip().endswith("cf engine: done"):
            raise AssertionError(f"mutations {tag}: no 'cf engine: done'")
        if mut["cites_dead"] or mut["dirty_published"]:
            raise AssertionError(f"mutations {tag}: pre-compaction bar {mut}")
        if not (res["completed"]["update"] >= 1
                and res["completed"]["remove"] >= 1):
            raise AssertionError(f"mutations {tag}: completed "
                                 f"{res['completed']}")
        if not rescans["n"] > 0:
            raise AssertionError(f"mutations {tag}: no repair rescan "
                                 f"launched the scan kernel")
        if tag == "smoke" and not (
                "refresh swap: " in text and "tombstone_frac=0.000"
                in text.split("refresh swap: ")[1].splitlines()[0]):
            raise AssertionError("mutations smoke: no compacting swap")
        _check_d1_routes(f"mutations {tag}", counts, d1)
        lanes = {}
        if tag == "full":
            check_obs.check_trace(str(trace / "trace.json"),
                                  require_overlap=True)
            check_obs.check_metrics(str(metrics))
            lanes = _lane_streams(prof / "torch_trace.json", res["lane_ids"])
            reads = set(lanes["read_streams"])
            if not (lanes["write_streams"] and reads
                    and not reads & set(lanes["write_streams"])
                    and lanes["lanes_by_kind"]["scan"] == ["engine-folds"]
                    and not reads & set(lanes["fold_streams"]["d1"])):
                raise AssertionError(f"mutations full: a write-lane kernel "
                                     f"ran on the read lane's stream: "
                                     f"{lanes}, lane ids {res['lane_ids']}")
        rl = res["read_latency"]
        wl = {k: f"{v.p50_ms:.3f}/{v.p99_ms:.3f} ms ({v.count})"
              for k, v in mut["write_latency"].items()}
        print(f"phase 10 mutations CLI ({tag}, {card}): sustained "
              f"{res['qps']:.1f} QPS, read p50/p95/p99 {rl.p50_ms:.3f}/"
              f"{rl.p95_ms:.3f}/{rl.p99_ms:.3f} ms ({rl.count} reads), "
              f"write p50/p99 {wl}, mutated_rows {res['mutated_rows']}, "
              f"repaired_rows {res['repaired_rows']}, tombstone_frac "
              f"{res['tombstone_frac']:.4f}, swap "
              f"{ {k: mut.get(k) for k in ('compacted', 'swap_gen')} }, "
              f"rescan launches {rescans['n']}, audit {res['checked']} re-run "
              f"0 mismatches, launches {counts}, d1 results {d1}"
              + (f", load window {json.dumps(lanes)}" if lanes else "")
              + f" | {time.perf_counter() - t1:.1f}s")
        out[tag] = counts
    print(f"phase 10: {time.perf_counter() - t0:.1f}s")
    return out["full"]


# ------------------------------------------------------ paper comparison
PAPER_DIR = ROOT / "build" / "phase11"
# card against CPU from the same initial parameters and permutation, one
# epoch at the ML-1M fold-0 shape (109 steps): f32 sums in other orders and
# the card's accumulation order in the gathers' backward, compounded over
# the steps; parameters are of scale 0.1-1
MF_PARAM_ATOL = 1e-4  # the largest |difference| of any parameter
MF_MAE_ATOL = 1e-5  # |MAE(card) - MAE(CPU)| on the fold's test pairs
# one Gibbs sweep, card against CPU on the same draws: batched Cholesky
# solves and inverses of other libraries (cuSOLVER / LAPACK), factors of
# scale ~0.1
BPMF_ATOL = 1e-4
# the reference's own bars (tests/test_system.py:56-57): landmark MAE,
# kNN and model-based MAE, and claim C3 (landmark within 0.02 of cosine kNN)
LANDMARK_MAE_BAR, BASELINE_MAE_BAR, C3_SLACK = 1.1, 1.2, 0.02
# compact reads against the widened graph's reads: the reference's bf16
# tolerance (tests/test_lifecycle.py)
COMPACT_TOL = 2e-2
# the kernels each part of phase 11 must launch: every landmark row of
# Table 15 runs d1 and the d2 scan; the lifecycle under --compact-serving
# --retrieval ivf folds in (the fold-in scan) and builds and probes its index
PAPER_KERNELS = {"table 15": ("masked_similarity", "topk_sim"),
                 "serve": ("masked_similarity", "foldin_topk",
                           "assign_clusters", "fused_probe_topk")}


def _paper_mf(d, tr, te):
    """11a: each MF configuration, one epoch, on the card and on the CPU
    from the same initial parameters and permutation."""
    out = {}
    users, items, ratings = d.users[tr], d.items[tr], d.ratings[tr]
    perms = [torch.randperm(len(tr), generator=torch.Generator().manual_seed(
        1))]
    for name, cfgf in paper.MF_CONFIGS:
        cfg_mf = cfgf(d.n_users, d.n_items, epochs=1)
        init = mf._init(cfg_mf, float(np.mean(ratings, dtype=np.float64)),
                        "cpu")
        res, maes = {}, {}
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            params, aux = mf.fit_mf(users, items, ratings, cfg_mf, device=dev,
                                    init=init, perms=perms)
            preds = mf.predict_mf(params, cfg_mf, d.users[te], d.items[te],
                                  aux)
            if dev == DEVICE:
                sync()
            res[dev] = (params, time.perf_counter() - t0)
            maes[dev] = data.mae(np.clip(preds.cpu().numpy(), 1, 5),
                                 d.ratings[te])
        diff = max(float((c.cpu() - p).abs().max()) for c, p in
                   zip(res[DEVICE][0], res["cpu"][0]))
        # the gathers' backward on the card: the same bits run to run?
        again, _ = mf.fit_mf(users, items, ratings, cfg_mf, device=DEVICE,
                             init=init, perms=perms)
        rerun = all(torch.equal(x, y) for x, y in zip(again, res[DEVICE][0]))
        dmae = abs(maes[DEVICE] - maes["cpu"])
        moved = float((res[DEVICE][0].mu.cpu() - init.mu).abs())
        if not (diff <= MF_PARAM_ATOL and dmae <= MF_MAE_ATOL
                and all(torch.isfinite(t).all() for t in res[DEVICE][0])):
            raise AssertionError(f"11a {name}: card vs CPU parameters differ "
                                 f"by {diff} (bound {MF_PARAM_ATOL}), MAE by "
                                 f"{dmae} (bound {MF_MAE_ATOL})")
        if (moved > 0) != cfg_mf.use_bias:
            raise AssertionError(f"11a {name}: mu moved by {moved}")
        out[name] = dict(max_param_diff=diff, mae_card=maes[DEVICE],
                         mae_diff=dmae, mu_moved=moved,
                         card_rerun_bitwise=rerun,
                         card_s=res[DEVICE][1], cpu_s=res["cpu"][1])
    return out


def _paper_bpmf(d, tr):
    """11b: one Gibbs sweep at the ML-1M shape, card against CPU, on the
    same draws (one seeded CPU generator each)."""
    bcfg = bpmf.BPMFConfig(d.n_users, d.n_items)
    out = {}
    for dev in (DEVICE, "cpu"):
        draws = bpmf.TorchDraws(bcfg.seed, dev)
        rc, m, _ = bpmf.centered_block(d.users[tr], d.items[tr],
                                       d.ratings[tr], bcfg, dev)
        p0 = draws.normal((bcfg.n_users, bcfg.dim)) * 0.1
        q0 = draws.normal((bcfg.n_items, bcfg.dim)) * 0.1
        t0 = time.perf_counter()
        out[dev] = bpmf.gibbs_step(draws, p0, q0, rc, m, bcfg)
        if dev == DEVICE:
            sync()
        out[dev + "_s"] = time.perf_counter() - t0
    diff = max(float((c.cpu() - p).abs().max())
               for c, p in zip(out[DEVICE], out["cpu"]))
    if not diff <= BPMF_ATOL or not all(torch.isfinite(t).all()
                                        for t in out[DEVICE]):
        raise AssertionError(f"11b: a Gibbs sweep, card vs CPU, differs by "
                             f"{diff} (bound {BPMF_ATOL})")
    return dict(max_factor_diff=diff, card_s=out[DEVICE + "_s"],
                cpu_s=out["cpu_s"])


def _paper_table(d):
    """11c: Table 15 on the card, every row, held to the reference's
    bars."""
    ops.reset_launches()
    rows = paper.tab15_comparative("movielens1m", data=d, device=DEVICE)
    sync()
    counts = _counts()
    by = {r["algo"]: r for r in rows}
    lm_mae = by["Landmarks kNN"]["mae"]
    bad = [r["algo"] for r in rows[1:] if not r["mae"] < BASELINE_MAE_BAR]
    if not (lm_mae < LANDMARK_MAE_BAR and not bad
            and lm_mae <= by["cosine kNN"]["mae"] + C3_SLACK
            and len(rows) == 9):
        raise AssertionError(f"11c: Table 15 misses the reference's bars: "
                             f"landmark {lm_mae}, over {BASELINE_MAE_BAR}: "
                             f"{bad}, cosine kNN {by['cosine kNN']['mae']}")
    return rows, counts


def _paper_profiles(d, tr):
    """Where the model-based rows' time goes on the card: the profiler
    over one RSVD epoch (109 autograd steps) and one BPMF sweep."""
    cfg_mf = mf.rsvd_config(d.n_users, d.n_items, epochs=1)
    bcfg = bpmf.BPMFConfig(d.n_users, d.n_items)
    rc, m, _ = bpmf.centered_block(d.users[tr], d.items[tr], d.ratings[tr],
                                   bcfg, DEVICE)
    draws = bpmf.TorchDraws(0, DEVICE)
    p0 = draws.normal((bcfg.n_users, bcfg.dim)) * 0.1
    q0 = draws.normal((bcfg.n_items, bcfg.dim)) * 0.1
    return {
        "rsvd_epoch": _profile(lambda: mf.fit_mf(
            d.users[tr], d.items[tr], d.ratings[tr], cfg_mf, device=DEVICE)),
        "bpmf_sweep": _profile(lambda: bpmf.gibbs_step(draws, p0, q0, rc, m,
                                                       bcfg))}


def _paper_compact(state, pairs):
    """11d, on the main-path fit: the compact serving graph's reads against
    the widened graph's, at the reference's bf16 tolerance."""
    bst = buckets.from_state(state)
    cst = buckets.compact_state(bst)
    g, gc = bst.state.graph, cst.state.graph
    if not (gc.indices.dtype == torch.uint16 and gc.indices.is_cuda
            and buckets.compact_state(cst) is cst):
        raise AssertionError(f"11d: compact graph {gc.indices.dtype}")
    users, items = pairs[0], pairs[1]
    ids, _ = knn._gathered(gc, users, torch.float32)
    full_ids, _ = knn._gathered(g, users, torch.float32)
    got = buckets.predict_pairs(cst, users, items)
    want = buckets.predict_pairs(bst, users, items)
    torch.testing.assert_close(got, want, rtol=COMPACT_TOL, atol=COMPACT_TOL)
    top_c, _ = buckets.recommend_topn(cst, users[:TOPN_USERS])
    if not torch.equal(ids, full_ids) or (top_c < 0).any():
        raise AssertionError("11d: the uint16 gather or top-N differs")
    return dict(pairs=int(users.shape[0]),
                max_read_diff=float((got - want).abs().max()),
                resident_kb=(gc.indices.nbytes + gc.weights.nbytes) / 1024,
                full_kb=(g.indices.nbytes + g.weights.nbytes) / 1024)


def _paper_serve():
    """11d: ``serve --compact`` at ML-1M width, and the lifecycle smoke with
    ``--compact-serving --retrieval ivf``."""
    shutil.rmtree(PAPER_DIR, ignore_errors=True)
    out = {}
    ops.reset_launches()
    for tag, argv, want in (
            ("compact", ["--users", "6040", "--items", "3952", "--waves", "2",
                         "--foldin", "64", "--compact"], "cf serve: done"),
            ("compact-serving", ["--lifecycle", "--retrieval", "ivf",
                                 "--smoke", "--compact-serving"],
             "cf lifecycle: done")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(["--workload", "cf", "--ckpt", str(PAPER_DIR / tag)]
                       + argv)
        sync()
        text = buf.getvalue()
        print(text, end="")
        if not text.rstrip().endswith(want):
            raise AssertionError(f"11d {tag}: no {want!r}")
        if tag == "compact":
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("loaded "))
            if "stored compact" not in line:
                raise AssertionError(f"11d: artifact not stored compact: "
                                     f"{line}")
        else:
            line = next((ln for ln in text.splitlines()
                         if "serving graph compacted" in ln), None)
            if line is None or "swap oracle-exact vs from-scratch fit (gen " \
                    "1): True" not in text:
                raise AssertionError("11d: no compacted wave or no "
                                     "oracle-exact swap")
        out[tag] = dict(line=line, s=time.perf_counter() - t0)
    sync()
    return out, _counts()


def phase_paper(d, tr, te, a, card):
    """11: the paper's comparison on the card — (a) the four MF baselines,
    one epoch, card against CPU; (b) one BPMF Gibbs sweep, card against
    CPU; (c) Table 15 on the card with the reference's bars; (d) compact
    serving: reads of the compact main-path graph, ``serve --compact`` and
    ``serve --lifecycle --retrieval ivf --smoke --compact-serving``.
    Returns the launches of (c) and (d) together."""
    t0 = time.perf_counter()
    t = time.perf_counter()
    mf_out = _paper_mf(d, tr, te)
    print(f"phase 11a MF card vs CPU, one epoch (bounds: parameters "
          f"{MF_PARAM_ATOL}, MAE {MF_MAE_ATOL}): {json.dumps(mf_out)} | "
          f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    print(f"phase 11b BPMF one Gibbs sweep card vs CPU (bound {BPMF_ATOL}): "
          f"{json.dumps(_paper_bpmf(d, tr))} | {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    rows, table_counts = _paper_table(d)
    for r in rows:
        print(f"phase 11c Table 15 ({card}): {r['algo']:14s} MAE "
              f"{r['mae']:.4f}  {r['time_s']:.4f}s  {r['rel']:.1f}x")
    d1 = ms.route_results()
    _check_d1_routes("phase 11 table 15", table_counts, d1)
    print(f"phase 11c Table 15 rows: {json.dumps(rows)}, launches "
          f"{table_counts}, d1 results {d1} | {time.perf_counter() - t:.1f}s")
    print("phase 11c profile (one RSVD epoch; one BPMF sweep): " + json.dumps(
        _paper_profiles(d, tr)))
    t = time.perf_counter()
    reads = _paper_compact(a["state"], a["fit_pairs"])
    serve_out, serve_counts = _paper_serve()
    d1 = ms.route_results()
    _check_d1_routes("phase 11 serve", serve_counts, d1)
    print(f"phase 11d compact serving: reads {json.dumps(reads)} (tolerance "
          f"{COMPACT_TOL}); {json.dumps(serve_out)}; launches {serve_counts}, "
          f"d1 results {d1} | {time.perf_counter() - t:.1f}s")
    for part, counts in (("table 15", table_counts), ("serve", serve_counts)):
        idle = [k for k in PAPER_KERNELS[part] if not counts[k] > 0]
        if idle:
            raise AssertionError(f"phase 11 {part}: {idle} never launched "
                                 f"({counts})")
    print(f"phase 11: {time.perf_counter() - t0:.1f}s")
    return {k: table_counts[k] + serve_counts[k] for k in table_counts}


MESH_DIR = ROOT / "build" / "phase12"
MESH_RUNS = (
    ("full", ["--mesh", "pod=2,data=2", "--users", "6040", "--items",
              "3952", "--arrivals", "64", "--foldin", "64", "--waves", "8",
              "--retrieval", "ivf", "--early-exit"]),
    ("smoke", ["--smoke", "--mesh", "pod=2,data=4", "--users", "128",
               "--items", "64", "--waves", "6", "--arrivals", "32",
               "--requests", "2", "--batch", "32", "--min-bucket", "128"]))
MESH_KERNELS = {"full": GRAPH_KERNELS + IVF_KERNELS,
                "smoke": GRAPH_KERNELS + ("score_candidates",)}


def _mesh_search(a):
    """search_sharded at full probe on the main path's representation over
    a 4-shard mesh against ``search`` on one device: vals and ids bitwise
    (the fused probe on every shard, the canonical merge)."""
    from repro_torch.distributed.sharding import cf_shard_count
    from repro_torch.launch.mesh import make_mesh

    rep = a["state"].representation
    mesh = make_mesh(("pod", "data"), (2, 2))
    axes = ("pod", "data")
    spec = rt.resolve_ivf_sharded(None, rep.shape[0],
                                  cf_shard_count(mesh, axes))
    index = rt.build_index(rep, spec, "cosine")
    sharded = rt.shard_index(index, mesh, axes)
    q = rep[:512]
    sids = torch.arange(512, dtype=torch.int32, device=DEVICE)
    want = rt.search(index, q, 13, spec.n_clusters, "cosine", self_ids=sids)
    got = rt.search_sharded(sharded, q, 13, spec.n_clusters, "cosine",
                            self_ids=sids)
    _bitwise("search_sharded at full probe", got[:2], want)
    if not bool((got[2] == spec.n_clusters).all()):
        raise AssertionError("full probe: every cell scored once")
    return (f"search_sharded full probe C={spec.n_clusters} over 4 shards "
            f"bitwise search on one device (512 queries)")


def _product_bits():
    """The row counts M at which rows of one f32 product ``A[:M] @ B.T``
    differ in any bit from the same rows of the M = 8192 product (K the
    landmark axis, N a fold-in batch): why the back-patch sums left to
    right (``core/graph.py::backpatch_sims``) rather than through a
    library product whose kernel follows the shape."""
    g = torch.Generator().manual_seed(26)
    out = {}
    for k, n in ((8, 32), (20, 64)):
        a = torch.randn((8192, k), generator=g).to(DEVICE)
        b = torch.randn((n, k), generator=g).to(DEVICE)
        full = a @ b.T
        out[f"K={k} N={n}"] = [m for m in (16, 32, 64, 128, 512, 2048)
                               if not torch.equal((a[:m] @ b.T)[:16],
                                                  full[:16])]
    return out


def _mesh_launches(counts, res):
    """The mesh path's own launches in one replay: every launch of the run
    less those the replay tallied beside it on its thread (the one-device
    shadow, the oracle fit, the materialization checks). Raises unless
    kernels 1-2 launched at least once a shard for every fit
    (``fit_distributed``: d1 and the scan on each shard) and kernels 3 and
    6 at least once a shard for every fold-in batch (the shard-local scan
    and back-patch)."""
    mesh = {k: c - res["side_launches"].get(k, 0) for k, c in counts.items()}
    s = res["shards"]
    need = {"masked_similarity": s * res["mesh_fits"],
            "topk_sim": s * res["mesh_fits"],
            "foldin_topk": s * res["mesh_fold_batches"],
            "score_candidates": s * res["mesh_fold_batches"]}
    short = {k: (mesh[k], n) for k, n in need.items() if mesh[k] < n}
    if short:
        raise AssertionError(f"mesh path launched fewer than one a shard "
                             f"(launched, needed): {short}")
    return mesh


def phase_mesh(a, card):
    """12: the sharded lifecycle replay at full width and as the reference's
    smoke, on the card. Returns the two runs' mesh-path launch counts
    summed (the shadow's and the checks' left out)."""
    t0 = time.perf_counter()
    total = {}
    for tag, argv in MESH_RUNS:
        ckpt = MESH_DIR / tag
        shutil.rmtree(ckpt, ignore_errors=True)
        buf = io.StringIO()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = serve.main(["--workload", "cf", "--lifecycle", "--ckpt",
                              str(ckpt)] + argv)
        sync()
        seconds = time.perf_counter() - t1
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        checks = {
            "bitwise every wave": res["identical_waves"] == res["waves"],
            "row shards on disk": res["row_shards"] == res["shards"],
            "every block on the card": all(
                d.startswith(DEVICE) for d in res["block_devices"]),
            "no S·C-row fold-in tensor":
                "0 full-row materializations" in text,
        }
        if tag == "smoke":
            checks["oracle-exact distributed refresh"] = (
                res["refreshed"] and "oracle-exact" in text
                and "launched on the mesh" in text)
        if "--early-exit" in argv:
            checks["ivf serve-path check"] = (
                "0 candidate-tensor materializations" in text)
        failed = [k for k, ok in checks.items() if not ok]
        mesh = _mesh_launches(counts, res)
        idle = [name for name in MESH_KERNELS[tag] if not mesh[name] > 0]
        if failed or idle:
            raise AssertionError(f"mesh {tag}: failed {failed}, never "
                                 f"launched on the mesh {idle} ({mesh})")
        _check_d1_routes(f"mesh {tag}", counts, d1)
        for name, c in mesh.items():
            total[name] = total.get(name, 0) + c
        swap = (f"swapped in at wave {res['swap_wave']}" if res["refreshed"]
                else "not fired")
        print(f"phase 12 mesh lifecycle ({tag}, {card}): {res['mesh']}; "
              f"{res['identical_waves']}/{res['waves']} waves bitwise the "
              f"one-device shadow; refresh {swap}; "
              f"row_shards={res['row_shards']}; blocks on "
              f"{res['block_devices']}; mesh path ms a wave "
              f"{[round(x, 1) for x in res['wave_ms']]} (shadow and "
              f"checks beside it: {[round(x, 1) for x in res['side_ms']]}); "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
              f"MiB; {res['mesh_fits']} fits, {res['mesh_fold_batches']} "
              f"fold-in batches; mesh launches {mesh}; shadow and checks "
              f"{res['side_launches']}; {seconds:.1f}s")
    print(f"phase 12 sharded search: {_mesh_search(a)}")
    print("phase 12 product bits (rows differing from M=8192 at M): "
          + json.dumps(_product_bits()))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    print(f"phase 12: {time.perf_counter() - t0:.1f}s")
    return total


ENGINE_MESH_DIR = ROOT / "build" / "phase13"
# the engine on a mesh: phase 9's full-width settings with the IVF sidecar
# and phase 10's with mutations, on 4 shards of the card, and the 8-shard
# smoke with mutations (whose compacting refresh fires); the full runs'
# load window is cut from 8 s to 4 s
ENGINE_MESH_WINDOW_S = 4
ENGINE_MESH_RUNS = (
    ("full ivf", ["--mesh", "pod=2,data=2", "--users", "6040", "--items",
                  "3952", "--batch", "128", "--foldin", "64", "--duration",
                  str(ENGINE_MESH_WINDOW_S), "--retrieval", "ivf",
                  "--early-exit"]),
    ("full mutations", ["--mesh", "pod=2,data=2", "--users", "6040",
                        "--items", "3952", "--batch", "128", "--foldin",
                        "64", "--duration", str(ENGINE_MESH_WINDOW_S),
                        "--mutations"]),
    ("smoke mutations", ["--smoke", "--mesh", "pod=2,data=4",
                         "--mutations"]))


def _update_backpatch(a):
    """The update's back-patch block on the card: ``update_ratings`` on the
    main path's fit in the lifecycle's 8192-row bucket, for 8, 16 and 64
    updated users; the (8192, b) block it scores must be one launch of
    kernel 6's shared form and ``ref.gathered_sims`` bit for bit."""
    from repro_torch.mutation import mutate

    bst = buckets.from_state(a["state"], LIFECYCLE_CAPACITY)
    mst = mutation.from_bucketed(bst)
    new_rows = a["folded"].ratings[-FOLD_IN:]
    out = {}
    for b in (8, 16, 64):
        blocks, real = [], mutate.backpatch_sims

        def spy(rep, new_rep, measure):
            got = real(rep, new_rep, measure)
            blocks.append((rep, new_rep, measure, got))
            return got

        ids = (np.arange(b) * 89) % bst.n_valid
        n0 = score_candidates.score_candidates.launches
        with mock.patch.object(mutate, "backpatch_sims", spy):
            mutation.update_ratings(mst, ids, new_rows[:b], b, cfg.MODEL)
        sync()
        (rep, new_rep, measure, got), = blocks
        _bitwise(f"update back-patch b={b}", [got],
                 [ref.gathered_sims(rep, new_rep, measure)])
        out[f"b={b}"] = dict(
            shape=list(got.shape),
            launches=score_candidates.score_candidates.launches - n0)
        if out[f"b={b}"]["launches"] != 1:
            raise AssertionError(f"update back-patch b={b}: {out}")
    return out


def _engine_mesh_launches(counts, m):
    """The mesh path's own launches in one engine run (every launch less
    those tallied beside it: the router checks and the one-device shadow).
    Raises unless kernel 3 launched at least once a shard for every fold
    batch, and kernel 6 (the back-patch's shared form) and kernel 1 at
    least once for every fold batch and every update."""
    mesh = {k: c - m["side_launches"].get(k, 0) for k, c in counts.items()}
    writes = m["fold_batches"] + m["updates"]
    need = {"foldin_topk": m["shards"] * m["fold_batches"],
            "score_candidates": writes, "masked_similarity": writes}
    short = {k: (mesh[k], n) for k, n in need.items() if mesh[k] < n}
    if short:
        raise AssertionError(f"engine mesh path launched too few (launched, "
                             f"needed): {short}")
    return mesh


def phase_engine_mesh(a, card):
    """13: ``serve --workload cf --engine --mesh`` on the card (the runs of
    ``ENGINE_MESH_RUNS``, under ``build/phase13/``, the full ones with a
    torch.profiler capture of the load window). Each run: every shard
    block on the card, the router's check with 0 offenders, routed reads
    bitwise the one-device backend's at every warm batch shape, the audit
    N > 0 with 0 mismatches, every d1 call on the tensor-core route, and
    the mesh path's own launches (``_engine_mesh_launches``; kernels 4-5
    with the sidecar); with ``--mutations`` a sample of live users' reads
    bitwise a one-device ``MutableLocalBackend`` shadow fed the same writes
    in the same order, before the compacting refresh and (the smoke) after
    it, and the pre-compaction bar. Before the runs, the update's
    back-patch block bitwise ``ref.gathered_sims``. Returns the runs'
    mesh-path launches summed."""
    from repro_torch.serving import EngineConfig

    t0 = time.perf_counter()
    print(f"phase 13 update back-patch ({card}): "
          f"{json.dumps(_update_backpatch(a))} bitwise ref.gathered_sims")
    shutil.rmtree(ENGINE_MESH_DIR, ignore_errors=True)
    total = {}
    for tag, argv in ENGINE_MESH_RUNS:
        prof = ENGINE_MESH_DIR / tag.replace(" ", "_")
        full = tag.startswith("full")
        extra = ["--torch-profile", str(prof)] if full else []
        buf = io.StringIO()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = serve.main(["--workload", "cf", "--engine"] + argv + extra)
        sync()
        seconds = time.perf_counter() - t1
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        m, mut = res["mesh"], res["mutations"]
        checks = {
            "every block on the card": all(
                d.startswith(DEVICE) for d in m["block_devices"]),
            "router 0 offenders": (m["router_offenders"] == 0
                                   and "0 offenders" in text),
            "routed bitwise at every warm shape": (
                m["routed_bitwise"] and m["routed_shapes"]
                == list(EngineConfig(max_batch=128,
                                     min_shape=32).batch_shapes())),
            "audit 0 mismatches": (res["checked"] > 0
                                   and res["mismatches"] == 0
                                   and res["nonfinite"] == 0),
            "done": text.rstrip().endswith("cf engine: done"),
        }
        if "--mutations" in argv:
            checks["shadow bitwise before compaction"] = \
                m["shadow_before"]["bitwise"]
            checks["pre-compaction bar"] = not (mut["cites_dead"]
                                                or mut["dirty_published"])
            if "shadow_after" in m or tag.startswith("smoke"):
                checks["shadow bitwise after compaction"] = (
                    "shadow_after" in m and m["shadow_after"]["bitwise"]
                    and mut.get("post_tombstone_frac") == 0.0)
        failed = [k for k, ok in checks.items() if not ok]
        mesh = _engine_mesh_launches(counts, m)
        need = ("assign_clusters", "fused_probe_topk") if \
            "--retrieval" in argv else ()
        idle = [k for k in need if not mesh[k] > 0]
        if failed or idle:
            raise AssertionError(f"engine mesh {tag}: failed {failed}, "
                                 f"never launched {idle} ({mesh})")
        _check_d1_routes(f"engine mesh {tag}", counts, d1)
        lanes = {}
        if full:
            lanes = _lane_streams(prof / "torch_trace.json", res["lane_ids"])
        rl, fl = res["read_latency"], res["fold_latency"]
        wl = {k: f"{v.p50_ms:.3f}/{v.p99_ms:.3f} ms ({v.count})"
              for k, v in mut.get("write_latency", {}).items()}
        window = ("no profiler capture" if not lanes else
                  f"busy/idle not measured (the profiler lost all "
                  f"{PROFILE_MARKERS} markers)" if lanes["busy_share"] is None
                  else f"busy {lanes['busy_share']:.4f} idle "
                  f"{lanes['idle_share']:.4f} of a {lanes['window_ms']:.1f} "
                  f"ms window")
        if lanes:
            window += (f", markers lost {lanes['markers_lost']} of "
                       f"{PROFILE_MARKERS}, kernels by lane@stream "
                       f"{lanes['kernels_by_lane_stream']}")
        print(f"phase 13 engine mesh ({tag}, {card}): {m['mesh']}, C="
              f"{m['capacity']}; sustained {res['qps']:.1f} QPS, read "
              f"p50/p95/p99 {rl.p50_ms:.3f}/{rl.p95_ms:.3f}/{rl.p99_ms:.3f} "
              f"ms ({rl.count} reads), shed_frac {res['shed_frac']:.4f}, fold "
              f"p50/p99 {fl.p50_ms:.3f}/{fl.p99_ms:.3f} ms "
              f"({res['completed']['fold']} folds)"
              + (f", write p50/p99 {wl}, repaired_rows "
                 f"{res['repaired_rows']}, compacted {mut.get('compacted')}"
                 f", shadow {m.get('shadow_before')} / "
                 f"{m.get('shadow_after')}" if wl else "")
              + f"; router {m['router_tensors']} tensors at batch "
              f"{m['router_batch']}, routed bitwise at {m['routed_shapes']}; "
              f"audit {res['checked']} re-run 0 mismatches; {window}; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
              f"{m['fold_batches']} fold batches, {m['updates']} updates; "
              f"mesh launches {mesh}; beside it {m['side_launches']} in "
              f"{m['side_ms']:.1f} ms; d1 results {d1}; load window "
              + (f"{ENGINE_MESH_WINDOW_S} s (cut from phase 9's 8 s)"
                 if full else "the smoke's")
              + f" | {seconds:.1f}s")
        for name, c in mesh.items():
            total[name] = total.get(name, 0) + c
    shutil.rmtree(ENGINE_MESH_DIR, ignore_errors=True)
    print(f"phase 13: {time.perf_counter() - t0:.1f}s")
    return total


# ----------------------------------------- any landmark count (phase 14)
WEB_N = cfg.WEB_FIT["n_landmarks"]  # 128: the registry's web_fit cell
WIDE_SPEC = dataclasses.replace(cfg.MODEL, n_landmarks=WEB_N)
WEB_USERS = 32768  # web_fit's 1,048,576 users, cut to what one card holds
def _wide_main_path(train, d, test_idx):
    """(a): fit → fold-in of 64 → 256-pair predict and top-N at n = 128 on
    the ML-1M ratings. Kernels 1-3 must launch; then each kernel's result
    on the path is held to its plain version on the path's own inputs:
    d1's representation, the fit's graph (kernel 2), the fold-in rows'
    lists (kernel 3)."""
    spec, k = WIDE_SPEC, WIDE_SPEC.k_neighbors
    u_fit, p = train.shape[0] - FOLD_IN, train.shape[1]
    r = train[:u_fit]
    users, items = (x[:256] for x in _pairs(test_idx, d, 0, u_fit)[:2])
    rec = torch.arange(0, u_fit, u_fit // TOPN_USERS,
                       device=DEVICE)[:TOPN_USERS]
    sync()
    ops.reset_launches()
    st = fit(RatingMatrix(r, u_fit, p), spec)
    st2 = fold_in(st, train[u_fit:], spec)
    pred = predict(st2, users, items, spec)
    top_i, top_s = knn.recommend_topn_graph(st2.graph, st2.ratings, rec,
                                            n=10)
    sync()
    counts = _counts()
    if not all(counts[name] > 0 for name in GRAPH_KERNELS):
        raise AssertionError(f"phase 14a: a kernel did not launch {counts}")
    rep = st.representation
    lm = r[st.landmark_idx]
    repq = kernel_rows(rep, "cosine")
    new_q = kernel_rows(st2.representation[u_fit:], "cosine")
    g_fit = finalize_topk(*ref.foldin_topk_ref(repq, repq, k, 0, u_fit,
                                               "cosine"))
    g_new = finalize_topk(*ref.foldin_topk_ref(
        new_q, torch.cat([repq, new_q]), k, u_fit, None, "cosine"))
    same = {
        "masked_similarity": torch.equal(
            _bits(st2.representation), _bits(ref.masked_similarity_ref(
                train, lm, "cosine"))),
        "topk_sim": torch.equal(st.graph.indices, g_fit.indices)
        and torch.equal(_bits(st.graph.weights), _bits(g_fit.weights)),
        "foldin_topk": torch.equal(st2.graph.indices[u_fit:], g_new.indices)
        and torch.equal(_bits(st2.graph.weights[u_fit:]),
                        _bits(g_new.weights)),
    }
    if not all(same.values()):
        raise AssertionError(f"phase 14a: not bitwise the plain versions "
                             f"{same}")
    if not (torch.isfinite(pred).all() and pred.shape == users.shape
            and top_i.shape == (TOPN_USERS, 10) and (top_i >= 0).all()
            and torch.isfinite(top_s).all()):
        raise AssertionError("phase 14a: predictions or top-N not finite "
                             "or misshaped")
    return st, st2, counts, same


def _wide_ivf(st, st2, train):
    """(b): at the same shape, ``build_index`` (kernel 4), a search at
    partial probe through ``scorer="kernel"`` (kernel 6's per-query form)
    and through the fused probe (kernel 5), and one bucketed fold-in of the
    64 rows (its back-patch on kernel 6's shared form), each tallied; then
    each kernel on those inputs bitwise its plain version."""
    spec, k = WIDE_SPEC, 13
    u_fit = st.representation.shape[0]
    rep = st.representation
    ivf = rt.resolve_ivf(None, u_fit)
    c = ivf.n_clusters
    sids = torch.arange(u_fit, dtype=torch.int32, device=DEVICE)
    sync()
    ops.reset_launches()
    tallies = {}
    with build.tally() as t:
        index = rt.build_index(rep, ivf, "cosine")
    tallies["build_index"] = dict(t)
    with build.tally() as t:
        kv, ki = rt.search(index, rep, k, ivf.nprobe, "cosine",
                           self_ids=sids, scorer="kernel")
    tallies["search kernel"] = dict(t)
    with build.tally() as t:
        fv, fi = rt.search(index, rep, k, ivf.nprobe, "cosine",
                           self_ids=sids, scorer="fused")
    tallies["search fused"] = dict(t)
    bst = buckets.from_state(st, LIFECYCLE_CAPACITY)
    with build.tally() as t:
        folded = buckets.fold_in_rows(bst, train[u_fit:], FOLD_IN, spec)
    tallies["bucketed fold-in"] = dict(t)
    sync()
    counts = _counts()
    forms = {"per_query": tallies["search kernel"].get("score_candidates", 0),
             "shared": tallies["bucketed fold-in"].get("score_candidates",
                                                       0)}
    if not (all(counts[name] > 0 for name in IVF_KERNELS)
            and all(forms.values())):
        raise AssertionError(f"phase 14b: a kernel or a form of kernel 6 "
                             f"did not launch: {tallies}")
    if not torch.equal(kv, fv) or list_mismatches(kv, ki, fv, fi, RTOL,
                                                  ATOL).size:
        raise AssertionError("phase 14b: kernel and fused scorers disagree")
    init = rt.init_centroids(torch.Generator().manual_seed(ivf.seed), rep, c)
    _bitwise("phase 14b kmeans_lloyd",
             assign_clusters.kmeans_lloyd(rep, init, ivf.iters),
             ref.kmeans_lloyd_ref(rep, init, ivf.iters))
    probe = rt.probe_cells(index, rep, ivf.nprobe, "cosine")
    args = (rep, probe, index.lists, index.rows, index.scale, index.fill)
    _bitwise("phase 14b fused_probe_topk",
             ivf_probe.fused_probe_topk(*args, k=k, self_ids=sids),
             ref.fused_probe_topk_ref(*args, k=k, self_ids=sids))
    qb, m = 256, ivf.nprobe * index.capacity
    cand = index.rows[probe[:qb].long()].reshape(qb, m, -1).contiguous()
    _bitwise("phase 14b score_candidates per-query",
             [score_candidates.score_candidates(rep[:qb].contiguous(),
                                                cand)],
             [ref.score_candidates_ref(rep[:qb].contiguous(), cand)])
    rows, _ = _capacity_rows(rep)
    new = st2.representation[u_fit:].contiguous()
    _bitwise("phase 14b score_candidates shared",
             [score_candidates.score_candidates(rows, new)],
             [ref.gathered_sims(rows, new, "cosine")])
    if folded.n_valid != u_fit + FOLD_IN:
        raise AssertionError(f"phase 14b: bucketed fold-in holds "
                             f"{folded.n_valid} rows")
    return counts, forms, dict(C=c, nprobe=ivf.nprobe, cap=index.capacity,
                               tallies=tallies)


def _web_fit():
    """(c): fit → fold-in of 64 at web_fit's widths (P = 65536 items, n =
    128 landmarks) with U cut to WEB_USERS, ratings made on the card."""
    full_u, p = cfg.WEB_FIT["n_users"], cfg.WEB_FIT["n_items"]
    u = WEB_USERS
    t0 = time.perf_counter()
    r = web_tool.web_ratings(u, p, DEVICE)
    sync()
    gen_s = time.perf_counter() - t0
    u_fit = u - FOLD_IN
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    st = fit(RatingMatrix(r[:u_fit], u_fit, p), WIDE_SPEC)
    sync()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st2 = fold_in(st, r[u_fit:], WIDE_SPEC)
    sync()
    fold_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _counts()
    # P = 65,536 whole stars: d1 on the tensor-core route, its result kept
    d1 = ms.route_results()
    _check_d1_routes("phase 14c", counts, d1)
    g = st2.graph
    if not (st2.representation.shape == (u, WEB_N)
            and torch.isfinite(st2.representation).all()
            and g.indices.shape == (u, WIDE_SPEC.k_neighbors)
            and bool(((g.indices >= 0) & (g.indices < u)).all())
            and torch.isfinite(g.weights).all()
            and all(counts[name] > 0 for name in GRAPH_KERNELS)):
        raise AssertionError(f"phase 14c: the fit or fold-in is not finite "
                             f"or misshaped, or a kernel did not launch "
                             f"({counts})")
    cut = (f"U cut from {full_u} to {u}: dense (U, P) f32 ratings of all "
           f"{full_u} users take {4 * full_u * p / 1e9:.0f} GB, one card "
           f"holds 80 GB; U={u} takes {4 * u * p / 1e9:.1f} GB")
    del r, st, st2
    return dict(U=u, P=p, n=WEB_N, density=web_tool.WEB_DENSITY, cut=cut,
                generate_s=gen_s, fit_s=fit_s, fold_in_s=fold_s,
                peak_bytes=peak, launches={k: v for k, v in counts.items()
                                           if v}, d1_results=d1)


def phase_wide(train, d, test_idx, card):
    """14: n = 128 landmarks, the width of the reference registry's
    web_fit cell (kernels 2-6 on their wide routes): (a) the ML-1M main
    path, (b) the IVF and lifecycle pieces, (c) fit → fold-in at web_fit's
    P and n with U cut to one card. Returns (a) and (b)'s launches."""
    t0 = time.perf_counter()
    st, st2, counts_a, same = _wide_main_path(train, d, test_idx)
    print(f"phase 14a wide main path ({card}): U={train.shape[0]} "
          f"P={train.shape[1]} n={WEB_N} k={WIDE_SPEC.k_neighbors}; "
          f"launches {json.dumps({k: counts_a[k] for k in GRAPH_KERNELS})}; "
          f"bitwise the plain versions {json.dumps(same)}")
    counts_b, forms, info = _wide_ivf(st, st2, train)
    print(f"phase 14b wide IVF ({card}): C={info['C']} nprobe="
          f"{info['nprobe']} cap={info['cap']} n={WEB_N}; launches "
          f"{json.dumps({k: counts_b[k] for k in IVF_KERNELS})}, kernel 6 "
          f"by form {json.dumps(forms)}; kernels 4-6 bitwise their plain "
          f"versions; tallies {json.dumps(info['tallies'])}")
    del st, st2
    web = _web_fit()
    print(f"phase 14c web_fit widths ({card}): " + json.dumps(web))
    print(f"phase 14: {time.perf_counter() - t0:.1f}s")
    return {k: counts_a.get(k, 0) + counts_b.get(k, 0)
            for k in set(counts_a) | set(counts_b)}


# ---------------------------------------------- MoE serving (phase 15)
MOE_ARCH, DBRX_ARCH = "deepseek-moe-16b", "dbrx-132b"
DBRX_LAYERS = 2  # of 40: its bf16 weights take 263 GB at full depth
# moe_ffn_ragged vs moe_ffn in bf16, of max |out|: the ragged form rounds
# each of a token's K weighted rows to bf16 and each of its K adds, where
# the dense combine rounds once, (K + 2) half-ulps with a factor 2 to spare
def _moe_bf16_rel(top_k):
    return (top_k + 2) * 2.0 ** -8


def _moe_model_shape(arch=MOE_ARCH):
    """(P, n, S, D) of kernel 7 on phase 15's forward of ``arch``: one
    problem per (batch, kv head), G·n_landmarks landmark queries each."""
    cfg = registry.get(arch).model
    g = cfg.n_heads // cfg.n_kv_heads
    return (LM_BATCH * cfg.n_kv_heads, g * cfg.n_landmarks, LM_SEQ,
            cfg.head_dim)


def _moe_model(arch, **over):
    cfg = dataclasses.replace(registry.get(arch).model, **over)
    return lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                      DEVICE)


def _decode_floor_ms(cfg):
    """Least time of one exact decode step: every weight read once in bf16
    at the HBM rate (a GShard decode group of one token still runs the
    (E, C) expert products over all E experts), but the embedding table,
    of which a step gathers B rows; the KV cache's few KB left out."""
    embed = 0 if cfg.tied_embed else cfg.vocab * cfg.d_model
    return 2 * (cfg.param_count() - embed) / kcost.HBM_BYTES_PER_S * 1e3


def _annotated(fn, name):
    """``fn`` inside a ``torch.profiler`` range named ``name``."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def _moe_serve(card):
    """15a: the lm serve CLI on the DeepSeek arch at full width and depth,
    exact KV and --landmark: its three lines, ms/token beside the decode
    floor, peak memory and launches."""
    floor = _decode_floor_ms(registry.get(MOE_ARCH).model)
    counts = {}
    for extra in ([], ["--landmark"]):
        buf = io.StringIO()
        t1 = time.perf_counter()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(buf):
            serve.main(["--workload", "lm", "--arch", MOE_ARCH] + extra)
        sync()
        peak = torch.cuda.max_memory_allocated()
        lines = buf.getvalue().strip().splitlines()
        print("\n".join(lines))
        if not (lines[-3].startswith("prefill 4x32: ")
                and lines[-2].startswith("decode 16 tokens (")
                and lines[-1].startswith("sample ids: [")):
            raise AssertionError(f"moe serve {extra}: unexpected output")
        ms = float(lines[-2].split(": ")[1].split(" ms/token")[0])
        run = ops.launch_counts()
        counts = {k: counts.get(k, 0) + v for k, v in run.items()}
        print(f"phase 15a moe serve CLI {MOE_ARCH} "
              f"{' '.join(extra) or '(exact KV)'} ({card}): {lines[-3]} | "
              f"{ms} ms/token (exact decode floor {floor:.3f} ms: all "
              f"weights read once, bf16, 3.35 TB/s) | peak {peak} bytes "
              f"({peak / 2**30:.2f} GiB) | launches {run} | "
              f"{time.perf_counter() - t1:.1f}s")
        torch.cuda.empty_cache()
    return counts


# Two runs of one MoE model whose hidden states differ in bf16 rounding
# (the kernel and the plain B̃V; a decode step and the forward) can route
# a token whose router holds a near-tie to other experts, and one swapped
# expert moves the logits by more than the rounding does. So the second
# run takes the first run's experts (the ROADMAP tie rule, for routing;
# the plain forward's routing, or the forward's for its last token). The
# check holds each call's router logits to the first run's within
# LM_LOGIT_REL of their largest magnitude, and each expert the second run
# would have chosen instead to a near-tie: the first run's relative
# probability gap between the two (``layers.route_flips``, the gap the CPU
# tests hold the port's routing to against the reference's) within
# ROUTER_TIE_REL.
def _logging_router(flog, rows=None):
    """The port's router, appending each call's (router logits, probs,
    ids) to ``flog``; ``rows`` picks the rows kept (a forward's last
    token)."""
    port_router = lm_layers._router

    def router(xt, router_w, top_k):
        probs, gates, ids = port_router(xt, router_w, top_k)
        logits = xt.float() @ router_w.float()
        row = (logits, probs, ids)
        flog.append(row if rows is None else tuple(rows(t) for t in row))
        return probs, gates, ids

    return router


def _replayed_router(flog, stats):
    """A router that takes, call by call, the experts another run chose
    (``flog``: its (router logits, probs, ids) in call order), with this
    run's own probabilities at them renormalized. Per call it appends to
    ``stats`` the router logits' largest difference from the other run's,
    the other run's largest |logit|, the routed (token, k) pairs, and the
    gap of each flipped expert (``layers.route_flips``)."""
    port_router = lm_layers._router

    def router(xt, router_w, top_k):
        probs, _, ids = port_router(xt, router_w, top_k)
        logits = xt.float() @ router_w.float()
        fl, fp, fi = flog.pop(0)
        _, gaps = lm_layers.route_flips(ids, fp, fi)
        diff = float((logits - fl).abs().max())
        stats.append((diff, float(fl.abs().max()), ids.numel(),
                      gaps.tolist()))
        return probs, lm_layers.replayed_gates(probs, fi), fi

    return router


def _replay_summary(stats, tag):
    """The replayed run's router against the other run's: the largest
    router-logit difference of any call, relative (held to LM_LOGIT_REL)
    and absolute, and the flips (count, share of routed pairs, largest
    gap, held to ROUTER_TIE_REL)."""
    gaps = [g for *_, call in stats for g in call]
    pairs = sum(n for _, _, n, _ in stats)
    out = {"router_calls": len(stats),
           "router_logit_rel": max((d / m for d, m, _, _ in stats),
                                   default=0.0),
           "router_logit_abs": max((d for d, *_ in stats), default=0.0),
           "flips": len(gaps), "flip_share": len(gaps) / max(pairs, 1),
           "max_flip_gap": max(gaps, default=0.0)}
    if not out["router_logit_rel"] <= LM_LOGIT_REL:
        raise AssertionError(f"{tag}: router logits differ by "
                             f"{out['router_logit_rel']} of the largest")
    if not out["max_flip_gap"] <= ROUTER_TIE_REL:
        raise AssertionError(f"{tag}: an expert flipped at a gap of "
                             f"{out['max_flip_gap']}, past the near-tie "
                             f"limit {ROUTER_TIE_REL}; {out}")
    return out


def _moe_decode_vs_forward(model, toks, moe, replay):
    """One exact decode step after an 8-token prefill against
    ``lm_forward``'s last position, with ``cfg.moe = moe``. With
    ``replay`` the step takes the forward's routing of that token (see
    ``_replayed_router``). Returns (max|Δ logits|, correlation, the
    replay's per-call stats)."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, moe=moe, attn_backend="full")
    b, s = toks.shape[0], 9
    flog, stats = [], []

    def last(t):
        return t.reshape(b, s, -1)[:, -1]

    with torch.inference_mode():
        with mock.patch.object(lm_layers, "_router",
                               _logging_router(flog, last)):
            full, _ = lm.lm_forward(model, toks[:, :s])
        logits_pre, cache = lm.lm_prefill(model, toks[:, :8], max_seq=16)
        router = (_replayed_router(flog, stats) if replay
                  else lm_layers._router)
        with mock.patch.object(lm_layers, "_router", router):
            dec, cache = lm.lm_decode_step(model, cache, toks[:, 8:9])
    model.cfg = cfg
    if logits_pre.shape != (b, 1, cfg.vocab) or int(cache["length"]) != s:
        raise AssertionError("moe decode: prefill logits or cache length")
    a, f = dec[:, 0].float(), full[:, -1].float()
    corr = float(torch.corrcoef(torch.stack([a.ravel(), f.ravel()]))[0, 1])
    return float((a - f).abs().max()), corr, stats


def _moe_decode_checks(model, tag):
    """15c: the decode step against the forward at the config's capacity
    (correlation > 0.8, the reference's check: the single-token decode
    group is the known GShard train/serve gap) and at a capacity where no
    group drops a token (within DECODE_ATOL on the forward's routing,
    ``_replay_summary``'s router checks held). Returns the figures."""
    m = model.cfg.moe
    toks = torch.as_tensor(synthetic.lm_batch(0, 0, 2, 16, model.cfg.vocab)[
        "tokens"], device=DEVICE)
    ample = dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)
    err_c, corr_c, _ = _moe_decode_vs_forward(model, toks, m, False)
    err_free, corr_free, _ = _moe_decode_vs_forward(model, toks, ample,
                                                    False)
    err, corr, stats = _moe_decode_vs_forward(model, toks, ample, True)
    replay = _replay_summary(stats, f"{tag} decode vs forward")
    if not corr_c > 0.8:
        raise AssertionError(f"{tag} decode vs forward at capacity "
                             f"{m.capacity_factor}: correlation {corr_c}")
    if not err < DECODE_ATOL:
        raise AssertionError(f"{tag} decode vs forward at ample capacity: "
                             f"max|Δ| {err}, {replay}")
    return {"capacity": m.capacity_factor, "max_abs": err_c, "corr": corr_c,
            "ample_capacity": ample.capacity_factor, "ample_max_abs": err,
            "ample_corr": corr, "replay": replay,
            "ample_max_abs_own_routing": err_free,
            "ample_corr_own_routing": corr_free}


def _ragged_vs_dense(model, tag):
    """``moe_ffn_ragged`` against ``moe_ffn`` at a capacity where nothing
    drops, on layer 0's router and experts at the model's full widths,
    one group of random bf16 tokens: the same routing, outputs within
    ``_moe_bf16_rel`` of the largest; the events time of each there and at a
    decode step's shape (B = 4 tokens, the config's capacity)."""
    cfg, lp = model.cfg, model.layers[0]
    m = cfg.moe
    weights = (lp.router, lp.ew1, lp.ew3, lp.ew2)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    x = torch.randn((1, m.group_size, cfg.d_model), generator=g,
                    device=DEVICE).to(cfg.dtype)
    ample = m.n_experts / m.top_k
    with torch.inference_mode():
        if not lm_layers.moe_route(x, lp.router, m.top_k, ample,
                                   m.group_size).kept.all():
            raise AssertionError(f"{tag}: ample capacity dropped a token")
        dense, aux_d = lm_layers.moe_ffn(x, *weights, m.top_k, ample,
                                         m.group_size, cfg.act)
        ragged, aux_r = lm_layers.moe_ffn_ragged(x, *weights, m.top_k,
                                                 cfg.act)
        sync()
        rel = float((ragged.float() - dense.float()).abs().max()
                    / dense.float().abs().max())
        if not rel < _moe_bf16_rel(m.top_k) or not torch.isclose(aux_d,
                                                                 aux_r):
            raise AssertionError(f"{tag}: ragged vs dense {rel}, aux "
                                 f"{float(aux_d)} {float(aux_r)}")
        xd = x[0, :4, None]  # (4, 1, D): a decode step's groups
        times = {
            "group_dense_ms": _event_ms(lambda: lm_layers.moe_ffn(
                x, *weights, m.top_k, ample, m.group_size, cfg.act), 5),
            "group_ragged_ms": _event_ms(lambda: lm_layers.moe_ffn_ragged(
                x, *weights, m.top_k, cfg.act), 5),
            "decode_dense_ms": _event_ms(lambda: lm_layers.moe_ffn(
                xd, *weights, m.top_k, m.capacity_factor, m.group_size,
                cfg.act), 5),
            "decode_ragged_ms": _event_ms(lambda: lm_layers.moe_ffn_ragged(
                xd, *weights, m.top_k, cfg.act), 5)}
    return {"tokens": m.group_size, "max_abs_rel": rel,
            "limit": _moe_bf16_rel(m.top_k), **times}


def _moe_forward(model, card, tag):
    """15b/d: the landmark forward (B = 2, S = 4096) through kernel 7 and
    through the plain B̃V: kernel 7 once a layer on the tensor-core route,
    logits within LM_LOGIT_REL, CE near ln V; then a profile (busy/idle,
    top kernels) and the MoE FFN's share of device time. The two forwards'
    hidden states differ in bf16 rounding, so a token whose router holds
    a near-tie may take another expert in each: the kernel forward runs on
    the plain forward's routing (``_replay_summary``'s router checks held),
    and the logits of the kernel forward on its own routing are printed
    beside. Returns the kernel forward's launches."""
    t0 = time.perf_counter()
    cfg = model.cfg
    p, n, s_, d = (LM_BATCH * cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
                   * cfg.n_landmarks, LM_SEQ, cfg.head_dim)
    batch = {key: torch.as_tensor(val, device=DEVICE) for key, val in
             synthetic.lm_batch(0, 0, LM_BATCH, LM_SEQ, cfg.vocab).items()}
    torch.cuda.reset_peak_memory_stats()
    flog, stats = [], []
    with mock.patch.object(lm_layers, "_router", _logging_router(flog)):
        out = _forward_variants(model, batch, (
            ("plain", ref.landmark_summary_ref),))
    with mock.patch.object(lm_layers, "_router",
                           _replayed_router(flog, stats)):
        out |= _forward_variants(model, batch, (
            ("kernel", ops.landmark_summary),))
    if flog:
        raise AssertionError(f"{tag}: {len(flog)} router calls not replayed")
    replay = _replay_summary(stats, f"{tag} landmark forward")
    own = _forward_variants(model, batch, (
        ("kernel", ops.landmark_summary),))["kernel"]
    rel = _check_forward(out, cfg, "tensor_core", LM_BATCH, "bf16")
    ka, pa = out["kernel"], out["plain"]
    want = pa["logits"]
    rel_own = float((own["logits"] - want).abs().max() / want.abs().max())
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 15 {tag} landmark forward ({card}): {cfg.name} "
          f"L={cfg.n_layers} d={cfg.d_model} E={cfg.moe.n_experts} "
          f"top-{cfg.moe.top_k} shared={cfg.moe.n_shared} B={LM_BATCH} "
          f"S={LM_SEQ} n={cfg.n_landmarks} bf16; kernel 7 at P={p} n={n} "
          f"S={s_} D={d}, launches {ka['counts']} by route {ka['routes']} | "
          f"CE kernel {ka['ce']:.6f} plain {pa['ce']:.6f} (uniform "
          f"{np.log(cfg.vocab):.6f}), aux (summed over layers) kernel "
          f"{ka['aux']:.4f} plain {pa['aux']:.4f}; logits max|Δ|/max|logit| "
          f"{rel:.5f} on the plain forward's routing (limit {LM_LOGIT_REL}; "
          f"replay {json.dumps(replay)}), {rel_own:.5f} on its own; "
          f"forward wall kernel "
          f"{ka['wall'] * 1e3:.1f} ms, plain {pa['wall'] * 1e3:.1f} ms; "
          f"peak {peak} bytes | {time.perf_counter() - t0:.1f}s")
    counts = dict(ka["counts"])
    del out, ka, pa, own, want
    with torch.inference_mode():
        with mock.patch.object(lm, "_ffn", _annotated(lm._ffn, "moe_ffn")):
            prof = _profile(lambda: lm.lm_forward(model, batch["tokens"]),
                            ("moe_ffn",))
    print(f"phase 15 {tag} profile (one landmark forward, kernel path): "
          + json.dumps(prof))
    return counts


def phase_moe(card):
    """15: MoE serving — (a) the serve CLI on DeepSeek-MoE-16B at full
    width and depth, exact KV and --landmark; (b) its landmark forward at
    B = 2, S = 4096 with kernel 7 once a layer at D = 128, G = 1; (c) an
    exact decode step against the forward; moe_ffn_ragged against moe_ffn
    at its full expert widths; (d) DBRX-132B at full width, depth cut to
    DBRX_LAYERS: the landmark forward (kernel 7 at G = 6), the decode
    checks and the ragged check. Returns the launches of (a), (b), (d)."""
    t0 = time.perf_counter()
    counts = _moe_serve(card)
    model = _moe_model(MOE_ARCH, attn_backend="landmark")
    fwd = _moe_forward(model, card, "b")
    dec = _moe_decode_checks(model, MOE_ARCH)
    print(f"phase 15c decode vs forward ({card}): {MOE_ARCH} full width "
          f"and depth, one exact decode step after an 8-token prefill "
          f"(limit {DECODE_ATOL} at ample capacity on the forward's "
          f"routing, router logits within {LM_LOGIT_REL}, flips at gaps "
          f"within {ROUTER_TIE_REL}; correlation > "
          f"0.8 at the config's capacity): "
          + json.dumps(dec))
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, attn_backend="full")
    with torch.inference_mode():
        served = lm.make_cache(model.cfg, 4, 48, DEVICE)
        served["length"].fill_(32)
        tok = torch.ones((4, 1), dtype=torch.int32, device=DEVICE)
        print(f"phase 15c profile (one exact decode step, B=4, cache 33/48; "
              f"floor {_decode_floor_ms(cfg):.3f} ms): " + json.dumps(
                  _profile(lambda: lm.lm_decode_step(model, dict(
                      served, length=served["length"].clone()), tok))))
    model.cfg = cfg
    del served
    rag = _ragged_vs_dense(model, MOE_ARCH)
    print(f"phase 15c moe_ffn_ragged vs moe_ffn ({card}): {MOE_ARCH} "
          f"layer 0, D={model.cfg.d_model} E={model.cfg.moe.n_experts} "
          f"F={model.cfg.moe.d_ff_expert}: " + json.dumps(rag))
    del model
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    model = _moe_model(DBRX_ARCH, n_layers=DBRX_LAYERS,
                       attn_backend="landmark")
    fwd_dbrx = _moe_forward(model, card, "d")
    dec = _moe_decode_checks(model, DBRX_ARCH)
    rag = _ragged_vs_dense(model, DBRX_ARCH)
    print(f"phase 15d {DBRX_ARCH} ({card}): full width, L cut from 40 to "
          f"{DBRX_LAYERS}; decode vs forward " + json.dumps(dec)
          + "; moe_ffn_ragged vs moe_ffn " + json.dumps(rag)
          + f" | {time.perf_counter() - t1:.1f}s")
    del model
    torch.cuda.empty_cache()
    for run in (fwd, fwd_dbrx):
        counts = {k: counts.get(k, 0) + v for k, v in run.items()}
    print(f"phase 15: launches {counts} | {time.perf_counter() - t0:.1f}s")
    return counts


# ---------------------------------------------- LM training (phase 16)
# of train_4k's 256, the largest power of two the card holds on both
# backends: B = 8 peaks at 35.8 GiB; at B = 16 the full-attention
# backward's recomputed block asks for a 7.5 GiB score chunk with 50.7 GiB
# allocated and 20.9 GiB reserved but free, and runs out of memory
TRAIN_BATCH = 8
TRAIN_STEPS = 4
TRAIN_DIR = ROOT / "build" / "phase16"
# kernel 7's backward against its plain version, of max |plain| per
# gradient: f32 FMAs summed in another order (the CPU emulation of its two
# passes, ref.landmark_summary_bwd_tiled_ref, differs from the plain
# version by up to 6.5e-7 of it)
BWD_REL = 1e-4
# the autograd Function (forward kernel, then backward kernel) against
# torch.autograd through the plain f32 forward: the forward kernel's own
# error (within LM_RTOL / LM_ATOL) enters Δ = Σ dO·O as well; bf16 inputs
# get bf16 gradients, one more rounding of up to 2^-8 of each value
FN_REL = 1e-3
FN_BF16_REL = FN_REL + 2 ** -8
BWD_DEVICE_FUNCS = DEVICE_FUNCS["landmark_summary_bwd"]
# split passes a backward call by route: dO's on the tensor-core routes,
# and q's, k's and v's too on f32_split
BWD_SPLITS = {"tensor_core": 1, "f32_split": 4, "fma": 0}
FMA_SHAPE = (2, 130, 500, 256)  # the FMA route's row (16a's D = 256)


def _train_shape():
    """(P, n, S, D) of kernel 7 and its backward in phase 16b: one problem
    per (batch, kv head), G·n_landmarks landmark queries each."""
    cfg = registry.get(LM_ARCH).model
    g = cfg.n_heads // cfg.n_kv_heads
    return (TRAIN_BATCH * cfg.n_kv_heads, g * cfg.n_landmarks, LM_SEQ,
            cfg.head_dim)


def _bwd_bound(p, n, s_, d, dtype):
    """Least time of the backward for p problems:
    ``kernels/cost.py::landmark_summary_bwd``."""
    return kcost.landmark_summary_bwd(p, n, s_, d,
                                      dtype == torch.bfloat16).bound()


def _bwd_inputs(p, n, s_, d, dtype, seed):
    q, k, v = _lm_inputs(p, n, s_, d, dtype, seed)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    scale = 1.0 / np.sqrt(d)
    out = ref.landmark_summary_ref(q, k, v, scale)
    dout = torch.randn(out.shape, generator=g, device=DEVICE)
    return q, k, v, out, dout, scale


def _rel(got, want):
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


def phase_train_kernel():
    """16a: kernel 7's backward against its plain version on the card (TF32
    off) at the training shape (bf16 and f32 inputs), DeepSeek's and DBRX's
    shapes, D = 32 and 256, a ragged S and an n off the query tile; two
    launches bitwise equal; launches by route and split passes counted;
    the autograd Function against torch.autograd through the plain f32
    forward. Returns the training-shape inputs per dtype and the largest
    absolute error there, and the same for the f32 inputs at FMA_SHAPE
    (key ``"fma"``)."""
    t0 = time.perf_counter()
    shapes = [(_train_shape(), (torch.bfloat16, torch.float32)),
              (_moe_model_shape(), (torch.bfloat16, torch.float32)),
              (_moe_model_shape(DBRX_ARCH), (torch.bfloat16,)),
              ((2, 100, 1000, 32), (torch.bfloat16, torch.float32)),
              (FMA_SHAPE, (torch.bfloat16, torch.float32)),
              ((3, 70, 777, 64), (torch.bfloat16, torch.float32)),
              ((2, 100, 300, 128), (torch.float32,)),
              ((1, 33, 777, 256), (torch.bfloat16,))]
    notes, model_in, model_err = [], {}, {}
    ops.reset_launches()
    lsum.bf16_terms.launches = 0
    calls = dict.fromkeys(lsum.landmark_summary_bwd.route_launches, 0)
    for i, ((p, n, s_, d), dtypes) in enumerate(shapes):
        for dtype in dtypes:
            args = _bwd_inputs(p, n, s_, d, dtype, seed=60 + i)
            got = lsum.landmark_summary_bwd(*args)
            again = lsum.landmark_summary_bwd(*args)
            want = ref.landmark_summary_bwd_ref(*args)
            sync()
            route = lsum.bwd_route(dtype, d)
            calls[route] += 2
            rel = _rel(got, want)
            if rel > BWD_REL or not all(bool(torch.isfinite(g).all())
                                        for g in got):
                raise AssertionError(f"16a: backward at P={p} n={n} S={s_} "
                                     f"D={d} {dtype}: {rel:.3g} of max "
                                     f"|plain| (limit {BWD_REL})")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"16a: two backward launches at P={p} "
                                     f"n={n} S={s_} D={d} differ")
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            notes.append(f"P={p} n={n} S={s_} D={d} {tag} {route} "
                         f"{rel:.3g} (max|err| {err:.3g})")
            if i == 0:
                model_in[dtype], model_err[dtype] = args, err
            elif (p, n, s_, d) == FMA_SHAPE and dtype == torch.float32:
                model_in["fma"], model_err["fma"] = args, err
            del got, again, want
    want_routes = {r: c * lsum.BWD_LAUNCHES for r, c in calls.items()}
    splits = sum(c * BWD_SPLITS[r] for r, c in calls.items())
    if (lsum.landmark_summary_bwd.launches != sum(want_routes.values())
            or lsum.landmark_summary_bwd.route_launches != want_routes
            or lsum.bf16_terms.launches != splits):
        raise AssertionError(f"16a: {lsum.landmark_summary_bwd.launches} "
                             f"backward launches by route "
                             f"{lsum.landmark_summary_bwd.route_launches} "
                             f"with {lsum.bf16_terms.launches} split passes,"
                             f" not {want_routes} with {splits}")
    # the autograd Function: kernel forward and kernel backward, against
    # torch.autograd through the plain f32 forward
    p, n, s_, d = 4, 1536, 4096, 64
    q, k, v, _, dout, scale = _bwd_inputs(p, n, s_, d, torch.float32, 90)
    fn_rel = {}
    for dtype in (torch.bfloat16, torch.float32):
        a = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        b = [t.to(dtype).float().detach().requires_grad_() for t in (q, k, v)]
        ops.reset_launches()
        ops.landmark_summary(*a).backward(dout)
        counts = ops.launch_counts()
        ref.landmark_summary_ref(*b, scale).backward(dout)
        sync()
        if (counts["landmark_summary"], counts["landmark_summary_bwd"]) != (
                1, lsum.BWD_LAUNCHES) or a[0].grad.dtype != dtype:
            raise AssertionError(f"16a Function {dtype}: launches {counts}, "
                                 f"grad dtype {a[0].grad.dtype}")
        rel = _rel([x.grad.float() for x in a], [y.grad for y in b])
        limit = FN_REL if dtype == torch.float32 else FN_BF16_REL
        if rel > limit:
            raise AssertionError(f"16a Function {dtype}: gradients {rel:.3g}"
                                 f" of max |autograd| (limit {limit})")
        fn_rel["bf16" if dtype == torch.bfloat16 else "f32"] = rel
    print(f"phase 16a landmark summary backward (TF32 off; limit {BWD_REL} "
          f"of max |plain| per gradient, two launches bitwise equal; "
          f"launches by route {want_routes}, {splits} split passes "
          f"({BWD_SPLITS} a call)): " + "; ".join(notes)
          + f" | Function vs torch.autograd of the plain "
          f"f32 forward at P={p} n={n} S={s_} D={d}: {fn_rel} (limit "
          f"{FN_REL}, bf16 {FN_BF16_REL:.5f}) | "
          f"{time.perf_counter() - t0:.1f}s")
    return model_in, model_err


@contextlib.contextmanager
def _counting_plain():
    """Count calls of the plain versions of kernel 7 and its backward."""
    seen = {"landmark_summary_ref": 0, "landmark_summary_bwd_ref": 0}

    def counted(name):
        real = getattr(ref, name)

        def fn(*args, **kwargs):
            seen[name] += 1
            return real(*args, **kwargs)
        return fn

    with mock.patch.object(ref, "landmark_summary_ref",
                           counted("landmark_summary_ref")), \
            mock.patch.object(ref, "landmark_summary_bwd_ref",
                              counted("landmark_summary_bwd_ref")):
        yield seen


def _train_arch(backend, **over):
    """SmolLM-360M on ``backend``, its model changed by ``over``, with one
    train_4k shape of TRAIN_BATCH sequences."""
    base = registry.get(LM_ARCH)
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, attn_backend=backend,
                                        **over),
        shapes=(ShapeSpec("train_4k", "train",
                          dict(batch=TRAIN_BATCH, seq=LM_SEQ)),))


def _train_batches(vocab):
    step = 0
    while True:
        yield synthetic.lm_batch(0, step, TRAIN_BATCH, LM_SEQ, vocab)
        step += 1


def _train_run(arch, steps=TRAIN_STEPS):
    """``steps`` steps of ``arch`` (``_train_arch``) through ``build_cell``
    and ``train_loop`` from seed-0 weights; each step timed to its loss
    (the loop's one sync) with its own launch counts."""
    cell = cells.build_cell(arch, "train_4k")
    model = lm.init_lm(arch.model, torch.Generator(device=DEVICE
                                                   ).manual_seed(0), DEVICE)
    opt_state = topt.opt_init(model, arch.opt)
    per_step = []

    def step_fn(model, opt_state, batch):
        sync()
        ops.reset_launches()
        lsum.bf16_terms.launches = 0
        t1 = time.perf_counter()
        out = cell.fn(model, opt_state, batch)
        loss = float(out[2]["loss"])
        per_step.append(dict(ms=(time.perf_counter() - t1) * 1e3, loss=loss,
                             counts=ops.launch_counts(), routes=dict(
                                 lsum.landmark_summary.route_launches),
                             bwd_routes=dict(
                                 lsum.landmark_summary_bwd.route_launches),
                             splits=lsum.bf16_terms.launches))
        return out

    torch.cuda.reset_peak_memory_stats()
    with _counting_plain() as plain:
        res = trainer.train_loop(
            step_fn, model, opt_state, trainer.Prefetcher(
                _train_batches(arch.model.vocab),
                lambda b: trainer.to_device(b, DEVICE)),
            trainer.TrainerConfig(total_steps=steps, log_every=1000),
            log=lambda *_: None)
    peak = torch.cuda.max_memory_allocated()
    return dict(model=model, opt_state=opt_state, cell=cell, steps=per_step,
                losses=res["losses"], plain=dict(plain), peak=peak)


def _check_train(run, backend, cfg, tag="16b", route="tensor_core",
                 steps=TRAIN_STEPS):
    """Every loss finite, the first within 2 of ln V; on the landmark
    backend kernel 7 forward at 2·L launches a step (the forward and its
    recompute under remat) and its backward at L calls of BWD_LAUNCHES
    launches, all on ``route``, with the route's split passes (three a
    forward launch on f32_split, BWD_SPLITS a backward call); none on the
    full backend; no plain version."""
    losses = run["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} {backend}: losses {losses}")
    if abs(losses[0] - np.log(cfg.vocab)) > 2.0:
        raise AssertionError(f"{tag} {backend}: first loss {losses[0]} is "
                             f"not within 2 of ln V = "
                             f"{np.log(cfg.vocab):.3f}")
    lmk = backend != "full"
    calls = cfg.n_layers if lmk else 0
    want = {"landmark_summary": 2 * calls,
            "landmark_summary_bwd": calls * lsum.BWD_LAUNCHES}
    want_routes = {r: want["landmark_summary"] if r == route else 0
                   for r in lsum.landmark_summary.route_launches}
    want_bwd = {r: want["landmark_summary_bwd"] if r == route else 0
                for r in lsum.landmark_summary_bwd.route_launches}
    fwd_splits = 3 if route == "f32_split" else 0
    want_splits = (fwd_splits * want["landmark_summary"]
                   + BWD_SPLITS[route] * calls)
    for i, st in enumerate(run["steps"]):
        got = {k: st["counts"][k] for k in want}
        others = {k: v for k, v in st["counts"].items() if k not in want and v}
        if (got != want or others or st["routes"] != want_routes
                or st["bwd_routes"] != want_bwd
                or st["splits"] != want_splits):
            raise AssertionError(f"{tag} {backend} step {i}: launches "
                                 f"{st['counts']} by route {st['routes']}, "
                                 f"backward by route {st['bwd_routes']} "
                                 f"with {st['splits']} split passes, not "
                                 f"{want} on {route} with {want_splits}")
    if any(run["plain"].values()):
        raise AssertionError(f"{tag} {backend}: plain versions called "
                             f"{run['plain']}")


def _grads_of(model, batch, summary=None):
    """Step 1's loss and gradients (no update), through ``summary`` as the
    B̃V function when given."""
    patch = (mock.patch.object(ops, "landmark_summary", summary) if summary
             else contextlib.nullcontext())
    with patch:
        loss, grads = cells.value_and_grad(model, batch)
    return float(loss), grads


def _grad_rel(a, b):
    """‖a − b‖ / ‖b‖ over each group of GRAD_GROUPS: the whole model, and
    each attention projection's leaves over every layer."""
    out = {}
    for group in GRAD_GROUPS:
        keys = [k for k in b if group == "all"
                or k.rsplit(".", 1)[-1] == group]
        num = sum(float((a[k].float() - b[k].float()).square().sum())
                  for k in keys)
        den = sum(float(b[k].float().square().sum()) for k in keys)
        out[group] = (num / den) ** 0.5
    return out


# step 1's gradients, kernel path against the plain B̃V, bf16 at 32 layers:
# ‖Δg‖ / ‖g‖ over the whole model and over each of wq, wk, wv (the leaves
# the summary's dq, dk, dv reach first) within GRAD_FLOOR_FACTOR times the
# same measure between the plain path and the plain path with its keys
# reversed (the same sums in another order: the bf16 floor of this check);
# each fault of PLANTED, put into the backward kernel's results, must fail
# that check
GRAD_GROUPS = ("all", "wq", "wk", "wv")
GRAD_FLOOR_FACTOR = 2.0
PLANTED = ("dk = 0", "delta = 0", "dk x 0.9")


def _with_backward(forward, backward):
    """A B̃V function: ``forward(q, k, v, scale)``, with
    ``backward(q, k, v, out, dout, scale)`` as its gradient (in the inputs'
    dtypes)."""

    class Summary(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            out = forward(q, k, v, scale)
            ctx.save_for_backward(q, k, v, out)
            ctx.scale = scale
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out = ctx.saved_tensors
            dq, dk, dv = backward(q, k, v, out, dout.float().contiguous(),
                                  ctx.scale)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None

    return Summary.apply


def _planted(fault, forward):
    """Kernel 7's backward with ``fault`` put into its results, behind
    ``forward``: dk zeroed, Δ = Σ dO·O taken as 0 (``out`` passed as
    zeros), or dk scaled by 0.9. A negative control of the gradient check
    only."""

    def backward(q, k, v, out, dout, scale):
        if fault == "delta = 0":
            out = torch.zeros_like(out)
        dq, dk, dv = lsum.landmark_summary_bwd(q, k, v, out, dout, scale)
        return dq, {"dk = 0": 0.0, "dk x 0.9": 0.9}.get(fault, 1.0) * dk, dv

    return _with_backward(forward, backward)


def _grad_check(arch, tag, isolate=False):
    """Step 1's gradients of ``arch`` through the kernels, from seed-0
    weights and batch 0, against a reference, by one rule: ‖Δg‖/‖g‖ within
    GRAD_FLOOR_FACTOR × the floor (the reference against itself over
    reversed keys) over each of GRAD_GROUPS, and each planted fault of the
    backward outside it. 16b: the kernel path (forward and backward
    kernels) against the plain B̃V under autograd. With ``isolate`` (16d):
    the reference is the plain pair (the plain forward with the plain
    backward, ``ref.landmark_summary_bwd_ref``) and the path held to the
    rule is the plain forward with the backward kernel, so that only the
    backward differs; the whole kernel path and the kernel forward alone
    (with the plain backward) are measured against the plain pair beside
    it (``whole_rel_norm``, ``forward_alone_rel_norm``), not held to the
    limit."""
    model = lm.init_lm(arch.model, torch.Generator(device=DEVICE
                                                   ).manual_seed(0), DEVICE)
    batch = trainer.to_device(synthetic.lm_batch(
        0, 0, TRAIN_BATCH, LM_SEQ, arch.model.vocab), DEVICE)
    if isolate:
        forward = ref.landmark_summary_ref
        plain = _with_backward(forward, ref.landmark_summary_bwd_ref)
        checked = _with_backward(forward, lsum.landmark_summary_bwd)
    else:
        forward, plain, checked = lsum._summary, ref.landmark_summary_ref, None

    def reversed_keys(q, k, v, scale):  # the same sum, in reverse key order
        return plain(q, k.flip(-2), v.flip(-2), scale)

    lp, gp = _grads_of(model, batch, plain)
    _, g = _grads_of(model, batch, reversed_keys)
    floor = _grad_rel(g, gp)
    limit = {k: GRAD_FLOOR_FACTOR * v for k, v in floor.items()}
    lk, g = _grads_of(model, batch)
    out = dict(loss_plain=lp, loss_kernel=lk, floor_rel_norm=floor,
               limit=limit)
    if isolate:
        out["whole_rel_norm"] = _grad_rel(g, gp)
        _, g = _grads_of(model, batch, _with_backward(
            lsum._summary, ref.landmark_summary_bwd_ref))
        out["forward_alone_rel_norm"] = _grad_rel(g, gp)
        _, g = _grads_of(model, batch, checked)
    kernel = _grad_rel(g, gp)
    over = [k for k in GRAD_GROUPS if not kernel[k] <= limit[k]]
    if over:
        raise AssertionError(f"{tag}: step-1 gradients kernel vs reference "
                             f"‖Δg‖/‖g‖ {kernel} over {limit} in {over}")
    planted = {}
    for fault in PLANTED:
        _, g = _grads_of(model, batch, _planted(fault, forward))
        planted[fault] = _grad_rel(g, gp)
        if all(planted[fault][k] <= limit[k] for k in GRAD_GROUPS):
            raise AssertionError(f"{tag}: the planted fault {fault!r} "
                                 f"passes the gradient check: "
                                 f"{planted[fault]} within {limit}")
    del g, gp, model
    torch.cuda.empty_cache()
    return dict(out, rel_norm=kernel, planted=planted)


def phase_train(card):
    """16b: SmolLM-360M trained at full width and depth (32 layers, S =
    4096, batch TRAIN_BATCH) for TRAIN_STEPS steps on each backend from the
    same weights and batches; launches, losses, step ms, tokens/s, peak
    memory, a profiled step; step 1's gradients kernel vs plain. Returns
    the landmark run's launches."""
    t0 = time.perf_counter()
    out, landmark_counts = {}, {}
    for backend in ("full", "landmark"):
        run = _train_run(_train_arch(backend))
        cfg = run["model"].cfg
        _check_train(run, backend, cfg)
        ms = [st["ms"] for st in run["steps"]]
        steady = statistics.median(ms[1:])
        cell, model, opt_state = run["cell"], run["model"], run["opt_state"]
        batch = trainer.to_device(synthetic.lm_batch(
            0, 99, TRAIN_BATCH, LM_SEQ, cfg.vocab), DEVICE)
        prof = _profile(lambda: float(cell.fn(model, opt_state, batch)[2][
            "loss"]), warm=False, sums=BWD_DEVICE_FUNCS)
        out[backend] = dict(
            losses=run["losses"], step_ms=ms, steady_step_ms=steady,
            tokens_per_s=TRAIN_BATCH * LM_SEQ / steady * 1e3,
            peak_gib=run["peak"] / 2 ** 30,
            launches_per_step={k: v for k, v in run["steps"][-1][
                "counts"].items() if v}, profile=prof)
        print(f"phase 16b train ({card}): {LM_ARCH} L={cfg.n_layers} "
              f"d={cfg.d_model} B={TRAIN_BATCH} (train_4k's 256 cut to what "
              f"one card holds) S={LM_SEQ} {backend} attention, AdamW, "
              f"remat: " + json.dumps(out[backend]))
        if backend == "landmark":
            for st in run["steps"]:
                for k, v in st["counts"].items():
                    landmark_counts[k] = landmark_counts.get(k, 0) + v
        del run, cell, model, opt_state, batch
        torch.cuda.empty_cache()
    grads = _grad_check(_train_arch("landmark"), "16b")
    print(f"phase 16b step-1 gradients, kernel vs plain B̃V ({card}; limit "
          f"‖Δg‖/‖g‖ ≤ {GRAD_FLOOR_FACTOR} × the plain-vs-reversed-keys "
          f"floor over each of {GRAD_GROUPS}; every planted fault of the "
          f"backward exceeds it): " + json.dumps(grads)
          + f" | {time.perf_counter() - t0:.1f}s")
    return landmark_counts, out


def phase_train_cli(card):
    """16c: ``launch.train --smoke --steps 6 --ckpt-dir D`` on the card,
    then ``--steps 10``, which resumes at step 6."""
    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    args = ["--arch", LM_ARCH, "--smoke", "--ckpt-dir", str(TRAIN_DIR)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first = train_cli.main(args + ["--steps", "6"])
        second = train_cli.main(args + ["--steps", "10"])
    lines = buf.getvalue().splitlines()
    if (len(first["losses"]) != 6 or "resumed from step 6" not in lines
            or second["last_step"] != 9 or len(second["losses"]) != 4
            or ckpt_mod.latest_step(TRAIN_DIR) != 10
            or not all(np.isfinite(first["losses"] + second["losses"]))):
        raise AssertionError(f"16c: train CLI resume failed: {lines}")
    print(f"phase 16c train CLI ({card}): --smoke --steps 6, then --steps "
          f"10 resumed at 6 ({lines[-1]}) | {time.perf_counter() - t0:.1f}s")


# 16d: f32 landmark training, SmolLM-360M at full width with the depth cut
# as phase 8b's f32 forward is
F32_TRAIN_LAYERS = 2
F32_TRAIN_STEPS = 2


def phase_train_f32(card):
    """16d: SmolLM-360M at full width, F32_TRAIN_LAYERS layers, f32 weights
    and landmark attention, trained F32_TRAIN_STEPS steps at B =
    TRAIN_BATCH, S = LM_SEQ (AdamW, remat) through ``build_cell`` and
    ``train_loop``: kernel 7 and its backward on ``f32_split`` at every
    launch, none on ``fma``; step ms, peak memory, a profiled step with the
    backward's device ms; step 1's gradients by the rule of 16b with the
    backward isolated (``_grad_check(..., isolate=True)``). Returns the
    run's launches of kernel 7 and its backward under the f32 rows' names,
    and its numbers."""
    t0 = time.perf_counter()
    arch = _train_arch("landmark", dtype=torch.float32,
                       n_layers=F32_TRAIN_LAYERS)
    run = _train_run(arch, F32_TRAIN_STEPS)
    cfg = run["model"].cfg
    _check_train(run, "landmark f32", cfg, tag="16d", route="f32_split",
                 steps=F32_TRAIN_STEPS)
    cell, model, opt_state = run["cell"], run["model"], run["opt_state"]
    batch = trainer.to_device(synthetic.lm_batch(
        0, 99, TRAIN_BATCH, LM_SEQ, cfg.vocab), DEVICE)
    prof = _profile(lambda: float(cell.fn(model, opt_state, batch)[2][
        "loss"]), warm=False, sums=BWD_DEVICE_FUNCS)
    # the step's split passes serve the forward (three a launch) as well:
    # the backward's own device ms a call are its two wgmma passes
    passes = [prof.get(f"{f} (ms, launches)", [None])[0]
              for f in ("bwd_dq_wgmma_kernel", "bwd_dkv_wgmma_kernel")]
    calls = cfg.n_layers
    out = dict(
        losses=run["losses"], step_ms=[st["ms"] for st in run["steps"]],
        peak_gib=run["peak"] / 2 ** 30,
        launches_per_step={k: v for k, v in run["steps"][-1][
            "counts"].items() if v},
        routes_per_step=run["steps"][-1]["routes"],
        bwd_routes_per_step=run["steps"][-1]["bwd_routes"],
        split_passes_per_step=run["steps"][-1]["splits"],
        backward_passes_ms_a_call_in_step=(
            sum(passes) / calls if None not in passes else None),
        profile=prof)
    print(f"phase 16d f32 train ({card}): {LM_ARCH} full width, L cut to "
          f"{cfg.n_layers}, d={cfg.d_model} B={TRAIN_BATCH} S={LM_SEQ} f32 "
          f"landmark attention, AdamW, remat: " + json.dumps(out))
    counts = {"landmark_summary_f32": sum(
        st["counts"]["landmark_summary"] for st in run["steps"]),
              "landmark_summary_bwd_f32": sum(
        st["counts"]["landmark_summary_bwd"] for st in run["steps"])}
    del run, cell, model, opt_state, batch
    torch.cuda.empty_cache()
    grads = _grad_check(arch, "16d", isolate=True)
    print(f"phase 16d step-1 gradients ({card}; limit ‖Δg‖/‖g‖ ≤ "
          f"{GRAD_FLOOR_FACTOR} × the floor of the plain forward and "
          f"backward against themselves over reversed keys, over each of "
          f"{GRAD_GROUPS}): the backward kernel behind the plain forward "
          f"vs the plain pair (rel_norm), every planted fault of the "
          f"backward past the limit; beside it, not held to the limit, the "
          f"whole kernel path (whole_rel_norm) and the f32 forward kernel "
          f"with the plain backward (forward_alone_rel_norm): "
          + json.dumps(grads) + f" | {time.perf_counter() - t0:.1f}s")
    out["grads"] = grads
    return counts, out


def _sdpa_bwd_ms(q, k, v, dtype=torch.bfloat16, batch=None):
    """Events ms of the backward alone of SDPA in ``dtype`` on (P, n, D)
    problems laid out as (batch, P / batch, n, D) (batch: TRAIN_BATCH by
    default), and the device kernels it ran."""
    import torch.nn.functional as F

    p = q.shape[0]
    batch = batch or TRAIN_BATCH
    q4, k4, v4 = (t.reshape(batch, p // batch, *t.shape[1:])
                  .to(dtype).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4)
    dout = torch.randn_like(out)
    run = lambda: torch.autograd.grad(out, (q4, k4, v4), dout,
                                      retain_graph=True)
    prof = _profile(run)
    return _event_ms(run, 10), (list(prof["top_ms"]) if "top_ms" in prof
                                else prof["device_time"])


def _bwd_split_floor(p, n, s_, d):
    """The f32_split route's own floor: its 27 bf16 products of 2·n·S·D at
    the tensor cores' peak (ms)."""
    return p * 27 * 2 * n * s_ * d / kcost.BF16_TC_FLOPS * 1e3


def _bwd_rows(model_in, err, launches, train_out, f32_counts, f32_out):
    """The kernel table's rows of kernel 7's backward: at the training
    shape, bf16 inputs (16b's) on the tensor-core route, with launches on
    the landmark training run, event and device ms alone and in the
    profiled step, bound, plain ms and bf16 SDPA's backward; f32 inputs
    (16d's) on the f32_split route, the same with the split passes' share,
    the 27-product floor and f32 SDPA's backward; and the FMA route at
    FMA_SHAPE (f32 inputs, launched on no path)."""
    q, k, v, out, dout, scale = model_in[torch.bfloat16]
    p, n, d = q.shape
    s_ = k.shape[1]
    run = lambda: lsum.landmark_summary_bwd(q, k, v, out, dout, scale)
    sdpa, backend = _sdpa_bwd_ms(q, k, v)
    print(f"phase 16 sdpa backward: F.scaled_dot_product_attention's "
          f"backward alone on (B, Hkv, n, D) = ({TRAIN_BATCH}, "
          f"{p // TRAIN_BATCH}, {n}, {d}) against S={s_}, bf16: {sdpa:.4f} "
          f"ms, backend {backend}")
    step = train_out["landmark"]["profile"]
    calls = train_out["landmark"]["launches_per_step"].get(
        "landmark_summary_bwd", 0) // lsum.BWD_LAUNCHES
    in_step = sum(step.get(f"{f} (ms, launches)", [0.0])[0]
                  for f in BWD_DEVICE_FUNCS)
    shape = (f"P={p} (B={TRAIN_BATCH} x Hkv) n={n} (G x n_landmarks) "
             f"S={s_} D={d}")
    plain_ms = _event_ms(lambda: ref.landmark_summary_bwd_ref(
        q, k, v, out, dout, scale), 3)
    bound_ms, bound_by = _bwd_bound(p, n, s_, d, torch.bfloat16)
    tc = dict(
        name="landmark_summary_bwd", route="cuda",
        kernel_route="tensor_core (TMA + wgmma; P, dS and dO in two bf16 "
        "terms; dO's split pass first)", **KERNELS["landmark_summary_bwd"],
        shape=f"{shape} bf16 in, f32 out", launches=launches,
        launches_per_landmark_step=train_out["landmark"][
            "launches_per_step"].get("landmark_summary_bwd", 0),
        max_abs_err=err[torch.bfloat16], ms=_event_ms(run, 5),
        device_ms=_device_ms(run, "landmark_summary_bwd", 10),
        device_ms_in_step=in_step / calls if calls and in_step else None,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=sdpa, library_note="bf16 F.scaled_dot_product_attention "
        "backward alone (bf16 out, causal off)")
    f32_in = model_in[torch.float32]
    f32_run = lambda: lsum.landmark_summary_bwd(*f32_in)
    bound_ms, bound_by = _bwd_bound(p, n, s_, d, torch.float32)
    sdpa_f32, backend = _sdpa_bwd_ms(*f32_in[:3], torch.float32)
    print(f"phase 16 sdpa backward, f32: {sdpa_f32:.4f} ms, backend "
          f"{backend}")
    device = _device_ms(f32_run, "landmark_summary_bwd_f32", 10)
    split = _device_ms(f32_run, "split_terms", 10)
    f32 = dict(
        name="landmark_summary_bwd_f32", route="cuda",
        kernel_route="f32_split (TMA + wgmma; q, k in three bf16 planes, v "
        "and dO in two, P and dS in two; 27 products; four split passes "
        "first)", **KERNELS["landmark_summary_bwd_f32"],
        shape=f"{shape} f32 in, f32 out",
        launches=f32_counts["landmark_summary_bwd_f32"],
        launches_per_f32_step=f32_out["launches_per_step"].get(
            "landmark_summary_bwd", 0),
        max_abs_err=err[torch.float32], ms=_event_ms(f32_run, 5),
        device_ms=device, split_device_ms=split,
        split_share=split / device if split and device else None,
        passes_device_ms_in_step=f32_out["backward_passes_ms_a_call_in_step"],
        plain_ms=_event_ms(lambda: ref.landmark_summary_bwd_ref(*f32_in), 3),
        bound_ms=bound_ms, bound_by=bound_by,
        floor_27_products_ms=_bwd_split_floor(p, n, s_, d),
        library_ms=sdpa_f32, library_note="f32 F.scaled_dot_product_attention "
        "backward alone (causal off)")
    fma_in = model_in["fma"]
    fma_run = lambda: lsum.landmark_summary_bwd(*fma_in)
    p, n, d = fma_in[0].shape
    s_ = fma_in[1].shape[1]
    bound_ms, bound_by = _bwd_bound(p, n, s_, d, torch.float32)
    sdpa_fma, backend = _sdpa_bwd_ms(*fma_in[:3], torch.float32, batch=p)
    print(f"phase 16 sdpa backward, f32 at P={p} n={n} S={s_} D={d}: "
          f"{sdpa_fma:.4f} ms, backend {backend}")
    fma = dict(
        name="landmark_summary_bwd_fma", route="cuda",
        kernel_route="fma (scalar f32 FMAs; D = 256, bf16 or f32 inputs)",
        **KERNELS["landmark_summary_bwd_fma"],
        shape=f"P={p} n={n} S={s_} D={d} f32 in, f32 out (phase 16a)",
        launches=0, max_abs_err=err["fma"], ms=_event_ms(fma_run, 5),
        device_ms=_device_ms(fma_run, "landmark_summary_bwd_fma", 10),
        plain_ms=_event_ms(lambda: ref.landmark_summary_bwd_ref(*fma_in), 3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_fma,
        library_note="f32 F.scaled_dot_product_attention backward alone on "
        f"({p}, 1, {n}, {d}) (causal off)")
    return [tc, f32, fma]


def _lm_bound(p, n, s_, d, dtype):
    """Least time for p problems of softmax(q̃Kᵀ·scale)V with f32 results,
    on the route of the inputs' dtype:
    ``kernels/cost.py::landmark_summary``."""
    return kcost.landmark_summary(p, n, s_, d,
                                  dtype == torch.bfloat16).bound()


def _lm_bound_f32_cores(p, n, s_, d):
    """A yardstick for the f32 route: the same function on f32 inputs with
    every operation at the f32 rate outside the tensor cores — q, k, v read
    once, the output written once, q̃Kᵀ and PV (4·n·S·D) and the exps
    (n·S)."""
    return _bound(4 * p * (n * d + 2 * s_ * d) + 4 * p * n * d,
                  p * (4 * n * s_ * d + n * s_))


def _sdpa_ms(q, k, v, dtype):
    """Events ms of one bf16 or f32 SDPA call on (P, n, D) problems laid
    out as (B, Hkv, n, D), so its fused backends can run, and the backend
    it ran."""
    import torch.nn.functional as F

    p = q.shape[0]
    q4, k4, v4 = (t.reshape(LM_BATCH, p // LM_BATCH, *t.shape[1:]).to(dtype)
                  for t in (q, k, v))
    return (_event_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4),
                      20), _sdpa_backend(q4, k4, v4))


def _moe_shape_row(moe_in, moe_err):
    """Kernel 7's bf16 route at phase 15's DeepSeek shape: time, device
    time, bound, plain version and bf16 SDPA, as the ``moe_*`` fields of
    row 7."""
    q, k, v = moe_in
    p, n, d = q.shape
    s_ = k.shape[1]
    bound_ms, bound_by = _lm_bound(p, n, s_, d, torch.bfloat16)
    sdpa, backend = _sdpa_ms(q, k, v, torch.bfloat16)
    print(f"phase 6 sdpa (bf16 row, DeepSeek shape): (B, Hkv, n, D) = "
          f"({LM_BATCH}, {p // LM_BATCH}, {n}, {d}) against S={s_}: "
          f"{sdpa:.4f} ms, backend {backend}")
    return dict(
        moe_shape=f"P={p} (B={LM_BATCH} x Hkv) n={n} (G x n_landmarks) "
        f"S={s_} D={d} bf16", moe_max_abs_err=moe_err,
        moe_ms=_event_ms(lambda: ops.landmark_summary(q, k, v), 20),
        moe_device_ms=_device_ms(lambda: ops.landmark_summary(q, k, v),
                                 "landmark_summary"),
        moe_plain_ms=_event_ms(lambda: ref.landmark_summary_ref(
            q, k, v, 1.0 / np.sqrt(d)), 5),
        moe_bound_ms=bound_ms, moe_bound_by=bound_by, moe_library_ms=sdpa)


def _lm_rows(model_in, err, launches, life_counts, moe_in, moe_err):
    """Row 7 of the kernel table at phase 8b's shape, one entry per route:
    bf16 inputs on the tensor-core route (launches on the bf16 landmark
    forward), f32 inputs on the f32_split route (launches on the f32 one);
    the bf16 entry also at phase 15's DeepSeek shape (``moe_*``). bf16 and
    f32 SDPA on the same inputs are the yardsticks, and for the f32 route
    the f32-rate bound as well; the port never calls them."""

    rows = []
    for dtype, name, route in (
            (torch.bfloat16, "landmark_summary", "tensor_core"),
            (torch.float32, "landmark_summary_f32", "f32_split")):
        q, k, v = model_in[dtype]
        p, n, d = q.shape
        s_ = k.shape[1]
        bound_ms, bound_by = _lm_bound(p, n, s_, d, dtype)
        extra = _moe_shape_row(moe_in, moe_err) if (
            dtype == torch.bfloat16) else dict(
            bound_f32_cores_ms=_lm_bound_f32_cores(p, n, s_, d)[0],
            split_device_ms=_device_ms(
                lambda: ops.landmark_summary(q, k, v), "split_terms"))
        sdpa_bf16, bf16_backend = _sdpa_ms(q, k, v, torch.bfloat16)
        sdpa_f32, f32_backend = _sdpa_ms(q, k, v, torch.float32)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"phase 6 sdpa ({tag} row): F.scaled_dot_product_attention on "
              f"(B, Hkv, n, D) = ({LM_BATCH}, {p // LM_BATCH}, {n}, {d}) "
              f"against S={s_}: bf16 inputs {sdpa_bf16:.4f} ms, backend "
              f"{bf16_backend}; f32 inputs {sdpa_f32:.4f} ms, backend "
              f"{f32_backend}")
        rows.append(dict(
            name=name, route="cuda", kernel_route=route, **KERNELS[name],
            shape=f"P={p} (B={LM_BATCH} x Hkv) n={n} (G x n_landmarks) "
            f"S={s_} D={d} {tag}", launches=launches[route],
            launches_lifecycle=life_counts["landmark_summary"],
            max_abs_err=err[dtype], max_err=err[dtype],
            ms=_event_ms(lambda: ops.landmark_summary(q, k, v), 20),
            plain_ms=_event_ms(lambda: ref.landmark_summary_ref(
                q, k, v, 1.0 / np.sqrt(d)), 5),
            bound_ms=bound_ms, bound_us=bound_ms * 1e3, bound_by=bound_by,
            library_ms=sdpa_bf16 if dtype == torch.bfloat16 else sdpa_f32,
            library_bf16_ms=sdpa_bf16, library_f32_ms=sdpa_f32,
            device_ms=_device_ms(lambda: ops.landmark_summary(q, k, v),
                                 name), **extra))
    return rows


def _sdpa_backend(q, k, v):
    """The device kernels one SDPA call ran, by name (which backend)."""
    import torch.nn.functional as F

    with obs_profile.profiled() as prof:
        F.scaled_dot_product_attention(q, k, v)
        sync()
    names = {e.name.split("(")[0].removeprefix("void ")[:80]
             for e in _kernels(prof) or ()}
    keys = ("flash", "fmha", "mem_eff", "attention", "cudnn", "gemm")
    named = sorted(x for x in names if any(k in x.lower() for k in keys))
    return named or sorted(names) or "not measured (no device events)"


def phase_training(card):
    """16: the training slice — (a) kernel 7's backward, (b) SmolLM-360M
    trained on both backends, (c) the train CLI, (d) f32 landmark training
    at 2 layers. Returns the backward's table rows and the launches of the
    landmark training run (b) and of the f32 one (d)."""
    t0 = time.perf_counter()
    bwd_in, bwd_err = phase_train_kernel()
    train_counts, train_out = phase_train(card)
    phase_train_cli(card)
    f32_counts, f32_out = phase_train_f32(card)
    rows = _bwd_rows(bwd_in, bwd_err, train_counts.get(
        "landmark_summary_bwd", 0), train_out, f32_counts, f32_out)
    print(f"phase 16: launches {train_counts}, f32 (16d) {f32_counts} | "
          f"{time.perf_counter() - t0:.1f}s")
    return rows, train_counts, f32_counts


# ------------------------------------------------------------------ phase 17
GNN_ARCH = "gatedgcn"
GNN_RUN_SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
GNN_TIMED = "minibatch_lg"  # row 8 is timed at its CSR by destination
GNN_STEPS = 4
GNN_PAD = 1024  # padded edges (node 0, mask 0) appended in 17a
# step 1's gradients, kernel path against the plain segment sum on the
# card: the plain version adds in the kernel's order, so only a leaf's own
# f32 products could differ; each leaf within this share of its largest
# |gradient| (bitwise is expected and printed)
GNN_GRAD_REL = 1e-6
# the mesh form against one device: its bf16 wire (h all-gathered and the
# partial sums added in bf16, 2^-9 relative each) moves the logits by a
# share of their scale, not by a fixed amount: 2^-7 of the largest |logit|
# (the CPU at 3 layers of width 16: up to 3.7e-3 of it over 8 seeds; at
# full width on full_graph_sm 1.8e-3, 0.036 against logits up to 19.7).
# The reference's own bound, 2e-2 absolute at 3 layers of width 16
# (tests/test_distributed.py, where its logits reach 5.4), is printed
# beside it
MESH_REL = 2 ** -7
MESH_ATOL = 2e-2


def _gnn_launches(cfg):
    """Kernel launches of one train step: each layer 2 sums in its forward,
    2 again in its remat recompute and 4 in its backward (the gathers of hv
    and he by source, of hd and the denominator by destination); the
    molecule readout 2 more (pooled sums and counts)."""
    return 8 * cfg.n_layers + (2 if cfg.task == "graph" else 0)


def _gnn_batch(cell, step=0):
    gen = train_cli._gnn_batches(cell.shape)
    for _ in range(step):
        next(gen)
    return next(gen)


def _segsum_bound(x, csr):
    """Least time of one segment sum:
    ``kernels/cost.py::segment_sum``."""
    return kcost.segment_sum(x.shape[1], csr.perm.numel(), csr.n,
                             x.element_size()).bound()


def _segsum_times(x, csr):
    """One CSR's timing: the kernel's event and device ms, its bound, and
    one ``index_add_`` call on the same live edges (the yardstick)."""
    run = lambda: segsum.segment_sum(x, csr)
    live = csr.perm.long()
    idx_live, x_live = csr.index[live], x[live]
    library = lambda: torch.zeros((csr.n, x.shape[1]), dtype=x.dtype,
                                  device=DEVICE).index_add_(0, idx_live,
                                                            x_live)
    bound_ms, bound_by = _segsum_bound(x, csr)
    return dict(events_ms=_event_ms(run, 50),
                device_ms=_device_ms(run, "segment_sum"), bound_ms=bound_ms,
                bound_by=bound_by, index_add_ms=_event_ms(library, 50))


def _segsum_checks(name, key, idx, mask, n, gen, h=70, times=()):
    """17a at one index: f32 and bf16, the kernel bitwise its plain version
    and itself, empty segments 0, padded edges changing nothing; timed in
    each dtype of ``times``."""
    csr = segsum.build_csr(idx, n, mask)
    counts = csr.indptr[1:] - csr.indptr[:-1]
    e = idx.shape[0]
    pad_idx = torch.cat([idx, torch.zeros(GNN_PAD, dtype=idx.dtype,
                                          device=DEVICE)])
    pad_mask = torch.cat([mask, torch.zeros(GNN_PAD, device=DEVICE)])
    masked = segsum.build_csr(pad_idx, n, pad_mask)
    as_live = segsum.build_csr(pad_idx, n, torch.cat([
        mask, torch.ones(GNN_PAD, device=DEVICE)]))
    out, timed = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((e, h), generator=gen, device=DEVICE).to(dtype)
        got = segsum.segment_sum(x, csr)
        again = segsum.segment_sum(x, csr)
        want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
        noise = torch.randn((GNN_PAD, h), generator=gen, device=DEVICE
                            ).to(dtype)
        pad_masked = segsum.segment_sum(torch.cat([x, noise]), masked)
        pad_live = segsum.segment_sum(torch.cat([x, torch.zeros_like(noise)]),
                                      as_live)
        sync()
        tag = f"17a {name} by {key} {dtype}"
        _bitwise(f"{tag}: kernel vs plain", (got,), (want,))
        _bitwise(f"{tag}: two launches", (again,), (got,))
        _bitwise(f"{tag}: masked padded edges", (pad_masked,), (got,))
        _bitwise(f"{tag}: live zero-row padded edges", (pad_live,), (got,))
        if got[counts == 0].any():
            raise AssertionError(f"{tag}: an empty segment is not 0")
        short = str(dtype).removeprefix("torch.")
        out[short] = float((got.float() - want.float()).abs().max())
        if dtype in times:
            timed[short] = _segsum_times(x, csr)
            timed[short]["plain_ms"] = _event_ms(
                lambda: ref.segment_sum_ref(x, csr.perm, csr.indptr), 3)
    return csr, dict(edges=e, live=int(csr.perm.numel()),
                     max_degree=int(counts.max()) if n else 0,
                     heavy_segments=int((counts > segsum.HEAVY).sum()),
                     empty_segments=int((counts == 0).sum()), max_abs_err=out,
                     **timed)


def _segsum_case(case):
    """(index, mask, N, H) of the card tests' schedule cases
    (``tests/test_torch_gpu.py::_segment_case``): power-law degrees at
    each width class H = 1, 31, 32, 33, 128; one segment of 5,000 members
    at H = 70 and 33; segments of HEAVY - 1, HEAVY and HEAVY + 1 members
    among light ones; a large CSR (N = 140,000); every edge masked; no
    edge. N = 3000 otherwise."""
    rng = np.random.default_rng(3)
    n, h = 3000, 70
    if case.startswith("h"):
        w = 1.0 / np.arange(1, n + 1) ** 0.7
        idx, h = rng.choice(n, size=20000, p=w / w.sum()), int(case[1:])
    elif case.startswith("one_5000"):
        idx = np.concatenate([np.full(5000, 7), rng.integers(0, n, 3000)])
        h = 33 if case == "one_5000_h33" else h
    elif case == "large":  # a dense head, then empty rows: chunks of 32
        n = 140000
        idx = rng.integers(0, 9000, 20000)
    elif case.startswith("deg"):
        idx = rng.integers(0, n, 20000)
        idx = np.concatenate([idx[(idx != 1) & (idx != 40) & (idx != 41)],
                              np.repeat([1, 40, 41],
                                        segsum.HEAVY + int(case[3:]))])
    else:  # "all_empty", "no_edges"
        idx = rng.integers(0, n, 0 if case == "no_edges" else 20000)
    mask = np.full(idx.shape[0], 0.0 if case == "all_empty" else 1.0,
                   np.float32)
    return (torch.as_tensor(idx.astype(np.int32), device=DEVICE),
            torch.as_tensor(mask, device=DEVICE), n, h)


SEGSUM_CASES = ("h1", "h31", "h32", "h33", "h128", "one_5000",
                "one_5000_h33", "deg-1", "deg+0", "deg+1", "large",
                "all_empty", "no_edges")


def phase_gnn_kernel():
    """17a: the segment-sum kernel at each trained shape's CSRs (by
    destination and by source; molecule's by graph id too), f32 and bf16,
    each CSR timed in f32 (and bf16 at GNN_TIMED); then at the schedule's
    cases. Returns the timed CSR's inputs, the table's error and the
    per-CSR notes."""
    t0 = time.perf_counter()
    arch = registry.get(GNN_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    notes, timed, err = {}, None, 0.0
    ops.reset_launches()
    for name in GNN_RUN_SHAPES:
        cell = cells.build_cell(arch, name)
        b = trainer.to_device(_gnn_batch(cell), DEVICE)
        n = b["node_feats"].shape[0]
        keys = ["edge_dst", "edge_src"] + (["graph_ids"] if name == "molecule"
                                           else [])
        for key in keys:
            idx = b[key]
            mask = (b["edge_mask"] if key != "graph_ids"
                    else torch.ones(idx.shape[0], device=DEVICE))
            segs = cell.shape.dims["batch"] if key == "graph_ids" else n
            times = ((torch.float32, torch.bfloat16) if name == GNN_TIMED
                     else (torch.float32,))
            csr, notes[f"{name} by {key}"] = _segsum_checks(
                name, key, idx, mask, segs, gen, times=times)
            err = max(err, *notes[f"{name} by {key}"]["max_abs_err"].values())
            print(f"phase 17a {name} by {key}: "
                  + json.dumps(notes[f"{name} by {key}"]))
            if name == GNN_TIMED and key == "edge_dst":
                timed = (torch.randn((idx.shape[0], 70), generator=gen,
                                     device=DEVICE), csr)
    cases = {}
    for case in SEGSUM_CASES:
        idx, mask, n, h = _segsum_case(case)
        _, note = _segsum_checks("case", case, idx, mask, n, gen, h=h)
        cases[case] = {k: note[k] for k in ("live", "max_degree",
                                            "heavy_segments")}
    print(f"phase 17a schedule cases (bitwise as above): "
          + json.dumps(cases))
    print(f"phase 17a segment sum (bitwise its plain version and itself, "
          f"f32 and bf16; empty segments 0; {GNN_PAD} padded edges at node "
          f"0 change nothing, masked or live with zero rows) at "
          f"{len(notes)} CSRs and {len(cases)} cases | launches "
          f"{ops.launch_counts()['segment_sum']} | "
          f"{time.perf_counter() - t0:.1f}s")
    return timed, err, notes


def _gnn_grads(cell, model, batch, plain=False):
    """Step 1's loss and gradients (no update), through the segment sum's
    plain version when ``plain``, with the kernel's launches."""
    patch = (mock.patch.object(segsum, "segment_sum", lambda x, csr:
                               ref.segment_sum_ref(x, csr.perm, csr.indptr))
             if plain else contextlib.nullcontext())
    ops.reset_launches()
    with patch:
        loss, grads = cells.value_and_grad(model, batch, gnn.gnn_loss)
    sync()
    return float(loss), grads, ops.launch_counts()["segment_sum"]


def _gnn_grad_check(name, cell):
    """Step 1 from seed-0 weights on batch 0: two kernel-path runs bitwise
    equal; the kernel path against the plain one within GNN_GRAD_REL of
    each leaf's largest |gradient|."""
    cfg = cell.arch.model
    model = gnn.init_gnn(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                         DEVICE)
    batch = trainer.to_device(_gnn_batch(cell), DEVICE)
    lk, gk, nk = _gnn_grads(cell, model, batch)
    lk2, gk2, _ = _gnn_grads(cell, model, batch)
    lp, gp, np_ = _gnn_grads(cell, model, batch, plain=True)
    if lk2 != lk or not all(torch.equal(gk[k], gk2[k]) for k in gk):
        raise AssertionError(f"17b {name}: two kernel-path runs of step 1 "
                             f"differ (loss {lk} vs {lk2})")
    if nk != _gnn_launches(cfg) or np_:
        raise AssertionError(f"17b {name}: {nk} launches on the kernel path "
                             f"(want {_gnn_launches(cfg)}), {np_} on the "
                             f"plain one")
    rel = max(float((gk[k] - gp[k]).abs().max())
              / max(float(gp[k].abs().max()), 1e-30) for k in gp)
    if not rel <= GNN_GRAD_REL or abs(lk - lp) > GNN_GRAD_REL * abs(lp):
        raise AssertionError(f"17b {name}: step-1 gradients kernel vs plain "
                             f"{rel:.3g} of a leaf's max (limit "
                             f"{GNN_GRAD_REL}); loss {lk} vs {lp}")
    return dict(loss_kernel=lk, loss_plain=lp, max_leaf_rel=rel,
                bitwise_plain=lk == lp and all(torch.equal(gk[k], gp[k])
                                               for k in gp),
                bitwise_twice=True)


def _gnn_run(name):
    """GNN_STEPS steps of GatedGCN at full width and depth through
    ``build_cell`` and ``train_loop`` from seed-0 weights on the shape's
    own generator; each step timed to its loss with its launches."""
    arch = registry.get(GNN_ARCH)
    cell = cells.build_cell(arch, name)
    model = gnn.init_gnn(cell.arch.model, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    opt_state = topt.opt_init(model, arch.opt)
    per_step = []

    def step_fn(model, opt_state, batch):
        sync()
        ops.reset_launches()
        t1 = time.perf_counter()
        out = cell.fn(model, opt_state, batch)
        loss = float(out[2]["loss"])
        per_step.append(dict(ms=(time.perf_counter() - t1) * 1e3, loss=loss,
                             counts=ops.launch_counts()))
        return out

    torch.cuda.reset_peak_memory_stats()
    res = trainer.train_loop(
        step_fn, model, opt_state, trainer.Prefetcher(
            train_cli._gnn_batches(cell.shape),
            lambda b: trainer.to_device(b, DEVICE)),
        trainer.TrainerConfig(total_steps=GNN_STEPS, log_every=1000),
        log=lambda *_: None)
    return dict(cell=cell, model=model, opt_state=opt_state, steps=per_step,
                losses=res["losses"], peak=torch.cuda.max_memory_allocated())


def phase_gnn_train(card):
    """17b: GatedGCN trained at full width and depth (16 layers, d_hidden
    70, f32, AdamW, remat) on full_graph_sm, minibatch_lg and molecule;
    per-step launches, losses, step ms, peak memory, a profiled step; step
    1's gradients kernel vs plain and twice. Returns the kernel path's
    launches."""
    t0 = time.perf_counter()
    counts = {}
    for name in GNN_RUN_SHAPES:
        run = _gnn_run(name)
        cell, model, opt_state = run["cell"], run["model"], run["opt_state"]
        cfg = cell.arch.model
        losses = run["losses"]
        if len(losses) != GNN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"17b {name}: losses {losses}")
        for i, st in enumerate(run["steps"]):
            others = {k: v for k, v in st["counts"].items()
                      if k != "segment_sum" and v}
            if st["counts"]["segment_sum"] != _gnn_launches(cfg) or others:
                raise AssertionError(f"17b {name} step {i}: launches "
                                     f"{st['counts']}, want segment_sum "
                                     f"{_gnn_launches(cfg)} and no other")
            for k, v in st["counts"].items():
                counts[k] = counts.get(k, 0) + v
        batch = trainer.to_device(_gnn_batch(cell, GNN_STEPS), DEVICE)
        prof = _profile(lambda: float(cell.fn(model, opt_state, batch)[2][
            "loss"]), warm=False, sums=("segment_sum",))
        del model, opt_state, batch
        grads = _gnn_grad_check(name, cell)
        ms = [st["ms"] for st in run["steps"]]
        out = dict(
            layers=cfg.n_layers, d_hidden=cfg.d_hidden, d_feat=cfg.d_feat,
            n_classes=cfg.n_classes, task=cfg.task,
            nodes=tuple(cell.args[2]["node_feats"].shape)[0],
            edges=tuple(cell.args[2]["edge_src"].shape)[0], losses=losses,
            step_ms=ms, steady_step_ms=statistics.median(ms[1:]),
            peak_gib=run["peak"] / 2 ** 30,
            segment_sum_launches_per_step=run["steps"][-1]["counts"][
                "segment_sum"], profile=prof, step1=grads)
        print(f"phase 17b train ({card}): {GNN_ARCH} {name} f32, AdamW, "
              f"remat: " + json.dumps(out))
        del run
        torch.cuda.empty_cache()
    print(f"phase 17b: launches {counts} | {time.perf_counter() - t0:.1f}s")
    return counts


def _mesh_check(model, raw, mesh):
    b = trainer.to_device(raw, DEVICE)
    args = (b["node_feats"], b["edge_src"], b["edge_dst"], b["edge_mask"])
    ops.reset_launches()
    with torch.no_grad():
        sharded = gnn.gnn_forward_sharded(model, *args, mesh)
        sync()
        launches = ops.launch_counts()["segment_sum"]
        one = gnn.gnn_forward(model, *args)
    err = float((sharded - one).abs().max())
    scale = float(one.abs().max())
    limit = MESH_REL * scale
    if not err <= limit or not bool(torch.isfinite(sharded).all()):
        raise AssertionError(f"17c: mesh form vs one device {err:.4g} "
                             f"(limit {limit:.4g}, max |logit| {scale:.4g})")
    return dict(max_abs_diff=err, max_abs_logit=scale, limit=limit,
                within_2e_2=err <= MESH_ATOL, forward_launches=launches)


def phase_gnn_mesh(card):
    """17c: the comm variant (the mesh form) on a single-process mesh
    (data=2, model=4, the reference's debug mesh) on the card: its logits
    against the one-device forward, at the reference test's configuration
    and at full width on full_graph_sm; one train step of the comm cell."""
    t0 = time.perf_counter()
    mesh = make_mesh(*cells.COMM_MESH, DEVICE)
    if any(d.type != torch.device(DEVICE).type for d in mesh.devices):
        raise AssertionError(f"17c: mesh devices {mesh.describe()}")
    small = gnn.GNNConfig("g", n_layers=3, d_hidden=16, d_feat=8,
                          n_classes=5)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(64, 8)).astype(np.float32)
    src = rng.integers(0, 64, 256).astype(np.int32)
    dst = rng.integers(0, 64, 256).astype(np.int32)
    raw = gnn.dst_partition({"node_feats": feats, "edge_src": src,
                             "edge_dst": dst,
                             "edge_mask": np.ones(256, np.float32)}, 2, 4)
    ref_cfg = _mesh_check(gnn.init_gnn(small, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE), raw, mesh)
    cell = cells.build_cell(registry.get(GNN_ARCH), "full_graph_sm", "comm")
    model = gnn.init_gnn(cell.arch.model, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    raw = gnn.dst_partition(_gnn_batch(cell), 2, 4)
    full = _mesh_check(model, raw, mesh)
    opt_state = topt.opt_init(model, cell.arch.opt)
    batch = trainer.to_device(raw, DEVICE)
    ops.reset_launches()
    sync()
    t1 = time.perf_counter()
    loss = float(cell.fn(model, opt_state, batch)[2]["loss"])
    step_ms = (time.perf_counter() - t1) * 1e3
    launches = ops.launch_counts()["segment_sum"]
    if not np.isfinite(loss) or launches != 8 * _gnn_launches(
            cell.arch.model):
        raise AssertionError(f"17c: comm step loss {loss}, {launches} "
                             f"launches (want 8 edge shards x "
                             f"{_gnn_launches(cell.arch.model)})")
    print(f"phase 17c mesh form ({card}; {mesh.describe()}; limit "
          f"{MESH_REL} x max |logit|): the reference test's configuration (3 "
          f"layers, d 16, N=64, E=256 dst-partitioned): "
          + json.dumps(ref_cfg) + "; full_graph_sm at full width: "
          + json.dumps(full) + f"; one comm train step: loss {loss:.4f}, "
          f"{step_ms:.1f} ms, {launches} launches | "
          f"{time.perf_counter() - t0:.1f}s")


def _gnn_row(timed, err, counts, notes):
    """Row 8 of the kernel table: the segment sum at minibatch_lg's CSR by
    destination (f32), with its launches on the GNN training runs (17b),
    events and device ms, bound, plain ms, and one index_add_ call (CUDA
    atomics) on the same live edges as the yardstick."""
    x, csr = timed
    run = lambda: segsum.segment_sum(x, csr)
    live = csr.perm.long()
    idx_live, x_live = csr.index[live], x[live]
    library = lambda: torch.zeros((csr.n, x.shape[1]), device=DEVICE
                                  ).index_add_(0, idx_live, x_live)
    got, lib1, lib2 = run(), library(), library()
    sync()
    bound_ms, bound_by = _segsum_bound(x, csr)
    return dict(
        name="segment_sum", route="cuda", **KERNELS["segment_sum"],
        shape=f"minibatch_lg by destination: N={csr.n} E={csr.n_edges} "
        f"(live {live.numel()}) H={x.shape[1]} f32",
        launches=counts.get("segment_sum", 0),
        launches_gnn=counts.get("segment_sum", 0), max_abs_err=err,
        ms=_event_ms(run, 20), device_ms=_device_ms(run, "segment_sum"),
        plain_ms=_event_ms(lambda: ref.segment_sum_ref(x, csr.perm,
                                                       csr.indptr), 5),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=_event_ms(library, 20),
        library_note="torch.zeros(N, H).index_add_(0, index, x) on the live "
        "edges (CUDA atomics; the port never calls it)",
        library_bitwise_kernel=bool(torch.equal(lib1, got)),
        library_bitwise_itself=bool(torch.equal(lib1, lib2)),
        per_csr={k: {t: v[t] for t in ("live", "max_degree", "float32",
                                       "bfloat16") if t in v}
                 for k, v in notes.items()})


def phase_gnn(card):
    """17: the GNN slice — (a) the segment-sum kernel, (b) GatedGCN trained
    at full width on three shapes, (c) the mesh form. Returns row 8 and
    the GNN training runs' launches."""
    t0 = time.perf_counter()
    timed, err, notes = phase_gnn_kernel()
    counts = phase_gnn_train(card)
    phase_gnn_mesh(card)
    row = _gnn_row(timed, err, counts, notes)
    print(f"phase 17: row 8 {json.dumps(row)} | "
          f"{time.perf_counter() - t0:.1f}s")
    return row, counts

# ------------------------------------------------------------------ phase 18
REC_ARCHS = ("fm", "bert4rec", "mind", "dien")
REC_STEPS = 3
REC_SERVE = ("serve_p99", "serve_bulk", "retrieval_cand")
# kernels whose names mark an atomic scatter-add (index_add_, which
# index_select's backward runs; scatter_add_ and torch.gather's backward,
# the scatter-like instantiation of the scatter/gather kernel): a recsys
# train step must launch none of them (the gather-like one, <false, …>, is
# a copy)
REC_ATOMIC = ("indexFunc", "scatter_gather_internal_kernel<true")
REC_MESH = 4  # 18a's mesh lookup: model = 4 row shards of one table


def _atomic_probe():
    """REC_ATOMIC against the library's own scatter-adds: the backward of
    ``index_select`` (``index_add_``) and of ``torch.gather`` (a
    scatter-like ``scatter_add_``) must each launch a kernel that one of
    its names matches, or 18b's check would pass vacuously."""
    gen = torch.Generator(device=DEVICE).manual_seed(181)
    idx = torch.randint(0, 512, (4096,), generator=gen, device=DEVICE)
    hits = {}
    for name, use in (
            ("index_select", lambda t: t.index_select(0, idx)),
            ("gather", lambda t: torch.gather(t, 0, idx[:, None].expand(
                -1, t.shape[1])))):
        t = torch.randn((512, 16), generator=gen, device=DEVICE,
                        requires_grad=True)

        def run():
            use(t).sum().backward()

        prof = _profile(run, sums=REC_ATOMIC)
        hits[name] = sum(prof.get(f"{k} (ms, launches)", [0, 0])[1]
                         for k in REC_ATOMIC)
        if "device_time" not in prof and not hits[name]:
            raise AssertionError(f"18b: REC_ATOMIC sees no kernel of "
                                 f"{name}'s backward")
    return hits


def _rec_inputs(cfg, meta, step=0, rows=None):
    """A batch for a recsys cell's ``meta`` inputs at ``rows`` rows (the
    meta batch when None), on the card: what the reference's generators
    (``fm_train_batch``, ``seq_rec_batch``) make, seeded uniform ids for
    the rest (candidates)."""
    rows = rows or next(iter(meta.values())).shape[0]
    n_mask = (meta["mask_positions"].shape[1] if "mask_positions" in meta
              else 0)
    n_neg = meta["negatives"].shape[0] if "negatives" in meta else 0
    if isinstance(cfg, recsys.FMConfig):
        raw = synthetic.fm_train_batch(0, step, rows, cfg.field_vocabs)
        hi = cfg.total_rows
    else:
        raw = synthetic.seq_rec_batch(0, step, rows, cfg.seq_len,
                                      cfg.n_items, n_mask, n_neg)
        hi = cfg.n_items
    rng = np.random.default_rng([18, step])
    out = {}
    for key, t in meta.items():
        shape = (tuple(t.shape) if key in ("negatives", "cand_ids")
                 else (rows,) + tuple(t.shape[1:]))
        out[key] = (raw[key] if key in raw
                    else rng.integers(0, hi, shape).astype(np.int32))
        assert out[key].shape == shape, (key, out[key].shape, shape)
    return trainer.to_device(out, DEVICE)


def _oom_search(try_rows, rows):
    """The largest power-of-two batch from ``rows`` down at which
    ``try_rows(rows)`` runs, halving on CUDA out-of-memory; (rows, the
    batches that ran out of memory)."""
    ooms = []
    while True:
        try:
            try_rows(rows)
            sync()
            return rows, ooms
        except torch.OutOfMemoryError:
            ooms.append(rows)
        gc.collect()
        torch.cuda.empty_cache()
        rows //= 2
        if rows < 1:
            raise AssertionError("18: no batch fits the card")


def _rec_csr(tag, ids, n, widths, gen):
    """18a at one lookup CSR: f32 rows of each width through the kernel,
    bitwise its plain version and itself, timed (events, device, bound,
    ``index_add_``) with the heavy/light split (CUDA-event ms of the launch
    with every heavy slot unused, the light walk alone, and with no chunk,
    the heavy units alone); the CSR's shape and schedule."""
    csr = embedding.lookup_csr(ids, n)
    counts = (csr.indptr[1:] - csr.indptr[:-1])
    light, heavy = segsum_tool.split(csr)
    note = dict(segments=n, edges=csr.n_edges, live=int(csr.perm.numel()),
                max_degree=int(counts.max()),
                head_share=float(counts.max()) / max(csr.perm.numel(), 1),
                heavy_segments=int((counts > segsum.HEAVY).sum()),
                chunks=csr.chunk_rows.numel() - 1,
                chunk_size=segsum.chunk_size(n, csr.perm.numel()))
    for h in widths:
        x = torch.randn((csr.n_edges, h), generator=gen, device=DEVICE)
        got, again = segsum.segment_sum(x, csr), segsum.segment_sum(x, csr)
        t1 = time.perf_counter()
        want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
        sync()
        plain_s = time.perf_counter() - t1
        _bitwise(f"18a {tag} H={h}: kernel vs plain", (got,), (want,))
        _bitwise(f"18a {tag} H={h}: two launches", (again,), (got,))
        note[f"H={h}"] = dict(
            _segsum_times(x, csr), plain_s=plain_s,
            light_alone_ms=_event_ms(lambda: segsum.segment_sum(x, light),
                                     20),
            heavy_alone_ms=_event_ms(lambda: segsum.segment_sum(x, heavy),
                                     20))
        del x, got, again, want
    return note


def _rec_like_cases(gen):
    """18a: the card tests' recsys-like CSRs
    (``tools/time_segment_sum.py::rec_like_case``), f32, bitwise the plain
    version and across two launches."""
    out = {}
    for kind in ("fm_like_h1", "fm_like_h10", "zipf_head"):
        idx, n, h = segsum_tool.rec_like_case(kind, DEVICE)
        csr = segsum.build_csr(idx, n, torch.ones(idx.shape[0],
                                                  device=DEVICE))
        x = torch.randn((idx.shape[0], h), generator=gen, device=DEVICE)
        got, again = segsum.segment_sum(x, csr), segsum.segment_sum(x, csr)
        want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
        sync()
        _bitwise(f"18a {kind}: kernel vs plain", (got,), (want,))
        _bitwise(f"18a {kind}: two launches", (again,), (got,))
        counts = csr.indptr[1:] - csr.indptr[:-1]
        out[kind] = dict(rows=n, max_degree=int(counts.max()),
                         heavy_segments=int((counts > segsum.HEAVY).sum()))
    return out


def _rec_mesh_check(gen):
    """18a: the lookup's mesh form (model = REC_MESH row shards on the
    card) bitwise the plain form, values and the table's gradient, on
    Zipf ids with padding."""
    mesh = make_mesh(("model",), (REC_MESH,), DEVICE)
    table = torch.randn((4096, 16), generator=gen, device=DEVICE)
    ids = torch.as_tensor(synthetic.seq_rec_batch(0, 0, 64, 50, 4096)[
        "item_ids"], device=DEVICE)
    ids[:8, :5] = -1
    cot = torch.randn(tuple(ids.shape) + (16,), generator=gen, device=DEVICE)
    out = []
    for m in (None, mesh):
        t = table.clone().requires_grad_()
        val = embedding.embedding_lookup(t, ids, m)
        (val * cot).sum().backward()
        out.append((val.detach(), t.grad))
    sync()
    _bitwise("18a mesh lookup (model=4) vs plain", out[1], out[0])
    return dict(table=(4096, 16), ids=tuple(ids.shape), shards=REC_MESH,
                bitwise_values_and_grad=True)


def phase_rec_kernel(b4r_rows):
    """18a: row 8 at the two recsys CSRs — FM's by field id at train_batch
    (v at H = 10 and w at H = 1 share it) and BERT4Rec's by item id at its
    18b batch, with the Zipf head — then the mesh lookup."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    notes = {key: _rec_csr(key.split()[0], ids, n, widths, gen)
             for key, ids, n, widths in segsum_tool.recsys_inputs(
                 DEVICE, b4r_rows)}
    cases = _rec_like_cases(gen)
    mesh = _rec_mesh_check(gen)
    for key, note in notes.items():
        print(f"phase 18a {key}: " + json.dumps(note))
    print(f"phase 18a recsys-like cases (bitwise as above): "
          + json.dumps(cases))
    print(f"phase 18a segment sum at the recsys CSRs (bitwise its plain "
          f"version and itself, f32); mesh lookup {json.dumps(mesh)} | "
          f"{time.perf_counter() - t0:.1f}s")
    return notes


def _rec_step1(arch, rows, plain=False):
    """Step 1 from seed-0 weights on batch 0 at ``rows`` rows: the loss,
    the gradients, the parameters after the update and the launches;
    through the plain segment sum when ``plain``."""
    cell = cells.build_cell(arch, "train_batch")
    model = recsys.init_recsys(arch.model, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    state = topt.opt_init(model, arch.opt)
    batch = _rec_inputs(arch.model, cell.args[2], 0, rows)
    patch = (mock.patch.object(segsum, "segment_sum", lambda x, csr:
                               ref.segment_sum_ref(x, csr.perm, csr.indptr))
             if plain else contextlib.nullcontext())
    ops.reset_launches()
    with patch:
        loss, grads = cells.value_and_grad(model, batch, recsys.family(
            arch.model).loss)
        topt.opt_update(model, grads, state, arch.opt)
    sync()
    params = {k: p.detach() for k, p in model.named_parameters()}
    return float(loss), grads, params, ops.launch_counts()["segment_sum"]


def _rec_step1_check(arch, rows):
    """Two kernel-path runs of step 1: gradients and updated parameters
    bitwise equal; the plain-sum run's gradients bitwise the kernel's."""
    lk, gk, pk, nk = _rec_step1(arch, rows)
    lk2, gk2, pk2, _ = _rec_step1(arch, rows)
    for tag, a, b in (("gradients", gk, gk2), ("parameters", pk, pk2)):
        if lk != lk2 or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f"18b {arch.name}: step-1 {tag} differ "
                                 f"between two runs")
    del gk2, pk2, pk
    lp, gp, _, np_ = _rec_step1(arch, rows, plain=True)
    same = lp == lk and all(torch.equal(gk[k], gp[k]) for k in gk)
    if not same or np_:
        raise AssertionError(f"18b {arch.name}: step-1 gradients with the "
                             f"plain sum differ from the kernel's (loss {lk} "
                             f"vs {lp}; plain-path launches {np_})")
    return dict(loss=lk, launches=nk, bitwise_twice=True,
                bitwise_plain=True)


def _rec_train(name, card):
    """18b for one arch at full width: the largest power-of-two batch up
    to train_batch that one forward and backward fits (the next power of
    two ran out of memory), REC_STEPS AdamW steps through ``build_cell``
    and ``train_loop``, a profiled step, step 1 twice and with the plain
    sum."""
    arch = registry.get(name)
    cell = cells.build_cell(arch, "train_batch")
    full = cell.shape.dims["batch"]
    model = recsys.init_recsys(arch.model, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    loss_fn = recsys.family(arch.model).loss

    def fits(rows):
        batch = _rec_inputs(arch.model, cell.args[2], 0, rows)
        cells.value_and_grad(model, batch, loss_fn)

    rows, ooms = _oom_search(fits, full)
    gc.collect()
    torch.cuda.empty_cache()
    opt_state = topt.opt_init(model, arch.opt)
    per_step = []

    def step_fn(model, opt_state, batch):
        sync()
        ops.reset_launches()
        t1 = time.perf_counter()
        out = cell.fn(model, opt_state, batch)
        loss = float(out[2]["loss"])
        per_step.append(dict(ms=(time.perf_counter() - t1) * 1e3, loss=loss,
                             counts=ops.launch_counts()))
        return out

    def batches():
        step = 0
        while True:
            yield _rec_inputs(arch.model, cell.args[2], step, rows)
            step += 1

    torch.cuda.reset_peak_memory_stats()
    res = trainer.train_loop(
        step_fn, model, opt_state, batches(),
        trainer.TrainerConfig(total_steps=REC_STEPS, log_every=1000),
        log=lambda *_: None)
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    if len(losses) != REC_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"18b {name}: losses {losses}")
    counts = {}
    for i, st in enumerate(per_step):
        others = {k: v for k, v in st["counts"].items()
                  if k != "segment_sum" and v}
        if not st["counts"]["segment_sum"] or others:
            raise AssertionError(f"18b {name} step {i}: launches "
                                 f"{st['counts']}")
        for k, v in st["counts"].items():
            counts[k] = counts.get(k, 0) + v
    batch = _rec_inputs(arch.model, cell.args[2], REC_STEPS, rows)
    prof = _profile(lambda: float(cell.fn(model, opt_state, batch)[2][
        "loss"]), warm=False, sums=("segment_sum",) + REC_ATOMIC)
    atomics = {k: prof.get(f"{k} (ms, launches)", [0, 0])[1]
               for k in REC_ATOMIC}
    if any(atomics.values()):
        raise AssertionError(f"18b {name}: atomic scatter kernels in a step "
                             f"{atomics}")
    del model, opt_state, batch, res
    gc.collect()
    torch.cuda.empty_cache()
    step1 = _rec_step1_check(arch, rows)
    ms_ = [st["ms"] for st in per_step]
    out = dict(
        config={f.name: getattr(arch.model, f.name)
                for f in dataclasses.fields(arch.model)
                if f.name not in ("dtype", "field_vocabs")},
        table_rows=arch.model.table_rows, batch=rows, train_batch=full,
        ran_out_of_memory_at=ooms, losses=losses, step_ms=ms_,
        steady_step_ms=statistics.median(ms_[1:]), peak_gib=peak / 2 ** 30,
        segment_sum_launches_per_step=per_step[-1]["counts"]["segment_sum"],
        atomic_scatter_kernels=atomics, profile=prof, step1=step1)
    print(f"phase 18b train ({card}): {name} full width f32, AdamW: "
          + json.dumps(out))
    return rows, counts


def _rec_serve(name, card):
    """18c for one arch: the scores cells at serve_p99 and serve_bulk (or
    the largest power-of-two batch that fits) and the retrieval cell at
    retrieval_cand, ms a call and peak memory; the card's top-100 ids
    against a CPU run of the port on the same parameters and inputs,
    under the tie rule."""
    arch = registry.get(name)
    model = recsys.init_recsys(arch.model, torch.Generator(
        device=DEVICE).manual_seed(0), DEVICE)
    out, counts = {}, {}
    for shape in REC_SERVE:
        cell = cells.build_cell(arch, shape)
        full = cell.shape.dims["batch"]

        def call(rows):
            cell.fn(model, _rec_inputs(arch.model, cell.args[1], 1, rows))

        rows, ooms = _oom_search(call, full)
        gc.collect()
        torch.cuda.empty_cache()
        batch = _rec_inputs(arch.model, cell.args[1], 1, rows)
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        got = cell.fn(model, batch)
        sync()
        peak = torch.cuda.max_memory_allocated()
        for k, v in ops.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        rec = dict(batch=rows, ran_out_of_memory_at=ooms,
                   ms=_event_ms(lambda: cell.fn(model, batch), 3),
                   peak_gib=peak / 2 ** 30)
        if shape == "retrieval_cand":
            cpu = recsys.family(arch.model).cls(arch.model, "cpu")
            convert.load_recsys_tree(cpu, convert.recsys_tree(model))
            wv, wi = cell.fn(cpu, {k: v.cpu() for k, v in batch.items()})
            bad = list_mismatches(wv, wi, got[0], got[1])
            if bad.size or got[1].shape != (1, 100):
                raise AssertionError(f"18c {name}: top-100 ids differ from "
                                     f"the CPU's beyond the tie rule")
            rec.update(ids_equal=bool(torch.equal(wi, got[1].cpu())),
                       tie_rule_mismatches=0, top_id=int(got[1][0, 0]))
            del cpu
        elif not bool(torch.isfinite(got).all()):
            raise AssertionError(f"18c {name} {shape}: non-finite scores")
        out[shape] = rec
        del batch, got
        torch.cuda.empty_cache()
    print(f"phase 18c serve ({card}): {name}: " + json.dumps(out))
    return counts


def phase_rec_example(d):
    """18d: the landmark-retrieval example's kernels at its shapes — d1
    over the item × user matrix (A = B = 3952 and B = 64 landmarks, P =
    6040, pearson), the tensor-core route bitwise the f32 route and within
    RTOL/ATOL of the plain version; kernel 7's f32_split route at P = 4,
    n = 64 and 256, S = 2048, D = 64 within LM_RTOL/LM_ATOL — then the
    example itself. Returns its launches (d1; kernel 7 by route)."""
    t0 = time.perf_counter()
    inter = d.to_matrix(device=DEVICE).ratings.T.contiguous()
    counts = (inter != 0).sum(dim=1)
    lms = inter[torch.argsort(-counts, stable=True)[:64]].contiguous()
    errs = {}
    for tag, b in (("item-item", inter), ("64 landmarks", lms)):
        got = ops.masked_similarity(inter, b, "pearson")
        f32 = ops.masked_similarity(inter, b, "pearson", route="f32")
        want = ref.masked_similarity_ref(inter, b, "pearson")
        sync()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        if not torch.equal(got, f32):
            raise AssertionError(f"18d d1 {tag}: the tensor-core route is "
                                 f"not bitwise the f32 route")
        errs[f"d1 {tag}"] = float((got - want).abs().max())
        del got, f32, want
    p, s_, dd = 4, ex_retrieval.ATTN_SHAPE[1], ex_retrieval.ATTN_SHAPE[3]
    for i, n in enumerate(ex_retrieval.ATTN_LANDMARKS):
        q, k, v = _lm_inputs(p, n, s_, dd, torch.float32, seed=180 + i)
        got = ops.landmark_summary(q, k, v)
        want = ref.landmark_summary_ref(q, k, v, 1.0 / np.sqrt(dd))
        sync()
        torch.testing.assert_close(got, want, rtol=LM_RTOL, atol=LM_ATOL)
        errs[f"kernel 7 f32 P={p} n={n} S={s_}"] = float(
            (got - want).abs().max())
    ops.reset_launches()
    res = ex_retrieval.main(["--device", DEVICE])
    sync()
    launches = dict(ops.launch_counts(), landmark_summary_f32=dict(
        lsum.landmark_summary.route_launches)["f32_split"])
    if launches["masked_similarity"] != 2 or launches[
            "landmark_summary_f32"] != 2:
        raise AssertionError(f"18d: example launches {launches}")
    print(f"phase 18d landmark retrieval example (rtol={RTOL} atol={ATOL}; "
          f"kernel 7 rtol={LM_RTOL} atol={LM_ATOL}): {json.dumps(errs)}; "
          f"example {json.dumps(res)} | launches masked_similarity "
          f"{launches['masked_similarity']}, landmark_summary f32_split "
          f"{launches['landmark_summary_f32']} | "
          f"{time.perf_counter() - t0:.1f}s")
    return {k: v for k, v in launches.items()
            if k in ("masked_similarity", "landmark_summary_f32")}


def phase_recsys(d, card):
    """18: the recsys slice — (b) each arch trained at full width, (a) row
    8 at the recsys CSRs (BERT4Rec's at 18b's batch), (c) serving, (d) the
    landmark-retrieval example's kernels. Returns the CSR notes and the
    launches of 18b–18d by kernel row."""
    t0 = time.perf_counter()
    print(f"phase 18b atomic scatter-add kernels seen by REC_ATOMIC in the "
          f"library's backwards: {json.dumps(_atomic_probe())}")
    counts, rows = {}, {}
    for name in REC_ARCHS:
        rows[name], c = _rec_train(name, card)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    notes = phase_rec_kernel(rows["bert4rec"])
    for name in REC_ARCHS:
        for k, v in _rec_serve(name, card).items():
            counts[k] = counts.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    counts.update(phase_rec_example(d))
    print(f"phase 18: batches {rows}, launches {counts} | "
          f"{time.perf_counter() - t0:.1f}s")
    return notes, counts

# --------------------------------------- CF cells, dry run, compression (19)
CF_ARCH = "landmark_cf"
CF_DATA = {"ml1m_fit": "movielens1m", "netflix1m_fit": "netflix1m"}
CF_SAMPLE = 2048  # web_fit's rows held to the plain path
CF_BLOCK = 256  # of them at a time through the plain top-k
# the card's peak bytes allocated in a step beyond what it held before,
# against the dry run's temp bytes: within TEMP_REL of them plus TEMP_ABS
# (the caching allocator's rounding, the top-k scan's split lists)
TEMP_REL, TEMP_ABS = 0.10, 64 << 20


def _cf_inputs(name, cell):
    """A CF cell's ratings on the card: the synthetic dataset of its shape
    (all of its ratings) padded to the cell's rows, or web_fit's made on
    the card (phase 14c's generator)."""
    rows, p = cell.args[1].shape
    if name == "web_fit":
        return web_tool.web_ratings(rows, p, DEVICE)
    d = data.synthesize(CF_DATA[name], seed=0)
    r = torch.zeros((rows, p), device=DEVICE)
    r[:d.n_users] = d.to_matrix(device=DEVICE).ratings
    return r


def _cf_fit_cell(name, arch, card):
    """19a: one cf_fit cell on the card (kernels 1 and 2 counted) against
    the plain path on the same ratings: popularity landmarks, the plain
    d1 and the streaming graph (web_fit: CF_SAMPLE rows, the plain top-k
    of those rows over the kernel's representation)."""
    cell = cells.build_cell(arch, name)
    spec = arch.model
    n_lm = cell.shape.dims.get("n_landmarks", spec.n_landmarks)
    k = spec.k_neighbors
    r = _cf_inputs(name, cell)
    u = r.shape[0]
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    idx, rep, w, nb = cell.fn(None, r)
    sync()
    first_s = time.perf_counter() - t0
    counts = _counts()
    # whole stars: one d1 call, on the tensor-core route, its result kept
    d1 = ms.route_results()
    _check_d1_routes(f"phase 19a {name}", counts, d1)
    split = None
    if name == "web_fit":  # seconds a call: one more, on the host clock
        t0 = time.perf_counter()
        cell.fn(None, r)
        sync()
        ms_ = (time.perf_counter() - t0) * 1e3
        split = web_tool.web_split(lambda: cell.fn(None, r))
        PROFILE_DROPS.append(split["markers_lost"])
    else:
        ms_ = _event_ms(lambda: cell.fn(None, r), 5)
    if counts["masked_similarity"] != 1 or counts["topk_sim"] < 1:
        raise AssertionError(f"phase 19a {name}: kernel 1 must launch once "
                             f"and kernel 2, got {counts}")
    p_idx = popularity_landmarks(r, n_lm)
    rows = (torch.arange(u, device=DEVICE) if name != "web_fit" else
            torch.linspace(0, u - 1, CF_SAMPLE, device=DEVICE).long())
    p_rep = ref.masked_similarity_ref(r[rows], r[p_idx], spec.d1)
    if name == "web_fit":
        # self excluded: each sampled row's own id dropped from k + 1; the
        # plain top-k a block of CF_BLOCK rows at a time (the scores and
        # sort of all CF_SAMPLE rows against U take ~8 GB at once)
        repq = kernel_rows(rep, spec.d2)
        parts = [ref.foldin_topk_ref(repq[blk], repq, k + 1, None, None,
                                     spec.d2) for blk in rows.split(CF_BLOCK)]
        pv, pi = filter_self_from_topk(torch.cat([v for v, _ in parts]),
                                       torch.cat([i for _, i in parts]),
                                       rows, k)
        del parts
        plain = finalize_topk(pv, pi)
    else:
        plain = build_neighbor_graph(p_rep, spec.d2, k, "streaming")
    rep_err = float((rep[rows] - p_rep).abs().max())
    bad = list_mismatches(plain.weights, plain.indices, w[rows], nb[rows],
                          RTOL, ATOL)
    # the tensor-core route's rows bitwise the f32 route's on the card,
    # and cosine bitwise the plain version
    f32_same = torch.equal(rep[rows], _d1_f32(r[rows], r[p_idx], spec.d1))
    plain_same = spec.d1 != "cosine" or torch.equal(rep[rows], p_rep)
    ok = (torch.equal(idx, p_idx) and bad.size == 0 and f32_same
          and plain_same
          and torch.allclose(rep[rows], p_rep, rtol=RTOL, atol=ATOL)
          and torch.isfinite(w).all() and nb.shape == (u, k))
    if not ok:
        raise AssertionError(f"phase 19a {name}: the cell differs from the "
                             f"plain path: landmarks equal "
                             f"{torch.equal(idx, p_idx)}, d1 max err "
                             f"{rep_err}, bitwise the f32 route {f32_same}, "
                             f"cosine bitwise the plain version "
                             f"{plain_same}, rows beyond the tie rule "
                             f"{bad[:10].tolist()}")
    out = dict(U=u, P=r.shape[1], n=n_lm, ms=ms_, first_call_s=first_s,
               launches={k_: v for k_, v in counts.items() if v},
               d1_results=d1, d1_max_abs_err=rep_err,
               d1_bitwise_f32_route=f32_same, rows_compared=int(rows.numel()))
    print(f"phase 19a {CF_ARCH}/{name} ({card}): " + json.dumps(out))
    if split is not None:
        print(f"phase 19a {CF_ARCH}/{name} step split ({card}): "
              + json.dumps(dict(U=u, step_ms=ms_, **split)))
    return r, (w, nb), counts


def _cf_predict_cell(arch, r, graph, card):
    """19a: ml1m_predict's 131,072 pairs over the ml1m_fit graph on the
    card, against the same step on the CPU (no kernel: Eq. (1) in plain
    torch)."""
    cell = cells.build_cell(arch, "ml1m_predict")
    pairs = cell.shape.dims["n_pairs"]
    rng = np.random.default_rng(19)
    users = torch.as_tensor(rng.integers(0, r.shape[0], pairs),
                            dtype=torch.int32, device=DEVICE)
    items = torch.as_tensor(rng.integers(0, r.shape[1], pairs),
                            dtype=torch.int32, device=DEVICE)
    args = (*graph, r, users, items)
    ops.reset_launches()
    got = cell.fn(*args)
    sync()
    counts = _counts()
    ms_ = _event_ms(lambda: cell.fn(*args), 5)
    want = cell.fn(*(a.cpu() for a in args))
    err = float((got.cpu() - want).abs().max())
    if not (got.shape == (pairs,) and torch.isfinite(got).all()
            and torch.allclose(got.cpu(), want, rtol=RTOL, atol=ATOL)):
        raise AssertionError(f"phase 19a ml1m_predict: card vs CPU max err "
                             f"{err}")
    print(f"phase 19a {CF_ARCH}/ml1m_predict ({card}): " + json.dumps(dict(
        pairs=pairs, ms=ms_, max_abs_err_vs_cpu=err,
        launches={k_: v for k_, v in counts.items() if v})))
    return args


def _smoke_cells():
    """(tag, arch, shape name, the step's inputs on the card) of the smoke
    cells whose counts the card and the dry run compare: SmolLM's smoke
    model trained at B = 4, S = 128 with full and with landmark attention
    (kernel 7 and its backward), the GNN's smoke model on a 200-node graph
    with no padded edge (every edge live, as the meta CSR counts) and FM's
    smoke model on 256 rows."""
    gen = torch.Generator(DEVICE).manual_seed(0)
    out = []
    lm_cfg = registry.get("smollm-360m").smoke_model
    for backend in ("full", "landmark"):
        cfg = dataclasses.replace(lm_cfg, attn_backend=backend)
        arch = dataclasses.replace(
            registry.get("smollm-360m"), model=cfg, grad_accum={},
            shapes=(ShapeSpec("train_4k", "train", dict(batch=4, seq=128)),))
        model = lm.init_lm(cfg, gen, DEVICE)
        batch = trainer.to_device(synthetic.lm_batch(0, 0, 4, 128, cfg.vocab),
                                  DEVICE)
        out.append((f"smollm-smoke/train/{backend}", arch, "train_4k",
                    (model, topt.opt_init(model, arch.opt), batch)))
    gcfg = registry.get("gatedgcn").smoke_model
    dims = dict(n_nodes=200, n_edges=800, d_feat=gcfg.d_feat,
                n_classes=gcfg.n_classes)
    arch = dataclasses.replace(registry.get("gatedgcn"), model=gcfg, shapes=(
        ShapeSpec("full_graph_sm", "train_graph", dims),))
    model = gnn.init_gnn(gcfg, gen, DEVICE)
    batch = trainer.to_device(synthetic.random_graph(0, 200, 800, gcfg.d_feat,
                                                     gcfg.n_classes), DEVICE)
    out.append(("gatedgcn-smoke/full_graph_sm", arch, "full_graph_sm",
                (model, topt.opt_init(model, arch.opt), batch)))
    fcfg = registry.get("fm").smoke_model
    arch = dataclasses.replace(registry.get("fm"), model=fcfg, shapes=(
        ShapeSpec("train_batch", "train", dict(batch=256)),))
    model = recsys.init_recsys(fcfg, gen, DEVICE)
    batch = trainer.to_device(synthetic.fm_train_batch(0, 0, 256,
                                                       fcfg.field_vocabs),
                              DEVICE)
    out.append(("fm-smoke/train_batch", arch, "train_batch",
                (model, topt.opt_init(model, arch.opt), batch)))
    return out


def _card_vs_meta(tag, arch, shape_name, args, card):
    """19b: one cell's step counted on the card (after a warm-up call, so
    the library's workspaces are held before) against the dry run's count
    of the same cell on meta: FLOPs equal, the card's peak allocated bytes
    beyond what it held before within the stated margin of the temp
    bytes."""
    meta = dryrun.count_cell(arch, shape_name)[0]
    cell = cells.build_cell(arch, shape_name)
    cell.fn(*args)
    sync()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out, got = step_costs.measure(cell.fn, args)
    sync()
    peak = torch.cuda.max_memory_allocated() - held
    temp = meta.memory["temp_size_in_bytes"]
    row = dict(flops_card=got.flops, flops_meta=meta.flops,
               kernel_ops_card=got.kernel_ops, kernel_ops_meta=meta.kernel_ops,
               max_memory_allocated_beyond_held=peak, temp_bytes_meta=temp,
               temp_bytes_card_traced=got.memory["temp_size_in_bytes"],
               kernels_card={k_: v["calls"] for k_, v in got.kernels.items()},
               kernels_meta={k_: v["calls"] for k_, v in meta.kernels.items()})
    print(f"phase 19b card vs dry run {tag} ({card}): " + json.dumps(row))
    if got.flops != meta.flops or row["kernels_card"] != row["kernels_meta"]:
        raise AssertionError(f"phase 19b {tag}: the card counted "
                             f"{got.flops} FLOPs and kernels "
                             f"{row['kernels_card']}, the dry run "
                             f"{meta.flops} and {row['kernels_meta']}")
    if abs(peak - temp) > TEMP_REL * temp + TEMP_ABS:
        raise AssertionError(f"phase 19b {tag}: peak {peak} B on the card "
                             f"against temp {temp} B of the dry run, beyond "
                             f"{TEMP_REL} of it + {TEMP_ABS} B")
    del out
    return row


def _compression_on_card(card):
    """19c: the quantizers on the card bitwise the CPU's on the same
    inputs; psum_compressed on make_debug_mesh() (8 positions round robin
    on one card) bitwise the CPU mesh's and within the reference test's
    bound (n · max|x| / 127 + 1e-5 of the exact sum)."""
    rng = np.random.default_rng(19)
    grads = {name: rng.standard_normal(shape).astype(np.float32) * scale
             for name, shape, scale in (("w", (512, 256), 1.0),
                                        ("b", (256,), 1e-3),
                                        ("e", (1000, 10), 30.0))}
    cpu = {k: torch.as_tensor(v) for k, v in grads.items()}
    gpu = {k: v.to(DEVICE) for k, v in cpu.items()}
    bufs_c, bufs_g = (compression.init_error_buffers(g) for g in (cpu, gpu))
    for step in range(3):
        (qc, sc), bufs_c, dc = compression.tree_compress(cpu, bufs_c)
        (qg, sg), bufs_g, dg = compression.tree_compress(gpu, bufs_g)
        for k_ in grads:
            for a, b in ((qc, qg), (sc, sg), (bufs_c, bufs_g), (dc, dg)):
                if not torch.equal(_bits(a[k_]), _bits(b[k_].cpu())):
                    raise AssertionError(f"phase 19c: {k_} step {step} "
                                         f"differs from the CPU's")
    res = {}
    for multi_pod, axis in ((False, "data"), (False, "model"), (True, "pod")):
        mesh = make_debug_mesh(multi_pod=multi_pod)
        x = torch.as_tensor(rng.normal(size=(32, 32)).astype(np.float32))
        n = mesh.shape[axis]
        got = compression.psum_compressed(x.to(DEVICE), mesh, axis)
        want = compression.psum_compressed(
            x, make_debug_mesh(multi_pod=multi_pod, device="cpu"), axis)
        err = float((got.cpu() - n * x).abs().max())
        bound = n * float(x.abs().max()) / 127.0 + 1e-5
        if not (torch.equal(_bits(got.cpu()), _bits(want)) and err <= bound
                and all(d.type == "cuda" for d in mesh.devices)):
            raise AssertionError(f"phase 19c psum over {axis}: err {err} "
                                 f"bound {bound}")
        res[f"{mesh.describe()} over {axis}"] = dict(max_abs_err=err,
                                                      bound=bound)
    print(f"phase 19c compression ({card}): quantizers, error feedback and "
          f"tree_compress bitwise the CPU's over 3 steps; psum_compressed "
          + json.dumps(res))


def phase_cells(card):
    """19: (a) the CF cells at full size on the card, (b) the dry run on
    meta and the card's counts against it, (c) compression on the card.
    Returns the launches of 19a's cells by kernel row."""
    t0 = time.perf_counter()
    launches = {}
    arch = registry.get(CF_ARCH)
    fits = {}
    for name in ("ml1m_fit", "netflix1m_fit"):
        r, graph, counts = _cf_fit_cell(name, arch, card)
        for k_, v in counts.items():
            launches[k_] = launches.get(k_, 0) + v
        fits[name] = (r, graph)
    pargs = _cf_predict_cell(arch, *fits["ml1m_fit"], card)
    full_u = arch.shape("web_fit").dims["n_users"]
    total = torch.cuda.get_device_properties(0).total_memory
    web_u, need = web_tool.web_users(total)
    web = web_tool.web_arch(n_users=web_u)
    print(f"phase 19a web_fit cut ({card}): U from {full_u} to {web_u}, the "
          f"most whose dry-run argument + temp bytes ({need}) fit "
          f"{web_tool.WEB_HEADROOM} of the card's {total} B; P and n as "
          f"registered")
    wr, _, counts = _cf_fit_cell("web_fit", web, card)
    for k_, v in counts.items():
        launches[k_] = launches.get(k_, 0) + v
    t_b = time.perf_counter()
    records = [r for fam in ("gnn", "recsys", "cf")
               for r in dryrun.main(["--all", "--family", fam])]
    print(f"phase 19b dry run: {len(records)} cells (the GNN, recsys and CF "
          f"families; the LM's on a mesh in phase 20) on meta in "
          f"{time.perf_counter() - t_b:.1f}s")
    for name, (r, _) in fits.items():
        _card_vs_meta(f"{CF_ARCH}/{name}", arch, name, (None, r), card)
    _card_vs_meta(f"{CF_ARCH}/ml1m_predict", arch, "ml1m_predict", pargs,
                  card)
    del fits, pargs
    _card_vs_meta(f"{CF_ARCH}/web_fit U={web_u}", web, "web_fit", (None, wr),
                  card)
    del wr
    gc.collect()
    torch.cuda.empty_cache()
    for tag, a, shape_name, args in _smoke_cells():
        _card_vs_meta(tag, a, shape_name, args, card)
        del args
    _compression_on_card(card)
    print(f"phase 19: {time.perf_counter() - t0:.1f}s")
    return launches

# ------------------------------------------------------------------ phase 20
# SmolLM-360M at full width and depth, landmark attention, AdamW, remat,
# trained over the reference's debug mesh (data=2, model=4) by 8 ranks, one
# process each, on the one card: the ranks share its 80 GB, so the global
# batch is cut from train_4k's 256 to 4 (one process alone peaks at
# 35.8 GiB at B = 8)
P20_ARCH, P20_BATCH, P20_STEPS = "smollm-360m", 4, 2
P20_MESH = (("data", "model"), (2, 4))
P20_TIMEOUT = 420  # s for the 8 ranks' run, spawn and build included
# each rank's loss against the one-process step's: the bf16 loss bound of
# tests/test_torch_lm.py (rtol 1e-2; the mesh sums in another order)
P20_LOSS_RTOL = 1e-2
# the leaves whose step-1 gradient and step-2 value the ranks hold against
# the one-process step's, each rank its own blocks (``mesh_run.held``; the
# embedding, the first layer's query projection, the last layer's MLP down
# projection), each with its bounds on |mesh - one process| / |one
# process| (Frobenius) of the gradient and of the value: about 2.5 times
# the H100's readings (PERF.md, phase 20). The embedding's gradient is loose by nature: its
# most frequent token's row sums thousands of lookup gradients in bf16, so
# the one-process bf16 step's is 0.84 from the f32 step's there; the
# reference's bf16 lookup gives the same bits
# (tests/test_torch_bf16_lookup.py), a fault the two share
P20_LEAVES = {"embed": (0.5, 1e-4), "layers.0.wq": (0.05, 1e-4),
              "layers.31.w2": (0.02, 1e-4)}
# the one-process runs' whole leaves, read by each rank for its own blocks
DIST_DIR = ROOT / "build" / "phase20"


def _saved_leaves(name, run, keys):
    """``run``'s whole leaves of ``keys`` (``grads``, ``params``,
    ``updates``) saved under :data:`DIST_DIR` for ranks to hold their
    blocks against (``mesh_run.train(against=...)``): its path."""
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    path = DIST_DIR / f"{name.replace(' ', '_')}.pt"
    torch.save({k: run[k] for k in keys}, path)
    return str(path)


def _p20_arch():
    from repro_torch.launch import mesh_run

    return mesh_run.smoke_arch(P20_ARCH, backend="landmark", smoke=False,
                               batch=P20_BATCH, seq=LM_SEQ)


def _p20_dry(arch):
    """The dry run of phase 20's cell at the debug mesh: per-device
    collectives by kind, argument and temp bytes. Its fake group's mesh is
    of the card's type, as the ranks' is, so DTensor plans the same
    collectives (a CPU mesh swaps an all-to-all for an all-gather)."""
    from repro_torch.launch import dist as dist_mod
    from repro_torch.launch.mesh import device_mesh

    with dist_mod.fake_group(8):
        costs, layers, traced = dryrun.count_cell(
            arch, "train", mesh=device_mesh(*P20_MESH, DEVICE))
    coll = {k: v for k, v in costs.collectives.items()
            if not k.startswith("_") and v}
    return dict(collectives=coll, counts={
        k: v for k, v in costs.collectives["_counts"].items() if v},
        argument_bytes=costs.memory["argument_size_in_bytes"],
        temp_bytes=costs.memory["temp_size_in_bytes"], layers=layers,
        traced=traced)


def phase_dist(card):
    """20: the multi-process launcher and the logical-axis rules on the
    card. (a) SmolLM-360M's landmark train step in one process at B = 4,
    the comparison; (b) the dry run of the same cell over the debug mesh on
    meta; (c) 8 ranks (``launch/dist.py::spawn``) on data=2, model=4 train
    it 2 steps with the parameters, AdamW state and batch placed by the
    arch's rules. Checks: every rank's loss within the bf16 bound of the
    one-process step's, kernel 7's forward and backward launched in every
    rank on the tensor-core route, a forward and a remat recompute a layer
    and a backward a layer each step, each rank's collectives (count and
    bytes by kind, step 2) equal to the dry run's, and :data:`P20_LEAVES`'
    step-1 gradients and step-2 values within their bounds of the
    one-process step's (each rank holds its blocks against the
    one-process leaves, saved whole; ``mesh_run.held``). Prints the backend and why,
    per-rank step ms (gloo over host memory on one shared card: nothing
    about NCCL), peak memory beside the dry run's argument + temp bytes,
    and what the collectives built from others really moved. Returns
    rank 0's launches by kernel row."""
    from repro_torch.launch import dist as dist_mod
    from repro_torch.launch import mesh_run

    t0 = time.perf_counter()
    arch = _p20_arch()
    cfg = arch.model
    one = mesh_run.train(DEVICE, arch, steps_n=P20_STEPS, want_grads=True,
                         want_params=True, leaves=list(P20_LEAVES))
    # the same step in f32: how far bf16 alone moves each leaf's gradient
    one32 = mesh_run.train(
        DEVICE, dataclasses.replace(arch, model=dataclasses.replace(
            cfg, dtype=torch.float32)), want_grads=True,
        leaves=list(P20_LEAVES))
    print(f"phase 20a one process ({card}): {P20_ARCH} L={cfg.n_layers} "
          f"d={cfg.d_model} B={P20_BATCH} S={LM_SEQ} landmark: losses "
          f"{one['losses']}, step ms {one['step_ms']}, peak GiB "
          f"{one['peak_bytes'] / 2 ** 30:.2f}")
    gc.collect()
    torch.cuda.empty_cache()
    t_dry = time.perf_counter()
    dry = _p20_dry(arch)
    print(f"phase 20b dry run of the cell at data=2,model=4 on meta "
          f"({time.perf_counter() - t_dry:.1f}s, depths {dry['traced']} "
          f"taken to {dry['layers']}): " + json.dumps(dry))
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t_run = time.perf_counter()
    ref = _saved_leaves(P20_ARCH, one, ("grads", "params"))
    place = dist_mod.spawn(
        mesh_run.ranks_run, 8, [(P20_ARCH, arch, dict(against=ref))],
        P20_MESH, P20_STEPS, device=DEVICE, threads=1, timeout=P20_TIMEOUT)
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    held = time.perf_counter() - t_run
    ranks = [dict(p[P20_ARCH], rank=p["rank"]) for p in place]
    r0 = ranks[0]
    print(f"phase 20c ({card}): 8 ranks on mesh {dict(zip(*P20_MESH))}, "
          f"device {place[0]['device']}, backend {place[0]['backend']} "
          f"({place[0]['reason']}); collectives built from others: "
          f"{place[0]['built'] or 'none'}; spawned, built and trained in "
          f"{held:.1f}s")
    launches = {}
    bwd_calls = cfg.n_layers * lsum.BWD_LAUNCHES
    for r in ranks:
        counts = {k: sum(st.get(k, 0) for st in r["launches"])
                  for k in ("landmark_summary", "landmark_summary_bwd")}
        coll = {k: v["bytes"] for k, v in r["collectives"][-1].items()}
        ncoll = {k: v["count"] for k, v in r["collectives"][-1].items()}
        print(f"phase 20c rank {r['rank']}: losses {r['losses']} (one "
              f"process {one['losses']}), launches {counts}, step ms "
              f"{[round(x, 1) for x in r['step_ms']]} (gloo over host "
              f"memory on one shared card), peak GiB "
              f"{r['peak_bytes'] / 2 ** 30:.2f} (dry run: argument + temp "
              f"{(dry['argument_bytes'] + dry['temp_bytes']) / 2 ** 30:.2f}"
              f"), collective bytes {coll}, moved {r['moved']}")
        np.testing.assert_allclose(r["losses"], one["losses"],
                                   rtol=P20_LOSS_RTOL)
        for st in r["launches"]:  # each step: forward and remat recompute
            assert st["landmark_summary"] == 2 * cfg.n_layers, st
            assert st["landmark_summary_bwd"] == bwd_calls, st
        assert coll == {k: int(v) for k, v in dry["collectives"].items()}, (
            coll, dry["collectives"])
        assert ncoll == {k: int(v) for k, v in dry["counts"].items()}, (
            ncoll, dry["counts"])
        if r["rank"] == 0:
            launches = counts
    errs, over = {}, []
    for name, tols in P20_LEAVES.items():
        for key, tol in zip(("grads", "params"), tols):
            errs[f"{key} {name}"] = err = mesh_run.held(ranks, key, name)
            if not err <= tol:
                over.append((key, name, err, tol))
        w32 = one32["grads"][name]
        errs[f"grads {name} one vs f32"] = float(
            (one["grads"][name] - w32).norm() / w32.norm())
    print(f"phase 20c ranks against one process, |diff| / |one| over each "
          f"copy of a leaf, the largest (bounds {P20_LEAVES}; step-1 "
          f"gradients, step-2 values; the one-process bf16 gradients against "
          f"the f32 step's beside them): " + json.dumps(errs))
    assert not over, over
    print(f"phase 20: {time.perf_counter() - t0:.1f}s")
    return launches



# ------------------------------------------------------------------ phase 21
# The recsys family and GatedGCN trained over the debug mesh by 8 ranks on
# the one card, each in a process of its own (as phase 20): FM at full
# width and train_batch, MIND, DIEN and BERT4Rec at full width, each at the
# largest power-of-two batch whose 8 ranks' dry-run argument + temp bytes
# stay under P21_HEADROOM of the card (the ranks share its memory; one
# process ran BERT4Rec out of memory past 16,384, phase 18b), and
# GatedGCN's comm variant at full width on minibatch_lg
P21_MESH = P20_MESH
P21_REC = ("fm", "mind", "dien", "bert4rec")
P21_GNN_SHAPE = "minibatch_lg"
P21_STEPS = 2
P21_TIMEOUT = 420  # s for the 8 ranks' five runs, spawn and build included
P21_HEADROOM = 0.8
# each rank's loss against the one-process run's, about 3 times the
# H100's readings (PERF.md, phase 21): recsys, f32, one ulp apart (8.6e-8:
# the mesh adds its partial sums over the ranks in another order), and
# GatedGCN's comm form (4.6e-5: bf16 partials on the wire, added in
# another order than the single-process form's)
P21_LOSS_RTOL = {"recsys": 3e-7, "comm": 1.5e-4}
# the leaves whose step-1 gradient and update over the 2 steps (last value
# less the initial one) the ranks hold against the one-process run's
# (each rank its own blocks, ``mesh_run.held``): every table and a dense leaf of each recsys arch,
# GatedGCN's first layer's U and V and its head. The update, not the
# value: a step moves a value by about lr / warmup = 1e-5 of itself, so a
# value's bound cannot see a wrong or missing update. Each with its
# bounds on |mesh - one process| / |one process| (Frobenius) of the
# gradient and of the update: about 3 times the H100's readings (PERF.md,
# phase 21), 1e-6 at least (1e-4 on the wire). The sequence models' tables
# read the most (2.0e-5 to 6.9e-5): their rows sum tens of thousands of
# terms that mostly cancel, added in another order over the data blocks
P21_LEAVES = {
    "fm": {"v": (1e-6, 1e-6), "w": (1e-6, 1e-6), "b": (2e-6, 4e-6)},
    "mind": {"item_embed": (2e-4, 1e-6), "s_matrix": (2e-6, 5e-5)},
    "dien": {"item_embed": (7e-5, 2e-6), "gru1.wh": (1e-6, 3e-5)},
    "bert4rec": {"item_embed": (3e-5, 6e-6), "layers.0.wq": (1e-6, 4e-5)},
    "gatedgcn comm": {"layers.0.U": (3e-3, 6e-2), "layers.0.V": (3e-3, 7e-2),
                      "head_w": (1e-4, 2e-4)},
}
# row 8's launches a step a rank: a lookup's backward each (FM's v and w
# share one CSR, one backward each; BERT4Rec's masked-position gather is
# one too); GatedGCN 8 a layer (2 forward, 2 in the remat recompute, 4
# backward)
P21_ROW8 = {"fm": 2, "mind": 4, "dien": 2, "bert4rec": 4}


def _p21_dry(arch, shape, variant="base"):
    """The dry run of a phase-21 cell at the debug mesh on meta, its fake
    group's mesh of the card's type (as :func:`_p20_dry`): per-device
    collectives by kind, argument and temp bytes."""
    from repro_torch.launch import dist as dist_mod
    from repro_torch.launch.mesh import device_mesh

    with dist_mod.fake_group(8):
        costs, _, _ = dryrun.count_cell(
            arch, shape, variant, mesh=device_mesh(*P21_MESH, DEVICE))
    return dict(
        collectives={k: int(v) for k, v in costs.collectives.items()
                     if not k.startswith("_") and v},
        counts={k: int(v) for k, v in costs.collectives["_counts"].items()
                if v},
        argument_bytes=costs.memory["argument_size_in_bytes"],
        temp_bytes=costs.memory["temp_size_in_bytes"])


def _p21_cases(card_bytes):
    """(tag, arch, variant) of each phase-21 run, the dry run of each, and
    the batches cut on the way to each recsys arch's."""
    from repro_torch.launch import mesh_run

    cases, dry, cuts = [], {}, {}
    for name in P21_REC:
        b = registry.get(name).shape("train_batch").dims["batch"]
        while True:
            arch = mesh_run.rec_arch(name, smoke=False, batch=b)
            d = _p21_dry(arch, "train_batch")
            need = 8 * (d["argument_bytes"] + d["temp_bytes"])
            if need < P21_HEADROOM * card_bytes or b == 1:
                break
            cuts.setdefault(name, []).append([b, need])
            b //= 2
        cases.append((name, arch, "base"))
        dry[name] = dict(d, batch=b)
    arch = mesh_run.gnn_arch(P21_GNN_SHAPE, smoke=False)
    cases.append(("gatedgcn comm", arch, "comm"))
    dry["gatedgcn comm"] = _p21_dry(arch, P21_GNN_SHAPE, "comm")
    return cases, dry, cuts


def phase_dist_families(card):
    """21: the recsys family and GatedGCN on the multi-process layer. (a)
    each run's dry run at the debug mesh on meta (the recsys batches cut
    to what 8 ranks hold), (b) each run in one process on the card, 2
    steps, the comparison (the comm form: the single-process mesh form on
    the same axes), (c) 8 ranks (``launch/dist.py::spawn``) on data=2,
    model=4 run the five one after another, 2 steps each
    (``mesh_run.ranks_run``). Checks: every rank's losses equal, and
    within their bound of (b)'s; row 8's launches in every rank and step
    (:data:`P21_ROW8`); no atomic scatter kernel (``REC_ATOMIC``) in a
    rank's profiled first step, and kernels in every rank's profile; each
    rank's collectives (count and bytes by kind, step 2) equal to (a)'s;
    :data:`P21_LEAVES`' step-1 gradients and updates, each rank's blocks
    held against (b)'s saved leaves, within their bounds. Prints the
    batches and their cuts, the backend and why, step ms a rank (gloo over
    host memory on one shared card: nothing about NCCL), peak memory a
    rank beside (a)'s argument + temp bytes. Returns rank 0's row-8
    launches over the five runs."""
    from repro_torch.launch import dist as dist_mod
    from repro_torch.launch import mesh_run

    t0 = time.perf_counter()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    cases, dry, cuts = _p21_cases(card_bytes)
    print(f"phase 21a dry runs at data=2,model=4 on meta "
          f"({time.perf_counter() - t0:.1f}s; batch cuts [batch, 8 ranks' "
          f"argument + temp bytes] past {P21_HEADROOM} of the card's "
          f"{card_bytes} B: {json.dumps(cuts)}): " + json.dumps(dry))
    one, runs = {}, []
    for tag, arch, variant in cases:
        gc.collect()
        torch.cuda.empty_cache()
        r = mesh_run.train(DEVICE, arch, variant=variant, comm_axes=P21_MESH,
                           steps_n=P21_STEPS, want_grads=True,
                           want_updates=True, leaves=list(P21_LEAVES[tag]))
        runs.append((tag, arch, dict(variant=variant, against=_saved_leaves(
            tag, r, ("grads", "updates")))))
        one[tag] = r = {k: v for k, v in r.items()
                        if k not in ("grads", "updates")}
        print(f"phase 21b one process ({card}): {tag} batch "
              f"{arch.shapes[0].dims.get('batch', arch.shapes[0].name)}: "
              f"losses {r['losses']}, step ms "
              f"{[round(x, 1) for x in r['step_ms']]}, row 8 launches "
              f"{[st['segment_sum'] for st in r['launches']]}, peak GiB "
              f"{r['peak_bytes'] / 2 ** 30:.2f}")
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t_run = time.perf_counter()
    ranks = dist_mod.spawn(mesh_run.ranks_run, 8, runs, P21_MESH, P21_STEPS,
                           REC_ATOMIC, device=DEVICE, threads=1,
                           timeout=P21_TIMEOUT)
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    held = time.perf_counter() - t_run
    r0 = ranks[0]
    print(f"phase 21c ({card}): 8 ranks on mesh {dict(zip(*P21_MESH))}, "
          f"device {r0['device']}, backend {r0['backend']} ({r0['reason']});"
          f" collectives built from others: {r0['built'] or 'none'}; "
          f"spawned, built and ran the five in {held:.1f}s")
    launches, errs, over = 0, {}, []
    for tag, arch, variant in cases:
        want_row8 = (8 * arch.model.n_layers if arch.family == "gnn"
                     else P21_ROW8[tag])
        d = dry[tag]
        for r in ranks:
            got = r[tag]
            coll = {k: v["bytes"] for k, v in got["collectives"][-1].items()}
            ncoll = {k: v["count"] for k, v in got["collectives"][-1].items()}
            prof = got.get("profile", {"kernels": 0, "watched": {}})
            print(f"phase 21c {tag} rank {r['rank']}: losses {got['losses']} "
                  f"(one process {one[tag]['losses']}), row 8 launches "
                  f"{[st['segment_sum'] for st in got['launches']]}, step ms "
                  f"{[round(x, 1) for x in got['step_ms']]} (the first "
                  f"profiled; gloo over host memory on one shared card), "
                  f"peak GiB {got['peak_bytes'] / 2 ** 30:.2f} (dry run: "
                  f"argument + temp "
                  f"{(d['argument_bytes'] + d['temp_bytes']) / 2 ** 30:.2f})"
                  f", collective bytes {coll}, moved {got['moved']}, "
                  f"profiled first step: {prof['kernels']} kernels, atomic "
                  f"scatter kernels {prof['watched']}")
            assert got["losses"] == ranks[0][tag]["losses"], tag
            np.testing.assert_allclose(
                got["losses"], one[tag]["losses"], err_msg=tag,
                rtol=P21_LOSS_RTOL["comm" if variant == "comm" else "recsys"])
            for st in got["launches"]:
                assert st["segment_sum"] == want_row8, (tag, st)
            # the atomics' check reads the profile: it must have seen
            # the step's kernels
            assert prof["kernels"] > 0, (tag, r["rank"], prof)
            assert not any(prof["watched"].values()), (tag, prof)
            assert coll == d["collectives"], (tag, coll, d["collectives"])
            assert ncoll == d["counts"], (tag, ncoll, d["counts"])
        launches += sum(st["segment_sum"] for st in r0[tag]["launches"])
        for leaf, tols in P21_LEAVES[tag].items():
            for key, tol in zip(("grads", "updates"), tols):
                errs[f"{tag} {key} {leaf}"] = err = mesh_run.held(
                    [r[tag] for r in ranks], key, leaf)
                if not err <= tol:
                    over.append((tag, key, leaf, err, tol))
    print(f"phase 21c ranks against one process, |diff| / |one| over each "
          f"copy of a leaf, the largest (bounds (gradient, update) "
          f"{P21_LEAVES}; step-1 gradients, updates over the {P21_STEPS} "
          f"steps): " + json.dumps(errs))
    assert not over, over
    print(f"phase 21: {time.perf_counter() - t0:.1f}s")
    return {"segment_sum": launches}

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port never falls back to the "
              "CPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (full f32, as the reference's "
          "Precision.HIGHEST)")
    card = phase_device()
    phase_build()
    t0 = time.perf_counter()
    d = data.synthesize("movielens1m", seed=0)
    train_idx, test_idx = data.kfold_split(d, 0)
    train = d.to_matrix(train_idx, device=DEVICE).ratings
    print(f"data: movielens1m-shaped synthetic, {d.n_ratings} ratings, "
          f"{time.perf_counter() - t0:.1f}s")
    err = phase_kernels(train)
    a, peak = phase_main_path(train, d, test_idx)
    phase_serve()
    ivf = phase_ivf_kernels(a)
    err.update({name: 0.0 for name in IVF_KERNELS})  # bitwise, checked
    ivf_counts = phase_ivf_path(train, a)
    life_counts = phase_lifecycle()
    model_in, lm_err, moe_in, moe_err = phase_lm_kernel()
    lm_launches = phase_lm_forward()
    phase_lm_serve()
    engine_counts = phase_engine()
    table = (phase_times(train, a, err, peak, life_counts)
             + _ivf_rows(ivf, ivf_counts, life_counts, err)
             + _lm_rows(model_in, lm_err, lm_launches, life_counts,
                        moe_in, moe_err))
    # after the kernel times: run after phase 10, phase 6's profiler
    # sessions saw only part of the device events
    mutation_counts = phase_mutation(a["state"], card)
    paper_counts = phase_paper(d, train_idx, test_idx, a, card)
    mesh_counts = phase_mesh(a, card)
    engine_mesh_counts = phase_engine_mesh(a, card)
    wide_counts = phase_wide(train, d, test_idx, card)
    moe_counts = phase_moe(card)
    bwd_rows, train_counts, f32_counts = phase_training(card)
    gnn_row, gnn_counts = phase_gnn(card)
    rec_notes, rec_counts = phase_recsys(d, card)
    cell_counts = phase_cells(card)
    dist_counts = phase_dist(card)
    dist_counts.update(phase_dist_families(card))
    gnn_row["per_csr"].update({key: {t: v[t] for t in v if t.startswith(
        ("live", "max_degree", "head_share", "H="))}
        for key, v in rec_notes.items()})
    table += bwd_rows + [gnn_row]
    for row in table:  # the engine runs' launches, every row
        row["launches_engine"] = engine_counts.get(row["name"], 0)
        row["launches_mutations"] = mutation_counts.get(row["name"], 0)
        row["launches_paper"] = paper_counts.get(row["name"], 0)
        row["launches_mesh"] = mesh_counts.get(row["name"], 0)
        row["launches_engine_mesh"] = engine_mesh_counts.get(row["name"], 0)
        row["launches_wide"] = wide_counts.get(row["name"], 0)
        # the tensor-core route: phase 15 checks every launch was on it
        row["launches_moe"] = (0 if row["name"] == "landmark_summary_f32"
                               else moe_counts.get(row["name"], 0))
        # the landmark training run (16b): kernel 7 forward and backward
        row["launches_train"] = (0 if row["name"] == "landmark_summary_f32"
                                 else train_counts.get(row["name"], 0))
        # the f32 landmark training run (16d): the f32 rows of kernel 7
        # and its backward
        row["launches_train_f32"] = f32_counts.get(row["name"], 0)
        # the GNN training runs (17b)
        row["launches_gnn"] = gnn_counts.get(row["name"], 0)
        # the recsys runs (18b, 18c) and the landmark-retrieval example (18d)
        row["launches_recsys"] = rec_counts.get(row["name"], 0)
        # the CF cells (19a)
        row["launches_cells"] = cell_counts.get(row["name"], 0)
        # rank 0 of the 8-rank mesh runs: kernel 7 and its backward (20c),
        # row 8 over the recsys and GatedGCN runs (21c)
        row["launches_dist"] = dist_counts.get(row["name"], 0)
        for tag, times in ivf["wide_ms"].items():  # kernels 2-6, 7a
            if row["name"] in times:
                row[f"{tag} ms"] = times[row["name"]]
    # kernel 6's shared form (the back-patch, 7a) beside its per-query row
    row6 = next(r for r in table if r["name"] == "score_candidates")
    row6["shared_form"] = {**ivf["patch_ms"], **{
        tag: times["score_candidates shared"]
        for tag, times in ivf["wide_ms"].items()}}
    print(f"profiler: {len(PROFILE_DROPS)} sessions, each opened by "
          f"{PROFILE_MARKERS} markers; markers dropped: max "
          f"{max(PROFILE_DROPS)}, in {sum(map(bool, PROFILE_DROPS))} "
          f"sessions; sessions that lost every marker (not measured): "
          f"{PROFILE_DROPS.count(PROFILE_MARKERS)}")
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
