"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

 1. the card's name and power limit; build every kernel of the main paths
    from ``src/repro_torch/kernels/csrc`` (one nvcc per source, started
    together) and print the build seconds;
 2. each kernel against its plain PyTorch version on the card, at the
    main paths' shapes and at ragged ones, synchronizing after every
    launch:
    * ``pairwise_sqdist`` ((1 048 576, 64), (4096, 64) and (1, 64) rows
      against (8, 64) centers; (4096, 32) and (1, 32) rows against
      (8, 32) centers; the kNN tiles (1024, 32) x (16 384, 32), the
      fusion tests (4096, 32) x (4096, 32) and (1024, 32) x (1024, 32);
      the LSH windows (256, 64, 32) x (256, 192, 32) as one batch; spectral
      seeding's (1 048 576, 8) x (8, 8), then d in {4, 8, 12} against k in
      {3, 5, 8} at m = 7 and 4097 and k = 5 at d = 5, each launching the
      variant its plan names) within
      rtol 1e-5 and atol 1e-4 * (||a||^2 + ||b||^2); ``kmeans_assign``,
      at the same shapes but the kNN, fusion, LSH and small-d ones, at
      minibatch Lloyd's (65 536, 64) x (8, 64), and at m = 255, 256 and
      257 (both sides of its small-m threshold), labels
      equal on every row whose two nearest distances differ by more than
      1e-5 relative (the count of rows left out is printed), sums within
      rtol 1e-5 / atol 1e-4 and counts equal where the labels are; at
      every shape each call launches the variant the wrapper's plan
      names (``stream`` / ``tiled`` for pairwise_sqdist, ``small`` /
      ``stream`` for kmeans_assign), and a single route launches one
      ``small`` kernel and nothing else;
    * ``group_ball_proj_batched`` at (1, 131 072, 32), (10, 131 072, 32)
      and (1, 8 386 560, 32), each with a radius per slot and with one
      per rung broadcast over the edges, and ``group_ball_proj`` at
      (523 776, 32)
      with a scalar and a per-row radius, then ragged e in {1, 7, 1031},
      d in {1, 16, 32, 200}, b in {1, 3}, with zero rows, rows on the
      sphere and inert (r = 0) slots, within rtol 1e-6 / atol
      1e-7 * ||v||; e = 0 must not launch;
    * the AMA iteration's two passes at the same duals, on the edge sets
      that make them (the kNN graph at C = 16 384, k = 8, one rung and
      the ladder's ten; the complete graph at C = 4096): the fused step
      (``group_ball_proj_batched`` given the step's operands, in place)
      bit for bit against the plain kernel fed PyTorch's gradient step,
      its ``moved`` against PyTorch's max |new - nu|, and against
      ``ama_step_ref`` on the card within the prox's tolerance above;
      ``ama_gather_back`` bit for bit against ``ama_gather_back_ref`` on
      the CPU; each launched twice, the repeat bit-identical;
    * ``flash_attention`` at the serving shape (4, 14, 8192, 64) x
      (4, 2, 8192, 64), bf16 (the tensor-core kernel), causal, window
      4096, on batch row 0 (the plain version's fp32 logits stay near
      3.8 GB), then 210 ragged cases: sq in {1, 7, 129, 1000}, skv - sq in
      {0, 1, 60}, sq > skv (rows without keys must be zero), head_dim in
      {8, 36, 64, 128, 256, 80, 192} (8 and 36 through the zero-padded
      copy in bf16), rep in {1, 2, 7}, window in {None, 5, 32}, both
      masks, fp32 (the CUDA-core kernel) and bf16, strided and
      contiguous; fp32 within rtol/atol 1e-4, bf16 within one bf16 ulp
      (2^-7 |want|) plus 1e-4 max|v|;
    * ``kmeans_assign`` at the route server's flush buckets, (n, 64) x
      (8, 64) for n = 1, 2, 4 ... 64: labels equal on every row, sums
      within the tolerance above, each n launching the variant its plan
      names;
    and every kernel's repeat run bit-identical; this slice adds
    ``kmeans_assign`` and ``pairwise_sqdist`` at one shard of the
    hierarchical round, (32 768, 64) x (8, 64) (its top level's (256, 64)
    x (8, 64) is the small-m threshold above), and at the Section 5
    federation's (100, 20) x (10, 20) and (100, 20) x (100, 20), each
    launching its planned variant, and ``group_ball_proj`` at its host
    AMA's (4950, 20); and ``flash_attention`` in bf16 at the model
    families' prefill shapes (``FAMILY_FLASH``: deepseek-moe-16b (4, 16,
    8192, 128) window 4096, hymba-1.5b (4, 25, 8192, 64) x (4, 5, 8192,
    64) window 1024, pixtral-12b (1, 32, 4096, 128) x (1, 8, 4096, 128)
    window 4096, the hubert-xlarge encoder (4, 16, 4096, 80)
    non-causal), batch row 0 against the plain version, twice;
 3. small rounds on the card against the same rounds on the CPU (the
    plain versions), with the same inputs: the ODCL-KM round (identical
    partitions and route labels, parameters within rtol 1e-5) and four
    ODCL-CC rounds (``convex-device`` on the complete graph at m = 256
    and on the kNN graph at m = 512, ``clusterpath-device`` on the LSH
    kNN graph at m = 2048, host ``convex_clustering`` at m = 256):
    identical partitions and route labels, u within
    atol 1e-5 * (1 + max|a|), the same AMA ``n_iter`` unless the last
    dual step lies within 1e-6 relative of the stop threshold (then
    both are printed); two card solves give bit-identical u;
 3d. this slice's paths, card vs CPU, at m = 4096 (clients around 8
    optima, sketch 32): ``kmeans-device`` with ``init="spectral"``;
    minibatch Lloyd (``batch_m`` 512) from the same carried rows; the
    ``trimmed_mean``, ``median`` and ``geometric_median`` center updates
    (with the same parameter reduction); ``engine="host"`` with kmeans++
    (each device's own seeds: the same partition up to a renaming);
    partitions and route labels identical, parameters and centers within
    rtol 1e-5 / atol 1e-5 max|x|, the same Lloyd iterations; the damped
    gradient-clustering loop from the same seeds (identical labels) and
    ``gradient-device`` on the card (purity 1.0); a logistic wave: 8
    Newton steps on both devices from the same (x, y) within 1e-4 of
    max|theta|, and the same partition of the CPU's models on both;
 3e. this slice's paths, card vs CPU, at m = 4096: the scenarios' masks,
    drifted and Zipf labels and keyed bits identical; the DP rows, the
    noise attack's rows and the normal draws within rtol 1e-6; the
    partitions of drift, longtail, Byzantine sign-flip, spoof, DP at
    epsilon 64 and the hierarchical round at S = 4 the same up to a
    renaming (parameters within rtol 1e-5); the Section 5 methods table
    (ODCL-KM with 8 kmeans++ restarts, ODCL-CC, IFCA, the baselines and
    oracles) the same, models within rtol 1e-5;
 3c. the LM serving model, card vs CPU: qwen2-0.5b at full width cut to
    2 layers, fp32, the same weights on both; b = 1, a prompt of 4160
    (past the 4096 window), 8 greedy tokens (the card's, fed to both):
    prefill and decode logits and the KV caches within 1e-4 of their
    largest magnitude, tokens equal wherever the top-2 margin exceeds
    that (the positions left out are printed);
 3f. the LM federation, card vs CPU (the reference tests' tiny config:
    qwen2-0.5b cut to 1 layer, d 64, vocab 64, fp32; C = 4 clients planted
    in K = 2 clusters, batch 2): 4 local AdamW steps at seq 16 (direct
    attention) and at seq 80 with attn_chunk 16 (the chunked scan), losses
    within rtol 1e-5 and parameters within ``lm_close``'s bounds; the
    sketches through one projection within 1e-5 of their largest
    magnitude; the ODCL partition on the host and device engines on both
    devices, the planted one; IFCA over 2 rounds with the loss and the
    sketch assignment, labels identical; a checkpoint of the card's
    trained stack that restores bit for bit;
 4. the main path at full size: ``simulate`` of the ODCL-KM one-shot
    round over 1 048 576 ridge clients (dim 16, 64 samples each, JL
    sketch 64, k = 8, kmeans++ + Lloyd, cluster mean), 10 warm finalizes
    after the first, and 4096 never-seen clients routed one request at a
    time and as one batch; purity and route purity must be 1.0, the
    one-by-one routes must give the batch's labels;
 4b. the convex paths at full size (dim 16, 64 samples, sketch 32, 8
    clusters, 200 AMA iterations at most, 3 finalizes, 4096 never-seen
    clients routed): ``convex-device`` on the kNN graph (k = 8) at
    C = 16 384, on the complete graph at C = 4096 (8 386 560 edges), and
    ``clusterpath-device`` on the LSH kNN graph at C = 16 384; then host
    ``convex_clustering`` of 1024 sketches at the exact lambda of the
    recovery interval (17), its clusters routing 4096 new clients; each
    must give purity 1.0, route purity 1.0 and K' = 8;
    for every path of phases 4, 4b, 4c and 4d every kernel's launch
    count is set to 0 just before and read just after, and every kernel
    that the path runs must have launched;
 4c. the LM serving path at full size through ``serve.generate``:
    qwen2-0.5b (24 layers, bf16, random weights from seed 0), batch 4,
    prompt 8192, 64 greedy tokens, then a warm repeat: prefill ms (first
    and warm), decode ms per token p50/p99, tok/s and peak device memory;
    flash_attention must launch 24 times in the prefill, all 24 on the
    tensor-core kernel and none on the CUDA-core one (the library's own
    counts); the prefill logits must be finite; every decode step's
    logits (the 63 steps, fed the generated tokens) must equal one
    prefill over the prompt plus the generated tokens at its position
    within 2^-4 of that position's largest |logit| (bf16 rounding
    through 24 layers), and a decode from a cache whose layer-0 values
    are negated must fall outside it.  Then the same weights with a planted
    previous-token head (``models.planted``): the 4 x 64 greedy tokens
    must be the head's known continuation, one prefill over them must
    show a top-2 margin above that tolerance at every generated
    position and pick every generated token, and a decode from a cache
    whose layer-0 values are negated must pick other tokens;
 4d. serving: the route server (``serving.RouteServer``) over a
    sketch-only session of C = 1 048 576 and then of C = 4096 (sketch 64,
    k = 8, built by ``serving.loadgen.build_session``): closed loops of 4
    and 16 callers, per request and batched (max_batch 64, max_wait 0.5
    ms), 3 s each, then 16 batched callers under ingest (keyed waves of
    256 every 0.2 s) with one background warm refinalize; no error,
    timeout or flush error; the server's labels for 4096 probes equal one
    batch route; the round refinalized in the background equals a
    serialized replay on the card (labels identical, centers
    bit-identical); qps, route p50/p99 (and during the refinalize), flush
    sizes, ``refinalize_under_load_ms`` and staleness printed, the
    batched/direct criterion printed and not gated.  Then ``simulate``
    at C = 1 048 576 with keyed re-uploads of a quarter of the clients
    and 64 joiners a round, sliding window 3 and the drift-triggered
    warm refinalize (purity 1.0, the refinalize must fire), and a
    ``convex-device`` kNN session at C = 16 384 refinalized warm (the
    same partition in fewer AMA iterations than cold);
 4e. this slice's paths at full size: one ridge session of C = 1 048 576
    (dim 16, 64 samples, sketch 64, k = 8), built once, then one finalize
    each of ``SLICE7_PATHS``: spectral seeding; kmeans++ with ``batch_m``
    65 536; the trimmed mean (beta 0.1) from random seeds with 8
    restarts (BENCH_robustness.json's robust config; purity printed, see
    ``SLICE7_PATHS``) and from kmeans++; the median; the geometric
    median; ``gradient-device``; ``engine="host"`` with kmeans++: purity
    1.0 (where gated), K' = 8, finite models, its ms, and every kernel
    of the path launched (counts set to 0 just before, read just after).
    Beside them the SVD of the centered sketches (``torch.linalg.svd``
    and the port's QR route, their ms and the angle between their top-8
    subspaces), whether the card's spectral seed rows are the CPU's, and
    the card's spectral partition against the CPU's (the same, up to a
    renaming); then ``simulate --task logistic`` at C = 1 048 576 with 8
    restarts (K' = 8; purity printed: the logistic models of 64 samples
    overlap across clusters) and ``simulate --trace`` at C = 4096, whose
    JSONL trace must hold the ``session.ingest`` and ``session.finalize``
    spans with their fields;
 4f. this slice's paths at the main path's size (ridge clients,
    C = 1 048 576, sketch 64, dim 16, k = 8, kmeans++, waves of one
    shard): ``simulate --shards 32`` (purity 1.0, K' = 8, served mse
    < 1e-2, comm bytes {268 435 456, 66 560}, 32 level-0 finalizes and one
    level-1 finalize, the shards' Lloyd on the stream assign and the top
    level's on the small one; level-0, level-1 and finalize ms printed);
    the hierarchical session at S = 1 against the flat session on the
    same clients (labels and served models bit-equal); ``--scenario
    drift`` (purity 1.0 against the drifted labels; migrated count
    printed); ``longtail`` (the run's occupancy equals the scenario's
    numpy Zipf counts); ``byzantine`` sign-flip at f = 0.1 with the mean
    and the trimmed mean (honest_frac within 0.9 +- five binomial sigma;
    every attacker's upload exactly -theta; purity and mse printed);
    the spoof (the attackers' rows one shared vector, the others and the
    parameters untouched); ``dp`` at epsilon 64 (no clipped row beyond
    the clip, the noise's std within 1 % of sigma); and the hierarchy at
    S = 32 under dp, whose sketch rows must equal the flat session's;
    each run's launches by variant printed;
 4g. the paper's Section 5 comparison on the card:
    ``make_linear_regression_federation(seed=0)`` (m = 100, K = 10,
    n = 100, d = 20) through ODCL-KM (one kmeans++ seeding, and 8
    kmeans++ restarts), ODCL-CC (clusterpath), IFCA (near-optima init,
    200 rounds), global ERM, local ERM, oracle averaging and the cluster
    oracle: ODCL-KM with restarts recovers the true partition and its
    mse equals oracle averaging's within 1e-5 relative; the single
    seeding with keys 0..63 recovers it for at least 40 of them (0.84 a
    key in both packages on the CPU), each with the oracle's mse; each
    method's nmse, comm rounds, ms and launches printed;
 4j. the package surface: examples/quickstart.py's calls through
    ``from repro_torch.core import ...`` (n = 200: ODCL over kmeans++ and
    over clusterpath, oracle averaging, local-only, global ERM) on the
    card and on the CPU, every partition card == CPU (kmeans++ from the
    CPU call's seed rows on both: each device's generator draws its own)
    and nmse within 1e-4 relative; ODCL-clusterpath the true partition
    at the oracle's mse; one round through
    ``repro_torch.core.engine.AggregationSession`` card == CPU;
    pairwise_sqdist, kmeans_assign and group_ball_proj launched; its
    seconds printed;
 4k. the one-layer decode API (``models.attention.decode_attention``):
    qwen2-0.5b's attention at full width, bf16, batch 4, a ring of 4096;
    16 steps from a ring carried over at position 4090 card == CPU
    within 2^-6 of the largest magnitude; 64 steps from an empty ring
    against the windowed causal ``attention`` (the flash kernel) within
    2^-4 of each position's max |out|; every step under
    ``torch.cuda.set_sync_debug_mode("error")``; its seconds printed;
 4h. Algorithm 1 at LM scale through ``launch.train``: qwen2-0.5b at
    full width (24 layers, bf16 parameters, fp32 AdamW moments, random
    init from seed 0), 8 clients in 2 clusters, batch 4, seq 64, sketch
    128 (the reference driver's defaults), with the local steps cut from
    100 to 20 and the post steps from 20 to 2: run 1 ``--method odcl
    --engine device --algo kmeans++`` (every loss finite, the last local
    loss below the first, K' = 2, the comm bytes ``sketch_round_bytes``,
    kmeans_assign and pairwise_sqdist launched); then
    ``serve.route_from_checkpoint`` of the trained stack in memory (sketch
    64) routes client 0 to a cluster model, which must equal
    ``cluster_mean_tree`` of its members bit for bit, and a prefill of it
    (batch 4, prompt 64, 4 tokens) must launch the flash kernel once a
    layer; run 2 ``--method ifca --ifca-assign sketch --rounds 2
    --local-steps 2`` (losses finite, kmeans_assign launched).  Purity,
    local-step p50, tokens/s, round ms and peak memory (gated below the
    card's) printed.  The 8 GB zlib checkpoint of this stack is left to
    phase 3f and the CPU tests.  Each run's record for phase 7d (labels,
    every client's losses, the round's and the final models, and for run
    1 an ODCL round of ``engine="host"`` on its trained state) is written
    on the host, to files beside the script that the script removes;
 3g. the model families, card vs CPU (run after 3f): deepseek-moe-16b (8
    experts, top 6), grok-1-314b (top 2 of 4, no shared experts),
    xlstm-125m, hymba-1.5b, hubert-xlarge and pixtral-12b, each reduced
    to 2 layers, d 512, fp32, the same weights on both: ``forward``
    (logits, aux loss), ``train_loss`` and its gradients, and (causal)
    ``prefill_with_cache`` with 8 ``decode_step``s, within 1e-4 of the
    largest magnitude (losses rtol 1e-5), every router top-k margin on
    the CPU above 1e-4; the one-shot round of a planted 4-client MoE
    federation through one projection (the planted partition on both,
    means within rtol 1e-5), and the same federation through
    ``hierarchical_one_shot_aggregate(state, cfg, shards=2)`` with the
    projection of the router-invariant values alone (each shard session
    sketches only those leaves; the planted partition, card == CPU ==
    the flat round within rtol 1e-5; its seconds printed);
    ``launch.train`` of a MoE federation on the card (finite losses,
    K' = 2, kmeans_assign and pairwise_sqdist);
 4i. the model families at full width, bf16, random weights from seed 0,
    each freed before the next: deepseek-moe-16b (28 layers, 16.9 B
    parameters), hymba-1.5b and xlstm-125m through ``serve.generate`` at
    batch 4, prompt 8192, 32 greedy tokens, then a warm repeat: flash
    once an attention layer in the prefill, all on the tensor-core
    kernel (the xLSTM none); every decode step's logits against one
    teacher-forced prefill within 2^-4 of the position's max |logit| and
    a decode from negated layer-0 values outside it (``family_gate``:
    the MoE on batch row 0 with no-drop capacity and the serve path
    routed as the prefill routes, its own routing's swaps printed; the
    xLSTM on an fp32 copy within 1e-3, its bf16 errors printed); the
    MoE prefill's drop share a layer printed.  Then pixtral-12b's
    ``prefill_with_cache`` (batch 1, 4096 tokens, 256 patch embeddings at
    distinct positions) and hubert-xlarge's ``forward`` (batch 4, 4096
    frames, 15 % masked): flash once a layer, row 0's logits against
    ``attention=train_attention`` within 2^-4 of each position's max
    |logit|.  Prefill ms (first, warm), decode ms p50/p99, tok/s and
    peak memory printed;
 5. one JSON line ``{"kernels": [...]}``, its times taken right after
    the build, before phase 2 (where the profiler starts after no other
    phase), its counts added after phase 4g: per kernel its launches on
    the main paths (in all, by path, and by variant), its largest error
    against the plain version, and at each of its main shapes (the
    Lloyd, batch-route, single-route and minibatch shapes of
    kmeans_assign, a shard's and the top level's of the hierarchical
    round (with the launches of phase 4f's ``--shards 32``), and its
    flush buckets 1, 4, 8, 16 and 64 with the serving paths' flushes at each,
    from the server's ``serving.flush_size``, and beside bucket 1 the
    direct rows' per-request routes; the
    kmeans++ shape (also the host Lloyd's and gradient clustering's), a
    kNN tile and the spectral shape of pairwise_sqdist, the last with
    the launches of the phase-4e finalize that runs it, and the Section 5
    federation's two shapes with phase 4g's ODCL launches (and the
    restarts' kmeans_assign at the first), the LM federation's
    (8, 128) x (2, 128) of both kernels with phase 4h's launches; the
    three dual
    shapes of the batched group prox, ``torch.renorm`` beside the one
    with one radius a rung at L = 1; the AMA's fused step and gather-back
    at the same duals, ``ama_step_ref`` and ``ama_gather_back_ref`` their
    plain versions, ``index_add_`` (atomics) the gather-back's library
    call) the card's own time for one call
    (``ms``: the durations of the device work that 20 calls launched,
    traced by torch.profiler, over 20), the caller's time (``call_ms``:
    CUDA events around the same 20 calls, host dispatch included), the
    same for the plain version and for one PyTorch call where one
    computes the same function, and the least time the card could take
    (the bytes and operations of ``roofline/kernel_costs.py``: bytes at
    3.35 TB/s or fp32 operations at 67 TFLOP/s, ``HW_H100_FP32``;
    flash_attention's operations at the bf16 tensor cores' 989 TFLOP/s,
    ``HW_H100``, with the fp32 figure beside it); one call of
    kmeans_assign at each shape and of pairwise_sqdist at the kmeans++
    shape must be exactly one kernel (a trace that lost some of that kernel's records is taken
    again, at most 5 times in all: the profiler dropped 1 to 11 of 20 on
    some runs, with nothing else in the trace; a trace with no device work
    at all is taken again without the profiler's schedule, and where every
    one is empty the call is timed by CUDA events and its one launch read
    from the wrapper's counters); the flash row adds the CUDA-core (fp32) kernel's time at
    the same shape in fp32 (``ms_fp32_kernel``), both kernels' ptxas
    registers and spill bytes, and its design, and ``at_shapes`` the
    four family shapes of phase 2 with their ms, call_ms, plain ms (row
    0), SDPA's ms, bound and phase 4i's launches;
 5b. the runtime and the engine roofline: TF32 off (cuBLAS, cuDNN, the
    matmul precision) once the entry points have resolved the card;
    ``core.erm.sgd_erm`` (2000 steps, batch 32, radius 100) on the card
    and on the CPU from the same minibatch rows within 1e-5 of the
    largest magnitude, and on the card's own draws within 0.3 of the
    exact ridge solution (Appendix D); ``roofline.engine_kernel_report``
    for the Lloyd row (C = 1 048 576, s = 64, k = 8) and the convex kNN
    row (C = 16 384, s = 32), and ``roofline.program_rows_from_snapshot``
    over phase 4's main path: every row's flops and bytes fractions of
    ``HW_H100_FP32``'s peaks in (0, 1.05]; one ``{"roofline": {...}}``
    line with the card's name and power limit;
 6. the multi-device dry run (``repro_torch.launch.dryrun``), four
    processes started together, each owning its fake process group:
    (a) grok-1-314b ``train_4k`` at full width on the 16x16 mesh (256
    ranks, ``tp_fsdp``, remat ``full``, fake CUDA tensors): status OK and
    the argument bytes a rank holds equal to the local shard bytes the
    specs imply (``dryrun_spec_bytes``) and within ``ARG_ESTIMATE_TOL``
    of the hand estimate (``dryrun_estimate_bytes``: every parameter and
    its two fp32 moments over all ranks, the batch over the data dim);
    one ``{"dryrun": {...}}`` line
    with the peak, the trace seconds, the roofline row and the
    collectives by kind and mesh dim; (b) the reference integration
    test's two combos through the CLI: xlstm_125m ``long_500k`` OK on
    256 ranks of a 16x16 mesh with a peak under 1 GiB and a named
    bottleneck, hubert_xlarge ``decode_32k`` skipped as encoder-only;
    (c) the tie to the card: qwen2-0.5b's train step at batch 4 x 4096
    (remat ``full``), predicted on a 1x1 mesh and run for real: its
    ``FlopCounterMode`` count equal to the dry run's, and the predicted
    peak at least ``TIE_PEAK_MIN`` of ``torch.cuda.max_memory_allocated``;
    one ``{"dryrun_checks": {...}}`` line;
 7. the round's client axis on a mesh (``mesh=`` / ``client_axis=``,
    ``sharding/clients.py``), each run held to the same run without a
    mesh, made first in this process: (a) the main path at one rank of
    NCCL (``launch.mesh.client_mesh``), labels, centers and cluster
    models bit for bit, purity 1.0; (b) in ``MESH_RANKS`` = 4 spawned
    processes of one gloo group over CUDA tensors on the card (NCCL
    refuses two ranks on one GPU), the main path at C = 1 048 576
    (262 144 rows a rank: labels equal, centers within rtol 1e-6, mse <
    1e-2, every rank's kmeans_assign calls on its own 262 144 rows, none
    on 1 048 576, each a ``stream`` launch), the mutation run (its
    labels, the warm refinalize taken), ``--shards 32`` and the convex
    kNN round at C = 16 384 (the same partitions); (c) in the same
    processes the fused round on qwen2-0.5b at full width, C = 8 clients
    in two planted clusters (2 a rank, sketch 128): the labels, and
    every rank's client models within one bf16 ulp of the unmeshed
    cluster models (plus 2^-20 of the leaf's largest magnitude, the fp32
    sums' rounding), the all-reduce bytes and seconds a rank printed;
    7b's main run also serves on rank 0 (``simulate(qps_callers=16)``):
    no error or timeout, the server's labels for 1024 probes equal to one
    batch route, no other rank serving; (d) in the same processes phase
    4h's two runs through ``launch.train(mesh=)`` on qwen2-0.5b at full
    width and depth, C = 8 (2 clients a rank), each rank building only
    its own clients: run 1 (ODCL, device engine, 20 local and 2 post
    steps) and one ODCL round of ``engine="host"`` on its trained state,
    run 2 (IFCA, sketch assignment, 2 rounds of 2 steps), held to 4h's
    records (kept on the host, in files beside the script) bit for bit:
    labels, every client's loss at every step, the round's, the final
    and the host round's models (the CPU rehearsal's fp32 models, whose
    sums round by order, within ``lm_drift_tol`` after an average);
    every rank's kmeans_assign
    launched (and pairwise_sqdist in run 1); each rank's local-step p50
    beside 4h's, the round ms, the gathered and all-reduced bytes and
    the peak memory printed; (e) in the same processes phase 4d's
    ingest row on the meshed session (``loadgen.build_session(mesh=)``,
    C = 1 048 576, sketch 64, k = 8): ``loadgen.run_row`` through rank
    0's ``RouteServer`` (16 batched callers for 3 s, keyed waves of 256
    every 0.2 s, one background warm refinalize midway) while the other
    ranks' servers follow its log, then 4096 probes through a fresh
    server equal to one batch route; no error, timeout or flush error,
    waves ingested and the round warm; every rank at rank 0's clock with
    its served round (labels, centers bit for bit); each rank's round
    equal bit for bit to the serialized replay of rank 0's log on the
    mesh, and rank 0's labels to the unmeshed replay's; the same row at
    the one NCCL rank of (a) (the log on a gloo group beside it), held
    bit for bit to the unmeshed replay.  qps, ``refinalize_under_load_ms``,
    the route p99 during the refinalize, and each rank's log entries and
    bytes and ``mesh.broadcast`` ms printed.  Each subphase prints its
    backend, ranks, rows a rank and seconds with the card line; one
    ``{"client_mesh": {...}}`` line;
 8. the card's name and power limit again, then the last line
    ``{"ok": true, "device": {...}}``.

``--profile`` adds, after phase 5's line, traced runs under ``torch.profiler``:
a second run of the main path, one finalize of the convex path on the
complete graph at C = 4096, two serve calls (phase 4c's prompts, 1
token, then 16), one local step and one streamed sketch of phase 4h's
federation, and one second of phase 4d's 16-caller closed loop,
batched and per request, at each C: device time by kernel and the
device's busy share; and in phase 4i, each served family's two serve
calls (1 token, then 16) and pixtral's prefill and hubert's forward.

The port imports no JAX; neither does this script.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MAIN_M, MAIN_K, MAIN_D = 1_048_576, 8, 64
ROUTE_M = 4096
FINALIZES = 11                     # the first, then 10 warm repeats
# group prox: the AMA dual at C = 16 384 (kNN, k = 8), its 10-rung ladder,
# and the complete graph at C = 4096; the host AMA at m = 1024.  The last
# flag: one radius per rung, broadcast over the edges (uniform weights)
PROX_MAIN = [(1, 131_072, 32, False), (10, 131_072, 32, False),
             (1, 8_386_560, 32, True)]
# the AMA iteration's two passes at the same duals, on the edge sets that
# make them: (edge set, clients, rungs)
AMA_MAIN = [("knn", 16_384, 1), ("knn", 16_384, 10), ("complete", 4096, 1)]
HOST_M = 1024
PAIRWISE_CONVEX = [(1024, 16_384, 32), (4096, 4096, 32), (HOST_M, HOST_M, 32)]
HOST_E = HOST_M * (HOST_M - 1) // 2
CONVEX_FINALIZES = 3
# the LM serving path: qwen2-0.5b at full width, bf16, batch 4, a prompt
# of 8192 (twice the serve window of 4096) and 64 greedy tokens
SERVE_ARCH = "qwen2-0.5b"
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 8192, 64
# the card-vs-CPU check: the same width cut to 2 layers, fp32, b = 1, a
# prompt just past the window, 8 greedy tokens
SMALL_LAYERS, SMALL_PROMPT, SMALL_GEN = 2, 4160, 8
# fp32 logits and caches, card vs CPU: within 1e-4 of the largest
# magnitude (the CPU parity bound against the reference)
FP32_REL_TOL = 1e-4
# bf16 decode vs prefill at full size: the two paths round the new
# token's projections (a 4-row vs a 32 772-row GEMM) and the attention
# output to bf16 at different points, and 24 layers carry each one-ulp
# (2^-8) difference forward
SERVE_BF16_REL_TOL = 2.0 ** -4
# the route server: flushes padded to powers of two up to max_batch 64
FLUSH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
SERVING_CLIENTS = (1_048_576, 4096)
SERVING_CALLERS = (4, 16)
SERVING_SECONDS = 3.0
SERVING_PROBES = 4096
# 4d's and 7e's route servers: flushes of up to 64, a 0.5 ms window
SERVER_KW = dict(max_batch=FLUSH_BUCKETS[-1], max_wait_ms=0.5)
# the mutation run of phase 4d (C = 1 048 576) and the convex warm path
MUTATION = {"reupload_frac": 0.25, "churn": 64, "max_age": 3,
            "refinalize_threshold": 1.5}
MUTATION_FINALIZES = 4
CONVEX_WARM_C = 16_384
# AMA budget of the convex warm path: enough for the cold solve to reach
# its stop test, which 200 iterations (phase 4b) do not
CONVEX_WARM_ITERS = 2000
# traces of a one-kernel call taken before its lost records fail the check
# (raised from 3 after a run lost one of 20 records on three in a row)
TRACES = 5
# the small-d shapes of pairwise_sqdist: spectral seeding's farthest-point
# traversal at (C, 8) x (8, 8), then d in {4, 8, 12} against k in {3, 5, 8}
# (the stream variant: d % 4 == 0) and k = 5 with d = 5 (tiled)
SPECTRAL_D = 8
PAIRWISE_SMALL_D = ([(MAIN_M, MAIN_K, SPECTRAL_D)]
                    + [(m, k, d) for d in (4, 8, 12) for k in (3, 5, 8)
                       for m in (7, 4097)] + [(4097, 5, 5)])
# minibatch Lloyd's rows an iteration at C = 1 048 576 (phase 4e)
BATCH_M = 65_536
# phase 3d: card vs CPU at m = 4096, minibatches of 512
SMALL_M, SMALL_BATCH = 4096, 512
# phase 4e: one finalize of each path over one session of C = 1 048 576,
# with the kernels it must launch and whether purity 1.0 is gated.  The
# trimmed mean's random init with 8 restarts is BENCH_robustness.json's
# "robust" config: 8 uniform rows hit all 8 clusters with probability
# 8!/8^8 = 0.24 %, and Lloyd does not undo a merge, so its purity is
# printed, not gated (1 of 10 generator seeds recovered the partition at
# C = 8192 on the CPU); the same update from kmeans++ seeds is gated.
SLICE7_PATHS = [
    ("spectral", {"algorithm": "kmeans-device",
                  "algo_options": {"init": "spectral", "iters": 50}},
     ("pairwise_sqdist", "kmeans_assign"), True),
    ("kmeans++ batch_m 65536", {
        "algorithm": "kmeans-device",
        "algo_options": {"init": "kmeans++", "iters": 50,
                         "batch_m": BATCH_M}},
     ("pairwise_sqdist", "kmeans_assign"), True),
    ("trimmed_mean random restarts 8", {
        "algorithm": "kmeans-device", "aggregator": "trimmed_mean",
        "algo_options": {"init": "random", "iters": 50, "restarts": 8,
                         "aggregator": "trimmed_mean"}},
     ("kmeans_assign",), False),
    ("trimmed_mean kmeans++", {
        "algorithm": "kmeans-device", "aggregator": "trimmed_mean",
        "algo_options": {"init": "kmeans++", "iters": 50,
                         "aggregator": "trimmed_mean"}},
     ("pairwise_sqdist", "kmeans_assign"), True),
    ("median", {"algorithm": "kmeans-device", "aggregator": "median",
                "algo_options": {"init": "kmeans++", "iters": 50,
                                 "aggregator": "median"}},
     ("pairwise_sqdist", "kmeans_assign"), True),
    ("geometric_median", {
        "algorithm": "kmeans-device", "aggregator": "geometric_median",
        "algo_options": {"init": "kmeans++", "iters": 50,
                         "aggregator": "geometric_median"}},
     ("pairwise_sqdist", "kmeans_assign"), True),
    ("gradient-device", {"algorithm": "gradient-device",
                         "algo_options": {"iters": 50}},
     ("pairwise_sqdist",), True),
    ("engine host kmeans++", {"algorithm": "kmeans++", "engine": "host",
                              "algo_options": {"iters": 50}},
     ("pairwise_sqdist",), True),
]
TRACE_C = 4096
# phase 4f: the two-level round at the main path's size, S = 32 shards of
# 32 768 clients each (the README's S = 32 row at C = 1 048 576), waves of
# one shard (a wave never straddles a shard edge, so the DP noise blocks,
# keyed by a wave's offset, are the flat session's); the top level
# clusters M = 32 x 8 = 256 shard centers, exactly kmeans_assign's small-m
# threshold
HIER_SHARDS = 32
SHARD_M = MAIN_M // HIER_SHARDS
TOP_M = HIER_SHARDS * MAIN_K
# the scenarios of phases 3e and 4f, each with its options
SCENARIO_DRIFT = {"drift_frac": 0.5}
SCENARIO_ZIPF = {"zipf_a": 1.2}
SCENARIO_BYZ = {"frac": 0.1}
SCENARIO_DP = {"epsilon": 64.0}
# phase 4g: the paper's Section 5 federation (m = 100 users, K = 10, n = 100
# samples, d = 20, Appendix E.1 optima); kmeans++ and the host Lloyd take
# (100, 20) x (<= 10, 20) distances, ODCL-CC's fusion (100, 20) x (100, 20),
# its host AMA E = 4950 edges of d = 20
PAPER_M, PAPER_K, PAPER_D = 100, 10, 20
PAPER_E = PAPER_M * (PAPER_M - 1) // 2
IFCA_ROUNDS = 200
# one kmeans++ seeding recovers the Section 5 partition for 0.84 of keys
# in both packages (tests/test_torch_methods.py, 500 keys on the CPU);
# phase 4g seeds it with keys 0..63 on the card and fails below 40
# recoveries, 4.8 binomial sigma under the 54 expected
SEEDING_KEYS, SEEDING_MIN = 64, 40


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20) -> float:
    """A caller's time for one call of ``fn()``: CUDA events around
    ``reps`` back-to-back calls, after two warm-up calls, divided by
    ``reps``.  Where a call's device work is shorter than its host
    dispatch this is the host's rate of issuing calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced_ops(fn, reps: int, scheduled: bool = True) -> list:
    """The device operations of ``reps`` calls of ``fn()`` as
    ``torch.profiler`` records them, after one warm-up step under the
    tracer (the step lets the tracer start before the measured calls);
    ``scheduled=False`` traces the calls alone, without a schedule, after
    a warm-up call outside the tracer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    if scheduled:
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    else:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_time(fn, reps: int = 20, kernel: str | None = None) -> dict:
    """The card's own time for one call of ``fn()``: the summed durations
    of the device work (kernels, copies, fills) that ``reps`` calls
    launched, traced by ``torch.profiler``, over ``reps``; ``call_ms``
    beside it (``cuda_time_ms``) and the device operations one call
    launches, by name.  With ``kernel``, a call is meant to launch that
    kernel alone: a trace holding that kernel and nothing else, but fewer
    than ``reps`` of its launches, lost records (the profiler has dropped
    1 to 11 of 20 on some runs) and is taken again, at most ``TRACES``
    times; ``traces`` says how many were taken.  A trace with no device
    work at all is taken again at once without the profiler's schedule,
    and the pair counts as one; the run fails if every one is empty."""
    call_ms = cuda_time_ms(fn, reps)
    ops = []
    for n in range(1, TRACES + 1):
        ops = (traced_ops(fn, reps)
               or traced_ops(fn, reps, scheduled=False))
        if not ops:
            continue
        per_call = {e.key[:80]: e.count / reps for e in ops}
        short = (kernel is not None and len(per_call) == 1
                 and kernel in next(iter(per_call))
                 and next(iter(per_call.values())) < 1.0)
        if not short:
            break
    check(ops, f"the profiler traced no device work in {TRACES} traces")
    return {"ms": sum(e.self_device_time_total for e in ops) / 1e3 / reps,
            "call_ms": call_ms, "device_ops_per_call": per_call,
            "traces": n}


def draw(seed: int, *shapes):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=gen, device="cuda") for s in shapes]


def read_counts(ops) -> dict:
    """Launches per wrapper since the last reset, and per variant as
    ``"<wrapper>.<variant>"`` for the wrappers that pick a kernel by
    shape."""
    return {**ops.launch_counts(),
            **{f"{name}.{variant}": n
               for name, by in ops.variant_counts().items()
               for variant, n in by.items()}}


# ------------------------------------------------------------ phase 2

def compare_pairwise(pairwise_l2, a, b) -> float:
    got = pairwise_l2.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = pairwise_l2.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale)
    check(float(excess.max()) <= 0.0,
          f"pairwise_sqdist disagrees at {tuple(a.shape)} x "
          f"{tuple(b.shape)}: excess {float(excess.max())}")
    again = pairwise_l2.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    check(torch.equal(again, got), "pairwise_sqdist is not repeatable")
    return float((got - want).abs().max())


def compare_assign(kmeans_assign, pairwise_l2, pts, cts) -> tuple:
    m, k = pts.shape[0], cts.shape[0]
    lab, sums, cnt = kmeans_assign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    wl, ws, wc = kmeans_assign.kmeans_assign_ref(pts, cts)
    if k > 1:
        two = torch.topk(pairwise_l2.pairwise_sqdist_ref(pts, cts), 2, dim=1,
                         largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs()
    else:
        clear = torch.ones(m, dtype=torch.bool, device=pts.device)
    excluded = int(m - int(clear.sum()))
    check(torch.equal(lab[clear], wl[clear]),
          f"kmeans_assign labels disagree at {tuple(pts.shape)} x "
          f"{tuple(cts.shape)}")
    if excluded:
        # counts and sums of the rows whose label is clear-cut
        ws = torch.nn.functional.one_hot(lab.long(), k).float().T @ pts
        wc = torch.bincount(lab.long(), minlength=k).float()
    check(torch.equal(cnt, wc), f"kmeans_assign counts disagree at "
          f"{tuple(pts.shape)} x {tuple(cts.shape)}")
    err = (sums - ws).abs()
    check(bool((err <= 1e-4 + 1e-5 * ws.abs()).all()),
          f"kmeans_assign sums disagree at {tuple(pts.shape)} x "
          f"{tuple(cts.shape)}: max err {float(err.max())}")
    again = kmeans_assign.kmeans_assign(pts, cts)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(again, (lab, sums, cnt))),
          "kmeans_assign is not bit-identical from run to run")
    return float(err.max()), excluded


def phase_kernels(pairwise_l2, kmeans_assign, ops) -> dict:
    # the main path's three shapes (Lloyd over all rows, a batch of
    # routes, one route), then ragged m in {1, 7, 4097}, k in {1, 8, 257},
    # d in {16, 64, 200}; then the convex paths' routes against the K'
    # centers in the sketch space of 32, a batch of 4096 and one
    shapes = [(MAIN_M, MAIN_K, MAIN_D), (ROUTE_M, MAIN_K, MAIN_D),
              (1, MAIN_K, MAIN_D), (1, 1, 16), (7, 257, 200), (4097, 8, 200), (4097, 1, 64),
              (7, 8, 16), (1, 257, 64), (4097, 257, 16), (4097, 257, 200),
              (ROUTE_M, 8, 32), (1, 8, 32),
              # minibatch Lloyd's batch (phase 4e)
              (BATCH_M, MAIN_K, MAIN_D),
              # both sides of kmeans_assign's small-m threshold (256 is
              # also the hierarchical top level's M, phase 4f)
              (kmeans_assign.SMALL_M, 8, 64), (kmeans_assign.SMALL_M + 1, 8, 64),
              (kmeans_assign.SMALL_M - 1, 8, 36),
              # one shard of the hierarchical round (phase 4f)
              (SHARD_M, MAIN_K, MAIN_D),
              # the Section 5 federation (phase 4g): kmeans++ and Lloyd
              # against 10 centers, ODCL-CC's fusion test against all 100
              (PAPER_M, PAPER_K, PAPER_D), (PAPER_M, PAPER_M, PAPER_D),
              # the LM federation (phase 4h): device Lloyd and IFCA's
              # sketch assign, kmeans++'s first center, the route's session
              # over the sketches of 64 and one route
              (LM_CLIENTS, LM_CLUSTERS, LM_FULL_SKETCH),
              (LM_CLIENTS, 1, LM_FULL_SKETCH),
              (LM_CLIENTS, LM_CLUSTERS, LM_ROUTE_SKETCH),
              (1, LM_CLUSTERS, LM_ROUTE_SKETCH)]
    errs = {}
    for i, (m, k, d) in enumerate(shapes):
        a, b = draw(100 + i, (m, d), (k, d))
        # points near the centers, as in Lloyd: clusters of (k, d) blobs
        pts = b[torch.arange(m, device="cuda") % k] + 0.5 * a
        ops.reset_launch_counts()
        pe = compare_pairwise(pairwise_l2, a, b)
        ae, excluded = compare_assign(kmeans_assign, pairwise_l2, pts, b)
        pv = pairwise_l2.pairwise_plan(m, k, d)[0]
        av = kmeans_assign.assign_plan(m, k, d).variant
        # two launches each (the comparison and its repeat), all of the
        # variant the plan names
        check({name: by for name, by in ops.variant_counts().items()
               if name in ("pairwise_sqdist", "kmeans_assign")} == {
            "pairwise_sqdist": {**dict.fromkeys(("stream", "tiled", "batched"), 0),
                                pv: 2},
            "kmeans_assign": {**dict.fromkeys(("small", "stream"), 0), av: 2}},
              f"kernels at ({m},{d})x({k},{d}) launched {ops.variant_counts()}, "
              f"not 2 x pairwise {pv} and 2 x assign {av}")
        print(f"[chip_smoke] kernels at ({m},{d})x({k},{d}): pairwise ({pv}) "
              f"max abs err {pe:.3g}, assign ({av}) sums max abs err {ae:.3g}, "
              f"{excluded} near-tie rows left out of the label check",
              flush=True)
        if (m, k, d) == (MAIN_M, MAIN_K, MAIN_D):
            errs = {"pairwise_sqdist": pe, "kmeans_assign": ae}
    # a single route is one launch of the small variant and nothing else
    pts, cts = draw(140, (1, MAIN_D), (MAIN_K, MAIN_D))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    kmeans_assign.kmeans_assign(pts, cts)
    check(read_counts(ops) == {**dict.fromkeys(ops.WRAPPERS, 0),
                               "kmeans_assign": 1,
                               "pairwise_sqdist.stream": 0,
                               "pairwise_sqdist.tiled": 0,
                               "pairwise_sqdist.batched": 0,
                               "kmeans_assign.small": 1,
                               "kmeans_assign.stream": 0,
                               "group_ball_proj_batched.plain": 0,
                               "group_ball_proj_batched.ama_step": 0},
          f"a single route launched {read_counts(ops)}")
    # pairwise_sqdist alone at the convex paths' other shapes: the kNN
    # tiles at C = 16 384, the complete graph's fusion at C = 4096 and the
    # host solver's fusion at m = 1024
    for i, (m, k, d) in enumerate(PAIRWISE_CONVEX):
        a, b = draw(150 + i, (m, d), (k, d))
        pe = compare_pairwise(pairwise_l2, a, b)
        print(f"[chip_smoke] pairwise_sqdist at ({m},{d})x({k},{d}): max abs "
              f"err {pe:.3g}", flush=True)
    # small feature dims: the TMA box is 32 columns wide, so a row of d = 8
    # fills a quarter of its 128-byte line and the rest is zero filled
    for i, (m, k, d) in enumerate(PAIRWISE_SMALL_D):
        a, b = draw(170 + i, (m, d), (k, d))
        ops.reset_launch_counts()
        pe = compare_pairwise(pairwise_l2, a, b)
        pv = pairwise_l2.pairwise_plan(m, k, d)[0]
        check(pv == ("stream" if d % 4 == 0 else "tiled"),
              f"pairwise_sqdist at ({m},{d})x({k},{d}) plans {pv}")
        check(ops.variant_counts()["pairwise_sqdist"] ==
              {**dict.fromkeys(("stream", "tiled", "batched"), 0), pv: 2},
              f"pairwise_sqdist at ({m},{d})x({k},{d}) launched "
              f"{ops.variant_counts()['pairwise_sqdist']}, not 2 x {pv}")
        print(f"[chip_smoke] pairwise_sqdist ({pv}) at ({m},{d})x({k},{d}): "
              f"max abs err {pe:.3g}", flush=True)
    return errs


def phase_flush_buckets(pairwise_l2, kmeans_assign, ops) -> float:
    """``kmeans_assign`` at the route server's flush buckets, (n, 64) x
    (8, 64) for n = 1, 2, 4 ... 64: labels equal on every row, sums
    within the phase's tolerance, two launches each of the variant its
    plan names."""
    worst = 0.0
    for i, n in enumerate(FLUSH_BUCKETS):
        a, b = draw(160 + i, (n, MAIN_D), (MAIN_K, MAIN_D))
        pts = b[torch.arange(n, device="cuda") % MAIN_K] + 0.5 * a
        ops.reset_launch_counts()
        err, excluded = compare_assign(kmeans_assign, pairwise_l2, pts, b)
        check(excluded == 0, f"flush bucket {n}: {excluded} near-tie rows; "
              "the labels are not compared on every row")
        variant = kmeans_assign.assign_plan(n, MAIN_K, MAIN_D).variant
        check(ops.variant_counts()["kmeans_assign"] ==
              {**dict.fromkeys(("small", "stream"), 0), variant: 2},
              f"flush bucket {n} launched "
              f"{ops.variant_counts()['kmeans_assign']}, not 2 x {variant}")
        worst = max(worst, err)
    print(f"[chip_smoke] kmeans_assign at the flush buckets "
          f"{FLUSH_BUCKETS} x ({MAIN_K},{MAIN_D}): labels equal on every "
          f"row, sums max abs err {worst:.3g}", flush=True)
    return worst


def prox_rows(seed: int, b: int, e: int, d: int):
    """Rows of v and radii that put some rows inside the ball and some
    outside, some exactly on its sphere, zero rows and inert (r = 0)
    slots."""
    v, r = draw(seed, (b, e, d), (b, e))
    norms = torch.sqrt((v * v).sum(-1))
    r = r.abs() * norms
    r[:, ::5] = norms[:, ::5]
    r[:, 1::7] = 0.0
    v[:, 2::11] = 0.0
    return v, r


def compare_prox(fn, plain, v, r) -> float:
    got = fn(v, r)
    torch.cuda.synchronize()
    want = plain(v, r)
    err = (got - want).abs()
    tol = 1e-6 * want.abs() + 1e-7 * torch.sqrt((v * v).sum(-1, keepdim=True))
    check(bool((err <= tol).all()),
          f"{fn.__name__} disagrees at {tuple(v.shape)}: max err "
          f"{float(err.max())}")
    again = fn(v, r)
    torch.cuda.synchronize()
    check(torch.equal(again, got), f"{fn.__name__} is not repeatable")
    return float(err.max())


def phase_prox_kernels(group_prox, pairwise_l2, ops) -> dict:
    """Phase 2 for the convex path's kernels: both group-prox kernels and
    the batched ``pairwise_sqdist``."""
    errs = {"group_ball_proj_batched": 0.0, "group_ball_proj": 0.0}
    for i, (b, e, d, _) in enumerate(PROX_MAIN):
        v, r = prox_rows(200 + i, b, e, d)
        # a radius per slot (the kNN graphs) and one per rung, broadcast
        # through strides (the complete graph)
        for name, radius in (("per-slot", r), ("per-rung", r[:, :1])):
            err = compare_prox(group_prox.group_ball_proj_batched,
                               group_prox.group_ball_proj_batched_ref, v,
                               radius)
            errs["group_ball_proj_batched"] = max(
                errs["group_ball_proj_batched"], err)
            print(f"[chip_smoke] group_ball_proj_batched at ({b},{e},{d}), "
                  f"{name} radius: max abs err {err:.3g}", flush=True)
        del v, r
    v, r = prox_rows(210, 1, HOST_E, 32)
    for name, radius in (("scalar", 0.75), ("per-row", r[0])):
        err = compare_prox(group_prox.group_ball_proj,
                           group_prox.group_ball_proj_ref, v[0], radius)
        errs["group_ball_proj"] = max(errs["group_ball_proj"], err)
        print(f"[chip_smoke] group_ball_proj at ({HOST_E},32), {name} "
              f"radius: max abs err {err:.3g}", flush=True)
    # the host AMA of the Section 5 federation (phase 4g)
    v, r = prox_rows(212, 1, PAPER_E, PAPER_D)
    err = compare_prox(group_prox.group_ball_proj,
                       group_prox.group_ball_proj_ref, v[0], 0.75)
    errs["group_ball_proj"] = max(errs["group_ball_proj"], err)
    print(f"[chip_smoke] group_ball_proj at ({PAPER_E},{PAPER_D}), scalar "
          f"radius: max abs err {err:.3g}", flush=True)
    for b in (1, 3):
        for e in (1, 7, 1031):
            for d in (1, 16, 32, 200):
                v, r = prox_rows(b * 10000 + e * 10 + d, b, e, d)
                compare_prox(group_prox.group_ball_proj_batched,
                             group_prox.group_ball_proj_batched_ref, v, r)
                for radius in (r[0], 0.75):
                    compare_prox(group_prox.group_ball_proj,
                                 group_prox.group_ball_proj_ref, v[0], radius)
    ops.reset_launch_counts()
    empty = group_prox.group_ball_proj_batched(
        torch.zeros((3, 0, 32), device="cuda"),
        torch.zeros((3, 0), device="cuda"))
    check(empty.shape == (3, 0, 32) and
          ops.launch_counts()["group_ball_proj_batched"] == 0,
          "group_ball_proj_batched launched at e = 0")
    print("[chip_smoke] group prox: ragged shapes, zero rows, rows on the "
          "sphere, inert slots and e = 0 agree", flush=True)
    a, b = draw(220, (256, 64, 32), (256, 192, 32))
    got = pairwise_l2.pairwise_sqdist(a, b)
    torch.cuda.synchronize()
    want = pairwise_l2.pairwise_sqdist_ref(a, b)
    scale = (a * a).sum(2)[:, :, None] + (b * b).sum(2)[:, None, :]
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-4 * scale)
    check(float(excess.max()) <= 0.0,
          f"batched pairwise_sqdist disagrees: excess {float(excess.max())}")
    check(torch.equal(pairwise_l2.pairwise_sqdist(a, b), got),
          "batched pairwise_sqdist is not repeatable")
    print(f"[chip_smoke] batched pairwise_sqdist at (256,64,32)x(256,192,32):"
          f" max abs err {float((got - want).abs().max()):.3g}", flush=True)
    return errs


def ama_operands(kind: str, m: int, L: int, seed: int) -> dict:
    """One AMA iteration's operands on the card, as ``_ama_fixed_point``
    makes them, at ``m`` clients of sketch 32 on the edge set ``kind``
    (k = 8): the dual nu (L, E, 32), eta, both segment plans, the int32
    edge ends, u gathered back, and the radius (the edges' weights times
    one lambda a rung, the complete graph's broadcast over the edges).
    The lambdas put the radius at 0.8 to 1.25 times the median norm of
    the stepped rows, so some rows are projected and some are not."""
    from repro_torch.core.engine.edges import get_edge_set
    from repro_torch.core.engine.segment import segment_plan
    from repro_torch.kernels import group_prox

    (a,) = draw(seed, (m, 32))
    edges = get_edge_set(kind)(a, knn_k=8)
    (nu,) = draw(seed + 1, (L, edges.n_edges, 32))
    nu *= 0.01
    o = {"a": a, "nu": nu,
         "eta": torch.as_tensor(1.0 / edges.inv_eta, dtype=torch.float32,
                                device="cuda"),
         "heads": segment_plan(edges.i_idx, m),
         "tails": segment_plan(edges.j_idx, m),
         "i_idx": edges.i_idx, "j_idx": edges.j_idx,
         "i32": edges.i_idx.to(torch.int32),
         "j32": edges.j_idx.to(torch.int32),
         "u": torch.empty((L, m, 32), device="cuda")}
    u = group_prox.ama_gather_back(a, nu, o["heads"], o["tails"], o["u"])
    v = nu - o["eta"] * (u[:, edges.i_idx] - u[:, edges.j_idx])
    med = torch.median(torch.sqrt((v * v).sum(-1)))
    del v
    w = edges.weights[:1] if edges.weights.stride(0) == 0 else edges.weights
    spread = (torch.linspace(0.8, 1.25, L, device="cuda") if L > 1
              else torch.ones(1, device="cuda"))
    o["radius"] = (med / torch.max(w) * spread)[:, None] * w[None, :]
    return o


def ama_step(group_prox, o: dict, nu: torch.Tensor,
             moved: torch.Tensor) -> torch.Tensor:
    """The fused step on ``nu``, in place."""
    return group_prox.group_ball_proj_batched(
        nu, o["radius"], u=o["u"], i_idx=o["i32"], j_idx=o["j32"],
        eta=o["eta"], moved=moved)


def phase_ama_kernels(group_prox, ops) -> dict:
    """Phase 2 for the AMA iteration's two passes (``AMA_MAIN``)."""
    from repro_torch.core.engine.segment import segment_plan

    errs = {"group_ball_proj_batched.ama_step": 0.0, "ama_gather_back": 0.0}
    for i, (kind, m, L) in enumerate(AMA_MAIN):
        ops.reset_launch_counts()
        o = ama_operands(kind, m, L, 240 + i)
        nu, u, e = o["nu"], o["u"], o["nu"].shape[1]
        at = f"{kind} C={m} ({L},{e},32)"
        # the gather-back: repeatable, and the CPU's segment sums bit for
        # bit (segment_reduce adds a run in order)
        again = torch.empty_like(u)
        group_prox.ama_gather_back(o["a"], nu, o["heads"], o["tails"], again)
        cpu = group_prox.ama_gather_back_ref(
            o["a"].cpu(), nu.cpu(), segment_plan(o["i_idx"].cpu(), m),
            segment_plan(o["j_idx"].cpu(), m), torch.empty(u.shape))
        check(torch.equal(again, u), f"ama_gather_back at {at} is not "
              "repeatable")
        check(torch.equal(u.cpu(), cpu), f"ama_gather_back at {at} differs "
              f"from the CPU's segment sums by "
              f"{float((u.cpu() - cpu).abs().max())}")
        del again, cpu
        # the fused step, in place, twice from the same dual
        v = nu - o["eta"] * (u[:, o["i_idx"]] - u[:, o["j_idx"]])
        want = group_prox.group_ball_proj_batched(v, o["radius"])
        v_norm = torch.sqrt((v * v).sum(-1, keepdim=True))
        del v
        want_moved = torch.max(torch.abs(want - nu))
        got, twice = nu.clone(), nu.clone()
        moved, moved2 = (torch.full((), -1.0, device="cuda")
                         for _ in range(2))
        ama_step(group_prox, o, got, moved)
        ama_step(group_prox, o, twice, moved2)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(moved, want_moved),
              f"the fused AMA step at {at} is not the plain prox of the "
              f"gradient step: max err {float((got - want).abs().max())}, "
              f"moved {float(moved)} against {float(want_moved)}")
        check(torch.equal(twice, got) and torch.equal(moved2, moved),
              f"the fused AMA step at {at} is not repeatable")
        del want, twice
        # and the plain version, PyTorch's prox, within its tolerance
        plain = group_prox.ama_step_ref(nu.clone(), o["radius"], u=u,
                                        i_idx=o["i_idx"], j_idx=o["j_idx"],
                                        eta=o["eta"], moved=moved2)
        err = (got - plain).abs()
        check(bool((err <= 1e-6 * plain.abs() + 1e-7 * v_norm).all()),
              f"the fused AMA step at {at} disagrees with ama_step_ref: max "
              f"err {float(err.max())}")
        errs["group_ball_proj_batched.ama_step"] = max(
            errs["group_ball_proj_batched.ama_step"], float(err.max()))
        # u and its repeat; the fused step and its repeat
        check(ops.variant_counts()["group_ball_proj_batched"]["ama_step"] == 2
              and ops.launch_counts()["ama_gather_back"] == 2,
              f"the AMA passes at {at} launched {read_counts(ops)}")
        print(f"[chip_smoke] AMA passes at {at}: the gather-back equals the "
              f"CPU's bit for bit, the fused step the plain prox of the "
              f"gradient step (ama_step_ref within {float(err.max()):.3g}); "
              "repeats bit-identical", flush=True)
        del o, nu, u, got, plain, v_norm, err
        torch.cuda.empty_cache()
    return errs


# ------------------------------------------------------------ phase 3

def phase_small_round() -> None:
    from repro_torch.core.engine.session import AggregationSession

    rng = np.random.default_rng(1)
    optima = rng.normal(size=(4, 16)) * 4.0
    truth = np.arange(512) % 4
    thetas = (optima[truth] + 0.5 * rng.normal(size=(512, 16))).astype(
        np.float32)
    probes = (optima[truth[:64]] + 0.5 * rng.normal(size=(64, 16))).astype(
        np.float32)
    proj = rng.normal(size=(16, 32)).astype(np.float32) / np.sqrt(32.0)
    init = thetas[:4] @ proj                 # one client of each cluster
    out = {}
    for dev in ("cpu", "cuda"):
        sess = AggregationSession(512, sketch_dim=32,
                                  projection=torch.from_numpy(proj),
                                  device=dev)
        for lo, hi in [(0, 200), (200, 333), (333, 512)]:
            sess.ingest({"theta": torch.from_numpy(thetas[lo:hi])})
        state, labels, info = sess.finalize(
            k=4, algo_options={"init": "warm",
                               "init_centers": torch.from_numpy(init)})
        routed = sess.route(sess.sketch_params(
            {"theta": torch.from_numpy(probes)}))
        out[dev] = (labels, state.params["theta"].cpu().numpy(), routed,
                    info["meta"]["n_iter"])
    (cl, cp, cr, cn), (gl, gp, gr, gn) = out["cpu"], out["cuda"]
    check(np.array_equal(cl, gl), "small round: partitions differ")
    check(np.array_equal(cr, gr), "small round: route labels differ")
    check(cn == gn, "small round: Lloyd iteration counts differ")
    check(np.allclose(gp, cp, rtol=1e-5, atol=1e-5) and np.isfinite(gp).all(),
          "small round: averaged parameters differ")
    print(f"[chip_smoke] small round: card == CPU (partition, {len(gr)} "
          f"route labels, n_iter {gn})", flush=True)


def clustered_thetas(seed: int, m: int, k: int, n_probes: int = 64):
    rng = np.random.default_rng(seed)
    optima = rng.normal(size=(k, 16)) * 20.0
    truth = np.arange(m) % k
    thetas = (optima[truth] + 0.3 * rng.normal(size=(m, 16))).astype(
        np.float32)
    probes = (optima[truth[:n_probes]]
              + 0.3 * rng.normal(size=(n_probes, 16))).astype(np.float32)
    proj = rng.normal(size=(16, 32)).astype(np.float32) / np.sqrt(32.0)
    return thetas, truth, probes, proj


def check_u(name, cpu, gpu, a_max) -> None:
    """u within atol 1e-5 * (1 + max|a|); n_iter equal unless the last dual
    step lies within 1e-6 relative of the stop threshold."""
    err = float(np.abs(cpu.u.cpu().numpy() - gpu.u.cpu().numpy()).max())
    check(err <= 1e-5 * (1.0 + a_max),
          f"{name}: u differs by {err} (atol {1e-5 * (1.0 + a_max)})")
    n_cpu, n_gpu = getattr(cpu, "n_iter", None), getattr(gpu, "n_iter", None)
    if n_cpu != n_gpu:
        near = [abs(r.moved - r.thresh) <= 1e-6 * r.thresh for r in (cpu, gpu)]
        print(f"[chip_smoke] {name}: n_iter {n_cpu} (CPU) vs {n_gpu} (card);"
              f" last moved {cpu.moved!r} / {gpu.moved!r}, thresh "
              f"{cpu.thresh!r} / {gpu.thresh!r}", flush=True)
        check(any(near), f"{name}: AMA iteration counts differ away from "
              "the stop threshold")


def phase_convex_rounds() -> None:
    from repro_torch.core.clustering.convex import (
        convex_clustering, lambda_interval)
    from repro_torch.core.engine.device_convex import (
        device_clusterpath, device_convex_cluster)
    from repro_torch.core.engine.session import AggregationSession

    cases = [("convex-device complete", 256, "convex-device",
              device_convex_cluster, {"iters": 200, "edges": "complete"}),
             ("convex-device knn", 512, "convex-device",
              device_convex_cluster, {"iters": 200, "edges": "knn",
                                      "knn_k": 8}),
             ("clusterpath-device knn-approx", 2048, "clusterpath-device",
              device_clusterpath, {"iters": 200, "edges": "knn-approx",
                                   "knn_k": 8})]
    for name, m, algorithm, solve, options in cases:
        thetas, truth, probes, proj = clustered_thetas(m, m, 8)
        options = dict(options)
        if algorithm == "convex-device":
            lo, hi = lambda_interval(thetas, truth)
            options["lam"] = 0.5 * (lo + hi) if lo < hi else lo
        out = {}
        for dev in ("cpu", "cuda"):
            sess = AggregationSession(m, sketch_dim=32,
                                      projection=torch.from_numpy(proj),
                                      device=dev)
            sess.ingest({"theta": torch.from_numpy(thetas)})
            _, labels, info = sess.finalize(algorithm=algorithm,
                                            algo_options=options)
            routed = sess.route(sess.sketch_params(
                {"theta": torch.from_numpy(probes)}))
            out[dev] = (labels, routed, info,
                        solve(None, sess.sketches, **options), sess.sketches)
        (cl, cr, ci, cres, ska), (gl, gr, _, gres, _) = (out["cpu"],
                                                          out["cuda"])
        check(np.array_equal(cl, gl), f"{name}: partitions differ")
        check(np.array_equal(cr, gr), f"{name}: route labels differ")
        check(ci["meta"]["n_iter"] == cres.n_iter, f"{name}: the session "
              "and the direct solve ran different iteration counts")
        check_u(name, cres, gres, float(ska.abs().max()))
        print(f"[chip_smoke] {name} at m={m}: card == CPU (partition of "
              f"{ci['n_clusters']} clusters, {len(gr)} route labels, n_iter "
              f"{gres.n_iter})", flush=True)
        if name == "convex-device knn":
            again = solve(None, sess.sketches, **options)
            check(torch.equal(again.u, gres.u),
                  "two card solves give different u")
            print("[chip_smoke] two card solves give bit-identical u",
                  flush=True)
    thetas, truth, _, proj = clustered_thetas(256, 256, 8)
    sk = thetas @ proj
    lo, hi = lambda_interval(sk, truth)
    lam = 0.5 * (lo + hi) if lo < hi else lo
    res = {dev: convex_clustering(torch.from_numpy(sk).to(dev), lam,
                                  iters=300) for dev in ("cpu", "cuda")}
    check(np.array_equal(res["cpu"].labels, res["cuda"].labels),
          "host convex_clustering: partitions differ")
    check_u("host convex_clustering", res["cpu"], res["cuda"],
            float(np.abs(sk).max()))
    print(f"[chip_smoke] host convex_clustering at m=256: card == CPU "
          f"({res['cuda'].n_clusters} clusters)", flush=True)


# ------------------------------------------------------------ phase 3d

def label_map(a, b):
    """The bijection of label ids that takes partition ``a`` to ``b``, or
    None where there is none (the two partitions differ)."""
    fwd, bwd = {}, {}
    for x, y in zip(np.asarray(a).tolist(), np.asarray(b).tolist()):
        if fwd.setdefault(x, y) != y or bwd.setdefault(y, x) != x:
            return None
    return fwd


def same_partition(a, b) -> bool:
    """Whether two label vectors are one partition up to a renaming."""
    return label_map(a, b) is not None


def renaming(a, b) -> dict:
    """``label_map(a, b)``; fails unless the two partitions are the same."""
    fwd = label_map(a, b)
    check(fwd is not None, "the card's partition differs from the CPU's")
    return fwd


def phase_slice7_rounds() -> None:
    """Phase 3d: small rounds of this slice's paths on the card against
    the same rounds on the CPU (the plain versions), the same inputs, at
    m = 4096.  Partitions and route labels identical (the kmeans++ seeds
    of the two generators differ, so for the host kmeans++ round up to a
    renaming of the cluster ids), parameters and centers within rtol 1e-5
    / atol 1e-5 max|x|, the same iteration counts."""
    from repro_torch.core.clustering.gradient import gradient_steps
    from repro_torch.core.clustering.kmeans import kmeans_plus_plus_init
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.core.erm import batched_logistic_erm
    from repro_torch.core.federated import cluster_agreement
    from repro_torch.core.sketch import make_generator
    from repro_torch.interop import rows_from_numpy

    thetas, truth, probes, proj = clustered_thetas(17, SMALL_M, 8)
    init = thetas[:8] @ proj                   # one client of each cluster
    rng = np.random.default_rng(17)
    rows = [rng.choice(SMALL_M, SMALL_BATCH, replace=False)
            for _ in range(50)]
    warm = {"init": "warm", "init_centers": torch.from_numpy(init),
            "iters": 50}
    cases = [("kmeans-device spectral", "kmeans-device",
              {"init": "spectral", "iters": 50}, "mean", "device"),
             (f"minibatch {SMALL_BATCH}", "kmeans-device",
              {**warm, "batch_m": SMALL_BATCH}, "mean", "device"),
             ("engine host kmeans++", "kmeans++", {"iters": 50}, "mean",
              "host")]
    cases += [(f"robust {agg}", "kmeans-device", {**warm, "aggregator": agg},
               agg, "device")
              for agg in ("trimmed_mean", "median", "geometric_median")]

    def session(dev, rows_in):
        sess = AggregationSession(rows_in.shape[0], sketch_dim=32,
                                  projection=torch.from_numpy(proj),
                                  device=dev)
        sess.ingest({"theta": torch.from_numpy(rows_in)})
        return sess

    for name, algorithm, options, agg, engine in cases:
        out = {}
        for dev in ("cpu", "cuda"):
            opts = dict(options)
            if "batch_m" in opts:
                opts["sampler"] = rows_from_numpy(*rows)
            sess = session(dev, thetas)
            state, labels, info = sess.finalize(
                algorithm=algorithm, k=8, algo_options=opts, engine=engine,
                aggregator=agg)
            routed = sess.route(sess.sketch_params(
                {"theta": torch.from_numpy(probes)}))
            out[dev] = (labels, routed, state.params["theta"].cpu().numpy(),
                        sess.route_centers.cpu().numpy(), info)
        (cl, cr, cp, cc, ci), (gl, gr, gp, gc, gi) = out["cpu"], out["cuda"]
        if algorithm == "kmeans++":
            ren = renaming(cl, gl)
            check([ren[x] for x in cr.tolist()] == gr.tolist(),
                  f"{name}: route labels differ")
            cc = cc[np.argsort([ren[x] for x in range(len(cc))])]
        else:
            check(np.array_equal(cl, gl), f"{name}: partitions differ")
            check(np.array_equal(cr, gr), f"{name}: route labels differ")
        check(algorithm == "kmeans++" or
              ci["meta"].get("n_iter") == gi["meta"].get("n_iter"),
              f"{name}: iteration counts differ")
        scale = float(np.abs(thetas).max())
        check(np.allclose(gp, cp, rtol=1e-5, atol=1e-5 * scale),
              f"{name}: averaged parameters differ")
        check(np.allclose(gc, cc, rtol=1e-5,
                          atol=1e-5 * float(np.abs(cc).max())),
              f"{name}: centers differ")
        check(cluster_agreement(gl, truth) == 1.0, f"{name}: purity below 1")
        print(f"[chip_smoke] 3d {name} at m={SMALL_M}: card == CPU "
              f"(engine {gi['engine']}, {gi['n_clusters']} clusters, "
              f"{len(gr)} route labels, n_iter {gi['meta'].get('n_iter')})",
              flush=True)

    # gradient clustering: the damped loop on both devices from the CPU's
    # kmeans++ seeds, then the registry's gradient-device on the card
    sk = torch.from_numpy(thetas @ proj)
    seeds = kmeans_plus_plus_init(make_generator(0, "cpu"), sk, 8)
    cpu = gradient_steps(sk, seeds, alpha=0.5, iters=100)
    gpu = gradient_steps(sk.cuda(), seeds.cuda(), alpha=0.5, iters=100)
    check(torch.equal(cpu.labels, gpu.labels.cpu()),
          "gradient clustering: partitions differ")
    check(torch.allclose(gpu.centers.cpu(), cpu.centers, rtol=1e-5,
                         atol=1e-5 * float(sk.abs().max())),
          "gradient clustering: centers differ")
    _, labels, info = session("cuda", thetas).finalize(
        algorithm="gradient-device", k=8, algo_options={"iters": 100})
    check(cluster_agreement(labels, truth) == 1.0 and
          info["n_clusters"] == 8, "gradient-device: purity below 1")
    print(f"[chip_smoke] 3d gradient clustering at m={SMALL_M}: card == CPU "
          "from the same seeds; gradient-device recovers the 8 clusters",
          flush=True)

    # a logistic wave: Newton on both devices from the same (x, y), then
    # one spectral round of the CPU's models on each
    rng = np.random.default_rng(18)
    optima = rng.choice([-1.0, 1.0], size=(8, 16)) * (
        np.arange(1, 9)[:, None] + rng.uniform(size=(8, 16)))
    x = rng.normal(size=(SMALL_M, 64, 16)).astype(np.float32)
    z = np.einsum("wnd,wd->wn", x, optima[truth])
    y = np.where(rng.uniform(size=z.shape) < 1.0 / (1.0 + np.exp(-z)), 1.0,
                 -1.0).astype(np.float32)
    th = {dev: batched_logistic_erm(torch.from_numpy(x).to(dev),
                                    torch.from_numpy(y).to(dev), 1e-6,
                                    8).cpu().numpy()
          for dev in ("cpu", "cuda")}
    err = float(np.abs(th["cuda"] - th["cpu"]).max())
    big = float(np.abs(th["cpu"]).max())
    check(np.isfinite(th["cuda"]).all() and err <= 1e-4 * big,
          f"logistic wave: thetas differ by {err} (atol {1e-4 * big})")
    lproj = rng.normal(size=(17, 32)).astype(np.float32) / np.sqrt(32.0)
    parts = {}
    for dev in ("cpu", "cuda"):
        sess = AggregationSession(SMALL_M, sketch_dim=32,
                                  projection=torch.from_numpy(lproj),
                                  device=dev)
        sess.ingest({"theta": torch.from_numpy(th["cpu"])})
        parts[dev] = sess.finalize(algorithm="kmeans-device", k=8,
                                   algo_options={"init": "spectral"})[1]
    check(np.array_equal(parts["cpu"], parts["cuda"]),
          "logistic wave: partitions differ")
    print(f"[chip_smoke] 3d logistic wave at m={SMALL_M}: Newton card vs "
          f"CPU max abs diff {err:.3g} (max|theta| {big:.3g}); partitions "
          "equal", flush=True)


# ------------------------------------------------------------ phase 3e

def scenario_thetas(seed: int, labels: np.ndarray, k: int = 8) -> np.ndarray:
    """Clients around k optima (as ``clustered_thetas``) under the given
    true labels (a scenario's drifted or Zipf occupancy)."""
    rng = np.random.default_rng(seed)
    optima = rng.normal(size=(k, 16)) * 20.0
    return (optima[labels] + 0.3 * rng.normal(size=(len(labels), 16))).astype(
        np.float32)


def scenario_key() -> int:
    """The scenario key ``simulate`` folds from seed 0."""
    from repro_torch.utils import prng

    return prng.fold_in(prng.key(0), 0x5ce0)


def scenarios() -> dict:
    from repro_torch.scenarios import (
        ByzantineScenario, DPScenario, DriftScenario, LongtailScenario)

    return {"drift": DriftScenario(**SCENARIO_DRIFT),
            "longtail": LongtailScenario(**SCENARIO_ZIPF),
            "byzantine": ByzantineScenario(**SCENARIO_BYZ),
            "noise": ByzantineScenario(**SCENARIO_BYZ, attack="noise"),
            "spoof": ByzantineScenario(**SCENARIO_BYZ, attack="spoof"),
            "dp": DPScenario(**SCENARIO_DP)}


def sketch_hook(scen, key):
    """The session's ``sketch_transform`` for a scenario (or ``None``)."""
    if scen is None or not scen.transforms_sketches:
        return None
    return lambda sk, off: scen.sketch_transform(key, sk, off)


def paper_federation_erm(device):
    """The Section 5 ridge solver (reg 1e-8) on ``device``."""
    from repro_torch.core.erm import batched_ridge_erm

    def erm(xs, ys):
        return batched_ridge_erm(torch.from_numpy(xs).to(device),
                                 torch.from_numpy(ys).to(device), 1e-8)

    return erm


def paper_methods(fed, device) -> list:
    """The paper's Section 5 cast over ``fed`` on ``device``, each as
    (name, method): ODCL-KM (kmeans++, one seeding; and kmeans++ seeding
    with 8 restarts kept by the lowest inertia), ODCL-CC (clusterpath, 8
    rungs of 200 AMA iterations, as examples/quickstart.py), IFCA (200
    gradient rounds from the optima plus N(0, 1) noise drawn on the CPU,
    so both devices start alike), global ERM, local ERM, oracle averaging
    and the cluster oracle."""
    from repro_torch.core.erm import ridge_erm
    from repro_torch.core.ifca import ifca_init_near_optima
    from repro_torch.core.methods import (
        IFCA, ODCL, ClusterOracle, GlobalERM, LocalOnly, OracleAveraging)
    from repro_torch.core.sketch import make_generator

    def sq_loss(t, x, y):
        r = x @ t - y
        return torch.mean(r * r)

    def solve(x, y):
        return ridge_erm(torch.from_numpy(x).to(device),
                         torch.from_numpy(y).to(device), 1e-8)

    theta0 = ifca_init_near_optima(make_generator(0, "cpu"), fed.optima, 1.0)
    return [
        ("odcl-kmeans++", ODCL("kmeans++", k=PAPER_K, device=device)),
        ("odcl-kmeans++ restarts 8", ODCL(
            "kmeans-device", k=PAPER_K, device=device,
            options={"init": "kmeans++", "restarts": 8})),
        ("odcl-clusterpath", ODCL("clusterpath", device=device,
                                  options={"n_lambdas": 8, "iters": 200})),
        ("ifca", IFCA(k=PAPER_K, loss_fn=sq_loss,
                      grad_fn=torch.func.grad(sq_loss), init=theta0,
                      rounds=IFCA_ROUNDS, device=device)),
        ("global-erm", GlobalERM()),
        ("local-only", LocalOnly()),
        ("oracle-averaging", OracleAveraging(true_labels=fed.true_labels)),
        ("cluster-oracle", ClusterOracle(solve_fn=solve,
                                         true_labels=fed.true_labels)),
    ]


def phase_slice8_rounds() -> None:
    """Phase 3e: this slice's paths, card against CPU, at m = 4096.  The
    scenarios' masks and labels bit for bit (the counter-based draws of
    ``utils/prng.py``); the DP rows, the noise attack's rows and the raw
    normal draws within rtol 1e-6 / atol 1e-6 of their largest magnitude;
    the partitions of drift, longtail, Byzantine sign-flip, spoof, DP at
    epsilon 64 (each from the CPU's kmeans++ seed rows) and of the
    hierarchical round at S = 4 (each device's own kmeans++) the same up
    to a renaming, models within rtol 1e-5 / atol 1e-5 max|theta|; the
    Section 5 methods table the same (labels identical, or up to a
    renaming where each device seeds kmeans++ itself; models within
    rtol 1e-5 / atol 1e-5 max|model|)."""
    from repro_torch.core.clustering.kmeans import kmeans_plus_plus_init
    from repro_torch.core.engine.hierarchy import HierarchicalSession
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.core.federated import cluster_agreement
    from repro_torch.core.sketch import make_generator
    from repro_torch.data import make_linear_regression_federation
    from repro_torch.utils import prng

    m, key, scen = SMALL_M, scenario_key(), scenarios()
    base = np.arange(m) % 8
    got = {}
    for dev in ("cpu", "cuda"):
        b = torch.from_numpy(base).to(dev)
        got[dev] = {
            "honest mask": scen["byzantine"].honest_mask(key, m, device=dev),
            "drift labels": scen["drift"].wave_labels(key, b, 0, m, 8),
            "longtail labels": scen["longtail"].population(key, m, 8,
                                                           device=dev),
            "keyed bits": prng.bits(key, torch.arange(m, device=dev))}
    for name, want in got["cpu"].items():
        check(torch.equal(got["cuda"][name].cpu(), want),
              f"3e {name}: the card's differ from the CPU's")
    thetas, truth, _, proj = clustered_thetas(19, m, 8)
    sk = torch.from_numpy(thetas @ proj)
    th = torch.from_numpy(thetas)
    rows = {dev: {"dp rows": scen["dp"].sketch_transform(key, sk.to(dev), 0),
                  "noise rows": scen["noise"].corrupt_uploads(
                      key, th.to(dev), None, 0, m),
                  "normal draws": prng.normal(key, (m, 64), device=dev)}
            for dev in ("cpu", "cuda")}
    errs = {}
    for name, want in rows["cpu"].items():
        scale = float(want.abs().max())
        err = float((rows["cuda"][name].cpu() - want).abs().max())
        check(torch.allclose(rows["cuda"][name].cpu(), want, rtol=1e-6,
                             atol=1e-6 * scale),
              f"3e {name}: the card's differ from the CPU's by {err}")
        errs[name] = err
    print(f"[chip_smoke] 3e scenarios at m={m}: masks, labels and keyed bits "
          f"card == CPU; max abs diffs {json.dumps(errs)}", flush=True)

    def session(dev, shards, hook):
        kw = dict(sketch_dim=32, projection=torch.from_numpy(proj),
                  sketch_transform=hook, device=dev)
        if shards > 1:
            return HierarchicalSession(m, shards=shards, **kw)
        return AggregationSession(m, **kw)

    drift = got["cpu"]["drift labels"].numpy()
    longtail = got["cpu"]["longtail labels"].numpy()
    cases = [("drift", scenario_thetas(20, drift), drift, None, 1),
             ("longtail", scenario_thetas(21, longtail), longtail, None, 1),
             ("byzantine sign_flip", thetas, truth, scen["byzantine"], 1),
             ("byzantine spoof", thetas, truth, scen["spoof"], 1),
             ("dp epsilon 64", thetas, truth, scen["dp"], 1),
             ("hierarchical S=4", thetas, truth, None, 4)]
    for name, pts, labels_true, sc, shards in cases:
        sess = {}
        for dev in ("cpu", "cuda"):
            sess[dev] = session(dev, shards, sketch_hook(sc, key))
            t = torch.from_numpy(pts).to(dev)
            for lo in range(0, m, 1024):
                w = t[lo:lo + 1024]
                if sc is not None:
                    w = sc.corrupt_uploads(key, w, None, lo, m)
                sess[dev].ingest({"theta": w})
        opts = {"init": "kmeans++", "iters": 50}
        if shards == 1:
            seeds = kmeans_plus_plus_init(make_generator(0, "cpu"),
                                          sess["cpu"].sketches, 8)
            opts = {"init": "warm", "init_centers": seeds, "iters": 50}
        out = {dev: sess[dev].finalize(k=8, algo_options=opts)
               for dev in ("cpu", "cuda")}
        (cs, cl, _), (gs, gl, gi) = out["cpu"], out["cuda"]
        renaming(cl, gl)
        cp = cs.params["theta"].cpu().numpy()
        gp = gs.params["theta"].cpu().numpy()
        check(np.allclose(gp, cp, rtol=1e-5,
                          atol=1e-5 * float(np.abs(cp).max())),
              f"3e {name}: averaged parameters differ")
        print(f"[chip_smoke] 3e {name} at m={m}: card == CPU up to a "
              f"renaming ({gi['n_clusters']} clusters, purity "
              f"{cluster_agreement(gl, labels_true):.4f})", flush=True)

    fed = make_linear_regression_federation(seed=0)
    table = {}
    for dev in ("cpu", "cuda"):
        erm = paper_federation_erm(dev)
        table[dev] = {name: method.fit(0, fed.xs, fed.ys, erm)
                      for name, method in paper_methods(fed, dev)}
    single = {}
    for name, want in table["cpu"].items():
        res = table["cuda"][name]
        if name == "odcl-kmeans++":
            # one kmeans++ seeding from each device's own generator: either
            # may land in a local optimum, so its recovery is printed
            single = {dev: bool(same_partition(table[dev][name].labels,
                                               fed.true_labels))
                      for dev in table}
            continue
        if name == "odcl-kmeans++ restarts 8":
            renaming(want.labels, res.labels)
        else:
            check(np.array_equal(res.labels, want.labels),
                  f"3e methods {name}: labels differ")
        scale = float(np.abs(want.user_models).max())
        check(np.allclose(res.user_models, want.user_models, rtol=1e-5,
                          atol=1e-5 * scale),
              f"3e methods {name}: models differ by "
              f"{float(np.abs(res.user_models - want.user_models).max())}")
    print(f"[chip_smoke] 3e methods table (Section 5, m={PAPER_M}): card == "
          f"CPU for {sorted(set(table['cpu']) - {'odcl-kmeans++'})}; one "
          f"kmeans++ seeding recovers the partition: {json.dumps(single)}",
          flush=True)


# --------------------------------------------------- --profile only

def phase_profile(fn, **run) -> dict:
    """A second, traced run of a path (``run``: ``fn``'s arguments, e.g.
    simulate's): device time by kernel and the device's busy share of the
    traced wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(**run)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    return {"run": run, "traced_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


# ----------------------------------------------------------- phase 4b

CONVEX_PATHS = [
    ("convex-device knn", {"clients": 16_384, "algorithm": "convex-device",
                           "edges": "knn"}),
    ("convex-device complete", {"clients": 4096, "algorithm": "convex-device",
                                "edges": "complete"}),
    ("clusterpath-device knn-approx", {"clients": 16_384,
                                       "algorithm": "clusterpath-device",
                                       "edges": "knn-approx"}),
]


def path_fields(summary: dict, launches: dict, card: str) -> dict:
    """The fields one path run prints (phase 4's ``main_path`` line and
    phase 4b's ``convex_path`` lines)."""
    sv = summary["serving"]
    return {
        "clients": summary["clients"], "clusters": summary["clusters"],
        "sketch_dim": summary["sketch_dim"], "purity": summary["purity"],
        "route_purity": sv["route_purity"],
        "route_single_purity": sv["route_single_purity"],
        "route_single_vs_batch": sv["route_single_vs_batch"],
        "mse": summary["mse"],
        "n_iter": summary["meta"]["n_iter"], "phases": summary["phases"],
        "finalize_first_ms": sv["finalize_first_ms"],
        "finalize_warm_count": sv["finalize_warm_count"],
        "finalize_p50_ms": sv["finalize_p50_ms"],
        "finalize_p99_ms": sv["finalize_p99_ms"],
        "route_p50_ms": sv["route_p50_ms"], "route_p99_ms": sv["route_p99_ms"],
        "routes_per_s": sv["routes_per_s"],
        "route_batch_ms": sv["route_batch_ms"],
        "batched_routes_per_s": sv["batched_routes_per_s"],
        "spans_p50_ms": {
            name[:-3]: h["p50"]
            for name, h in summary["obs"]["histograms"].items()
            if h.get("count")},
        "launches": launches, "device": summary["device_name"],
        "card": card}


def check_path(name: str, summary: dict, launches: dict, kernels) -> None:
    sv = summary["serving"]
    check(summary["purity"] == 1.0,
          f"{name}: purity {summary['purity']} != 1.0")
    check(sv["route_purity"] == 1.0,
          f"{name}: route purity {sv['route_purity']} != 1.0")
    check(sv["route_single_purity"] == 1.0,
          f"{name}: single-route purity {sv['route_single_purity']} != 1.0")
    check(sv["route_single_vs_batch"] == 1.0,
          f"{name}: routes one by one disagree with the batch on "
          f"{1.0 - sv['route_single_vs_batch']:.3g} of the clients")
    check(summary["n_clusters_recovered"] == 8,
          f"{name}: recovered {summary['n_clusters_recovered']} clusters, "
          "not 8")
    check(np.isfinite(summary["mse"]) and summary["mse"] < 1e-2,
          f"{name}: served models off their optima: mse {summary['mse']}")
    for kernel in kernels:
        check(launches[kernel] > 0, f"{name}: launched no {kernel} kernel")


def phase_convex_paths(simulate, ops, card: str) -> dict:
    """The convex paths at full size, each with the launch counts set to 0
    just before and read just after.  Returns the launches by path."""
    by_path = {}
    for name, kw in CONVEX_PATHS:
        ops.reset_launch_counts()
        summary = simulate(clusters=8, dim=16, samples=64, sketch_dim=32,
                           knn_k=8, cc_iters=200, route_probes=ROUTE_M,
                           finalize_repeats=CONVEX_FINALIZES, device="cuda",
                           **kw)
        launches = read_counts(ops)
        check_path(name, summary, launches, ("group_ball_proj_batched",
                                             "ama_gather_back",
                                             "pairwise_sqdist",
                                             "kmeans_assign"))
        counters = summary["obs"]["counters"]
        c = summary["clients"]
        print(json.dumps({"convex_path": {
            "name": name, "algorithm": summary["algorithm"],
            "edges": summary["edges"], "knn_k": summary["knn_k"],
            "lam": summary["lam"],
            "n_clusters": summary["n_clusters_recovered"],
            # per finalize: one read per AMA iteration, one per label
            # propagation step (every rung's, on the ladder)
            "ama_iterations_per_finalize":
                counters.get("convex.ama.iterations", 0) / CONVEX_FINALIZES,
            "propagation_steps_per_finalize":
                counters.get("convex.components.steps", 0) / CONVEX_FINALIZES,
            # the mean stage's one-hot over root-indexed centers is (C, C)
            "mean_onehot_bytes": 4 * c * c,
            **path_fields(summary, launches, card)}}), flush=True)
        by_path[name] = launches
    return by_path


def phase_host_convex(ops, card: str) -> dict:
    """Host ``convex_clustering`` (the unbatched kernel's path) over the
    sketches of 1024 ridge clients at the exact lambda of (17), then 4096
    never-seen clients routed to its clusters."""
    from repro_torch.core.clustering.convex import (
        convex_clustering, lambda_interval)
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.core.federated import cluster_agreement
    from repro_torch.core.sketch import make_generator
    from repro_torch.launch.simulate import staggered_optima, wave_ridge_erm

    gen = make_generator(0, torch.device("cuda"))
    optima = staggered_optima(gen, 8, 16)
    truth = torch.arange(HOST_M, device="cuda") % 8
    probe_truth = torch.arange(ROUTE_M, device="cuda") % 8
    thetas = wave_ridge_erm(gen, optima, truth, n=64)
    probes = wave_ridge_erm(gen, optima, probe_truth, n=64)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess = AggregationSession(HOST_M, sketch_dim=32, device="cuda")
    sess.ingest({"theta": thetas})
    lo, hi = lambda_interval(sess.sketches, truth.cpu().numpy())
    lam = 0.5 * (lo + hi) if lo < hi else lo
    t1 = time.perf_counter()
    res = convex_clustering(sess.sketches, lam, iters=300)
    t2 = time.perf_counter()
    centers = torch.from_numpy(res.centers).cuda()
    routed, _, _ = ops.kmeans_assign(sess.sketch_params({"theta": probes}),
                                     centers)
    routed = routed.cpu().numpy()
    t3 = time.perf_counter()
    launches = read_counts(ops)
    purity = cluster_agreement(res.labels, truth.cpu().numpy())
    route_purity = cluster_agreement(routed, probe_truth.cpu().numpy())
    check(purity == 1.0, f"host convex: purity {purity} != 1.0")
    check(route_purity == 1.0, f"host convex: route purity {route_purity}")
    check(res.n_clusters == 8, f"host convex: {res.n_clusters} clusters")
    for kernel in ("group_ball_proj", "pairwise_sqdist", "kmeans_assign"):
        check(launches[kernel] > 0, f"host convex: launched no {kernel}")
    print(json.dumps({"convex_path": {
        "name": "host convex_clustering", "clients": HOST_M, "clusters": 8,
        "sketch_dim": 32, "edges": "complete", "n_edges": HOST_E,
        "lam": lam, "iters": 300, "n_clusters": res.n_clusters,
        "purity": purity, "route_purity": route_purity,
        "phases": {"ingest_and_lambda_s": t1 - t0, "cluster_s": t2 - t1,
                   "route_batch_s": t3 - t2},
        "launches": launches, "device": torch.cuda.get_device_name(0),
        "card": card}}), flush=True)
    return launches


# ------------------------------------------------- phase 2 (flash)

def attn_inputs(seed: int, b: int, hkv: int, rep: int, sq: int, skv: int,
                dh: int, dtype, strided: bool = True):
    """q, k, v as the model hands them to the kernel: transposes of
    (b, s, h, dh) buffers (or contiguous (b, h, s, dh))."""
    h = hkv * rep
    q, k, v = draw(seed, (b, sq, h, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))
    if strided:
        return [t.to(dtype).transpose(1, 2) for t in (q, k, v)]
    return [t.transpose(1, 2).contiguous().to(dtype) for t in (q, k, v)]


def compare_flash(flash, q, k, v, causal, window, rows=None) -> float:
    """The kernel against its plain version (on batch rows ``rows`` only,
    to bound the plain version's logits), then bit-identical on repeat.
    fp32 within rtol/atol 1e-4 (the reference holds its Pallas kernel to
    its oracle so); bf16 within one bf16 ulp of the plain version's
    result (2^-7 |want|: both round an fp32 value whose two summation
    orders differ by ~1e-6) plus 1e-4 max|v|."""
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    sel = slice(None) if rows is None else slice(0, rows)
    want = flash.flash_attention_ref(q[sel], k[sel], v[sel], causal=causal,
                                     window=window)
    err = (got[sel].float() - want.float()).abs()
    if q.dtype == torch.float32:
        tol = 1e-4 + 1e-4 * want.abs()
    else:
        tol = 2.0 ** -7 * want.float().abs() + 1e-4 * float(v.abs().max())
    check(bool((err <= tol).all()),
          f"flash_attention disagrees at q {tuple(q.shape)} k "
          f"{tuple(k.shape)} {q.dtype} causal={causal} window={window}: "
          f"max err {float(err.max())}")
    sq, skv = q.shape[2], k.shape[2]
    if causal and sq > skv:
        check(bool((got[:, :, :sq - skv] == 0).all()),
              "flash_attention: rows without keys are not zero")
    again = flash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    check(torch.equal(again, got), "flash_attention is not repeatable")
    return float(err.max())


def phase_flash_kernel(flash) -> dict:
    """The serving shape (batch row 0 against the plain version), then
    ragged cases: sq in {1, 7, 129, 1000}, skv - sq in {0, 1, 60}, sq > skv,
    head_dim in {8, 36, 64, 128, 256, 80, 192}, rep in {1, 2, 7}, window
    in {None, 5, 32}, both masks, fp32 and bf16, strided and contiguous."""
    q, k, v = attn_inputs(300, SERVE_B, 2, 7, SERVE_PROMPT, SERVE_PROMPT, 64,
                          torch.bfloat16)
    err = compare_flash(flash, q, k, v, True, 4096, rows=1)
    print(f"[chip_smoke] flash_attention at the serving shape "
          f"{tuple(q.shape)} x {tuple(k.shape)} bf16, causal, window 4096: "
          f"max abs err {err:.3g} (batch row 0)", flush=True)
    del q, k, v
    n = 0
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    windows, reps = (None, 5, 32), (1, 2, 7)
    for i, dh in enumerate((8, 36, 64, 128, 256, 80, 192)):
        for j, sq in enumerate((1, 7, 129, 1000)):
            for e, extra in enumerate((0, 1, 60, -5)):
                skv = sq + extra
                if skv < 1:
                    continue
                for dtype in (torch.float32, torch.bfloat16):
                    c = i + j + e
                    causal = (c + (dtype == torch.float32)) % 3 != 2
                    q, k, v = attn_inputs(400 + n, 1 + c % 2, 1 + c % 2,
                                          reps[c % 3], sq, skv, dh, dtype,
                                          strided=bool(c % 2))
                    worst[dtype] = max(worst[dtype], compare_flash(
                        flash, q, k, v, causal or extra < 0,
                        windows[(c + j) % 3]))
                    n += 1
    print(f"[chip_smoke] flash_attention: {n} ragged cases agree (max abs "
          f"err fp32 {worst[torch.float32]:.3g}, bf16 "
          f"{worst[torch.bfloat16]:.3g}); rows without keys are zero",
          flush=True)
    return {"flash_attention": err}


# ------------------------------------------------------------ phase 3c

def top2_margin(logits: torch.Tensor) -> torch.Tensor:
    two = torch.topk(logits.float(), 2, dim=-1).values
    return two[..., 0] - two[..., 1]


def phase_serve_card_vs_cpu() -> None:
    """qwen2-0.5b at full width cut to 2 layers, fp32, the same weights on
    the card and the CPU: prefill over a prompt of 4160, then 8 greedy
    tokens (the card's choices fed to both)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.transformer import prefill_with_cache

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=SMALL_LAYERS,
                              dtype="float32")
    cpu = init_params(cfg, seed=1, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, SMALL_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    cap = SMALL_PROMPT + SMALL_GEN
    with torch.inference_mode():
        lg, cache = prefill_with_cache(card, cfg, {"tokens": prompt.cuda()},
                                       capacity=cap)
        want, cpu_cache = prefill_with_cache(cpu, cfg, {"tokens": prompt},
                                             capacity=cap)
        scale = float(want.abs().max())
        err = float((lg.cpu() - want).abs().max())
        check(err <= FP32_REL_TOL * scale and bool(torch.isfinite(lg).all()),
              f"serve card vs CPU: prefill logits differ by {err} (max "
              f"|logit| {scale})")
        errs = [err / scale]
        tok = torch.argmax(lg[:, -1:], dim=-1)
        want_last = want[:, -1:]
        del lg, want
        left_out = 0
        for step in range(SMALL_GEN):
            tol = FP32_REL_TOL * float(want_last.abs().max())
            clear = top2_margin(want_last) > tol
            left_out += int((~clear).sum())
            cpu_tok = torch.argmax(want_last, dim=-1)
            check(torch.equal(tok.cpu()[clear], cpu_tok[clear]),
                  f"serve card vs CPU: greedy token {step} differs")
            if step == SMALL_GEN - 1:
                break
            lg, cache = decode_step(card, cfg, cache, tok)
            want_last, cpu_cache = decode_step(cpu, cfg, cpu_cache, tok.cpu())
            err = float((lg.cpu() - want_last).abs().max())
            scale = float(want_last.abs().max())
            check(err <= FP32_REL_TOL * scale,
                  f"serve card vs CPU: decode step {step} logits differ by "
                  f"{err} (max |logit| {scale})")
            errs.append(err / scale)
            tok = torch.argmax(lg[:, -1:], dim=-1)
        kv_err = 0.0
        for got_l, want_l in zip(cache.layers, cpu_cache.layers):
            for name in ("k", "v"):
                w = want_l[name]
                e = float((got_l[name].cpu() - w).abs().max())
                check(e <= FP32_REL_TOL * float(w.abs().max()),
                      f"serve card vs CPU: {name} cache differs by {e}")
                kv_err = max(kv_err, e / float(w.abs().max()))
    print(f"[chip_smoke] serve card vs CPU ({SERVE_ARCH}, {SMALL_LAYERS} "
          f"layers, fp32, prompt {SMALL_PROMPT}, {SMALL_GEN} greedy tokens): "
          f"logits within {max(errs):.3g} of max |logit| (tolerance "
          f"{FP32_REL_TOL}), KV caches within {kv_err:.3g}; {left_out} of "
          f"{SMALL_GEN} token positions left out (top-2 margin within the "
          f"tolerance)", flush=True)


# ------------------------------------------------------------ phase 3f

# the LM federation of the reference tests: qwen2-0.5b cut to 1 layer,
# d 64, vocab 64, fp32; C = 4 clients in K = 2 clusters, batch 2, seq 16,
# and a second variant at seq 80 with attn_chunk 16 (the chunked path)
LM_C, LM_K, LM_BATCH, LM_SEQ, LM_STEPS = 4, 2, 2, 16, 4
LM_CHUNK_SEQ, LM_CHUNK = 80, 16
LM_SKETCH, LM_LR = 32, 1e-3


def lm_tiny_cfg(chunk=None):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(SERVE_ARCH).reduced(n_layers=1, max_d_model=64,
                                         max_vocab=64)
    return cfg if chunk is None else dataclasses.replace(cfg,
                                                         attn_chunk=chunk)


def lm_batches(cfg, seq: int, seed: int = 0):
    from repro_torch.data import ClusteredTokenStream, make_lm_batch_iterator

    stream = ClusteredTokenStream(n_clients=LM_C, n_clusters=LM_K,
                                  vocab_size=cfg.vocab_size, seed=seed,
                                  branching=4)
    raw = make_lm_batch_iterator(stream, clients_per_batch=list(range(LM_C)),
                                 per_client_batch=LM_BATCH, seq_len=seq)
    return ({"tokens": t, "labels": l} for t, l in raw)


def planted_lm_state(cfg, device):
    """Clients 0-1: init seed 0 plus 1e-2 normal noise; clients 2-3: init
    seed 1 plus noise (CPU draws, then moved): two clusters that every
    seeding splits the same way."""
    from repro_torch.core.federated import FederatedState
    from repro_torch.models.transformer import init_tree
    from repro_torch.optim import adamw_init
    from repro_torch.utils import tree_map

    a, b = (init_tree(cfg, seed=s, device="cpu") for s in (0, 1))
    gen = torch.Generator().manual_seed(2)
    params = tree_map(lambda la, lb: (
        torch.stack([la, la, lb, lb])
        + 1e-2 * torch.randn((LM_C,) + tuple(la.shape), generator=gen)
    ).to(device), a, b)
    return FederatedState(params, adamw_init(params, LM_C), LM_C)


def lm_close(name: str, got, want, move: float) -> float:
    """Card vs CPU after AdamW steps (``move`` = lr x steps, the most Adam
    moves an entry): every entry within 2 x move, and all but max(2, 1e-4
    of the leaf) entries within 1e-5 of the leaf's largest magnitude or
    1e-2 x move (Adam divides each gradient entry by its own RMS, so an
    entry whose gradient is at rounding level moves by a rounding-sized
    fraction of lr); the key bias, whose true gradient is zero, within
    2 x move alone.  Returns the largest error over the largest magnitude."""
    from repro_torch.utils import tree_leaves_with_path

    worst = 0.0
    for (path, g), (_, w) in zip(tree_leaves_with_path(got),
                                 tree_leaves_with_path(want)):
        g, w = g.detach().float().cpu(), w.detach().float()
        scale = max(float(w.abs().max()), 1e-30)
        err = (g - w).abs()
        check(float(err.max()) <= 2 * move,
              f"{name}: {path} off by {float(err.max())} > 2 x {move}")
        if not path.endswith("attn/bk"):
            off = int((err > max(1e-5 * scale, 1e-2 * move)
                       + 1e-5 * w.abs()).sum())
            check(off <= max(2, 1e-4 * err.numel()),
                  f"{name}: {path} has {off} entries off")
            worst = max(worst, float(err.max()) / scale)
    return worst


def phase_lm_card_vs_cpu() -> None:
    """Phase 3f: the LM federation, card vs CPU from the same planted
    state and batches: 4 local AdamW steps (losses within rtol 1e-5,
    parameters within ``lm_close``) at seq 16 (direct attention) and seq
    80 with attn_chunk 16 (chunked); the sketches through one projection
    (within 1e-5 of their largest magnitude); the ODCL partition on both
    engines on both devices, equal up to renaming and the planted one;
    IFCA over 2 rounds with both assign rules (labels identical, models
    within ``lm_close``); a checkpoint of the card's trained stack that
    restores bit for bit."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.core.federated import local_training, one_shot_aggregate
    from repro_torch.core.federated_methods import IFCAFederated
    from repro_torch.core.sketch import jl_projection, sketch_stacked
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils import tree_leaves, tree_size

    opt = AdamWConfig(lr=LM_LR, weight_decay=0.0)
    errs = {}
    trained = None
    for seq, chunk in ((LM_SEQ, None), (LM_CHUNK_SEQ, LM_CHUNK)):
        cfg = lm_tiny_cfg(chunk)
        runs = {}
        for dev in ("cuda", "cpu"):
            state, losses = local_training(planted_lm_state(cfg, dev), cfg,
                                           lm_batches(cfg, seq), LM_STEPS,
                                           opt)
            runs[dev] = (state, np.stack(losses))
        (card, lc), (cpu, lw) = runs["cuda"], runs["cpu"]
        check(np.all(np.isfinite(lc)) and np.allclose(lc, lw, rtol=1e-5),
              f"3f local steps seq {seq}: losses {lc} vs {lw}")
        errs[f"params seq {seq}"] = lm_close(f"3f local steps seq {seq}",
                                             card.params, cpu.params,
                                             LM_STEPS * LM_LR)
        if trained is None:
            trained = (cfg, card, cpu)
    cfg, card, cpu = trained
    n = tree_size(cpu.params) // LM_C
    proj = jl_projection(n, LM_SKETCH, seed=0, device="cpu")
    sk_card = sketch_stacked(card.params, proj.cuda()).cpu()
    sk_cpu = sketch_stacked(cpu.params, proj)
    errs["sketches"] = float((sk_card - sk_cpu).abs().max()
                             / sk_cpu.abs().max())
    check(errs["sketches"] <= 1e-5, f"3f sketches differ by "
          f"{errs['sketches']} of their largest magnitude")
    parts = {}
    for dev, state in (("cuda", card), ("cpu", cpu)):
        for engine, algo in (("host", "kmeans++"), ("device", "kmeans-device")):
            new, labels, _ = one_shot_aggregate(
                state, cfg, algorithm=algo, k=LM_K, sketch_dim=LM_SKETCH,
                engine=engine, projection=proj.to(dev), device=dev)
            parts[f"{dev} {engine}"] = (labels, new.params)
    for name, (labels, _) in parts.items():
        check(same_partition(labels, [0, 0, 1, 1]),
              f"3f ODCL {name}: partition {labels} is not the planted one")
    errs["odcl params"] = lm_close("3f ODCL card vs CPU",
                                   parts["cuda device"][1],
                                   parts["cpu device"][1], LM_STEPS * LM_LR)
    for assign in ("loss", "sketch"):
        res = {}
        for dev in ("cuda", "cpu"):
            method = IFCAFederated(k=LM_K, rounds=2, local_steps=1,
                                   assign=assign, init="clients",
                                   sketch_dim=LM_SKETCH, opt=opt,
                                   projection=proj.to(dev))
            res[dev] = method.run(0, planted_lm_state(cfg, dev), cfg,
                                  lm_batches(cfg, LM_SEQ, seed=1))
        check(np.array_equal(res["cuda"].labels, res["cpu"].labels)
              and res["cuda"].comm_bytes == res["cpu"].comm_bytes,
              f"3f IFCA {assign}: labels {res['cuda'].labels} vs "
              f"{res['cpu'].labels}")
        errs[f"ifca {assign}"] = lm_close(
            f"3f IFCA {assign}", res["cuda"].state.params,
            res["cpu"].state.params, 2 * LM_LR)
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) \
            as tmp:
        save_checkpoint(tmp, 4, card.params)
        back = restore_checkpoint(tmp, 4, card.params)
    for got, want in zip(tree_leaves(back), tree_leaves(card.params)):
        check(got.dtype == want.dtype and torch.equal(got, want.cpu()),
              "3f checkpoint: a restored leaf differs")
    print(json.dumps({"lm_card_vs_cpu": {
        "config": f"{SERVE_ARCH} reduced to 1 layer, d 64, vocab 64, fp32",
        "clients": LM_C, "clusters": LM_K, "batch": LM_BATCH,
        "seq": [LM_SEQ, LM_CHUNK_SEQ], "chunk": LM_CHUNK,
        "local_steps": LM_STEPS, "max_rel_err": errs,
        "odcl_partitions": {k: np.asarray(v[0]).tolist()
                            for k, v in parts.items()}}}), flush=True)


# ------------------------------------------------------------ phase 4c

def teacher_forced(model, cfg, tokens: torch.Tensor, pad_to: int = 1) -> tuple:
    """(b, P + G) tokens -> the logits at the G positions P - 1 .. P + G - 2
    twice, fp32: as the serve path computes them (the prompt's prefill,
    then G - 1 decode steps fed the generated tokens) and from one
    prefill over all of them but the last.  ``pad_to``: that prefill's
    length is padded with token 0 to a multiple of it; a causal model's
    logits at the earlier positions do not see the padding."""
    from repro_torch.models import decode_step
    from repro_torch.models.transformer import prefill_with_cache

    n_gen = tokens.shape[1] - SERVE_PROMPT
    logits, cache = prefill_with_cache(
        model, cfg, {"tokens": tokens[:, :SERVE_PROMPT]},
        capacity=SERVE_PROMPT + n_gen)
    rows = [logits[:, -1].float()]
    del logits
    for i in range(SERVE_PROMPT, SERVE_PROMPT + n_gen - 1):
        lg, cache = decode_step(model, cfg, cache, tokens[:, i:i + 1])
        rows.append(lg[:, -1].float())
    del cache
    forced = tokens[:, :-1]
    pad = -forced.shape[1] % pad_to
    forced = torch.cat([forced, forced.new_zeros((forced.shape[0], pad))], 1)
    full, _ = prefill_with_cache(model, cfg, {"tokens": forced})
    at = full[:, SERVE_PROMPT - 1:SERVE_PROMPT - 1 + n_gen].float()
    del full
    return torch.stack(rows, dim=1), at


def negated_decode(model, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """The first decode step's (b, V) fp32 logits from a cache whose
    layer-0 values were negated after the prompt's prefill (the
    attention's V ring; the xLSTM's mLSTM memory C, which holds the
    values): what a corrupted cache gives."""
    from repro_torch.models import decode_step
    from repro_torch.models.transformer import prefill_with_cache

    _, cache = prefill_with_cache(
        model, cfg, {"tokens": tokens[:, :SERVE_PROMPT]},
        capacity=tokens.shape[1])
    layer0 = cache.layers[0]
    layer0["v" if "v" in layer0 else "m_c"].neg_()
    lg, _ = decode_step(model, cfg, cache,
                        tokens[:, SERVE_PROMPT:SERVE_PROMPT + 1])
    return lg[:, -1].float()


def rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """max |got - want| over the vocabulary, over max |want| there."""
    return ((got - want).abs().amax(-1) / want.abs().amax(-1)).cpu()


def phase_planted_serve(model, cfg, prompts: torch.Tensor) -> dict:
    """A copy of the serve model with a planted previous-token head
    (``models.planted``): the greedy tokens must be its known
    continuation and not repeat their input throughout; one prefill over
    them must show a top-2 margin above the bf16 tolerance at every
    generated position, pick every generated token and agree with every
    decode step within that tolerance; a decode from negated layer-0
    values must pick another token in every row."""
    import copy

    from repro_torch.launch import serve
    from repro_torch.models.planted import (
        continuation, plant_previous_token_head)

    planted = copy.deepcopy(model)
    head = plant_previous_token_head(planted, cfg, seed=0)
    tokens, _ = serve.generate(planted, cfg, prompts, SERVE_GEN,
                               device="cuda")
    got = tokens[:, SERVE_PROMPT:].cpu().numpy()
    want = continuation(prompts.cpu().numpy(), SERVE_GEN, head)
    check(np.array_equal(got, want), f"serve (planted): "
          f"{int((got != want).sum())} of {got.size} greedy tokens are not "
          "the planted head's continuation")
    check(bool((got[:, 1:] != got[:, :-1]).any(axis=1).all()),
          "serve (planted): a row only repeats its input token")
    with torch.inference_mode():
        dec, at = teacher_forced(planted, cfg, tokens)
        worst = float(rel_err(dec, at).max())
        check(worst <= SERVE_BF16_REL_TOL, f"serve (planted): decode and "
              f"prefill differ by {worst} of the position's max |logit|")
        scale = float(at.abs().max())
        margin = top2_margin(at)
        check(bool((margin > SERVE_BF16_REL_TOL * scale).all()),
              f"serve (planted): the top-2 margin {float(margin.min())} "
              f"falls within the tolerance {SERVE_BF16_REL_TOL * scale} at "
              "some generated position")
        check(torch.equal(torch.argmax(at, dim=-1),
                          tokens[:, SERVE_PROMPT:]),
              "serve (planted): decode and prefill pick different tokens")
        del dec, at
        neg = torch.argmax(negated_decode(planted, cfg, tokens), dim=-1)
        check(bool((neg != tokens[:, SERVE_PROMPT + 1]).all()),
              "serve (planted): a decode from negated layer-0 values still "
              "picks the continuation's token")
    del planted
    return {"tokens_equal_continuation": True,
            "tokens_compared": int(got.size),
            "rope_pairs": head.pairs, "score_gap": head.score_gap,
            "decode_vs_prefill_rel_err": worst,
            "min_top2_margin_rel": float(margin.min()) / scale,
            "negated_cache_tokens_differ": True}


def phase_serve(ops, card: str) -> tuple:
    """The LM serving path at full size through ``serve.generate``:
    qwen2-0.5b, 24 layers, bf16, batch 4, prompt 8192, 64 greedy tokens,
    seed 0; then a warm repeat, every decode step against one prefill
    over the generated tokens, and the planted weights' run.  Returns
    (launches of the first run, its line, a closure that reruns it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = get_config(SERVE_ARCH)
    model = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    by_kernel = flash.kernel_launches()
    tokens, first = serve.generate(model, cfg, prompts, SERVE_GEN,
                                   device="cuda")
    launches = read_counts(ops)
    by_kernel = {name: n - by_kernel[name]
                 for name, n in flash.kernel_launches().items()}
    peak = torch.cuda.max_memory_allocated()
    check(launches["flash_attention"] == cfg.n_layers,
          f"serve: {launches['flash_attention']} flash_attention launches "
          f"in one prefill, not {cfg.n_layers}")
    check(by_kernel == {"tensor_core": cfg.n_layers, "cuda_core": 0},
          f"serve: the bf16 prefill's attention ran {by_kernel}, not "
          f"{cfg.n_layers} tensor-core launches and no CUDA-core one")
    check(tokens.shape == (SERVE_B, SERVE_PROMPT + SERVE_GEN)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          "serve: generated tokens out of range")
    again, warm = serve.generate(model, cfg, prompts, SERVE_GEN,
                                 device="cuda")
    with torch.inference_mode():
        dec, at = teacher_forced(model, cfg, tokens)
        check(bool(torch.isfinite(dec).all()) and
              bool(torch.isfinite(at).all()),
              "serve: decode or prefill logits are not finite")
        check(torch.equal(tokens[:, SERVE_PROMPT],
                          torch.argmax(dec[:, 0], dim=-1)),
              "serve: the first generated token is not the prefill's argmax")
        at1 = at[:, 1].clone()
        rel = rel_err(dec, at)
        worst = float(rel.max())
        check(worst <= SERVE_BF16_REL_TOL,
              f"serve: decode and prefill differ by {worst} of the "
              f"position's max |logit| at generated position "
              f"{int(rel.amax(0).argmax())} (tolerance "
              f"{SERVE_BF16_REL_TOL})")
        del dec, at
        # the same comparison must fail for a cache whose layer-0 values
        # are negated: it sees the cache
        negated = float(rel_err(negated_decode(model, cfg, tokens),
                                at1).max())
        check(negated > SERVE_BF16_REL_TOL,
              f"serve: a decode from negated layer-0 values is within "
              f"{negated} of the prefill, inside the tolerance")
    planted_line = phase_planted_serve(model, cfg, prompts)
    steps = np.asarray(warm["decode_ms"])
    line = {
        "arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "batch": SERVE_B, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
        "serve_window": cfg.serve_window,
        "prefill_ms_first": first["prefill_s"] * 1e3,
        "prefill_ms_warm": warm["prefill_s"] * 1e3,
        "decode_ms_p50": float(np.percentile(steps, 50)),
        "decode_ms_p99": float(np.percentile(steps, 99)),
        "decode_ms_p50_first_run": float(np.percentile(first["decode_ms"],
                                                       50)),
        "tok_per_s": warm["tok_per_s"], "tok_per_s_first_run":
            first["tok_per_s"],
        "max_memory_allocated_bytes": peak,
        "tokens_repeat_equal": bool(torch.equal(tokens, again)),
        "decode_vs_prefill_rel_err": worst,
        "decode_vs_prefill_positions_compared": SERVE_GEN,
        "decode_vs_prefill_rel_err_layer0_v_negated": negated,
        "planted": planted_line,
        "launches": launches, "flash_launches_by_kernel": by_kernel,
        "device": torch.cuda.get_device_name(0), "card": card}
    print(json.dumps({"serve_path": line}), flush=True)
    return launches, line, (lambda **kw: serve.generate(
        model, cfg, prompts, device="cuda", **kw))


# ------------------------------------------------------------ phase 4d

def check_rows(name: str, rows: list) -> None:
    for row in rows:
        what = (f"{name}: {'batched' if row['batched'] else 'direct'} at "
                f"{row['callers']} callers")
        check(row["n_errors"] == 0 and row["timeouts"] == 0,
              f"{what}: {row['n_errors']} errors, {row['timeouts']} timeouts")
        check(row["flush_errors"] == 0, f"{what}: {row['flush_errors']} "
              "serving.flush_errors")
        check(row["n_requests"] > 0, f"{what}: no request was answered")


def check_ingest_row(what: str, row: dict, session) -> None:
    """The ingest row ran waves and its one background refinalize, warm."""
    check(row["ingest_waves"] > 0 and row["refinalize_under_load_ms"]
          is not None, f"{what}: the ingest row ran {row['ingest_waves']} "
          "waves and no refinalize")
    mode = session.served_round.out[2]["refinalize"]
    check(mode == "warm", f"{what}: the background refinalize ran {mode}, "
          "not warm")


def check_probes(what: str, session, rows, timeout: float) -> None:
    """The labels of SERVING_PROBES probes through a fresh server equal
    one batch route."""
    from repro_torch.serving.server import RouteServer

    probes = rows[:SERVING_PROBES]
    srv = RouteServer(session, queue_depth=2 * SERVING_PROBES,
                      **SERVER_KW).start()
    futures = [srv.submit(p, timeout=60.0) for p in probes]
    got = np.asarray([f.result(60.0) for f in futures])
    srv.stop(timeout=timeout)
    want = np.asarray(session.route(probes))
    check(np.array_equal(got, want), f"{what}: the server's labels differ "
          f"from one batch route on {int((got != want).sum())} of "
          f"{len(probes)} probes")


def replay_log(log: list, upto: int, clients: int, device, mesh=None):
    """The serialized replay: the fixture (its cold finalize), the logged
    keyed waves in clock order up to ``upto``, then a warm refinalize
    right after (the background round's snapshot clock)."""
    from repro_torch.serving import loadgen

    replay, _ = loadgen.build_session(clients=clients, clusters=MAIN_K,
                                      sketch_dim=MAIN_D, seed=0,
                                      device=device, mesh=mesh)
    for clock, ids, chunk in sorted(log, key=lambda w: w[0]):
        if clock > upto:
            break
        replay.ingest(sketches=chunk, client_ids=ids)
        check(replay.clock == clock, f"replay clock {replay.clock} != "
              f"{clock}")
    replay.refinalize()
    return replay.served_round


def same_round(a, b) -> bool:
    """Two served rounds equal bit for bit."""
    return (a.clock == b.clock and a.n_clusters == b.n_clusters
            and np.array_equal(a.out[1], b.out[1])
            and np.array_equal(a.first_idx, b.first_idx)
            and torch.equal(a.centers.cpu(), b.centers.cpu())
            and a.finalized_d2 == b.finalized_d2)


def phase_serving(ops, card: str, clients: int) -> tuple:
    """The route server over a sketch-only session of ``clients`` rows
    (sketch 64, k = 8, built by the port's ``loadgen.build_session``):
    closed loops at each caller count, per request and batched; one
    batched row under ingest (keyed waves of 256 every 0.2 s) with one
    background warm refinalize; then the server's labels for 4096 probes
    against one batch route, and the served round against a serialized
    replay (labels identical, centers bit-identical).  Returns (launches,
    the rows' flushes by the bucket they launched at, the per-request
    routes of the direct rows, the printed line)."""
    from repro_torch.serving import loadgen

    callers = SERVING_CALLERS
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    session, rows = loadgen.build_session(clients=clients, clusters=MAIN_K,
                                          sketch_dim=MAIN_D, seed=0,
                                          device="cuda")
    build_s = time.perf_counter() - t0
    config = {"clients": clients, "clusters": MAIN_K, "sketch_dim": MAIN_D}
    kw = dict(duration_s=SERVING_SECONDS, queue_depth=1024, config=config,
              **SERVER_KW)
    bench, criterion = [], {}
    for m in callers:
        direct = loadgen.run_row(session, rows, mode="closed", batched=False,
                                 callers=m, **kw)
        batched = loadgen.run_row(session, rows, mode="closed", batched=True,
                                  callers=m, **kw)
        bench += [direct, batched]
        criterion[f"callers={m}"] = {
            "batched_qps": batched["qps"], "direct_qps": direct["qps"],
            "speedup": batched["qps"] / max(direct["qps"], 1e-9),
            "pass": batched["qps"] > direct["qps"]}
    log: list = []
    under = loadgen.run_row(session, rows, mode="closed", batched=True,
                            callers=max(callers), ingest=True,
                            ingest_log=log, **kw)
    bench.append(under)
    check_rows(f"serving C={clients}", bench)
    check_ingest_row(f"serving C={clients}", under, session)
    served = session.served_round
    check_probes(f"serving C={clients}", session, rows, 60.0)
    launches = read_counts(ops)
    # one kmeans_assign launch per flush, at its bucket (the server's own
    # serving.flush_size observations), and one at m = 1 per request of
    # a direct row (route_direct)
    flushes: dict = {}
    for r in bench:
        for b, n in r["flushes_by_bucket"].items():
            flushes[int(b)] = flushes.get(int(b), 0) + n
    direct_routes = sum(r["n_requests"] for r in bench if not r["batched"])
    check(same_round(replay_log(log, served.clock, clients, "cuda"),
                     served), f"serving C={clients}: the round refinalized "
          "in the background differs from the serialized replay")
    for kernel in ("kmeans_assign", "pairwise_sqdist"):
        check(launches[kernel] > 0, f"serving C={clients}: launched no "
              f"{kernel} kernel")
    b16 = [r for r in bench if r["batched"] and r["callers"] == max(callers)
           and not r["ingest_waves"]][0]
    line = {
        "clients": clients, "clusters": MAIN_K, "sketch_dim": MAIN_D,
        "seconds": SERVING_SECONDS, "build_session_s": build_s,
        "criterion": criterion,
        "qps": {f"{'batched' if r['batched'] else 'direct'} "
                f"{r['callers']}{' ingest' if r['ingest_waves'] else ''}":
                r["qps"] for r in bench},
        "route_p50_ms": {f"{'batched' if r['batched'] else 'direct'} "
                         f"{r['callers']}": r["route_p50_ms"]
                         for r in bench if not r["ingest_waves"]},
        "route_p99_ms": {f"{'batched' if r['batched'] else 'direct'} "
                         f"{r['callers']}": r["route_p99_ms"]
                         for r in bench if not r["ingest_waves"]},
        "route_p99_ms_batched_no_refinalize": b16["route_p99_ms"],
        "route_p50_ms_during_refinalize":
            under.get("route_p50_ms_during_refinalize"),
        "route_p99_ms_during_refinalize":
            under.get("route_p99_ms_during_refinalize"),
        "route_p99_ms_outside_refinalize_ingest_row":
            under.get("route_p99_ms_outside_refinalize"),
        "n_requests_during_refinalize":
            under.get("n_requests_during_refinalize"),
        "refinalize_window_ms": under.get("refinalize_window_ms"),
        "refinalize_under_load_ms": under["refinalize_under_load_ms"],
        "refinalize_n_iter": served.out[2]["meta"]["n_iter"],
        "staleness_at_serve_p95": under["staleness_at_serve_p95"],
        "flush_size_p50": {r["callers"]: r["flush_size_p50"]
                           for r in bench if r["batched"]
                           and not r["ingest_waves"]},
        "flush_size_p95": {r["callers"]: r["flush_size_p95"]
                           for r in bench if r["batched"]
                           and not r["ingest_waves"]},
        "ingest_waves": under["ingest_waves"],
        "replay_equal": True, "labels_equal_batch_route": True,
        "launches": launches, "flushes_by_bucket": flushes,
        "direct_routes": direct_routes,
        "rows": bench, "device": torch.cuda.get_device_name(0),
        "card": card}
    print(json.dumps({"serving_path": line}), flush=True)
    return launches, flushes, direct_routes, line


def phase_traces(simulate, generate) -> None:
    """``--profile``, after phase 5 (a trace of CPU and CUDA activity
    taken earlier left phase 5's own profiler sessions counting about
    half of a kernel's launches): a second run of the main path, one
    finalize of the complete fusion graph (8 386 560 edges), two serve
    calls (the prompt pass alone, then it and 15 decode steps: the
    difference is the decode steps' share), and one second of phase 4d's
    16-caller closed loop, batched and then per request, over a fresh
    session of each phase-4d size."""
    from repro_torch.serving import loadgen
    from repro_torch.serving.server import RouteServer

    print(json.dumps({"profile": phase_profile(
        simulate, clients=MAIN_M, clusters=8, dim=16, samples=64,
        sketch_dim=64, wave=65_536, algorithm="kmeans-device",
        init="kmeans++", route_probes=256, finalize_repeats=3,
        device="cuda")}), flush=True)
    print(json.dumps({"profile": phase_profile(
        simulate, clients=4096, clusters=8, dim=16, samples=64,
        sketch_dim=32, algorithm="convex-device", edges="complete",
        cc_iters=200, device="cuda")}), flush=True)
    for n in (1, 16):
        print(json.dumps({"profile": phase_profile(generate, gen=n)}),
              flush=True)
    lm_traces()
    for clients in SERVING_CLIENTS:
        session, rows = loadgen.build_session(
            clients=clients, clusters=MAIN_K, sketch_dim=MAIN_D, seed=0,
            device="cuda")
        loadgen.warm_route_buckets(session, rows[0], FLUSH_BUCKETS[-1])
        srv = RouteServer(session, max_batch=FLUSH_BUCKETS[-1],
                          max_wait_ms=0.5, queue_depth=1024).start()
        for batched in (True, False):
            print(json.dumps({"profile": phase_profile(
                lambda clients, **kw: loadgen.closed_loop(srv, rows, **kw),
                clients=clients, callers=max(SERVING_CALLERS),
                duration_s=1.0, batched=batched)}), flush=True)
        srv.stop(timeout=60.0)


def lm_traces() -> None:
    """``--profile``: phase 4h's federation (qwen2-0.5b, bf16, 8 clients,
    batch 4, seq 64) traced for one local AdamW step after a warm one,
    and for one streamed sketch of the 8 clients into 128 values."""
    from repro_torch.configs import get_config
    from repro_torch.core.federated import init_federation, local_training
    from repro_torch.core.sketch import sketch_stacked
    from repro_torch.data import ClusteredTokenStream, make_lm_batch_iterator
    from repro_torch.optim import AdamWConfig

    cfg = get_config(SERVE_ARCH)
    stream = ClusteredTokenStream(n_clients=LM_CLIENTS,
                                  n_clusters=LM_CLUSTERS,
                                  vocab_size=cfg.vocab_size, seed=0)
    raw = make_lm_batch_iterator(stream,
                                 clients_per_batch=list(range(LM_CLIENTS)),
                                 per_client_batch=LM_FULL_BATCH,
                                 seq_len=LM_FULL_SEQ)
    batches = ({"tokens": t, "labels": l} for t, l in raw)
    state = init_federation(0, cfg, LM_CLIENTS, device="cuda")
    opt = AdamWConfig(lr=1e-3, weight_decay=0.0)
    state, _ = local_training(state, cfg, batches, 1, opt)
    print(json.dumps({"profile": phase_profile(
        lambda what: local_training(state, cfg, batches, 1, opt),
        what="4h local step, 8 clients")}), flush=True)
    print(json.dumps({"profile": phase_profile(
        lambda what: sketch_stacked(state.params, sketch_dim=LM_FULL_SKETCH,
                                    seed=0),
        what="4h streamed sketch, 8 clients into 128")}), flush=True)
    del state
    torch.cuda.empty_cache()


def phase_mutation(simulate, ops, card: str) -> dict:
    """``simulate`` with the mutation knobs: keyed re-uploads of a quarter
    of the clients and 64 joiners a round for three rounds against
    shifted optima, sliding window 3, then the drift-triggered warm
    re-finalize and its repeats.  Purity 1.0 and the refinalize must
    fire."""
    ops.reset_launch_counts()
    summary = simulate(clients=MAIN_M, clusters=8, dim=16, samples=64,
                       sketch_dim=MAIN_D, wave=65_536,
                       algorithm="kmeans-device", init="kmeans++",
                       finalize_repeats=MUTATION_FINALIZES, device="cuda",
                       **MUTATION)
    launches = read_counts(ops)
    sv = summary["serving"]
    check(summary["purity"] == 1.0,
          f"mutation: purity {summary['purity']} != 1.0")
    check(sv["refinalize_fired"] is True, "mutation: the drift-triggered "
          f"refinalize did not fire (drift {sv['drift_after_mutation']})")
    for kernel in ("kmeans_assign", "pairwise_sqdist"):
        check(launches[kernel] > 0, f"mutation: launched no {kernel} kernel")
    print(json.dumps({"mutation_path": {
        "clients": MAIN_M, "wave": 65_536, **MUTATION,
        "purity": summary["purity"], "live_clients": sv["live_clients"],
        "evictions": sv["evictions"],
        "drift_after_mutation": sv["drift_after_mutation"],
        "refinalize_fired": sv["refinalize_fired"],
        "refinalize_count": sv["refinalize_count"],
        "refinalize_warm_p50_ms": sv["refinalize_warm_p50_ms"],
        "refinalize_warm_p99_ms": sv["refinalize_warm_p99_ms"],
        "refinalize_n_iter": sv["refinalize_n_iter"],
        "finalize_first_ms": sv["finalize_first_ms"],
        "finalize_cold_p50_ms": sv["finalize_p50_ms"],
        "cold_n_iter": summary["meta"]["n_iter"],
        "phases": summary["phases"], "launches": launches,
        "device": summary["device_name"], "card": card}}), flush=True)
    return launches


def phase_convex_warm(ops, card: str) -> dict:
    """A ``convex-device`` session on the kNN graph (k = 8) at the exact
    lambda of (17), finalized cold and then refinalized warm from its AMA
    dual: the same partition in fewer AMA iterations, both within a
    budget of CONVEX_WARM_ITERS."""
    from repro_torch.core.clustering.convex import lambda_interval
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.core.federated import cluster_agreement
    from repro_torch.core.sketch import make_generator
    from repro_torch.launch.simulate import staggered_optima, wave_ridge_erm

    clients = CONVEX_WARM_C
    gen = make_generator(0, torch.device("cuda"))
    optima = staggered_optima(gen, 8, 16)
    truth = torch.arange(clients, device="cuda") % 8
    ops.reset_launch_counts()
    sess = AggregationSession(clients, sketch_dim=32, device="cuda")
    for lo in range(0, clients, 4096):
        sess.ingest({"theta": wave_ridge_erm(gen, optima, truth[lo:lo + 4096],
                                             n=64)})
    lo, hi = lambda_interval(sess.state().params["theta"], truth.cpu().numpy())
    options = {"lam": 0.5 * (lo + hi) if lo < hi else lo,
               "iters": CONVEX_WARM_ITERS, "edges": "knn", "knn_k": 8}
    t0 = time.perf_counter()
    _, cold, info0 = sess.finalize(algorithm="convex-device",
                                   algo_options=options)
    t1 = time.perf_counter()
    _, warm, info1 = sess.refinalize()
    t2 = time.perf_counter()
    launches = read_counts(ops)
    n0, n1 = info0["meta"]["n_iter"], info1["meta"]["n_iter"]
    purity = cluster_agreement(warm, truth.cpu().numpy())
    check(info1["refinalize"] == "warm", "convex warm: the refinalize ran "
          f"{info1['refinalize']}")
    check(np.array_equal(cold, warm), "convex warm: the warm partition "
          "differs from the cold one")
    check(n1 < n0, f"convex warm: {n1} AMA iterations warm, not fewer than "
          f"{n0} cold")
    check(purity == 1.0, f"convex warm: purity {purity}")
    for kernel in ("group_ball_proj_batched", "pairwise_sqdist"):
        check(launches[kernel] > 0, f"convex warm: launched no {kernel}")
    # each AMA iteration is one fused step and one gather-back, and each
    # solve one gather-back more for its result
    check(launches["group_ball_proj_batched.ama_step"] == n0 + n1 and
          launches["ama_gather_back"] == n0 + n1 + 2,
          f"convex warm: {n0} + {n1} AMA iterations launched "
          f"{launches['group_ball_proj_batched.ama_step']} fused steps and "
          f"{launches['ama_gather_back']} gather-backs")
    print(json.dumps({"convex_warm_path": {
        "clients": clients, "edges": "knn", "knn_k": 8,
        "lam": options["lam"], "n_clusters": info1["n_clusters"],
        "purity": purity, "iters": CONVEX_WARM_ITERS, "n_iter_cold": n0,
        "n_iter_warm": n1,
        "finalize_cold_ms": (t1 - t0) * 1e3,
        "refinalize_warm_ms": (t2 - t1) * 1e3, "launches": launches,
        "device": torch.cuda.get_device_name(0), "card": card}}),
        flush=True)
    return launches


def phase_slice7(simulate, ops, card: str) -> tuple:
    """Phase 4e: one ridge session of C = 1 048 576 (dim 16, 64 samples,
    sketch 64, k = 8), built once, then one finalize of each of
    ``SLICE7_PATHS`` with the launch counts set to 0 just before and read
    just after: purity 1.0, K' = 8 and every kernel of the path launched.
    Beside them the SVD of the centered sketches (torch.linalg.svd, and
    the QR route the port takes), the spectral seeds and partition of the
    card against the CPU's, ``simulate --task logistic`` at C = 1 048 576
    and ``simulate --trace`` at C = 4096.  Returns (launches by path, the
    launches at the new phase-5 shapes)."""
    from repro_torch.core.clustering.kmeans import (
        spectral_init, top_right_singular)
    from repro_torch.core.engine.device_kmeans import device_kmeans
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.core.federated import cluster_agreement
    from repro_torch.core.sketch import make_generator
    from repro_torch.launch.simulate import main as simulate_main
    from repro_torch.launch.simulate import staggered_optima, wave_ridge_erm
    from repro_torch.obs import read_jsonl

    gen = make_generator(0, torch.device("cuda"))
    optima = staggered_optima(gen, 8, 16)
    truth = torch.arange(MAIN_M, device="cuda") % 8
    t0 = time.perf_counter()
    sess = AggregationSession(MAIN_M, sketch_dim=MAIN_D, device="cuda")
    for lo in range(0, MAIN_M, 65_536):
        sess.ingest({"theta": wave_ridge_erm(gen, optima,
                                             truth[lo:lo + 65_536], n=64)})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    truth_np = truth.cpu().numpy()

    # the SVD of the (C, 64) centered sketches, two ways
    sk = sess.sketches
    x = sk - torch.mean(sk, dim=0, keepdim=True)
    svd_ms = {}
    for name, fn in (("qr_then_svd", lambda: top_right_singular(x, 8)),
                     ("torch.linalg.svd", lambda: torch.linalg.svd(
                         x, full_matrices=False)[2][:8])):
        fn()                                   # cuSOLVER's set-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vt = fn()
        torch.cuda.synchronize()
        svd_ms[name] = (time.perf_counter() - t1) * 1e3
        svd_ms[name + "_vt"] = vt
    # the two top-8 subspaces: the largest principal angle's sine
    a, b = svd_ms.pop("qr_then_svd_vt"), svd_ms.pop("torch.linalg.svd_vt")
    sing = torch.linalg.svdvals(a @ b.T)
    svd_ms["subspace_sin_max"] = float(torch.sqrt(torch.clamp_min(
        1.0 - sing.min() ** 2, 0.0)))
    svals = torch.linalg.svdvals(x)[:10].cpu().tolist()
    seeds_card = spectral_init(sk, 8)
    sk_cpu = sk.cpu()
    seeds_cpu = spectral_init(sk_cpu, 8)
    seed_rows_agree = bool(torch.equal(seeds_card.cpu(), seeds_cpu))
    del x, a, b

    by_path, shape_launches, rows = {}, {}, []
    for name, kw, kernels, gate_purity in SLICE7_PATHS:
        kw = dict(kw)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        state, labels, info = sess.finalize(k=8, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        launches = read_counts(ops)
        purity = cluster_agreement(labels, truth_np)
        check(purity == 1.0 or not gate_purity,
              f"4e {name}: purity {purity} != 1.0")
        check(info["n_clusters"] == 8,
              f"4e {name}: recovered {info['n_clusters']} clusters, not 8")
        check(bool(torch.isfinite(state.params["theta"]).all()),
              f"4e {name}: non-finite models")
        for kernel in kernels:
            check(launches[kernel] > 0, f"4e {name}: launched no {kernel}")
        meta = info["meta"]
        row = {"name": name, "engine": info["engine"],
               "purity_gated": gate_purity,
               "algorithm": kw["algorithm"],
               "aggregator": kw.get("aggregator", "mean"),
               "options": {k: v for k, v in kw["algo_options"].items()},
               "finalize_ms": ms, "purity": purity,
               "n_clusters": info["n_clusters"],
               "n_iter": meta.get("n_iter"), "restarts": meta.get("restarts"),
               "inertia": meta.get("inertia"),
               "restart_spread": meta.get("restart_spread"),
               "launches": launches}
        if name == "spectral":
            # the card's partition against the CPU's spectral Lloyd on the
            # same sketches (identical, or the same up to renaming where
            # the near-tied 8th singular axis rotated the seeds)
            cpu = device_kmeans(make_generator(0, "cpu"), sk_cpu, 8, iters=50,
                                init="spectral")
            row["cpu_labels_identical"] = bool(np.array_equal(
                cpu.labels.numpy(), np.asarray(labels)))
            renaming(cpu.labels.numpy(), labels)
            shape_launches["spectral"] = launches["pairwise_sqdist"]
        if name.startswith("kmeans++ batch_m"):
            # every minibatch iteration, then the final assignment over C
            shape_launches["minibatch"] = launches["kmeans_assign"] - 1
        rows.append(row)
        by_path[f"4e {name}"] = launches
        print(json.dumps({"slice7_path": {**row, "clients": MAIN_M,
                                          "card": card}}), flush=True)

    # simulate --task logistic at C = 1 048 576: 8 Newton steps a client.
    # The logistic models of 64 samples overlap across clusters (their
    # separability margin is below 1), so the planted partition is not
    # the clustering's optimum; the reference's simulate recovers 0.75 of
    # it at C = 4096.  K' = 8 and finite models are gated, the purity and
    # the margin are printed.
    ops.reset_launch_counts()
    logi = simulate(clients=MAIN_M, clusters=8, dim=16, samples=64,
                    sketch_dim=MAIN_D, wave=65_536, task="logistic",
                    restarts=8, device="cuda")
    launches = read_counts(ops)
    check(logi["n_clusters_recovered"] == 8,
          f"4e logistic: recovered {logi['n_clusters_recovered']} clusters")
    check(logi["purity"] > 0.5, f"4e logistic: purity {logi['purity']}")
    for kernel in ("pairwise_sqdist", "kmeans_assign"):
        check(launches[kernel] > 0, f"4e logistic: launched no {kernel}")
    by_path["4e simulate logistic"] = launches
    print(json.dumps({"slice7_logistic": {
        "clients": MAIN_M, "task": "logistic", "restarts": 8,
        "purity": logi["purity"], "n_clusters": logi["n_clusters_recovered"],
        "phases": logi["phases"], "meta": logi["meta"],
        "launches": launches, "card": card}}), flush=True)

    # simulate --trace at C = 4096: the JSONL trace holds the session's
    # spans with their fields (written beside this script, then removed)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent) as tmp:
        path = str(Path(tmp) / "trace.jsonl")
        simulate_main(["--clients", str(TRACE_C), "--clusters", "8",
                       "--trace", path])
        events = read_jsonl(path)
    by_path["4e simulate trace"] = read_counts(ops)
    spans = [e for e in events if e["event"] == "span"]
    ingest = [e for e in spans if e["name"] == "session.ingest"]
    fin = [e for e in spans if e["name"] == "session.finalize"]
    check(ingest and all(e.get("wave") == TRACE_C and e.get("offset") == 0
                         and e.get("mode") == "params" for e in ingest),
          f"trace: session.ingest spans {ingest}")
    check(len(fin) == 1 and fin[0].get("count") == TRACE_C and
          fin[0].get("algorithm") == "kmeans-device" and
          fin[0].get("engine") == "device" and fin[0].get("ms", 0) > 0,
          f"trace: session.finalize spans {fin}")
    print(json.dumps({"slice7_setup": {
        "clients": MAIN_M, "build_s": build_s,
        "svd_ms": svd_ms, "singular_values": svals,
        "spectral_seed_rows_agree_with_cpu": seed_rows_agree,
        "trace_events": len(spans), "trace_finalize": fin[0],
        "card": card}}), flush=True)
    return by_path, shape_launches


def by_variant(launches: dict) -> dict:
    """The launches of one run by wrapper and variant (those non-zero)."""
    return {k: v for k, v in launches.items() if v}


def span_ms(summary_obs: dict, name: str) -> dict:
    h = summary_obs["histograms"].get(f"{name}.ms", {})
    return {"count": h.get("count", 0), "sum_ms": h.get("sum"),
            "p50_ms": h.get("p50")}


def phase_slice8(simulate, ops, card: str) -> tuple:
    """Phase 4f: this slice's paths at the main path's size (ridge
    clients, C = 1 048 576, sketch 64, dim 16, k = 8, kmeans++), each
    with the launch counts set to 0 just before and read just after.
    Returns (launches by path, the launches at the new phase-5 shapes)."""
    from repro_torch.core.engine.hierarchy import HierarchicalSession
    from repro_torch.core.engine.session import AggregationSession
    from repro_torch.core.federated import cluster_agreement
    from repro_torch.core.sketch import make_generator
    from repro_torch.launch.simulate import staggered_optima, wave_ridge_erm

    base = dict(clients=MAIN_M, clusters=8, dim=16, samples=64,
                sketch_dim=MAIN_D, wave=SHARD_M, device="cuda")
    by_path, shape_launches = {}, {}

    def run(name, **kw):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = simulate(**base, **kw)
        launches = read_counts(ops)
        by_path[f"4f {name}"] = launches
        row = {"name": name, "run_s": time.perf_counter() - t0,
               "purity": out["purity"], "purity_all": out["purity_all"],
               "honest_frac": out["honest_frac"], "mse": out["mse"],
               "n_clusters": out["n_clusters_recovered"],
               "phases": out["phases"], "scenario": out["scenario"],
               "scenario_options": out["scenario_options"],
               "aggregator": out["aggregator"], "shards": out["shards"],
               "launches": by_variant(launches)}
        return out, launches, row

    # the two-level round, S = 32
    out, launches, row = run(f"shards {HIER_SHARDS}", shards=HIER_SHARDS)
    spans = {n: span_ms(out["obs"], n)
             for n in ("hierarchy.finalize", "hierarchy.level0",
                       "hierarchy.level1", "session.finalize")}
    want_bytes = {"level0": MAIN_M * MAIN_D * 4,
                  "level1": TOP_M * (MAIN_D + 1) * 4}
    check(out["purity"] == 1.0 and out["n_clusters_recovered"] == 8,
          f"4f shards: purity {out['purity']}, K' "
          f"{out['n_clusters_recovered']}")
    check(out["mse"] < 1e-2, f"4f shards: served mse {out['mse']}")
    check(out["comm_level_bytes"] == want_bytes,
          f"4f shards: comm bytes {out['comm_level_bytes']} != {want_bytes}")
    check(spans["session.finalize"]["count"] == HIER_SHARDS + 1 and
          spans["hierarchy.level0"]["count"] == 1 and
          spans["hierarchy.level1"]["count"] == 1,
          f"4f shards: finalize spans {spans}")
    check(launches["pairwise_sqdist"] > 0 and
          launches["kmeans_assign.stream"] > 0 and
          launches["kmeans_assign.small"] > 0,
          f"4f shards: launches {by_variant(launches)} (the shards' Lloyd "
          "on the stream assign, the top level's on the small one)")
    shape_launches["shard"] = launches["kmeans_assign.stream"]
    shape_launches["top"] = launches["kmeans_assign.small"]
    print(json.dumps({"slice8_path": {
        **row, "comm_level_bytes": out["comm_level_bytes"],
        "level0_ms": spans["hierarchy.level0"]["sum_ms"],
        "level1_ms": spans["hierarchy.level1"]["sum_ms"],
        "finalize_ms": spans["hierarchy.finalize"]["sum_ms"],
        "session_finalizes": spans["session.finalize"]["count"],
        "card": card}}), flush=True)

    # one federation, built once, for the session-level checks
    gen = make_generator(0, torch.device("cuda"))
    optima = staggered_optima(gen, 8, 16)
    truth = torch.arange(MAIN_M, device="cuda") % 8
    thetas = torch.cat([wave_ridge_erm(gen, optima, truth[lo:lo + SHARD_M],
                                       n=64)
                        for lo in range(0, MAIN_M, SHARD_M)])
    truth_np = truth.cpu().numpy()
    key, scen = scenario_key(), scenarios()

    def fill(sess, corrupt=None):
        for lo in range(0, MAIN_M, SHARD_M):
            w = thetas[lo:lo + SHARD_M]
            if corrupt is not None:
                w = corrupt.corrupt_uploads(key, w, None, lo, MAIN_M)
            sess.ingest({"theta": w})
        torch.cuda.synchronize()
        return sess

    def flat(sc=None):
        return fill(AggregationSession(MAIN_M, sketch_dim=MAIN_D,
                                       sketch_transform=sketch_hook(sc, key),
                                       device="cuda"))

    opts = {"init": "kmeans++", "iters": 50}
    # shards = 1 delegates: bit-equal to the flat session on the same clients
    plain = flat()
    ops.reset_launch_counts()
    f_state, f_labels, _ = plain.finalize(k=8, algo_options=opts)
    one = fill(HierarchicalSession(MAIN_M, shards=1, sketch_dim=MAIN_D,
                                   device="cuda"))
    h_state, h_labels, h_info = one.finalize(k=8, algo_options=opts)
    by_path["4f shards 1 and flat"] = read_counts(ops)
    check(np.array_equal(h_labels, f_labels) and torch.equal(
        h_state.params["theta"], f_state.params["theta"]),
          "4f shards=1: labels or served models differ from the flat round")
    check(h_info["shards"] == 1, f"4f shards=1: info {h_info}")
    print(json.dumps({"slice8_path": {
        "name": "shards 1 against the flat session", "bit_equal": True,
        "purity": cluster_agreement(h_labels, truth_np),
        "launches": by_variant(by_path["4f shards 1 and flat"]),
        "card": card}}), flush=True)
    del one, h_state, f_state

    # drift: purity against the drifted labels, and the migrated count
    out, _, row = run("drift", scenario="drift",
                      scenario_options=SCENARIO_DRIFT)
    drifted = scen["drift"].wave_labels(key, truth, 0, MAIN_M, 8)
    migrated = int((drifted != truth).sum())
    check(out["purity"] == 1.0, f"4f drift: purity {out['purity']}")
    check(0 < migrated < MAIN_M // 2, f"4f drift: {migrated} migrated")
    print(json.dumps({"slice8_path": {**row, "migrated": migrated,
                                      "card": card}}), flush=True)

    # longtail: the run's occupancy (its true labels counted on the card)
    # is the scenario's numpy Zipf counts, which the CPU tests hold to the
    # reference's bit for bit at this size
    out, _, row = run("longtail", scenario="longtail",
                      scenario_options=SCENARIO_ZIPF)
    want = np.bincount(scen["longtail"].population(
        key, MAIN_M, 8, device="cpu").numpy(), minlength=8).tolist()
    check(out["occupancy"] == want,
          f"4f longtail: occupancy {out['occupancy']} != {want}")
    print(json.dumps({"slice8_path": {**row, "occupancy": out["occupancy"],
                                      "card": card}}), flush=True)

    # byzantine sign flip, f = 0.1, with the mean and the trimmed mean
    sigma = 5.0 * np.sqrt(0.1 * 0.9 / MAIN_M)
    for agg in ("mean", "trimmed_mean"):
        out, _, row = run(f"byzantine sign_flip {agg}", scenario="byzantine",
                          scenario_options=SCENARIO_BYZ, aggregator=agg)
        check(abs(out["honest_frac"] - 0.9) <= sigma,
              f"4f byzantine: honest_frac {out['honest_frac']} outside "
              f"0.9 +- {sigma:.4g}")
        print(json.dumps({"slice8_path": {**row, "card": card}}), flush=True)
    honest = scen["byzantine"].honest_mask(key, MAIN_M, device="cuda")
    flipped = scen["byzantine"].corrupt_uploads(key, thetas, None, 0, MAIN_M)
    check(torch.equal(flipped[~honest], -thetas[~honest]) and
          torch.equal(flipped[honest], thetas[honest]),
          "4f byzantine: an attacker's upload is not exactly -theta, or an "
          "honest one changed")
    del flipped

    # spoof: the attackers' rows are one shared vector, the rest untouched
    spoof = flat(scen["spoof"])
    bad = ~scen["spoof"].honest_mask(key, MAIN_M, device="cuda")
    rows = spoof.sketches
    check(bool((rows[bad] == rows[bad][:1]).all()),
          "4f spoof: the attackers' rows are not one shared vector")
    check(torch.equal(rows[~bad], plain.sketches[~bad]),
          "4f spoof: an honest row changed")
    check(torch.equal(spoof.state().params["theta"], thetas),
          "4f spoof: the parameters changed")
    ops.reset_launch_counts()
    _, labels, _ = spoof.finalize(k=8, algo_options=opts)
    by_path["4f byzantine spoof"] = read_counts(ops)
    keep = (~bad).cpu().numpy()
    print(json.dumps({"slice8_path": {
        "name": "byzantine spoof", "attackers": int(bad.sum()),
        "purity": cluster_agreement(labels[keep], truth_np[keep]),
        "purity_all": cluster_agreement(labels, truth_np),
        "launches": by_variant(by_path["4f byzantine spoof"]),
        "card": card}}), flush=True)
    del spoof, rows

    # dp, epsilon 64: clipped rows inside the ball, the noise's spread
    dp = scen["dp"]
    noised = flat(dp)
    clipped = dp.clip_rows(plain.sketches)
    norm_max = float(torch.linalg.vector_norm(clipped, dim=1).max())
    check(norm_max <= dp.clip * (1.0 + 1e-6),
          f"4f dp: a clipped row's norm {norm_max} exceeds {dp.clip}")
    spread = float(torch.std(noised.sketches - clipped))
    check(abs(spread / dp.sigma - 1.0) <= 0.01,
          f"4f dp: noise std {spread} against sigma {dp.sigma}")
    ops.reset_launch_counts()
    _, labels, _ = noised.finalize(k=8, algo_options=opts)
    by_path["4f dp"] = read_counts(ops)
    print(json.dumps({"slice8_path": {
        "name": "dp", "epsilon": dp.epsilon, "delta": dp.delta,
        "clip": dp.clip, "sigma": dp.sigma, "noise_std": spread,
        "clipped_norm_max": norm_max,
        "purity": cluster_agreement(labels, truth_np),
        "launches": by_variant(by_path["4f dp"]), "card": card}}),
        flush=True)
    del clipped, plain

    # the hierarchy under dp: each shard keys its hook by global row, so
    # its rows are the flat session's
    hier = fill(HierarchicalSession(MAIN_M, shards=HIER_SHARDS,
                                    sketch_dim=MAIN_D,
                                    sketch_transform=sketch_hook(dp, key),
                                    device="cuda"))
    check(torch.equal(hier.sketches, noised.sketches),
          f"4f shards {HIER_SHARDS} dp: the sketch rows differ from the flat "
          "session's")
    ops.reset_launch_counts()
    _, labels, info = hier.finalize(k=8, algo_options=opts)
    by_path[f"4f shards {HIER_SHARDS} dp"] = read_counts(ops)
    print(json.dumps({"slice8_path": {
        "name": f"shards {HIER_SHARDS} dp", "rows_equal_flat": True,
        "purity": cluster_agreement(labels, truth_np),
        "n_clusters": info["n_clusters"],
        "launches": by_variant(by_path[f"4f shards {HIER_SHARDS} dp"]),
        "card": card}}), flush=True)
    del hier, noised, thetas
    torch.cuda.empty_cache()
    return by_path, shape_launches


def phase_paper_methods(ops, card: str) -> tuple:
    """Phase 4g: the paper's Section 5 comparison on the card: the
    federation of ``make_linear_regression_federation(seed=0)`` through
    every method of ``paper_methods``.  ODCL-KM with 8 kmeans++ restarts
    must recover the true partition and its mse must equal oracle
    averaging's within 1e-5 relative (with the partition exact, the
    cluster mean is the oracle average).  One kmeans++ seeding lands in a
    local optimum for some keys (0.16 of them, in both packages), so it
    runs with keys 0..SEEDING_KEYS-1: at least SEEDING_MIN must recover
    the partition, each of them with the oracle's mse.  Returns (launches
    by method, the launches at the paper's phase-5 shapes)."""
    from repro_torch.data import make_linear_regression_federation

    fed = make_linear_regression_federation(seed=0)
    erm = paper_federation_erm("cuda")
    res, by_path, rows = {}, {}, []
    for name, method in paper_methods(fed, "cuda"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res[name] = method.fit(0, fed.xs, fed.ys, erm)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(ops)
        by_path[f"4g {name}"] = launches
        r = res[name]
        rows.append({"method": name, "nmse": r.nmse(fed.optima,
                                                    fed.true_labels),
                     "mse": r.mse(fed.optima, fed.true_labels),
                     "comm_rounds": r.comm_rounds,
                     "n_clusters": r.n_clusters, "fit_ms": ms,
                     "true_partition": bool(same_partition(
                         r.labels, fed.true_labels)),
                     "launches": by_variant(launches)})
    oracle = res["oracle-averaging"].mse(fed.optima, fed.true_labels)
    km = res["odcl-kmeans++ restarts 8"]
    check(same_partition(km.labels, fed.true_labels),
          "4g ODCL-KM: not the true partition")

    def oracle_mse(name, r):
        mse = r.mse(fed.optima, fed.true_labels)
        check(abs(mse - oracle) <= 1e-5 * oracle,
              f"4g {name}: mse {mse} != oracle averaging's {oracle}")

    oracle_mse("odcl-kmeans++ restarts 8", km)
    single = dict(paper_methods(fed, "cuda"))["odcl-kmeans++"]
    ops.reset_launch_counts()
    recovered = []
    for key in range(SEEDING_KEYS):
        r = single.fit(key, fed.xs, fed.ys, erm)
        if same_partition(r.labels, fed.true_labels):
            oracle_mse(f"odcl-kmeans++ key {key}", r)
            recovered.append(key)
    by_path[f"4g odcl-kmeans++ keys 0-{SEEDING_KEYS - 1}"] = read_counts(ops)
    check(len(recovered) >= SEEDING_MIN,
          f"4g odcl-kmeans++: {len(recovered)} of {SEEDING_KEYS} keys "
          f"recover the partition, fewer than {SEEDING_MIN}")
    for kernel, names in (("pairwise_sqdist", ("odcl-kmeans++",
                                               "odcl-kmeans++ restarts 8",
                                               "odcl-clusterpath")),
                          ("group_ball_proj", ("odcl-clusterpath",))):
        for name in names:
            check(by_path[f"4g {name}"][kernel] > 0,
                  f"4g {name}: launched no {kernel}")
    print(json.dumps({"paper_methods": {
        "federation": {"m": fed.m, "K": fed.K, "n": fed.n,
                       "d": int(fed.xs.shape[-1]), "D": fed.D},
        "oracle_mse": oracle, "rows": rows,
        "kmeans++_keys_recovered": len(recovered),
        "kmeans++_keys": SEEDING_KEYS,
        "kmeans++_keys_missed": sorted(set(range(SEEDING_KEYS))
                                       - set(recovered)),
        "card": card}}), flush=True)
    # (100, 20) x (<= 10, 20) runs on the stream variant, the fusion test's
    # (100, 20) x (100, 20) on the tiled one; the device Lloyd's assign of
    # the restarts at (100, 20) x (10, 20) on the small one
    odcl = [p for n, p in by_path.items() if n.startswith("4g odcl")]
    return by_path, {
        "paper kmeans++": sum(p["pairwise_sqdist.stream"] for p in odcl),
        "paper fusion": sum(p["pairwise_sqdist.tiled"] for p in odcl),
        "paper lloyd": sum(p["kmeans_assign"] for p in odcl)}


# ------------------------------------------------------------ phase 4j

# examples/quickstart.py's federation: the paper's Section 5 at n = 200
QUICKSTART_N = 200
QUICKSTART_NMSE_RTOL = 1e-4
QUICKSTART_SKETCH = 32


def quickstart_methods(fed, device):
    """examples/quickstart.py's five methods, built from the port's
    package surface, on ``device`` (the quickstart passes none: CUDA)."""
    from repro_torch.core import (
        ODCL, GlobalERM, LocalOnly, OracleAveraging)

    kw = {} if device == "cuda" else {"device": device}
    return [("odcl-kmeans++", ODCL(algorithm="kmeans++", k=10, **kw)),
            ("odcl-clusterpath", ODCL(algorithm="clusterpath",
                                      options=dict(n_lambdas=8, iters=200),
                                      **kw)),
            ("oracle-averaging", OracleAveraging(true_labels=fed.true_labels)),
            ("local-only", LocalOnly()),
            ("global-erm", GlobalERM())]


def quickstart_session(local: torch.Tensor, truth, device: str) -> tuple:
    """One small round through ``repro_torch.core.engine``'s
    ``AggregationSession`` over the quickstart's local models: one
    projection drawn on the CPU for both devices, Lloyd warm-started
    from the first client of each true cluster.  Returns (labels, the
    per-client models, route labels of the models themselves)."""
    from repro_torch.core.engine import AggregationSession
    from repro_torch.core.sketch import jl_projection

    proj = jl_projection(local.shape[1], QUICKSTART_SKETCH, seed=0,
                         device="cpu")
    sess = AggregationSession(local.shape[0], sketch_dim=QUICKSTART_SKETCH,
                              projection=proj, device=device)
    sess.ingest({"theta": local.to(device)})
    firsts = [int(np.flatnonzero(truth == c)[0]) for c in np.unique(truth)]
    state, labels, _ = sess.finalize(
        k=len(firsts), algo_options={"init": "warm",
                                     "init_centers": sess.sketches[firsts]})
    routed = sess.route(sess.sketch_params({"theta": local.to(device)}))
    return labels, state.params["theta"].cpu(), np.asarray(routed)


def phase_public_surface(ops, card: str) -> tuple:
    """Phase 4j: examples/quickstart.py's calls through the port's package
    surface (``from repro_torch.core import ODCL, OracleAveraging,
    LocalOnly, GlobalERM, batched_ridge_erm, list_algorithms``) on the
    card, and the same calls on the CPU with key 0: the paper's
    federation at n = 200, ODCL over kmeans++ (k = 10) and over
    clusterpath (8 rungs of 200 AMA iterations), and the three reference
    methods.  Every method's partition on the card is the CPU's (up to a
    renaming) and its nmse the CPU's within QUICKSTART_NMSE_RTOL, but
    one: ODCL-kmeans++ draws its seeding from each device's own
    generator, so key 0 seeds other rows on the card than on the CPU.
    That method is held card == CPU from each device's seeding instead
    (its key-0 kmeans++ rows, handed to ``kmeans-device`` with
    ``init="warm"``): Lloyd from the CPU's seeds on the card is the CPU
    call, and the card's own key-0 call is the CPU's Lloyd from the
    card's seeds; on each device, Lloyd from its own seeds is its call.
    No gate asks the card's seeding to recover the partition (4g: 0.16
    of the keys land in a local optimum).
    ODCL-clusterpath recovers the true partition with the oracle's mse
    (within 1e-5 relative).  Then one round through
    ``repro_torch.core.engine.AggregationSession`` on both devices: the
    true partition, card == CPU (labels, route labels, models within
    rtol 1e-5).  The card's work launches ``pairwise_sqdist``,
    ``kmeans_assign`` and the unbatched ``group_ball_proj``.  Returns
    those launches."""
    import repro_torch.core as tcore
    from repro_torch.core import ODCL, batched_ridge_erm, list_algorithms
    from repro_torch.core.clustering.kmeans import kmeans_plus_plus_init
    from repro_torch.core.sketch import make_generator
    from repro_torch.data import make_linear_regression_federation

    t0 = time.perf_counter()
    missing = [n for n in tcore.__all__ if not hasattr(tcore, n)]
    check(not missing, f"4j: repro_torch.core lacks {missing}")
    check("clusterpath" in list_algorithms() and "kmeans++"
          in list_algorithms(), "4j: the registry lacks the quickstart's "
          "algorithms")
    fed = make_linear_regression_federation(seed=0, n=QUICKSTART_N)

    def ridge_solver(xs, ys, dev):
        return batched_ridge_erm(torch.as_tensor(xs, device=dev),
                                 torch.as_tensor(ys, device=dev), 1e-8)

    local = ridge_solver(fed.xs, fed.ys, "cpu")
    # each device's key-0 kmeans++ seeding, as ODCL.fit draws it (key 0 ->
    # that device's generator, over that device's local models)
    seeds = {dev: kmeans_plus_plus_init(make_generator(0, dev), ridge_solver(
        fed.xs, fed.ys, dev), 10) for dev in ("cpu", "cuda")}
    res, seeded, sess = {}, {}, {}
    ops.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        def erm(xs, ys, dev=dev):
            return ridge_solver(xs, ys, dev)

        res[dev] = {name: method.fit(0, fed.xs, fed.ys, erm)
                    for name, method in quickstart_methods(fed, dev)}
        # Lloyd from either device's seeding, on this device
        seeded[dev] = {
            by: ODCL(algorithm="kmeans-device", k=10, device=dev,
                     options={"init": "warm",
                              "init_centers": seeds[by].to(dev)}).fit(
                0, fed.xs, fed.ys, erm) for by in ("cpu", "cuda")}
        sess[dev] = quickstart_session(local, fed.true_labels, dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = read_counts(ops)
    rows = []
    compared = {name: (res["cuda"][name], want)
                for name, want in res["cpu"].items()}
    compared["odcl-kmeans++"] = (seeded["cuda"]["cpu"], seeded["cpu"]["cpu"])
    # the card's own key-0 call against the CPU's Lloyd from its seeds
    compared["odcl-kmeans++ card seeding"] = (res["cuda"]["odcl-kmeans++"],
                                              seeded["cpu"]["cuda"])
    for dev in ("cpu", "cuda"):
        check(same_partition(seeded[dev][dev].labels,
                             res[dev]["odcl-kmeans++"].labels),
              f"4j odcl-kmeans++: Lloyd from the {dev} call's seeds is not "
              f"its partition")
    for name, (got, want) in compared.items():
        nmse = (got.nmse(fed.optima, fed.true_labels),
                want.nmse(fed.optima, fed.true_labels))
        check(same_partition(got.labels, want.labels),
              f"4j {name}: the card's partition is not the CPU's")
        check(abs(nmse[0] - nmse[1]) <= QUICKSTART_NMSE_RTOL * abs(nmse[1]),
              f"4j {name}: nmse {nmse[0]} on the card, {nmse[1]} on the CPU")
        rows.append({"method": name, "nmse": nmse[0], "nmse_cpu": nmse[1],
                     "n_clusters": got.n_clusters,
                     "comm_rounds": int(got.comm_rounds),
                     "true_partition": bool(same_partition(
                         got.labels, fed.true_labels))})
    rows[0]["cpu_key0_call_true_partition"] = bool(same_partition(
        res["cpu"]["odcl-kmeans++"].labels, fed.true_labels))
    cp = res["cuda"]["odcl-clusterpath"]
    oracle = res["cuda"]["oracle-averaging"].mse(fed.optima, fed.true_labels)
    check(same_partition(cp.labels, fed.true_labels),
          "4j odcl-clusterpath: not the true partition")
    mse = cp.mse(fed.optima, fed.true_labels)
    check(abs(mse - oracle) <= 1e-5 * oracle,
          f"4j odcl-clusterpath: mse {mse} != oracle averaging's {oracle}")
    for kernel in ("pairwise_sqdist", "kmeans_assign", "group_ball_proj"):
        check(launches[kernel] > 0, f"4j: launched no {kernel}")
    (gl, gp, gr), (cl, cp_, cr) = sess["cuda"], sess["cpu"]
    check(same_partition(gl, fed.true_labels),
          "4j session: not the true partition")
    check(np.array_equal(gl, cl) and np.array_equal(gr, cr),
          "4j session: labels or route labels differ card vs CPU")
    check(np.array_equal(gr, gl), "4j session: a client routes to another "
          "cluster than its own")
    scale = float(cp_.abs().max())
    check(bool(torch.allclose(gp, cp_, rtol=1e-5, atol=1e-5 * scale)),
          "4j session: models differ card vs CPU")
    secs = time.perf_counter() - t0
    print(json.dumps({"public_surface": {
        "federation": {"m": fed.m, "K": fed.K, "n": fed.n},
        "rows": rows, "oracle_mse": oracle,
        "session": {"clients": len(gl), "sketch_dim": QUICKSTART_SKETCH,
                    "true_partition": True},
        "launches": by_variant(launches), "seconds": secs,
        "card": card}}), flush=True)
    print(f"[chip_smoke] 4j public surface (quickstart through "
          f"repro_torch.core, one AggregationSession round): card == CPU "
          f"in {secs:.1f}s", flush=True)
    return launches


# ------------------------------------------------------------ phase 4k

# one attention layer of qwen2-0.5b at full width, bf16, batch 4, a ring
# of capacity 4096 (serve_window 4096): DECODE_WRAP_STEPS steps from a
# carried-over ring at DECODE_WRAP_POS (past the wrap), and
# DECODE_FORCED_STEPS steps from an empty ring against teacher forcing
DECODE_B, DECODE_CAPACITY = 4, 4096
DECODE_WRAP_POS, DECODE_WRAP_STEPS, DECODE_FORCED_STEPS = 4090, 16, 64
# card vs CPU, of the largest magnitude of each step's output and of the
# ring: the two devices round the bf16 projections after summing in other
# orders (one bf16 ulp is 2^-8 relative), and the attention output is
# rounded to bf16 again before ``wo``
DECODE_CARD_CPU_TOL = 2.0 ** -6


def decode_layer(cfg, device):
    """The layer's attention weights (wq, wk, wv, wo and the QKV bias) in
    bf16: normal draws of std fan_in^-1/2 (bias std 0.02) from a CPU
    generator of seed 0, then moved."""
    gen = torch.Generator().manual_seed(0)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    shapes = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d),
              "bq": (hq,), "bk": (hkv,), "bv": (hkv,)}
    out = {}
    for name, shape in shapes.items():
        std = shape[0] ** -0.5 if len(shape) == 2 else 0.02
        out[name] = (torch.randn(shape, generator=gen) * std).to(
            device, torch.bfloat16)
    return out


def run_decode(params, xs, cache, cfg) -> tuple:
    """``decode_attention`` over xs (b, steps, D), one token a step:
    (outputs (b, steps, D), the final cache)."""
    from repro_torch.models.attention import decode_attention

    outs = []
    for t in range(xs.shape[1]):
        out, cache = decode_attention(params, xs[:, t:t + 1], cache, cfg)
        outs.append(out)
    return torch.cat(outs, dim=1), cache


def phase_decode_api(card: str) -> dict:
    """Phase 4k: the reference's one-layer decode API
    (``models.attention.KVCache`` / ``init_kv_cache`` /
    ``decode_attention``) on one attention layer of qwen2-0.5b at full
    width (D 896, 14 heads over 2 KV heads of 64, serve_window 4096),
    bf16, batch 4, a ring of capacity 4096, random weights of seed 0.
    Card == CPU: DECODE_WRAP_STEPS steps from a random ring carried over
    at position DECODE_WRAP_POS (``interop.kv_cache_from_numpy``), which
    pass the wrap, every output and the rings within DECODE_CARD_CPU_TOL
    of their largest magnitude.  Decode == teacher forcing:
    DECODE_FORCED_STEPS steps from an empty ring against the port's
    windowed causal ``attention`` (the flash kernel) over the same K and
    V, within SERVE_BF16_REL_TOL of each position's max |out|.  Both runs
    on the card go under ``torch.cuda.set_sync_debug_mode("error")``: a
    step that reads the position on the host fails (and a host read of
    the final position, made on purpose under the mode, must raise)."""
    import dataclasses
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.interop import kv_cache_from_numpy
    from repro_torch.models import attention as attn
    from repro_torch.models.attention import init_kv_cache

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), dtype="bfloat16")
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator().manual_seed(1)
    ring = [(torch.randn((DECODE_B, hkv, DECODE_CAPACITY, dh), generator=gen)
             .to(torch.bfloat16)) for _ in range(2)]
    xs = (torch.randn((DECODE_B, DECODE_WRAP_STEPS + DECODE_FORCED_STEPS,
                       cfg.d_model), generator=gen)).to(torch.bfloat16)
    wrap_x, forced_x = (xs[:, :DECODE_WRAP_STEPS],
                        xs[:, DECODE_WRAP_STEPS:])
    params = {dev: decode_layer(cfg, dev) for dev in ("cuda", "cpu")}
    # float32 copies hold the bf16 values exactly
    k_np, v_np = (r.float().numpy() for r in ring)
    wrap = {}
    for dev in ("cpu", "cuda"):
        cache = kv_cache_from_numpy(k_np, v_np, DECODE_WRAP_POS, device=dev)
        cache = cache._replace(k=cache.k.to(torch.bfloat16),
                               v=cache.v.to(torch.bfloat16))
        x = wrap_x.to(dev)
        if dev == "cuda":
            # RoPE's angle table reaches the card once, outside the check
            attn.decode_attention(params[dev], x[:, :1], init_kv_cache(
                DECODE_B, hkv, 8, dh, device=dev), cfg)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            wrap[dev] = run_decode(params[dev], x, cache, cfg)
        finally:
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    (g_out, g_cache), (c_out, c_cache) = wrap["cuda"], wrap["cpu"]
    check(int(g_cache.pos) == DECODE_WRAP_POS + DECODE_WRAP_STEPS
          == int(c_cache.pos), "4k: the position after the wrap steps")
    wrap_err = {name: rel_close(f"4k card vs CPU {name}", g, c,
                                DECODE_CARD_CPU_TOL)
                for name, g, c in (("out", g_out, c_out),
                                   ("k ring", g_cache.k, c_cache.k),
                                   ("v ring", g_cache.v, c_cache.v))}
    del wrap, g_cache, c_cache
    cache = init_kv_cache(DECODE_B, hkv, DECODE_CAPACITY, dh, device="cuda")
    x = forced_x.to("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dec, cache = run_decode(params["cuda"], x, cache, cfg)
        # the mode has teeth: reading the position on the host raises
        try:
            int(cache.pos)
            detects = False
        except RuntimeError:
            detects = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(detects, "4k: the sync debug mode let a host read of pos pass")
    view = SimpleNamespace(**params["cuda"])
    q, k, v = attn.qkv_proj(view, x, cfg)
    pos = torch.arange(DECODE_FORCED_STEPS, device="cuda")[None].expand(
        DECODE_B, -1)
    q = attn.rope_transpose(q, pos, cfg.rope_theta)
    k = attn.rope_transpose(k, pos, cfg.rope_theta)
    forced = attn.out_proj(view, attn.attention(q, k, v, causal=True,
                                                window=cfg.serve_window))
    check(bool(torch.isfinite(dec).all()), "4k: decode is not finite")
    rel = rel_err(dec.float(), forced.float())                   # (b, G)
    worst = float(rel.max())
    check(worst <= SERVE_BF16_REL_TOL, f"4k: decode and teacher forcing "
          f"differ by {worst} of the position's max |out|")
    secs = time.perf_counter() - t0
    out = {"arch": SERVE_ARCH, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "kv_heads": hkv, "head_dim": dh,
           "serve_window": cfg.serve_window, "batch": DECODE_B,
           "capacity": DECODE_CAPACITY, "dtype": "bfloat16",
           "wrap": {"from_pos": DECODE_WRAP_POS, "steps": DECODE_WRAP_STEPS,
                    "card_vs_cpu_rel_err": wrap_err,
                    "tolerance": DECODE_CARD_CPU_TOL},
           "teacher_forced": {"steps": DECODE_FORCED_STEPS,
                              "rel_err_max": worst,
                              "rel_err_p50": float(rel.median()),
                              "tolerance": SERVE_BF16_REL_TOL},
           "sync_debug_mode": "error", "host_read_detected": detects,
           "seconds": secs, "card": card}
    print(json.dumps({"decode_api": out}), flush=True)
    print(f"[chip_smoke] 4k decode API (qwen2-0.5b attention, bf16, batch "
          f"{DECODE_B}, ring {DECODE_CAPACITY}): card == CPU past the wrap, "
          f"decode == teacher forcing, no host sync, in {secs:.1f}s",
          flush=True)
    return out


# ------------------------------------------------------------ phase 4h

# the reference driver's LM federation at full width: qwen2-0.5b, bf16
# parameters, fp32 AdamW moments, 8 clients in 2 clusters, batch 4, seq 64,
# sketch 128 (``launch/train.py``'s defaults); the local steps cut from
# 100 to 20 and the post steps from 20 to 2 to bound the time
LM_CLIENTS, LM_CLUSTERS, LM_FULL_BATCH, LM_FULL_SEQ = 8, 2, 4, 64
LM_FULL_SKETCH, LM_ROUTE_SKETCH = 128, 64
LM_RUN1 = ["--method", "odcl", "--engine", "device", "--algo", "kmeans++",
           "--local-steps", "20", "--post-steps", "2"]
LM_RUN2 = ["--method", "ifca", "--ifca-assign", "sketch", "--rounds", "2",
           "--local-steps", "2"]
LM_PROMPT, LM_GEN = 64, 4


def lm_losses_finite(name: str, losses) -> None:
    check(losses and all(np.isfinite(x) for x in losses),
          f"4h {name}: losses {losses}")


def phase_lm_train(ops, card: str, keep_dir: str | None = None) -> tuple:
    """Phase 4h: ``launch.train`` at full width, then the route to a
    cluster model and its prefill.

    Run 1 (ODCL, the device engine, kmeans++): every loss finite, the last
    local loss below the first, K' = 2, the comm bytes
    ``sketch_round_bytes``, kmeans_assign and pairwise_sqdist launched.
    Then ``serve.route_from_checkpoint`` over the trained stack in memory
    (sketch 64): the served model must equal ``cluster_mean_tree`` of its
    members' slices bit for bit, and its prefill must launch the flash
    kernel once a layer.  Run 2 (IFCA, sketch assignment, 2 rounds):
    losses finite, kmeans_assign launched.  Purity, local-step p50,
    tokens/s, the round ms and the peak memory are printed, not gated.
    With ``keep_dir``, each run's record (``lm_run``: labels, every
    client's losses, the round's and the final models) goes to a file
    there on the host for phase 7d, run 1's with one ODCL round of
    ``engine="host"`` on its trained state.  Returns (launches by path,
    the launches at the LM phase-5 shapes)."""
    from repro_torch import obs
    from repro_torch.core.federated import (
        params_bytes_per_client, sketch_round_bytes)

    total = torch.cuda.get_device_properties(0).total_memory
    tokens = LM_CLIENTS * LM_FULL_BATCH * LM_FULL_SEQ
    by_path, rows = {}, {}
    torch.cuda.empty_cache()
    for name, argv in (("odcl", LM_RUN1), ("ifca", LM_RUN2)):
        obs.reset()
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        out, rec = lm_run(argv)
        wall = out["wall_s"]
        by_path[f"4h {name}"] = launches = read_counts(ops)
        res, cfg = out["result"], out["cfg"]
        snap = obs.snapshot()
        step = snap["histograms"]["fed.local_step.ms"]
        peak = torch.cuda.max_memory_allocated()
        check(peak < total, f"4h {name}: peak memory {peak} >= {total}")
        row = {"purity": out["purity"], "n_clusters": res.n_clusters,
               "labels": np.asarray(res.labels).tolist(),
               "comm_bytes": res.comm_bytes,
               "local_step_p50_ms": step["p50"],
               "local_steps": step["count"],
               "tokens_per_s": tokens / (step["p50"] / 1e3),
               "round_ms": [r["round_ms"] for r in res.round_metrics
                            if "round_ms" in r],
               "eval_loss_mean": float(np.mean(out["eval_loss"])),
               "wall_s": wall, "peak_memory_bytes": peak,
               "launches": by_variant(launches)}
        if name == "odcl":
            local, _, post = res.round_metrics
            lm_losses_finite(name, local["losses"] + post["losses"])
            check(local["losses"][-1] < local["losses"][0],
                  f"4h odcl: last local loss {local['losses'][-1]} not "
                  f"below the first {local['losses'][0]}")
            check(res.n_clusters == LM_CLUSTERS, f"4h odcl: K' = "
                  f"{res.n_clusters}")
            want = sketch_round_bytes(LM_CLIENTS, LM_FULL_SKETCH,
                                      params_bytes_per_client(res.state))
            check(res.comm_bytes == want,
                  f"4h odcl: comm bytes {res.comm_bytes} != {want}")
            for kernel in ("kmeans_assign", "pairwise_sqdist"):
                check(launches[kernel] > 0, f"4h odcl: no {kernel} launch")
            row.update(loss_first=local["losses"][0],
                       loss_last=local["losses"][-1],
                       post_loss_last=post["losses"][-1])
            rows[name] = row
            if keep_dir is not None:
                rec["host"] = lm_host_round(res.state, cfg)
                row["host_round_s"] = rec["host"]["seconds"]
            params = res.state.params
            del out, res              # the fp32 moments go with them
            torch.cuda.empty_cache()
            rows["route"] = phase_lm_route(ops, cfg, params, by_path)
            del params
            torch.cuda.empty_cache()
        if keep_dir is not None:
            rec["local_step_p50_ms"] = step["p50"]
            t0 = time.perf_counter()
            torch.save(rec, Path(keep_dir) / f"{name}.pt")
            row["kept_s"] = time.perf_counter() - t0
        del rec
        if name != "odcl":
            lm_losses_finite(name, [x for r in res.round_metrics
                                    for x in r["losses"]])
            check(launches["kmeans_assign"] > 0, "4h ifca: no kmeans_assign")
            row["loss_last"] = res.round_metrics[-1]["loss_last"]
            rows[name] = row
            del out, res
            torch.cuda.empty_cache()
    print(json.dumps({"lm_train": {
        "arch": SERVE_ARCH, "dtype": "bfloat16", "clients": LM_CLIENTS,
        "clusters": LM_CLUSTERS, "batch": LM_FULL_BATCH,
        "seq": LM_FULL_SEQ, "sketch_dim": LM_FULL_SKETCH,
        "run1": " ".join(LM_RUN1), "run2": " ".join(LM_RUN2),
        "card_memory_bytes": total, "card": card, **rows}}), flush=True)
    return by_path, {
        "lm": by_path["4h odcl"]["kmeans_assign"]
        + by_path["4h ifca"]["kmeans_assign"],
        "lm kmeans++": by_path["4h odcl"]["pairwise_sqdist"]}


def phase_lm_route(ops, cfg, params, by_path: dict) -> dict:
    """4h's serving side: route client 0 of the trained stack to a cluster
    model through the session (sketch 64), hold the model to
    ``cluster_mean_tree`` of its members bit for bit, and prefill it."""
    from repro_torch.core.federated import cluster_mean_tree
    from repro_torch.launch.serve import generate, route_from_checkpoint
    from repro_torch.models.transformer import model_view
    from repro_torch.utils import tree_leaves

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, cid, info = route_from_checkpoint(
        params, cfg, 0, algorithm="kmeans-device", clusters=LM_CLUSTERS,
        sketch_dim=LM_ROUTE_SKETCH, device="cuda")
    torch.cuda.synchronize()
    route_s = time.perf_counter() - t0
    labels = torch.as_tensor(info["labels"], device="cuda").long()
    onehot = torch.nn.functional.one_hot(labels, info["n_clusters"]).float()
    want = cluster_mean_tree(params, onehot, onehot.sum(0))
    for got, w in zip(tree_leaves(model), tree_leaves(want)):
        check(got.dtype == w.dtype and torch.equal(got, w[cid]),
              "4h route: the served model is not its cluster's mean")
    del want
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (LM_FULL_BATCH, LM_PROMPT),
                            generator=gen, device="cuda")
    toks, stats = generate(model_view(model, cfg), cfg, prompts, LM_GEN,
                           device="cuda")
    launches = read_counts(ops)
    by_path["4h route + prefill"] = launches
    check(launches["flash_attention"] == cfg.n_layers,
          f"4h route: {launches['flash_attention']} flash launches in the "
          f"prefill, not {cfg.n_layers}")
    check(launches["kmeans_assign"] > 0, "4h route: no kmeans_assign")
    check(toks.shape == (LM_FULL_BATCH, LM_PROMPT + LM_GEN),
          f"4h route: tokens {tuple(toks.shape)}")
    return {"client": 0, "cluster": cid,
            "labels": np.asarray(info["labels"]).tolist(),
            "members": int((labels == cid).sum()),
            "route_s": route_s, "prefill_ms": stats["prefill_s"] * 1e3,
            "launches": by_variant(launches)}


def ptxas_instances(usage: dict) -> dict:
    """ptxas registers and spill bytes by kernel instance, keyed by a
    readable name (``flash_attention_tc<1,128>``) in place of the mangled
    one."""
    named = {}
    for mangled, info in usage.items():
        found = re.search(r"(flash_attention_(?:tc|kernel))I((?:Li\d+E)+)E",
                          mangled)
        if found:
            args = ",".join(re.findall(r"Li(\d+)E", found.group(2)))
            named[f"{found.group(1)}<{args}>"] = info
    return named


def flash_kernel_row(flash, card: str) -> dict:
    """Phase 5's flash_attention row at the serving shape: the tensor-core
    kernel on all 4 batch rows, the CUDA-core kernel on the same inputs in
    fp32, the plain version on batch row 0 (its fp32 logits would need
    15 GB at 4), ``scaled_dot_product_attention`` with the same band mask
    as the library yardstick.  Bound: 4 dh flop for each live (q, k) pair
    at the bf16 tensor cores' rate (which compute a bf16 product exactly
    in fp32) against q, k, v and o moved once; the split of P into two
    bf16 terms is the design's cost and not counted."""
    from repro_torch.kernels import _build
    from repro_torch.roofline import HW_H100, HW_H100_FP32, kernel_costs

    b, s, w, dh, h, hkv = SERVE_B, SERVE_PROMPT, 4096, 64, 14, 2
    q, k, v = attn_inputs(500, b, hkv, h // hkv, s, s, dh, torch.bfloat16)
    pos = torch.arange(s, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
    live = kernel_costs.flash_live_pairs(s, s, True, w)
    check(live == int(band.sum()), f"flash live pairs {live} != the band's")
    cost = kernel_costs.flash_attention(b, h, hkv, s, s, dh, causal=True,
                                        window=w, itemsize=2)
    nbytes, flops = cost
    b_ms, b_by = bound(cost, HW_H100)
    kern = device_time(lambda: flash.flash_attention(q, k, v, causal=True,
                                                     window=w), reps=10)
    qf, kf, vf = (t.float() for t in (q, k, v))
    fp32 = device_time(lambda: flash.flash_attention(
        qf, kf, vf, causal=True, window=w), reps=3)
    del qf, kf, vf
    plain_ms = device_time(lambda: flash.flash_attention_ref(
        q[:1], k[:1], v[:1], causal=True, window=w), reps=3)["ms"]
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_time(lambda: sdpa(qc, kc, vc, attn_mask=band,
                                          enable_gqa=True), reps=10)["ms"]
    lib_diff = float((sdpa(qc[:1], kc[:1], vc[:1], attn_mask=band,
                           enable_gqa=True).float()
                      - flash.flash_attention_ref(q[:1], k[:1], v[:1],
                                                  causal=True, window=w)
                      .float()).abs().max())
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:75",
            "launches": None, "max_abs_err": None, "ms": kern["ms"],
            "call_ms": kern["call_ms"], "ms_fp32_kernel": fp32["ms"],
            "call_ms_fp32_kernel": fp32["call_ms"],
            "design": "wgmma+TMA, split-P",
            "ptxas": ptxas_instances(_build.ptxas_usage("flash_attention")),
            "plain_ms": plain_ms, "plain_rows": 1,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_ms_fp32_cuda_cores": bound(cost, HW_H100_FP32)[0],
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention(attn_mask=band, "
                       "enable_gqa=True)",
            "library_max_abs_diff": lib_diff,
            "live_pairs_per_head": live, "flop": flops, "bytes": nbytes,
            "shape": f"q {tuple(q.shape)} x kv {tuple(k.shape)} bf16, "
                     f"causal, window {w}", "card": card}


# ------------------------------------------------- phase 2 (families)

# the flash kernel at the model families' full-width prefill shapes:
# (class, b, hkv, rep, s, dh, window, causal) of deepseek-moe-16b (its
# serve window 4096 over a prompt of 8192), hymba-1.5b (window 1024),
# pixtral-12b (window 4096 at 4096 tokens) and the hubert-xlarge encoder
FAMILY_FLASH = [("deepseek-moe-16b prefill", 4, 16, 1, 8192, 128, 4096, True),
                ("hymba-1.5b prefill", 4, 5, 5, 8192, 64, 1024, True),
                ("pixtral-12b prefill", 1, 8, 4, 4096, 128, 4096, True),
                ("hubert-xlarge forward", 4, 16, 1, 4096, 80, None, False)]


def phase_family_flash(flash) -> float:
    """Phase 2: the kernel against its plain version at the families'
    shapes, bf16, batch row 0 (the plain version's fp32 logits), two
    launches each (the second bit-identical)."""
    worst = 0.0
    for i, (cls, b, hkv, rep, s, dh, window, causal) in enumerate(
            FAMILY_FLASH):
        q, k, v = attn_inputs(600 + i, b, hkv, rep, s, s, dh, torch.bfloat16)
        err = compare_flash(flash, q, k, v, causal, window, rows=1)
        worst = max(worst, err)
        print(f"[chip_smoke] flash_attention at the {cls} shape "
              f"{tuple(q.shape)} x {tuple(k.shape)} bf16, causal={causal}, "
              f"window {window}: max abs err {err:.3g} (batch row 0)",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return worst


# ------------------------------------------------------------ phase 3g

# the model families, card vs CPU: each config reduced to 2 layers (the
# xLSTM to one m + s pair), d_model 512 at most, vocab 1024, fp32, the
# port's init from seed 1 on the CPU, copied to the card; deepseek-moe-16b
# keeps 8 experts (top 6), so routing chooses; xlstm-125m runs its mLSTM
# in chunks of 16 and hymba-1.5b its SSM in chunks of 16 (the chunked
# paths); a forward over 32 tokens, a prefill over 32 and 8 decode steps
FAMILY_ARCHS = ("deepseek-moe-16b", "grok-1-314b", "xlstm-125m",
                "hymba-1.5b", "hubert-xlarge", "pixtral-12b")
FAM_SEQ, FAM_PROMPT, FAM_GEN, FAM_PATCHES = 32, 32, 8, 6
# the input seeds (forward, loss, prefill): each keeps every top-k margin
# of the reduced MoE configs above ROUTER_MARGIN on the CPU, which the
# phase checks: a router whose k-th and (k+1)-th probabilities lie within
# rounding of each other may choose another expert on the card
FAM_SEEDS = (5, 8, 9)
ROUTER_MARGIN = 1e-4
# the MoE round card vs CPU: the 3g deepseek config, C = 4 clients planted
# in 2 clusters (inits from seeds 0 and 1 plus 1e-2 noise, CPU draws), one
# JL projection for both devices; then launch.train on the card (the
# launch.train's --reduced deepseek-moe-16b: 4 experts, top 4, two shared)
FAM_ROUND_SKETCH = 32
FAM_TRAIN = ["--arch", "deepseek-moe-16b", "--reduced", "--clients", "4",
             "--clusters", "2", "--local-steps", "8", "--post-steps", "1",
             "--seq-len", "32", "--batch", "4", "--lr", "3e-3",
             "--sketch-dim", "64", "--method", "odcl", "--engine", "device"]


class RouterLog:
    """While active, hands each MoE router call's (probs, top-k ids, k) to
    ``record`` and, with ``force``, routes by the ids that ``force(probs,
    ids, k)`` returns (the weights then the call's own probabilities at
    those ids).  It wraps ``models.moe.route``: chip_smoke's own
    instrument; the package computes nothing for it."""

    def __init__(self, record=None, force=None):
        self.record, self.force = record, force

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe.route

        def routed(x, router, k):
            probs, topv, topi = self.route(x, router, k)
            if self.record is not None:
                self.record(probs.detach(), topi, k)
            if self.force is not None:
                topi = self.force(probs.detach(), topi, k)
                topv = torch.gather(probs, -1, topi)
            return probs, topv, topi

        moe.route = routed
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def topk_margins(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest probability less the (k+1)-th, per token."""
    if k >= probs.shape[-1]:
        return torch.full(probs.shape[:-1], float("inf"),
                          device=probs.device)
    top = torch.topk(probs.float(), k + 1, dim=-1).values
    return top[..., k - 1] - top[..., k]


def family_small_cfg(arch: str):
    import dataclasses

    from repro_torch.configs import get_config

    kw = {"max_experts": 8} if arch == "deepseek-moe-16b" else {}
    return dataclasses.replace(get_config(arch).reduced(**kw),
                               mlstm_chunk=16, ssm_chunk=16)


def family_inputs(cfg, seed: int, s: int, b: int = 2) -> dict:
    """CPU inputs for ``cfg``'s input mode, from numpy: tokens and
    next-token labels; audio frames with a 30 % frame mask and codebook
    labels; tokens with FAM_PATCHES patch embeddings at distinct
    positions within the first FAM_PROMPT."""
    from repro_torch.models.transformer import FRONTEND_DIM, PATCH_DIM

    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)))
    if cfg.input_mode == "embeddings":
        return {"frames": torch.from_numpy(rng.normal(
                    size=(b, s, FRONTEND_DIM)).astype(np.float32)),
                "mask": torch.from_numpy(rng.random((b, s)) < 0.3),
                "labels": toks[:, :s]}
    batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
    if cfg.input_mode == "multimodal":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(b, FAM_PATCHES, PATCH_DIM)).astype(np.float32))
        batch["patch_positions"] = torch.from_numpy(np.stack(
            [rng.permutation(FAM_PROMPT)[:FAM_PATCHES] for _ in range(b)]))
    return batch


def rel_close(name: str, got: torch.Tensor, want: torch.Tensor,
              tol: float = FP32_REL_TOL) -> float:
    """Card vs CPU: max |got - want| within ``tol`` of max |want|."""
    want = want.detach().float()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.detach().float().cpu() - want).abs().max()) / scale
    check(err <= tol, f"{name}: off by {err} of the largest magnitude "
          f"(tolerance {tol})")
    return err


def family_card_vs_cpu(arch: str) -> dict:
    """3g for one config: forward (logits, aux), the loss and its
    gradients, and (causal) the prefill with 8 decode steps."""
    import copy

    from repro_torch.models import decode_step, init_params
    from repro_torch.models.transformer import (
        forward, prefill_with_cache, train_loss, tree_from_model)
    from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map

    cfg = family_small_cfg(arch)
    cpu = init_params(cfg, seed=1, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    margins = []

    def record(probs, topi, k):
        margins.append(float(topk_margins(probs, k).min()))

    def on(dev, batch):
        return {k: v.to(dev) for k, v in batch.items()}

    seed_fwd, seed_loss, seed_pre = FAM_SEEDS
    errs = {}
    batch = family_inputs(cfg, seed_fwd, FAM_SEQ)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.inference_mode():
        with RouterLog(record):
            want, waux = forward(cpu, cfg, inputs)
        got, gaux = forward(card, cfg, on("cuda", inputs))
    errs["forward"] = rel_close(f"3g {arch} forward", got, want)
    check(abs(float(gaux) - float(waux)) <= 1e-5 * abs(float(waux)),
          f"3g {arch}: aux {float(gaux)} vs {float(waux)}")
    losses = {}
    grads = {}
    batch = family_inputs(cfg, seed_loss, FAM_SEQ)
    for dev, model in (("cpu", cpu), ("cuda", card)):
        live = tree_map(lambda l: l.detach().clone().requires_grad_(True),
                        tree_from_model(model))
        with RouterLog(record if dev == "cpu" else
                       (lambda *a: None)):
            loss = train_loss(live, cfg, on(model.embed.device, batch))
        losses[dev] = float(loss)
        grads[dev] = torch.autograd.grad(loss, tree_leaves(live),
                                         allow_unused=True,
                                         materialize_grads=True)
        paths = [p for p, _ in tree_leaves_with_path(live)]
    check(abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"]),
          f"3g {arch}: loss {losses['cuda']} vs {losses['cpu']}")
    errs["grads"] = max(rel_close(f"3g {arch} grad {p}", g, w)
                        for p, g, w in zip(paths, grads["cuda"],
                                           grads["cpu"]))
    if cfg.causal:
        batch = family_inputs(cfg, seed_pre, FAM_PROMPT + FAM_GEN)
        prompt = {k: v[:, :FAM_PROMPT] if k == "tokens" else v
                  for k, v in batch.items() if k != "labels"}
        cap = FAM_PROMPT + FAM_GEN
        with torch.inference_mode():
            with RouterLog(record):
                want, wc = prefill_with_cache(cpu, cfg, prompt, capacity=cap)
            got, gc = prefill_with_cache(card, cfg, on("cuda", prompt),
                                         capacity=cap)
            errs["prefill"] = rel_close(f"3g {arch} prefill", got, want)
            toks = batch["tokens"]
            for t in range(FAM_PROMPT, cap):
                with RouterLog(record):
                    want, wc = decode_step(cpu, cfg, wc, toks[:, t:t + 1])
                got, gc = decode_step(card, cfg, gc,
                                      toks[:, t:t + 1].cuda())
                errs["decode"] = max(errs.get("decode", 0.0), rel_close(
                    f"3g {arch} decode {t}", got, want))
            for name in wc.layers[0]:
                errs[f"cache {name}"] = max(
                    rel_close(f"3g {arch} cache {name}", g[name], w[name])
                    for g, w in zip(gc.layers, wc.layers))
    least = min(margins, default=None)
    check(least is None or least > ROUTER_MARGIN,
          f"3g {arch}: a router top-k margin {least} within {ROUTER_MARGIN}")
    return {"config": f"{cfg.name} reduced: {cfg.n_layers} layers, d "
                      f"{cfg.d_model}, vocab {cfg.vocab_size}, fp32"
                      + (f", {cfg.n_experts} experts top {cfg.top_k}"
                         if cfg.is_moe else ""),
            "max_rel_err": errs, "loss": losses["cpu"],
            "min_router_margin": least}


def planted_moe_state(cfg, device):
    """Clients 0-1: the init of seed 0 plus 1e-2 normal noise, clients
    2-3: seed 1 plus noise (CPU draws, then moved)."""
    from repro_torch.core.federated import FederatedState
    from repro_torch.models.transformer import init_tree
    from repro_torch.utils import tree_map

    a, b = (init_tree(cfg, seed=s, device="cpu") for s in (0, 1))
    gen = torch.Generator().manual_seed(2)
    params = tree_map(lambda la, lb: (
        torch.stack([la, la, lb, lb])
        + 1e-2 * torch.randn((4,) + tuple(la.shape), generator=gen)
    ).to(device), a, b)
    return FederatedState(params, None, 4)


def moe_hierarchical_round(ops, cfg, proj, flat_means) -> dict:
    """Phase 3g's planted MoE round through the two-level round,
    ``hierarchical_one_shot_aggregate(state, cfg, shards=2)``, on the card
    and on the CPU, with the projection of the router-invariant values
    alone: each shard session gets ``cfg`` and so sketches only those
    leaves (a shard that sketched every leaf would refuse the
    projection).  Gates: the planted partition on both devices, the
    means card == CPU and equal to the flat round's (``flat_means``, the
    card's) within rtol 1e-5, kmeans_assign and pairwise_sqdist
    launched.  Prints its seconds."""
    from repro_torch.core.engine import hierarchical_one_shot_aggregate
    from repro_torch.utils import tree_leaves

    t0 = time.perf_counter()
    out = {}
    for dev in ("cuda", "cpu"):
        if dev == "cuda":
            ops.reset_launch_counts()
        new, labels, info = hierarchical_one_shot_aggregate(
            planted_moe_state(cfg, dev), cfg, shards=2, k=2,
            sketch_dim=FAM_ROUND_SKETCH, projection=proj.to(dev),
            device=dev)
        out[dev] = (np.asarray(labels), new.params, info)
        if dev == "cuda":
            launches = read_counts(ops)
    for dev, (labels, _, info) in out.items():
        check(info["shards"] == 2 and same_partition(labels, [0, 0, 1, 1]),
              f"3g hierarchical MoE round on {dev}: partition {labels} "
              f"over {info['shards']} shards is not the planted one")
    card_cpu = max(rel_close("3g hierarchical MoE round means", g, w, 1e-5)
                   for g, w in zip(tree_leaves(out["cuda"][1]),
                                   tree_leaves(out["cpu"][1])))
    vs_flat = max(rel_close("3g hierarchical vs flat MoE round", g,
                            w.cpu(), 1e-5)
                  for g, w in zip(tree_leaves(out["cuda"][1]),
                                  tree_leaves(flat_means)))
    for kernel in ("kmeans_assign", "pairwise_sqdist"):
        check(launches[kernel] > 0, f"3g hierarchical MoE round: no {kernel}")
    secs = time.perf_counter() - t0
    print(f"[chip_smoke] 3g hierarchical MoE round (shards 2, the "
          f"router-invariant sketch): card == CPU == the flat round in "
          f"{secs:.1f}s", flush=True)
    return {"shards": 2, "partition": out["cuda"][0].tolist(),
            "per_shard_clusters": out["cuda"][2]["per_shard_clusters"],
            "means_max_rel_err": card_cpu,
            "vs_flat_max_rel_err": vs_flat,
            "launches": by_variant(launches), "seconds": secs}


def phase_families_card_vs_cpu(ops) -> dict:
    """Phase 3g: every new family on the card against the same model on
    the CPU (fp32, tolerance FP32_REL_TOL of the largest magnitude for
    logits, caches and each gradient leaf; losses and the aux loss within
    rtol 1e-5); the one-shot round of a planted MoE federation (the
    router-invariant sketch through one projection, kmeans-device, the
    cluster means) on both devices: the planted partition on both and
    the means within rtol 1e-5; then ``launch.train`` of a MoE
    federation on the card: finite losses, K' = 2, kmeans_assign and
    pairwise_sqdist launched.  Returns that run's launches."""
    from repro_torch.core.federated import one_shot_aggregate
    from repro_torch.core.sketch import jl_projection, sketch_leaves
    from repro_torch.core.federated import _leaf_filter_for
    from repro_torch.launch import train as ttrain
    from repro_torch.utils import tree_leaves

    rows = {arch: family_card_vs_cpu(arch) for arch in FAMILY_ARCHS}
    cfg = family_small_cfg("deepseek-moe-16b")
    n = sum(l[0].numel() for l in sketch_leaves(
        planted_moe_state(cfg, "cpu").params, _leaf_filter_for(cfg)))
    proj = jl_projection(n, FAM_ROUND_SKETCH, seed=0, device="cpu")
    parts = {}
    for dev in ("cuda", "cpu"):
        if dev == "cuda":
            ops.reset_launch_counts()
        new, labels, _ = one_shot_aggregate(
            planted_moe_state(cfg, dev), cfg, algorithm="kmeans-device", k=2,
            sketch_dim=FAM_ROUND_SKETCH, engine="device",
            projection=proj.to(dev), device=dev)
        parts[dev] = (np.asarray(labels), new.params)
        if dev == "cuda":
            round_launches = read_counts(ops)
    for dev, (labels, _) in parts.items():
        check(same_partition(labels, [0, 0, 1, 1]),
              f"3g MoE round on {dev}: partition {labels} is not the "
              "planted one")
    round_err = max(rel_close("3g MoE round means", g, w, 1e-5)
                    for g, w in zip(tree_leaves(parts["cuda"][1]),
                                    tree_leaves(parts["cpu"][1])))
    for kernel in ("kmeans_assign", "pairwise_sqdist"):
        check(round_launches[kernel] > 0, f"3g MoE round: no {kernel}")
    rows["moe round"] = {"sketched_values": n, "sketch_dim":
                         FAM_ROUND_SKETCH, "partition": parts["cuda"][0]
                         .tolist(), "means_max_rel_err": round_err,
                         "launches": by_variant(round_launches)}
    rows["moe hierarchical round"] = moe_hierarchical_round(
        ops, cfg, proj, parts["cuda"][1])
    ops.reset_launch_counts()
    out = ttrain.train(FAM_TRAIN)
    launches = read_counts(ops)
    res = out["result"]
    losses = [x for r in res.round_metrics for x in r.get("losses", [])]
    lm_losses_finite("3g MoE train", losses)
    check(res.n_clusters == 2, f"3g MoE train: K' = {res.n_clusters}")
    for kernel in ("kmeans_assign", "pairwise_sqdist"):
        check(launches[kernel] > 0, f"3g MoE train: no {kernel}")
    rows["moe train"] = {"argv": " ".join(FAM_TRAIN),
                         "labels": np.asarray(res.labels).tolist(),
                         "purity": out["purity"],
                         "loss_first": losses[0], "loss_last": losses[-1],
                         "launches": by_variant(launches)}
    print(json.dumps({"families_card_vs_cpu": rows}), flush=True)
    return launches


# ------------------------------------------------------------ phase 4i

# the families at full width, bf16, random weights from seed 0: the three
# served through serve.generate at phase 4c's batch and prompt, 32 tokens
FAMILY_SERVE = ("deepseek-moe-16b", "hymba-1.5b", "xlstm-125m")
FAMILY_GEN = 32
PIXTRAL_S, PIXTRAL_PATCHES = 4096, 256
HUBERT_B, HUBERT_S, HUBERT_MASK = 4, 4096, 0.15


# the xLSTM's decode vs prefill in fp32: 12 layers of fp32 rounding in
# other summation orders (the chunkwise mLSTM against its recurrence)
XLSTM_TOL = 1e-3


def no_drop(cfg):
    """The MoE config with capacity_factor E / k: an expert's capacity is
    then at least the sequence, so no token is dropped."""
    import dataclasses

    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def drop_shares(cfg, s: int) -> tuple:
    """(a recorder for RouterLog, the list it fills): per router call over
    ``s`` tokens, the share of (token, choice) pairs that the dispatch
    drops (past an expert's per-sequence capacity)."""
    from repro_torch.models.moe import capacity

    shares = []

    def record(probs, topi, k):
        b, n, _ = topi.shape
        if n != s:
            return
        counts = torch.zeros((b, cfg.n_experts), dtype=torch.long,
                             device=topi.device)
        counts.scatter_add_(1, topi.reshape(b, -1),
                            torch.ones_like(topi.reshape(b, -1)))
        over = torch.clamp_min(counts - capacity(n, cfg), 0).sum()
        shares.append(over / (b * n * k))

    return record, shares


class ForcedRouting:
    """A ``RouterLog`` force for ``teacher_forced`` and ``negated_decode``
    on the serve path: the prompt prefill's last position and each
    decode step take the top-k experts that the one long prefill chose
    at that position (``ids``: per layer (b, G, k)); the long prefill
    itself routes freely.  ``natural`` keeps, per (layer, position), the
    serve path's own choice and probabilities."""

    def __init__(self, ids: list):
        self.ids, self.n_layers = ids, len(ids)
        self.prompt_calls = self.step_calls = 0
        self.natural = {}

    def __call__(self, probs, topi, k):
        n = probs.shape[1]
        if n == SERVE_PROMPT:
            layer, g = self.prompt_calls % self.n_layers, 0
            self.prompt_calls += 1
            forced = topi.clone()
            forced[:, -1:] = self.ids[layer][:, :1]
        elif n == 1:
            layer = self.step_calls % self.n_layers
            g = 1 + self.step_calls // self.n_layers
            self.step_calls += 1
            forced = self.ids[layer][:, g:g + 1]
        else:
            return topi
        self.natural[layer, g] = (topi[:, -1], probs[:, -1])
        return forced


def moe_routing(model, cfg, tokens: torch.Tensor) -> tuple:
    """The one long prefill of ``teacher_forced`` (all tokens but the
    last), recording per layer the top-k ids and probabilities at the G
    compared positions: (ids, probs), lists of (b, G, k) and (b, G, E)."""
    from repro_torch.models.transformer import prefill_with_cache

    n_gen = tokens.shape[1] - SERVE_PROMPT
    at = slice(SERVE_PROMPT - 1, SERVE_PROMPT - 1 + n_gen)
    ids, probs = [], []

    def record(p, topi, k):
        ids.append(topi[:, at])
        probs.append(p[:, at])

    with RouterLog(record=record):
        prefill_with_cache(model, cfg, {"tokens": tokens[:, :-1]})
    return ids, probs


def family_gate(model, cfg, tokens: torch.Tensor) -> dict:
    """Every decode step's logits against one teacher-forced prefill
    (``teacher_forced``) within SERVE_BF16_REL_TOL of the position's max
    |logit|, and a decode from negated layer-0 values outside it.

    A MoE model runs the check with ``no_drop(cfg)`` on batch row 0
    (capacity is per sequence, so the serve path's prefill drops tokens
    that decode never drops) and with the serve path routed as the long
    prefill routes (``ForcedRouting``): bf16 rounding moves the router's
    probabilities between the two paths by more than the top-k margin at
    most positions of a random-weight model, and a swapped expert moves
    that position's logits well past the tolerance (deepseek-moe-16b on
    an H100: experts swapped at 29 of 32 positions, logits apart by up to
    0.26 of the max |logit|).  The serve path's own routing is compared with the prefill's
    and printed: the positions with an expert swapped in some layer, the
    probability drift and the margins, and the rel. error of the same
    check routed freely.

    The xLSTM's check runs on an fp32 copy of its weights, within
    XLSTM_TOL; the bf16 run's errors are printed.  In bf16 the two paths'
    states part by a few percent a step (the gates' exponentials magnify
    one-ulp differences, and six layers carry them on) and the logits by
    up to 0.65 of the max |logit| over 31 steps (on an H100), while in
    fp32 they agree to rounding."""
    import copy
    import dataclasses

    from repro_torch.models.transformer import n_stack

    out = {}
    tol = SERVE_BF16_REL_TOL
    if cfg.is_moe:
        cfg, tokens = no_drop(cfg), tokens[:1]
        ids, probs = moe_routing(model, cfg, tokens)
        forced = ForcedRouting(ids)
        with RouterLog(force=forced):
            dec, at = teacher_forced(model, cfg, tokens)
        n_gen = at.shape[1]
        nat_ids = torch.stack([torch.stack([forced.natural[l, g][0]
                                            for g in range(n_gen)], 1)
                               for l in range(n_stack(cfg))])   # (L,b,G,k)
        nat_probs = torch.stack([torch.stack([forced.natural[l, g][1]
                                              for g in range(n_gen)], 1)
                                 for l in range(n_stack(cfg))])
        swapped = (nat_ids.sort(-1).values
                   != torch.stack(ids).sort(-1).values).any(-1)  # (L,b,G)
        drift = (nat_probs - torch.stack(probs)).abs().amax(-1)
        margin = topk_margins(torch.stack(probs), cfg.top_k)
        free, _ = teacher_forced(model, cfg, tokens)
        free_rel = rel_err(free, at)
        out.update(routing="forced to the long prefill's top-k",
                   positions_with_a_swap=int(swapped.any(0).sum()),
                   swaps=int(swapped.sum()),
                   swaps_by_layer=swapped.sum((1, 2)).tolist(),
                   router_drift_p50=float(drift.median()),
                   router_drift_max=float(drift.max()),
                   router_margin_p50=float(margin.median()),
                   router_margin_min=float(margin.min()),
                   free_routing_rel_err_max=float(free_rel.max()),
                   free_routing_rel_err_p50=float(free_rel.median()))
        del free
        negate = RouterLog(force=ForcedRouting(ids))
    else:
        # whole chunks: the xLSTM's mLSTM takes nothing else, and the SSM
        # scans a length that is not a multiple of its chunk in one piece
        pad_to = {"xlstm": cfg.mlstm_chunk,
                  "hybrid": cfg.ssm_chunk}.get(cfg.block_pattern, 1)
        dec, at = teacher_forced(model, cfg, tokens, pad_to=pad_to)
        negate = contextlib.nullcontext()
        if cfg.block_pattern == "xlstm":
            model = copy.deepcopy(model).float()
            cfg, tol = dataclasses.replace(cfg, dtype="float32"), XLSTM_TOL
            free_rel = rel_err(dec, at)
            out.update(check_dtype="float32 (a copy of the bf16 weights)",
                       bf16_rel_err_max=float(free_rel.max()),
                       bf16_rel_err_p50=float(free_rel.median()),
                       bf16_rel_err_by_step=free_rel.amax(0).tolist())
            dec, at = teacher_forced(model, cfg, tokens, pad_to=pad_to)
    check(bool(torch.isfinite(dec).all()) and bool(torch.isfinite(at).all()),
          "4i: decode or prefill logits are not finite")
    rel = rel_err(dec, at)                                       # (b, G)
    worst = float(rel.max())
    check(worst <= tol,
          f"4i {cfg.name}: decode and prefill differ by {worst} of the "
          f"position's max |logit| (tolerance {tol})")
    with negate:
        neg = negated_decode(model, cfg, tokens)
    negated = float(rel_err(neg, at[:, 1]).max())
    check(negated > tol,
          f"4i {cfg.name}: a decode from negated layer-0 values is within "
          f"{negated} of the prefill")
    out.update(decode_vs_prefill_rel_err=worst, tolerance=tol,
               decode_vs_prefill_rel_err_p50=float(rel.median()),
               positions_compared=int(rel.numel()),
               rows_compared=int(rel.shape[0]),
               decode_vs_prefill_rel_err_layer0_negated=negated,
               negated_changes_token=int((neg.argmax(-1)
                                          != at[:, 1].argmax(-1)).sum()))
    return out


def profile_generate(model, cfg, prompts) -> dict:
    """--profile: the prompt pass alone (1 token), then it and 15 decode
    steps, traced."""
    from repro_torch.launch import serve

    return {f"gen {n}": phase_profile(
        lambda gen: serve.generate(model, cfg, prompts, gen, device="cuda"),
        gen=n) for n in (1, 16)}


def phase_family_serve(ops, card: str, arch: str, profile: bool) -> tuple:
    """4i for one served family at full width (batch 4, prompt 8192, 32
    greedy tokens, then a warm repeat): flash launched once an attention
    layer in the prefill, all on the tensor-core kernel; tokens in range;
    ``family_gate``; a MoE model's per-layer drop share in the prefill
    printed.  Returns (launches of the first run, its line)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = get_config(arch)
    model = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    attn_layers = 0 if cfg.block_pattern == "xlstm" else cfg.n_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    before = flash.kernel_launches()
    record, shares = drop_shares(cfg, SERVE_PROMPT)
    with RouterLog(record):
        tokens, first = serve.generate(model, cfg, prompts, FAMILY_GEN,
                                       device="cuda")
    launches = read_counts(ops)
    by_kernel = {name: n - before[name]
                 for name, n in flash.kernel_launches().items()}
    check(launches["flash_attention"] == attn_layers,
          f"4i {arch}: {launches['flash_attention']} flash launches in one "
          f"prefill, not {attn_layers}")
    check(by_kernel == {"tensor_core": attn_layers, "cuda_core": 0},
          f"4i {arch}: the bf16 prefill's attention ran {by_kernel}")
    check(tokens.shape == (SERVE_B, SERVE_PROMPT + FAMILY_GEN)
          and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size,
          f"4i {arch}: generated tokens out of range")
    again, warm = serve.generate(model, cfg, prompts, FAMILY_GEN,
                                 device="cuda")
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        gate = family_gate(model, cfg, tokens)
    steps = np.asarray(warm["decode_ms"])
    line = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "batch": SERVE_B, "prompt": SERVE_PROMPT, "gen": FAMILY_GEN,
            "serve_window": cfg.serve_window,
            "params": sum(p.numel() for p in model.parameters()),
            "prefill_ms_first": first["prefill_s"] * 1e3,
            "prefill_ms_warm": warm["prefill_s"] * 1e3,
            "decode_ms_p50": float(np.percentile(steps, 50)),
            "decode_ms_p99": float(np.percentile(steps, 99)),
            "tok_per_s": warm["tok_per_s"],
            "max_memory_allocated_bytes": peak,
            "tokens_repeat_equal": bool(torch.equal(tokens, again)),
            **gate, "launches": by_variant(launches),
            "flash_launches_by_kernel": by_kernel, "card": card}
    if cfg.is_moe:
        line["prefill_drop_share_by_layer"] = [float(x) for x in shares]
    if profile:
        line["profile"] = profile_generate(model, cfg, prompts)
    print(json.dumps({"family_serve": line}), flush=True)
    del model, tokens, again
    torch.cuda.empty_cache()
    return launches, line


def phase_family_prefill(ops, card: str, arch: str, profile: bool) -> tuple:
    """4i for pixtral-12b (one ``prefill_with_cache`` at batch 1, 4096
    tokens, 256 patch embeddings at distinct positions) and hubert-xlarge
    (one ``forward`` at batch 4, 4096 frames, 15 % masked), bf16, twice
    (first, warm): flash once a layer, finite logits, and batch row 0's
    logits against the same model with ``attention=train_attention``
    (the plain path) within SERVE_BF16_REL_TOL of each position's max
    |logit|.  Returns (launches of the first run, its line)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import init_params
    from repro_torch.models.transformer import (
        FRONTEND_DIM, PATCH_DIM, forward, prefill_with_cache)

    cfg = get_config(arch)
    model = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if cfg.input_mode == "multimodal":
        b, s = 1, PIXTRAL_S
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device="cuda"),
                 "patch_embeds": torch.randn(
                     (b, PIXTRAL_PATCHES, PATCH_DIM), generator=gen,
                     device="cuda").bfloat16(),
                 "patch_positions": torch.randperm(
                     s, generator=gen, device="cuda")[:PIXTRAL_PATCHES][None]}

        def run(attention=attn_lib.attention, rows=slice(None)):
            return prefill_with_cache(
                model, cfg, {k: v[rows] for k, v in batch.items()},
                attention=attention)[0]
    else:
        b, s = HUBERT_B, HUBERT_S
        batch = {"frames": torch.randn((b, s, FRONTEND_DIM), generator=gen,
                                       device="cuda").bfloat16(),
                 "mask": torch.rand((b, s), generator=gen,
                                    device="cuda") < HUBERT_MASK}

        def run(attention=attn_lib.attention, rows=slice(None)):
            return forward(model, cfg, {k: v[rows] for k, v in batch.items()},
                           attention=attention)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with torch.inference_mode():
        for i in range(2):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits = run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                launches = read_counts(ops)
        check(launches["flash_attention"] == cfg.n_layers,
              f"4i {arch}: {launches['flash_attention']} flash launches, "
              f"not {cfg.n_layers}")
        check(bool(torch.isfinite(logits).all()),
              f"4i {arch}: logits are not finite")
        got = logits[:1].float()
        del logits
        peak = torch.cuda.max_memory_allocated()
        want = run(attn_lib.train_attention, slice(0, 1)).float()
        rel = rel_err(got[0], want[0])
        worst = float(rel.max())
        check(worst <= SERVE_BF16_REL_TOL,
              f"4i {arch}: flash and plain attention differ by {worst} of a "
              f"position's max |logit| (tolerance {SERVE_BF16_REL_TOL})")
        line = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
                "batch": b, "seq": s, "entry": "prefill_with_cache"
                if cfg.input_mode == "multimodal" else "forward",
                "params": sum(p.numel() for p in model.parameters()),
                "ms_first": times[0], "ms_warm": times[1],
                "max_memory_allocated_bytes": peak,
                "flash_vs_plain_rel_err": worst,
                "flash_vs_plain_rel_err_p50": float(rel.median()),
                "positions_compared": int(rel.numel()),
                "launches": by_variant(launches), "card": card}
        if profile:
            line["profile"] = phase_profile(lambda rows: run(rows=rows),
                                            rows=slice(None))
            line["profile"]["run"] = "one prefill" if b == 1 else \
                "one forward"
    print(json.dumps({"family_prefill": line}), flush=True)
    del model, batch, got, want
    torch.cuda.empty_cache()
    return launches, line


def phase_families(ops, card: str, profile: bool) -> tuple:
    """Phase 4i: deepseek-moe-16b, hymba-1.5b and xlstm-125m served, then
    pixtral-12b's prefill and hubert-xlarge's forward, each model freed
    before the next.  Returns (launches by path, the flash launches at
    the families' phase-5 shapes)."""
    by_path, shape_launches = {}, {}
    for arch in FAMILY_SERVE:
        by_path[f"4i serve {arch}"], _ = phase_family_serve(ops, card, arch,
                                                            profile)
    for arch in ("pixtral-12b", "hubert-xlarge"):
        by_path[f"4i {arch}"], _ = phase_family_prefill(ops, card, arch,
                                                        profile)
    for cls, *_ in FAMILY_FLASH:
        arch = cls.split()[0]
        path = (f"4i serve {arch}" if arch in FAMILY_SERVE
                else f"4i {arch}")
        shape_launches[cls] = by_path[path]["flash_attention"]
    return by_path, shape_launches


def family_flash_rows(flash) -> list:
    """Phase 5's flash entries at the families' shapes (``at_shapes``):
    the kernel's device time on all rows (``ms``) and the caller's
    (``call_ms``), the plain version's on batch row 0, SDPA's with the
    same band mask (none for the encoder), and the bound: 4 dh flop for
    each live (q, k) pair at 989 TFLOP/s bf16 against q, k, v and o moved
    once."""
    from repro_torch.roofline import HW_H100, kernel_costs

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i, (cls, b, hkv, rep, s, dh, window, causal) in enumerate(
            FAMILY_FLASH):
        h = hkv * rep
        q, k, v = attn_inputs(700 + i, b, hkv, rep, s, s, dh, torch.bfloat16)
        pos = torch.arange(s, device="cuda")
        band = torch.ones((s, s), dtype=torch.bool, device="cuda")
        if causal:
            band &= pos[None, :] <= pos[:, None]
        if window is not None:
            band &= pos[None, :] > pos[:, None] - window
        live = kernel_costs.flash_live_pairs(s, s, causal, window)
        check(live == int(band.sum()), f"{cls}: live pairs {live} != the "
              "band's")
        b_ms, b_by = bound(kernel_costs.flash_attention(
            b, h, hkv, s, s, dh, causal=causal, window=window, itemsize=2),
            HW_H100)
        kern = device_time(lambda: flash.flash_attention(
            q, k, v, causal=causal, window=window), reps=10)
        plain_ms = device_time(lambda: flash.flash_attention_ref(
            q[:1], k[:1], v[:1], causal=causal, window=window), reps=3)["ms"]
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        mask = None if not (causal or window) else band
        library_ms = device_time(lambda: sdpa(
            qc, kc, vc, attn_mask=mask, enable_gqa=rep > 1), reps=10)["ms"]
        rows.append({"class": cls, "shape": f"q {tuple(q.shape)} x kv "
                     f"{tuple(k.shape)} bf16, causal={causal}, window "
                     f"{window}", "ms": kern["ms"],
                     "call_ms": kern["call_ms"], "plain_ms": plain_ms,
                     "plain_rows": 1, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms,
                     "live_pairs_per_head": live})
        del q, k, v, qc, kc, vc, band
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 5

def prox_kernel_rows(group_prox) -> list:
    """Phase 5 rows of the two group-prox kernels: the batched one at the
    convex paths' three dual shapes (the row's own numbers at the first,
    the kNN graph at C = 16 384), the unbatched one at the host AMA's
    (523 776, 32) with a scalar radius (and a per-row one beside it)."""
    from repro_torch.roofline import kernel_costs

    def timed(fn, plain, v, r, library=None):
        b_ms, b_by = bound(kernel_costs.group_ball_proj(
            v.numel() // v.shape[-1], v.shape[-1],
            kernel_costs.radius_elems(r)))
        kern = device_time(lambda: fn(v, r), kernel="group_ball_proj_kernel")
        lib = device_time(library) if library is not None else None
        return {"shape": str(tuple(v.shape)), "ms": kern["ms"],
                "call_ms": kern["call_ms"],
                "plain_ms": device_time(lambda: plain(v, r))["ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib["ms"] if lib is not None else None,
                "traces": kern["traces"]}

    at = []
    for i, (b, e, d, per_rung) in enumerate(PROX_MAIN):
        v, r = prox_rows(230 + i, b, e, d)
        # the radius the main path passes at this shape
        if per_rung:
            r = r[:, :1]
        # one rung with one radius is what torch.renorm computes (with
        # + 1e-7 in its norm); it takes one radius, so no one call covers
        # a radius a slot or L > 1 rungs
        library = None
        if per_rung and b == 1:
            radius = float(r)
            library = (lambda v=v, radius=radius:
                       torch.renorm(v[0], 2, 0, radius))
        at.append(timed(group_prox.group_ball_proj_batched,
                        group_prox.group_ball_proj_batched_ref, v, r,
                        library=library))
        if library is not None:
            at[-1]["library"] = "torch.renorm(v[0], 2, 0, r)"
            at[-1]["library_max_abs_diff"] = float(
                (library() - group_prox.group_ball_proj_batched_ref(
                    v, r)[0]).abs().max())
        del v, r, library
    v, r = prox_rows(233, 1, HOST_E, 32)
    v, r = v[0], r[0]
    # the host AMA passes lambda as a 0-d tensor on the card
    scalar = torch.tensor(0.75, device="cuda")
    renorm_diff = float((torch.renorm(v, 2, 0, 0.75)
                         - group_prox.group_ball_proj_ref(v, scalar))
                        .abs().max())
    host = timed(group_prox.group_ball_proj, group_prox.group_ball_proj_ref,
                 v, scalar, library=lambda: torch.renorm(v, 2, 0, 0.75))
    host_rows = timed(group_prox.group_ball_proj,
                      group_prox.group_ball_proj_ref, v, r)
    rows = []
    for name, main, extra, replaces in (
            ("group_ball_proj_batched", at[0], {"at_shapes": at},
             "src/repro/kernels/group_prox.py:71"),
            ("group_ball_proj", host,
             {"per_row_radius": host_rows,
              # torch.renorm floors the norm with + 1e-7
              "library_max_abs_diff": renorm_diff,
              "library": "torch.renorm(v, 2, 0, r)"},
             "src/repro/kernels/group_prox.py:39")):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/group_prox.cu",
                     "replaces": replaces, "launches": None,
                     "max_abs_err": None, "ms": main["ms"],
                     "call_ms": main["call_ms"], "plain_ms": main["plain_ms"],
                     "bound_ms": main["bound_ms"],
                     "bound_by": main["bound_by"],
                     "library_ms": main["library_ms"],
                     "shape": main["shape"], **extra})
    return rows


def ama_kernel_rows(group_prox) -> list:
    """Phase 5 rows of the AMA iteration's two passes at ``AMA_MAIN``'s
    duals (the row's own numbers at the complete graph's, the cell
    ``cc-4k-round`` runs): the fused step (stepping one dual in place
    call after call, as the loop does) against ``ama_step_ref``, the
    gather-back against ``ama_gather_back_ref`` and ``index_add_``."""
    from repro_torch.roofline import kernel_costs

    steps, gathers = [], []
    for i, (kind, m, L) in enumerate(AMA_MAIN):
        o = ama_operands(kind, m, L, 250 + i)
        nu, u, e = o["nu"], o["u"], o["nu"].shape[1]
        shape = f"({L}, {e}, 32), {kind} C={m}"
        moved = torch.zeros((), device="cuda")
        b_ms, b_by = bound(kernel_costs.ama_step(
            L, e, m, 32, kernel_costs.radius_elems(o["radius"])))
        kern = device_time(lambda: ama_step(group_prox, o, nu, moved),
                           kernel="group_ball_proj_kernel")
        plain = device_time(lambda: group_prox.ama_step_ref(
            nu, o["radius"], u=u, i_idx=o["i_idx"], j_idx=o["j_idx"],
            eta=o["eta"], moved=moved))
        steps.append({"shape": shape, "ms": kern["ms"],
                      "call_ms": kern["call_ms"], "plain_ms": plain["ms"],
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                      "device_ops_per_call": kern["device_ops_per_call"],
                      "traces": kern["traces"]})
        b_ms, b_by = bound(kernel_costs.ama_gather_back(L, e, m, 32))
        args = (o["a"], nu, o["heads"], o["tails"], u)
        kern = device_time(lambda: group_prox.ama_gather_back(*args),
                           kernel="ama_gather_back_kernel")
        plain = device_time(lambda: group_prox.ama_gather_back_ref(*args))
        lib = device_time(lambda: u.copy_(o["a"].expand_as(u))
                          .index_add_(1, o["i_idx"], nu)
                          .index_add_(1, o["j_idx"], nu, alpha=-1.0))
        gathers.append({"shape": f"{shape} -> ({L}, {m}, 32)",
                        "ms": kern["ms"], "call_ms": kern["call_ms"],
                        "plain_ms": plain["ms"], "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib["ms"],
                        "traces": kern["traces"]})
        del o, nu, u, args
        torch.cuda.empty_cache()
    source = "src/repro_torch/kernels/csrc/group_prox.cu"
    # neither replaces a TPU kernel: the reference leaves the loop body
    # to XLA
    return [{"name": "group_ball_proj_batched.ama_step", "route": "cuda",
             "source": source, "replaces": None, "launches": None,
             "max_abs_err": None, **steps[-1],
             "library": None, "at_shapes": steps},
            {"name": "ama_gather_back", "route": "cuda", "source": source,
             "replaces": None, "launches": None, "max_abs_err": None,
             **gathers[-1], "library": "index_add_ (atomics: not repeatable)",
             "at_shapes": gathers}]


def bound(cost: tuple, hw=None) -> tuple:
    """The least time the card could take for ``cost`` = ``(bytes,
    ops)`` (``roofline.kernel_costs``): the bytes at the HBM rate or the
    operations at the peak of ``hw`` (default ``HW_H100_FP32``: 3.35 TB/s,
    67 TFLOP/s fp32), whichever is longer, and which it is."""
    from repro_torch.roofline import HW_H100_FP32

    hw = hw or HW_H100_FP32
    nbytes, nops = cost
    t_bytes = nbytes / hw.hbm_bw * 1e3
    t_ops = nops / hw.peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# phase 5's shapes: (class, m, k, d).  kmeans_assign: Lloyd over all rows,
# a batch of routes, the single routes of the KM and the convex paths;
# pairwise_sqdist: kmeans++ seeding and one kNN tile of the convex path
ASSIGN_SHAPES = [("lloyd", MAIN_M, MAIN_K, MAIN_D),
                 ("batch route", ROUTE_M, MAIN_K, MAIN_D),
                 ("single route", 1, MAIN_K, MAIN_D),
                 ("single route", 1, 8, 32),
                 # the route server's flushes (phase 4d): the buckets
                 # 4 and 16 take most of them at 4 and 16 callers
                 ("flush 1", 1, MAIN_K, MAIN_D),
                 ("flush 4", 4, MAIN_K, MAIN_D),
                 ("flush 8", 8, MAIN_K, MAIN_D),
                 ("flush 16", 16, MAIN_K, MAIN_D),
                 ("flush 64", 64, MAIN_K, MAIN_D),
                 # minibatch Lloyd's batch (phase 4e)
                 ("minibatch", BATCH_M, MAIN_K, MAIN_D),
                 # the hierarchical round (phase 4f): one shard's Lloyd,
                 # and the top level's over the 256 shard centers
                 ("shard", SHARD_M, MAIN_K, MAIN_D),
                 ("top", TOP_M, MAIN_K, MAIN_D),
                 # ODCL-KM's 8 restarts on the Section 5 federation (4g)
                 ("paper lloyd", PAPER_M, PAPER_K, PAPER_D),
                 # the LM federation (4h): the device Lloyd of run 1 and
                 # IFCA's sketch assignment of run 2
                 ("lm", LM_CLIENTS, LM_CLUSTERS, LM_FULL_SKETCH)]
# the kmeans++ shape is also the host Lloyd's and gradient clustering's
# assignment (phase 4e); spectral: the farthest-point traversal
PAIRWISE_SHAPES = [("kmeans++", MAIN_M, MAIN_K, MAIN_D),
                   ("knn tile", 1024, 16_384, 32),
                   ("spectral", MAIN_M, MAIN_K, SPECTRAL_D),
                   # the Section 5 federation (phase 4g): kmeans++ and the
                   # host Lloyd, then ODCL-CC's fusion test
                   ("paper kmeans++", PAPER_M, PAPER_K, PAPER_D),
                   ("paper fusion", PAPER_M, PAPER_M, PAPER_D),
                   # the LM federation's kmeans++ seeding (4h run 1)
                   ("lm kmeans++", LM_CLIENTS, LM_CLUSTERS, LM_FULL_SKETCH)]


def one_kernel(timing: dict, kernel: str, what: str) -> None:
    """Fail unless one call launched exactly one device operation, the
    named kernel."""
    ops = timing["device_ops_per_call"]
    check(len(ops) == 1 and kernel in next(iter(ops)) and
          next(iter(ops.values())) == 1.0,
          f"{what}: one call ran {ops}, not one {kernel} launch")


def ptxas_named(usage: dict) -> dict:
    """ptxas registers and spill bytes by kernel instance, keyed by a
    readable name (``assign_stream_kernel<1>``) in place of the mangled
    one."""
    named = {}
    for mangled, info in usage.items():
        found = re.search(r"\d+([a-z][a-z_]*_kernel)((?:I(?:L[ib]\d+E)+E)?)", mangled)
        if found:
            args = re.findall(r"L[ib](\d+)E", found.group(2))
            named[found.group(1) + (f"<{','.join(args)}>" if args else "")] = info
    return named


def kernel_rows(pairwise_l2, kmeans_assign) -> list:
    """Phase 5 rows of the two slice-1 kernels, one entry a shape: device
    ms and call ms of the kernel, the plain version and the library call,
    the bound, and the variant the wrapper picked; each kernel
    instance's ptxas registers and spill bytes.  ``add_counts`` fills in
    the launches once the paths have run."""
    from repro_torch.kernels import _build
    from repro_torch.roofline import kernel_costs

    rows = []
    at = {"pairwise_sqdist": [], "kmeans_assign": []}
    for i, (cls, m, k, d) in enumerate(PAIRWISE_SHAPES):
        a, b = draw(7 + i, (m, d), (k, d))
        variant = pairwise_l2.pairwise_plan(m, k, d)[0]
        kern = device_time(lambda: pairwise_l2.pairwise_sqdist(a, b),
                           kernel=("pairwise_stream_kernel"
                                   if variant == "stream" else None))
        if variant == "stream":
            one_kernel(kern, "pairwise_stream_kernel", f"pairwise_sqdist {cls}")
        b_ms, b_by = bound(kernel_costs.pairwise_sqdist(m, k, d))
        plain = device_time(lambda: pairwise_l2.pairwise_sqdist_ref(a, b))
        lib = device_time(lambda: torch.cdist(a, b))
        at["pairwise_sqdist"].append({
            "class": cls, "shape": f"({m},{d})x({k},{d})", "variant": variant,
            "ms": kern["ms"], "call_ms": kern["call_ms"],
            "device_ops_per_call": kern["device_ops_per_call"],
            "traces": kern["traces"],
            "plain_ms": plain["ms"], "library_ms": lib["ms"],
            "library_call_ms": lib["call_ms"], "bound_ms": b_ms,
            "bound_by": b_by})
        del a, b
    for i, (cls, m, k, d) in enumerate(ASSIGN_SHAPES):
        a, b = draw(17 + i, (m, d), (k, d))
        pts = b[torch.arange(m, device="cuda") % k] + 0.5 * a
        variant = kmeans_assign.assign_plan(m, k, d).variant
        kern = device_time(lambda: kmeans_assign.kmeans_assign(pts, b),
                           kernel=f"assign_{variant}_kernel")
        one_kernel(kern, f"assign_{variant}_kernel", f"kmeans_assign {cls}")
        b_ms, b_by = bound(kernel_costs.kmeans_assign(m, k, d))
        plain = device_time(lambda: kmeans_assign.kmeans_assign_ref(pts, b))
        at["kmeans_assign"].append({
            "class": cls, "shape": f"({m},{d})x({k},{d})", "variant": variant,
            "ms": kern["ms"], "call_ms": kern["call_ms"],
            "device_ops_per_call": kern["device_ops_per_call"],
            "traces": kern["traces"],
            "plain_ms": plain["ms"], "library_ms": None, "bound_ms": b_ms,
            "bound_by": b_by})
        del a, b, pts
    for name, src, replaces, library in (
            ("pairwise_sqdist", "src/repro_torch/kernels/csrc/pairwise_l2.cu",
             "src/repro/kernels/pairwise_l2.py:44",
             "torch.cdist (which also takes the root)"),
            ("kmeans_assign", "src/repro_torch/kernels/csrc/kmeans_assign.cu",
             "src/repro/kernels/kmeans_assign.py:48",
             "none: no one PyTorch call returns labels + sums + counts")):
        main = at[name][0]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, "max_abs_err": None,
            "ms": main["ms"],
            "call_ms": main["call_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library": library,
            "ptxas": ptxas_named(_build.ptxas_usage(src.split("/")[-1][:-3])),
            "shape": main["shape"], "at_shapes": at[name]})
    return rows


def phase_timings(card: str) -> list:
    """Phase 5's timings, taken first, while no earlier phase has run in
    the process (after phases 2-4g, ``torch.profiler`` lost kernel
    records in some runs): every kernel at its shapes.  The launch counts
    and errors come later (``add_counts``)."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import group_prox, kmeans_assign, pairwise_l2

    t0 = time.perf_counter()
    rows = (kernel_rows(pairwise_l2, kmeans_assign)
            + prox_kernel_rows(group_prox) + ama_kernel_rows(group_prox)
            + [flash_kernel_row(flash, card)])
    rows[-1]["at_shapes"] = family_flash_rows(flash)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[chip_smoke] phase 5 timings in {time.perf_counter() - t0:.1f}s",
          flush=True)
    return rows


# ---------------------------------------------- phase 5b (the roofline)

SGD_STEPS, SGD_BATCH = 2000, 32
# the bench rows whose per-iteration kernels phase 5b probes: the Lloyd
# row at C = 1 048 576 and the convex kNN row at C = 16 384
ROOFLINE_PROBES = [(MAIN_M, MAIN_D, MAIN_K, "kmeans-device", "complete"),
                   (16_384, 32, MAIN_K, "convex-device", "knn")]


def sgd_problem(device):
    """Appendix D's check (``tests/test_substrates.py``): 500 noisy
    linear samples in 4 dimensions, the squared loss and its exact ridge
    solution."""
    from repro_torch.core.erm import ridge_erm

    rng = np.random.default_rng(2)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    w = rng.normal(size=4).astype(np.float32)
    y = (x @ w + 0.01 * rng.normal(size=500)).astype(np.float32)
    data = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))

    def loss(theta, batch):
        xx, yy = batch
        r = xx @ theta - yy
        return 0.5 * torch.mean(r * r)

    return data, loss, ridge_erm(*data, 1e-6)


def in_peak(row: dict) -> bool:
    return all(0.0 < row[key] <= 1.05
               for key in ("flops_frac_of_peak", "bytes_frac_of_peak"))


def phase_roofline(card: str, main_obs: dict) -> dict:
    """Phase 5b: the runtime and the engine roofline on the card.  TF32
    must be off once the entry points have resolved the card; ``sgd_erm``
    on the card and on the CPU from the same minibatch rows within 1e-5
    of the largest magnitude, and on the card's own draws within 0.3 of
    the exact ridge solution (Appendix D); ``engine_kernel_report`` at
    ``ROOFLINE_PROBES`` and ``program_rows_from_snapshot`` over the main
    path's run, every row's flops and bytes fractions of the H100's fp32
    peaks in (0, 1.05]."""
    from repro_torch.core.erm import sgd_erm
    from repro_torch.roofline import (
        engine_kernel_report,
        hardware_info,
        program_rows_from_snapshot,
    )

    t0 = time.perf_counter()
    tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32,
            "precision": torch.get_float32_matmul_precision()}
    check(not tf32["matmul"] and not tf32["cudnn"]
          and tf32["precision"] == "highest", f"5b: TF32 is on: {tf32}")
    idx = torch.randint(0, 500, (SGD_STEPS, SGD_BATCH),
                        generator=torch.Generator().manual_seed(0))
    on = {}
    for dev in ("cuda", "cpu"):
        data, loss, _ = sgd_problem(dev)
        on[dev] = sgd_erm(None, torch.zeros(4, device=dev), data, loss,
                          steps=SGD_STEPS, batch=SGD_BATCH, radius=100.0,
                          indices=idx).cpu()
    sgd_err = float((on["cuda"] - on["cpu"]).abs().max()
                    / on["cpu"].abs().max())
    check(sgd_err <= 1e-5, f"5b: sgd_erm card vs CPU {sgd_err:.3g} > 1e-5")
    data, loss, exact = sgd_problem("cuda")
    t1 = time.perf_counter()
    own = sgd_erm(torch.Generator(device="cuda").manual_seed(0),
                  torch.zeros(4, device="cuda"), data, loss,
                  steps=SGD_STEPS, batch=SGD_BATCH, radius=100.0)
    sgd_ms = (time.perf_counter() - t1) * 1e3
    gap = float(torch.linalg.vector_norm(own - exact))
    check(gap < 0.3, f"5b: sgd_erm lies {gap:.3g} from the exact ridge")
    probes = []
    for c, s, k, algorithm, edges in ROOFLINE_PROBES:
        for row in engine_kernel_report(c, s, k, algorithm, edges=edges):
            row["row"] = f"{algorithm} {edges} C={c}"
            probes.append(row)
    programs = program_rows_from_snapshot(main_obs)
    check(programs, "5b: the main path recorded no program gauges")
    for what, row in ([(r["row"], r) for r in probes]
                      + list(programs.items())):
        check(in_peak(row), f"5b: {what} outside (0, 1.05] of the peaks: "
              f"flops {row['flops_frac_of_peak']:.3g}, bytes "
              f"{row['bytes_frac_of_peak']:.3g}")
    out = {"card": card, "hw": hardware_info(), "tf32": tf32,
           "sgd_erm": {"card_vs_cpu": sgd_err, "gap_to_exact": gap,
                       "ms": sgd_ms, "steps": SGD_STEPS},
           "probes": probes, "programs": programs,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"roofline": out}), flush=True)
    return out


# phase 6: the multi-device dry run.  grok-1-314b at full width on the
# 16x16 mesh (256 ranks of a fake process group, fake CUDA tensors); the
# reference integration test's two combos; and the tie to the card:
# qwen2-0.5b's train step at batch 4 x 4096 (remat "full"), predicted on
# a 1x1 mesh and run for real
DRYRUN_ARCH, DRYRUN_SHAPE = "grok_1_314b", "train_4k"
TIE_ARCH, TIE_B, TIE_S = "qwen2_0_5b", 4, 4096
# a dry run that predicts less than this share of the measured peak
# misleads every fit decision
TIE_PEAK_MIN = 0.8
DRYRUN_TIMEOUT = 900
# the grok argument bytes a rank may differ from the hand estimate (every
# parameter and its two fp32 moments split evenly over the ranks, the
# batch over the data dim) by this share: the leaves the rules replicate
ARG_ESTIMATE_TOL = 0.02


def dryrun_spec_bytes(cfg, shape, mesh) -> int:
    """The grok train step's argument bytes a rank holds, from the specs
    alone: each parameter and both fp32 moments at their local shard, the
    step count, and the batch's local rows."""
    from repro_torch.launch import dryrun, inputs
    from repro_torch.sharding import batch_spec, opt_state_specs, param_specs
    from repro_torch.sharding.specs import spec_map
    from repro_torch.utils import tree_leaves

    rules = dryrun.make_rules(cfg, mesh, "train")
    specs = inputs.input_specs(cfg, shape)
    pspecs = param_specs(cfg, specs["params"], rules, mesh)
    bspec = batch_spec(cfg, rules, mesh)
    sizes = spec_map(lambda sp, l: dryrun.local_bytes(l, sp, mesh),
                     opt_state_specs(pspecs), specs["opt_state"])
    total = sum(tree_leaves(spec_map(
        lambda sp, l: dryrun.local_bytes(l, sp, mesh), pspecs,
        specs["params"])))
    total += sum(tree_leaves(sizes["mu"])) + sum(tree_leaves(sizes["nu"]))
    total += sizes["step"]
    total += sum(dryrun.local_bytes(v, bspec(v), mesh)
                 for v in specs["batch"].values())
    return total


def dryrun_estimate_bytes(cfg, shape, mesh) -> float:
    """The same bytes by hand, without the specs: every parameter with
    its two fp32 moments over all ranks, the batch over the data dim."""
    from repro_torch.launch import inputs
    from repro_torch.utils import tree_leaves

    specs = inputs.input_specs(cfg, shape)
    params = sum(l.numel() * (l.element_size() + 8)
                 for l in tree_leaves(specs["params"]))
    batch = sum(v.numel() * v.element_size()
                for v in specs["batch"].values())
    return params / mesh.size() + batch / mesh["data"].size()


def dryrun_child(which: str) -> None:
    """One dry run in this process, which owns its fake process group;
    prints one JSON line."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    if which == "grok":
        mesh = make_production_mesh(device="cuda")
        _, info = dryrun.lower_one(DRYRUN_ARCH, DRYRUN_SHAPE, mesh=mesh)
        cfg, shape = get_config(DRYRUN_ARCH), INPUT_SHAPES[DRYRUN_SHAPE]
        info["spec_argument_bytes"] = dryrun_spec_bytes(cfg, shape, mesh)
        info["estimate_argument_bytes"] = dryrun_estimate_bytes(cfg, shape,
                                                                mesh)
        print(json.dumps(info), flush=True)
        return
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_tree
    from repro_torch.optim import adamw_init

    cfg = get_config(TIE_ARCH)
    shape = InputShape(f"train_{TIE_B}x{TIE_S}", TIE_S, TIE_B, "train")
    _, info = dryrun.lower_one(TIE_ARCH, shape.name, shape=shape,
                               mesh=make_debug_mesh(1, 1, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    params = init_tree(cfg, seed=0, device="cuda")
    opt = adamw_init(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (TIE_B, TIE_S),
                              generator=gen, device="cuda",
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, remat="full")
    with FlopCounterMode(display=False) as flops:
        loss, _, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    info["real"] = {"flops": flops.get_total_flops(),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "loss": float(loss)}
    print(json.dumps(info), flush=True)


def start_child(args: list, logs: Path) -> subprocess.Popen:
    """``python3 <args>`` from the repo root with ``src`` on the path,
    started now, its output to files under ``logs`` (a pipe left unread
    would stall it); :func:`finish_child` reads them."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    n = len(list(logs.iterdir()))
    paths = (logs / f"{n}.out", logs / f"{n}.err")
    with open(paths[0], "w") as out, open(paths[1], "w") as err:
        proc = subprocess.Popen([sys.executable, *args], cwd=root, env=env,
                                stdout=out, stderr=err)
    proc.logs = paths
    return proc


def finish_child(proc: subprocess.Popen, what: str) -> str:
    """The child's standard output once it exits 0; fails otherwise (a
    child still running at ``DRYRUN_TIMEOUT`` is killed)."""
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out, err = (p.read_text() for p in proc.logs)
    check(proc.returncode == 0,
          f"{what} exited {proc.returncode}: {out[-2000:]} {err[-3000:]}")
    return out


def phase_dryrun(card: str) -> dict:
    """Phase 6: the multi-device dry run.  Each dry run owns its fake
    process group in a process of its own; the four start together (the
    traces run on the host's cores, the tie's real step on the card)."""
    t_all = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent)
    combos = {"xlstm_125m": "long_500k", "hubert_xlarge": "decode_32k"}
    logs = Path(tmp.name) / "logs"
    logs.mkdir()
    procs = {"grok": start_child([__file__, "--dryrun-child", "grok"], logs),
             "tie": start_child([__file__, "--dryrun-child", "tie"], logs)}
    for arch, shape in combos.items():
        procs[arch] = start_child(
            ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--json", str(Path(tmp.name) / f"{arch}.jsonl")], logs)
    try:
        outs = {name: finish_child(p, f"6: the {name} dry run")
                for name, p in procs.items()}
        recs = {arch: json.loads((Path(tmp.name) / f"{arch}.jsonl")
                                 .read_text().splitlines()[0])
                for arch in combos}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()
    seconds = time.perf_counter() - t_all

    grok = json.loads(outs["grok"].strip().splitlines()[-1])
    check(grok["status"] == "OK", f"6a: {DRYRUN_ARCH} status {grok}")
    check(grok["argument_bytes_per_device"] == grok["spec_argument_bytes"],
          f"6a: argument bytes {grok['argument_bytes_per_device']} differ "
          f"from the specs' {grok['spec_argument_bytes']}")
    gap = grok["argument_bytes_per_device"] / grok[
        "estimate_argument_bytes"] - 1
    check(abs(gap) <= ARG_ESTIMATE_TOL,
          f"6a: argument bytes {grok['argument_bytes_per_device']} are "
          f"{gap:+.4f} off the hand estimate "
          f"{grok['estimate_argument_bytes']}")
    print(json.dumps({"dryrun": {
        "arch": DRYRUN_ARCH, "shape": DRYRUN_SHAPE, "mesh": grok["mesh"],
        "chips": grok["chips"], "card": card,
        **{k: grok[k] for k in (
            "compile_s", "argument_bytes_per_device",
            "output_bytes_per_device", "temp_bytes_per_device",
            "peak_bytes_per_device", "flops_per_device",
            "bytes_per_device", "roofline")},
        "estimate_argument_bytes": grok["estimate_argument_bytes"],
        "argument_gap_to_estimate": gap,
        "collectives": {"counts": grok["collectives"]["_counts"],
                        "by_mesh_dim": grok["collectives"]["_mesh_dims"]},
    }}), flush=True)

    rec = recs["xlstm_125m"]
    check(rec["status"] == "OK" and rec["chips"] == 256
          and rec["mesh"] == "16x16"
          and rec["peak_bytes_per_device"] < 2 ** 30
          and rec["roofline"]["bottleneck"] in ("compute", "memory",
                                                "collective"),
          f"6b: xlstm_125m long_500k {rec}")
    rec = recs["hubert_xlarge"]
    check(rec["status"] == "SKIP" and "encoder-only" in rec["reason"],
          f"6b: hubert_xlarge decode_32k {rec}")

    tie = json.loads(outs["tie"].strip().splitlines()[-1])
    real = tie["real"]
    ratio = tie["peak_bytes_per_device"] / real["max_memory_allocated"]
    check(tie["flops_per_device"] == real["flops"],
          f"6c: dry-run flops {tie['flops_per_device']} != the step's "
          f"{real['flops']}")
    check(ratio >= TIE_PEAK_MIN,
          f"6c: predicted peak {tie['peak_bytes_per_device']} is {ratio:.3f} "
          f"of the measured {real['max_memory_allocated']}")
    out = {"card": card,
           "xlstm_125m long_500k": {k: recs["xlstm_125m"][k] for k in (
               "peak_bytes_per_device", "compile_s")},
           "tie": {"arch": TIE_ARCH, "batch": TIE_B, "seq": TIE_S,
                   "flops": real["flops"],
                   "predicted_peak": tie["peak_bytes_per_device"],
                   "measured_peak": real["max_memory_allocated"],
                   "ratio": ratio, "trace_s": tie["compile_s"],
                   "loss": real["loss"]},
           "seconds": seconds}
    print(json.dumps({"dryrun_checks": out}), flush=True)
    return out


# ---------------------------------------------- phase 7 (the client mesh)

# the round's client axis on a mesh of MESH_RANKS processes: gloo over
# CUDA tensors on the one card (NCCL refuses two ranks on one GPU), NCCL
# at one rank; the main path at C = 1 048 576 (262 144 rows a rank), the
# mutation run, the two-level round at S = 32 and the convex kNN round at
# C = 16 384; the LM round on qwen2-0.5b at full width, C = 8 clients in
# two planted clusters (2 a rank), sketch 128
MESH_RANKS = 4
MESH_TIMEOUT = 600
MESH_CONVEX_C = 16_384
MESH_LM_C, MESH_LM_K, MESH_LM_SKETCH = 8, 2, 128
# the all-reduce moves sums in another order than the unmeshed one-hot
# product: centers within rtol 1e-6 (atol 1e-6 of the largest magnitude);
# a bf16 cluster model within one bf16 ulp of the unmeshed one, plus the
# fp32 sums' own rounding, 2^-20 of the leaf's largest magnitude (four
# members a cluster; an entry whose members nearly cancel keeps only
# that)
MESH_CENTER_RTOL = 1e-6
BF16_ULP = 2.0 ** -7
FP32_SUM_ATOL = 2.0 ** -20
# 7b's main run serves on rank 0: closed loops of 16 callers, per
# request and batched, a second each
MESH_QPS_CALLERS, MESH_QPS_SECONDS = 16, 1.0
# 7e: phase 4d's ingest row on the meshed session, through rank 0's
# server; a follower's stop waits this long for rank 0's close
MESH_FOLLOW_TIMEOUT = 300.0


def mesh_runs(main_c: int, convex_c: int) -> dict:
    """Phase 7's simulate runs (7a's main path, 7b's five), by name: 7b
    runs the main path twice, the first a fresh process's first work on
    the card, the second warm."""
    base = dict(clusters=8, dim=16, samples=64, sketch_dim=64,
                algorithm="kmeans-device", init="kmeans++")
    return {
        "main": dict(base, clients=main_c, wave=65_536),
        "main again": dict(base, clients=main_c, wave=65_536),
        "mutation": dict(base, clients=main_c, wave=65_536,
                         mutation_rounds=3, **MUTATION),
        "shards 32": dict(base, clients=main_c, wave=main_c // HIER_SHARDS,
                          shards=HIER_SHARDS),
        "convex-device knn": dict(base, clients=convex_c, sketch_dim=32,
                                  algorithm="convex-device", edges="knn",
                                  knn_k=8, cc_iters=200),
    }


def mesh_round(summary: dict) -> dict:
    """What a run is held to: its labels, centers and cluster models on
    the host, its purity, MSE and the refinalize it took; with where its
    time went (``run_breakdown``)."""
    r = summary.round
    models = {k: v.float().cpu() for k, v in r["models"].items()}
    return {"labels": np.asarray(r["labels"]), "centers": r["centers"].cpu(),
            "models": models, "purity": summary["purity"],
            "mse": summary["mse"], "n_iter": summary["meta"]["n_iter"],
            "refinalize": r["refinalize"],
            "refinalize_fired": (summary["serving"] or {}).get(
                "refinalize_fired"),
            **run_breakdown(summary)}


def run_breakdown(summary: dict) -> dict:
    """A run's phases (simulate's wall clock: the clients' ERMs, the
    ingest, the server round) and the spans that split them, summed over
    the run: the collectives (``mesh.*``) and the round's stages, ms."""
    spans = {name[:-3]: {"ms": h.get("sum", 0.0), "count": h.get("count", 0)}
             for name, h in summary["obs"]["histograms"].items()
             if name.endswith(".ms") and name.startswith(
                 ("mesh.", "session.", "engine.", "hierarchy."))}
    return {"phases": summary["phases"], "spans": spans}


def mesh_close(name: str, got: torch.Tensor, want: torch.Tensor,
               rtol: float) -> float:
    """|got - want| <= rtol (|want| + max|want|), elementwise; returns the
    largest error over the largest magnitude."""
    scale = float(want.abs().max()) or 1.0
    err = (got - want).abs()
    check(bool((err <= rtol * (want.abs() + scale)).all()),
          f"{name}: off by {float(err.max()):.3g} (scale {scale:.3g})")
    return float(err.max()) / scale


def lm_planted_clients(cfg, rows: range, device) -> dict:
    """Clients ``rows`` of the planted LM federation, stacked: client i is
    the random init of seed i % MESH_LM_K plus 1e-2 normal noise drawn
    from seed 1000 + i, so any rank makes any client alone."""
    from repro_torch.models.transformer import init_tree
    from repro_torch.utils import tree_map

    bases = [init_tree(cfg, seed=c, device=device) for c in range(MESH_LM_K)]
    clients = []
    for i in rows:
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        clients.append(tree_map(lambda l: (l.float() + 1e-2 * torch.randn(
            l.shape, generator=gen, device=device)).to(l.dtype),
            bases[i % MESH_LM_K]))
    del bases
    return tree_map(lambda *ls: torch.stack(ls), *clients)


def lm_round(cfg, params, n_clients: int, device, mesh=None):
    from repro_torch.core.engine.aggregate import one_shot_aggregate_device
    from repro_torch.core.federated import FederatedState

    return one_shot_aggregate_device(
        FederatedState(params=params, opt_state=None, n_clients=n_clients),
        cfg, algorithm="kmeans-device", k=MESH_LM_K,
        sketch_dim=MESH_LM_SKETCH, seed=0, mesh=mesh, device=device)


@contextlib.contextmanager
def calls_by_rows(ops):
    """Count the calls of ``kops.kmeans_assign`` and ``kops.pairwise_sqdist``
    by the rows they are given, ``{name: {rows: calls}}``, while the
    block runs (the wrappers are put back after it)."""
    seen = {"kmeans_assign": {}, "pairwise_sqdist": {}}
    inner = {name: getattr(ops, name) for name in seen}

    def counting(fn, calls):
        def wrapped(points, *args):
            m = int(points.shape[-2])
            calls[m] = calls.get(m, 0) + 1
            return fn(points, *args)
        return wrapped

    for name, calls in seen.items():
        setattr(ops, name, counting(inner[name], calls))
    try:
        yield seen
    finally:
        for name, fn in inner.items():
            setattr(ops, name, fn)


# ---- 7d: phase 4h's training runs on the mesh

# What 7d holds each meshed run to, 4h's unmeshed run.  At bf16 (the
# card's qwen2-0.5b) everything bit for bit: labels, every client's loss
# at every step of every phase, the round's, the final and the host
# round's models.  The local phase runs the same kernels on the same
# shapes and rows.  An average (the round's, IFCA's initial mean and
# cluster means) adds each cluster's bf16 members in fp32, in another
# order under a mesh (two a rank, then the all-reduce); on these runs
# the two orders gave the same sums on the H100 (every model and loss
# after an average 0.0 from 4h's; PERF.md), and the data, seeds and
# kernels are fixed, so a run that parts from 4h has a fault.
#
# At fp32 (the reduced config of the CPU rehearsal) exactness does not
# hold: fp32 members carry all 24 bits, so the two orders round the sums
# differently (1.7e-7 of the leaf's scale in the rehearsal's round).
# There the labels and the local phase's losses stay bit for bit; after
# an average each AdamW step moves an entry by at most lr *
# ``adam_step_bound(t)`` in either run (an entry whose gradient is
# rounding noise can step either way), so a model n steps on lies within
# 2 lr sum_t bound(t) of the other plus (2 + n) bf16 ulps
# (``lm_drift_tol``), and a loss within one bf16 ulp (``LM_LOSS_RTOL``).
LM_LOSS_RTOL = BF16_ULP


def adam_step_bound(t: int, b1: float = 0.9, b2: float = 0.95) -> float:
    """The largest |m_hat / sqrt(v_hat)| AdamW can reach at step t after a
    reset, over every gradient sequence (Cauchy-Schwarz on the two
    exponential averages; eps and the clip only make it smaller)."""
    s = sum(((1 - b1) * b1 ** (t - i)) ** 2 / ((1 - b2) * b2 ** (t - i))
            for i in range(1, t + 1))
    return (s * (1 - b2 ** t)) ** 0.5 / (1 - b1 ** t)


def lm_drift_tol(lr: float, steps: list) -> tuple:
    """(absolute move, bf16 ulps) two fp32 runs of ``steps`` (the step
    counts after each reset of the moments) may part by after an
    average."""
    move = 2 * lr * sum(adam_step_bound(t) for n in steps
                        for t in range(1, n + 1))
    return move, 2 + sum(steps)


def lm_rows_err(what: str, got, want, tol, device="cpu") -> float:
    """The largest |got - want| of two rows (on ``device``).  ``tol`` =
    None: fails unless they are equal bit for bit; else (move, ulps,
    scale): unless |got - want| <= move + ulps * BF16_ULP (|want| + move)
    + 2^-20 scale, elementwise, and the error is returned over
    ``scale``."""
    g, w = got.to(device), want.to(device)
    err = (g.float() - w.float()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    if tol is None:
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"{what}: not bit for bit (off by {worst:.3g})")
        return worst
    move, ulps, scale = tol
    bound = (move + ulps * BF16_ULP * (w.float().abs() + move)
             + FP32_SUM_ATOL * scale)
    check(bool((err <= bound).all()),
          f"{what}: off by {worst:.3g} (bound at that entry "
          f"{float(bound.flatten()[int(err.argmax())]):.3g})")
    return worst / scale


@contextlib.contextmanager
def captured_post_start(keep: dict, meshed: bool):
    """While the block runs, the models ODCL's post phase starts from (the
    round's, handed to the second ``local_training`` call) are copied to
    the host, outside the round's and the steps' timers: every client's
    rows, or under a mesh this rank's."""
    from repro_torch.core import federated_methods as fm
    from repro_torch.utils import tree_map

    inner = fm.local_training
    calls = []

    def capturing(state, *args, **kw):
        calls.append(1)
        if len(calls) == 2:
            keep["rows"] = tree_map(
                lambda l: (l.to_local() if meshed else l).to(
                    "cpu", copy=True), state.params)
        return inner(state, *args, **kw)

    fm.local_training = capturing
    try:
        yield keep
    finally:
        fm.local_training = inner


def first_members(labels: np.ndarray, k: int) -> list:
    return [int(np.argmax(labels == c)) for c in range(k)]


def lm_run(argv: list, mesh=None, rows: tuple | None = None) -> tuple:
    """One ``launch.train`` run of 4h or 7d.  Returns (train's summary
    with ``wall_s``, the run's record on the host): labels, every
    client's loss at every step by phase (ODCL) or round (IFCA), ODCL's
    round (its labels and models: each cluster's, or under a mesh this
    rank's ``rows`` = (lo, hi) of the clients), and the final models
    (every client's, or this rank's)."""
    from repro_torch.launch import train as ttrain
    from repro_torch.utils import tree_map

    keep: dict = {}
    t0 = time.perf_counter()
    with captured_post_start(keep, rows is not None):
        out = ttrain.train(argv, mesh=mesh)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    res = out["result"]
    labels = np.asarray(res.labels)
    losses = {m.get("phase", f"round{m.get('round')}"):
              np.asarray(m["client_losses"], np.float32)
              for m in res.round_metrics if m.get("client_losses")}
    round_ = None
    if keep:
        round_ = {"labels": labels}
        if rows is None:
            first = first_members(labels, res.n_clusters)
            round_["models"] = tree_map(lambda l: l[first], keep["rows"])
        else:
            round_["rows"] = keep["rows"]
    final = tree_map(lambda l: (l.to_local() if rows else l).to(
        "cpu", copy=True), res.state.params)
    return out, {"labels": labels, "losses": losses, "round": round_,
                 "final": final}


def lm_host_round(state, cfg, mesh=None, rows=None, device="cuda") -> dict:
    """One ODCL round with ``engine="host"`` (kmeans++, K = 2, sketch 128)
    on a trained federation: labels, models as ``captured_round`` keeps
    them, seconds."""
    from repro_torch.core.federated import one_shot_aggregate
    from repro_torch.utils import tree_map

    t0 = time.perf_counter()
    new, labels, _ = one_shot_aggregate(
        state, cfg, algorithm="kmeans++", k=LM_CLUSTERS, engine="host",
        sketch_dim=LM_FULL_SKETCH, seed=0, mesh=mesh, device=device)
    labels = np.asarray(labels)
    if rows is None:
        first = first_members(labels, int(labels.max()) + 1)
        kept = {"models": tree_map(lambda l: l[first].cpu(), new.params)}
    else:
        kept = {"rows": tree_map(lambda l: l.to_local().to("cpu", copy=True),
                                 new.params)}
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    return {"labels": labels, **kept, "seconds": time.perf_counter() - t0}


def lm_hold(what: str, got: dict, want: dict, lo: int, lr: float,
            drift_steps: list, local_phase: str | None,
            device="cpu") -> dict:
    """Hold a meshed run's record (this rank's clients ``lo`` ...) to the
    unmeshed one's: bit for bit where the models are bf16; at fp32 only
    the labels and ``local_phase``'s losses (before any average), the
    rest within ``lm_drift_tol`` of the AdamW steps after each reset that
    follow the first average (``drift_steps``).  Returns the largest
    errors (0.0 where exact; at fp32 the models' over their scale) and
    the losses' over their value."""
    from repro_torch.utils import tree_leaves

    exact = all(l.dtype == torch.bfloat16
                for l in tree_leaves(want["final"]))
    check(np.array_equal(got["labels"], want["labels"]),
          f"{what}: labels {got['labels'].tolist()} != "
          f"{want['labels'].tolist()}")
    worst = {"exact": exact, "losses": 0.0}
    for phase, w in want["losses"].items():
        g = got["losses"][phase]
        rel = np.abs(g - w) / np.abs(w)
        worst["losses"] = max(worst["losses"], float(rel.max()))
        if exact or phase == local_phase:
            bad = np.flatnonzero((g != w).any(axis=0))
            check(bad.size == 0, f"{what}: {phase} losses differ from the "
                  f"unmeshed run for clients {bad.tolist()} (off by "
                  f"{float(rel.max()):.3g} of their value)")
        else:
            check(bool((rel <= LM_LOSS_RTOL).all()),
                  f"{what}: {phase} losses off by {float(rel.max()):.3g} "
                  f"of their value")
    move, ulps = lm_drift_tol(lr, drift_steps)

    def hold_rows(name, got_tree, want_tree, labels, move, ulps):
        """Each of this rank's rows against its cluster's model
        (``labels``) or its own row; the scale is the largest magnitude
        of the models read (every cluster's, or this rank's rows)."""
        err = 0.0
        for i, (g, w) in enumerate(zip(tree_leaves(got_tree),
                                       tree_leaves(want_tree))):
            if labels is None:
                w = w[lo:lo + g.shape[0]]
                pick = list(range(g.shape[0]))
            else:
                pick = [int(labels[lo + j]) for j in range(g.shape[0])]
            tol = None if exact else (
                move, ulps, float(w.to(device).float().abs().max()) or 1.0)
            for j, row in enumerate(pick):
                err = max(err, lm_rows_err(
                    f"{what}: {name} leaf {i} of client {lo + j}", g[j],
                    w[row], tol, device))
        return err

    if want.get("round"):
        worst["round_models"] = hold_rows(
            "the round's model", got["round"]["rows"],
            want["round"]["models"], want["round"]["labels"], 0.0, 1.0)
    worst["final_models"] = hold_rows("the final model", got["final"],
                                      want["final"], None, move, ulps)
    if want.get("host"):
        check(np.array_equal(got["host"]["labels"], want["host"]["labels"]),
              f"{what}: the host round's labels differ")
        # one more average, one more rounding
        worst["host_round_models"] = hold_rows(
            "the host round's model", got["host"]["rows"],
            want["host"]["models"], want["host"]["labels"], move, ulps + 1)
    return worst


def lm_train_child(rank: int, mesh, dev: str, sizes: dict, ops) -> dict:
    """7d on one rank: 4h's two runs through ``launch.train`` with the
    mesh, and an ODCL host round on run 1's trained state, each held to
    4h's records (``sizes["lm_keep"]``)."""
    from repro_torch import obs
    from repro_torch.launch import train as ttrain

    keep_dir = Path(sizes["lm_keep"])
    per = LM_CLIENTS // MESH_RANKS
    rows = (rank * per, (rank + 1) * per)
    lr = ttrain.parser().parse_args([]).lr
    out = {}
    for name, argv, local_phase, drift in (
            ("odcl", LM_RUN1, "local", [2]),
            ("ifca", LM_RUN2, None, [2, 2])):
        argv = list(argv) + list(sizes.get("lm_argv", ()))
        memory = None
        if dev == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            memory = card_memory()
            print(f"[chip_smoke] 7d {name} rank {rank} before: "
                  f"{json.dumps(memory)}", flush=True)
        obs.reset()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        run, rec = lm_run(argv, mesh=mesh, rows=rows)
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        snap = obs.snapshot()
        launches = read_counts(ops) if dev == "cuda" else None
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else None
        res = run["result"]
        host = None
        if name == "odcl":
            host = lm_host_round(res.state, run["cfg"], mesh=mesh, rows=rows,
                                 device=dev)
            rec["host"] = host
        del run, res
        gc.collect()
        want = torch.load(keep_dir / f"{name}.pt", mmap=True,
                          weights_only=False)
        what = f"7d {name} (rank {rank})"
        worst = lm_hold(what, rec, want, rows[0], lr, drift, local_phase,
                        dev)
        if dev == "cuda":
            need = (("kmeans_assign", "pairwise_sqdist") if name == "odcl"
                    else ("kmeans_assign",))
            for kernel in need:
                check(launches[kernel] > 0, f"{what}: no {kernel} launch")
        step = snap["histograms"].get("fed.local_step.ms", {})
        out[name] = {
            "seconds": seconds, "labels": rec["labels"].tolist(),
            "local_step_p50_ms": step.get("p50"),
            "local_steps": step.get("count"),
            "unmeshed_local_step_p50_ms": want["local_step_p50_ms"],
            "round_ms": snap["histograms"].get("fed.round.ms", {}).get(
                "sum"),
            "host_round_s": None if host is None else host["seconds"],
            "gather_bytes": snap["counters"].get("mesh.gather.bytes", 0.0),
            "all_reduce_bytes": snap["counters"].get(
                "mesh.all_reduce.bytes", 0.0),
            "all_reduce_ms": snap["histograms"].get(
                "mesh.all_reduce.ms", {}).get("sum", 0.0),
            "peak_memory_bytes": peak, "memory_at_start": memory,
            "launches": launches, "max_err": worst}
        del rec, want, host
        gc.collect()
    return out


def lm_keep_runs(keep_dir: str, argv_extra=(), device="cuda") -> None:
    """The unmeshed records 7d holds its runs to, when phase 4h has not
    made them (the CPU rehearsal): both runs and the host round."""
    for name, argv in (("odcl", LM_RUN1), ("ifca", LM_RUN2)):
        run, rec = lm_run(list(argv) + list(argv_extra))
        if name == "odcl":
            rec["host"] = lm_host_round(run["result"].state, run["cfg"],
                                        device=device)
        rec["local_step_p50_ms"] = None
        torch.save(rec, Path(keep_dir) / f"{name}.pt")
        del run, rec


def card_memory() -> dict:
    """This process's allocated and reserved bytes on the card, its five
    largest segments (total, allocated), and the card's free bytes."""
    free, total = torch.cuda.mem_get_info()
    segs = sorted(torch.cuda.memory_snapshot(),
                  key=lambda g: -g["total_size"])[:5]
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(), "card_free": free,
            "card_total": total,
            "largest_segments": [(g["total_size"], g["allocated_size"])
                                 for g in segs]}


def card_used_mib() -> list:
    """The card's used memory (MiB) and each compute process's, as
    ``nvidia-smi`` reads them."""
    def query(what):
        return subprocess.run(
            ["nvidia-smi", f"--query-{what}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.split()

    used = query("gpu=memory.used")
    apps = query("compute-apps=used_memory")
    return [int(float(x)) for x in used[:1]] + [int(float(x)) for x in apps]


def lm_round_worst(rank: int, per: int, labels, state, want) -> float:
    """7c's check: this rank's client models within one bf16 ulp of the
    unmeshed cluster models (plus the fp32 sums' rounding); returns the
    largest error over each leaf's scale.  (Its own frame, so that no
    full-width row outlives the check.)"""
    from repro_torch.utils import tree_leaves

    worst = 0.0
    for i, (got_l, want_l) in enumerate(zip(
            tree_leaves(state.params), tree_leaves(want["models"]))):
        mine_rows = got_l.to_local()
        scale = float(want_l.float().abs().max()) or 1.0
        atol = FP32_SUM_ATOL * scale
        for j in range(per):
            lab = int(labels[rank * per + j])
            g, w = mine_rows[j].float(), want_l[lab].float()
            err = (g - w).abs()
            check(bool((err <= BF16_ULP * w.abs() + atol).all()),
                  f"7c (rank {rank}): leaf {i} of client "
                  f"{rank * per + j} off by {float(err.max()):.3g}, "
                  "more than one bf16 ulp of the unmeshed model")
            worst = max(worst, float(err.max()) / scale)
    return worst


# ---- 7e: the route server under ingest on the mesh

def mesh_serving(session, rows, rank: int, what: str) -> dict:
    """7e on one rank of a meshed session: rank 0 runs phase 4d's ingest
    row through ``loadgen.run_row`` (16 batched callers for
    SERVING_SECONDS, keyed waves of 256 every 0.2 s, one background warm
    refinalize midway), then routes SERVING_PROBES probes through a
    fresh server against one batch route; every other rank follows both
    servers.  Returns the row (rank 0), the log and the rank's
    ``mesh.broadcast`` / ``serving.log`` figures over the row."""
    from repro_torch import obs
    from repro_torch.serving import loadgen
    from repro_torch.serving.server import RouteServer

    if rank != 0:
        obs.reset()
        RouteServer(session, **SERVER_KW).start().stop(
            timeout=MESH_FOLLOW_TIMEOUT)
        snap = obs.snapshot()
        RouteServer(session, **SERVER_KW).start().stop(
            timeout=MESH_FOLLOW_TIMEOUT)
        return {"row": None, "log": None, **log_figures(snap)}
    log: list = []
    row = loadgen.run_row(session, rows, mode="closed", batched=True,
                          callers=max(SERVING_CALLERS), ingest=True,
                          ingest_log=log, duration_s=SERVING_SECONDS,
                          queue_depth=1024, **SERVER_KW)
    snap = obs.snapshot()
    check_rows(what, [row])
    check_ingest_row(what, row, session)
    check_probes(what, session, rows, MESH_FOLLOW_TIMEOUT)
    return {"row": row, "log": log, **log_figures(snap)}


def log_figures(snap: dict) -> dict:
    """A rank's log and broadcast figures from an obs snapshot (on a
    follower the broadcast span includes the wait for rank 0's next
    entry)."""
    c, h = snap["counters"], snap["histograms"].get("mesh.broadcast.ms", {})
    return {"log_entries": int(c.get("serving.log.entries", 0)),
            "log_bytes": int(c.get("serving.log.bytes", 0)),
            "broadcast_bytes": int(c.get("mesh.broadcast.bytes", 0)),
            "broadcasts": int(h.get("count", 0)),
            "broadcast_ms": h.get("sum", 0.0)}


def serving_line(res: dict, seconds: float, ranks: int, backend: str,
                 per_rank: list, card: str) -> dict:
    """7e's part of the ``client_mesh`` line."""
    row = res["row"]
    waves = row["ingest_waves"]
    return {
        "backend": backend, "ranks": ranks, "seconds": seconds, "card": card,
        "callers": row["callers"], "qps": row["qps"],
        "route_p50_ms": row["route_p50_ms"],
        "route_p99_ms": row["route_p99_ms"],
        "refinalize_under_load_ms": row["refinalize_under_load_ms"],
        "route_p99_ms_during_refinalize":
            row.get("route_p99_ms_during_refinalize"),
        "n_requests_during_refinalize":
            row.get("n_requests_during_refinalize"),
        "staleness_at_serve_p95": row["staleness_at_serve_p95"],
        "ingest_waves": waves,
        "log_per_rank": [{k: r[k] for k in (
            "log_entries", "log_bytes", "broadcast_bytes", "broadcasts",
            "broadcast_ms")} for r in per_rank],
        "rank0_broadcast_ms_per_wave": per_rank[0]["broadcast_ms"]
        / max(waves, 1)}


def mesh_child(rank: int, port: int, out_dir: str, base: dict,
               sizes: dict) -> None:
    """One rank of phase 7b-d: every run with the mesh, each held to the
    unmeshed run of the parent (``base``) or of phase 4h, then one JSON
    record."""
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.kernels.kmeans_assign import assign_plan
    from repro_torch.launch.mesh import client_mesh
    from repro_torch.launch.simulate import simulate
    from repro_torch.sharding.clients import ClientAxis
    from repro_torch.utils import tree_map

    dev = sizes["device"]
    mesh = client_mesh(MESH_RANKS, backend="gloo", device=dev, rank=rank,
                       init_method=f"tcp://localhost:{port}")
    axis = ClientAxis(mesh)
    rec = {"rank": rank, "runs": {}}
    for name, kw in mesh_runs(sizes["main_c"], sizes["convex_c"]).items():
        if name == "main":
            # the route server over the meshed session, rank 0's
            kw = dict(kw, qps_callers=MESH_QPS_CALLERS,
                      qps_duration=MESH_QPS_SECONDS)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with calls_by_rows(ops) as rows:
            summary = simulate(mesh=mesh, device=dev, **kw)
        seconds = time.perf_counter() - t0
        got, want = mesh_round(summary), base[name]
        what = f"7b {name} (rank {rank})"
        if name in ("shards 32", "convex-device knn"):
            check(same_partition(got["labels"], want["labels"]),
                  f"{what}: another partition than the unmeshed run")
        else:
            check(np.array_equal(got["labels"], want["labels"]),
                  f"{what}: labels differ from the unmeshed run on "
                  f"{int((got['labels'] != want['labels']).sum())} clients")
            mesh_close(f"{what} centers", got["centers"], want["centers"],
                       MESH_CENTER_RTOL)
        check(got["purity"] == 1.0, f"{what}: purity {got['purity']}")
        check(got["mse"] is not None and got["mse"] < 1e-2,
              f"{what}: mse {got['mse']}")
        if name == "mutation":
            check(got["refinalize_fired"] and got["refinalize"] == "warm",
                  f"{what}: the warm refinalize was not taken "
                  f"({got['refinalize_fired']}, {got['refinalize']})")
        mine = sizes["main_c"] // MESH_RANKS
        if name.startswith("main"):
            calls = rows["kmeans_assign"]
            check(calls.get(mine, 0) > 0 and sizes["main_c"] not in calls,
                  f"{what}: kmeans_assign by rows {calls}, not on the "
                  f"rank's {mine} rows alone")
            if dev == "cuda":
                # the round's calls, and rank 0's batch routes past the
                # small-m threshold
                want = sum(n for m, n in calls.items() if assign_plan(
                    m, kw["clusters"], kw["sketch_dim"]).variant == "stream")
                stream = ops.variant_counts()["kmeans_assign"]["stream"]
                check(stream == want,
                      f"{what}: {stream} stream launches for {want} calls "
                      f"of the stream variant ({calls})")
        qps = summary["qps_server"]
        if name == "main" and rank == 0:
            check(qps is not None and qps["errors"] == 0
                  and qps["timeouts"] == 0
                  and qps["labels_equal_batch_route"],
                  f"{what}: the route server {qps}")
        else:
            check(qps is None, f"{what}: rank {rank} served {qps}")
        rec["runs"][name] = {
            "seconds": seconds, "purity": got["purity"], "mse": got["mse"],
            "n_iter": got["n_iter"], "rows_per_rank": (
                kw["clients"] + kw.get("churn", 0)
                * kw.get("mutation_rounds", 0)) // MESH_RANKS,
            "calls_by_rows": {k: {str(m): n for m, n in v.items()}
                              for k, v in rows.items()},
            "launches": read_counts(ops) if dev == "cuda" else None,
            "all_reduce_bytes": summary["obs"]["counters"].get(
                "mesh.all_reduce.bytes", 0.0),
            "gather_bytes": summary["obs"]["counters"].get(
                "mesh.gather.bytes", 0.0),
            "phases": got["phases"], "spans": got["spans"],
            "qps_server": qps}
        del summary
    rec["serving"] = mesh_serving_child(rank, mesh, dev, sizes["main_c"])
    # the unmeshed LM models arrived through CUDA IPC: popped from the
    # shared dict, so the last reference goes with this frame's and the
    # parent's storage is released before the process ends
    want = base.pop("lm", None)
    if want is not None:
        from repro_torch.configs import get_config

        cfg = sizes.get("lm_cfg") or get_config(SERVE_ARCH)
        per = MESH_LM_C // MESH_RANKS
        local = lm_planted_clients(cfg, range(rank * per, (rank + 1) * per),
                                   dev)
        params = tree_map(lambda l: axis.dtensor(l, [per] * MESH_RANKS),
                          local)
        del local
        obs.reset()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, labels, info = lm_round(cfg, params, MESH_LM_C, dev, mesh)
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        snap = obs.snapshot()
        check(np.array_equal(np.asarray(labels), want["labels"]),
              f"7c (rank {rank}): labels {labels} != {want['labels']}")
        worst = lm_round_worst(rank, per, labels, state, want)
        hist = snap["histograms"].get("mesh.all_reduce.ms", {})
        rec["lm"] = {"seconds": seconds,
                     "all_reduce_bytes": snap["counters"].get(
                         "mesh.all_reduce.bytes", 0.0),
                     "all_reduce_ms": hist.get("sum", 0.0),
                     "all_reduces": hist.get("count", 0),
                     "max_err_over_scale": worst, "rows_per_rank": per,
                     "launches": read_counts(ops) if dev == "cuda" else None,
                     "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                           if dev == "cuda" else None)}
        del state, params, want
        gc.collect()
    if sizes.get("lm_keep"):
        rec["lm_train"] = lm_train_child(rank, mesh, dev, sizes, ops)
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def mesh_serving_child(rank: int, mesh, dev: str, clients: int) -> dict:
    """7e in a rank of the gloo world: the session (``loadgen``'s
    fixture on the mesh), the row through rank 0's server, then the
    gates: every rank at rank 0's clock with its served round; each
    rank's round equal to the serialized replay of rank 0's log on the
    mesh, bit for bit; rank 0's labels equal to the unmeshed replay's."""
    import torch.distributed as dist
    from repro_torch.serving import loadgen

    what = f"7e (rank {rank})"
    t0 = time.perf_counter()
    session, rows = loadgen.build_session(clients=clients, clusters=MAIN_K,
                                          sketch_dim=MAIN_D, seed=0,
                                          device=dev, mesh=mesh)
    build_s = time.perf_counter() - t0
    res = mesh_serving(session, rows, rank, what)
    served = session.served_round
    ends = [None] * MESH_RANKS
    dist.all_gather_object(ends, (session.clock, served.clock, served.out[1],
                                  served.centers.cpu().numpy()))
    for r, (clock, sclock, labels, centers) in enumerate(ends):
        check(clock == ends[0][0] and sclock == ends[0][1],
              f"{what}: rank {r} ends at clock {clock} (round {sclock}), "
              f"rank 0 at {ends[0][0]} (round {ends[0][1]})")
        check(np.array_equal(labels, ends[0][2])
              and np.array_equal(centers.view(np.int32),
                                 ends[0][3].view(np.int32)),
              f"{what}: rank {r}'s served round differs from rank 0's")
    box = [None if res["log"] is None else
           [w for w in res["log"] if w[0] <= served.clock]]
    dist.broadcast_object_list(box, src=0)
    t1 = time.perf_counter()
    rep = replay_log(box[0], served.clock, clients, dev, mesh)
    check(same_round(rep, served), f"{what}: the served round differs "
          "from the serialized replay of rank 0's log on the mesh")
    if rank == 0:
        flat = replay_log(box[0], served.clock, clients, dev)
        check(np.array_equal(flat.out[1], served.out[1]),
              f"{what}: labels differ from the unmeshed replay on "
              f"{int((flat.out[1] != served.out[1]).sum())} clients")
        del flat
    dist.barrier()
    del rep, session
    gc.collect()
    out = {k: v for k, v in res.items() if k != "log"}
    out.update(build_session_s=build_s,
               replay_s=time.perf_counter() - t1,
               seconds=time.perf_counter() - t0,
               waves_replayed=len(box[0]), clock=ends[0][0],
               served_clock=ends[0][1])
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_client_mesh(card: str, device: str = "cuda",
                      main_c: int = MAIN_M, convex_c: int = MESH_CONVEX_C,
                      lm_cfg=None, single_backend: str = "nccl",
                      lm_keep: str | None = None, lm_argv=()) -> dict:
    """Phase 7: the client axis on a mesh.  7a: the main path at one rank
    of ``single_backend`` equal to the unmeshed run bit for bit (labels,
    centers, cluster models).  7b: the runs of ``mesh_runs`` in
    ``MESH_RANKS`` spawned processes of one gloo group over tensors on
    the card, each held to the unmeshed run, the main one serving on
    rank 0.  7c: the LM round at C = 8 in the same processes, held to
    the unmeshed round.  7d: phase 4h's two training runs in the same
    processes, held to 4h's records in ``lm_keep``.  7e: phase 4d's
    ingest row through rank 0's ``RouteServer`` over the meshed session
    in the same processes (the others follow its log), and at the one
    rank of 7a, held to serialized replays of the log.  (``device``, the
    sizes and ``lm_argv``, extra ``launch.train`` flags, let the phase be
    rehearsed on the CPU; without ``lm_keep`` the records are made here
    first.)"""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import client_mesh
    from repro_torch.launch.simulate import simulate
    from repro_torch.serving import loadgen
    from repro_torch.utils import tree_map

    t_all = time.perf_counter()
    if device == "cuda":
        torch.cuda.empty_cache()
    runs = mesh_runs(main_c, convex_c)
    base, seconds = {}, {}
    for name, kw in runs.items():
        t0 = time.perf_counter()
        base[name] = mesh_round(simulate(device=device, **kw))
        seconds[f"unmeshed {name}"] = time.perf_counter() - t0
    out = {"card": card, "ranks": MESH_RANKS, "subphases": {}}

    # ---- 7a: one rank of NCCL, bit for bit
    t0 = time.perf_counter()
    mesh = client_mesh(1, backend=single_backend, device=device, rank=0,
                       init_method=f"tcp://localhost:{free_port()}")
    ops.reset_launch_counts()
    got = mesh_round(simulate(mesh=mesh, device=device, **runs["main"]))
    launches = read_counts(ops) if device == "cuda" else None
    seconds_7a = time.perf_counter() - t0
    # ---- 7e at the one rank: the control group is gloo beside the mesh's
    t0 = time.perf_counter()
    session, rows = loadgen.build_session(clients=main_c, clusters=MAIN_K,
                                          sketch_dim=MAIN_D, seed=0,
                                          device=device, mesh=mesh)
    res = mesh_serving(session, rows, 0, "7e (1 rank)")
    served = session.served_round
    check(same_round(replay_log(res["log"], served.clock, main_c, device),
                     served), "7e (1 rank): the served round differs from "
          "the unmeshed serialized replay of its log")
    del session, rows
    out["subphases"]["7e 1 rank"] = serving_line(
        res, time.perf_counter() - t0, 1, single_backend, [res], card)
    dist.destroy_process_group()
    print(f"[chip_smoke] 7e {single_backend} 1 rank: "
          f"{json.dumps(out['subphases']['7e 1 rank'])}  ({card})",
          flush=True)
    want = base["main"]
    check(np.array_equal(got["labels"], want["labels"]),
          "7a: labels differ from the unmeshed run")
    check(torch.equal(got["centers"], want["centers"]),
          "7a: centers differ from the unmeshed run")
    for key in want["models"]:
        check(torch.equal(got["models"][key], want["models"][key]),
              f"7a: cluster model {key} differs from the unmeshed run")
    check(got["purity"] == 1.0, f"7a: purity {got['purity']}")
    out["subphases"]["7a"] = {
        "backend": single_backend, "ranks": 1, "rows_per_rank": main_c,
        "seconds": seconds_7a,
        "unmeshed_seconds": seconds["unmeshed main"], "launches": launches,
        "purity": got["purity"], "n_iter": got["n_iter"],
        "phases": got["phases"], "spans": got["spans"],
        "unmeshed_phases": want["phases"], "unmeshed_spans": want["spans"]}
    print(f"[chip_smoke] 7a {single_backend} 1 rank, {main_c} rows: "
          f"{out['subphases']['7a']['seconds']:.1f}s  ({card})", flush=True)

    # ---- the LM round without a mesh
    if lm_cfg is not None or device == "cuda":
        from repro_torch.configs import get_config
        from repro_torch.utils import tree_leaves

        cfg = lm_cfg or get_config(SERVE_ARCH)
        t0 = time.perf_counter()
        params = lm_planted_clients(cfg, range(MESH_LM_C), device)
        state, labels, _ = lm_round(cfg, params, MESH_LM_C, device)
        del params
        labels = np.asarray(labels)
        check(same_partition(labels, np.arange(MESH_LM_C) % MESH_LM_K),
              f"7c: the unmeshed round missed the planted clusters {labels}")
        first = torch.as_tensor([int(np.argmax(labels == c))
                                 for c in range(MESH_LM_K)], device=device)
        models = tree_map(lambda l: l.index_select(0, first), state.params)
        del state
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        base["lm"] = {"labels": labels, "models": models}
        seconds["unmeshed lm"] = time.perf_counter() - t0
        n_params = sum(l[0].numel() for l in tree_leaves(models))
        del models, first
    else:
        base["lm"] = None

    # ---- 7b-d: MESH_RANKS processes of gloo
    tmp = tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent)
    if lm_keep is None and lm_argv:
        t0 = time.perf_counter()
        lm_keep = tmp.name
        lm_keep_runs(lm_keep, lm_argv, device)
        seconds["unmeshed lm_train"] = time.perf_counter() - t0
    if device == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        out["parent_memory"] = card_memory()
        print(f"[chip_smoke] 7 parent on the card before the ranks: "
              f"{json.dumps(out['parent_memory'])}", flush=True)
    t0 = time.perf_counter()
    sizes = {"device": device, "main_c": main_c, "convex_c": convex_c,
             "lm_cfg": lm_cfg, "lm_keep": lm_keep, "lm_argv": list(lm_argv)}
    # four processes share the card: each returns freed memory to it at
    # page granularity (expandable segments), since 7d's ranks need ~16 GB
    # each at their peaks (the setting is read at a process's first CUDA
    # use, so it reaches the ranks alone)
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ctx = mp.start_processes(mesh_child, args=(free_port(), tmp.name,
                                                   base, sizes),
                                 nprocs=MESH_RANKS, join=False,
                                 start_method="spawn")
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    deadline = time.monotonic() + MESH_TIMEOUT
    peak_used = None                    # the card's, polled every 5 s
    # the LM models went to the ranks through CUDA IPC: the parent lets go
    # of them, and their memory returns once every rank has let go too
    base.pop("lm", None)
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                fail(f"7b-c: the {MESH_RANKS} ranks ran past "
                     f"{MESH_TIMEOUT} s")
            if device == "cuda":
                torch.cuda.ipc_collect()
                torch.cuda.empty_cache()
                used = card_used_mib()
                if used and (peak_used is None or used[0] > peak_used[0]):
                    peak_used = used
    except ProcessException as e:
        fail(f"7b-d: a rank failed (the card's peak use, MiB, and each "
             f"process's: {peak_used}): {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    recs = [json.loads((Path(tmp.name) / f"rank{r}.json").read_text())
            for r in range(MESH_RANKS)]
    tmp.cleanup()
    wall = time.perf_counter() - t0
    base_phases = {name: {k: base[name][k] for k in ("phases", "spans")}
                   for name in runs}
    del base
    for name in runs:
        per_rank = [r["runs"][name] for r in recs]
        out["subphases"][f"7b {name}"] = {
            "backend": "gloo", "ranks": MESH_RANKS,
            "rows_per_rank": per_rank[0]["rows_per_rank"],
            "seconds": max(r["seconds"] for r in per_rank),
            "unmeshed_seconds": seconds[f"unmeshed {name}"],
            "purity": per_rank[0]["purity"], "mse": per_rank[0]["mse"],
            "n_iter": per_rank[0]["n_iter"],
            "all_reduce_bytes_per_rank": per_rank[0]["all_reduce_bytes"],
            "gather_bytes_per_rank": per_rank[0]["gather_bytes"],
            "calls_by_rows_per_rank": [r["calls_by_rows"] for r in per_rank],
            "launches_per_rank": [r["launches"] for r in per_rank],
            "phases_per_rank": [r["phases"] for r in per_rank],
            "spans_rank0": per_rank[0]["spans"],
            "unmeshed_phases": base_phases[name]["phases"],
            "unmeshed_spans": base_phases[name]["spans"],
            "qps_server_rank0": per_rank[0].get("qps_server")}
        ph = per_rank[0]["phases"]
        print(f"[chip_smoke] 7b {name}: gloo {MESH_RANKS} ranks, "
              f"{per_rank[0]['rows_per_rank']} rows a rank: "
              f"{out['subphases'][f'7b {name}']['seconds']:.1f}s (rank 0: "
              f"ERM {ph['local_erm_s']:.2f}s, ingest {ph['ingest_s']:.2f}s, "
              f"round {ph['aggregate_s']:.2f}s)  ({card})", flush=True)
    sv = [r["serving"] for r in recs]
    sub = serving_line(sv[0], max(r["seconds"] for r in sv), MESH_RANKS,
                       "gloo", sv, card)
    sub.update(rows_per_rank=main_c // MESH_RANKS,
               build_session_s=[r["build_session_s"] for r in sv],
               replay_s=[r["replay_s"] for r in sv],
               waves_replayed=sv[0]["waves_replayed"], clock=sv[0]["clock"],
               served_clock=sv[0]["served_clock"])
    out["subphases"]["7e"] = sub
    print(f"[chip_smoke] 7e route server under ingest, gloo {MESH_RANKS} "
          f"ranks, {main_c // MESH_RANKS} rows a rank: {sub['seconds']:.1f}s, "
          f"{sub['qps']:.0f} qps, refinalize under load "
          f"{sub['refinalize_under_load_ms']:.1f} ms, {sub['ingest_waves']} "
          f"waves, rank 0 broadcast {sub['rank0_broadcast_ms_per_wave']:.3f}"
          f" ms a wave  ({card})", flush=True)
    if recs[0].get("lm") is not None:
        lm = [r["lm"] for r in recs]
        out["subphases"]["7c lm"] = {
            "backend": "gloo", "ranks": MESH_RANKS, "arch": SERVE_ARCH,
            "clients": MESH_LM_C, "clusters": MESH_LM_K,
            "sketch_dim": MESH_LM_SKETCH, "params_per_client": n_params,
            "rows_per_rank": lm[0]["rows_per_rank"],
            "seconds": max(r["seconds"] for r in lm),
            "unmeshed_seconds": seconds["unmeshed lm"],
            "all_reduce_bytes_per_rank": lm[0]["all_reduce_bytes"],
            "all_reduce_ms_per_rank": [r["all_reduce_ms"] for r in lm],
            "all_reduces_per_rank": lm[0]["all_reduces"],
            "max_err_over_scale": max(r["max_err_over_scale"] for r in lm),
            "peak_memory_bytes_per_rank": [r["peak_memory_bytes"]
                                           for r in lm],
            "launches_per_rank": [r["launches"] for r in lm]}
        print(f"[chip_smoke] 7c {SERVE_ARCH} C={MESH_LM_C}: gloo "
              f"{MESH_RANKS} ranks, {lm[0]['rows_per_rank']} clients a "
              f"rank: {out['subphases']['7c lm']['seconds']:.1f}s, "
              f"all-reduce {lm[0]['all_reduce_bytes'] / 1e9:.2f} GB a rank "
              f"in {lm[0]['all_reduce_ms'] / 1e3:.1f}s  ({card})", flush=True)
    if recs[0].get("lm_train") is not None:
        for name in ("odcl", "ifca"):
            per_rank = [r["lm_train"][name] for r in recs]
            sub = {
                "backend": "gloo", "ranks": MESH_RANKS, "arch": SERVE_ARCH,
                "argv": " ".join(LM_RUN1 if name == "odcl" else LM_RUN2),
                "clients": LM_CLIENTS,
                "clients_per_rank": LM_CLIENTS // MESH_RANKS,
                "labels": per_rank[0]["labels"],
                "seconds": max(r["seconds"] for r in per_rank),
                **{key: [r[key] for r in per_rank] for key in (
                    "local_step_p50_ms", "round_ms", "host_round_s",
                    "gather_bytes", "all_reduce_bytes", "all_reduce_ms",
                    "peak_memory_bytes", "memory_at_start", "launches")},
                "local_steps": per_rank[0]["local_steps"],
                "unmeshed_local_step_p50_ms":
                    per_rank[0]["unmeshed_local_step_p50_ms"],
                "max_err": {key: max(r["max_err"][key] for r in per_rank)
                            for key in per_rank[0]["max_err"]}}
            out["subphases"][f"7d {name}"] = sub
            print(f"[chip_smoke] 7d {name} {SERVE_ARCH} C={LM_CLIENTS}: "
                  f"gloo {MESH_RANKS} ranks, {sub['clients_per_rank']} "
                  f"clients a rank: {sub['seconds']:.1f}s, local step p50 "
                  f"{sub['local_step_p50_ms']} ms a rank (unmeshed "
                  f"{sub['unmeshed_local_step_p50_ms']}), errors "
                  f"{sub['max_err']}  ({card})", flush=True)
    out["card_used_mib_peak"] = peak_used     # [card, each process]
    out["spawned_seconds"] = wall
    out["seconds"] = time.perf_counter() - t_all
    print(json.dumps({"client_mesh": out}), flush=True)
    return out


def add_counts(rows: list, by_path: dict, errs: dict, flushes: dict,
               direct_routes: int, shape_launches: dict) -> None:
    """Phase 5: each row's launches on the paths (``by_path``: by wrapper
    and variant), its error from phase 2, and each shape entry's
    launches: a flush bucket's flushes (``flushes``, from the route
    server's ``serving.flush_size``; bucket 1 also gives the direct
    rows' per-request routes, one launch at m = 1 each, which are not
    flushes) and the launches at the shapes of phases 4e-4g
    (``shape_launches``)."""
    for row in rows:
        name = row["name"]
        row["launches"] = sum(n[name] for n in by_path.values())
        row["max_abs_err"] = errs[name]
        row["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
        variants = [key.split(".", 1)[1] for key in by_path["kmeans-device"]
                    if key.startswith(name + ".")]
        if variants:
            row["launches_by_variant"] = {
                v: sum(n[f"{name}.{v}"] for n in by_path.values())
                for v in variants}
            row["launches_by_variant_by_path"] = {
                p: {v: n[f"{name}.{v}"] for v in variants}
                for p, n in by_path.items()}
        for at in row.get("at_shapes", []):
            cls = at.get("class", "")
            if name == "kmeans_assign" and cls.startswith("flush"):
                at["launches"] = flushes.get(int(cls.split()[1]), 0)
                if cls == "flush 1":
                    at["direct_route_launches"] = direct_routes
            elif cls in shape_launches:
                at["launches"] = shape_launches[cls]


def main() -> None:
    ap = argparse.ArgumentParser(description="chip check of the port")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a second main-path run with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--dryrun-child", choices=["grok", "tie"],
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("[chip_smoke] FAIL: no CUDA device (torch.cuda.is_available() "
              "is False)", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if args.dryrun_child:
        dryrun_child(args.dryrun_child)
        return
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import group_prox, kmeans_assign, ops, pairwise_l2
    from repro_torch.launch.simulate import simulate

    t_all = time.perf_counter()
    card = card_line()
    print(f"[chip_smoke] {card}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[chip_smoke] kernels built in {time.perf_counter() - t0:.1f}s "
          f"({json.dumps(built)})", flush=True)

    rows = phase_timings(card)
    errs = phase_kernels(pairwise_l2, kmeans_assign, ops)
    phase_flush_buckets(pairwise_l2, kmeans_assign, ops)
    errs.update(phase_prox_kernels(group_prox, pairwise_l2, ops))
    errs.update(phase_ama_kernels(group_prox, ops))
    errs.update(phase_flash_kernel(flash))
    errs["flash_attention"] = max(errs["flash_attention"],
                                  phase_family_flash(flash))
    phase_small_round()
    phase_convex_rounds()
    phase_slice7_rounds()
    phase_slice8_rounds()
    phase_serve_card_vs_cpu()
    phase_lm_card_vs_cpu()
    phase_families_card_vs_cpu(ops)

    ops.reset_launch_counts()
    summary = simulate(clients=MAIN_M, clusters=8, dim=16, samples=64,
                       sketch_dim=64, wave=65_536, algorithm="kmeans-device",
                       init="kmeans++", route_probes=ROUTE_M,
                       finalize_repeats=FINALIZES, device="cuda")
    launches = read_counts(ops)
    check_path("main path", summary, launches,
               ("pairwise_sqdist", "kmeans_assign"))
    print(json.dumps({"main_path": path_fields(summary, launches, card)}),
          flush=True)
    by_path = {"kmeans-device": launches}

    by_path.update(phase_convex_paths(simulate, ops, card))
    by_path["host convex_clustering"] = phase_host_convex(ops, card)
    by_path[f"serve {SERVE_ARCH}"], _, generate = phase_serve(ops, card)
    if not args.profile:
        del generate                  # the model's memory goes with it
    flushes: dict = {}
    direct_routes = 0
    for clients in SERVING_CLIENTS:
        launches, by_bucket, direct, _ = phase_serving(ops, card, clients)
        by_path[f"serving C={clients}"] = launches
        direct_routes += direct
        for b, n in by_bucket.items():
            flushes[b] = flushes.get(b, 0) + n
    by_path[f"mutation C={MAIN_M}"] = phase_mutation(simulate, ops, card)
    by_path[f"convex-device knn warm C={CONVEX_WARM_C}"] = phase_convex_warm(
        ops, card)
    slice7, shape_launches = phase_slice7(simulate, ops, card)
    by_path.update(slice7)
    slice8, launches = phase_slice8(simulate, ops, card)
    by_path.update(slice8)
    shape_launches.update(launches)
    paper, launches = phase_paper_methods(ops, card)
    by_path.update(paper)
    shape_launches.update(launches)
    by_path["4j quickstart"] = phase_public_surface(ops, card)
    phase_decode_api(card)
    # 4h's records for 7d, on the host (files beside the script)
    lm_keep = tempfile.TemporaryDirectory(
        dir=Path(__file__).resolve().parent)
    lm, launches = phase_lm_train(ops, card, lm_keep.name)
    by_path.update(lm)
    shape_launches.update(launches)
    families, launches = phase_families(ops, card, args.profile)
    by_path.update(families)
    shape_launches.update(launches)
    add_counts(rows, by_path, errs, flushes, direct_routes, shape_launches)
    print(json.dumps({"kernels": rows}), flush=True)
    phase_roofline(card, summary["obs"])
    phase_dryrun(card)
    try:
        phase_client_mesh(card, lm_keep=lm_keep.name)
    finally:
        lm_keep.cleanup()
    if args.profile:
        phase_traces(simulate, generate)
    print(f"[chip_smoke] every phase passed in "
          f"{time.perf_counter() - t_all:.1f}s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
