#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card.  After each
phase a ``[phase-clock] name=... seconds=... since_start=...`` line gives
the seconds since the previous one, so the clock lines sum to the whole
run.
Phases, one line each on stdout:

0. analysis  — the port's static analyzer, ``python -m repro_torch.analysis
               --baseline .github/gnscheck-torch-baseline.txt --json`` with
               ``PYTHONPATH=src`` in a subprocess (it imports neither
               ``jax`` nor ``repro``, so it runs where they are missing):
               exit 0, no finding, no new and no stale baseline entry;
               then the same CLI over ``tests/analysis_fixtures_torch``:
               exit 1, with every ported rule firing (16, the trace-purity
               and scalar retrace rules among them).  Prints what the
               passes walked (modules, ``@guarded_by`` classes, thread
               entry points, host→device transfer sites, all paired, the
               trace roots resolved, at least the reference's 19, and the
               functions they reach, at least its 68) and the wall seconds
               of each run;
1. build     — compile the port's CUDA kernels (K1 ``cache_lookup_agg``, K2
               ``gather_agg`` and K3 ``gns_sample_agg`` on row tiles, K4
               ``flash_attention`` in three routes) from
               ``src/repro_torch/csrc``; then read them back with
               ``cuobjdump``: registers, stack and local memory (spills) of
               K1's, K2's and K3's 12 tile kernels (``[kbuild]``; each must
               use at most 64 registers and not spill) and K4's kernels,
               and the HMMA instructions that K4's tensor-core route must
               hold (``[k4-build]``);
2. parity    — at the bucket-128 and bucket-512 serving shapes of preset
               ``paper_train``, hold K1 and K2 against their plain PyTorch
               versions on the card: ``torch.equal`` on integer-valued f32,
               random f32 and a bf16 table;
3. serve     — ``GNSEngine`` on preset ``paper_train`` with the fused K1
               input layer and the K2 aggregation serves 64 requests of 1-16
               node ids through ``GNSServer`` in waves that use all three
               buckets; every request must come back with finite logits,
               both kernels' launch counters, zeroed just before, must be
               above 0, and every K1 and K2 launch must take the vector
               path (D = 100 and 256).  Then, for one prepared batch per
               bucket, the card's logits must match the same engine's plain
               path on the CPU
               (allclose rtol 1e-4, atol 1e-4: cuBLAS and the CPU sum the f32
               matmul in different orders);
   fabric    — a 2-worker ``ServeFabric`` over the same engine, tenants
               ``mobile`` (weight 2, queue 16) and ``batch`` (weight 1,
               queue 64): 4 waves of 24 requests, then worker 0 is killed
               with a batch in flight mid-wave (12 more requests): its
               batch is reclaimed and served by the survivor (failover and
               retries at least 1).  Every request ``ok`` with finite
               logits, the meter's errors 0, ``fabric_error`` None, K1's and
               K2's counters (zeroed just before) above 0 and all on the
               vector path.  Prints each tenant's p50/p99, batches per
               worker, the launches and the wall time.  Then one prepared
               batch computed before and after a forced ``store.refresh()``
               gives the same logits bit for bit (the generation pin);
   tcp       — the same engine's config (JSON) behind a 2-worker
               ``ServeFabric(transport="tcp")``: two ``python -m
               repro_torch.rpc.endpoint`` processes on this card, each with
               its own engine replica launching K1 and K2, started after
               this process built the kernels.  24 requests of 2-8
               validation ids one at a time through an inproc fabric over a
               fresh engine and then through tcp: logits bit for bit, the
               same generation and bucket, wire bytes both ways.  Then the
               fabric phase's 4 waves over tcp (per-tenant p50/p99, rpc
               wait, batches per worker, wire bytes, and tcp p99 over the
               inproc waves' p99, logged, not asserted), then endpoint 0 is
               SIGKILLed with 16 pinned requests in flight: all served by
               worker 1, 0 errors, a failover, ``healthy() == [1]`` and
               STATS from worker 1 only.  A SHUTDOWN frame stops the
               survivor, which prints its K1 and K2 launches: each at least
               1, all on the vector path (``launches_by_path["tcp"]``);
   stream    — preset ``stream_replay`` at its own width (scale 0.25,
               D = 100, hidden 256, fanouts (5, 10), two shards, locality
               placement, adaptive policy, buckets 32/128) with K1's input
               and K2's aggregation, behind a 2-worker fabric: request
               bursts between the 4 batches of a temporal event stream (64
               events each, 10% new nodes) staged with ``ingest_events``;
               the watchdog merges them (bounded wait until nothing is
               pending and the merged generation is live and routed), then
               new nodes are served with finite logits.  The same checks as
               ``fabric``; prints ``merges_applied``, ``rows_migrated`` and
               the routed-local fraction before and after.  Then one engine
               on the card and one on the CPU, same seeds and parameters,
               merge the same events: ``infer`` on the same ids (every new
               node among them) allclose (rtol 1e-4, atol 1e-4);
4. k3-parity — K3 against its plain version at the training shape of
               ``paper_train`` with ``backend="device"`` (B = 176,000 rows,
               k = 5, D = 100) and at the bucket-128 serving shape: the drawn
               lanes (rows and weights) and the output bit for bit
               (``torch.equal``) on integer-valued f32, random f32 and bf16
               tables;
5. train     — (A) ``GNSEngine.fit(epochs=2)`` of ``paper_train`` with
               ``SamplerConfig(backend="device")``: 6 steps through K3 (the
               generation swaps once), then ``evaluate``; K3's counter,
               zeroed just before, must equal steps plus eval batches.  (B)
               the host backend with ``input_impl="fused"``,
               ``fit(epochs=1, max_batches=2)`` and one eval batch through
               K1.  Losses must be finite; each prints its losses, its step
               time (CUDA events; median of the last 3 steps) and the
               meter's sample / copy / compute split; every K3 launch of
               (A) and every K1 launch of (B) must take the vector path
               (D = 100);
   Then one more step of (A) under ``torch.profiler``: the device's busy
   time against the step's wall time, and the largest device and host
   entries (after the counted run, so it adds no launch to the counts;
   so are the baselines' profiled steps in 7.);
6. train-parity — one step of (A) at batch 250 on the card against the same
               engine on the CPU from the same parameters and seeds: loss
               (rtol 1e-4) and updated parameters (rtol 1e-4, atol 1e-5)
               allclose — cuBLAS and the CPU order the f32 sums of the matmuls
               differently, and the reference aggregation's backward sums by
               ``index_add_`` in no fixed order on the card;
7. baselines — the paper's baselines ``ns``, ``ladies`` and ``lazygcn`` on
               the same dataset, each a ``GNSEngine`` on the host backend
               with ``input_impl="fused"`` (no feature store: a 1-row dummy
               cache, every K1 lane a miss): ``fit(epochs=1,
               max_batches=3)`` and one eval batch, K1's counters zeroed
               just before each and read just after: its launches must
               equal steps plus eval batches, all on the vector path;
               losses finite; LazyGCN's recycled steps (no bytes streamed)
               where the reference's schedule puts them.  One line per
               sampler: step ms (CUDA events, median), the meter's sample /
               slice / copy / compute split per step, input nodes, isolated
               rows and streamed bytes per batch; then one more step of
               each (LazyGCN: a fresh and a recycled one, which reuses the
               fresh one's device copy) under ``torch.profiler``, as (A)'s,
               with each step's ``Memcpy HtoD`` and host ``aten::copy_``
               time and count.  Then one LADIES step at
               batch 250 on the card against the CPU (6.'s tolerances); a
               checkpoint round trip: ``save`` the trained engine of (A),
               ``restore`` it into a fresh card engine and a CPU engine
               (every parameter and moment equal); and ``describe()`` of
               every engine;
8. k4-parity — K4 against its plain version on the card, f32 and bf16, at
               (a) the enc-dec serve shape (B=4, 16 heads, 1 query over 1024
               keys, Dh=64), (b) qwen2-7b's geometry (28/4 heads, Dh=128,
               4096 causal), (c) h2o-danube3's (32/8 heads, Dh=120, 8192
               causal, window 4096) and (d) the JAX kernel tests' small
               cases (MQA, a poisoned tail past ``kv_len``, odd lengths
               37/53) with few-row and Dh-256 cases, each on the route
               ``flash_attention_cuda`` picks (split-KV for at most 16 rows
               per (batch, kv head), else the tensor cores in bf16 and the
               CUDA cores in f32; the route counters must show it, and
               every route must be met).  f32 within 2e-5 at (a) and (d),
               1e-4 at (b) and (c)
               (the online and the full softmax sum in other orders); bf16
               within rtol 1e-2, atol 4e-3 (both round the same f32 value
               once, so they differ by at most one bf16 ulp, <= 2^-7 |x|);
9. lm-serve  — ``seamless-m4t-medium`` at its published width (12 + 12
               layers, d_model 1024, 16 heads, vocab 256,206, bf16) with
               ``attn_impl="pallas"`` and random weights from ``SEED``:
               ``ServeEngine(max_batch=4).generate_batch`` serves 8 requests
               in 2 batches (prompts of 32 tokens, 32 new tokens, 1024 stub
               frames per request).  Every token must lie in the vocabulary,
               every step's logits must be finite, and K4's counter, zeroed
               just before, must equal 12 calls per single-token decode
               step (744), every one on the split-KV route (its route
               counter).  Then one more decode step of a batch, twice
               from the same state: its 12 K4 calls each held to the plain
               version on their own operands (the bf16 tolerance of 8.),
               and its logits to those of ``attn_impl="reference"`` within
               2^-6 of their largest magnitude (2-4 bf16 ulps).  Then 3 more
               decode steps of one batch under
               ``torch.profiler``: device busy time against the step time,
               and K4's kernels' share of the busy time;
10. lm-parity — the reduced ``seamless`` config (f32, ``attn_impl="pallas"``)
               with the same parameters on the card and on the CPU: the
               ``decode_step`` logits of one prefill and three
               teacher-forced single-token steps allclose (rtol 1e-4, atol
               1e-5: cuBLAS and the CPU order the f32 sums differently);
    lm-train — ``seamless-m4t-medium`` at its published width, 6 + 6 of
               its 12 + 12 layers (cut: depth; bf16,
               ``remat=True``, ``attn_impl="pallas"``) through
               ``launch.train.train_loop``: 8 steps at batch 8, seq 256 (64
               stub frames + 192 tokens); every loss finite, the first
               within 1.0 of ln V, the last below the first.  Then 6 steps
               with a checkpoint every 4 (under ``build/``, removed after)
               and a resume to 8: resumed from step 4, steps 5-8 within
               rtol 2e-3 of the uninterrupted run's (whether bit for bit is
               logged).  Logs ms per step after the
               first, positions and decoder tokens per second, the
               checkpoint's size;
    lm-train-dec — ``gemma-2b`` at its published width (tied 256,000-entry
               embedding, MQA, head_dim 256): 2 ``make_train_step`` steps
               at batch 2, seq 1,024, ``remat=True``; then the plain-CE loss
               and one step with ``chunked_ce=512, bf16_grad_stream=True``
               from the same parameters and batch: the losses within rtol
               5e-3; then one more step with its loss-and-gradients and its
               AdamW update timed apart (CUDA events), each half's own
               peak memory beside it; losses finite, no NaN parameter,
               peak memory under 80 GB;
    lm-train-moe — ``deepseek-v2-236b`` at its published widths, 2 of 60
               layers (the dense first layer and one MoE layer: 5.36 B
               parameters): (a) one random leaf of 3·2^26 + 12,345
               elements updated over AdamW's slices and as one slice, bit
               for bit; (b) ``train_loop``, 3 steps at batch 2, seq 1,024
               (bf16, remat, f32 moments, clip 1.0): losses finite, peak
               memory under 80 GB; (c) from a fresh tree, one step's loss
               and gradients and its AdamW update timed apart (the
               update beside its bound), no gradient leaf non-finite; (d)
               the loss and gradients twice on the same parameters and
               batch, bit for bit (integer checksums of each gradient
               leaf's bits).  Alone: ``PYTHONPATH=src python3 -c "import
               chip_smoke as c; c.phase_lm_train_moe()"``;
    lm-serve-dec — ``h2o-danube-3-4b`` at its published width (SWA window
               4,096, ``attn_impl="pallas"``): ``ServeEngine(max_batch=2)``
               serves 2 requests of 4,032 prompt tokens and 128 new tokens,
               so the ring cache wraps at decode step 64: tokens in the
               vocabulary, logits finite, every layer's ``slot_pos`` the
               last 4,096 absolute positions, and ``lm_forward`` over the
               4,159 tokens without a cache within 2^-5 of the largest
               logit of the last decode step's logits.  Logs prefill ms
               and ms per token beside the step's bound (weights and ring
               over the HBM rate), then profiles 3 more decode steps as
               ``lm-profile`` does;
    lm-train-xlstm — ``xlstm-125m`` at its published width, 6 of its 12
               blocks (d_model 768, the sLSTM at 3; the one at 9, the
               same code, cut to keep the script within 960 s;
               tied 50,304 vocab, bf16, remat) through ``train_loop``:
               2 steps at batch 8 × 1,024,
               then 1 step with a checkpoint and a resume to 2: the
               resumed loss bit for bit the uninterrupted run's, losses
               finite, the last below the first.  Then two more steps
               timed (CUDA events) in turns
               with the sLSTM blocks alone (forward, remat recompute,
               backward; their share of the step), one step profiled
               (device launches, busy ms), and the loss
               with ``xlstm.chunk=256`` against ``chunk=0`` on the same
               parameters and batch (rtol 2e-3);
    lm-train-zamba2 — ``zamba2-2.7b`` at its published width (54 Mamba2
               layers, d_model 2,560, 80 SSD heads, d_state 64, chunk 128,
               one shared MHA + FFN block run 9 times, bf16, remat): 3
               ``make_train_step`` steps at batch 2 × 1,024, then one more
               with its loss-and-gradients and AdamW timed apart: losses
               finite, every gradient and parameter finite;
    lm-serve-rec — ``ServeEngine`` over the recurrent families at their
               published widths: xlstm-125m (``max_batch=4``) 4 requests of
               512 prompt and 128 new tokens, zamba2-2.7b (``max_batch=2``)
               2 of 512 + 64.  The prompt runs through ``decode_step`` (the
               recurrent forms); with the weights cast to f32 its last
               logits must be within 2^-5 of the largest logit of the
               parallel forward's at the last position (in bf16 the two
               forms part by up to a third of it, in the reference too:
               logged); tokens in the vocabulary, ``pos`` the tokens fed,
               zamba2's 9 KV groups distinct.  Logs prefill ms, ms a token
               beside the step's bound (weights and state read, state
               written, over the HBM rate), then profiles 3 decode steps;
    lm-serve-moe — the MoE family at its published widths, bf16, depth
               cut: deepseek-v2-236b at 3 layers (its dense first layer
               and 2 MoE layers, MLA attention; 9.33 B parameters) and
               arctic-480b at 1 layer (14.07 B), each through
               ``ServeEngine(max_batch=4).generate_batch``: 4 requests of
               512 prompt and 64 new tokens, served twice: tokens in the
               vocabulary, logits finite, and the second run's tokens and
               last logits bit for bit the first's (the combine has no
               atomics).  The second run records each MoE layer's
               capacity and the share of token-expert choices dropped at
               prefill and at the first decode step.  Then the first MoE
               layer's weights on 2 x 128 random activations through
               ``moe_forward`` on a dropless copy of the config (capacity
               factor E / k, so C = T) against the plain form (each
               token's top-k experts' FFNs weighted and summed in f32),
               within 2^-5 of its largest output; and (deepseek) the
               first attention layer in f32, TF32 off: a 128-token
               prefill into the compressed cache and one absorbed decode
               step against the expand form over the 129 tokens without a
               cache, within 1e-4 of its largest output.  Logs parameters,
               init time and peak, prefill ms, ms a token beside the
               step's bound (all weights and the cache over the HBM rate:
               every expert gets at least one slot a step), the cache's
               bytes a token a layer (MLA: beside a per-head K/V cache of
               128 heads), the second (recorded) run's times too (warm,
               with one read-back a MoE layer a step), then profiles 3
               decode steps;
    lm-serve-sc — ``starcoder2-7b`` served whole at its published widths
               (32 layers, d_model 4,608, 36/4 heads, non-gated GELU FFN
               of 18,432, attention biases, untied 49,152 vocabulary;
               7.40 B parameters, bf16, ``attn_impl="pallas"``) through
               ``ServeEngine(max_batch=4).generate_batch``: 4 requests of
               512 prompt and 64 new tokens; tokens in the vocabulary,
               logits finite, and ``lm_forward`` over the 575 tokens
               without a cache within 2^-5 of the largest logit of the
               last decode step's.  Logs prefill ms and ms a token beside
               the step's bound (weights and cache over the HBM rate),
               then profiles 3 decode steps (launches a step);
    lm-serve-vlm — ``internvl2-1b``'s backbone served whole (24 layers,
               d_model 896, 14/2 heads, tied 151,655 vocabulary; 0.49 B
               parameters) as ``lm-serve-sc``, on tokens (the reference's
               engine has no patch path);
    lm-train-vlm — ``internvl2-1b`` at all 24 layers (bf16, remat): 3
               ``make_train_step`` steps at batch 2 × 1,024, each 256
               patch embeddings before 768 tokens (the vision prefix),
               then one more with its loss-and-gradients and AdamW timed
               apart (the update beside its bound): losses finite, no
               gradient or parameter leaf non-finite;
    lm-train-sc — ``starcoder2-7b`` at its published widths as
               ``lm-train-vlm``, at 23 of its 32 layers, the most whose
               peak stays under 72 GB (all 32 need 88.8 GB of bf16
               parameters and gradients and f32 moments; a layer adds
               2.6 GB): the peak must stay under 72 GB; logs it beside the
               peak one layer more would reach;
    lm-train-parity — reduced seamless, gemma, danube, xlstm, zamba2,
               deepseek, arctic, qwen2-7b, starcoder2 and internvl2 (f32,
               remat; internvl2's batch with its patch embeddings) with the
               same parameters and batch on the card and on the CPU: loss
               and every gradient allclose (rtol 1e-4, atol 1e-5; xlstm
               atol 1e-4, its tied embedding's f32 gradients sit up to
               4.7e-5 from an f64 evaluation on the CPU alone).
    Each of these twelve phases zeroes the kernels' launch counters and the
    peak-memory mark first, logs its wall time and
    ``torch.cuda.max_memory_allocated()``, fails if any kernel (K4
    included) was launched (the reference runs ``mha_ref`` in training and
    in decoder-only and hybrid decode), and frees what it allocated;
11. mesh     — the row-sharded cache and DP > 1 over ``torch.distributed``
               ranks, all on ``cuda:0`` over gloo (one card: NCCL refuses
               two ranks on one GPU), spawned by
               ``repro_torch.launch.mesh.run_ranks`` after this process
               built the kernels (the ranks load them), each spawn with a
               deadline of 300 s; any rank that fails or outlives it fails
               the phase.  A 2-rank world runs the cache in 2 shards (mesh
               (1, 2)) and then DP over 2 groups (mesh (2, 1)); a 4-rank
               world runs (2, 2).  In the ranks: the sharded K1 at the
               training (B) shape and at b=512 on integer-valued operands,
               for its psum, static and per-group (dynamic) paths, bit for
               bit single-rank K1 on the same operands, with K1 launched
               only by the owner under the static and per-group paths; K3
               over each shard's row range at the training (A) shape, bit
               for bit its plain version, and on exact operands the
               shards' sum bit for bit the full-range call; the
               ``all_reduce`` time of a [176,000, 100] f32 output over the
               cache group.  On the 2 shards, (A) ``fit`` 3 steps, (B) 2
               steps and ``infer`` of 600 ids with the served config (K1
               per shard, K2 replicated): step losses within 1e-5 and logits
               within 1e-4 of the same runs on one rank in this process.
               DP runs (B) for 2 epochs (a step takes one batch per group):
               the parameters bit for bit equal on every rank.  The one-rank
               runs pad the cache to 2 shards (306 rows, not 305), as the
               mesh's shards do, so both draw the same members.  Logs
               per rank and run: losses, step ms beside the one-rank step,
               K1/K2/K3 launches by access path (their sum over the ranks
               is ``launches_by_path["mesh"]``), ``bytes_cache_upload``;
12. mesh-serve — serving, the fabric, streaming ingest and checkpoints
               on a mesh, ranks on ``cuda:0`` over gloo as in 11.  A
               2-rank world, mesh (1, 2): (a) the served ``paper_train``
               config (hidden 256, fanouts (5, 10, 15), buckets
               32/128/512), its cache padded to 2 shards, behind
               ``GNSServer``: 24 requests one at a time, the same as a
               one-rank server in this process gets (bucket and generation
               equal, logits within rtol 1e-4, atol 1e-4; whether the
               ranks' logits agree bit for bit is logged), then 64 requests
               in waves over all three buckets; (c) preset
               ``stream_replay`` at its own width behind a 2-worker fabric
               while the leader ingests 4 temporal event batches: every
               rank ends merged at one generation with the same members,
               new nodes served; then a fresh mesh engine merges the same
               events and ``infer``s the new nodes and 200 others, within
               rtol 1e-4, atol 1e-4 of a one-rank card engine that did the
               same; (d) that engine, with 4 staged deltas, ``save``s on
               the mesh and a one-rank card engine restores it: parameters
               bit for bit, the delta log equal.  A 4-rank world, mesh (2,
               2): (b) the fabric phase's tenants, 4 waves and mid-wave
               kill (108 requests, a failover and a retry at least, 0
               errors; the killed worker dies on every rank).  On every
               rank K1's and K2's counters, zeroed just before each main
               path, must be above 0 and all on the vector path; their sum
               over the ranks is ``launches_by_path["mesh_serve"]``.  Logs
               p50/p99, each rank's all_reduce ms per batch (CUDA events
               on the stream around each, ``kernels.ops.psum_clock``) and
               the phase's wall time.  (e)
               ``ServeFabric(transport="tcp")`` over mesh endpoints: two
               ``python -m repro_torch.rpc.endpoint`` worlds, each (2, 2)
               on ``cuda:0``, and the coordinator, one process as the
               reference's is (``GNSEngine.coordinator`` of the (2, 2)
               config in this process: no process group, the cache's 2
               shards), at the served config: 12 requests pinned to the
               workers in turn, one at a time, the same as a one-rank
               inproc fabric with its cache padded to 2 shards gets (bucket and
               generation equal, logits within rtol 1e-4, atol 1e-4);
               then the reference rpc smoke's traffic (two tenants, 40
               requests, 4 pinned to worker 0 as endpoint 0's leader is
               SIGKILLed, 6 more): 0 errors, a failover and a retry,
               ``healthy() == [1]``, STATS from worker 1 only, a
               routed-local share above 0.5, endpoint 0's other ranks
               gone within 30 s.  A SHUTDOWN stops the survivor, whose 4
               ranks must each show K1 and K2 launches, all on the vector
               path, and the same batch count; their sum is
               ``launches_by_path["tcp_mesh"]``.  Logs per-tenant p50/p99,
               rpc wait p50/p99, endpoint ready s, the coordinator's ready
               s, each rank's all_reduce ms per batch, the wall times, and
               the meshless tcp phase's p99 beside them;
13. lm-train-mesh — the LM zoo trained on a mesh of ranks
               (``train_loop(mesh=)``: tensor parallelism over ``model``,
               expert parallelism, data parallelism, ZeRO-3), ranks on
               ``cuda:0`` over gloo as in 11, random weights.  First, in
               this process: one rank's ``train_loop`` of (a) and (b) and
               one rank's MoE layer of (c), then ``free_card``.  (a)
               ``gemma-2b`` at its published width, 9 of 18 layers (cut:
               depth; bf16, remat, tied
               256,000 vocab split over the ranks, MQA: its one K/V head
               gathered, ``chunked_ce=512``) on (1, 2), 3 steps at 2 x
               1,024: losses within 2^-7 relative at step 0 and 2^-5
               after of one rank's on the same seed and batches, the
               replicated leaves (norms) equal on both ranks bit for bit;
               (b) ``seamless-m4t-medium`` at its width on (2, 1), 2 steps
               at 8 x 256 (4 rows a rank), the same bounds against one
               rank at batch 8, the parameters equal on both ranks bit
               for bit; each logs per rank ms a step, the last step
               profiled (device busy ms beside its wall ms), collectives a
               step (calls and MB by kind), peak GB, and (a) one 8 MB
               all_reduce's ms, (b) the step's gradient all_reduce timed
               alone; (c) ``deepseek-v2-236b``'s MoE layer at its width
               (160 experts, 80 a rank, 2 shared; bf16) expert parallel on
               (1, 2) over 4 x 64 tokens, within 2^-5 of one rank's
               largest output (each rank's combine rounds to bf16 before
               the sum over the ranks, as the reference's psum: a few
               ulps); (d) reduced gemma-2b, qwen2-7b, and
               deepseek and arctic with ``fsdp=True`` in f32 (TF32 off) on
               (1, 2), (2, 1) and (2, 2), card ranks against the same runs
               on CPU gloo ranks, parameters drawn on the CPU: losses
               within 1e-5 relative, parameters within 1e-5 but for at
               most 1 element in 10,000 of the tree and within 2·lr a
               step everywhere (the key bias to that bound alone: its
               true gradient is 0).  Tensor parallelism for the enc-dec
               and recurrent families: (e) seamless at its width on
               (1, 2), 2 steps at 8 x 256 (heads, cross-attention
               head-local, the 256,206 vocab split in two), against (b)'s
               one rank; (f) ``xlstm-125m`` at its width, 6 of 12 blocks
               (the sLSTM at 3; cut: depth), on
               (1, 2) and (1, 4) (its 4 heads: 2 and 1 a rank), 2 steps
               at 4 x 512; (g) ``zamba2-2.7b`` at its width, 12 of 54
               layers (2 shared-block invocations; cut: depth), on
               (1, 2), 3 steps at 2 x 1,024 (Mamba2's ``in_proj``
               columns gathered as activations); each against one rank's
               run in this process on the same seed, depth and batches,
               with (a)'s bounds and the leaves left whole equal over the
               group bit for bit; (d) also trains reduced seamless,
               xlstm and zamba2 (xlstm's share beyond 1e-5 logged beside
               the CPU ranks' one-ulp floor: MESH_REDUCED_NOISY), each
               CPU world in the background beside the next card worlds.
               Each full-width run logs per rank its losses and their error,
               ms a step beside one rank's, peak GB, collectives a step.
               The ranks' K1-K4 counters stay 0;
14. vocab-cache — ``data/vocab_cache.py`` on the card: gemma-2b's
               vocabulary and width as a host table (256,000 x 2,048
               f32, 2.1 GB, seed ``SEED``), 1% of its rows (2,560,
               21 MB) cached on the card, the Zipf ``SyntheticCorpus``,
               20 batches of 8 x 1,024 tokens, a refresh every 5
               batches, strategies ``topk`` and ``sampled``: every
               batch's ``embed_with_cache`` on the card equal to
               ``table[tokens]`` bit for bit, and the last batch's
               ``sampled_softmax_loss`` within 1e-5 relative of the
               CPU's on the same inputs (TF32 off).  Logs the hit rate,
               the streamed bytes against those of a lookup of every
               row (and of every distinct row), the refresh, assembly
               and lookup times; K1-K4 launch 0 times;
15. lm-serve-mesh — the LM zoo served on a mesh of ranks on ``cuda:0``
               over gloo (``launch/serve.py::mesh_generate``), bf16 at
               published widths, seeded weights, depth cut:
               ``qwen2-7b`` (14 of 28
               layers; Hkv 4, a head-local cache) on (1, 2), prefill 4 x
               512 then 16 decode steps; ``deepseek-v2-236b`` at 3 of 60
               layers (MLA absorbed and head-local, 80 experts a rank),
               ``zamba2-2.7b`` at 12 of 54 and ``xlstm-125m`` at 6 of 12
               (recurrent
               decode on their heads) on (1, 2), the same batch (xlstm
               also in f32, where the logits must agree within 1e-2); ``h2o-
               danube-3-4b`` at 12 of 24 layers on (2, 1) at B = 1,
               4,032 + 72 tokens
               (the ring wraps at decode step 64) through its 4,096-slot
               ring split over the data ranks
               (2,048 a rank); ``deepseek-v2-236b`` at 3 of 60 layers on
               (1, 3), 4 x (512 + 33) — 3 divides neither its 160 experts
               nor its 128 heads: the MoE layer's single-device branch
               with the experts split along f (w1/w3 [160, 5120, 512], w2
               [160, 512, 5120] a rank, logged and checked) and MLA over
               all heads on every rank (``q_up`` a column block gathered
               whole; ``k_up``, ``v_up``, ``wo`` and the 102,400 vocab
               whole), the leaves' specs and local shapes logged; then in
               that world its MoE layer at full width (bf16) forward and
               backward over 4 x 64 tokens, the output and every gradient
               (each rank's blocks) within 2^-5 of one rank's largest
               |value| (``lm-train-mesh-moe``'s rule); cut: depth.  Then a
               (2, 3) world of 6 ranks (``SIX_MESH``: data > 1 beside a
               model axis of 3) serves nothing: deepseek's MLA layer
               (128 heads, ``q_up`` the one split leaf) and MoE layer
               (experts split along f) at full width, bf16, each data
               rank on its 2 x 64 rows of the 4 x 64 tokens, forward and
               backward against one rank's run of the whole batch (the
               global batch routing sees; the other rows' output weights
               zeroed), the same rule; the split and local shapes
               checked, peak GB a rank logged (``[lm-mesh-six-mla]``,
               ``[lm-mesh-six-moe]``).  Each
               run is held to one rank's run from the same weights in
               rank 0's process: the mesh run is teacher-forced by its
               greedy tokens, so every
               step's logits compare (largest difference logged), and a
               greedy flip counts only where one rank's top-two gap at
               that step is within ``SERVE_MESH_TIE``.  Logs ms a token
               per rank beside one rank's, collectives a step (calls and
               MB, from the recorder), peak GB a rank; K1-K4 launch 0
               times;
16. dryrun   — every (arch x shape) cell of the 16x16 mesh counted, and
               each arch's ``MULTIPOD_SHAPE`` (train_4k: the data group
               over pod x data, the collectives that span nodes) on the
               2x16x16 mesh run with no counts (cut: from 40 multi-pod
               cells to 10; the CPU tests hold every cell,
               ``tests/test_torch_dryrun.py``)
               (``launch/dryrun.py::run_cell``: rank 0's step on ``meta``
               tensors over a ``fake`` world), then ``dryrun-gnn``
               (papers100M's GNS step on both meshes): in a process of
               its own on the host's CPU, started after phase 0 and
               joined here, its lines printed then; each cell logs its
               dominant term and three terms at the H100, arg and peak
               GB a device, whether it fits 80 GB and ``count_s``;
17. roofline-calib — gemma-2b trained at 2 x 1,024 on one rank: the
               dry-run's (1, 1) FLOPs and bytes equal the same counter's
               over the real CUDA step, the predicted peak within
               ``CALIB_PEAK_MARGIN`` of ``max_memory_allocated``, and the
               step timed by CUDA events gives the measured roofline
               fraction ``model_flops / (step_s · 989e12)``; then each
               of qwen2-7b's (1, 2) serving ranks: its allocation with
               its parameters and decode state within
               ``CALIB_ARG_MARGIN`` of the dry-run's arg bytes, and its
               decode step's collectives the dry-run's list;
18. times    — each kernel's median time over cold-L2 launches at the
               serving and training shapes (K1 also at LADIES's: B = 2,024
               rows of 32 lanes over 2,536 streamed rows, all misses), in
               turns within this call with
               the plain version and, where one PyTorch call computes the
               same function, that call (``embedding_bag`` for the gathers;
               for K1 over its lanes resolved ahead into one table, gather
               only; ``scaled_dot_product_attention`` for K4), and its
               bound.  K1 is held bitwise to its plain version at both
               training shapes first; K4 at (a)-(c) in bf16 also takes turns
               with the CUDA-core kernel (route (iii) by name, ``prev_ms``,
               the design the other routes replace on these shapes).

Then one JSON line with every kernel's numbers, the card's name and power
limit as ``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero.  Without a CUDA card, or without ``src/repro_torch`` beside
it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
HBM_MS = HBM_BYTES_PER_S / 1e3   # bytes per ms
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 dense on the tensor cores
BUCKETS = (128, 512)           # timed / parity-checked serving shapes
REPS = 30                      # timed launches per measurement
SEED = 0
PARITY_BATCH = 250             # train-parity batch (the CPU runs it too)
METER_TIMES = ("t_sample", "t_slice", "t_copy", "t_compute", "t_refresh")
ANALYSIS_RULES = {"lock-unguarded-write", "lock-unguarded-read",
                  "lock-external-access", "gen-chained-read",
                  "gen-multi-read", "gen-direct-private",
                  "meter-unpaired-transfer", "retrace-pad-registry",
                  "retrace-scalar-arg", "retrace-scalar-flow",
                  "trace-nondeterminism", "trace-global-state",
                  "trace-self-mutation", "trace-mutation",
                  "trace-host-branch", "trace-root-missing"}
REFERENCE_TRACE_ROOTS = 19     # distinct roots of the reference's analyzer
REFERENCE_TRACED = 68          # the functions they reach


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


class PhaseClock:
    """``[phase-clock]`` lines from the script's start."""

    def __init__(self) -> None:
        self.start = self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        """One line: the seconds since the last one (or the start), so the
        lines sum to the whole run, and since the start."""
        now = time.perf_counter()
        log("phase-clock", name=name, seconds=round(now - self.last, 3),
            since_start=round(now - self.start, 3))
        self.last = now


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gnscheck(*args: str) -> tuple[subprocess.CompletedProcess, float]:
    """``python -m repro_torch.analysis --json *args`` with
    ``PYTHONPATH=src``, and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    return proc, time.perf_counter() - t0


def phase_analysis() -> None:
    """The port's tree clean against its empty baseline, every reference
    trace root's counterpart resolved; every ported rule firing on the
    fixtures."""
    proc, s = gnscheck("--baseline",
                       str(ROOT / ".github" / "gnscheck-torch-baseline.txt"))
    if proc.returncode != 0:
        raise RuntimeError(f"analysis: exit {proc.returncode} on "
                           f"src/repro_torch\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout)
    if out["violations"] or out["new"] or out["stale_baseline"]:
        raise RuntimeError(f"analysis: findings on src/repro_torch: {out}")
    fx, fx_s = gnscheck("--root",
                        str(ROOT / "tests" / "analysis_fixtures_torch"))
    if fx.returncode != 1:
        raise RuntimeError(f"analysis: exit {fx.returncode} on the "
                           f"fixtures, expected 1\n{fx.stderr[-4000:]}")
    fired = {v["rule"] for v in json.loads(fx.stdout)["violations"]}
    if fired != ANALYSIS_RULES:
        raise RuntimeError(f"analysis: rules not firing on the fixtures: "
                           f"{sorted(ANALYSIS_RULES - fired)}, unknown: "
                           f"{sorted(fired - ANALYSIS_RULES)}")
    st = out["stats"]
    if st["transfers"] < 3 or st["paired_transfers"] != st["transfers"]:
        raise RuntimeError(f"analysis: transfer sites {st}")
    if st["trace_roots"] < REFERENCE_TRACE_ROOTS \
            or st["traced_functions"] < REFERENCE_TRACED:
        raise RuntimeError(f"analysis: trace region {st}")
    log("analysis", modules=st["modules"],
        guarded_classes=st["guarded_classes"],
        thread_entries=st["thread_entries"], transfers=st["transfers"],
        paired=st["paired_transfers"], trace_roots=st["trace_roots"],
        traced_functions=st["traced_functions"],
        findings=len(out["violations"]), s=round(s, 3),
        fixture_rules=len(fired), fixture_s=round(fx_s, 3))


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def bound_ms(n_bytes: int, n_flops: int,
             flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over
    ``flops_per_s``, in ms, and which of the two it is."""
    t_bytes = n_bytes / HBM_MS
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_work(feat, idx, w) -> tuple[int, int, int]:
    """Bytes and flops K2 needs on these inputs: each distinct row that a
    lane with w != 0 reads, idx and w once, the output once; two flops per
    element of a live lane.  Also the bytes of the kernel's own reads, one
    row per lane (B*K*D*elt + B*K*8 + B*D*4)."""
    import torch
    live = w != 0
    rows = torch.unique(idx[live]).numel()
    d = feat.shape[1]
    io = idx.numel() * 8 + idx.shape[0] * d * 4
    n_bytes = rows * d * feat.element_size() + io
    lane_bytes = idx.numel() * d * feat.element_size() + io
    return n_bytes, lane_bytes, 2 * int(live.sum()) * d


def lookup_work(cache, streamed, slots, idx, w) -> tuple[int, int, int]:
    """Bytes and flops K1 needs: for each distinct input row that a live
    lane reads, its slot and its live row (cache row on a hit, streamed row
    on a miss), idx and w once, the output once.  Also the bytes of the
    kernel's own reads, a slot and a live row per lane (B*K*D*elt + B*K*12
    + B*D*4)."""
    import torch
    live = w != 0
    rows = torch.unique(idx[live]).long()
    hit = slots[rows] >= 0
    d = cache.shape[1]
    io = idx.numel() * 8 + idx.shape[0] * d * 4
    n_bytes = (int(hit.sum()) * d * cache.element_size()
               + int((~hit).sum()) * d * 4 + rows.numel() * 4 + io)
    lane_hits = int((slots[idx.long()] >= 0).sum())
    lane_bytes = (lane_hits * d * cache.element_size()
                  + (idx.numel() - lane_hits) * d * 4 + idx.numel() * 4 + io)
    return n_bytes, lane_bytes, 2 * int(live.sum()) * d


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def sample_work(adj, table, dst, fb_rows, lane_rows, lane_w
                ) -> tuple[int, int]:
    """Bytes and flops K3 needs on these inputs: dst_rows once, the
    fallback lanes of the uncached rows once, the CSR's four arrays once,
    each distinct table row that a live lane reads once, the output once;
    two flops per element of a live lane."""
    import torch
    live = (lane_rows >= 0) & (lane_w != 0)
    rows = torch.unique(lane_rows[live]).numel()
    bsz, k = fb_rows.shape
    d = table.shape[1]
    nnz = int(adj.indptr[-1])
    n_bytes = (bsz * 4 + int((dst < 0).sum()) * k * 8
               + (adj.indptr.numel() + nnz) * 4 + adj.deg.numel() * 8
               + rows * d * table.element_size() + bsz * d * 4)
    return n_bytes, 2 * int(live.sum()) * d


def train_config(path: str, batch_size: int = 1000):
    """Preset ``paper_train`` at full width for one training path:
    ``"device"`` (A) or ``"fused"`` (B)."""
    from repro_torch.gns import EngineConfig, ModelConfig
    cfg = EngineConfig.preset("paper_train", seed=SEED)
    backend = "device" if path == "device" else "host"
    return dataclasses.replace(
        cfg, sampling=dataclasses.replace(cfg.sampling, backend=backend,
                                          batch_size=batch_size),
        model=ModelConfig(hidden_dim=256,
                          input_impl="fused" if path == "fused" else "where"))


def serve_config():
    """Preset ``paper_train`` with the fused K1 input layer and the K2
    aggregation: the served engine's config."""
    from repro_torch.gns import EngineConfig, ModelConfig
    cfg = EngineConfig.preset(
        "paper_train", seed=SEED,
        model=ModelConfig(hidden_dim=256, aggregate_impl="pallas",
                          input_impl="fused"))
    # a 20 ms coalescing window (default 2 ms) so that each wave below lands
    # in one micro-batch; the buckets stay the default (32, 128, 512)
    return dataclasses.replace(
        cfg, serve=dataclasses.replace(cfg.serve, max_wait_ms=20.0))


def build_engine(ds):
    from repro_torch.gns import GNSEngine
    return GNSEngine(serve_config(), dataset=ds)  # on the GPU: no device=


def serving_shapes(engine, rng):
    """One prepared batch per timed bucket, its arrays on the card."""
    out = {}
    for b in BUCKETS:
        ids = rng.choice(engine.ds.graph.num_nodes, b, replace=False)
        mb = engine.infer_prepare(ids, bucket=b, rng=rng)
        out[b] = (mb, mb.device.to(engine.device))
        log("batch", bucket=b, input_rows_padded=len(mb.input_node_ids),
            input_nodes=mb.num_input, cached=mb.num_cached,
            streamed_mb=round(mb.device.input_streamed.nbytes / 1e6, 1),
            miss_mb=round(mb.bytes_streamed / 1e6, 2))
    return out


def phase_parity(engine, shapes, rng) -> dict:
    """Kernel vs plain version at the serving shapes.  Returns the largest
    |kernel - plain| on random f32 per (kernel, bucket, layer)."""
    import torch
    from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                                  cache_lookup_agg_plain)
    from repro_torch.kernels.gather_agg import (gather_agg_cuda,
                                                gather_agg_plain)
    dev = engine.device
    cases = (("int", torch.float32), ("rand", torch.float32),
             ("rand", torch.bfloat16))     # (data, table dtype)
    errs = {}

    def table(shape, kind, dtype=torch.float32):
        if kind == "int":
            a = rng.integers(-128, 129, shape).astype(np.float32)
        else:
            a = rng.normal(size=shape).astype(np.float32)
        return torch.from_numpy(a).to(dev, dtype=dtype)

    def weights(like, kind):
        if kind == "int":
            a = rng.integers(-8, 9, like.shape).astype(np.float32)
        else:
            a = like.cpu().numpy()       # the sampler's own weights
        return torch.from_numpy(a).to(dev)

    def hold(name, b, layer, kind, dtype, kernel, plain, args, idx):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.equal(got, want)
        log("parity", kernel=name, bucket=b, layer=layer, data=kind,
            table=str(dtype).removeprefix("torch."), B=idx.shape[0],
            K=idx.shape[1], D=got.shape[1], max_abs_err=err, ok=ok)
        if not ok:
            raise AssertionError(f"{name} b={b} layer {layer} {kind} "
                                 f"{dtype}: max err {err}")
        if kind == "rand" and dtype == torch.float32:
            errs[(name, b, layer)] = err

    cache_rows = engine.store.generation.table.shape[0]
    for b, (_, db) in shapes.items():
        blk0 = db.blocks[0]
        for kind, dtype in cases:
            args = (table((cache_rows, engine.ds.feat_dim), kind, dtype),
                    table(tuple(db.input_streamed.shape), kind),
                    db.input_cache_slots, blk0.nbr_idx,
                    weights(blk0.nbr_w, kind))
            hold("cache_lookup_agg", b, 0, kind, dtype,
                 cache_lookup_agg_cuda, cache_lookup_agg_plain, args,
                 blk0.nbr_idx)
        for li in (1, 2):
            blk = db.blocks[li]
            n_src = db.blocks[li - 1].nbr_idx.shape[0]
            for kind, dtype in cases:
                args = (table((n_src, engine.mcfg.hidden_dim), kind, dtype),
                        blk.nbr_idx, weights(blk.nbr_w, kind))
                hold("gather_agg", b, li, kind, dtype, gather_agg_cuda,
                     gather_agg_plain, args, blk.nbr_idx)
    return errs


def kernel_counters() -> tuple:
    """K1's, K2's and K3's launch counters and access-path counters."""
    from repro_torch.kernels import cache_lookup, gather_agg
    from repro_torch.sampling import kernels as k3
    return ({"cache_lookup_agg": cache_lookup.launches,
             "gather_agg": gather_agg.launches,
             "gns_sample_agg": k3.launches},
            {"k1": cache_lookup.path_calls, "k2": gather_agg.path_calls,
             "k3": k3.path_calls})


def reset_k12() -> None:
    """K1's and K2's launch and access-path counters to 0."""
    from repro_torch.kernels import cache_lookup, gather_agg
    for c in (cache_lookup.launches, gather_agg.launches,
              *cache_lookup.path_calls.values(),
              *gather_agg.path_calls.values()):
        c.reset()


def read_k12(engine, phase: str) -> dict:
    """K1's and K2's launches since :func:`reset_k12`; raises unless both
    ran and every launch took the vector path."""
    from repro_torch.kernels import cache_lookup, gather_agg
    counts = {"cache_lookup_agg": cache_lookup.launches.value,
              "gather_agg": gather_agg.launches.value}
    k1_paths = {p: c.value for p, c in cache_lookup.path_calls.items()}
    k2_paths = {p: c.value for p, c in gather_agg.path_calls.items()}
    if counts["cache_lookup_agg"] < 1 or counts["gather_agg"] < 1:
        raise AssertionError(f"{phase}: a kernel was never launched: "
                             f"{counts}")
    if k1_paths != {"vector": counts["cache_lookup_agg"], "scalar": 0}:
        raise AssertionError(f"{phase}: K1 left the vector path at D = "
                             f"{engine.ds.feat_dim}: {k1_paths}")
    if k2_paths != {"vector": counts["gather_agg"], "scalar": 0}:
        raise AssertionError(f"{phase}: K2 left the vector path at D = "
                             f"{engine.mcfg.hidden_dim}: {k2_paths}")
    return {"counts": counts, "k1_paths": k1_paths, "k2_paths": k2_paths}


def phase_serve(engine, rng) -> dict:
    """Serve request waves through GNSServer; returns the launch counts of
    this run (counters zeroed just before it, read just after)."""
    n_cls = engine.mcfg.num_classes
    num_nodes = engine.ds.graph.num_nodes
    # wave sizes in requests: 1 request (bucket 32), 7 (33..112 ids, bucket
    # 128 unless all are tiny), then 56 (bucket 512): 64 requests in all
    waves = [[int(rng.integers(1, 17))],
             [int(rng.integers(5, 17)) for _ in range(7)],
             [int(rng.integers(1, 17)) for _ in range(56)]]
    waves[1][0] = 16
    waves[1][1] = 16
    waves[1][2] = 16                  # >= 48 ids: never fits bucket 32
    reset_k12()
    t0 = time.perf_counter()
    results = []
    with engine.serve() as server:
        for sizes in waves:
            futs = [(n, server.submit(rng.integers(0, num_nodes, n)))
                    for n in sizes]
            for n, fut in futs:
                res = fut.result(timeout=300)
                if res.status != "ok":
                    raise AssertionError(f"request status {res.status}")
                if res.logits.shape != (n, n_cls) or \
                        not np.isfinite(res.logits).all():
                    raise AssertionError("bad logits for a served request")
                results.append(res)
    wall = time.perf_counter() - t0
    k12 = read_k12(engine, "serve")
    counts = k12["counts"]
    snap = server.meter.snapshot()
    buckets = sorted({r.bucket for r in results})
    log("serve", requests=len(results), batches=snap["batches"],
        buckets=buckets, launches_k1=counts["cache_lookup_agg"],
        launches_k2=counts["gather_agg"], k1_paths=k12["k1_paths"],
        k2_paths=k12["k2_paths"], k1_vector_path_at_d=engine.ds.feat_dim,
        k2_vector_path_at_d=engine.mcfg.hidden_dim, wall_s=round(wall, 3),
        total_p50_ms=snap["total_p50_ms"], total_p99_ms=snap["total_p99_ms"],
        cache_hit_rate=snap["cache_hit_rate"])
    if len(results) != 64:
        raise AssertionError(f"{len(results)} of 64 requests served")
    if buckets != [32, 128, 512]:
        raise AssertionError(f"buckets used {buckets}, expected all three")
    return counts


def phase_engine_parity(engine, rng) -> None:
    """The card's logits vs the same engine's plain path on the CPU."""
    import torch
    from repro_torch.models import graphsage
    params_cpu = {"layers": [{k: v.cpu() for k, v in layer.items()}
                             for layer in engine.params["layers"]]}
    for b in (32, 128, 512):
        ids = rng.choice(engine.ds.graph.num_nodes, b, replace=False)
        mb = engine.infer_prepare(ids, bucket=b, rng=rng)
        on_card = engine.infer_compute(mb)
        with torch.inference_mode():
            on_cpu = graphsage.forward(
                params_cpu, mb.device.to("cpu"), mb.cache_gen.table.cpu(),
                engine.mcfg).numpy()
        err = float(np.abs(on_card - on_cpu).max())
        ok = np.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)
        log("engine-parity", bucket=b, logits=list(on_card.shape),
            max_abs_err=err, ok=ok)
        if not ok or not np.isfinite(on_card).all():
            raise AssertionError(f"card vs CPU logits differ at b={b}: {err}")


# ---------------------------------------------------------------------------
# the multi-tenant fabric and streaming ingest
# ---------------------------------------------------------------------------

FABRIC_WAIT_S = 120.0           # bound on every wait of the two phases


def wait_for(pred, what: str, timeout: float = FABRIC_WAIT_S) -> None:
    """Poll ``pred`` until it holds; raise after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout} s: {what}")
        time.sleep(0.01)


def check_results(futs, n_cls: int, phase: str) -> list:
    """Every future ``ok`` with finite logits of its request's shape."""
    out = []
    for n, fut in futs:
        res = fut.result(timeout=FABRIC_WAIT_S)
        if res.status != "ok":
            raise AssertionError(f"{phase}: request status {res.status}")
        if res.logits.shape != (n, n_cls) or \
                not np.isfinite(res.logits).all():
            raise AssertionError(f"{phase}: bad logits for a request")
        out.append(res)
    return out


def check_fabric(fab, phase: str) -> dict:
    """No request failed inside a worker and no build failed inside the
    watchdog: both are absorbed there, so each is read here."""
    snap = fab.snapshot()
    if snap["errors"] != 0 or fab.fabric_error is not None:
        raise AssertionError(f"{phase}: errors={snap['errors']} "
                             f"fabric_error={fab.fabric_error!r}")
    return snap


def fabric_split(fab, snap) -> dict:
    """Where a request's time went: queue wait and batch compute (sample +
    copy + forward + readback) p50/p99, and the host->device copy's wall
    time per batch from the workers' own meters."""
    copy_s = sum(w.copy_meter.t_copy for w in fab.workers)
    return {k: snap[k] for k in ("queue_wait_p50_ms", "queue_wait_p99_ms",
                                 "compute_p50_ms", "compute_p99_ms",
                                 "fill_fraction")} | {
        "copy_ms_per_batch": round(copy_s / max(snap["batches"], 1) * 1e3,
                                   3)}


def phase_fabric(engine, rng) -> dict:
    """Serve about 100 requests of two tenants through a 2-worker
    ``ServeFabric`` over the ``paper_train`` serve engine, kill one worker
    mid-wave (its in-flight batch reclaimed and served by the survivor),
    then hold one prepared batch's logits bitwise across a forced refresh.
    Returns the K1/K2 launch counts of the fabric's run and the meter's
    snapshot after the 4 waves (before the kill)."""
    from repro_torch.gns import FabricConfig, TenantConfig
    n_cls = engine.mcfg.num_classes
    num_nodes = engine.ds.graph.num_nodes
    cfg = FabricConfig(workers=2, tenants=(
        TenantConfig("mobile", weight=2.0, max_queue=16),
        TenantConfig("batch", weight=1.0, max_queue=64)),
        stall_timeout_ms=10_000.0)
    fab = engine.serve_fabric(cfg)
    reset_k12()
    t0 = time.perf_counter()
    results = []
    with fab:
        # 4 waves of 12 mobile (1-8 ids) and 12 batch (4-16 ids) requests
        for _ in range(4):
            futs = []
            for i in range(24):
                tenant = "mobile" if i % 2 == 0 else "batch"
                n = int(rng.integers(1, 9) if tenant == "mobile"
                        else rng.integers(4, 17))
                futs.append((n, fab.submit(rng.integers(0, num_nodes, n),
                                           tenant=tenant)))
            results += check_results(futs, n_cls, "fabric")
        waves = fab.meter.snapshot()
        # chaos: worker 0 dies with its next batch in flight, mid-wave
        w0 = fab.workers[0]
        w0.kill()
        futs = [(8, fab.submit(rng.integers(0, num_nodes, 8),
                               tenant="mobile", worker=0))]
        futs += [(n, fab.submit(rng.integers(0, num_nodes, n),
                                tenant=("mobile", "batch")[i % 2]))
                 for i, n in enumerate(rng.integers(1, 17, 11))]
        wait_for(lambda: not w0.alive(), "the killed worker's thread ends")
        results += check_results(futs, n_cls, "fabric")
        wait_for(lambda: fab.healthy() == [1], "worker 0 leaves rotation")
    wall = time.perf_counter() - t0
    k12 = read_k12(engine, "fabric")
    snap = check_fabric(fab, "fabric")
    rt = snap["routing"]
    if rt["failovers"] < 1 or rt["retries"] < 1:
        raise AssertionError(f"fabric: the kill did not fail over: {rt}")
    if len(results) != 108:
        raise AssertionError(f"fabric: {len(results)} of 108 served")
    tenants = {t: (v["served"], v["total_p50_ms"], v["total_p99_ms"])
               for t, v in snap["tenants"].items()}
    log("fabric", requests=len(results), batches=snap["batches"],
        batches_per_worker=rt["worker_batches"],
        tenants_served_p50_p99_ms=tenants, failovers=rt["failovers"],
        retries=rt["retries"], healthy=fab.healthy(),
        launches_k1=k12["counts"]["cache_lookup_agg"],
        launches_k2=k12["counts"]["gather_agg"], k1_paths=k12["k1_paths"],
        k2_paths=k12["k2_paths"], total_p50_ms=snap["total_p50_ms"],
        total_p99_ms=snap["total_p99_ms"],
        waves_total_p99_ms=waves["total_p99_ms"], **fabric_split(fab, snap),
        wall_s=round(wall, 3))
    # the generation pin: a prepared batch computed before and after a
    # forced refresh publishes generation g+1 gives the same bits
    ids = rng.choice(num_nodes, 100, replace=False)
    mb = engine.infer_prepare(ids, bucket=128, rng=rng)
    before = engine.infer_compute(mb)
    v0 = engine.store.version
    engine.store.refresh(np.random.default_rng(SEED + 1), version=v0 + 1)
    after = engine.infer_compute(mb)
    same = np.array_equal(before, after)
    log("fabric-pin", batch_generation=mb.cache_version,
        live_generation=engine.store.version, bitwise_equal=same)
    if not same or engine.store.version != v0 + 1 or mb.cache_version != v0:
        raise AssertionError("fabric: a pinned batch changed across a swap")
    return k12["counts"], waves


# ---------------------------------------------------------------------------
# the RPC fabric: endpoint processes over TCP
# ---------------------------------------------------------------------------

TCP_SEED = SEED + 2            # the tcp phase's own requests
TCP_REQUESTS = 24              # sent one at a time, inproc then tcp


class Endpoint:
    """One ``python -m repro_torch.rpc.endpoint`` process on the card, its
    stdout lines read by a daemon thread (every read has a deadline) and
    its stderr in a file beside the config."""

    def __init__(self, cfg_path: Path, index: int, extra: tuple = ()):
        import os
        import queue
        import threading
        self.index = index
        self.err_path = cfg_path.parent / f"endpoint{index}.err"
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.rpc.endpoint",
                 "--config", str(cfg_path), "--index", str(index),
                 "--port", "0", *extra],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                stdout=subprocess.PIPE, stderr=err, text=True)
        self.lines = queue.Queue()
        self.pids = []                 # the other ranks of a mesh endpoint
        self.left = []                 # of those, alive after the wait
        self.t_dead = self.t_gone = None

        def pump():
            with self.proc.stdout:
                for line in self.proc.stdout:
                    self.lines.put(line)
            self.lines.put(None)                 # EOF

        threading.Thread(target=pump, daemon=True).start()
        self.port = None

    def line(self, tag: str) -> str:
        """The first stdout line that starts with ``tag``."""
        import queue
        deadline = time.monotonic() + FABRIC_WAIT_S
        while True:
            try:
                line = self.lines.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(
                    f"tcp: endpoint {self.index} printed no {tag} line "
                    f"(exit {self.proc.poll()}): "
                    f"{self.err_path.read_text()[-2000:]}")
            if line.startswith(tag):
                return line.strip()

    def ready(self) -> str:
        line = self.line("GNS_ENDPOINT_READY")
        kv = dict(f.split("=") for f in line.split()[1:])
        self.port = int(kv["port"])
        if "pids" in kv:
            self.pids = [int(p) for p in kv["pids"].split(",")]
        return f"127.0.0.1:{self.port}"

    def watch_death(self) -> None:
        """Record (wall clock) when the leader dies and when the last of
        its other ranks is gone, on a daemon thread."""
        import threading

        def gone(pid):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    return f.read().rsplit(")", 1)[1].split()[0] in "ZX"
            except (FileNotFoundError, ProcessLookupError):
                return True

        def watch():
            while self.proc.poll() is None:
                time.sleep(0.02)
            self.t_dead = time.time()
            while (time.time() < self.t_dead + 2 * RANKS_GONE_S
                   and not all(gone(p) for p in self.pids)):
                time.sleep(0.02)
            self.left = [p for p in self.pids if not gone(p)]
            self.t_gone = time.time()

        threading.Thread(target=watch, daemon=True).start()

    def check_running(self) -> None:
        if self.proc.poll() is not None:
            raise AssertionError(
                f"tcp: endpoint {self.index} exited on its own "
                f"({self.proc.returncode}): "
                f"{self.err_path.read_text()[-2000:]}")

    def reap(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=FABRIC_WAIT_S)


def tcp_requests(engine) -> list:
    """``TCP_REQUESTS`` requests of 2-8 validation ids, tenants
    alternating."""
    rng = np.random.default_rng(TCP_SEED)
    val = engine.ds.val_idx.astype(np.int64)
    return [("mobile" if i % 2 == 0 else "batch",
             rng.choice(val, int(rng.integers(2, 9)), replace=False))
            for i in range(TCP_REQUESTS)]


def one_at_a_time(fab, reqs) -> list:
    with fab:
        out = [fab.submit(ids, tenant=t).result(timeout=FABRIC_WAIT_S)
               for t, ids in reqs]
    check_fabric(fab, "tcp")
    if any(r.status != "ok" for r in out):
        raise AssertionError("tcp: a sequential request failed")
    return out


def phase_tcp(engine, inproc_waves: dict) -> tuple:
    """The served engine's config behind a 2-worker tcp fabric whose
    workers are two endpoint processes on this card (started after this
    process built the kernels, so they load the built extension).  (1)
    ``TCP_REQUESTS`` requests one at a time through an inproc fabric over a
    fresh engine from the same config, then through tcp: logits bit for
    bit, the same generation and bucket.  (2) The fabric phase's 4 waves
    of 24 requests through tcp: per-tenant p50/p99, rpc wait, batches per
    worker, wire bytes and the p99 ratio to the inproc fabric's waves.  (3)
    SIGKILL endpoint 0 with pinned requests in flight: every request served
    by worker 1, 0 errors, a failover, only worker 1 healthy and answering
    STATS.  (4) A SHUTDOWN frame to the survivor, which prints its K1 and
    K2 launches: each at least 1, all on the vector path.  Returns those
    counts and the waves' total p99 ms."""
    import os
    import signal
    import socket
    import tempfile
    from repro_torch.gns import (EngineConfig, FabricConfig, GNSEngine,
                                 TenantConfig)
    from repro_torch.rpc import wire
    from repro_torch.rpc.endpoint import LAUNCHES_TAG
    n_cls = engine.mcfg.num_classes
    num_nodes = engine.ds.graph.num_nodes
    (ROOT / "build").mkdir(exist_ok=True)
    eps = []
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="chip_smoke_tcp_") as d:
        cfg_path = Path(d) / "engine.json"
        cfg_path.write_text(json.dumps(engine.cfg.to_dict()))
        try:
            t0 = time.perf_counter()
            eps = [Endpoint(cfg_path, i) for i in range(2)]
            addrs = tuple(ep.ready() for ep in eps)
            t_ready = time.perf_counter() - t0
            tenants = (TenantConfig("mobile", weight=2.0, max_queue=16),
                       TenantConfig("batch", weight=1.0, max_queue=64))

            def tcp_fabric():
                return engine.serve_fabric(FabricConfig(
                    workers=2, transport="tcp", endpoints=addrs,
                    tenants=tenants, stall_timeout_ms=10_000.0))

            # (1) bitwise against inproc, one request at a time
            fresh = GNSEngine(EngineConfig.from_dict(
                json.loads(cfg_path.read_text())))
            reqs = tcp_requests(fresh)
            inproc = one_at_a_time(fresh.serve_fabric(FabricConfig(
                workers=2, tenants=tenants, stall_timeout_ms=10_000.0)),
                reqs)
            fab = tcp_fabric()
            tcp = one_at_a_time(fab, reqs)
            del fresh
            rpc = fab.rpc_traffic()
            same = all(np.array_equal(a.logits, b.logits)
                       and a.cache_version == b.cache_version
                       and a.bucket == b.bucket for a, b in zip(inproc, tcp))
            seq = [np.median([r.total_s for r in rs]) * 1e3
                   for rs in (inproc, tcp)]
            log("tcp-bitwise", requests=len(reqs), bitwise_equal=same,
                buckets=sorted({r.bucket for r in tcp}),
                generations=sorted({r.cache_version for r in tcp}),
                endpoints_ready_s=round(t_ready, 2),
                inproc_total_p50_ms=round(seq[0], 3),
                tcp_total_p50_ms=round(seq[1], 3),
                tcp_over_inproc_p50=round(seq[1] / seq[0], 3), **rpc)
            if not same:
                raise AssertionError("tcp: logits, generation or bucket "
                                     "differ from the inproc fabric")
            if rpc["bytes_rpc_tx"] <= 0 or rpc["bytes_rpc_rx"] <= 0:
                raise AssertionError(f"tcp: no wire traffic: {rpc}")

            # (2) the fabric phase's waves, then (3) the chaos
            rng = np.random.default_rng(TCP_SEED + 1)
            fab = tcp_fabric()
            t0 = time.perf_counter()
            with fab:
                for _ in range(4):
                    futs = []
                    for i in range(24):
                        tenant = "mobile" if i % 2 == 0 else "batch"
                        n = int(rng.integers(1, 9) if tenant == "mobile"
                                else rng.integers(4, 17))
                        futs.append((n, fab.submit(
                            rng.integers(0, num_nodes, n), tenant=tenant)))
                    check_results(futs, n_cls, "tcp")
                wall = time.perf_counter() - t0
                snap = check_fabric(fab, "tcp")
                for ep in eps:
                    ep.check_running()
                w0 = fab.workers[0]
                batches1 = snap["routing"]["worker_batches"].get(1, 0)
                futs = [(8, fab.submit(rng.integers(0, num_nodes, 8),
                                       tenant="batch", worker=0))
                        for _ in range(16)]
                wait_for(lambda: w0.inflight_count() > 0,
                         "a pinned request in flight on endpoint 0")
                os.kill(eps[0].proc.pid, signal.SIGKILL)
                wait_for(lambda: not w0.alive(), "worker 0's proxy ends")
                check_results(futs, n_cls, "tcp-chaos")
                wait_for(lambda: fab.healthy() == [1],
                         "worker 0 leaves rotation")
                remote = fab.pull_remote_stats(timeout=FABRIC_WAIT_S)
            chaos = check_fabric(fab, "tcp-chaos")
            rt, wrt = chaos["routing"], snap["routing"]
            tenants_ms = {t: (v["served"], v["total_p50_ms"],
                              v["total_p99_ms"])
                          for t, v in snap["tenants"].items()}
            log("tcp", requests=96, batches=snap["batches"],
                batches_per_worker=wrt["worker_batches"],
                tenants_served_p50_p99_ms=tenants_ms,
                total_p50_ms=snap["total_p50_ms"],
                total_p99_ms=snap["total_p99_ms"],
                rpc_wait_p50_ms=snap.get("rpc_wait_p50_ms"),
                rpc_wait_p99_ms=snap.get("rpc_wait_p99_ms"),
                queue_wait_p99_ms=snap["queue_wait_p99_ms"],
                compute_p50_ms=snap["compute_p50_ms"],
                compute_p99_ms=snap["compute_p99_ms"],
                inproc_waves_total_p99_ms=inproc_waves["total_p99_ms"],
                tcp_over_inproc_p99=round(snap["total_p99_ms"]
                                          / inproc_waves["total_p99_ms"], 3),
                wall_s=round(wall, 3), **fab.rpc_traffic())
            served_by_1 = rt["worker_batches"].get(1, 0) - batches1
            log("tcp-chaos", pinned=len(futs), failovers=rt["failovers"],
                retries=rt["retries"], healthy=fab.healthy(),
                worker1_batches_after_kill=served_by_1,
                remote_stats_from=sorted(remote),
                endpoint0_exit=eps[0].proc.wait(timeout=FABRIC_WAIT_S))
            if rt["failovers"] < 1 or served_by_1 < 1:
                raise AssertionError(f"tcp: the SIGKILL did not fail "
                                     f"over to worker 1: {rt}")
            if fab.healthy() != [1] or sorted(remote) != [1]:
                raise AssertionError(f"tcp: healthy {fab.healthy()}, "
                                     f"STATS from {sorted(remote)}")
            if eps[0].proc.returncode != -signal.SIGKILL:
                raise AssertionError("tcp: endpoint 0 was not the one "
                                     "killed")

            # (4) stop the survivor and read its launches
            eps[1].check_running()
            with socket.create_connection(("127.0.0.1", eps[1].port),
                                          timeout=FABRIC_WAIT_S) as sock:
                wire.send_frame(sock, wire.SHUTDOWN)
                line = eps[1].line(LAUNCHES_TAG)
            code = eps[1].proc.wait(timeout=FABRIC_WAIT_S)
        finally:
            for ep in eps:
                ep.reap()
    got = json.loads(line.removeprefix(LAUNCHES_TAG))
    counts = {k: got[k] for k in ("cache_lookup_agg", "gather_agg")}
    log("tcp-endpoint", index=got["index"], exit=code,
        launches_k1=counts["cache_lookup_agg"],
        launches_k2=counts["gather_agg"], k1_paths=got["k1_paths"],
        k2_paths=got["k2_paths"])
    if code != 0 or min(counts.values()) < 1:
        raise AssertionError(f"tcp: survivor exit {code}, launches {counts}")
    if (got["k1_paths"] != {"vector": counts["cache_lookup_agg"],
                            "scalar": 0}
            or got["k2_paths"] != {"vector": counts["gather_agg"],
                                   "scalar": 0}):
        raise AssertionError(f"tcp: a launch left the vector path: {got}")
    return counts, snap["total_p99_ms"]


def stream_config():
    """Preset ``stream_replay`` at its own width (scale 0.25, D = 100,
    hidden 256, fanouts (5, 10), two shards, locality placement, adaptive
    policy, buckets 32/128), with K1's input layer and K2's aggregation."""
    from repro_torch.gns import EngineConfig, ModelConfig
    return EngineConfig.preset(
        "stream_replay", seed=SEED,
        model=ModelConfig(hidden_dim=256, aggregate_impl="pallas",
                          input_impl="fused"))


def route_counts(fab) -> tuple:
    m = fab.meter
    with m.lock:
        return m.routed_known_ids, m.routed_local_ids


def phase_stream(rng) -> dict:
    """Serve preset ``stream_replay`` through a 2-worker fabric while a
    temporal event stream is ingested between request bursts; the watchdog
    drains the deltas into an async build and swaps it in; a new node is
    served.  Then one engine on the card and one on the CPU, same seeds and
    parameters, merge the same events: ``infer`` on the same ids (new nodes
    among them) within rtol 1e-4, atol 1e-4.  Returns the K1/K2 launch
    counts of the fabric's run."""
    from repro_torch.data import temporal_event_stream
    from repro_torch.gns import FabricConfig, GNSEngine
    cfg = stream_config()
    t0 = time.perf_counter()
    engine = GNSEngine(cfg)
    v0 = engine.ds.graph.num_nodes
    n_cls = engine.mcfg.num_classes
    val = engine.ds.val_idx.astype(np.int64)
    hot = (val[: len(val) // 2][:64], val[len(val) // 2:][:64])
    fab = engine.serve_fabric(FabricConfig(workers=2,
                                           stall_timeout_ms=10_000.0))

    def burst(n=16):
        futs = []
        for i in range(n):
            k = int(rng.integers(2, 9))
            futs.append((k, fab.submit(rng.choice(hot[i % 2], k,
                                                  replace=False))))
        return check_results(futs, n_cls, "stream")

    def local_fraction(c0, c1):
        known = c1[0] - c0[0]
        return round((c1[1] - c0[1]) / known, 4) if known else None

    events = temporal_event_stream(engine.ds, num_batches=4,
                                   events_per_batch=64, new_node_frac=0.1,
                                   seed=SEED)
    reset_k12()
    with fab:
        burst()                             # placement demand histograms
        c0 = route_counts(fab)
        served = len(burst())
        frac_before = local_fraction(c0, route_counts(fab))
        for ev in events:
            engine.ingest_events(ev)
            served += len(burst(8))         # serving never pauses
        v1 = v0 + events.total_new_nodes
        wait_for(lambda: engine.pending_deltas == 0
                 and engine.store.generation.graph.num_nodes == v1
                 and fab.router.table_version == engine.store.version,
                 "the merged generation swapped in")
        c1 = route_counts(fab)
        served += len(burst())
        frac_after = local_fraction(c1, route_counts(fab))
        new = np.arange(v0, v1, dtype=np.int64)[:8]
        out = fab.infer(new, timeout=FABRIC_WAIT_S)
        if out.shape != (len(new), n_cls) or not np.isfinite(out).all():
            raise AssertionError("stream: a new node's logits")
    wall = time.perf_counter() - t0
    k12 = read_k12(engine, "stream")
    snap = check_fabric(fab, "stream")
    st = engine.describe()["stream"]
    log("stream", nodes_before=v0, nodes_after=engine.ds.graph.num_nodes,
        events=events.total_events, new_nodes=events.total_new_nodes,
        merges_applied=st["merges_applied"],
        rows_migrated=st["rows_migrated"],
        swaps_observed=snap["swaps_observed"],
        route_local_before=frac_before, route_local_after=frac_after,
        requests=served + 1, batches=snap["batches"],
        launches_k1=k12["counts"]["cache_lookup_agg"],
        launches_k2=k12["counts"]["gather_agg"], k1_paths=k12["k1_paths"],
        k2_paths=k12["k2_paths"], total_p50_ms=snap["total_p50_ms"],
        total_p99_ms=snap["total_p99_ms"], **fabric_split(fab, snap),
        wall_s=round(wall, 3))
    if st["merges_applied"] < 1 or st["pending_deltas"] != 0:
        raise AssertionError(f"stream: deltas not merged: {st}")
    # the card against the CPU on the same merged structure
    card = GNSEngine(cfg)
    cpu = GNSEngine(cfg, device="cpu")
    cpu.params = {"layers": [{k: v.cpu() for k, v in layer.items()}
                             for layer in card.params["layers"]]}
    for eng in (card, cpu):
        for ev in events:
            eng.ingest_events(ev)
        eng.merge_deltas()
    if not np.array_equal(card.ds.graph.indices, cpu.ds.graph.indices):
        raise AssertionError("stream: card and CPU merged different graphs")
    ids = np.concatenate([np.arange(v0, v1), rng.choice(v0, 200, False)])
    on_card, on_cpu = card.infer(ids), cpu.infer(ids)
    err = float(np.abs(on_card - on_cpu).max())
    ok = (np.isfinite(on_card).all()
          and np.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4))
    log("stream-parity", ids=len(ids), new_nodes=int(v1 - v0),
        logits=list(on_card.shape), max_abs_err=err, ok=ok)
    if not ok:
        raise AssertionError(f"stream: card vs CPU logits differ: {err}")
    return k12["counts"]


def device_shapes(engine, rng) -> dict:
    """One device-backend batch at the training shape and one at the
    bucket-128 serving shape, with K3's operands on the card: (adj, table,
    dst_rows, fb_rows, fb_w, key).  Sampled with the store's accounting
    off, so the training meter starts clean."""
    engine.ensure_cache(np.random.default_rng(SEED))
    engine.store.record = False
    try:
        targets = rng.choice(engine.ds.train_idx, engine.scfg.batch_size,
                             replace=False)
        batches = {"train": engine.sampler.sample(targets, rng)}
        ids = rng.choice(engine.ds.graph.num_nodes, 128, replace=False)
        batches["b=128"] = engine.infer_prepare(ids, bucket=128, rng=rng)
    finally:
        engine.store.record = True
    out = {}
    for name, mb in batches.items():
        db = mb.device.to(engine.device)
        out[name] = (mb.cache_gen.device_adj, mb.cache_gen.table,
                     db.input_cache_slots, db.input_fb_rows, db.input_fb_w,
                     db.sample_key)
        log("batch", shape=name, B=db.input_fb_rows.shape[0],
            k=db.input_fb_rows.shape[1],
            cached_dst=int((db.input_cache_slots >= 0).sum()),
            fallback_dst=int(((db.input_cache_slots < 0)
                              & (db.input_mask > 0)).sum()))
    return out


def phase_k3_parity(shapes, rng) -> dict:
    """K3 vs its plain version: lanes and output bit for bit.  Returns the
    largest |kernel - plain| on random f32 per shape."""
    import torch
    from repro_torch.sampling.kernels import (gns_sample_agg_cuda,
                                              gns_sample_agg_plain,
                                              sample_lanes_plain)
    errs = {}
    for name, (adj, table, dst, fb_rows, fb_w, key) in shapes.items():
        dev = table.device
        want_rows, want_w = sample_lanes_plain(adj, dst, fb_rows, fb_w, key)
        for kind, dtype in (("int", torch.float32), ("rand", torch.float32),
                            ("rand", torch.bfloat16)):
            if kind == "int":
                a = rng.integers(-128, 129, tuple(table.shape))
            else:
                a = rng.normal(size=tuple(table.shape))
            tbl = torch.from_numpy(a.astype(np.float32)).to(dev, dtype=dtype)
            lane_rows = torch.empty_like(fb_rows)
            lane_w = torch.empty_like(fb_w)
            got = gns_sample_agg_cuda(adj, tbl, dst, fb_rows, fb_w, key,
                                      lane_rows, lane_w)
            want = gns_sample_agg_plain(adj, tbl, dst, fb_rows, fb_w, key)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = (torch.equal(got, want) and torch.equal(lane_rows, want_rows)
                  and torch.equal(lane_w, want_w))
            log("k3-parity", shape=name, data=kind,
                table=str(dtype).removeprefix("torch."), B=dst.shape[0],
                k=fb_rows.shape[1], D=got.shape[1], max_abs_err=err,
                lanes_equal=torch.equal(lane_rows, want_rows)
                and torch.equal(lane_w, want_w), ok=ok)
            if not ok:
                raise AssertionError(f"K3 {name} {kind} {dtype}: max err "
                                     f"{err}")
            if kind == "rand" and dtype == torch.float32:
                errs[name] = err
    return errs


def phase_train(engine, name: str, epochs: int, max_batches, eval_batches: int,
                expect: str) -> dict:
    """Drive ``fit`` then ``evaluate`` with every kernel counter zeroed just
    before and read just after.  ``expect`` names the kernel whose launches
    must equal steps + eval batches.  Returns the counts and the numbers
    printed."""
    import torch
    counters, paths = kernel_counters()
    meter = engine.meter
    before = {f: getattr(meter, f) for f in METER_TIMES}
    store = engine.store
    swaps0 = store.swaps if store is not None else 0
    step_ms, losses, batches = [], [], []
    run_batch = engine.run_batch

    def timed_step(mb):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, acc = run_batch(mb)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(loss)
        batches.append({"bytes_streamed": mb.bytes_streamed,
                        "layer0": list(mb.device.blocks[0].nbr_idx.shape)})
        return loss, acc

    engine.run_batch = timed_step
    for c in (*counters.values(),
              *(c for v in paths.values() for c in v.values())):
        c.reset()
    t0 = time.perf_counter()
    try:
        rep = engine.fit(epochs=epochs, max_batches=max_batches)
        acc = engine.evaluate(num_batches=eval_batches)
    finally:
        del engine.run_batch
    wall = time.perf_counter() - t0
    counts = {k: c.value for k, c in counters.items()}
    path_counts = {k: {p: c.value for p, c in v.items()}
                   for k, v in paths.items()}
    split = {f: getattr(meter, f) - before[f] for f in METER_TIMES}
    steps = len(step_ms)
    log("train", path=name, steps=steps, losses=losses,
        epoch_losses=rep.losses, val_acc=acc,
        step_ms_median_last3=float(np.median(step_ms[-3:])),
        step_ms=step_ms,
        swaps=(store.swaps - swaps0) if store is not None else None,
        launches=counts, paths=path_counts,
        feat_dim=engine.ds.feat_dim, wall_s=round(wall, 3),
        **{f + "_s": v for f, v in split.items()},
        input_nodes_per_batch=rep.input_nodes_per_batch,
        cached_nodes_per_batch=rep.cached_nodes_per_batch)
    if not steps or not np.isfinite(losses).all() \
            or not np.isfinite(rep.losses).all():
        raise AssertionError(f"{name}: non-finite losses {losses}")
    if not 0.0 <= acc <= 1.0:
        raise AssertionError(f"{name}: accuracy {acc}")
    if counts[expect] != steps + eval_batches:
        raise AssertionError(f"{name}: {expect} launched {counts[expect]} "
                             f"times for {steps} steps + {eval_batches} "
                             f"eval batches")
    for k, kernel in (("k1", "cache_lookup_agg"), ("k3", "gns_sample_agg")):
        if path_counts[k] != {"vector": counts[kernel], "scalar": 0}:
            raise AssertionError(f"{name}: {k.upper()} left the vector path "
                                 f"at D = {engine.ds.feat_dim}: "
                                 f"{path_counts[k]}")
    return {"counts": counts, "steps": steps, "step_ms": step_ms,
            "losses": losses, "split": split, "batches": batches,
            "report": rep}


def phase_profile(engine, rng, path: str, steps: int = 1) -> None:
    """``steps`` more steps of a path, after its counted run, each under
    ``torch.profiler``: the device's busy time (kernels and copies) against
    the step's time by CUDA events (the profiler's start-up left out, its
    per-op recording left in), the host->device copies (device time and
    count) and the host's ``aten::copy_``, and the largest device and host
    entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for step in range(steps):
        mb = sample_quietly(engine, rng)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()   # inside: the profiler's own start-up is out
            engine.run_batch(mb)
            end.record()
            end.synchronize()
        wall_ms = start.elapsed_time(end)
        events = prof.key_averages()
        on_card = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
        top = sorted(on_card, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
        host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
        htod = [e for e in on_card if e.key.startswith("Memcpy HtoD")]
        copy = [e for e in events if e.key == "aten::copy_"]
        log("profile", path=path, step=step,
            bytes_streamed=mb.bytes_streamed,
            step_wall_ms=round(wall_ms, 3), device_busy_ms=round(busy_ms, 3),
            idle_share=round(1.0 - busy_ms / wall_ms, 4),
            memcpy_htod_ms_count=(
                round(sum(e.self_device_time_total for e in htod) / 1e3, 3),
                sum(e.count for e in htod)),
            host_copy_ms_count=(
                round(sum(e.self_cpu_time_total for e in copy) / 1e3, 3),
                sum(e.count for e in copy)),
            top_device=[(e.key[:60], round(e.self_device_time_total / 1e3, 3),
                         e.count) for e in top],
            top_host=[(e.key[:60], round(e.self_cpu_time_total / 1e3, 3),
                       e.count) for e in host])


def phase_train_parity(ds, cfg, phase: str) -> None:
    """One training step of ``cfg`` on the card against the same engine on
    the CPU, from the same parameters and seeds; logged as ``phase``."""
    from repro_torch.gns import GNSEngine
    from repro_torch.models.graphsage import params_from_numpy
    card = GNSEngine(cfg, dataset=ds)
    cpu = GNSEngine(cfg, device="cpu", dataset=ds)
    cpu.params = params_from_numpy(
        {"layers": [{k: v.cpu().numpy() for k, v in layer.items()}
                    for layer in card.params["layers"]]}, device="cpu")
    rep_card = card.fit(epochs=1, max_batches=1)
    rep_cpu = cpu.fit(epochs=1, max_batches=1)
    loss_ok = np.allclose(rep_card.losses, rep_cpu.losses, rtol=1e-4)
    err, ok = 0.0, loss_ok
    for lc, lp in zip(card.params["layers"], cpu.params["layers"]):
        for k in ("w", "b"):
            a, b = lc[k].cpu().numpy(), lp[k].numpy()
            err = max(err, float(np.abs(a - b).max()))
            ok = ok and np.allclose(a, b, rtol=1e-4, atol=1e-5)
    log(phase, sampler=cfg.sampler, batch=cfg.sampling.batch_size,
        loss_card=rep_card.losses, loss_cpu=rep_cpu.losses,
        param_max_abs_err=err, ok=ok)
    if not ok:
        raise AssertionError(f"{phase}: card vs CPU train step differ: "
                             f"losses {rep_card.losses} {rep_cpu.losses}, "
                             f"params max err {err}")


BASELINES = ("ns", "ladies", "lazygcn")
BASELINE_STEPS = 3             # fit() steps per baseline, then 1 eval batch


def baseline_config(name: str, batch_size: int = 1000):
    """Preset ``paper_train`` with the baseline sampler ``name`` on the
    host backend, layer 0 through K1 (``input_impl="fused"``; no feature
    store, so a 1-row dummy cache and every lane a miss)."""
    return dataclasses.replace(train_config("fused", batch_size),
                               sampler=name)


def lazygcn_recycled(scfg, n: int) -> list:
    """Which of ``n`` LazyGCN steps of one epoch reuse the megabatch: each
    period p takes max(round(R·rho^p), 1) steps, the first fresh (the
    reference's ``LazyGCNSampler.sample``)."""
    out, period = [], 0
    while len(out) < n:
        r = max(int(round(scfg.recycle_period
                          * scfg.recycle_growth ** period)), 1)
        out += [False] + [True] * (r - 1)
        period += 1
    return out[:n]


def phase_baselines(ds) -> tuple:
    """The paper's baselines trained on the card through K1: for each
    sampler ``fit(epochs=1, max_batches=BASELINE_STEPS)`` and one eval
    batch (:func:`phase_train`, K1's counters zeroed just before each and
    read just after; its launches equal steps + eval batches, all on the
    vector path).  Returns the summed launch counts and the engines."""
    from repro_torch.gns import GNSEngine
    counts, engines = {}, {}
    for name in BASELINES:
        engine = GNSEngine(baseline_config(name), dataset=ds)
        out = phase_train(engine, f"baseline_{name}", epochs=1,
                          max_batches=BASELINE_STEPS, eval_batches=1,
                          expect="cache_lookup_agg")
        batches, split, rep = out["batches"], out["split"], out["report"]
        recycled = [b["bytes_streamed"] == 0 for b in batches]
        log("baseline", sampler=name, steps=out["steps"],
            step_ms_median=float(np.median(out["step_ms"])),
            **{f.removeprefix("t_") + "_s_per_step": split[f] / out["steps"]
               for f in ("t_sample", "t_slice", "t_copy", "t_compute")},
            input_nodes_per_batch=rep.input_nodes_per_batch,
            isolated_per_batch=rep.isolated_per_batch,
            streamed_bytes_per_batch=float(np.mean(
                [b["bytes_streamed"] for b in batches])),
            input_rows_padded=engine.sampler.pad_sizes[0][1],
            layer0_lanes=batches[0]["layer0"], recycled=recycled)
        if name == "lazygcn":
            want = lazygcn_recycled(engine.scfg, out["steps"])
            if recycled != want or not any(want):
                raise AssertionError(f"lazygcn recycled steps {recycled}, "
                                     f"the schedule puts them at {want}")
        elif any(recycled):
            raise AssertionError(f"{name}: a step streamed no bytes")
        for k, v in out["counts"].items():
            counts[k] = counts.get(k, 0) + v
        engines[name] = engine
        # after the counted run: a LazyGCN fresh step, then a recycled one
        phase_profile(engine, np.random.default_rng(SEED),
                      f"baseline_{name}", 2 if name == "lazygcn" else 1)
    return counts, engines


def engine_state(engine) -> list:
    """(name, tensor) of the engine's parameters and AdamW moments."""
    out = []
    for tree, tag in ((engine.params, "params"),
                      (engine.opt_state["m"], "m"),
                      (engine.opt_state["v"], "v")):
        for i, layer in enumerate(tree["layers"]):
            out += [(f"{tag}/{i}/{k}", layer[k]) for k in sorted(layer)]
    return out


def phase_checkpoint(engine, ds) -> None:
    """``save`` the trained engine of path (A), then ``restore`` it into a
    fresh engine on the card (every tensor ``torch.equal``, on the card)
    and into one on the CPU (equal after ``.cpu()``).  The checkpoint goes
    under ``build/`` of this checkout and is removed after."""
    import tempfile
    import torch
    from repro_torch.gns import GNSEngine
    (ROOT / "build").mkdir(exist_ok=True)
    step = engine.opt_state["step"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="chip_smoke_ckpt_") as d:
        t0 = time.perf_counter()
        path = engine.save(d, step=step)
        t_save = time.perf_counter() - t0
        want = engine_state(engine)
        size = sum(f.stat().st_size for f in Path(path).iterdir())
        for device in ("cuda", "cpu"):
            fresh = GNSEngine(engine.cfg, device=device, dataset=ds)
            t0 = time.perf_counter()
            got_step = fresh.restore(d)
            t_restore = time.perf_counter() - t0
            got = engine_state(fresh)
            bad = [n for (n, a), (_, b) in zip(want, got)
                   if b.device.type != device or not torch.equal(a.cpu(),
                                                                 b.cpu())]
            ok = (got_step == step and fresh.opt_state["step"] == step
                  and len(got) == len(want) and not bad)
            log("checkpoint", into=device, step=got_step, tensors=len(got),
                bytes=size, save_s=round(t_save, 3),
                restore_s=round(t_restore, 3), mismatched=bad, ok=ok)
            if not ok:
                raise AssertionError(f"checkpoint into {device}: step "
                                     f"{got_step} of {step}, {bad}")


def phase_describe(engines: dict) -> None:
    """Each engine's ``describe()`` record, its meter cut to two counts."""
    for name, engine in engines.items():
        rec = engine.describe()
        log("describe", engine=name, sampler=engine.cfg.sampler,
            **{k: v for k, v in rec.items() if k != "meter"},
            meter_steps=rec["meter"]["steps"],
            meter_bytes_streamed=rec["meter"]["bytes_streamed"])


def launch_fields(counts: dict, kernel: str) -> dict:
    """``launches``: the kernel's launches summed over the main paths that
    ran it (each path counted from zero just before it), and the count of
    each path beside it."""
    by_path = {path: c[kernel] for path, c in counts.items()
               if c.get(kernel)}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


TIME_KEYS = ("name", "ms", "bound_ms", "bound_by", "plain_ms",
             "library_ms", "bytes", "lane_bound_ms", "path")


def log_times(rows: list) -> None:
    for r in rows:
        log("time", **{k: r[k] for k in TIME_KEYS if k in r})


def lookup_row(label: str, args: tuple, counts: dict, err: float,
               flush) -> dict:
    """K1's ``[time]`` row at one shape, in turns with its plain version
    and the ``embedding_bag`` yardstick (gather only: the lanes resolved
    beforehand, untimed, into rows of ``torch.cat([cache, streamed])``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                                  cache_lookup_agg_plain,
                                                  lookup_access_path)
    cache, streamed, slots, idx, w = args
    lane_slots = slots.long()[idx.long()]
    lib_idx = torch.where(lane_slots >= 0, lane_slots,
                          cache.shape[0] + idx.long())
    lib_table = torch.cat([cache.float(), streamed])
    n_bytes, lane_bytes, n_flops = lookup_work(*args)
    t_bound, by = bound_ms(n_bytes, n_flops)
    return {
        "name": f"cache_lookup_agg[{label},layer=0]", "route": "cuda",
        "source": "src/repro_torch/csrc/cache_lookup.cu",
        "replaces": "src/repro/kernels/cache_lookup.py:78",
        **launch_fields(counts, "cache_lookup_agg"),
        "max_abs_err": err,
        **turns_ms({
            "ms": lambda: cache_lookup_agg_cuda(*args),
            "plain_ms": lambda: cache_lookup_agg_plain(*args),
            "library_ms": lambda: F.embedding_bag(
                lib_idx, lib_table, per_sample_weights=w, mode="sum")},
            flush),
        "bound_ms": t_bound, "bound_by": by,
        "library": "F.embedding_bag over the lanes resolved into "
                   "torch.cat([cache, streamed]) (gather only)",
        "bytes": n_bytes, "lane_bound_ms": lane_bytes / HBM_MS,
        "B": idx.shape[0], "path": lookup_access_path(cache, streamed)}


def phase_train_times(k3_shapes, k3_errs, k1_shapes, counts) -> list:
    """K3 at the training and bucket-128 shapes, in turns with its plain
    version and the ``embedding_bag`` yardstick of the gather; K1 at the
    training shapes of the host-fused path and of LADIES
    (``k1_shapes``), each held bitwise to its plain version, then timed
    (:func:`lookup_row`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.cache_lookup import (cache_lookup_agg_cuda,
                                                  cache_lookup_agg_plain)
    from repro_torch.kernels.gather_agg import access_path
    from repro_torch.sampling.kernels import (gns_sample_agg_cuda,
                                              gns_sample_agg_plain,
                                              sample_lanes_plain)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    rows = []
    for name, args in k3_shapes.items():
        adj, table, dst, fb_rows, fb_w, key = args
        lane_rows, lane_w = sample_lanes_plain(adj, dst, fb_rows, fb_w, key)
        n_bytes, n_flops = sample_work(adj, table, dst, fb_rows, lane_rows,
                                       lane_w)
        t_bound, by = bound_ms(n_bytes, n_flops)
        lib_idx = lane_rows.clamp(min=0).long()
        lib_w = torch.where(lane_rows >= 0, lane_w, 0.0)
        t = turns_ms({
            "ms": lambda: gns_sample_agg_cuda(*args),
            "plain_ms": lambda: gns_sample_agg_plain(*args),
            "library_ms": lambda: F.embedding_bag(
                lib_idx, table, per_sample_weights=lib_w, mode="sum")},
            flush)
        rows.append({
            "name": f"gns_sample_agg[{name}]", "route": "cuda",
            "source": "src/repro_torch/csrc/gns_sample_agg.cu",
            "replaces": "src/repro/sampling/kernels.py:138",
            **launch_fields(counts, "gns_sample_agg"),
            "max_abs_err": k3_errs[name], **t,
            "bound_ms": t_bound, "bound_by": by,
            "library": "F.embedding_bag over the drawn lanes (gather only)",
            "bytes": n_bytes, "B": dst.shape[0],
            "path": access_path(table)})
    for shape, k1_args in k1_shapes.items():
        got = cache_lookup_agg_cuda(*k1_args)
        want = cache_lookup_agg_plain(*k1_args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K1 at the {shape} shape: max err {err}")
        idx, w = k1_args[3], k1_args[4]
        log("parity", kernel="cache_lookup_agg", shape=shape, layer=0,
            data="sampled",
            table=str(k1_args[0].dtype).removeprefix("torch."),
            B=idx.shape[0], K=idx.shape[1], D=got.shape[1],
            cache_rows=k1_args[0].shape[0],
            hit_lanes=int((k1_args[2].long()[idx.long()] >= 0).sum()),
            live_lanes=int((w != 0).sum()), max_abs_err=err, ok=True)
        del got, want
        rows.append(lookup_row(shape, k1_args, counts, err, flush))
    log_times(rows)
    return rows


def sample_quietly(engine, rng):
    """One training batch of ``engine``, with its store's accounting (if it
    has a store) off, so the training meter stays as the run left it."""
    if engine.store is not None:
        engine.store.record = False
    try:
        targets = rng.choice(engine.ds.train_idx, engine.scfg.batch_size,
                             replace=False)
        return engine.sampler.sample(targets, rng)
    finally:
        if engine.store is not None:
            engine.store.record = True


def host_train_batch(engine, rng) -> tuple:
    """K1's operands at the training shape of a host-fused engine, on the
    card: its cache table (a storeless engine's 1-row dummy), streamed
    rows, slots and layer 0's lanes."""
    mb = sample_quietly(engine, rng)
    db = mb.device.to(engine.device)
    blk0 = db.blocks[0]
    return (engine._cache_table(mb), db.input_streamed,
            db.input_cache_slots, blk0.nbr_idx, blk0.nbr_w)


def phase_times(engine, shapes, errs, counts) -> list:
    """K1 and K2 at the serving shapes, each in turns with its plain
    version and ``embedding_bag``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.gather_agg import (access_path, gather_agg_cuda,
                                                gather_agg_plain)
    dev = engine.device
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)  # > L2
    rows = []
    for b, (mb, db) in shapes.items():
        blk0 = db.blocks[0]
        # the table of the generation the batch pinned (the fabric phase
        # has since refreshed the live one)
        args = (mb.cache_gen.table, db.input_streamed, db.input_cache_slots, blk0.nbr_idx,
                blk0.nbr_w)
        rows.append(lookup_row(f"b={b}", args, counts,
                               errs[("cache_lookup_agg", b, 0)], flush))
        h = torch.randn((blk0.nbr_idx.shape[0], engine.mcfg.hidden_dim),
                        device=dev)
        for li in (1, 2):
            blk = db.blocks[li]
            feat = h[: db.blocks[li - 1].nbr_idx.shape[0]].contiguous()
            idx, w = blk.nbr_idx, blk.nbr_w
            n_bytes, lane_bytes, n_flops = gather_work(feat, idx, w)
            t_bound, by = bound_ms(n_bytes, n_flops)
            rows.append({
                "name": f"gather_agg[b={b},layer={li}]", "route": "cuda",
                "source": "src/repro_torch/csrc/gather_agg.cu",
                "replaces": "src/repro/kernels/gather_agg.py:51",
                **launch_fields(counts, "gather_agg"),
                "max_abs_err": errs[("gather_agg", b, li)],
                **turns_ms({
                    "ms": lambda: gather_agg_cuda(feat, idx, w),
                    "plain_ms": lambda: gather_agg_plain(feat, idx, w),
                    "library_ms": lambda: F.embedding_bag(
                        idx, feat, per_sample_weights=w, mode="sum")},
                    flush),
                "bound_ms": t_bound, "bound_by": by,
                "bytes": n_bytes, "lane_bound_ms": lane_bytes / HBM_MS,
                "path": access_path(feat)})
    log_times(rows)
    return rows


# ---------------------------------------------------------------------------
# K4 and the LM serving slice
# ---------------------------------------------------------------------------

# name: (B, Hq, Hkv, Sq, Sk, Dh, causal, window, kv_len, q_offset); kv_len /
# q_offset None: the op's own (Sk, Sk - Sq)
K4_SHAPES = {
    "a:serve": (4, 16, 16, 1, 1024, 64, False, None, None, None),
    "b:qwen2-7b": (1, 28, 4, 4096, 4096, 128, True, None, None, None),
    "c:danube3": (1, 32, 8, 8192, 8192, 120, True, 4096, None, None),
    "d:mqa": (1, 8, 1, 64, 64, 64, True, None, None, None),
    "d:kv_len-poisoned": (1, 2, 2, 32, 64, 32, False, None, 48, 16),
    "d:odd-37/53": (1, 2, 1, 37, 53, 32, True, None, None, None),
    # few rows (split-KV in both dtypes): MQA with a window; a chunk the
    # rows at position 127 see none of; a poisoned tail at Dh 256
    "d:split-mqa-window": (2, 8, 1, 2, 500, 64, True, 100, None, None),
    "d:split-last-chunk-masked": (1, 4, 2, 4, 131, 32, True, None, None,
                                  None),
    "d:split-kv_len-dh256": (2, 4, 4, 1, 400, 256, False, None, 333, 332),
    # many rows at Dh 256 with a window and a poisoned tail
    "d:dh256-window-kv_len": (1, 2, 1, 100, 200, 256, True, 50, 180, 80),
}
K4_TIMED = ("a:serve", "b:qwen2-7b", "c:danube3")
K4_SOURCES = {"split_kv": "flash_attention_split.cu",
              "tensor_core": "flash_attention_tc.cu",
              "simt": "flash_attention.cu"}
# K4's device kernels by name (the split-KV route launches two)
K4_KERNEL_NAMES = ("split_partial_kernel", "split_combine_kernel",
                   "flash_tc_kernel", "flash_attention_kernel")
LM_ARCH = "seamless-m4t-medium"
LM_BATCHES, LM_BATCH, LM_PROMPT, LM_NEW, LM_FRAMES = 2, 4, 32, 32, 1024


def k4_operands(name: str, dtype) -> tuple:
    """(q, k, v, kwargs) of one K4 case on the card, drawn from SEED; the
    tail past an explicit kv_len is poisoned with 1e5."""
    import torch
    b, hq, hkv, sq, sk, dh, causal, window, kv_len, q_offset = K4_SHAPES[name]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((b, h, s, dh), generator=gen, device="cuda"
                           ).to(dtype)
               for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    if kv_len is None:
        kv_len, q_offset = sk, sk - sq
    else:
        k[:, :, kv_len:] = 1e5
        v[:, :, kv_len:] = 1e5
    return q, k, v, dict(causal=causal, window=window, kv_len=kv_len,
                         q_offset=q_offset)


K4_BF16_TOL = (1e-2, 4e-3)            # (rtol, atol): one bf16 ulp and more


def k4_tolerance(name: str, dtype) -> tuple[float, float]:
    """(rtol, atol) of K4 against its plain version."""
    import torch
    if dtype == torch.bfloat16:
        return K4_BF16_TOL
    tol = 1e-4 if name[0] in "bc" else 2e-5
    return tol, tol


def k4_routes_since(before: dict) -> dict:
    """K4's calls per route since the snapshot ``before``."""
    from repro_torch.kernels.flash_attention import route_calls
    now = {name: c.value - before.get(name, 0)
           for name, c in route_calls.items()}
    return {name: n for name, n in now.items() if n}


def phase_k4_parity() -> dict:
    """K4 vs its plain version at (a)-(d), f32 and bf16, each case on the
    route ``flash_attention_cuda`` picks for it (logged from the route
    counters; every route is met).  Returns the largest |kernel - plain|
    per (case, dtype)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     k4_route, route_calls)
    log("k4-parity", why="f32 2e-5 at (a),(d) and 1e-4 at (b),(c): the "
        "online and the full softmax sum in different orders, more so over "
        "4096-8192 keys; bf16 rtol 1e-2, atol 4e-3: both keep p.v in f32 "
        "and round each output to bf16 once, so they differ by at most one "
        "bf16 ulp (<= 2^-7 of the value)")
    errs, met = {}, set()
    for name in K4_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kw = k4_operands(name, dtype)
            before = {n: c.value for n, c in route_calls.items()}
            got = flash_attention_cuda(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            took = k4_routes_since(before)
            route = k4_route(q.shape[1] // k.shape[1] * q.shape[2], dtype)
            rtol, atol = k4_tolerance(name, dtype)
            err = float((got.float() - want.float()).abs().max())
            ok = (bool(torch.allclose(got.float(), want.float(), rtol=rtol,
                                      atol=atol)) and got.dtype == dtype
                  and took == {route: 1})
            dt = str(dtype).removeprefix("torch.")
            log("k4-parity", case=name, dtype=dt, route=route, took=took,
                q=list(q.shape), k=list(k.shape), **kw, rtol=rtol,
                atol=atol, max_abs_err=err, ok=ok)
            if not ok:
                raise AssertionError(f"K4 {name} {dt}: max err {err}, "
                                     f"routes {took}")
            errs[(name, dtype)] = err
            met.add(route)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    if met != set(route_calls):
        raise AssertionError(f"K4 parity met routes {met} only")
    return errs


def lm_config(reduced: bool):
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    return dataclasses.replace(cfg.reduced() if reduced else cfg,
                               attn_impl="pallas")


def phase_lm_serve() -> dict:
    """Full-width seamless-m4t-medium through ServeEngine.generate_batch;
    returns the launch counts of this run (every counter zeroed just
    before, read just after)."""
    import torch
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models.lm import get_model
    cfg = lm_config(reduced=False)
    t0 = time.perf_counter()
    params = get_model(cfg).init(SEED)          # on the GPU: no device= given
    torch.cuda.synchronize()
    n_params, p_bytes = tree_size(params)
    log("lm-init", arch=cfg.name, params=n_params,
        param_gb=round(p_bytes / 1e9, 3),
        layers=f"{cfg.encoder_layers}+{cfg.num_layers}", d_model=cfg.d_model,
        heads=cfg.num_heads, vocab=cfg.vocab_size, dtype=cfg.dtype,
        seconds=round(time.perf_counter() - t0, 2))
    engine = ServeEngine(cfg, params, max_batch=LM_BATCH)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    seen = []
    decode = engine.model.decode_step

    def checked(p, tokens, state):
        logits, state = decode(p, tokens, state)
        seen.append(tuple(logits.shape))
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, state

    engine.model = dataclasses.replace(engine.model, decode_step=checked)
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(LM_BATCHES):
        reqs = [Request(rng.integers(0, cfg.vocab_size, LM_PROMPT)
                        .astype(np.int32), max_new_tokens=LM_NEW)
                for _ in range(LM_BATCH)]
        frames = rng.standard_normal((LM_BATCH, LM_FRAMES, cfg.d_model),
                                     dtype=np.float32)
        batches.append((reqs, frames))
    counters = lm_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in (*counters.values(), *k4.route_calls.values()):
        c.reset()
    comps = [engine.generate_batch(reqs, frame_embeds=frames)
             for reqs, frames in batches]
    counts = {name: c.value for name, c in counters.items()}
    routes = {name: c.value for name, c in k4.route_calls.items()}
    decode_steps = sum(c[0].steps - 1 for c in comps)
    for i, batch in enumerate(comps):
        c = batch[0]
        log("lm-serve", batch=i, requests=len(batch),
            prefill_ms=round(c.prefill_s * 1e3, 3),
            decode_steps=c.steps - 1, decode_s=round(c.decode_s, 4),
            ms_per_token=round(c.decode_s * 1e3 / (c.steps - 1), 3),
            decode_tokens_per_s=round(len(batch) * (c.steps - 1)
                                      / c.decode_s, 1))
    tokens = np.stack([c.tokens for batch in comps for c in batch])
    ok_tokens = tokens.shape == (LM_BATCHES * LM_BATCH, LM_NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    expect = cfg.num_layers * decode_steps
    log("lm-serve", requests=len(tokens), tokens=list(tokens.shape),
        distinct_tokens=int(np.unique(tokens).size),
        logits=sorted(set(seen)), logits_finite=bool(finite),
        launches=counts, expect_k4=expect, k4_routes=routes,
        peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
    if not ok_tokens:
        raise AssertionError(f"tokens out of range or short: {tokens.shape}")
    if not bool(finite):
        raise AssertionError("non-finite logits in a decode step")
    if counts["flash_attention"] != expect:
        raise AssertionError(f"K4 launched {counts['flash_attention']} "
                             f"times, expected {expect}")
    if routes["split_kv"] != expect:
        raise AssertionError(f"K4 calls by route {routes}: expected all "
                             f"{expect} on the split-KV route")
    phase_lm_check(engine, *batches[0])
    phase_lm_profile(engine, *batches[0])
    del engine, params
    torch.cuda.empty_cache()
    return {**counts, "flash_attention_routes": routes}


def lm_state(engine, reqs, frames) -> tuple:
    """(next tokens, decode state) of one batch after its encoder, its
    prompt's prefill and one decode step, as ``generate_batch`` runs them."""
    import torch
    from repro_torch.launch.serve import CACHE_MARGIN
    from repro_torch.models import encdec
    dev = engine.device
    with torch.inference_mode():
        state = engine.model.decode_init(
            len(reqs), len(reqs[0].prompt) + LM_NEW + CACHE_MARGIN,
            frames.shape[1], device=dev)
        state["cross"] = encdec.prefill_encoder(
            engine.params, engine.cfg, torch.from_numpy(frames).to(dev))
        prompts = torch.from_numpy(np.stack([r.prompt for r in reqs])
                                   ).to(dev)
        nxt, state = engine._step(prompts, state)
        nxt, state = engine._step(nxt, state)
    return nxt, state


def phase_lm_check(engine, reqs, frames) -> None:
    """After the counted run: one full-width decode step of a served batch,
    twice from the same state.  First through K4, whose 12 cross-attention
    calls are recorded and each held to K4's plain version on the very
    operands the model gave it; then with ``attn_impl="reference"``
    (``mha_ref`` everywhere).  The two steps differ only in the
    cross-attention, so their logits must agree within 2^-6 of the logits'
    largest magnitude (two to four bf16 ulps there)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import encdec
    cfg = engine.cfg
    nxt, state = lm_state(engine, reqs, frames)
    calls = []
    k4_op = ops.flash_attention

    def recorded(q, k, v, **kw):
        out = k4_op(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    ops.flash_attention = recorded
    try:
        with torch.inference_mode():
            got, _ = encdec.decode_step(engine.params, cfg, nxt, state)
    finally:
        ops.flash_attention = k4_op
    with torch.inference_mode():
        want, _ = encdec.decode_step(
            engine.params, dataclasses.replace(cfg, attn_impl="reference"),
            nxt, state)
    rtol, atol = K4_BF16_TOL
    ok_x, x_err = len(calls) == cfg.num_layers, 0.0
    for q, k, v, kw, out in calls:
        sq, sk = q.shape[2], k.shape[2]
        plain = flash_attention_plain(q, k, v, causal=kw["causal"],
                                      window=kw["window"], kv_len=sk,
                                      q_offset=sk - sq)
        x_err = max(x_err, float((out.float() - plain.float()).abs().max()))
        ok_x = ok_x and bool(torch.allclose(out.float(), plain.float(),
                                            rtol=rtol, atol=atol))
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    tol = 2.0 ** -6 * scale                    # 2-4 bf16 ulps at the top
    err = float((got - want).abs().max())
    ok = ok_x and err <= tol and bool(torch.isfinite(got).all())
    shapes = [list(t.shape) for t in calls[0][:2]] if calls else None
    log("lm-check", k4_calls=len(calls), q_k=shapes,
        xattn_max_abs_err=x_err, xattn_rtol=rtol,
        xattn_atol=atol, logits=list(got.shape), logits_max_abs=scale,
        logits_max_abs_err=err, logits_tol=tol,
        logits_equal_share=float((got == want).float().mean()),
        same_argmax=bool((got.argmax(-1) == want.argmax(-1)).all()), ok=ok)
    if not ok:
        raise AssertionError(f"full-width K4 step vs reference: cross-attn "
                             f"err {x_err}, logits err {err} > {tol}")


def phase_lm_profile(engine, reqs, frames, steps: int = 3) -> None:
    """After the counted run: ``steps`` single-token decode steps of one
    batch under ``torch.profiler`` (``profile_decode``)."""
    nxt, state = lm_state(engine, reqs, frames)
    profile_decode(engine, nxt, state, "lm-profile", steps)


def profile_decode(engine, nxt, state, name: str, steps: int = 3) -> None:
    """``steps`` single-token decode steps of ``engine`` from ``state``
    under ``torch.profiler`` (no readback between them): the device's busy
    time per step against the step's time by CUDA events, the kernel
    launches per step, K4's share, and the largest device and host
    entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        nxt, state = engine._step(nxt, state)          # one warm step
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(steps):
                nxt, state = engine._step(nxt, state)
            end.record()
            end.synchronize()
    step_ms = start.elapsed_time(end) / steps
    events = prof.key_averages()
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / steps
    top = sorted(on_card, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    k4 = [e for e in on_card if any(n in e.key for n in K4_KERNEL_NAMES)]
    k4_ms = sum(e.self_device_time_total for e in k4) / 1e3 / steps
    log(name, batch=nxt.shape[0], steps=steps,
        step_ms=round(step_ms, 3), device_busy_ms=round(busy_ms, 3),
        idle_share=round(1.0 - busy_ms / step_ms, 4),
        device_launches_per_step=sum(e.count for e in on_card) / steps,
        k4_ms_per_step=round(k4_ms, 4),
        k4_share_of_busy=round(k4_ms / busy_ms, 4),
        k4_kernel_launches_per_step=sum(e.count for e in k4) / steps,
        top_device=[(e.key[:60], round(e.self_device_time_total / 1e3
                                       / steps, 4), e.count // steps)
                    for e in top],
        top_host=[(e.key[:60], round(e.self_cpu_time_total / 1e3 / steps,
                                     3), e.count // steps) for e in host])


def phase_lm_parity() -> None:
    """The reduced seamless config (f32) on the card against the CPU, from
    the same parameters: logits of a prefill and three decode steps."""
    import torch
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models import encdec
    from repro_torch.models.lm import get_model
    from repro_torch.models.scan_util import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_config(reduced=True)
    params_cpu = get_model(cfg).init(SEED, device="cpu")
    rng = np.random.default_rng(SEED)
    b, s_enc, s, cache_len = 2, 24, 8, 16
    frames = rng.standard_normal((b, s_enc, cfg.d_model), dtype=np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 3)).astype(np.int32)
    feeds = [toks[:, :s]] + [toks[:, i:i + 1] for i in range(s, s + 3)]
    logits = {}
    n0 = k4.launches.value
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), params_cpu)
        with torch.inference_mode():
            state = encdec.init_decode_state(cfg, b, cache_len, s_enc,
                                             device=dev)
            state["cross"] = encdec.prefill_encoder(
                params, cfg, torch.from_numpy(frames).to(dev))
            out = []
            for feed in feeds:
                lg, state = encdec.decode_step(
                    params, cfg, torch.from_numpy(feed).to(dev), state)
                out.append(lg.cpu().numpy())
        logits[dev] = np.stack(out)
    launched = k4.launches.value - n0
    err = float(np.abs(logits["cuda"] - logits["cpu"]).max())
    ok = (np.allclose(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-5)
          and launched == 3 * cfg.num_layers)
    log("lm-parity", arch=cfg.name + " (reduced)", dtype=cfg.dtype,
        steps=len(feeds), logits=list(logits["cuda"].shape),
        k4_launches=launched, max_abs_err=err, ok=ok)
    if not ok:
        raise AssertionError(f"card vs CPU logits differ: {err} "
                             f"(K4 launched {launched})")


# ---------------------------------------------------------------------------
# the LM training slice and decoder-only serving
# ---------------------------------------------------------------------------

LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_EVERY = 8, 8, 256, 4
LM_TRAIN_CUT = 6                  # the interrupted run's steps
LM_TRAIN_LAYERS = 6               # of 12 + 12: lm-train's depth
NO_SAVE = 10 ** 6                 # a checkpoint interval no run reaches
LM_RESUME_RTOL = 2e-3             # resumed steps against the uninterrupted
DEC_TRAIN_ARCH, DEC_TRAIN_BATCH, DEC_TRAIN_SEQ = "gemma-2b", 2, 1024
DEC_CHUNK = 512                   # chunked_ce of the third step
DEC_CE_RTOL = 5e-3                # chunked against plain CE, bf16 logits
DEC_SERVE_ARCH, DEC_SERVE_BATCH = "h2o-danube-3-4b", 2
DEC_PROMPT, DEC_NEW = 4032, 128   # the 4,096-slot ring wraps at step 64
XL_ARCH, ZA_ARCH = "xlstm-125m", "zamba2-2.7b"
XL_TRAIN_STEPS, XL_TRAIN_BATCH, XL_TRAIN_SEQ, XL_TRAIN_EVERY = 2, 8, 1024, 1
XL_TRAIN_CUT = 1                  # the interrupted run's steps
# depths cut to keep the script within 960 s once starcoder2's and
# internvl2's four phases came in: lm-train's seamless to 6 + 6 layers
# (LM_TRAIN_LAYERS), xlstm to 6 of 12 blocks here and in the mesh phases
# (the sLSTM at 3; the one at 9 is the same code), and the mesh phases'
# gemma, zamba2, qwen2 and danube (MESH_*_LAYERS, SERVE_MESH_RUNS)
XL_TRAIN_LAYERS = 6
XL_CHUNK, XL_CHUNK_RTOL = 256, 2e-3   # chunked against parallel mLSTM, bf16
REC_SERVE = ((XL_ARCH, 4, 512, 128), (ZA_ARCH, 2, 512, 64))
MOE_SERVE = (("deepseek-v2-236b", 3), ("arctic-480b", 1))  # (arch, layers)
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 512, 64
MOE_CHECK_SHAPE = (2, 128)        # tokens of the full-width MoE layer check
MOE_CHECK_TOL = 2.0 ** -5         # of the plain form's largest |output|
MLA_CHECK_PROMPT = 128            # cached tokens before the absorbed step
MLA_CHECK_TOL = 1e-4              # of the expand form's largest |output|
SC_ARCH, VLM_ARCH = "starcoder2-7b", "internvl2-1b"
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 4, 512, 64   # lm-serve-sc / -vlm
# train_steps: lm-train-zamba2, lm-train-vlm, lm-train-sc
STEP_TRAIN_STEPS, STEP_TRAIN_BATCH, STEP_TRAIN_SEQ = 3, 2, 1024
SC_TRAIN_PEAK = 72e9              # lm-train-sc's peak stays under this
# the most of starcoder2's 32 layers whose training peak stays under
# SC_TRAIN_PEAK in this script on an H100: 24 layers peaked at 72.43 GB
# (71.66 alone: the script holds 0.77 GB of earlier phases), 23 at 68.90
# alone; a layer adds 2.6 GB of bf16 parameters, gradients and f32
# moments (PERF.md §6)
SC_TRAIN_LAYERS = 23
TRAIN_PARITY_ARCHS = ("seamless-m4t-medium", DEC_TRAIN_ARCH, DEC_SERVE_ARCH,
                      XL_ARCH, ZA_ARCH, "deepseek-v2-236b", "arctic-480b",
                      "qwen2-7b", SC_ARCH, VLM_ARCH)
TRAIN_PARITY_TOL = dict(rtol=1e-4, atol=1e-5)
# xLSTM's tied embedding: on the CPU alone its f32 gradients sit up to
# 4.7e-5 from an f64 evaluation of the same loss (exponential gates)
TRAIN_PARITY_TOL_BY_ARCH = {XL_ARCH: dict(rtol=1e-4, atol=1e-4)}
CARD_BYTES = 80e9                 # one H100's HBM
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "deepseek-v2-236b", 2  # dense + one MoE
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 3, 2, 1024
SLICE_CHECK_ELEMENTS = 3 * 2 ** 26 + 12_345   # (a): 3 slices + a ragged tail
CHECKSUM_SLICE = 2 ** 26          # elements a checksum slice (d)


def at_depth(cfg, layers: int, encoder_layers: int = 0):
    """``cfg`` cut to its first ``layers`` (decoder) layers and, for an
    encoder-decoder, ``encoder_layers`` encoder layers; an xLSTM keeps
    the sLSTM blocks that fall among them."""
    cut = dict(num_layers=layers)
    if encoder_layers:
        cut["encoder_layers"] = encoder_layers
    if cfg.xlstm is not None:
        cut["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_at=tuple(
            i for i in cfg.xlstm.slstm_at if i < layers))
    return dataclasses.replace(cfg, **cut)


def lm_counters() -> dict:
    """K1's to K4's launch counters."""
    from repro_torch.kernels import flash_attention as k4
    return {**kernel_counters()[0], "flash_attention": k4.launches}


def lm_phase_start() -> tuple:
    """Zero the launch counters and the peak-memory mark; (counters, t0)."""
    import torch
    counters = lm_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return counters, time.perf_counter()


def lm_phase_end(name: str, counters: dict, t0: float,
                 peak=None) -> tuple:
    """Read the counters, log the phase's wall time and peak memory (the
    caller's ``peak`` where it reset the mark inside the phase), and
    fail if K4 (or any other kernel) was launched: none is on these paths
    (the reference sends training and decoder-only decode to ``mha_ref``)."""
    import torch
    torch.cuda.synchronize()
    counts = {k: c.value for k, c in counters.items()}
    peak = max(peak or 0, torch.cuda.max_memory_allocated())
    log(f"{name}-done", seconds=round(time.perf_counter() - t0, 2),
        peak_mem_gb=round(peak / 1e9, 3), launches=counts)
    if any(counts.values()):
        raise AssertionError(f"{name}: kernels launched {counts}, expected "
                             f"none on this path")
    return counts, peak


def free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def tree_size(tree) -> tuple[int, int]:
    """(elements, bytes) of a tree's tensors."""
    from repro_torch.models.scan_util import tree_leaves
    leaves = tree_leaves(tree)
    return (sum(t.numel() for t in leaves),
            sum(t.numel() * t.element_size() for t in leaves))


def dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def phase_lm_train() -> dict:
    """``seamless-m4t-medium`` at its published width, ``remat=True``,
    through ``launch.train.train_loop``: 8 steps at batch 8, seq 256 (64
    frames + 192 tokens); then 6 steps with a checkpoint every 4 and a
    resume to 8 that saves none (one checkpoint written in all)."""
    import math
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    cfg = dataclasses.replace(
        at_depth(get_config(LM_ARCH), LM_TRAIN_LAYERS, LM_TRAIN_LAYERS),
        attn_impl="pallas", remat=True)
    ck = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
              ckpt_every=LM_TRAIN_EVERY, log_every=0, seed=SEED)
    counters, t0 = lm_phase_start()
    try:
        full = train_loop(cfg, steps=LM_TRAIN_STEPS, **kw)
        full_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        cut = train_loop(cfg, steps=LM_TRAIN_CUT, ckpt_dir=ck / "cut", **kw)
        ck_bytes = dir_bytes(ck / "cut" / f"step_{LM_TRAIN_EVERY:08d}")
        free_at = shutil.disk_usage(ck).free
        resumed = train_loop(cfg, steps=LM_TRAIN_STEPS, ckpt_dir=ck / "cut",
                             resume=True, **{**kw, "ckpt_every": NO_SAVE})
        resume_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    counts, peak = lm_phase_end("lm-train", counters, t0)
    losses = full.losses
    step_s = float(np.mean(full.step_times[1:]))
    tail = losses[LM_TRAIN_EVERY:]
    resumed_err = float(np.max(np.abs(np.subtract(resumed.losses, tail))
                               / np.abs(tail)))
    ln_v = math.log(cfg.vocab_size)
    log("lm-train", arch=cfg.name, layers=f"{cfg.encoder_layers}+"
        f"{cfg.num_layers}", d_model=cfg.d_model, vocab=cfg.vocab_size,
        dtype=cfg.dtype, remat=cfg.remat, steps=LM_TRAIN_STEPS,
        batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
        losses=[round(x, 5) for x in losses], ln_vocab=round(ln_v, 4),
        ms_per_step=round(step_s * 1e3, 2),
        step_ms=[round(s * 1e3, 1) for s in full.step_times],
        positions_per_s=round(LM_TRAIN_BATCH * LM_TRAIN_SEQ / step_s, 1),
        decoder_tokens_per_s=round(LM_TRAIN_BATCH * (LM_TRAIN_SEQ * 3 // 4)
                                   / step_s, 1),
        checkpoints=cut.checkpoints + resumed.checkpoints,
        checkpoint_gb=round(ck_bytes / 1e9, 3), run_s=round(full_s, 2),
        init_s=round(full_s - sum(full.step_times), 2),
        disk_free_gb=round(free_at / 1e9, 1), k4=counts["flash_attention"],
        peak_mem_gb=round(peak / 1e9, 3))
    log("lm-train-resume", cut_steps=LM_TRAIN_CUT, cut_losses_equal=(
        cut.losses == losses[:LM_TRAIN_CUT]),
        resumed_from=resumed.resumed_from,
        resumed_losses=[round(x, 5) for x in resumed.losses],
        max_rel_err=resumed_err, rtol=LM_RESUME_RTOL,
        bit_for_bit=resumed.losses == tail, seconds=round(resume_s, 2))
    if not all(math.isfinite(x) for x in losses + resumed.losses):
        raise AssertionError(f"lm-train: non-finite loss {losses}")
    if abs(losses[0] - ln_v) > 1.0 or not losses[-1] < losses[0]:
        raise AssertionError(f"lm-train: losses {losses} (first must be "
                             f"within 1.0 of ln V = {ln_v:.3f}, last below)")
    if resumed.resumed_from != LM_TRAIN_EVERY or resumed_err > LM_RESUME_RTOL:
        raise AssertionError(f"lm-train: resumed from "
                             f"{resumed.resumed_from}, losses "
                             f"{resumed.losses} vs {tail}")
    del full, cut, resumed
    free_card()
    return counts


def nonfinite_leaves(tree) -> int:
    """The leaves of ``tree`` with a non-finite entry, each read over
    AdamW's slices: whole-leaf ``isfinite`` temporaries of starcoder2's
    FFN stacks raised ``lm-train-sc``'s peak by 6.3 GB."""
    import torch
    from repro_torch.models.scan_util import tree_leaves
    from repro_torch.optim.adam import leaf_slices
    return sum(int(not torch.stack([torch.isfinite(s).all()
                                    for s, in leaf_slices(t)]).all())
               for t in tree_leaves(tree))


def step_split(model, opt, params, state, batch) -> tuple:
    """One more train step, its halves timed apart with CUDA events: the
    loss and gradients (forward, remat recompute, backward) and the AdamW
    update (clipping included), beside the update's bound: parameters and
    moments read and written once, gradients read once, over the HBM
    rate; each half's own peak memory (the mark reset before it); then
    the loss and the count of gradient leaves with a non-finite entry.
    Returns (that dict, the phase's peak bytes before the step), the
    latter for ``lm_phase_end``'s ``peak``."""
    import torch
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.scan_util import tree_leaves
    update_bytes = sum(2 * p.numel() * p.element_size()
                       + p.numel() * p.element_size()
                       + 2 * (m.numel() * m.element_size()
                              + v.numel() * v.element_size())
                       for p, m, v in zip(tree_leaves(params),
                                          tree_leaves(state["m"]),
                                          tree_leaves(state["v"])))
    prior = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    loss, grads = value_and_grad(model.loss, params,
                                 {k: v[0] for k, v in batch.items()})
    ev[1].record()
    grads_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt.update(grads, state, params)
    ev[2].record()
    ev[2].synchronize()
    return {"loss_and_grads": round(ev[0].elapsed_time(ev[1]), 2),
            "adamw": round(ev[1].elapsed_time(ev[2]), 2),
            "adamw_bound": round(update_bytes / HBM_MS, 2),
            "loss_and_grads_peak_gb": round(grads_peak / 1e9, 3),
            "adamw_peak_gb": round(torch.cuda.max_memory_allocated() / 1e9,
                                   3),
            "loss": float(loss),      # the update reads the gradients only
            "nonfinite_grad_leaves": nonfinite_leaves(grads)
            }, max(prior, grads_peak)


def phase_lm_train_dec() -> dict:
    """``gemma-2b`` at its published width: 2 ``make_train_step`` steps at
    batch 2, seq 1,024, ``remat=True``; then, from the same parameters and
    batch, the plain-CE loss and one step with ``chunked_ce=512`` and
    ``bf16_grad_stream=True``: the two losses within rtol 5e-3."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import add_accum_dim, make_train_step
    from repro_torch.models.common import make_generator
    from repro_torch.models.lm import get_model, make_batch
    from repro_torch.models.scan_util import tree_leaves
    from repro_torch.optim.adam import AdamConfig, AdamW
    cfg = dataclasses.replace(get_config(DEC_TRAIN_ARCH), attn_impl="pallas",
                              remat=True)
    counters, t0 = lm_phase_start()
    model = get_model(cfg)
    params = model.init(SEED)
    n_params, p_bytes = tree_size(params)
    opt = AdamW(AdamConfig(lr=3e-4, clip_norm=1.0))
    state = opt.init(params)
    step = make_train_step(model, opt)
    batches = [add_accum_dim(cfg, make_batch(
        cfg, DEC_TRAIN_SEQ, DEC_TRAIN_BATCH, make_generator(SEED + i)))
        for i in range(3)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, times = [], []
    for batch in batches[:2]:
        t1 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t1)
    with torch.no_grad():
        plain = float(model.loss(params, {k: v[0] for k, v in
                                          batches[2].items()}))
    ccfg = dataclasses.replace(cfg, chunked_ce=DEC_CHUNK,
                               bf16_grad_stream=True)
    t1 = time.perf_counter()
    params, state, loss = make_train_step(get_model(ccfg), opt)(
        params, state, batches[2])
    chunked = float(loss)
    chunk_s = time.perf_counter() - t1
    split, peak = step_split(model, opt, params, state, batches[0])
    nan_leaves = sum(int(torch.isnan(p).any()) for p in tree_leaves(params))
    counts, peak = lm_phase_end("lm-train-dec", counters, t0, peak)
    rel = abs(chunked - plain) / abs(plain)
    log("lm-train-dec", arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
        head_dim=cfg.head_dim_eff, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        tied=cfg.tie_embeddings, params=n_params,
        param_gb=round(p_bytes / 1e9, 3),
        state_gb=round((p_bytes + tree_size(state["m"])[1]
                        + tree_size(state["v"])[1]) / 1e9, 3),
        init_s=round(init_s, 2), batch=DEC_TRAIN_BATCH, seq_len=DEC_TRAIN_SEQ,
        losses=[round(x, 5) for x in losses],
        step_ms=[round(t * 1e3, 1) for t in times],
        chunked_step_ms=round(chunk_s * 1e3, 1), split_step_ms=split,
        tokens_per_s=round(DEC_TRAIN_BATCH * DEC_TRAIN_SEQ / times[-1], 1),
        plain_ce=plain, chunked_ce=chunked, ce_rel_err=rel,
        ce_rtol=DEC_CE_RTOL, nan_leaves=nan_leaves,
        peak_mem_gb=round(peak / 1e9, 3))
    if not all(np.isfinite(losses + [plain, chunked])) or nan_leaves:
        raise AssertionError(f"lm-train-dec: losses {losses}, {plain}, "
                             f"{chunked}; {nan_leaves} NaN leaves")
    if rel > DEC_CE_RTOL:
        raise AssertionError(f"lm-train-dec: chunked CE {chunked} vs plain "
                             f"{plain}")
    if peak >= CARD_BYTES:
        raise AssertionError(f"lm-train-dec: peak memory {peak / 1e9} GB")
    del params, state, batches, model, step
    free_card()
    return counts


def slices_check() -> dict:
    """(a) of ``lm-train-moe``: one random leaf of SLICE_CHECK_ELEMENTS
    (bf16 parameter and gradient, f32 moments, weight decay 0.1, no
    clipping) updated over AdamW's slices and as a single slice (the
    constant raised for that call): parameter and moments bit for bit."""
    import torch
    from repro_torch.optim import adam
    n, limit = SLICE_CHECK_ELEMENTS, adam.SLICE_ELEMENTS
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p, g, m = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    v = torch.rand(n, generator=gen, device="cuda") * 1e-6
    p, g, m = p.bfloat16(), (g * 1e-3).bfloat16(), m * 1e-3
    opt = adam.AdamW(adam.AdamConfig(lr=3e-4, weight_decay=0.1))
    out, ms = {}, {}
    for name, elements in (("sliced", limit), ("one", n)):
        params, state = [p.clone()], {"m": [m.clone()], "v": [v.clone()],
                                      "step": 0}
        adam.SLICE_ELEMENTS = elements
        try:
            pieces = len(adam.leaf_slices(p))
            ms[name] = cuda_ms(lambda: opt.update([g], state, params))
        finally:
            adam.SLICE_ELEMENTS = limit
        out[name] = (params[0], state["m"][0], state["v"][0], pieces)
    equal = [bool(torch.equal(a, b)) for a, b in zip(out["sliced"][:3],
                                                      out["one"][:3])]
    return {"elements": n, "slice_elements": limit,
            "slices": out["sliced"][3], "one": out["one"][3],
            "sliced_ms": round(ms["sliced"], 3), "one_ms": round(ms["one"], 3),
            "p_m_v_equal": equal}


def bit_checksums(tree) -> list:
    """Two integer checksums of each leaf's raw bits, slice by slice: the
    bits' sum and their sum weighted by position mod 65,521 plus 1 (int64,
    wrapping), so two trees compare without both on the card."""
    import torch
    from repro_torch.models.scan_util import tree_leaves
    ints = {2: torch.int16, 4: torch.int32}
    out = []
    for t in tree_leaves(tree):
        flat = t.reshape(-1).view(ints[t.element_size()])
        plain = weighted = 0
        for i in range(0, flat.numel(), CHECKSUM_SLICE):
            x = flat[i:i + CHECKSUM_SLICE].long()
            pos = torch.arange(i, i + x.numel(), device=x.device) % 65521 + 1
            plain += int(x.sum())
            weighted += int((x * pos).sum())
        out.append((plain, weighted))
    return out


def phase_lm_train_moe() -> dict:
    """``deepseek-v2-236b`` at its published widths, trained on one card at
    2 of its 60 layers (the dense first layer and one MoE layer): (a) AdamW
    over slices of a leaf against one slice, bit for bit
    (:func:`slices_check`); (b) ``train_loop``, 3 steps at 2 × 1,024
    (bf16, remat, f32 moments, clip 1.0): losses finite, peak memory under
    80 GB; (c) from a fresh tree of the same seed, one step's loss and
    gradients and its AdamW update timed apart (``step_split``), no
    gradient leaf non-finite; (d) the loss and gradients twice on the same
    parameters and batch, bit for bit (:func:`bit_checksums`)."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import add_accum_dim, value_and_grad
    from repro_torch.launch.sharding import map_with_path
    from repro_torch.launch.train import train_loop
    from repro_torch.models.common import make_generator
    from repro_torch.models.lm import get_model, make_batch
    from repro_torch.models.scan_util import tree_leaves
    from repro_torch.optim.adam import AdamConfig, AdamW
    full = get_config(MOE_TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_TRAIN_LAYERS)
    counters, t0 = lm_phase_start()
    sliced = slices_check()
    log("lm-train-moe-slices", **sliced)
    if not all(sliced["p_m_v_equal"]) or sliced["slices"] < 2 \
            or sliced["one"] != 1:
        raise AssertionError(f"lm-train-moe: sliced update {sliced}")
    free_card()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    report = train_loop(cfg, steps=MOE_TRAIN_STEPS, batch=MOE_TRAIN_BATCH,
                        seq_len=MOE_TRAIN_SEQ, seed=SEED, log_every=0,
                        device=None)
    loop_s = time.perf_counter() - t1
    loop_peak = torch.cuda.max_memory_allocated()
    peak = max(peak, loop_peak)
    free_card()

    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    params = model.init(SEED)
    n_params, p_bytes = tree_size(params)
    opt = AdamW(AdamConfig(lr=3e-4, clip_norm=1.0))
    state = opt.init(params)
    s_bytes = p_bytes + tree_size(state["m"])[1] + tree_size(state["v"])[1]
    batch = add_accum_dim(cfg, make_batch(cfg, MOE_TRAIN_SEQ,
                                          MOE_TRAIN_BATCH,
                                          make_generator(SEED)))
    init_peak = torch.cuda.max_memory_allocated()
    split, split_prior = step_split(model, opt, params, state, batch)
    peak = max(peak, split_prior)
    del state
    free_card()
    peak = max(peak, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()

    names = tree_leaves(map_with_path(lambda path, _: path, params))
    one = {k: v[0] for k, v in batch.items()}
    runs = []
    t1 = time.perf_counter()
    for _ in range(2):
        loss, grads = value_and_grad(model.loss, params, one)
        runs.append((float(loss), bit_checksums(grads)))
        del grads
    det_s = time.perf_counter() - t1
    det_peak = torch.cuda.max_memory_allocated()
    differ = [n for n, a, b in zip(names, runs[0][1], runs[1][1]) if a != b]
    counts, peak = lm_phase_end("lm-train-moe", counters, t0, peak)
    step_s = float(np.mean(report.step_times[1:]))
    log("lm-train-moe", arch=cfg.name,
        layers=f"{cfg.num_layers} of {full.num_layers}",
        d_model=cfg.d_model, experts=cfg.moe.num_experts,
        top_k=cfg.moe.top_k, d_expert=cfg.moe.d_expert,
        shared=cfg.moe.num_shared, vocab=cfg.vocab_size, dtype=cfg.dtype,
        remat=cfg.remat, params=n_params, param_gb=round(p_bytes / 1e9, 3),
        state_gb=round(s_bytes / 1e9, 3), steps=MOE_TRAIN_STEPS,
        batch=MOE_TRAIN_BATCH, seq_len=MOE_TRAIN_SEQ,
        losses=[round(x, 5) for x in report.losses],
        ln_vocab=round(math.log(cfg.vocab_size), 4),
        step_ms=[round(t * 1e3, 1) for t in report.step_times],
        ms_per_step=round(step_s * 1e3, 2),
        tokens_per_s=round(MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / step_s, 1),
        loop_s=round(loop_s, 2), loop_peak_gb=round(loop_peak / 1e9, 3),
        init_peak_gb=round(init_peak / 1e9, 3), split_step_ms=split,
        peak_mem_gb=round(peak / 1e9, 3))
    log("lm-train-moe-determinism", passes=2, leaves=len(names),
        losses=[r[0] for r in runs], losses_equal=runs[0][0] == runs[1][0],
        leaves_differing=differ, seconds=round(det_s, 2),
        peak_mem_gb=round(det_peak / 1e9, 3))
    if not all(math.isfinite(x) for x in report.losses + [split["loss"]]) \
            or split["nonfinite_grad_leaves"]:
        raise AssertionError(f"lm-train-moe: losses {report.losses}, "
                             f"{split['loss']}; "
                             f"{split['nonfinite_grad_leaves']} non-finite "
                             f"gradient leaves")
    if peak >= CARD_BYTES:
        raise AssertionError(f"lm-train-moe: peak memory {peak / 1e9} GB")
    if runs[0][0] != runs[1][0] or differ:
        raise AssertionError(f"lm-train-moe: two gradient passes differ: "
                             f"losses {runs[0][0]} / {runs[1][0]}, leaves "
                             f"{differ}")
    del params, batch, model, report
    free_card()
    return counts


def watch_decode(engine) -> tuple:
    """Wrap ``engine``'s decode step: every step's logits must be finite
    (one flag on the card, no read-back a step), and the last step's
    logits and state are kept.  Returns (the flag, ``{"logits",
    "state"}``, a function that unwraps the step)."""
    import torch
    finite = torch.ones((), dtype=torch.bool, device=engine.device)
    last = {}
    decode = engine.model.decode_step

    def checked(p, tokens, state):
        logits, state = decode(p, tokens, state)
        finite.logical_and_(torch.isfinite(logits).all())
        last.update(logits=logits, state=state)
        return logits, state

    def unwatch():
        engine.model = dataclasses.replace(engine.model, decode_step=decode)

    engine.model = dataclasses.replace(engine.model, decode_step=checked)
    return finite, last, unwatch


def phase_lm_serve_dec() -> dict:
    """``h2o-danube-3-4b`` at its published width (``attn_impl="pallas"``)
    through ``ServeEngine(max_batch=2).generate_batch``: 2 requests of
    4,032 prompt tokens and 128 new tokens, so the 4,096-slot ring cache
    wraps at decode step 64.  Then ``lm_forward`` over the 4,159 tokens
    without a cache against the last decode step's logits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import transformer
    from repro_torch.models.lm import get_model
    cfg = dataclasses.replace(get_config(DEC_SERVE_ARCH), attn_impl="pallas")
    counters, t0 = lm_phase_start()
    params = get_model(cfg).init(SEED)
    n_params, p_bytes = tree_size(params)
    engine = ServeEngine(cfg, params, max_batch=DEC_SERVE_BATCH)
    dev = engine.device
    finite, last, unwatch = watch_decode(engine)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (DEC_SERVE_BATCH, DEC_PROMPT)
                           ).astype(np.int32)
    reqs = [Request(p, max_new_tokens=DEC_NEW) for p in prompts]
    comp = engine.generate_batch(reqs)
    tokens = np.stack([c.tokens for c in comp])
    steps = comp[0].steps - 1
    ring = last["state"]["caches"]["layers"]
    seen = DEC_PROMPT + steps                        # positions fed
    window = cfg.sliding_window
    want_pos = torch.arange(seen - window, seen, dtype=torch.int32,
                            device=dev)
    ring_ok = bool(torch.equal(ring["slot_pos"].sort(dim=1).values,
                               want_pos.expand(cfg.num_layers, -1)))
    fed = np.concatenate([prompts, tokens[:, :steps]], axis=1)
    with torch.inference_mode():
        full = transformer.lm_forward(params, cfg,
                                      torch.from_numpy(fed).to(dev))[:, -1]
    got = last["logits"].float()
    scale = float(got.abs().max())
    err = float((full.float() - got).abs().max())
    tol = 2.0 ** -5 * scale
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (ring["k"], ring["v"]))
    bound_ms = (p_bytes + cache_bytes) / HBM_MS
    unwatch()
    profile_decode(engine, torch.from_numpy(tokens[:, -1:]).to(dev),
                   last["state"], "lm-serve-dec-profile")
    counts, peak = lm_phase_end("lm-serve-dec", counters, t0)
    c = comp[0]
    ok_tokens = tokens.shape == (DEC_SERVE_BATCH, DEC_NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    log("lm-serve-dec", arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
        window=window, params=n_params, param_gb=round(p_bytes / 1e9, 3),
        requests=len(comp), prompt=DEC_PROMPT, new_tokens=DEC_NEW,
        decode_steps=steps, prefill_ms=round(c.prefill_s * 1e3, 2),
        ms_per_token=round(c.decode_s * 1e3 / steps, 3),
        step_bound_ms=round(bound_ms, 3),
        step_bound_weights_ms=round(p_bytes / HBM_MS, 3),
        ring_gb=round(cache_bytes / 1e9, 3),
        decode_tokens_per_s=round(len(comp) * steps / c.decode_s, 1),
        tokens_ok=ok_tokens, logits_finite=bool(finite),
        ring_holds_last_window=ring_ok, wrapped_at_step=window - DEC_PROMPT,
        full_forward_max_abs_err=err, logits_max_abs=scale, tol=tol,
        k4=counts["flash_attention"], peak_mem_gb=round(peak / 1e9, 3))
    if not (ok_tokens and bool(finite) and ring_ok and err <= tol):
        raise AssertionError(
            f"lm-serve-dec: tokens ok {ok_tokens}, finite {bool(finite)}, "
            f"ring {ring_ok}, full-forward err {err} > {tol}")
    del engine, params, last, full, got
    free_card()
    return counts


def cuda_ms(fn) -> float:
    """``fn()``'s time on the card by CUDA events (a sync after)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def profile_device(fn) -> tuple:
    """``fn()`` under ``torch.profiler`` with device activity only (an
    xLSTM train step launches about 186,000 kernels; with host events too
    the profile took minutes to read): (device busy ms, kernel launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in on_card) / 1e3,
            sum(e.count for e in on_card))


def phase_lm_train_xlstm() -> dict:
    """``xlstm-125m`` at its published width, 6 of its 12 blocks (bf16,
    remat), through ``train_loop``: 2 steps at batch 8 × 1,024, then 1 step with a
    checkpoint and a resume to 2 (bit for bit);
    one more step profiled beside the sLSTM blocks alone; the chunked
    mLSTM's loss against the parallel form's."""
    import math
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import (add_accum_dim, make_train_step,
                                          value_and_grad)
    from repro_torch.launch.train import train_loop
    from repro_torch.models import xlstm_lm
    from repro_torch.models.common import make_generator
    from repro_torch.models.lm import get_model, make_batch
    from repro_torch.optim.adam import AdamConfig, AdamW
    published = get_config(XL_ARCH)
    cfg = dataclasses.replace(at_depth(published, XL_TRAIN_LAYERS),
                              remat=True)
    ck = ROOT / "build" / "lm_train_xlstm_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(batch=XL_TRAIN_BATCH, seq_len=XL_TRAIN_SEQ,
              ckpt_every=XL_TRAIN_EVERY, log_every=0, seed=SEED)
    counters, t0 = lm_phase_start()
    try:
        full = train_loop(cfg, steps=XL_TRAIN_STEPS, **kw)
        full_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        cut = train_loop(cfg, steps=XL_TRAIN_CUT, ckpt_dir=ck / "cut", **kw)
        ck_bytes = dir_bytes(ck / "cut" / f"step_{XL_TRAIN_EVERY:08d}")
        resumed = train_loop(cfg, steps=XL_TRAIN_STEPS, ckpt_dir=ck / "cut",
                             resume=True, **{**kw, "ckpt_every": NO_SAVE})
        resume_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(ck, ignore_errors=True)

    model = get_model(cfg)
    params = model.init(SEED)
    n_params, p_bytes = tree_size(params)
    opt = AdamW(AdamConfig(lr=3e-4, clip_norm=1.0))
    state = opt.init(params)
    step = make_train_step(model, opt)
    batch = add_accum_dim(cfg, make_batch(cfg, XL_TRAIN_SEQ, XL_TRAIN_BATCH,
                                          make_generator(SEED)))

    # the sLSTM blocks alone, as the model runs them (forward under
    # remat, recompute, backward) on a batch-shaped input
    runs = [name for name, _, kind in xlstm_lm.layer_runs(cfg)
            if kind == "slstm"]
    gen = make_generator(SEED + 1)
    x = torch.randn((XL_TRAIN_BATCH, XL_TRAIN_SEQ, cfg.d_model),
                    generator=gen, device=gen.device).to(torch.bfloat16)

    def slstm_blocks(p, _):
        h = x
        for name in runs:
            h = xlstm_lm._scan_run(p[name], cfg, h, "slstm")
        return h.float().square().mean()

    sl_params = {name: params[name] for name in runs}
    # in turns (step, blocks, blocks, step): the host's pace drifts
    times = {"step": [], "slstm": []}
    for which in ("step", "slstm", "slstm", "step"):
        times[which].append(cuda_ms(
            (lambda: step(params, state, batch)) if which == "step" else
            (lambda: value_and_grad(slstm_blocks, sl_params, None))))
    step_ms, sl_ms = (float(np.mean(times[k])) for k in ("step", "slstm"))
    busy_ms, launches = profile_device(lambda: step(params, state, batch))
    with torch.no_grad():
        mb = {k: v[0] for k, v in batch.items()}
        plain = float(model.loss(params, mb))
        ccfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
            cfg.xlstm, chunk=XL_CHUNK))
        chunked = float(get_model(ccfg).loss(params, mb))
    counts, peak = lm_phase_end("lm-train-xlstm", counters, t0)
    losses = full.losses
    tail = losses[XL_TRAIN_EVERY:]
    step_s = float(np.mean(full.step_times[1:]))
    chunk_rel = abs(chunked - plain) / abs(plain)
    ln_v = math.log(cfg.vocab_size)
    log("lm-train-xlstm", arch=cfg.name,
        layers=f"{cfg.num_layers} of {published.num_layers}",
        slstm_at=list(cfg.xlstm.slstm_at), d_model=cfg.d_model,
        vocab=cfg.vocab_size, tied=cfg.tie_embeddings, dtype=cfg.dtype,
        remat=cfg.remat, params=n_params, param_gb=round(p_bytes / 1e9, 3),
        steps=XL_TRAIN_STEPS, batch=XL_TRAIN_BATCH, seq_len=XL_TRAIN_SEQ,
        losses=[round(v, 5) for v in losses], ln_vocab=round(ln_v, 4),
        ms_per_step=round(step_s * 1e3, 2),
        step_ms=[round(t * 1e3, 1) for t in full.step_times],
        tokens_per_s=round(XL_TRAIN_BATCH * XL_TRAIN_SEQ / step_s, 1),
        checkpoints=cut.checkpoints + resumed.checkpoints,
        checkpoint_gb=round(ck_bytes / 1e9, 3), run_s=round(full_s, 2),
        timed_step_ms=[round(t, 2) for t in times["step"]],
        device_busy_ms=round(busy_ms, 2),
        idle_share=round(1.0 - busy_ms / step_ms, 4),
        device_launches_per_step=launches,
        slstm_blocks_ms=[round(t, 2) for t in times["slstm"]],
        slstm_share_of_step=round(sl_ms / step_ms, 4),
        plain_loss=plain, chunked_loss=chunked, chunk=XL_CHUNK,
        chunk_rel_err=chunk_rel, chunk_rtol=XL_CHUNK_RTOL,
        peak_mem_gb=round(peak / 1e9, 3))
    bitwise = resumed.losses == tail
    log("lm-train-xlstm-resume", cut_steps=XL_TRAIN_CUT,
        cut_losses_equal=cut.losses == losses[:XL_TRAIN_CUT],
        resumed_from=resumed.resumed_from,
        resumed_losses=[round(v, 5) for v in resumed.losses],
        bit_for_bit=bitwise, seconds=round(resume_s, 2))
    if not all(math.isfinite(v) for v in losses + resumed.losses):
        raise AssertionError(f"lm-train-xlstm: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"lm-train-xlstm: losses {losses} (the last "
                             f"must be below the first)")
    if resumed.resumed_from != XL_TRAIN_EVERY or not bitwise:
        raise AssertionError(f"lm-train-xlstm: resumed from "
                             f"{resumed.resumed_from}, losses "
                             f"{resumed.losses} vs {tail}")
    if not chunk_rel <= XL_CHUNK_RTOL:
        raise AssertionError(f"lm-train-xlstm: chunked loss {chunked} vs "
                             f"parallel {plain}")
    del full, cut, resumed, params, state, model, step, batch, x, sl_params
    free_card()
    return counts


def phase_lm_train_zamba2() -> dict:
    """``zamba2-2.7b`` at its published width (bf16, remat) through
    :func:`train_steps`."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(ZA_ARCH), remat=True)
    return train_steps(
        cfg, "lm-train-zamba2", layers=cfg.num_layers,
        groups=f"{cfg.num_layers // cfg.shared_attn_every}x"
        f"{cfg.shared_attn_every}", d_inner=cfg.ssm.expand * cfg.d_model,
        ssd_heads=cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim,
        d_state=cfg.ssm.d_state, chunk=cfg.ssm.chunk)["counts"]


def rec_state_bytes(state: dict, pos: int) -> tuple[int, int]:
    """(recurrent state bytes, KV rows 0..pos bytes) of a decode state."""
    from repro_torch.models.scan_util import tree_leaves
    rec = sum(t.numel() * t.element_size() for k, v in state.items()
              if k not in ("pos", "shared_kv") for t in tree_leaves(v))
    kv = sum(t[..., :pos, :].numel() * t.element_size()
             for t in tree_leaves(state.get("shared_kv", {})))
    return rec, kv


def phase_lm_serve_rec() -> dict:
    """``ServeEngine`` over xlstm-125m and zamba2-2.7b at their published
    widths: the prompt through the recurrent forms against the parallel
    forward at its last position, the decode loop, one profiled step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import hybrid, xlstm_lm
    from repro_torch.models.lm import get_model
    counters, t0 = lm_phase_start()
    for arch, b, prompt, new in REC_SERVE:
        cfg = get_config(arch)
        params = get_model(cfg).init(SEED)
        n_params, p_bytes = tree_size(params)
        engine = ServeEngine(cfg, params, max_batch=b)
        dev = engine.device
        finite = torch.ones((), dtype=torch.bool, device=dev)
        seen = []
        decode = engine.model.decode_step

        def checked(p, tokens, state):
            logits, state = decode(p, tokens, state)
            finite.logical_and_(torch.isfinite(logits).all())
            if not seen:
                seen.append(logits.clone())          # the prefill's
            seen[1:] = [state]
            return logits, state

        engine.model = dataclasses.replace(engine.model, decode_step=checked)
        rng = np.random.default_rng(SEED)
        prompts = rng.integers(0, cfg.vocab_size, (b, prompt)
                               ).astype(np.int32)
        comp = engine.generate_batch([Request(p, max_new_tokens=new)
                                      for p in prompts])
        engine.model = dataclasses.replace(engine.model, decode_step=decode)
        tokens = np.stack([c.tokens for c in comp])
        steps = comp[0].steps - 1                    # decode calls
        state = seen[1]
        fwd = (xlstm_lm.xlstm_forward if cfg.xlstm is not None
               else hybrid.hybrid_forward)
        toks = torch.from_numpy(prompts).to(dev)
        with torch.inference_mode():
            full = fwd(params, cfg, toks)[:, -1].float()
        bf16_gap = float((full - seen[0].float()).abs().max())
        # the check: the same weights in f32, the recurrences over the
        # prompt (decode_step) against the parallel forward
        err, scale = prefill_vs_parallel_f32(cfg, params, toks, fwd)
        tol = 2.0 ** -5 * scale
        pos_ok = state["pos"] == prompt + steps
        kv_distinct = None
        if "shared_kv" in state:
            k = state["shared_kv"]["k"][..., :state["pos"], :].flatten(1)
            kv_distinct = all(not torch.equal(k[i], k[j])
                              for i in range(k.shape[0])
                              for j in range(i + 1, k.shape[0]))
        rec_bytes, kv_bytes = rec_state_bytes(state, state["pos"])
        bound_ms = (p_bytes + 2 * rec_bytes + kv_bytes) / HBM_MS
        profile_decode(engine, torch.from_numpy(tokens[:, -1:]).to(dev),
                       state, f"lm-serve-rec-profile-{arch}")
        ok_tokens = tokens.shape == (b, new) and bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
        c = comp[0]
        log("lm-serve-rec", arch=cfg.name, layers=cfg.num_layers,
            d_model=cfg.d_model, params=n_params,
            param_gb=round(p_bytes / 1e9, 3), requests=len(comp),
            prompt=prompt, new_tokens=new, decode_steps=steps,
            prefill_ms=round(c.prefill_s * 1e3, 2),
            ms_per_token=round(c.decode_s * 1e3 / steps, 3),
            step_bound_ms=round(bound_ms, 4),
            step_bound_weights_ms=round(p_bytes / HBM_MS, 4),
            recurrent_state_gb=round(rec_bytes / 1e9, 4),
            kv_read_gb=round(kv_bytes / 1e9, 4),
            decode_tokens_per_s=round(len(comp) * steps / c.decode_s, 1),
            tokens_ok=ok_tokens, logits_finite=bool(finite),
            pos=state["pos"], pos_ok=pos_ok, kv_groups_distinct=kv_distinct,
            bf16_prefill_vs_parallel_max_abs_err=bf16_gap,
            bf16_logits_max_abs=float(full.abs().max()),
            f32_prefill_vs_parallel_max_abs_err=err,
            f32_logits_max_abs=scale, tol=tol)
        if not (ok_tokens and bool(finite) and pos_ok and err <= tol
                and kv_distinct is not False):
            raise AssertionError(
                f"lm-serve-rec {arch}: tokens ok {ok_tokens}, finite "
                f"{bool(finite)}, pos {state['pos']}, KV groups distinct "
                f"{kv_distinct}, prefill vs parallel err {err} > {tol}")
        del engine, params, seen, state, full
        free_card()
    counts, _ = lm_phase_end("lm-serve-rec", counters, t0)
    return counts


def routing_recorder(stats: list):
    """Wrap ``models.moe.route`` (which ``_routed_experts`` calls) so that
    each call appends (tokens, capacity, kept choices, choices); undo with
    the returned function.  Reads the kept count back: for an untimed run
    only."""
    from repro_torch.models import moe
    route = moe.route

    def recorded(xt, router, cfg, num_local_experts, expert_offset):
        top_aff, top_idx = route(xt, router, cfg, num_local_experts,
                                 expert_offset)
        stats.append((xt.shape[0], top_idx.shape[1],
                      int((top_aff != 0).sum()), xt.shape[0] * cfg.moe.top_k))
        return top_aff, top_idx

    moe.route = recorded
    return lambda: setattr(moe, "route", route)


def plain_moe(mp: dict, cfg, x):
    """The MoE layer's plain form, dropless: for each token, its top-k
    experts' FFNs (the model dtype's products) weighted and summed in f32,
    plus the shared experts or the dense residual; [B, S, d] f32."""
    import torch
    from repro_torch.models.common import activation
    from repro_torch.models.ffn import ffn_forward
    m = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs = torch.softmax(xt.float() @ mp["router"], dim=-1)
    gv, gi = torch.topk(probs, m.top_k, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True).clamp(min=1e-9)
    act = activation(cfg.ffn_act)
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for e in gi.unique().tolist():
        tok, slot = (gi == e).nonzero(as_tuple=True)
        xe = xt[tok]
        y = (act(xe @ mp["experts_w1"][e]) * (xe @ mp["experts_w3"][e])
             ) @ mp["experts_w2"][e]
        out.index_add_(0, tok, y.float() * gv[tok, slot, None])
    for name in ("shared", "dense"):
        if name in mp:
            out += ffn_forward(mp[name], cfg.ffn_act, xt, gated=True).float()
    return out.reshape(b, s, d)


def moe_layer_check(params: dict, cfg, gen) -> dict:
    """Check 3 of ``lm-serve-moe``: the served config's first MoE layer
    (bf16) through ``moe_forward`` on a dropless copy of the config
    (``capacity_factor = E / k``, so C = T) against :func:`plain_moe` on
    the same random activations."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.scan_util import tree_map
    m = cfg.moe
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    mp = tree_map(lambda t: t[0], params["layers_moe"]["moe"])
    x = torch.randn((*MOE_CHECK_SHAPE, cfg.d_model), generator=gen,
                    device=gen.device).to(torch.bfloat16)
    t = x.shape[0] * x.shape[1]
    with torch.inference_mode():
        got = moe.moe_forward(mp, dropless, x).float()
        want = plain_moe(mp, dropless, x)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return {"tokens": t, "capacity": moe.capacity(dropless, t),
            "max_abs_err": err, "max_abs": scale,
            "tol": MOE_CHECK_TOL * scale, "ok": err <= MOE_CHECK_TOL * scale}


def mla_forms_check(params: dict, cfg, gen) -> dict:
    """Check 4 of ``lm-serve-moe``: deepseek's first attention layer cast
    to f32 (TF32 off): a ``MLA_CHECK_PROMPT``-token prefill into the
    compressed cache, then one absorbed decode step, against the expand
    form over the same tokens without a cache, at the last position."""
    import torch
    from repro_torch.models import attention
    from repro_torch.models.scan_util import tree_map
    from repro_torch.models.transformer import token_positions
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ap = tree_map(lambda t: t[0].float(), params["layers_dense"]["attn"])
    b, s = 2, MLA_CHECK_PROMPT
    x = torch.randn((b, s + 1, cfg.d_model), generator=gen,
                    device=gen.device)
    dev = x.device
    with torch.inference_mode():
        cache = attention.init_mla_cache(cfg32, b, s + 1, device=dev)
        attention.mla_forward(ap, cfg32, x[:, :s], token_positions(
            b, s, 0, dev), kv_cache=cache, cache_pos=0)
        got, _ = attention.mla_forward(ap, cfg32, x[:, s:], token_positions(
            b, 1, s, dev), kv_cache=cache, cache_pos=s)
        full, _ = attention.mla_forward(ap, cfg32, x, token_positions(
            b, s + 1, 0, dev))
    want = full[:, -1]
    scale = float(want.abs().max())
    err = float((got[:, 0] - want).abs().max())
    return {"prompt": s, "max_abs_err": err, "max_abs": scale,
            "tol": MLA_CHECK_TOL * scale, "ok": err <= MLA_CHECK_TOL * scale}


def phase_lm_serve_moe() -> dict:
    """``ServeEngine(max_batch=4)`` over deepseek-v2-236b (3 layers: the
    dense one and 2 MoE) and arctic-480b (1 layer) at their published
    widths, bf16: 4 requests of 512 + 64 tokens, served twice (tokens and
    last logits bit for bit); the capacity and the dropped share of
    token-expert choices at prefill and at a decode step; one MoE layer
    against its plain form and (deepseek) MLA's absorbed step against
    its expand form, both at full width; a profiled decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import CACHE_MARGIN, Request, ServeEngine
    from repro_torch.models.common import make_generator
    from repro_torch.models.lm import get_model
    from repro_torch.models.scan_util import tree_leaves
    from repro_torch.models.transformer import layer_groups
    counters, t0 = lm_phase_start()
    for arch, layers in MOE_SERVE:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        t_init = time.perf_counter()
        params = get_model(cfg).init(SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_init
        init_peak = torch.cuda.max_memory_allocated()
        n_params, p_bytes = tree_size(params)
        engine = ServeEngine(cfg, params, max_batch=MOE_BATCH)
        dev = engine.device
        finite, last, unwatch = watch_decode(engine)
        rng = np.random.default_rng(SEED)
        prompts = rng.integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)
                               ).astype(np.int32)
        reqs = [Request(p, max_new_tokens=MOE_NEW) for p in prompts]
        comp = engine.generate_batch(reqs)
        tokens = np.stack([c.tokens for c in comp])
        logits_1 = last["logits"].clone()
        stats = []
        undo = routing_recorder(stats)
        try:
            again = engine.generate_batch(reqs)      # untimed, recorded
        finally:
            undo()
        same_tokens = all(np.array_equal(a.tokens, c.tokens)
                          for a, c in zip(again, comp))
        same_logits = bool(torch.equal(last["logits"], logits_1))
        t_pre = MOE_BATCH * MOE_PROMPT
        pre = [st for st in stats if st[0] == t_pre]
        step = [st for st in stats if st[0] == MOE_BATCH][:len(pre)]
        dropped = {name: 1.0 - sum(st[2] for st in sts) / sum(
            st[3] for st in sts) for name, sts in (("prefill", pre),
                                                   ("decode", step))}
        state = last["state"]
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(state["caches"]))
        per_token = cache_bytes // (MOE_BATCH * cfg.num_layers * (
            MOE_PROMPT + MOE_NEW + CACHE_MARGIN))
        steps = comp[0].steps - 1
        bound_ms = (p_bytes + cache_bytes) / HBM_MS
        unwatch()
        profile_decode(engine, torch.from_numpy(tokens[:, -1:]).to(dev),
                       state, f"lm-serve-moe-profile-{arch}")
        gen = make_generator(SEED + 1)
        layer = moe_layer_check(params, cfg, gen)
        mla = mla_forms_check(params, cfg, gen) if cfg.mla else None
        ok_tokens = tokens.shape == (MOE_BATCH, MOE_NEW) and bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
        c = comp[0]
        fields = {}
        if cfg.mla is not None:        # a per-head K/V cache of its heads
            m = cfg.mla
            per_head = cfg.num_heads * (m.qk_nope + m.qk_rope + m.v_head) * 2
            fields = dict(per_head_kv_bytes_per_token_layer=per_head,
                          per_head_kv_cache_gb=round(
                              cache_bytes / per_token * per_head / 1e9, 4))
        log("lm-serve-moe", arch=cfg.name, layers=cfg.num_layers,
            groups=[(g, n) for g, n, _ in layer_groups(cfg)],
            d_model=cfg.d_model, experts=cfg.moe.num_experts,
            top_k=cfg.moe.top_k, params=n_params,
            param_gb=round(p_bytes / 1e9, 3), init_s=round(init_s, 2),
            init_peak_gb=round(init_peak / 1e9, 3), requests=len(comp),
            prompt=MOE_PROMPT, new_tokens=MOE_NEW, decode_steps=steps,
            prefill_ms=round(c.prefill_s * 1e3, 2),
            ms_per_token=round(c.decode_s * 1e3 / steps, 3),
            recorded_prefill_ms=round(again[0].prefill_s * 1e3, 2),
            recorded_ms_per_token=round(again[0].decode_s * 1e3 / steps, 3),
            step_bound_ms=round(bound_ms, 3),
            step_bound_weights_ms=round(p_bytes / HBM_MS, 3),
            cache_gb=round(cache_bytes / 1e9, 4),
            cache_bytes_per_token_layer=per_token,
            **fields,
            decode_tokens_per_s=round(len(comp) * steps / c.decode_s, 1),
            capacity_prefill=pre[0][1], capacity_decode=step[0][1],
            dropped_share_prefill=round(dropped["prefill"], 5),
            dropped_share_decode=round(dropped["decode"], 5),
            tokens_ok=ok_tokens, logits_finite=bool(finite),
            served_twice_same_tokens=same_tokens,
            served_twice_same_logits=same_logits, moe_layer=layer,
            mla_forms=mla,
            peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
        if not (ok_tokens and bool(finite) and same_tokens and same_logits
                and layer["ok"] and (mla is None or mla["ok"])):
            raise AssertionError(
                f"lm-serve-moe {arch}: tokens ok {ok_tokens}, finite "
                f"{bool(finite)}, served twice: tokens {same_tokens}, "
                f"logits {same_logits}; MoE layer {layer}; MLA {mla}")
        del engine, params, last, state, logits_1
        free_card()
    counts, _ = lm_phase_end("lm-serve-moe", counters, t0)
    return counts


def phase_lm_serve_dense(arch: str, name: str) -> dict:
    """``arch`` at its published widths, bf16, every layer, through
    ``ServeEngine(max_batch=4).generate_batch`` (``attn_impl="pallas"``):
    4 requests of 512 prompt and 64 new tokens; tokens in the vocabulary,
    every step's logits finite, and ``lm_forward`` over the 575 tokens fed
    without a cache within 2^-5 of the largest logit of the last decode
    step's (``lm-serve-dec``'s tolerance).  Logs prefill ms and ms a
    token beside the step's bound (weights and cache over the HBM rate),
    then profiles 3 decode steps (``{name}-profile``: launches a step).
    A vision config serves its backbone on tokens, as the reference's
    engine does (no patch path)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models import transformer
    from repro_torch.models.lm import get_model
    from repro_torch.models.scan_util import tree_leaves
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    counters, t0 = lm_phase_start()
    params = get_model(cfg).init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, p_bytes = tree_size(params)
    engine = ServeEngine(cfg, params, max_batch=DENSE_BATCH)
    dev = engine.device
    finite, last, unwatch = watch_decode(engine)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT)
                           ).astype(np.int32)
    comp = engine.generate_batch([Request(p, max_new_tokens=DENSE_NEW)
                                  for p in prompts])
    tokens = np.stack([c.tokens for c in comp])
    steps = comp[0].steps - 1
    fed = np.concatenate([prompts, tokens[:, :steps]], axis=1)
    with torch.inference_mode():
        full = transformer.lm_forward(params, cfg,
                                      torch.from_numpy(fed).to(dev))[:, -1]
    got = last["logits"].float()
    scale = float(got.abs().max())
    err = float((full.float() - got).abs().max())
    tol = 2.0 ** -5 * scale
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(last["state"]["caches"]))
    bound_ms = (p_bytes + cache_bytes) / HBM_MS
    unwatch()
    profile_decode(engine, torch.from_numpy(tokens[:, -1:]).to(dev),
                   last["state"], f"{name}-profile")
    counts, peak = lm_phase_end(name, counters, t0)
    c = comp[0]
    ok_tokens = tokens.shape == (DENSE_BATCH, DENSE_NEW) and bool(
        ((tokens >= 0) & (tokens < cfg.vocab_size)).all())
    log(name, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        heads=f"{cfg.num_heads}/{cfg.num_kv_heads}",
        head_dim=cfg.head_dim_eff, d_ff=cfg.d_ff, gated=cfg.gated_ffn,
        act=cfg.ffn_act, bias=cfg.attn_bias, vocab=cfg.vocab_size,
        tied=cfg.tie_embeddings, params=n_params,
        param_gb=round(p_bytes / 1e9, 3), init_s=round(init_s, 2),
        requests=len(comp), prompt=DENSE_PROMPT, new_tokens=DENSE_NEW,
        decode_steps=steps, prefill_ms=round(c.prefill_s * 1e3, 2),
        ms_per_token=round(c.decode_s * 1e3 / steps, 3),
        step_bound_ms=round(bound_ms, 3),
        step_bound_weights_ms=round(p_bytes / HBM_MS, 3),
        cache_gb=round(cache_bytes / 1e9, 4),
        decode_tokens_per_s=round(len(comp) * steps / c.decode_s, 1),
        tokens_ok=ok_tokens, logits_finite=bool(finite),
        full_forward_max_abs_err=err, logits_max_abs=scale, tol=tol,
        k4=counts["flash_attention"], peak_mem_gb=round(peak / 1e9, 3))
    if not (ok_tokens and bool(finite) and err <= tol):
        raise AssertionError(
            f"{name}: tokens ok {ok_tokens}, finite {bool(finite)}, "
            f"full-forward err {err} > {tol}")
    del engine, params, last, full, got
    free_card()
    return counts


def train_steps(cfg, name: str, **fields) -> dict:
    """``cfg`` (bf16, remat) through 3 ``make_train_step`` steps at 2 ×
    1,024 (a vision config: its patch embeddings before the text), then
    one more with its loss-and-gradients and AdamW timed apart
    (``step_split``): losses finite, no gradient or parameter leaf
    non-finite.  ``fields`` join the phase's line.  Returns the launch
    counts and the phase's peak bytes."""
    import math
    import torch
    from repro_torch.launch.steps import add_accum_dim, make_train_step
    from repro_torch.models.common import make_generator
    from repro_torch.models.lm import get_model, make_batch
    from repro_torch.optim.adam import AdamConfig, AdamW
    counters, t0 = lm_phase_start()
    model = get_model(cfg)
    params = model.init(SEED)
    n_params, p_bytes = tree_size(params)
    opt = AdamW(AdamConfig(lr=3e-4, clip_norm=1.0))
    state = opt.init(params)
    s_bytes = p_bytes + tree_size(state["m"])[1] + tree_size(state["v"])[1]
    step = make_train_step(model, opt)
    batches = [add_accum_dim(cfg, make_batch(
        cfg, STEP_TRAIN_SEQ, STEP_TRAIN_BATCH, make_generator(SEED + i)))
        for i in range(STEP_TRAIN_STEPS)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, times = [], []
    for batch in batches:
        t1 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        times.append(time.perf_counter() - t1)
    split, peak = step_split(model, opt, params, state, batches[0])
    bad_params = nonfinite_leaves(params)
    counts, peak = lm_phase_end(name, counters, t0, peak)
    shapes = {k: list(v.shape[1:]) for k, v in batches[0].items()}
    step_s = float(np.mean(times[1:]))
    log(name, arch=cfg.name, **fields, d_model=cfg.d_model,
        heads=f"{cfg.num_heads}/{cfg.num_kv_heads}", d_ff=cfg.d_ff,
        gated=cfg.gated_ffn, vocab=cfg.vocab_size, tied=cfg.tie_embeddings,
        dtype=cfg.dtype, remat=cfg.remat, params=n_params,
        param_gb=round(p_bytes / 1e9, 3), state_gb=round(s_bytes / 1e9, 3),
        init_s=round(init_s, 2), steps=STEP_TRAIN_STEPS, batch=shapes,
        losses=[round(x, 5) for x in losses],
        ln_vocab=round(math.log(cfg.vocab_size), 4),
        step_ms=[round(t * 1e3, 1) for t in times],
        ms_per_step=round(step_s * 1e3, 2),
        tokens_per_s=round(STEP_TRAIN_BATCH * STEP_TRAIN_SEQ / step_s, 1),
        split_step_ms=split, nonfinite_param_leaves=bad_params,
        k4=counts["flash_attention"], peak_mem_gb=round(peak / 1e9, 3))
    if not all(math.isfinite(x) for x in losses + [split["loss"]]) \
            or split["nonfinite_grad_leaves"] or bad_params:
        raise AssertionError(f"{name}: losses {losses}, {split['loss']}; "
                             f"{split['nonfinite_grad_leaves']} non-finite "
                             f"gradient leaves, {bad_params} non-finite "
                             f"parameter leaves")
    if peak >= CARD_BYTES:
        raise AssertionError(f"{name}: peak memory {peak / 1e9} GB")
    del params, state, batches, model, step
    free_card()
    return {"counts": counts, "peak": peak}


def phase_lm_train_vlm() -> dict:
    """``internvl2-1b`` trained at all 24 layers (:func:`train_steps`):
    the vision prefix's first run on the card."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(VLM_ARCH), attn_impl="pallas",
                              remat=True)
    return train_steps(cfg, "lm-train-vlm",
                       layers=cfg.num_layers)["counts"]


def phase_lm_train_sc() -> dict:
    """``starcoder2-7b`` at its published widths, trained at
    ``SC_TRAIN_LAYERS`` of its 32 layers (:func:`train_steps`): all 32
    need 88.8 GB of bf16 parameters and gradients and f32 moments.  The
    peak must stay under ``SC_TRAIN_PEAK``; logs it beside the peak that
    one layer more would reach (this one's plus that layer's parameters,
    gradients and moments)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import get_model
    full = dataclasses.replace(get_config(SC_ARCH), attn_impl="pallas",
                               remat=True)

    def params_at(n: int) -> int:
        return tree_size(get_model(dataclasses.replace(
            full, num_layers=n)).init(SEED, device="meta"))[0]

    layer = params_at(2) - params_at(1)            # 217.1 M
    state = 12 * params_at(full.num_layers)
    out = train_steps(dataclasses.replace(full, num_layers=SC_TRAIN_LAYERS),
                      "lm-train-sc",
                      layers=f"{SC_TRAIN_LAYERS} of {full.num_layers}")
    peak = out["peak"]
    log("lm-train-sc-depth", layers=SC_TRAIN_LAYERS, of=full.num_layers,
        reason=f"the most layers whose peak stays under "
               f"{SC_TRAIN_PEAK / 1e9:.0f} GB",
        all_layers_state_gb=round(state / 1e9, 3), layer_params=layer,
        layer_state_gb=round(12 * layer / 1e9, 3),
        peak_gb=round(peak / 1e9, 3),
        one_more_layer_peak_gb=round((peak + 12 * layer) / 1e9, 3),
        limit_gb=SC_TRAIN_PEAK / 1e9)
    if peak > SC_TRAIN_PEAK:
        raise AssertionError(f"lm-train-sc: peak {peak / 1e9} GB at "
                             f"{SC_TRAIN_LAYERS} layers, over "
                             f"{SC_TRAIN_PEAK / 1e9} GB")
    return out["counts"]


def prefill_vs_parallel_f32(cfg, params, toks, fwd) -> tuple[float, float]:
    """The served weights cast to f32 (TF32 off): the last logits of
    ``decode_step`` over the prompt (the recurrences) against ``fwd``, the
    parallel forward, at the last position; (max abs error, largest
    logit).  In bf16 the two forms part by up to a third of the largest
    logit in the reference too (``PERF.md`` §6, PR 26), so the check
    runs in f32."""
    import torch
    from repro_torch.models.lm import get_model
    from repro_torch.models.scan_util import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = get_model(cfg32)
    p32 = tree_map(lambda t: t.float(), params)
    b, s = toks.shape
    state = (model.decode_init(b, device=toks.device) if cfg.xlstm
             else model.decode_init(b, s, device=toks.device))
    with torch.inference_mode():
        got, _ = model.decode_step(p32, toks, state)
        want = fwd(p32, cfg32, toks)[:, -1]
    return (float((got - want).abs().max()), float(want.abs().max()))


def phase_lm_train_parity() -> None:
    """Reduced seamless, gemma, danube, xlstm, zamba2, deepseek, arctic,
    qwen2, starcoder2 and internvl2 (f32) with the same parameters and batch on the card and on the CPU: the loss and
    every gradient allclose (rtol 1e-4, atol 1e-5: cuBLAS and the CPU order
    the f32 sums differently; TF32 off; xlstm's atol 1e-4,
    ``TRAIN_PARITY_TOL_BY_ARCH``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.common import make_generator
    from repro_torch.models.lm import get_model, make_batch
    from repro_torch.models.scan_util import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    counters, t0 = lm_phase_start()
    for arch in TRAIN_PARITY_ARCHS:
        tol = TRAIN_PARITY_TOL_BY_ARCH.get(arch, TRAIN_PARITY_TOL)
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  attn_impl="pallas", remat=True)
        model = get_model(cfg)
        params = model.init(SEED, device="cpu")
        batch = make_batch(cfg, 32, 2, make_generator(SEED, "cpu"))
        (lc, gc_), (lg, gg) = (value_and_grad(
            model.loss, tree_map(lambda t: t.to(dev), params),
            {k: v.to(dev) for k, v in batch.items()})
            for dev in ("cpu", "cuda"))
        pairs = list(zip(tree_leaves(gc_), tree_leaves(gg)))
        err = max(float((a - b.cpu()).abs().max()) for a, b in pairs)
        ok = bool(torch.allclose(lg.cpu(), lc, **tol)) and all(
            torch.allclose(b.cpu(), a, **tol) for a, b in pairs)
        log("lm-train-parity", arch=cfg.name + " (reduced)", dtype=cfg.dtype,
            loss_cpu=float(lc), loss_card=float(lg), grads=len(pairs),
            grad_max_abs_err=err, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f"lm-train-parity {arch}: card vs CPU "
                                 f"loss {float(lg)} / {float(lc)}, grad err "
                                 f"{err}")
    lm_phase_end("lm-train-parity", counters, t0)
    free_card()


def k4_work(q, k, kw) -> tuple[int, int]:
    """Bytes and flops K4 needs: q, the keys and values that some row sees,
    the output, once each; 4 * Dh flops per visible (row, key) pair."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    pos = np.arange(sq, dtype=np.int64) + kw["q_offset"]
    hi = np.full(sq, min(kw["kv_len"], sk), np.int64)
    if kw["causal"]:
        hi = np.minimum(hi, pos + 1)
    lo = np.zeros(sq, np.int64)
    if kw["window"] is not None:
        lo = np.maximum(lo, pos - kw["window"] + 1)
    seen = np.maximum(hi - lo, 0)
    keys = max(int(hi.max() - lo[seen > 0].min()), 0) if seen.any() else 0
    elt = q.element_size()
    n_bytes = 2 * q.numel() * elt + 2 * b * hkv * keys * dh * elt
    return n_bytes, 4 * dh * b * hq * int(seen.sum())


HOLD_CYCLES = 2_000_000   # about 1 ms of a spin kernel at the H100's clock


def turns_ms(fns: dict, flush) -> dict:
    """Median ms of each function over REPS rounds in which they take turns,
    each launch timed with CUDA events after ``flush`` was overwritten
    (cold L2).  A spin kernel (``torch.cuda._sleep``) then holds the stream
    while the host records the start event and issues the function, so
    that the events time the device's work and not the host's set-up (a
    call with two launches and Python around them would otherwise show its
    host time whenever the host is slower than the flush)."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in fns]
    for _ in range(REPS):
        for (name, fn), (start, end) in zip(fns.items(), events):
            flush.zero_()
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: float(np.median(t)) for name, t in times.items()}


def device_us(fns: dict, flush, reps: int = 10) -> dict:
    """Device time per call of each kernel each function launches, in us,
    under ``torch.profiler``, cold L2 as in :func:`turns_ms` (the flush and
    the spin kernel left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in fns.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                torch.cuda._sleep(HOLD_CYCLES)
                fn()
            torch.cuda.synchronize()
        out[name] = [
            (e.key[:48], round(e.self_device_time_total / reps, 2))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not any(x in e.key for x in ("Fill", "spin", "sleep"))]
    return out


def phase_k4_times(errs, counts) -> list:
    """K4 at (a)-(c) in bf16 (the model's type), in one call and in turns:
    the route ``flash_attention_cuda`` takes, the CUDA-core kernel (route
    (iii) by name, ``prev_ms``), the plain version and SDPA (timed
    only; the port never calls it); and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_attention_simt,
                                                     k4_route)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    dtype = torch.bfloat16
    rows = []
    for name in K4_TIMED:
        q, k, v, kw = k4_operands(name, dtype)
        n_bytes, n_flops = k4_work(q, k, kw)
        t_bound, by = bound_ms(n_bytes, n_flops, BF16_FLOPS)
        sq, sk = q.shape[2], k.shape[2]
        mask = None
        if kw["causal"] and (kw["window"] is not None or sq != sk):
            i = torch.arange(sq, device="cuda")[:, None] + kw["q_offset"]
            j = torch.arange(sk, device="cuda")[None, :]
            mask = j <= i
            if kw["window"] is not None:
                mask &= j > i - kw["window"]
        causal = kw["causal"] and mask is None

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True)

        lib = sdpa()
        prev = flash_attention_simt(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        lib_err = float((lib.float() - want.float()).abs().max())
        prev_err = float((prev.float() - want.float()).abs().max())
        t = turns_ms({
            "ms": lambda: flash_attention_cuda(q, k, v, **kw),
            "prev_ms": lambda: flash_attention_simt(q, k, v, **kw),
            "plain_ms": lambda: flash_attention_plain(q, k, v, **kw),
            "library_ms": sdpa}, flush)
        if name == K4_TIMED[0]:
            log("k4-device", case=name, **device_us({
                "k4": lambda: flash_attention_cuda(q, k, v, **kw),
                "sdpa": sdpa}, flush))
        rows.append({
            "name": f"flash_attention[{name},bf16]", "route": "cuda",
            "k4_route": k4_route(q.shape[1] // k.shape[1] * sq, dtype),
            "source": "src/repro_torch/csrc/" + K4_SOURCES[k4_route(
                q.shape[1] // k.shape[1] * sq, dtype)],
            "replaces": "src/repro/kernels/flash_attention.py:90",
            **launch_fields(counts, "flash_attention"),
            "launches_by_route": counts.get("lm_serve", {}).get(
                "flash_attention_routes"),
            "max_abs_err": errs[(name, dtype)], **t,
            "prev": "src/repro_torch/csrc/flash_attention.cu",
            "prev_max_abs_err": prev_err,
            "bound_ms": t_bound, "bound_by": by,
            "library": "F.scaled_dot_product_attention(enable_gqa=True"
                       + (", end-aligned attn_mask)" if mask is not None
                          else f", is_causal={causal})"),
            "library_max_abs_err": lib_err, "bytes": n_bytes,
            "flops": n_flops, "q": list(q.shape), "k": list(k.shape)})
        del q, k, v, want, lib, prev, mask
        torch.cuda.empty_cache()
    for r in rows:
        log("time", **{k: r[k] for k in ("name", "k4_route", "ms", "prev_ms",
                                         "bound_ms", "bound_by", "plain_ms",
                                         "library_ms", "bytes", "flops")})
    return rows


# K1's, K2's and K3's device kernels by name: the tile kernels
TILE_KERNEL_NAMES = ("cache_lookup_agg_kernel", "gather_agg_kernel",
                     "gns_sample_agg_kernel")
TILE_MAX_REGS = 64


def kernel_label(mangled: str, names: tuple) -> str:
    """``flash_tc_kernel<128,64>`` or ``gather_agg_kernel<f32,vec>`` from a
    mangled kernel name that holds one of ``names``."""
    import re
    name = next(n for n in names if f"{len(n)}{n}" in mangled)
    args = mangled.split(f"{len(name)}{name}", 1)[1]
    args = args[1:args.index("EEv")] if args.startswith("I") else ""
    parts = [m[0] or ("bf16" if m[1] else "f32" if m[2] else
                      "vec" if m[3] == "1" else "scalar")
             for m in re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)|Lb([01])E",
                                 args)]
    return f"{name}<{','.join(parts)}>"


def phase_kbuild() -> None:
    """The kernels of K1-K4 in the built library, read by ``cuobjdump``:
    registers, stack and local memory (spills) per kernel, and for K4 the
    tensor-core instructions (HMMA) in each one's SASS.  The 12 tile
    kernels of K1-K3 must use at most ``TILE_MAX_REGS`` registers and not
    spill (stack and local 0); every tensor-core route kernel of K4 must
    hold HMMA."""
    import re
    import shutil
    from repro_torch.kernels._ext import load_kernels
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = load_kernels().__file__
    names = K4_KERNEL_NAMES + TILE_KERNEL_NAMES

    def dump(flag: str) -> str:
        return subprocess.run([exe, flag, lib], capture_output=True,
                              text=True, timeout=300, check=True).stdout

    def named(fn: str, group: tuple) -> bool:     # as mangled: 17gather...
        return any(f"{len(n)}{n}" in fn for n in group)

    usage, fn = {}, None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            fn = m.group(1) if named(m.group(1), names) else None
        elif fn and "REG:" in line:
            usage[fn] = {k.lower(): int(v) for k, v in re.findall(
                r"(REG|STACK|LOCAL):(\d+)", line)}
    hmma, fn = {}, None
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if m.group(1) in usage else None
            if fn:
                hmma[fn] = 0
        elif fn and re.search(r"\bHMMA\b", line):
            hmma[fn] += 1
    k4 = sorted((f for f in usage if named(f, K4_KERNEL_NAMES)),
                key=lambda f: kernel_label(f, K4_KERNEL_NAMES))
    for f in k4:
        log("k4-build", kernel=kernel_label(f, K4_KERNEL_NAMES), **usage[f],
            hmma=hmma.get(f, 0))
    tiles = sorted((f for f in usage if named(f, TILE_KERNEL_NAMES)),
                   key=lambda f: kernel_label(f, TILE_KERNEL_NAMES))
    for f in tiles:
        log("kbuild", kernel=kernel_label(f, TILE_KERNEL_NAMES), **usage[f])
    tc = [f for f in k4 if "flash_tc_kernel" in f]
    if not tc or not all(hmma.get(f) for f in tc):
        raise AssertionError("tensor-core route without HMMA: " + str(
            [(kernel_label(f, K4_KERNEL_NAMES), hmma.get(f)) for f in tc]))
    # 3 kernels x 2 table types x 2 access paths
    over = {kernel_label(f, TILE_KERNEL_NAMES): usage[f] for f in tiles
            if usage[f].get("stack") or usage[f].get("local")
            or usage[f]["reg"] > TILE_MAX_REGS}
    if len(tiles) != 12 or over:
        raise AssertionError(f"tile kernels: {len(tiles)} of 12 found; "
                             f"spilling or over {TILE_MAX_REGS} registers: "
                             f"{over}")


# ---------------------------------------------------------------------------
# mesh: the sharded cache and DP > 1 over torch.distributed ranks
# ---------------------------------------------------------------------------

MESH_DEADLINE_S = 300.0        # each spawn of ranks must end within this
MESH_BACKEND = "gloo"          # the ranks share one card: NCCL refuses that
MESH_TOL = dict(rtol=1e-5, atol=1e-5)


def counted_run(engine, epochs: int = 0, max_batches=None,
                infer_n: int = 0) -> dict:
    """``fit`` for ``epochs`` (none: 0), then ``infer`` of the first
    ``infer_n`` validation ids (none: 0), with every kernel counter zeroed
    just before and read just after; each step timed with CUDA events."""
    import torch
    counters, paths = kernel_counters()
    step_ms, step_losses, run_batch = [], [], engine.run_batch

    def timed_step(mb):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run_batch(mb)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        step_losses.append(out[0])
        return out

    engine.run_batch = timed_step
    for c in (*counters.values(),
              *(c for v in paths.values() for c in v.values())):
        c.reset()
    try:
        if epochs:
            engine.fit(epochs=epochs, max_batches=max_batches,
                       prefetch=False)
        logits = (engine.infer(engine.ds.val_idx[:infer_n]) if infer_n
                  else None)
    finally:
        del engine.run_batch
    return {"losses": step_losses, "step_ms": step_ms,
            "launches": {k: c.value for k, c in counters.items()},
            "paths": {k: {p: c.value for p, c in v.items()}
                      for k, v in paths.items()},
            "upload_bytes": engine.meter.bytes_cache_upload,
            "uploads": engine.meter.uploads, "logits": logits,
            "params": [t.detach().cpu().numpy()
                       for layer in engine.params["layers"]
                       for t in layer.values()]}


def k1_operands(gen, groups: int, b: int, k: int, s0: int, c: int, d: int,
                shards: int) -> list:
    """Integer-valued K1 operands of ``groups`` groups on the card, made
    from ``gen``: a [c, d] table, and per group streamed rows, random
    slots, slots whose hits all lie on the last shard (the static path's
    contract), slots on the group's home shard (the dynamic path's), lanes
    and weights."""
    import torch
    dev = "cuda"
    rps = c // shards

    def ints(lo, hi, shape, dtype=torch.float32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    def slots_on(lo, hi):
        hit = torch.rand(s0, generator=gen, device=dev) < 0.5
        return torch.where(hit, ints(lo, hi, (s0,), torch.int32),
                           -1).to(torch.int32)

    table = ints(-64, 65, (c, d))
    out = []
    for g in range(groups):
        home = g % shards
        out.append({
            "table": table, "streamed": ints(-64, 65, (s0, d)),
            "slots": slots_on(0, c),
            "slots_ls": slots_on((shards - 1) * rps, shards * rps),
            "slots_home": slots_on(home * rps, (home + 1) * rps),
            "home": home, "idx": ints(0, s0, (b, k), torch.int32),
            "w": ints(-4, 5, (b, k))})
    return out


def mesh_k1_checks(mesh, shape: str, ops_in: dict) -> dict:
    """The sharded K1's three forward paths on this rank's group's operands
    against single-rank K1 (the whole table) on the same: bitwise.  Under
    the static path only its owner launches K1."""
    import torch
    from repro_torch.kernels import cache_lookup as k1
    from repro_torch.kernels import ops
    m, n = mesh.index("model"), mesh.shape["model"]
    rps = ops_in["table"].shape[0] // n
    local = ops_in["table"][m * rps:(m + 1) * rps].contiguous()
    args = (ops_in["streamed"], ops_in["idx"], ops_in["w"])
    homes = np.full(mesh.shape["data"], -1, np.int32)
    homes[mesh.index("data")] = ops_in["home"]
    out = {}
    for path, slots, kw in (
            ("psum", "slots", {}),
            ("static", "slots_ls", {"local_shard": n - 1}),
            ("dynamic", "slots_home", {"local_shards": homes})):
        st, sl = args[0], ops_in[slots]
        want = k1.cache_lookup_agg_cuda(ops_in["table"], st, sl, *args[1:])
        n0 = k1.launches.value
        got = ops.cache_lookup_agg(local, st, sl, *args[1:], mesh=mesh,
                                   shard_axis="model", **kw)
        torch.cuda.synchronize()
        launched = k1.launches.value - n0
        out[path] = {"equal": bool(torch.equal(got, want)),
                     "max_abs_err": float((got - want).abs().max()),
                     "k1_launches": launched}
        if not out[path]["equal"]:
            raise AssertionError(f"mesh K1 {shape} {path}: rank "
                                 f"{mesh.rank} differs from one rank by "
                                 f"{out[path]['max_abs_err']}")
        owner = {"static": n - 1, "dynamic": ops_in["home"]}.get(path, m)
        expect = 1 if m == owner else 0
        if launched != expect:
            raise AssertionError(f"mesh K1 {shape} {path}: rank "
                                 f"{mesh.rank} launched {launched}, "
                                 f"expected {expect}")
    return out


def k3_operands(gen, b: int, k: int, c: int, d: int, exact: bool) -> tuple:
    """K3's operands at the training (A) shape on the card: a CSR over c
    table rows, dst rows (0.2% cached, as sampled), fallback lanes, a key;
    ``exact`` caps each row at k neighbours with hit probability and degree
    1 and integer fallback weights, so every weight and sum is exact."""
    import torch
    from repro_torch.sampling.adjacency import DeviceCacheAdj
    dev = "cuda"
    n_c = torch.randint(0, k + 1 if exact else 3 * k, (c,), generator=gen,
                        device=dev)
    indptr = torch.zeros(c + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(n_c, 0)
    indices = torch.randint(0, c, (max(int(indptr[-1]), 1),), generator=gen,
                            device=dev, dtype=torch.int32)
    if exact:
        deg = torch.ones(c, device=dev)
        hitp = torch.ones(c, device=dev)
    else:
        deg = torch.randint(1, 60, (c,), generator=gen, device=dev).float()
        hitp = torch.rand(c, generator=gen, device=dev).clamp(min=0.01)
    dst = torch.where(torch.rand(b, generator=gen, device=dev) < 0.002,
                      torch.randint(0, c, (b,), generator=gen, device=dev),
                      -1).to(torch.int32)
    fb_rows = torch.where(
        (dst < 0)[:, None],
        torch.randint(-1, c, (b, k), generator=gen, device=dev),
        -1).to(torch.int32)
    fb_w = torch.rand((b, k), generator=gen, device=dev)
    if exact:
        fb_w = torch.ceil(fb_w * 3)
    fb_w = torch.where(fb_rows >= 0, fb_w, 0.0)
    table = torch.randint(-64, 65, (c, d), generator=gen, device=dev,
                          dtype=torch.int32).float()
    return (DeviceCacheAdj(indptr, indices, deg, hitp), table, dst,
            fb_rows.contiguous(), fb_w.contiguous(),
            np.array([[11, 13]], np.uint32))


def mesh_k3_checks(mesh, gen) -> dict:
    """K3 over each shard's row range at the training (A) shape: each
    partial bitwise its plain version; on exact operands the partials sum
    to the full-range call bit for bit, through the mesh entry point's
    all_reduce too."""
    import torch
    from repro_torch.sampling import kernels as k3
    m, n = mesh.index("model"), mesh.shape["model"]
    out = {}
    for exact in (False, True):
        adj, table, dst, fb_rows, fb_w, key = k3_operands(
            gen, 176_000, 5, 306, 100, exact)
        rps = table.shape[0] // n
        rng_kw = {"row_lo": m * rps, "row_count": rps}
        local = table[m * rps:(m + 1) * rps].contiguous()
        part = k3.gns_sample_agg_cuda(adj, local, dst, fb_rows, fb_w, key,
                                      **rng_kw)
        plain = k3.gns_sample_agg_plain(adj, local, dst, fb_rows, fb_w, key,
                                        **rng_kw)
        full = k3.gns_sample_agg_cuda(adj, table, dst, fb_rows, fb_w, key)
        summed = k3.gns_sample_agg(adj, local, dst, fb_rows, fb_w, key,
                                   mesh=mesh, shard_axis="model")
        torch.cuda.synchronize()
        name = "exact" if exact else "rand"
        out[name] = {"partial_equal_plain": bool(torch.equal(part, plain)),
                     "sum_max_abs_err": float((summed - full).abs().max()),
                     "sum_equal_full": bool(torch.equal(summed, full))}
        if not out[name]["partial_equal_plain"] or (
                exact and not out[name]["sum_equal_full"]):
            raise AssertionError(f"mesh K3 {name}: rank {mesh.rank}: "
                                 f"{out[name]}")
    return out


def allreduce_ms(mesh, reps: int = 5) -> float:
    """Median ms of one all_reduce of layer 0's [176,000, 100] f32 output
    over the cache group (gloo stages a CUDA tensor through the host)."""
    import torch
    import torch.distributed as dist
    x = torch.ones((176_000, 100), device="cuda")
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=mesh.group("model"))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def mesh_rank(world, device, ds, which: str) -> dict:
    """One rank of the mesh phase (``launch.mesh.run_ranks`` spawns it).
    ``which="two"``: a 2-rank world runs the cache in 2 shards (mesh (1,
    2): the kernel checks, (A) and (B) trained, the serving config's
    ``infer``), then DP over 2 groups (mesh (2, 1), (B) trained);
    ``"four"``: the (2, 2) mesh (K1's checks per group, (B) trained)."""
    import torch
    from repro_torch.gns import GNSEngine
    from repro_torch.kernels._ext import load_kernels
    from repro_torch.launch.mesh import make_host_mesh
    load_kernels()                     # built by the parent: a load
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"rank": world.rank, "checks": {}, "runs": {}}
    meshes = ([("model2", make_host_mesh(1, 2)),
               ("data2", make_host_mesh(2, 1))] if which == "two"
              else [("2x2", world)])
    for name, mesh in meshes:
        shards, groups = mesh.shape["model"], mesh.shape["data"]
        if shards > 1:
            for shape, b, s0 in (("train(B)", 176_000, 1_056_000),
                                 ("b=512", 90_112, 540_672)):
                ops_in = k1_operands(gen, groups, b, 5, s0, 306, 100, shards)
                out["checks"][f"{name}/k1/{shape}"] = mesh_k1_checks(
                    mesh, shape, ops_in[mesh.index("data")])
                del ops_in
            out["allreduce_ms"] = allreduce_ms(mesh)
        if name == "model2":
            out["checks"][f"{name}/k3"] = mesh_k3_checks(mesh, gen)
            for run, cfg, kw in mesh_runs():
                out["runs"][f"{name}/{run}"] = counted_run(
                    GNSEngine(cfg, dataset=ds, mesh=mesh), **kw)
        else:
            out["runs"][f"{name}/B"] = counted_run(
                GNSEngine(train_config("fused"), dataset=ds, mesh=mesh), 2)
    return out


MESH_INFER = 600               # ids infer()'d on the mesh and on one rank


def two_shards(cfg):
    """``cfg`` with its cache padded to 2 shards (306 rows, not 305): the
    layout of the mesh's 2 shards, so one rank draws the same members."""
    return dataclasses.replace(cfg, cache=dataclasses.replace(cfg.cache,
                                                              shards=2))


def mesh_runs() -> list:
    """The runs held against one rank: (A) 3 steps, (B) 2 steps, and
    ``infer`` of the serving config (K1 per shard, K2 replicated)."""
    return [("A", two_shards(train_config("device")),
             {"epochs": 1, "max_batches": 3}),
            ("B", two_shards(train_config("fused")),
             {"epochs": 1, "max_batches": 2}),
            ("infer", two_shards(serve_config()), {"infer_n": MESH_INFER})]


def phase_mesh(ds) -> dict:
    """The sharded cache and DP > 1 on the card: 2 ranks, then 4, all on
    ``cuda:0`` over gloo (module docstring, phase 11).  Returns the K1, K2
    and K3 launches of the ranks' main-path runs, summed over the ranks."""
    from repro_torch.gns import GNSEngine
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    single = {run: counted_run(GNSEngine(cfg, dataset=ds), **kw)
              for run, cfg, kw in mesh_runs()}
    for run, res in single.items():
        log("mesh-single", run=run, losses=res["losses"],
            step_ms=res["step_ms"], launches=res["launches"])
    ranks = []
    for which, data, model in (("two", 2, 1), ("four", 2, 2)):
        devices = ["cuda:0"] * (data * model)
        log("mesh-launch", world=which, ranks=len(devices), devices=devices,
            backend=MESH_BACKEND, deadline_s=MESH_DEADLINE_S)
        t1 = time.perf_counter()
        ranks += run_ranks("chip_smoke:mesh_rank", data=data, model=model,
                           devices=devices, backend=MESH_BACKEND,
                           args=(ds, which), timeout_s=MESH_DEADLINE_S)
        log("mesh-world", world=which,
            seconds=round(time.perf_counter() - t1, 1))
    counts = {"cache_lookup_agg": 0, "gather_agg": 0, "gns_sample_agg": 0}
    for r in ranks:
        for check, res in r["checks"].items():
            log("mesh-check", rank=r["rank"], check=check, **res)
        for run, res in r["runs"].items():
            for k, v in res["launches"].items():
                counts[k] += v
            one = single.get(run.removeprefix("model2/"))
            log("mesh", rank=r["rank"], run=run, losses=res["losses"],
                step_ms=res["step_ms"],
                one_rank_step_ms=one["step_ms"] if one else None,
                launches=res["launches"], paths=res["paths"],
                bytes_cache_upload=res["upload_bytes"],
                uploads=res["uploads"],
                allreduce_176000x100_ms=r.get("allreduce_ms"))
            if one is not None:
                ok = np.allclose(res["losses"], one["losses"], **MESH_TOL)
                if res["logits"] is not None:
                    err = float(np.abs(res["logits"] - one["logits"]).max())
                    log("mesh-infer", rank=r["rank"], ids=MESH_INFER,
                        max_abs_err=err)
                    ok = ok and np.allclose(res["logits"], one["logits"],
                                            rtol=1e-4, atol=1e-4)
                if not ok:
                    raise AssertionError(
                        f"mesh {run} rank {r['rank']}: losses "
                        f"{res['losses']} vs one rank's {one['losses']}")
            for k, kernel in (("k1", "cache_lookup_agg"),
                              ("k2", "gather_agg"),
                              ("k3", "gns_sample_agg")):
                if res["paths"][k]["scalar"]:
                    raise AssertionError(f"mesh {run}: {kernel} left the "
                                         f"vector path: {res['paths']}")
    # every rank of a run ends with the same parameters, bit for bit
    for run in {run for r in ranks for run in r["runs"]}:
        params = [r["runs"][run]["params"] for r in ranks if run in r["runs"]]
        for p in params[1:]:
            if not all(np.array_equal(a, b) for a, b in zip(p, params[0])):
                raise AssertionError(f"mesh {run}: ranks' parameters differ")
    for kernel in counts:
        if counts[kernel] < 1:
            raise AssertionError(f"mesh: {kernel} was never launched")
    log("mesh-done", launches=counts,
        seconds=round(time.perf_counter() - t0, 1))
    return counts


# ---------------------------------------------------------------------------
# mesh-serve: serving, the fabric, ingest and checkpoints on a mesh of ranks
# ---------------------------------------------------------------------------

MESH_SERVE_ONE_AT_A_TIME = 24  # requests held against one rank's server


def one_at_a_time_requests(num_nodes: int) -> list:
    """The requests sent one at a time to the mesh's server and to one
    rank's: 1-48 ids each, so they ride buckets 32 and 128."""
    rng = np.random.default_rng(SEED + 3)
    return [rng.choice(num_nodes, int(n), replace=False)
            for n in rng.integers(1, 49, MESH_SERVE_ONE_AT_A_TIME)]


def serve_waves(rng) -> list:
    """Request sizes of the serve phase's 3 waves (64 requests; buckets 32,
    128 and 512)."""
    waves = [[int(rng.integers(1, 17))],
             [int(rng.integers(5, 17)) for _ in range(7)],
             [int(rng.integers(1, 17)) for _ in range(56)]]
    waves[1][:3] = [16, 16, 16]       # >= 48 ids: never fits bucket 32
    return waves


def served_one_at_a_time(server, reqs, leader: bool) -> list:
    """(bucket, version, logits) of each request, sent one at a time."""
    if not leader:
        return []
    out = []
    for ids in reqs:
        r = server.submit(ids).result(timeout=FABRIC_WAIT_S)
        if r.status != "ok":
            raise AssertionError(f"mesh-serve: request status {r.status}")
        out.append((r.bucket, r.cache_version, r.logits))
    return out


def record_logits(engine) -> list:
    """Log (pinned version, logits) of every batch this rank computes."""
    log_ = []
    compute = engine.infer_compute

    def recorded(mb, meter=None, mesh=None):
        out = compute(mb, meter=meter, mesh=mesh)
        log_.append((mb.cache_version, out))
        return out

    engine.infer_compute = recorded
    return log_


def mesh_serve_rank(mesh, device, ds, which: str) -> dict:
    """One rank of the mesh-serve phase (``run_ranks`` spawns it).
    ``"two"`` ((1, 2)): (a) the served config on 2 shards through
    ``GNSServer`` (24 requests one at a time, then 64 in 3 waves); (c)
    ``stream_replay`` through a 2-worker fabric while the leader ingests 4
    event batches, then a fresh engine that merges the same events and
    ``infer``s; (d) ``save`` with 8 staged deltas.  ``"four"`` ((2, 2)):
    (b) the fabric phase's tenants, waves and kill."""
    import torch
    from repro_torch.data import temporal_event_stream
    from repro_torch.gns import FabricConfig, GNSEngine, TenantConfig
    from repro_torch.kernels._ext import load_kernels
    from repro_torch.kernels.ops import psum_clock
    load_kernels()                     # built by the parent: a load
    out = {"rank": mesh.rank, "leader": mesh.leader, "runs": {}}
    leader = mesh.leader

    def counted(name, fn):
        reset_k12()
        calls0, ms0 = psum_clock.read()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        calls, ms = psum_clock.read()
        k12 = read_k12(engine, f"mesh-serve {name} rank {mesh.rank}")
        res.update(k12=k12, wall_s=time.perf_counter() - t0,
                   psum_ms=ms - ms0, psum_calls=calls - calls0)
        out["runs"][name] = res
        return res

    if which == "four":                              # (b)
        engine = GNSEngine(two_shards(serve_config()), dataset=ds,
                           mesh=mesh)
        rng = np.random.default_rng(SEED + 4)
        n_cls, num_nodes = engine.mcfg.num_classes, engine.ds.graph.num_nodes

        def fabric_run():
            fab = engine.serve_fabric(FabricConfig(workers=2, tenants=(
                TenantConfig("mobile", weight=2.0, max_queue=16),
                TenantConfig("batch", weight=1.0, max_queue=64)),
                stall_timeout_ms=10_000.0))
            res = {}
            with fab:
                if leader:
                    results = []
                    for _ in range(4):
                        futs = []
                        for i in range(24):
                            tenant = "mobile" if i % 2 == 0 else "batch"
                            n = int(rng.integers(1, 9) if tenant == "mobile"
                                    else rng.integers(4, 17))
                            futs.append((n, fab.submit(
                                rng.integers(0, num_nodes, n),
                                tenant=tenant)))
                        results += check_results(futs, n_cls, "mesh-serve")
                    w0 = fab.workers[0]
                    w0.kill()
                    futs = [(8, fab.submit(rng.integers(0, num_nodes, 8),
                                           tenant="mobile", worker=0))]
                    futs += [(n, fab.submit(rng.integers(0, num_nodes, n),
                                            tenant=("mobile", "batch")[i % 2]))
                             for i, n in enumerate(rng.integers(1, 17, 11))]
                    wait_for(lambda: not w0.alive(), "worker 0 ends")
                    results += check_results(futs, n_cls, "mesh-serve")
                    wait_for(lambda: fab.healthy() == [1],
                             "worker 0 leaves rotation")
                    res["requests"] = len(results)
            res["alive"] = [w.alive() for w in fab.workers]
            res["batches"] = fab.meter.batch_count()
            if leader:
                snap = check_fabric(fab, "mesh-serve (b)")
                res["snapshot"] = {k: snap[k] for k in (
                    "total_p50_ms", "total_p99_ms", "errors", "batches")}
                res["routing"] = snap["routing"]
            return res

        counted("b", fabric_run)
        return out

    # (a) the served config on 2 shards
    engine = GNSEngine(two_shards(serve_config()), dataset=ds, mesh=mesh)
    reqs = one_at_a_time_requests(engine.ds.graph.num_nodes)
    rng = np.random.default_rng(SEED + 5)
    n_cls, num_nodes = engine.mcfg.num_classes, engine.ds.graph.num_nodes
    batches = record_logits(engine)

    def serve_run():
        res = {}
        with engine.serve() as server:
            res["one_at_a_time"] = served_one_at_a_time(server, reqs, leader)
            if leader:
                res["one_snapshot"] = server.meter.snapshot()
                results = []
                for sizes in serve_waves(rng):
                    futs = [(n, server.submit(rng.integers(0, num_nodes, n)))
                            for n in sizes]
                    results += check_results(futs, n_cls, "mesh-serve")
                res["wave_buckets"] = sorted({r.bucket for r in results})
                res["wave_requests"] = len(results)
        res["batches"] = server.meter.batch_count()
        if leader:
            snap = server.meter.snapshot()
            res["snapshot"] = {k: snap[k] for k in (
                "total_p50_ms", "total_p99_ms", "errors", "served",
                "batches")}
        res["versions"] = [v for v, _ in batches]
        res["logits"] = [x for _, x in batches[:MESH_SERVE_ONE_AT_A_TIME]]
        return res

    counted("a", serve_run)
    del engine, batches

    # (c) stream_replay through a fabric while the leader ingests
    engine = GNSEngine(stream_config(), mesh=mesh)
    v0 = engine.ds.graph.num_nodes
    n_cls = engine.mcfg.num_classes
    val = engine.ds.val_idx.astype(np.int64)
    hot = (val[: len(val) // 2][:64], val[len(val) // 2:][:64])
    events = temporal_event_stream(engine.ds, num_batches=4,
                                   events_per_batch=64, new_node_frac=0.1,
                                   seed=SEED)
    v1 = v0 + events.total_new_nodes
    rng = np.random.default_rng(SEED + 6)

    def stream_run():
        fab = engine.serve_fabric(FabricConfig(workers=2,
                                               stall_timeout_ms=10_000.0))
        res = {}

        def burst(n):
            futs = []
            for i in range(n):
                k = int(rng.integers(2, 9))
                futs.append((k, fab.submit(rng.choice(hot[i % 2], k,
                                                      replace=False))))
            return len(check_results(futs, n_cls, "mesh-serve (c)"))

        with fab:
            if leader:
                served = burst(16)
                for ev in events:
                    engine.ingest_events(ev)
                    served += burst(8)
            wait_for(lambda: engine.store.generation.graph.num_nodes == v1
                     and engine.pending_deltas == 0,
                     "every merge live on this rank")
            if leader:
                new = np.arange(v0, v1, dtype=np.int64)[:8]
                got = fab.infer(new, timeout=FABRIC_WAIT_S)
                if got.shape != (len(new), n_cls) or \
                        not np.isfinite(got).all():
                    raise AssertionError("mesh-serve (c): new nodes' logits")
                res["requests"] = served + 1
        engine.store.wait_refresh(timeout=FABRIC_WAIT_S)
        res["batches"] = fab.meter.batch_count()
        res["merged"] = {"version": engine.store.version,
                         "merges": engine.store.merges_applied,
                         "nodes": engine.ds.graph.num_nodes,
                         "members": engine.store.state.node_ids.copy()}
        if leader:
            snap = check_fabric(fab, "mesh-serve (c)")
            res["snapshot"] = {k: snap[k] for k in (
                "total_p50_ms", "total_p99_ms", "errors", "batches",
                "swaps_observed")}
        return res

    counted("c", stream_run)
    del engine

    # (c) parity and (d) the checkpoint: a fresh engine merges the events
    engine = GNSEngine(stream_config(), mesh=mesh)
    if leader:
        for ev in events:
            engine.ingest_events(ev)
    engine.merge_deltas()
    ids = np.concatenate([np.arange(v0, v1),
                          np.random.default_rng(SEED + 7).choice(v0, 200,
                                                                 False)])
    out["stream_infer"] = engine.infer(ids)
    if leader:                          # a delta log rides the checkpoint
        new = engine.ingest_nodes(np.ones((2, engine.ds.feat_dim),
                                          np.float32))
        engine.ingest(new, [0, 1])
    (ROOT / "build").mkdir(exist_ok=True)
    path = engine.save(ROOT / "build" / "chip_smoke_mesh_ckpt", step=3)
    out["ckpt"] = {"path": str(path),
                   "params": [t.detach().cpu().numpy()
                              for layer in engine.params["layers"]
                              for t in layer.values()],
                   "stream": engine.stream.state() if leader else None}
    return out


def phase_mesh_serve(ds) -> dict:
    """Serving, the fabric, ingest and checkpoints on a mesh (module
    docstring, phase 12).  Returns K1's and K2's launches on the ranks'
    main paths, summed over the ranks."""
    import shutil
    import torch
    from repro_torch.data import temporal_event_stream
    from repro_torch.gns import GNSEngine
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    # one rank: the same 24 requests one at a time
    one = GNSEngine(two_shards(serve_config()), dataset=ds)
    reqs = one_at_a_time_requests(one.ds.graph.num_nodes)
    with one.serve() as server:
        want = served_one_at_a_time(server, reqs, True)
        one_snap = server.meter.snapshot()
    del one
    shutil.rmtree(ROOT / "build" / "chip_smoke_mesh_ckpt",
                  ignore_errors=True)
    ranks = []
    for which, data, model in (("two", 1, 2), ("four", 2, 2)):
        devices = ["cuda:0"] * (data * model)
        log("mesh-serve-launch", world=which, mesh=(data, model),
            devices=devices, backend=MESH_BACKEND, deadline_s=MESH_DEADLINE_S)
        t1 = time.perf_counter()
        ranks += run_ranks("chip_smoke:mesh_serve_rank", data=data,
                           model=model, devices=devices, backend=MESH_BACKEND,
                           args=(ds, which), timeout_s=MESH_DEADLINE_S)
        log("mesh-serve-world", world=which,
            seconds=round(time.perf_counter() - t1, 1))
    counts = {"cache_lookup_agg": 0, "gather_agg": 0}
    two = [r for r in ranks if "a" in r["runs"]]
    for r in ranks:
        for name, res in r["runs"].items():
            for k, v in res["k12"]["counts"].items():
                counts[k] += v
            log("mesh-serve", rank=r["rank"], run=name,
                launches=res["k12"]["counts"], k1_paths=res["k12"]["k1_paths"],
                k2_paths=res["k12"]["k2_paths"], batches=res["batches"],
                allreduce_ms_per_batch=round(
                    res["psum_ms"] / max(res["batches"], 1), 3),
                allreduce_calls=res["psum_calls"],
                wall_s=round(res["wall_s"], 2),
                **{k: res[k] for k in ("snapshot", "routing", "alive",
                                       "wave_buckets", "requests")
                   if k in res})
    # (a) against one rank: bucket, version, logits
    lead = two[0]["runs"]["a"]
    got = lead["one_at_a_time"]
    errs = [float(np.abs(g[2] - w[2]).max()) for g, w in zip(got, want)]
    same = [(g[0], g[1]) == (w[0], w[1]) for g, w in zip(got, want)]
    close = [np.allclose(g[2], w[2], rtol=1e-4, atol=1e-4)
             for g, w in zip(got, want)]
    bitwise = all(all(np.array_equal(a, b) for a, b in zip(
        r["runs"]["a"]["logits"], lead["logits"])) for r in two[1:])
    log("mesh-serve-a", requests=len(got), max_abs_err=max(errs),
        buckets=sorted({g[0] for g in got}), same_bucket_and_version=all(same),
        ranks_bitwise=bitwise,
        mesh_p50_ms=lead["one_snapshot"]["total_p50_ms"],
        one_rank_p50_ms=one_snap["total_p50_ms"],
        mesh_p99_ms=lead["one_snapshot"]["total_p99_ms"],
        one_rank_p99_ms=one_snap["total_p99_ms"],
        wave_buckets=lead["wave_buckets"])
    if len(got) != MESH_SERVE_ONE_AT_A_TIME or not all(same) \
            or not all(close):
        raise AssertionError(f"mesh-serve (a): the mesh's server differs "
                             f"from one rank's: {same} {errs}")
    if lead["wave_buckets"] != [32, 128, 512] or lead["wave_requests"] != 64:
        raise AssertionError(f"mesh-serve (a): waves {lead['wave_buckets']}")
    if any(r["runs"]["a"]["versions"] != lead["versions"] for r in two):
        raise AssertionError("mesh-serve (a): ranks pinned other versions")
    # (b) the fabric's kill
    four = [r for r in ranks if "b" in r["runs"]]
    fb = four[0]["runs"]["b"]
    rt = fb["routing"]
    if fb["requests"] != 108 or fb["snapshot"]["errors"] != 0 \
            or rt["failovers"] < 1 or rt["retries"] < 1:
        raise AssertionError(f"mesh-serve (b): {fb['requests']} served, "
                             f"{fb['snapshot']}, {rt}")
    if any(r["runs"]["b"]["alive"] != [False, False] for r in four):
        raise AssertionError("mesh-serve (b): a worker outlived the stop")
    # (c) every rank merged at one version; the mesh's infer vs one rank's
    merged = [r["runs"]["c"]["merged"] for r in two]
    if any(m["version"] != merged[0]["version"]
           or m["merges"] != merged[0]["merges"] or merged[0]["merges"] < 1
           or not np.array_equal(m["members"], merged[0]["members"])
           for m in merged):
        raise AssertionError(f"mesh-serve (c): ranks merged apart: "
                             f"{[(m['version'], m['merges']) for m in merged]}")
    single = GNSEngine(stream_config())
    v0 = single.ds.graph.num_nodes
    events = temporal_event_stream(single.ds, num_batches=4,
                                   events_per_batch=64, new_node_frac=0.1,
                                   seed=SEED)
    for ev in events:
        single.ingest_events(ev)
    single.merge_deltas()
    ids = np.concatenate([np.arange(v0, v0 + events.total_new_nodes),
                          np.random.default_rng(SEED + 7).choice(v0, 200,
                                                                 False)])
    # the mesh's parameters: the same seed on every rank and on one rank
    want_c = single.infer(ids)
    got_c = two[0]["stream_infer"]
    err_c = float(np.abs(got_c - want_c).max())
    log("mesh-serve-c", merges=merged[0]["merges"],
        version=merged[0]["version"], nodes=merged[0]["nodes"], ids=len(ids),
        max_abs_err=err_c)
    if not np.allclose(got_c, want_c, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"mesh-serve (c): infer differs by {err_c}")
    # (d) the mesh's checkpoint into one rank on the card
    ck = two[0]["ckpt"]
    fresh = GNSEngine(stream_config())
    step = fresh.restore(Path(ck["path"]).parent)
    params = [t.detach().cpu().numpy() for layer in fresh.params["layers"]
              for t in layer.values()]
    ok_p = all(np.array_equal(a, b) for a, b in zip(params, ck["params"]))
    st = fresh.stream.state()
    ok_s = all(np.array_equal(st[k], v) for k, v in ck["stream"].items())
    log("mesh-serve-d", step=step, tensors=len(params), params_bitwise=ok_p,
        delta_log_equal=ok_s, pending=fresh.pending_deltas,
        on=str(fresh.params["layers"][0]["w"].device))
    if step != 3 or not ok_p or not ok_s or fresh.pending_deltas != 4 \
            or any(r["ckpt"]["path"] != ck["path"] for r in two):
        raise AssertionError("mesh-serve (d): the checkpoint did not round "
                             "trip")
    shutil.rmtree(ROOT / "build" / "chip_smoke_mesh_ckpt",
                  ignore_errors=True)
    torch.cuda.synchronize()
    log("mesh-serve-done", launches=counts,
        seconds=round(time.perf_counter() - t0, 1))
    for kernel, n in counts.items():
        if n < 1:
            raise AssertionError(f"mesh-serve: {kernel} never launched")
    return counts


# ---------------------------------------------------------------------------
# mesh-serve (e): the tcp fabric over endpoints that are (2, 2) worlds
# ---------------------------------------------------------------------------

MESH_RPC_PINNED = 12           # requests held against one rank's fabric
RANKS_GONE_S = 30.0            # a killed endpoint's ranks exit within this


def mesh_rpc_config():
    """The served config on a (2, 2) mesh: every world of the phase."""
    from repro_torch.gns.config import MeshConfig
    return dataclasses.replace(serve_config(), mesh=MeshConfig(2, 2))


def mesh_rpc_pinned(num_nodes: int) -> list:
    """(worker, ids): the first of the mesh-serve requests, pinned to the
    workers in turn (1-48 ids each: buckets 32 and 128)."""
    return [(i % 2, ids) for i, ids in
            enumerate(one_at_a_time_requests(num_nodes)[:MESH_RPC_PINNED])]


def mesh_rpc_coordinator(ds, spec: dict) -> dict:
    """The coordinator of (e), in this process: ``GNSEngine.coordinator``
    of the (2, 2) config (one process, no rank) proxies to the two
    endpoint worlds.  (1) the pinned requests one at a time; (2) the
    reference smoke's traffic (two tenants, 40 requests, 4 pinned to
    worker 0 with endpoint 0's leader SIGKILLed, 6 more)."""
    import os
    import signal
    import torch.distributed as dist
    from repro_torch.gns import FabricConfig, GNSEngine, TenantConfig
    t0 = time.perf_counter()
    engine = GNSEngine.coordinator(mesh_rpc_config(), dataset=ds)
    out = {"mesh": engine.mesh, "shards": engine.store.n_shards}
    tcp = dict(workers=2, transport="tcp", endpoints=tuple(spec["addrs"]),
               stall_timeout_ms=10_000.0, watch_interval_ms=50.0,
               heartbeat_ms=50.0)
    with engine.serve_fabric(FabricConfig(**tcp)) as fab:
        out["ready_s"] = time.perf_counter() - t0
        res = [fab.submit(ids, worker=w).result(timeout=FABRIC_WAIT_S)
               for w, ids in spec["pinned"]]
        if any(r.status != "ok" for r in res):
            raise AssertionError("mesh-serve (e): a pinned request failed")
        out["pinned"] = [(r.bucket, r.cache_version, r.logits) for r in res]
    fab = engine.serve_fabric(FabricConfig(**tcp, tenants=(
        TenantConfig("mobile", weight=2.0, max_queue=64),
        TenantConfig("batch", weight=1.0, max_queue=64))))
    ds_ = engine.ds
    rng = np.random.default_rng(7)
    half = len(ds_.val_idx) // 2
    hot_a = rng.choice(ds_.val_idx[:half], size=30, replace=False)
    hot_b = rng.choice(ds_.val_idx[half:], size=30, replace=False)
    n_cls = engine.mcfg.num_classes
    t0 = time.perf_counter()
    with fab:
        futs = []
        for i in range(40):
            tenant, hot = (("mobile", hot_a) if i % 2 == 0
                           else ("batch", hot_b))
            n = int(rng.integers(2, 8))
            futs.append((n, fab.submit(rng.choice(hot, size=n,
                                                  replace=False),
                                       tenant=tenant)))
        results = check_results(futs, n_cls, "mesh-serve (e)")
        snap = fab.snapshot()
        w0 = fab.workers[0]
        futs = [(4, fab.submit(rng.choice(hot_a, size=4, replace=False),
                               tenant="mobile", worker=0))
                for _ in range(4)]
        os.kill(spec["pid0"], signal.SIGKILL)
        wait_for(lambda: not w0.alive(), "worker 0's proxy ends")
        results += check_results(futs, n_cls, "mesh-serve (e)")
        futs = [(4, fab.submit(rng.choice(hot_b, size=4, replace=False),
                               tenant="batch")) for _ in range(6)]
        results += check_results(futs, n_cls, "mesh-serve (e)")
        wait_for(lambda: fab.healthy() == [1], "worker 0 leaves rotation")
        out["smoke"] = {
            "requests": len(results), "healthy": fab.healthy(),
            "remote": sorted(fab.pull_remote_stats(timeout=FABRIC_WAIT_S)),
            "wall_s": time.perf_counter() - t0,
            "before_kill": snap, "snapshot": fab.snapshot()}
    out["dist"] = dist.is_available() and dist.is_initialized()
    return out


def phase_mesh_rpc(ds, tcp_p99_ms: float) -> dict:
    """(e) of the mesh-serve phase (module docstring, phase 12): two
    endpoint worlds and the one-process coordinator.  Returns K1's and
    K2's launches over the surviving endpoint's ranks."""
    import signal
    import socket
    import tempfile
    import torch
    from repro_torch.gns import FabricConfig, GNSEngine
    from repro_torch.rpc import wire
    from repro_torch.rpc.endpoint import LAUNCHES_TAG
    t_phase = time.perf_counter()
    # one rank: the pinned requests through an inproc fabric
    one = GNSEngine(two_shards(serve_config()), dataset=ds)
    pinned = mesh_rpc_pinned(one.ds.graph.num_nodes)
    with one.serve_fabric(FabricConfig(workers=2,
                                       stall_timeout_ms=10_000.0)) as fab:
        want = [fab.submit(ids, worker=w).result(timeout=FABRIC_WAIT_S)
                for w, ids in pinned]
    del one
    torch.cuda.synchronize()
    eps = []
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="chip_smoke_mesh_rpc_") as d:
        cfg_path = Path(d) / "engine.json"
        cfg_path.write_text(json.dumps(mesh_rpc_config().to_dict()))
        try:
            t0 = time.perf_counter()
            eps = [Endpoint(cfg_path, i, ("--heartbeat-ms", "50"))
                   for i in range(2)]
            addrs = [ep.ready() for ep in eps]
            t_ready = time.perf_counter() - t0
            eps[0].watch_death()
            log("mesh-serve-e-launch", endpoints=addrs,
                ranks=[[ep.proc.pid] + ep.pids for ep in eps],
                ready_s=round(t_ready, 2), deadline_s=MESH_DEADLINE_S)
            lead = mesh_rpc_coordinator(ds, {
                "addrs": addrs, "pinned": pinned, "pid0": eps[0].proc.pid})
            wait_for(lambda: eps[0].t_gone is not None,
                     "endpoint 0's ranks are gone")
            eps[1].check_running()
            with socket.create_connection(("127.0.0.1", eps[1].port),
                                          timeout=FABRIC_WAIT_S) as sock:
                wire.send_frame(sock, wire.SHUTDOWN)
                line = eps[1].line(LAUNCHES_TAG)
            code = eps[1].proc.wait(timeout=FABRIC_WAIT_S)
        finally:
            for ep in eps:
                ep.reap()
    # (1) against one rank: bucket, version, logits
    got = lead["pinned"]
    errs = [float(np.abs(g[2] - w.logits).max()) for g, w in zip(got, want)]
    same = [(g[0], g[1]) == (w.bucket, w.cache_version)
            for g, w in zip(got, want)]
    close = [np.allclose(g[2], w.logits, rtol=1e-4, atol=1e-4)
             for g, w in zip(got, want)]
    log("mesh-serve-e-pinned", requests=len(got), max_abs_err=max(errs),
        buckets=sorted({g[0] for g in got}),
        same_bucket_and_version=all(same))
    if len(got) != MESH_RPC_PINNED or not all(same) or not all(close):
        raise AssertionError(f"mesh-serve (e): the endpoints differ from "
                             f"one rank's fabric: {same} {errs}")
    # (2) the smoke: no error, a failover, the killed world gone
    sm = lead["smoke"]
    snap, rt = sm["snapshot"], sm["snapshot"]["routing"]
    exit_s = eps[0].t_gone - eps[0].t_dead
    tenants_ms = {t: (v["served"], v["total_p50_ms"], v["total_p99_ms"])
                  for t, v in sm["before_kill"]["tenants"].items()}
    log("mesh-serve-e", requests=sm["requests"], errors=snap["errors"],
        failovers=rt["failovers"], retries=rt["retries"],
        healthy=sm["healthy"], remote_stats_from=sm["remote"],
        routed_known_ids=rt["routed_known_ids"],
        route_local_fraction=rt["route_local_fraction"],
        tenants_served_p50_p99_ms=tenants_ms,
        total_p50_ms=sm["before_kill"]["total_p50_ms"],
        total_p99_ms=sm["before_kill"]["total_p99_ms"],
        rpc_wait_p50_ms=sm["before_kill"].get("rpc_wait_p50_ms"),
        rpc_wait_p99_ms=sm["before_kill"].get("rpc_wait_p99_ms"),
        meshless_tcp_total_p99_ms=tcp_p99_ms,
        endpoint0_exit=eps[0].proc.returncode,
        endpoint0_ranks_gone_s=round(exit_s, 3),
        endpoint0_ranks_left=eps[0].left, smoke_wall_s=round(sm["wall_s"], 3),
        coordinator_ready_s=round(lead["ready_s"], 2),
        coordinator_shards=lead["shards"], coordinator_mesh=lead["mesh"],
        coordinator_process_group=lead["dist"], **snap["rpc"])
    if lead["mesh"] is not None or lead["dist"] or lead["shards"] != 2:
        raise AssertionError(f"mesh-serve (e): the coordinator is not one "
                             f"process on 2 shards: {lead}")
    if (sm["requests"] != 50 or snap["errors"] != 0 or rt["failovers"] < 1
            or rt["retries"] < 1 or sm["healthy"] != [1]
            or sm["remote"] != [1] or rt["routed_known_ids"] < 1
            or not rt["route_local_fraction"] > 0.5):
        raise AssertionError(f"mesh-serve (e): the smoke failed: {sm}")
    if eps[0].proc.returncode != -signal.SIGKILL or eps[0].left \
            or exit_s > RANKS_GONE_S:
        raise AssertionError(f"mesh-serve (e): endpoint 0's ranks "
                             f"{eps[0].left} outlived its leader "
                             f"({exit_s:.1f} s)")
    # (3) the survivor's ranks: K1 and K2 on every one, all vector
    rec = json.loads(line.removeprefix(LAUNCHES_TAG))
    for r in rec["ranks"]:
        k1, k2 = r["cache_lookup_agg"], r["gather_agg"]
        log("mesh-serve-e-rank", rank=r["rank"], launches_k1=k1,
            launches_k2=k2, k1_paths=r["k1_paths"], k2_paths=r["k2_paths"],
            batches=r["batches"], generation=r["version"],
            allreduce_ms_per_batch=round(
                r["psum_ms"] / max(r["batches"], 1), 3),
            allreduce_calls=r["psum_calls"])
        if (min(k1, k2) < 1 or r["k1_paths"] != {"vector": k1, "scalar": 0}
                or r["k2_paths"] != {"vector": k2, "scalar": 0}):
            raise AssertionError(f"mesh-serve (e): rank {r['rank']} of "
                                 f"endpoint 1: {r}")
    counts = {k: rec[k] for k in ("cache_lookup_agg", "gather_agg")}
    log("mesh-serve-e-done", exit=code, ranks=len(rec["ranks"]),
        launches=counts, seconds=round(time.perf_counter() - t_phase, 1))
    if code != 0 or len(rec["ranks"]) != 4 \
            or len({r["batches"] for r in rec["ranks"]}) != 1:
        raise AssertionError(f"mesh-serve (e): survivor exit {code}, "
                             f"{rec}")
    return counts


# ---------------------------------------------------------------------------
# lm-train-mesh: the LM zoo trained on a mesh of ranks
# ---------------------------------------------------------------------------

MESH_LM_ARCH, MESH_LM_BATCH, MESH_LM_SEQ = "gemma-2b", 2, 1024
MESH_LM_LAYERS = 9         # of 18
MESH_LM_STEPS = 3
MESH_DP_ARCH, MESH_DP_BATCH, MESH_DP_SEQ, MESH_DP_STEPS = (
    "seamless-m4t-medium", 8, 256, 2)
MESH_XL_ARCH, MESH_XL_BATCH, MESH_XL_SEQ, MESH_XL_STEPS = (
    "xlstm-125m", 4, 512, 2)
MESH_ZA_ARCH, MESH_ZA_BATCH, MESH_ZA_SEQ, MESH_ZA_STEPS = (
    "zamba2-2.7b", 2, 1024, 3)
MESH_ZA_LAYERS = 12        # of 54 (2 shared-block invocations): one rank at
                           # 54 peaks at about 70 GB
# the card worlds: (name, data, model, the full-width runs it makes):
# (a) gemma, (e) seamless, (f) xlstm and (g) zamba2 tensor parallel on
# (1, 2), (b) seamless data parallel on (2, 1), (f) again on (1, 4); (d)
# on the first three
MESH_WORLDS = (("model2", 1, 2, ("gemma", "seamless", "xlstm", "zamba2")),
               ("data2", 2, 1, ("seamless",)),
               ("2x2", 2, 2, ()),
               ("model4", 1, 4, ("xlstm",)))
MESH_REDUCED_WORLDS = ((1, 2), (2, 1), (2, 2))
MESH_MOE_ARCH, MESH_MOE_SHAPE = "deepseek-v2-236b", (4, 64)
MESH_BF16_RTOL = (2.0 ** -7, 2.0 ** -5)   # step 0's loss, the later ones'
# of the one-rank layer's largest |output|: each rank's combine rounds to
# bf16 before the sum over the ranks (the reference's psum, in bf16), so
# an output can sit a few bf16 ulps (2^-8 to 2^-7 of its own size each)
# from one rank's
MESH_MOE_TOL = 2.0 ** -5
MESH_REDUCED = (("gemma-2b", {}), ("qwen2-7b", {}),
                ("deepseek-v2-236b", {"fsdp": True}),
                ("arctic-480b", {"fsdp": True}),
                ("seamless-m4t-medium", {}), ("xlstm-125m", {}),
                ("zamba2-2.7b", {}))
# xlstm's two steps are chaotic at f32's rounding (tests/
# test_torch_lm_mesh_tp.py): one ulp on every starting parameter moves
# 5-10 of its 285,184 elements beyond MESH_REDUCED_TOL on the CPU ranks,
# and the card's other sums 28-42, over the 28 that
# MESH_REDUCED_OFF_SHARE allows.  Its share is logged beside that floor,
# measured on the CPU ranks in the same run, and it is held to the loss
# tolerance and the 2·lr bound
MESH_REDUCED_NOISY = ("xlstm-125m",)
MESH_REDUCED_TOL = 1e-5       # cuda ranks against CPU ranks, f32, TF32 off
# AdamW moves an element by about lr·sign(g) where its gradient g is near
# zero, so a rounding-sized change there moves it by up to 2·lr a step:
# every element is held to that bound, all but this share of the tree's
# to MESH_REDUCED_TOL, and the key bias (true gradient 0: softmax does not
# see a shift of all of a query's logits) to the bound alone
MESH_REDUCED_OFF_SHARE = 1e-4
MESH_REDUCED_LR = 3e-4        # train_loop's default
MESH_REDUCED_BATCH, MESH_REDUCED_SEQ, MESH_REDUCED_STEPS = 4, 32, 2


class CollectiveMeter:
    """Counts this process's collectives (calls and bytes of the tensor
    each rank contributes, by kind) by wrapping ``torch.distributed``'s
    functions, which the port calls through the module; ``close`` undoes
    it."""

    KINDS = ("all_reduce", "all_gather", "broadcast")

    def __init__(self) -> None:
        import torch.distributed as dist
        self.counts = {k: [0, 0] for k in self.KINDS}
        self._saved = {k: getattr(dist, k) for k in self.KINDS}
        for kind, fn in self._saved.items():
            setattr(dist, kind, self._wrap(kind, fn))

    def _wrap(self, kind, fn):
        def counted(*args, **kw):
            t = args[1] if kind == "all_gather" else args[0]
            self.counts[kind][0] += 1
            self.counts[kind][1] += t.numel() * t.element_size()
            return fn(*args, **kw)
        return counted

    def close(self) -> dict:
        import torch.distributed as dist
        for kind, fn in self._saved.items():
            setattr(dist, kind, fn)
        return {k: {"calls": c, "bytes": b} for k, (c, b) in
                self.counts.items()}


def one_ulp(tree, seed: int):
    """Every f32 element of a tree of tensors moved by one ulp, up or
    down (a generator seeded with ``seed``, the same on every rank)."""
    import torch
    from repro_torch.models.scan_util import tree_map
    gen = torch.Generator().manual_seed(seed)
    inf = torch.tensor(float("inf"))

    def one(t):
        if t.dtype != torch.float32:
            return t
        up = torch.rand(t.shape, generator=gen) < 0.5
        return torch.nextafter(t, torch.where(up, inf, -inf))
    return tree_map(one, tree)


def train_capturing(cfg, mesh, device, *, steps, batch, seq_len,
                    cpu_init=False, profile_last=False,
                    ulp_seed=None) -> dict:
    """``launch.train.train_loop`` on this rank, with its train step
    wrapped to keep the final parameters and their plans (and, with
    ``profile_last``, the last step under ``torch.profiler``: the card's
    busy ms beside the step's wall ms).  ``cpu_init``: the parameters are
    drawn on the CPU and moved (so CPU and card ranks start alike), with
    ``ulp_seed`` each moved by one ulp first (:func:`one_ulp`)."""
    import torch
    from repro_torch.launch import train as train_mod
    from repro_torch.models.lm import get_model
    from repro_torch.models.scan_util import tree_map
    kept = {"calls": 0}
    make_step = train_mod.make_train_step

    def capture(model, opt, plans=None):
        step = make_step(model, opt, plans)

        def run(params, state, b):
            kept["calls"] += 1
            if profile_last and kept["calls"] == steps:
                t0 = time.perf_counter()
                busy, launches = profile_device(
                    lambda: kept.update(out=step(params, state, b)))
                kept["profile"] = {"busy_ms": round(busy, 2),
                                   "wall_ms": round((time.perf_counter()
                                                     - t0) * 1e3, 2),
                                   "device_launches": launches}
                out = kept.pop("out")
            else:
                out = step(params, state, b)
            kept["params"], kept["plans"] = out[0], plans
            return out
        return run

    saved = train_mod.get_model, train_mod.make_train_step
    if cpu_init:
        base = get_model(cfg)
        def init(seed=0, device=None):
            tree = base.init(seed, device="cpu")
            if ulp_seed is not None:
                tree = one_ulp(tree, ulp_seed)
            return tree_map(lambda t: t.to(device), tree)
        model = dataclasses.replace(base, init=init)
        train_mod.get_model = lambda _cfg: model
    train_mod.make_train_step = capture
    try:
        rep = train_mod.train_loop(cfg, steps=steps, batch=batch,
                                   seq_len=seq_len, mesh=mesh, device=device,
                                   seed=SEED, log_every=0)
    finally:
        train_mod.get_model, train_mod.make_train_step = saved
    return {"losses": rep.losses, "step_ms": [round(t * 1e3, 1)
                                              for t in rep.step_times],
            "params": kept["params"], "plans": kept["plans"],
            "profile": kept.get("profile")}


def replicated_equal(params, plans, mesh, axis: str) -> tuple:
    """(leaves whole on every rank, how many are equal bit for bit on
    every rank of the ``axis`` group): each gathered over the group and
    compared here."""
    import torch
    import torch.distributed as dist
    from repro_torch.models.scan_util import tree_leaves
    n = same = 0
    for p, plan in zip(tree_leaves(params), tree_leaves(plans)):
        if plan.axes:
            continue
        parts = [torch.empty_like(p) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, p.contiguous(), group=mesh.group(axis))
        n += 1
        same += all(torch.equal(parts[0], q) for q in parts[1:])
    return n, same


def allreduces_ms(mesh, axis: str, tensors: list, reps: int = 3) -> float:
    """Median ms of all_reduces of ``tensors`` (one after another, a card
    sync on both sides) over the ``axis`` group."""
    import torch
    import torch.distributed as dist
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in tensors:
            dist.all_reduce(t, group=mesh.group(axis))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return round(float(np.median(times[1:])), 2)


def mesh_moe_layer(device, mesh=None):
    """deepseek-v2-236b's MoE layer at its published width (bf16: 160
    experts, 2 shared) from seed ``SEED + 7`` on ``device``, on 4 x 64
    random tokens: the output [4, 64, d] in f32 on the CPU.  With a mesh:
    this rank's experts (``shard_params``), the full stacks freed first."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import use_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import make_generator, model_dtype
    from repro_torch.models.lm_params import shard_params
    cfg = get_config(MESH_MOE_ARCH)
    gen = make_generator(SEED + 7, device)
    mp = moe.init_moe(gen, cfg)
    x = torch.randn((*MESH_MOE_SHAPE, cfg.d_model), generator=gen,
                    device=gen.device).to(model_dtype(cfg))
    if mesh is not None:
        mp = shard_params(mp, mesh, cfg)[0]
        torch.cuda.empty_cache()
    with torch.inference_mode(), use_mesh(mesh):
        out = moe.moe_forward(mp, cfg, x).float().cpu().numpy()
    experts = mp["experts_w1"].shape[0]
    del mp
    torch.cuda.empty_cache()
    return out, experts


def reduced_cells(mesh, device) -> dict:
    """(d): the reduced configs trained on this mesh in f32 (TF32 off),
    from parameters drawn on the CPU: cell -> (losses, local params, and
    on the CPU for a noisy arch the elements beyond MESH_REDUCED_TOL that
    one ulp on the starting parameters moves, else None)."""
    import torch
    from repro_torch.configs import get_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch, kw in MESH_REDUCED:
        cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
        args = dict(steps=MESH_REDUCED_STEPS, batch=MESH_REDUCED_BATCH,
                    seq_len=MESH_REDUCED_SEQ, cpu_init=True)
        run = train_capturing(cfg, mesh, device, **args)
        params, floor = flat_numpy(run["params"]), None
        if arch in MESH_REDUCED_NOISY and str(device) == "cpu":
            moved = flat_numpy(train_capturing(cfg, mesh, device,
                                               ulp_seed=SEED,
                                               **args)["params"])
            floor = sum(int((np.abs(moved[k] - a) > MESH_REDUCED_TOL).sum())
                        for k, a in params.items())
        out[arch] = (run["losses"], params, floor)
    return out


def flat_numpy(tree, prefix: str = "") -> dict:
    """path -> numpy array of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_numpy(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree.detach().cpu().numpy()}


def reduced_param_check(got: dict, want: dict, floor=None) -> tuple:
    """(max |error|, elements beyond MESH_REDUCED_TOL, ok) of a rank's
    parameters on the card against the same rank's on the CPU
    (``MESH_REDUCED_OFF_SHARE``; with a noisy arch's ``floor``, the
    2·lr bound alone: MESH_REDUCED_NOISY)."""
    bound = 2 * MESH_REDUCED_LR * MESH_REDUCED_STEPS
    err, off, size = 0.0, 0, 0
    for path, a in want.items():
        d = np.abs(got[path] - a)
        err = max(err, float(d.max()))
        if not path.endswith("/bk"):
            off += int((d > MESH_REDUCED_TOL).sum())
            size += a.size
    share_ok = floor is not None or off <= size * MESH_REDUCED_OFF_SHARE
    return err, off, err <= bound and share_ok


def mesh_reduced_rank(mesh, device) -> dict:
    """A rank of (d) on the CPU (``run_ranks`` spawns it)."""
    import torch
    torch.set_num_threads(2)
    return reduced_cells(mesh, device)


def mesh_full_runs() -> dict:
    """The full-width runs of ``lm-train-mesh`` (module docstring, phase
    13): key -> (config, steps, batch, seq)."""
    from repro_torch.configs import get_config
    return {
        "gemma": (dataclasses.replace(at_depth(get_config(MESH_LM_ARCH),
                                               MESH_LM_LAYERS),
                                      chunked_ce=DEC_CHUNK),
                  MESH_LM_STEPS, MESH_LM_BATCH, MESH_LM_SEQ),
        "seamless": (get_config(MESH_DP_ARCH), MESH_DP_STEPS,
                     MESH_DP_BATCH, MESH_DP_SEQ),
        "xlstm": (at_depth(get_config(MESH_XL_ARCH), XL_TRAIN_LAYERS),
                  MESH_XL_STEPS, MESH_XL_BATCH, MESH_XL_SEQ),
        "zamba2": (at_depth(get_config(MESH_ZA_ARCH), MESH_ZA_LAYERS),
                   MESH_ZA_STEPS, MESH_ZA_BATCH, MESH_ZA_SEQ)}


def full_rank_run(key: str, mesh, device) -> dict:
    """One full-width run on this rank: losses, ms a step, collectives a
    step, peak GB, the leaves left whole compared over the group; (a)
    and (b) also profile their last step, (a) times one activation's
    all_reduce ([2, 1024, d]) and (b) the step's gradient all_reduce
    alone."""
    import torch
    from repro_torch.models.scan_util import tree_leaves
    cfg, steps, batch, seq = mesh_full_runs()[key]
    axis = "model" if mesh.shape["model"] > 1 else "data"
    torch.cuda.reset_peak_memory_stats()
    meter = CollectiveMeter()
    try:
        run = train_capturing(cfg, mesh, device, steps=steps, batch=batch,
                              seq_len=seq, profile_last=key == "gemma"
                              or axis == "data")
    finally:
        coll = meter.close()
    n_rep, same = replicated_equal(run["params"], run["plans"], mesh, axis)
    leaves = tree_leaves(run["params"])
    res = {"arch": cfg.name, "layers": cfg.num_layers,
           "losses": run["losses"], "step_ms": run["step_ms"],
           "profile": run["profile"],
           "collectives_per_step": {
               k: {"calls": v["calls"] / steps,
                   "mb": round(v["bytes"] / steps / 1e6, 1)}
               for k, v in coll.items() if v["calls"]},
           "replicated_leaves": n_rep, "replicated_equal": same,
           "local_params": sum(p.numel() for p in leaves),
           "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}
    if key == "gemma":
        res["allreduce_8mb_ms"] = allreduces_ms(mesh, "model", [
            torch.ones((MESH_LM_BATCH, MESH_LM_SEQ, cfg.d_model),
                       dtype=torch.bfloat16, device=device)])
    elif axis == "data":
        res["grad_allreduce_ms"] = allreduces_ms(
            mesh, "data", [torch.zeros_like(p) for p in leaves], reps=1)
        res["grad_allreduce_gb"] = round(sum(
            p.numel() * p.element_size() for p in leaves) / 1e9, 3)
    del run, leaves
    torch.cuda.empty_cache()
    return res


def mesh_lm_rank(mesh, device, which: str, runs: tuple) -> dict:
    """A card rank of ``lm-train-mesh`` (``run_ranks`` spawns it; module
    docstring, phase 13): the full-width ``runs`` of its world
    (``MESH_WORLDS``), (c) on ``"model2"``, (d) on the worlds of
    ``MESH_REDUCED_WORLDS``."""
    out = {"rank": mesh.rank,
           "runs": {key: full_rank_run(key, mesh, device) for key in runs}}
    if which == "model2":
        layer, experts = mesh_moe_layer(device, mesh)
        out["moe_layer"] = {"out": layer, "local_experts": experts}
    if (mesh.shape["data"], mesh.shape["model"]) in MESH_REDUCED_WORLDS:
        out["reduced"] = reduced_cells(mesh, device)
    out["launches"] = {k: c.value for k, c in lm_counters().items()}
    return out


def full_run_checks(one: dict, card: dict) -> list:
    """(a), (b), (e), (f), (g): each rank's losses against one rank's on
    the same seed and batches (``MESH_BF16_RTOL``), the leaves left whole
    equal over the group; logs each rank's run; returns the failures."""
    failures = []
    for (which, data, model, runs) in MESH_WORLDS:
        for key in runs:
            rep, one_peak = one[key]
            want = rep.losses
            for r in card[(data, model)]:
                run = r["runs"][key]
                err = [abs(a - b) / abs(b)
                       for a, b in zip(run["losses"], want)]
                ok = (err[0] <= MESH_BF16_RTOL[0]
                      and all(e <= MESH_BF16_RTOL[1] for e in err[1:])
                      and run["replicated_equal"] == run["replicated_leaves"])
                log("lm-train-mesh", mesh=(data, model), rank=r["rank"],
                    **run, one_rank_losses=want,
                    one_rank_step_ms=[round(t * 1e3, 1)
                                      for t in rep.step_times],
                    one_rank_peak_gb=round(one_peak / 1e9, 3),
                    rel_err=[float(f"{e:.3g}") for e in err], ok=ok)
                if not ok:
                    failures.append(f"{run['arch']} on {(data, model)} "
                                    f"rank {r['rank']}")
    return failures


def reduced_checks(card: dict, cpu: dict) -> list:
    """(d): each card rank's reduced runs against the same rank's on the
    CPU (``MESH_REDUCED_TOL``, ``reduced_param_check``); returns the
    failures."""
    failures = []
    for mesh in MESH_REDUCED_WORLDS:
        for r_card, r_cpu in zip(card[mesh], cpu[mesh]):
            for arch, _ in MESH_REDUCED:
                (lc, pc, floor), (lg, pg, _) = (r_cpu[arch],
                                                r_card["reduced"][arch])
                loss_err = float(np.max(np.abs(np.subtract(lg, lc))
                                        / np.abs(lc)))
                p_err, p_off, p_ok = reduced_param_check(pg, pc, floor)
                ok = loss_err <= MESH_REDUCED_TOL and p_ok
                log("lm-train-mesh-reduced", mesh=mesh, rank=r_card["rank"],
                    arch=arch, losses_card=lg, losses_cpu=lc,
                    loss_rel_err=loss_err, param_max_abs_err=p_err,
                    params_beyond_tol=p_off, one_ulp_floor=floor, ok=ok)
                if not ok:
                    failures.append(f"reduced {arch} on {mesh}")
    return failures


def phase_lm_train_mesh() -> dict:
    """The LM zoo on a mesh of ranks on ``cuda:0`` over gloo (module
    docstring, phase 13)."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.train import train_loop
    counters, t0 = lm_phase_start()
    one = {}
    for key, (cfg, steps, batch, seq) in mesh_full_runs().items():
        torch.cuda.reset_peak_memory_stats()
        rep = train_loop(cfg, steps=steps, batch=batch, seq_len=seq,
                         seed=SEED, log_every=0)
        one[key] = (rep, torch.cuda.max_memory_allocated())
        free_card()
    torch.cuda.reset_peak_memory_stats()
    one_layer, _ = mesh_moe_layer("cuda")
    free_card()
    counts, peak = lm_phase_end("lm-train-mesh-one-rank", counters, t0,
                                peak=max(p for _, p in one.values()))
    card, cpu_futs = {}, {}

    def cpu_world(data, model):
        t = time.perf_counter()
        out = run_ranks("chip_smoke:mesh_reduced_rank", data=data,
                        model=model, devices=["cpu"] * (data * model),
                        backend=MESH_BACKEND, timeout_s=MESH_DEADLINE_S)
        return out, time.perf_counter() - t

    # each (d)'s CPU world runs in the background, beside the next card
    # worlds (one CPU world at a time)
    with ThreadPoolExecutor(1) as pool:
        for which, data, model, runs in MESH_WORLDS:
            t1 = time.perf_counter()
            card[(data, model)] = run_ranks(
                "chip_smoke:mesh_lm_rank", data=data, model=model,
                devices=["cuda:0"] * (data * model), backend=MESH_BACKEND,
                args=(which, runs), timeout_s=MESH_DEADLINE_S)
            log("lm-train-mesh-world", mesh=(data, model),
                card_s=round(time.perf_counter() - t1, 1))
            if (data, model) in MESH_REDUCED_WORLDS:
                cpu_futs[(data, model)] = pool.submit(cpu_world, data,
                                                      model)
        t2 = time.perf_counter()
        cpu = {}
        for (data, model), fut in cpu_futs.items():
            cpu[(data, model)], cpu_s = fut.result()
            log("lm-train-mesh-cpu-world", mesh=(data, model),
                cpu_s=round(cpu_s, 1))
        log("lm-train-mesh-cpu-wait", seconds=round(
            time.perf_counter() - t2, 1))
    failures = full_run_checks(one, card)
    # (c): the expert-parallel MoE layer
    scale = float(np.abs(one_layer).max())
    for r in card[(1, 2)]:
        err = float(np.abs(r["moe_layer"]["out"] - one_layer).max())
        ok = err <= MESH_MOE_TOL * scale
        log("lm-train-mesh-moe", arch=MESH_MOE_ARCH, rank=r["rank"],
            tokens=MESH_MOE_SHAPE[0] * MESH_MOE_SHAPE[1],
            local_experts=r["moe_layer"]["local_experts"],
            max_abs_err=err, max_abs=scale, tol=MESH_MOE_TOL * scale, ok=ok)
        if not ok:
            failures.append(f"moe layer rank {r['rank']}")
    failures += reduced_checks(card, cpu)
    launches = {k: sum(r["launches"][k] for rs in card.values() for r in rs)
                for k in counts}
    log("lm-train-mesh-done", seconds=round(time.perf_counter() - t0, 1),
        one_rank_peak_gb=round(peak / 1e9, 3), rank_launches=launches)
    if any(launches.values()):
        failures.append(f"kernels launched on the ranks: {launches}")
    if failures:
        raise AssertionError(f"lm-train-mesh: {failures}")
    return launches


# ---------------------------------------------------------------------------
# vocab-cache: the hot-vocabulary cache on the card
# ---------------------------------------------------------------------------

VC_ARCH = "gemma-2b"           # its vocabulary and width: the host table
VC_FRACTION, VC_PERIOD = 0.01, 5
VC_BATCHES, VC_BATCH, VC_SEQ = 20, 8, 1024
VC_SOFTMAX_RTOL = 1e-5         # the card's sampled softmax against the CPU's


def vocab_cache_run(vc, table: np.ndarray, corpus, meter) -> dict:
    """One strategy's 20 batches: observe, refresh every 5, assemble onto
    the card, ``embed_with_cache`` (CUDA events) held to ``table[tokens]``
    bit for bit; the hit rate, bytes and times; the last batch's tokens
    and its embeddings on the card."""
    import torch
    from repro_torch.data.vocab_cache import embed_with_cache
    hits, exact, every_row, unique_rows = [], True, 0, 0
    refresh_ms, assemble_ms, embed_ms = [], [], []
    row_bytes = table.shape[1] * table.itemsize
    for step in range(VC_BATCHES):
        toks = corpus.batch(0, step, batch=VC_BATCH, seq_len=VC_SEQ)
        vc.observe(toks)
        if step % VC_PERIOD == 0:
            t0 = time.perf_counter()
            vc.refresh(step, meter)
            torch.cuda.synchronize()
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        batch = vc.assemble(toks, meter, device="cuda")
        torch.cuda.synchronize()
        assemble_ms.append((time.perf_counter() - t0) * 1e3)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        h = embed_with_cache(vc.table, batch)
        end.record()
        torch.cuda.synchronize()
        embed_ms.append(start.elapsed_time(end))
        exact = exact and np.array_equal(h.cpu().numpy(), table[toks])
        hits.append(vc.hit_rate(toks))
        every_row += toks.size * row_bytes
        unique_rows += np.unique(toks).size * row_bytes
    return {"hit_rate": float(np.mean(hits[VC_PERIOD:])),
            "hit_rate_first": hits[0], "exact": exact,
            "streamed_mb": meter.bytes_streamed / 1e6,
            "every_row_mb": every_row / 1e6,
            "unique_rows_mb": unique_rows / 1e6,
            "streamed_share": meter.bytes_streamed / every_row,
            "cache_fill_mb": meter.bytes_cache_fill / 1e6,
            "refresh_ms": round(float(np.median(refresh_ms)), 2),
            "assemble_ms": round(float(np.median(assemble_ms)), 2),
            "embed_ms": round(float(np.median(embed_ms)), 4),
            "tokens": toks, "h": h}


def softmax_check(vc, table: np.ndarray, toks: np.ndarray, h) -> dict:
    """``sampled_softmax_loss`` of the last batch (hidden: its embeddings
    over sqrt(d); gold rows: the next tokens' rows, the table tied as
    gemma's; negatives: the cached rows with their eq. 11 probabilities)
    on the card and on the CPU, TF32 off."""
    import torch
    from repro_torch.data.vocab_cache import sampled_softmax_loss
    d = table.shape[1]
    labels = toks[:, 1:].reshape(-1)
    hidden = h[:, :-1].reshape(-1, d) * d ** -0.5
    incl = torch.from_numpy(vc.inclusion_probs(vc.token_ids).astype(
        np.float32))
    gold = torch.from_numpy(table[labels])
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = float(sampled_softmax_loss(
            hidden, torch.from_numpy(labels).cuda(), gold.cuda(), vc.table,
            incl.cuda()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu = float(sampled_softmax_loss(hidden.cpu(), torch.from_numpy(labels),
                                     gold, vc.table.cpu(), incl))
    return {"tokens": int(labels.size), "loss_card": card, "loss_cpu": cpu,
            "rel_err": abs(card - cpu) / abs(cpu)}


def phase_vocab_cache() -> dict:
    """The hot-vocabulary cache (``data/vocab_cache.py``) on the card
    (module docstring, phase 14)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.data.vocab_cache import VocabCache, VocabCacheConfig
    from repro_torch.featurestore import TrafficMeter
    counters, t0 = lm_phase_start()
    cfg = get_config(VC_ARCH)
    t1 = time.perf_counter()
    table = np.random.default_rng(SEED).standard_normal(
        (cfg.vocab_size, cfg.d_model), dtype=np.float32)
    log("vocab-cache-table", rows=table.shape[0], dim=table.shape[1],
        gb=round(table.nbytes / 1e9, 3),
        draw_s=round(time.perf_counter() - t1, 1))
    corpus = SyntheticCorpus(cfg.vocab_size, seed=SEED)
    failures = []
    for strategy in ("topk", "sampled"):
        vc = VocabCache(table, VocabCacheConfig(fraction=VC_FRACTION,
                                                strategy=strategy),
                        device="cuda", seed=SEED)
        res = vocab_cache_run(vc, table, corpus, TrafficMeter())
        sm = softmax_check(vc, table, res.pop("tokens"), res.pop("h"))
        ok = res["exact"] and sm["rel_err"] <= VC_SOFTMAX_RTOL
        log("vocab-cache", arch=VC_ARCH, strategy=strategy,
            cache_rows=vc.size,
            cache_mb=round(vc.table.numel() * 4 / 1e6, 1),
            batches=VC_BATCHES, batch=(VC_BATCH, VC_SEQ),
            refresh_every=VC_PERIOD, **res, softmax=sm, ok=ok)
        if not ok:
            failures.append(strategy)
        del vc
    counts, _ = lm_phase_end("vocab-cache", counters, t0)
    if failures:
        raise AssertionError(f"vocab-cache: {failures}")
    return counts


# ---------------------------------------------------------------------------
# lm-serve-mesh: the LM zoo served on a mesh of ranks on the card
# ---------------------------------------------------------------------------

# (key, arch, config overrides (the depth cut, a dtype), mesh (data,
# model), batch, prompt, new tokens: the prompt's call gives the first,
# each decode step one more)
SERVE_MESH_RUNS = (
    ("qwen2", "qwen2-7b", {"num_layers": 14}, (1, 2), 4, 512, 17),
    ("deepseek", "deepseek-v2-236b", {"num_layers": 3}, (1, 2), 4, 512, 17),
    ("zamba2", "zamba2-2.7b", {"num_layers": 12}, (1, 2), 4, 512, 17),
    ("xlstm", "xlstm-125m", {"num_layers": 6}, (1, 2), 4, 512, 17),
    ("xlstm-f32", "xlstm-125m", {"num_layers": 6, "dtype": "float32"},
     (1, 2), 4, 512, 17),
    # 4,032 + 72: the 4,096-slot ring wraps at decode step 64
    ("danube", "h2o-danube-3-4b", {"num_layers": 12}, (2, 1), 1, 4032, 72),
    # 3 model ranks divide neither the 160 experts nor the 128 heads: the
    # MoE layer's single-device branch (experts split along f, 512 of
    # 1,536 columns a rank) and MLA over all heads on every rank
    ("deepseek-13", "deepseek-v2-236b", {"num_layers": 3}, (1, 3), 4, 512,
     33),
)
# the (1, 3) world's full-width MoE layer, forward and backward: the
# layout the rule table must give each rank (one layer's stacks)
SERVE_MESH_THREE = (1, 3)
THREE_EXPERT_SHAPES = {"experts_w1": [160, 5120, 512],
                       "experts_w3": [160, 5120, 512],
                       "experts_w2": [160, 512, 5120]}
# a greedy flip counts only where one rank's top-two logit gap at that
# step is at most this; in f32 the logits too must lie within it.  f32
# sums in another order diverge through xlstm's sLSTM recurrence with
# depth and length: 3.1e-5 at 12 layers x 32 tokens and 1.4e-4 at 6 x 512
# on CPU ranks, 2.27e-3 at 12 x 512 on the card (logits up to 2.7)
SERVE_MESH_TIE = {"bfloat16": 0.5, "float32": 1e-2}
SERVE_MESH_DEADLINE_S = 900.0
# data > 1 beside a model axis of 3: deepseek's MLA and MoE layers at full
# width, each data rank on its rows of MESH_MOE_SHAPE; MLA's q_up is the
# one leaf split (24,576 columns; 16,384 of k_up, v_up and wo's rows are not
# divisible by 3)
SIX_MESH = (2, 3)
SIX_MLA_SPLIT = ["q_up"]
SIX_MLA_SHAPES = {"q_up": [1536, 8192], "k_up": [512, 16384],
                  "v_up": [512, 16384], "wo": [16384, 5120]}
CALIB_ARCH, CALIB_BATCH, CALIB_SEQ = "gemma-2b", 2, 1024
CALIB_PEAK_MARGIN = 0.05  # predicted peak bytes vs max_memory_allocated
CALIB_ARG_MARGIN = 0.001  # predicted arg bytes vs memory_allocated, a rank
DRYRUN_DEADLINE_S = 900.0  # the background dry-run must end within this
MULTIPOD_SHAPE = "train_4k"  # the one 2x16x16 cell an arch (phase 16)


def serve_mesh_cfg(arch: str, overrides: dict):
    """``arch``'s config with ``overrides``, ``num_layers`` through
    :func:`at_depth`."""
    from repro_torch.configs import get_config
    over = dict(overrides)
    cfg = get_config(arch)
    if "num_layers" in over:
        cfg = at_depth(cfg, over.pop("num_layers"))
    return dataclasses.replace(cfg, **over)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def one_rank_decode(cfg, params, prompts: np.ndarray, new: int,
                    device) -> dict:
    """The one-rank run the mesh runs are held to: greedy decode on
    ``device``, no mesh; tokens, f32 logits, top-two gaps, ms a step."""
    import torch
    from repro_torch.launch.serve import CACHE_MARGIN, _decode_init
    from repro_torch.models.lm import get_model
    model = get_model(cfg)
    b, s = prompts.shape
    toks, logits, gaps, times = [], [], [], []
    with torch.inference_mode():
        state = _decode_init(model, b, s + new + CACHE_MARGIN, 0, device)
        nxt = torch.as_tensor(prompts, device=device)
        for _ in range(new):
            sync(device)
            t0 = time.perf_counter()
            lg, state = model.decode_step(params, nxt, state)
            sync(device)
            times.append(time.perf_counter() - t0)
            lg32 = lg.float()
            top2 = torch.topk(lg32, 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            logits.append(lg32.cpu().numpy())
            nxt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            toks.append(nxt.cpu().numpy())
    return {"tokens": np.concatenate(toks, 1), "logits": logits,
            "gaps": np.stack(gaps, 1), "step_ms": [t * 1e3 for t in times]}


def leaf_layout(plans, names: tuple) -> dict:
    """{path: (spec, local shape)} of the plans whose leaf is in
    ``names``, stacked layer dims dropped."""
    from repro_torch.launch.sharding import map_with_path
    out = {}

    def one(path, plan):
        leaf = path.split("/")[-1]
        if leaf in names:   # one layer's leaf: rank 3 (experts) or 2
            n = len(plan.shape) - (3 if leaf.startswith("experts") else 2)
            out[path] = (str(plan.spec[n:]), list(plan.local_shape[n:]))
    map_with_path(one, plans)
    return out


def moe_vs_one_rank(mesh, device) -> dict:
    """deepseek's MoE layer at its published width (bf16; 160 experts
    split along f, 2 shared) forward and backward on this mesh over
    ``MESH_MOE_SHAPE`` tokens, data rank di on rows [di·B/D, (di+1)·B/D),
    against one rank's run of the whole batch: the (1, 3) and the (2, 3)
    worlds' check.  In turns, each rank draws the full layer, input and
    output weights from seed ``SEED + 9``, runs it alone over the whole
    batch (the global batch that routing sees) with the output weights of
    the other data ranks' rows zeroed (the gradients of its own rows'
    loss, which the mesh's training step sums over the data group) and
    keeps its own rows and blocks: one rank's full layer and gradients on
    the card at a time.  Then every rank runs its blocks on its rows on
    the mesh.  Returns each leaf's (largest error, largest one-rank
    |value|), the layout, the local shapes and the mesh run's peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import tree_param_shardings, use_mesh
    from repro_torch.models import moe
    from repro_torch.models.common import make_generator, model_dtype
    from repro_torch.models.scan_util import tree_map
    cfg = get_config(MESH_MOE_ARCH)
    n = MESH_MOE_SHAPE[0] // mesh.shape["data"]
    rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)

    def fwd_bwd(p, x, w):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
        xg = x.detach().requires_grad_(True)
        out = moe.moe_forward(leaves, cfg, xg)
        flat = {"router": leaves["router"], "x": xg,
                **{k: leaves[k] for k in ("experts_w1", "experts_w2",
                                           "experts_w3")},
                **{f"shared/{k}": v for k, v in leaves["shared"].items()}}
        g = torch.autograd.grad((out.float() * w.float()).sum(),
                                list(flat.values()))
        return out.detach(), dict(zip(flat, g))

    mine = local = plans = None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            gen = make_generator(SEED + 9, device)
            mp = moe.init_moe(gen, cfg)
            x = torch.randn((*MESH_MOE_SHAPE, cfg.d_model), generator=gen,
                            device=gen.device).to(model_dtype(cfg))
            w = torch.randn(x.shape, generator=gen,
                            device=gen.device).to(x.dtype)
            plans = tree_param_shardings(mesh, mp)

            def plan_of(k):
                return plans["shared"][k[7:]] if k.startswith("shared/") \
                    else plans.get(k)
            own = torch.zeros_like(w)
            own[rows] = w[rows]
            out, g = fwd_bwd(mp, x, own)
            g["x"] = g["x"][rows]
            mine = (out[rows].clone(),
                    {k: (plan_of(k).local(v) if plan_of(k) else v)
                     for k, v in g.items()},
                    {k: largest_abs(v) for k, v in g.items()})
            local = {k: plans[k].local(v) for k, v in mp.items()
                     if k != "shared"}
            local["shared"] = {k: plans["shared"][k].local(v)
                               for k, v in mp["shared"].items()}
            x, w = x[rows].clone(), w[rows].clone()
            del mp, out, g, own
            free_card()
        dist.barrier(group=mesh.host_group)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with use_mesh(mesh):
        out, g = fwd_bwd(local, x, w)
        split = moe.expert_layout(cfg)
    # the mesh run's peak (the one-rank blocks kept for the check in it),
    # read before the check's f32 temporaries
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    return {"errs": layer_errs(out, g, *mine), "split": split,
            "peak_gb": peak,
            "layout": {k: list(local[k].shape) for k in THREE_EXPERT_SHAPES}}


def largest_abs(t) -> float:
    """max |t| without a temporary the size of ``t``."""
    import torch
    lo, hi = torch.aminmax(t)
    return max(abs(float(lo)), abs(float(hi)))


def largest_diff(a, b) -> float:
    """max |a - b| in f32, over slices of the first dim of at most 2^24
    elements: the six ranks of the (2, 3) world check at once, and f32
    copies of whole expert blocks (1.68 GB each) ran the card out of
    memory beside the script's own process."""
    if a.dim() == 0:
        return float((a.float() - b.float()).abs())
    n = max(1, (1 << 24) // max(1, a[0].numel()))
    return max(float((a[i:i + n].float() - b[i:i + n].float()).abs().max())
               for i in range(0, a.shape[0], n))


def layer_errs(out, g: dict, one_out, one_g: dict, scale: dict) -> dict:
    """{name: (largest |mesh - one rank|, largest one-rank |value|)} of a
    layer's output and gradients (this rank's rows and blocks)."""
    errs = {"out": (largest_diff(out, one_out), largest_abs(one_out))}
    for k, v in g.items():
        errs[k] = (largest_diff(v, one_g[k]), scale[k])
    return errs


def mla_vs_one_rank(mesh, device) -> dict:
    """deepseek's MLA layer at its published width (bf16, 128 heads) on
    this mesh, forward and backward over ``MESH_MOE_SHAPE`` tokens, data
    rank di on its rows, against one rank's run of the whole batch with
    the other rows' output weights zeroed (as :func:`moe_vs_one_rank`).  A
    model axis of 3 does not divide the 128 heads: every rank attends over
    all of them, ``q_up`` a column block gathered whole, the rest as the
    rule table lays it out.  Every rank draws the layer (0.3 GB) from seed
    ``SEED + 10`` and runs the one-rank layer itself."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import tree_param_shardings, use_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models.common import make_generator, model_dtype
    from repro_torch.models.transformer import token_positions
    cfg = get_config(MESH_MOE_ARCH)
    n = MESH_MOE_SHAPE[0] // mesh.shape["data"]
    rows = slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)
    gen = make_generator(SEED + 10, device)
    p = attn.init_attn(gen, cfg)
    x = torch.randn((*MESH_MOE_SHAPE, cfg.d_model), generator=gen,
                    device=gen.device).to(model_dtype(cfg))
    w = torch.randn(x.shape, generator=gen, device=gen.device).to(x.dtype)
    pos = token_positions(*MESH_MOE_SHAPE, 0, gen.device)

    def fwd_bwd(p, x, w, pos):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        xg = x.detach().requires_grad_(True)
        out = attn.attn_forward(leaves, cfg, xg, pos)[0]
        names = sorted(leaves)
        g = torch.autograd.grad((out.float() * w.float()).sum(),
                                [leaves[k] for k in names] + [xg])
        return out.detach(), dict(zip(names + ["x"], g))

    own = torch.zeros_like(w)
    own[rows] = w[rows]
    one_out, one_g = fwd_bwd(p, x, own, pos)
    one_g["x"] = one_g["x"][rows]
    scale = {k: largest_abs(v) for k, v in one_g.items()}
    plans = tree_param_shardings(mesh, p)
    local = {k: plans[k].local(v) for k, v in p.items()}
    one_g = {k: plans[k].local(v) if k in plans else v
             for k, v in one_g.items()}
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with use_mesh(mesh):
        out, g = fwd_bwd(local, x[rows], w[rows], pos[rows])
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    return {"errs": layer_errs(out, g, one_out[rows], one_g, scale),
            "split": sorted(k for k, pl in plans.items() if pl.axes),
            "peak_gb": peak,
            "layout": {k: list(local[k].shape) for k in SIX_MLA_SHAPES}}


def six_layers_rank(mesh, device) -> dict:
    """A card rank of the (2, 3) world (``lm-serve-mesh``): deepseek's
    MLA layer and then its MoE layer at their published widths on the
    mesh against one rank's (:func:`mla_vs_one_rank`,
    :func:`moe_vs_one_rank`), and the rank's kernel launches."""
    import torch
    out = {"rank": mesh.rank, "mla_layer": mla_vs_one_rank(mesh, device)}
    if torch.device(device).type == "cuda":
        free_card()
    out["moe_layer"] = moe_vs_one_rank(mesh, device)
    out["launches"] = {k: c.value for k, c in lm_counters().items()}
    return out


def serve_mesh_rank(mesh, device, runs: tuple, moe_layer: bool) -> dict:
    """A card rank of ``lm-serve-mesh`` (module docstring): for each run,
    the same seeded weights on every rank, drawn and sharded one rank at a
    time; rank 0 decodes them alone first; then ``mesh_generate`` decodes the
    batch teacher-forced by rank 0's tokens, under the collectives
    recorder; with ``moe_layer``, :func:`moe_vs_one_rank` last."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.collectives import recording
    from repro_torch.launch.mesh import broadcast_object
    from repro_torch.launch.serve import mesh_generate
    from repro_torch.models.lm import get_model
    from repro_torch.models.lm_params import shard_params
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 runs in f32
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "runs": {}}
    for key, arch, over, _, b, prompt, new in runs:
        cfg = serve_mesh_cfg(arch, over)
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (b, prompt)).astype(np.int32)
        cuda = device.type == "cuda"
        one = None
        # in turns, so that one rank's full weights are on the card at a
        # time (three ranks' full deepseek would not fit beside each other)
        for turn in range(mesh.size):
            if turn == mesh.rank:
                params = get_model(cfg).init(SEED, device=device)
                if mesh.leader:
                    one = one_rank_decode(cfg, params, prompts, new, device)
                local, plans = shard_params(params, mesh, cfg)
                del params
                if cuda:
                    free_card()
            dist.barrier(group=mesh.host_group)
        one = broadcast_object(one, mesh.host_group)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        with recording() as log:
            gen = mesh_generate(cfg, local, plans, mesh, prompts, new,
                                device=device, keep_logits=True,
                                forced=one["tokens"][:, :-1])
        sync(device)
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if cuda and clear:   # cuBLAS's workspaces are the library's, not args
            clear()
        arg_bytes = torch.cuda.memory_allocated() if cuda else 0
        per_call = len(log) // new
        step_log = log[-per_call:] if per_call else []
        out["runs"][key] = {
            "tokens": gen.tokens, "logits": gen.logits, "one": one,
            "layout": gen.layout, "step_ms": [t * 1e3 for t in gen.step_s],
            "leaves": leaf_layout(plans, (
                "experts_w1", "experts_w2", "experts_w3", "q_up", "k_up",
                "v_up", "wo")) if cfg.mla is not None else {},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda
            else 0.0,
            "arg_bytes": arg_bytes,
            "step_log": [(r["op"], r["bytes"], r["group"], r["site"])
                         for r in step_log],
            "calls": len(log)}
        del local, plans, gen
        if cuda:
            free_card()
    if moe_layer:
        out["moe_layer"] = moe_vs_one_rank(mesh, device)
    out["launches"] = {k: c.value for k, c in lm_counters().items()}
    return out


def serve_mesh_check(key: str, rank: dict, rows: np.ndarray,
                     tie: float, f32: bool) -> dict:
    """One rank's run against rank 0's one-rank run: the largest logit
    difference (teacher-forced, every step) and the greedy flips, each
    allowed only where one rank's top-two gap is within ``tie`` (in f32
    the logits too must lie within it)."""
    run = rank["runs"][key]
    one = run["one"]
    err = max(float(np.abs(lg - one["logits"][i][rows]).max())
              for i, lg in enumerate(run["logits"]))
    flips = np.argwhere(run["tokens"] != one["tokens"][rows])
    gaps = [float(one["gaps"][rows][r, t]) for r, t in flips]
    return {"max_abs_logit_err": err, "flips": len(flips),
            "flip_gaps": gaps[:8], "max_flip_gap": max(gaps, default=0.0),
            "ok": all(g <= tie for g in gaps) and (not f32 or err <= tie)}


def phase_lm_serve_mesh(only=None) -> dict:
    """The LM zoo served on a mesh of ranks on ``cuda:0`` over gloo
    (module docstring): each run held to one rank's.  ``only``: the
    (data, model) worlds to run (None: all of them)."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.sharding import ShardPlan, spec_for
    counters, t0 = lm_phase_start()
    worlds: dict = {}
    runs_here = [r for r in SERVE_MESH_RUNS if only is None or r[3] in only]
    for run in runs_here:
        worlds.setdefault(run[3], []).append(run)
    ranks, failures = {}, []
    for (d, m), runs in worlds.items():
        t1 = time.perf_counter()
        ranks[(d, m)] = run_ranks(
            "chip_smoke:serve_mesh_rank", data=d, model=m,
            devices=["cuda:0"] * (d * m), backend=MESH_BACKEND,
            args=(tuple(runs), (d, m) == SERVE_MESH_THREE),
            timeout_s=SERVE_MESH_DEADLINE_S)
        log("lm-serve-mesh-world", mesh=(d, m),
            seconds=round(time.perf_counter() - t1, 1))
    for key, arch, over, (d, m), b, prompt, new in runs_here:
        cfg = serve_mesh_cfg(arch, over)
        tie = SERVE_MESH_TIE[cfg.dtype]
        for r in ranks[(d, m)]:
            run = r["runs"][key]
            view = r_mesh_view(d, m, r["rank"])
            rows = ShardPlan(view, spec_for(view, ("batch", None), (b, 1)),
                             (b, 1)).local(torch.arange(b)[:, None])
            rows = rows.reshape(-1).numpy()
            chk = serve_mesh_check(key, r, rows, tie, cfg.dtype == "float32")
            calls_step = run["calls"] // new
            log("lm-serve-mesh", run=key, arch=arch, dtype=cfg.dtype,
                layers=cfg.num_layers,
                mesh=(d, m), rank=r["rank"], batch=b, prompt=prompt,
                new_tokens=new, layout=run["layout"],
                prefill_ms=round(run["step_ms"][0], 2),
                ms_per_token=round(float(np.median(run["step_ms"][1:])), 3),
                one_rank_prefill_ms=round(run["one"]["step_ms"][0], 2),
                one_rank_ms_per_token=round(float(np.median(
                    run["one"]["step_ms"][1:])), 3),
                collectives_per_step=calls_step,
                collective_mb_per_step=round(sum(
                    x[1] for x in run["step_log"]) / 1e6, 4),
                peak_gb=round(run["peak_gb"], 3), tie_bound=tie, **chk)
            if not chk["ok"]:
                failures.append(f"{key} rank {r['rank']}: flips {chk}")
            if run["leaves"]:
                log("lm-serve-mesh-leaves", run=key, rank=r["rank"],
                    **{k.replace("/", "."): v
                       for k, v in run["leaves"].items()})
    for r in ranks.get(SERVE_MESH_THREE, []):
        failures += mesh_layer_check("lm-serve-mesh-moe", SERVE_MESH_THREE,
                                     r, "moe_layer", "hidden",
                                     THREE_EXPERT_SHAPES)
    if only is None or SIX_MESH in only:
        t1 = time.perf_counter()
        d, m = SIX_MESH
        ranks[SIX_MESH] = run_ranks(
            "chip_smoke:six_layers_rank", data=d, model=m,
            devices=["cuda:0"] * (d * m), backend=MESH_BACKEND,
            timeout_s=SERVE_MESH_DEADLINE_S)
        log("lm-serve-mesh-world", mesh=SIX_MESH,
            seconds=round(time.perf_counter() - t1, 1))
        for r in ranks[SIX_MESH]:
            failures += mesh_layer_check("lm-mesh-six-mla", SIX_MESH, r,
                                         "mla_layer", SIX_MLA_SPLIT,
                                         SIX_MLA_SHAPES)
            failures += mesh_layer_check("lm-mesh-six-moe", SIX_MESH, r,
                                         "moe_layer", "hidden",
                                         THREE_EXPERT_SHAPES)
    launches = {k: sum(r["launches"][k] for rs in ranks.values()
                       for r in rs) for k in lm_counters()}
    counts, _ = lm_phase_end("lm-serve-mesh", counters, t0)
    log("lm-serve-mesh-launches", rank_launches=launches)
    if any(launches.values()):
        failures.append(f"kernels launched on the ranks: {launches}")
    if failures:
        raise AssertionError(f"lm-serve-mesh: {failures}")
    return launches, ranks


def mesh_layer_check(tag: str, mesh: tuple, rank: dict, key: str, split,
                     layout: dict) -> list:
    """Log one rank's full-width layer ``rank[key]`` (forward and backward
    against one rank's: each within ``MESH_MOE_TOL`` of its one-rank
    largest |value|, the rule of ``lm-train-mesh-moe``), its layout and
    local shapes, which must be ``split`` and ``layout``; the failures."""
    ml = rank[key]
    bad = [k for k, (err, scale) in ml["errs"].items()
           if not err <= MESH_MOE_TOL * scale]
    log(tag, arch=MESH_MOE_ARCH, rank=rank["rank"], mesh=mesh,
        tokens=MESH_MOE_SHAPE[0] * MESH_MOE_SHAPE[1],
        tokens_a_rank=MESH_MOE_SHAPE[0] * MESH_MOE_SHAPE[1] // mesh[0],
        split=ml["split"], local_shapes=ml["layout"],
        max_abs_err={k: e for k, (e, _) in ml["errs"].items()},
        max_abs={k: v for k, (_, v) in ml["errs"].items()},
        tol_of_max_abs=MESH_MOE_TOL, peak_gb=round(ml["peak_gb"], 3),
        ok=not bad)
    out = [f"{mesh} {key} rank {rank['rank']}: {k}" for k in bad]
    if ml["layout"] != layout or ml["split"] != split:
        out.append(f"{mesh} {key} rank {rank['rank']}: layout "
                   f"{ml['split']} {ml['layout']}")
    return out


def r_mesh_view(d: int, m: int, rank: int):
    """What ``ShardPlan.local`` reads of rank ``rank``'s view of (d, m)."""
    import types
    coord = {"data": rank // m, "model": rank % m}
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": d, "model": m},
                                 index=lambda a: coord[a])


# ---------------------------------------------------------------------------
# dryrun / dryrun-gnn: the port's dry-run on the card's host
# ---------------------------------------------------------------------------

def dryrun_main() -> int:
    """The ``dryrun`` and ``dryrun-gnn`` phases (module docstring), run by
    :func:`start_dryrun` in a process of their own on the host's CPU
    while the card runs the other phases: ``meta`` tensors over a
    ``fake`` world, no device work."""
    sys.path.insert(0, str(ROOT / "src"))
    phase_dryrun()
    phase_dryrun_gnn()
    return 0


def start_dryrun():
    """(process, its output file): :func:`dryrun_main` started now."""
    import tempfile
    out = tempfile.TemporaryFile("w+")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.dryrun_main())"], cwd=ROOT, env=env,
        stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish_dryrun(proc, out, t_start: float) -> None:
    """Wait for the background dry-run, print its lines, fail if it did."""
    left = DRYRUN_DEADLINE_S - (time.perf_counter() - t_start)
    try:
        rc = proc.wait(timeout=max(left, 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at its deadline"
    out.seek(0)
    text = out.read()
    out.close()
    sys.stdout.write(text)
    log("dryrun-process", rc=rc,
        wall_s=round(time.perf_counter() - t_start, 1))
    if rc != 0:
        raise RuntimeError(f"dryrun: exit {rc}\n{text[-4000:]}")


def phase_dryrun() -> dict:
    """Every applicable (arch x shape) cell of the 16x16 mesh counted, and
    each arch's ``MULTIPOD_SHAPE`` cell of the 2x16x16 mesh run with no
    counts (module docstring)."""
    from repro_torch.configs import SHAPES, get_config, list_archs
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline.analysis import H100_SXM
    t0 = time.perf_counter()
    recs, failures = {}, []
    for multi in (False, True):
        for arch in list_archs():
            for shape in (MULTIPOD_SHAPE,) if multi else SHAPES:
                mdt = "bfloat16" if get_config(arch).fsdp else "float32"
                try:
                    rec = run_cell(arch, shape, multi, opt_moment_dtype=mdt,
                                   probe=not multi)
                except Exception as e:           # reported, then raised
                    failures.append(f"{arch} x {shape} x {multi}: {e!r}")
                    continue
                recs[(arch, shape, multi)] = rec
                fields = {"arch": arch, "shape": shape,
                          "mesh": rec.get("mesh"), "status": rec["status"]}
                if rec["status"] == "ok":
                    fields.update(
                        arg_gb=round(rec["arg_bytes_per_device"] / 1e9, 3),
                        count_s=rec["count_s"])
                    if rec["roofline"]:
                        r = rec["roofline"]
                        fields.update(
                            dominant=r["dominant"],
                            compute_s=r["compute_s"], memory_s=r["memory_s"],
                            collective_s=r["collective_s"],
                            peak_gb=round(rec["peak_bytes_per_device"]
                                          / 1e9, 3),
                            fits_80gb=rec["fits_hbm"],
                            roofline_fraction=r["roofline_fraction"])
                else:
                    fields["reason"] = rec["reason"]
                log("dryrun", **fields)
    log("dryrun-done", cells=len(recs), hw=H100_SXM.name,
        seconds=round(time.perf_counter() - t0, 1))
    if failures:
        raise AssertionError(f"dryrun: {failures}")
    return recs


def phase_dryrun_gnn() -> None:
    """The GNS engine's step at ogbn-papers100M's dimensions on both
    production meshes (``launch/dryrun_gnn.py``)."""
    from repro_torch.launch import dryrun_gnn
    for multi in (False, True):
        rec = dryrun_gnn.run(multi_pod=multi)
        r = rec["roofline"]
        log("dryrun-gnn", mesh=rec["mesh"], dp_groups=rec["dp_groups"],
            dominant=r["dominant"], compute_s=r["compute_s"],
            memory_s=r["memory_s"], collective_s=r["collective_s"],
            cache_mb_per_chip=round(rec["cache_bytes_per_chip"] / 1e6, 2),
            upload_gb_per_gen=round(rec["upload_bytes_per_gen_sharded"]
                                    / 1e9, 3),
            local_hit=rec["lookup_local_frac_locality"],
            input_rows=rec["input_rows_per_batch"], count_s=rec["count_s"])
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun-gnn: {rec}")


# ---------------------------------------------------------------------------
# roofline-calib: the dry-run held to the real step on the card
# ---------------------------------------------------------------------------

def phase_roofline_calib(serve_ranks: dict) -> None:
    """gemma-2b trained at 2 x 1,024 on one rank: the dry-run's (1, 1)
    counts against the same counter over the real CUDA step, its peak
    against ``max_memory_allocated``, the measured step against the
    roofline; qwen2-7b's (1, 2) serving ranks against the dry-run's
    prediction of their arg bytes and collectives (module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import cell_step, count_step
    from repro_torch.launch.mesh import dryrun_mesh
    from repro_torch.launch.sharding import arch_scope, use_mesh
    from repro_torch.models.scan_util import tree_leaves
    from repro_torch.roofline.analysis import (H100_SXM, model_flops,
                                               roofline_terms,
                                               collective_bytes)
    counters, t0 = lm_phase_start()
    cfg = get_config(CALIB_ARCH)
    shape = ShapeSpec("calib", CALIB_SEQ, CALIB_BATCH, "train")
    with dryrun_mesh((1, 1)) as mesh, arch_scope(cfg):
        run, arg, _, n_active, _ = cell_step(cfg, shape, mesh, "float32")
        meta, meta_log = count_step(run, mesh)
        run, _, _, _, args = cell_step(cfg, shape, mesh, "float32",
                                       device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for t in tree_leaves(args[0]):
            t.normal_(0.0, 0.02, generator=gen)
        for t in tree_leaves(args[2]):
            t.random_(0, cfg.vocab_size, generator=gen)
        batch_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(args[2]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        real, real_log = count_step(run, mesh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        with use_mesh(mesh):
            run()                                     # warm
            ms = cuda_ms_n(run, 3)
    pred_peak = arg + batch_bytes + meta.peak_bytes
    terms = roofline_terms(float(meta.flops), float(meta.bytes),
                           collective_bytes(meta_log), cfg, shape, 1,
                           hw=H100_SXM, n_active=n_active)
    mf = model_flops(cfg, shape, n_active=n_active)
    frac = mf / (ms / 1e3 * H100_SXM.peak_flops)
    log("roofline-calib", arch=cfg.name, batch=CALIB_BATCH, seq=CALIB_SEQ,
        flops_dryrun=meta.flops, flops_card=real.flops,
        bytes_dryrun=meta.bytes, bytes_card=real.bytes,
        ops_dryrun=meta.ops, ops_card=real.ops,
        peak_pred_gb=round(pred_peak / 1e9, 4),
        peak_card_gb=round(peak / 1e9, 4),
        peak_rel_err=round(abs(pred_peak - peak) / peak, 5),
        peak_margin=CALIB_PEAK_MARGIN, step_ms=round(ms, 3),
        compute_s=terms.compute_s, memory_s=terms.memory_s,
        dominant=terms.dominant, model_flops=mf,
        measured_roofline_fraction=round(frac, 5),
        bound_over_step=round(max(terms.compute_s, terms.memory_s) * 1e3
                              / ms, 5))
    failures = []
    if (meta.flops, meta.bytes) != (real.flops, real.bytes):
        failures.append(f"counts dry-run {meta.as_dict()} card "
                        f"{real.as_dict()}")
    if abs(pred_peak - peak) > CALIB_PEAK_MARGIN * peak:
        failures.append(f"peak {pred_peak} vs {peak}")
    del run, args
    free_card()
    failures += calib_serving(serve_ranks)
    lm_phase_end("roofline-calib", counters, t0)
    if failures:
        raise AssertionError(f"roofline-calib: {failures}")


def cuda_ms_n(fn, reps: int) -> float:
    """Median ms of ``reps`` calls of ``fn`` by CUDA events."""
    import torch
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def calib_serving(serve_ranks: dict) -> list:
    """qwen2-7b's (1, 2) serving ranks: each rank's measured allocation
    with its parameters and decode state against the dry-run's arg bytes
    for the same shapes, and its decode step's collectives against the
    dry-run's log of that step."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import cell_step, count_step
    from repro_torch.launch.mesh import dryrun_mesh
    from repro_torch.launch.serve import CACHE_MARGIN
    from repro_torch.roofline.analysis import collective_bytes
    key, arch, over, (d, m), b, prompt, new = SERVE_MESH_RUNS[0]
    cfg = serve_mesh_cfg(arch, over)
    shape = ShapeSpec("serve", prompt + new + CACHE_MARGIN, b, "decode")
    failures = []
    for r in serve_ranks[(d, m)]:
        with dryrun_mesh((d, m), rank=r["rank"]) as mesh:
            run, arg, *_ = cell_step(cfg, shape, mesh, "float32")
            _, pred_log = count_step(run, mesh)
        run_r = r["runs"][key]
        pred = [(x["op"], x["bytes"], x["group"], x["site"])
                for x in pred_log]
        pred_b = collective_bytes(pred_log)["total"]
        got_b = collective_bytes([{"op": o, "bytes": nb, "group": g}
                                  for o, nb, g, _ in run_r["step_log"]])[
            "total"]
        err = abs(run_r["arg_bytes"] - arg) / arg
        log("roofline-calib-serve", arch=arch, mesh=(d, m), rank=r["rank"],
            arg_pred_gb=round(arg / 1e9, 4),
            arg_card_gb=round(run_r["arg_bytes"] / 1e9, 4),
            arg_rel_err=round(err, 6), arg_margin=CALIB_ARG_MARGIN,
            coll_calls_pred=len(pred), coll_calls_card=len(run_r["step_log"]),
            coll_wire_mb_pred=round(pred_b / 1e6, 4),
            coll_wire_mb_card=round(got_b / 1e6, 4),
            same_log=pred == run_r["step_log"])
        if err > CALIB_ARG_MARGIN or pred != run_r["step_log"]:
            failures.append(f"{arch} rank {r['rank']}: arg {arg} vs "
                            f"{run_r['arg_bytes']}, logs equal "
                            f"{pred == run_r['step_log']}")
    return failures


def main() -> int:
    clock = PhaseClock()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    card = nvidia_smi()
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    phase_analysis()
    clock("analysis")
    dryrun, t_dryrun = start_dryrun(), time.perf_counter()
    try:
        return run_phases(card, clock, dryrun, t_dryrun)
    finally:
        if dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()


def run_phases(card: str, clock: PhaseClock, dryrun: tuple,
               t_dryrun: float) -> int:
    """Phases 1 onward (module docstring), the dry-run running beside
    them in its own process; ``clock`` ticks after each."""
    import torch
    from repro_torch.kernels._ext import load_kernels
    t0 = time.perf_counter()
    load_kernels()
    log("build", seconds=round(time.perf_counter() - t0, 1))
    phase_kbuild()
    clock("build")

    from repro_torch.gns import GNSEngine
    from repro_torch.graph.datasets import get_dataset

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    preset = train_config("device").data
    ds = get_dataset(preset.name, scale=preset.scale, seed=preset.seed)
    engine = build_engine(ds)
    engine.ensure_cache(np.random.default_rng(SEED))
    log("engine", nodes=engine.ds.graph.num_nodes,
        train_nodes=len(engine.ds.train_idx),
        cache_rows=engine.store.generation.table.shape[0],
        seconds=round(time.perf_counter() - t0, 1))
    clock("engine")
    shapes = serving_shapes(engine, rng)
    errs = phase_parity(engine, shapes, rng)
    clock("parity")
    counts = {"serve": phase_serve(engine, rng)}
    clock("serve")
    phase_engine_parity(engine, rng)
    clock("engine-parity")
    counts["fabric"], fabric_waves = phase_fabric(engine, rng)
    clock("fabric")
    counts["tcp"], tcp_p99_ms = phase_tcp(engine, fabric_waves)
    clock("tcp")
    counts["stream"] = phase_stream(rng)
    clock("stream")

    dev_engine = GNSEngine(train_config("device"), dataset=ds)
    host_engine = GNSEngine(train_config("fused"), dataset=ds)
    k3_shapes = device_shapes(dev_engine, rng)
    k3_errs = phase_k3_parity(k3_shapes, rng)
    clock("k3-parity")
    counts["train_device"] = phase_train(
        dev_engine, "device", epochs=2, max_batches=None, eval_batches=2,
        expect="gns_sample_agg")["counts"]
    clock("train-device")
    phase_profile(dev_engine, rng, "device")
    clock("profile")
    counts["train_host_fused"] = phase_train(
        host_engine, "host_fused", epochs=1, max_batches=2, eval_batches=1,
        expect="cache_lookup_agg")["counts"]
    clock("train-host-fused")
    phase_train_parity(ds, train_config("device", PARITY_BATCH),
                       "train-parity")
    clock("train-parity")
    k1_shapes = {"train": host_train_batch(host_engine, rng)}
    counts["train_baselines"], baseline_engines = phase_baselines(ds)
    clock("baselines")
    phase_train_parity(ds, baseline_config("ladies", PARITY_BATCH),
                       "baseline-parity")
    clock("baseline-parity")
    phase_checkpoint(dev_engine, ds)
    clock("checkpoint")
    phase_describe({"serve": engine, "train_device": dev_engine,
                    "train_host_fused": host_engine,
                    **{f"baseline_{k}": v
                       for k, v in baseline_engines.items()}})
    k1_shapes["ladies"] = host_train_batch(baseline_engines["ladies"], rng)
    del baseline_engines
    clock("describe")

    k4_errs = phase_k4_parity()
    clock("k4-parity")
    counts["lm_serve"] = phase_lm_serve()
    clock("lm-serve")
    phase_lm_parity()
    clock("lm-parity")
    counts["lm_train"] = phase_lm_train()
    clock("lm-train")
    counts["lm_train_dec"] = phase_lm_train_dec()
    clock("lm-train-dec")
    counts["lm_train_moe"] = phase_lm_train_moe()
    clock("lm-train-moe")
    counts["lm_serve_dec"] = phase_lm_serve_dec()
    clock("lm-serve-dec")
    counts["lm_train_xlstm"] = phase_lm_train_xlstm()
    clock("lm-train-xlstm")
    counts["lm_train_zamba2"] = phase_lm_train_zamba2()
    clock("lm-train-zamba2")
    counts["lm_serve_rec"] = phase_lm_serve_rec()
    clock("lm-serve-rec")
    counts["lm_serve_moe"] = phase_lm_serve_moe()
    clock("lm-serve-moe")
    counts["lm_serve_sc"] = phase_lm_serve_dense(SC_ARCH, "lm-serve-sc")
    clock("lm-serve-sc")
    counts["lm_serve_vlm"] = phase_lm_serve_dense(VLM_ARCH, "lm-serve-vlm")
    clock("lm-serve-vlm")
    counts["lm_train_vlm"] = phase_lm_train_vlm()
    clock("lm-train-vlm")
    counts["lm_train_sc"] = phase_lm_train_sc()
    clock("lm-train-sc")
    phase_lm_train_parity()
    clock("lm-train-parity")
    counts["mesh"] = phase_mesh(ds)
    clock("mesh")
    counts["mesh_serve"] = phase_mesh_serve(ds)
    clock("mesh-serve")
    counts["tcp_mesh"] = phase_mesh_rpc(ds, tcp_p99_ms)
    clock("mesh-serve-e")
    free_card()
    counts["lm_train_mesh"] = phase_lm_train_mesh()
    clock("lm-train-mesh")
    counts["vocab_cache"] = phase_vocab_cache()
    clock("vocab-cache")
    free_card()
    counts["lm_serve_mesh"], serve_ranks = phase_lm_serve_mesh()
    clock("lm-serve-mesh")
    finish_dryrun(*dryrun, t_dryrun)
    clock("dryrun-wait")
    phase_roofline_calib(serve_ranks)
    clock("roofline-calib")
    counts["dryrun"] = {k: 0 for k in lm_counters()}
    rows = (phase_times(engine, shapes, errs, counts)
            + phase_train_times(k3_shapes, k3_errs, k1_shapes, counts)
            + phase_k4_times(k4_errs, counts))
    clock("times")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
