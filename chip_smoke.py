"""Drive the PyTorch/CUDA port on one NVIDIA card: the GP suggestion
service, the paper's §4 HPO loop (in process, over HTTP from worker
processes, and through a sharded fleet that loses a shard), the LM
server (recurrentgemma-2b; the MoE family: granite-moe-3b-a800m and
deepseek-v2-lite-16b; the encoder-decoder whisper-medium and the
parallel-block command-r-plus-104b; the VLM llava-next-34b and the xLSTM
xlstm-125m), the error-feedback int8 all-reduce, and LM training (one
model, a population of trials in one program, and the MoE,
encoder-decoder, parallel-block, VLM and xLSTM families), and the mesh
tooling (a dry run over fake 256- and 512-rank groups, a sharded train
step).

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON object per line; any failure raises, so the
script exits non-zero and prints no result):

1. card and build — the card's name and power limit, torch and CUDA
   versions, and the nvcc build of every kernel under
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once);
   ptxas's registers and spill bytes for each compiled function, and the
   count of ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in
   the flash-attention library's SASS (``cuobjdump -sass``), in the whole
   library and in each of its bf16 functions (the forward, the backward's
   dK/dV and dQ kernels, one a head dim), and of ``LDGSTS`` (cp.async) in
   gp_ei's and rglru_scan's, which fails the run when any is 0.
2. kernels against their plain PyTorch versions on the card —
   ``gp_nll_chol``, ``gp_fit_grads`` through the autograd backward, and
   ``gp_ei`` over k lanes x b bucket (ragged masks, inert all-zero-mask
   lanes), each with its error, its time by CUDA events, its bound, the
   plain version's time and, where one PyTorch call computes the same
   function, that call's time; ``gp_nll_chol`` and ``gp_fit_grads`` also
   at b = 1024 and 2048 (k = 1 and 4) and at b = 1024 with 20 dimensions,
   held to the float64 oracle (no further from it than 1e-3 or twice the
   plain version); ``gp_ei`` alone also at b = 1024, 2048 and 6016 (the
   first bucket whose V tile is past shared memory: V in global scratch,
   held to the float64 oracle as ``gp_nll_chol`` is past b = 512) and at
   ragged shapes (b = 37 and 100, m = 1001), every ``gp_ei`` case
   beside ``torch.linalg.solve_triangular`` on the same substitution
   (``trsm_ms``); at k = 1, b = 512 a plain EI whose panel 8 skips its
   update from the panels above must fail the limit;
   then the GP numerics on the card against the same numerics on the CPU
   at a small size, and the host wall time of each GP call of the ask
   path at the paper's size, one thread alone.  Last, the thread probe
   (``phase_thread_memory``): fresh threads each run one op on the card
   (an elementwise pass, a product, ``cholesky_ex`` on one matrix and on
   4 lanes of 512, ``solve_triangular``), two rounds an op, and the
   card's memory outside PyTorch's allocator is read around each round:
   what a thread's library handles hold, and whether a later thread
   reuses them.  ``card_memory`` lines (``free_card``) report it, as
   ``outside_gb``, after every phase and around the service's
   construction and teardown.
3. the service at the paper's size — 4 concurrent ``gp`` experiments on
   one ``LocalClient`` with the prefetch pump on, each with the paper's
   budget of 300 and parallel 15 over the 3-parameter CNN space, driven
   by worker threads that suggest, evaluate a cheap deterministic
   objective (held for ``TRIAL_SECONDS`` as a trial would be) and
   observe.  The kernels' launch counters are zeroed just
   before and read just after.
3b. the paper's §4 loop — first one batch of the CNN (``models/cnn.py``)
   on the card against the same batch on the CPU from the same
   parameters (logits, loss and every gradient within 1e-4 by relative
   norm) and ``train_cnn``'s ms a step; then ``Orchestrator.run`` with a
   cluster pool ``gpu`` of 30 chips and two experiments at once, each
   ``examples/hpo_cnn.py`` at ``--paper`` scale (budget 300, parallel 15,
   ``gp``, ASHA from step 9 at eta 3, seeds 0 and 1), each trial training
   the CNN for 40 steps on its lease's card; the fit executor has one
   worker, and ``RefitPairing`` makes the two experiments' refits meet
   in one dispatch once (the loop alone seldom co-batches them).  It fails unless both
   complete their budgets with no failed trial and no repeated
   suggestion id, each best accuracy is above 3/43, no executor job
   failed and no pump died, ``gp_ei`` and ``gp_nll`` launched (counters
   zeroed just before) and a refit dispatch co-batched the two; it
   records wall time, trials a second, suggest latency as the scheduler
   sees it (a timing wrapper around the client), the ASHA outcomes and
   peak device memory.
3c. the §4 run over the wire, the paper's own topology — ``serve_api`` on
   the card in this process, and one worker process a seed, each the
   port's CLI (``cluster create`` of a pool ``gpu`` of 15 chips, then
   ``run --service URL --cluster``) running 3b's experiment with the
   trial ``chip_smoke:cnn_trial`` (``examples/hpo_cnn.py``'s, on its
   lease's card); no ``RefitPairing``.  First an idle worker's
   ``Orchestrator`` is probed in a process of its own: it must start no
   thread and hold no tensor on the card.  It fails unless both workers
   exit 0, the service holds exactly 300 observations an experiment with
   no repeated suggestion id and no failed trial (nor any in the
   workers' stores), each best accuracy is above 3/43, no executor job
   failed and no pump died, and ``gp_ei`` launched in the service; it
   records wall time, trials a second, the service's suggest latency
   (a timing wrapper around its backend: the wire left out), its hits
   and misses, ``gp_nll`` launches and co-batched dispatches, the card's
   utilization, host cores and device memory per process, and a
   worker's trial seconds a step.
3d. the fleet with a shard failover — ``serve_fleet`` with two shards on
   the card in this process, four ``gp`` experiments at the paper's
   budget and parallelism over the same space, each driven by
   ``Orchestrator.run(fleet=URL)`` with phase 3's stand-in trial; once a
   third of all observations are in, the listener of the shard owning
   the most experiments is shut.  It fails unless the experiments were
   on both shards, the manager counts one dead shard and maps it no
   more, every experiment completes exactly its budget with no repeated
   suggestion id and no duplicate observation, the survivor serves every
   adopted experiment, ``gp_ei`` launched after the failover (counters
   zeroed there) and no executor job failed; it records wall time,
   detection (shut to dead) and adoption (dead to the survivor's first
   suggestion for each adopted experiment, its cold refit included).
4. the LM kernels against their plain PyTorch versions on the card —
   ``flash_attention`` at the serve shape (B 4, S 3000, H 10, K 1, D 256,
   window 2048) in bf16 and f32, at S = 4096, at granite-8b's shape, with
   a softcap, ragged (Sq != Skv, not tile multiples) and at D = 64 and 16
   in both types, with 4 query heads a KV head and a window at D = 128,
   and at D = 32 in both types (``gqa_ragged_d32``: a head dim between the
   instantiated ones, which the wrapper zero-pads to 64);
   ``rglru_scan`` at the serve shape, a ragged one, S = 1, S = one time
   tile + 1 and R = 999 (4-byte staging), and at the serve shape a plain
   scan that drops the carry into every tile after the first must fail
   its limit — each with its
   error, its time by CUDA events, its bound, the plain version's time and
   ``F.scaled_dot_product_attention``'s (band mask, ``enable_gqa``) as the
   library yardstick for attention.  Attention is held element by element
   against the float32 oracle on the same inputs, and at the serve shape
   three faults planted into the plain version (a key or the oldest tile
   of the band missing, no window) must fail that limit.  Then
   (``flash_offsets``) ``flash_attention`` on one rank's quarter of a
   sequence's queries at ``q_offset`` against the whole sequence's keys,
   as a sequence-parallel step calls it, at the middle and the last
   quarter of llava's layout (S 3328, H 56, K 8, D 128) and of
   recurrentgemma's windowed one (S 3000, H 10, K 1, D 256, window
   2048), bf16: held to the plain float32 version at the same offset,
   the plain version at offset 0 planted as a fault, timed beside the
   same call at offset 0, the plain version, SDPA (the offset band as a
   mask) and the offset's bound; launches counted.
4b. ``flash_attention`` at the MoE family's prefill layouts, bf16, B 4,
   S 3000, causal: granite-moe-3b-a800m's (H 24, K 8, D 64) and
   deepseek-v2-lite-16b's MLA (H = K = 16, q/k 192 and v 128 zero-padded
   to 256, scale 1/sqrt(192)), held element by element to the float32
   oracle with phase 4's limit, the padded output columns zero, a planted
   fault (MLA at the padded head's own scale, 1/16) failing the limit;
   timed beside the plain version and SDPA on the unpadded layout under
   the first backend that takes it (named in the line); the bound counts
   the unpadded work.
4c. ``flash_attention`` at the encoder-decoder family's and the parallel
   block's prefill layouts, bf16, B 4: whisper-medium's encoder (S 1536,
   H = K = 16, D 64, non-causal), its cross-attention (384 queries over
   1536 keys, non-causal) and its decoder's self-attention (S 384,
   causal), and command-r-plus-104b's (S 3000, H 96, K 8, D 128, causal),
   held element by element to the float32 oracle with phase 4's limit, a
   planted fault each failing it (made causal, made non-causal, KV heads
   shifted by one); timed beside the plain version, SDPA (the first
   backend that takes the layout, causal or not as the layout is) and
   the bound.
4d. ``flash_attention`` at llava-next-34b's prefill layout (B 4, S 3328:
   2304 image positions and a 1024-token prompt, H 56, K 8, D 128,
   causal) in bf16 and float32, held and timed as 4c's layouts are (the
   planted fault: KV heads shifted by one).
5. the LM server at full width — ``serve("recurrentgemma-2b", batch=4,
   prompt_len=3000, gen=64, reduced=False)`` with random weights from its
   seed: exactly 8 ``flash_attention`` and 18 ``rglru_scan`` launches in
   the prefill and none in decode (counters zeroed just before, read just
   after); then the same weights and prompts once more with the two ops
   swapped for their plain versions, and once in float32 with the plain
   versions, both fed the served tokens: the kernel path may be no
   further from the float32 model than 1.25x the plain bf16 path's
   distance from it (bf16's own error on these weights sets the scale)
   by relative norm at the output of every attention and RG-LRU layer of
   the prefill, and 2x by max |logits| at the prefill and every decode
   step.
   A fault planted in each kernel's place (attention with no window,
   the scan one step late) must fail the per-layer limit; whether the
   logits limit sees it is recorded.  Last, one more prefill and 8
   decode steps under torch.profiler: the device's busy time and idle
   share, and its kernels by device time.
5b. the MoE family served at full width and depth — ``serve(arch,
   batch=4, prompt_len=3000, gen=64, reduced=False)`` for
   granite-moe-3b-a800m and deepseek-v2-lite-16b, random weights from the
   seed: exactly one ``flash_attention`` launch an attention layer in the
   prefill (32 and 27) and none in decode, finite logits, prefill ms,
   decode tokens a second, peak memory and the share of (token, choice)
   pairs dropped by capacity (spied at ``moe.slots``); then at full width
   and reduced depth (granite-moe 2 layers; deepseek 3, its dense layer
   and two MoE layers) the kernel path against the plain bf16 path and a
   float32 model of the same weights, prefill and 4 decode steps fed the
   kernel path's tokens: every attention and MoE layer of the prefill by
   relative norm and the logits by max |.| at ``LAYER_FACTOR`` and
   ``LOGITS_FACTOR`` times the plain bf16 path's distance, the share
   of router choices that differ from the float32 model's, and planted
   faults (a capacity of 1, every choice shifted one expert on, MLA at
   the padded head's scale) failing the layer limit.
5c. whisper-medium and command-r-plus-104b served at full width —
   ``serve(arch, batch=4, gen=64, reduced=False)``, random weights from
   the seed: whisper at full depth (24 encoder + 24 decoder layers) over
   1536 stub frames with prompt 384 (448 in all, its decoder's context),
   command-r with prompt 3000 at 8 of its 64 layers (serve's config
   lookup cut to 8; the cut is printed), each with exactly 72 and 8
   ``flash_attention`` launches a prefill and none in decode, finite
   logits, prefill ms, decode tokens a second and peak memory; one more
   prefill and 8 decode steps of each under torch.profiler; then the
   hold at full width (whisper at full depth, command-r at depth 2): the
   kernel path against the plain bf16 path (its attention one batch row
   at a time) and a float32 model of the same weights, every attention
   and cross-attention layer of the prefill within ``LAYER_FACTOR`` and
   the logits within ``LOGITS_FACTOR`` of the plain path's distance from
   float32, and planted faults (the encoder run causal, cross-attention
   fed the decoder's own hidden state, sinusoidal positions shifted by
   one; command-r run as sequential blocks) failing the layer limit.
5d. llava-next-34b and xlstm-125m served at full width — ``serve(arch,
   batch=4, gen=64, reduced=False)``, random weights from the seed:
   llava with 2304 stub patch embeddings and prompt 1024 at 30 of its 60
   layers (the cut is printed), its cache n_img + prompt + gen = 3392
   positions, exactly 30 ``flash_attention`` launches a prefill; xlstm
   at full depth with prompt 3000 and no kernel launch at all (the
   reference has no kernel for its blocks); none in decode, finite
   logits, prefill ms, decode tokens a second, peak memory, and for
   xlstm the share of the prefill its 3 sLSTM layers' per-step loops
   take and what one launches a step; one more prefill and 8 decode
   steps of each under torch.profiler; then the hold (llava at depth 2,
   xlstm at full depth): every attention (llava) or mLSTM / sLSTM block
   (xlstm) output of the prefill within ``LAYER_FACTOR`` and the logits
   within ``LOGITS_FACTOR`` of the plain bf16 path's distance from
   float32, planted faults (the prefix dropped from the text's K/V, the
   text's positions counted from 0; the mLSTM state reset each chunk,
   the sLSTM recurrence zeroed) failing the layer limit, and in float32
   the prefill and 4 decode steps within 1e-3 of max |logits| of one
   ``forward`` over the same tokens.
6. the error-feedback int8 all-reduce — (a) ``int8_quantize`` against its
   plain version, bit for bit (codes and scales), at the gradient tree's
   largest leaf (the 256 000 x 2560 embedding), ragged and short inputs,
   NaN and inf blocks (scale NaN / inf, codes 0) and one buffer of
   2^31 + 1000 elements, each timed beside its bound; (b)
   ``compressed_psum_tree`` over recurrentgemma-2b's full gradient tree
   (308 float32 leaves, 2.894 B elements), world size 1 over NCCL, 3 steps
   carrying the error: exactly 308 kernel launches a step (counter zeroed
   just before), reduced and new error bit for bit against the plain
   path, the reference test's drift bound, ms a step and peak memory; (c)
   4 gloo ranks on the one card over the reduced tree, 3 steps: each
   rank's launches, its new error bit for bit, its reduced tensor within
   4 float32 ulps of the float64 mean of the ranks' sent tensors.
6d. AdamW's kernels (``csrc/adamw.cu``) alone, at the state of
   granite-moe-3b-a800m at depth 4 (42 leaves, 478.4 M parameters a
   trial): four trials stacked with float32 gradients under vmap, each
   with its own lr and decoupled decay (the population's), and one trial
   with bf16 gradients and the coupled decay (the single trial's).  One
   update of the whole state: its launches (one a leaf), the norm within
   1e-6 of the plain one, the largest leaf and the small ones against the
   plain update at the kernel's norm (within 1e-6), two runs bit for bit;
   then its time by CUDA events beside its bound (``adamw_work`` and
   ``sumsq_work`` over the state, at 3.35 TB/s) and the plain update's
   time (under vmap for the four trials, as the parent ran it).

8. LM training (run right after phase 1, while the card holds nothing
   else: the population needs ~65 GB of it; each part first frees what
   was left and reports the card's memory, as the later phases do) —
   (a) the two backward kernels against their plain versions:
   ``flash_attention_bwd`` at the train shape (B 1, S 3000, H 10, K 1,
   D 256, window 2048, no softcap) in bf16 and f32, in bf16 at D 256
   with two KV heads and two batches (H 8, K 2, S 1000, window 512) and
   at the population's folded shape (B 3, S 1024), at S = 1, 65 and
   1000, grouped-query (H 4, K 2, D 64), windows 0 and 32, softcap 30
   (q, k of std 4 so the cap bends), D 16 and 128 and non-causal, and
   MLA's scale 1/sqrt(192) at H = K = 16, D 256, and D 32 (padded to 64
   by the wrapper) in both types, held element by element
   to the plain float32 backward of the same inputs (``FLASH_TOL`` and a
   floor, ``bwd_excess``), the kernel's lse within 1e-4 of the plain one,
   and planted faults (the oldest key of the window dropped, the softcap
   dropped, dK/dV from one query head of a group, the default scale in
   MLA's place) failing that limit; ``rglru_scan_bwd`` at (1, 3000, 2560),
   S = 1, 65 and R = 999 within 1e-5 of the largest gradient, a plain
   backward with no carry between tiles failing it; each with its time
   by CUDA events, its bound, the plain version's time and, for
   attention, SDPA's backward (band mask, ``enable_gqa``).
   (b) ``launch.train.train("recurrentgemma-2b", reduced=False, batch=1,
   seq=3000, steps=4, warmup=2)``: all 26 layers, bf16 compute, f32
   masters, remat "full"; exactly 16 ``flash_attention``, 8
   ``flash_attention_bwd``, 36 ``rglru_scan``, 18 ``rglru_scan_bwd`` and
   308 ``adamw`` launches a step (one update a parameter leaf; counts read
   around each step), finite losses and
   gradient norms; each step's ms, tokens a second, peak memory (with
   ``--train``, the last step under torch.profiler).  (c) one step at full width and depth 3:
   the kernel path's loss and per-leaf gradients against the plain bf16
   path and the float32 model (``GRAD_FACTOR``, ``LOSS_FACTOR``).  (d)
   ``PopulationTrainer``: 3 trials at full width, depth 3, batch 1 x
   1024, each with its own lr, weight decay and seed, 4 steps, twice: at
   the config's own remat "full" (each layer's forward recomputed in the
   backward: 2 / 1 / 4 / 2 launches a step for all trials) and at remat
   "none" (one launch of each kernel a layer a step), 37 ``adamw``
   launches a step for all trials at both; trial-steps a
   second and peak memory of each; then each trial alone through the
   same step unbatched at the same remat, every loss within ``POP_TOL``
   of the population's.
   (e) ``flash_attention_bwd`` at the seven layouts the MoE,
   encoder-decoder, parallel-block and VLM families train at (B 1, the
   train_4k sequence of 4096, bf16): granite-moe's (H 24, K 8, D 64),
   MLA's (H = K = 16, q/k 192 and v 128 zero-padded to 256, scale
   1/sqrt(192)), whisper-medium's encoder (S 1536, non-causal),
   cross-attention (4096 queries over 1536 keys, non-causal) and decoder
   self-attention (H = K = 16, D 64), command-r's (H 96, K 8, D 128) and
   llava's (H 56, K 8, D 128), each held as (a) holds its cases, a
   planted fault each (dK/dV from one query head of a group, the default
   scale in MLA's place, causality flipped) failing the limit, timed
   beside the plain version, the bound and SDPA's backward (no mask,
   ``is_causal``, ``enable_gqa``; MLA on its unpadded widths); and
   ``flash_attention_bwd`` at phase 4's offset layouts, held and timed
   as phase 4 holds the forward there.  (f) one
   ``loss_and_grads`` a family at full width and reduced depth
   (``FAMILY_HOLDS``: granite-moe 2, deepseek 2, whisper's decoder 2 over
   its 24 encoder layers, command-r 2 at seq 1024, llava 2, xlstm whole
   at seq 512; batch 1 from ``concrete_inputs``) through the kernels,
   their plain versions in bf16 and float32, as (c) holds
   recurrentgemma's (the dense oracle's autograd path reported); the
   MoE pair's later runs replay the kernel run's router choices (the
   share of choices that would have flipped is reported); exactly two
   forward and one backward launch an attention call (whisper: 24
   encoder, 2 self and 2 cross); a planted fault each failing it.  (g)
   three AdamW steps a family at full width, bf16 compute, float32
   masters, remat "full", batch 1 (``FAMILY_TRAIN``: granite-moe whole at
   4096, deepseek at 4 of 27 layers, whisper whole, llava at 4 of 60
   layers over 2304 image and 1792 text positions, xlstm whole at seq
   1024), the token-only families through ``launch.train.train``,
   whisper and llava through ``launch.steps.make_train_step`` on
   ``concrete_inputs`` batches: exactly two forward and one backward
   ``flash_attention`` launch an attention call a step, finite losses;
   ms a step, tokens a second and peak memory.  command-r-plus-104b takes
   no step: one layer and its tied table are 75.5 GB of state.  (h) the
   families' populations at full width and remat "full", held as (d)
   holds (``POP_FAMILIES``): granite-moe at depth 2 and deepseek at depth
   2 (the MoE dispatch, MLA under vmap), whisper whole over 1536 float
   frames and llava at depth 1 over 2304 float image positions, batch 1
   from ``concrete_inputs``; two forward and one backward launch an
   attention call a step for all trials; whisper's and llava's
   populations fed their float inputs cast to integers (as the trainer
   once fed them) must miss the hold at the first step.

9. the mesh and sharding tooling, right after 8g — (a) the dry run
   (``launch/dryrun.py``) of ``DRYRUN_CELLS``, every arch x shape on the
   16x16 pod mesh but xlstm-125m's ``train_4k`` and ``prefill_32k`` and
   recurrentgemma-2b ``train_4k`` on 2x16x16, each cell one step on a
   fake process group of 256 or 512 ranks over meta tensors in a pool of
   host processes: every cell ``ok`` or skipped with the reference's
   reason, command-r ``train_4k``'s argument bytes a device equal to
   ``sharded_bytes`` of its state recomputed here; each cell's dominant
   term, roofline fraction, argument bytes and trace seconds; with the
   sequence sharded (the batch short of the mesh), command-r-plus-104b
   ``prefill_32k``'s bound at most ``SEQ_PREFILL_BOUND_S`` and
   phi3-medium-14b ``decode_32k``'s peak at most ``SEQ_DECODE_PEAK_ARGS``
   times its argument bytes, or the run fails.  (b) 8b's
   step sharded over a one-card mesh (NCCL world 1; ``state_specs``,
   ``batch_specs``, ``activation_sharding``, ``grad_specs``) from the
   same state as an unsharded step run just before: loss and parameters
   bit for bit (else within 1e-6 of the largest, the first differing
   leaf named), 16 / 8 / 36 / 18 launches (the layers' ``local_map``
   regions reached the kernels), warm steps timed, one step under the cost analyser whose
   H100 bound may not exceed the measured step; roofline fraction,
   useful ratio, peak memory.  (c) 4 gloo ranks on a (2, 2) mesh
   (``launch/shard_check.py``), reduced recurrentgemma-2b and
   granite-moe-3b-a800m in float32, 2 sharded AdamW steps within 1e-5
   of the largest parameter of the same steps unsharded, a planted fault
   (each region's weight gradients taken as summed over the batch
   shards) past it, and the collectives ``CommDebugMode`` saw equal to
   the cost analyser's count on a fake (2, 2) group; the same at batch
   2, which leaves "model" to the sequence (the step sequence-parallel),
   with a second fault (the gathered keys' and values' gradients taken
   as summed); and the split decode (``shard_check.run_decode_ranks``):
   a sequence-parallel prefill and 3 decode steps over a cache sharded on
   its slots, for global attention, the local ring buffer and MLA's
   latent in two cache layouts, within 1e-5 of the unsharded path, the
   chunks attended alone (never combined) past it.  On CPU tensors,
   since a gloo group's functional all-gather (DTensor's) dies on CUDA
   tensors with no code of the port (``--gloo-cuda``).

7. device times — ``gp_ei`` at every case of phase 2 and ``rglru_scan``
   at every case of phase 4 again, on the same inputs, by torch.profiler:
   the kernels' own time, which at small shapes the CUDA-event time of a
   wrapper call (the host's) hides; each beside its CUDA-event time.
   Last, after every end-to-end run.

The last lines are the kernels' summary, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --device-times   # phase 7 alone

runs only phase 7 (each kernel built at its first call) and prints its
lines and the card: the same cases on another checkout's kernels, for
comparing two trees on one card.

    python3 chip_smoke.py --hpo N          # phase 3b alone, N times

runs the §4 loop N times, each with its own checks, and prints each run's
line, how many passed and the card: how often the refits co-batch.

    python3 chip_smoke.py --remote         # phases 3c and 3d alone

runs the remote topology and the fleet failover (the kernels build at
their first call in the service) and prints their lines and the card.

    python3 chip_smoke.py --moe            # phases 1, 4b and 5b alone

builds the kernels, runs the MoE family's attention cases and serving
and prints their lines and the card.

    python3 chip_smoke.py --encdec         # phases 1, 4c and 5c alone

builds the kernels, runs the encoder-decoder and parallel-block attention
cases and serving and prints their lines and the card.

    python3 chip_smoke.py --vlm            # phases 1, 4d and 5d alone

builds the kernels, runs llava's attention cases and the VLM and xLSTM
serving and prints their lines and the card.

    python3 chip_smoke.py --train          # phases 1 and 8a-8d alone

builds the kernels, runs LM training's checks and prints their lines and
the card.

    python3 chip_smoke.py --population     # phases 1, 8d and 8h alone

builds the kernels, runs the populations (recurrentgemma-2b at remat
"full" and "none", the families at "full") with their holds and prints
their lines and the card.

    python3 chip_smoke.py --train-families # phases 1 and 8e-8g alone

builds the kernels, runs the other families' training checks (the
backward at their layouts, their gradient holds, their train steps) and
prints their lines and the card.

    python3 chip_smoke.py --offsets        # phase 1, 4's and 8e's offsets

builds the kernels, runs the flash kernels' sequence-parallel cases (a
quarter of the queries at ``q_offset``, forward and backward:
``flash_offsets``) and prints their lines and the card.

    python3 chip_smoke.py --shard          # phases 1 and 9 alone

builds the kernels, runs the mesh tooling's checks (the dry run, the
sharded step on the card, the 4 gloo ranks) and prints their lines and
the card.

    python3 chip_smoke.py --serve          # phases 1, 5, 5b and 5c alone
    python3 chip_smoke.py --shard --serve  # the same after phase 9

builds the kernels and serves recurrentgemma-2b, the MoE family,
whisper-medium and command-r-plus-104b (their prefill ms and decode
tokens/s), after phase 9 when asked: what phase 9 leaves behind for the
phases after it.

    python3 chip_smoke.py --adamw          # phases 1 and 6d alone

builds the kernels, runs AdamW's kernels at the benchmark's state and
prints their lines and the card.

    python3 chip_smoke.py --gloo-cuda      # where gloo fails on CUDA

runs each collective a sharded step issues alone on gloo ranks, on CUDA
and on CPU tensors, then 9c's check on CUDA tensors at one rank and at
four, and prints each one's exit codes and first error or crash stack.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import card_pool  # noqa: E402

#: published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W), and
#: the work formulas every bound divides by them, from the package
from repro_torch.distributed.roofline import (  # noqa: E402
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS)
from repro_torch.kernels.work import (  # noqa: E402
    adamw_work, ei_work, flash_bwd_work, flash_work, nll_work, q8_work,
    scan_bwd_work, scan_work, sumsq_work)

KS = (1, 4, 8, 16)
BS = (16, 64, 256, 512)
#: buckets past the paper's budget, for gp_ei alone (k = 1): 6016 is the
#: first whose V tile (b x 8 floats) no longer fits a block's shared
#: memory at d = 3 (5984 does), so V lives in global scratch
EI_BS = (1024, 2048, 6016)
#: the largest bucket at which gp_ei is held to its plain version; past
#: it, to the float64 oracle (``ei_case``)
EI_PLAIN_MAX_B = 2048
#: (k, b, m) for gp_ei alone at ragged shapes: b = 37 leaves its last panel
#: 5 rows and its rows not 16-byte aligned (4-byte staging), b = 100 a
#: 4-row last panel; m = 1001 a last tile of one candidate
EI_RAGGED = ((3, 37, 1001), (2, 100, 1001))
#: the panel whose update the planted gp_ei fault skips at MAIN_EI
EI_FAULT_PANEL = 8
D = 3
M = 1280            # candidate pool on the path: 1024 + 1024 // 4
#: buckets past the paper's budget for gp_nll_chol and gp_fit_grads, at
#: k = 1 and 4 lanes: the gradients under the same float64 check as
#: b = 512, (nll, L, z) under the same form of it (``nll_case``)
NLL_BS = (1024, 2048)
NLL_KS = (1, 4)
#: (k, b, d) with more points x dimensions than the kernel stages in
#: shared memory (16384), so its covariance takes the unstaged path
NLL_WIDE = (1, 1024, 20)
MAIN_NLL = (4, 512)  # (lanes, bucket) of a 4-experiment co-batched refit
MAIN_EI = (1, 512)   # one lane per exact ask, history in bucket 512
#: how long one trial runs in phase 3: the §4 CNN trains for minutes;
#: three seconds keep 4 x 300 trials (20 rounds of 15) near a minute
#: while leaving the service idle gaps between observations, as it has
#: in use, for its pump and its shared fit executor (at one second the
#: 60 trials outrun the service and every suggest is a miss)
TRIAL_SECONDS = 3.0
#: phase 3b, the paper's §4 run: ``examples/hpo_cnn.py --paper`` (budget
#: 300, parallel 15, 40 steps a trial) for each seed, both experiments at
#: once on one orchestrator; the time they may take
HPO_BUDGET = 300
HPO_PARALLEL = 15
HPO_STEPS = 40
HPO_SEEDS = (0, 1)
HPO_TIMEOUT_S = 600
#: relative-norm limit of the CNN on the card against the CPU (float32
#: both, TF32 off: cuDNN's and the CPU's convolutions sum in other orders)
CNN_LIMIT = 1e-4

#: instructions each library's SASS must hold: the bf16 flash kernel's
#: wgmma (HGMMA) and TMA loads (UTMALDG); gp_ei's and rglru_scan's
#: cp.async staging (LDGSTS)
SASS_OPS = {"flash_attention": ("HGMMA", "UTMALDG"), "gp_ei": ("LDGSTS",),
            "rglru_scan": ("LDGSTS",)}
#: and each function of a library whose name holds one of these parts, one
#: instantiation a head dim the kernels take: the bf16 attention kernels,
#: the forward and the backward's dK/dV and dQ, each on wgmma fed by TMA
SASS_FUNCTION_OPS = {"flash_attention": {
    "flash_tc_kernel": ("HGMMA", "UTMALDG"),
    "dkdv_tc_kernel": ("HGMMA", "UTMALDG"),
    "dq_tc_kernel": ("HGMMA", "UTMALDG")}}

RESULTS = {}
#: the card's name and power limit (``card_line``), set by ``main``: every
#: line ``emit`` prints and writes names it
CARD = None
#: the script's start: every line carries its seconds since (``at_s``)
T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    fields = dict(fields, at_s=time.perf_counter() - T0)
    if CARD is not None:
        fields = dict(fields, card=CARD)
    RESULTS.setdefault(phase, []).append(fields)
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of ``obj`` for the length of a ``with`` block."""
    old = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(obj, name, value)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| (max-norm relative error)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


def time_ms(fn, budget_s: float = 0.15) -> float:
    """Mean device time of ``fn`` by CUDA events over warmed launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t0, 1e-6)
    iters = int(min(200, max(3, budget_s / one)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names, n: int = 20) -> float:
    """Device time a call of ``fn`` spends in the kernels whose names hold
    one of ``names``, by torch.profiler over n warmed calls: the kernels'
    own time, where ``time_ms`` of a small call reads the host's.  Only
    after the end-to-end phases: once started, the profiler can slow
    later host-bound work (phase 5's decode read slower in runs that had
    profiled before it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a trace can come back without the kernels' records (seen once on
    # the card, at a 6 us kernel after many traces): trace up to 3 times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and any(k in e.name for k in names))
        if us > 0:
            break
    check(us > 0, f"the profiler saw none of {names}")
    return us / 1e3 / n


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ------------------------------------------------------------- phase 1
def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_card():
    card = card_line()
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    t0 = time.perf_counter()
    _build.build_all()
    wall = time.perf_counter() - t0
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_wall_s=wall, build_s=dict(_build.build_seconds))
    for name, log in _build.ptxas_report.items():
        emit("ptxas", kernel=name, functions=ptxas_functions(log))
    # the bf16 flash kernels, forward and backward, must run on the tensor
    # cores, fed by TMA, and gp_ei and rglru_scan must stage through cp.async
    for lib, ops in SASS_OPS.items():
        sass = subprocess.run(
            [_build.tool("cuobjdump"), "-sass",
             str(_build.library_path(lib))],
            capture_output=True, text=True, timeout=120)
        check(sass.returncode == 0, f"cuobjdump: {sass.stderr.strip()}")
        counts = {op: len(re.findall(rf"\b{op}\b", sass.stdout))
                  for op in ops}
        emit("sass", library=lib, counts=counts)
        check(all(counts.values()), f"{lib} SASS lacks {counts}")
        functions = sass_functions(sass.stdout)
        for part, fops in SASS_FUNCTION_OPS.get(lib, {}).items():
            found = {name: {op: len(re.findall(rf"\b{op}\b", text))
                            for op in fops}
                     for name, text in functions.items() if part in name}
            emit("sass", library=lib, function=part, counts=found)
            check(len(found) == len(HEAD_DIMS),
                  f"{lib}: {len(found)} functions named {part}, expected "
                  f"one a head dim of {HEAD_DIMS}")
            check(all(all(c.values()) for c in found.values()),
                  f"{lib}: a {part} lacks one of {fops}: {found}")
    return card


def sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` output cut into its functions: mangled name ->
    that function's instructions."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return {n: "\n".join(lines) for n, lines in out.items()}


def ptxas_functions(log: str):
    """``-Xptxas -v`` per compiled function: its registers and spill
    bytes (stores, loads), mangled names kept."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.append(dict(function=name, spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2))))
        m = re.search(r"Used (\d+) registers", line)
        if m and out and "registers" not in out[-1]:
            out[-1]["registers"] = int(m.group(1))
    return out


# ------------------------------------------------------------- phase 2
def gp_case(k: int, b: int, seed: int, dev, d: int = D):
    """k lanes over a b bucket of d-dimensional points: ragged masks
    (prefix sizes spread over [2, b]), the last lane inert (all-zero mask)
    when k > 1, and hyperparameters over the reference tests' ranges."""
    rng = np.random.default_rng(seed)
    x = rng.random((k, b, d))
    y = rng.standard_normal((k, b))
    mask = np.zeros((k, b))
    for i in range(k):
        n = b if i == 0 else int(rng.integers(2, b + 1))
        if k > 1 and i == k - 1:
            n = 0
        mask[i, :n] = 1.0
    ll = rng.uniform(-1.5, 0.5, (k, d))
    la = rng.uniform(-0.5, 0.5, (k,))
    ln = rng.uniform(-3.0, -1.0, (k,))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return tuple(t(a) for a in (ll, la, ln, x, y, mask))


def nll_case(k: int, b: int, dev, d: int = D):
    """``gp_nll_chol`` and ``gp_fit_grads`` at k lanes over a b bucket
    against their plain versions, checked and timed -> (fields, max abs
    error, the case's inputs)."""
    from repro_torch.kernels import gp as kgp
    from repro_torch.kernels import ops, ref
    lim = 1e-4 if b <= 64 else 1e-3
    ll, la, ln, x, y, mask = gp_case(k, b, seed=1000 * k + b + d - D,
                                     dev=dev, d=d)
    # gp_nll_chol: kernel vs plain
    nll, L, z = kgp.gp_nll_chol(ll, la, ln, x, y, mask)
    torch.cuda.synchronize()
    p_nll, p_L, p_z = kgp.gp_nll_chol_plain(ll, la, ln, x, y, mask)
    errs = {"nll": rel_err(nll, p_nll), "L": rel_err(L, p_L),
            "z": rel_err(z, p_z)}
    abs_err = max(float((nll - p_nll).abs().max()),
                  float((L - p_L).abs().max()),
                  float((z - p_z).abs().max()))
    errs64 = p_errs64 = None
    if b in BS:
        check(all(math.isfinite(e) and e <= lim for e in errs.values()),
              f"gp_nll_chol k={k} b={b}: {errs} > {lim}")
    else:
        # past the paper's buckets both float32 factorizations drift from
        # the float64 one by more than 1e-3 (z = L^-1 y·m at a condition
        # number near 1e6), so the outputs are held to it as the
        # gradients are: no further than 1e-3 or twice the plain version
        o64 = kgp.gp_nll_chol_plain(*(a.double() for a in
                                      (ll, la, ln, x, y, mask)))
        errs64 = {n: rel_err(a.double(), w) for n, a, w in
                  zip(("nll", "L", "z"), (nll, L, z), o64)}
        p_errs64 = {n: rel_err(a.double(), w) for n, a, w in
                    zip(("nll", "L", "z"), (p_nll, p_L, p_z), o64)}
        check(all(math.isfinite(errs64[n])
                  and errs64[n] <= max(lim, 2.0 * p_errs64[n])
                  for n in errs64),
              f"gp_nll_chol k={k} b={b} from f64: {errs64} against "
              f"plain {p_errs64}")
        del o64
    del nll, L, z, p_nll, p_L, p_z
    # gp_fit_grads through the autograd backward vs the oracle.
    # Both are float32 derivations through an explicit K^-1 whose
    # condition number reaches ~1e6 here, so each is also held
    # against the float64 oracle: the kernel path may be no
    # further from it than 1e-3 or twice the plain version.
    g = ops.gp_fit_grads(ll, la, ln, x, y, mask)
    torch.cuda.synchronize()
    g_ref = ref.gp_nll_grads_ref(ll, la, ln, x, y, mask)
    g64 = ref.gp_nll_grads_ref(*(a.double() for a in
                                 (ll, la, ln, x, y, mask)))
    g_err = max(rel_err(a, w) for a, w in zip(g, g_ref))
    g_err64 = max(rel_err(a.double(), w) for a, w in zip(g, g64))
    p_err64 = max(rel_err(a.double(), w) for a, w in zip(g_ref, g64))
    g_lim = max(1e-3, 2.0 * p_err64)
    check(math.isfinite(g_err64) and g_err64 <= g_lim,
          f"gp_fit_grads k={k} b={b}: {g_err64} > {g_lim} from f64")
    for lane in range(k):
        if float(mask[lane].sum()) == 0.0:    # inert lane
            check(all(float(a[lane].abs().max()) == 0.0 for a in g),
                  f"inert lane {lane} has nonzero gradients")
    del g, g_ref, g64
    # times and bounds
    cov = ref.masked_cov(ll, la, ln, x, mask)
    n_bound, n_by = bound_ms(*nll_work(k, b, d))
    fields = dict(
        k=k, b=b, d=d, limit=lim, nll_rel_err=errs,
        nll_rel_err_f64=errs64, plain_nll_rel_err_f64=p_errs64,
        grads_rel_err=g_err,
        grads_rel_err_f64=g_err64, plain_grads_rel_err_f64=p_err64,
        gp_nll_ms=time_ms(lambda: kgp.gp_nll_chol(ll, la, ln, x, y, mask)),
        gp_nll_plain_ms=time_ms(
            lambda: kgp.gp_nll_chol_plain(ll, la, ln, x, y, mask)),
        cholesky_ex_ms=time_ms(lambda: torch.linalg.cholesky_ex(cov)),
        gp_nll_bound_ms=n_bound, gp_nll_bound_by=n_by,
        gp_fit_grads_ms=time_ms(lambda: ops.gp_fit_grads(ll, la, ln, x, y,
                                                         mask)),
        gp_fit_grads_plain_ms=time_ms(lambda: ref.gp_nll_grads_ref(
            ll, la, ln, x, y, mask)))
    return fields, abs_err, (ll, la, ln, x, y, mask)


def ei_inputs(ll, la, ln, x, y, mask, m: int, seed: int):
    """``gp_ei``'s arguments for a case's lanes: the plain posterior
    factors, and (y_mean, y_std, cand (k, m, d), best) drawn from seed."""
    from repro_torch.kernels import ref
    chol = ref.cholesky(ref.masked_cov(ll, la, ln, x, mask))
    alpha = torch.cholesky_solve((y * mask)[..., None], chol)[..., 0]
    rng = np.random.default_rng(seed)
    k, _, d = x.shape
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=x.device)
    return tuple(a.contiguous() for a in (
        ll, la, x, mask, chol, alpha, t(rng.standard_normal(k)),
        t(rng.uniform(0.5, 2.0, k)), t(rng.random((k, m, d))),
        t(rng.standard_normal(k))))


def ei_case(args, lim: float):
    """``gp_ei`` against its plain version on ``args``, checked and timed,
    with ``torch.linalg.solve_triangular`` on the same substitution
    (V = L⁻¹kqᵀ over every lane, the part of EI that dominates) as its
    yardstick -> (fields, kernel ei, plain ei)."""
    from repro_torch.kernels import gp as kgp
    from repro_torch.kernels import ref
    ll, la, x, mask, chol = args[:5]
    cand = args[8]
    k, b, d = x.shape
    m = cand.shape[1]
    ei = kgp.gp_ei(*args)
    torch.cuda.synchronize()
    p_ei = ref.gp_ei_ref(*args)
    e_err = rel_err(ei, p_ei)
    e_err64 = p_err64 = None
    if b <= EI_PLAIN_MAX_B:
        check(math.isfinite(e_err) and e_err <= lim,
              f"gp_ei k={k} b={b} m={m}: {e_err} > {lim}")
    else:
        # past it the two float32 substitutions drift apart by more than
        # the limit (sum V^2 cancels against amp^2 as the bucket's
        # condition number grows), so each is held to the float64 oracle
        # on the same inputs, as nll_case holds gp_nll_chol past the
        # paper's buckets: no further from it than 1e-3 or twice the plain
        o64 = ref.gp_ei_ref(*(a.double() for a in args))
        e_err64 = rel_err(ei.double(), o64)
        p_err64 = rel_err(p_ei.double(), o64)
        check(math.isfinite(e_err64)
              and e_err64 <= max(lim, 2.0 * p_err64),
              f"gp_ei k={k} b={b} m={m} from f64: {e_err64} against plain "
              f"{p_err64}")
        del o64
    kq_t = (ref._matern52(cand, x, ll, la)
            * mask[:, None, :]).transpose(-1, -2).contiguous()
    e_bound, e_by = bound_ms(*ei_work(k, b, d, m))
    fields = dict(
        m=m, ei_limit=lim, ei_rel_err=e_err, ei_rel_err_f64=e_err64,
        plain_ei_rel_err_f64=p_err64,
        gp_ei_ms=time_ms(lambda: kgp.gp_ei(*args)),
        gp_ei_plain_ms=time_ms(lambda: ref.gp_ei_ref(*args)),
        gp_ei_bound_ms=e_bound, gp_ei_bound_by=e_by,
        trsm_ms=time_ms(lambda: torch.linalg.solve_triangular(
            chol, kq_t, upper=False)))
    return fields, ei, p_ei


def ei_blocked_plain(args, skip_panel: int = -1, nb: int = 32):
    """Plain EI with V = L⁻¹kqᵀ solved in panels of nb rows, the order of
    the kernel's panels: when ``skip_panel`` names one, that panel's
    update from the panels above it is left out (the planted fault)."""
    from repro_torch.kernels import ref
    ll, la, x, mask, chol, alpha, y_mean, y_std, cand, best = args
    kq = ref._matern52(cand, x, ll, la) * mask[:, None, :]
    mu = (kq @ alpha[..., None])[..., 0]
    rhs = kq.transpose(-1, -2)
    v = torch.zeros_like(rhs)
    for r0 in range(0, x.shape[1], nb):
        r1 = min(r0 + nb, x.shape[1])
        part = rhs[:, r0:r1]
        if r0 // nb != skip_panel:
            part = part - chol[:, r0:r1, :r0] @ v[:, :r0]
        v[:, r0:r1] = torch.linalg.solve_triangular(
            chol[:, r0:r1, r0:r1], part, upper=False)
    return ref.ei_closed_form(mu, v, la, y_mean, y_std, best)


def phase_kernels():
    dev = torch.device("cuda", 0)
    summary = {}
    for k in KS:
        for b in BS:
            lim = 1e-4 if b <= 64 else 1e-3
            nll_fields, abs_err, case = nll_case(k, b, dev)
            # gp_ei: kernel vs plain on the plain posterior factors
            ei_args = ei_inputs(*case, m=M, seed=k + b)
            ei_fields, ei, p_ei = ei_case(ei_args, lim)
            extra = {}
            if (k, b) == MAIN_EI:
                # the blocked plain order agrees; skipping one panel's
                # update must fail the limit
                extra["blocked_plain_rel_err"] = rel_err(
                    ei_blocked_plain(ei_args), p_ei)
                check(extra["blocked_plain_rel_err"] <= lim,
                      f"blocked plain EI: {extra['blocked_plain_rel_err']}")
                extra["planted_panel_skipped_rel_err"] = rel_err(
                    ei_blocked_plain(ei_args, EI_FAULT_PANEL), p_ei)
                check(extra["planted_panel_skipped_rel_err"] > lim,
                      f"planted fault (panel {EI_FAULT_PANEL} not updated) "
                      f"passes: {extra['planted_panel_skipped_rel_err']}")
            emit("kernel_case", **nll_fields, **ei_fields, **extra)
            if (k, b) == MAIN_NLL:
                summary["gp_nll"] = dict(
                    max_abs_err=abs_err, ms=nll_fields["gp_nll_ms"],
                    plain_ms=nll_fields["gp_nll_plain_ms"],
                    bound_ms=nll_fields["gp_nll_bound_ms"],
                    bound_by=nll_fields["gp_nll_bound_by"],
                    library_ms=nll_fields["cholesky_ex_ms"])
            if (k, b) == MAIN_EI:
                summary["gp_ei"] = dict(
                    max_abs_err=float((ei - p_ei).abs().max()),
                    ms=ei_fields["gp_ei_ms"],
                    plain_ms=ei_fields["gp_ei_plain_ms"],
                    bound_ms=ei_fields["gp_ei_bound_ms"],
                    bound_by=ei_fields["gp_ei_bound_by"], library_ms=None)
            torch.cuda.synchronize()
    for k, b, d in [(k, b, D) for k in NLL_KS for b in NLL_BS] + [NLL_WIDE]:
        emit("kernel_case_nll", **nll_case(k, b, dev, d)[0])
        torch.cuda.empty_cache()
    for k, b, m in [(1, b, M) for b in EI_BS] + list(EI_RAGGED):
        case = gp_case(k, b, seed=b if k == 1 else b + k, dev=dev)
        fields, _, _ = ei_case(ei_inputs(*case, m=m, seed=b),
                               1e-4 if b <= 64 else 1e-3)
        emit("kernel_case_ei", k=k, b=b, d=D, **fields)
        del case
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return summary


def phase_gp_parity():
    """The GP numerics on the card against the same numerics on the CPU
    (the plain paths) at a small size: a fit, a posterior, a q-EI batch
    through the ``gp_ei`` kernel and a co-batched fit through the
    ``gp_nll`` kernel."""
    from repro_torch.core.suggest import gp
    rng = np.random.default_rng(7)
    x = rng.random((40, D))
    y = np.sin(3.0 * x @ rng.random(D)) + 0.1 * rng.standard_normal(40)
    cuda = gp.fit_gp(x, y, steps=40, bucket=64, device="cuda")
    cpu = gp.fit_gp(x, y, steps=40, bucket=64, device="cpu")
    p_err = max(float(np.abs(gp._np(a) - gp._np(c)).max())
                for a, c in zip(cuda.params, cpu.params))
    check(p_err <= 1e-3, f"fit_gp card vs cpu params: {p_err}")
    post_cpu = gp.posterior_from_numpy(gp.to_numpy(cuda), device="cpu")
    cand = rng.random((M, D)).astype(np.float32)
    ei = gp.expected_improvement(cuda, cand, float(np.max(y)))
    ei_cpu = gp.expected_improvement(post_cpu, cand, float(np.max(y)))
    ei_err = float(np.abs(gp._np(ei) - gp._np(ei_cpu)).max())
    check(ei_err <= 1e-4 * max(1.0, float(np.abs(gp._np(ei_cpu)).max())),
          f"expected_improvement card vs cpu: {ei_err}")
    picks, _ = gp.select_batch(cuda, cand, float(np.max(y)), 8)
    picks_cpu, _ = gp.select_batch(post_cpu, cand, float(np.max(y)), 8)
    items = [(x, y, None), (x[:30], y[:30], None)]
    fit_c = gp.batched_fit(items, steps=[20, 30], bucket=64, device="cuda")
    fit_h = gp.batched_fit(items, steps=[20, 30], bucket=64, device="cpu")
    b_err = max(float(np.abs(gp._np(a) - gp._np(c)).max())
                for pc, ph in zip(fit_c, fit_h) for a, c in zip(pc, ph))
    check(b_err <= 1e-3, f"batched_fit card vs cpu params: {b_err}")
    emit("gp_parity", fit_params_abs_err=p_err, ei_abs_err=ei_err,
         picks_equal=bool(np.array_equal(picks, picks_cpu)),
         batched_fit_abs_err=b_err)
    if not np.array_equal(picks, picks_cpu):
        # a tie, not a wrong pick: the CPU's EI at the card's first
        # differing pick must equal its own maximum to 1e-5 relative
        i = int(np.argmax(picks != picks_cpu))
        _, p = gp.select_batch(post_cpu, cand, float(np.max(y)), i) \
            if i else (None, post_cpu)
        e = gp._np(gp.expected_improvement(p, cand, float(np.max(y))))
        e[picks_cpu[:i]] = -np.inf
        check(e[picks[i]] >= e.max() - 1e-5 * abs(e.max()),
              f"select_batch card pick {picks[i]} is not a tie")


def phase_gp_host():
    """Wall time of each GP call of the ask path at the paper's size (300
    observations, bucket 512), one thread, nothing else running: what
    the eager path costs on the host before any contention."""
    from repro_torch.core.suggest import gp
    rng = np.random.default_rng(11)
    x = rng.random((300, D))
    y = np.sin(3.0 * x @ rng.random(D)) + 0.1 * rng.standard_normal(300)
    cand = rng.random((M, D)).astype(np.float32)
    post = gp.fit_gp(x, y, steps=10, bucket=512, device="cuda")

    def wall_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    best = float(np.max(y))
    emit("gp_host", n=300, bucket=512, m=M,
         fit_gp_150_ms=wall_ms(lambda: gp.fit_gp(x, y, steps=150,
                                                 bucket=512), 1),
         fit_gp_10_ms=wall_ms(lambda: gp.fit_gp(x, y, steps=10, bucket=512)),
         batched_fit_2x10_ms=wall_ms(lambda: gp.batched_fit(
             [(x, y, None)] * 2, steps=10, bucket=512)),
         make_posterior_ms=wall_ms(lambda: gp.make_posterior(
             post.params, x, y, bucket=512)),
         append_lie_ms=wall_ms(lambda: gp.append_lie(post, cand[0]), 10),
         select_batch_8_ms=wall_ms(lambda: gp.select_batch(post, cand,
                                                           best, 8)),
         batched_select_2x8_ms=wall_ms(lambda: gp.batched_select(
             [(post, cand, best, 8)] * 2)))


# ------------------------------------------------------------- phase 3
def objective(a) -> float:
    """Cheap deterministic stand-in for the §4 CNN's accuracy over
    (lr, momentum, fc_width): one smooth peak at lr=10^-1.5,
    momentum 0.9, fc_width 160."""
    lr = (math.log10(a["lr"]) + 1.5) / 1.2
    mom = (a["momentum"] - 0.9) / 0.4
    fc = (a["fc_width"] - 160) / 160.0
    return math.exp(-0.5 * (lr * lr + mom * mom + fc * fc))


def percentiles_ms(lat) -> dict:
    ms = np.asarray(lat if lat else [float("nan")]) * 1e3
    return {f"suggest_p{q}_ms": float(np.percentile(ms, q))
            for q in (50, 90, 99)}


def hpo_space():
    from repro_torch.core import Param, Space
    return Space([Param("lr", "double", 1e-4, 3e-1, log=True),
                  Param("momentum", "double", 0.0, 0.99),
                  Param("fc_width", "int", 32, 256)])


def phase_service(budget: int = 300, parallel: int = 15, n_exp: int = 4):
    from repro_torch.api import CreateExperiment, LocalClient, ObserveRequest
    from repro_torch.api import pipeline
    from repro_torch.core.experiment import ExperimentConfig
    from repro_torch.core.space import strip_internal
    from repro_torch.kernels import gp as kgp

    space = hpo_space()
    free_card("service: before its construction")
    client = LocalClient(tempfile.mkdtemp(prefix="chip-smoke-"))
    free_card("service: constructed")
    lat, ids, values, errors = [], [], [], []
    lock = threading.Lock()
    deadline = time.monotonic() + 600

    def worker(exp):
        try:
            while time.monotonic() < deadline:
                t0 = time.perf_counter()
                batch = client.suggest(exp, 1)
                dt = time.perf_counter() - t0
                if not batch.suggestions:
                    if batch.remaining == 0 and not client.status(exp).pending:
                        return
                    time.sleep(0.005)
                    continue
                s = batch.suggestions[0]
                v = objective(strip_internal(s.assignment))
                time.sleep(TRIAL_SECONDS)
                with lock:
                    lat.append(dt)
                    ids.append(s.suggestion_id)
                    values.append(v)
                client.observe(ObserveRequest(exp, s.suggestion_id,
                                              s.assignment, value=v))
        except Exception as e:  # re-raised below, after the join
            errors.append(f"{type(e).__name__}: {e}")

    # let one refit dispatch take every experiment's owed fit: the
    # executor's dynamic cap starts at 2 lanes
    pipeline.FitExecutor.MAX_LANES = n_exp
    kgp.gp_nll_launches.reset()
    kgp.gp_ei_launches.reset()
    pool0 = card_pool.stats()
    t0 = time.perf_counter()
    exps = [client.create_experiment(CreateExperiment(config=ExperimentConfig(
        name=f"cnn-{i}", budget=budget, parallel=parallel, optimizer="gp",
        goal="max", space=space, seed=i).to_json())).exp_id
        for i in range(n_exp)]
    threads = [threading.Thread(target=worker, args=(e,), daemon=True)
               for e in exps for _ in range(parallel)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(1.0, deadline - time.monotonic()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gp_nll": kgp.gp_nll_launches.count,
                "gp_ei": kgp.gp_ei_launches.count}
    statuses = [client.status(e) for e in exps]
    executor = pipeline.executor_snapshot() or {}
    handoffs = pool_delta(pool0)
    free_card("service: workers joined")
    client.close()
    pipeline.FitExecutor.MAX_LANES = None
    free_card("service: closed")
    emit("service", experiments=n_exp, budget=budget, parallel=parallel,
         wall_s=wall, **percentiles_ms(lat),
         observations=sum(st.observations for st in statuses),
         best=[st.best and st.best["value"] for st in statuses],
         launches=dict(launches), executor=executor,
         cobatched_extra_lanes=executor.get("lanes", 0)
         - executor.get("batched", 0),
         pump=[{k: st.pump.get(k) for k in
                ("hits", "misses", "coalesced", "prefilled",
                 "batched_prefilled", "sparse_prefilled", "maintained",
                 "prewarmed", "invalidated")} for st in statuses],
         refit=[st.pump.get("refit") for st in statuses],
         card_pool=handoffs)
    check(not errors, f"workers failed: {errors[:3]}")
    check(not any(t.is_alive() for t in threads), "workers did not finish")
    for st in statuses:
        check(st.observations == budget,
              f"{st.exp_id}: {st.observations} observations != {budget}")
        log = client.store.exp_dir(st.exp_id) / "observations.jsonl"
        check(len(log.read_text().strip().splitlines()) == budget,
              f"{st.exp_id}: log lines != {budget}")
        check(st.best is not None and math.isfinite(st.best["value"]),
              f"{st.exp_id}: no finite best")
    check(len(ids) == n_exp * budget and len(set(ids)) == len(ids),
          "duplicate or missing suggestion ids")
    check(all(math.isfinite(v) for v in values), "non-finite objective")
    # the executor and the pumps catch what their jobs raise, to keep the
    # service up; a kernel fault there must still fail this run
    check(executor.get("failed", 0) == 0,
          f"executor jobs failed: {executor.get('last_error')}")
    for st in statuses:
        check("pump_error" not in st.pump,
              f"{st.exp_id}: pump died: {st.pump.get('pump_error')}")
    check(launches["gp_ei"] > 0, "gp_ei never launched on the main path")
    # a lone refit autodiffs plain torch and the prewarm launches nothing,
    # so gp_nll runs here only in refit dispatches of two lanes or more
    check(launches["gp_nll"] > 0, "gp_nll never launched on the main path")
    check(executor.get("lanes", 0) > executor.get("batched", 0),
          "no refit dispatch co-batched two experiments")
    return launches


def phase3_outside_rise() -> dict:
    """The rise of memory held outside PyTorch's allocator across phase 3
    (the service, 3b, 3c and 3d): the ``card_memory`` line "after phase
    3d" less "service: before its construction", and its share a phase,
    beside the threads of each kind that ran card work: the GP's fixed
    set (``repro_torch.card_pool``: the fit executor's workers and the
    pool's own threads) and 3b's CNN trial threads."""
    from repro_torch import card_pool
    at = {line["at"]: line["outside_gb"] for line in RESULTS["card_memory"]}
    marks = ("service: before its construction", "after phase 3",
             "after phase 3b", "after phase 3c", "after phase 3d")
    steps = {f"{a} -> {b}": at[b] - at[a] for a, b in zip(marks, marks[1:])}
    workers = RESULTS["service"][-1]["executor"].get("workers", 0)
    out = dict(rise_gb=at[marks[-1]] - at[marks[0]], by_phase_gb=steps,
               before_gb=at[marks[0]], after_gb=at[marks[-1]],
               gp_threads=dict(executor_workers=workers,
                               card_pool=card_pool.THREADS),
               cnn_trial_threads=RESULTS["hpo"][-1]["trial_threads"])
    emit("phase3_outside_rise", **out)
    return out


# -------------------------------------------------- phase 2: thread probe
#: fresh threads a probe round starts, each running its op once on the card
PROBE_THREADS = 8


def phase_thread_memory():
    """What one thread costs on the card outside PyTorch's allocator: for
    each op the service's threads run, ``PROBE_THREADS`` fresh threads
    run it once each, in two rounds (the second after the first's threads
    have ended), and ``outside_gb`` is read before and after each round.
    PyTorch keeps a cuBLAS and a cuSOLVER handle per thread that used
    one, in pools that hand a dead thread's handles to the next thread
    and destroy none: a first round shows what a handle holds, a second
    whether the pool reuses it.  The cholesky_ex shapes are a lone fit's
    and a co-batched refit's (``MAIN_NLL``)."""
    dev = torch.device("cuda", 0)
    k, b = MAIN_NLL
    a = torch.randn((b, b), device=dev)
    spd = a @ a.T + b * torch.eye(b, device=dev)
    lanes = spd.expand(k, b, b).contiguous()
    low = torch.linalg.cholesky(spd)
    ops = {"elementwise": lambda: (a * 2.0).sum(),
           "matmul": lambda: a @ a,
           "cholesky_ex": lambda: torch.linalg.cholesky_ex(spd),
           "cholesky_ex_lanes": lambda: torch.linalg.cholesky_ex(lanes),
           "solve_triangular": lambda: torch.linalg.solve_triangular(
               low, a, upper=False)}
    torch.cuda.synchronize()
    free_card("thread probe: before")
    for name, op in ops.items():
        for rnd in (1, 2):
            errors = []

            def run(op=op):
                try:
                    with torch.cuda.device(dev):
                        op()
                        torch.cuda.synchronize()
                except Exception as e:  # re-raised below, after the join
                    errors.append(f"{type(e).__name__}: {e}")

            before = outside_gb()
            threads = [threading.Thread(target=run)
                       for _ in range(PROBE_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            check(not errors and not any(t.is_alive() for t in threads),
                  f"thread probe {name}: {errors[:2]}")
            after = outside_gb()
            emit("thread_memory", op=name, round=rnd,
                 threads=PROBE_THREADS, outside_gb_before=before,
                 outside_gb_after=after,
                 per_thread_mb=(after - before) * 1e3 / PROBE_THREADS)
    del a, spd, lanes, low
    free_card("thread probe: after")


# ------------------------------------------------------------ phase 3b
def phase_cnn():
    """One batch of the §4 CNN on the card against the same batch on the
    CPU, from the same parameters: logits, loss and every gradient within
    ``CNN_LIMIT`` by relative norm; then ``train_cnn``'s wall time a step
    on the card and the host time of one batch of its data."""
    from repro_torch.models import cnn
    dev = torch.device("cuda", 0)
    cfg = cnn.CNNConfig()
    params = cnn.init_cnn(0, cfg, device=dev)
    data = cnn.synthetic_signs(1, 64)

    def run(device):
        p = {n: {k: t.detach().to(device).requires_grad_()
                 for k, t in layer.items()} for n, layer in params.items()}
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        logits = cnn.cnn_forward(p, batch["image"], cfg)
        loss, _ = cnn.cnn_loss(p, batch, cfg)
        grads = torch.autograd.grad(loss, [t for layer in p.values()
                                           for t in layer.values()])
        return [t.detach().cpu() for t in (logits, loss, *grads)]

    got, want = run(dev), run(torch.device("cpu"))
    errs = [float((g - w).norm() / w.norm().clamp_min(1e-30))
            for g, w in zip(got, want)]
    a = {"lr": 3e-3, "momentum": 0.9, "fc_width": 128}
    cnn.train_cnn(a, steps=2, device=dev)      # cuDNN and cuBLAS set-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = cnn.train_cnn(a, steps=HPO_STEPS, device=dev)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / HPO_STEPS
    t0 = time.perf_counter()
    for s in range(10):
        cnn.synthetic_signs(s, 64)
    data_ms = (time.perf_counter() - t0) * 1e3 / 10
    emit("cnn", logits_err=errs[0], loss_err=errs[1], grad_errs=errs[2:],
         limit=CNN_LIMIT, train_step_ms=step_ms, data_batch_ms=data_ms,
         accuracy=acc)
    check(max(errs) <= CNN_LIMIT,
          f"CNN on the card vs the CPU: {max(errs):.3g} > {CNN_LIMIT}")


def train_trial(a, ctx, done: list) -> float:
    """``examples/hpo_cnn.py:18-22``'s trial on the device of the trial's
    lease, ``HPO_STEPS`` steps; ``done[0]`` holds the steps run so far
    (a stopped trial ends at a report)."""
    from repro_torch.models.cnn import train_cnn

    def report(step, value):
        done[0] = step + 1
        ctx.report(step, value)

    acc = train_cnn(a, steps=HPO_STEPS, report=report,
                    device=ctx.lease.devices[0])
    done[0] = HPO_STEPS
    ctx.log(f"accuracy={acc:.4f}")
    return acc


def cnn_trial(a, ctx) -> float:
    """Phase 3c's trial, the entrypoint ``chip_smoke:cnn_trial`` of the
    worker processes: ``train_trial``, logging the steps it ran and its
    wall seconds and its process's peak of reserved device memory (the
    phase reads them from the worker's store)."""
    done, t0 = [0], time.perf_counter()
    try:
        return train_trial(a, ctx, done)
    finally:
        ctx.log(f"cnn steps={done[0]} "
                f"seconds={time.perf_counter() - t0:.6f} "
                f"reserved={torch.cuda.max_memory_reserved()}")


def pool_delta(before: dict) -> dict:
    """The GP's hand-offs to its fixed threads since ``before``
    (``card_pool.stats``): count, seconds the callers waited, seconds
    of that queued, and the mean wait in ms."""
    now = card_pool.stats()
    d = {k: now[k] - before[k] for k in now}
    d["mean_wait_ms"] = d["waited_s"] * 1e3 / max(1, d["handoffs"])
    return d


class CNNTrials:
    """``train_trial`` in this process; it keeps each run's steps and
    wall seconds, where the run ends (a completed trial, or one stopped at
    a report), its thread's CPU seconds, and the threads that ran one
    (each keeps a cuBLAS and a cuDNN handle on the card)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.steps, self.seconds, self.cpu_seconds = 0, 0.0, 0.0
        self.threads = set()        # threads that ran a trial on the card

    def __call__(self, a, ctx) -> float:
        done, t0, c0 = [0], time.perf_counter(), time.thread_time()
        try:
            return train_trial(a, ctx, done)
        finally:
            with self._lock:
                self.steps += done[0]
                self.seconds += time.perf_counter() - t0
                self.cpu_seconds += time.thread_time() - c0
                self.threads.add(threading.get_ident())


class TimedClient:
    """A client as its caller sees it: every ``suggest`` timed on the
    host clock (those that hand out suggestions; empty answers only
    counted), its ids kept, and when each experiment was first served
    after ``mark`` is set; all else passes through."""

    def __init__(self, client):
        self._client = client
        self._lock = threading.Lock()
        self.lat, self.ids, self.empty = [], [], 0
        self.mark, self.first = None, {}

    def __getattr__(self, name):
        return getattr(self._client, name)

    def suggest(self, exp_id, count=1):
        t0 = time.perf_counter()
        batch = self._client.suggest(exp_id, count)
        t1 = time.perf_counter()
        with self._lock:
            if batch.suggestions:
                self.lat.append(t1 - t0)
                self.ids.extend(s.suggestion_id for s in batch.suggestions)
                if self.mark is not None:
                    self.first.setdefault(exp_id, t1)
            else:
                self.empty += 1
        return batch


class CardSampler:
    """While a phase runs: the card's utilization (nvidia-smi every 500
    ms), the device memory of each process on it (``--query-compute-apps``
    every 2 s; the reading with the largest total, MiB a process, largest
    first: in a container every process reads as pid 1) and the host CPU
    seconds of each watched process (``/proc/<pid>/stat``, last reading)."""

    def __init__(self, pids: dict):
        self.pids, self.tick = dict(pids), os.sysconf("SC_CLK_TCK")
        self.util, self.apps_mib, self.cpu_s = [], [], {}
        self._stop = threading.Event()
        self._smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "500"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(2.0):
            out = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,used_memory",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=60).stdout
            mib = sorted((int(m) for m in re.findall(r",\s*(\d+)", out)),
                         reverse=True)
            if sum(mib) > sum(self.apps_mib):
                self.apps_mib = mib
            for name, pid in self.pids.items():
                try:
                    with open(f"/proc/{pid}/stat") as f:
                        fields = f.read().rsplit(")", 1)[1].split()
                except OSError:
                    continue
                self.cpu_s[name] = (int(fields[11]) + int(fields[12])) \
                    / self.tick

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)
        self._smi.terminate()
        self.util = [int(v) for v in self._smi.communicate(timeout=30)[0]
                     .split() if v.isdigit()]


#: thread name prefixes that ``thread_cpu_by_kind`` groups by
THREAD_KINDS = ("trial-", "sched-", "suggest-pump-", "fit-exec-",
                card_pool.PREFIX)


def thread_cpu() -> dict:
    """This process's threads' CPU seconds (``/proc/self/task``), by
    thread id -> (its Python name, else its OS name; seconds)."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                head, rest = f.read().rsplit(")", 1)
        except OSError:
            continue
        fields = rest.split()
        out[int(tid)] = (names.get(int(tid), head.split("(", 1)[1]),
                         (int(fields[11]) + int(fields[12])) / tick)
    return out


def thread_cpu_by_kind(before: dict, after: dict) -> dict:
    """CPU seconds between two ``thread_cpu`` readings by kind of thread
    (a ``THREAD_KINDS`` prefix, else the name less its number), largest
    first; threads that ended in between are missing, and their seconds
    are in the process's total."""
    kinds: dict = {}
    for tid, (name, sec) in after.items():
        kind = next((k.rstrip("-") for k in THREAD_KINDS
                     if name.startswith(k)), re.sub(r"[-_]?\d+$", "", name))
        s0 = before[tid][1] if tid in before else 0.0
        kinds[kind] = kinds.get(kind, 0.0) + sec - s0
    return dict(sorted(kinds.items(), key=lambda kv: -kv[1]))


class GilProbe:
    """A thread that sleeps 1 ms at a time while a phase runs: how much
    later than that it runs again is how long it waited for the GIL (and
    for a core)."""

    def __init__(self):
        self.late_ms: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="gil-probe")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            time.sleep(0.001)
            self.late_ms.append((time.perf_counter() - t0) * 1e3 - 1.0)

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=10)
        late = np.asarray(self.late_ms or [0.0])
        return {"samples": len(self.late_ms), "mean": float(late.mean()),
                **{f"p{q}": float(np.percentile(late, q))
                   for q in (50, 90, 99)}}


class RefitPairing:
    """Makes the experiments' refits meet in one dispatch, once.  Left
    alone the loop seldom co-batches them on the card: refits co-batch
    only within one shape bucket, the two histories drift apart (ASHA
    stops one's trials sooner), a pump holds its optimizer lock for long
    stretches serving misses while a peer's snapshot gives up after 50
    ms, and a slow cold fit stretches the refit period.  So a watcher
    thread queues a job on the executor (priority 0) as soon as every
    experiment has the history a fit needs, all in one bucket.  On the
    executor's one worker the job takes every experiment's optimizer lock
    (re-entrant, so the snapshots on this thread pass them), folds the
    pending observations, marks each optimizer as owing a refit (the
    debt its own schedule sets every ``refit_period`` observations), has
    each pump queue it, and runs the first through the executor's own
    ``_run_batch``, which takes the others as its peers.  The watcher
    tries again until a dispatch has co-batched or the executor stops."""

    def __init__(self, ex, n: int, service, lock_s: float = 30.0):
        self.ex, self.n, self.service, self.lock_s = ex, n, service, lock_s
        self.tries, self.paired, self.held_s = 0, 0, 0.0
        self._armed = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True)

    def start(self) -> None:
        self._watcher.start()

    def join(self) -> None:
        self._watcher.join(timeout=60)

    def _cobatched(self) -> bool:
        stats = self.ex.snapshot()
        return stats["lanes"] > stats["batched"]

    def _states(self) -> list:
        with self.service._lock:
            return list(self.service._exps.values())

    def _ready(self, states) -> bool:
        from repro_torch.core.suggest import gp as sgp
        opts = [st.optimizer for st in states]
        return (len(states) >= self.n and all(st.pump for st in states)
                and all(len(o._ys) >= max(2, len(o.space)) for o in opts)
                and len({sgp.bucket_size(len(o._ys)) for o in opts}) == 1)

    def _watch(self) -> None:
        from repro_torch.api import pipeline
        while not self.ex._stopped and not self._cobatched():
            if not self._armed.is_set() and self._ready(self._states()):
                self._armed.set()
                self.ex.submit(("pair", self.tries), self._pair,
                               pipeline.PRIO_MISS)
            time.sleep(0.01)

    def _pair(self) -> bool:
        from repro_torch.api import pipeline
        t0 = time.monotonic()
        states, held = self._states(), []
        try:
            for st in states:
                if not st.opt_lock.acquire(timeout=self.lock_s):
                    return False
                held.append(st.opt_lock)
            for st in states:
                pipeline.drain_ops(st)
            if self._cobatched() or not self._ready(states):
                return False
            for st in states:
                st.optimizer._needs_fit = True
                st.pump._push_fit_debt(False, 0)
            with self.ex._cv:
                fits = [(key, prio, fn) for key, (prio, fn)
                        in self.ex._jobs.items()
                        if type(fn) is pipeline.BatchableFit]
                if len(fits) < self.n:
                    return False
                key, prio, fn = fits[0]
                del self.ex._jobs[key]
                self.ex._active.add(key)
            try:
                again, _ = self.ex._run_batch(key, fn, prio)
            finally:
                with self.ex._cv:
                    self.ex._active.discard(key)
                    self.ex.stats["executed"] += 1
            if again:
                self.ex.submit(key, fn, prio)
            self.paired += 1
            return False
        finally:
            for lock in held:
                lock.release()
            self.tries += 1
            self.held_s += time.monotonic() - t0
            self._armed.clear()


def phase_hpo(gil_probe: bool = False):
    """The paper's §4 run through ``Orchestrator.run``: two experiments of
    ``examples/hpo_cnn.py`` at ``--paper`` scale at once, on one
    orchestrator (one ``LocalClient``, so their refits co-batch), each
    trial training the CNN on its lease's card.  The kernels' launch
    counters are zeroed just before and read just after.  With
    ``gil_probe`` a ``GilProbe`` runs beside (it costs the phase about a
    tenth of a core and adds to the contention it reads)."""
    from repro_torch.api import pipeline
    from repro_torch.core import (ExperimentConfig, Orchestrator, Param,
                                  Resources, Space)
    from repro_torch.kernels import gp as kgp

    orch = Orchestrator(tempfile.mkdtemp(prefix="chip-smoke-hpo-"))
    client = orch.client = TimedClient(orch.client)
    orch.cluster_create({"cluster_name": "h100", "pools": [
        {"name": "gpu", "resource": "gpu",
         "chips": HPO_PARALLEL * len(HPO_SEEDS)}]})
    cfgs = [ExperimentConfig(
        name=f"traffic-sign-cnn-{seed}", budget=HPO_BUDGET,
        parallel=HPO_PARALLEL, optimizer="gp", goal="max", space=hpo_space(),
        resources=Resources(pool="gpu", chips=1),
        early_stop={"min_steps": 9, "eta": 3}, seed=seed)
        for seed in HPO_SEEDS]
    # A fit executor of one worker whose refits are paired until one
    # dispatch co-batches, so that the two experiments' refits run as one
    # co-batched dispatch
    # (``gp_nll``'s path).  Left alone, the loop co-batched in about half
    # the card runs: under this load the pumps' refits are urgent (their
    # queues miss), run at once, and seldom find the other's queued (with
    # the default two workers, never).
    pipeline.fit_executor().stop()
    with pipeline._EXECUTOR_LOCK:
        ex = pipeline._EXECUTOR = pipeline.FitExecutor(workers=1)
    pairing = RefitPairing(ex, len(HPO_SEEDS), client._client)
    before = pipeline.executor_snapshot()
    pipeline.FitExecutor.MAX_LANES = len(HPO_SEEDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kgp.gp_nll_launches.reset()
    kgp.gp_ei_launches.reset()
    pairing.start()
    pool0 = card_pool.stats()
    # the card's utilization and the process's CPU time: where the run's
    # time goes (the service is not traced: a profiler slows the
    # host-bound loop it would measure)
    sampler = CardSampler({})
    gil = GilProbe() if gil_probe else None
    tcpu0 = thread_cpu()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    deadline = time.monotonic() + HPO_TIMEOUT_S
    trials = CNNTrials()
    try:
        exps = [orch.run(cfg, trial_fn=trials, cluster="h100",
                         background=True) for cfg in cfgs]
        for exp in exps:
            orch.wait(exp, timeout=max(1.0, deadline - time.monotonic()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = time.process_time() - cpu0
        cores = cpu / wall
        tcpu = thread_cpu_by_kind(tcpu0, thread_cpu())
    finally:
        sampler.stop()
        gil_late = gil.stop() if gil else None
    util = sampler.util
    handoffs = pool_delta(pool0)
    launches = {"gp_nll": kgp.gp_nll_launches.count,
                "gp_ei": kgp.gp_ei_launches.count}
    peak = torch.cuda.max_memory_allocated()
    pipeline.FitExecutor.MAX_LANES = None
    alive = [exp for exp in exps if orch._threads[exp].is_alive()]
    for exp in alive:
        orch.delete(exp)
    after = pipeline.executor_snapshot() or {}
    executor = {k: after.get(k, 0) - before.get(k, 0) for k in
                ("executed", "batched", "lanes", "batched_asks",
                 "ask_lanes", "failed")}
    statuses = {exp: orch.status(exp) for exp in exps}
    pumps = {exp: client.status(exp).pump for exp in exps}
    outcomes, records = {}, {}
    for exp in exps:
        records[exp] = orch.store.load_observation_records(exp)
        meta = [r.get("metadata") or {} for r in records[exp]]
        outcomes[exp] = dict(
            completed=sum(1 for m in meta if not m.get("pruned")),
            stopped=sum(1 for m in meta if m.get("pruned")
                        and not m.get("paused")),
            stopped_at_step_9=sum(1 for m in meta
                                  if m.get("pruned_at_step") == 9),
            paused_then_pruned=sum(1 for m in meta if m.get("paused")),
            pauses=sum(1 for line in orch.store.iter_logs(exp)
                       if "paused at step" in line))
    client.close()
    ex.stop()                        # its queue holds the pumps' jobs
    pairing.join()
    n_obs = sum(len(r) for r in records.values())
    emit("hpo", experiments=len(exps), budget=HPO_BUDGET,
         parallel=HPO_PARALLEL, steps=HPO_STEPS, wall_s=wall,
         trials_per_s=n_obs / wall, train_steps=trials.steps,
         train_steps_per_s=trials.steps / wall,
         gpu_util_pct=sum(util) / max(1, len(util)),
         gpu_util_samples=len(util), host_cores=cores,
         device_mib_by_process=sampler.apps_mib, trial_s=trials.seconds,
         trial_cpu_s=trials.cpu_seconds,
         slot_busy=trials.seconds / (wall * HPO_PARALLEL * len(exps)),
         **percentiles_ms(client.lat),
         suggests=len(client.lat), empty_suggests=client.empty,
         observations=[st.get("observations") for st in statuses.values()],
         failures=[st.get("failures") for st in statuses.values()],
         best=[(st.get("best") or {}).get("value")
               for st in statuses.values()],
         asha=list(outcomes.values()), launches=dict(launches),
         executor=executor, pairing_tries=pairing.tries,
         pairing_paired=pairing.paired, pairing_held_s=pairing.held_s,
         peak_gb=peak / 1e9, trial_threads=len(trials.threads),
         pump=[{k: p.get(k) for k in
                ("hits", "misses", "coalesced", "prefilled",
                 "batched_prefilled", "maintained", "invalidated")}
               for p in pumps.values()],
         refit=[p.get("refit") for p in pumps.values()],
         card_pool=handoffs, cpu_s=cpu, thread_cpu_s=tcpu,
         gil_late_ms=gil_late)
    check(not alive, f"experiments still running after {HPO_TIMEOUT_S} s")
    ids = []
    for exp, st in statuses.items():
        check(st.get("state") == "complete", f"{exp}: state {st.get('state')}")
        check(st.get("observations") == HPO_BUDGET
              and len(records[exp]) == HPO_BUDGET,
              f"{exp}: {len(records[exp])} observations != {HPO_BUDGET}")
        check(st.get("failures") == 0
              and not any(r.get("failed") for r in records[exp]),
              f"{exp}: a trial failed")
        best = (st.get("best") or {}).get("value")
        check(best is not None and math.isfinite(best)
              and best > 3.0 / 43, f"{exp}: best accuracy {best}")
        ids += [r.get("suggestion_id") for r in records[exp]]
    check(None not in ids and len(set(ids)) == len(ids)
          and len(set(client.ids)) == len(client.ids),
          "a suggestion id repeats")
    check(executor["failed"] == 0, "executor jobs failed: "
          f"{after.get('last_error')}")
    for exp, pump in pumps.items():
        check("pump_error" not in pump,
              f"{exp}: pump died: {pump.get('pump_error')}")
    check(launches["gp_ei"] > 0, "gp_ei never launched in the §4 run")
    check(launches["gp_nll"] > 0, "gp_nll never launched in the §4 run")
    check(executor["lanes"] > executor["batched"],
          "no refit dispatch co-batched the two experiments")
    del orch, client, trials
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phase 3c
#: the workers of phase 3c: ``python -m repro_torch.launch.cli`` with the
#: checkout's ``src`` and root importable (``chip_smoke:cnn_trial``)
CLI = [sys.executable, "-m", "repro_torch.launch.cli"]

#: what an idle worker's ``Orchestrator`` costs: its ``LocalClient`` is
#: never used by ``run(service=)``; it must start no thread and hold no
#: tensor on the card (the CUDA context its device resolution creates is
#: the one the trials use)
IDLE_PROBE = r"""
import json, os, subprocess, sys, threading, time
t0 = time.perf_counter()
import torch
from repro_torch.core import Orchestrator
t1 = time.perf_counter()
orch = Orchestrator(sys.argv[1])
t2 = time.perf_counter()
smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                      "--format=csv,noheader,nounits"], capture_output=True,
                     text=True, timeout=60).stdout
print(json.dumps({"import_s": t1 - t0, "init_s": t2 - t1,
                  "threads": [t.name for t in threading.enumerate()
                              if t is not threading.main_thread()],
                  "allocated": torch.cuda.memory_allocated(),
                  "reserved": torch.cuda.memory_reserved(),
                  "pid": os.getpid(), "compute_apps": smi.split("\n")}))
"""


def worker_env() -> dict:
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
                PYTHONUNBUFFERED="1")


def phase_remote():
    """The paper's §4 run over the wire: ``serve_api`` on the card in
    this process (so the kernels' counters can be read), and one worker
    process a seed, each the port's CLI (``cluster create`` of a pool
    ``gpu`` of 15 chips, then ``run --service URL --cluster``) running
    ``examples/hpo_cnn.py --paper`` with the trial ``chip_smoke:cnn_trial``
    on its lease's card.  No ``RefitPairing``: whether refits co-batch is
    what the phase reports."""
    from repro_torch.api import pipeline
    from repro_torch.api.http import serve_api
    from repro_torch.core import ExperimentConfig, Resources
    from repro_torch.core.store import Store
    from repro_torch.kernels import gp as kgp

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-remote-"))
    server = serve_api(str(tmp / "service"), device="cuda").start()
    backend, procs = server.backend, []
    try:
        env = worker_env()
        probe = subprocess.Popen(
            [sys.executable, "-c", IDLE_PROBE, str(tmp / "probe")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)
        roots, creates = {}, []
        for seed in HPO_SEEDS:
            roots[seed] = tmp / f"worker-{seed}"
            roots[seed].mkdir()
            (roots[seed] / "cluster.json").write_text(json.dumps({
                "cluster_name": f"worker-{seed}", "pools": [
                    {"name": "gpu", "resource": "gpu",
                     "chips": HPO_PARALLEL}]}))
            cfg = ExperimentConfig(
                name=f"traffic-sign-cnn-{seed}", budget=HPO_BUDGET,
                parallel=HPO_PARALLEL, optimizer="gp", goal="max",
                space=hpo_space(), resources=Resources(pool="gpu", chips=1),
                early_stop={"min_steps": 9, "eta": 3}, seed=seed,
                entrypoint="chip_smoke:cnn_trial").to_json()
            (roots[seed] / "exp.json").write_text(json.dumps(cfg))
            creates.append(subprocess.run(
                CLI + ["--store", str(roots[seed]), "cluster",
                       "create", "-f", str(roots[seed] / "cluster.json")],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=300))
        out, err = probe.communicate(timeout=300)
        check(probe.returncode == 0, f"idle probe: {err[-2000:]}")
        idle = json.loads(out.strip().splitlines()[-1])
        for c in creates:
            check(c.returncode == 0, f"cluster create: {c.stderr[-2000:]}")

        timed = TimedClient(backend)
        before = pipeline.executor_snapshot() or {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kgp.gp_nll_launches.reset()
        kgp.gp_ei_launches.reset()
        cpu0, t0 = time.process_time(), time.perf_counter()
        with patched(server._httpd.RequestHandlerClass, backend=timed):
            for seed in HPO_SEEDS:
                log = open(roots[seed] / "worker.log", "w")
                procs.append(subprocess.Popen(
                    CLI + ["--store", str(roots[seed]), "run",
                           "-f", str(roots[seed] / "exp.json"),
                           "--service", server.url,
                           "--cluster", f"worker-{seed}"],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
                log.close()
            sampler = CardSampler({f"worker-{s}": p.pid
                                   for s, p in zip(HPO_SEEDS, procs)})
            deadline = time.monotonic() + HPO_TIMEOUT_S
            try:
                for proc in procs:
                    proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            finally:
                sampler.stop()
        wall = time.perf_counter() - t0
        cores = (time.process_time() - cpu0) / wall
        launches = {"gp_nll": kgp.gp_nll_launches.count,
                    "gp_ei": kgp.gp_ei_launches.count}
        peak = torch.cuda.max_memory_allocated()
        rcs = [proc.poll() for proc in procs]
        after = pipeline.executor_snapshot() or {}
        executor = {k: after.get(k, 0) - before.get(k, 0) for k in
                    ("executed", "batched", "lanes", "batched_asks",
                     "ask_lanes", "failed")}
        store = Store(str(tmp / "service"))
        exps = store.list_experiments()
        statuses = {e: backend.status(e) for e in exps}
        records = {e: store.load_observation_records(e) for e in exps}
        workers = []
        for seed, proc in zip(HPO_SEEDS, procs):
            wstore = Store(str(roots[seed]))
            steps = secs = reserved = 0
            failures = []
            for e in wstore.list_experiments():
                failures.append(wstore.get_status(e).get("failures"))
                for line in wstore.iter_logs(e):
                    m = re.search(r"cnn steps=(\d+) seconds=([\d.]+) "
                                  r"reserved=(\d+)", line)
                    if m:
                        steps += int(m.group(1))
                        secs += float(m.group(2))
                        reserved = max(reserved, int(m.group(3)))
            workers.append(dict(
                seed=seed, rc=proc.returncode, failures=failures,
                steps=steps, trial_s=secs,
                ms_per_step=secs * 1e3 / max(1, steps),
                cpu_s=sampler.cpu_s.get(f"worker-{seed}"),
                reserved_gb=reserved / 1e9,
                tail=(roots[seed] / "worker.log").read_text()[-1500:]
                if proc.returncode else ""))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        server.shutdown()
    n_obs = sum(len(r) for r in records.values())
    emit("remote", experiments=len(exps), budget=HPO_BUDGET,
         parallel=HPO_PARALLEL, steps=HPO_STEPS, wall_s=wall,
         trials_per_s=n_obs / wall, service_host_cores=cores,
         gpu_util_pct=sum(sampler.util) / max(1, len(sampler.util)),
         gpu_util_samples=len(sampler.util),
         device_mib_by_process=sampler.apps_mib,
         service_peak_gb=peak / 1e9, idle_orchestrator=idle,
         steps_per_s=sum(w["steps"] for w in workers) / wall,
         workers=workers, **percentiles_ms(timed.lat),
         suggests=len(timed.lat),
         observations=[st.observations for st in statuses.values()],
         best=[(st.best or {}).get("value") for st in statuses.values()],
         launches=dict(launches), executor=executor,
         cobatched=executor["lanes"] > executor["batched"],
         pump=[{k: st.pump.get(k) for k in
                ("hits", "misses", "coalesced", "prefilled",
                 "batched_prefilled", "maintained", "invalidated")}
               for st in statuses.values()],
         refit=[st.pump.get("refit") for st in statuses.values()])
    check(rcs == [0] * len(procs), f"worker exit codes {rcs}: "
          + " | ".join(w["tail"] for w in workers))
    check(not idle["threads"] and idle["allocated"] == 0,
          f"an idle worker's Orchestrator started {idle['threads']} or "
          f"holds {idle['allocated']} bytes on the card")
    check(len(exps) == len(HPO_SEEDS), f"{len(exps)} experiments served")
    ids = []
    for e, st in statuses.items():
        check(st.observations == HPO_BUDGET
              and len(records[e]) == HPO_BUDGET,
              f"{e}: {len(records[e])} observations != {HPO_BUDGET}")
        check(st.failures == 0 and not any(r.get("failed")
                                           for r in records[e]),
              f"{e}: a trial failed")
        best = (st.best or {}).get("value")
        check(best is not None and math.isfinite(best) and best > 3.0 / 43,
              f"{e}: best accuracy {best}")
        check("pump_error" not in st.pump,
              f"{e}: pump died: {st.pump.get('pump_error')}")
        ids += [r.get("suggestion_id") for r in records[e]]
    check(None not in ids and len(set(ids)) == len(ids)
          and len(set(timed.ids)) == len(timed.ids),
          "a suggestion id repeats")
    check(all(w["failures"] == [0] for w in workers),
          f"a worker recorded failed trials: {workers}")
    check(executor["failed"] == 0,
          f"executor jobs failed: {after.get('last_error')}")
    check(launches["gp_ei"] > 0, "gp_ei never launched in the service")
    return launches


# ------------------------------------------------------------ phase 3d
FLEET_SHARDS = 2
FLEET_EXPERIMENTS = 4
FLEET_PERIOD_S = 0.5
#: how long a probe of a shard may take before it counts as failed: the
#: shards share this process's interpreter lock with 60 trial threads,
#: the pumps and the fit executor, so a live shard can take seconds to
#: answer; a shard whose listener is shut refuses at once, so detection
#: still takes the two periods of ``dead_after``
FLEET_PROBE_TIMEOUT_S = 5.0
#: share of all observations in before the failover
FLEET_FAIL_AT = 1 / 3


def fleet_trial(a, ctx) -> float:
    """Phase 3's stand-in for the §4 CNN, held ``TRIAL_SECONDS``."""
    time.sleep(TRIAL_SECONDS)
    return objective(a)


def fleet_exp_ids(ring, n: int):
    """``n`` experiment ids the ring spreads evenly over its shards, so
    that both shards own experiments before the failover."""
    per = -(-n // len(ring))
    ids, owned = [], {}
    for j in range(10_000):
        key = f"exp-fleet-{j:04d}"
        owner = ring.owner(key)
        if owned.get(owner, 0) < per:
            owned[owner] = owned.get(owner, 0) + 1
            ids.append(key)
        if len(ids) == n:
            return ids
    raise RuntimeError("no spread of experiment ids found")


def phase_fleet():
    """``serve_fleet`` with two shards on the card in this process and
    four ``gp`` experiments at the paper's budget and parallelism, each
    driven by ``Orchestrator.run(fleet=URL)`` with phase 3's stand-in
    trial; once a third of all observations are in, the listener of the
    shard owning the most experiments is shut, and the survivor adopts
    them from the shared store (a cold refit) and serves them on."""
    from repro_torch.api import pipeline
    from repro_torch.core import ExperimentConfig, Orchestrator
    from repro_torch.core.store import Store
    from repro_torch.fleet import serve_fleet
    from repro_torch.kernels import gp as kgp

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-fleet-"))
    # a fresh fit executor: the shards' admission reads its duty cycle,
    # which an earlier phase's work would still hold above the limit
    pipeline.fit_executor().stop()
    srv = serve_fleet(str(tmp / "fleet"), shards=FLEET_SHARDS,
                      period=FLEET_PERIOD_S, device="cuda",
                      probe_timeout=FLEET_PROBE_TIMEOUT_S).start()
    manager, store = srv.manager, Store(str(tmp / "fleet"))
    orch = Orchestrator(str(tmp / "worker"), device="cuda")
    exps = fleet_exp_ids(manager.ring, FLEET_EXPERIMENTS)
    total = HPO_BUDGET * len(exps)

    def observed() -> int:
        return sum(len(store.load_observation_records(e)) for e in exps)

    before = pipeline.executor_snapshot() or {}
    kgp.gp_nll_launches.reset()
    kgp.gp_ei_launches.reset()
    timers = {}
    try:
        for i, shard in enumerate(srv.owned_shards):
            timers[f"shard-{i}"] = TimedClient(shard.backend)
            shard._httpd.RequestHandlerClass.backend = timers[f"shard-{i}"]
        t0 = time.perf_counter()
        for i, exp in enumerate(exps):
            orch.run(ExperimentConfig(
                name=f"fleet-cnn-{i}", budget=HPO_BUDGET,
                parallel=HPO_PARALLEL,
                optimizer="gp", goal="max", space=hpo_space(), seed=i),
                trial_fn=fleet_trial, background=True, exp_id=exp,
                fleet=srv.url)
        owners = {e: manager.owner_of(e).shard_id for e in exps}
        deadline = time.monotonic() + HPO_TIMEOUT_S
        while observed() < FLEET_FAIL_AT * total:
            check(time.monotonic() < deadline, "no third of the budget in")
            time.sleep(0.1)
        check(len(manager.shard_map().shards) == FLEET_SHARDS,
              f"a shard left before the failover: {manager.events[-8:]}")
        counts = {sid: list(owners.values()).count(sid)
                  for sid in sorted(set(owners.values()))}
        victim_id = max(counts, key=counts.get)
        victim = srv.owned_shards[int(victim_id.split("-")[1])]
        survivor_id = next(s for s in manager.shard_map().shards
                           if s != victim_id)
        adopted = [e for e, s in owners.items() if s == victim_id]
        launches_before = {"gp_nll": kgp.gp_nll_launches.count,
                           "gp_ei": kgp.gp_ei_launches.count}
        kgp.gp_nll_launches.reset()
        kgp.gp_ei_launches.reset()
        obs_at_failover = observed()
        t_fail = time.perf_counter()
        timers[survivor_id].mark = t_fail
        victim._httpd.shutdown()
        victim._httpd.server_close()
        while manager.stats["dead_shards"] < 1:
            check(time.monotonic() < deadline, "the shard never died")
            time.sleep(0.01)
        t_dead = time.perf_counter()
        for e in exps:
            orch.wait(e, timeout=max(1.0, deadline - time.monotonic()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        alive = [e for e in exps if orch._threads[e].is_alive()]
        launches = {"gp_nll": kgp.gp_nll_launches.count,
                    "gp_ei": kgp.gp_ei_launches.count}
        after = pipeline.executor_snapshot() or {}
        executor = {k: after.get(k, 0) - before.get(k, 0) for k in
                    ("executed", "batched", "lanes", "failed")}
        survivor = srv.owned_shards[int(survivor_id.split("-")[1])].backend
        statuses = {e: survivor.status(e) for e in exps}
        records = {e: store.load_observation_records(e) for e in exps}
        stats, shard_map = dict(manager.stats), manager.shard_map()
        first = timers[survivor_id].first
    finally:
        for e in exps:
            if e in orch._schedulers:
                orch._schedulers[e].stop()
            if e in orch._exp_clients:
                orch._exp_clients[e].close()
        srv.shutdown()
    served_ids = [i for t in timers.values() for i in t.ids]
    emit("fleet", shards=FLEET_SHARDS, experiments=len(exps),
         budget=HPO_BUDGET, parallel=HPO_PARALLEL, period_s=FLEET_PERIOD_S,
         wall_s=wall, owners=owners, victim=victim_id, adopted=adopted,
         observations_at_failover=obs_at_failover,
         detection_s=t_dead - t_fail,
         adoption_s={e: first[e] - t_dead for e in adopted if e in first},
         launches_before_failover=launches_before,
         launches_after_failover=launches, executor=executor,
         manager=stats, observations=[len(r) for r in records.values()],
         best=[(st.best or {}).get("value") for st in statuses.values()],
         **percentiles_ms([x for t in timers.values() for x in t.lat]))
    check(not alive, f"experiments still running: {alive}")
    check(set(owners.values()) == {f"shard-{i}"
                                   for i in range(FLEET_SHARDS)},
          f"experiments not on every shard before the failover: {owners}")
    check(stats["dead_shards"] == 1, f"dead shards {stats['dead_shards']}")
    check(victim_id not in shard_map.shards, "the victim is still mapped")
    for e in exps:
        ids = [r.get("suggestion_id") for r in records[e]]
        check(len(ids) == HPO_BUDGET
              and statuses[e].observations == HPO_BUDGET,
              f"{e}: {len(ids)} observations != {HPO_BUDGET}")
        check(None not in ids and len(set(ids)) == len(ids),
              f"{e}: a duplicate observation was accepted")
    check(len(set(served_ids)) == len(served_ids), "a suggestion id repeats")
    check(all(e in first for e in adopted),
          "the survivor served no adopted experiment")
    check(launches["gp_ei"] > 0, "gp_ei never launched after the failover")
    check(executor["failed"] == 0,
          f"executor jobs failed: {after.get('last_error')}")
    return {k: launches_before[k] + launches[k] for k in launches}


# ------------------------------------------------------------- phase 4
#: (name, B, Sq, Skv, H, K, D, causal, window, softcap, dtype); the first
#: is the serve shape of recurrentgemma-2b's local attention
FLASH_CASES = (
    ("serve", 4, 3000, 3000, 10, 1, 256, True, 2048, 0.0, "bfloat16"),
    ("serve_f32", 4, 3000, 3000, 10, 1, 256, True, 2048, 0.0, "float32"),
    ("s4096", 4, 4096, 4096, 10, 1, 256, True, 2048, 0.0, "bfloat16"),
    ("granite", 1, 4096, 4096, 32, 8, 128, True, 0, 0.0, "bfloat16"),
    ("softcap", 2, 1024, 1024, 8, 2, 128, True, 0, 50.0, "bfloat16"),
    ("ragged", 2, 1000, 1500, 8, 2, 64, True, 300, 0.0, "float32"),
    ("ragged_noncausal", 3, 777, 555, 4, 4, 16, False, 0, 0.0, "float32"),
    ("ragged_bf16", 2, 1000, 1500, 8, 2, 64, True, 300, 0.0, "bfloat16"),
    ("ragged_noncausal_bf16", 3, 777, 555, 4, 4, 16, False, 0, 0.0,
     "bfloat16"),
    ("gqa4_window", 2, 1500, 1500, 16, 4, 128, True, 1000, 0.0, "bfloat16"),
    # a head dim between the instantiated ones (the CPU tests' gqa_ragged):
    # the wrapper zero-pads it to 64 at the scale 1/sqrt(32)
    ("gqa_ragged_d32", 2, 70, 70, 8, 2, 32, True, 0, 0.0, "bfloat16"),
    ("gqa_ragged_d32_f32", 2, 70, 70, 8, 2, 32, True, 0, 0.0, "float32"),
)
#: (name, B, S, R); the first is the serve shape of an RG-LRU layer.  The
#: kernel's tiles are 64 steps x 64 features: S = 1 is one partial tile,
#: S = 65 a full tile and one step of the next (R = 1000 ends in a
#: 40-feature strip), R = 999 takes the 4-byte staging path
SCAN_CASES = (("serve", 4, 3000, 2560), ("ragged", 3, 1001, 1000),
              ("s1", 2, 1, 1000), ("tile_plus_1", 3, 65, 1000),
              ("unaligned", 2, 129, 999))
#: element-wise limit (rtol, c) of the kernel against the float32 oracle
#: on the same inputs: |out - ref32| <= rtol |ref32| + c rms(ref32's row),
#: a row being one (batch, query, head) output vector.  bf16: one rounding
#: of the output (2^-8 relative) and a 2^-10 share of the row's size for
#: float32 sums in another order; f32: sums in another order only
FLASH_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -8, 2.0 ** -10)}
#: max |sdpa - plain| / max |plain| for the library yardstick, which in
#: bf16 rounds its probabilities before the product: a sanity check that
#: it computes the same function, not a limit on the port
SDPA_LIMIT = {"float32": 5e-4, "bfloat16": 5e-2}
#: faults planted into the plain version at the serve shape, each of
#: which the element-wise limit must reject: the window one key short,
#: the oldest 64-key tile of every full band dropped, no window at all
FLASH_FAULTS = {"window_minus_1": -1, "oldest_tile_dropped": -64,
                "no_window": None}
SCAN_LIMIT = 1e-5


def flash_excess(out, ref32, dtype: str) -> float:
    """The largest ratio of |out - ref32| to its element-wise limit
    (``FLASH_TOL``); at most 1 when ``out`` agrees everywhere."""
    rtol, c = FLASH_TOL[dtype]
    ref32 = ref32.float()
    rms = ref32.square().mean(-1, keepdim=True).sqrt()
    lim = rtol * ref32.abs() + c * rms
    return float(((out.float() - ref32).abs() / lim.clamp(min=1e-30)).max())


def band_mask(Sq, Skv, causal, window, dev):
    qp = torch.arange(Sq, device=dev)[:, None]
    kp = torch.arange(Skv, device=dev)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        m &= qp >= kp
    if window:
        m &= (qp - kp) < window
    return m


def phase_lm_kernels():
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as krg
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    summary = {}
    for (name, B, Sq, Skv, H, K, D, causal, window, cap,
         dtype) in FLASH_CASES:
        gen.manual_seed(Sq + Skv + D)
        dt = getattr(torch, dtype)
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Skv, K, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Skv, K, D), generator=gen, device=dev).to(dt)
        kw = dict(causal=causal, window=window, softcap=cap)
        out = kfa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, **kw)
        err = rel_err(out.float(), want.float())
        abs_err = float((out.float() - want.float()).abs().max())
        ref32 = (want if dtype == "float32" else ref.flash_attention_ref(
            q.float(), k.float(), v.float(), **kw))
        excess = flash_excess(out, ref32, dtype)
        check(math.isfinite(excess) and excess <= 1.0,
              f"flash_attention {name}: {excess} x its element-wise limit")
        planted = {}
        if name == "serve":
            # the limit must see a tile or a key of the band go missing
            for fault, dw in FLASH_FAULTS.items():
                bad = ref.flash_attention_ref(
                    q, k, v, causal=causal, softcap=cap,
                    window=0 if dw is None else window + dw)
                planted[fault] = flash_excess(bad, ref32, dtype)
                check(planted[fault] > 1.0,
                      f"planted fault {fault} passes: {planted[fault]}")
                del bad
        del ref32
        lib_ms = lib_err = None
        if not cap:  # SDPA has no softcap
            mask = band_mask(Sq, Skv, causal, window, dev)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, scale=1.0 / math.sqrt(D),
                enable_gqa=True)
            lib_err = rel_err(sdpa().transpose(1, 2).float(), want.float())
            check(lib_err <= SDPA_LIMIT[dtype],
                  f"sdpa {name} disagrees: {lib_err}")
            lib_ms = time_ms(sdpa)
        del want
        ms = time_ms(lambda: kfa.flash_attention(q, k, v, **kw))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw))
        flops, nbytes = flash_work(B, Sq, Skv, H, K, D, causal, window,
                                   q.element_size())
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if dtype ==
                             "bfloat16" else PEAK_F32_FLOPS)
        emit("flash_case", case=name, B=B, Sq=Sq, Skv=Skv, H=H, K=K, D=D,
             causal=causal, window=window, softcap=cap, dtype=dtype,
             tol=FLASH_TOL[dtype], excess=excess, planted_excess=planted,
             rel_err=err, max_abs_err=abs_err, ms=ms,
             plain_ms=plain_ms, sdpa_ms=lib_ms, sdpa_rel_err=lib_err,
             bound_ms=bound, bound_by=by, gflop=flops / 1e9,
             mbytes=nbytes / 1e6)
        if name == "serve":
            summary["flash_attention"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del q, k, v, out
        torch.cuda.empty_cache()
    check(krg.TIME_TILE + 1 == SCAN_CASES[3][2], "tile_plus_1 is not one "
          f"step past the kernel's {krg.TIME_TILE}-step tile")
    for name, B, S, R in SCAN_CASES:
        gen.manual_seed(S + R)
        la = -0.5 * torch.rand((B, S, R), generator=gen, device=dev)
        b = torch.randn((B, S, R), generator=gen, device=dev)
        h = krg.rglru_scan(la, b)
        torch.cuda.synchronize()
        want = ref.rglru_scan_ref(la, b)
        abs_err = float((h - want).abs().max())
        lim = SCAN_LIMIT * max(1.0, float(want.abs().max()))
        check(math.isfinite(abs_err) and abs_err <= lim,
              f"rglru_scan {name}: {abs_err} > {lim}")
        planted = None
        if name == "serve":
            # the limit must see the carry into a tile go missing: each
            # time tile after the first scanned from h = 0
            tiles = [ref.rglru_scan_ref(la[:, t:t + krg.TIME_TILE],
                                        b[:, t:t + krg.TIME_TILE])
                     for t in range(0, S, krg.TIME_TILE)]
            planted = float((torch.cat(tiles, 1) - want).abs().max()) / lim
            check(planted > 1.0,
                  f"planted fault (no carry between tiles) passes: {planted}")
            del tiles
        ms = time_ms(lambda: krg.rglru_scan(la, b))
        plain_ms = time_ms(lambda: ref.rglru_scan_ref(la, b))
        bound, by = bound_ms(*scan_work(B, S, R))
        emit("rglru_case", case=name, B=B, S=S, R=R, limit=lim,
             max_abs_err=abs_err, planted_no_carry_excess=planted, ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
             library_ms=None)
        if name == "serve":
            summary["rglru_scan"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)
    return summary


# ------------------------------------------------------------ phase 4b
#: (name, B, S, H, K, Dqk, Dv) of the MoE family's prefill attention, all
#: causal and bf16: granite-moe-3b-a800m's GQA (24 query heads over 8 KV
#: heads, 64 wide) and deepseek-v2-lite-16b's MLA (q/k 192 = 128 + 64
#: rope, v 128, 16 heads), which models/attention._mla_forward zero-pads
#: to the kernel's head dim 256 with the scale 1/sqrt(192) of its own width
MOE_FLASH_CASES = (("granite_moe", 4, 3000, 24, 8, 64, 64),
                   ("mla", 4, 3000, 16, 16, 192, 128))


def sdpa_backends(q, k, v, scale, causal: bool = True):
    """``F.scaled_dot_product_attention`` (``causal`` or not, grouped heads
    where K < H) on q (B,Sq,H,Dqk), k (B,Skv,K,Dqk), v (B,Skv,K,Dv) under
    the first backend that takes the layout, of flash, cuDNN,
    memory-efficient and math -> (backend name, a call, its output
    (B,Sq,H,Dv)), or (None, None, None) when none does."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale,
                    enable_gqa=gqa)
        try:
            out = call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, call, out.transpose(1, 2)
    return None, None, None


def phase_moe_kernels():
    """4b: ``flash_attention`` at the MoE family's two prefill layouts,
    held element by element against the float32 oracle on the same
    (padded) inputs, the padded columns zero, and for MLA a planted fault
    (the padded head's own scale 1/16) failing the limit; timed beside the
    plain version and SDPA on the unpadded layout.  The bound counts the
    unpadded work: 2·(Dqk + Dv) operations a visible pair a head, the
    unpadded q, k, v and o once."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    for name, B, S, H, K, Dqk, Dv in MOE_FLASH_CASES:
        gen.manual_seed(S + H + Dqk)
        D = next(d for d in kfa.HEAD_DIMS if d >= max(Dqk, Dv))
        scale = 1.0 / math.sqrt(Dqk)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, S, H, Dqk), (B, S, K, Dqk),
                                          (B, S, K, Dv)))

        def padded():
            return (F.pad(q, (0, D - Dqk)), F.pad(k, (0, D - Dqk)),
                    F.pad(v, (0, D - Dv)))
        qp, kp, vp = padded()
        kw = dict(causal=True, scale=scale)
        out = kfa.flash_attention(qp, kp, vp, **kw)
        torch.cuda.synchronize()
        check(not bool(out[..., Dv:].any()),
              f"flash_attention {name}: padded output columns not zero")
        out = out[..., :Dv]
        want = ref.flash_attention_ref(qp, kp, vp, **kw)[..., :Dv]
        abs_err = float((out.float() - want.float()).abs().max())
        ref32 = ref.flash_attention_ref(qp.float(), kp.float(), vp.float(),
                                        **kw)[..., :Dv]
        excess = flash_excess(out, ref32, "bfloat16")
        check(math.isfinite(excess) and excess <= 1.0,
              f"flash_attention {name}: {excess} x its element-wise limit")
        planted = None
        if D != Dqk:
            # the padded head's default scale, 1/sqrt(D), in MLA's place
            bad = ref.flash_attention_ref(qp, kp, vp, causal=True)
            planted = flash_excess(bad[..., :Dv], ref32, "bfloat16")
            check(planted > 1.0, f"planted fault (scale 1/sqrt({D})) "
                  f"passes: {planted}")
            del bad
        del ref32
        backend, sdpa, lib_out = sdpa_backends(q, k, v, scale)
        lib_ms = lib_err = None
        if backend is not None:
            lib_err = rel_err(lib_out.float(), want.float())
            check(lib_err <= SDPA_LIMIT["bfloat16"],
                  f"sdpa {name} ({backend}) disagrees: {lib_err}")
            lib_ms = time_ms(sdpa)
        del lib_out, want
        ms = time_ms(lambda: kfa.flash_attention(qp, kp, vp, **kw))
        pad_ms = time_ms(padded) if D != Dqk or D != Dv else 0.0
        plain_ms = time_ms(lambda: ref.flash_attention_ref(qp, kp, vp, **kw))
        flops, nbytes = flash_work(B, S, S, H, K, Dqk, True, 0, 2, Dv)
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        emit("flash_case", case=name, B=B, Sq=S, Skv=S, H=H, K=K, D=D,
             Dqk=Dqk, Dv=Dv, scale=scale, causal=True, window=0,
             softcap=0.0, dtype="bfloat16", tol=FLASH_TOL["bfloat16"],
             excess=excess, planted_excess={"default_scale": planted},
             max_abs_err=abs_err, ms=ms, pad_ms=pad_ms, plain_ms=plain_ms,
             sdpa_ms=lib_ms, sdpa_backend=backend, sdpa_rel_err=lib_err,
             bound_ms=bound, bound_by=by, gflop=flops / 1e9,
             mbytes=nbytes / 1e6)
        del q, k, v, qp, kp, vp, out
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 5
SERVE = dict(arch="recurrentgemma-2b", batch=4, prompt_len=3000, gen=64,
             reduced=False)
#: what recurrentgemma-2b's 26 layers launch in one prefill: 8 local
#: attention layers, 18 RG-LRU layers
PREFILL_LAUNCHES = {"flash_attention": 8, "rglru_scan": 18}
#: how much further than the plain bf16 path the kernel path may be from
#: the float32 model: per mixing layer of the prefill, by relative norm
#: (both paths share every bf16 matmul, and the H100 put them within
#: 0.6% of each other at all 26 layers), and on the logits by max |.|,
#: where one bf16 step of the largest logit decides and the first limit,
#: 1x, failed at decode step 9
LAYER_FACTOR = 1.25
LOGITS_FACTOR = 2.0
#: decode steps traced after the traced prefill
PROFILED_STEPS = 8


#: the port's own kernels, by a part of their names, which a device
#: profile reports whether or not they rank in its top
OWN_KERNELS = ("flash_", "rglru_kernel", "ei_kernel", "inv_kernel",
               "nll_", "quant", "bwd::", "rglru_bwd")


def device_profile(run, top: int = 12):
    """Run ``run`` under torch.profiler: its wall time (ms, synchronised,
    with the profiler's own host cost), the device's busy time (the union
    of its kernels' spans, ms), its kernels by device time, the most
    first, the port's own kernels among them, and the seconds the whole
    trace took, its reading included (``trace_s``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t_trace = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # (name, start, end) in us of each device record, read from the
    # profiler's raw results: ``prof.events()`` builds a tree of Python
    # objects at ~0.1 ms an event (on the H100 machine's host, 110 s for
    # xlstm-125m's prefill: 232 k kernels and the host's records of them)
    kernels = [(e.name(), e.start_ns() / 1e3,
                (e.start_ns() + e.duration_ns()) / 1e3)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    busy, end = 0.0, -math.inf
    for start, stop in sorted(k[1:] for k in kernels):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    by_name = {}
    for name, start, stop in kernels:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (stop - start) / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / 1e3 / wall_ms,
                device_kernels=len(kernels),
                top=[dict(kernel=name[:90], ms=ms, launches=n)
                     for name, (ms, n) in ranked],
                own=[dict(kernel=name[:90], ms=ms, launches=n)
                     for name, (ms, n) in by_name.items()
                     if any(k in name for k in OWN_KERNELS)],
                trace_s=time.perf_counter() - t_trace)


def phase_serve():
    """The LM server at full width through ``serve``, spied on at
    ``LM.prefill`` and ``LM.decode_step`` for its logits and the launch
    counts of its prefill; then the same weights and prompts through the
    plain versions, in float32 and in bf16, fed the served tokens, and
    through each planted fault."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as krg
    from repro_torch.launch import serve as srv
    from repro_torch.launch.steps import cast_params
    from repro_torch.models import attention as MA
    from repro_torch.models import model as M
    from repro_torch.models import recurrent as MR

    counters = {"flash_attention": kfa.flash_attention_launches,
                "rglru_scan": krg.rglru_scan_launches}
    counts = lambda: {n: c.count for n, c in counters.items()}  # noqa: E731
    seen = {"steps": []}
    prefill, decode_step = M.LM.prefill, M.LM.decode_step

    def spy_prefill(self, params, batch, cache_len):
        # the weights are made by now: the peak from here on is serving's
        seen["init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        cache, logits = prefill(self, params, batch, cache_len)
        seen.update(params=params, tokens=batch["tokens"],
                    cache_len=cache_len, logits=logits.float().clone(),
                    prefill_launches=counts())
        return cache, logits

    def spy_decode(self, params, cache, tokens):
        logits, cache = decode_step(self, params, cache, tokens)
        seen["steps"].append((tokens.clone(), logits.float().clone()))
        return logits, cache

    lines = []
    # what earlier phases still hold; the peaks below include it
    resident_gb = torch.cuda.memory_allocated() / 1e9
    M.LM.prefill, M.LM.decode_step = spy_prefill, spy_decode
    try:
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        seqs = srv.serve(SERVE["arch"], SERVE["batch"], SERVE["prompt_len"],
                         SERVE["gen"], reduced=SERVE["reduced"], seed=0,
                         log=lines.append)
        wall = time.perf_counter() - t0
        launches = counts()
    finally:
        M.LM.prefill, M.LM.decode_step = prefill, decode_step
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = re.search(r"in ([\d.]+)ms; decoded (\d+) steps in ([\d.]+)ms "
                  r"\(([\d.]+) tok/s\)", lines[-1])
    check(m is not None, f"serve's log line: {lines}")
    prefill_ms, decode_ms, tok_s = (float(m.group(1)), float(m.group(3)),
                                    float(m.group(4)))
    check(seqs.shape == (SERVE["batch"], SERVE["gen"]),
          f"served tokens {seqs.shape}")
    check(seen["prefill_launches"] == PREFILL_LAUNCHES,
          f"prefill launches {seen['prefill_launches']}")
    check(launches == PREFILL_LAUNCHES,
          f"decode launched kernels: {launches} after the prefill's "
          f"{seen['prefill_launches']}")
    check(len(seen["steps"]) == SERVE["gen"] - 1, "decode steps missing")
    served = [torch.as_tensor(seqs[:, i], device=seen["tokens"].device)
              for i in range(SERVE["gen"])]
    check(all(torch.equal(t, s) for (t, _), s in
              zip(seen["steps"], served[:-1])), "decode fed other tokens")
    kernel_logits = [seen["logits"]] + [lg for _, lg in seen["steps"]]
    check(all(bool(torch.isfinite(lg).all()) for lg in kernel_logits),
          "non-finite logits")

    cfg = get_config(SERVE["arch"])
    if SERVE["reduced"]:
        cfg = cfg.reduced()
    params, tokens = seen["params"], seen["tokens"]

    def forced(model, params, steps=len(served) - 1):
        """Prefill and ``steps`` decode steps fed the served tokens ->
        every logits."""
        with torch.inference_mode():
            cache, logits = model.prefill(params, {"tokens": tokens},
                                          seen["cache_len"])
            out = [logits.float()]
            for tok in served[:steps]:
                logits, cache = model.decode_step(params, cache, tok)
                out.append(logits.float())
        return out

    def mixing_layers(ref32=None):
        """Spies on the prefill's mixing layers (attention and RG-LRU,
        the layers that own the kernels) in stack order: their outputs
        as float32 when ``ref32`` is None, else each output's relative
        distance ||y - y32|| / ||y32|| from the float32 model's."""
        got = []

        def spy(fn):
            def spied(*args, **kwargs):
                y, entry = fn(*args, **kwargs)
                if ref32 is None:
                    got.append(y.float())
                else:
                    r = ref32[len(got)]
                    got.append(float(torch.linalg.vector_norm(y.float() - r)
                                     / torch.linalg.vector_norm(r)))
                return y, entry
            return spied
        return got, (patched(MA, attn_forward=spy(MA.attn_forward)),
                     patched(MR, rglru_forward=spy(MR.rglru_forward)))

    def run_spied(model, params, ref32=None, steps=len(served) - 1):
        got, (pa, pr) = mixing_layers(ref32)
        with pa, pr:
            logits = forced(model, params, steps)
        return logits, got

    fa, rg = ops.flash_attention, ops.rglru_scan
    for c in counters.values():
        c.reset()
    with patched(ops, flash_attention=ref.flash_attention_ref,
                 rglru_scan=ref.rglru_scan_ref):
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        f32, layers32 = run_spied(M.LM(cfg32),
                                  cast_params(params, torch.float32))
        t0 = time.perf_counter()
        plain, plain_rel = run_spied(M.LM(cfg), params, layers32)
        plain_s = time.perf_counter() - t0
    check(counts() == {n: 0 for n in counters},
          f"the plain runs launched kernels: {counts()}")
    # the kernel path once more, spied: it must be the served run again
    again, kernel_rel = run_spied(M.LM(cfg), params, layers32, steps=0)
    check(torch.equal(again[0], seen["logits"]),
          "the spied kernel prefill differs from the served one")
    # Both paths round to bf16 at every layer, and a one-step difference
    # anywhere (the kernel's float32 sums run in another order) soon
    # decorrelates that rounding, so the kernel path is held to the
    # float32 model at a multiple of the plain bf16 path's own distance
    # from it: per mixing layer of the prefill, by relative norm, and per
    # step on the logits.
    def layers_ok(rel):
        return all(k <= LAYER_FACTOR * p for k, p in zip(rel, plain_rel))

    k_err = [float((a - b).abs().max()) for a, b in zip(kernel_logits, plain)]
    k_err32 = [float((a - c).abs().max()) for a, c in zip(kernel_logits, f32)]
    bf16_err = [float((b - c).abs().max()) for b, c in zip(plain, f32)]

    def logits_ok(logits):
        return all(float((a - c).abs().max()) <= LOGITS_FACTOR * be
                   for a, c, be in zip(logits, f32, bf16_err))

    check(len(kernel_rel) == len(plain_rel) == len(cfg.pattern),
          f"spied {len(kernel_rel)} mixing layers")
    for i, (ke, pe) in enumerate(zip(kernel_rel, plain_rel)):
        check(ke <= LAYER_FACTOR * pe, f"layer {i} ({cfg.pattern[i]}): "
              f"|kernel - f32| {ke} > {LAYER_FACTOR} x |plain - f32| {pe}")
    for i, (ke, be) in enumerate(zip(k_err32, bf16_err)):
        check(ke <= LOGITS_FACTOR * be, f"logits "
              f"{'prefill' if i == 0 else f'step {i}'}: |kernel - f32| {ke} "
              f"> {LOGITS_FACTOR} x |plain - f32| {be}")
    # Plant a fault in each kernel's place and show that the per-layer
    # limit rejects it; record whether the logits limit would.
    faults = {
        "flash_no_window": dict(flash_attention=lambda q, k, v, *, causal,
                                window, softcap: fa(
                                    q, k, v, causal=causal, window=0,
                                    softcap=softcap)),
        "rglru_one_step_late": dict(rglru_scan=lambda la, b: F.pad(
            rg(la, b)[:, :-1], (0, 0, 1, 0))),
    }
    planted = {}
    for fault, swap in faults.items():
        with patched(ops, **swap):
            logits, rel = run_spied(M.LM(cfg), params, layers32, steps=0)
        first = next((i for i, (fe, pe) in enumerate(zip(rel, plain_rel))
                      if fe > LAYER_FACTOR * pe), None)
        planted[fault] = dict(
            layers_reject=not layers_ok(rel), first_layer_rejected=first,
            worst_layer_ratio=max(fe / max(pe, 1e-30)
                                  for fe, pe in zip(rel, plain_rel)),
            logits_reject=not logits_ok(logits),
            prefill_logits_abs_err_vs_f32=float(
                (logits[0] - f32[0]).abs().max()))
        check(planted[fault]["layers_reject"],
              f"planted fault {fault} passes the per-layer limit: "
              f"{planted[fault]}")
    model = M.LM(cfg)
    prof_cache = {}

    def profiled_prefill():
        with torch.inference_mode():
            prof_cache["c"], _ = model.prefill(params, {"tokens": tokens},
                                               seen["cache_len"])

    def profiled_decode():
        with torch.inference_mode():
            cache = prof_cache["c"]
            for tok in served[:PROFILED_STEPS]:
                _, cache = model.decode_step(params, cache, tok)

    profiles = {"prefill": device_profile(profiled_prefill),
                f"decode_{PROFILED_STEPS}_steps":
                    device_profile(profiled_decode)}
    for name, prof in profiles.items():
        emit("serve_profile", part=name, **prof)
    agree = [int((torch.argmax(p, -1) == s).sum()) for p, s in
             zip(plain, served)]
    agree32 = [int((torch.argmax(p, -1) == s).sum()) for p, s in
               zip(f32, served)]
    emit("serve", **SERVE, wall_s=wall, prefill_ms=prefill_ms,
         decode_ms=decode_ms, decode_tok_s=tok_s,
         decode_steps=int(m.group(2)), resident_before_gb=resident_gb,
         peak_memory_gb=peak_gb,
         init_peak_memory_gb=seen["init_peak_gb"],
         params=sum(t.numel() for t in M.tensors(params)),
         param_gb=sum(t.numel() * t.element_size()
                      for t in M.tensors(params)) / 1e9,
         prefill_launches=seen["prefill_launches"], launches=launches,
         logits_abs_err_kernel_vs_plain=k_err,
         logits_abs_err_kernel_vs_f32=k_err32,
         logits_abs_err_plain_vs_f32=bf16_err,
         layer_rel_err_kernel_vs_f32=kernel_rel,
         layer_rel_err_plain_vs_f32=plain_rel,
         planted_faults=planted,
         greedy_agree_plain=sum(agree), greedy_agree_f32=sum(agree32),
         greedy_total=int(seqs.size), plain_forced_s=plain_s,
         first_tokens=seqs[:, :8].tolist())
    return launches


# ------------------------------------------------------- phases 5b and 5c
#: decode steps of a hold, fed the kernel path's greedy tokens
HOLD_STEPS = 4


def spy_attention(keep):
    """A hold's spy on ``attention.attn_forward`` (the prefill's and
    training's attention; decode calls ``attn_decode``): each output to
    ``keep``."""
    from repro_torch.models import attention as MA
    attn = MA.attn_forward

    def spy(*a, **kw):
        out = attn(*a, **kw)
        keep(out[0] if isinstance(out, tuple) else out)
        return out
    return MA, dict(attn_forward=spy)


def hold_run(cfg, params, batch, cache_len, fed, spies, ref32=None,
             steps=HOLD_STEPS):
    """One run of a hold: the prefill and ``steps`` decode steps, fed the
    tokens in ``fed`` (the first run's greedy tokens, appended as it
    makes them) -> (logits in float32 at the prefill and each step, the
    prefill's spied outputs: float32, or each one's relative distance
    from ``ref32``'s).  ``spies(keep)`` -> [(module, {name: wrapper})],
    patched for the run, whose wrappers hand the outputs to ``keep``."""
    from repro_torch.models import model as M
    layers = []

    def keep(y):
        if ref32 is None:
            layers.append(y.float())
        else:
            r = ref32[len(layers)]
            layers.append(float(torch.linalg.vector_norm(y.float() - r)
                                / torch.linalg.vector_norm(r)))

    with contextlib.ExitStack() as stack, torch.inference_mode():
        for mod, swap in spies(keep):
            stack.enter_context(patched(mod, **swap))
        model = M.LM(cfg)
        cache, lg = model.prefill(params, batch, cache_len)
        logits = [lg.float()]
        for i in range(steps):
            if len(fed) <= i:
                fed.append(torch.argmax(lg, dim=-1))
            lg, cache = model.decode_step(params, cache, fed[i])
            logits.append(lg.float())
    return logits, layers


def hold_paths(arch, cfg, p32, batch, kinds, launches, spies, faults,
               plain_attention):
    """A hold at full width (5b, 5c): the kernel path (bf16 weights cast
    once from the float32 ``p32``), the plain bf16 path and the plain
    float32 model (``ops.flash_attention`` swapped for
    ``plain_attention``), each through ``hold_run`` on the same inputs.
    The kernel path launches ``flash_attention`` exactly ``launches``
    times (the plain runs never), and is no further from float32 than
    ``LAYER_FACTOR`` times the plain path at each spied output of the
    prefill (``kinds`` names them) by relative norm, and ``LOGITS_FACTOR``
    at the logits by max |.|.  ``faults``: {name: (config, params from
    the bf16 weights or None for them, [(module, {name: swap})])}, each
    run on the kernel path, prefill only, must fail the layer limit.
    -> the hold line's fields."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import cast_params
    B, S = batch["tokens"].shape
    n_img = batch["img_embeds"].shape[1] if "img_embeds" in batch else 0
    cache_len = n_img + S + HOLD_STEPS
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p16 = cast_params(p32, torch.bfloat16)
    fed = []
    counters = lm_counters()
    counters["flash_attention"].reset()
    kernel, kernel_layers = hold_run(cfg, p16, batch, cache_len, fed, spies)
    n = counters["flash_attention"].count
    check(n == launches, f"{arch} hold: {n} flash_attention launches in "
          f"a depth-{cfg.n_layers} prefill, not {launches}")
    with patched(ops, flash_attention=plain_attention):
        f32, layers32 = hold_run(cfg32, p32, batch, cache_len, fed, spies)
        plain, plain_rel = hold_run(cfg, p16, batch, cache_len, fed, spies,
                                    layers32)
    check(counters["flash_attention"].count == n,
          "the plain runs launched the kernel")
    kernel_rel = [float(torch.linalg.vector_norm(y - r)
                        / torch.linalg.vector_norm(r))
                  for y, r in zip(kernel_layers, layers32)]
    del kernel_layers
    bf16_err = [float((p - c).abs().max()) for p, c in zip(plain, f32)]
    k_err32 = [float((k - c).abs().max()) for k, c in zip(kernel, f32)]
    check(len(kernel_rel) == len(plain_rel) == len(kinds),
          f"{arch} hold: spied {len(kernel_rel)} layers, not {len(kinds)}")

    def layers_ok(rel):
        return all(k <= LAYER_FACTOR * p for k, p in zip(rel, plain_rel))

    def logits_ok(logits):
        return all(float((a - c).abs().max()) <= LOGITS_FACTOR * be
                   for a, c, be in zip(logits, f32, bf16_err))

    for i, (ke, pe) in enumerate(zip(kernel_rel, plain_rel)):
        check(ke <= LAYER_FACTOR * pe, f"{arch} hold layer {i} "
              f"({kinds[i]}): |kernel - f32| {ke} > {LAYER_FACTOR} x "
              f"|plain - f32| {pe}")
    for i, (ke, be) in enumerate(zip(k_err32, bf16_err)):
        check(ke <= LOGITS_FACTOR * be, f"{arch} hold logits "
              f"{'prefill' if i == 0 else f'step {i}'}: |kernel - f32| {ke}"
              f" > {LOGITS_FACTOR} x |plain - f32| {be}")
    planted = {}
    for fault, (c, make_params, swaps) in faults.items():
        params = p16 if make_params is None else make_params(p16)
        with contextlib.ExitStack() as stack:
            for mod, swap in swaps:
                stack.enter_context(patched(mod, **swap))
            logits, rel = hold_run(c, params, batch, cache_len, fed, spies,
                                   layers32, steps=0)
        del params
        first = next((i for i, (fe, pe) in enumerate(zip(rel, plain_rel))
                      if fe > LAYER_FACTOR * pe), None)
        worst = max(fe / max(pe, 1e-30) for fe, pe in zip(rel, plain_rel))
        planted[fault] = dict(
            layers_reject=not layers_ok(rel), first_layer_rejected=first,
            worst_layer_ratio=worst, over_limit=worst / LAYER_FACTOR,
            logits_reject=not logits_ok(logits))
        check(planted[fault]["layers_reject"],
              f"{arch}: planted fault {fault} passes the layer limit: "
              f"{planted[fault]}")
    return dict(depth=cfg.n_layers, batch=B, prompt_len=S, layers=kinds,
                steps=HOLD_STEPS, layer_rel_err_kernel_vs_f32=kernel_rel,
                layer_rel_err_plain_vs_f32=plain_rel,
                logits_abs_err_kernel_vs_f32=k_err32,
                logits_abs_err_plain_vs_f32=bf16_err,
                planted_faults=planted, hold_launches=n)


def serve_spied(arch, cfg, batch, prompt_len, gen, n_attn, spies=()):
    """``serve(arch, batch, prompt_len, gen, reduced=False, seed=0)`` with
    serve's config lookup answering ``cfg`` (the published config, or a
    cut of its depth), spied on at ``LM.prefill`` and ``LM.decode_step``
    and through ``spies`` [(module, {name: wrapper})]: exactly ``n_attn``
    ``flash_attention`` launches in the prefill and none in decode (the
    counters zeroed just before), finite logits -> (the launches, a run
    for ``profile_served``: its config, weights, inputs and the tokens
    decode was fed, and its line: prefill ms, decode tokens a second,
    peak memory, ...)."""
    from repro_torch.launch import serve as srv
    from repro_torch.models import model as M
    counters = lm_counters()
    counts = lambda: {n: c.count for n, c in counters.items()}  # noqa: E731
    resident_gb = free_card(f"serve {arch}")
    seen = {"steps": []}
    prefill, decode_step = M.LM.prefill, M.LM.decode_step

    def spy_prefill(self, params, batch_, cache_len):
        seen["init_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        cache, logits = prefill(self, params, batch_, cache_len)
        seen.update(logits=logits.float().clone(), params=params,
                    batch=batch_, cache_len=cache_len,
                    prefill_launches=counts())
        return cache, logits

    def spy_decode(self, params, cache, tokens):
        logits, cache = decode_step(self, params, cache, tokens)
        seen["steps"].append((tokens.clone(), torch.isfinite(logits).all()))
        return logits, cache

    lines = []
    with contextlib.ExitStack() as stack:
        for mod, swap in [(M.LM, dict(prefill=spy_prefill,
                                      decode_step=spy_decode)),
                          (srv, dict(get_config=lambda name: cfg)),
                          *spies]:
            stack.enter_context(patched(mod, **swap))
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        seqs = srv.serve(arch, batch, prompt_len, gen, reduced=False, seed=0,
                         log=lines.append)
        wall = time.perf_counter() - t0
        launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = re.search(r"in ([\d.]+)ms; decoded (\d+) steps in ([\d.]+)ms "
                  r"\(([\d.]+) tok/s\)", lines[-1])
    check(m is not None, f"serve's log line: {lines}")
    want = {n: 0 for n in counters}
    want["flash_attention"] = n_attn
    check(seen["prefill_launches"] == want,
          f"{arch} prefill launches {seen['prefill_launches']}")
    check(launches == want, f"{arch}: decode launched kernels: "
          f"{launches} after the prefill's {seen['prefill_launches']}")
    check(seqs.shape == (batch, gen), f"{arch} served {seqs.shape}")
    check(len(seen["steps"]) == gen - 1, f"{arch}: decode steps missing")
    check(bool(torch.isfinite(seen["logits"]).all())
          and all(bool(f) for _, f in seen["steps"]),
          f"{arch}: non-finite logits")
    params = seen["params"]
    line = dict(
        arch=arch, batch=batch, prompt_len=prompt_len, gen=gen,
        reduced=False, layers=cfg.n_layers,
        encoder_layers=cfg.encoder_layers,
        inputs={k: list(v.shape) for k, v in seen["batch"].items()},
        wall_s=wall, prefill_ms=float(m.group(1)),
        decode_ms=float(m.group(3)), decode_tok_s=float(m.group(4)),
        decode_steps=int(m.group(2)), resident_before_gb=resident_gb,
        peak_memory_gb=peak_gb, init_peak_memory_gb=seen["init_peak_gb"],
        params=sum(t.numel() for t in M.tensors(params)),
        param_gb=sum(t.numel() * t.element_size()
                     for t in M.tensors(params)) / 1e9,
        prefill_launches=seen["prefill_launches"], launches=launches,
        first_tokens=seqs[:, :8].tolist())
    run = dict(cfg=cfg, params=params, batch=seen["batch"],
               cache_len=seen["cache_len"],
               fed=[t for t, _ in seen["steps"][:PROFILED_STEPS]], line=line)
    return launches, run


def profile_served(phase: str, served: dict) -> None:
    """Emit each run of ``serve_spied`` (``phase``) and trace one more
    prefill and ``PROFILED_STEPS`` decode steps of it under
    torch.profiler (``phase``_profile), after every serve run of the
    phase: a trace can slow later host-bound decode.  Frees each run."""
    from repro_torch.models import model as M
    for arch, run in served.items():
        model = M.LM(run["cfg"])
        kept = {}

        def profiled_prefill():
            with torch.inference_mode():
                kept["c"], _ = model.prefill(run["params"], run["batch"],
                                             run["cache_len"])

        def profiled_decode():
            with torch.inference_mode():
                cache = kept["c"]
                for tok in run["fed"]:
                    _, cache = model.decode_step(run["params"], cache, tok)

        emit(phase, **run["line"])
        for part, fn in (("prefill", profiled_prefill),
                         (f"decode_{PROFILED_STEPS}_steps", profiled_decode)):
            emit(f"{phase}_profile", arch=arch, part=part,
                 **device_profile(fn))
        del model, kept
        run.clear()
        free_card(f"{phase} {arch} profiled")


# ------------------------------------------------------------ phase 5b
MOE_SERVE = dict(batch=4, prompt_len=3000, gen=64)
#: arch -> (its attention layers, each one ``flash_attention`` launch a
#: prefill; the depth of the float32 hold: deepseek-v2-lite's dense layer
#: and two MoE layers, granite-moe's first two layers; a float32 copy at
#: full depth would be ~63 GB for deepseek)
MOE_ARCHS = {"granite-moe-3b-a800m": (32, 2), "deepseek-v2-lite-16b": (27, 3)}
#: The hold keeps phase 5's LAYER_FACTOR and LOGITS_FACTOR.  bf16 routing
#: flips a share of the router's choices (near top-k ties) against the
#: float32 model, and a few between the kernel and plain bf16 paths; the
#: H100's first run put the kernel path within 1.022x of the plain path's
#: distance at every layer (0.06-0.9% of choices flipped between the two)
#: and its logits within 1.44x, so the factors stand for the MoE family.


def moe_hold(arch: str, depth: int) -> dict:
    """5b's hold (``hold_paths``) at full width and depth ``depth``, the
    weights drawn in float32: every attention and MoE layer of the
    prefill spied, the share of (token, choice) pairs whose expert
    differs from the float32 model's reported, and planted faults (a
    capacity of 1, every choice shifted one expert on, MLA at the padded
    head's default scale) failing the layer limit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.models import moe as MM
    import torch.nn.functional as F

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    B, S = MOE_SERVE["batch"], MOE_SERVE["prompt_len"]
    p32 = M.LM(cfg).init(seed=1, device=dev, dtype=torch.float32)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)), device=dev)}
    #: the router's choices (B,S,k) a layer, one list a run of the hold:
    #: the kernel path, float32, the plain bf16 path, then the faults
    choices = []

    def spies(keep):
        run_choices = []
        choices.append(run_choices)
        moe, router = MM.moe_forward, MM._router

        def spy_moe(p, x, c_):
            y, aux = moe(p, x, c_)
            if x.shape[1] > 1:
                keep(y)
            return y, aux

        def spy_router(p, x, c_):
            w, idx, aux = router(p, x, c_)
            if x.shape[1] > 1:
                run_choices.append(idx)
            return w, idx, aux

        return [spy_attention(keep),
                (MM, dict(moe_forward=spy_moe, _router=spy_router))]

    def flipped(a, b):
        """Share of (token, choice) pairs of ``a`` whose expert is not
        among ``b``'s choices for that token."""
        na = F.one_hot(a, cfg.n_experts).sum(-2)
        nb = F.one_hot(b, cfg.n_experts).sum(-2)
        return float((na - nb).clamp(min=0).sum()) / a.numel()

    fa, router = ops.flash_attention, MM._router

    def shifted(p, x, c_):
        w, idx, aux = router(p, x, c_)
        return w, (idx + 1) % cfg.n_experts, aux

    faults = {"capacity_1": (cfg, None, [(MM, dict(
                  capacity=lambda c_, seq: 1))]),
              "experts_shifted_by_one": (cfg, None, [(MM, dict(
                  _router=shifted))])}
    if cfg.mla:
        faults["mla_default_scale"] = (cfg, None, [(ops, dict(
            flash_attention=lambda q, k, v, **kw: fa(
                q, k, v, **dict(kw, scale=None))))])
    # every layer's attention, then its MoE FFN (a dense MLP is not spied)
    kinds = [kind for i in range(depth) for kind in
             (("attn",) if i < cfg.first_dense_layers else ("attn", "moe"))]
    out = hold_paths(arch, cfg, p32, batch, kinds, depth, spies, faults,
                     ref.flash_attention_ref)
    kernel_idx, idx32, plain_idx = choices[:3]
    out.update(
        flipped_share_kernel_vs_f32=[flipped(a, b) for a, b in
                                     zip(kernel_idx, idx32)],
        flipped_share_plain_vs_f32=[flipped(a, b) for a, b in
                                    zip(plain_idx, idx32)],
        flipped_share_kernel_vs_plain=[flipped(a, b) for a, b in
                                       zip(kernel_idx, plain_idx)])
    del p32, batch, choices
    free_card(f"moe_hold {arch}")
    return out


def phase_moe_serve():
    """5b: ``serve`` of the MoE family at full width and full depth
    (``serve_spied``), also spied at ``moe.slots`` (pairs dropped by
    capacity); once both have served, ``profile_served``, then
    ``moe_hold`` at reduced depth.  -> the LM kernels' launches summed
    over both serve runs (counters zeroed just before each)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MM
    total = {n: 0 for n in lm_counters()}
    B, S, gen = (MOE_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    served = {}
    for arch, (n_attn, _) in MOE_ARCHS.items():
        cfg = get_config(arch)
        drops = []
        slots = MM.slots

        def spy_slots(idx, n_experts, cap):
            dest = slots(idx, n_experts, cap)
            drops.append(((dest == n_experts * cap).sum(), dest.numel()))
            return dest

        launches, run = serve_spied(arch, cfg, B, S, gen, n_attn,
                                    [(MM, dict(slots=spy_slots))])
        moe_layers = cfg.n_layers - cfg.first_dense_layers
        dropped = sum(int(d) for d, _ in drops)
        pairs = sum(n for _, n in drops)
        check(len(drops) == moe_layers
              and pairs == moe_layers * B * S * cfg.top_k,
              f"{arch}: {len(drops)} dispatches of {pairs} pairs")
        run["line"].update(capacity=MM.capacity(cfg, S),
                           dropped_pairs=dropped, pairs=pairs,
                           dropped_share=dropped / pairs)
        for n in total:
            total[n] += launches[n]
        served[arch] = run
    profile_served("moe_serve", served)
    for arch, (_, depth) in MOE_ARCHS.items():
        emit("moe_hold", arch=arch, **moe_hold(arch, depth))
    return total


# ------------------------------------------------------- phases 4c and 4d
#: (name, B, Sq, Skv, H, K, D, causal, dtype) of the encoder-decoder
#: family's and the parallel block's prefill attention at their serve
#: shapes: whisper-medium's encoder (1536 frames, non-causal), its
#: decoder's cross-attention (384 queries over the 1536 encoder positions)
#: and self-attention (384, causal), all 16 heads of 64;
#: command-r-plus-104b's GQA, 96 query heads over 8 KV heads of 128,
#: prompt 3000
ENCDEC_FLASH_CASES = (
    ("whisper_encoder", 4, 1536, 1536, 16, 16, 64, False, "bfloat16"),
    ("whisper_cross", 4, 384, 1536, 16, 16, 64, False, "bfloat16"),
    ("whisper_decoder", 4, 384, 384, 16, 16, 64, True, "bfloat16"),
    ("command_r", 4, 3000, 3000, 96, 8, 128, True, "bfloat16"),
)
#: the same for llava-next-34b's prefill (4d): 2304 image positions and a
#: 1024-token prompt (3328), causal, 56 query heads over 8 KV heads of 128
#: (7 a KV head), in bf16 and float32
VLM_FLASH_CASES = (
    ("llava", 4, 3328, 3328, 56, 8, 128, True, "bfloat16"),
    ("llava_f32", 4, 3328, 3328, 56, 8, 128, True, "float32"),
)


def plain_by_batch(q, k, v, **kw):
    """``ref.flash_attention_ref`` one batch row at a time: the same
    function with a batch's share of its dense float32 scores in memory
    (command-r's are 13.8 GB a call at batch 4)."""
    from repro_torch.kernels import ref
    return torch.cat([ref.flash_attention_ref(q[i:i + 1], k[i:i + 1],
                                              v[i:i + 1], **kw)
                      for i in range(q.shape[0])])


def flash_layouts(cases, where: str):
    """4c, 4d: ``flash_attention`` at each layout of ``cases``, held
    element by element to the float32 oracle on the same inputs
    (``FLASH_TOL``), a planted fault failing that limit (K and V heads
    shifted by one where heads are grouped, else a non-causal layout made
    causal and a causal one non-causal); timed beside the plain version,
    SDPA (the first backend that takes the layout) and the bound (4·D
    operations a visible pair a head; q, k, v and o once) -> {layout: its
    kernel, plain, SDPA and bound times and its error}."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    layouts = {}
    for name, B, Sq, Skv, H, K, D, causal, dtype in cases:
        free_card(f"flash_case {name}")
        gen.manual_seed(Sq + Skv + H)
        dt = getattr(torch, dtype)
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, Skv, K, D), generator=gen, device=dev).to(dt)
                for _ in range(2))
        out = kfa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        # the plain version is float32 inside: on inputs of ``dt`` it is
        # the float32 oracle rounded once to ``dt``
        ref32 = plain_by_batch(q.float(), k.float(), v.float(),
                               causal=causal)
        abs_err = float((out.float() - ref32.to(dt).float()).abs().max())
        excess = flash_excess(out, ref32, dtype)
        check(math.isfinite(excess) and excess <= 1.0,
              f"flash_attention {name}: {excess} x its element-wise limit")
        if K < H:
            fault = "kv_heads_shifted"
            bad = plain_by_batch(q, k.roll(1, dims=2), v.roll(1, dims=2),
                                 causal=causal)
        else:
            fault = "made_noncausal" if causal else "made_causal"
            bad = plain_by_batch(q, k, v, causal=not causal)
        planted = {fault: flash_excess(bad, ref32, dtype)}
        check(planted[fault] > 1.0,
              f"planted fault {fault} passes: {planted[fault]}")
        del bad
        scale = 1.0 / math.sqrt(D)
        backend, sdpa, lib_out = sdpa_backends(q, k, v, scale, causal)
        lib_ms = lib_err = None
        if backend is not None:
            lib_err = rel_err(lib_out.float(), ref32)
            check(lib_err <= SDPA_LIMIT[dtype],
                  f"sdpa {name} ({backend}) disagrees: {lib_err}")
            lib_ms = time_ms(sdpa)
        del lib_out, ref32
        ms = time_ms(lambda: kfa.flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                           causal=causal))
        flops, nbytes = flash_work(B, Sq, Skv, H, K, D, causal, 0,
                                   q.element_size())
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS
                             if dtype == "bfloat16" else PEAK_F32_FLOPS)
        emit("flash_case", case=name, B=B, Sq=Sq, Skv=Skv, H=H, K=K, D=D,
             causal=causal, window=0, softcap=0.0, dtype=dtype,
             tol=FLASH_TOL[dtype], excess=excess,
             planted_excess=planted, max_abs_err=abs_err, ms=ms,
             plain_ms=plain_ms, sdpa_ms=lib_ms, sdpa_backend=backend,
             sdpa_rel_err=lib_err, bound_ms=bound, bound_by=by,
             gflop=flops / 1e9, mbytes=nbytes / 1e6)
        layouts[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del q, k, v, out
    free_card(f"after phase {where}")
    return layouts


#: the sequence-parallel layouts of the flash kernels (the forward in
#: phase 4, the backward in 8e): (name, B, S, H, K, D, window) of the
#: whole sequence, causal, bf16: llava-next-34b's (2304 image and 1024
#: text positions) and recurrentgemma-2b's local attention; one rank's
#: shard is a quarter of the queries, at the quarters of
#: ``OFFSET_QUARTERS`` (the middle and the last), against every key
FLASH_OFFSET_LAYOUTS = (("llava", 4, 3328, 56, 8, 128, 0),
                        ("recurrentgemma_local", 4, 3000, 10, 1, 256, 2048))
OFFSET_QUARTERS = (2, 3)


def offset_mask(n, S, off, window, dev):
    """The causal (and windowed) band of queries off .. off + n - 1 over
    keys 0 .. S - 1, as SDPA takes a mask."""
    qp = torch.arange(off, off + n, device=dev)[:, None]
    kp = torch.arange(S, device=dev)[None, :]
    m = qp >= kp
    if window:
        m &= (qp - kp) < window
    return m


def flash_offsets(backward: bool = False) -> dict:
    """Phase 4 (the forward) and 8e (``backward``): the flash kernel on a
    quarter of the queries of each layout of ``FLASH_OFFSET_LAYOUTS`` at
    ``q_offset`` (``OFFSET_QUARTERS``) against every key, held element by
    element to the plain float32 version at that offset (``flash_excess``
    / ``bwd_excess``), the plain version at offset 0 planted as a fault
    that must fail the limit; timed beside the same call at offset 0
    (the first quarter: its ``ms_offset0`` and bound), the plain version,
    SDPA with the offset band as its mask, and the bound of the offset's
    pairs (``work.flash_work`` / ``flash_bwd_work``); the case's launches
    counted (its hold and its timed calls) -> {layout: its line}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    counter = (kfa.flash_attention_bwd_launches if backward
               else kfa.flash_attention_launches)
    work_fn = flash_bwd_work if backward else flash_work
    dt = torch.bfloat16
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    layouts = {}
    for name, B, S, H, K, D, window in FLASH_OFFSET_LAYOUTS:
        free_card(f"flash_offset {name}")
        n = S // 4
        gen.manual_seed(S + H + D)
        q_all = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
        k, v = (torch.randn((B, S, K, D), generator=gen, device=dev).to(dt)
                for _ in range(2))
        do_all = torch.randn((B, S, H, D), generator=gen, device=dev).to(dt)
        kw = dict(causal=True, window=window)
        scale = 1.0 / math.sqrt(D)
        first = q_all[:, :n].contiguous()
        o0, lse0 = kfa.flash_attention(first, k, v, return_lse=True, **kw)
        do0 = do_all[:, :n].contiguous()
        for quarter in OFFSET_QUARTERS:
            off = quarter * n
            at = dict(kw, q_offset=off)
            q = q_all[:, off:off + n].contiguous()
            launches0 = counter.count
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(backward)
                          for t in (q, k, v))
            mask = offset_mask(n, S, off, window, dev)
            if not backward:
                out = kfa.flash_attention(q, k, v, **at)
                torch.cuda.synchronize()
                want = ref.flash_attention_ref(*f32((q, k, v)), **at)
                excess = flash_excess(out, want, "bfloat16")
                abs_err = float((out.float() - want).abs().max())
                planted = flash_excess(
                    ref.flash_attention_ref(*f32((q, k, v)), **kw), want,
                    "bfloat16")
                lib_out = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
                lib_err = rel_err(lib_out.transpose(1, 2).float(), want)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, scale=scale,
                    enable_gqa=True)
                run = lambda: kfa.flash_attention(q, k, v, **at)  # noqa
                run0 = lambda: kfa.flash_attention(  # noqa: E731
                    first, k, v, **kw)
                plain = lambda: ref.flash_attention_ref(  # noqa: E731
                    q, k, v, **at)
                del out, want, lib_out
            else:
                o, lse = kfa.flash_attention(q, k, v, return_lse=True, **at)
                do = do_all[:, off:off + n].contiguous()
                got = kfa.flash_attention_bwd(q, k, v, o, lse, do, **at)
                torch.cuda.synchronize()
                want = ref.flash_attention_bwd_ref(*f32((q, k, v, o)), lse,
                                                   do.float(), **at)
                excess = bwd_excess(got, want, "bfloat16")
                abs_err = max(float((g.float() - w).abs().max())
                              for g, w in zip(got, want))
                planted = bwd_excess(ref.flash_attention_bwd_ref(
                    *f32((q, k, v, o)), lse, do.float(), **kw), want,
                    "bfloat16")
                lib_o = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
                dot = do.transpose(1, 2)
                lib = lambda: torch.autograd.grad(  # noqa: E731
                    lib_o, (qt, kt, vt), dot, retain_graph=True)
                lib_err = max(rel_err(g.transpose(1, 2).float(), w)
                              for g, w in zip(lib(), want))
                run = lambda: kfa.flash_attention_bwd(  # noqa: E731
                    q, k, v, o, lse, do, **at)
                run0 = lambda: kfa.flash_attention_bwd(  # noqa: E731
                    first, k, v, o0, lse0, do0, **kw)
                plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
                    q, k, v, o, lse, do, **at)
                del got, want
            check(math.isfinite(excess) and excess <= 1.0,
                  f"flash {'bwd ' if backward else ''}{name} at offset "
                  f"{off}: {excess} x its element-wise limit")
            check(planted > 1.0, f"flash {name} at offset {off}: the plain "
                  f"version at offset 0 passes ({planted})")
            check(lib_err <= (SDPA_BWD_LIMIT if backward
                              else SDPA_LIMIT)["bfloat16"],
                  f"sdpa {name} at offset {off} disagrees: {lib_err}")
            ms, ms0 = time_ms(run), time_ms(run0)
            plain_ms, lib_ms = time_ms(plain), time_ms(lib)
            flops, nbytes = work_fn(B, n, S, H, K, D, True, window, 2,
                                    q_offset=off)
            bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            bound0, _ = bound_ms(*work_fn(B, n, S, H, K, D, True, window, 2),
                                 PEAK_BF16_FLOPS)
            line = dict(layout=name, backward=backward, B=B, Sq=n, Skv=S,
                        H=H, K=K, D=D, window=window, q_offset=off,
                        dtype="bfloat16", tol=FLASH_TOL["bfloat16"],
                        excess=excess, planted_offset0_excess=planted,
                        max_abs_err=abs_err, ms=ms, ms_offset0=ms0,
                        plain_ms=plain_ms, library_ms=lib_ms,
                        sdpa_rel_err=lib_err, bound_ms=bound, bound_by=by,
                        bound_ms_offset0=bound0, bound_share=bound / ms,
                        launches=counter.count - launches0,
                        gflop=flops / 1e9, mbytes=nbytes / 1e6)
            emit("flash_offset_case", **line)
            layouts[f"{name}_q{quarter}"] = line
            del qt, kt, vt, mask, lib, run, run0, plain
            if backward:
                del o, lse, do, lib_o, dot
        del q_all, k, v, do_all, first, o0, lse0, do0
    free_card("after flash offsets")
    return layouts


# ------------------------------------------------------------ phase 5c
ENCDEC_SERVE = dict(batch=4, gen=64)
#: arch -> (prompt length, layers served (None: all), flash_attention
#: launches a prefill, the depth of the float32 hold).  whisper-medium:
#: 384 prompt tokens + 64 generated = 448, its decoder's context, over
#: 1536 stub frames; 24 encoder, 24 self- and 24 cross-attention layers,
#: held at full depth (a float32 copy is 3 GB).  command-r-plus-104b: its
#: published widths at 8 of its 64 layers (all 64 in bf16 would be ~208
#: GB; 8 are ~31.5 GB with the tied 6.3 GB table), held at depth 2 (~25
#: GB in float32)
ENCDEC_ARCHS = {"whisper-medium": (384, None, 72, 24),
                "command-r-plus-104b": (3000, 8, 8, 2)}


def served_config(arch: str, layers):
    """The published config of ``arch``, cut to ``layers`` (None: all)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def encdec_hold(arch: str, depth: int, prompt_len: int) -> dict:
    """5c's hold (``hold_paths``) at full width and depth ``depth``
    (whisper's decoder depth; its encoder keeps its 24 layers), the
    weights drawn in float32, the plain attention one batch row at a time
    (``plain_by_batch``): every attention output of the prefill spied
    (the encoder's, the decoder's self- and cross-attention's,
    command-r's), and planted faults failing the layer limit: for whisper
    the encoder run causal, cross-attention fed the decoder's own hidden
    state for keys and values, sinusoidal positions shifted by one; for
    command-r the layers run as sequential blocks (attention, then the
    FFN on the norm of its sum with the input, through ln1's weights)."""
    from repro_torch.models import attention as MA
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0)
    cfg = served_config(arch, depth)
    B = ENCDEC_SERVE["batch"]
    p32 = M.LM(cfg).init(seed=1, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, prompt_len)), device=dev)}
    attn, sincos = MA.attn_forward, M._sincos

    def encoder_causal(*a, **kw):
        if kw.get("causal") is False:
            kw["causal"] = True
        return attn(*a, **kw)

    def cross_own_kv(p, x, *a, **kw):
        if kw.get("kv_source") is not None:
            kw["kv_source"] = x
        return attn(p, x, *a, **kw)

    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model)),
            dtype=torch.float32, device=dev)
        kinds = ["encoder"] * cfg.encoder_layers + ["self", "cross"] * depth
        faults = {
            "encoder_causal": (cfg, None, [(MA, dict(
                attn_forward=encoder_causal))]),
            "cross_fed_own_kv": (cfg, None, [(MA, dict(
                attn_forward=cross_own_kv))]),
            "sincos_shifted_by_one": (cfg, None, [(M, dict(
                _sincos=lambda pos, d, dt: sincos(pos + 1, d, dt)))])}
    else:
        kinds = ["attn"] * depth
        faults = {"sequential_block": (
            dataclasses.replace(cfg, parallel_block=False),
            lambda p16: dict(p16, layers=[dict(lp, ln2=lp["ln1"])
                                          for lp in p16["layers"]]), [])}
    out = hold_paths(arch, cfg, p32, batch, kinds, len(kinds),
                     lambda keep: [spy_attention(keep)], faults,
                     plain_by_batch)
    out["encoder_layers"] = cfg.encoder_layers
    del p32, batch
    free_card(f"encdec_hold {arch}")
    return out


def phase_encdec_serve():
    """5c: ``serve`` of whisper-medium (full depth) and
    command-r-plus-104b (full width, ``ENCDEC_ARCHS``' cut of its depth,
    printed) through ``serve_spied``, batch 4, 64 tokens; once both have
    served, ``profile_served``, then ``encdec_hold``.  -> the LM kernels'
    launches summed over both serve runs (counters zeroed just before
    each)."""
    total = {n: 0 for n in lm_counters()}
    B, gen = ENCDEC_SERVE["batch"], ENCDEC_SERVE["gen"]
    served = {}
    for arch, (S, layers, n_attn, _) in ENCDEC_ARCHS.items():
        cfg = served_config(arch, layers)
        published = served_config(arch, None).n_layers
        if layers is not None:
            print(f"chip_smoke: {arch} served at {layers} of its "
                  f"{published} layers (full width)", flush=True)
        launches, run = serve_spied(arch, cfg, B, S, gen, n_attn)
        run["line"]["published_layers"] = published
        for n in total:
            total[n] += launches[n]
        served[arch] = run
    profile_served("encdec_serve", served)
    for arch, (S, _, _, depth) in ENCDEC_ARCHS.items():
        emit("encdec_hold", arch=arch, **encdec_hold(arch, depth, S))
    return total


# ------------------------------------------------------------ phase 5d
VLM_SERVE = dict(batch=4, gen=64)
#: arch -> (prompt length, layers served (None: all), flash_attention
#: launches a prefill, the depth of the float32 hold).  llava-next-34b:
#: its 2304 stub patch embeddings and a 1024-token prompt (3328 positions,
#: a cache of 3392) at its published widths and 30 of its 60 layers
#: (17.65 B parameters, 35.3 GB of bf16 weights; all 60 would be 68.8 GB,
#: past what the card has beside the ~10.5 GB that phase 3 leaves outside
#: the allocator), held at depth 2 (~8 GB in float32).  xlstm-125m at
#: full depth and width, prompt 3000 (12 mLSTM chunks), no kernel: the
#: reference has none for its blocks
VLM_ARCHS = {"llava-next-34b": (1024, 30, 30, 2),
             "xlstm-125m": (3000, None, 0, 12)}
#: float32 prefill and decode against one forward over the same tokens:
#: max |difference| over max |forward logits|.  The same model in another
#: order of operations (decode's one query against the cache): float32
#: rounding, ~1e-6; a cache or prefix position off by one moves logits
#: by O(1) of their size
FORWARD_TOL = 1e-3


def slstm_share(run: dict) -> dict:
    """xlstm-125m's served prefill once more, the card synchronised around
    each sLSTM layer's call, and one sLSTM layer at the served shape
    traced (``device_profile``): the prefill's ms, the sLSTM layers' ms
    and share of it, the prefill without them, and what one layer's
    per-step loop launches (kernels a layer and a time step)."""
    from repro_torch.models import model as M
    from repro_torch.models import recurrent as R
    model = M.LM(run["cfg"])
    slstm = R.slstm_forward
    spent, first = [], []

    def timed(p, x, cfg, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = slstm(p, x, cfg, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        if not first:
            first.append((p, x))
        return out

    with patched(R, slstm_forward=timed), torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(run["params"], run["batch"], run["cache_len"])
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    p, x = first[0]
    with torch.inference_mode():
        one = device_profile(lambda: slstm(p, x, run["cfg"]), top=6)
    steps = x.shape[1]
    return dict(prefill_ms=prefill_ms, slstm_layers=len(spent),
                slstm_ms=spent, slstm_share=sum(spent) / prefill_ms,
                prefill_without_slstm_ms=prefill_ms - sum(spent),
                one_layer_launches=one["device_kernels"],
                launches_a_step=one["device_kernels"] / steps,
                one_layer_traced=one)


def forward_agrees(cfg, p32, batch) -> dict:
    """In float32: the prefill and ``HOLD_STEPS`` greedy decode steps
    against one ``forward`` over the prompt and the tokens decode was
    fed, each within ``FORWARD_TOL`` of max |forward logits| (a cache or
    a prefix position off by one fails it) -> the hold's fields."""
    from repro_torch.models import model as M
    model = M.LM(dataclasses.replace(cfg, dtype="float32"))
    n_img = batch["img_embeds"].shape[1] if "img_embeds" in batch else 0
    S = batch["tokens"].shape[1]
    with torch.inference_mode():
        cache, lg = model.prefill(p32, batch, n_img + S + HOLD_STEPS)
        logits, fed = [lg], []
        for _ in range(HOLD_STEPS):
            fed.append(torch.argmax(lg, dim=-1))
            lg, cache = model.decode_step(p32, cache, fed[-1])
            logits.append(lg)
        del cache
        tokens = torch.cat([batch["tokens"], torch.stack(fed, dim=1)], 1)
        full, _ = model.forward(p32, dict(batch, tokens=tokens))
        full = full[:, S - 1:]
    scale = float(full.abs().max())
    errs = [float((a - full[:, i]).abs().max()) / scale
            for i, a in enumerate(logits)]
    check(max(errs) <= FORWARD_TOL, f"{cfg.name}: float32 prefill and "
          f"decode against forward: {errs} > {FORWARD_TOL}")
    return dict(forward_rel_err_f32=errs, forward_limit=FORWARD_TOL)


def vlm_hold(arch: str, depth: int, prompt_len: int) -> dict:
    """5d's hold (``hold_paths``) at full width and depth ``depth``, the
    weights drawn in float32, the plain attention one batch row at a time
    (``plain_by_batch``), then ``forward_agrees``.  llava: every attention
    output of the prefill spied; planted faults: the image prefix dropped
    from the text's keys and values (prefix and text attended apart), the
    text's positions counted from 0 instead of from the prefix's end.
    xlstm: every mLSTM and sLSTM block's output (its served path is the
    plain one, so the hold is against float32); planted faults: the mLSTM
    state reset at each chunk, the sLSTM recurrence ``r`` zeroed."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import recurrent as R

    dev = torch.device("cuda", 0)
    cfg = served_config(arch, depth)
    B = VLM_SERVE["batch"]
    p32 = M.LM(cfg).init(seed=1, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, prompt_len)), device=dev)}
    if cfg.family == "vlm":
        n = cfg.n_img_tokens
        batch["img_embeds"] = torch.as_tensor(
            rng.normal(0, 1, (B, n, cfg.d_model)), dtype=torch.float32,
            device=dev)
        fa, positions_in = ops.flash_attention, M.LM._positions_in

        def prefix_dropped(q, k, v, **kw):
            return torch.cat([fa(q[:, :n], k[:, :n], v[:, :n], **kw),
                              fa(q[:, n:], k[:, n:], v[:, n:], **kw)], 1)

        def text_from_0(self, x):
            x, pos = positions_in(self, x)
            return x, torch.cat([pos[:n], pos[n:] - n])

        kinds, launches = ["attn"] * depth, depth

        def spies(keep):
            return [spy_attention(keep)]

        faults = {
            "prefix_dropped_from_kv": (cfg, None, [(ops, dict(
                flash_attention=prefix_dropped))]),
            "text_positions_from_0": (cfg, None, [(M.LM, dict(
                _positions_in=text_from_0))])}
    else:
        kinds, launches = list(cfg.pattern), 0
        chunk = R._mlstm_chunk

        def spies(keep):
            def spy(fwd):
                def run(*a, **kw):
                    out = fwd(*a, **kw)
                    keep(out[0] if isinstance(out, tuple) else out)
                    return out
                return run
            return [(R, dict(mlstm_forward=spy(R.mlstm_forward),
                             slstm_forward=spy(R.slstm_forward)))]

        def chunk_from_zero(carry, inp, scale):
            C, nn, m = carry
            return chunk((torch.zeros_like(C), torch.zeros_like(nn),
                          torch.full_like(m, -60.0)), inp, scale)

        def r_zeroed(p16):
            return dict(p16, layers=[
                dict(lp, slstm=dict(lp["slstm"], r=torch.zeros_like(
                    lp["slstm"]["r"]))) if "slstm" in lp else lp
                for lp in p16["layers"]])

        faults = {
            "mlstm_state_reset_each_chunk": (cfg, None, [(R, dict(
                _mlstm_chunk=chunk_from_zero))]),
            "slstm_r_zeroed": (cfg, r_zeroed, [])}
    t0 = time.perf_counter()
    out = hold_paths(arch, cfg, p32, batch, kinds, launches, spies, faults,
                     plain_by_batch)
    out.update(forward_agrees(cfg, p32, batch),
               n_img_tokens=cfg.n_img_tokens,
               hold_s=time.perf_counter() - t0)
    del p32, batch
    free_card(f"vlm_hold {arch}")
    return out


def phase_vlm_serve():
    """5d: ``serve`` of llava-next-34b (full width, ``VLM_ARCHS``' cut of
    its depth, printed) and xlstm-125m (full depth) through
    ``serve_spied``, batch 4, 64 tokens: the cache sized n_img + prompt +
    gen; xlstm's sLSTM share (``slstm_share``); once both have served,
    ``profile_served``, then ``vlm_hold``.  -> the LM kernels' launches
    summed over both serve runs (counters zeroed just before each)."""
    total = {n: 0 for n in lm_counters()}
    B, gen = VLM_SERVE["batch"], VLM_SERVE["gen"]
    served = {}
    for arch, (S, layers, n_attn, _) in VLM_ARCHS.items():
        cfg = served_config(arch, layers)
        published = served_config(arch, None).n_layers
        if layers is not None:
            print(f"chip_smoke: {arch} served at {layers} of its "
                  f"{published} layers (full width)", flush=True)
        launches, run = serve_spied(arch, cfg, B, S, gen, n_attn)
        n_img = cfg.n_img_tokens
        check(run["cache_len"] == n_img + S + gen,
              f"{arch}: serve's cache holds {run['cache_len']} positions, "
              f"not {n_img} + {S} + {gen}")
        run["line"].update(published_layers=published, n_img_tokens=n_img,
                           cache_len=run["cache_len"])
        if cfg.family == "ssm":
            run["line"]["slstm"] = slstm_share(run)
        for n in total:
            total[n] += launches[n]
        served[arch] = run
    profile_served("vlm_serve", served)
    for arch, (S, _, _, depth) in VLM_ARCHS.items():
        emit("vlm_hold", arch=arch, **vlm_hold(arch, depth, S))
    return total


# ------------------------------------------------------------- phase 6
#: the gradient tree of phase 6b: every parameter of recurrentgemma-2b at
#: full width, in float32 (308 leaves, 2 894 481 920 elements)
COMPRESS_ARCH = "recurrentgemma-2b"
TREE_LEAVES = 308
COMPRESS_STEPS = 3
#: phase 6c: ranks on the one card, each over the reduced tree
RANKS = 4
RANK_TIMEOUT_S = 240
#: |reduced - mean| limit of phase 6c in units of 2^-23 x the mean of the
#: ranks' |sent|: a float32 sum of 4 terms is off by at most 3 x 2^-24 of
#: their magnitude sum, and the division by 4 is exact
RANK_ULPS = 4
#: (name, elements) of phase 6a's kernel cases besides the NaN/inf blocks;
#: the first is the tree's largest leaf, the embedding gradient
#: (256 000 x 2560), the last passes 2^31 elements, so its offsets need
#: 64 bits
QUANT_CASES = (("embed", 256_000 * 2560), ("ragged", 256 * 4099 + 17),
               ("small", 100), ("over_2^31", 2 ** 31 + 1000))
#: plain versions are compared in chunks of this many blocks (4.3 GB)
QUANT_CHUNK = 2 ** 22


def q8_same(a, b) -> bool:
    """Two (q, scales) results equal bit for bit, NaN scales where NaN."""
    (qa, sa), (qb, sb) = a, b
    return (torch.equal(qa, qb) and torch.equal(sa.isnan(), sb.isnan())
            and torch.equal(sa.nan_to_num(), sb.nan_to_num()))


def phase_quant_kernels():
    """6a: the int8 kernel against its plain version on the card, bit for
    bit, at the tree's largest leaf, ragged and short inputs, NaN and inf
    blocks, and one buffer past 2^31 elements compared in chunks."""
    from repro_torch.kernels import int8_quant as kq8
    from repro_torch.kernels import ref
    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    summary = {}
    # a NaN block, an inf block, a -inf block, then exact halves
    x = torch.zeros(4 * 256, device=dev)
    x[:768] = torch.randn(768, generator=gen.manual_seed(1), device=dev)
    x[3], x[300], x[600] = float("nan"), float("inf"), -float("inf")
    x[768:] = torch.arange(256, device=dev) - 127.5
    got, want = kq8.int8_quantize(x), ref.int8_quant_ref(x)
    torch.cuda.synchronize()
    check(q8_same(got, want), "int8_quantize NaN/inf blocks vs plain")
    s = got[1].tolist()
    check(math.isnan(s[0]) and s[1] == s[2] == math.inf
          and math.isfinite(s[3]), f"NaN/inf block scales {s}")
    check(not bool(got[0][:3].any()), "NaN/inf blocks have nonzero codes")
    emit("quant_case", case="nan_inf", n=x.numel(), equal=True, scales=s[:3])
    for name, n in QUANT_CASES:
        x = torch.randn(n, generator=gen.manual_seed(n), device=dev)
        q, sc = kq8.int8_quantize(x)
        torch.cuda.synchronize()
        equal = True
        for b0 in range(0, sc.numel(), QUANT_CHUNK):
            chunk = x[b0 * 256:(b0 + QUANT_CHUNK) * 256]
            equal &= q8_same((q[b0:b0 + QUANT_CHUNK],
                              sc[b0:b0 + QUANT_CHUNK]),
                             ref.int8_quant_ref(chunk))
        check(equal, f"int8_quantize {name} (n={n}) differs from plain")
        del q, sc
        ms = time_ms(lambda: kq8.int8_quantize(x))
        plain_ms = (None if n > QUANT_CHUNK * 256
                    else time_ms(lambda: ref.int8_quant_ref(x)))
        bound, by = bound_ms(*q8_work(n))
        emit("quant_case", case=name, n=n, equal=True, ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
             gbytes=q8_work(n)[1] / 1e9)
        if name == "embed":
            summary["int8_quantize"] = dict(
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)
        del x
        torch.cuda.empty_cache()
    return summary


#: phase 6d: the benchmark's state (granite-moe-3b-a800m at depth 4), the
#: population's trials and per-trial hyperparameters
ADAMW_DEPTH = 4
ADAMW_LR, ADAMW_DECAY = (1e-4, 3e-4, 6e-4, 1e-3), (0.01, 0.02, 0.05, 0.1)


def adamw_state(shapes, trials, g_dtype, dev, seed):
    """(params, grads, m, v) lists at ``shapes``, stacked over ``trials``
    (None: one trial), float32 but the gradients, made from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead = () if trials is None else (trials,)
    params = [torch.randn(lead + s, generator=gen, device=dev) * 0.02
              for s in shapes]
    grads = [(torch.randn(lead + s, generator=gen, device=dev) * 1e-3)
             .to(g_dtype) for s in shapes]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    return params, grads, m, v


def phase_adamw_kernel():
    """6d: AdamW's kernels at the benchmark's state against the plain
    update -> {"adamw": the population's numbers, with the single
    trial's beside them}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import adamw as kaw
    from repro_torch.models import LM
    from repro_torch.models.model import tensors
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as A
    dev = torch.device("cuda", 0)
    free_card("before phase 6d")
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              n_layers=ADAMW_DEPTH)
    shapes = [tuple(t.shape) for t in tensors(LM(cfg).init(0, "meta"))]
    big = max(range(len(shapes)), key=lambda i: math.prod(shapes[i]))
    out = {}
    for case, trials, g_dtype, ocfg in (
            ("population", 4, torch.float32, AdamWConfig(weight_decay=0.0)),
            ("single", None, torch.bfloat16, AdamWConfig(lr=3e-4))):
        count = trials or 1
        params, grads, m, v = adamw_state(shapes, trials, g_dtype, dev, 1)
        step = torch.zeros(() if trials is None else (count,),
                           dtype=torch.int32, device=dev)
        if trials is None:
            lr, decay = ocfg.lr, None
        else:
            lr = torch.tensor(ADAMW_LR, device=dev)
            decay = torch.tensor(ADAMW_DECAY, device=dev)

        def kernel(p=params, step=step):
            def one(g, m, v, step, p, lr, d):
                return A.adamw_update(g, {"m": m, "v": v, "step": step}, p,
                                      ocfg, lr, decay=d)
            if trials is None:
                return one(grads, m, v, step, p, lr, decay)[2]["grad_norm"]
            return torch.func.vmap(one)(grads, m, v, step, p, lr,
                                        decay)[2]["grad_norm"]

        def plain(p=params, step=step):
            def one(g, m, v, step, p, lr, d):
                return A._plain(g, m, v, p, step + 1, lr, d, ocfg)
            if trials is None:
                return one(grads, m, v, step, p, lr, decay)
            return torch.func.vmap(one)(grads, m, v, step, p, lr, decay)

        # one checked update: the largest leaf and the first leaf of each
        # of the three smallest shapes copied first, and updated by the
        # plain path at the kernel's norm
        first_of = {}
        for i, shape in enumerate(shapes):
            first_of.setdefault(shape, i)
        keep = [big] + sorted(first_of.values(),
                              key=lambda i: math.prod(shapes[i]))[:3]
        saved = {i: [t[i].clone() for t in (params, m, v)] for i in keep}
        kaw.adamw_launches.reset()
        norm = kernel()
        torch.cuda.synchronize()
        launches = kaw.adamw_launches.count
        check(launches == len(shapes),
              f"adamw {case}: {launches} launches for {len(shapes)} leaves")
        per = (lambda x, i: x if trials is None or not isinstance(
            x, torch.Tensor) else x[i])
        plain_norm = torch.stack([A.global_norm(
            [g if trials is None else g[i] for g in grads])
            for i in range(count)]).reshape(norm.shape)
        norm_err = rel_err(norm, plain_norm)
        check(norm_err <= 1e-6, f"adamw {case}: norm off by {norm_err}")
        errs = {}
        for i in keep:
            p0, m0, v0 = saved[i]
            for t in range(count):
                at = (lambda x: x) if trials is None else (lambda x: x[t])
                scale, c1, c2 = A._coefficients(
                    per(norm, t), per(step + 1, t), ocfg)
                A._plain_leaf(at(grads[i]), at(m0), at(v0), at(p0), scale,
                              c1, c2, per(lr, t), ocfg, per(decay, t))
            errs[i] = max(rel_err(params[i], p0), rel_err(m[i], m0),
                          rel_err(v[i], v0))
            check(errs[i] <= 1e-6, f"adamw {case}: leaf {shapes[i]} off by "
                                   f"{errs[i]}")
        del saved
        # two runs from the same state give the same bits
        snap = [t.clone() for t in (params[big], m[big], v[big])]
        first = kernel()
        after = [t.clone() for t in (params[big], m[big], v[big])]
        for dst, src in zip((params[big], m[big], v[big]), snap):
            dst.copy_(src)
        second = kernel()
        torch.cuda.synchronize()
        same = (torch.equal(first, second) and all(
            torch.equal(a, b) for a, b in zip(
                after, (params[big], m[big], v[big]))))
        check(same, f"adamw {case}: two runs differ")
        del snap, after
        n = sum(math.prod(s) for s in shapes) * count
        flops = bytes_ = 0.0
        for s in shapes:
            k = math.prod(s) * count
            f1, b1 = adamw_work(k, 4, torch.finfo(g_dtype).bits // 8)
            f2, b2 = sumsq_work(k, torch.finfo(g_dtype).bits // 8)
            flops, bytes_ = flops + f1 + f2, bytes_ + b1 + b2
        bound, by = bound_ms(flops, bytes_)
        ms = time_ms(kernel, budget_s=1.0)
        plain_ms = time_ms(plain, budget_s=1.0)
        torch.cuda.synchronize()
        line = dict(case=case, trials=count, leaves=len(shapes),
                    elements=n, grad_dtype=str(g_dtype), launches=launches,
                    norm_err=norm_err,
                    leaf_errs={f"{i} {shapes[i]}": e
                               for i, e in errs.items()},
                    repeats=same, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=by, gbytes=bytes_ / 1e9,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit("adamw", **line)
        out[case] = line
        del params, grads, m, v
        free_card(f"after phase 6d {case}")
    pop, solo = out["population"], out["single"]
    return {"adamw": dict(
        max_rel_err=max(max(pop["leaf_errs"].values()),
                        max(solo["leaf_errs"].values())),
        ms=pop["ms"], plain_ms=pop["plain_ms"], bound_ms=pop["bound_ms"],
        bound_by=pop["bound_by"], library_ms=None, single_ms=solo["ms"],
        single_plain_ms=solo["plain_ms"], single_bound_ms=solo["bound_ms"])}


def _process_group(backend: str, rank: int, world: int, store: str):
    import datetime
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))


def phase_compress():
    """6b: ``compressed_psum_tree`` over recurrentgemma-2b's full gradient
    tree in float32, world size 1 (NCCL on the card), 3 steps carrying
    the error: 308 kernel launches a step, every step's reduced and new
    error bit for bit against the same step through the plain version,
    and the error-feedback drift bound of the reference's test."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compress
    from repro_torch.kernels import int8_quant as kq8
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    meta = M.LM(get_config(COMPRESS_ARCH)).init(device="meta",
                                                 dtype=torch.float32)
    n_leaves = len(list(M.tensors(meta)))
    n_elems = sum(t.numel() for t in M.tensors(meta))
    check(n_leaves == TREE_LEAVES, f"{n_leaves} leaves")
    gen = torch.Generator(device=dev)

    def draw(step):
        gen.manual_seed(step)
        return M.tree_map(lambda t: torch.randn(
            t.shape, generator=gen, device=dev), meta)

    zeros = lambda: M.tree_map(  # noqa: E731
        lambda t: torch.zeros(t.shape, device=dev), meta)
    _process_group("nccl", 0, 1, str(pathlib.Path(tempfile.mkdtemp(
        prefix="chip-smoke-pg-")) / "store"))
    try:
        errs, drift = zeros(), zeros()
        steps = []
        kq8.int8_quantize_launches.reset()
        for step in range(COMPRESS_STEPS):
            grads = draw(step)
            torch.cuda.synchronize()
            before = kq8.int8_quantize_launches.count
            step_resident = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            reduced, new_errs = compress.compressed_psum_tree(grads, errs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            launched = kq8.int8_quantize_launches.count - before
            check(launched == TREE_LEAVES,
                  f"step {step}: {launched} int8_quantize launches")
            # the same step through the plain version, leaf by leaf, the
            # largest (first) leaf last, freeing each leaf as it goes
            g_l, r_l = list(M.tensors(grads)), list(M.tensors(reduced))
            del grads, reduced
            e_l, ne_l = list(M.tensors(errs)), list(M.tensors(new_errs))
            d_l = list(M.tensors(drift))
            equal = True
            with patched(ops, int8_quantize=ref.int8_quant_ref):
                for i in reversed(range(n_leaves)):
                    g, r = g_l.pop(), r_l.pop()
                    if i == 0:
                        # the plain path's 2.6 GB temporaries of the
                        # embedding leaf can find the ~13 GB the cache
                        # holds free too fragmented for one of them (an
                        # OOM at ~60 GB of 80 on the H100): hand it back
                        torch.cuda.empty_cache()
                    pr, pe = compress.compressed_psum(g, e_l[i])
                    equal &= torch.equal(pr, r) and torch.equal(pe, ne_l[i])
                    # world size 1: reduced is what was sent
                    d_l[i].add_(g - r)
                    del g, r, pr, pe
            check(kq8.int8_quantize_launches.count - before == TREE_LEAVES,
                  "the plain path launched the kernel")
            check(equal, f"step {step}: kernel path differs from plain")
            errs = new_errs
            del e_l, ne_l, d_l
            steps.append(dict(step=step, ms=ms, launches=launched,
                              resident_gb=step_resident, peak_gb=peak,
                              equal=equal))
        launches = kq8.int8_quantize_launches.count
        # the reference's drift bound (tests/test_compress.py): accumulated
        # gradients minus accumulated sent values stay within the residual
        err_max = max(float(t.abs().max()) for t in M.tensors(errs))
        drift_max = max(float(t.abs().max()) for t in M.tensors(drift))
        check(drift_max <= err_max + 1e-5,
              f"drift {drift_max} > max|err| {err_max} + 1e-5")
        del drift
        # one more step, unchecked, under torch.profiler
        grads = draw(COMPRESS_STEPS)
        prof = device_profile(
            lambda: compress.compressed_psum_tree(grads, errs))
        del grads, errs
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    bound, by = bound_ms(0, 16 * n_elems)
    q8_bound, _ = bound_ms(*q8_work(n_elems))
    emit("compress", arch=COMPRESS_ARCH, leaves=n_leaves, elements=n_elems,
         steps=steps, launches=launches, resident_before_gb=resident_gb,
         drift_max=drift_max, err_max=err_max, step_bound_ms=bound,
         step_bound_by=by, kernel_bound_ms_per_step=q8_bound,
         ms_per_step=[s_["ms"] for s_ in steps], profile=prof)
    return {"int8_quantize": launches}


def compress_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of phase 6c: ``compressed_psum_tree`` over the reduced
    recurrentgemma-2b tree, grads drawn on the card from (rank, step), 3
    steps carrying the error, gloo all-reduces of CUDA tensors.  Every
    rank replays all ranks' steps through the plain version to hold its
    new error bit for bit and its reduced tensor against the float64 mean
    of the ranks' sent tensors; it writes what it found to ``out``."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import compress
    from repro_torch.kernels import int8_quant as kq8
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    meta = list(M.tensors(M.LM(get_config(COMPRESS_ARCH).reduced()).init(
        device="meta", dtype=torch.float32)))
    gen = torch.Generator(device=dev)

    def draw(r, step):
        gen.manual_seed(1000 * r + step)
        return [torch.randn(t.shape, generator=gen, device=dev) for t in meta]

    _process_group("gloo", rank, world, store)
    try:
        errs = [torch.zeros(t.shape, device=dev) for t in meta]
        plain_errs = [[e.clone() for e in errs] for _ in range(world)]
        stats = dict(rank=rank, launches=[], new_err_equal=True,
                     worst_ulps=0.0)
        for step in range(COMPRESS_STEPS):
            kq8.int8_quantize_launches.reset()
            reduced, errs = compress.compressed_psum_tree(draw(rank, step),
                                                          errs)
            torch.cuda.synchronize()
            stats["launches"].append(kq8.int8_quantize_launches.count)
            sent_sum = [torch.zeros(t.shape, dtype=torch.float64,
                                    device=dev) for t in meta]
            mag = [s_.clone() for s_ in sent_sum]
            for r in range(world):
                for i, g in enumerate(draw(r, step)):
                    corrected = g + plain_errs[r][i]
                    q, sc = ref.int8_quant_ref(corrected)
                    sent = compress.dequantize(q, sc, g.shape)
                    plain_errs[r][i] = corrected - sent
                    sent_sum[i] += sent.double()
                    mag[i] += sent.double().abs()
            for i in range(len(meta)):
                stats["new_err_equal"] &= torch.equal(errs[i],
                                                      plain_errs[rank][i])
                ulps = ((reduced[i].double() - sent_sum[i] / world).abs()
                        / (2.0 ** -23 * mag[i] / world).clamp(min=1e-300))
                stats["worst_ulps"] = max(stats["worst_ulps"],
                                          float(ulps.max()))
        stats["leaves"] = len(meta)
    finally:
        dist.destroy_process_group()
    pathlib.Path(out).write_text(json.dumps(stats))


def phase_compress_ranks():
    """6c: four gloo ranks on the one card (the smoke has one card, so
    NCCL cannot place four ranks), file-store rendezvous; a rank that
    fails or outlives ``RANK_TIMEOUT_S`` fails the run and the others are
    killed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-ranks-"))
    store = str(work / "store")
    procs = [ctx.Process(target=compress_rank,
                         args=(r, RANKS, store, str(work / f"rank{r}.json")))
             for r in range(RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    wall = time.perf_counter() - t0
    codes = [p.exitcode for p in procs]
    check(codes == [0] * RANKS, f"ranks exited {codes} (None: hung)")
    stats = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(RANKS)]
    for st in stats:
        check(st["launches"] == [st["leaves"]] * COMPRESS_STEPS,
              f"rank {st['rank']} launches {st['launches']}")
        check(st["new_err_equal"], f"rank {st['rank']} new_err differs")
        check(st["worst_ulps"] <= RANK_ULPS,
              f"rank {st['rank']} reduced {st['worst_ulps']} ulps off")
    emit("compress_ranks", ranks=RANKS, backend="gloo", wall_s=wall,
         limit_ulps=RANK_ULPS, stats=stats)


# ------------------------------------------------------------- phase 7
def phase_device_times():
    """The device time of ``gp_ei`` at every case of phase 2 and of
    ``rglru_scan`` at every case of phase 4, on the same inputs (the same
    seeds), by torch.profiler: at small shapes the CUDA-event time of a
    wrapper call is the host's.  Last, so the profiler runs after every
    end-to-end measurement."""
    from repro_torch.kernels import gp as kgp
    from repro_torch.kernels import rglru_scan as krg
    dev = torch.device("cuda", 0)
    ei = ("ei_kernel", "inv_kernel", "small_kernel")
    for k in KS:
        for b in BS:
            args = ei_inputs(*gp_case(k, b, seed=1000 * k + b, dev=dev), m=M,
                             seed=k + b)
            emit("device_time", kernel="gp_ei", k=k, b=b, m=M,
                 ms=device_ms(lambda: kgp.gp_ei(*args), ei),
                 event_ms=time_ms(lambda: kgp.gp_ei(*args)))
    for k, b, m in [(1, b, M) for b in EI_BS] + list(EI_RAGGED):
        args = ei_inputs(*gp_case(k, b, seed=b if k == 1 else b + k, dev=dev),
                         m=m, seed=b)
        emit("device_time", kernel="gp_ei", k=k, b=b, m=m,
             ms=device_ms(lambda: kgp.gp_ei(*args), ei),
             event_ms=time_ms(lambda: kgp.gp_ei(*args)))
        del args
    gen = torch.Generator(device=dev)
    for name, B, S, R in SCAN_CASES:
        gen.manual_seed(S + R)
        la = -0.5 * torch.rand((B, S, R), generator=gen, device=dev)
        b = torch.randn((B, S, R), generator=gen, device=dev)
        emit("device_time", kernel="rglru_scan", case=name, B=B, S=S, R=R,
             ms=device_ms(lambda: krg.rglru_scan(la, b),
                          ("rglru_kernel", "Memset")),
             event_ms=time_ms(lambda: krg.rglru_scan(la, b)))
        del la, b


# ------------------------------------------------------------- phase 8
#: (name, B, Sq, Skv, H, K, D, causal, window, softcap, dtype) of phase
#: 8a: the first two are the train shape of recurrentgemma-2b's local
#: attention (batch 1 x 3000, window 2048, no attention softcap);
#: "gqa_d256" sums the bf16 kernel's per-head shares over several KV heads
#: and batches at the largest head dim, "population" is the folded shape
#: phase 8d launches (3 trials x 1024)
BWD_CASES = (
    ("train", 1, 3000, 3000, 10, 1, 256, True, 2048, 0.0, "bfloat16"),
    ("train_f32", 1, 3000, 3000, 10, 1, 256, True, 2048, 0.0, "float32"),
    ("gqa_d256", 2, 1000, 1000, 8, 2, 256, True, 512, 0.0, "bfloat16"),
    ("population", 3, 1024, 1024, 10, 1, 256, True, 2048, 0.0, "bfloat16"),
    ("s1", 2, 1, 1, 4, 2, 64, True, 0, 0.0, "bfloat16"),
    ("s65", 2, 65, 65, 4, 2, 64, True, 32, 0.0, "bfloat16"),
    ("s1000_f32", 1, 1000, 1000, 4, 2, 64, True, 0, 0.0, "float32"),
    ("gqa_window32", 2, 1000, 1000, 4, 2, 64, True, 32, 0.0, "bfloat16"),
    ("softcap30", 1, 1000, 1000, 4, 2, 128, True, 0, 30.0, "bfloat16"),
    ("softcap30_f32", 1, 1000, 1000, 4, 2, 128, True, 0, 30.0, "float32"),
    ("d16", 2, 1000, 1000, 4, 2, 16, True, 0, 0.0, "bfloat16"),
    ("d128_window_f32", 1, 1000, 1000, 8, 2, 128, True, 256, 0.0, "float32"),
    ("noncausal_d16_f32", 2, 300, 300, 4, 4, 16, False, 0, 0.0, "float32"),
    ("mla_scaled", 1, 1000, 1000, 16, 16, 256, True, 0, 0.0, "bfloat16"),
    # D 32, zero-padded to 64 by the wrapper (phase 4's gqa_ragged_d32)
    ("gqa_ragged_d32", 2, 70, 70, 8, 2, 32, True, 0, 0.0, "bfloat16"),
    ("gqa_ragged_d32_f32", 2, 70, 70, 8, 2, 32, True, 0, 0.0, "float32"),
)
#: phase 8e: the attention layouts the MoE, encoder-decoder,
#: parallel-block and VLM families train at, the reference's train_4k
#: sequence (4096) at batch 1, bf16: granite-moe's G 3 at D 64; MLA's
#: q/k 192 and v 128 zero-padded to 256 (``BWD_WIDTHS``) at 1/sqrt(192);
#: whisper-medium's encoder (1536 frames, non-causal), cross-attention
#: (4096 queries over 1536 encoder positions, non-causal) and decoder
#: self-attention; command-r's G 12 and llava's G 7 at D 128
FAMILY_BWD_CASES = (
    ("granite_moe_train", 1, 4096, 4096, 24, 8, 64, True, 0, 0.0,
     "bfloat16"),
    ("mla_train", 1, 4096, 4096, 16, 16, 256, True, 0, 0.0, "bfloat16"),
    ("whisper_encoder_train", 1, 1536, 1536, 16, 16, 64, False, 0, 0.0,
     "bfloat16"),
    ("whisper_cross_train", 1, 4096, 1536, 16, 16, 64, False, 0, 0.0,
     "bfloat16"),
    ("whisper_decoder_train", 1, 4096, 4096, 16, 16, 64, True, 0, 0.0,
     "bfloat16"),
    ("command_r_train", 1, 4096, 4096, 96, 8, 128, True, 0, 0.0,
     "bfloat16"),
    ("llava_train", 1, 4096, 4096, 56, 8, 128, True, 0, 0.0, "bfloat16"),
)
#: the true q/k and v widths of a case whose heads the model zero-pads to
#: the kernel's head dim (MLA): the padded columns of q, k, v and dO are
#: zero, as the model's, and the bound counts the true widths
BWD_WIDTHS = {"mla_train": (192, 128)}
#: cases of BWD_CASES run with a scale of their own: MLA's 1/sqrt(192) on
#: heads padded to 256 (the kernel's default would be 1/16)
BWD_SCALE = {"mla_scaled": 1.0 / math.sqrt(192),
             "mla_train": 1.0 / math.sqrt(192)}
#: std of q and k under a softcap: scores of std 16 reach where the cap
#: bends (tanh(16/30) = 0.49, its derivative 0.76), so dropping the
#: derivative is a fault the limit can see; unit inputs leave the cap
#: nearly linear there (a derivative of 0.999)
CAP_STD = 4.0
#: the backward's absolute floor, a share of the largest gradient's rms
#: (bwd_excess):
#: dP = dO.V and D = dO.O are D-term float32 sums of about sqrt(D) at unit
#: inputs (16 at D = 256), summed in other orders, so where they cancel
#: (dS -> 0) 2^-24 * 16 * 16 ~ 1.5e-5 is left, carried into dq by K / 16:
#: ~1e-5 of dq's rms at the train shape (on the H100: 1.2e-5 in the first
#: query row, the kernel 8.4e-7 from the plain float32 version there)
BWD_FLOOR = 1e-4
#: |lse_kernel - lse_plain| limit: both are float32 log-sum-exps of the
#: same float32 scores, summed in other orders
LSE_LIMIT = 1e-4
#: max |sdpa grad - plain| / max |plain| of the library yardstick, which
#: in bf16 rounds P and dS before its products: a sanity check that it
#: computes the same function, not a limit on the port
SDPA_BWD_LIMIT = {"float32": 1e-3, "bfloat16": 1e-1}
#: (name, B, S, R) of the scan's backward; the first is the train shape
SCAN_BWD_CASES = (("train", 1, 3000, 2560), ("s1", 2, 1, 1000),
                  ("s65", 3, 65, 1000), ("r999", 2, 129, 999))
#: phase 8b: recurrentgemma-2b at its published widths, trained
TRAIN = dict(arch="recurrentgemma-2b", reduced=False, batch=1, seq=3000,
             steps=4, warmup=2)
#: launches a train step: 8 local-attention and 18 RG-LRU layers, each
#: forward run twice under remat "full" (forward, then recomputed), and
#: AdamW's update once each of the 308 parameter leaves
TRAIN_LAUNCHES = {"flash_attention": 16, "flash_attention_bwd": 8,
                  "rglru_scan": 36, "rglru_scan_bwd": 18, "adamw": 308}
#: phase 8c: one step at full width and depth 3, one (R, R, A) group; how
#: much further than the plain bf16 path the kernel path may be from the
#: float32 model, per gradient leaf by relative norm, and on the loss
#: (with a floor of 1e-3, about one bf16 rounding of a logit averaged
#: over 3000 tokens, as a scalar's distance can be near 0 by chance)
HOLD_DEPTH = 3
GRAD_FACTOR = 1.5
LOSS_FACTOR = 2.0
LOSS_FLOOR = 1e-3
#: the same at depth 3, whose 37 parameter leaves AdamW updates in 8d (8c
#: takes the gradients alone)
HOLD_LAUNCHES = {"flash_attention": 2, "flash_attention_bwd": 1,
                 "rglru_scan": 4, "rglru_scan_bwd": 2, "adamw": 37}
#: phase 8d: the population, P = 3 trials at full width and depth 3,
#: batch 1 x 1024 each, 4 steps, at the config's own remat "full"
#: (``HOLD_LAUNCHES`` a step: each layer's forward twice) and at remat
#: "none" (``POP_LAUNCHES``: one launch a layer a step); AdamW's update
#: once a leaf a step for all three trials
POP_REMATS = ("full", "none")
POP_TRIALS = ({"lr": 1e-4, "weight_decay": 0.0, "seed": 0},
              {"lr": 3e-4, "weight_decay": 0.1, "seed": 1},
              {"lr": 1e-3, "weight_decay": 0.01, "seed": 2})
POP_SEQ = 1024
POP_STEPS = 4
POP_LAUNCHES = {"flash_attention": 1, "flash_attention_bwd": 1,
                "rglru_scan": 2, "rglru_scan_bwd": 2, "adamw": 37}
#: |population loss - single-trial loss| limit at each step: bf16
#: compute, and the trials' products batched (one bmm for three) where a
#: single trial's are not, so the two round differently; 1.6e-3 of the
#: initial ln(256000) = 12.45, well under one bf16 step (2^-8) of it
POP_TOL = 2e-2
#: |population - single-trial| / single-trial gradient norm limit at each
#: step: the same rounding over a norm of ~1e8-1e9 bf16 gradients; the
#: gradient norm reads every input (the loss at random weights barely
#: reads an encoder's or a prefix's: the final norm rescales the state)
POP_NORM_TOL = 2e-2
#: the same for an MoE population: the router's bf16 logits differ
#: between the batched and the unbatched products, a few of the (token,
#: choice) pairs go to other experts, and the gradient norm follows
#: (granite-moe 1.07% and 2.20% in two runs on the H100)
POP_NORM_TOL_MOE = 5e-2
#: phase 8h: arch -> (layers, None: all; text positions; trials), full
#: width, remat "full", batch 1 from ``concrete_inputs``; state at 16
#: bytes a parameter (float32 parameters, m, v and gradients) x trials:
#: granite-moe 2 layers x 3 trials 13.3 GB, deepseek its dense layer and
#: one MoE layer x 2 trials 34.7 GB, whisper whole (24 + 24 layers over
#: 1536 frames) x 3 trials 36.4 GB, llava one layer over 2304 image
#: positions x 2 trials 47.2 GB.  command-r-plus-104b does not run: one
#: layer and its tied table are 4.72 B parameters, 151 GB of state at
#: two trials
POP_FAMILIES = {"granite-moe-3b-a800m": (2, 1024, 3),
                "deepseek-v2-lite-16b": (2, 1024, 2),
                "whisper-medium": (None, 1024, 3),
                "llava-next-34b": (1, 1024, 2)}
POP_FAMILY_STEPS = 3


def bwd_excess(got, want32, dtype: str) -> float:
    """The largest ratio, over (dq, dk, dv), of |got - ref32| to the
    element-wise limit of ``FLASH_TOL`` plus a floor of ``BWD_FLOOR``
    times the largest rms of the three: a gradient row can be 0 where its
    terms are not (the first query's dq: dP - D cancels exactly, p = 1;
    at S = 1 all of dq and dk), and float32 sums of those terms in
    another order leave an error there that no share of the row's own
    size bounds."""
    rtol, c = FLASH_TOL[dtype]
    floor = BWD_FLOOR * max(float(w.float().square().mean().sqrt())
                            for w in want32)
    worst = 0.0
    for g, w in zip(got, want32):
        w = w.float()
        rms = w.square().mean(-1, keepdim=True).sqrt()
        lim = rtol * w.abs() + c * rms + floor
        worst = max(worst, float(((g.float() - w).abs()
                                  / lim.clamp(min=1e-30)).max()))
    return worst


def lm_counters():
    from repro_torch.kernels import adamw as kaw
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rglru_scan as krg
    return {"flash_attention": kfa.flash_attention_launches,
            "flash_attention_bwd": kfa.flash_attention_bwd_launches,
            "rglru_scan": krg.rglru_scan_launches,
            "rglru_scan_bwd": krg.rglru_scan_bwd_launches,
            "adamw": kaw.adamw_launches}


def free_card(where: str) -> float:
    """Drop what earlier phases left in the allocator's cache -> GB still
    allocated; report it beside what the card has free (memory outside
    PyTorch's allocator, or another process's, shows as the difference)."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    allocated = torch.cuda.memory_allocated() / 1e9
    reserved = torch.cuda.memory_reserved() / 1e9
    emit("card_memory", at=where, allocated_gb=allocated,
         reserved_gb=reserved, free_gb=free / 1e9, total_gb=total / 1e9,
         outside_gb=outside_gb())
    return allocated


def outside_gb() -> float:
    """GB of the card in use but not reserved by PyTorch's allocator: the
    CUDA context, library handles and workspaces, other processes."""
    free, total = torch.cuda.mem_get_info()
    return (total - free - torch.cuda.memory_reserved()) / 1e9


def bwd_case(case, gen, dev, family: bool = False) -> dict:
    """One case of ``BWD_CASES`` (8a) or ``FAMILY_BWD_CASES`` (8e, with
    ``family``): ``flash_attention_bwd`` against the plain float32
    backward of the same inputs (``bwd_excess`` <= 1), the kernel's lse
    against the plain one, planted faults failing that limit (8e: dK/dV
    from one query head of a group where K < H, the default scale in
    MLA's place, else the backward run with its causality flipped), SDPA's
    backward as the yardstick (8e: no mask, ``is_causal``, MLA on its
    unpadded widths), timed beside the plain version and the bound ->
    the case's line, also emitted."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    (name, B, Sq, Skv, H, K, D, causal, window, cap, dtype) = case
    gen.manual_seed(Sq + D + H)
    dt = getattr(torch, dtype)
    std = CAP_STD if cap else 1.0
    q = (std * torch.randn((B, Sq, H, D), generator=gen, device=dev)).to(dt)
    k = (std * torch.randn((B, Skv, K, D), generator=gen, device=dev)
         ).to(dt)
    v = torch.randn((B, Skv, K, D), generator=gen, device=dev).to(dt)
    do = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
    Dqk, Dv = BWD_WIDTHS.get(name, (D, D))
    for t, width in ((q, Dqk), (k, Dqk), (v, Dv), (do, Dv)):
        t[..., width:] = 0
    kw = dict(causal=causal, window=window, softcap=cap)
    if name in BWD_SCALE:
        kw["scale"] = BWD_SCALE[name]
    o, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
    _, lse_plain = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    lse_err = float((lse - lse_plain).abs().max())
    del lse_plain
    check(lse_err <= LSE_LIMIT, f"lse {name}: {lse_err} > {LSE_LIMIT}")
    got = kfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    want32 = ref.flash_attention_bwd_ref(*f32((q, k, v, o)), lse,
                                         do.float(), **kw)
    excess = bwd_excess(got, want32, dtype)
    abs_err = max(float((g.float() - w).abs().max())
                  for g, w in zip(got, want32))
    check(math.isfinite(excess) and excess <= 1.0,
          f"flash_attention_bwd {name}: {excess} x its limit")
    planted = {}
    faults = {}
    if name == "train":
        faults["oldest_key_dropped"] = lambda: ref.flash_attention_bwd_ref(
            *f32((q, k, v, o)), lse, do.float(), causal=causal,
            window=window - 1, softcap=cap)
    if name == "softcap30":
        faults["softcap_dropped"] = lambda: ref.flash_attention_bwd_ref(
            *f32((q, k, v, o)), lse, do.float(), causal=causal,
            window=window, softcap=0.0)
    if name in BWD_SCALE:
        faults["default_scale"] = lambda: ref.flash_attention_bwd_ref(
            *f32((q, k, v, o)), lse, do.float(), causal=causal,
            window=window, softcap=cap)
    if name == "gqa_window32" or (family and K < H):
        G = H // K

        def one_head():
            # dK and dV from the first query head of each group only
            _, dk1, dv1 = ref.flash_attention_bwd_ref(
                *f32((q[:, :, ::G], k, v, o[:, :, ::G])),
                lse[:, ::G], do[:, :, ::G].float(), **kw)
            return want32[0], dk1, dv1
        faults["gqa_heads_missing"] = one_head
    elif family and name not in BWD_SCALE:
        faults["made_noncausal" if causal else "made_causal"] = (
            lambda: ref.flash_attention_bwd_ref(
                *f32((q, k, v, o)), lse, do.float(),
                **dict(kw, causal=not causal)))
    for fault, run in faults.items():
        planted[fault] = bwd_excess(run(), want32, dtype)
        check(planted[fault] > 1.0,
              f"planted fault {fault} passes: {planted[fault]}")
    lib_ms = lib_err = None
    if not cap:  # SDPA has no softcap
        scale = kw.get("scale", 1.0 / math.sqrt(D))
        qt, kt, vt = (t[..., :w].transpose(1, 2).detach().requires_grad_()
                      for t, w in ((q, Dqk), (k, Dqk), (v, Dv)))
        if family:
            out = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True)
        else:
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band_mask(Sq, Skv, causal, window,
                                                dev),
                scale=scale, enable_gqa=True)
        dot = do[..., :Dv].transpose(1, 2)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dot, retain_graph=True)
        lib_err = max(rel_err(g.transpose(1, 2).float(), w[..., :g.shape[-1]])
                      for g, w in zip(lib(), want32))
        check(lib_err <= SDPA_BWD_LIMIT[dtype],
              f"sdpa backward {name} disagrees: {lib_err}")
        lib_ms = time_ms(lib)
        del out, qt, kt, vt
    del want32
    ms = time_ms(lambda: kfa.flash_attention_bwd(q, k, v, o, lse, do, **kw))
    plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, **kw))
    flops, nbytes = flash_bwd_work(B, Sq, Skv, H, K, Dqk, causal, window,
                                   q.element_size(), Dv)
    bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS if dtype ==
                         "bfloat16" else PEAK_F32_FLOPS)
    line = dict(case=name, B=B, Sq=Sq, Skv=Skv, H=H, K=K, D=D, Dqk=Dqk,
                Dv=Dv, causal=causal, window=window, softcap=cap,
                dtype=dtype, scale=kw.get("scale", 1.0 / math.sqrt(D)),
                tol=FLASH_TOL[dtype], excess=excess, planted_excess=planted,
                lse_abs_err=lse_err, max_abs_err=abs_err, ms=ms,
                plain_ms=plain_ms, sdpa_ms=lib_ms, sdpa_rel_err=lib_err,
                bound_ms=bound, bound_by=by, bound_share=bound / ms,
                gflop=flops / 1e9, mbytes=nbytes / 1e6)
    emit("family_bwd_case" if family else "flash_bwd_case", **line)
    del q, k, v, o, lse, do, got
    free_card("bwd_case")
    return line


def phase_train_kernels():
    """8a: the two backward kernels against their plain versions."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as krg
    dev = torch.device("cuda", 0)
    free_card("train_kernels")
    gen = torch.Generator(device=dev)
    summary = {}
    for case in BWD_CASES:
        line = bwd_case(case, gen, dev)
        if line["case"] == "train":
            summary["flash_attention_bwd"] = {
                n: line[f] for n, f in (
                    ("max_abs_err", "max_abs_err"), ("ms", "ms"),
                    ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                    ("bound_by", "bound_by"), ("library_ms", "sdpa_ms"))}
    for name, B, S, R in SCAN_BWD_CASES:
        gen.manual_seed(S + R + 1)
        la = -0.5 * torch.rand((B, S, R), generator=gen, device=dev)
        b = torch.randn((B, S, R), generator=gen, device=dev)
        dh = torch.randn((B, S, R), generator=gen, device=dev)
        h = krg.rglru_scan(la, b)
        got = krg.rglru_scan_bwd(la, h, dh)
        torch.cuda.synchronize()
        want = ref.rglru_scan_bwd_ref(la, h, dh)
        errs, lims = [], []
        for g, w in zip(got, want):
            errs.append(float((g - w).abs().max()))
            lims.append(SCAN_LIMIT * max(1.0, float(w.abs().max())))
        check(all(math.isfinite(e) and e <= lim for e, lim in
                  zip(errs, lims)),
              f"rglru_scan_bwd {name}: {errs} > {lims}")
        planted = None
        if name == "train":
            # each time tile scanned alone: no carry from the tile after
            tiles = [ref.rglru_scan_bwd_ref(la[:, t:t + krg.TIME_TILE],
                                            h[:, t:t + krg.TIME_TILE],
                                            dh[:, t:t + krg.TIME_TILE])
                     for t in range(0, S, krg.TIME_TILE)]
            planted = max(float((torch.cat([tl[i] for tl in tiles], 1)
                                 - want[i]).abs().max()) / lims[i]
                          for i in range(2))
            check(planted > 1.0,
                  f"planted fault (no carry between tiles) passes: {planted}")
            del tiles
        ms = time_ms(lambda: krg.rglru_scan_bwd(la, h, dh))
        plain_ms = time_ms(lambda: ref.rglru_scan_bwd_ref(la, h, dh))
        bound, by = bound_ms(*scan_bwd_work(B, S, R))
        emit("rglru_bwd_case", case=name, B=B, S=S, R=R, limits=lims,
             max_abs_err=errs, planted_no_carry_excess=planted, ms=ms,
             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
             library_ms=None)
        if name == "train":
            summary["rglru_scan_bwd"] = dict(
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)
        del la, b, dh, h, got, want
    free_card("scan_bwd_cases_done")
    return summary


def spied_step(fn, steps: list, counts, trace_at=None):
    """``fn`` (a train step) wrapped to append one record to ``steps`` a
    call: its ms (host clock around the synchronised step), the kernels'
    launches during it (``counts()`` before and after), its loss,
    gradient norm and lr; the call numbered ``trace_at`` runs under
    torch.profiler (``train_profile``)."""
    def timed(state, batch):
        out = {}

        def run():
            out["r"] = fn(state, batch)
        torch.cuda.synchronize()
        before = counts()
        traced = len(steps) == trace_at
        t0 = time.perf_counter()
        prof = device_profile(run) if traced else run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        state2, metrics = out["r"]
        steps.append(dict(
            ms=ms, traced=traced,
            launches={n: c - before[n] for n, c in counts().items()},
            loss=float(metrics["loss"]),
            grad_norm=float(metrics["grad_norm"]),
            lr=float(metrics["lr"])))
        if traced:
            emit("train_profile", **prof)
        return state2, metrics
    return timed


def phase_train(trace: bool = False):
    """8b: ``launch.train.train`` on recurrentgemma-2b at full width,
    spied on at its step function for each step's time, launches, loss
    and gradient norm; with ``trace`` (``--train``) its last step under
    torch.profiler, which the whole script leaves to its end (a profiler
    started early slows the host-bound phases after it)."""
    from repro_torch.launch import train as tr
    counters = lm_counters()
    counts = lambda: {n: c.count for n, c in counters.items()}  # noqa: E731
    steps = []
    make = tr.make_accum_train_step

    def spy_make(*args, **kwargs):
        model, fn = make(*args, **kwargs)
        return model, spied_step(fn, steps, counts,
                                 TRAIN["steps"] - 1 if trace else None)

    resident = free_card("train")
    torch.cuda.reset_peak_memory_stats()
    lines = []
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    with patched(tr, make_accum_train_step=spy_make):
        last = tr.train(TRAIN["arch"], TRAIN["steps"], TRAIN["batch"],
                        TRAIN["seq"], reduced=TRAIN["reduced"],
                        warmup=TRAIN["warmup"], seed=0, log_every=1,
                        log=lines.append)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(steps) == TRAIN["steps"], f"{len(steps)} train steps")
    for i, st in enumerate(steps):
        check(st["launches"] == TRAIN_LAUNCHES,
              f"train step {i} launches {st['launches']}")
        check(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]),
              f"train step {i}: loss {st['loss']}, grad norm "
              f"{st['grad_norm']}")
    check(math.isfinite(last), f"train returned {last}")
    warm = [st["ms"] for st in steps[1:] if not st["traced"]]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    emit("train", **TRAIN, wall_s=wall, step_ms=[st["ms"] for st in steps],
         warm_ms=warm, tokens_per_s=tokens / (sum(warm) / len(warm) / 1e3),
         peak_memory_gb=peak, resident_before_gb=resident,
         losses=[st["loss"] for st in steps],
         grad_norms=[st["grad_norm"] for st in steps],
         lrs=[st["lr"] for st in steps], launches=launches,
         step_launches=steps[0]["launches"], log=lines)
    return launches


def phase_train_parity():
    """8c: one step's loss and gradients at full width, depth 3, through
    the kernels, the plain bf16 path and the plain float32 path."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as S
    from repro_torch.models import LM
    from repro_torch.models.model import tensors
    dev = torch.device("cuda", 0)
    free_card("train_parity")
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=HOLD_DEPTH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = LM(cfg).init(seed=1, device=dev)
    batch = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["batch"], seed=0)).batch_at(0)
    batch = {k: torch.as_tensor(v, device=dev).long()
             for k, v in batch.items()}
    counters = lm_counters()
    for c in counters.values():
        c.reset()
    loss_k, _, g_k = S.loss_and_grads(
        LM(cfg), S.cast_params(params, cfg.compute_dtype), batch)
    torch.cuda.synchronize()
    launches = {n: c.count for n, c in counters.items()}
    check(launches == dict(HOLD_LAUNCHES, adamw=0),
          f"depth-3 step launches {launches}")
    with patched(ops, flash_attention=ref.flash_attention_ref,
                 rglru_scan=ref.rglru_scan_ref):
        loss_p, _, g_p = S.loss_and_grads(
            LM(cfg), S.cast_params(params, cfg.compute_dtype), batch)
        loss_32, _, g_32 = S.loss_and_grads(LM(cfg32), params, batch)
    check(all(c.count == launches[n] for n, c in counters.items()),
          "the plain runs launched kernels")
    rel = lambda a, b: float(  # noqa: E731
        torch.linalg.vector_norm(a.float() - b.float())
        / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))
    leaves = [(rel(a, c), rel(b, c)) for a, b, c in
              zip(tensors(g_k), tensors(g_p), tensors(g_32))]
    for i, (ke, pe) in enumerate(leaves):
        check(math.isfinite(ke) and ke <= GRAD_FACTOR * pe,
              f"gradient leaf {i}: |kernel - f32| {ke} > {GRAD_FACTOR} x "
              f"|plain - f32| {pe}")
    lk, lp, l32 = float(loss_k), float(loss_p), float(loss_32)
    check(abs(lk - l32) <= LOSS_FACTOR * max(abs(lp - l32), LOSS_FLOOR),
          f"loss: kernel {lk}, plain {lp}, f32 {l32}")
    emit("train_parity", depth=HOLD_DEPTH, seq=TRAIN["seq"],
         loss_kernel=lk, loss_plain=lp, loss_f32=l32, launches=launches,
         grad_rel_err_kernel_vs_f32=[ke for ke, _ in leaves],
         grad_rel_err_plain_vs_f32=[pe for _, pe in leaves],
         worst_leaf_ratio=max(ke / max(pe, 1e-30) for ke, pe in leaves))


def population_spied(cfg, norms: list):
    """A ``PopulationTrainer`` of ``cfg`` on the card whose step appends
    each step's per-trial gradient norms to ``norms``."""
    from repro_torch.core import vmap_trials as vt
    from repro_torch.optim import AdamWConfig
    trainer = vt.PopulationTrainer(cfg, AdamWConfig(),
                                   device=torch.device("cuda", 0))
    step = trainer.step

    def spied(*args):
        state, metrics = step(*args)
        norms.append(metrics["grad_norm"].float().tolist())
        return state, metrics
    trainer.step = spied
    return trainer


def population_hold(cfg, trials, data, steps: int, launches: dict,
                    fault=None) -> dict:
    """``PopulationTrainer`` of ``cfg`` over ``trials`` for ``steps``
    steps on ``data(t)``, exactly ``launches`` a step for all trials,
    then each trial alone through ``make_trial_step`` at the same remat,
    every loss within ``POP_TOL`` and every gradient norm within
    ``POP_NORM_TOL`` (an MoE's ``POP_NORM_TOL_MOE``) of the population's
    -> the line.  With ``fault`` ((name, a batch -> the batch it
    plants)), the population run again on the planted batches must miss
    that hold."""
    from repro_torch.core import vmap_trials as vt
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = torch.device("cuda", 0)
    counters = lm_counters()
    counts = lambda: {n: c.count for n, c in counters.items()}  # noqa: E731
    resident = free_card(f"population {cfg.name} {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    trainer = population_spied(cfg, norms := [])
    marks = []

    def report(t, losses):
        marks.append((time.perf_counter(), counts(), losses.tolist()))

    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), counts(), None))
    objective = trainer.train(list(trials), data, steps, eval_last=steps,
                              report=report)
    total = counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_launches = [{n: c - a[1][n] for n, c in b[1].items()}
                     for a, b in zip(marks, marks[1:])]
    step_s = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    for i, sl in enumerate(step_launches):
        check(sl == launches,
              f"{cfg.name} {cfg.remat} population step {i} launches {sl}, "
              f"not {launches}")
    pop = [m[2] for m in marks[1:]]
    check(all(math.isfinite(x) for row in pop for x in row),
          f"{cfg.name} population losses {pop}")
    del trainer
    free_card(f"population {cfg.name} done")
    # each trial alone: the same step without vmap, on its own state
    model, one_step = vt.make_trial_step(cfg, AdamWConfig())
    seq, seq_norms = [], []
    for a in trials:
        params = model.init(a["seed"], dev)
        state = {"params": params, "opt": adamw_init(params)}
        lr = torch.tensor(a["lr"], device=dev)
        wd = torch.tensor(a["weight_decay"], device=dev)
        losses, gnorms = [], []
        for t in range(steps):
            batch = {k: vt._on_device(v, dev) for k, v in data(t).items()}
            state, metrics = one_step(state, batch, lr, wd)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
        seq.append(losses)
        seq_norms.append(gnorms)
        del state, params
        free_card("single_trial")

    def excess(losses, gnorms):
        """(largest |loss - single|, largest relative gradient-norm
        difference) over the trials and steps."""
        idx = [(i, t) for i in range(len(trials)) for t in range(steps)]
        return (max(abs(losses[t][i] - seq[i][t]) for i, t in idx),
                max(abs(gnorms[t][i] - seq_norms[i][t]) / seq_norms[i][t]
                    for i, t in idx))
    norm_tol = POP_NORM_TOL_MOE if cfg.moe else POP_NORM_TOL
    diff, norm_diff = excess(pop, norms)
    check(diff <= POP_TOL and norm_diff <= norm_tol,
          f"{cfg.name} {cfg.remat} population vs single trials: loss "
          f"{diff} (limit {POP_TOL}), gradient norm {norm_diff} (limit "
          f"{norm_tol})")
    planted = None
    if fault is not None:
        name, plant = fault
        bad, bad_norms = [], []
        population_spied(cfg, bad_norms).train(
            list(trials), lambda t: plant(data(t)), steps, eval_last=steps,
            report=lambda t, losses: bad.append(losses.tolist()))
        miss, norm_miss = excess(bad, bad_norms)
        over = max(miss / POP_TOL, norm_miss / norm_tol)
        check(over > 1, f"{cfg.name}: planted {name} within the hold (loss "
              f"{miss}, gradient norm {norm_miss})")
        planted = dict(name=name, loss_diff=miss, grad_norm_diff=norm_miss,
                       over_limit=over)
        free_card(f"population {cfg.name} fault done")
    warm = step_s[1:]
    return dict(arch=cfg.name, remat=cfg.remat, trials=len(trials),
                layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
                steps=steps, step_s=step_s,
                trial_steps_per_s=len(trials) * len(warm) / sum(warm),
                peak_memory_gb=peak, resident_before_gb=resident,
                losses=pop, single_trial_losses=seq, max_abs_diff=diff,
                grad_norms=norms, single_trial_grad_norms=seq_norms,
                max_grad_norm_rel_diff=norm_diff, grad_norm_limit=norm_tol,
                objective=objective.tolist(), launches=total,
                step_launches=step_launches[0], planted=planted)


def phase_population():
    """8d: ``population_hold`` of three trials at full width, depth 3, at
    each remat of ``POP_REMATS`` -> the launches summed over the runs."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    data = TokenPipeline(DataConfig(
        vocab_size=get_config(TRAIN["arch"]).vocab_size, seq_len=POP_SEQ,
        global_batch=1, seed=0)).batch_at
    want = {"full": HOLD_LAUNCHES, "none": POP_LAUNCHES}
    total = {n: 0 for n in lm_counters()}
    for remat in POP_REMATS:
        cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                                  n_layers=HOLD_DEPTH, remat=remat)
        line = population_hold(cfg, POP_TRIALS, data, POP_STEPS,
                               want[remat])
        emit("population", seq=POP_SEQ, **line)
        for n in total:
            total[n] += line["launches"][n]
    return total


def as_integers(batch):
    """8h's planted fault: every entry cast to integers, as the population
    trainer once cast a batch (whisper's frames, llava's embeddings)."""
    return {k: v.long() for k, v in batch.items()}


def phase_population_families():
    """8h: ``population_hold`` of each family of ``POP_FAMILIES`` at full
    width and its own remat "full" on ``concrete_inputs`` batches, the
    families with float inputs with their integer cast planted -> the
    launches summed over them."""
    from repro_torch.configs import concrete_inputs
    from repro_torch.models import ShapeSpec
    dev = torch.device("cuda", 0)
    total = {n: 0 for n in lm_counters()}
    for arch, (layers, text, P) in POP_FAMILIES.items():
        cfg = served_config(arch, layers)
        check(cfg.remat == "full", f"{arch}: remat {cfg.remat}")
        shape = ShapeSpec("train", text + cfg.n_img_tokens, 1, "train")
        fault = (("inputs_as_integers", as_integers)
                 if cfg.family in ("encdec", "vlm") else None)
        line = population_hold(
            cfg, POP_TRIALS[:P],
            lambda t: concrete_inputs(cfg, shape, seed=t, device=dev),
            POP_FAMILY_STEPS, step_launches(cfg, update=True), fault)
        emit("population_family", text=text, published_layers=(
            served_config(arch, None).n_layers), **line)
        for n in total:
            total[n] += line["launches"][n]
    return total


# ------------------------------------------------------- phases 8e-8g
#: phase 8f: arch -> (depth, seq) of the gradient hold at full width,
#: batch 1 from ``concrete_inputs``: granite-moe's first two layers;
#: deepseek's dense layer and one MoE layer; whisper's decoder at depth 2
#: over its 24 encoder layers (1536 frames); command-r at seq 1024 (its
#: tied 3.15 B table and two 1.57 B layers are ~25 GB in float32, and as
#: much again in float32 gradients); llava's 2304 image and 1792 text
#: positions; xlstm-125m whole at seq 512, two 256-step mLSTM chunks
#: (its sLSTM loop launches ~25 kernels a time step a layer, forward
#: twice and backward once: 57 s for the hold's five runs at seq 1024)
FAMILY_HOLDS = {"granite-moe-3b-a800m": (2, 4096),
                "deepseek-v2-lite-16b": (2, 4096),
                "whisper-medium": (2, 4096),
                "command-r-plus-104b": (2, 1024),
                "llava-next-34b": (2, 4096),
                "xlstm-125m": (12, 512)}
#: phase 8g: arch -> (layers trained, None: all; seq), batch 1, at 16
#: bytes of state a parameter (float32 masters, m and v; bf16 weights and
#: gradients): granite-moe whole (3.30 B, ~53 GB); deepseek at 4 of 27
#: layers (~2.25 B, ~36 GB; its MoE layers are ~0.585 B each, ~250 GB
#: at full depth); whisper whole (0.76 B) over 1536 frames; llava at 4 of
#: 60 layers (~3.15 B, ~50 GB) over 2304 image and 1792 text positions;
#: xlstm whole at seq 1024 (cut from 4096: its step time is linear in
#: the sLSTM loop's launches).  command-r-plus-104b takes no step: its
#: tied 3.15 B table and one 1.57 B layer are 75.5 GB of state before
#: any activation, past one 80 GB card at any depth (8f holds its
#: gradient)
FAMILY_TRAIN = {"granite-moe-3b-a800m": (None, 4096),
                "deepseek-v2-lite-16b": (4, 4096),
                "whisper-medium": (None, 4096),
                "llava-next-34b": (4, 4096),
                "xlstm-125m": (None, 1024)}
FAMILY_TRAIN_STEPS = 3
#: 8f: a gradient leaf whose float32 norm is below ZERO_LEAF of the
#: largest leaf's has an exact gradient of 0 -- a key projection's bias
#: (whisper's), whose gradient the softmax cancels: what any path
#: computes there is rounding, and no ratio of two paths' roundings is a
#: limit.  Such a leaf is held to within ZERO_LEAF_TOL (bf16's step) of
#: the largest leaf's norm instead; the rest as 8c holds.  On the H100
#: whisper's 28 key biases were 8.1e-10 of the largest leaf or less, and
#: the smallest other leaf of any family 3.6e-5 of it
ZERO_LEAF = 1e-7
ZERO_LEAF_TOL = 2.0 ** -8
FAMILY_TRAIN_WARMUP = 2


def attention_layers(cfg) -> int:
    """Attention calls a forward of ``cfg`` makes: one an attention layer,
    two a decoder layer of an encoder-decoder (self and cross), one an
    encoder layer."""
    from repro_torch.models.common import ATTN, LOCAL_ATTN
    from repro_torch.models.model import XATTN, build_specs
    return (sum(2 if s.kind == XATTN else int(s.kind in (ATTN, LOCAL_ATTN))
                for s in build_specs(cfg)) + cfg.encoder_layers)


def step_launches(cfg, update: bool) -> dict:
    """The LM kernels' launches a train step of ``cfg``: every attention
    call's forward twice (remat recomputes it) and its backward once;
    with ``update``, AdamW's once a parameter leaf (for every trial of a
    population at once)."""
    from repro_torch.models import LM
    from repro_torch.models.model import tensors
    n = attention_layers(cfg)
    want = {name: 0 for name in lm_counters()}
    want.update(flash_attention=(1 if cfg.remat == "none" else 2) * n,
                flash_attention_bwd=n)
    if update:
        want["adamw"] = sum(1 for _ in tensors(LM(cfg).init(0, "meta")))
    return want


def flipped_share(a, b, n_experts: int) -> float:
    """Share of (token, choice) pairs of ``a`` whose expert is not among
    ``b``'s choices for that token."""
    import torch.nn.functional as F
    na = F.one_hot(a, n_experts).sum(-2)
    nb = F.one_hot(b, n_experts).sum(-2)
    return float((na - nb).clamp(min=0).sum()) / a.numel()


class TopKReplay:
    """``moe._top_k`` for 8f: records the router's choices of the kernel
    run, call by call (remat's recomputation included), then in each
    later run replays them in the same order, their weights gathered
    from that run's own probabilities, and records the share of that
    run's own choices that differ from the replayed ones."""

    def __init__(self):
        self.recorded, self.flips, self.i = [], None, 0

    def replay(self) -> list:
        self.i, self.flips = 0, []
        return self.flips

    def __call__(self, probs, k):
        w, idx = torch.topk(probs, k, dim=-1)
        if self.flips is None:
            self.recorded.append(idx)
            return w, idx
        rec = self.recorded[self.i]
        self.i += 1
        self.flips.append(flipped_share(idx, rec, probs.shape[-1]))
        return probs.gather(-1, rec), rec


def family_fault(cfg):
    """8f's planted fault for ``cfg``'s family -> (name, [(module, {name:
    swap})], params from the bf16 weights or None)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    bwd, fa = kfa.flash_attention_bwd, ops.flash_attention
    if cfg.family == "encdec":
        def cross_causal(q, k, v, o, lse, do, **kw):
            # cross-attention's backward (its Sq != Skv) run causal
            if q.shape[1] != k.shape[1]:
                kw = dict(kw, causal=True)
            return bwd(q, k, v, o, lse, do, **kw)
        return ("cross_attention_bwd_causal",
                [(kfa, dict(flash_attention_bwd=cross_causal))], None)
    if cfg.family == "vlm":
        n = cfg.n_img_tokens

        def prefix_dropped(q, k, v, **kw):
            return torch.cat([fa(q[:, :n], k[:, :n], v[:, :n], **kw),
                              fa(q[:, n:], k[:, n:], v[:, n:], **kw)], 1)
        return ("prefix_dropped_from_kv",
                [(ops, dict(flash_attention=prefix_dropped))], None)
    if cfg.family == "ssm":
        def r_zeroed(p16):
            return dict(p16, layers=[
                dict(lp, slstm=dict(lp["slstm"], r=torch.zeros_like(
                    lp["slstm"]["r"]))) if "slstm" in lp else lp
                for lp in p16["layers"]])
        return "slstm_r_zeroed", [], r_zeroed
    if cfg.mla:
        def default_scale(*a, **kw):
            return bwd(*a, **dict(kw, scale=None))
        return ("bwd_default_scale",
                [(kfa, dict(flash_attention_bwd=default_scale))], None)

    def heads_missing(q, k, v, o, lse, do, **kw):
        # dK and dV from the first query head of each group only
        G = q.shape[2] // k.shape[2]
        dq, _, _ = bwd(q, k, v, o, lse, do, **kw)
        _, dk, dv = bwd(q[:, :, ::G], k, v, o[:, :, ::G], lse[:, ::G],
                        do[:, :, ::G], **kw)
        return dq, dk, dv
    return ("bwd_gqa_heads_missing",
            [(kfa, dict(flash_attention_bwd=heads_missing))], None)


def family_hold(arch: str, depth: int, seq: int) -> dict:
    """8f: one ``loss_and_grads`` of ``arch`` at full width and depth
    ``depth`` (float32 weights from seed 1, a ``concrete_inputs`` batch of
    one ``seq`` sequence) in bf16 through the kernels, through their
    plain versions (``flash_attention`` and ``flash_attention_bwd``
    swapped at the wrappers: the same function, the backward's D from the
    stored bf16 output), through the dense oracle differentiated by
    autograd (``ops.flash_attention`` swapped, as 8c; reported, not a
    limit), once with the family's planted fault on the kernel path, and
    in float32 through the dense oracle.  The kernel run launches
    ``step_launches``; each gradient leaf of the kernel run is no further
    from float32 than ``GRAD_FACTOR`` times the plain versions' run (a
    leaf whose exact gradient is 0, ``ZERO_LEAF``: within
    ``ZERO_LEAF_TOL`` of the largest leaf), the loss ``LOSS_FACTOR``
    times (floor ``LOSS_FLOOR``); the fault fails one of them.  An MoE
    family's later runs replay the kernel run's router choices
    (``TopKReplay``), so the hold measures attention and dispatch, not
    routing flips, which are reported.  The bf16 runs' gradients wait on
    the host while the float32 run holds the card."""
    from repro_torch.configs import concrete_inputs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as S
    from repro_torch.models import LM, ShapeSpec
    from repro_torch.models import moe as MM
    from repro_torch.models.model import tensors
    dev = torch.device("cuda", 0)
    free_card(f"family_hold {arch}")
    t0 = time.perf_counter()
    cfg = served_config(arch, depth)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = LM(cfg).init(seed=1, device=dev)
    batch = concrete_inputs(cfg, ShapeSpec("train", seq, 1, "train"),
                            seed=0, device=dev)
    counters = lm_counters()
    topk = TopKReplay()
    plain = (kfa, dict(flash_attention=ref.flash_attention_ref,
                       flash_attention_bwd=ref.flash_attention_bwd_ref))
    dense = (ops, dict(flash_attention=ref.flash_attention_ref))

    def run(c, params, swaps=(), host=True):
        with contextlib.ExitStack() as stack:
            for mod, swap in [(MM, dict(_top_k=topk)), *swaps]:
                stack.enter_context(patched(mod, **swap))
            loss, _, g = S.loss_and_grads(LM(c), params, batch)
        torch.cuda.synchronize()
        return float(loss), [t.cpu() if host else t for t in tensors(g)]

    p16 = S.cast_params(p32, cfg.compute_dtype)
    for c in counters.values():
        c.reset()
    runs = {"kernel": run(cfg, p16)}
    launches = {n: c.count for n, c in counters.items()}
    want = step_launches(cfg, update=False)
    check(launches == want, f"{arch} hold: launches {launches}, not {want}")
    flips = {}
    for name, sw in (("plain", plain), ("dense", dense)):
        flips[name] = topk.replay()
        runs[name] = run(cfg, p16, [sw])
    check(all(c.count == launches[n] for n, c in counters.items()),
          f"{arch} hold: the plain runs launched kernels")
    fault, swaps, make_params = family_fault(cfg)
    topk.replay()
    runs["fault"] = run(cfg, p16 if make_params is None
                        else make_params(p16), swaps)
    del p16
    flips["f32"] = topk.replay()
    loss_32, g_32 = run(cfg32, p32, [dense], host=False)
    del p32
    norm = lambda a: float(torch.linalg.vector_norm(a.float()))  # noqa
    sizes = [norm(c) for c in g_32]
    # per leaf, each run's distance from float32 relative to the float32
    # leaf's norm, or for a leaf whose exact gradient is 0 (ZERO_LEAF) to
    # the largest leaf's
    scale = [c if c >= ZERO_LEAF * max(sizes) else max(sizes)
             for c in sizes]
    zero = [i for i, (c, sc) in enumerate(zip(sizes, scale)) if c < sc]
    err = {name: [norm(g.to(dev).float() - c) / max(sc, 1e-30)
                  for g, c, sc in zip(grads, g_32, scale)]
           for name, (_, grads) in runs.items()}
    losses = {name: loss for name, (loss, _) in runs.items()}
    del runs, g_32

    def loss_ok(lk):
        return abs(lk - loss_32) <= LOSS_FACTOR * max(
            abs(losses["plain"] - loss_32), LOSS_FLOOR)

    def bad_leaves(name):
        return [i for i, (e, pe) in enumerate(zip(err[name], err["plain"]))
                if not (math.isfinite(e) and e <= (
                    ZERO_LEAF_TOL if i in zero else GRAD_FACTOR * pe))]

    def worst(name, over):
        return max(e / max(pe, 1e-30) for i, (e, pe) in
                   enumerate(zip(err[name], err[over])) if i not in zero)

    failed = bad_leaves("kernel")
    caught = bad_leaves("fault")
    line = dict(
        arch=arch, depth=depth, seq=seq, encoder_layers=cfg.encoder_layers,
        n_img_tokens=cfg.n_img_tokens, launches=launches,
        attention_layers=attention_layers(cfg), loss_f32=loss_32,
        **{f"loss_{n}": v for n, v in losses.items()}, leaves=len(sizes),
        **{f"grad_rel_err_{n}_vs_f32": err[n]
           for n in ("kernel", "plain", "dense")},
        worst_leaf_ratio=worst("kernel", "plain"),
        worst_leaf_ratio_vs_dense=worst("kernel", "dense"),
        failed_leaves=failed, zero_leaves=zero,
        leaf_norm_over_largest=[c / max(sizes) for c in sizes],
        router_calls=len(topk.recorded),
        **{f"flipped_share_{n}_vs_kernel": f for n, f in flips.items()},
        planted_fault=dict(name=fault, loss=losses["fault"],
                           leaves_rejected=len(caught),
                           worst_leaf_ratio=worst("fault", "plain"),
                           over_limit=worst("fault", "plain") / GRAD_FACTOR,
                           loss_rejects=not loss_ok(losses["fault"])),
        hold_s=time.perf_counter() - t0)
    emit("family_hold", **line)
    check(not failed, f"{arch} hold: gradient leaves {failed} past "
          f"{GRAD_FACTOR} x the plain versions' distance from float32 "
          f"(zero leaves {zero}: {ZERO_LEAF_TOL} of the largest)")
    check(loss_ok(losses["kernel"]), f"{arch} hold loss: {losses}, f32 "
          f"{loss_32}")
    check(caught or not loss_ok(losses["fault"]),
          f"{arch}: planted fault {fault} passes: {line['planted_fault']}")
    del batch
    free_card(f"family_hold {arch} done")
    return line


def phase_family_bwd():
    """8e: ``flash_attention_bwd`` at the seven train layouts
    (``FAMILY_BWD_CASES``, ``bwd_case``) and at the offset layouts
    (``flash_offsets``) -> {layout: its error, times, bound and planted
    faults}."""
    dev = torch.device("cuda", 0)
    free_card("family_bwd")
    gen = torch.Generator(device=dev)
    layouts = {}
    for case in FAMILY_BWD_CASES:
        line = bwd_case(case, gen, dev, family=True)
        layouts[line["case"]] = dict(
            excess=line["excess"], max_abs_err=line["max_abs_err"],
            ms=line["ms"], plain_ms=line["plain_ms"],
            bound_ms=line["bound_ms"], bound_by=line["bound_by"],
            library_ms=line["sdpa_ms"], planted=line["planted_excess"])
    layouts.update(flash_offsets(backward=True))
    return layouts


def phase_family_parity():
    """8f: ``family_hold`` for each family of ``FAMILY_HOLDS``."""
    for arch, (depth, seq) in FAMILY_HOLDS.items():
        family_hold(arch, depth, seq)


def family_train(arch: str, layers, seq: int) -> dict:
    """8g: ``FAMILY_TRAIN_STEPS`` AdamW steps of ``arch`` at full width
    (``layers`` of its published depth, None: all), bf16 compute, float32
    masters, remat "full", batch 1 x ``seq``: a token-only family through
    ``launch.train.train`` (its config lookup answering the cut), an
    encoder-decoder or VLM through ``launch.steps.make_train_step`` on
    ``concrete_inputs`` batches (stub frames or patch embeddings), each
    step spied on (``spied_step``): ``step_launches`` a step, finite
    losses and gradient norms -> the line: ms a step, tokens a second,
    peak memory."""
    from repro_torch.configs import concrete_inputs
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as tr
    from repro_torch.models import ShapeSpec
    from repro_torch.models.model import tensors
    from repro_torch.optim import AdamWConfig, linear_warmup_cosine
    dev = torch.device("cuda", 0)
    cfg = served_config(arch, layers)
    published = served_config(arch, None).n_layers
    if layers is not None:
        print(f"chip_smoke: {arch} trained at {layers} of its {published} "
              "layers (full width)", flush=True)
    counters = lm_counters()
    counts = lambda: {n: c.count for n, c in counters.items()}  # noqa: E731
    steps, lines = [], []
    resident = free_card(f"family_train {arch}")
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    if cfg.family in ("encdec", "vlm"):
        entry = "launch.steps.make_train_step"
        _, fn = S.make_train_step(cfg, AdamWConfig(lr=3e-4),
                                  linear_warmup_cosine(3e-4,
                                                       FAMILY_TRAIN_WARMUP,
                                                       FAMILY_TRAIN_STEPS))
        step = spied_step(fn, steps, counts)
        state = S.init_train_state(cfg, 0, dev)
        shape = ShapeSpec("train", seq, 1, "train")
        for t in range(FAMILY_TRAIN_STEPS):
            batch = concrete_inputs(cfg, shape, seed=t, device=dev)
            state, _ = step(state, batch)
        inputs = {k: list(v.shape) for k, v in batch.items()}
        params = sum(t.numel() for t in tensors(state["params"]))
        del state, batch
    else:
        entry = "launch.train.train"
        make = tr.make_accum_train_step

        def spy_make(*args, **kwargs):
            model, fn = make(*args, **kwargs)
            return model, spied_step(fn, steps, counts)

        with patched(tr, make_accum_train_step=spy_make,
                     get_config=lambda name: cfg):
            last = tr.train(arch, FAMILY_TRAIN_STEPS, 1, seq, reduced=False,
                            warmup=FAMILY_TRAIN_WARMUP, seed=0, log_every=1,
                            log=lines.append)
        check(math.isfinite(last), f"{arch}: train returned {last}")
        inputs = {"tokens": [1, seq], "labels": [1, seq]}
        params = cfg.param_count()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = counts()
    want = step_launches(cfg, update=True)
    check(len(steps) == FAMILY_TRAIN_STEPS, f"{arch}: {len(steps)} steps")
    for i, st in enumerate(steps):
        check(st["launches"] == want,
              f"{arch} train step {i} launches {st['launches']}, not {want}")
        check(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]),
              f"{arch} train step {i}: loss {st['loss']}, grad norm "
              f"{st['grad_norm']}")
    warm = [st["ms"] for st in steps[1:]]
    tokens = math.prod(inputs["tokens"])
    positions = tokens + cfg.n_img_tokens
    mean_s = sum(warm) / len(warm) / 1e3
    free_card(f"family_train {arch} done")
    return dict(arch=arch, entry=entry, layers=cfg.n_layers,
                published_layers=published,
                encoder_layers=cfg.encoder_layers, params=params,
                seq=seq, inputs=inputs, steps=FAMILY_TRAIN_STEPS,
                wall_s=wall, step_ms=[st["ms"] for st in steps],
                warm_ms=warm, tokens_per_s=tokens / mean_s,
                positions_per_s=positions / mean_s, peak_memory_gb=peak,
                resident_before_gb=resident,
                losses=[st["loss"] for st in steps],
                grad_norms=[st["grad_norm"] for st in steps],
                lrs=[st["lr"] for st in steps], launches=launches,
                step_launches=steps[0]["launches"], log=lines)


def phase_family_train():
    """8g: ``family_train`` for each family of ``FAMILY_TRAIN`` -> the LM
    kernels' launches summed over them (counters zeroed before each)."""
    total = {n: 0 for n in lm_counters()}
    for arch, (layers, seq) in FAMILY_TRAIN.items():
        line = family_train(arch, layers, seq)
        emit("family_train", **line)
        for n in total:
            total[n] += line["launches"][n]
    return total


# ------------------------------------------------------------- phase 9
#: 9a: the dry run's cells (arch, shape, multi_pod), each on a fake
#: process group of 256 or 512 ranks in a pool of worker processes:
#: every arch x shape on 16x16 but the two that take too long for the
#: script, and recurrentgemma-2b ``train_4k`` on 2x16x16; the train cells
#: first, the longest
DRYRUN_SLOW = (("xlstm-125m", "train_4k"), ("xlstm-125m", "prefill_32k"))
DRYRUN_CELLS = tuple(
    (a, s, False) for s in ("train_4k", "prefill_32k", "decode_32k",
                            "long_500k")
    for a in ("command-r-plus-104b", "llava-next-34b", "whisper-medium",
              "phi3-medium-14b", "deepseek-v2-lite-16b",
              "granite-moe-3b-a800m", "recurrentgemma-2b", "granite-3-8b",
              "granite-8b", "xlstm-125m")
    if (a, s) not in DRYRUN_SLOW) + (("recurrentgemma-2b", "train_4k", True),)
DRYRUN_CUT = ("xlstm-125m train_4k and prefill_32k (its sLSTM steps 4096 "
              "and 32768 times in Python: ~10 and ~15 min on a host; "
              "python -m repro_torch.launch.dryrun runs them) and every "
              "2x16x16 cell but recurrentgemma-2b train_4k")
DRYRUN_WORKERS = 7
DRYRUN_TIMEOUT_S = 400
#: 9a's holds of the sequence-parallel step (the batch short of the mesh,
#: the sequence over the rest): command-r-plus-104b ``prefill_32k``'s
#: bound in seconds (the per-op design's 5.45 s and room for the causal
#: imbalance of the last sequence shard, whose rank the dry run is) and
#: phi3-medium-14b ``decode_32k``'s peak a device in units of its
#: argument bytes (no rank gathers a layer's cache)
SEQ_PREFILL_BOUND_S = 6.0
SEQ_DECODE_PEAK_ARGS = 2.0
#: the same two cells where each layer gathered the sequence (the commit
#: before the sequence-parallel step, ``scripts/compare_dryrun.py``, a
#: host run): the bound in seconds and the peak and argument bytes a
#: device
SEQ_PARENT = {"prefill_bound_s": 16.7563, "decode_peak_bytes": 50.36e9,
              "decode_arg_bytes": 3.47e9}
#: 9a's wall time for these 39 cells before the tracker of live storage
#: bytes ran around each step (H100 80GB HBM3, 700.00 W)
DRYRUN_WALL_UNTRACKED = 42.2
#: 9b: 8b's step (recurrentgemma-2b, full width and depth, batch 1 x
#: 3000, lr 3e-4 with 2 warmup steps of 4) sharded over a one-card mesh,
#: then ``SHARD_WARM`` timed steps and one under the cost analyser; the
#: sharded step's distance from the unsharded one where it is not bit
#: for bit, relative to the largest parameter
SHARD_WARM = 3
SHARD_LIMIT = 1e-6
#: 9b's memory: the tracker's peak of the counted step against the
#: allocator's peak of the same step, and the same step's peak on meta
#: tensors at world size 1 against the card's tracker (relative); and
#: the step's rise, the tracker's (its peak less the bytes registered
#: before the step) against the allocator's (its peak less what it held
#: before the step): the part of the peak the tracker measures itself
SHARD_MEM_LIMIT = 0.10
SHARD_META_LIMIT = 0.01
SHARD_RISE_LIMIT = 0.02
#: 9c: 4 gloo ranks on a (2, 2) mesh, reduced configs in float32, 2
#: AdamW steps of batch 4 x 32, against the same steps unsharded; then
#: batch 2 (``SHARD_RANK_SEQ_BATCH``), which leaves "model" to the
#: sequence: the step sequence-parallel
SHARD_RANK_ARCHS = ("recurrentgemma-2b", "granite-moe-3b-a800m")
SHARD_RANK_CELL = dict(mesh=(2, 2), batch=4, seq=32, steps=2)
SHARD_RANK_SEQ_BATCH = 2
#: 9c's tensors: on CUDA tensors a gloo group's functional all-gather,
#: which DTensor's redistribution issues, dies (SIGSEGV) with no code of
#: the port at one rank and at two, while c10d's own collectives work
#: (``--gloo-cuda``, ``phase_gloo_probe``); NCCL cannot place four ranks
#: on the one card
SHARD_RANK_DEVICE = "cpu"
#: ``--gloo-cuda``: the collectives a sharded step issues, each alone on
#: gloo ranks: c10d's, the functional collectives DTensor issues (each
#: followed by its ``wait_tensor``), and a DTensor's redistribution
GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "all_to_all_single",
                  "funcol_all_gather", "funcol_reduce_scatter",
                  "dtensor_gather")
GLOO_PROBE_WORLDS = (1, 2)


def dryrun_cell(cell) -> dict:
    """One cell of 9a in a worker process: its record (a failure's
    traceback cut to its end)."""
    from repro_torch.launch import dryrun
    arch, shape, multi_pod = cell
    out = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    rec = dryrun.run_cell(arch, shape, multi_pod, out, verbose=False)
    rec["traceback"] = rec.get("traceback", "")[-3000:]
    return rec


def phase_dryrun():
    """9a: the dry run (host, fake ranks): every cell of ``DRYRUN_CELLS``
    ``ok`` or skipped with the reference's reason, each ``ok`` cell's
    memory (the tracker's peak, output, alias and temp bytes a device)
    with its peak at or above its argument bytes and peak = argument +
    output - alias + temp, and command-r-plus-104b ``train_4k``'s
    argument bytes a device equal to ``sharded_bytes`` of its state
    recomputed here, its peak beside them."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.distributed.auto_shard import sharded_bytes
    from repro_torch.launch import steps as S
    from repro_torch.models.common import SHAPES, shape_applicable
    t0 = time.perf_counter()
    with cf.ProcessPoolExecutor(DRYRUN_WORKERS,
                                mp_context=mp.get_context("spawn")) as ex:
        recs = list(ex.map(dryrun_cell, DRYRUN_CELLS,
                           timeout=DRYRUN_TIMEOUT_S))
    wall = time.perf_counter() - t0
    for (arch, shape, _), rec in zip(DRYRUN_CELLS, recs):
        ok, reason = shape_applicable(get_config(arch), SHAPES[shape])
        check(rec["ok"], f"dry run {arch} {shape} {rec['mesh']}: "
              f"{rec.get('error')}\n{rec['traceback']}")
        check(rec.get("skipped", False) == (not ok)
              and rec.get("skip_reason", "") == reason,
              f"dry run {arch} {shape}: skip {rec.get('skip_reason')}")
        if not rec.get("skipped"):
            mem = rec["memory"]
            check(mem["peak_memory_in_bytes"]
                  >= mem["argument_size_in_bytes"]
                  == rec["arg_bytes_per_device"]
                  and mem["peak_memory_in_bytes"] == (
                      mem["argument_size_in_bytes"]
                      + mem["output_size_in_bytes"]
                      - mem["alias_size_in_bytes"]
                      + mem["temp_size_in_bytes"]),
                  f"dry run {arch} {shape}: memory {mem}")
        emit("dryrun_cell", arch=arch, shape=shape, mesh=rec["mesh"],
             skipped=rec.get("skipped", False),
             **({} if rec.get("skipped") else dict(
                 memory=rec["memory"],
                 dominant=rec["roofline"]["dominant"],
                 roofline_fraction=rec["roofline"].get("roofline_fraction"),
                 useful_ratio=rec["roofline"].get("useful_ratio"),
                 bound_s=rec["roofline"]["bound_s"],
                 arg_bytes_per_device=rec["arg_bytes_per_device"],
                 reordered_leaves=rec["reordered_leaves"],
                 trace_s=rec["trace_s"],
                 collectives=rec["collectives"]["counts"],
                 kernels=rec["kernels"])))
    by_cell = {c[:2]: r for c, r in zip(DRYRUN_CELLS, recs) if not c[2]}
    pre = by_cell[("command-r-plus-104b", "prefill_32k")]
    dec = by_cell[("phi3-medium-14b", "decode_32k")]
    peak, args = (dec["memory"]["peak_memory_in_bytes"],
                  dec["memory"]["argument_size_in_bytes"])
    emit("dryrun_seq", prefill_cell="command-r-plus-104b prefill_32k",
         prefill_bound_s=pre["roofline"]["bound_s"],
         prefill_bound_limit_s=SEQ_PREFILL_BOUND_S,
         prefill_flops=pre["cost"]["flops"],
         prefill_useful_ratio=pre["roofline"].get("useful_ratio"),
         decode_cell="phi3-medium-14b decode_32k", decode_peak_bytes=peak,
         decode_arg_bytes=args, decode_peak_over_args=peak / args,
         decode_peak_limit_args=SEQ_DECODE_PEAK_ARGS,
         decode_collectives=dec["collectives"]["counts"],
         parent=SEQ_PARENT)
    check(pre["roofline"]["bound_s"] <= SEQ_PREFILL_BOUND_S,
          f"command-r prefill_32k: bound {pre['roofline']['bound_s']} s > "
          f"{SEQ_PREFILL_BOUND_S}")
    check(peak <= SEQ_DECODE_PEAK_ARGS * args,
          f"phi3 decode_32k: peak {peak} > {SEQ_DECODE_PEAK_ARGS} x its "
          f"argument bytes {args}")
    cfg = get_config("command-r-plus-104b")
    shapes = S.train_state_shapes(cfg)
    pod = {"data": 16, "model": 16}
    want = sharded_bytes(shapes, S.state_specs(cfg, pod, shapes), pod)
    got = next(r for c, r in zip(DRYRUN_CELLS, recs)
               if c == ("command-r-plus-104b", "train_4k", False))
    check(got["arg_bytes_per_device"] == want,
          f"command-r train_4k: {got['arg_bytes_per_device']} argument "
          f"bytes a device, its state's sharded_bytes {want}")
    emit("dryrun", cells=len(recs), workers=DRYRUN_WORKERS, wall_s=wall,
         wall_s_untracked=DRYRUN_WALL_UNTRACKED, cut=DRYRUN_CUT,
         command_r_train_arg_bytes=want,
         command_r_train_memory=got["memory"],
         memory_notes=got["memory_notes"],
         trace_s_sum=sum(r.get("trace_s", 0.0) for r in recs))
    return recs


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_train_run(cfg, dev, batches, opt_cfg, schedule, warm: int,
                    backend: str):
    """9b's work (the card's, or on the CPU a rehearsal's): one
    unsharded step of ``init_train_state(cfg, 0)`` on ``batches[0]``;
    then the same state sharded over a one-rank mesh (``state_specs``,
    ``batch_specs``, ``activation_sharding``, ``grad_specs``) through the
    same step, ``warm`` timed steps and one under the cost analyser and
    the tracker of live storage bytes (on the card, the allocator's peak
    of that step beside it) -> a dict of the hold, the launches, the
    times, the cost and the memory."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import input_specs
    from repro_torch.distributed import cost, memory
    from repro_torch.distributed.act_sharding import activation_sharding
    from repro_torch.distributed.auto_shard import Spec, shard_tree
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import ShapeSpec
    from repro_torch.models.model import tensors
    counters = lm_counters()
    counts = lambda: {n: c.count for n, c in counters.items()}  # noqa: E731
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    state = S.init_train_state(cfg, 0, dev)
    _, step = S.make_train_step(cfg, opt_cfg, schedule)
    state, m = step(state, batches[0])
    sync()
    want_loss = float(m["loss"])
    want = [t.cpu() for t in tensors(state["params"])]
    del state, m, step
    if dev.type == "cuda":
        free_card("shard_train_unsharded_done")
        torch.cuda.reset_peak_memory_stats()
    B, S_ = batches[0]["tokens"].shape
    shape = ShapeSpec("shard", S_, B, "train")
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh((1, 1))
        specs = S.state_specs(cfg, mesh, S.train_state_shapes(cfg))
        state = shard_tree(S.init_train_state(cfg, 0, dev), mesh, specs)
        b_specs = S.batch_specs(cfg, shape, mesh, input_specs(cfg, shape))
        tok = b_specs["tokens"]
        _, sstep = S.make_train_step(cfg, opt_cfg, schedule,
                                     grad_specs=specs["params"])

        def run(t, batch=None):
            if batch is None:
                batch = shard_tree(batches[t], mesh, b_specs)
            with implicit_replication(), \
                    activation_sharding(Spec(tok[0], tok[1])):
                return sstep(state, batch)
        for c in counters.values():
            c.reset()
        state, m = run(0)
        sync()
        launches = counts()
        loss = float(m["loss"].to_local())
        worst, mag, first = 0.0, 0.0, None
        for i, (p, w) in enumerate(zip(tensors(state["params"]), want)):
            p = p.to_local()
            w = w.to(p.device)
            if not torch.equal(p, w) and first is None:
                first = i
            worst = max(worst, float((p.double() - w.double()).abs().max()))
            mag = max(mag, float(w.double().abs().max()))
        del want
        ms = []
        for t in range(1, warm + 1):
            sync()
            t0 = time.perf_counter()
            state, m = run(t)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        # the counted step, under the cost analyser and the tracker of
        # live storage bytes, its batch placed first (live, not counted
        # as an argument), against the allocator's own peak of the step
        batch = shard_tree(batches[warm + 1], mesh, b_specs)
        batch_bytes = sum(t.to_local().untyped_storage().nbytes()
                          for t in batch.values())
        sync()
        alloc = {}
        if dev.type == "cuda":
            alloc["earlier_peak"] = torch.cuda.max_memory_allocated()
            alloc["before"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        with cost.counting() as counter, \
                memory.tracking(state, live=batch) as tracker:
            state, m = run(warm + 1, batch)
            tracker.add_outputs((state, m))
            sync()
        if dev.type == "cuda":
            alloc["peak"] = torch.cuda.max_memory_allocated()
        mem = tracker.result()
        peak = (max(alloc["earlier_peak"], alloc["peak"]) / 1e9
                if dev.type == "cuda" else None)
        mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        del state, m, batch
    finally:
        dist.destroy_process_group()
    return dict(loss=loss, want_loss=want_loss, launches=launches,
                bit_equal=first is None and loss == want_loss,
                first_differing_leaf=first, rel_err=worst / max(mag, 1e-30),
                warm_ms=ms, cost=counter.result(), peak_gb=peak,
                mesh=mesh_shape, tokens=B * S_, memory=mem,
                batch_bytes=batch_bytes, allocator=alloc)


def phase_shard_train():
    """9b: the sharded train step on the card (see ``shard_train_run``):
    its loss and updated parameters equal the unsharded step's bit for
    bit (else within ``SHARD_LIMIT`` of the largest, the first differing
    leaf named: the sharded norm sums on the DTensors, the unsharded one
    in AdamW's kernel), 8b's launches a step, AdamW's one a leaf among
    them (so ``local_map`` reached the kernels), and charged, its cost
    analyser's bound no more than the measured warm step, and its memory
    (``shard_memory``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed.roofline import roofline_terms
    from repro_torch.optim import AdamWConfig, linear_warmup_cosine
    dev = torch.device("cuda", 0)
    free_card("shard_train")
    cfg = get_config(TRAIN["arch"])
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN["seq"],
                                    global_batch=TRAIN["batch"], seed=0))
    batches = [{k: torch.as_tensor(v, device=dev).long()
                for k, v in pipe.batch_at(t).items()}
               for t in range(SHARD_WARM + 2)]
    opt_cfg = AdamWConfig(lr=3e-4)
    schedule = linear_warmup_cosine(3e-4, TRAIN["warmup"], TRAIN["steps"])
    r = shard_train_run(cfg, dev, batches, opt_cfg, schedule, SHARD_WARM,
                        "nccl")
    check(r["launches"] == TRAIN_LAUNCHES,
          f"sharded step launches {r['launches']}")
    # AdamW's kernel is charged once a leaf, on the leaf's local shard
    check(r["cost"]["kernels"] and {k: v["launches"] for k, v in
                                    r["cost"]["kernels"].items()}
          == TRAIN_LAUNCHES,
          f"charged launches {r['cost']['kernels']}")
    check(r["bit_equal"] or r["rel_err"] <= SHARD_LIMIT,
          f"sharded step: leaf {r['first_differing_leaf']} first differs, "
          f"{r['rel_err']} of the largest parameter; loss {r['loss']} vs "
          f"{r['want_loss']}")
    mem = shard_memory(cfg, r)
    n = cfg.param_count()
    model_flops = 6.0 * n * r["tokens"]
    terms = roofline_terms(r["cost"], r["cost"]["ici_bytes"],
                           model_flops_per_chip=model_flops)
    step_s = sorted(r["warm_ms"])[len(r["warm_ms"]) // 2] / 1e3
    check(terms["bound_s"] <= step_s,
          f"sharded step {step_s} s is faster than its bound "
          f"{terms['bound_s']} s")
    emit("shard_train", arch=TRAIN["arch"], batch=TRAIN["batch"],
         seq=TRAIN["seq"], mesh=r["mesh"], backend="nccl", world=1,
         loss=r["loss"], unsharded_loss=r["want_loss"],
         bit_equal=r["bit_equal"], rel_err=r["rel_err"],
         first_differing_leaf=r["first_differing_leaf"],
         launches=r["launches"], warm_ms=r["warm_ms"], step_ms=step_s * 1e3,
         bound_ms=terms["bound_s"] * 1e3, dominant=terms["dominant"],
         roofline_fraction=model_flops / PEAK_BF16_FLOPS / step_s,
         useful_ratio=terms["useful_ratio"], peak_memory_gb=r["peak_gb"],
         peak_memory_gb_8b=58.58, params=n,
         cost={k: r["cost"][k] for k in ("flops", "bytes accessed",
                                         "ici_bytes", "collective_counts",
                                         "kernels", "aten_ops", "top_ops")},
         terms=terms, memory=mem)
    return r["launches"]


def shard_memory(cfg, r) -> dict:
    """9b's memory checks: (i) the tracker's peak of the counted sharded
    step on the card within ``SHARD_MEM_LIMIT`` of the allocator's peak
    of the same step, and the step's rise (peak less what was live before
    it) within ``SHARD_RISE_LIMIT`` of the allocator's rise: the
    arguments, about 60% of the peak, are counted by construction, so the
    rise is what holds the tracker's own counting; (ii) the same step on
    meta tensors at world size 1 through the dry run's code path
    (``dryrun.measure``: a fake group of one, this config, batch 1 x
    3000) within ``SHARD_META_LIMIT`` of (i)'s tracker.  Prints them, the
    bytes the tracker does not see and what they are."""
    from repro_torch.distributed import memory
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import ShapeSpec
    card, alloc = r["memory"], r["allocator"]
    shape = ShapeSpec("shard", TRAIN["seq"], TRAIN["batch"], "train")
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        meta = dryrun.measure(cfg, shape, make_local_mesh(
            (1, 1), device_type="cpu"))["memory"]
    meta_s = time.perf_counter() - t0
    tracked = card["peak_memory_in_bytes"]
    registered = card["argument_size_in_bytes"] + r["batch_bytes"]
    vs_alloc = tracked / alloc["peak"] - 1.0
    rise, alloc_rise = tracked - registered, alloc["peak"] - alloc["before"]
    rise_vs_alloc = rise / alloc_rise - 1.0
    vs_meta = meta["peak_memory_in_bytes"] / tracked - 1.0
    out = dict(card_tracker=card, meta_world1=meta, meta_s=meta_s,
               allocator_peak=alloc["peak"],
               allocator_before=alloc["before"],
               tracker_vs_allocator=vs_alloc, tracker_rise=rise,
               allocator_rise=alloc_rise,
               rise_vs_allocator=rise_vs_alloc, meta_vs_card=vs_meta,
               limits={"tracker_vs_allocator": SHARD_MEM_LIMIT,
                       "rise_vs_allocator": SHARD_RISE_LIMIT,
                       "meta_vs_card": SHARD_META_LIMIT},
               unseen_bytes=alloc["peak"] - tracked,
               unseen=dict(
                   live_before_the_step_outside_its_arguments=(
                       alloc["before"] - registered),
                   rest=memory.UNSEEN))
    emit("shard_memory", **out)
    check(abs(vs_alloc) <= SHARD_MEM_LIMIT,
          f"sharded step: the tracker's peak {tracked} is {vs_alloc:+.2%} "
          f"of the allocator's {alloc['peak']}")
    check(abs(rise_vs_alloc) <= SHARD_RISE_LIMIT,
          f"sharded step: the tracker's rise {rise} is {rise_vs_alloc:+.2%} "
          f"of the allocator's {alloc_rise}")
    check(abs(vs_meta) <= SHARD_META_LIMIT,
          f"sharded step: the meta peak at world 1 "
          f"{meta['peak_memory_in_bytes']} is {vs_meta:+.3%} of the card's "
          f"tracker {tracked}")
    return out


def phase_shard_ranks():
    """9c: 4 gloo ranks on a (2, 2) mesh, on CPU tensors (``SHARD_RANK_
    DEVICE``), reduced recurrentgemma-2b and granite-moe-3b-a800m in
    float32, at batch 4 and at batch 2 (``SHARD_RANK_SEQ_BATCH``: the
    sequence over "model"): 2 sharded AdamW steps within
    ``shard_check.LIMIT`` of the unsharded ones on every rank, planted
    faults (each region's weight gradients taken as summed over the
    shards; at batch 2 also the gathered keys' and values' gradients)
    past it, and the collectives ``CommDebugMode`` saw equal to the cost
    analyser's count of the same cell on a fake (2, 2) group.  Then the
    split decode (``shard_check.run_decode_ranks``): every record within
    the limit, the chunks attended alone past it."""
    from repro_torch.configs import get_config
    from repro_torch.launch import shard_check
    from repro_torch.models.common import ShapeSpec
    device = SHARD_RANK_DEVICE
    for batch in (SHARD_RANK_CELL["batch"], SHARD_RANK_SEQ_BATCH):
        c = dict(SHARD_RANK_CELL, batch=batch)
        faults = (False, True) + (
            ("gathered",) if batch == SHARD_RANK_SEQ_BATCH else ())
        for arch in SHARD_RANK_ARCHS:
            t0 = time.perf_counter()
            normal, *faulty = shard_check.run_ranks(
                4, arch, c["mesh"], c["batch"], c["seq"], c["steps"],
                faults=faults, device=device, timeout_s=RANK_TIMEOUT_S)
            for r in normal:
                check(r["rel_err"] <= shard_check.LIMIT,
                      f"{arch} batch {batch} rank {r['rank']}: "
                      f"{r['rel_err']} of the largest parameter from the "
                      "unsharded steps")
            for fault in faulty:
                for r in fault:
                    check(r["rel_err"] > shard_check.LIMIT,
                          f"{arch} batch {batch} rank {r['rank']}: the "
                          f"planted fault {r['fault']} passes "
                          f"({r['rel_err']})")
            cost = shard_check.fake_cost(
                get_config(arch).reduced(),
                ShapeSpec("check", c["seq"], c["batch"], "train"),
                c["mesh"], device=device)
            check(cost["collective_counts"] == normal[0]["comms"],
                  f"{arch} batch {batch}: CommDebugMode saw "
                  f"{normal[0]['comms']}, the cost analyser counts "
                  f"{cost['collective_counts']}")
            emit("shard_ranks", arch=arch, ranks=4, backend="gloo",
                 device=device, **c, seq_axes=normal[0]["seq_axes"],
                 wall_s=time.perf_counter() - t0, limit=shard_check.LIMIT,
                 rel_err=[r["rel_err"] for r in normal],
                 fault_rel_err={str(f[0]["fault"]): [r["rel_err"] for r in f]
                                for f in faulty},
                 losses=normal[0]["losses"],
                 plain_losses=normal[0]["plain_losses"],
                 comms=normal[0]["comms"],
                 analyser_comms=cost["collective_counts"])
    t0 = time.perf_counter()
    recs = shard_check.run_decode_ranks(faults=(False, True), device=device,
                                        timeout_s=RANK_TIMEOUT_S)
    for r in recs:
        check(shard_check.decode_ok(r) != r["fault"],
              f"split decode {r['arch']} {r['layout']} rank {r['rank']} "
              f"(fault {r['fault']}): {r}")
    for r in (r for r in recs if r["rank"] == 0):
        emit("shard_decode", arch=r["arch"], layout=r["layout"],
             fault=r["fault"], ranks=4, backend="gloo", device=device,
             cell=r["cell"], chunk_dims=r["chunk_dims"],
             prefill_seq_axes=r["prefill_seq_axes"],
             prefill_rel_err=r["prefill_rel_err"],
             decode_rel_err=r["decode_rel_err"],
             cache_rel_err=r["cache_rel_err"], limit=r["limit"])
    emit("shard_decode_ranks", wall_s=time.perf_counter() - t0,
         records=len(recs))


def gloo_probe_rank(rank: int, world: int, store: str, op: str,
                    device: str, out: str) -> None:
    """One rank of ``phase_gloo_probe``: ``op`` once on a float32 tensor
    of ``device`` in a gloo group of ``world``; a Python exception, or
    the stack of a fatal signal, written to ``out``."""
    import faulthandler
    import traceback
    import torch.distributed as dist
    fh = open(out, "w")
    faulthandler.enable(fh)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        x = torch.arange(4 * world, dtype=torch.float32,
                         device=device) + rank
        if op == "all_reduce":
            dist.all_reduce(x)
        elif op == "broadcast":
            dist.broadcast(x, 0)
        elif op == "all_gather_into_tensor":
            dist.all_gather_into_tensor(
                torch.empty(4 * world * world, device=device), x)
        elif op == "reduce_scatter_tensor":
            dist.reduce_scatter_tensor(torch.empty(4, device=device), x)
        elif op == "all_to_all_single":
            dist.all_to_all_single(torch.empty_like(x), x)
        elif op == "funcol_all_gather":
            from torch.distributed import _functional_collectives as fc
            fc.wait_tensor(fc.all_gather_tensor(x, 0, dist.group.WORLD))
        elif op == "funcol_reduce_scatter":
            from torch.distributed import _functional_collectives as fc
            fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0,
                                                   dist.group.WORLD))
        else:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import (Replicate, Shard,
                                                  distribute_tensor)
            mesh = init_device_mesh(device, (world,))
            t = distribute_tensor(x.reshape(world, 4), mesh, [Shard(0)])
            t.redistribute(mesh, [Replicate()]).to_local()
        if device == "cuda":
            torch.cuda.synchronize()
    except Exception:
        fh.write(traceback.format_exc())
        fh.flush()
        raise
    finally:
        dist.destroy_process_group()


def phase_gloo_probe():
    """Where gloo ranks on CUDA tensors fail: each collective of
    ``GLOO_PROBE_OPS`` alone in gloo groups of ``GLOO_PROBE_WORLDS``
    ranks, on CUDA and on CPU tensors (no code of the port), then 9c's
    check on CUDA tensors at one rank (mesh (1, 1)) and at four -> a line
    for each: the ranks' exit codes and the first error or crash stack."""
    import multiprocessing as mp
    from repro_torch.launch import shard_check
    ctx = mp.get_context("spawn")
    for device in ("cuda", "cpu"):
        for world in GLOO_PROBE_WORLDS:
            for op in GLOO_PROBE_OPS:
                work = pathlib.Path(tempfile.mkdtemp(prefix="gloo-probe-"))
                outs = [str(work / f"rank{r}.txt") for r in range(world)]
                procs = [ctx.Process(target=gloo_probe_rank, args=(
                    r, world, str(work / "store"), op, device, outs[r]))
                    for r in range(world)]
                for q in procs:
                    q.start()
                for q in procs:
                    q.join(60)
                    if q.is_alive():
                        q.kill()
                        q.join(10)
                texts = [pathlib.Path(o).read_text() for o in outs
                         if pathlib.Path(o).exists()]
                emit("gloo_probe", device=device, world=world, op=op,
                     exit_codes=[q.exitcode for q in procs],
                     first_error=next((t for t in texts if t), "")[-2000:])
    c = SHARD_RANK_CELL
    for world, mesh in ((1, (1, 1)), (4, c["mesh"])):
        try:
            recs = shard_check.run_ranks(
                world, SHARD_RANK_ARCHS[0], mesh, c["batch"], c["seq"],
                c["steps"], device="cuda", timeout_s=RANK_TIMEOUT_S)[0]
            emit("gloo_probe", device="cuda", world=world, op="shard_check",
                 mesh=mesh, exit_codes=[0] * world, first_error="",
                 rel_err=[r["rel_err"] for r in recs])
        except RuntimeError as e:
            emit("gloo_probe", device="cuda", world=world, op="shard_check",
                 mesh=mesh, exit_codes=None, first_error=str(e)[-4000:])


def phase3_alone():
    """The thread probe, then phases 3-3d as the whole script runs them,
    and the rise of memory outside PyTorch's allocator across phase 3
    (``--phase3``)."""
    phase_thread_memory()
    phase_service()
    free_card("after phase 3")
    phase_cnn()
    phase_hpo()
    free_card("after phase 3b")
    phase_remote()
    free_card("after phase 3c")
    phase_fleet()
    free_card("after phase 3d")
    return phase3_outside_rise()


def serve_phases():
    """Phases 5, 5b and 5c alone (``--serve``): the LM servers' prefill
    ms and decode tokens/s, each phase's card freed after it."""
    phase_serve()
    free_card("after phase 5")
    phase_moe_serve()
    free_card("after phase 5b")
    phase_encdec_serve()
    free_card("after phase 5c")


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    CARD = card_line()
    if sys.argv[1:] == ["--device-times"]:
        phase_device_times()
        print(card_line())
        return 0
    if sys.argv[1:2] == ["--hpo"] and len(sys.argv) == 3:
        runs, passed = int(sys.argv[2]), 0
        for i in range(runs):
            try:
                phase_hpo()
                passed += 1
            except RuntimeError as e:
                print(f"chip_smoke: hpo run {i}: {e}", flush=True)
        print(f"hpo: {passed} of {runs} runs passed")
        print(card_line())
        return 0 if passed == runs else 1
    if sys.argv[1:] == ["--remote"]:
        phase_remote()
        phase_fleet()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--phase3"]:
        phase_card()
        phase3_alone()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--moe"]:
        phase_card()
        phase_moe_kernels()
        phase_moe_serve()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--encdec"]:
        phase_card()
        flash_layouts(ENCDEC_FLASH_CASES, "4c")
        phase_encdec_serve()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--vlm"]:
        phase_card()
        flash_layouts(VLM_FLASH_CASES, "4d")
        phase_vlm_serve()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--train"]:
        phase_card()
        phase_train_kernels()
        phase_train(trace=True)
        phase_train_parity()
        phase_population()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--population"]:
        phase_card()
        phase_population()
        phase_population_families()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--train-families"]:
        phase_card()
        phase_family_bwd()
        phase_family_parity()
        phase_family_train()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--offsets"]:
        phase_card()
        flash_offsets()
        flash_offsets(backward=True)
        print(card_line())
        return 0
    if sys.argv[1:] == ["--shard"]:
        phase_card()
        phase_dryrun()
        phase_shard_train()
        phase_shard_ranks()
        print(card_line())
        return 0
    if sys.argv[1:] in (["--serve"], ["--shard", "--serve"]):
        phase_card()
        if "--shard" in sys.argv:
            phase_dryrun()
            phase_shard_train()
            phase_shard_ranks()
            free_card("after phase 9")
        serve_phases()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--adamw"]:
        phase_card()
        phase_adamw_kernel()
        print(card_line())
        return 0
    if sys.argv[1:] == ["--gloo-cuda"]:
        phase_gloo_probe()
        print(card_line())
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    card = phase_card()
    # phase 8 first: the population needs ~65 GB of an 80 GB card (8g's
    # granite-moe-3b-a800m ~70 GB), and the later phases leave the
    # allocator fragmented and memory held outside it (a cuBLAS and a
    # cuSOLVER handle for each thread that ran the GP on the card, now a
    # fixed set, repro_torch.card_pool; a cuBLAS and a cuDNN handle for
    # each of 3b's trial threads: phase3_outside_rise)
    summary = phase_train_kernels()
    train = phase_train()
    phase_train_parity()
    population = phase_population()
    pop_families = phase_population_families()
    family_layouts = phase_family_bwd()
    phase_family_parity()
    families = phase_family_train()
    # phase 9 here, while the card holds nothing outside the allocator
    # (a run of it after phase 6c once ran out of memory beside 15.3 GB
    # that the GP's threads held before they were confined)
    phase_dryrun()
    sharded = phase_shard_train()
    phase_shard_ranks()
    free_card("after phase 8")
    summary.update(phase_kernels())
    phase_gp_parity()
    phase_gp_host()
    phase_thread_memory()
    launches = phase_service()
    free_card("after phase 3")
    phase_cnn()
    hpo = phase_hpo()
    free_card("after phase 3b")
    remote = phase_remote()
    free_card("after phase 3c")
    fleet = phase_fleet()
    free_card("after phase 3d")
    phase3_outside_rise()
    summary.update(phase_lm_kernels())
    offsets = flash_offsets()
    phase_moe_kernels()
    launches.update(phase_serve())
    free_card("after phase 5")
    moe = phase_moe_serve()
    free_card("after phase 5b")
    layouts = flash_layouts(ENCDEC_FLASH_CASES, "4c")
    layouts.update(offsets)
    encdec = phase_encdec_serve()
    free_card("after phase 5c")
    layouts.update(flash_layouts(VLM_FLASH_CASES, "4d"))
    vlm = phase_vlm_serve()
    free_card("after phase 5d")
    summary.update(phase_quant_kernels())
    summary.update(phase_adamw_kernel())
    launches.update(phase_compress())
    free_card("after phase 6b")
    phase_compress_ranks()
    free_card("after phase 6c")
    phase_device_times()
    kernels = [
        dict(name="gp_nll", route="cuda",
             source="src/repro_torch/kernels/csrc/gp_nll.cu",
             replaces="src/repro/kernels/gp.py:129",
             launches=launches["gp_nll"], **summary["gp_nll"]),
        dict(name="gp_ei", route="cuda",
             source="src/repro_torch/kernels/csrc/gp_ei.cu",
             replaces="src/repro/kernels/gp.py:254",
             launches=launches["gp_ei"], **summary["gp_ei"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:97",
             launches=launches["flash_attention"],
             **summary["flash_attention"], layouts=layouts),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan.py:40",
             launches=launches["rglru_scan"], **summary["rglru_scan"]),
        dict(name="int8_quantize", route="cuda",
             source="src/repro_torch/kernels/csrc/int8_quant.cu",
             replaces="src/repro/kernels/int8_quant.py:28",
             launches=launches["int8_quantize"],
             **summary["int8_quantize"]),
        # new: XLA fuses the reference's update (src/repro/optim/adamw.py)
        dict(name="adamw", route="cuda",
             source="src/repro_torch/kernels/csrc/adamw.cu",
             replaces="none", launches=train["adamw"], **summary["adamw"]),
        # the gradients of the two LM kernels: the Pallas kernels have no
        # backward, so each replaces its forward's TPU kernel
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:97",
             launches=train["flash_attention_bwd"],
             **summary["flash_attention_bwd"], layouts=family_layouts),
        dict(name="rglru_scan_bwd", route="cuda",
             source="src/repro_torch/kernels/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan.py:40",
             launches=train["rglru_scan_bwd"], **summary["rglru_scan_bwd"]),
    ]
    for k in kernels:
        k["hpo_launches"] = hpo.get(k["name"], 0)
        k["remote_launches"] = remote.get(k["name"], 0)
        k["fleet_launches"] = fleet.get(k["name"], 0)
        k["train_launches"] = train.get(k["name"], 0)
        k["population_launches"] = population.get(k["name"], 0)
        k["population_families_launches"] = pop_families.get(k["name"], 0)
        k["moe_serve_launches"] = moe.get(k["name"], 0)
        k["encdec_serve_launches"] = encdec.get(k["name"], 0)
        k["vlm_serve_launches"] = vlm.get(k["name"], 0)
        k["train_families_launches"] = families.get(k["name"], 0)
        k["sharded_train_launches"] = sharded.get(k["name"], 0)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(RESULTS, kernels=kernels, card=card), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
