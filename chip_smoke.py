#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing its own lines; any
failure raises and the script exits non-zero without a result line:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel from ray_tpu_torch/csrc (rms_norm, flash_fwd,
   flash_bwd, flash_bwd_dq, flash_bwd_dkv, flash_chunk_fwd,
   flash_chunk_bwd, chunk_tile_bounds, flash_packed_fwd), one nvcc each,
   all at once, for sm_90a; ptxas registers and spills by kernel
   instantiation (any spill of a flash, chunk or pre-pass kernel fails)
   and each flash kernel's dynamic shared memory;
3. kernel vs plain: rms_norm's kernel against rms_norm_reference over a
   grid of row counts, widths and dtypes, plus times at the engine's and
   the trainer's shapes (kernel, plain version, torch.nn.functional.
   rms_norm, bound: device time per call, and host time per eager call);
4. kernel vs plain: flash_fwd (K2) and flash_bwd (K3, the Hopper designs:
   TMA rings, wgmma, 128-row tiles, K3's dq summed across its CTAs by
   float4 reductions and its delta made inside it) against their plain
   twins over causal/non-causal, GQA rep 1/4, head_dim 64/128, S 2048 and
   a ragged length, and the training shape; K3's dk/dv bit-identical on
   repeat there and its dq within tolerance of a second run; each build's
   registers; B 65536 (H1 S64 D64, causal and not) through K2, K3, K6 and
   K7 against their twins (more batch rows than a grid's y or z dimension
   holds); then times at the training shape (B4 H32 Hkv8 S2048 D64 causal
   bf16): kernel, twin, bound, and scaled_dot_product_attention (forward;
   forward + backward, and its backward alone, for flash_bwd) as the
   yardstick;
4b. kernel vs plain: the split backward, flash_bwd_dq (K4) and
   flash_bwd_dkv (K5, which folds the GQA heads inside the kernel)
   against flash_bwd_split_plain over causal/non-causal, GQA rep 1/4,
   head_dim 64/128 and S 2048, 197 (ViT-B/16's tokens) and a ragged 1000,
   then rep 2 and 8, the 128-row tile edges (S 127, 128, 129, 257), S 1,
   and B * H = 65544 (B5462 H12 S8); two launches on the same inputs
   bit-identical at head_dim 64 and 128, causal and not; then K4 and K5
   timed at the training shape, and the whole split backward through its
   wrapper beside K3's (both compute delta), the twins, the bound and
   scaled_dot_product_attention's backward alone;
4c. kernel vs plain: the head-packed forward kernels packed_fwd_epi (K8),
   packed_fwd_inl (K9) and packed_fwd (K10) of the profiling entry point
   ray_tpu_torch.devbench.prof_flash_pack against their twins over
   causal/non-causal, GQA rep 1/4, head_dim 64/128 and every (pack,
   block_q, block_k) each takes (B1 H8 S512), and at the profiling shape
   (B4 H32 Hkv8 S2048 D64 causal, the defaults pack 2, block_q 64,
   block_k 64), and at B * H / pack = 65536 (B65536 H2 Hkv1 S64); at the
   profiling shape every variant at block_k 64 bit-identical
   to K2, and for each block_k every variant of the three kernels the
   same bits; times of the defaults beside the bound, the twin, K2 and
   causal SDPA, with TFLOP/s and ptxas registers; then the entry point's
   check and its sweep of K2 and the 25 packed variants (launch counts
   reset right before the sweep and read right after);
5. kernel vs plain: the ring's chunk kernels flash_chunk_fwd (K6) and
   flash_chunk_bwd (K7, nonzero lse cotangent), and their tile-bounds
   pre-pass chunk_tile_bounds, against their twins over causal/non-causal,
   GQA rep 1/4, head_dim 64/128 and nine position cases (the diagonal
   chunk, a past, a future and an offset chunk, ragged lengths partly and
   wholly masked, and the tile classes' cases: rows that see no key beside
   rows that do, shuffled positions, S 1024 causal; there rows that see no
   key keep lse < -1e29 and K7's dk/dv repeat bit for bit), the sp = 4
   ring's past, diagonal and future chunks (B1 H32 Hkv8 Sq=Skv=4096 D64)
   and the CP step's own shape (B1 H32 Hkv8 S16384 D64, positions 0..S-1,
   causal); then times at the CP step's shape and at the ring's past
   chunk: kernel, twin, bound (the FLOPs the mask keeps), TFLOP/s over the
   kept pairs and at the full-pass rate, the (q tile, kv tile) pairs each
   kernel skips, masks and takes whole, and scaled_dot_product_attention
   (forward for K6, its backward alone for K7) as the yardstick; the
   pre-pass's time at the CP step's positions;
6. the ring's schedule at sp = 4 in one process: B1 H32 Hkv8 S16384 D64
   bf16 in four chunks, every (virtual rank, step) pair through the flash
   ring step (16 K6 launches, 16 K7 through autograd), output and dq/dk/dv
   against flash_fwd/flash_bwd on the whole sequence, chunk by chunk;
7. the serving path: the LLM engine at Llama-3.2-1B width (bf16, seeded
   random weights) serving a warm-up wave and then WAVES timed waves of
   concurrent greedy requests (median and range reported), a two-chunk
   prefill, prefix-cache hits and chained decode bursts; kernel launch
   counts are reset right before it and read right after; then the host
   vs device split of one 16-step decode burst;
8. the training path: make_llama_train_step at the 1.1B bench geometry
   (bench.py), b4 s2048, remat attn+, adamw_lowmem, seeded random weights
   and tokens: 2 warm-up and 10 timed steps with counts reset right before
   and read right after (they must equal what the remat policy predicts);
   with the earlier phases' heap frozen out of the garbage collector:
   tokens/s, step ms and MFU over the whole timed window, the per-step
   spread, peak memory and its split, the loss trajectory (finite,
   falling) and a profiler split of three steps;
8b. the same trainer with the split backward (K4 + K5): first the loss and
   every parameter's gradient against the fused backward on the same
   params and batch (each run twice beside it), then 2 warm-up and 5
   timed steps, launches per step as predicted (K4/K5 for K3), the first
   loss bit-equal to phase 8's;
9. the context-parallel training path: first one forward + backward with
   sp_axis = a one-rank NCCL group (ring attention through K6/K7) against
   sp_axis=None (K2/K3) on the same params and batch (the loss, the final
   hidden states row by row, every parameter's gradient); then
   make_train_step over loss_fn with that sp_axis at the 1.1B geometry,
   b1 s16384, remat attn+, adamw_lowmem: 2 warm-up and 3 timed steps,
   launches per step against the prediction (16 K6, 16 K7, no K2/K3),
   step ms, tokens/s, peak memory, the losses, a profiler split of one
   step;
9b. the ViT-B/16 training path: make_vit_train_step at ViT-B/16 (224 px,
   patch 16, hidden 768, 12 layers, 12 heads, 86.4M params, bf16), b128,
   remat none, adamw_lowmem, seeded images and labels, once with the
   fused and once with the split backward: 2 warm-up and 10 timed steps
   each, launches per step as predicted, images/s, step ms, MFU
   (vit_train_flops), peak memory, a profiler split of one step, the
   first losses bit-equal, and for each run the device time by PyTorch
   op; then the loss and every parameter's gradient at b128, the split
   backward against the fused one and each against plain f32 attention
   (blockwise_attention); then K2, K3, K4, K5 against their twins at its
   attention (B128 H12 S197 D64, non-causal), K4/K5 bit-identical on
   repeat, and K2-K5 and both whole backwards timed there beside
   non-causal SDPA;
10. with two or more cards visible, the ring over ranks, one card each
   (NCCL; the largest power of two of them): ring attention at S16384
   against one card's flash_fwd/flash_bwd, then the phase-9 model through
   make_llama_train_step over build_mesh(MeshSpec(sp=world)) (the ring
   over the mesh's sp group, gradients averaged by the step): the final
   hidden states and the first step's loss and grad norm against one
   card's sp_axis=None, then timed steps with their updates; with one
   card it prints that it skipped;
13. data-parallel training at Llama-3-8B width (vocab 128256, hidden
   4096, MLP 14336, 32/8 heads of 128, untied; depth cut to 8 of 32
   layers, 2.80B params), b4 s2048, bf16, remat attn+, adamw_lowmem,
   seeded weights and tokens, through the step factory in five modes from
   one param tree: (a) mesh=None, (b) flat over a one-rank NCCL mesh, (c)
   zero1, (d) zero1 + grad_accum 2 + grad_norm_every 2, (e)
   hybrid_mesh(dp=1, dcn dp) + zero1 + int8 gradients; 2 warm-up and 3
   timed steps each: step ms, tokens/s, MFU, peak memory, moments, launches
   per step as predicted; (b)/(c) against (a)'s losses (first bit-equal),
   (d) and (e) within their limits, (e) off (a) at step 2; a profiler
   split of one (c) step;
13b. with two or more cards, one card a rank (NCCL): phase 13's model at
   its global b4 s2048 under flat, zero1 and a two-slice hybrid mesh
   (dcn dp, zero1, int8), losses against phase 13's (a), per-rank peak
   memory and moments (1/world under zero1); then Llama-3-8B at full
   depth (16 layers below four cards) under zero1 at b1 s2048 a rank:
   tokens/s per card, MFU, per-rank peak memory; with one card it prints
   that it skipped;
14. pipeline (GPipe) training at phase 13's Llama-3-8B width and depth
   cut (8 of 32 layers), b4 s2048, 4 microbatches of one row, bf16, no
   remat, JAX's default adamw (moments in the params' bf16), through
   parallel.pipeline.make_pp_train_step on a one-rank NCCL mesh (pp=1:
   the microbatch loop, the per-microbatch backward, the shared params'
   reductions): the first loss against make_llama_train_step(mesh=None,
   remat="none")'s with the unfused head (loss_fn(fused_ce=False)) on the
   same params and batch, 1 warm-up and 3 timed steps, the loss falling,
   launches per step as predicted (K1, K2, K3 at head_dim 128, per
   microbatch), step ms, tokens/s, MFU, peak memory, the bubble share
   (P - 1) / (M + P - 1) and a profiler split of one step;
14b. with two or more cards, one card a rank (NCCL, at most four): pp2
   (4 layers a stage) on two cards, pp2 x dp2 (two microbatches a rank)
   and pp4 on four, each rank's losses step by step against phase 14's;
   with one card it prints that it skipped;
15. Mixtral training at 8x7B's published widths (vocab 32000, hidden
   4096, MLP 14336, 32/8 heads of 128, 8 experts, top-2, capacity factor
   1.25, rope theta 1e6), depth cut to 2 of 32 layers (3.165B params),
   b4 s2048 (T 8192, capacity 2560), bf16, remat full, the step factory's
   default adamw (bf16 moments), through make_mixtral_train_step: (a)
   mesh=None and (b) the default rules on a one-rank NCCL mesh (expert
   leaves over ep, the routing's claim gather and the ep conjugates on
   one-rank groups), 1 warm-up and 3 timed steps each: step ms, tokens/s,
   MFU over the active params, peak memory, launches per step as
   predicted, (b)'s losses bit-equal to (a)'s, a profiler split of one
   (a) step; the claims dropped past capacity at the seeded params, and
   the one-hot dispatch/combine products timed at the step's shapes with
   their share of the step;
15b. with two or more cards (at most four): Mixtral at 4 layers under
   ep = cards (each rank its experts, every rank the whole batch) and, on
   four cards, dp2 x ep2: the first loss against one card's mesh=None
   loss at that depth and layer 0's claims per expert against one card's
   (equal under ep alone), step ms, tokens/s per card, MFU, per-rank
   peak; with one card it prints that it skipped;
16. RL (ray_tpu_torch.rl): (a) the batched envs VecCartPole, VecCatch and
   VecGridWorld under AutoResetWrapper, 4096 envs x 200 seeded steps, each
   step from the card's state on the card and on the CPU with the same
   fresh episodes: CartPole's obs within 1e-5 and the same dones (one may
   differ only at a termination threshold), Catch and GridWorld exact;
   (c) Anakin PPO at Podracer scale (CartPole-v1, 4096 envs x 128 unroll
   x 8 iterations a call, hidden 64, 4 x 4 minibatches): 1 warm-up and 5
   timed calls (env-steps/s, ms an iteration, peak memory), one profiled
   call of one iteration (its kernels, device busy share, device-to-host
   copies: exactly one), the return over 20 calls rising by more than
   10, and one iteration split into rollout, GAE and update; (b) GAE,
   V-trace, ppo_update and Anakin's _update at that batch (524288 rows)
   and dqn_update, sac_update, impala_update and appo_update at their
   configs' defaults, each on the card against the CPU on the same
   inputs; the README's geometry (512 x 64 x 8) timed; (d) the EnvRunner
   path (PPOConfig's defaults), DQN, SAC (Pendulum), IMPALA and APPO with
   device "cuda", three steps each: finite losses, env-steps/s;
16b. with two or more cards, one card a rank (NCCL): one card's Anakin
   rate, then (c)'s config over the ranks with its 4096 envs split
   ("strong") and with 4096 envs a rank ("weak"), 1 warm-up and 3 timed
   calls each: env-steps/s in all and per card, the ranks' params
   bit-equal after every call; with one card it prints that it skipped;
17. the rest of serving at Llama-3.2-1B width (seeded random weights;
   rms_norm's launch count reset right before and read right after):
   (a) in f32 at 2 layers, phase 7's 16 prompts through the dense engine
   and the block pool (16 slots, 512 blocks of 16: phase 7's 8192 tokens
   of KV) and through a 160-block pool that must preempt, every greedy
   stream equal; in bf16 at full depth phase 7's wave dense at
   concurrency 8 against blocked at 16, in turns (tok/s, TTFT p50, their
   spread, preemptions, the pool's bytes), a block prefix adoption, and
   decode_burst_blocked against decode_burst (wall, and device busy by
   the profiler); (b) speculative decoding (k 4) with a perfect and a
   seeded 2-layer draft: in f32 every stream equal to plain greedy, the
   perfect draft's acceptance above 0.9; in bf16 a stream may differ only
   at a near-tie (SPEC_TIE_ULPS); a tick's draft_propose and
   spec_verify_step against five decode steps; (c) the P/D hand-off
   between two bf16 engines on one param tree at 128 and 700 prompt
   tokens, bit for bit against one engine's greedy tokens, the prompt
   retired, export and import ms; (d) in f32 an HF-named state dict
   through convert_hf_llama and a save_pytree directory through
   checkpoint_path, each giving the original params' tokens;
18. the rest of RL (no kernel of csrc/ runs: their counts, set to 0 at
   the start, must stay 0; TF32 off): (a) tests/test_rl.py's expert
   CartPole data (30 episodes of the angle+velocity controller) through
   ray_tpu_torch.data; BC 5 steps x 3 epochs with 3 greedy evaluation
   episodes, its action accuracy above 0.8 (the JAX test's bar); MARWIL
   and CQL 3 steps each (samples/s); bc_update, marwil_update and
   cql_update, 3 updates each, on the card against the CPU; (b)
   MultiAgentPPO on CoordinationGame (shared policy) and ChaseGame (pred
   and prey policies), 3 steps each (env-steps/s), one policy's GAE and
   update on the card against the CPU; (c) Dreamer at DreamerConfig()'s
   defaults on CartPole-v1 for 12 iterations: the return by iteration
   beside the JAX test's bar (a finding: the random stream is not JAX's),
   env-steps/s, peak memory; dreamer_update timed on CUDA events and the
   host clock with one profiled update (kernels, device busy share) at
   the defaults and at DreamerV3's S geometry (B16 T64 H15, 512 units);
   (d) one dreamer_update on the card against the CPU with the same
   noise: every loss term, every gradient leaf, the params after the
   step;
19. TorchTrainer on the port's in-process runtime (ray_tpu_torch.init,
   the train controller, its worker group and checkpoint restarts), at
   phase 8's 1.1B geometry, full depth, fused backward: (a) the step run
   directly for steps 0-5 (batch i from a numpy generator seeded by i),
   then under TorchTrainer with one worker (use_gpu, a one-rank NCCL group
   through TorchBackendConfig(distributed=True), max_failures 1): rank 0
   saves with save_pytree after step 2, the first attempt raises at the
   start of step 4, the resumed one restores and runs 3-5; the reported
   losses bit-equal to the direct loop's (step 3's in both attempts), the
   restart recorded as (checkpoint, worker_error), K1-K3 launched inside
   the worker thread as the remat policy predicts for the 7 steps run,
   the train thread on cuda:0, the card's allocated memory back within 64
   MiB of its value before fit() when the restarted attempt starts; the
   median step time under the trainer beside the direct loop's, the
   checkpoint's bytes and save time, the restart time split into the
   group rebuild and init, the restore and the first step, each attempt's
   peak memory; (b) tests/test_train.py's two-worker quadratic in CUDA f32
   tensors, the gradient averaged through the host collective (one card a
   rank with two or more cards, else both threads on cuda:0): both ranks'
   w bit-equal, and equal to the same program on the CPU; (c) the
   refusals: distributed=True at two workers raises NotImplementedError
   before any worker starts, use_gpu=True on a runtime with no "GPU"
   resource raises ValueError without hanging;
20. Serve on the card (ray_tpu_torch.serve on the in-process runtime,
   init(resources={"GPU": 1})): phase 7's engine configuration, its
   seeded weights (embedding rows from 128 up zeroed, so greedy outputs
   are visible ASCII) written once as a save_pytree directory that the
   direct engine and every replica load, behind build_openai_app with
   ray_actor_options={"num_gpus": ...}, reached over HTTP through the
   proxy, handle, router and replica: (a) phase 7's wave through POST
   /v1/completions by eight urllib clients, a warm-up then P20_WAVES
   timed waves in turns with the engine driven directly, every
   completion's text, usage and finish_reason equal to the engine's;
   tok/s of both (median [min, max]), their ratio, and the median latency
   a request adds over HTTP; (b) POST /v1/chat/completions with stream:
   true, a wave and P20_STREAM_WAVES more, each in turn with the engine
   driven directly: every line an SSE data line, [DONE] last, the
   frames' deltas equal to the non-streaming and the direct text, TTFT
   p50/p90 (request to first data frame) beside the engine's own
   first_token_ts - submit_ts; (c) autoscaling (min 1, max 2, target 4 ongoing, short
   delays, num_gpus 0.5 a replica): waves until both replicas have
   served, the replica count over time 1 -> 2 -> 1, the tokens equal
   to the engine's; after each serve.shutdown() the card's allocated
   memory (cuBLAS workspaces cleared for each reading) back within
   P20_MEM_SLACK of its value before serve.run, and the workspaces so
   freed at most P20_CUBLAS_WORKSPACE for each engine thread that ran
   at once (2 in (a)/(b), 3 in (c)); (d)
   the refusals, each at once: placement_group_bundles, grpc_options,
   a replica's tensor_parallel_size above the visible cards (ValueError),
   num_gpus on a runtime with no "GPU" resource;
   rms_norm's launches counted over the HTTP waves only;
21. tuning on the card: (a) every remat policy (none, full, attn, attn+,
   dots, dots+ and "dots:8,attn:8") at phase 8's configuration from the
   same seeded params on the same batch, 1 warm-up and 3 timed steps each:
   step 1's loss bit-equal to none's, one forward + backward's gradients
   within test_torch_train.py's tolerance of none's (bit-equality
   printed), K1-K3 launches per step as predicted_launches says; step ms,
   tokens/s, peak memory beside the autotuner's prediction; then
   ViT-B/16 (phase 9b's b128) and Mixtral (phase 15's configuration)
   under none, attn and dots with the same gates, and the 1.1B step under
   dots with RTPU_CE_CHUNK 256 and 2048 (loss within 1e-5 of chunk
   512's; peak and ms); (b) the train-step autotuner at the 1.1B
   geometry, s2048, over candidate_space(16, batches=(4, 8)) within
   device_hbm_budget_bytes(), measuring 6 (each build and step inside its
   candidate's applied_env, peak by max_memory_allocated, a finally that
   frees everything): a measured winner, every failure an
   OutOfMemoryError, card memory back after the search, each measured
   peak over its prediction, the rerun from the cache alone choosing the
   same winner; (c) Tune on ray_tpu_torch.init(resources={"GPU": 1}):
   four trials at once ({"CPU": 1, "GPU": 0.25}) of a 2-layer 1.1B-width
   step at b2 s2048 over four learning rates under ASHA (max_t 8, grace
   2), each trial's losses bit-equal to the same function run directly,
   the best lr the direct runs', card memory back after fit(); then
   Tuner(TorchTrainer) over two learning rates, each final loss equal to
   the trainer alone's; K1-K3's launches counted over each part;
22. the mesh layouts of the training step on one card, each on a one-rank
   NCCL mesh against its reference's losses bit for bit, step by step,
   with launches per step as predicted, step ms and peak beside the
   reference's: (a) phase 13's model (Llama-3-8B width, 8 layers, b4
   s2048, attn+, adamw_lowmem) with embed on tp and layers on pp (every
   split dim gathered, the stacked layers dim once a step) against phase
   13's (a), and ViT-B/16 at b128 with classes on tp against mesh=None;
   (b) the unfused loss (loss_fn(fused_ce=False)) under the default rules
   against mesh=None's; (c) FSDP + zero1 at one layer of that width,
   written after step 2 through the write-behind writer, restored with
   mesh=None and at the same mesh, steps 3-4 bit-equal to the
   uninterrupted run's (bytes, save and restore seconds); (d) phase 15's
   Mixtral with the batch over (dp, ep) (the all-to-all dispatch's
   reduce-scatter and all-gather on one-rank groups) against phase 15's
   (a);
22b. with four cards, one a rank (NCCL): context parallelism under FSDP
   and TP (fsdp2 x sp2, tp2 x sp2; the ring through K6/K7 over sp, the
   gathers over fsdp, the tp conjugates) at Llama-3-8B width, 8 layers,
   global b2 s8192, adamw at 2e-5 (the loss falls step by step), every
   step's loss and the first grad norm against one card's run of the
   same batch (mesh=None, K2/K3), launches a rank a step as predicted,
   tokens/s per card and per-rank peak; Mixtral at phase 15's 2 layers
   (4 do not train on one card) and phase 15b's global batch under dp2 x
   ep2 as 15b runs it (the ep ranks on the same rows), with the batch
   over (dp, ep) and sp2 x ep2 (the ring, the routing in JAX's token
   order), tokens/s per card beside the first, each against one card's
   training run: under adamw the first loss and grad norm, under plain
   SGD every step's loss and the first grad norm; an
   FSDP + zero1 state saved at fsdp2 x dp2 and restored at tp2 x dp2,
   stepped on; with fewer cards it prints that it skipped;
11. cross-device: f32 engines at tiny width (d=64) and at 1B width with
   two layers (d=2048), CUDA (kernel) vs CPU (plain) greedy token streams
   must be equal; a bf16 trainer at small width, 3 steps on the card
   (kernels) vs 3 on the CPU (plain twins) from one param tree: losses
   agree and the norm weights' gradients are non-zero and agree; a bf16
   ViT (head_dim 64, 65 tokens) under each backward choice: every
   parameter's gradient of one forward + backward and the losses of 3
   steps, on the card vs on the CPU, agree;
23. tensor-parallel serving, tp 1: Llama-3-8B (all 32 layers, bf16,
   seeded random weights) through the engine with phase 7's wave (16
   greedy prompts, concurrency 8, 64 out): tok/s, TTFT p50, peak memory,
   K1's launches over the wave; the streams and the first prefill chunk's
   logits kept for 23b; the card's memory back within P20_MEM_SLACK after
   shutdown(); then a tensor_parallel_size above the visible cards raises
   ValueError before any process starts;
23b. with two or more cards, one a rank (NCCL), phase 23's weights at tp
   2 and (four cards) tp 4: (a) the first prefill chunk's logits within
   P23B_LOGIT_FACTOR x tp 1's own move when the chunk is padded, the
   wave's greedy streams against 23's (equal count; each first divergence
   a near-tie: within the larger of SPEC_TIE_ULPS bf16 steps and twice
   that fixed bound), a temperature-0.8, top-p-0.9 wave whose tokens
   every rank reports equal; (b) the block pool at 16 slots and (c)
   speculation (k 4, a seeded 2-layer draft) against (a)'s streams under
   the same rule; (d) at tp 2, the P/D hand-off from one tp-2 engine into
   another, tokens equal to the prefill engine's own; (e) build_openai_app
   at the largest tp, a wave over HTTP whose texts equal the direct
   engine's; (f) at the largest tp, a follower killed mid-burst: the
   requests fail within P23B_FAIL_S and shutdown() returns within
   P23B_STOP_S; for each tp tok/s, TTFT p50, per-rank peak, K1's launches
   on every rank, collectives a decode step against the code's count,
   NCCL ms a step, rank 0's host us a collective and the header's host us
   a device call; after each shutdown() no follower alive and every
   card's memory back within P20_MEM_SLACK; with one card it prints that
   it skipped;
24. Ray Data on the port's runtime (ray_tpu_torch.data): (a) batch
   inference through build_llm_processor at phase 7's engine (llama3_1b,
   bf16, its seeded weights; 64 slots), 256 seeded ASCII prompts of 128-512 bytes
   in blocks of 64 through one pool actor (num_gpus=1): every row back
   once, each generation's token ids equal to a direct engine's on the
   same prompts, K1 launched on the pool's engine, the GPU resource and
   the card's memory back after the pool's shutdown; rows/s, tok/s beside
   phase 7's, the card's busy share over a profiler window; (b)
   TorchTrainer(datasets=) at phase 8's 1.1B geometry (b4 s2048, attn+,
   adamw_lowmem), one worker on the card reading 4096 seeded rows of
   2049 token ids (64 blocks, a map_batches splitting tokens and targets)
   through get_dataset_shard and iter_torch_batches(prefetch=2) for 5
   steps: losses bit-equal to the same step fed the same batches
   directly, K1-K3 launches as predicted; step ms beside the direct
   step's and the host ms each step waited for its batch; (c)
   range(65536) over two workers through streaming_split(2, equal=True):
   every row once, equal splits, rows/s;
25. tracing, profiling and the goodput ledger (util/tracing.py,
   profiling/, observability/goodput.py, util/state): (a) phase 19's
   TorchTrainer at the 1.1B geometry (b4 s2048, attn+, K1-K3) with
   tracing on, one worker for P25_STEPS steps with profile_cluster
   (P25_CAPTURE_S, from the main thread) mid-fit: the merged chrome trace
   must hold K1-K3's kernels by name, the goodput.* lane and the workers'
   task spans; device_memory()'s cuda:0 bytes equal to memory_allocated
   read around it; the rank's goodput snapshot (mid-fit and final) with
   unattributed_s at most P25_UNATTRIBUTED_S and phases + open tail
   within P25_WALL_SLACK_S of its wall clock; the step_compute share and
   the ledger's self-cost; then two workers on the host collective
   (phase 19 (b)'s quadratic and a bf16 matmul a step), each rank's
   snapshot held alike and stragglers() ranking both; (b) phase 20's
   LLMServer (seeded Llama-3.2-1B, bf16, 8 slots) behind two deployments,
   trace_sample_rate 1.0 and 0.0: waves of P25_WAVE prompts (phase 7's
   lengths, 64 greedy tokens, concurrency 8) through the handle, tracing
   off and on in turns: tok/s and the engine's TTFT p50 of each; at 1.0
   every request one trace serve.request -> serve.attempt ->
   handle_request -> engine.queue/prefill/decode, parent by parent; at
   0.0 no request span in the main buffer but the one request ended by
   its P25_DEADLINE_S deadline, kept by the tail; (c) with four cards,
   phase 13b's step (P25C_LAYERS of its layers, flat and ZeRO-1) on four
   ranks, each rank
   capturing on a side thread over the same steps, merged into one
   gzipped chrome trace per mode under chiprun_out/p25c: per rank the
   GEMM, attention (K2/K3), elementwise and NCCL ms, the idle share and
   the top host frames;
12. a JSON line of the kernels, then the JSON result line.

Exits non-zero when no CUDA device is visible or when run outside a
checkout. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
SEED = 0


_T0 = time.monotonic()  # the script's start: each phase line says how far in


def _phase(name: str) -> None:
    print(f"== {name} (at {time.monotonic() - _T0:.1f} s)", flush=True)


def device_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Device time per call of ``fn`` in ms: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between two CUDA events (so the
    host's launch cost is not in the number). Inputs stay hot in L2, as
    they are when the engine's previous op just wrote them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * iters)


def host_us(fn, calls: int = 2000) -> float:
    """Host time per call of ``fn`` in us: ``calls`` calls issued without a
    sync between them (the eager dispatch cost the engine's Python loop
    pays); the device runs behind and is drained only after the clock
    stops."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def rms_bound_ms(rows: int, d: int, x_bytes: int, w_bytes: int):
    """Least time for one rms_norm: x read once, y written once, w read
    once, over HBM bandwidth; vs ~4 f32 flops per element over the f32
    peak. Returns (ms, "bytes" | "operations")."""
    t_bytes = (2 * rows * d * x_bytes + d * w_bytes) / HBM_BYTES_PER_S
    t_ops = 4 * rows * d / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device():
    import torch

    _phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} count {torch.cuda.device_count()}")
    # The engine's f32 lm head and the tests' tolerances assume full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind, smi[0]


def phase_build():
    from ray_tpu_torch._native import build

    _phase("build")
    t0 = time.perf_counter()
    paths = build.build_all()
    dt = time.perf_counter() - t0
    print(f"built {len(paths)} kernel librar{'y' if len(paths) == 1 else 'ies'}"
          f" in {dt:.2f} s with {build.nvcc_path()}: "
          + ", ".join(os.path.relpath(p) for p in paths))
    # Libraries whose every instantiation must not spill.
    no_spill = ("flash_fwd", "flash_bwd", "flash_packed_fwd",
                "flash_chunk_fwd", "flash_chunk_bwd", "chunk_tile_bounds",
                "flash_bwd_dq", "flash_bwd_dkv")
    spilled = []
    for name, log in build.BUILD_LOGS.items():
        entry = ""
        for line in log.splitlines():
            if "entry function" in line:
                entry = _ptxas_entry(line)
                entry += " " if entry else ""
            spill = "spill" in line and " 0 bytes spill" not in line
            if "Used" in line or spill or "error" in line.lower():
                print(f"  [{name}] {entry}{line.strip()}")
            if spill and name in no_spill:
                spilled.append(f"{name}: {entry}")
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")
    from ray_tpu_torch.devbench.prof_flash_pack import MAX_ROWS, smem_bytes
    from ray_tpu_torch.ops.attention import kernel_smem_bytes
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_chunk_fwd", "flash_chunk_bwd"):
        print(f"  [{name}] dynamic shared memory per CTA: "
              + ", ".join(f"D={d}: {kernel_smem_bytes(name, d)} B"
                          for d in (64, 128)))
    print("  [flash_packed_fwd] dynamic shared memory per CTA at its most "
          "rows (256 at D 64, 128 at D 128): "
          + ", ".join(f"D={d} block_k={bk}: {smem_bytes(d, bk, MAX_ROWS[d])}"
                      " B" for d in (64, 128) for bk in (64, 128)))


def _ptxas_entry(line: str) -> str:
    """The kernel a ptxas "entry function" line names, with its integer and
    bool template arguments (flash_fwd_kernel<64,2>); "" if it has none."""
    m = re.search(r"([A-Za-z_]+_kernel)I((?:L[ib]\d+E)+)E", line)
    return (f"{m.group(1)}<" + ",".join(re.findall(r"\d+", m.group(2)))
            + ">") if m else ""


def build_registers(name: str) -> dict:
    """{kernel<template arguments>: registers} from ptxas's report of this
    process's build of library ``name`` (empty when it was cached)."""
    from ray_tpu_torch._native import build

    regs, entry = {}, ""
    for line in build.BUILD_LOGS.get(name, "").splitlines():
        if "entry function" in line:
            entry = _ptxas_entry(line)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    return regs


def phase_kernel():
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import norms

    _phase("kernel vs plain: rms_norm")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tol = {torch.bfloat16: (8e-3, 1e-2), torch.float32: (1e-5, 1e-5)}
    worst = {}
    cases = [(r, d, dt, dt) for dt in (torch.bfloat16, torch.float32)
             for r in (1, 8, 33, 512, 4099) for d in (64, 2048, 4096)]
    cases.append((33, 2048, torch.bfloat16, torch.float32))  # mixed dtypes
    for rows, d, dt, wdt in cases:
        x = (torch.randn((rows, d), generator=gen, device="cuda") * 3 + 0.5
             ).to(dt)
        w = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
             ).to(wdt)
        y = norms.rms_norm(x, w, 1e-5)
        ref = norms.rms_norm_reference(x, w, 1e-5)
        torch.cuda.synchronize()
        rtol, atol = tol[dt]
        err = (y.float() - ref.float()).abs()
        bad = err > atol + rtol * ref.float().abs()
        if bad.any():
            raise AssertionError(
                f"rms_norm kernel disagrees at rows={rows} d={d} {dt}/{wdt}:"
                f" max abs err {err.max().item():.3e} "
                f"({int(bad.sum())} elements past rtol={rtol} atol={atol})")
        worst[dt] = max(worst.get(dt, 0.0), err.max().item())
    for dt, e in worst.items():
        print(f"rms_norm kernel == plain over {len(cases)} cases; max abs "
              f"err {dt}: {e:.3e} (tolerance rtol={tol[dt][0]} "
              f"atol={tol[dt][1]})")
    try:
        norms.rms_norm(torch.zeros((4, 60), device="cuda"),
                       torch.ones((60,), device="cuda"))
    except ValueError:
        print("rms_norm rejects d=60 (not a multiple of 8): ok")
    else:
        raise AssertionError("rms_norm accepted d=60")

    times = []
    for rows in (8, 512, 8192):  # decode step, prefill chunk, train batch
        d = 2048
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = torch.ones((d,), device="cuda", dtype=torch.bfloat16)
        ms = device_ms(lambda: norms.rms_norm(x, w, 1e-5))
        plain_ms = device_ms(lambda: norms.rms_norm_reference(x, w, 1e-5))
        lib = getattr(F, "rms_norm", None)
        lib_ms = (device_ms(lambda: lib(x, (d,), w, 1e-5))
                  if lib is not None else None)
        bound, by = rms_bound_ms(rows, d, 2, 2)
        host = host_us(lambda: norms.rms_norm(x, w, 1e-5))
        plain_host = host_us(lambda: norms.rms_norm_reference(x, w, 1e-5))
        lib_host = (host_us(lambda: lib(x, (d,), w, 1e-5))
                    if lib is not None else None)
        times.append({"rows": rows, "d": d, "dtype": "bfloat16", "ms": ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by, "host_us": host,
                      "plain_host_us": plain_host,
                      "library_host_us": lib_host})
        print(f"rms_norm rows={rows} d={d} bf16: device: kernel "
              f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, F.rms_norm "
              f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}, "
              f"bound {bound * 1e3:.4f} us ({by}); host per eager call: "
              f"kernel wrapper {host:.2f} us, plain {plain_host:.2f} us, "
              f"F.rms_norm "
              f"{'n/a' if lib_host is None else f'{lib_host:.2f} us'}")
    return max(worst.values()), times


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def run_wave(eng, prompts, sampling, concurrency: int = 8):
    """Closed loop: ``concurrency`` clients each submit the next prompt as
    soon as their last one finished. Returns ([(index, request)], wall s,
    [TTFT s], output tokens). Raises if a request fails."""
    done = []
    lock = threading.Lock()
    queue_ = list(enumerate(prompts))

    def client():
        while True:
            with lock:
                if not queue_:
                    return
                i, p = queue_.pop(0)
            req = eng.submit(p, sampling)
            if not req.done.wait(600):
                raise TimeoutError("request timed out")
            with lock:
                done.append((i, req))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wave_s = time.perf_counter() - t0
    if len(done) != len(prompts) or any(t.is_alive() for t in threads):
        raise AssertionError(f"{len(done)}/{len(prompts)} requests done")
    for i, req in done:
        if req.error or req.finish_reason not in ("length", "stop"):
            raise AssertionError(f"request {i} ended {req.finish_reason}"
                                 f" ({req.error})")
    ttft = [req.first_token_ts - req.submit_ts for _, req in done]
    out_toks = sum(len(req.out_tokens) for _, req in done)
    return done, wave_s, ttft, out_toks


def _spread(vals):
    return (f"median {statistics.median(vals):.1f} "
            f"[min {min(vals):.1f}, max {max(vals):.1f}]")


WAVES = 3  # timed waves after the warm-up wave


def phase_engine(rms_host_us: float):
    import numpy as np
    import torch
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.engine import decode_burst, init_kv_cache
    from ray_tpu_torch.ops import norms

    _phase("engine: llama3_1b width, bf16, seeded random weights")
    cfg = LLMConfig(model="llama3_1b", dtype="bfloat16", max_num_seqs=8,
                    max_seq_len=1024, decode_burst=16, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = LLMEngine(cfg, device="cuda")
    torch.cuda.synchronize()
    mc = eng.model_cfg
    print(f"engine up in {time.perf_counter() - t0:.2f} s: "
          f"{mc.num_params() / 1e9:.3f}B params, hidden {mc.hidden_size}, "
          f"{mc.num_layers} layers, heads {mc.num_heads}/{mc.num_kv_heads}"
          f", vocab {mc.vocab_size}")
    rng = np.random.default_rng(SEED)
    greedy64 = SamplingParams(max_tokens=64, temperature=0.0)
    short, wave = _wave_prompts(rng)  # short: < PREFIX_COPY_MIN tokens
    long_prompt = [int(t) for t in rng.integers(0, 256, 700)]
    prefix = [int(t) for t in rng.integers(0, 256, 128)]
    shared = [prefix + [int(t) for t in rng.integers(0, 256, 20)]
              for _ in range(3)]
    results = {}
    try:
        norms.rms_norm.launches = 0  # count the main path only
        wall0 = time.perf_counter()

        solo = eng.generate(short, greedy64)

        # Warm-up wave: also the solo/repeat/concurrent determinism check.
        done, wave_s, _, out_toks = run_wave(eng, wave, greedy64)
        concurrent_short = next(r for i, r in done if i == len(wave) - 1)
        again = eng.generate(short, greedy64)
        if not (solo.token_ids == again.token_ids
                == eng._result(concurrent_short).token_ids):
            raise AssertionError("short prompt: solo, repeated and "
                                 "concurrent tokens differ")
        print(f"warm-up wave: {out_toks / wave_s:.1f} tok/s; repeated "
              f"prompt and solo-vs-concurrent tokens identical: ok")
        # Timed waves: the same prompt lengths with fresh tokens each time,
        # so no wave re-hits the prefix cache of an earlier one.
        rates, p50s, maxs = [], [], []
        for _ in range(WAVES):
            prompts = [[int(t) for t in rng.integers(0, 256, len(p))]
                       for p in wave]
            _, wave_s, ttft, out_toks = run_wave(eng, prompts, greedy64)
            rates.append(out_toks / wave_s)
            p50s.append(statistics.median(ttft) * 1e3)
            maxs.append(max(ttft) * 1e3)
            print(f"  wave: {out_toks} output tokens in {wave_s:.3f} s = "
                  f"{rates[-1]:.1f} tok/s; TTFT p50 {p50s[-1]:.1f} ms, max "
                  f"{maxs[-1]:.1f} ms")
        print(f"{WAVES} waves of {len(wave)} requests at concurrency 8 "
              f"(prompts 12-200 tokens, max_tokens 64): tok/s "
              f"{_spread(rates)}; TTFT p50 ms {_spread(p50s)}; TTFT max ms "
              f"{_spread(maxs)}")

        chunks0 = eng.stats()["prefill_chunks"]
        res = eng.generate(long_prompt, greedy64)
        chunks = eng.stats()["prefill_chunks"] - chunks0
        if chunks != 2 or res.finish_reason not in ("length", "stop"):
            raise AssertionError(f"700-token prompt: {chunks} chunks, "
                                 f"{res.finish_reason}")
        print(f"700-token prompt: {chunks} prefill chunks, "
              f"{len(res.token_ids)} tokens, {res.finish_reason}")

        hits0 = eng.stats()["prefix_hits"]
        donor = eng.submit(shared[0], greedy64)
        deadline = time.time() + 120
        while not eng._prefix_live and time.time() < deadline:
            time.sleep(0.002)  # the donor's prefill completes
        second = eng.generate(shared[1], greedy64)
        if not donor.done.wait(300):
            raise TimeoutError("prefix donor timed out")
        third = eng.generate(shared[2], greedy64)
        st = eng.stats()
        for r in (donor, second, third):
            fr = r.finish_reason
            if fr not in ("length", "stop"):
                raise AssertionError(f"shared-prefix request ended {fr}")
        if st["prefix_hits"] - hits0 < 2:
            raise AssertionError(f"prefix hits {st['prefix_hits'] - hits0}"
                                 " < 2 for three 128-token-prefix prompts")
        wall = time.perf_counter() - wall0
        launches = norms.rms_norm.launches
        print(f"prefix cache: {st['prefix_hits'] - hits0} hits, "
              f"{st['prefix_tokens_saved']} prompt tokens reused")
        if st["decode_bursts"] < 1 or st["chained_bursts"] < 1:
            raise AssertionError(f"bursts {st['decode_bursts']}, chained "
                                 f"{st['chained_bursts']}")
        if launches < 1:
            raise AssertionError("rms_norm kernel never launched on the "
                                 "main path")
        print(f"main path wall {wall:.3f} s; stats {json.dumps(st)}; "
              f"rms_norm kernel launches {launches} "
              f"(= {launches / 33:.1f} forwards x 33)")
        gib = 2.0 ** 30
        peak = torch.cuda.max_memory_allocated() / gib
        weights = sum(t.numel() * t.element_size() for t in
                      _leaves(eng.params)) / gib
        kv = sum(t.numel() * t.element_size()
                 for t in eng.cache.values()) / gib
        head = eng._weights.head_f32.numel() * 4 / gib
        print(f"peak device memory {peak:.3f} GiB: weights {weights:.3f}, "
              f"f32 head copy {head:.3f}, KV cache {kv:.3f}, the rest "
              f"activations and allocator slack")
        results.update(launches=launches, wall_s=wall, peak_gib=peak,
                       waves=WAVES, tok_per_s=statistics.median(rates),
                       tok_per_s_min=min(rates), tok_per_s_max=max(rates),
                       ttft_p50_ms=statistics.median(p50s),
                       ttft_p50_ms_min=min(p50s), ttft_p50_ms_max=max(p50s))

        _phase("burst split: one 16-step decode burst, 8 slots at 600")
        cache = init_kv_cache(mc, 8, 1024, "cuda")
        tokens = np.arange(8, dtype=np.int64)
        pos = np.full(8, 600, np.int64)
        write = np.ones(8, bool)
        temps, top_ps = np.zeros(8, np.float32), np.ones(8, np.float32)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)

        def burst():
            return decode_burst(mc, eng._weights, cache, tokens, pos, write,
                                temps, top_ps, gen, 16, False)[1]

        burst()
        torch.cuda.synchronize()
        host, walls = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            burst()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host.append((t1 - t0) * 1e3)
            walls.append((time.perf_counter() - t0) * 1e3)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            burst()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        by_name: dict[str, float] = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        wall_ms = min(walls)
        rms_ms = 16 * 33 * rms_host_us / 1e3
        print(f"burst of 16 steps: host enqueue {min(host):.2f} ms, wall "
              f"{wall_ms:.2f} ms, launches/step "
              f"{len(kern) / 16:.0f} (profiler); rms_norm wrapper host time "
              f"528 x {rms_host_us:.2f} us = {rms_ms:.2f} ms "
              f"({100 * rms_ms / min(host):.1f}% of the host enqueue)")
        if busy_ms > 0:
            print(f"device busy {busy_ms:.2f} ms = "
                  f"{100 * busy_ms / wall_ms:.1f}% of wall (idle "
                  f"{100 - 100 * busy_ms / wall_ms:.1f}%)")
            for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                print(f"  {ms:8.3f} ms  {name[:100]}")
        else:
            print("device busy: not measured (profiler saw no kernels)")
        results.update(burst_host_ms=min(host), burst_wall_ms=wall_ms,
                       burst_busy_ms=busy_ms or None,
                       burst_rms_norm_host_ms=rms_ms)
    finally:
        eng.shutdown()
    return results


def phase_cross_device():
    from dataclasses import replace

    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig, init_params

    _phase("cross-device: f32, CUDA kernel path vs CPU plain path")
    # tiny (d=64) runs the warp-per-row kernel; the 1B width (d=2048, two
    # layers, small vocab) runs the CTA-per-row kernel the main path uses.
    wide = replace(LlamaConfig.llama3_1b(), num_layers=2, vocab_size=512,
                   max_seq_len=128, dtype="float32")
    prompts = ["hello from the port", "x",
               "a prompt long enough to run over two prefill chunks of 32",
               "hello from the port"]  # the repeat re-hits the prefix cache
    for name, model in (("tiny", "tiny"), ("1b-width 2-layer", wide)):
        cfg = LLMConfig(model=model, max_num_seqs=4, max_seq_len=128,
                        decode_burst=8, prefill_chunk=32, seed=SEED)
        params = init_params(cfg.model_config(), generator=7, device="cpu")
        streams = {}
        for dev in ("cuda", "cpu"):
            eng = LLMEngine(cfg, params=params, device=dev)
            try:
                streams[dev] = [eng.generate(p, SamplingParams(max_tokens=24))
                                .token_ids for p in prompts]
            finally:
                eng.shutdown()
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"{name}: greedy streams differ: {streams}")
        print(f"{name} (d={cfg.model_config().hidden_size}): {len(prompts)}"
              f" greedy streams identical on cuda and cpu "
              f"({sum(map(len, streams['cuda']))} tokens)")


def events_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn`` in ms from CUDA events around an
    eager loop of ``iters`` calls (for calls of a hundred microseconds and
    more, whose host cost hides behind the device's)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# Tolerances of the flash kernels against their plain twins (bf16): out,
# dq, dk, dv within 1e-2 of the largest value (one bf16 ulp where sums in
# another order round apart; dq's atomics add in no fixed order); lse
# within 2e-3 (f32 sums of the same bf16 p in another order).
FLASH_REL_TOL = 1e-2
# A recorded figure, not a reading of this run (so it stays out of the
# kernels line): K3's and K7's times with dq summed by f32 atomics (the
# parent, e3857e2, whose dq did not repeat bit for bit), each the mean of
# its two turns in the paired call against the ordered dq on one NVIDIA
# H100 80GB HBM3, 700.00 W: devbench/pair_flash.py at the training shape
# (B4 H32 Hkv8 S2048 D64, causal), devbench/pair_chunk.py at the CP step's
# (B1 H32 Hkv8 S16384 D64); PERF.md's kernel table. Printed, so named,
# beside this run's own times.
RECORDED_ATOMIC_PARENT_MS = {"flash_bwd": 0.9308, "flash_chunk_bwd": 16.2861}
FLASH_LSE_TOL = 2e-3
# lse of rows that see few keys (causal S 64 over B 65536, 4M rows): one p
# in [0.5, 1) that rounds to the other side of a bf16 step in the kernel
# than in the twin (s summed in another order) moves l >= 1 by 2^-8, so
# lse by up to 2^-8 (2.1e-3 read there on an H100). Only the big-batch
# causal checks take it.
FEW_KEYS_LSE_TOL = 2 ** -8
MAIN_ATTN = dict(b=4, h=32, hkv=8, s=2048, d=64)  # the trainer's shape
BIG_BATCH = dict(b=65536, h=1, hkv=1, s=64, d=64)  # past a grid's y/z limit


# The kernels line's note of K2's and K3's designs.
FLASH_DESIGN = {
    "flash_fwd": "Hopper design: 128 q rows a CTA (two consumer "
                 "warpgroups + a producer warp), TMA ring of K/V tiles, "
                 "wgmma for both products, static tile classes, linear grid",
    "flash_bwd": "Hopper design: 128 kv rows a CTA (two consumer "
                 "warpgroups), TMA ring of q/dO/O tiles, wgmma for all five "
                 "products (dq from ds^T in shared memory), delta made in "
                 "the kernel, dq summed across CTAs by float4 reductions, "
                 "dk/dv over the GQA heads in registers, linear grid"}


def _flash_inputs(gen, b, h, hkv, s, d):
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)


def _flash_check(q, k, v, do, causal, label, worst, lse_tol=FLASH_LSE_TOL):
    """Both kernels against their twins on one input; raises past the
    tolerance, folds the max abs errors into ``worst``."""
    import torch
    from ray_tpu_torch.ops import attention as att

    scale = q.shape[-1] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
    p_out, p_lse = att.flash_fwd_plain(q, k, v, causal, scale)
    grads = att.flash_bwd_cuda(q, k, v, p_out, p_lse, do, causal, scale)
    plain = att.flash_bwd_plain(q, k, v, p_out, p_lse, do, causal, scale)
    torch.cuda.synchronize()
    errs = {}
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (p_out, *plain)):
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"flash {name} disagrees with its twin at "
                                 f"{label}: max abs err {err:.3e} = {rel:.3e}"
                                 f" of the largest value (> {FLASH_REL_TOL})")
        errs[name] = err
    errs["lse"] = (lse - p_lse).abs().max().item()
    if not errs["lse"] < lse_tol:
        raise AssertionError(f"flash lse disagrees at {label}: "
                             f"{errs['lse']:.3e} > {lse_tol}")
    worst["flash_fwd"] = max(worst["flash_fwd"], errs["out"], errs["lse"])
    worst["flash_bwd"] = max(worst["flash_bwd"], errs["dq"], errs["dk"],
                             errs["dv"])
    return errs


def flash_bounds(b, h, hkv, s, d, causal: bool = True):
    """(fwd, bwd) least times in ms with what bounds each: the FLOPs (half
    of them when causal) over the bf16 peak vs bytes (each input read once,
    each output written once) over HBM bandwidth. The backward does five
    products per tile pair to the forward's two."""
    from ray_tpu_torch.accelerators.flops import attention_flops, peak_flops

    fl = attention_flops(b, h, s, d, causal=causal)
    qb, kvb, rows = b * h * s * d * 2, b * hkv * s * d * 2, b * h * s * 4
    out = {}
    for name, flops, nbytes in (
            ("flash_fwd", fl, 2 * qb + 2 * kvb + rows),
            # q, k, v, out, dO, lse in; dq, dk, dv out
            ("flash_bwd", 2.5 * fl, 4 * qb + 4 * kvb + rows)):
        t_ops = flops / peak_flops("h100", "bf16")
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


def phase_flash():
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: flash_fwd / flash_bwd")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    n = 0
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                for s in (2048, 1000):  # 1000: a ragged tail of 40 rows
                    q, k, v, do = _flash_inputs(gen, 1, 8, 8 // rep, s, d)
                    _flash_check(q, k, v, do, causal,
                                 f"causal={causal} rep={rep} d={d} s={s}",
                                 worst)
                    n += 1
    m = MAIN_ATTN
    q, k, v, do = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"],
                                m["d"])
    errs = _flash_check(q, k, v, do, True, "the training shape", worst)
    print(f"flash kernels == plain twins over {n} cases + the training "
          f"shape (bf16); max abs err: flash_fwd {worst['flash_fwd']:.3e}, "
          f"flash_bwd {worst['flash_bwd']:.3e}; at the training shape "
          + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL})")

    # K3 twice on the same inputs, at the training shape and at phase
    # 13's (D 128): dk/dv are summed in one CTA's registers, dq across CTAs
    # in ascending kv-tile order, so all three are the same bits.
    scale = m["d"] ** -0.5
    for label, (qr, kr_, vr_, dor) in (
            ("the training shape", (q, k, v, do)),
            ("phase 13's B4 H32 Hkv8 S2048 D128",
             _flash_inputs(gen, 4, 32, 8, 2048, 128))):
        sc = qr.shape[-1] ** -0.5
        o_, l_ = att.flash_fwd_cuda(qr, kr_, vr_, True, sc)
        runs = [att.flash_bwd_cuda(qr, kr_, vr_, o_, l_, dor, True, sc)
                for _ in range(2)]
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), *runs):
            if not torch.equal(x, y):
                raise AssertionError(f"K3: {name} of two launches on the "
                                     f"same inputs differs at {label}")
        del runs, o_, l_
    out, lse = att.flash_fwd_cuda(q, k, v, True, scale)
    regs = {n: build_registers(n) for n in ("flash_fwd", "flash_bwd")}
    print(f"K3 at the training shape and at D 128, two launches each: dq, "
          f"dk, dv bit-identical; registers a thread (ptxas): "
          + "; ".join(f"{n} " + ", ".join(f"{e} {r}" for e, r in x.items())
                      for n, x in regs.items()))

    # More batch rows than a grid's y or z dimension holds: K2, K3, K6 and
    # K7 on linear grids, each against its twin.
    big = BIG_BATCH
    chunk_worst = dict.fromkeys(("flash_chunk_fwd", "flash_chunk_bwd",
                                 "flash_chunk_fwd rel",
                                 "flash_chunk_bwd rel"), 0.0)
    big_errs = {}
    for causal in (True, False):
        lse_tol = FEW_KEYS_LSE_TOL if causal else FLASH_LSE_TOL
        label = f"B{big['b']} H1 S{big['s']} D64 causal={causal}"
        qb, kb, vb, dob = _flash_inputs(gen, big["b"], big["h"], big["hkv"],
                                        big["s"], big["d"])
        big_errs[f"K2/K3 causal={causal}"] = _flash_check(
            qb, kb, vb, dob, causal, label, worst, lse_tol)
        pos = torch.arange(big["s"], dtype=torch.int32, device="cuda")
        big_errs[f"K6/K7 causal={causal}"] = _chunk_check(
            (qb, kb, vb, pos, pos, dob.float(),
             torch.randn(qb.shape[:3], generator=gen, device="cuda")),
            causal, label, chunk_worst, lse_tol=lse_tol)
        del qb, kb, vb, dob
    print(f"B {big['b']} (H1 S{big['s']} D64): K2, K3, K6, K7 == their twins"
          f" on linear grids, causal and not; max abs err "
          + "; ".join(f"{n}: " + ", ".join(f"{k_} {e:.3e}"
                                            for k_, e in x.items())
                      for n, x in big_errs.items())
          + f" (lse {FEW_KEYS_LSE_TOL:.3e} causal, {FLASH_LSE_TOL} not)")

    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(o, (qg, kg, vg), do)

    # SDPA's backward alone: one forward, then its saved graph replayed.
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd_ms = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), 20)
    del o_lib

    times = {
        "flash_fwd": (
            events_ms(lambda: att.flash_fwd_cuda(q, k, v, True, scale), 20),
            events_ms(lambda: att.flash_fwd_plain(q, k, v, True, scale), 3),
            events_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=True), 20)),
        "flash_bwd": (
            events_ms(lambda: att.flash_bwd_cuda(q, k, v, out, lse, do, True,
                                                 scale), 20),
            events_ms(lambda: att.flash_bwd_plain(q, k, v, out, lse, do,
                                                  True, scale), 3),
            events_ms(sdpa_fwd_bwd, 20)),
    }
    bounds = flash_bounds(**m)
    rows = {}
    for name, (ms, plain_ms, lib_ms) in times.items():
        bound, by, flops, nbytes = bounds[name]
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by,
                      "max_abs_err": worst[name],
                      "tflops": flops / (ms * 1e-3) / 1e12}
        rows[name]["registers"] = regs[name]
        if name == "flash_bwd":
            rows[name]["library_bwd_ms"] = lib_bwd_ms
            rows[name]["dq_dk_dv_bit_identical"] = True
        print(f"{name} B4 H32 Hkv8 S2048 D64 causal bf16: kernel {ms:.4f} ms"
              f" ({flops / 1e9:.1f} GFLOP, {rows[name]['tflops']:.1f} "
              f"TFLOP/s = {100 * bound / ms:.1f}% of the bound), plain twin "
              f"{plain_ms:.4f} ms, scaled_dot_product_attention"
              f"{' fwd+bwd' if name == 'flash_bwd' else ''} {lib_ms:.4f} ms"
              f" (k/v repeated to 32 heads beforehand), bound "
              f"{bound:.4f} ms ({by}; {nbytes / 1e6:.1f} MB)"
              + (f"; recorded, not measured here: the atomic-dq parent "
                 f"(e3857e2) {RECORDED_ATOMIC_PARENT_MS[name]:.4f} ms in "
                 f"devbench/pair_flash.py's paired call (PERF.md)"
                 if name in RECORDED_ATOMIC_PARENT_MS else ""))
    print(f"flash_bwd against scaled_dot_product_attention's backward alone "
          f"{lib_bwd_ms:.4f} ms: {times['flash_bwd'][0] / lib_bwd_ms:.2f}x "
          f"its time; flash_fwd against its forward: "
          f"{times['flash_fwd'][0] / times['flash_fwd'][2]:.2f}x")
    return rows


def split_bounds(b, h, hkv, sq, skv, d, causal: bool):
    """(K4, K5) least times in ms with what bounds each: the FLOPs of the
    (q, k) pairs the mask keeps (K4 three products, 6 * D FLOPs a pair; K5
    four, 8 * D) over the bf16 peak vs bytes (each input read once, each
    output written once: K5's dk/dv per kv head, folded) over HBM
    bandwidth."""
    from ray_tpu_torch.accelerators.flops import peak_flops

    pairs = b * h * (sq * (sq + 1) // 2 if causal and sq == skv
                     else sq * skv)
    qb, kvb, rows = b * h * sq * d * 2, b * hkv * skv * d * 2, b * h * sq * 4
    out = {}
    for name, flops, nbytes in (
            # q, k, v, dO, lse, delta in; dq out
            ("flash_bwd_dq", 6.0 * d * pairs, 3 * qb + 2 * kvb + 2 * rows),
            # q, k, v, dO, lse, delta in; dk, dv per kv head out
            ("flash_bwd_dkv", 8.0 * d * pairs, 2 * qb + 4 * kvb + 2 * rows)):
        t_ops = flops / peak_flops("h100", "bf16")
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes)
    return out


def _split_check(q, k, v, do, causal, label, worst):
    """K4 and K5 (dk/dv folded inside it) against flash_bwd_split_plain
    (fold_heads of K5's per-head twin) on the twin's residuals; raises past
    the tolerance, folds the max abs and relative errors into ``worst``."""
    import torch
    from ray_tpu_torch.ops import attention as att

    scale = q.shape[-1] ** -0.5
    out, lse = att.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1)
    dq = att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    plain = att.flash_bwd_split_plain(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    # At S 1 a row's softmax has one key: p = 1 and dp = delta, so dq and dk
    # vanish in exact arithmetic and hold rounding noise alone; there each
    # output is held to the tolerance of the twin's largest gradient.
    floor = (max(w.float().abs().max().item() for w in plain)
             if q.shape[2] == 1 else 0.0)
    errs = {}
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), plain):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"split {name} not finite at {label}")
        err = (got.float() - want.float()).abs().max().item()
        rel = err / max(want.float().abs().max().item(), floor)
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"split {name} disagrees with its twin at "
                                 f"{label}: max abs err {err:.3e} = {rel:.3e}"
                                 f" of the largest value (> {FLASH_REL_TOL})")
        errs[name] = (err, rel)
    for kname, keys in (("flash_bwd_dq", ("dq",)),
                        ("flash_bwd_dkv", ("dk", "dv"))):
        worst[kname] = max([worst[kname]] + [errs[n][0] for n in keys])
        worst[kname + " rel"] = max([worst[kname + " rel"]]
                                    + [errs[n][1] for n in keys])
    return {n: e for n, (e, _) in errs.items()}


def phase_split():
    import torch
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: flash_bwd_dq / flash_bwd_dkv (split backward)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "flash_bwd_dq rel": 0.0, "flash_bwd_dkv rel": 0.0}
    n = 0
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                # 197: ViT-B/16's tokens; 1000: a ragged tail of 40 rows
                for s in (2048, 197, 1000):
                    q, k, v, do = _flash_inputs(gen, 1, 8, 8 // rep, s, d)
                    _split_check(q, k, v, do, causal,
                                 f"causal={causal} rep={rep} d={d} s={s}",
                                 worst)
                    n += 1
    # rep 2 and 8 (H8 Hkv1); the kernels' 128-row tile edges and S 1; more
    # (batch, head) pairs than a grid's y dimension holds.
    extra = [(1, 8, 8 // rep, 256, d, causal) for causal in (True, False)
             for rep in (2, 8) for d in (64, 128)]
    extra += [(1, 8, 2, s, d, causal) for causal in (True, False)
              for d in (64, 128) for s in (1, 127, 128, 129, 257)]
    extra.append((5462, 12, 12, 8, 64, False))
    for b, h, hkv, s, d, causal in extra:
        q, k, v, do = _flash_inputs(gen, b, h, hkv, s, d)
        _split_check(q, k, v, do, causal, f"causal={causal} b={b} h={h} "
                     f"hkv={hkv} d={d} s={s}", worst)
        n += 1
    # Two launches on the same inputs, the same bits: both head dims.
    for d in (64, 128):
        for causal in (True, False):
            q, k, v, do = _flash_inputs(gen, 2, 8, 2, 1000, d)
            scale = d ** -0.5
            out, lse = att.flash_fwd_cuda(q, k, v, causal, scale)
            runs = [att.flash_bwd_split_cuda(q, k, v, out, lse, do, causal,
                                             scale) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError(f"K4/K5 at d={d} causal={causal}: two "
                                     f"launches on the same inputs differ")
    m = MAIN_ATTN
    q, k, v, do = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"],
                                m["d"])
    errs = _split_check(q, k, v, do, True, "the training shape", worst)
    print(f"split kernels (K5 folds inside) == flash_bwd_split_plain over "
          f"{n} cases + the training shape (bf16); bit-identical on repeat "
          f"at d 64 and 128, causal and not; max abs err: flash_bwd_dq "
          f"{worst['flash_bwd_dq']:.3e}, flash_bwd_dkv "
          f"{worst['flash_bwd_dkv']:.3e} (= {worst['flash_bwd_dq rel']:.3e}"
          f" and {worst['flash_bwd_dkv rel']:.3e} of the case's largest "
          f"value); at the training shape "
          + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value)")

    scale = m["d"] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1)
    runs = [(att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, True, scale),
             *att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True, scale))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("K4/K5: two launches on the same inputs differ")
    k3 = [att.flash_bwd_cuda(q, k, v, out, lse, do, True, scale)
          for _ in range(2)]
    k3_same = [torch.equal(a, b) for a, b in zip(*k3)]
    del runs, k3
    print(f"two launches on the same inputs: K4 dq and K5 dk/dv bit-"
          f"identical; K3 dq/dk/dv identical {k3_same} (dq summed across "
          f"CTAs in no fixed order)")

    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))
    o_lib = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True)
    lib_bwd_ms = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), 20)
    del o_lib, qg, kg, vg
    ms = {
        "flash_bwd": events_ms(lambda: att.flash_bwd_cuda(
            q, k, v, out, lse, do, True, scale), 20),
        "flash_bwd_dq": events_ms(lambda: att.flash_bwd_dq_cuda(
            q, k, v, do, lse, delta, True, scale), 20),
        "flash_bwd_dkv": events_ms(lambda: att.flash_bwd_dkv_cuda(
            q, k, v, do, lse, delta, True, scale), 20),
        "split": events_ms(lambda: att.flash_bwd_split_cuda(
            q, k, v, out, lse, do, True, scale), 20),
        "flash_bwd_dq plain": events_ms(lambda: att.flash_bwd_dq_plain(
            q, k, v, do, lse, delta, True, scale), 2),
        "flash_bwd_dkv plain": events_ms(lambda: att._dkv_folded_plain(
            q, k, v, do, lse, delta, True, scale), 2),
    }
    bounds = split_bounds(m["b"], m["h"], m["hkv"], m["s"], m["s"], m["d"],
                          True)
    rows = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        bound, by, flops, nbytes = bounds[name]
        rows[name] = {
            "ms": ms[name], "plain_ms": ms[name + " plain"],
            "library_ms": lib_bwd_ms, "bound_ms": bound, "bound_by": by,
            "max_abs_err": worst[name], "max_rel_err": worst[name + " rel"],
            "tflops": flops / (ms[name] * 1e-3) / 1e12,
            "split_total_ms": ms["split"],
            "k3_ms": ms["flash_bwd"], "bit_identical": True}
        print(f"{name} B4 H32 Hkv8 S2048 D64 causal bf16: kernel "
              f"{ms[name]:.4f} ms ({flops / 1e9:.1f} GFLOP the mask keeps, "
              f"{rows[name]['tflops']:.1f} TFLOP/s = "
              f"{100 * bound / ms[name]:.1f}% of the bound), plain twin "
              f"{ms[name + ' plain']:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB)")
    kernels = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
    k3_ms = ms["flash_bwd"]
    print(f"split backward: K4 {ms['flash_bwd_dq']:.4f} + K5 (the fold "
          f"inside) {ms['flash_bwd_dkv']:.4f} = "
          f"{kernels:.4f} ms with delta given; whole backwards, each "
          f"through its wrapper with delta, buffers and casts: split "
          f"{ms['split']:.4f} ms against K3 {k3_ms:.4f} ms in this call "
          f"({ms['split'] / k3_ms:.2f}x) and scaled_dot_product_attention's "
          f"backward alone {lib_bwd_ms:.4f} ms "
          f"({ms['split'] / lib_bwd_ms:.2f}x; k/v repeated to 32 heads "
          f"beforehand)")
    return rows


# The head-packed forward kernels (ray_tpu_torch/devbench/prof_flash_pack.py):
# kernel name on the kernels line -> (schedule, the TPU kernel's line).
PACKED = {"packed_fwd_epi": ("epi", 59), "packed_fwd_inl": ("inl", 123),
          "packed_fwd": ("masked", 262)}
# schedule -> its template argument in csrc/flash_packed_fwd.cu
PACKED_SCHED = {"masked": 0, "epi": 1, "inl": 2}
PACKED_DESIGN = ("Hopper design (K2's machinery with head packing on top): "
                 "one warpgroup per 64 rows of one packed head, 1-4 a CTA, "
                 "no producer warp (thread 0 issues TMA), K/V tiles of "
                 "block_k rows through a 3-stage (D 64) / 2-stage TMA "
                 "ring read by every warpgroup, wgmma for both products, "
                 "warpgroups stop after the tile holding their last row, "
                 "linear grid with the last q tiles first")
PACKED_CHECK = dict(b=1, h=8, s=512)  # the correctness cases' batch, heads, S


def _packed_tiles(kind, rep, d):
    """(pack, block_q, block_k) that kernel ``kind`` takes at GQA rep and
    head_dim d."""
    from ray_tpu_torch.devbench import prof_flash_pack as pfp

    return [(p, bq, bk) for p in pfp.PACKS if rep % p == 0
            for bq in pfp.BLOCKS for bk in pfp.BLOCKS
            if p * bq <= pfp.MAX_ROWS[d] and (kind != "inl" or bq == bk)]


def _packed_errs(got, want):
    """(max abs err of out, relative to want's largest value, lse err)."""
    (out, lse), (p_out, p_lse) = got, want
    err = (out.float() - p_out.float()).abs().max().item()
    return err, err / p_out.float().abs().max().item(), \
        (lse - p_lse).abs().max().item()


def phase_packed():
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.devbench import prof_flash_pack as pfp
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: packed_fwd / packed_fwd_epi / packed_fwd_inl "
           "(head-packed flash forward, the profiling entry point)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    worst = {name: [0.0, 0.0, 0.0] for name in PACKED}  # abs, rel, lse
    n = 0

    def hold(name, got, want, label, lse_tol=FLASH_LSE_TOL):
        if not torch.isfinite(got[0].float()).all():
            raise AssertionError(f"{name} out not finite at {label}")
        errs = _packed_errs(got, want)
        if not (errs[1] < FLASH_REL_TOL and errs[2] < lse_tol):
            raise AssertionError(
                f"{name} disagrees with its twin at {label}: out max abs err "
                f"{errs[0]:.3e} = {errs[1]:.3e} of the largest value (> "
                f"{FLASH_REL_TOL}) or lse {errs[2]:.3e} (> {lse_tol})")
        worst[name] = [max(a, b) for a, b in zip(worst[name], errs)]
        return errs

    c = PACKED_CHECK
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                q, k, v, _ = _flash_inputs(gen, c["b"], c["h"], c["h"] // rep,
                                           c["s"], d)
                scale = d ** -0.5
                for name, (kind, _) in PACKED.items():
                    fn, twin = pfp.KERNELS[kind]
                    twins = {}
                    for pack, bq, bk in _packed_tiles(kind, rep, d):
                        if (bq, bk) not in twins:  # pack groups rows only
                            twins[bq, bk] = twin(q, k, v, causal, scale, pack,
                                                 bq, bk)
                        hold(name, fn(q, k, v, causal, scale, pack, bq, bk),
                             twins[bq, bk], f"causal={causal} rep={rep} "
                             f"d={d} pack={pack} bq={bq} bk={bk}")
                        n += 1
    m = MAIN_ATTN
    q, k, v, _ = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"], m["d"])
    scale = m["d"] ** -0.5
    main_errs, plain = {}, {}
    for name, (kind, _) in PACKED.items():
        fn, twin = pfp.KERNELS[kind]
        plain[name] = twin(q, k, v, True, scale)
        main_errs[name] = hold(name, fn(q, k, v, True, scale), plain[name],
                               "the profiling shape")
    print(f"packed kernels == plain twins over {n} cases (causal/non-causal, "
          f"rep 1 and 4, D 64/128, every pack x (block_q, block_k) each "
          f"takes, B1 H8 S512) + the profiling shape (B4 H32 Hkv8 S2048 D64 "
          f"causal, the defaults pack 2 block_q 64 block_k 64); max abs err "
          + ", ".join(f"{k_} {w[0]:.3e} (= {w[1]:.3e} of the largest value), "
                      f"lse {w[2]:.3e}" for k_, w in worst.items())
          + f"; at the profiling shape " + ", ".join(
              f"{k_} {e[0]:.3e} / lse {e[2]:.3e}" for k_, e in
              main_errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL})")
    if not all(torch.equal(o, plain["packed_fwd"][0])
               and torch.equal(l, plain["packed_fwd"][1])
               for o, l in plain.values()):
        raise AssertionError("the three twins differ at the profiling shape")
    # More packs of heads than a grid's y dimension holds: B * H / pack =
    # 65536 on a linear grid (causal S 64: rows that see few keys).
    big = BIG_BATCH
    qb, kb, vb, _ = _flash_inputs(gen, big["b"], 2, 1, big["s"], big["d"])
    big_twin = pfp.packed_fwd_plain(qb, kb, vb, True, 0.125, 2, 64, 64)
    big_errs = {name: hold(name, pfp.KERNELS[kind][0](qb, kb, vb, True,
                                                      0.125, 2, 64, 64),
                           big_twin, f"B{big['b']} H2 Hkv1 pack 2 "
                           f"S{big['s']}", FEW_KEYS_LSE_TOL)
                for name, (kind, _) in PACKED.items()}
    del qb, kb, vb, big_twin
    print(f"packed kernels at B * H / pack = {big['b']} (B{big['b']} H2 "
          f"Hkv1 pack 2 S{big['s']} D64 causal) == their twin on a linear "
          f"grid: " + ", ".join(f"{k_} out {e[0]:.3e}, lse {e[2]:.3e}"
                                for k_, e in big_errs.items())
          + f" (lse tolerance {FEW_KEYS_LSE_TOL:.3e})")

    # Against K2 at block_k 64, on the same inputs: the same bits (the
    # same arithmetic on the same wgmma products over the same tiles); and
    # for each block_k the three schedules at every pack give one result.
    k2 = att.flash_fwd_cuda(q, k, v, True, scale)
    same, by_bk = {}, {}
    for name, (kind, _) in PACKED.items():
        fn = pfp.KERNELS[kind][0]
        for pack, bq, bk in _packed_tiles(kind, m["h"] // m["hkv"],
                                          m["d"]):
            got = fn(q, k, v, True, scale, pack, bq, bk)
            torch.cuda.synchronize()
            label = f"{name} pack{pack}_bq{bq}_bk{bk}"
            first = by_bk.setdefault(bk, (label, got))
            if not (torch.equal(got[0], first[1][0])
                    and torch.equal(got[1], first[1][1])):
                raise AssertionError(f"{label}'s out/lse bits differ from "
                                     f"{first[0]}'s at the profiling shape")
            if bk != 64:
                continue
            same[label] = (torch.equal(got[0], k2[0])
                           and torch.equal(got[1], k2[1]))
            if not same[label]:
                raise AssertionError(
                    f"{label} is not bit-identical to K2: out/lse errs "
                    f"{_packed_errs(got, k2)}")
    print(f"at the profiling shape: every packed variant at block_k 64 "
          f"({len(same)}) bit-identical to K2 (flash_fwd_cuda); for each "
          f"block_k the three kernels at every pack and block_q give the "
          f"same bits as " + ", ".join(lab for lab, _ in by_bk.values()))
    del by_bk
    regs = build_registers("flash_packed_fwd")
    print("packed_fwd_kernel<D, block_k, schedule, more than 128 rows> "
          "registers a thread (ptxas): "
          + ", ".join(f"{k_} {v_}" for k_, v_ in regs.items()))

    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    k2_ms = events_ms(lambda: att.flash_fwd_cuda(q, k, v, True, scale), 20)
    lib_ms = events_ms(lambda: F.scaled_dot_product_attention(
        q, kr, vr, is_causal=True), 20)
    bound, by, flops, nbytes = flash_bounds(**m)["flash_fwd"]
    rows = {}
    for name, (kind, _) in PACKED.items():
        fn, twin = pfp.KERNELS[kind]
        ms = events_ms(lambda: fn(q, k, v, True, scale), 20)
        plain_ms = events_ms(lambda: twin(q, k, v, True, scale), 2)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by, "k2_ms": k2_ms,
                      "max_abs_err": worst[name][0],
                      "max_rel_err": worst[name][1],
                      "lse_err": worst[name][2],
                      "tflops": flops / (ms * 1e-3) / 1e12,
                      "k2_bit_identical": {k_: v_ for k_, v_ in same.items()
                                           if k_.startswith(name + " ")},
                      # <D, block_k, schedule, more than 128 rows>
                      "registers": {k_: v_ for k_, v_ in regs.items()
                                    if k_.split(",")[2] == str(
                                        PACKED_SCHED[kind])}}
        print(f"{name} (pack 2, block_q 64, block_k 64) B4 H32 Hkv8 S2048 "
              f"D64 causal bf16: kernel {ms:.4f} ms ({flops / 1e9:.1f} GFLOP,"
              f" {rows[name]['tflops']:.1f} TFLOP/s = {100 * bound / ms:.1f}% "
              f"of the bound), plain twin {plain_ms:.4f} ms, K2 {k2_ms:.4f} ms"
              f" ({ms / k2_ms:.2f}x K2), scaled_dot_product_attention forward"
              f" {lib_ms:.4f} ms (k/v repeated to 32 heads beforehand; "
              f"{ms / lib_ms:.2f}x), bound {bound:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB)")

    # The entry point's own check, then its sweep: the main path of this
    # slice, with the launch counts reset right before and read right after.
    errs = pfp.check("cuda", print_fn=lambda line: None)
    print(f"prof_flash_pack check (B1 H8 Hkv2 S1024 D64 causal against f32 "
          f"attention_reference, limit {pfp.CHECK_TOL} of its largest value):"
          f" {len(errs)} variants, max abs err {max(errs.values()):.3e}")
    fns = {name: pfp.KERNELS[kind][0] for name, (kind, _) in PACKED.items()}
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sweep = pfp.sweep()
    launches = {name: fn.launches for name, fn in fns.items()}
    best = min(sweep[1:], key=lambda r: r["ms"])
    print(f"prof_flash_pack sweep: {len(sweep)} variants in "
          f"{time.perf_counter() - t0:.1f} s; best {best['name']} "
          f"{best['ms']:.4f} ms = {best['ms'] / sweep[0]['ms']:.2f}x prod "
          f"(K2) {sweep[0]['ms']:.4f} ms; launches {launches}")
    for name, (kind, _) in PACKED.items():
        if not launches[name]:
            raise AssertionError(f"the sweep launched {name} no time")
        prefix = {"masked": "pack", "epi": "epi_", "inl": "inl_"}[kind]
        rows[name].update(launches=launches[name], sweep_ms={
            r["name"]: r["ms"] for r in sweep
            if r["name"].startswith(prefix)})
    return rows, sweep


# K6/K7 position cases (Sq, Skv, qpos offset, kpos offset): the diagonal
# chunk, a wholly visible past chunk, a wholly masked future chunk, offsets
# that are no multiple of 64, and ragged lengths partly and wholly masked.
CHUNK_POS = {"diagonal": (2048, 2048, 2048, 2048),
             "past": (2048, 2048, 2048, 0),
             "future": (2048, 2048, 0, 2048),
             "offset": (2048, 2048, 1000, 37),
             "ragged": (1000, 936, 300, 0),
             "ragged future": (1000, 936, 0, 2000),
             # The tile classes' cases: rows that see no key sharing tiles
             # with rows that do; the diagonal's positions permuted (seeded),
             # so a tile's min and max are not its ends; S 1024 causal, 16
             # tiles a side with every class present.
             "mixed": (2048, 2048, 0, 30),
             "shuffled": (2048, 2048, 2048, 2048),
             "long causal": (1024, 1024, 0, 0)}
TILE_CASES = ("mixed", "shuffled", "long causal")
# The JAX bench's 1.1B geometry (bench.py:292-297); max_seq_len per phase.
BENCH_GEOMETRY = dict(vocab_size=32128, hidden_size=2048,
                      intermediate_size=8192, num_layers=16, num_heads=32,
                      num_kv_heads=8, head_dim=64, tie_embeddings=True,
                      dtype="bfloat16")
CP_SEQ = 16384  # the context-parallel phases' sequence (b1)
# K6/K7 at the CP step's shape (one rank: the whole sequence, positions
# 0..S-1, causal) and at the sp = 4 ring's chunk shape (a quarter of it).
CP_ATTN = dict(b=1, h=32, hkv=8, s=CP_SEQ, d=64)
RING_CHUNK = dict(CP_ATTN, s=CP_SEQ // 4)


def _chunk_inputs(gen, b, h, hkv, sq, skv, d, q0, k0, shuffle=False):
    """bf16 q/k/v, int32 global positions (each vector permuted, seeded,
    with ``shuffle``), and f32 cotangents of out and lse (the lse one
    nonzero, as the ring's combine makes it)."""
    import torch

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    qpos = torch.arange(sq, dtype=torch.int32, device="cuda") + q0
    kpos = torch.arange(skv, dtype=torch.int32, device="cuda") + k0
    if shuffle:
        perm = torch.Generator().manual_seed(SEED + 11)
        qpos = qpos[torch.randperm(sq, generator=perm).cuda()]
        kpos = kpos[torch.randperm(skv, generator=perm).cuda()]
    return (rnd(b, h, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d), qpos,
            kpos, rnd(b, h, sq, d, dtype=torch.float32),
            rnd(b, h, sq, dtype=torch.float32))


def _chunk_check(inputs, causal, label, worst, strict=False,
                 lse_tol=FLASH_LSE_TOL):
    """K6 and K7 against their twins on one input (K7 on the twin's
    residuals), and the tile-bounds pre-pass against its twin; raises past
    the tolerance, folds the max abs errors into ``worst``. ``strict``
    also holds rows that see no key finite with lse < -1e29 and K7's dq,
    dk and dv to the same bits on a second launch."""
    import torch
    from ray_tpu_torch.ops import attention as att

    q, k, v, qpos, kpos, g_out, g_lse = inputs
    scale = q.shape[-1] ** -0.5
    if not torch.equal(att.chunk_tile_bounds_cuda(qpos, kpos),
                       att.chunk_tile_bounds_plain(qpos, kpos)):
        raise AssertionError(f"chunk_tile_bounds disagrees with its twin at "
                             f"{label}")
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal, scale)
    p_out, p_lse = att.flash_chunk_fwd_plain(q, k, v, qpos, kpos, causal,
                                             scale)
    grads = att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, p_out, p_lse,
                                     g_out, g_lse, causal, scale)
    plain = att.flash_chunk_bwd_plain(q, k, v, qpos, kpos, p_out, p_lse,
                                      g_out, g_lse, causal, scale)
    torch.cuda.synchronize()
    errs, rels = {}, {}
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (p_out, *plain)):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"flash chunk {name} not finite at {label}")
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        rels[name] = rel
        if not rel < FLASH_REL_TOL:
            raise AssertionError(f"flash chunk {name} disagrees with its "
                                 f"twin at {label}: max abs err {err:.3e} = "
                                 f"{rel:.3e} of the largest value (> "
                                 f"{FLASH_REL_TOL})")
        errs[name] = err
    errs["lse"] = (lse - p_lse).abs().max().item()
    if not errs["lse"] < lse_tol:
        raise AssertionError(f"flash chunk lse disagrees at {label}: "
                             f"{errs['lse']:.3e} > {lse_tol}")
    if strict:
        nokey = qpos < kpos.min() if causal else torch.zeros_like(qpos).bool()
        if not (lse[..., nokey] < -1e29).all():
            raise AssertionError(f"rows that see no key lost lse ~ -6.9e29 "
                                 f"at {label}")
        again = att.flash_chunk_bwd_cuda(q, k, v, qpos, kpos, p_out, p_lse,
                                         g_out, g_lse, causal, scale)
        for name, x, y in zip(("dq", "dk", "dv"), again, grads):
            if not torch.equal(x, y):
                raise AssertionError(f"K7's {name} differs between two "
                                     f"launches at {label}")
    worst["flash_chunk_fwd"] = max(worst["flash_chunk_fwd"], errs["out"],
                                   errs["lse"])
    worst["flash_chunk_bwd"] = max(worst["flash_chunk_bwd"], errs["dq"],
                                   errs["dk"], errs["dv"])
    for name, keys in (("flash_chunk_fwd", ("out",)),
                       ("flash_chunk_bwd", ("dq", "dk", "dv"))):
        worst[name + " rel"] = max([worst[name + " rel"]]
                                   + [rels[k] for k in keys])
    return errs


def chunk_bounds(b, h, hkv, qpos, kpos, d, causal):
    """(K6, K7) least times in ms with what bounds each: the FLOPs that
    these positions need (4 and 10 * B*H*D per visible (q, k) pair: the
    pairs the mask keeps, kpos ascending) over the bf16 peak vs bytes (each
    input read once, each output written once) over HBM bandwidth. Also the
    full pass's FLOPs, for its rate beside the kept pairs'."""
    import torch
    from ray_tpu_torch.accelerators.flops import peak_flops

    sq, skv = qpos.numel(), kpos.numel()
    pairs = (int(torch.searchsorted(kpos, qpos, right=True).sum())
             if causal else sq * skv)  # kpos ascending
    qb, kvb = b * h * sq * d * 2, b * hkv * skv * d * 2
    rows, pos = b * h * sq * 4, (sq + skv) * 4
    out = {}
    for name, flops, nbytes in (
            # q, k, v, qpos, kpos in; out f32, lse out
            ("flash_chunk_fwd", 4.0 * b * h * d * pairs,
             qb + 2 * kvb + pos + 2 * qb + rows),
            # q, k, v, qpos, kpos, out f32, lse, g_out f32, g_lse in;
            # dq, dk, dv out
            ("flash_chunk_bwd", 10.0 * b * h * d * pairs,
             qb + 2 * kvb + pos + 4 * qb + 2 * rows + qb + 2 * kvb)):
        t_ops = flops / peak_flops("h100", "bf16")
        t_bytes = nbytes / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes",
                     flops, nbytes, 4.0 * b * h * d * sq * skv
                     * (2.5 if name == "flash_chunk_bwd" else 1.0))
    return out


def tile_pairs(qpos, kpos, causal: bool) -> dict:
    """{kernel: {"skipped", "partial", "visible": pairs}} over one head's
    (q tile, kv tile) pairs in each kernel's own geometry, counted on the
    host from the positions: K6 classes 64-row q halves against 64-wide kv
    tiles, K7 64-row q tiles against its 128-row kv tiles. Skipped: kmin >
    qmax and every row of the q tile sees a key (qmin >= min kpos);
    visible: kmax <= qmin with whole tiles (K6 needs only the kv tile
    whole); partial: the rest, masked per element."""
    import numpy as np

    qp, kp = qpos.cpu().numpy(), kpos.cpu().numpy()
    cmin = kp.min()

    def blocks(pos, n):
        nb = -(-pos.size // n)
        pad = np.concatenate([pos, np.full(nb * n - pos.size, pos[-1])])
        full = np.arange(nb) * n + n <= pos.size
        return pad.reshape(nb, n).min(1), pad.reshape(nb, n).max(1), full

    out = {}
    for name, bk, need_q_whole in (("flash_chunk_fwd", 64, False),
                                   ("flash_chunk_bwd", 128, True)):
        qlo, qhi, qfull = (a[:, None] for a in blocks(qp, 64))
        klo, khi, kfull = (a[None, :] for a in blocks(kp, bk))
        whole = kfull & (qfull if need_q_whole else True)
        if causal:
            skipped = (klo > qhi) & (qlo >= cmin)
            visible = (khi <= qlo) & whole & ~skipped
        else:
            skipped = np.zeros(qlo.shape[0] * klo.shape[1], bool).reshape(
                qlo.shape[0], klo.shape[1])
            visible = np.broadcast_to(whole, skipped.shape)
        n = skipped.size
        out[name] = {"skipped": int(skipped.sum()),
                     "visible": int(visible.sum()),
                     "partial": int(n - skipped.sum() - visible.sum())}
    return out


def _chunk_times(inputs, m, causal, lib_causal, iters):
    """K6/K7, their twins and scaled_dot_product_attention (on k/v
    repeated to q's heads; its forward for K6, its backward alone for K7;
    ``lib_causal`` when the positions make the mask the diagonal's) on one
    input: {name: (ms, plain ms, library ms)}."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att

    q, k, v, qpos, kpos, g_out, g_lse = inputs
    scale = m["d"] ** -0.5
    out, lse = att.flash_chunk_fwd_cuda(q, k, v, qpos, kpos, causal, scale)
    kr, vr = att._repeat_kv(k, m["h"]), att._repeat_kv(v, m["h"])
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, kr, vr))
    do = g_out.to(torch.bfloat16)
    # SDPA's backward alone: one forward, its graph replayed.
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=lib_causal)
    lib_bwd_ms = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), iters)
    del o_lib
    return {
        "flash_chunk_fwd": (
            events_ms(lambda: att.flash_chunk_fwd_cuda(
                q, k, v, qpos, kpos, causal, scale), iters),
            events_ms(lambda: att.flash_chunk_fwd_plain(
                q, k, v, qpos, kpos, causal, scale), 2),
            events_ms(lambda: F.scaled_dot_product_attention(
                q, kr, vr, is_causal=lib_causal), iters)),
        "flash_chunk_bwd": (
            events_ms(lambda: att.flash_chunk_bwd_cuda(
                q, k, v, qpos, kpos, out, lse, g_out, g_lse, causal, scale),
                iters),
            events_ms(lambda: att.flash_chunk_bwd_plain(
                q, k, v, qpos, kpos, out, lse, g_out, g_lse, causal, scale),
                2),
            lib_bwd_ms),
    }


def phase_chunk():
    import torch
    from ray_tpu_torch.ops import attention as att

    _phase("kernel vs plain: flash_chunk_fwd / flash_chunk_bwd (ring step)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst = {"flash_chunk_fwd": 0.0, "flash_chunk_bwd": 0.0,
             "flash_chunk_fwd rel": 0.0, "flash_chunk_bwd rel": 0.0}
    n = 0
    for causal in (True, False):
        for rep in (1, 4):
            for d in (64, 128):
                for where, (sq, skv, q0, k0) in CHUNK_POS.items():
                    tile = where in TILE_CASES
                    _chunk_check(_chunk_inputs(gen, 1, 8, 8 // rep, sq, skv,
                                               d, q0, k0,
                                               shuffle=where == "shuffled"),
                                 causal,
                                 f"causal={causal} rep={rep} d={d} {where}",
                                 worst, strict=tile)
                    n += 1
    # The sp = 4 schedule's three kinds of chunk pair at its shape, then the
    # CP step's own inputs (the main path's shape).
    r, c = RING_CHUNK, CP_ATTN
    ring = {where: _chunk_inputs(gen, r["b"], r["h"], r["hkv"], r["s"],
                                 r["s"], r["d"], q0, k0)
            for where, (q0, k0) in (("past", (r["s"], 0)),
                                    ("diagonal", (r["s"], r["s"])),
                                    ("future", (0, r["s"])))}
    ring_errs = {where: _chunk_check(inputs, True, f"the ring's {where} "
                                     f"chunk", worst, strict=True)
                 for where, inputs in ring.items()}
    main = _chunk_inputs(gen, c["b"], c["h"], c["hkv"], c["s"], c["s"],
                         c["d"], 0, 0)
    main_errs = _chunk_check(main, True, "the CP step's shape", worst,
                             strict=True)
    print(f"flash chunk kernels == plain twins over {n} cases (the tile "
          f"classes' {', '.join(TILE_CASES)} with no-key rows and K7's "
          f"dq/dk/dv bits on repeat checked, as at the ring's and the CP "
          f"step's shapes), the sp=4 "
          f"ring's past/diagonal/future chunks (B1 H32 Hkv8 4096x4096 D64) "
          f"and the CP step's shape (B1 H32 Hkv8 S16384 D64, positions "
          f"0..16383, causal); bf16, nonzero lse cotangent; max abs err: "
          f"flash_chunk_fwd {worst['flash_chunk_fwd']:.3e}, flash_chunk_bwd "
          f"{worst['flash_chunk_bwd']:.3e} (= "
          f"{worst['flash_chunk_fwd rel']:.3e}"
          f" and {worst['flash_chunk_bwd rel']:.3e} of the case's largest "
          f"value; tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL}); chunk_tile_bounds == its twin on every case")
    for where, errs in (*ring_errs.items(), ("CP step", main_errs)):
        print(f"  at the {where} shape: "
              + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items()))

    rows = {}
    for label, m, inputs, lib_causal, iters in (
            ("CP step", c, main, True, 5),
            ("ring chunk", r, ring["past"], False, 10)):
        times = _chunk_times(inputs, m, True, lib_causal, iters)
        bounds = chunk_bounds(m["b"], m["h"], m["hkv"], inputs[3],
                              inputs[4], m["d"], True)
        pairs = tile_pairs(inputs[3], inputs[4], True)
        for name, (ms, plain_ms, lib_ms) in times.items():
            bound, by, flops, nbytes, full = bounds[name]
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by,
                   "tflops": flops / (ms * 1e-3) / 1e12,
                   "tflops_full_pass": full / (ms * 1e-3) / 1e12,
                   "tile_pairs": pairs[name]}
            if label == "CP step":
                rows[name] = dict(row, max_abs_err=worst[name],
                                  max_rel_err=worst[name + " rel"],
                                  main_shape_errs=main_errs)
            else:
                rows[name]["chunk_4096"] = row
            print(f"{name} {label}: kernel {ms:.4f} ms ({row['tflops']:.1f} "
                  f"TFLOP/s over the {flops / 1e9:.1f} GFLOP the mask keeps;"
                  f" full-pass rate {row['tflops_full_pass']:.1f} TFLOP/s of "
                  f"{full / 1e9:.1f} GFLOP; {100 * bound / ms:.1f}% of the "
                  f"bound), plain twin {plain_ms:.4f} ms, "
                  f"{'causal' if lib_causal else 'non-causal'} "
                  f"scaled_dot_product_attention "
                  + ("backward alone" if name == "flash_chunk_bwd"
                     else "forward")
                  + f" {lib_ms:.4f} ms (k/v repeated to 32 heads beforehand; "
                  f"{ms / lib_ms:.2f}x), bound {bound:.4f} ms ({by}; "
                  f"{nbytes / 1e6:.1f} MB); tile pairs a head (skipped / "
                  f"partial / visible): {pairs[name]['skipped']} / "
                  f"{pairs[name]['partial']} / {pairs[name]['visible']}"
                  + (f"; recorded, not measured here: the atomic-dq parent "
                     f"(e3857e2) {RECORDED_ATOMIC_PARENT_MS[name]:.4f} ms in "
                     f"devbench/pair_chunk.py's paired call (PERF.md)"
                     if label == "CP step"
                     and name in RECORDED_ATOMIC_PARENT_MS else ""))
    # The pre-pass at the CP step's positions: bytes bound (the positions
    # read once, the bounds written once).
    qpos, kpos = main[3], main[4]
    out = att.chunk_tile_bounds_cuda(qpos, kpos)
    nbytes = (qpos.numel() + kpos.numel() + out.numel()) * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    pre = {"ms": events_ms(lambda: att.chunk_tile_bounds_cuda(qpos, kpos),
                           200),
           "plain_ms": events_ms(
               lambda: att.chunk_tile_bounds_plain(qpos, kpos), 50),
           "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
           "max_abs_err": 0}
    rows["chunk_tile_bounds"] = pre
    print(f"chunk_tile_bounds CP step: kernel {pre['ms']:.4f} ms (one CTA; "
          f"exact, == its twin), plain twin {pre['plain_ms']:.4f} ms, bound "
          f"{bound:.6f} ms (bytes; {nbytes / 1e3:.1f} KB); no single "
          f"PyTorch call computes it")
    return rows


# Limits on the ring against flash_fwd/flash_bwd on the whole sequence,
# each a block's error over that block's norm (chunk_rel_err), so the
# chunks of small values count as much as the large ones; about three
# times the readings on an H100 (PERF.md).
RING_CHUNK_TOL = {"out": 8e-3, "dq": 1.5e-2, "dk": 1.5e-2, "dv": 1.5e-2}


def row_rel_err(got, want) -> float:
    """The largest error of any row (the last axis), relative to that row's
    norm: max over rows of ||got_r - want_r|| / ||want_r||."""
    g = got.detach().float().reshape(-1, got.shape[-1])
    w = want.detach().float().reshape(-1, want.shape[-1])
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max() \
        .item()


def chunk_rel_err(got, want, n: int) -> float:
    """The largest error of any (batch row, head, chunk) block of a
    [B, H, S, D] tensor whose sequence is split into the ring's n chunks,
    relative to that block's norm. A chunk pair the ring got wrong shows
    whole in its block; single rows whose exact value is near 0 (dq of
    the first query: ds = dp - delta cancels) do not drown the reading."""
    b, h, s, d = want.shape
    g = got.detach().float().reshape(b, h, n, s // n * d)
    w = want.detach().float().reshape(b, h, n, s // n * d)
    return ((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max() \
        .item()


def ring_errors(got, want, n: int) -> dict:
    """{name: (chunk_rel_err, max abs err over the largest value)} of the
    ring's (out, dq, dk, dv) over n chunks against flash_fwd/flash_bwd's."""
    return {name: (chunk_rel_err(g, w, n),
                   ((g.float() - w.float()).abs().max()
                    / w.float().abs().max()).item())
            for name, g, w in zip(("out", "dq", "dk", "dv"), got, want)}


def check_ring_errors(errs: dict, label: str) -> None:
    bad = {k: e for k, (e, _) in errs.items() if not e < RING_CHUNK_TOL[k]}
    if bad:
        raise AssertionError(f"{label}: chunks off flash_attention's past "
                             f"{RING_CHUNK_TOL}: {bad}")


def phase_ring_schedule():
    import torch
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops.ring_attention import simulate_ring

    _phase("ring schedule: sp = 4 in one process, B1 H32 Hkv8 S16384 D64")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    m, sp = CP_ATTN, 4

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = (rnd(m["b"], h, m["s"], m["d"]).requires_grad_()
               for h in (m["h"], m["hkv"], m["hkv"]))
    do = rnd(m["b"], m["h"], m["s"], m["d"])
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    want = att.flash_attention(*ref, True)
    want.backward(do)
    counters = _counters()
    for c in counters.values():
        c.launches = 0  # count the schedule only
    t0 = time.perf_counter()
    out = simulate_ring(q, k, v, sp)
    out.backward(do)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k_: c.launches for k_, c in counters.items()}
    if (launches["flash_chunk_fwd"], launches["flash_chunk_bwd"]) != \
            (sp * sp, sp * sp) or launches["flash_fwd"] or \
            launches["flash_bwd"]:
        raise AssertionError(f"ring schedule launches {launches}, want "
                             f"{sp * sp} K6 and {sp * sp} K7, no K2/K3")
    errs = ring_errors((out, q.grad, k.grad, v.grad),
                       (want, *(r.grad for r in ref)), sp)
    print(f"sp={sp} schedule: {launches['flash_chunk_fwd']} K6 + "
          f"{launches['flash_chunk_bwd']} K7 launches, no K2/K3, "
          f"{wall * 1e3:.1f} ms forward + backward (first run); against "
          f"flash_fwd/flash_bwd on the whole sequence, worst (head, chunk)"
          f" block's error over its norm (max abs err over the largest "
          f"value): "
          + ", ".join(f"{k_} {e:.3e} ({g:.3e})" for k_, (e, g) in errs.items())
          + f"; limits {RING_CHUNK_TOL}")
    check_ring_errors(errs, f"sp={sp} schedule")
    return {"launches": launches, "errs": errs}


TRAIN_WARMUP = 2   # steps before the clock starts
TRAIN_STEPS = 10   # timed steps
PROFILED_STEPS = 3  # steps under torch.profiler after the timed ones


def predicted_launches(remat, num_layers: int, ring: int = 0,
                       split: bool = False, model: str = "llama") -> dict:
    """Kernel launches per training step under a remat policy or a
    per-layer spec ("dots:8,attn:8"), for Llama, ViT and Mixtral alike
    (each runs two rms_norms a layer plus a final one). Forward: the
    norms, one flash forward a layer. The backward recomputes the norms of
    the checkpointed segments (attn, attn+, dots: both of a layer; full:
    the layer, the flash forward included; Llama's dots+ keeps its norm
    outputs and recomputes none, while ViT's and Mixtral's layers name no
    norm output, so their dots+ is dots) and runs one flash backward a
    layer; rms_norm's backward is plain tensor ops (no launch). The flash
    kernels are K2/K3, K2 and K4 + K5 with ``split`` (the split backward),
    or with ``ring`` > 0 (context parallel over that many ranks: as many
    ring steps a layer) K6/K7, each after its tile-bounds pre-pass."""
    from ray_tpu_torch.models.llama import normalize_remat

    spec = normalize_remat(remat, num_layers)
    layers = list(spec) if isinstance(spec, tuple) else [spec] * num_layers
    kept_norms = ("none", False) + (("dots+",) if model == "llama" else ())
    segments = ("none", False, "attn", "attn+", "dots", "dots+")
    recompute = sum(0 if p in kept_norms else 2 for p in layers)
    fwd = sum(1 if p in segments else 2 for p in layers)
    bwd = num_layers
    flat = 0 if ring else 1
    return {"rms_norm": 2 * num_layers + 1 + recompute,
            "flash_fwd": fwd * flat,
            "flash_bwd": 0 if split else bwd * flat,
            "flash_bwd_dq": bwd * flat if split else 0,
            "flash_bwd_dkv": bwd * flat if split else 0,
            "flash_chunk_fwd": fwd * ring, "flash_chunk_bwd": bwd * ring,
            # K6 and K7 each launch the tile-bounds pre-pass first
            "chunk_tile_bounds": (fwd + bwd) * ring}


def kernel_category(name: str) -> str:
    """Coarse class of a CUDA kernel name from the profiler."""
    low = name.lower()
    for cat, keys in (("flash", ("flash_",)), ("rms_norm", ("rms_norm",)),
                      ("nccl", ("nccl",)),
                      ("gemm", ("nvjet", "gemm", "cutlass", "cublas")),
                      ("copy/cast", ("copy", "cat_", "catarray")),
                      ("reduction", ("reduce", "softmax", "logsumexp")),
                      ("elementwise", ("elementwise",)),
                      ("index/scatter", ("index", "scatter", "gather",
                                         "embedding"))):
        if any(k in low for k in keys):
            return cat
    return "other"


def _counters():
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops import norms

    return {"rms_norm": norms.rms_norm, "flash_fwd": att.flash_fwd_cuda,
            "flash_bwd": att.flash_bwd_cuda,
            "flash_bwd_dq": att.flash_bwd_dq_cuda,
            "flash_bwd_dkv": att.flash_bwd_dkv_cuda,
            "flash_chunk_fwd": att.flash_chunk_fwd_cuda,
            "flash_chunk_bwd": att.flash_chunk_bwd_cuda,
            "chunk_tile_bounds": att.chunk_tile_bounds_cuda}


@contextlib.contextmanager
def backward_choice(fused: bool):
    """A context in which flash_attention's backward is K3 (``fused``) or
    K4 + K5; the attention module's ``FUSED_BWD`` is restored on
    exit."""
    from ray_tpu_torch.ops import attention as att

    old = att.FUSED_BWD
    att.FUSED_BWD = fused
    try:
        yield
    finally:
        att.FUSED_BWD = old


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


TOP_OPS = 16  # PyTorch ops listed by the device time they launched


def profile_steps(step, state, tok, tgt, steps: int, step_s: float,
                  counters, quiet: bool = False) -> tuple:
    """``steps`` training steps under torch.profiler: prints the device
    busy share (of the profiled wall, which carries the profiler's own
    host cost, and of the unprofiled window's ``step_s``), each counted
    kernel's and each category's device ms per step, the largest kernels
    and the PyTorch ops that launched the most device time themselves
    (``quiet``: nothing printed). Returns (state, the numbers)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _m = step(state, tok, tgt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kern:  # per step
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3 / steps
    busy_ms = sum(by_name.values())
    share = {key: sum(ms for n, ms in by_name.items()
                      if re.search(rf"\b{key}(_cta|_warp)?_kernel\b", n))
             for key in counters}
    cats: dict[str, float] = {}
    for name, ms in by_name.items():
        cat = kernel_category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
    if busy_ms > 0 and not quiet:
        print(f"{steps} profiled step{'s' if steps > 1 else ''}, per step: "
              f"wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms = "
              f"{100 * busy_ms / wall_ms:.1f}% of the profiled wall (idle "
              f"{100 - 100 * busy_ms / wall_ms:.1f}%), "
              f"{100 * busy_ms / (step_s * 1e3):.1f}% of the unprofiled "
              f"window's {step_s * 1e3:.2f} ms step, "
              f"{len(kern) // steps} kernels; "
              + ", ".join(f"{k} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)"
                          for k, ms in share.items()))
        print("by category: " + ", ".join(
            f"{c} {ms:.2f} ms ({100 * ms / busy_ms:.1f}%)"
            for c, ms in sorted(cats.items(), key=lambda kv: -kv[1])))
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
            print(f"  {ms:8.3f} ms  {name[:100]}")
    elif not quiet:
        print("device busy: not measured (profiler saw no kernels)")
    ops = {}  # host-side ops only: the kernels' own rows repeat them
    for e in prof.key_averages() if busy_ms else ():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CPU and us > 0:
            ops[e.key] = us / 1e3 / steps
    if ops and not quiet:
        print("by PyTorch op (device ms per step of the kernels each op "
              "launched itself): " + ", ".join(
                  f"{k[:40]} {ms:.2f}" for k, ms in sorted(
                      ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]))
    return state, {"profiled_wall_ms": wall_ms, "busy_ms": busy_ms or None,
                   "kernel_ms_per_step": share if busy_ms else None,
                   "category_ms_per_step": cats if busy_ms else None,
                   **({"op_ms_per_step": ops} if ops else {})}


def phase_train():
    import gc
    import math

    import numpy as np
    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        llama_train_flops,
        peak_flops,
    )
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.train.optim import optimizer_state_bytes

    _phase("train: the 1.1B bench geometry, b4 s2048, remat attn+, "
           "adamw_lowmem, seeded random weights and tokens")
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    batch, seq, remat = 4, 2048, "attn+"
    opt = adamw_lowmem(3e-4, weight_decay=0.1)
    torch.cuda.reset_peak_memory_stats()
    step, init, shard = make_llama_train_step(
        cfg, optimizer=opt, attn_impl="flash", remat=remat, seed=SEED,
        device="cuda")
    t0 = time.perf_counter()
    state = init()
    torch.cuda.synchronize()
    print(f"state up in {time.perf_counter() - t0:.2f} s: "
          f"{cfg.num_params() / 1e9:.3f}B params, hidden {cfg.hidden_size}, "
          f"{cfg.num_layers} layers, heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads}, vocab {cfg.vocab_size}, tied")
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))

    counters = _counters()
    for c in counters.values():
        c.launches = 0  # count the training path only
    losses, norms_ = [], []
    for _ in range(TRAIN_WARMUP):
        state, m = step(state, tok, tgt)
        losses.append(m["loss"])
        norms_.append(m["grad_norm"])
    # The phases before this one leave a large heap; a full garbage
    # collection of it inside the timed window idles the device for
    # hundreds of ms. Freeze it out of the collector until the phase ends.
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(TRAIN_STEPS):
        state, m = step(state, tok, tgt)
        marks[i + 1].record()  # no sync: the host runs ahead as it can
        losses.append(m["loss"])
        norms_.append(m["grad_norm"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    launches = {k: c.launches for k, c in counters.items()}
    steps = TRAIN_WARMUP + TRAIN_STEPS
    want = predicted_launches(remat, cfg.num_layers)
    per_step = {k: n / steps for k, n in launches.items()}
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"launches per step {per_step} != the remat "
                             f"policy's {want}")
    loss_vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_vals) or \
            not loss_vals[-1] < loss_vals[0]:
        raise AssertionError(f"loss trajectory not finite and falling: "
                             f"{loss_vals}")
    step_s = dt / TRAIN_STEPS  # the whole window: all tokens, all time
    flops = llama_train_flops(cfg, batch, seq)
    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    if not rate:
        raise AssertionError("no peak rate for this card in "
                             "ray_tpu_torch/accelerators/flops.py")
    toks, mfu = batch * seq / step_s, flops / step_s / rate
    print(f"{TRAIN_STEPS} timed steps after {TRAIN_WARMUP} warm-up, whole "
          f"window on the host clock: {step_s * 1e3:.2f} ms a step, "
          f"{toks:.1f} tokens/s, MFU {100 * mfu:.2f}% ({flops / 1e12:.2f} "
          f"TFLOP per step counted as 6*N*tokens + attention, against "
          f"{rate / 1e12:.0f} TFLOP/s); per step between CUDA events "
          f"{_spread(step_ms)} ms")
    print("loss " + " ".join(f"{x:.4f}" for x in loss_vals)
          + "; grad_norm " + " ".join(f"{float(x):.4f}" for x in norms_))
    print(f"launches per step: " + ", ".join(
        f"{k} {v:g}" for k, v in per_step.items())
          + f" (= the {remat} policy's prediction over {steps} steps)")
    gib = 2.0 ** 30
    peak = torch.cuda.max_memory_allocated() / gib
    p_bytes = _nbytes(tree_leaves(state.params)) / gib
    m_bytes = optimizer_state_bytes(opt, state.params) / gib
    print(f"peak device memory {peak:.3f} GiB: params {p_bytes:.3f}, grads "
          f"{p_bytes:.3f} (bf16, freed after each update), moments "
          f"{m_bytes:.3f} (bf16), activations, the update's f32 transients "
          f"and allocator slack {peak - 2 * p_bytes - m_bytes:.3f}")

    state, prof = profile_steps(step, state, tok, tgt, PROFILED_STEPS,
                                step_s, counters)
    gc.unfreeze()
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_per_step": per_step,
            "step_ms": step_s * 1e3, "step_ms_events": step_ms,
            "tokens_per_s": toks, "mfu": mfu,
            "peak_gib": peak, "params_gib": p_bytes, "moments_gib": m_bytes,
            "losses": loss_vals,
            **prof}


SPLIT_STEPS = 5  # timed steps of the split-backward trainer
# Limit on each parameter's gradient under the split backward against the
# fused one on the same params and batch: its error's norm over its norm.
# On an H100 the readings were 8.9e-3 to 1.44e-2, and the fused backward
# against itself 8.4e-3 to 1.40e-2 (K3's dq atomics); the split one
# against itself 0. The limit is about 3.5x the worst reading, as CP's.
SPLIT_GRAD_TOL = 5e-2


def _loss_grads(loss_call, leaves):
    """One forward + backward: (loss, the leaves' gradients); the leaves'
    .grad is left None."""
    loss = loss_call()
    loss.backward()
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return float(loss.detach()), grads


def _grad_errs(names, grads, ref_grads) -> dict:
    return {name: ((g.float() - w.float()).norm() / w.float().norm()).item()
            for name, g, w in zip(names, grads, ref_grads)}


def split_against_fused(loss_call, params) -> dict:
    """The loss and every parameter's gradient under the split backward
    against the fused one, from the same params and batch; beside them each
    backward run twice (the fused one's dq atomics add in no fixed order,
    the split one has none)."""
    from ray_tpu_torch._device import tree_leaves

    leaves = tree_leaves(params)
    names = list(_leaf_names(params))
    runs = {}
    for name, fused in (("fused", True), ("split", False)):
        with backward_choice(fused):
            runs[name] = [_loss_grads(loss_call, leaves) for _ in range(2)]
    (ref_loss, ref), (ref_loss2, ref2) = runs["fused"]
    (loss, got), (loss2, got2) = runs["split"]
    return {"loss": loss, "ref_loss": ref_loss,
            "losses_repeat_equal": loss == loss2 and ref_loss == ref_loss2,
            "grad_errs": _grad_errs(names, got, ref),
            "fused_repeat_errs": _grad_errs(names, ref2, ref),
            "split_repeat_errs": _grad_errs(names, got2, got)}


def check_split(res: dict, label: str) -> None:
    """Prints ``split_against_fused``'s readings, then holds them: the
    first loss bit-equal (the forward is K2 either way), each gradient
    within SPLIT_GRAD_TOL of the fused one's."""
    errs = res["grad_errs"]
    print(f"{label}: split backward against fused on the same params and "
          f"batch: loss {res['loss']!r} vs {res['ref_loss']!r}; each "
          f"parameter's gradient error over its norm (limit "
          f"{SPLIT_GRAD_TOL}; in brackets fused run twice, then split run "
          f"twice): " + ", ".join(
              f"{k} {e:.3e} [{res['fused_repeat_errs'][k]:.3e}, "
              f"{res['split_repeat_errs'][k]:.3e}]" for k, e in errs.items()))
    bad = {k: e for k, e in errs.items() if not e < SPLIT_GRAD_TOL}
    if bad or res["loss"] != res["ref_loss"] or not math.isfinite(
            res["loss"]):
        raise AssertionError(f"{label}: split backward off the fused one: "
                             f"{res}")


def phase_train_split(fused: dict):
    import gc

    import numpy as np
    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        llama_train_flops,
        peak_flops,
    )
    from ray_tpu_torch.models.llama import LlamaConfig, loss_fn
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    _phase("train, split backward (K4 + K5): the 1.1B bench geometry, b4 "
           "s2048, remat attn+, adamw_lowmem, the phase before's weights "
           "and tokens")
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    batch, seq, remat = 4, 2048, "attn+"
    opt = adamw_lowmem(3e-4, weight_decay=0.1)
    torch.cuda.reset_peak_memory_stats()
    step, init, shard = make_llama_train_step(
        cfg, optimizer=opt, attn_impl="flash", remat=remat, seed=SEED,
        device="cuda")
    state = init()
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))
    check = split_against_fused(
        lambda: loss_fn(cfg, state.params, tok, tgt, remat=remat),
        state.params)
    check_split(check, "Llama 1.1B b4 s2048")

    counters = _counters()
    with backward_choice(False):
        for c in counters.values():
            c.launches = 0  # count the split trainer only
        losses = []
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, tok, tgt)
            losses.append(m["loss"])
        gc.collect()
        gc.freeze()
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(SPLIT_STEPS + 1)]
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(SPLIT_STEPS):
            state, m = step(state, tok, tgt)
            marks[i + 1].record()
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / SPLIT_STEPS
        launches = {k: c.launches for k, c in counters.items()}
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        state, prof = profile_steps(step, state, tok, tgt, 1, step_s,
                                    counters)
        gc.unfreeze()
    steps = TRAIN_WARMUP + SPLIT_STEPS
    per_step = {k: n / steps for k, n in launches.items()}
    want = predicted_launches(remat, cfg.num_layers, split=True)
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"launches per step {per_step} != the split "
                             f"prediction {want}")
    loss_vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_vals) or \
            loss_vals[0] != fused["losses"][0] or \
            loss_vals[0] != check["ref_loss"]:
        raise AssertionError(f"split losses {loss_vals}: not finite, or the "
                             f"first is not the fused trainer's "
                             f"{fused['losses'][0]!r} bit for bit")
    flops = llama_train_flops(cfg, batch, seq)
    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    toks, mfu = batch * seq / step_s, flops / step_s / rate
    peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
    print(f"{SPLIT_STEPS} timed steps after {TRAIN_WARMUP} warm-up, whole "
          f"window on the host clock: {step_s * 1e3:.2f} ms a step, "
          f"{toks:.1f} tokens/s, MFU {100 * mfu:.2f}% (the fused trainer: "
          f"{fused['step_ms']:.2f} ms, {fused['tokens_per_s']:.1f} tokens/s);"
          f" per step between CUDA events {_spread(step_ms)} ms (the fused "
          f"trainer: {_spread(fused['step_ms_events'])} ms); peak device "
          f"memory {peak:.3f} GiB (the check's four gradient sets "
          f"included)")
    print("loss " + " ".join(f"{x:.4f}" for x in loss_vals)
          + f"; the first bit-equal to the fused trainer's")
    print(f"launches per step: " + ", ".join(
        f"{k} {v:g}" for k, v in per_step.items())
          + f" (= the split prediction over {steps} steps)")
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_per_step": per_step,
            "step_ms": step_s * 1e3, "step_ms_events": step_ms,
            "tokens_per_s": toks, "mfu": mfu, "peak_gib": peak,
            "losses": loss_vals, "check": check, **prof}


CP_WARMUP = 2  # context-parallel steps before the clock starts
CP_STEPS = 3   # timed context-parallel steps
# Limits on a context-parallel forward + backward against sp_axis=None on
# the same params and batch (cp_against_plain): the loss, relative; the
# final hidden states, row_rel_err; each parameter's gradient, its error's
# norm over its norm. Each path run twice on one card gives the same bits
# (K3 and K7 sum dq in a fixed order; when they summed it with f32
# atomics, two sp_axis=None runs differed by up to 1.4e-2 in a leaf); the two paths differ where K7's
# delta reads the f32 out and K3's the bf16 one, carried through 16 bf16
# layers, and over several ranks each rank's partial gradients round to
# bf16 before the sum (PERF.md holds the readings).
CP_LOSS_TOL = 1e-4
CP_HIDDEN_TOL = 4e-3
CP_GRAD_TOL = 5e-2


def cp_loss_and_grads(cfg, params, tokens, group):
    """One context-parallel forward + backward of the (1, S) batch
    ``tokens`` (targets: the tokens shifted by one) over the one-rank
    group ``group``: the ring's single step, whose gradients are the whole
    sequence's. Several ranks train through the step factory instead
    (phase 10), which averages the gradients itself. Returns (loss,
    grads); the leaves' .grad is left None."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.models.llama import loss_fn

    if dist.get_world_size(group) != 1:
        raise ValueError("cp_loss_and_grads takes a one-rank group")
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    return _loss_grads(lambda: loss_fn(
        cfg, params, tokens, torch.roll(tokens, -1, dims=1), positions=pos,
        sp_axis=group, remat="attn+"), tree_leaves(params))


def cp_hidden_err(cfg, params, tokens, group) -> float:
    """This rank's shard of the final hidden states with sp_axis=``group``
    (the ring over its ranks, each on its consecutive shard) against the
    same rows of sp_axis=None on the whole sequence: the worst row's error
    over its norm (row_rel_err)."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import forward_hidden

    n, r = dist.get_world_size(group), dist.get_rank(group)
    c = tokens.shape[1] // n
    pos = torch.arange(r * c, (r + 1) * c, device=tokens.device)
    with torch.no_grad():
        want = forward_hidden(cfg, params, tokens, remat="attn+")[:, pos]
        got = forward_hidden(cfg, params, tokens[:, pos], positions=pos,
                             sp_axis=group, remat="attn+")
        return row_rel_err(got, want)


def _grad_norm(grads) -> float:
    import torch

    return float(torch.stack([g.float().square().sum()
                              for g in grads]).sum().sqrt())


def cp_against_plain(cfg, params, tokens, group) -> dict:
    """``cp_loss_and_grads`` over a one-rank group and the final hidden
    states against sp_axis=None (K2/K3) on the whole sequence, from the
    same params (leaves that require grad). Returns the readings that
    ``check_cp`` holds to their limits."""
    import torch
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.models.llama import loss_fn

    hidden = cp_hidden_err(cfg, params, tokens, group)
    leaves, names = tree_leaves(params), list(_leaf_names(params))

    def plain():  # sp_axis=None's loss and gradients
        return _loss_grads(lambda: loss_fn(
            cfg, params, tokens, torch.roll(tokens, -1, dims=1),
            remat="attn+"), leaves)

    ref_loss, ref_grads = plain()
    # Each path against itself: K3 and K7 sum dq in a fixed order, so a
    # second run gives the same bits (checked with the limits).
    again_loss, again = plain()
    floor = _grad_errs(names, again, ref_grads)
    plain_same = again_loss == ref_loss and all(
        torch.equal(x, y) for x, y in zip(again, ref_grads))
    del again
    loss, grads = cp_loss_and_grads(cfg, params, tokens, group)
    loss2, grads2 = cp_loss_and_grads(cfg, params, tokens, group)
    cp_same = loss2 == loss and all(torch.equal(x, y)
                                    for x, y in zip(grads2, grads))
    del grads2
    return {"loss": loss, "ref_loss": ref_loss, "hidden_row_err": hidden,
            "grad_errs": _grad_errs(names, grads, ref_grads),
            "plain_grad_errs": floor, "plain_repeat_bit_equal": plain_same,
            "cp_repeat_bit_equal": cp_same, "grad_norm": _grad_norm(grads),
            "ref_grad_norm": _grad_norm(ref_grads)}


def _leaf_names(tree, prefix: str = ""):
    """The leaves' paths, in tree_leaves' order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix


def check_cp(res: dict, label: str) -> None:
    """Prints ``cp_against_plain``'s readings, then holds them to their
    limits (and, where it ran each path twice on one card, to the same
    bits on the second run)."""
    repeats = "cp_repeat_bit_equal" in res
    loss_rel = abs(res["loss"] - res["ref_loss"]) / abs(res["ref_loss"])
    errs = res["grad_errs"]
    print(f"{label} against sp_axis=None (K2/K3) on the same params and "
          f"batch: loss {res['loss']:.6f} vs {res['ref_loss']:.6f} "
          f"({loss_rel:.3e} relative, limit {CP_LOSS_TOL}); final hidden "
          f"states' worst row {res['hidden_row_err']:.3e} of its norm "
          f"(limit {CP_HIDDEN_TOL}); grad norm {res['grad_norm']:.6f} vs "
          f"{res['ref_grad_norm']:.6f}; each parameter's gradient error "
          f"over its norm (limit {CP_GRAD_TOL}; in brackets sp_axis=None "
          f"run twice): " + ", ".join(
              f"{k} {e:.3e} [{res['plain_grad_errs'][k]:.3e}]"
              for k, e in errs.items())
          + (f"; each path run twice, loss and every gradient bit-equal: "
             f"sp_axis=None {res['plain_repeat_bit_equal']}, CP "
             f"{res['cp_repeat_bit_equal']}" if repeats else ""))
    bad = {k: e for k, e in errs.items() if not e < CP_GRAD_TOL}
    if bad or not (math.isfinite(res["loss"]) and loss_rel <= CP_LOSS_TOL
                   and res["hidden_row_err"] < CP_HIDDEN_TOL
                   and res.get("plain_repeat_bit_equal", True)
                   and res.get("cp_repeat_bit_equal", True)):
        raise AssertionError(f"{label} disagrees with sp_axis=None or with "
                             f"itself on a second run: {res}")


def phase_cp_train():
    import gc
    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        llama_train_flops,
        peak_flops,
    )
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.train import adamw_lowmem, make_train_step

    _phase("context-parallel train: the 1.1B bench geometry, b1 s16384, "
           "sp_axis = a one-rank NCCL group, remat attn+, adamw_lowmem")
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=CP_SEQ)
    batch, seq, remat = 1, CP_SEQ, "attn+"
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        positions = torch.arange(seq, device="cuda")  # the one shard's
        opt = adamw_lowmem(3e-4, weight_decay=0.1)
        step, init, shard = make_train_step(
            loss=lambda p, tok, tgt: loss_fn(
                cfg, p, tok, tgt, sp_axis=group, positions=positions,
                remat=remat),
            init_fn=partial(init_params, cfg, device="cuda"),
            optimizer=opt, seed=SEED, device="cuda")
        state = init()
        rng = np.random.default_rng(SEED + 2)
        tokens = rng.integers(0, cfg.vocab_size, (batch, seq),
                              dtype=np.int32)
        tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))
        # The same params and batch through sp_axis=None (K2/K3). With one
        # rank the ring's single step does K2's arithmetic (a full pass
        # whose masked tiles add exact zeros, then an exact combine); the
        # gradients differ where K7's delta = rowsum(dO * out) reads the
        # f32 out and K3's the bf16 one.
        check = cp_against_plain(cfg, state.params, tok, group)
        check_cp(check, "one-rank CP forward + backward")
        torch.cuda.reset_peak_memory_stats()
        counters = _counters()
        for c in counters.values():
            c.launches = 0  # count the context-parallel path only
        losses = []
        for _ in range(CP_WARMUP):
            state, m = step(state, tok, tgt)
            losses.append(m["loss"])
        gc.collect()
        gc.freeze()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CP_STEPS):
            state, m = step(state, tok, tgt)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / CP_STEPS
        launches = {k: c.launches for k, c in counters.items()}
        steps = CP_WARMUP + CP_STEPS
        per_step = {k: n / steps for k, n in launches.items()}
        want = predicted_launches(remat, cfg.num_layers, ring=1)
        if per_step != {k: float(v) for k, v in want.items()}:
            raise AssertionError(f"launches per step {per_step} != the "
                                 f"prediction {want}")
        loss_vals = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in loss_vals) or not \
                abs(loss_vals[0] - check["loss"]) <= CP_LOSS_TOL * abs(
                    check["loss"]):
            raise AssertionError(f"CP losses {loss_vals}: not finite, or "
                                 f"the first is off the checked "
                                 f"{check['loss']}")
        flops = llama_train_flops(cfg, batch, seq)
        rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
        toks, mfu = batch * seq / step_s, flops / step_s / rate
        gib = 2.0 ** 30
        peak = torch.cuda.max_memory_allocated() / gib
        print(f"{CP_STEPS} timed steps after {CP_WARMUP} warm-up, whole "
              f"window on the host clock: {step_s * 1e3:.2f} ms a step, "
              f"{toks:.1f} tokens/s, MFU {100 * mfu:.2f}% "
              f"({flops / 1e12:.2f} TFLOP per step counted as 6*N*tokens + "
              f"causal attention; the ring's kernels skip the tiles the "
              f"mask hides wholly); peak device memory "
              f"{peak:.3f} GiB")
        print(f"loss " + " ".join(f"{x:.4f}" for x in loss_vals))
        print(f"launches per step: " + ", ".join(
            f"{k} {v:g}" for k, v in per_step.items())
              + f" (= the prediction over {steps} steps)")
        state, prof = profile_steps(step, state, tok, tgt, 1, step_s,
                                    counters)
        gc.unfreeze()
        del state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "launches_per_step": per_step,
            "step_ms": step_s * 1e3, "tokens_per_s": toks, "mfu": mfu,
            "peak_gib": peak, "losses": loss_vals, "check": check, **prof}


VIT_BATCH = 128  # a card's share of DeiT-B's 1024 images over 8 GPUs
VIT_STEPS = 10   # timed ViT steps, after TRAIN_WARMUP
VIT_ATTN = dict(b=VIT_BATCH, h=12, hkv=12, s=197, d=64)  # ViT-B/16's


def _vit_run(cfg, images, labels, fused: bool) -> dict:
    """make_vit_train_step under one backward choice: TRAIN_WARMUP + VIT_STEPS
    steps with the counts reset right before and read right after, then one
    profiled step."""
    import gc

    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        peak_flops,
        vit_train_flops,
    )
    from ray_tpu_torch.train import adamw_lowmem, make_vit_train_step

    torch.cuda.reset_peak_memory_stats()
    step, init, shard = make_vit_train_step(
        cfg, optimizer=adamw_lowmem(3e-4, weight_decay=0.1), seed=SEED,
        device="cuda")
    state = init()
    img, lab = shard(images), shard(labels)
    counters = _counters()
    with backward_choice(fused):
        for c in counters.values():
            c.launches = 0  # count this run's steps only
        losses = []
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, img, lab)
            losses.append(m["loss"])
        gc.collect()
        gc.freeze()
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(VIT_STEPS + 1)]
        t0 = time.perf_counter()
        marks[0].record()
        for i in range(VIT_STEPS):
            state, m = step(state, img, lab)
            marks[i + 1].record()
            losses.append(m["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / VIT_STEPS
        launches = {k: c.launches for k, c in counters.items()}
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
        state, prof = profile_steps(step, state, img, lab, 1, step_s,
                                    counters)
        gc.unfreeze()
    steps = TRAIN_WARMUP + VIT_STEPS
    per_step = {k: n / steps for k, n in launches.items()}
    want = predicted_launches(False, cfg.num_layers, split=not fused)
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"ViT launches per step {per_step} != the "
                             f"prediction {want}")
    loss_vals = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"ViT losses not finite: {loss_vals}")
    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    flops = vit_train_flops(cfg, VIT_BATCH)
    res = {"launches": launches, "launches_per_step": per_step,
           "step_ms": step_s * 1e3, "step_ms_events": step_ms,
           "images_per_s": VIT_BATCH / step_s,
           "mfu": flops / step_s / rate, "tflop_per_step": flops / 1e12,
           "peak_gib": peak, "losses": loss_vals, **prof}
    print(f"{'fused (K3)' if fused else 'split (K4 + K5)'} backward: "
          f"{VIT_STEPS} timed steps after {TRAIN_WARMUP} warm-up, whole "
          f"window on the host clock: {res['step_ms']:.2f} ms a step, "
          f"{res['images_per_s']:.1f} images/s, MFU {100 * res['mfu']:.2f}% "
          f"({flops / 1e12:.3f} TFLOP a step, vit_train_flops); per step "
          f"between CUDA events {_spread(step_ms)} ms; peak device memory "
          f"{peak:.3f} GiB; launches per step " + ", ".join(
              f"{k} {v:g}" for k, v in per_step.items() if v)
          + "; loss " + " ".join(f"{x:.4f}" for x in loss_vals))
    del state
    torch.cuda.empty_cache()
    return res


def _vit_attn_times() -> dict:
    """K2, K3, K4, K5 at ViT-B/16's attention (B128 H12 S197 D64,
    non-causal, bf16): first each against its plain twin and K4/K5 run
    twice (bit-identical), then timed beside non-causal
    scaled_dot_product_attention's forward and its backward alone, and
    each kernel's bound."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as att

    m = VIT_ATTN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    q, k, v, do = _flash_inputs(gen, m["b"], m["h"], m["hkv"], m["s"],
                                m["d"])
    label = "ViT-B/16's attention"
    worst = dict.fromkeys(("flash_fwd", "flash_bwd", "flash_bwd_dq",
                           "flash_bwd_dkv", "flash_bwd_dq rel",
                           "flash_bwd_dkv rel"), 0.0)
    errs = {**_flash_check(q, k, v, do, False, label, worst),
            **{f"split {n}": e for n, e in _split_check(
                q, k, v, do, False, label, worst).items()}}
    scale = m["d"] ** -0.5
    out, lse = att.flash_fwd_cuda(q, k, v, False, scale)
    delta = (do.float() * out.float()).sum(-1)
    runs = [(att.flash_bwd_dq_cuda(q, k, v, do, lse, delta, False, scale),
             *att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, False, scale))
            for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"K4/K5 at {label}: two launches on the same "
                             f"inputs differ")
    del runs
    print(f"K2, K3, K4, K5 (K3 and K4/K5 on the twin's residuals) == their "
          f"plain twins at {label} (B128 H12 S197 D64 non-causal bf16); max "
          f"abs err " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tolerance {FLASH_REL_TOL} of the largest value, lse "
          f"{FLASH_LSE_TOL}); K4/K5 bit-identical on repeat")
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qg, kg, vg)
    lib_bwd = events_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), 20)
    del o_lib
    ms = {"flash_fwd": (events_ms(lambda: att.flash_fwd_cuda(
              q, k, v, False, scale), 20),
              events_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)),
          "flash_bwd": (events_ms(lambda: att.flash_bwd_cuda(
              q, k, v, out, lse, do, False, scale), 20), lib_bwd),
          "flash_bwd_dq": (events_ms(lambda: att.flash_bwd_dq_cuda(
              q, k, v, do, lse, delta, False, scale), 20), lib_bwd),
          "flash_bwd_dkv": (events_ms(lambda: att.flash_bwd_dkv_cuda(
              q, k, v, do, lse, delta, False, scale), 20), lib_bwd)}
    split_ms = events_ms(lambda: att.flash_bwd_split_cuda(
        q, k, v, out, lse, do, False, scale), 20)
    bounds = {**{k_: v_[:2] for k_, v_ in flash_bounds(
        m["b"], m["h"], m["hkv"], m["s"], m["d"], causal=False).items()},
        **{k_: v_[:2] for k_, v_ in split_bounds(
            m["b"], m["h"], m["hkv"], m["s"], m["s"], m["d"],
            False).items()}}
    rows = {}
    for name, (t, lib) in ms.items():
        bound, by = bounds[name]
        rows[name] = {"ms": t, "library_ms": lib, "bound_ms": bound,
                      "bound_by": by, "max_abs_err": worst[name]}
        if name in ("flash_bwd_dq", "flash_bwd_dkv"):
            rows[name]["split_total_ms"] = split_ms
        print(f"{name} at ViT-B/16's attention (B128 H12 S197 D64 non-causal "
              f"bf16): kernel {t:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"non-causal scaled_dot_product_attention "
              f"{'forward' if name == 'flash_fwd' else 'backward alone'} "
              f"{lib:.4f} ms")
    split = ms["flash_bwd_dq"][0] + ms["flash_bwd_dkv"][0]
    k3 = ms["flash_bwd"][0]
    print(f"at ViT-B/16's attention: K4 + K5 {split:.4f} ms with delta "
          f"given (rep 1: no fold); whole backwards through their wrappers "
          f"(delta, buffers, casts): split {split_ms:.4f} ms against K3 "
          f"{k3:.4f} ms ({split_ms / k3:.2f}x) and SDPA's backward alone "
          f"{lib_bwd:.4f} ms ({split_ms / lib_bwd:.2f}x)")
    return rows


# Limits on ViT-B/16's loss and each parameter's gradient through the
# kernels against plain attention (blockwise_attention: f32 scores and
# softmax, autograd) on the same params and batch: the loss relative, each
# gradient its error's norm over its norm. On an H100 the loss read 6.2e-5
# and the gradients 6.6e-3 to 1.7e-2, but wq and wk 4.6e-2 under either
# backward (the flash contract rounds p and ds to bf16; the plain path
# keeps them in f32). The limits are about 3x the worst readings.
VIT_PLAIN_LOSS_TOL = 2e-4
VIT_PLAIN_GRAD_TOL = 0.15


def vit_grads_check(cfg, images, labels) -> dict:
    """ViT-B/16's loss and every parameter's gradient at the trainer's
    batch, from seeded params: the split backward against the fused one
    (``split_against_fused``), then each against plain attention."""
    import torch
    from ray_tpu_torch._device import tree_leaves, tree_map
    from ray_tpu_torch.models.vit import init_params, loss_fn

    params = tree_map(lambda t: t.requires_grad_(),
                      init_params(cfg, generator=SEED, device="cuda"))
    img = torch.as_tensor(images, device="cuda")
    lab = torch.as_tensor(labels, device="cuda")
    leaves, names = tree_leaves(params), list(_leaf_names(params))
    check = split_against_fused(lambda: loss_fn(cfg, params, img, lab),
                                params)
    check_split(check, f"ViT-B/16 b{VIT_BATCH}")
    plain_loss, plain = _loss_grads(lambda: loss_fn(
        cfg, params, img, lab, attn_impl="blockwise"), leaves)
    errs = {}
    for name, fused in (("fused", True), ("split", False)):
        with backward_choice(fused):
            errs[name] = _grad_errs(names, _loss_grads(
                lambda: loss_fn(cfg, params, img, lab), leaves)[1], plain)
    loss_rel = abs(check["ref_loss"] - plain_loss) / abs(plain_loss)
    print(f"ViT-B/16 b{VIT_BATCH} through the kernels against plain "
          f"attention (blockwise_attention, f32 scores, autograd) on the "
          f"same params and batch: loss {check['ref_loss']!r} vs "
          f"{plain_loss!r} ({loss_rel:.3e} relative, limit "
          f"{VIT_PLAIN_LOSS_TOL}); each parameter's gradient error over its "
          f"norm (limit {VIT_PLAIN_GRAD_TOL}; fused, split): " + ", ".join(
              f"{n} {errs['fused'][n]:.3e}, {errs['split'][n]:.3e}"
              for n in names))
    bad = {(k, n): e for k, d in errs.items() for n, e in d.items()
           if not e < VIT_PLAIN_GRAD_TOL}
    if bad or not loss_rel <= VIT_PLAIN_LOSS_TOL:
        raise AssertionError(f"ViT-B/16 gradients off plain attention's: "
                             f"loss {loss_rel:.3e} relative, {bad}")
    del params, plain
    torch.cuda.empty_cache()
    return {"split_vs_fused": check, "plain_loss": plain_loss,
            "plain_grad_errs": errs}


def phase_vit():
    from dataclasses import replace

    import numpy as np
    from ray_tpu_torch.models.vit import ViTConfig

    cfg = replace(ViTConfig.base16(), dtype="bfloat16")
    _phase(f"ViT-B/16 train: {cfg.num_params() / 1e6:.1f}M params, 224 px, "
           f"patch 16, b{VIT_BATCH}, remat none, adamw_lowmem, seeded "
           f"random weights, images and labels; fused then split backward")
    rng = np.random.default_rng(SEED + 5)
    images = rng.uniform(0, 1, (VIT_BATCH, cfg.image_size, cfg.image_size,
                                cfg.num_channels)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, VIT_BATCH)
    runs = {"fused": _vit_run(cfg, images, labels, True),
            "split": _vit_run(cfg, images, labels, False)}
    first = [runs[k]["losses"][0] for k in ("fused", "split")]
    if first[0] != first[1]:
        raise AssertionError(f"ViT first losses differ: {first}")
    print(f"first losses bit-equal: {first[0]!r}; split step "
          f"{runs['split']['step_ms'] / runs['fused']['step_ms']:.3f}x the "
          f"fused step")
    runs["grads"] = vit_grads_check(cfg, images, labels)
    runs["attention"] = _vit_attn_times()
    return runs


# Limit on each parameter's gradient of the small ViT, card (kernels)
# against CPU (twins), its error's norm over its norm: on an H100 the
# readings were 3.1e-3 to 1.16e-2 under either backward.
VIT_XDEV_GRAD_TOL = 5e-2


def phase_cross_device_vit():
    import math

    import numpy as np
    import torch
    from ray_tpu_torch._device import tree_leaves, tree_map
    from ray_tpu_torch.models.vit import ViTConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.train import adamw_lowmem, make_vit_train_step

    _phase("cross-device: bf16 ViT trainer, CUDA kernels vs CPU plain twins,"
           " fused and split backward")
    # head_dim 64, 65 tokens (64 patches + the class token).
    cfg = ViTConfig(image_size=32, patch_size=4, hidden_size=128,
                    intermediate_size=256, num_layers=2, num_heads=2,
                    num_classes=10, dtype="bfloat16")
    params = init_params(cfg, generator=9, device="cpu")
    rng = np.random.default_rng(SEED + 8)
    images = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, 8)
    # Tolerances (bf16 end to end; matmul outputs round apart where the two
    # devices sum in other orders): losses within 1e-2 relative; each
    # parameter's gradient from one forward + backward, its error's norm
    # over its norm, within VIT_XDEV_GRAD_TOL.
    names = list(_leaf_names(params))
    for fused in (True, False):
        kern = att.flash_bwd_cuda if fused else att.flash_bwd_dq_cuda
        before = kern.launches
        losses, grads = {}, {}
        with backward_choice(fused):
            for dev in ("cuda", "cpu"):
                leaves = tree_map(
                    lambda t: t.to(dev).clone().requires_grad_(), params)
                grads[dev] = [g.cpu() for g in _loss_grads(
                    lambda: loss_fn(cfg, leaves,
                                    torch.from_numpy(images).to(dev),
                                    torch.from_numpy(labels).to(dev)),
                    tree_leaves(leaves))[1]]
                step, init, shard = make_vit_train_step(
                    cfg, optimizer=adamw_lowmem(1e-3, weight_decay=0.1),
                    device=dev)
                state = init(params)
                losses[dev] = [float(step(state, shard(images),
                                          shard(labels))[1]["loss"])
                               for _ in range(3)]
        if kern.launches - before != 4 * cfg.num_layers:
            raise AssertionError(f"the card's ViT loss and trainer launched "
                                 f"{kern.launches - before} backward kernels,"
                                 f" want {4 * cfg.num_layers}")
        for a, b in zip(losses["cuda"], losses["cpu"]):
            if not (math.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)):
                raise AssertionError(f"ViT loss trajectories differ: "
                                     f"{losses}")
        errs = _grad_errs(names, grads["cuda"], grads["cpu"])
        print(f"{'fused' if fused else 'split'} backward: losses cuda "
              f"{['%.5f' % x for x in losses['cuda']]} vs cpu "
              f"{['%.5f' % x for x in losses['cpu']]} (within 1e-2 "
              f"relative); each parameter's gradient, card vs CPU, error "
              f"over its norm (limit {VIT_XDEV_GRAD_TOL}): " + ", ".join(
                  f"{n} {e:.3e}" for n, e in errs.items()))
        bad = {n: e for n, e in errs.items() if not e < VIT_XDEV_GRAD_TOL}
        if bad:
            raise AssertionError(f"ViT gradients, card vs CPU: {bad}")


def phase_cross_device_train():
    import math

    import numpy as np
    import torch
    from ray_tpu_torch._device import tree_map
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    _phase("cross-device: bf16 trainer, CUDA kernels vs CPU plain twins")
    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                      max_seq_len=256, dtype="bfloat16")
    params = init_params(cfg, generator=7, device="cpu")
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (2, 256), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    # Tolerances (bf16 end to end; matmul outputs round apart where the two
    # devices sum in other orders): losses within 1e-2 relative; norm
    # weight gradients within 5e-2 of their largest value.
    losses, norm_grads = {}, {}
    fwd0 = att.flash_fwd_cuda.launches
    for dev in ("cuda", "cpu"):
        leaves = tree_map(lambda t: t.to(dev).clone().requires_grad_(),
                          params)
        tok = torch.from_numpy(tokens).to(dev)
        tgt = torch.from_numpy(targets).to(dev)
        loss_fn(cfg, leaves, tok, tgt, remat="attn+").backward()
        norm_grads[dev] = {
            "attn_norm": leaves["layers"]["attn_norm"].grad,
            "mlp_norm": leaves["layers"]["mlp_norm"].grad,
            "final_norm": leaves["final_norm"].grad}
        step, init, shard = make_llama_train_step(
            cfg, optimizer=adamw_lowmem(1e-3, weight_decay=0.1),
            remat="attn+", device=dev)
        state = init(params)
        losses[dev] = [float(step(state, tok, tgt)[1]["loss"])
                       for _ in range(3)]
    if att.flash_fwd_cuda.launches == fwd0:
        raise AssertionError("the card's trainer launched no flash kernel")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)):
            raise AssertionError(f"loss trajectories differ: {losses}")
    worst = 0.0
    for name, want in norm_grads["cpu"].items():
        got = norm_grads["cuda"][name]
        if got is None or not got.float().abs().sum().item() > 0:
            raise AssertionError(f"{name}: no gradient on the card")
        err = ((got.cpu().float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        if not err < 5e-2:
            raise AssertionError(f"{name} gradient: card vs CPU {err:.3e} "
                                 f"of the largest value (> 5e-2)")
        worst = max(worst, err)
    print(f"losses cuda {['%.5f' % x for x in losses['cuda']]} vs cpu "
          f"{['%.5f' % x for x in losses['cpu']]} (within 1e-2 relative); "
          f"norm weight gradients non-zero on the card, worst "
          f"{worst:.3e} of the largest value off the CPU's (< 5e-2)")


# Phase 13: data-parallel training at Llama-3-8B width on one card, through
# the step factory's multi-rank paths over a one-rank NCCL mesh.
P13_LAYERS = 8          # depth cut: 32 layers need ~80 GB of moments alone
P13_BATCH, P13_SEQ = 4, 2048
P13_WARMUP, P13_STEPS = 2, 3
P13_MODES = {  # label -> (what, mesh kind, step options)
    "a": ("mesh=None", None, {}),
    "b": ("flat over a one-rank NCCL mesh", "build", {}),
    "c": ("zero1", "build", {"zero1": True}),
    "d": ("zero1 + grad_accum=2 + grad_norm_every=2", "build",
          {"zero1": True, "grad_accum": 2, "grad_norm_every": 2}),
    "e": ("hybrid_mesh(dp=1, dcn dp) + zero1 + int8", "hybrid",
          {"zero1": True, "dcn_axes": ("dp",), "dcn_quant": "int8"}),
    "f": ("default rules on a one-rank MeshSpec(fsdp=1) mesh: the "
          "param-shard plan (FSDP gathers, tp conjugates, vocabulary-"
          "parallel embedding and loss on one-rank groups)", "build",
          {"rules": {}}),
    "g": ("tp-only rules (embed replicated) on a one-rank MeshSpec(tp=1) "
          "mesh: column/row-parallel products, vocabulary-parallel "
          "embedding and loss, no FSDP gather", "build",
          {"rules": {"embed": None}}),
}
# Limits on each loss against run (a)'s, absolute (the losses run 9-12).
# (b), (c), (f) and (g) do (a)'s arithmetic (a one-rank reduce or gather
# is a copy, a logsumexp over one rank's is exact; the optimizer is
# elementwise), and K3 sums dq across CTAs in a fixed order, so each must
# give (a)'s losses bit for bit at every step, as (a) run again must
# (when K3 summed dq with f32 atomics, two runs of (a) differed by up to
# 3.6e-3 by step 3 and this limit was 1e-2). Under the split backward (K4 + K5)
# (b) and (c) must also give (a)'s losses bit for bit, P13_DET_STEPS steps
# each. (d) sums two microbatches' bf16 gradients (other GEMM shapes,
# another rounding). (e) rounds every gradient to int8 per 256 elements:
# an element far below its bucket's largest moves by up to half a step of
# that scale, and adam, which normalizes each element, turns that into a
# different update for it (JAX documents a ~1e-2 drift on its tiny model;
# here 4.4e-2 by step 3 in the first run). The first loss, before any
# update, must be bit-equal in every mode but (d).
P13_SAME_TOL = 0.0
P13_ACCUM_TOL = 2e-2
P13_QUANT_TOL = 1e-1
P13_DET_STEPS = 3
# DDP rules: params replicated on every axis. A mode's "rules" option
# overrides the default table instead ({} is the default table itself).
DDP_RULES = dict(vocab=None, embed=None, mlp=None, heads=None,
                 kv_heads=None)


def cfg_8b(layers: int):
    """Llama-3-8B's published geometry (vocab 128256, hidden 4096, MLP
    14336, 32/8 heads of 128, untied, rope theta 500000), depth cut to
    ``layers``."""
    from dataclasses import replace

    from ray_tpu_torch.models.llama import LlamaConfig

    return replace(LlamaConfig.llama3_8b(), num_layers=layers,
                   max_seq_len=P13_SEQ)


def _opt_bytes(state) -> int:
    from ray_tpu_torch._device import tree_leaves

    return sum(t.numel() * t.element_size()
               for t in tree_leaves(state.opt_state)
               if hasattr(t, "element_size"))


def train_run(cfg, mesh, params, tokens, opts: dict, warmup: int,
              steps: int, counters=None, profile: bool = False,
              lr: float = 3e-4) -> dict:
    """``warmup`` + ``steps`` steps of make_llama_train_step (bf16, remat
    attn+, adamw_lowmem at ``lr``) from a copy of ``params`` over ``mesh`` on the
    global batch ``tokens``, with DDP rules unless ``opts`` holds "rules"
    (overrides of the default table); counts reset right before the first
    step and read right after the last. Returns the losses, grad norms,
    step times, peak memory over the steps (from the built state on) and
    moments' bytes on this rank (and a profiler split of one more step
    with ``profile``)."""
    import numpy as np
    import torch
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    torch.cuda.empty_cache()
    opts = dict(opts)
    rules = ShardingRules().override(**opts.pop("rules", DDP_RULES))
    step, init, shard = make_llama_train_step(
        cfg, mesh, rules=rules,
        optimizer=adamw_lowmem(lr, weight_decay=0.1), attn_impl="flash",
        remat="attn+", seed=SEED,
        device=torch.device("cuda", torch.cuda.current_device()), **opts)
    return timed_steps(step, init, params, shard(tokens),
                       shard(np.roll(tokens, -1, axis=1)), warmup, steps,
                       counters, profile)


def timed_steps(step, init, params, tok, tgt, warmup: int, steps: int,
                counters=None, profile: bool = False,
                quiet: bool = False, finish=None) -> dict:
    """``init(params)``, then ``warmup`` + ``steps`` steps of ``step`` on
    (``tok``, ``tgt``), the counts reset right before the first step and
    read right after the last; ``train_run``'s readings (and a profiler
    split of one more step with ``profile``, printed unless ``quiet``,
    and ``finish(state)``'s readings). The state dies here."""
    import gc

    import torch

    state = init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (counters or {}).values():
        c.launches = 0
    losses, norms = [], []
    for _ in range(warmup):
        state, m = step(state, tok, tgt)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(steps):
        state, m = step(state, tok, tgt)
        marks[i + 1].record()
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    out = {"losses": [float(x) for x in losses],
           "norms": [float(x) for x in norms], "step_ms": step_s * 1e3,
           "step_ms_events": [a.elapsed_time(b)
                              for a, b in zip(marks, marks[1:])],
           "launches": {k: c.launches for k, c in (counters or {}).items()},
           "peak_gib": torch.cuda.max_memory_allocated() / 2.0 ** 30,
           "moments_gib": _opt_bytes(state) / 2.0 ** 30,
           "rows": int(tok.shape[0])}
    if profile:
        state, out["profile"] = profile_steps(step, state, tok, tgt, 1,
                                              step_s, counters, quiet)
    if finish is not None:
        out.update(finish(state))
    gc.unfreeze()
    del state
    torch.cuda.empty_cache()
    return out


def _rates(cfg, rows: int, step_ms: float) -> tuple[float, float]:
    """(tokens/s, MFU) of one card taking ``rows`` rows of P13_SEQ tokens a
    step."""
    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        llama_train_flops,
        peak_flops,
    )

    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    if not rate:
        raise AssertionError("no peak rate for this card in "
                             "ray_tpu_torch/accelerators/flops.py")
    s = step_ms / 1e3
    return rows * P13_SEQ / s, llama_train_flops(cfg, rows, P13_SEQ) / s / rate


def _check_losses(label: str, got: list, want: list, tol: float,
                  first_equal: bool) -> None:
    diff = max(abs(a - b) for a, b in zip(got, want))
    if not all(math.isfinite(x) for x in got) or diff > tol or (
            first_equal and got[0] != want[0]):
        raise AssertionError(f"{label}: losses {got} against {want}: worst "
                             f"{diff:.3e} (limit {tol}), first bit-equal "
                             f"required: {first_equal}")


def phase_train_8b() -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh
    from ray_tpu_torch.train.backend import free_port, init_distributed

    _phase(f"data-parallel train at Llama-3-8B width ({P13_LAYERS} of 32 "
           f"layers), b{P13_BATCH} s{P13_SEQ}, bf16, remat attn+, "
           f"adamw_lowmem: seven modes of the step factory, one rank")
    cfg = cfg_8b(P13_LAYERS)
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        meshes = {"build": build_mesh(MeshSpec()),
                  "hybrid": hybrid_mesh(MeshSpec(dp=1, dcn_axes=("dp",)),
                                        1, 1)}
        params = init_params(cfg, generator=SEED, device="cuda")
        tokens = np.random.default_rng(SEED + 5).integers(
            0, cfg.vocab_size, (P13_BATCH, P13_SEQ), dtype=np.int32)
        print(f"{cfg.num_params() / 1e9:.3f}B params (vocab "
              f"{cfg.vocab_size}, hidden {cfg.hidden_size}, MLP "
              f"{cfg.intermediate_size}, heads {cfg.num_heads}/"
              f"{cfg.num_kv_heads} of {cfg.head_dim}, untied, rope theta "
              f"{cfg.rope_theta:g}); the process group: NCCL, world "
              f"{dist.get_world_size()}")
        counters = _counters()
        runs = {}
        for key, (what, kind, opts) in P13_MODES.items():
            runs[key] = train_run(cfg, meshes[kind] if kind else None,
                                  params, tokens, opts, P13_WARMUP,
                                  P13_STEPS, counters, profile=key == "c")
            r = runs[key]
            accum = opts.get("grad_accum", 1)
            want = {k: float(v * accum) for k, v in predicted_launches(
                "attn+", cfg.num_layers).items()}
            per_step = {k: n / (P13_WARMUP + P13_STEPS)
                        for k, n in r["launches"].items()}
            if per_step != want:
                raise AssertionError(f"({key}) launches per step {per_step}"
                                     f" != the prediction {want}")
            r["tokens_per_s"], r["mfu"] = _rates(cfg, P13_BATCH,
                                                 r["step_ms"])
            print(f"({key}) {what}: {r['step_ms']:.2f} ms a step "
                  f"({_spread(r['step_ms_events'])} between CUDA events), "
                  f"{r['tokens_per_s']:.1f} tokens/s, MFU "
                  f"{100 * r['mfu']:.2f}%, peak {r['peak_gib']:.3f} GiB, "
                  f"moments {r['moments_gib']:.3f} GiB; loss "
                  + " ".join(f"{x:.6f}" for x in r["losses"])
                  + "; grad_norm " + " ".join(f"{x:.4f}" for x in r["norms"])
                  + "; launches per step " + ", ".join(
                      f"{k} {v:g}" for k, v in per_step.items() if v))
        a = runs["a"]["losses"]
        # (a) again: K3 sums dq in a fixed order, so the same bits.
        runs["a2"] = train_run(cfg, None, params, tokens, {}, P13_WARMUP,
                               P13_STEPS)
        for key in ("a2", "b", "c", "f", "g"):
            got = runs[key]["losses"]
            runs[key]["bit_equal"] = [x == y for x, y in zip(got, a)]
            print(f"({key}) against (a): losses bit-equal step by step "
                  f"{runs[key]['bit_equal']}, worst "
                  f"{max(abs(x - y) for x, y in zip(got, a)):.3e} (limit "
                  f"{P13_SAME_TOL})"
                  + (" ((a) run again)" if key == "a2" else ""))
            _check_losses(f"({key})", got, a, P13_SAME_TOL, True)
        # Under the split backward every run repeats bit for bit, so (b)
        # and (c) must be (a) exactly: the one-rank collectives and the
        # 1-D pieces change no bit.
        det = {}
        with backward_choice(False):
            for key in "abc":
                det[key] = train_run(
                    cfg, meshes[P13_MODES[key][1]] if P13_MODES[key][1]
                    else None, params, tokens, P13_MODES[key][2], 0,
                    P13_DET_STEPS)["losses"]
        print(f"split backward, {P13_DET_STEPS} steps: (a) "
              + " ".join(f"{x:.6f}" for x in det["a"])
              + f"; (b) bit-equal {det['b'] == det['a']}, (c) bit-equal "
              f"{det['c'] == det['a']}")
        if not det["a"] == det["b"] == det["c"]:
            raise AssertionError(f"under the split backward (b)/(c) are not "
                                 f"(a) bit for bit: {det}")
        _check_losses("(d)", runs["d"]["losses"], a, P13_ACCUM_TOL, False)
        norms = runs["d"]["norms"]
        if norms[1::2] != [-1.0] * len(norms[1::2]) or min(norms[::2]) <= 0:
            raise AssertionError(f"(d) grad_norm_every=2: norms {norms}")
        _check_losses("(e)", runs["e"]["losses"], a, P13_QUANT_TOL, True)
        if runs["e"]["losses"][1] == a[1]:
            raise AssertionError("(e): int8 gradients left step 2's loss "
                                 "bit-equal to (a)'s")
        for key in "bcdefg":
            runs[key]["overhead"] = runs[key]["step_ms"] / runs["a"][
                "step_ms"] - 1
        print("step time against (a): " + ", ".join(
            f"({k}) {100 * runs[k]['overhead']:+.2f}%" for k in "bcdefg"))
        del params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"layers": cfg.num_layers, "params": cfg.num_params(),
            "runs": runs, "split_backward_losses": det}


# The ranks' losses against phase 13's (a), absolute: flat and zero1 sum
# each rank's bf16 gradients (another rounding than one card's whole-batch
# gradient), tp sums the ranks' bf16 partial products (row-parallel
# outputs, the norms' input gradients); the int8 mode takes P13_QUANT_TOL,
# as (e) does.
P13B_TOL = 2e-2
# The most device memory a rank took training Llama-3-8B at full depth
# under zero1 in this phase (the "full" mode) on four NVIDIA H100 80GB
# HBM3, 700.00 W, when no FSDP existed: the full model under FSDP must
# stay below it.
ZERO1_FULL_PEAK_GIB = 41.977
TRAIN_RANKS_TIMEOUT_S = 900


def _rank_train(rank: int, world: int, store: str, out_path: str,
                port: int) -> None:
    """One rank of ``phase_train_ranks`` on card ``rank``; rank 0 writes
    the readings (each rank's peak memory and moments included)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, hybrid_mesh
    from ray_tpu_torch.train.backend import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    counters = _counters()
    res = {}
    cfg = cfg_8b(P13_LAYERS)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (P13_BATCH, P13_SEQ), dtype=np.int32)
    params = init_params(cfg, generator=SEED, device="cuda")
    hybrid = MeshSpec(dp=2, fsdp=world // 2, dcn_axes=("dp",))
    modes = {"flat": (build_mesh(MeshSpec(dp=world)), {}),
             "zero1": (build_mesh(MeshSpec(dp=world)), {"zero1": True}),
             "hybrid_zero1_int8": (hybrid_mesh(hybrid, 2, world // 2),
                                   {"zero1": True, "dcn_axes": ("dp",),
                                    "dcn_quant": "int8"}),
             # Tensor parallel under the default rules: H/tp heads a rank,
             # every rank on the whole batch.
             f"tp{world}": (build_mesh(MeshSpec(tp=world)), {"rules": {}})}
    if world == 4:
        modes["dp2tp2"] = (build_mesh(MeshSpec(dp=2, tp=2)), {"rules": {}})
    for name, (mesh, opts) in modes.items():
        r = train_run(cfg, mesh, params, tokens, opts, P13_WARMUP,
                      P13_STEPS, counters)
        peaks = [None] * world
        dist.all_gather_object(peaks, (r["peak_gib"], r["moments_gib"]))
        r["per_rank_peak_gib"] = [p for p, _ in peaks]
        r["per_rank_moments_gib"] = [m for _, m in peaks]
        r["tp"] = int(mesh.size(mesh.mesh_dim_names.index("tp")))
        res[name] = r
    del params
    torch.cuda.empty_cache()
    # The full model where it fits (see phase_train_ranks): under zero1,
    # then under FSDP (default rules, fsdp = world).
    layers = 32 if world >= 4 else 16
    cfg = cfg_8b(layers)
    tokens = np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (world, P13_SEQ), dtype=np.int32)
    for name, mesh, opts in (
            ("full", build_mesh(MeshSpec(dp=world)), {"zero1": True}),
            ("full_fsdp", build_mesh(MeshSpec(fsdp=world)), {"rules": {}})):
        r = train_run(cfg, mesh, None, tokens, opts, P13_WARMUP, P13_STEPS,
                      counters)
        peaks = [None] * world
        dist.all_gather_object(peaks, (r["peak_gib"], r["moments_gib"]))
        r["per_rank_peak_gib"] = [p for p, _ in peaks]
        r["per_rank_moments_gib"] = [m for _, m in peaks]
        r["layers"], r["params"] = layers, cfg.num_params()
        res[name] = r
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def phase_train_ranks(world: int, one_card: dict) -> dict:
    """Phase 13b: the step factory over ``world`` NCCL ranks, one card
    each: phase 13's 8-layer model at its global b4 s2048 under flat,
    zero1, a two-slice hybrid mesh (dcn dp, zero1, int8) and, under the
    default rules, tp = world (and dp2 x tp2 on four cards), losses against
    phase 13's one-card (a); then Llama-3-8B at full depth at b1 s2048 a
    rank under zero1 and under FSDP (fsdp = world, default rules), whose
    per-rank peak must stay below zero1's (16 layers below four cards: 32
    would not fit)."""
    import tempfile

    from ray_tpu_torch._spawn import run_ranks
    from ray_tpu_torch.train.backend import free_port

    _phase(f"data-parallel train over {world} ranks, one card each")
    a = one_card["runs"]["a"]["losses"]
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank_train, world, tmp,
                  (out_path, free_port()), TRAIN_RANKS_TIMEOUT_S)
        with open(out_path) as f:
            res = json.load(f)
    for name, r in res.items():
        cfg = cfg_8b(r.get("layers", P13_LAYERS))
        # A tp group's cards share its rows: a card's share is rows / tp.
        r["tokens_per_s_per_card"], r["mfu"] = _rates(
            cfg, r["rows"] / r.get("tp", 1), r["step_ms"])
        print(f"{name} ({cfg.num_layers} layers, {r['rows']} rows a rank, "
              f"tp {r.get('tp', 1)}): "
              f"{r['step_ms']:.2f} ms a step on rank 0's host clock, "
              f"{r['tokens_per_s_per_card']:.1f} tokens/s per card, MFU "
              f"{100 * r['mfu']:.2f}%; peak GiB per rank "
              f"{[round(p, 3) for p in r['per_rank_peak_gib']]}, moments "
              f"GiB per rank {[round(m, 3) for m in r['per_rank_moments_gib']]}"
              f"; loss " + " ".join(f"{x:.6f}" for x in r["losses"]))
        if name.startswith("full"):
            if not all(math.isfinite(x) for x in r["losses"]):
                raise AssertionError(f"{name} model losses {r['losses']}")
            continue
        _check_losses(f"{name} over {world} ranks", r["losses"], a,
                      P13_QUANT_TOL if "int8" in name else P13B_TOL, False)
    fsdp_peak = max(res["full_fsdp"]["per_rank_peak_gib"])
    print(f"full model: FSDP's most memory a rank took {fsdp_peak:.3f} GiB "
          f"against zero1's {max(res['full']['per_rank_peak_gib']):.3f} GiB "
          f"in this run (the recorded zero1 reading {ZERO1_FULL_PEAK_GIB} "
          f"GiB)")
    if world >= 4 and not fsdp_peak < ZERO1_FULL_PEAK_GIB:
        raise AssertionError(f"FSDP full model peak {fsdp_peak:.3f} GiB a "
                             f"rank, not below zero1's {ZERO1_FULL_PEAK_GIB}")
    flat_m = res["flat"]["per_rank_moments_gib"][0]
    for name in ("zero1", "hybrid_zero1_int8"):
        m = max(res[name]["per_rank_moments_gib"])
        if not m <= flat_m / world * 1.01:
            raise AssertionError(f"{name}: moments {m} GiB a rank, flat "
                                 f"{flat_m} over {world} ranks")
    return res


# Phase 14: GPipe pipeline training at phase 13's Llama-3-8B width and
# depth cut, through parallel.pipeline.make_pp_train_step.
P14_MICRO = 4  # microbatches of the global b4, one row each
P14_WARMUP, P14_STEPS = 1, 3
# The first loss against make_llama_train_step(mesh=None, remat="none")'s
# on the same params and batch with the unfused head (loss_fn(fused_ce=
# False)), absolute (the loss runs ~12): the pipeline's products take one
# row at a time, so its bf16 activations round at other GEMM shapes than
# the whole batch's, and its head accumulates the bf16 products in f32
# where the reference multiplies the widened inputs in f32.
P14_REF_TOL = 2e-2
# The ranks' losses, step by step, against one card's pipeline, absolute:
# the stages' bf16 activations cross NCCL unchanged, but the dp ranks'
# bf16 gradients are summed (another rounding), and pp2 x dp2 runs two
# microbatches a rank.
P14B_TOL = 2e-2
PIPELINE_TIMEOUT_S = 600


def pipeline_run(cfg, mesh, params, tokens, micro: int, warmup: int,
                 steps: int, counters=None, profile: bool = False,
                 finish=None) -> dict:
    """``timed_steps`` of make_pp_train_step (flash attention, JAX's
    default adamw) over ``mesh`` with ``micro`` microbatches a rank."""
    import numpy as np
    import torch
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step

    torch.cuda.empty_cache()
    step, init, shard = make_pp_train_step(
        cfg, mesh, micro, attn_impl="flash", seed=SEED,
        device=torch.device("cuda", torch.cuda.current_device()))
    return timed_steps(step, init, params, shard(tokens),
                       shard(np.roll(tokens, -1, axis=1)), warmup, steps,
                       counters, profile, finish=finish)


def param_checksums(state) -> dict:
    """{"checksums": one exact integer per param leaf: the sum of its
    elements' bit patterns (as int16 or int32), in int64, chunk by
    chunk}. Equal bits give equal sums."""
    import torch
    from ray_tpu_torch.parallel.sharding import tree_paths

    out = []
    for _, p in tree_paths(state.params):
        t = p.detach().contiguous().view(-1)
        t = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out.append(int(sum(c.to(torch.int64).sum() for c in
                           t.split(1 << 26))))
    return {"checksums": out}


def bubble_share(pp: int, micro: int) -> float:
    """GPipe's idle share of a stage: (P - 1) / (M + P - 1)."""
    return (pp - 1) / (micro + pp - 1)


def phase_pipeline() -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import init_params, loss_fn
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train.backend import free_port, init_distributed

    _phase(f"pipeline (GPipe) train at Llama-3-8B width ({P13_LAYERS} of 32 "
           f"layers), b{P13_BATCH} s{P13_SEQ}, {P14_MICRO} microbatches, "
           f"bf16, no remat, JAX's default adamw: pp=1 on a one-rank NCCL "
           f"mesh")
    cfg = cfg_8b(P13_LAYERS)
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        params = init_params(cfg, generator=SEED, device="cuda")
        tokens = np.random.default_rng(SEED + 5).integers(
            0, cfg.vocab_size, (P13_BATCH, P13_SEQ), dtype=np.int32)
        tok = torch.as_tensor(tokens, device="cuda").long()
        with torch.no_grad():
            ref = float(loss_fn(cfg, params, tok, tok.roll(-1, 1),
                                attn_impl="flash", remat="none",
                                fused_ce=False))
        del tok
        torch.cuda.empty_cache()
        counters = _counters()
        r = pipeline_run(cfg, build_mesh(MeshSpec()), params, tokens,
                         P14_MICRO, P14_WARMUP, P14_STEPS, counters,
                         profile=True)
        want = {k: float(v * P14_MICRO) for k, v in predicted_launches(
            "none", cfg.num_layers).items()}
        per_step = {k: n / (P14_WARMUP + P14_STEPS)
                    for k, n in r["launches"].items()}
        if per_step != want:
            raise AssertionError(f"pipeline launches per step {per_step} "
                                 f"!= the prediction {want}")
        r["tokens_per_s"], r["mfu"] = _rates(cfg, P13_BATCH, r["step_ms"])
        r["bubble"] = bubble_share(1, P14_MICRO)
        diff = abs(r["losses"][0] - ref)
        print(f"pp=1, {P14_MICRO} microbatches: {r['step_ms']:.2f} ms a step "
              f"({_spread(r['step_ms_events'])} between CUDA events), "
              f"{r['tokens_per_s']:.1f} tokens/s, MFU {100 * r['mfu']:.2f}%, "
              f"peak {r['peak_gib']:.3f} GiB, moments "
              f"{r['moments_gib']:.3f} GiB, bubble {r['bubble']:.3f}; loss "
              + " ".join(f"{x:.6f}" for x in r["losses"])
              + "; grad_norm " + " ".join(f"{x:.4f}" for x in r["norms"])
              + "; launches per step " + ", ".join(
                  f"{k} {v:g}" for k, v in per_step.items() if v))
        print(f"first loss {r['losses'][0]:.6f} against mesh=None remat none "
              f"with the unfused head {ref:.6f}: {diff:.3e} (limit "
              f"{P14_REF_TOL})")
        if not all(math.isfinite(x) for x in r["losses"]) or \
                diff > P14_REF_TOL or not r["losses"][-1] < r["losses"][0]:
            raise AssertionError(f"pipeline losses {r['losses']} against "
                                 f"the reference's first {ref}")
        del params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"layers": cfg.num_layers, "ref_loss": ref, "run": r}


def _rank_pipeline(rank: int, world: int, store: str, out_path: str,
                   port: int, only=None) -> None:
    """One rank of ``phase_pipeline_ranks`` on card ``rank``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train.backend import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    counters = _counters()
    cfg = cfg_8b(P13_LAYERS)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (P13_BATCH, P13_SEQ), dtype=np.int32)
    params = init_params(cfg, generator=SEED, device="cuda")
    # name -> (mesh, microbatches a rank: one row each)
    modes = {"pp2": (MeshSpec(pp=2), P14_MICRO)} if world == 2 else {
        "pp2dp2": (MeshSpec(pp=2, dp=2), P14_MICRO // 2),
        "pp4": (MeshSpec(pp=4), P14_MICRO),
        # JAX's shard_map replicates the pipeline over another axis: each
        # coordinate of tp or fsdp runs its own replica pipeline.
        "pp2tp2": (MeshSpec(pp=2, tp=2), P14_MICRO),
        "pp2fsdp2": (MeshSpec(pp=2, fsdp=2), P14_MICRO)}
    res = {}
    for name, (spec, micro) in modes.items():
        if only and name not in only:
            continue
        replicated = spec.tp > 1 or spec.fsdp > 1
        r = pipeline_run(cfg, build_mesh(spec), params, tokens, micro,
                         P14_WARMUP, P14_STEPS, counters,
                         finish=param_checksums if replicated else None)
        peaks = [None] * world
        dist.all_gather_object(peaks, r["peak_gib"])
        if replicated:  # every rank's checksums and losses
            sums = [None] * world
            dist.all_gather_object(sums, (r.pop("checksums"),
                                          r["losses"]))
            r["rank_checksums"] = sums
        r.update(per_rank_peak_gib=peaks, pp=spec.pp, dp=spec.dp,
                 micro=micro, replica=spec.tp * spec.fsdp)
        res[name] = r
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def phase_pipeline_ranks(world: int, one_card: dict, only=None) -> dict:
    """Phase 14b: the pipeline over ``world`` NCCL ranks (2 or 4), one
    card each, at phase 14's model and global batch: pp2 on two cards
    (4 layers a stage); pp2 x dp2, pp4, pp2 x tp2 and pp2 x fsdp2 on four
    (the last two replicate the pipeline over tp or fsdp: the ranks of a
    stage along it must hold the same params, bit for bit). Losses step
    by step against phase 14's one card. ``only`` runs those modes
    alone."""
    import tempfile

    from ray_tpu_torch._spawn import run_ranks
    from ray_tpu_torch.train.backend import free_port

    _phase(f"pipeline train over {world} ranks, one card each")
    cfg = cfg_8b(P13_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank_pipeline, world, tmp,
                  (out_path, free_port(), only), PIPELINE_TIMEOUT_S)
        with open(out_path) as f:
            res = json.load(f)
    for name, r in res.items():
        r["bubble"] = bubble_share(r["pp"], r["micro"])
        r["tokens_per_s_per_card"], r["mfu"] = _rates(
            cfg, P13_BATCH / world, r["step_ms"])
        print(f"{name} ({cfg.num_layers // r['pp']} layers a stage, "
              f"{r['micro']} microbatches a rank, bubble "
              f"{r['bubble']:.3f}): {r['step_ms']:.2f} ms a step on rank 0's "
              f"host clock, {r['tokens_per_s_per_card']:.1f} tokens/s per "
              f"card, MFU {100 * r['mfu']:.2f}%; peak GiB per rank "
              f"{[round(p, 3) for p in r['per_rank_peak_gib']]}; loss "
              + " ".join(f"{x:.6f}" for x in r["losses"])
              + "; rank 0's launches " + ", ".join(
                  f"{k} {v}" for k, v in r["launches"].items() if v))
        _check_losses(f"{name} over {world} ranks", r["losses"],
                      one_card["run"]["losses"], P14B_TOL, False)
        if "rank_checksums" in r:
            # ranks r and r' of one stage differ only on the replica axis
            per = r["replica"]
            for first in range(0, world, per):
                group = r["rank_checksums"][first:first + per]
                if any(g != group[0] for g in group[1:]):
                    raise AssertionError(
                        f"{name}: ranks {first}-{first + per - 1} (one "
                        f"stage, replicas over tp/fsdp) differ in params "
                        f"or losses")
            print(f"{name}: the {per} ranks of each stage hold the same "
                  f"params (every leaf's bit checksum) and losses")
    return res


# Phase 15: Mixtral-8x7B's published widths, depth cut, through
# make_mixtral_train_step (one-hot dispatch, capacity routing).
P15_LAYERS = 2  # ~3.16B params: params, gradients and moments ~25 GB
P15_BATCH, P15_SEQ = 4, 2048  # T = 8192 tokens, capacity C = 2560
P15_WARMUP, P15_STEPS = 1, 3
P15_MODES = {  # label -> (what, on a one-rank mesh)
    "a": ("mesh=None", False),
    "b": ("default rules on a one-rank mesh: expert leaves over ep, FSDP "
          "gathers, tp conjugates, global routing's claim gather and the "
          "ep conjugates on one-rank groups", True),
}
# (b) does (a)'s arithmetic (every collective on a one-rank group is a
# copy), and K3 repeats bit for bit: (a)'s losses exactly, step by step.
P15_SAME_TOL = 0.0
P15B_LAYERS = 4
# The ranks' first loss against one card's mesh=None loss at the same
# depth, absolute: the ep ranks' bf16 partial combines are summed over ep
# (another rounding of each layer's output from layer 0's on).
P15B_TOL = 2e-2
# dp2 x ep2: layer 0's claims per expert against one card's, relative (its
# attention runs two rows a rank: other GEMM shapes may move a router
# logit's last bit, and a near-tie its top-2); ep alone: equal.
P15B_CLAIMS_TOL = 1e-2
MIXTRAL_TIMEOUT_S = 600


def cfg_mixtral(layers: int):
    """Mixtral-8x7B's published geometry (vocab 32000, hidden 4096, MLP
    14336, 32/8 heads of 128, 8 experts, top-2, capacity factor 1.25, rope
    theta 1e6), depth cut to ``layers``."""
    from dataclasses import replace

    from ray_tpu_torch.models.mixtral import MixtralConfig

    return replace(MixtralConfig.mixtral_8x7b(), num_layers=layers,
                   max_seq_len=P15_SEQ)


def _mixtral_rates(cfg, rows: float, step_ms: float) -> tuple:
    """(tokens/s, MFU over the active top-2 params) of a card taking
    ``rows`` rows of P15_SEQ tokens a step."""
    import torch
    from ray_tpu_torch.accelerators.flops import (
        generation_of,
        mixtral_train_flops,
        peak_flops,
    )

    rate = peak_flops(generation_of(torch.cuda.get_device_name(0)) or "")
    s = step_ms / 1e3
    return rows * P15_SEQ / s, \
        mixtral_train_flops(cfg, rows, P15_SEQ) / s / rate


def drop_rates(cfg, claims: list, tokens: int) -> list:
    """Each layer's share of claims past its expert's capacity."""
    c = cfg.capacity(tokens)
    return [1.0 - float(x.clamp(max=c).sum()) / float(x.sum())
            for x in claims]


def onehot_product_ms(cfg, tokens: int) -> dict:
    """Device ms a call (CUDA events) of the three forms of the one-hot
    products at a step's shapes ([T, E, C] against [T, H] or [E, C, H],
    bf16): the dispatch form (forward, and the combine's gradient into
    the expert outputs), the combine form (forward, and the dispatch's
    gradient into the tokens) and the combine weights' gradient."""
    import torch

    e, c, h = cfg.num_experts, cfg.capacity(tokens), cfg.hidden_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    onehot, x, y, dy = rnd(tokens, e, c), rnd(tokens, h), rnd(e, c, h), \
        rnd(tokens, h)
    forms = {"dispatch": lambda: torch.einsum("tec,th->ech", onehot, x),
             "combine": lambda: torch.einsum("tec,ech->th", onehot, y),
             "combine_grad": lambda: torch.einsum("th,ech->tec", dy, y)}
    return {k: events_ms(f, 10) for k, f in forms.items()}


def phase_mixtral() -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train import make_mixtral_train_step
    from ray_tpu_torch.train.backend import free_port, init_distributed

    cfg = cfg_mixtral(P15_LAYERS)
    t = P15_BATCH * P15_SEQ
    _phase(f"Mixtral train at 8x7B width ({P15_LAYERS} of 32 layers), "
           f"b{P15_BATCH} s{P15_SEQ} (T {t}, capacity {cfg.capacity(t)}), "
           f"bf16, remat full, the step factory's default adamw (bf16 "
           f"moments): mesh=None and the default rules on a one-rank mesh")
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        params = mixtral.init_params(cfg, generator=SEED, device="cuda")
        tokens = np.random.default_rng(SEED + 7).integers(
            0, cfg.vocab_size, (P15_BATCH, P15_SEQ), dtype=np.int32)
        claims = []
        with torch.no_grad():
            mixtral.forward_hidden(
                cfg, params, torch.as_tensor(tokens, device="cuda").long(),
                attn_impl="flash", remat=False, route_stats=claims)
        drops = drop_rates(cfg, claims, t)
        print(f"{cfg.num_params() / 1e9:.3f}B params "
              f"({cfg.num_params(active=True) / 1e9:.3f}B active: top-"
              f"{cfg.top_k} of {cfg.num_experts} experts); claims dropped "
              f"past capacity by layer at the first step's params: "
              + ", ".join(f"{100 * d:.2f}%" for d in drops)
              + "; claims per expert, layer 0: " + str(claims[0].tolist()))
        counters = _counters()
        runs = {}
        for key, (what, on_mesh) in P15_MODES.items():
            torch.cuda.empty_cache()
            step, init, shard = make_mixtral_train_step(
                cfg, build_mesh(MeshSpec()) if on_mesh else None,
                attn_impl="flash", remat=True, seed=SEED,
                device=torch.device("cuda", torch.cuda.current_device()))
            r = runs[key] = timed_steps(
                step, init, params, shard(tokens),
                shard(np.roll(tokens, -1, axis=1)), P15_WARMUP, P15_STEPS,
                counters, profile=key == "a")
            del step, init, shard
            want = {k: float(v) for k, v in predicted_launches(
                "full", cfg.num_layers).items()}
            per_step = {k: n / (P15_WARMUP + P15_STEPS)
                        for k, n in r["launches"].items()}
            if per_step != want:
                raise AssertionError(f"({key}) Mixtral launches per step "
                                     f"{per_step} != the prediction {want}")
            r["tokens_per_s"], r["mfu"] = _mixtral_rates(cfg, P15_BATCH,
                                                         r["step_ms"])
            print(f"({key}) {what}: {r['step_ms']:.2f} ms a step "
                  f"({_spread(r['step_ms_events'])} between CUDA events), "
                  f"{r['tokens_per_s']:.1f} tokens/s, MFU "
                  f"{100 * r['mfu']:.2f}% (active params), peak "
                  f"{r['peak_gib']:.3f} GiB, moments {r['moments_gib']:.3f} "
                  f"GiB; loss " + " ".join(f"{x:.6f}" for x in r["losses"])
                  + "; grad_norm " + " ".join(f"{x:.4f}" for x in r["norms"])
                  + "; launches per step " + ", ".join(
                      f"{k} {v:g}" for k, v in per_step.items() if v))
        a = runs["a"]["losses"]
        if not a[-1] < a[0]:
            raise AssertionError(f"(a) Mixtral losses do not fall: {a}")
        _check_losses("(b)", runs["b"]["losses"], a, P15_SAME_TOL, True)
        print(f"(b) against (a): losses bit-equal step by step "
              f"{[x == y for x, y in zip(runs['b']['losses'], a)]}")
        prod = onehot_product_ms(cfg, t)
        # A layer's forward runs the dispatch and combine forms once, the
        # full remat's recompute again, its backward the combine form
        # (into the tokens), the dispatch form (into the expert outputs)
        # and the combine weights' gradient.
        onehot_ms = cfg.num_layers * (3 * prod["dispatch"]
                                      + 3 * prod["combine"]
                                      + prod["combine_grad"])
        share = onehot_ms / runs["a"]["step_ms"]
        flop = 2.0 * t * cfg.num_experts * cfg.capacity(t) * cfg.hidden_size
        print(f"one-hot products at T {t}, E {cfg.num_experts}, C "
              f"{cfg.capacity(t)}, H {cfg.hidden_size} ({flop / 1e12:.3f} "
              f"TFLOP each): dispatch {prod['dispatch']:.3f} ms, combine "
              f"{prod['combine']:.3f} ms, combine weights' gradient "
              f"{prod['combine_grad']:.3f} ms; 7 a layer a step = "
              f"{onehot_ms:.2f} ms = {100 * share:.1f}% of (a)'s step "
              f"(event-timed products x their count, not a profiler "
              f"attribution)")
        del params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"layers": cfg.num_layers, "params": cfg.num_params(),
            "active_params": cfg.num_params(active=True),
            "capacity": cfg.capacity(t), "drop_rate": drops,
            "claims_layer0": claims[0].tolist(), "runs": runs,
            "onehot_ms": prod, "onehot_ms_per_step": onehot_ms,
            "onehot_share": share}


def _rank_mixtral(rank: int, world: int, store: str, out_path: str,
                  port: int) -> None:
    """One rank of ``phase_mixtral_ranks`` on card ``rank``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.param_shard import ParamShard
    from ray_tpu_torch.parallel.sharding import ShardingRules, shard_params
    from ray_tpu_torch.train import make_mixtral_train_step
    from ray_tpu_torch.train.backend import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    counters = _counters()
    cfg = cfg_mixtral(P15B_LAYERS)
    t = P15_BATCH * P15_SEQ
    tokens = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (P15_BATCH, P15_SEQ), dtype=np.int32)
    params = mixtral.init_params(cfg, generator=SEED, device="cuda")
    res = {}
    if rank == 0:  # one card's loss and routing at this depth
        claims = []
        tok = torch.as_tensor(tokens, device="cuda").long()
        with torch.no_grad():
            loss = mixtral.loss_fn(cfg, params, tok, tok.roll(-1, 1),
                                   attn_impl="flash", remat=False,
                                   route_stats=claims)
        res["one_card"] = {"loss": float(loss),
                           "claims": [c.tolist() for c in claims]}
        del tok, loss
        torch.cuda.empty_cache()
    dist.barrier()
    logical = mixtral.param_logical_axes(cfg)
    modes = {f"ep{world}": MeshSpec(ep=world)}
    if world == 4:
        modes["dp2ep2"] = MeshSpec(dp=2, ep=2)
    for name, spec in modes.items():
        mesh = build_mesh(spec)
        step, init, shard = make_mixtral_train_step(
            cfg, mesh, attn_impl="flash", remat=True, seed=SEED,
            device=torch.device("cuda", rank))
        tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))
        # The routing of the first step's params through the step's model.
        ps = ParamShard(mesh, logical, ShardingRules(), ("dp", "fsdp", "sp"))
        routing = mixtral.RoutingGroup.of_mesh(mesh, ("dp", "fsdp"))
        claims = []
        with torch.no_grad():
            mixtral.forward_hidden(
                cfg, shard_params(params, mesh, logical), tok.long(),
                attn_impl="flash", remat=False, param_shard=ps,
                routing=routing, route_stats=claims)
        torch.cuda.empty_cache()
        r = timed_steps(step, init, params, tok, tgt, P15_WARMUP, P15_STEPS,
                        counters)
        del step, init, shard
        peaks = [None] * world
        dist.all_gather_object(peaks, r["peak_gib"])
        r.update(per_rank_peak_gib=peaks, dp=spec.dp, ep=spec.ep,
                 claims=[c.tolist() for c in claims],
                 drop_rate=drop_rates(cfg, claims, t))
        res[name] = r
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def phase_mixtral_ranks(world: int) -> dict:
    """Phase 15b: Mixtral at 8x7B width, P15B_LAYERS layers, over
    ``world`` NCCL ranks (2 or 4), one card each: ep = world (each rank 8
    / world experts, every rank on the whole batch), and on four cards dp2
    x ep2; the first loss against one card's mesh=None loss at the same
    depth, layer 0's claims per expert against one card's."""
    import tempfile

    from ray_tpu_torch._spawn import run_ranks
    from ray_tpu_torch.train.backend import free_port

    _phase(f"Mixtral train over {world} ranks, one card each "
           f"({P15B_LAYERS} layers)")
    cfg = cfg_mixtral(P15B_LAYERS)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank_mixtral, world, tmp, (out_path, free_port()),
                  MIXTRAL_TIMEOUT_S)
        with open(out_path) as f:
            res = json.load(f)
    one = res.pop("one_card")
    print(f"one card, mesh=None, no grad: loss {one['loss']:.6f}; layer 0's "
          f"claims per expert {one['claims'][0]}")
    for name, r in res.items():
        rows = P15_BATCH / world  # a card's share of the global batch
        r["tokens_per_s_per_card"], r["mfu"] = _mixtral_rates(
            cfg, rows, r["step_ms"])
        diff = abs(r["losses"][0] - one["loss"])
        got, want = r["claims"][0], one["claims"][0]
        worst = max(abs(g - w) / w for g, w in zip(got, want))
        print(f"{name}: {r['step_ms']:.2f} ms a step on rank 0's host "
              f"clock, {r['tokens_per_s_per_card']:.1f} tokens/s per card, "
              f"MFU {100 * r['mfu']:.2f}%; peak GiB per rank "
              f"{[round(p, 3) for p in r['per_rank_peak_gib']]}; loss "
              + " ".join(f"{x:.6f}" for x in r["losses"])
              + f"; first loss off one card's by {diff:.3e} (limit "
              f"{P15B_TOL}); layer 0's claims {got} (worst {worst:.2e} "
              f"off one card's); drops by layer "
              + ", ".join(f"{100 * d:.2f}%" for d in r["drop_rate"]))
        limit = P15B_CLAIMS_TOL if r["dp"] > 1 else 0.0
        if not all(math.isfinite(x) for x in r["losses"]) or \
                diff > P15B_TOL or worst > limit:
            raise AssertionError(f"{name} over {world} ranks: first loss "
                                 f"{r['losses'][0]} vs {one['loss']}, "
                                 f"layer 0 claims {got} vs {want}")
    res["one_card"] = one
    return res


# Phase 16: RL. Anakin at Podracer scale: CartPole-v1, 4096 envs
# x 128 unroll = 524288 rows an iteration, 8 iterations a call (4.19M env
# steps), hidden 64, 4 epochs x 4 minibatches.
RL_ENVS, RL_UNROLL, RL_ITERS, RL_HIDDEN = 4096, 128, 8, 64
RL_CALLS = 20          # warm-up, timed, profiled and learning calls
RL_TIMED = 5
RL_RISE = 10.0         # the return must rise by more than this
RL_README = dict(num_envs=512, unroll_len=64, iters=8)
RL_ENV_STEPS = 200     # (a): steps of each env, cuda against cpu
# (a) CartPole's obs, cuda against cpu from the same state (sin/cos and
# division round apart by an ulp); a done may differ only where the state
# lies within this of a termination threshold.
RL_ENV_TOL = 1e-5
# (b) GAE and V-trace: 1e-5 of max(1, the largest |output|) (f32 sums of
# at most 128 steps in the same order; one device may fuse a multiply-add).
RL_SCAN_TOL = 1e-5
# (b) The updates, params after all their adam steps and their losses:
# gradients are means over up to 131072 rows summed in another order
# (cuBLAS against the CPU's BLAS, ~1e-6 relative); adam moves a param by
# at most lr a step, and a gradient's relative error moves the step by as
# much of it, so the params stay within 1e-4 unless a gradient element
# lies within its rounding error of zero. Losses: 1e-4 relative.
RL_UPDATE_TOL = 1e-4
RL_RANKS_TIMEOUT_S = 600


def _rl_cfg(**kw):
    from ray_tpu_torch.rl import PPOConfig

    base = dict(vectorized=True, num_envs=RL_ENVS, unroll_len=RL_UNROLL,
                hidden=RL_HIDDEN, num_epochs=4, num_minibatches=4,
                extra={"iters_per_step": RL_ITERS})
    base.update(kw)
    return PPOConfig(**base)


def _tree_err(got, want) -> float:
    from ray_tpu_torch._device import tree_leaves

    return max(float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def _rel_err(got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().double()
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def _check(label: str, err: float, tol: float, results: dict) -> None:
    print(f"  {label}: max err {err:.3e} (limit {tol:.0e})")
    results[label] = err
    if not err <= tol:
        raise AssertionError(f"{label}: {err} > {tol}")


def rl_env_check() -> dict:
    """(a) Each batched env under AutoResetWrapper, N = RL_ENVS for
    RL_ENV_STEPS steps: at every step the card's state steps on the card
    and on the CPU with the same seeded actions and the same fresh
    episodes (drawn on the CPU), and the outputs must agree; the card's
    state goes on."""
    import numpy as np
    import torch
    from ray_tpu_torch.rl.vec_env import VecCartPole, make_vec_env

    res = {}
    for name in ("CartPole-v1", "Catch-v0", "GridWorld-v0"):
        env = make_vec_env(name)
        cpu_gen = torch.Generator().manual_seed(SEED)
        rng = np.random.default_rng(SEED)
        state, obs = env.reset(RL_ENVS, cpu_gen)
        state = {k: v.cuda() for k, v in state.items()}
        worst, done_diff, dones = 0.0, 0, 0
        for _ in range(RL_ENV_STEPS):
            act = torch.from_numpy(rng.integers(
                0, env.num_actions, RL_ENVS)).long()
            fs, fo = env.reset(RL_ENVS, cpu_gen)
            host = {k: v.cpu() for k, v in state.items()}
            want = env.step(host, act, fresh=(fs, fo))
            got = env.step(state, act.cuda(),
                           fresh=({k: v.cuda() for k, v in fs.items()},
                                  fo.cuda()))
            d_got, d_want = got[3].cpu(), want[3]
            if name == "CartPole-v1":
                # Where a done differs, the pre-step state must sit at a
                # threshold: the stepped x or theta within tolerance of it.
                phys = env.env.step(host, act)[0]["phys"]
                edge = ((phys[:, 0].abs() - VecCartPole.X_LIMIT).abs()
                        <= RL_ENV_TOL) | ((phys[:, 2].abs()
                                           - VecCartPole.THETA_LIMIT).abs()
                                          <= RL_ENV_TOL)
                bad = (d_got != d_want) & ~edge
                done_diff += int((d_got != d_want).sum())
                same = d_got == d_want
                worst = max(worst, float(
                    (got[1].cpu()[same] - want[1][same]).abs().max()))
                if bool(bad.any()):
                    raise AssertionError(f"phase 16a {name}: dones differ "
                                         "away from a threshold")
            else:
                if not (torch.equal(d_got, d_want)
                        and torch.equal(got[1].cpu(), want[1])
                        and torch.equal(got[2].cpu(), want[2])):
                    raise AssertionError(f"phase 16a {name}: not exact")
            dones += int(d_want.sum())
            state = got[0]
        tol = RL_ENV_TOL if name == "CartPole-v1" else 0.0
        print(f"  {name}: {RL_ENVS} envs x {RL_ENV_STEPS} steps, {dones} "
              f"episode ends, obs max err {worst:.3e} (limit {tol:.0e}), "
              f"dones differing at a threshold {done_diff}")
        if not worst <= tol:
            raise AssertionError(f"phase 16a {name}: obs err {worst}")
        res[name] = {"max_abs_err": worst, "episode_ends": dones,
                     "dones_differing_at_threshold": done_diff}
    return res


def rl_learner_check(eng) -> dict:
    """(b) Each learner function on the card against the CPU on the same
    inputs: GAE, V-trace, ppo_update and Anakin's _update on one rollout
    of ``eng`` (RL_ENVS x RL_UNROLL rows), then dqn_update, sac_update,
    impala_update and appo_update at their configs' defaults."""
    import torch
    from ray_tpu_torch.rl import anakin, appo, dqn, impala, ppo, sac
    from ray_tpu_torch.rl.ppo import init_mlp, init_policy
    from ray_tpu_torch.train.optim import adam

    res: dict = {}
    gen = torch.Generator().manual_seed(SEED + 16)
    (_, obs, _), traj, _ = eng.rollout(eng.params, eng.env_states, eng.obs,
                                       eng.ep_ret, eng.gen)
    with torch.no_grad():
        last = anakin._apply_vf(eng.params, obs)
    host = {k: v.cpu() for k, v in traj.items()}
    cfg = eng.cfg
    args = ("rewards", "values", "dones")
    adv, ret = ppo.compute_gae(*(traj[k] for k in args), last, cfg.gamma,
                               cfg.gae_lambda)
    hadv, hret = ppo.compute_gae(*(host[k] for k in args), last.cpu(),
                                 cfg.gamma, cfg.gae_lambda)
    _check("compute_gae", max(_rel_err(adv, hadv), _rel_err(ret, hret)),
           RL_SCAN_TOL, res)
    target = traj["logp"].cpu() + 0.1 * torch.randn(
        traj["logp"].shape, generator=gen)
    vt = impala.vtrace(traj["logp"], target.cuda(), traj["rewards"],
                       traj["values"], traj["dones"], last, cfg.gamma)
    hvt = impala.vtrace(host["logp"], target, host["rewards"],
                        host["values"], host["dones"], last.cpu(), cfg.gamma)
    _check("vtrace", max(_rel_err(a, b) for a, b in zip(vt, hvt)),
           RL_SCAN_TOL, res)
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    batch = {"obs": flat(traj["obs"]), "actions": flat(traj["actions"]),
             "logp": flat(traj["logp"]), "advantages": flat(adv),
             "returns": flat(ret)}
    hbatch = {k: v.cpu() for k, v in batch.items()}
    B = batch["obs"].shape[0]
    static = eng.static
    idxs = ppo.permutation_idxs(B, cfg.num_minibatches, cfg.num_epochs, gen)
    shifts = torch.randint(0, B, (cfg.num_epochs,), generator=gen)
    for label, fn, extra in (("ppo_update", ppo.ppo_update, idxs),
                             ("anakin _update", anakin._update, shifts)):
        out = {}
        for dev, b in (("cuda", batch), ("cpu", hbatch)):
            p = init_policy(torch.Generator().manual_seed(SEED), 4, 2,
                            RL_HIDDEN, device=dev)
            opt = adam(cfg.lr)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, _, st = fn(opt, static, p, opt.init(p), b, extra.to(dev))
            torch.cuda.synchronize()
            out[dev] = (p, st, (time.perf_counter() - t0) * 1e3)
        _check(f"{label} params", _tree_err(out["cuda"][0], out["cpu"][0]),
               RL_UPDATE_TOL, res)
        _check(f"{label} losses", max(
            _rel_err(out["cuda"][1][k], out["cpu"][1][k])
            for k in out["cpu"][1]), RL_UPDATE_TOL, res)
        res[f"{label} ms"] = {"cuda": out["cuda"][2], "cpu": out["cpu"][2]}
        print(f"  {label} at {B} rows, {cfg.num_epochs}x"
              f"{cfg.num_minibatches} minibatches: card {out['cuda'][2]:.2f}"
              f" ms, CPU {out['cpu'][2]:.2f} ms (host clock)")

    # DQN at DQNConfig's defaults: 32 batches of 128, hidden 64, CartPole.
    dc = dqn.DQNConfig()
    K, Bq = dc.train_batches_per_step, dc.batch_size
    rows = RL_ENVS  # draw from the rollout's own observations
    pick = torch.randint(0, B - rows, (1,), generator=gen).item()
    pool = hbatch["obs"][pick:pick + rows]
    draw = lambda: pool[torch.randint(0, rows, (K, Bq), generator=gen)]
    qb = {"obs": draw(), "actions": torch.randint(0, 2, (K, Bq),
                                                  generator=gen),
          "rewards": torch.ones(K, Bq), "next_obs": draw(),
          "dones": (torch.rand(K, Bq, generator=gen) < 0.05).float()}
    out = {}
    for dev in ("cuda", "cpu"):
        g = torch.Generator().manual_seed(SEED)
        q = init_mlp(g, [4, dc.hidden, dc.hidden, 2], scale_last=1.0,
                     device=dev)
        tq = ppo.clone_params(init_mlp(g, [4, dc.hidden, dc.hidden, 2],
                                       scale_last=1.0, device=dev))
        opt = adam(dc.lr)
        q, _, loss, tds = dqn.dqn_update(
            opt, dc.double_dqn, q, tq, opt.init(q),
            {k: v.to(dev) for k, v in qb.items()}, dc.gamma)
        out[dev] = (q, loss, tds)
    _check("dqn_update params", _tree_err(out["cuda"][0], out["cpu"][0]),
           RL_UPDATE_TOL, res)
    _check("dqn_update loss, |td|", max(_rel_err(out["cuda"][1],
                                                 out["cpu"][1]),
                                        _rel_err(out["cuda"][2],
                                                 out["cpu"][2])),
           RL_UPDATE_TOL, res)

    # SAC at SACConfig's defaults: 16 batches of 256, hidden 128, Pendulum.
    sc = sac.SACConfig()
    K, Bs = sc.train_batches_per_step, sc.batch_size
    th = torch.rand(K, Bs, generator=gen) * 2 * math.pi - math.pi
    pend = lambda t: torch.stack([t.cos(), t.sin(), torch.rand(
        K, Bs, generator=gen) * 16 - 8], -1)
    sb = {"obs": pend(th), "actions": torch.rand(K, Bs, 1, generator=gen)
          * 4 - 2, "rewards": -th ** 2, "next_obs": pend(th + 0.05),
          "dones": torch.zeros(K, Bs)}
    noise = torch.randn(K, 2, Bs, 1, generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        g = torch.Generator().manual_seed(SEED)
        qs = [3 + 1, sc.hidden, sc.hidden, 1]
        p = {"actor": init_mlp(g, [3, sc.hidden, sc.hidden, 2], device=dev),
             "q": (init_mlp(g, qs, scale_last=1.0, device=dev),
                   init_mlp(g, qs, scale_last=1.0, device=dev)),
             "log_alpha": torch.tensor(math.log(sc.init_alpha)).to(
                 dev).requires_grad_(True)}
        opts = (adam(sc.actor_lr), adam(sc.critic_lr), adam(sc.alpha_lr))
        states = {"actor": opts[0].init(p["actor"]),
                  "q": opts[1].init(p["q"]),
                  "alpha": opts[2].init(p["log_alpha"])}
        p, tq, _, ql, al, alpha = sac.sac_update(
            opts, sc.gamma, -1.0, p, ppo.clone_params(p["q"]), states,
            {k: v.to(dev) for k, v in sb.items()}, noise.to(dev), 2.0,
            sc.tau)
        out[dev] = (p, tq, (ql, al, alpha))
    _check("sac_update params", max(_tree_err(out["cuda"][0],
                                              out["cpu"][0]),
                                    _tree_err(out["cuda"][1],
                                              out["cpu"][1])),
           RL_UPDATE_TOL, res)
    _check("sac_update losses", max(_rel_err(a, b) for a, b in zip(
        out["cuda"][2], out["cpu"][2])), RL_UPDATE_TOL, res)

    # IMPALA and APPO at ImpalaConfig's defaults: [64, 8] rollouts, 3
    # updates, from this phase's trajectory.
    ic = appo.APPOConfig()
    T, N = min(ic.rollout_len, RL_UNROLL - 1), ic.num_envs_per_runner
    ib = {k: host[k][:T, :N] for k in ("obs", "actions", "logp", "rewards",
                                       "dones")}
    ib["last_obs"] = host["obs"][T, :N]
    ist = (ic.gamma, ic.rho_clip, ic.c_clip, ic.vf_coef, ic.ent_coef)
    for label, fn, static in (("impala_update", impala.impala_update, ist),
                              ("appo_update", appo.appo_update,
                               ist + (ic.clip_eps,))):
        out = {}
        for dev in ("cuda", "cpu"):
            p = init_policy(torch.Generator().manual_seed(SEED), 4, 2,
                            ic.hidden, device=dev)
            opt = adam(ic.lr)
            s = opt.init(p)
            b = {k: v.to(dev) for k, v in ib.items()}
            for _ in range(3):
                p, s, st = fn(opt, static, p, s, b)
            out[dev] = (p, st)
        _check(f"{label} params", _tree_err(out["cuda"][0], out["cpu"][0]),
               RL_UPDATE_TOL, res)
        _check(f"{label} losses", max(
            _rel_err(out["cuda"][1][k], out["cpu"][1][k])
            for k in out["cpu"][1]), RL_UPDATE_TOL, res)
    return res


def _profile_fn(fn) -> dict:
    """One call of ``fn`` under torch.profiler (device activity only):
    wall, device busy share, kernels, memcpys (by direction) and
    memsets."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    names = [e.name for e in dev]
    kernels = [n for n in names if not n.startswith(("Memcpy", "Memset"))]
    cats: dict[str, float] = {}
    for e in dev:
        c = kernel_category(e.name)
        cats[c] = cats.get(c, 0.0) + e.time_range.elapsed_us() / 1e3
    return {"profiled_wall_ms": wall_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms if busy_ms else None,
            "kernels": len(kernels),
            "dtoh_copies": sum(n.startswith("Memcpy DtoH") for n in names),
            "htod_copies": sum(n.startswith("Memcpy HtoD") for n in names),
            "memsets": sum(n.startswith("Memset") for n in names),
            "category_ms": cats}


def _profile_call(algo) -> dict:
    """One train_step of ONE iteration under torch.profiler
    (``_profile_fn``). A call of 8 iterations made ~121k device events,
    which took the profiler ~25 s to stop and read back."""
    eng = algo._engine
    iters, eng.iters_per_step = eng.iters_per_step, 1
    try:
        res = _profile_fn(algo.train_step)
    finally:
        eng.iters_per_step = iters
    res["kernels_per_iter"] = res.pop("kernels")
    return res


def rl_anakin_run(cfg, calls: int, timed: int, profile: bool = True) -> dict:
    """1 warm-up call, ``timed`` timed calls, one profiled call, then the
    rest of ``calls``; the returns of every call."""
    import torch

    t_start = time.perf_counter()
    algo = cfg.build()
    eng = algo._engine
    iters = eng.iters_per_step
    per_call = iters * eng.num_envs * eng.unroll_len
    returns = [algo.train_step()["episode_return_mean"]]
    t_warm = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        m = algo.train_step()
        returns.append(m["episode_return_mean"])
    dt = time.perf_counter() - t0  # train_step ends in its host copy
    res = {"envs": eng.num_envs, "unroll": eng.unroll_len, "iters": iters,
           "env_steps_per_call": per_call,
           "env_steps_per_s": timed * per_call / dt,
           "ms_per_iter": dt * 1e3 / (timed * iters),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    t_prof = time.perf_counter()
    if profile:
        res["profile"] = _profile_call(algo)
        returns.append(None)  # the profiled call's is not kept
    t_rest = time.perf_counter()
    while len(returns) < calls:
        returns.append(algo.train_step()["episode_return_mean"])
    res["returns"] = returns
    res["seconds"] = {"build_and_warm_up": t_warm - t_start,
                      "timed": t_prof - t_warm, "profile": t_rest - t_prof,
                      "rest": time.perf_counter() - t_rest}
    print("seconds: " + ", ".join(f"{k} {v:.1f}"
                                  for k, v in res["seconds"].items()))
    res["algo"] = algo
    return res


def phase_rl() -> dict:
    """Phase 16: the RL port on the card. (a) the batched envs against the
    CPU; (b) every learner function against the CPU; (c) Anakin at
    Podracer scale (and the README's geometry) with its rates, launches,
    busy share, peak memory and learning; (d) the EnvRunner path and DQN,
    SAC, IMPALA and APPO, three steps each."""
    import torch
    from ray_tpu_torch.rl import (APPOConfig, DQNConfig, ImpalaConfig,
                                  PPOConfig, SACConfig)
    from ray_tpu_torch.rl.anakin import _apply_vf
    from ray_tpu_torch.rl.ppo import compute_gae

    _phase("RL (a): batched envs, cuda against cpu")
    t_phase = time.perf_counter()
    out = {"envs": rl_env_check()}
    out["a_s"] = time.perf_counter() - t_phase

    _phase(f"RL (c): Anakin PPO, CartPole-v1, {RL_ENVS} envs x {RL_UNROLL} "
           f"unroll x {RL_ITERS} iterations a call, hidden {RL_HIDDEN}")
    run = rl_anakin_run(_rl_cfg(), RL_CALLS, RL_TIMED)
    algo = run.pop("algo")
    prof = run["profile"]
    # The profiler's own host cost stretches the profiled iteration: the
    # busy ms over an unprofiled iteration's time too.
    prof["busy_share_unprofiled"] = prof["busy_ms"] / run["ms_per_iter"]
    rets = [r for r in run["returns"] if r is not None]
    rise = max(rets[1:]) - rets[0]
    print(f"{run['env_steps_per_s']:.1f} env-steps/s, "
          f"{run['ms_per_iter']:.2f} ms an iteration ({RL_TIMED} timed "
          f"calls of {run['env_steps_per_call']} env steps, host clock), "
          f"peak {run['peak_gib']:.3f} GiB")
    print(f"one profiled call of one iteration: wall "
          f"{prof['profiled_wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms = "
          f"{100 * (prof['busy_share'] or 0):.1f}% of it, "
          f"{100 * prof['busy_share_unprofiled']:.1f}% of an unprofiled "
          f"iteration's {run['ms_per_iter']:.2f} ms, "
          f"{prof['kernels_per_iter']} kernels an iteration, "
          f"{prof['dtoh_copies']} device-to-host and {prof['htod_copies']} "
          f"host-to-device copies, {prof['memsets']} memsets; by "
          "category: " + ", ".join(
              f"{c} {ms:.2f} ms" for c, ms in sorted(
                  prof["category_ms"].items(), key=lambda kv: -kv[1])))
    print("returns by call: " + " ".join(f"{r:.2f}" for r in rets)
          + f"; rise {rise:.2f} (limit > {RL_RISE})")
    if prof["busy_ms"] and prof["dtoh_copies"] != 1:
        raise AssertionError(f"phase 16c: {prof['dtoh_copies']} "
                             "device-to-host copies in a call, not 1")
    if not rise > RL_RISE:
        raise AssertionError(f"phase 16c: the return rose {rise}")
    out["anakin"] = run

    # Where an iteration's time goes: the rollout, GAE and the update on
    # CUDA events (device) and the host clock, one iteration.
    eng = algo._engine
    e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    e[0].record()
    (eng.env_states, eng.obs, eng.ep_ret), traj, _ = eng.rollout(
        eng.params, eng.env_states, eng.obs, eng.ep_ret, eng.gen)
    e[1].record()
    h1 = time.perf_counter()
    with torch.no_grad():
        last = _apply_vf(eng.params, eng.obs)

    compute_gae(traj["rewards"], traj["values"], traj["dones"], last,
                eng.cfg.gamma, eng.cfg.gae_lambda)
    e[2].record()
    h2 = time.perf_counter()
    eng.one_iter()
    e[3].record()
    h3 = time.perf_counter()
    torch.cuda.synchronize()
    split = {"rollout": (e[0].elapsed_time(e[1]), (h1 - h0) * 1e3),
             "gae": (e[1].elapsed_time(e[2]), (h2 - h1) * 1e3),
             "whole iteration": (e[2].elapsed_time(e[3]), (h3 - h2) * 1e3)}
    split["update (whole - rollout - gae)"] = tuple(
        w - r - g for w, r, g in zip(split["whole iteration"],
                                     split["rollout"], split["gae"]))
    print("one iteration, (events ms, host-enqueue ms): " + ", ".join(
        f"{k} ({a:.2f}, {b:.2f})" for k, (a, b) in split.items()))
    out["split_ms"] = split

    out["c_s"] = time.perf_counter() - t_phase - out["a_s"]
    _phase("RL (b): learner functions, cuda against cpu")
    t_b = time.perf_counter()
    out["learners"] = rl_learner_check(eng)
    out["b_s"] = time.perf_counter() - t_b
    del algo, eng

    g = RL_README
    readme = rl_anakin_run(_rl_cfg(num_envs=g["num_envs"],
                                   unroll_len=g["unroll_len"],
                                   extra={"iters_per_step": g["iters"]}),
                           4, 3, profile=False)
    readme.pop("algo")
    print(f"README geometry ({g['num_envs']} envs x {g['unroll_len']} x "
          f"{g['iters']}): {readme['env_steps_per_s']:.1f} env-steps/s, "
          f"{readme['ms_per_iter']:.2f} ms an iteration")
    out["readme_geometry"] = readme

    _phase("RL (d): the EnvRunner path, DQN, SAC, IMPALA, APPO on the card")
    out["algos"] = {}
    # Each algorithm's losses, the first of which must be non-zero (its
    # update ran: DQN and SAC start learning after 256 env steps).
    for label, cfg, keys in (
            ("ppo", PPOConfig(), ("vf_loss", "policy_loss", "entropy")),
            ("dqn", DQNConfig(learning_starts=256), ("td_loss",)),
            ("sac", SACConfig(learning_starts=256),
             ("q_loss", "actor_loss", "alpha")),
            ("impala", ImpalaConfig(), ("vf_loss", "policy_loss")),
            ("appo", APPOConfig(), ("vf_loss", "policy_loss"))):
        algo = cfg.build()
        t0 = time.perf_counter()
        ms = [algo.train_step() for _ in range(3)]
        dt = time.perf_counter() - t0
        steps = (ms[-1]["num_env_steps_sampled"] if label in ("dqn", "sac")
                 else sum(m["num_env_steps_sampled"] for m in ms))
        losses = {k: ms[-1][k] for k in keys}
        print(f"  {label}: 3 steps, {steps / dt:.1f} env-steps/s (host "
              f"clock), last " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in losses.items()))
        if not all(math.isfinite(v) for v in losses.values()) or \
                losses[keys[0]] == 0.0:
            raise AssertionError(f"phase 16d {label}: losses {losses}")
        out["algos"][label] = {"env_steps_per_s": steps / dt, **losses}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 16: {out['phase_s']:.1f} s ((a) {out['a_s']:.1f}, (c) "
          f"{out['c_s']:.1f}, (b) {out['b_s']:.1f})")
    return out


def _rank_rl(rank: int, world: int, store: str, out_path: str,
             port: int) -> None:
    """One rank of ``phase_rl_ranks`` on card ``rank``."""
    import torch
    import torch.distributed as dist
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.train.backend import init_distributed

    res = {}
    if rank == 0:  # one card's rate first, in the same call (no group yet)
        torch.cuda.set_device(0)
        algo = _rl_cfg().build()
        algo.train_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            algo.train_step()
        res["one_card_env_steps_per_s"] = 3 * RL_ITERS * RL_ENVS * \
            RL_UNROLL / (time.perf_counter() - t0)
        del algo
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    for label, envs in (("strong", RL_ENVS), ("weak", RL_ENVS * world)):
        algo = _rl_cfg(num_envs=envs).build()
        eng = algo._engine
        per_call = RL_ITERS * envs * RL_UNROLL
        equal = []

        def call():
            m = algo.train_step()
            flat = torch.cat([t.detach().reshape(-1)
                              for t in tree_leaves(eng.params)])
            every = [torch.empty_like(flat) for _ in range(world)]
            dist.all_gather(every, flat)
            equal.append(all(torch.equal(every[0], x) for x in every))
            return m

        call()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        rets = [call()["episode_return_mean"] for _ in range(3)]
        dt = time.perf_counter() - t0
        res[label] = {"envs": envs, "envs_per_rank": eng.n_local,
                      "env_steps_per_s": 3 * per_call / dt,
                      "env_steps_per_s_per_card": 3 * per_call / dt / world,
                      "ms_per_iter": dt * 1e3 / (3 * RL_ITERS),
                      "ranks_bit_equal": equal, "returns": rets}
        del algo, eng
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def phase_rl_ranks(world: int) -> dict:
    """Phase 16b: (c)'s Anakin config over ``world`` NCCL ranks, one card
    each: its 4096 envs split over the ranks ("strong"), then 4096 envs a
    rank ("weak"); 1 warm-up and 3 timed calls each. The ranks' params
    must be bit-equal after every call."""
    import tempfile

    from ray_tpu_torch._spawn import run_ranks
    from ray_tpu_torch.train.backend import free_port

    _phase(f"RL over {world} ranks, one card each: Anakin PPO")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank_rl, world, tmp, (out_path, free_port()),
                  RL_RANKS_TIMEOUT_S)
        with open(out_path) as f:
            res = json.load(f)
    one = res["one_card_env_steps_per_s"]
    print(f"one card, before the group: {one:.1f} env-steps/s")
    for label in ("strong", "weak"):
        r = res[label]
        r["over_one_card"] = r["env_steps_per_s"] / one
        print(f"{label}: {r['envs']} envs ({r['envs_per_rank']} a rank): "
              f"{r['env_steps_per_s']:.1f} env-steps/s in all "
              f"({r['over_one_card']:.3f}x one card), "
              f"{r['env_steps_per_s_per_card']:.1f} per card, "
              f"{r['ms_per_iter']:.2f} ms an iteration; params bit-equal "
              f"after every call: {r['ranks_bit_equal']}")
        if not all(r["ranks_bit_equal"]):
            raise AssertionError(f"phase 16b {label}: ranks' params differ")
    return res


# Phase 18: the rest of RL. (a) The offline data is tests/test_rl.py's
# expert (CartPole, the angle+velocity controller, 30 episodes of at most
# 200 steps) through ray_tpu_torch.data; BC trains 5 steps x 3 epochs and
# must pass that test's action-accuracy bar.
RL18_EPISODES, RL18_MAX_STEPS = 30, 200
BC_STEPS, BC_EPOCHS, BC_ACC_BAR = 5, 3, 0.8
RL18_STEPS = 3            # MARWIL, CQL and each multi-agent run
DREAMER_ITERS = 12        # (c): DreamerConfig() on CartPole-v1
DREAMER_BAR = 30.0        # tests/test_rl.py: max of the last 6 >= 30
DREAMER_TIMED = 20        # updates timed on CUDA events
# DreamerV3's published training geometry (batch 16 x length 64,
# imagination horizon 15) at its S size (512 recurrent and 512 hidden
# units); the latent stays at the config's 8.
DREAMER_V3_S = dict(batch_seqs=16, seq_len=64, horizon=15, det=512,
                    hidden=512, latent=8)
# (d) One dreamer_update, card against CPU on the same params, batch and
# noise (f32, TF32 off). cuBLAS and the CPU's BLAS sum products in other
# orders (~1e-7 relative); the 16-step filter and the 10-step imagination
# carry that through tanh and sigmoid gates, and each gradient leaf sums
# over the 256 windows' rows. The CPU tests hold the port to JAX's
# gradients within 1e-5 of each leaf's largest magnitude; the card gets
# 1e-4 of it, and 1e-4 relative on every loss term. Adam's first step is
# lr * g / (|g| + eps): a rounding error flips it only where |g| lies
# within that error of zero, so the params after the step are held to
# 1e-5 where |g| >= 1e-3 of the leaf's largest, and the rest (counted)
# to 2 * lr.
DREAMER_LOSS_TOL = 1e-4
DREAMER_GRAD_TOL = 1e-4
DREAMER_PARAM_TOL = 1e-5
DREAMER_HELD_FROM = 1e-3


def expert_cartpole_blocks() -> list:
    """The expert's transitions as two blocks of obs, actions, rewards,
    next_obs, dones (terminations) and returns (to go, gamma 0.99)."""
    import numpy as np
    from ray_tpu_torch.rl.env import CartPoleEnv

    env = CartPoleEnv(seed=SEED)
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "dones", "returns")}
    for _ in range(RL18_EPISODES):
        obs, done, steps, rews = env.reset(), False, 0, []
        while not done and steps < RL18_MAX_STEPS:
            a = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0
            nobs, r, term, trunc = env.step(a)
            cols["obs"].append(np.asarray(obs, np.float32))
            cols["actions"].append(a)
            cols["rewards"].append(r)
            cols["next_obs"].append(np.asarray(nobs, np.float32))
            cols["dones"].append(float(term))
            rews.append(r)
            obs, done, steps = nobs, term or trunc, steps + 1
        g, rets = 0.0, []
        for r in reversed(rews):
            g = r + 0.99 * g
            rets.append(g)
        cols["returns"].extend(reversed(rets))
    data = {k: (np.stack(v) if k in ("obs", "next_obs") else
                np.asarray(v, np.int32 if k == "actions" else np.float32))
            for k, v in cols.items()}
    half = len(data["actions"]) // 2
    return [{k: v[:half] for k, v in data.items()},
            {k: v[half:] for k, v in data.items()}]


def _card_vs_cpu(label: str, run, res: dict) -> None:
    """``run(device)`` -> (params, [0-d tensors]) of the same updates;
    the card's against the CPU's."""
    got, want = run("cuda"), run("cpu")
    _check(f"{label} params", _tree_err(got[0], want[0]), RL_UPDATE_TOL,
           res)
    _check(f"{label} losses", max(_rel_err(a, b) for a, b in
                                  zip(got[1], want[1])), RL_UPDATE_TOL, res)


def rl_offline_check(ds) -> dict:
    """(a) bc_update, marwil_update (beta 1, with its EMA) and cql_update,
    three updates each on the dataset's first three batches of 256, on the
    card against the CPU from the same params."""
    import itertools

    import torch
    from ray_tpu_torch.rl import bc, cql, marwil
    from ray_tpu_torch.rl.ppo import clone_params, init_mlp
    from ray_tpu_torch.train.optim import adam

    res: dict = {}
    host = [bc.device_batch(b, "cpu") for b in
            itertools.islice(ds.iter_batches(batch_size=256), 3)]

    def mlp(dev, out, scale_last=0.01, seed=SEED):
        return init_mlp(torch.Generator().manual_seed(seed),
                        [4, 64, 64, out], scale_last=scale_last, device=dev)

    def run_bc(dev):
        p, opt, losses = mlp(dev, 2), adam(1e-3), []
        s = opt.init(p)
        for b in host:
            p, s, loss, acc = bc.bc_update(opt, p, s, b["obs"].to(dev),
                                           b["actions"].to(dev))
            losses += [loss, acc]
        return p, losses

    def run_marwil(dev):
        p = {"pi": mlp(dev, 2), "vf": mlp(dev, 1, 1.0, SEED + 1)}
        opt, ma, losses = adam(1e-3), torch.ones((), device=dev), []
        s = opt.init(p)
        for b in host:
            p, s, ma, loss, critic = marwil.marwil_update(
                opt, 1.0, p, s, ma, b["obs"].to(dev), b["actions"].to(dev),
                b["returns"].to(dev))
            losses += [loss, critic, ma]
        return p, losses

    def run_cql(dev):
        p, opt, losses = mlp(dev, 2), adam(1e-3), []
        target, s = clone_params(p), opt.init(p)
        for b in host:
            p, s, td, gap = cql.cql_update(
                opt, p, target, s, {k: b[k].to(dev) for k in cql._COLUMNS},
                0.99, 1.0)
            losses += [td, gap]
        return p, losses

    for label, run in (("bc_update", run_bc), ("marwil_update", run_marwil),
                       ("cql_update", run_cql)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _card_vs_cpu(label, run, res)
        res[f"{label} s (card and CPU)"] = time.perf_counter() - t0
    return res


def rl_multi_agent_check(algo) -> dict:
    """(b) One policy's update (``MultiAgentPPO._update_policy``) on one
    of ``algo``'s samples, on the card against a CPU copy of ``algo``,
    from the same params, a fresh optimizer state and the same minibatch
    indices."""
    import dataclasses
    import torch
    from ray_tpu_torch.rl import ppo

    algo._runner.set_weights(algo.policies)
    sample = algo._runner.sample()
    pid = next(iter(algo.policies))
    s, cfg = sample[pid], algo.cfg
    host = ppo.params_to_numpy(algo.policies[pid])
    rows = s["obs"].shape[0] * s["obs"].shape[1]
    idxs = ppo.permutation_idxs(rows, cfg.num_minibatches, cfg.num_epochs,
                                torch.Generator().manual_seed(SEED))
    on_cpu = dataclasses.replace(cfg, device="cpu").build()

    def run(dev):
        a = algo if dev == "cuda" else on_cpu
        a.policies[pid] = ppo.params_from_jax(host, a.device)
        a.opt_states[pid] = a.optimizer.init(a.policies[pid])
        st = a._update_policy(pid, s, idxs)
        return a.policies[pid], list(st.values())

    res: dict = {}
    _card_vs_cpu(f"{cfg.env} ppo_update ({pid})", run, res)
    return res


def _dreamer_inputs(cfg, obs_size: int, num_actions: int, device):
    """Seeded params, optimizer, a synthetic [B, T] batch (episodes
    starting every 20 steps), reward bounds and noise at ``cfg``'s
    geometry."""
    import torch
    from ray_tpu_torch.rl import dreamer
    from ray_tpu_torch.train.optim import adam, chain, clip_by_global_norm

    gen = torch.Generator().manual_seed(SEED)
    B, T = cfg.batch_seqs, cfg.seq_len
    params = dreamer.init_world_model(gen, obs_size, num_actions, cfg.det,
                                      cfg.latent, cfg.hidden, device=device)
    opt = chain(clip_by_global_norm(100.0), adam(cfg.lr))
    first = torch.zeros(B, T)
    first[:, ::20] = 1.0
    batch = {"obs": torch.randn(B, T, obs_size, generator=gen),
             "actions": torch.randint(0, num_actions, (B, T), generator=gen),
             "rewards": torch.ones(B, T),
             "dones": torch.roll(first, -1, 1) * (torch.rand(
                 B, T, generator=gen) < 0.5),
             "is_first": first}
    noise = dreamer.update_noise(gen, B, T, cfg.horizon, cfg.latent,
                                 num_actions, "cpu")
    to = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    return (params, opt, opt.init(params), to(batch),
            torch.tensor([0.0, 1.0], device=device), to(noise))


def dreamer_update_times(cfg, params, opt, state, batch, bounds, noise,
                         num_actions: int) -> dict:
    """ms per dreamer_update on CUDA events and on the host clock (each
    over DREAMER_TIMED updates after 2 warm-up), then one profiled
    update: kernels, device busy share; peak memory of the updates."""
    import torch
    from ray_tpu_torch.rl import dreamer

    static = (cfg.horizon, cfg.gamma, cfg.lam, cfg.free_bits, cfg.ent_coef)

    def one():
        dreamer.dreamer_update(opt, static, num_actions, params, state,
                               batch, bounds, noise)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = events_ms(one, DREAMER_TIMED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DREAMER_TIMED):
        one()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / DREAMER_TIMED
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _profile_fn(one)
    return {"events_ms": ev, "host_ms": host, "peak_gib": peak,
            "kernels": prof["kernels"], "busy_ms": prof["busy_ms"],
            "busy_share": prof["busy_share"],
            "busy_share_unprofiled": prof["busy_ms"] / ev,
            "category_ms": prof["category_ms"]}


def _print_dreamer_times(label: str, t: dict) -> None:
    print(f"{label}: {t['events_ms']:.3f} ms an update (CUDA events), "
          f"{t['host_ms']:.3f} ms (host clock), {t['kernels']} kernels an "
          f"update, device busy {t['busy_ms']:.3f} ms = "
          f"{100 * (t['busy_share'] or 0):.1f}% of a profiled update, "
          f"{100 * t['busy_share_unprofiled']:.1f}% of an unprofiled one; "
          f"peak {t['peak_gib']:.3f} GiB; by category: " + ", ".join(
              f"{c} {ms:.3f} ms" for c, ms in sorted(
                  t["category_ms"].items(), key=lambda kv: -kv[1])))


def dreamer_card_vs_cpu(algo) -> dict:
    """(d) One dreamer_update of ``algo``'s params on a batch from its
    ring, on the card against the CPU with the same noise: every loss
    term, every gradient leaf, the params after the step."""
    import torch
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.rl import dreamer
    from ray_tpu_torch.rl.ppo import params_from_jax, params_to_numpy
    from ray_tpu_torch.train.optim import adam, chain, clip_by_global_norm

    cfg = algo.cfg
    static = (cfg.horizon, cfg.gamma, cfg.lam, cfg.free_bits, cfg.ent_coef)
    batch = {k: v.cpu() for k, v in algo._sample_batch().items()}
    noise = dreamer.update_noise(torch.Generator().manual_seed(SEED + 18),
                                 cfg.batch_seqs, cfg.seq_len, cfg.horizon,
                                 cfg.latent, algo.num_actions, "cpu")
    host = params_to_numpy(algo.params)
    bounds = torch.tensor([algo._rew_lo, algo._rew_hi])
    out = {}
    for dev in ("cuda", "cpu"):
        p = params_from_jax(host, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        n = {k: v.to(dev) for k, v in noise.items()}
        total, m = dreamer.dreamer_loss(static, algo.num_actions, p, b,
                                        bounds.to(dev), n)
        grads = torch.autograd.grad(total, tree_leaves(p))
        opt = chain(clip_by_global_norm(100.0), adam(cfg.lr))
        p, _, _ = dreamer.dreamer_update(opt, static, algo.num_actions, p,
                                         opt.init(p), b, bounds.to(dev), n)
        out[dev] = (m, [g.cpu() for g in grads], tree_leaves(p))
    res: dict = {}
    (m, g, p), (mw, gw, pw) = out["cuda"], out["cpu"]
    _check("dreamer_update loss terms", max(
        _rel_err(m[k], mw[k]) for k in mw), DREAMER_LOSS_TOL, res)
    _check("dreamer_update gradients (of each leaf's largest)", max(
        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        for a, b in zip(g, gw)), DREAMER_GRAD_TOL, res)
    held = free = 0.0
    n_free = 0
    for a, b, gb in zip(p, pw, gw):
        diff = (a.detach().cpu() - b.detach()).abs()
        keep = gb.abs() >= DREAMER_HELD_FROM * gb.abs().max()
        held = max(held, float(diff[keep].max()) if keep.any() else 0.0)
        if (~keep).any():
            free = max(free, float(diff[~keep].max()))
            n_free += int((diff[~keep] > DREAMER_PARAM_TOL).sum())
    _check("dreamer_update params (|g| >= 1e-3 of the leaf's largest)",
           held, DREAMER_PARAM_TOL, res)
    _check("dreamer_update params (the rest: at most 2 lr)", free,
           2 * cfg.lr, res)
    print(f"  params off by more than {DREAMER_PARAM_TOL:.0e} where |g| < "
          f"1e-3 of the leaf's largest: {n_free}")
    res["params_past_1e-5_with_small_g"] = n_free
    return res


def phase_rl_rest() -> dict:
    """Phase 18: the rest of RL on the card. (a) BC, MARWIL and CQL on
    the expert dataset, their updates against the CPU; (b) MultiAgentPPO
    with a shared and with two policies; (c) Dreamer at its defaults, 24
    iterations, its update timed at the default and at DreamerV3's S
    geometry; (d) one Dreamer update against the CPU. No kernel of
    csrc/ runs on this path: the counts, set to 0 at the start, must
    stay 0."""
    import torch
    from ray_tpu_torch.data import from_blocks
    from ray_tpu_torch.rl import (BCConfig, CQLConfig, DreamerConfig,
                                  MARWILConfig, MultiAgentPPOConfig)
    from ray_tpu_torch.rl.dreamer import update_noise

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t_phase = time.perf_counter()
    out: dict = {}

    _phase("RL, the rest (a): BC, MARWIL, CQL on the expert CartPole data")
    ds = from_blocks(expert_cartpole_blocks())
    rows = ds.count()
    print(f"dataset: {rows} transitions of {RL18_EPISODES} expert episodes "
          f"in {ds.num_blocks()} blocks")
    off: dict = {"rows": rows}
    for label, cfg, steps in (
            ("bc", BCConfig(dataset=ds, epochs_per_step=BC_EPOCHS,
                            evaluation_episodes=3, seed=SEED), BC_STEPS),
            ("marwil", MARWILConfig(dataset=ds, seed=SEED), RL18_STEPS),
            ("cql", CQLConfig(dataset=ds, seed=SEED), RL18_STEPS)):
        algo = cfg.build()
        epochs = cfg.epochs_per_step
        t0 = time.perf_counter()
        ms = [algo.train_step() for _ in range(steps)]
        dt = time.perf_counter() - t0
        last = {k: v for k, v in ms[-1].items()
                if isinstance(v, float) and k != "done"}
        rate = steps * epochs * rows / dt
        evals = (f", {cfg.evaluation_episodes} evaluation episodes a step "
                 "included" if cfg.evaluation_episodes else "")
        print(f"  {label}: {steps} steps x {epochs} epochs, {rate:.1f} "
              f"samples/s (host clock{evals}), last "
              + ", ".join(f"{k} {v:.4f}" for k, v in last.items()))
        if not all(math.isfinite(v) for v in last.values()):
            raise AssertionError(f"phase 18a {label}: {last}")
        off[label] = {"samples_per_s": rate, **last}
    acc = off["bc"]["action_accuracy"]
    print(f"BC action accuracy {acc:.4f} (limit > {BC_ACC_BAR}), greedy "
          f"return {off['bc']['episode_return_mean']:.1f}")
    if not acc > BC_ACC_BAR:
        raise AssertionError(f"phase 18a: BC action accuracy {acc}")
    off["card_vs_cpu"] = rl_offline_check(ds)
    out["offline"] = off

    _phase("RL, the rest (b): multi-agent PPO, shared and two policies")
    multi: dict = {}
    for label, kw in (("CoordinationGame, shared", {}),
                      ("ChaseGame, pred + prey", dict(
                          env="ChaseGame", policies=("pred", "prey"),
                          policy_mapping={"pred0": "pred", "pred1": "pred",
                                          "prey": "prey"}))):
        algo = MultiAgentPPOConfig(seed=SEED, **kw).build()
        agents = len(algo._runner.env.agent_ids)
        t0 = time.perf_counter()
        ms = [algo.train_step() for _ in range(RL18_STEPS)]
        dt = time.perf_counter() - t0
        steps = RL18_STEPS * algo.cfg.rollout_len
        losses = {k: v for k, v in ms[-1].items()
                  if k.endswith(("policy_loss", "vf_loss"))}
        print(f"  {label}: {RL18_STEPS} steps, {steps / dt:.1f} env-steps/s"
              f" ({agents * steps / dt:.1f} agent-steps/s, host clock), "
              f"last " + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()))
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"phase 18b {label}: {losses}")
        multi[label] = {"env_steps_per_s": steps / dt,
                        "agent_steps_per_s": agents * steps / dt, **losses,
                        "card_vs_cpu": rl_multi_agent_check(algo)}
    out["multi_agent"] = multi

    _phase(f"RL, the rest (c): Dreamer, DreamerConfig() on CartPole-v1, "
           f"{DREAMER_ITERS} iterations")
    cfg = DreamerConfig(seed=SEED)
    algo = cfg.build()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    returns = [algo.step()["episode_return_mean"]
               for _ in range(DREAMER_ITERS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    updates = cfg.train_steps_per_iter * sum(
        1 for i in range(1, DREAMER_ITERS + 1)
        if i * (cfg.env_steps_per_iter // cfg.num_envs) * cfg.num_envs
        >= cfg.learning_starts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    best = max(returns[-6:])
    print("episode_return_mean by iteration: "
          + " ".join(f"{r:.2f}" for r in returns))
    print(f"max of the last 6 {best:.2f} against the JAX test's bar "
          f"{DREAMER_BAR} ({'reached' if best >= DREAMER_BAR else 'not reached'}"
          "; a finding, not a gate: the card's random stream is not JAX's)")
    print(f"{algo.total_env_steps} env steps and {updates} updates in "
          f"{dt:.1f} s: {algo.total_env_steps / dt:.1f} env-steps/s (host "
          f"clock, updates included), peak {peak:.3f} GiB")
    dream = {"returns": returns, "max_last6": best, "bar": DREAMER_BAR,
             "env_steps": algo.total_env_steps, "updates": updates,
             "seconds": dt, "env_steps_per_s": algo.total_env_steps / dt,
             "peak_gib": peak}
    batch = algo._sample_batch()
    bounds = torch.tensor([algo._rew_lo, algo._rew_hi], device="cuda")
    noise = update_noise(algo._gen, cfg.batch_seqs, cfg.seq_len,
                         cfg.horizon, cfg.latent, algo.num_actions, "cuda")
    t = dreamer_update_times(cfg, algo.params, algo.optimizer,
                             algo.opt_state, batch, bounds, noise,
                             algo.num_actions)
    _print_dreamer_times(f"dreamer_update at the defaults (B{cfg.batch_seqs}"
                         f" T{cfg.seq_len} H{cfg.horizon} det {cfg.det} "
                         f"hidden {cfg.hidden})", t)
    dream["update_defaults"] = t
    s_cfg = DreamerConfig(**DREAMER_V3_S)
    inputs = _dreamer_inputs(s_cfg, algo.obs_size, algo.num_actions, "cuda")
    t = dreamer_update_times(s_cfg, *inputs, algo.num_actions)
    _print_dreamer_times(
        f"dreamer_update at DreamerV3's S geometry (B{s_cfg.batch_seqs} "
        f"T{s_cfg.seq_len} H{s_cfg.horizon} det {s_cfg.det} hidden "
        f"{s_cfg.hidden} latent {s_cfg.latent})", t)
    dream["update_v3_s"] = t
    del inputs
    out["dreamer"] = dream

    _phase("RL, the rest (d): one dreamer_update, cuda against cpu")
    out["dreamer_card_vs_cpu"] = dreamer_card_vs_cpu(algo)

    launches = {k: c.launches for k, c in counters.items()}
    print(f"kernel launches in phase 18: {launches} (this path reaches no "
          "TPU kernel)")
    if any(launches.values()):
        raise AssertionError(f"phase 18: kernels launched {launches}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 18: {out['phase_s']:.1f} s")
    return out


RANKS_TIMEOUT_S = 600
# Limit on the CP losses after each update against one card's mesh=None
# run from the same params and batch, absolute: the ranks' bf16 partial
# gradients round before the sum, and K3's dq order differs run to run
# (P13B_TOL's reasoning; the first loss keeps CP_LOSS_TOL).
CP_STEPS_TOL = 2e-2


def _first_grads(opt, seen: list):
    """``opt`` that keeps, in ``seen``, a copy of the gradient leaves its
    first update is handed: the step's averaged gradients."""
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.train.optim import GradientTransformation

    def update(grads, state, params=None):
        if not seen:
            seen.extend(g.detach().clone() for g in tree_leaves(grads))
        return opt.update(grads, state, params)

    return GradientTransformation(opt.init, update)


def _rank_main(rank: int, world: int, store: str, out_path: str) -> None:
    """One rank of ``phase_ranks``, on card ``rank``; rank 0 writes its
    readings to ``out_path``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch._device import tree_leaves
    from ray_tpu_torch.models.llama import LlamaConfig, init_params, loss_fn
    from ray_tpu_torch.ops import attention as att
    from ray_tpu_torch.ops.ring_attention import (
        ring_attention_local,
        ring_attention_sharded,
    )
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world, device_id=dev)
    res = {}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    # 1. Ring attention over the ranks against one card's flash.
    gen = torch.Generator().manual_seed(SEED + 3)
    m = CP_ATTN
    q, k, v, do = (torch.randn((m["b"], h, m["s"], m["d"]), generator=gen)
                   .to(dev, torch.bfloat16)  # the same on every rank
                   for h in (m["h"], m["hkv"], m["hkv"], m["h"]))
    for t in (q, k, v):
        t.requires_grad_()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = ring_attention_sharded(q, k, v, impl="flash")
    # Each rank takes 1/world of the global loss; all_gather's backward
    # sums the ranks' cotangents.
    ((out.float() * do.float()).sum() / world).backward()
    # Each rank's gradients are its own shard's rows (zero elsewhere):
    # gather the shards into the whole sequence's.
    rows = slice(rank * m["s"] // world, (rank + 1) * m["s"] // world)
    grads = []
    for t in (q, k, v):
        own = t.grad[:, :, rows].contiguous()
        parts = [torch.empty_like(own) for _ in range(world)]
        dist.all_gather(parts, own)
        grads.append(torch.cat(parts, dim=2))
    sync()
    res["ring_launches"] = {k_: c.launches for k_, c in counters.items()}
    if rank == 0:
        ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        want = att.flash_attention(*ref, True)
        want.backward(do)
        res["ring_errs"] = ring_errors((out, *grads),
                                       (want, *(r.grad for r in ref)), world)
        del ref, want
    # The ring alone on this rank's shard, forward + backward, timed on
    # the host clock around a barrier (the shifts wait on peers).
    ql, kl, vl = (t.detach()[:, :, rows].clone().requires_grad_()
                  for t in (q, k, v))

    def ring_step():
        ring_attention_local(ql, kl, vl, None, impl="flash").backward(
            do[:, :, rows])

    ring_step()
    sync()
    t0 = time.perf_counter()
    for _ in range(3):
        ring_step()
    sync()
    res["ring_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    del q, k, v, do, out, grads, ql, kl, vl
    torch.cuda.empty_cache()

    # 2. The context-parallel Llama through the step factory over an sp
    # mesh (the ring over its sp group, gradients averaged by the step),
    # against one card's mesh=None factory on rank 0 from the same params
    # and batch: the first step's loss, grad norm and averaged gradients,
    # leaf by leaf, as each optimizer is handed them, then the losses
    # after each update.
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=CP_SEQ)
    params = init_params(cfg, generator=SEED, device=dev)
    names = list(_leaf_names(params))
    tokens_np = np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (1, CP_SEQ), dtype=np.int32)
    tokens = torch.from_numpy(tokens_np).to(dev)
    targets_np = np.roll(tokens_np, -1, axis=1)
    opt = adamw_lowmem(3e-4, weight_decay=0.1)
    mesh = build_mesh(MeshSpec(sp=world))
    res["hidden_row_err"] = cp_hidden_err(cfg, params, tokens,
                                          mesh.get_group("sp"))
    if rank == 0:
        ref_grads = []
        step, init, shard = make_llama_train_step(
            cfg, None, optimizer=_first_grads(opt, ref_grads),
            remat="attn+", seed=SEED, device=dev)
        state = init(params)
        tok, tgt = shard(tokens_np), shard(targets_np)
        res["ref_losses"] = []
        for _ in range(CP_STEPS + 1):
            state, met = step(state, tok, tgt)
            res["ref_losses"].append(float(met["loss"]))
            res.setdefault("ref_grad_norm", float(met["grad_norm"]))
        res["ref_loss"] = res["ref_losses"][0]
        del state, step, init, shard, tok, tgt
        # sp_axis=None's backward once more: what K3's dq atomics make of
        # the same gradients, the floor of the CP reading.
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_()
        _, again = _loss_grads(lambda: loss_fn(
            cfg, params, tokens, torch.roll(tokens, -1, dims=1),
            remat="attn+"), leaves)
        res["plain_grad_errs"] = _grad_errs(names, again, ref_grads)
        del again, leaves
    del tokens
    seen = []
    step, init, shard = make_llama_train_step(
        cfg, mesh, optimizer=_first_grads(opt, seen) if rank == 0 else opt,
        remat="attn+", seed=SEED, device=dev)
    state = init(params)
    del params
    torch.cuda.empty_cache()
    tok, tgt = shard(tokens_np), shard(targets_np)
    for c in counters.values():
        c.launches = 0
    state, met = step(state, tok, tgt)
    res["loss"], res["grad_norm"] = float(met["loss"]), float(
        met["grad_norm"])
    if rank == 0:
        res["grad_errs"] = _grad_errs(names, seen, ref_grads)
        del seen, ref_grads
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses = [res["loss"]]
    sync()
    t0 = time.perf_counter()
    for _ in range(CP_STEPS):
        state, met = step(state, tok, tgt)
        losses.append(met["loss"])
    sync()
    res["cp_step_ms"] = (time.perf_counter() - t0) / CP_STEPS * 1e3
    res["losses"] = [float(x) for x in losses]
    res["cp_launches"] = {k_: c.launches / (CP_STEPS + 1)
                          for k_, c in counters.items()}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2.0 ** 30
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def phase_ranks(world: int) -> dict:
    """The ring over ``world`` ranks, one card each (NCCL): ring attention
    at B1 H32 Hkv8 S16384 D64 against flash_fwd/flash_bwd on rank 0's card
    (RING_CHUNK_TOL), and the context-parallel Llama at the 1.1B geometry, b1
    s16384 (s16384 / world tokens a rank) through
    make_llama_train_step over build_mesh(MeshSpec(sp=world)): the final
    hidden states, and the first step's loss, grad norm and each leaf's
    averaged gradient against one card's mesh=None step from the same
    params and batch (check_cp's limits); then timed steps with their
    updates, whose losses hold to CP_STEPS_TOL of one card's."""
    import tempfile

    from ray_tpu_torch._spawn import run_ranks

    _phase(f"ring over {world} ranks, one card each: attention at "
           f"S{CP_SEQ} and the context-parallel Llama at s{CP_SEQ}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        run_ranks(_rank_main, world, tmp, (out_path,), RANKS_TIMEOUT_S)
        with open(out_path) as f:
            res = json.load(f)
    wall = time.perf_counter() - t0
    errs = res["ring_errs"]
    print(f"ring attention over {world} ranks: "
          f"{res['ring_launches']['flash_chunk_fwd']} K6 + "
          f"{res['ring_launches']['flash_chunk_bwd']} K7 launches on rank 0;"
          f" against flash_fwd/flash_bwd on one card, worst (head, chunk) "
          f"block's error over its norm (max abs err over the largest "
          f"value): "
          + ", ".join(f"{k} {e:.3e} ({g:.3e})" for k, (e, g) in errs.items())
          + f"; the ring alone on rank 0's shard, forward + backward: "
          f"{res['ring_ms']:.2f} ms")
    want = {"flash_chunk_fwd": world, "flash_chunk_bwd": world}
    if any(res["ring_launches"][k] != n for k, n in want.items()) or \
            res["ring_launches"]["flash_fwd"]:
        raise AssertionError(f"ring launches {res['ring_launches']}, want "
                             f"{want} a rank")
    check_ring_errors(errs, f"ring over {world} ranks")
    label = (f"context-parallel Llama over {world} ranks through the step "
             f"factory (sp={world} mesh), first step")
    check_cp(res, label)
    norm_rel = abs(res["grad_norm"] - res["ref_grad_norm"]) / \
        res["ref_grad_norm"]
    if not norm_rel < CP_GRAD_TOL:
        raise AssertionError(f"{label}: grad norm {norm_rel:.3e} relative "
                             f"off one card's (limit {CP_GRAD_TOL})")
    diff = max(abs(a - b) for a, b in zip(res["losses"], res["ref_losses"]))
    print(f"losses after each update against one card's mesh=None: "
          + " ".join(f"{a:.6f}/{b:.6f}" for a, b in
                     zip(res["losses"], res["ref_losses"]))
          + f"; worst {diff:.3e} (limit {CP_STEPS_TOL})")
    _check_losses(f"CP over {world} ranks", res["losses"],
                  res["ref_losses"], CP_STEPS_TOL, False)
    toks = CP_SEQ / (res["cp_step_ms"] / 1e3)
    want = {k: float(n) for k, n in
            predicted_launches("attn+", BENCH_GEOMETRY["num_layers"],
                               ring=world).items()}
    print(f"context-parallel Llama over {world} ranks, whole steps (forward "
          f"+ backward, gradients averaged over the sp group, adamw_lowmem "
          f"update): {res['cp_step_ms']:.2f} ms a step on rank 0's host "
          f"clock = {toks:.1f} tokens/s; losses "
          + " ".join(f"{x:.4f}" for x in res["losses"])
          + "; launches a step on rank 0 "
          + ", ".join(f"{k} {n:g}" for k, n in res["cp_launches"].items())
          + f"; peak device memory over the timed steps "
          f"{res['peak_gib']:.3f} GiB on rank 0; "
          f"phase wall {wall:.1f} s")
    if res["cp_launches"] != want:
        raise AssertionError(f"CP launches a step on rank 0 "
                             f"{res['cp_launches']} != the prediction {want}")
    res["tokens_per_s"] = toks
    return res


# Phase 17: the serving engine's block pool, speculative decoding, P/D
# hand-off and checkpoint loading at Llama-3.2-1B width.
#
# A bf16 speculative stream may leave plain greedy's only at a near-tie:
# at its first differing position the plain stream, teacher-forced through
# prefill (f32 logits), must score the two tokens within SPEC_TIE_ULPS
# bf16 steps (2^-8 relative) of the row's largest |logit|. Set before the
# first run: one path's bf16 roundings against another's move a logit by
# about one such step at 16 layers; a wrong token (stale KV, a bad
# acceptance) misses by the logits' spread, ~0.9 at this init.
SPEC_TIE_ULPS = 4
REST_BLOCK = 16          # kv_block_size
REST_BLOCKS = 512        # 8192 tokens: phase 7's 8 dense slots x 1024
REST_SLOTS = 16          # twice phase 7's slots on the same KV bytes
REST_SPEC_K = 4
REST_SMALL_POOL = 160    # blocks: fewer than the f32 wave needs at 16 slots
REST_PD_LENGTHS = (128, 700)
REST_DEVICE = "cuda"


def _wave_prompts(rng):
    """Phase 7's prompts: 15 of 32-200 random tokens and a 12-token one."""
    short = [int(t) for t in rng.integers(0, 256, 12)]
    wave = [[int(t) for t in rng.integers(0, 256, int(n))]
            for n in rng.integers(32, 201, 15)] + [short]
    return short, wave


def _f32_1b():
    """The exact gates' model: Llama-3.2-1B's widths and vocabulary, two
    layers, f32 (TF32 is off: phase_device)."""
    from dataclasses import replace

    from ray_tpu_torch.models.llama import LlamaConfig
    return replace(LlamaConfig.llama3_1b(), num_layers=2, dtype="float32")


def _bf16_1b():
    """The timed runs' model: Llama-3.2-1B's geometry, bf16, full depth."""
    from ray_tpu_torch.llm import LLMConfig
    return LLMConfig(model="llama3_1b", dtype="bfloat16").model_config()


def _streams(done) -> dict:
    return {i: list(req.out_tokens) for i, req in done}


def _engine(cfg, params, **kw):
    from ray_tpu_torch.llm import LLMConfig, LLMEngine

    base = dict(model=cfg, max_num_seqs=8, max_seq_len=1024,
                decode_burst=16, seed=SEED)
    base.update(kw)
    return LLMEngine(LLMConfig(**base), params=params, device=REST_DEVICE)


def _first_diff(a: list, b: list):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def spec_tie_check(mc, weights, prompt, plain, spec) -> dict:
    """Where a speculative stream first leaves the plain one: the two
    tokens' f32 logits under the plain stream teacher-forced through
    prefill, against SPEC_TIE_ULPS bf16 steps at the row's scale."""
    import numpy as np
    import torch
    from ray_tpu_torch.llm.engine import init_kv_cache, prefill

    i = _first_diff(plain, spec)
    if i is None:
        return {"differs": False}
    if i >= min(len(plain), len(spec)):
        raise AssertionError(f"speculative stream ended apart from plain "
                             f"at {i} ({len(spec)} vs {len(plain)})")
    seq = list(prompt) + list(plain[:i])
    s = -(-len(seq) // 64) * 64
    toks = np.zeros((s,), np.int64)
    toks[:len(seq)] = seq
    cache = init_kv_cache(mc, 1, s, REST_DEVICE)
    _, logits = prefill(mc, weights, cache, toks, len(seq), 0)
    la, lb = float(logits[plain[i]]), float(logits[spec[i]])
    scale = float(logits.abs().max())
    margin = SPEC_TIE_ULPS * 2.0 ** -8 * scale
    out = {"differs": True, "at": i, "gap": abs(la - lb),
           "margin": margin, "top": int(torch.argmax(logits))}
    if abs(la - lb) > margin:
        raise AssertionError(f"speculative token {spec[i]} at {i} is not "
                             f"a near-tie of plain {plain[i]}: {out}")
    return out


def _busy_ms(fn):
    """(device ms, {kernel: ms}) of one call of ``fn`` under the
    profiler: the sum of its CUDA kernels' durations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    return sum(by_name.values()), by_name


def _host_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def rest_blocked_gates(prompts, greedy64) -> dict:
    """(a) f32 gates: dense vs blocked greedy on phase 7's prompts, then a
    pool too small for the wave (preemption) against the same tokens."""
    from ray_tpu_torch.models.llama import init_params

    mc = _f32_1b()
    params = init_params(mc, generator=SEED, device=REST_DEVICE)
    out = {}
    dense = _engine(mc, params)
    try:
        done, _, _, _ = run_wave(dense, prompts, greedy64, concurrency=8)
        want = _streams(done)
    finally:
        dense.shutdown()
        del dense
    for label, blocks in (("blocked", REST_BLOCKS),
                          ("small_pool", REST_SMALL_POOL)):
        eng = _engine(mc, params, max_num_seqs=REST_SLOTS,
                      kv_block_size=REST_BLOCK, kv_num_blocks=blocks)
        try:
            done, _, _, _ = run_wave(eng, prompts, greedy64,
                                     concurrency=REST_SLOTS)
            got = _streams(done)
            st = eng.stats()
        finally:
            eng.shutdown()
            del eng
        bad = [i for i in want if got[i] != want[i]]
        if bad:
            raise AssertionError(f"{label}: prompts {bad} differ from the "
                                 f"dense engine's greedy tokens")
        if label == "small_pool" and st["preemptions"] < 1:
            raise AssertionError(f"{blocks} blocks never preempted")
        out[label] = {"preemptions": st["preemptions"],
                      "blocks": blocks, "tokens": sum(map(len, got.values()))}
        print(f"{label} ({blocks} blocks of {REST_BLOCK}, {REST_SLOTS} "
              f"slots, f32 2-layer): {len(prompts)} greedy streams equal "
              f"the dense engine's; preemptions {st['preemptions']}")
    return out


def rest_blocked_timed(mc, params, prompts, greedy64, rng) -> dict:
    """(a) bf16 at full depth: phase 7's wave on the dense engine at
    concurrency 8 and on the blocked one at 16, in turns; block prefix
    adoption; decode_burst_blocked against decode_burst."""
    import numpy as np
    import torch
    from ray_tpu_torch.llm.engine import (decode_burst, decode_burst_blocked,
                                          init_kv_cache,
                                          init_kv_cache_blocked)

    dense = _engine(mc, params)
    blocked = _engine(mc, params, max_num_seqs=REST_SLOTS,
                      kv_block_size=REST_BLOCK, kv_num_blocks=REST_BLOCKS)
    w = dense._weights
    out = {}
    try:
        pool = sum(t.numel() * t.element_size()
                   for t in blocked.cache.values())
        dense_kv = sum(t.numel() * t.element_size()
                       for t in dense.cache.values())
        print(f"KV bytes: blocked pool {pool / 2 ** 20:.1f} MiB "
              f"({REST_BLOCKS} x {REST_BLOCK} tokens, {REST_SLOTS} slots), "
              f"dense {dense_kv / 2 ** 20:.1f} MiB (8 slots x 1024)")
        runs = {"dense": (dense, 8), "blocked": (blocked, REST_SLOTS)}
        for eng, conc in runs.values():  # warm-up
            run_wave(eng, prompts, greedy64, concurrency=conc)
        rates = {k: [] for k in runs}
        p50s = {k: [] for k in runs}
        order = ["dense", "blocked", "blocked", "dense", "dense", "blocked"]
        for name in order:
            eng, conc = runs[name]
            fresh = [[int(t) for t in rng.integers(0, 256, len(p))]
                     for p in prompts]
            _, wave_s, ttft, toks = run_wave(eng, fresh, greedy64,
                                             concurrency=conc)
            rates[name].append(toks / wave_s)
            p50s[name].append(statistics.median(ttft) * 1e3)
        for name, (eng, conc) in runs.items():
            st = eng.stats()
            out[name] = {"concurrency": conc,
                         "tok_per_s": statistics.median(rates[name]),
                         "tok_per_s_min": min(rates[name]),
                         "tok_per_s_max": max(rates[name]),
                         "ttft_p50_ms": statistics.median(p50s[name]),
                         "ttft_p50_ms_min": min(p50s[name]),
                         "ttft_p50_ms_max": max(p50s[name]),
                         "preemptions": st.get("preemptions")}
            print(f"{name} at concurrency {conc} ({len(rates[name])} waves "
                  f"in turns): tok/s {_spread(rates[name])}; TTFT p50 ms "
                  f"{_spread(p50s[name])}; preemptions "
                  f"{st.get('preemptions')}")
        out["pool_bytes"] = pool
        out["dense_kv_bytes"] = dense_kv

        prefix = [int(t) for t in rng.integers(0, 256, 128)]
        shared = [prefix + [int(t) for t in rng.integers(0, 256, 20)]
                  for _ in range(2)]
        from ray_tpu_torch.llm import SamplingParams
        hits0 = blocked.stats()["prefix_hits"]
        donor = blocked.submit(shared[0], SamplingParams(max_tokens=256))
        deadline = time.time() + 120
        while not blocked._prefix_live and time.time() < deadline:
            time.sleep(0.002)
        blocked.generate(shared[1], greedy64)
        if not donor.done.wait(300) or donor.error:
            raise AssertionError(f"prefix donor: {donor.error}")
        st = blocked.stats()
        hits = st["prefix_hits"] - hits0
        if hits < 1:
            raise AssertionError("blocked prefix adoption: no hit")
        out["prefix_hits"] = hits
        out["prefix_tokens_saved"] = st["prefix_tokens_saved"]
        print(f"blocked prefix adoption through copy_blocks: {hits} hit, "
              f"{st['prefix_tokens_saved']} tokens reused")
    finally:
        dense.shutdown()
        blocked.shutdown()
        del dense, blocked

    # The gather's cost: one 16-step burst, 8 slots at position 600.
    b, pos = 8, 600
    tokens = np.arange(b, dtype=np.int64)
    posv = np.full(b, pos, np.int64)
    write = np.ones(b, bool)
    temps, top_ps = np.zeros(b, np.float32), np.ones(b, np.float32)
    gen = torch.Generator(device=REST_DEVICE)
    gen.manual_seed(SEED)
    cache = init_kv_cache(mc, b, 1024, REST_DEVICE)
    pool = init_kv_cache_blocked(mc, REST_BLOCKS, REST_BLOCK, REST_DEVICE)
    mb = 1024 // REST_BLOCK
    tables = np.arange(b * mb, dtype=np.int32).reshape(b, mb)

    def dense_burst():
        decode_burst(mc, w, cache, tokens, posv, write, temps, top_ps, gen,
                     16, False)

    def blocked_burst():
        decode_burst_blocked(mc, w, pool, tables, tokens, posv, write, temps,
                             top_ps, gen, 16, False)

    # The burst is host-bound (its wall is the eager loop's enqueue), so
    # the gathers' cost is read as device time: the kernels' sum in a
    # profiled burst, each side profiled twice in turns.
    walls = {"dense": [], "blocked": []}
    busy = {"dense": [], "blocked": []}
    kern = {}
    for name in ("dense", "blocked", "blocked", "dense"):
        fn = dense_burst if name == "dense" else blocked_burst
        walls[name].append(events_ms(fn, 3))
        ms, by_name = _busy_ms(fn)
        busy[name].append(ms)
        kern[name] = by_name
    d_ms, b_ms = (statistics.mean(walls[k]) for k in ("dense", "blocked"))
    d_busy, b_busy = (statistics.mean(busy[k]) for k in ("dense", "blocked"))
    # What the gathers move: each layer and step reads the 8 slots'
    # 1024-position K and V lines from the pool and writes them once.
    gather_bytes = 2 * 2 * mc.num_layers * b * 1024 * mc.num_kv_heads * \
        mc.head_dim * 2 * 16
    out["burst_ms"] = {"dense_wall": d_ms, "blocked_wall": b_ms,
                       "dense_busy": d_busy or None,
                       "blocked_busy": b_busy or None,
                       "gather_busy_ms": (b_busy - d_busy) if d_busy
                       else None,
                       "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3}
    print(f"16-step burst, 8 slots at {pos}, in turns: wall (CUDA events) "
          f"decode_burst {d_ms:.3f} ms, decode_burst_blocked {b_ms:.3f} ms; "
          f"the gathers move {gather_bytes / 2 ** 30:.2f} GiB = "
          f"{out['burst_ms']['gather_bound_ms']:.3f} ms at HBM rate")
    if d_busy and b_busy:
        print(f"  device busy (profiler) dense {d_busy:.3f} ms, blocked "
              f"{b_busy:.3f} ms: the gathers +{b_busy - d_busy:.3f} ms "
              f"({100 * (b_busy / d_busy - 1):.1f}% of the dense busy, "
              f"{100 * (b_busy - d_busy) / b_ms:.1f}% of the blocked wall)")
        extra = {k: v - kern["dense"].get(k, 0.0)
                 for k, v in kern["blocked"].items()}
        for k, v in sorted(extra.items(), key=lambda kv: -kv[1])[:4]:
            print(f"    +{v:8.3f} ms  {k[:90]}")
    else:
        print("  device busy: not measured (profiler saw no kernels)")
    del cache, pool
    return out


def rest_spec(prompts, mc16, params16) -> dict:
    """(b) speculative decoding: f32 gates with a perfect and a seeded
    2-layer draft; bf16 at full depth with the near-tie rule; the tick's
    split and a K+1 verify against K+1 decode steps."""
    from dataclasses import replace

    import numpy as np
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.llm.engine import (decode_step, draft_propose,
                                          init_kv_cache, spec_verify_step)
    from ray_tpu_torch.models.llama import init_params

    greedy = SamplingParams(max_tokens=64, temperature=0.0)
    some = prompts[:4]
    out = {"f32": {}, "bf16": {}}
    mc = _f32_1b()
    params = init_params(mc, generator=SEED, device=REST_DEVICE)
    plain = _engine(mc, params)
    try:
        want = [plain.generate(p, greedy).token_ids for p in some]
    finally:
        plain.shutdown()
        del plain
    for draft in ("perfect", "seeded"):
        eng = _engine(mc, params, speculative_model=mc,
                      speculative_tokens=REST_SPEC_K)
        try:
            if draft == "perfect":
                eng.draft_params = params
            got = [eng.generate(p, greedy).token_ids for p in some]
            st = eng.stats()
        finally:
            eng.shutdown()
            del eng
        if got != want:
            raise AssertionError(f"f32 speculative ({draft} draft) tokens "
                                 f"differ from plain greedy")
        if draft == "perfect" and st["spec_acceptance"] <= 0.9:
            raise AssertionError(f"perfect draft accepted only "
                                 f"{st['spec_acceptance']}")
        out["f32"][draft] = {"acceptance": st["spec_acceptance"],
                             "ticks": st["spec_ticks"]}
        print(f"f32 2-layer, {draft} draft: {len(some)} streams equal plain "
              f"greedy; acceptance {st['spec_acceptance']} over "
              f"{st['spec_ticks']} ticks")
    del params

    # bf16, full depth: the 16-layer target; drafts: itself and a seeded
    # 2-layer model at its widths and vocabulary.
    draft_cfg = replace(mc16, num_layers=2)
    plain = _engine(mc16, params16)
    try:
        t0 = time.perf_counter()
        want = [plain.generate(p, greedy).token_ids for p in some]
        plain_s = time.perf_counter() - t0
        w16 = plain._weights
    finally:
        plain.shutdown()
        del plain
    out["bf16"]["plain_tok_per_s"] = sum(map(len, want)) / plain_s
    for draft in ("perfect", "seeded"):
        eng = _engine(mc16, params16,
                      speculative_model=mc16 if draft == "perfect"
                      else draft_cfg, speculative_tokens=REST_SPEC_K)
        try:
            if draft == "perfect":
                eng.draft_params = params16
            t0 = time.perf_counter()
            got = [eng.generate(p, greedy).token_ids for p in some]
            spec_s = time.perf_counter() - t0
            st = eng.stats()
            dw = eng._draft_weights
            dcfg = eng.draft_cfg
        finally:
            eng.shutdown()
            del eng
        ties = [spec_tie_check(mc16, w16, p, a, b)
                for p, a, b in zip(some, want, got)]
        out["bf16"][draft] = {
            "acceptance": st["spec_acceptance"], "ticks": st["spec_ticks"],
            "tok_per_s": sum(map(len, got)) / spec_s, "ties": ties}
        print(f"bf16 16-layer, {draft} draft: acceptance "
              f"{st['spec_acceptance']} over {st['spec_ticks']} ticks, "
              f"{out['bf16'][draft]['tok_per_s']:.1f} tok/s sequential vs "
              f"plain {out['bf16']['plain_tok_per_s']:.1f} (random weights:"
              f" acceptance and gain mean nothing); streams differing at a "
              f"near-tie {sum(t['differs'] for t in ties)}/{len(ties)}: "
              f"{[t for t in ties if t['differs']]}")
        if draft == "seeded":
            seeded_w, seeded_cfg = dw, dcfg

    # The tick's split, 8 slots at 600: draft_propose (seeded 2-layer
    # draft, k + 1 steps), spec_verify_step (K + 1 = 5 tokens), and five
    # single decode steps of the target.
    b, pos, k = 8, 600, REST_SPEC_K
    tok0 = np.arange(b, dtype=np.int64)
    posv = np.full(b, pos, np.int64)
    write = np.ones(b, bool)
    cache = init_kv_cache(mc16, b, 1024, REST_DEVICE)
    dcache = init_kv_cache(seeded_cfg, b, 1024, REST_DEVICE)
    verify = np.tile(np.arange(k + 1, dtype=np.int64), (b, 1))

    def propose():
        draft_propose(seeded_cfg, seeded_w, dcache, tok0, posv, k, write)

    def verify_step():
        spec_verify_step(mc16, w16, cache, verify, posv, write)

    def steps():
        for j in range(k + 1):
            decode_step(mc16, w16, cache, tok0, posv + j, write)

    t = {"propose": [], "verify": [], "steps": []}
    for name in ("propose", "verify", "steps", "steps", "verify", "propose"):
        t[name].append(events_ms({"propose": propose, "verify": verify_step,
                                  "steps": steps}[name], 5))
    ms = {n: statistics.mean(v) for n, v in t.items()}
    out["tick_ms"] = {"draft_propose": ms["propose"],
                      "spec_verify_step": ms["verify"],
                      "decode_steps_5": ms["steps"],
                      "verify_over_steps": ms["verify"] / ms["steps"]}
    print(f"speculative tick, 8 slots at {pos} (CUDA events, in turns): "
          f"draft_propose (2-layer draft, {k + 1} steps) "
          f"{ms['propose']:.3f} ms + spec_verify_step ({k + 1} tokens) "
          f"{ms['verify']:.3f} ms; {k + 1} single decode steps "
          f"{ms['steps']:.3f} ms (verify / steps "
          f"{ms['verify'] / ms['steps']:.3f})")
    return out


def rest_pd(mc, params, rng, greedy64) -> dict:
    """(c) the P/D hand-off between two engines on one param tree (bf16,
    full depth): the continuation equals one engine's greedy tokens bit
    for bit; the prefill engine retires the prompt; export and import ms."""
    import torch
    from ray_tpu_torch.llm.engine import _HostFetch, init_kv_cache
    from ray_tpu_torch.serve.prefix import block_hashes

    pre, dec = _engine(mc, params), _engine(mc, params)
    out = {}
    try:
        for n in REST_PD_LENGTHS:
            prompt = [int(t) for t in rng.integers(0, 256, n)]
            want = dec.generate(prompt, greedy64).token_ids
            payload = pre.prefill_only(prompt)
            req = dec.submit_prefilled(payload, greedy64)
            if not req.done.wait(300) or req.error:
                raise AssertionError(f"P/D decode at {n}: {req.error}")
            got = dec._result(req).token_ids
            if got != want:
                raise AssertionError(f"P/D continuation at {n} tokens "
                                     f"differs from one engine's greedy")
            deadline = time.time() + 10
            hashes = set(block_hashes(prompt, pre.prefix_block))
            while not hashes <= set(pre.prefix_block_hashes()):
                if time.time() > deadline:
                    raise AssertionError("release_slot did not retire "
                                         "the exported prompt")
                time.sleep(0.005)
            kv = (payload["kv_k"], payload["kv_v"])
            nbytes = sum(t.numel() * t.element_size() for t in kv)
            # The engine's copies, on a line of their own.
            line = init_kv_cache(mc, 1, 1024, REST_DEVICE)

            def export():
                fs = [_HostFetch(line[c][:, 0, :, :n]) for c in ("k", "v")]
                [f.tensor() for f in fs]

            def imp(src):
                def run():
                    for c, t in zip(("k", "v"), src):
                        line[c][:, 0, :, :n] = t.pin_memory().to(
                            REST_DEVICE, non_blocking=True)
                return run

            # The export hands out pinned tensors (pin_memory() is then
            # free); a payload that crossed a process is pageable and is
            # pinned by a host copy first.
            pageable = [t.clone() for t in kv]
            ex_ms = _host_ms(export)
            im_ms, im_pg_ms = _host_ms(imp(kv)), _host_ms(imp(pageable))
            out[n] = {"bytes": nbytes, "export_ms": ex_ms,
                      "import_ms": im_ms, "import_pageable_ms": im_pg_ms,
                      "tokens": len(got)}
            print(f"P/D at {n} prompt tokens: {len(got)} tokens equal one "
                  f"engine's greedy (bf16, bit for bit); prompt retired; "
                  f"payload {nbytes / 2 ** 20:.2f} MiB, export (device to "
                  f"host) {ex_ms:.3f} ms, import (host to device) "
                  f"{im_ms:.3f} ms from the exported (pinned) payload, "
                  f"{im_pg_ms:.3f} ms from a pageable copy (host clock, "
                  f"synchronized)")
    finally:
        pre.shutdown()
        dec.shutdown()
        del pre, dec
    torch.cuda.synchronize()
    return out


def _hf_source(mc, params):
    """An HF-named state dict built from these params (projections
    transposed to [out, in]) with a config.to_dict(): what
    convert_hf_llama reads from an in-memory model."""
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    lay = params["layers"]
    sd = {"model.embed_tokens.weight": params["embed_tokens"],
          "model.norm.weight": params["final_norm"]}
    for i in range(mc.num_layers):
        for ours, hf in names.items():
            sd[f"model.layers.{i}.{hf}.weight"] = lay[ours][i].t()
        sd[f"model.layers.{i}.input_layernorm.weight"] = lay["attn_norm"][i]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            lay["mlp_norm"][i]
    hf_cfg = {"vocab_size": mc.vocab_size, "hidden_size": mc.hidden_size,
              "intermediate_size": mc.intermediate_size,
              "num_hidden_layers": mc.num_layers,
              "num_attention_heads": mc.num_heads,
              "num_key_value_heads": mc.num_kv_heads,
              "head_dim": mc.head_dim,
              "max_position_embeddings": mc.max_seq_len,
              "rope_theta": mc.rope_theta, "rms_norm_eps": mc.norm_eps,
              "tie_word_embeddings": mc.tie_embeddings}

    class Source:
        config = type("Config", (), {"to_dict": staticmethod(
            lambda: dict(hf_cfg))})

        @staticmethod
        def state_dict():
            return dict(sd)

    return Source()


def rest_checkpoints(prompts, greedy64) -> dict:
    """(d) f32 2-layer: params through convert_hf_llama and through a
    save_pytree directory give the original params' greedy tokens."""
    import tempfile

    import torch
    from ray_tpu_torch.llm.hf import convert_hf_llama
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train.checkpoint import save_pytree

    mc = _f32_1b()
    params = init_params(mc, generator=SEED, device=REST_DEVICE)
    some = prompts[:3]

    def tokens(params=None, **kw):
        eng = _engine(mc, params, **kw)
        try:
            return [eng.generate(p, greedy64).token_ids for p in some]
        finally:
            eng.shutdown()

    want = tokens(params=params)
    cfg, converted = convert_hf_llama(_hf_source(mc, params),
                                      dtype="float32")
    if cfg != mc:
        raise AssertionError(f"convert_hf_llama geometry {cfg}")
    if tokens(params=converted) != want:
        raise AssertionError("HF-converted params' tokens differ")
    with tempfile.TemporaryDirectory() as tmp:
        save_pytree(params, tmp)
        got = tokens(checkpoint_path=tmp, dtype="float32")
    if got != want:
        raise AssertionError("DCP checkpoint_path tokens differ")
    del params, converted
    torch.cuda.synchronize()
    print(f"checkpoints (f32 2-layer): HF-named state dict through "
          f"convert_hf_llama and a save_pytree directory through "
          f"checkpoint_path give the original params' {len(some)} greedy "
          f"streams")
    return {"streams": len(some), "tokens": sum(map(len, want))}


def phase_serving_rest() -> dict:
    """Phase 17: the serving engine's remaining surface at Llama-3.2-1B
    width (seeded random weights): (a) the block pool, (b) speculative
    decoding, (c) the P/D hand-off, (d) checkpoint loading. rms_norm's
    launch count is reset right before and read right after."""
    import gc

    import numpy as np
    import torch
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.ops import norms

    torch.cuda.empty_cache()
    # The host runs the engines (serving is host-bound): keep the earlier
    # phases' heap out of the garbage collector's passes, as phase 8 does.
    gc.collect()
    gc.freeze()
    rng = np.random.default_rng(SEED)
    _, prompts = _wave_prompts(rng)
    greedy64 = SamplingParams(max_tokens=64, temperature=0.0)
    out = {}
    t0 = time.perf_counter()
    norms.rms_norm.launches = 0
    _phase("serving (a): block pool, f32 gates at 1B width, 2 layers")
    out["blocked_gates"] = rest_blocked_gates(prompts, greedy64)
    gc.collect()
    torch.cuda.empty_cache()
    mc16 = _bf16_1b()
    params16 = init_params(mc16, generator=SEED, device=REST_DEVICE)
    _phase("serving (a): block pool, bf16 at full depth")
    out["blocked"] = rest_blocked_timed(mc16, params16, prompts, greedy64,
                                        rng)
    _phase("serving (b): speculative decoding")
    out["spec"] = rest_spec(prompts, mc16, params16)
    gc.collect()
    torch.cuda.empty_cache()
    _phase("serving (c): prefill/decode hand-off, bf16 at full depth")
    out["pd"] = rest_pd(mc16, params16, rng, greedy64)
    del params16
    gc.collect()
    torch.cuda.empty_cache()
    _phase("serving (d): checkpoints")
    out["checkpoints"] = rest_checkpoints(prompts, greedy64)
    out["launches"] = norms.rms_norm.launches
    out["s"] = time.perf_counter() - t0
    if out["launches"] < 1:
        raise AssertionError("rms_norm kernel never launched in phase 17")
    print(f"phase 17: {out['s']:.1f} s; rms_norm kernel launches "
          f"{out['launches']}")
    gc.unfreeze()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phase 19: TorchTrainer on the port's in-process runtime, at phase 8's
# 1.1B geometry (bench.py:292-297), full width and depth, on the fused
# backward. (a) One worker, restarted once: steps 0-5, batch i from a
# numpy generator seeded by i; rank 0 saves after step 2; the first attempt
# raises at the start of step 4; the resumed one restores and runs 3-5.
P19_STEPS = 6
P19_SAVE_AFTER = 2
P19_FAIL_AT = 4
# After the failed attempt's group shut down, the card's allocated memory
# must be back to what it was before fit(), within this many bytes.
P19_MEM_SLACK = 64 * 2 ** 20
# (b) Two workers average a quadratic's gradient through the host
# collective: tests/test_train.py's test_multi_worker_ddp_with_host_collective
# in CUDA f32 tensors.
P19_DDP_STEPS = 5
# How long a fit() may take before the phase calls it hung (seconds).
P19_FIT_DEADLINE_S = 600


def _p19_batch(i: int, vocab: int, batch: int, seq: int):
    import numpy as np

    rng = np.random.default_rng(i)
    tokens = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _p19_step(cfg, device):
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    return make_llama_train_step(
        cfg, optimizer=adamw_lowmem(3e-4, weight_decay=0.1),
        attn_impl="flash", remat="attn+", seed=SEED, device=device)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _fit_in_time(trainer, deadline_s: float = P19_FIT_DEADLINE_S):
    """trainer.fit() on a thread joined within ``deadline_s``: a fit that
    hangs fails the phase instead of the script's time limit."""
    out: dict = {}

    def run():
        try:
            out["result"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True, name="p19-fit")
    t.start()
    t.join(deadline_s)
    if t.is_alive():
        raise AssertionError(f"fit() did not return in {deadline_s} s")
    if "error" in out:
        raise out["error"]
    return out["result"]


def _thread_matmul_residue() -> int:
    """Bytes the card keeps allocated after a thread that ran one matmul
    has ended: PyTorch keeps a cuBLAS workspace per handle and stream in
    its caching allocator, and a new thread takes an idle handle (and its
    workspace) from the pool."""
    import torch

    before = torch.cuda.memory_allocated()

    def one_matmul():
        a = torch.ones(64, 64, device="cuda")
        (a @ a).sum().item()

    t = threading.Thread(target=one_matmul)
    t.start()
    t.join()
    return torch.cuda.memory_allocated() - before


def trainer_direct_loop(cfg, device, batch: int, seq: int) -> dict:
    """The step with no trainer: steps 0..P19_STEPS-1 on their batches;
    each step's loss (read as a float, as the train function reports it)
    and host time, and the state's checkpoint bytes."""
    import gc

    import torch
    from ray_tpu_torch._device import tree_leaves

    step, init, shard = _p19_step(cfg, device)
    state = init()
    losses, secs = [], []
    for i in range(P19_STEPS):
        tok, tgt = _p19_batch(i, cfg.vocab_size, batch, seq)
        t0 = time.perf_counter()
        state, m = step(state, shard(tok), shard(tgt))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    state_bytes = _nbytes(t for t in tree_leaves(state.checkpoint_tree())
                          if isinstance(t, torch.Tensor))
    del state, step, init, shard, m
    gc.collect()
    return {"losses": losses, "step_s": secs, "state_bytes": state_bytes}


def trainer_restart_fn(cfg, batch: int, seq: int, marks: dict):
    """The train function of phase 19 (a): it builds the step itself,
    saves on rank 0 after step P19_SAVE_AFTER, raises at the start of step
    P19_FAIL_AT in its first attempt, and when resumed restores the
    checkpoint and runs the steps after it. ``marks[attempt]`` collects
    its clocks, step times and memory readings (no tensor: the function
    holds none past its own frame)."""

    def train_fn(config):
        import torch
        from ray_tpu_torch.train import (get_context, report, restore_pytree,
                                         save_pytree)

        ctx = get_context()
        dev = ctx.get_device()
        on_card = dev.type == "cuda"
        rec = marks.setdefault(ctx.restart_count, {"step_s": [],
                                                   "reports": []})
        rec["t_start"] = time.time()
        rec["device"] = str(dev)
        if on_card:
            rec["current_device"] = torch.cuda.current_device()
            rec["mem_start"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        step, init, shard = _p19_step(cfg, dev)
        state, start = init(), 0
        if ctx.get_checkpoint():
            t0 = time.time()
            restore_pytree(ctx.get_checkpoint(), state.checkpoint_tree())
            if on_card:
                torch.cuda.synchronize()
            rec["restore"] = (t0, time.time())
            start = P19_SAVE_AFTER + 1
        for i in range(start, P19_STEPS):
            if i == P19_FAIL_AT and ctx.restart_count == 0:
                if on_card:
                    rec["peak"] = torch.cuda.max_memory_allocated()
                rec["t_error"] = time.time()
                raise RuntimeError(f"injected failure at the start of step {i}")
            tok, tgt = _p19_batch(i, cfg.vocab_size, batch, seq)
            t0 = time.perf_counter()
            state, m = step(state, shard(tok), shard(tgt))
            loss = float(m["loss"])
            rec["step_s"].append((i, time.perf_counter() - t0))
            ck = None
            if i == P19_SAVE_AFTER and ctx.get_world_rank() == 0:
                t0 = time.perf_counter()
                ck = save_pytree(state.checkpoint_tree(), os.path.join(
                    ctx.storage_path, f"checkpoint_{i:08d}"), step=i)
                rec["save_s"] = time.perf_counter() - t0
                rec["ckpt_bytes"] = _dir_bytes(ck)
            report({"step": i, "loss": loss, "attempt": ctx.restart_count},
                   checkpoint=ck)
            rec["reports"].append((i, time.time()))
        if on_card:
            rec["peak"] = torch.cuda.max_memory_allocated()

    return train_fn


def trainer_ddp_fn(config):
    """Phase 19 (b)'s train function: tests/test_train.py's quadratic in
    f32 tensors on the worker's device, the gradient averaged through the
    host collective; the last report carries w."""
    import torch
    import ray_tpu_torch.collective as col
    from ray_tpu_torch.train import get_context, report

    ctx = get_context()
    rank, world, dev = ctx.get_world_rank(), ctx.get_world_size(), \
        ctx.get_device()
    g = col.init_collective_group(world_size=world, rank=rank,
                                  backend="host", group_name=config["group"])
    w = torch.zeros(4, dtype=torch.float32, device=dev)
    for step in range(P19_DDP_STEPS):
        target = torch.full((4,), 3.0 + 0.1 * rank, dtype=torch.float32,
                            device=dev)
        grad = 2 * (w - target)
        grad = g.allreduce(grad) / world  # DDP gradient average
        w -= 0.3 * grad
        report({"step": step, "rank": rank,
                "loss": float(((w - 3.05) ** 2).sum()),
                "current_device": torch.cuda.current_device()
                if dev.type == "cuda" else None,
                **({"w": w.cpu().tolist()}
                   if step == P19_DDP_STEPS - 1 else {})})


def trainer_ddp_run(storage: str, device: str, num_workers: int,
                    use_gpu: bool, label: str) -> dict:
    """Phase 19 (b) under one runtime: each rank's final w and reports."""
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchBackendConfig,
                                     TorchTrainer)

    scaling = ScalingConfig(num_workers=num_workers, use_gpu=use_gpu,
                            resources_per_worker={} if use_gpu
                            else {"CPU": 1})
    res = _fit_in_time(TorchTrainer(
        trainer_ddp_fn, train_loop_config={"group": f"ddp-{label}"},
        scaling_config=scaling,
        run_config=RunConfig(name=f"ddp-{label}", storage_path=storage),
        backend_config=TorchBackendConfig(device=device)))
    if not res.ok:
        raise AssertionError(f"ddp ({label}) failed: {res.error}")
    last = {m["rank"]: m for m in res.metrics_history
            if m["step"] == P19_DDP_STEPS - 1}
    return {"w": {r: last[r]["w"] for r in sorted(last)},
            "current_device": {m["rank"]: m["current_device"]
                               for m in res.metrics_history}}


def phase_trainer() -> dict:
    """Phase 19: TorchTrainer on the in-process runtime. (a) The 1.1B step
    under one worker restarted once from its checkpoint, its losses bit
    for bit against the step run directly; (b) two workers averaging
    through the host collective on the card against the same program on
    the CPU; (c) the refusals."""
    import gc
    import shutil
    import statistics

    import torch
    import torch.distributed as dist
    import ray_tpu_torch
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchBackendConfig, TorchTrainer)

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    storage = os.path.join(root, "ray_tpu_torch", "_native", "_build",
                           "phase19")
    shutil.rmtree(storage, ignore_errors=True)
    os.makedirs(storage)
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    batch, seq = 4, 2048
    out: dict = {}
    gib = 2.0 ** 30

    _phase("TorchTrainer (a): the 1.1B step, one worker, restarted once "
           "from its checkpoint")
    direct = trainer_direct_loop(cfg, "cuda", batch, seq)
    free = shutil.disk_usage(storage).free
    if free < 2 * direct["state_bytes"]:
        raise AssertionError(
            f"the checkpoint directory {storage} has {free / gib:.2f} GiB "
            f"free, less than twice the state's {direct['state_bytes'] / gib:.3f}"
            " GiB")
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    thread_residue = _thread_matmul_residue()
    counters = _counters()
    for c in counters.values():
        c.launches = 0  # count the trainer's run only
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8,
                       resources={"GPU": torch.cuda.device_count()})
    marks: dict = {}
    t0 = time.perf_counter()
    try:
        res = _fit_in_time(TorchTrainer(
            trainer_restart_fn(cfg, batch, seq, marks),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            backend_config=TorchBackendConfig(distributed=True),
            run_config=RunConfig(
                name="llama-1b", storage_path=storage,
                failure_config=FailureConfig(max_failures=1))))
    finally:
        ray_tpu_torch.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()
    fit_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if not res.ok:
        raise AssertionError(f"fit failed: {res.error}")
    restarts = [(r["tier"], r["trigger"]) for r in res.restarts]
    if restarts != [("checkpoint", "worker_error")]:
        raise AssertionError(f"restarts {res.restarts}")
    got = [(m["attempt"], m["step"], m["loss"]) for m in res.metrics_history]
    want = [(0, i, direct["losses"][i]) for i in range(P19_FAIL_AT)] + \
        [(1, i, direct["losses"][i])
         for i in range(P19_SAVE_AFTER + 1, P19_STEPS)]
    if got != want:
        raise AssertionError(f"reported losses {got} != the direct loop's "
                             f"{want} (bit for bit)")
    steps_run = len(got)
    want_launch = {k: v * steps_run for k, v in
                   predicted_launches("attn+", cfg.num_layers).items()}
    for k in ("rms_norm", "flash_fwd", "flash_bwd"):
        if launches[k] != want_launch[k]:
            raise AssertionError(
                f"{k} launched {launches[k]} times in fit(), not the "
                f"{want_launch[k]} of {steps_run} steps")
    a0, a1 = marks[0], marks[1]
    for a in (a0, a1):
        if a["current_device"] != 0 or a["device"] != "cuda:0":
            raise AssertionError(f"train thread on {a['device']} / "
                                 f"{a['current_device']}, not cuda:0")
    mem_after = a1["mem_start"]
    if abs(mem_after - mem_before) > P19_MEM_SLACK:
        raise AssertionError(
            f"after the failed attempt the card holds {mem_after / gib:.3f}"
            f" GiB, against {mem_before / gib:.3f} GiB before fit()")
    direct_ms = 1e3 * statistics.median(direct["step_s"][1:])
    trainer_s = [s for i, s in a0["step_s"][1:]] + \
        [s for i, s in a1["step_s"][1:]]
    trainer_ms = 1e3 * statistics.median(trainer_s)
    restore_s = a1["restore"][1] - a1["restore"][0]
    first_report = a1["reports"][0][1]
    restart_s = first_report - a0["t_error"]
    regroup_s = a1["restore"][0] - a0["t_error"]
    warm_s = first_report - a1["restore"][1]
    print(f"losses bit-equal to the direct loop: "
          + " ".join(f"{x:.6f}" for x in direct["losses"])
          + f" (step {P19_SAVE_AFTER + 1}'s in both attempts)")
    print(f"restarts: {res.restarts[0]['tier']}, trigger "
          f"{res.restarts[0]['trigger']}, detection "
          f"{res.restarts[0]['detection_latency_s']:.3f} s after the last "
          f"good poll")
    print(f"step ms, median of each attempt's steps after its first: "
          f"trainer {trainer_ms:.2f} ({len(trainer_s)} steps: "
          + " ".join(f"{1e3 * s:.2f}" for s in trainer_s)
          + f") vs direct loop {direct_ms:.2f} (steps 1-{P19_STEPS - 1}: "
          + " ".join(f"{1e3 * s:.2f}" for s in direct["step_s"][1:])
          + f"); trainer/direct {trainer_ms / direct_ms:.4f}")
    print(f"checkpoint: {a0['ckpt_bytes'] / gib:.3f} GiB on disk "
          f"({a0['ckpt_bytes']} bytes; state tensors "
          f"{direct['state_bytes']} bytes), saved in {a0['save_s']:.3f} s "
          f"({a0['ckpt_bytes'] / a0['save_s'] / 1e9:.2f} GB/s)")
    print(f"restart: {restart_s:.3f} s from the failure to the first "
          f"resumed report = detection, group rebuild, step build and init "
          f"{regroup_s:.3f} s + restore {restore_s:.3f} s "
          f"({a0['ckpt_bytes'] / restore_s / 1e9:.2f} GB/s) + first step "
          f"{warm_s:.3f} s")
    print(f"peak device memory: attempt 0 {a0['peak'] / gib:.3f} GiB, "
          f"attempt 1 {a1['peak'] / gib:.3f} GiB; allocated before fit() "
          f"{mem_before / gib:.3f} GiB, at the restart "
          f"{mem_after / gib:.3f} GiB ({(mem_after - mem_before) / 2**20:+.1f}"
          f" MiB; a thread that ran one matmul and ended leaves "
          f"{thread_residue / 2**20:+.1f} MiB, its cuBLAS workspace)")
    print(f"launches in fit(): " + ", ".join(
        f"{k} {launches[k]}" for k in ("rms_norm", "flash_fwd", "flash_bwd"))
          + f" (= {steps_run} steps of the attn+ policy); fit() "
          f"{fit_s:.2f} s")
    out["restart"] = {
        "losses": direct["losses"], "launches": launches,
        "step_ms_trainer": trainer_ms, "step_ms_direct": direct_ms,
        "step_ms_trainer_each": [1e3 * s for s in trainer_s],
        "step_ms_direct_each": [1e3 * s for s in direct["step_s"]],
        "ckpt_bytes": a0["ckpt_bytes"], "state_bytes": direct["state_bytes"],
        "save_s": a0["save_s"], "restore_s": restore_s,
        "restart_s": restart_s, "regroup_s": regroup_s,
        "first_step_s": warm_s,
        "detection_s": res.restarts[0]["detection_latency_s"],
        "peak_gib": [a0["peak"] / gib, a1["peak"] / gib],
        "mem_before_gib": mem_before / gib,
        "mem_at_restart_gib": mem_after / gib,
        "thread_matmul_residue_mib": thread_residue / 2 ** 20,
        "fit_s": fit_s}
    shutil.rmtree(storage, ignore_errors=True)
    os.makedirs(storage)
    gc.collect()
    torch.cuda.empty_cache()

    _phase("TorchTrainer (b): two workers, the host collective, on the card "
           "against the CPU")
    cards = torch.cuda.device_count()
    runs = {}
    for label, device, use_gpu in (("cuda", "cuda", cards >= 2),
                                   ("cpu", "cpu", False)):
        ray_tpu_torch.init(num_cpus=8, resources={"GPU": cards})
        try:
            runs[label] = trainer_ddp_run(storage, device, 2, use_gpu, label)
        finally:
            ray_tpu_torch.shutdown()
    w_card, w_cpu = runs["cuda"]["w"], runs["cpu"]["w"]
    if w_card[0] != w_card[1] or w_card != w_cpu:
        raise AssertionError(f"w on the card {w_card} vs the CPU {w_cpu}: "
                             "not bit-equal")
    devs = runs["cuda"]["current_device"]
    want_devs = {0: 0, 1: 1 if cards >= 2 else 0}
    if devs != want_devs:
        raise AssertionError(f"train threads' current devices {devs}, not "
                             f"{want_devs}")
    print(f"w after {P19_DDP_STEPS} steps, both ranks and the CPU run, bit "
          f"for bit: {w_card[0]}; rank threads on cuda "
          + ", ".join(f"{r}:{d}" for r, d in sorted(devs.items()))
          + (" (use_gpu, one card a rank)" if cards >= 2
             else " (one card: both threads on cuda:0, CPU 1 a worker)"))
    out["ddp"] = {"w": w_card[0], "current_device": devs}

    _phase("TorchTrainer (c): the refusals")
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": cards})
    try:
        before = len(global_worker.runtime._actors)
        t0 = time.perf_counter()
        try:
            TorchTrainer(trainer_ddp_fn, scaling_config=ScalingConfig(
                num_workers=2), backend_config=TorchBackendConfig(
                    distributed=True), run_config=RunConfig(
                        storage_path=storage)).fit()
            raise AssertionError("distributed=True at 2 workers ran")
        except NotImplementedError as e:
            refused_dist = str(e)
        if len(global_worker.runtime._actors) != before:
            raise AssertionError("a worker started before the refusal")
    finally:
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)  # no "GPU" resource
    try:
        try:
            _fit_in_time(TorchTrainer(
                trainer_ddp_fn, scaling_config=ScalingConfig(use_gpu=True),
                run_config=RunConfig(storage_path=storage)), deadline_s=60)
            raise AssertionError("use_gpu=True without a GPU resource ran")
        except ValueError as e:
            refused_gpu = str(e)
    finally:
        ray_tpu_torch.shutdown()
    refuse_s = time.perf_counter() - t0
    print(f"distributed=True at 2 workers: NotImplementedError, no worker "
          f"started ({refused_dist[:90]}...); use_gpu=True without a GPU "
          f"resource: ValueError ({refused_gpu[:80]}...); both in "
          f"{refuse_s:.3f} s")
    out["refusals_s"] = refuse_s
    shutil.rmtree(storage, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['phase_s']:.1f} s")
    return out


# Phase 20: Serve on the card. Phase 7's configuration behind a serve
# replica, driven over HTTP.
P20_WAVES = 3  # timed HTTP waves, each in turn with a direct one
P20_STREAM_WAVES = 1  # more streaming waves, each in turn with a direct one
# Greedy outputs are kept in ASCII: the seeded embedding's rows from this
# id up are zeroed (tied head, so those logits are 0 and never the
# largest), which makes every output token a visible one-byte character
# and the text gates compare every token.
P20_VOCAB_SHOWN = 128
P20_MEM_SLACK = 64 * 2 ** 20  # card memory after serve.shutdown, bytes
# PyTorch's cuBLAS workspace for one thread on sm_90 (its default
# CUBLAS_WORKSPACE_CONFIG ":4096:8", 8 x 4096 KiB). The workspaces freed
# for a reading may be at most one of these for each engine thread that
# ran at once; more would be a handle left behind by each replica.
P20_CUBLAS_WORKSPACE = 32 * 2 ** 20
P20_SCALE_S = 60.0  # the most the autoscaling load may run


def _p20_request(port: int, path: str, body: dict):
    import urllib.request

    return urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})


def p20_post(port: int, path: str, body: dict) -> dict:
    import urllib.request

    with urllib.request.urlopen(_p20_request(port, path, body),
                                timeout=600) as r:
        return json.loads(r.read())


def p20_stream(port: int, path: str, body: dict):
    """POST a streaming request; returns (parsed frames, seconds from the
    request to the first data frame). Fails unless every line is an SSE
    data line or blank, each frame parses, and the stream ends in
    ``data: [DONE]``."""
    import urllib.request

    t0 = time.perf_counter()
    frames, first, done = [], None, False
    with urllib.request.urlopen(_p20_request(port, path, body),
                                timeout=600) as r:
        ctype = r.headers.get("Content-Type", "")
        for raw in r:
            line = raw.decode("utf-8").rstrip("\n")
            if not line:
                continue
            if not line.startswith("data: ") or done:
                raise AssertionError(f"SSE line {line[:80]!r} (after "
                                     f"[DONE]: {done})")
            if first is None:
                first = time.perf_counter() - t0
            if line == "data: [DONE]":
                done = True
                continue
            frames.append(json.loads(line[6:]))
    if not ctype.startswith("text/event-stream") or not done:
        raise AssertionError(f"stream of {ctype!r} ended without [DONE]")
    return frames, first


def p20_loop(prompts, call, concurrency: int = 8):
    """Closed loop: ``concurrency`` clients each send the next prompt as
    soon as their last answer came. Returns ({index: answer}, wall s,
    {index: latency s}); raises the first client's error."""
    out, lat, errors = {}, {}, []
    lock = threading.Lock()
    todo = list(enumerate(prompts))

    def client():
        while True:
            with lock:
                if not todo or errors:
                    return
                i, p = todo.pop(0)
            t0 = time.perf_counter()
            try:
                r = call(p)
            except BaseException as e:  # noqa: BLE001 - raised below
                with lock:
                    errors.append(e)
                return
            with lock:
                out[i], lat[i] = r, time.perf_counter() - t0

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if len(out) != len(prompts) or any(t.is_alive() for t in threads):
        raise AssertionError(f"{len(out)}/{len(prompts)} requests answered")
    return out, wall, lat


def p20_direct(eng, prompt, sampling):
    """One request to the engine itself: (result, engine TTFT s)."""
    req = eng.submit(prompt, sampling)
    if not req.done.wait(600):
        raise TimeoutError("direct request timed out")
    if req.error or req.finish_reason not in ("length", "stop"):
        raise AssertionError(f"direct request ended {req.finish_reason} "
                             f"({req.error})")
    return eng._result(req), req.first_token_ts - req.submit_ts


def p20_check_completion(label: str, got: dict, want) -> None:
    """An HTTP completion against the engine's own result."""
    choice = got["choices"][0]
    text = choice.get("text", choice.get("message", {}).get("content"))
    usage = {"prompt_tokens": len(want.prompt_ids),
             "completion_tokens": len(want.token_ids),
             "total_tokens": len(want.prompt_ids) + len(want.token_ids)}
    if text != want.text or got["usage"] != usage or \
            choice["finish_reason"] != want.finish_reason:
        raise AssertionError(
            f"{label}: HTTP {text!r} {got['usage']} "
            f"{choice['finish_reason']} vs direct {want.text!r} {usage} "
            f"{want.finish_reason}")


def p20_check_stream(label: str, frames: list, want_text: str,
                     want_tokens: int) -> None:
    deltas = [f["choices"][0]["delta"].get("content", "") for f in frames]
    if "".join(deltas) != want_text or len(frames) != want_tokens + 1 or \
            frames[-1]["choices"][0]["finish_reason"] not in ("length",
                                                              "stop"):
        raise AssertionError(
            f"{label}: stream {''.join(deltas)!r} in {len(frames)} frames "
            f"vs {want_text!r} ({want_tokens} tokens)")


def p20_checkpoint(cfg, directory: str, device: str) -> None:
    """Phase 7's seeded weights with the embedding rows from
    P20_VOCAB_SHOWN up zeroed, written once as a save_pytree directory
    that the direct engine and every replica load."""
    import shutil

    import torch
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.train.checkpoint import save_pytree

    shutil.rmtree(directory, ignore_errors=True)
    params = init_params(cfg.model_config(), generator=cfg.seed,
                         device=device)
    with torch.no_grad():
        params["embed_tokens"][P20_VOCAB_SHOWN:] = 0
        if "lm_head" in params:  # an untied head (the CPU check's tiny)
            params["lm_head"][:, P20_VOCAB_SHOWN:] = 0
    save_pytree(params, directory)
    del params


def p20_allocated() -> tuple[int, int]:
    """(the card's allocated bytes without cuBLAS workspaces, the
    workspaces' bytes). PyTorch keeps a cuBLAS handle and its workspace
    for each thread that ran a matmul, and hands both to the next thread
    after that thread ends (32 MiB a handle on an H100): clearing them
    makes the reading count what is held, not how many threads ran."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    after = torch.cuda.memory_allocated()
    return after, before - after


def p20_memory_back(mem0: int, engine_threads: int,
                    after: str = "serve.shutdown()",
                    before: str = "serve.run") -> float:
    """Wait (up to 15 s: killed replicas' threads end on their own) until
    the card's allocated memory, cuBLAS workspaces aside, is back within
    P20_MEM_SLACK of mem0, and check that the workspaces freed for the
    readings are at most P20_CUBLAS_WORKSPACE for each of the
    engine_threads that ran at once; returns the gap in MiB."""
    deadline = time.perf_counter() + 15
    freed = 0
    while True:
        now, workspaces = p20_allocated()
        freed += workspaces
        gap = now - mem0
        if abs(gap) <= P20_MEM_SLACK:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(
                f"card memory after {after} {gap / 2 ** 20:+.1f} "
                f"MiB from before {before}")
        time.sleep(0.2)
    bound = engine_threads * P20_CUBLAS_WORKSPACE
    if freed > bound:
        raise AssertionError(
            f"{freed / 2 ** 20:.2f} MiB of cuBLAS workspaces freed after "
            f"{after}, above {bound / 2 ** 20:.0f} MiB for "
            f"{engine_threads} engine threads: a handle left behind")
    print(f"after {after}: allocated {gap / 2 ** 20:+.2f} MiB from "
          f"before {before} (slack {P20_MEM_SLACK // 2 ** 20} MiB), cuBLAS "
          f"workspaces aside ({freed / 2 ** 20:.2f} MiB of them freed "
          f"for the reading, at most {bound / 2 ** 20:.0f} MiB for "
          f"{engine_threads} engine threads)")
    return gap / 2 ** 20


def p20_replicas(name: str):
    """(replica id, actor) of each RUNNING replica of deployment name."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.handle import CONTROLLER_NAME, SERVE_NAMESPACE

    ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=SERVE_NAMESPACE)
    infos = ray_tpu_torch.get(ctrl.get_replicas.remote(name), timeout=30)
    return [(i.replica_id, ray_tpu_torch.get_actor(
        i.actor_name, namespace=SERVE_NAMESPACE)) for i in infos
        if not i.draining]


def phase_serve(model="llama3_1b", dtype: str = "bfloat16",
                device: str = "cuda") -> dict:
    """Phase 20: Serve on the card (ray_tpu_torch.serve): phase 7's engine
    behind a replica of build_openai_app, reached over HTTP through the
    proxy, handle, router and replica. (a) /v1/completions in turns with
    the engine driven directly, every completion's text and usage equal
    to the engine's; (b) /v1/chat/completions with stream: true, the SSE
    frames well formed and their deltas equal to the non-streaming and
    the direct text, TTFT beside the engine's own; (c) autoscaling 1 -> 2
    -> 1 on one card, both replicas serving, tokens equal to the
    engine's, the card's memory back within P20_MEM_SLACK after
    serve.shutdown(); (d) the refusals. ``model``, ``dtype`` and
    ``device`` shrink it for a CPU check of the script itself."""
    from dataclasses import replace

    import numpy as np
    import torch
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import (LLMConfig, LLMEngine, LLMServer,
                                   SamplingParams, build_openai_app)
    from ray_tpu_torch.ops import norms

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    root = os.path.dirname(os.path.abspath(__file__))
    ckdir = os.path.join(root, "ray_tpu_torch", "_native", "_build",
                         "phase20")
    base = LLMConfig(model=model, dtype=dtype, max_num_seqs=8,
                     max_seq_len=1024, decode_burst=16, prefill_chunk=512,
                     seed=SEED)
    _phase("Serve (setup): phase 7's engine, seeded weights written once")
    p20_checkpoint(base, ckdir, device)
    cfg = replace(base, checkpoint_path=ckdir)
    greedy64 = SamplingParams(max_tokens=64, temperature=0.0)
    body64 = {"max_tokens": 64, "temperature": 0.0}
    rng = np.random.default_rng(SEED + 20)

    def fresh_wave():
        """Phase 7's prompt lengths, fresh ASCII tokens."""
        _, wave = _wave_prompts(rng)
        return [[t % P20_VOCAB_SHOWN for t in p] for p in wave]

    def chat(ids):
        return [{"role": "user", "content": "".join(map(chr, ids))}]

    eng = LLMEngine(cfg, device=device)
    out: dict = {}
    serve_launches = 0

    def served(fn):
        """Run one HTTP wave, adding its rms_norm launches (the direct
        engine idles meanwhile) to the serve path's count."""
        nonlocal serve_launches
        norms.rms_norm.launches = 0
        try:
            return fn()
        finally:
            serve_launches += norms.rms_norm.launches

    try:
        mem0 = p20_allocated()[0] if cuda else 0
        ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
        try:
            _phase("Serve (a): /v1/completions over HTTP in turns with the "
                   "engine driven directly")
            t0 = time.perf_counter()
            serve.run(build_openai_app(
                cfg, device=device, ray_actor_options={"num_gpus": 1}),
                route_prefix="/", http=True, _blocking_timeout=300)
            port = serve.http_port()
            up_s = time.perf_counter() - t0
            print(f"serve.run up in {up_s:.2f} s (one replica, its engine "
                  f"loaded from the checkpoint); proxy on port {port}")

            def http_wave(prompts):
                return served(lambda: p20_loop(prompts, lambda p: p20_post(
                    port, "/v1/completions", {"prompt": p, **body64})))

            def direct_wave(prompts):
                return p20_loop(prompts,
                                lambda p: p20_direct(eng, p, greedy64))

            def check_wave(label, prompts, http, direct):
                for i in range(len(prompts)):
                    p20_check_completion(f"{label} prompt {i}", http[i],
                                         direct[i][0])

            warm = fresh_wave()
            h, _, _ = http_wave(warm)
            d, _, _ = direct_wave(warm)
            check_wave("warm-up", warm, h, d)
            http_rates, direct_rates, http_lat, direct_lat = [], [], [], []
            for w in range(P20_WAVES):
                prompts = fresh_wave()
                h, h_s, h_lat = http_wave(prompts)
                d, d_s, d_lat = direct_wave(prompts)
                check_wave(f"wave {w}", prompts, h, d)
                h_tok = sum(r["usage"]["completion_tokens"]
                            for r in h.values())
                d_tok = sum(len(r[0].token_ids) for r in d.values())
                http_rates.append(h_tok / h_s)
                direct_rates.append(d_tok / d_s)
                http_lat += list(h_lat.values())
                direct_lat += list(d_lat.values())
                print(f"  wave {w}: HTTP {h_tok} tokens in {h_s:.3f} s = "
                      f"{http_rates[-1]:.1f} tok/s; direct {d_tok} in "
                      f"{d_s:.3f} s = {direct_rates[-1]:.1f} tok/s")
            ratio = statistics.median(http_rates) / \
                statistics.median(direct_rates)
            extra_ms = (statistics.median(http_lat)
                        - statistics.median(direct_lat)) * 1e3
            print(f"{P20_WAVES} waves of 16 at concurrency 8, in turns: HTTP "
                  f"tok/s {_spread(http_rates)}; direct tok/s "
                  f"{_spread(direct_rates)}; HTTP/direct {ratio:.4f}; request "
                  f"latency median HTTP "
                  f"{statistics.median(http_lat) * 1e3:.1f} ms vs direct "
                  f"{statistics.median(direct_lat) * 1e3:.1f} ms (HTTP adds "
                  f"{extra_ms:.1f} ms); every text and usage equal: ok")
            out["http"] = {
                "up_s": up_s, "waves": P20_WAVES,
                "http_tok_per_s": statistics.median(http_rates),
                "http_tok_per_s_min": min(http_rates),
                "http_tok_per_s_max": max(http_rates),
                "direct_tok_per_s": statistics.median(direct_rates),
                "direct_tok_per_s_min": min(direct_rates),
                "direct_tok_per_s_max": max(direct_rates),
                "http_over_direct": ratio,
                "latency_ms_http": statistics.median(http_lat) * 1e3,
                "latency_ms_direct": statistics.median(direct_lat) * 1e3,
                "extra_latency_ms": extra_ms}

            _phase("Serve (b): /v1/chat/completions with stream: true")
            path = "/v1/chat/completions"
            prompts = fresh_wave()
            whole, _, _ = served(lambda: p20_loop(prompts, lambda p: p20_post(
                port, path, {"messages": chat(p), **body64})))
            streams, _, _ = served(lambda: p20_loop(prompts, lambda p: p20_stream(
                port, path, {"messages": chat(p), "stream": True, **body64})))
            tok = eng.tokenizer
            direct, _, _ = p20_loop(prompts, lambda p: p20_direct(
                eng, tok.apply_chat_template(chat(p)), greedy64))
            for i in range(len(prompts)):
                want = direct[i][0]
                p20_check_completion(f"chat prompt {i}", whole[i], want)
                p20_check_stream(f"stream prompt {i}", streams[i][0],
                                 whole[i]["choices"][0]["message"]["content"],
                                 len(want.token_ids))
            http_ttft = [streams[i][1] * 1e3 for i in streams]
            eng_ttft = [direct[i][1] * 1e3 for i in direct]
            for w in range(P20_STREAM_WAVES):
                prompts = fresh_wave()
                streams, _, _ = served(lambda: p20_loop(
                    prompts, lambda p: p20_stream(port, path, {
                        "messages": chat(p), "stream": True, **body64})))
                direct, _, _ = p20_loop(prompts, lambda p: p20_direct(
                    eng, tok.apply_chat_template(chat(p)), greedy64))
                for i in range(len(prompts)):
                    want = direct[i][0]
                    p20_check_stream(f"timed stream {w} prompt {i}",
                                     streams[i][0], want.text,
                                     len(want.token_ids))
                http_ttft += [streams[i][1] * 1e3 for i in streams]
                eng_ttft += [direct[i][1] * 1e3 for i in direct]
            q = statistics.quantiles
            ttft = {"http_p50_ms": statistics.median(http_ttft),
                    "http_p90_ms": q(http_ttft, n=10)[-1],
                    "engine_p50_ms": statistics.median(eng_ttft),
                    "engine_p90_ms": q(eng_ttft, n=10)[-1]}
            print(f"SSE: frames parse, [DONE] last, deltas equal the "
                  f"non-streaming and the direct text: ok; TTFT over "
                  f"{len(http_ttft)} streamed requests (sent to first data "
                  f"frame) p50 {ttft['http_p50_ms']:.1f} ms, p90 "
                  f"{ttft['http_p90_ms']:.1f} ms; the engine's own "
                  f"(first_token_ts - submit_ts) direct p50 "
                  f"{ttft['engine_p50_ms']:.1f} ms, p90 "
                  f"{ttft['engine_p90_ms']:.1f} ms")
            out["stream"] = ttft
            serve.shutdown()
            if cuda:
                # the direct engine's thread and one replica's
                out["mem_gap_mib_ab"] = p20_memory_back(mem0, 2)

            _phase("Serve (c): autoscaling 1 -> 2 -> 1 on one card")
            asc = {"min_replicas": 1, "max_replicas": 2,
                   "target_ongoing_requests": 4, "upscale_delay_s": 0.5,
                   "downscale_delay_s": 2.0, "metrics_interval_s": 0.2}
            t_scale = time.perf_counter()
            serve.run(build_openai_app(
                cfg, device=device, name="LLMAuto", autoscaling_config=asc,
                ray_actor_options={"num_gpus": 0.5}), route_prefix="/",
                http=True, _blocking_timeout=300)
            port = serve.http_port()
            counts, stop_watch = [], threading.Event()

            def watch():
                while not stop_watch.is_set():
                    st = serve.status().get("LLMAuto")
                    n = st.replica_states.get("RUNNING", 0) if st else 0
                    if not counts or counts[-1][1] != n:
                        counts.append((time.perf_counter() - t_scale, n))
                    stop_watch.wait(0.1)

            watcher = threading.Thread(target=watch)
            watcher.start()
            try:
                asked, answers = [], []
                served_by: dict = {}
                deadline = time.perf_counter() + P20_SCALE_S
                while len(served_by) < 2 or min(served_by.values()) < 1:
                    if time.perf_counter() > deadline:
                        raise AssertionError(
                            f"no two serving replicas in {P20_SCALE_S} s: "
                            f"counts {counts}, served {served_by}")
                    prompts = fresh_wave()
                    h, _, _ = http_wave(prompts)
                    asked += prompts
                    answers += [h[i] for i in range(len(prompts))]
                    reps = p20_replicas("LLMAuto")
                    served_by = {rid: ray_tpu_torch.get(
                        a.get_metrics.remote(), timeout=30)["total"]
                        for rid, a in reps}
                stats = {rid: ray_tpu_torch.get(a.handle_request.remote(
                    "stats", (), {}), timeout=30) for rid, a in reps}
                t_load = time.perf_counter() - t_scale
                deadline = time.perf_counter() + 60
                while counts[-1][1] != 1 or \
                        serve.status()["LLMAuto"].replica_states != \
                        {"RUNNING": 1}:
                    if time.perf_counter() > deadline:
                        raise AssertionError(f"no scale-down: {counts}")
                    time.sleep(0.1)
            finally:
                stop_watch.set()
                watcher.join()
            peak = max(n for _, n in counts)
            if peak != 2 or counts[-1][1] != 1:
                raise AssertionError(f"replica counts {counts}")
            direct, _, _ = p20_loop(asked, lambda p: p20_direct(eng, p,
                                                                greedy64))
            for i, got in enumerate(answers):
                p20_check_completion(f"autoscaled prompt {i}", got,
                                     direct[i][0])
            print(f"replicas over time (s, RUNNING): "
                  + ", ".join(f"({t:.2f}, {n})" for t, n in counts)
                  + f"; load stopped at {t_load:.2f} s after "
                  f"{len(asked)} requests; requests a replica "
                  f"{served_by}; engine prefill chunks a replica "
                  + json.dumps({r: s["prefill_chunks"]
                                for r, s in stats.items()})
                  + "; every text and usage equal to the engine's: ok")
            out["autoscale"] = {"counts": counts, "load_s": t_load,
                                "requests": len(asked),
                                "served_by": list(served_by.values())}
            serve.shutdown()
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
        if cuda:
            # the direct engine's thread and two replicas'
            out["mem_gap_mib_c"] = p20_memory_back(mem0, 3)
    finally:
        eng.shutdown()

    _phase("Serve (d): the refusals")
    t0 = time.perf_counter()
    refused = []

    def refuses(label, exc, fn):
        try:
            fn()
        except exc as e:
            refused.append(f"{label}: {type(e).__name__}")
            return
        raise AssertionError(f"{label} did not raise {exc.__name__}")

    refuses("placement_group_bundles", NotImplementedError,
            lambda: serve.deployment(
                placement_group_bundles=[{"GPU": 1}])(LLMEngine))
    refuses("grpc_options", NotImplementedError,
            lambda: serve.start(grpc_options={"port": 0}))
    if cuda:  # tensor parallelism serves (phase 23): past the cards only
        n_cards = torch.cuda.device_count()
        refuses(f"tensor_parallel_size {n_cards + 1} on {n_cards} cards",
                ValueError, lambda: LLMServer(
                    replace(cfg, tensor_parallel_size=n_cards + 1),
                    device=device))
    ray_tpu_torch.init(num_cpus=8)  # no "GPU" resource
    try:
        refuses("num_gpus without a GPU resource", ValueError,
                lambda: serve.run(build_openai_app(
                    cfg, device=device, ray_actor_options={"num_gpus": 1}),
                    _blocking_timeout=60))
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    refuse_s = time.perf_counter() - t0
    if refuse_s > 5:
        raise AssertionError(f"the refusals took {refuse_s:.2f} s")
    print(f"{'; '.join(refused)}; all in {refuse_s:.3f} s")
    import shutil

    shutil.rmtree(ckdir, ignore_errors=True)
    out["refusals_s"] = refuse_s
    out["launches"] = serve_launches
    if cuda and serve_launches < 1:
        raise AssertionError("rms_norm never launched on the serve path")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"rms_norm launches on the serve path {serve_launches}; phase 20: "
          f"{out['phase_s']:.1f} s")
    return out


P21_WARMUP, P21_STEPS = 1, 3   # steps of each run: warm-up, then timed
P21_POLICIES = ("none", "full", "attn", "attn+", "dots", "dots+",
                "dots:8,attn:8")
P21_GRAD_TOL = dict(rtol=1e-6, atol=1e-7)  # test_torch_train.py's
P21_CE_CHUNKS = (256, 2048)  # against the default 512, under dots
P21_CE_RTOL = 1e-5           # test_torch_loss.py's f32 tolerance
P21_AUTOTUNE_BATCHES = (4, 8)
P21_MAX_MEASURE = 6
P21_TUNE_LAYERS, P21_TUNE_BATCH, P21_TUNE_STEPS = 2, 2, 8
P21_TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
P21_TUNE_REMAT = "dots"
P21_TRAINER_LRS = (3e-4, 1e-3)
P21_TRAINER_STEPS = 3
P21_FIT_DEADLINE_S = 300
P21_TUNE_THREADS = 4  # trial threads that ran matmuls at once
# cuBLAS workspaces a thread of a training step leaves: the fused loss's
# f32-output products go through cuBLASLt, which keeps its own (phase
# 21's first chip run read 64 MiB for the main thread after (b)).
P21_THREAD_WORKSPACES = 2


P21_KERNELS = ("rms_norm", "flash_fwd", "flash_bwd")  # K1-K3


def _p21_counts(counters) -> dict:
    return {k: counters[k].launches for k in P21_KERNELS}


def _p21_zero(counters) -> None:
    for c in counters.values():
        c.launches = 0


def _p21_add(total: dict, launches: dict) -> None:
    """Adds one run's K1-K3 launches (timed_steps zeroes the counts at
    each run's start) to a part's total."""
    for k in P21_KERNELS:
        total[k] = total.get(k, 0) + launches[k]


def p21_grads_against_none(names, loss_call, params, policies) -> dict:
    """Each policy's loss and gradients of one forward + backward from
    ``params`` against remat none's: the loss bit-equal, every gradient
    within P21_GRAD_TOL (and whether bit-equal). Fails on a difference.
    Also what each policy keeps for the backward: the card's allocated
    bytes after the forward over before it."""
    import torch
    from ray_tpu_torch._device import tree_leaves, tree_map

    tree = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(tree)
    kept = {}

    def run(policy):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()

        def call():
            loss = loss_call(tree, policy)
            torch.cuda.synchronize()
            kept[policy] = torch.cuda.memory_allocated() - base
            return loss

        return _loss_grads(call, leaves)

    ref_loss, ref = run("none")
    out = {"none": {"kept_gib": kept["none"] / 2 ** 30}}
    for policy in policies:
        loss, got = run(policy)
        if loss != ref_loss:
            raise AssertionError(f"remat {policy}: loss {loss!r} != none's "
                                 f"{ref_loss!r}")
        bits = True
        for name, g, w in zip(names, got, ref):
            torch.testing.assert_close(
                g, w, **P21_GRAD_TOL,
                msg=lambda m, n=name: f"remat {policy} grad {n}: {m}")
            bits = bits and torch.equal(g, w)
        out[policy] = {"loss": loss, "grads_bit_equal": bits,
                       "kept_gib": kept[policy] / 2 ** 30}
        del got
    del ref, leaves, tree
    return out


def p21_policy_runs(label, model, cfg, params, make_step, batch, loss_call,
                    policies, counters, launches: dict, predict=None,
                    tokens_per_step=None) -> dict:
    """(a) for one model: every policy in ``policies`` from the same
    params on the same batch, P21_WARMUP + P21_STEPS steps each, the
    first loss bit-equal to none's, launches per step as predicted, and
    one forward + backward each against none's gradients. ``make_step(p)``
    gives (step, init, shard) under policy p; ``predict(p)`` the
    autotuner's bytes for p (None: no model of this family); ``launches``
    gets the runs' K1-K3 launches."""
    import torch

    names = list(_leaf_names(params))
    grads = p21_grads_against_none(names, loss_call, params,
                                   [p for p in policies if p != "none"])
    torch.cuda.empty_cache()
    runs = {}
    for policy in policies:
        step, init, shard = make_step(policy)
        r = timed_steps(step, init, params, shard(batch[0]),
                        shard(batch[1]), P21_WARMUP, P21_STEPS, counters,
                        profile=True, quiet=True)
        del step, init, shard
        steps = P21_WARMUP + P21_STEPS
        _p21_add(launches, r["launches"])
        per_step = {k: r["launches"][k] / steps for k in P21_KERNELS}
        want = {k: float(v) for k, v in predicted_launches(
            policy, cfg.num_layers, model=model).items() if k in per_step}
        if per_step != want:
            raise AssertionError(f"{label} remat {policy}: launches per step "
                                 f"{per_step} != the prediction {want}")
        if r["losses"][0] != runs.get("none", r)["losses"][0]:
            raise AssertionError(
                f"{label} remat {policy}: step 1's loss {r['losses'][0]!r} "
                f"!= none's {runs['none']['losses'][0]!r}")
        pred = predict(policy) if predict else None
        ms = statistics.median(r["step_ms_events"])
        runs[policy] = {
            "losses": r["losses"], "step_ms": ms,
            "step_ms_events": r["step_ms_events"],
            "per_s": tokens_per_step / (ms / 1e3),
            "peak_gib": r["peak_gib"], "launches_per_step": per_step,
            "predicted_gib": None if pred is None else pred / 2 ** 30,
            "busy_ms": r["profile"]["busy_ms"],
            "profiled_wall_ms": r["profile"]["profiled_wall_ms"],
            **grads.get(policy, {})}
        x = runs[policy]
        print(f"{label} {policy}: {ms:.2f} ms a step (median of "
              f"{P21_STEPS}), {x['per_s']:.1f} {'images' if model == 'vit' else 'tokens'}/s, "
              f"kept after the forward {x['kept_gib']:.3f} GiB, peak "
              f"{x['peak_gib']:.3f} GiB, predicted "
              + ("n/a" if pred is None else f"{x['predicted_gib']:.3f} GiB "
                 f"(measured/predicted {x['peak_gib'] / x['predicted_gib']:.3f})")
              + "; launches per step " + ", ".join(
                  f"{k} {v:g}" for k, v in per_step.items())
              + (f"; grads bit-equal to none's: {x['grads_bit_equal']}"
                 if "grads_bit_equal" in x else "")
              + ("; device busy " + (
                  f"{x['busy_ms']:.2f} of {x['profiled_wall_ms']:.2f} ms "
                  f"profiled" if x["busy_ms"] else "not measured"))
              + f"; step-1 loss {r['losses'][0]:.6f}")
        torch.cuda.empty_cache()
    return runs


def p21_remat(counters) -> dict:
    """(a): every remat policy at full width, ViT and Mixtral under attn
    and dots, and RTPU_CE_CHUNK."""
    from dataclasses import replace

    import numpy as np
    import torch
    from ray_tpu_torch.autotune import Candidate, predict_hbm
    from ray_tpu_torch.models import llama, mixtral, vit
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.models.vit import ViTConfig
    from ray_tpu_torch.train import (
        adamw_lowmem,
        make_llama_train_step,
        make_mixtral_train_step,
        make_vit_train_step,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    out, launches = {}, {}
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    batch, seq = 4, 2048
    params = llama.init_params(cfg, generator=SEED, device=dev)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    targets = np.roll(tokens, -1, axis=1)
    tok_t, tgt_t = (torch.as_tensor(a, device=dev) for a in (tokens, targets))

    def llama_step(policy):
        return make_llama_train_step(
            cfg, optimizer=adamw_lowmem(3e-4, weight_decay=0.1),
            attn_impl="flash", remat=policy, seed=SEED, device=dev)

    out["llama"] = p21_policy_runs(
        "1.1B", "llama", cfg, params, llama_step, (tokens, targets),
        lambda p, r: llama.loss_fn(cfg, p, tok_t, tgt_t, attn_impl="flash",
                                   remat=r),
        P21_POLICIES, counters, launches,
        predict=lambda r: predict_hbm(cfg, seq, Candidate(
            batch=batch, remat=r)).total_bytes,
        tokens_per_step=batch * seq)

    chunks = {512: out["llama"]["dots"]}
    for chunk in P21_CE_CHUNKS:
        cand = Candidate(batch=batch, remat="dots", ce_chunk=chunk)
        with cand.applied_env():
            step, init, shard = llama_step("dots")
            r = timed_steps(step, init, params, shard(tokens),
                            shard(targets), P21_WARMUP, P21_STEPS, counters)
            del step, init, shard
        _p21_add(launches, r["launches"])
        ms = statistics.median(r["step_ms_events"])
        chunks[chunk] = {"losses": r["losses"], "step_ms": ms,
                         "peak_gib": r["peak_gib"],
                         "predicted_gib": predict_hbm(
                             cfg, seq, cand).total_bytes / 2 ** 30}
        torch.cuda.empty_cache()
    base = chunks[512]["losses"][0]
    for chunk, r in sorted(chunks.items()):
        if abs(r["losses"][0] - base) > P21_CE_RTOL * abs(base):
            raise AssertionError(f"RTPU_CE_CHUNK={chunk}: loss "
                                 f"{r['losses'][0]!r} vs chunk 512's {base!r}")
        print(f"1.1B dots, RTPU_CE_CHUNK={chunk}: step-1 loss "
              f"{r['losses'][0]:.6f} ({r['losses'][0] / base - 1:+.2e} of "
              f"chunk 512's), {r['step_ms']:.2f} ms a step, peak "
              f"{r['peak_gib']:.3f} GiB, predicted "
              f"{r['predicted_gib']:.3f} GiB")
    out["ce_chunk"] = {str(k): {k2: v2 for k2, v2 in v.items()
                                if k2 in ("step_ms", "peak_gib",
                                          "predicted_gib")}
                       | {"loss": v["losses"][0]}
                       for k, v in chunks.items()}
    del params, tok_t, tgt_t
    torch.cuda.empty_cache()

    vcfg = replace(ViTConfig.base16(), dtype="bfloat16")
    vrng = np.random.default_rng(SEED + 5)
    images = vrng.uniform(0, 1, (VIT_BATCH, vcfg.image_size, vcfg.image_size,
                                 vcfg.num_channels)).astype(np.float32)
    labels = vrng.integers(0, vcfg.num_classes, VIT_BATCH)
    img_t = torch.as_tensor(images, device=dev)
    lab_t = torch.as_tensor(labels, device=dev)
    vparams = vit.init_params(vcfg, generator=SEED, device=dev)
    out["vit"] = p21_policy_runs(
        f"ViT-B/16 b{VIT_BATCH}", "vit", vcfg, vparams,
        lambda r: make_vit_train_step(
            vcfg, optimizer=adamw_lowmem(3e-4, weight_decay=0.1), remat=r,
            seed=SEED, device=dev),
        (images, labels),
        lambda p, r: vit.loss_fn(vcfg, p, img_t, lab_t, remat=r),
        ("none", "attn", "dots"), counters, launches,
        tokens_per_step=VIT_BATCH)
    del vparams, img_t, lab_t
    torch.cuda.empty_cache()

    mcfg = cfg_mixtral(P15_LAYERS)
    mtok = np.random.default_rng(SEED + 7).integers(
        0, mcfg.vocab_size, (P15_BATCH, P15_SEQ), dtype=np.int32)
    mtgt = np.roll(mtok, -1, axis=1)
    mtok_t, mtgt_t = (torch.as_tensor(a, device=dev).long()
                      for a in (mtok, mtgt))
    mparams = mixtral.init_params(mcfg, generator=SEED, device=dev)
    out["mixtral"] = p21_policy_runs(
        f"Mixtral 8x7B-width {P15_LAYERS} layers", "mixtral", mcfg, mparams,
        lambda r: make_mixtral_train_step(mcfg, None, attn_impl="flash",
                                          remat=r, seed=SEED, device=dev),
        (mtok, mtgt),
        lambda p, r: mixtral.loss_fn(mcfg, p, mtok_t, mtgt_t,
                                     attn_impl="flash", remat=r),
        ("none", "attn", "dots"), counters, launches,
        tokens_per_step=P15_BATCH * P15_SEQ)
    del mparams, mtok_t, mtgt_t
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def p21_measure_fn(cfg, seq: int, counters, failures: list,
                   launches: dict):
    """The autotuner's measurement closure (the port's counterpart of
    bench.py's): build the candidate's step and run its steps inside
    ``applied_env()`` (the port reads RTPU_CE_CHUNK at each step),
    P21_WARMUP + P21_STEPS steps, the peak from the built state on; the
    ``finally`` frees everything so that an out-of-memory candidate does
    not poison the next. ``failures`` gets (label, error type, message),
    ``launches`` the K1-K3 launches of the steps that ran."""
    import gc

    import numpy as np
    import torch
    from ray_tpu_torch.train import adamw, adamw_lowmem, make_llama_train_step

    def measure(cand):
        step = init = shard = None
        try:
            opt = (adamw_lowmem(3e-4, weight_decay=0.1)
                   if cand.opt == "lowmem" else
                   adamw(3e-4, weight_decay=0.1, mu_dtype=torch.bfloat16))
            tokens = np.random.default_rng(SEED).integers(
                0, cfg.vocab_size, (cand.batch, seq), dtype=np.int32)
            with cand.applied_env():
                step, init, shard = make_llama_train_step(
                    cfg, optimizer=opt, attn_impl=cand.attn,
                    remat=cand.remat, seed=SEED, device="cuda",
                    **cand.step_options())
                r = timed_steps(step, init, None, shard(tokens),
                                shard(np.roll(tokens, -1, axis=1)),
                                P21_WARMUP, P21_STEPS, counters)
            _p21_add(launches, r["launches"])
            ms = statistics.median(r["step_ms_events"])
            peak = int(r["peak_gib"] * 2 ** 30)
            return {"tokens_per_sec": cand.batch * seq / (ms / 1e3),
                    "step_ms": ms, "measured_hbm_bytes": peak,
                    "measured_hbm_gb": round(peak / 2 ** 30, 3),
                    "hbm_source": "torch.cuda.max_memory_allocated"}
        except Exception as e:  # noqa: BLE001 - recorded, then re-raised
            failures.append((cand.label, type(e).__name__, str(e)[:200]))
            raise
        finally:
            step = init = shard = None  # noqa: F841
            gc.unfreeze()
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    return measure


def p21_autotune(counters) -> dict:
    """(b): autotune_train_configs at the 1.1B geometry, s2048, over
    candidate_space(16, batches=(4, 8)) within the card's memory."""
    import tempfile

    import torch
    from ray_tpu_torch.autotune import (
        AutotuneCache,
        autotune_train_configs,
        candidate_space,
        device_hbm_budget_bytes,
        predict_hbm,
    )
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    seq = 2048
    space = candidate_space(cfg.num_layers, batches=P21_AUTOTUNE_BATCHES)
    budget = device_hbm_budget_bytes()
    kind = torch.cuda.get_device_name(0)
    failures: list = []
    launches: dict = {}
    mem0, _ = p20_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        cache = AutotuneCache(os.path.join(tmp, "autotune.json"))
        t0 = time.perf_counter()
        res = autotune_train_configs(
            cfg, seq, space, hbm_budget_bytes=budget,
            measure_fn=p21_measure_fn(cfg, seq, counters, failures,
                                      launches),
            max_measure=P21_MAX_MEASURE, cache=cache, device_kind=kind)
        search_s = time.perf_counter() - t0
        again = autotune_train_configs(
            cfg, seq, space, hbm_budget_bytes=budget, measure_fn=None,
            max_measure=P21_MAX_MEASURE, cache=cache, device_kind=kind)
    now, workspaces = p20_allocated()
    if abs(now - mem0) > P20_MEM_SLACK:
        raise AssertionError(f"autotune: card memory after the search "
                             f"{(now - mem0) / 2 ** 20:+.1f} MiB from before")
    if res.measured < 1:
        raise AssertionError(f"autotune measured nothing: {res.trace}")
    by_label = {c.label: c for c in space}
    for label, kind_, msg in failures:
        pred = predict_hbm(cfg, seq, by_label[label]).total_bytes
        print(f"autotune: {label} failed ({kind_}), predicted "
              f"{pred / 2 ** 30:.3f} GiB: {msg}")
    bad = [f for f in failures if f[1] != "OutOfMemoryError"]
    if bad:
        raise AssertionError(f"autotune candidates failed with other than "
                             f"out-of-memory: {bad}")
    if again.winner != res.winner:
        raise AssertionError(f"autotune rerun from the cache chose "
                             f"{again.winner}, the measured winner is "
                             f"{res.winner}")
    rows = [r for r in res.trace if "tokens_per_sec" in r]
    for r in rows:
        r["measured_over_predicted"] = (r["measured_hbm_gb"]
                                        / r["predicted_hbm_gb"])
        print(f"autotune measured {r['config']}: {r['tokens_per_sec']:.1f} "
              f"tokens/s ({r['step_ms']:.2f} ms a step), peak "
              f"{r['measured_hbm_gb']:.3f} GiB, predicted "
              f"{r['predicted_hbm_gb']:.3f} GiB, measured/predicted "
              f"{r['measured_over_predicted']:.3f}")
    print(f"autotune: space {res.space_size}, pruned {res.pruned} (budget "
          f"{budget / 2 ** 30:.2f} GiB), measured {res.measured}, failed "
          f"{res.failed}, in {search_s:.1f} s; winner {res.winner} at "
          f"{res.tokens_per_sec:.1f} tokens/s; the rerun from the cache "
          f"alone chose {again.winner}; card memory after "
          f"{(now - mem0) / 2 ** 20:+.2f} MiB ({workspaces / 2 ** 20:.0f} "
          f"MiB of cuBLAS workspaces cleared)")
    return {"space": res.space_size, "pruned": res.pruned,
            "measured": res.measured, "failed": res.failed,
            "budget_gib": budget / 2 ** 30, "winner": res.winner,
            "tokens_per_sec": res.tokens_per_sec, "search_s": search_s,
            "rerun_winner": again.winner, "measured_rows": rows,
            "failures": failures, "launches": launches}


def p21_tune_losses(lr: float, report=None) -> list:
    """The 1.1B geometry at P21_TUNE_LAYERS layers, b2 s2048, remat
    P21_TUNE_REMAT, adamw_lowmem(lr), P21_TUNE_STEPS steps on one seeded
    batch (phase 19's first), so that a good lr fits it; the losses so
    far, handed to ``report`` after each step."""
    from dataclasses import replace

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step

    cfg = replace(LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048),
                  num_layers=P21_TUNE_LAYERS)
    step, init, shard = make_llama_train_step(
        cfg, optimizer=adamw_lowmem(lr, weight_decay=0.1),
        attn_impl="flash", remat=P21_TUNE_REMAT, seed=SEED, device="cuda")
    state = init()
    tok, tgt = _p19_batch(0, cfg.vocab_size, P21_TUNE_BATCH, 2048)
    tok, tgt = shard(tok), shard(tgt)
    losses = []
    for _ in range(P21_TUNE_STEPS):
        state, m = step(state, tok, tgt)
        losses.append(float(m["loss"]))
        if report is not None:
            report(losses)
    return losses


def p21_tune_trial(config: dict) -> None:
    """Tune's function trainable: every step reports the loss and the
    losses so far."""
    from ray_tpu_torch import tune

    p21_tune_losses(config["lr"], lambda losses: tune.report(
        {"loss": losses[-1], "losses": list(losses)}))


def p21_trainer_fn(config: dict) -> None:
    """TorchTrainer's train function: phase 19's step (its seeded batches)
    at P21_TUNE_LAYERS layers with adamw_lowmem(config["lr"])."""
    from dataclasses import replace

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import (
        adamw_lowmem,
        get_context,
        make_llama_train_step,
        report,
    )

    cfg = replace(LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048),
                  num_layers=P21_TUNE_LAYERS)
    step, init, shard = make_llama_train_step(
        cfg, optimizer=adamw_lowmem(config["lr"], weight_decay=0.1),
        attn_impl="flash", remat="attn+", seed=SEED,
        device=get_context().get_device())
    state = init()
    for i in range(config["steps"]):
        tok, tgt = _p19_batch(i, cfg.vocab_size, P21_TUNE_BATCH, 2048)
        state, m = step(state, shard(tok), shard(tgt))
        report({"loss": float(m["loss"]), "step": i})


def _p21_trainer(lr: float):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    return TorchTrainer(
        p21_trainer_fn, train_loop_config={"lr": lr,
                                           "steps": P21_TRAINER_STEPS},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True))


def p21_tune(counters) -> dict:
    """(c): Tune's Tuner on the card, four trials at once a quarter card
    each, against the same function run directly; then TorchTrainer under
    Tune against the trainer alone."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import tune

    direct, t0 = {}, time.perf_counter()
    for lr in P21_TUNE_LRS:
        direct[lr] = p21_tune_losses(lr)
    direct_s = time.perf_counter() - t0
    best_lr = min(P21_TUNE_LRS, key=lambda lr: direct[lr][-1])
    early = min(P21_TUNE_LRS, key=lambda lr: direct[lr][1])
    print("Tune direct runs (main thread): " + "; ".join(
        f"lr {lr:g}: " + " ".join(f"{x:.4f}" for x in direct[lr])
        for lr in P21_TUNE_LRS) + f"; best lr {best_lr:g} (at step 2: "
        f"{early:g}), {direct_s:.2f} s")
    torch.cuda.empty_cache()
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    try:
        mem0, _ = p20_allocated()
        _p21_zero(counters)
        t0 = time.perf_counter()
        grid = _fit_in_time(tune.Tuner(
            p21_tune_trial,
            param_space={"lr": tune.grid_search(list(P21_TUNE_LRS))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=4,
                scheduler=tune.AsyncHyperBandScheduler(
                    max_t=P21_TUNE_STEPS, grace_period=2)),
            trial_resources={"CPU": 1, "GPU": 0.25}), P21_FIT_DEADLINE_S)
        fit_s = time.perf_counter() - t0
        launches = _p21_counts(counters)
        freed = 0
        deadline = time.perf_counter() + 15
        while True:
            now, ws = p20_allocated()
            freed += ws
            if abs(now - mem0) <= P20_MEM_SLACK:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"Tune: card memory after fit() "
                                     f"{(now - mem0) / 2 ** 20:+.1f} MiB")
            time.sleep(0.2)
        if freed > (P21_TUNE_THREADS * P21_THREAD_WORKSPACES
                    * P20_CUBLAS_WORKSPACE):
            raise AssertionError(f"Tune: {freed / 2 ** 20:.0f} MiB of cuBLAS "
                                 f"workspaces after fit(): a handle kept")
        if grid.errors:
            raise AssertionError(f"Tune trials failed: {grid.errors}")
        stopped, reached = 0, {}
        for r in grid.results:
            got = r.metrics["losses"]
            want = direct[r.config["lr"]][:len(got)]
            if got != want:
                raise AssertionError(f"Tune trial lr {r.config['lr']:g}: "
                                     f"losses {got} != direct {want}")
            stopped += len(got) < P21_TUNE_STEPS
            reached[r.config["lr"]] = len(got)
        # ASHA stops whichever trial reaches its rung last, a race between
        # the trials' threads: the best is held against the direct runs
        # cut where each trial stopped, and against the whole runs' best
        # when no trial that could win was stopped.
        best = grid.get_best_result().config["lr"]
        cut_best = min(reached, key=lambda lr: direct[lr][reached[lr] - 1])
        if best != cut_best or (reached[best_lr] == P21_TUNE_STEPS
                                and best != best_lr):
            raise AssertionError(f"Tune's best lr {best:g}: the direct runs "
                                 f"cut at the trials' stops give "
                                 f"{cut_best:g}, whole {best_lr:g}")
        print(f"Tune: {len(grid)} trials, 4 at once ({{'CPU': 1, 'GPU': "
              f"0.25}} each), ASHA max_t {P21_TUNE_STEPS} grace 2: "
              f"{stopped} stopped early (steps run: " + ", ".join(
                  f"lr {k:g} {v}" for k, v in sorted(reached.items()))
              + f"); every trial's losses bit-equal to the direct run's; "
              f"best lr {best:g} (the direct runs' {best_lr:g}); fit() "
              f"{fit_s:.2f} s vs "
              f"the direct runs' {direct_s:.2f} s; card memory after fit() "
              f"{(now - mem0) / 2 ** 20:+.2f} MiB ({freed / 2 ** 20:.0f} "
              f"MiB of cuBLAS workspaces cleared); launches " + ", ".join(
                  f"{k} {v}" for k, v in launches.items())
              + "; device busy share over fit(): not measured")

        alone = {}
        for lr in P21_TRAINER_LRS:
            res = _fit_in_time(_p21_trainer(lr), P21_FIT_DEADLINE_S)
            if res.error:
                raise AssertionError(f"TorchTrainer lr {lr:g}: {res.error}")
            alone[lr] = res.metrics["loss"]
        t0 = time.perf_counter()
        tgrid = _fit_in_time(tune.Tuner(
            _p21_trainer(P21_TRAINER_LRS[0]),
            param_space={"train_loop_config": {
                "lr": tune.grid_search(list(P21_TRAINER_LRS)),
                "steps": P21_TRAINER_STEPS}},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=1)),
            P21_FIT_DEADLINE_S)
        tfit_s = time.perf_counter() - t0
        if tgrid.errors:
            raise AssertionError(f"Tuner(TorchTrainer) failed: "
                                 f"{tgrid.errors}")
        for r in tgrid.results:
            lr = r.config["train_loop_config"]["lr"]
            if r.metrics["loss"] != alone[lr]:
                raise AssertionError(
                    f"Tuner(TorchTrainer) lr {lr:g}: final loss "
                    f"{r.metrics['loss']!r} != alone {alone[lr]!r}")
        print(f"Tuner(TorchTrainer): {len(tgrid)} trials of phase 19's step "
              f"at {P21_TUNE_LAYERS} layers, {P21_TRAINER_STEPS} steps, "
              f"each final loss equal to the trainer alone's ("
              + ", ".join(f"lr {k:g}: {v:.6f}" for k, v in alone.items())
              + f"); fit() {tfit_s:.2f} s")
    finally:
        ray_tpu_torch.shutdown()
    return {"trials": len(grid), "stopped_early": stopped, "best_lr": best,
            "direct_best_lr": best_lr, "steps_run": {
                str(k): v for k, v in reached.items()},
            "direct_losses": {str(k): v for k, v in direct.items()},
            "fit_s": fit_s, "direct_s": direct_s, "launches": launches,
            "memory_after_mib": (now - mem0) / 2 ** 20,
            "trainer_trials": len(tgrid), "trainer_fit_s": tfit_s,
            "trainer_losses": {str(k): v for k, v in alone.items()}}


def phase_tuning() -> dict:
    """Phase 21: tuning on the card. (a) every remat policy, (b) the
    autotuner, (c) Tune; K1-K3's launches counted over each part."""
    _phase("tuning: every remat policy (1.1B, ViT-B/16, Mixtral), "
           "RTPU_CE_CHUNK, the train-step autotuner within the card's "
           "memory, and Tune's Tuner with ASHA on the port's runtime")
    counters = _counters()
    out, launches = {}, {}
    for name, part in (("remat", p21_remat), ("autotune", p21_autotune),
                       ("tune", p21_tune)):
        t0 = time.perf_counter()
        out[name] = part(counters)
        launches[name] = out[name].pop("launches")
        out[name + "_s"] = time.perf_counter() - t0
        idle = [k for k in P21_KERNELS if not launches[name].get(k)]
        if idle:
            raise AssertionError(f"phase 21 ({name}): {idle} never launched")
        print(f"phase 21 ({name}) took {out[name + '_s']:.1f} s; launches "
              + ", ".join(f"{k} {v}" for k, v in launches[name].items()))
    out["launches"] = launches
    return out


# Phase 22: every mesh layout of the training step on one card (one-rank
# NCCL groups: a one-rank gather, reduce-scatter or all-reduce is a copy,
# so each mode must give its reference's losses bit for bit).
P22_WARMUP, P22_STEPS = 1, 2
# (c)'s depth: the save and two restores write and read the state (params
# and adamw_lowmem's bf16 moments, ~8 GB at one layer: the untied
# embedding and head hold 1.05B of its 1.27B params) at DCP's ~0.5 and
# ~1.5 GB/s (phase 19), so one layer keeps the phase near its budget.
P22_CKPT_LAYERS = 1
P22_CKPT_STEPS = 4  # the uninterrupted run; the save after step 2
# (a)'s rules: embed on tp takes tp before heads (wq), mlp (w_gate) and
# vocab (lm_head), so no unit is tp-local: every split dim is gathered;
# the stacked layers dim over pp is gathered once a step.
P22_GATHER_RULES = {"embed": "tp", "layers": "pp"}
P22_KERNELS = ("rms_norm", "flash_fwd", "flash_bwd")


def _p22_gate(label: str, r: dict, want_losses: list, want: dict,
              launches: dict) -> None:
    """Losses bit-equal to ``want_losses`` step by step, launches per step
    equal to ``want``; adds the run's launches to ``launches``."""
    steps = len(r["losses"])
    per_step = {k: n / steps for k, n in r["launches"].items()}
    for k, n in r["launches"].items():
        launches[k] = launches.get(k, 0) + n
    if per_step != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"{label}: launches per step {per_step} != "
                             f"the prediction {want}")
    if r["losses"] != want_losses[:steps]:
        raise AssertionError(f"{label}: losses {r['losses']} not bit-equal "
                             f"to {want_losses[:steps]}")
    print(f"{label}: losses bit-equal step by step "
          + " ".join(f"{x:.6f}" for x in r["losses"])
          + f"; {r['step_ms']:.2f} ms a step, peak {r['peak_gib']:.3f} GiB"
          + "; launches per step " + ", ".join(
              f"{k} {v:g}" for k, v in per_step.items() if v))


def _p22_unfused_step(cfg, mesh):
    from functools import partial

    import torch
    from ray_tpu_torch.models.llama import (
        init_params,
        loss_fn,
        param_logical_axes,
    )
    from ray_tpu_torch.train import adamw_lowmem, make_train_step

    dev = torch.device("cuda", torch.cuda.current_device())
    return make_train_step(
        mesh, loss=partial(loss_fn, cfg, fused_ce=False, attn_impl="flash",
                           remat="attn+"),
        init_fn=partial(init_params, cfg, device=dev),
        logical_axes=param_logical_axes(cfg),
        optimizer=adamw_lowmem(3e-4, weight_decay=0.1), seed=SEED,
        device=dev)


def p22_checkpoint(mesh, counters, launches) -> dict:
    """(c): FSDP + zero1 (the default rules on the one-rank mesh) for
    P22_CKPT_STEPS steps, written after step 2 through the write-behind
    writer; restored with mesh=None and at the same mesh, each stepping
    on: the losses bit-equal to the uninterrupted run's."""
    import shutil

    import numpy as np
    import torch
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import (
        AsyncCheckpointWriter,
        adamw_lowmem,
        make_llama_train_step,
        restore_pytree,
    )

    cfg = cfg_8b(P22_CKPT_LAYERS)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = init_params(cfg, generator=SEED, device="cuda")
    tokens = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (P13_BATCH, P13_SEQ), dtype=np.int32)
    root = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(root, "ray_tpu_torch", "_native", "_build",
                             "phase22")

    def make(m):
        return make_llama_train_step(
            cfg, m, rules=ShardingRules(),
            optimizer=adamw_lowmem(3e-4, weight_decay=0.1),
            attn_impl="flash", remat="attn+", seed=SEED, device=dev,
            **({"zero1": True} if m is not None else {}))

    out = {"layers": cfg.num_layers, "params": cfg.num_params()}
    try:
        step, init, shard = make(mesh)
        tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))
        state = init(params)
        for c in counters.values():
            c.launches = 0
        losses = []
        for i in range(P22_CKPT_STEPS):
            state, m = step(state, tok, tgt)
            losses.append(float(m["loss"]))
            if i == 1:
                writer = AsyncCheckpointWriter()
                t0 = time.perf_counter()
                writer.save(state.checkpoint_tree(), directory, step=2)
                out["snapshot_s"] = time.perf_counter() - t0
                writer.wait()
                out["save_s"] = time.perf_counter() - t0
                if writer.completed() != [directory]:
                    raise AssertionError("phase 22 (c): the write-behind "
                                         "writer did not complete")
        n = {k: c.launches for k, c in counters.items()}
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
        out["bytes"] = _dir_bytes(directory)
        del state, step, init, shard
        torch.cuda.empty_cache()
        out["losses"] = losses
        for key, m in (("mesh_none", None), ("same_mesh", mesh)):
            step, init, shard = make(m)
            state = init(params)
            t0 = time.perf_counter()
            restore_pytree(directory, state.checkpoint_tree())
            out[key + "_restore_s"] = time.perf_counter() - t0
            got = []
            for _ in range(P22_CKPT_STEPS - 2):
                state, mt = step(state, tok, tgt)
                got.append(float(mt["loss"]))
            if int(state.step) != P22_CKPT_STEPS or got != losses[2:]:
                raise AssertionError(f"phase 22 (c) resumed {key}: losses "
                                     f"{got} not bit-equal to "
                                     f"{losses[2:]}")
            out[key] = got
            del state, step, init, shard
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    gb = out["bytes"] / 1e9
    print(f"(c) FSDP + zero1 at {cfg.num_layers} layer(s) "
          f"({cfg.num_params() / 1e9:.3f}B): losses "
          + " ".join(f"{x:.6f}" for x in out["losses"])
          + f"; written after step 2 by the write-behind writer, "
          f"{gb:.3f} GB in {out['save_s']:.2f} s ({gb / out['save_s']:.2f} "
          f"GB/s; the host snapshot {out['snapshot_s']:.2f} s), restored "
          f"with mesh=None in {out['mesh_none_restore_s']:.2f} s and at the "
          f"same mesh in {out['same_mesh_restore_s']:.2f} s: steps 3-4 "
          f"bit-equal in both")
    return out


def phase_layouts(train8b: dict, moe: dict) -> dict:
    """Phase 22: the new mesh layouts on a one-rank NCCL mesh, each
    against its reference's losses bit for bit: (a) item 1's gathers
    (embed on tp, layers on pp at the Llama-3-8B width of phase 13,
    against phase 13's (a); ViT-B/16 at b128 with classes on tp, against
    mesh=None); (b) the unfused loss under the default rules, against
    mesh=None's; (c) FSDP + zero1 saved and resumed (p22_checkpoint); (d)
    Mixtral (phase 15's configuration) with the batch over (dp, ep): the
    all-to-all dispatch's collectives on one-rank groups, against phase
    15's (a)."""
    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.models.vit import ViTConfig
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import (
        adamw_lowmem,
        make_mixtral_train_step,
        make_vit_train_step,
    )
    from ray_tpu_torch.train.backend import free_port, init_distributed

    _phase("mesh layouts of the training step on one rank: item 1's "
           "gathers (tp, pp), the unfused loss, FSDP + zero1 saved and "
           "resumed, Mixtral's batch over ep")
    t_phase = time.perf_counter()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    counters = _counters()
    launches: dict = {}
    runs: dict = {}
    dev = torch.device("cuda", torch.cuda.current_device())
    try:
        mesh = build_mesh(MeshSpec())
        cfg = cfg_8b(P13_LAYERS)
        params = init_params(cfg, generator=SEED, device="cuda")
        tokens = np.random.default_rng(SEED + 5).integers(
            0, cfg.vocab_size, (P13_BATCH, P13_SEQ), dtype=np.int32)
        want = predicted_launches("attn+", cfg.num_layers)
        a13 = train8b["runs"]["a"]
        r = runs["gathers"] = train_run(
            cfg, mesh, params, tokens, {"rules": P22_GATHER_RULES},
            P22_WARMUP, P22_STEPS, counters)
        _p22_gate(f"(a) embed on tp, layers on pp ({cfg.num_layers} "
                  f"layers) against phase 13's (a)", r, a13["losses"],
                  want, launches)
        tgt = np.roll(tokens, -1, axis=1)
        for key, m in (("unfused_none", None), ("unfused", mesh)):
            step, init, shard = _p22_unfused_step(cfg, m)
            runs[key] = timed_steps(step, init, params, shard(tokens),
                                    shard(tgt), P22_WARMUP, P22_STEPS,
                                    counters)
            del step, init, shard
        _p22_gate("(b) the unfused loss, default rules, against mesh=None's",
                  runs["unfused"], runs["unfused_none"]["losses"], want,
                  launches)
        del params
        torch.cuda.empty_cache()
        vcfg = replace(ViTConfig.base16(), dtype="bfloat16")
        rng = np.random.default_rng(SEED + 5)
        images = rng.uniform(0, 1, (VIT_BATCH, vcfg.image_size,
                                    vcfg.image_size, vcfg.num_channels)
                             ).astype(np.float32)
        labels = rng.integers(0, vcfg.num_classes, VIT_BATCH)
        for key, m in (("vit_none", None), ("vit_classes_tp", mesh)):
            step, init, shard = make_vit_train_step(
                vcfg, m, rules=ShardingRules().override(classes="tp"),
                optimizer=adamw_lowmem(3e-4, weight_decay=0.1), seed=SEED,
                device=dev)
            runs[key] = timed_steps(step, init, None, shard(images),
                                    shard(labels), P22_WARMUP, P22_STEPS,
                                    counters)
            del step, init, shard
        _p22_gate(f"(a) ViT-B/16 b{VIT_BATCH}, classes on tp, against "
                  f"mesh=None", runs["vit_classes_tp"],
                  runs["vit_none"]["losses"],
                  predicted_launches(False, vcfg.num_layers), launches)
        runs["checkpoint"] = p22_checkpoint(mesh, counters, launches)
        mcfg = cfg_mixtral(P15_LAYERS)
        mparams = mixtral.init_params(mcfg, generator=SEED, device="cuda")
        mtok = np.random.default_rng(SEED + 7).integers(
            0, mcfg.vocab_size, (P15_BATCH, P15_SEQ), dtype=np.int32)
        step, init, shard = make_mixtral_train_step(
            mcfg, mesh, rules=ShardingRules().override(batch=("dp", "ep")),
            attn_impl="flash", remat=True, seed=SEED, device=dev)
        runs["mixtral_batch_ep"] = timed_steps(
            step, init, mparams, shard(mtok),
            shard(np.roll(mtok, -1, axis=1)), P22_WARMUP, P22_STEPS,
            counters)
        del step, init, shard, mparams
        torch.cuda.empty_cache()
        _p22_gate("(d) Mixtral, batch over (dp, ep), against phase 15's (a)",
                  runs["mixtral_batch_ep"], moe["runs"]["a"]["losses"],
                  predicted_launches("full", mcfg.num_layers), launches)
    finally:
        dist.destroy_process_group()
    idle = [k for k in P22_KERNELS if not launches.get(k)]
    if idle:
        raise AssertionError(f"phase 22: {idle} never launched")
    for key, ref, what in (("gathers", a13, "phase 13 (a)"),
                           ("unfused", runs["unfused_none"], "mesh=None"),
                           ("vit_classes_tp", runs["vit_none"], "mesh=None"),
                           ("mixtral_batch_ep", moe["runs"]["a"],
                            "phase 15 (a)")):
        r = runs[key]
        r["over_reference"] = r["step_ms"] / ref["step_ms"] - 1
        print(f"{key}: {r['step_ms']:.2f} ms a step, peak "
              f"{r['peak_gib']:.3f} GiB; {what} {ref['step_ms']:.2f} ms, "
              f"peak {ref['peak_gib']:.3f} GiB ({100 * r['over_reference']:+.2f}"
              f"% a step)")
    out = {"runs": runs, "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    print(f"phase 22 took {out['seconds']:.1f} s; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    return out


# Phase 22b: the layouts over four ranks, one card each.
P22B_LAYERS = 8
P22B_BATCH, P22B_SEQ = 2, 8192  # global: 16384 tokens a step
P22B_WARMUP, P22B_STEPS = 1, 2
P22B_CP = {"fsdp2sp2": dict(fsdp=2, sp=2), "tp2sp2": dict(tp=2, sp=2)}
# adamw_lowmem's rate for the CP runs and their one-card reference: at
# 3e-4 the loss of this batch rose at step 3 (12.27, 11.22, 13.62: the
# second adam step overshoots), at 1e-4 too (11.10, 11.90); at 2e-5 it
# falls step by step (12.27, 11.15, 9.45, 8.51), so each step's loss can
# be held against one card's (one card, NVIDIA H100 80GB HBM3, 700.00 W).
P22B_LR = 2e-5
# Each rank's losses, step by step, against one card's run of the same
# global batch, absolute: the ring (K6/K7, chunk by chunk, the log-sum-
# exp combine) rounds the bf16 attention otherwise than K2/K3 on the whole
# sequence, and the ranks' bf16 gradients are summed. Ten times the
# largest gap of the first four-card run's sound readings (1.1e-3).
P22B_TOL = 1e-2
# The first step's grad norm (the params still equal), relative: ten
# times the first four-card run's largest reading (1.2e-4).
P22B_NORM_RTOL = 1.2e-3
# Mixtral's part: its depth and its two optimizers. Four layers do not
# train on one card (out of memory at 75 GiB), so the part runs at phase
# 15's two, each layout against one card's training run of the same
# optimizer. adamw (bf16 moments, eps 1e-8) at 5e-5: its loss falls step
# by step (10.90, 8.23, 7.97, 7.41 on one card), but its first update is
# lr * sign(g) wherever |g| >> eps, so a gradient element that bf16
# rounding leaves near zero moves by lr either way; in the first run
# over ranks the layouts' second losses were 2.9e-3 to 6.3e-2 off one
# card's (the layout with the most bf16 roundings, ep ranks summing
# partial combines, the furthest) while their first losses and grad
# norms agreed within 3.1e-4 and 4.6e-4. Its pre-update loss and grad
# norm are gated and its later losses printed. Plain SGD moves each
# element by lr * g, so a rounding of g stays a rounding of the update:
# its every step is gated, which holds the layouts' gradients, not only
# their norm, against one card's.
P22B_MOE_LAYERS = 2
P22B_MOE_LR = 5e-5
# SGD's rate: its loss falls step by step at 1e-2 (10.896, 10.828,
# 10.762, 10.694 on one card) and not at 3e-2 or above.
P22B_MOE_SGD_LR = 1e-2
# Losses, absolute: ten times the first run's largest first-loss gap
# (3.0e-4 at two layers, 7.4e-4 at four); the first grad norm, relative:
# ten times its largest reading (4.5e-4).
P22B_MOE_TOL = 1e-2
P22B_MOE_NORM_RTOL = 5e-3
P22B_MOE_OPTS = ("adamw", "sgd")
P22B_CKPT_LAYERS = 2
LAYOUTS_TIMEOUT_S = 900


def _p22b_llama(rank, world, counters, res) -> None:
    """Context parallelism under FSDP and TP at the Llama-3-8B width:
    one card's run of the global batch (rank 0, mesh=None, K2/K3), then
    each P22B_CP mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from dataclasses import replace

    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    cfg = replace(cfg_8b(P22B_LAYERS), max_seq_len=P22B_SEQ)
    tokens = np.random.default_rng(SEED + 8).integers(
        0, cfg.vocab_size, (P22B_BATCH, P22B_SEQ), dtype=np.int32)
    params = init_params(cfg, generator=SEED, device="cuda")
    if rank == 0:
        res["one_card"] = train_run(cfg, None, params, tokens, {},
                                    P22B_WARMUP, P22B_STEPS, counters,
                                    lr=P22B_LR)
    dist.barrier()
    for name, axes in P22B_CP.items():
        r = train_run(cfg, build_mesh(MeshSpec(**axes)), params, tokens,
                      {"rules": {}}, P22B_WARMUP, P22B_STEPS, counters,
                      lr=P22B_LR)
        peaks = [None] * world
        dist.all_gather_object(peaks, r["peak_gib"])
        r.update(per_rank_peak_gib=peaks, axes=axes)
        res[name] = r
    del params
    torch.cuda.empty_cache()


P22B_MOE_LAYOUTS = (
    ("moe_dp2ep2", dict(dp=2, ep=2), {}),  # phase 15b's layout
    ("moe_batch_ep", dict(dp=2, ep=2), {"batch": ("dp", "ep")}),
    ("moe_sp2ep2", dict(sp=2, ep=2), {}))


def _p22b_mixtral(rank, world, counters, res) -> None:
    """Mixtral at P22B_MOE_LAYERS, at phase 15b's global batch, under
    each of P22B_MOE_OPTS: one card's training run (rank 0, mesh=None),
    then dp2 x ep2 as phase 15b runs it (the ep ranks on the same rows),
    with the batch over (dp, ep), and sp2 x ep2 (the ring), each from the
    same params with the same optimizer."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import mixtral
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import make_mixtral_train_step
    from ray_tpu_torch.train.optim import adamw, sgd

    cfg = cfg_mixtral(P22B_MOE_LAYERS)
    tokens = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (P15_BATCH, P15_SEQ), dtype=np.int32)
    params = mixtral.init_params(cfg, generator=SEED, device="cuda")
    dev = torch.device("cuda", rank)

    def run(mesh, over, opt):
        step, init, shard = make_mixtral_train_step(
            cfg, mesh, rules=ShardingRules().override(**over),
            optimizer=sgd(P22B_MOE_SGD_LR) if opt == "sgd" else adamw(
                P22B_MOE_LR, weight_decay=0.1, mu_dtype=torch.bfloat16),
            attn_impl="flash", remat=True, seed=SEED, device=dev)
        return timed_steps(step, init, params, shard(tokens),
                           shard(np.roll(tokens, -1, axis=1)), P15_WARMUP,
                           P15_STEPS, counters, quiet=True)

    meshes = {}  # one mesh a layout: each group's NCCL communicator
    # holds card memory outside PyTorch's pool until the process ends
    for opt in P22B_MOE_OPTS:
        if rank == 0:
            res[f"moe_one_card_{opt}"] = run(None, {}, opt)
        dist.barrier()
        for name, axes, over in P22B_MOE_LAYOUTS:
            key = tuple(sorted(axes.items()))
            if key not in meshes:
                meshes[key] = build_mesh(MeshSpec(**axes))
            r = run(meshes[key], over, opt)
            peaks = [None] * world
            dist.all_gather_object(peaks, r["peak_gib"])
            r.update(per_rank_peak_gib=peaks, axes=axes)
            res[f"{name}_{opt}"] = r
    del params
    torch.cuda.empty_cache()


def _p22b_checkpoint(rank, world, res) -> None:
    """An FSDP + zero1 state (fsdp2 x dp2) saved after step 1 and restored
    at tp2 x dp2 under zero1, one step each way."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.train import (
        adamw_lowmem,
        make_llama_train_step,
        restore_pytree,
        save_pytree,
    )

    cfg = cfg_8b(P22B_CKPT_LAYERS)
    dev = torch.device("cuda", rank)
    params = init_params(cfg, generator=SEED, device="cuda")
    tokens = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (P13_BATCH, P13_SEQ), dtype=np.int32)
    tgt = np.roll(tokens, -1, axis=1)
    root = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(root, "ray_tpu_torch", "_native", "_build",
                             "phase22b")

    def make(axes):
        return make_llama_train_step(
            cfg, build_mesh(MeshSpec(**axes)), rules=ShardingRules(),
            optimizer=adamw_lowmem(3e-4, weight_decay=0.1),
            attn_impl="flash", remat="attn+", seed=SEED, device=dev,
            zero1=True)

    try:
        step, init, shard = make(dict(fsdp=2, dp=2))
        state = init(params)
        state, m1 = step(state, shard(tokens), shard(tgt))
        t0 = time.perf_counter()
        save_pytree(state.checkpoint_tree(), directory, step=1)
        save_s = time.perf_counter() - t0
        state, m2 = step(state, shard(tokens), shard(tgt))
        want = [float(m1["loss"]), float(m2["loss"])]
        del state, step, init, shard
        torch.cuda.empty_cache()
        step, init, shard = make(dict(tp=2, dp=2))
        state = init(params)
        t0 = time.perf_counter()
        restore_pytree(directory, state.checkpoint_tree())
        restore_s = time.perf_counter() - t0
        state, m = step(state, shard(tokens), shard(tgt))
        res["checkpoint"] = {"losses": want, "resumed": float(m["loss"]),
                             "step": int(state.step), "save_s": save_s,
                             "restore_s": restore_s,
                             "layers": cfg.num_layers}
        del state, step, init, shard
        dist.barrier()
        if rank == 0:
            res["checkpoint"]["bytes"] = _dir_bytes(directory)
    finally:
        dist.barrier()
        if rank == 0:
            shutil.rmtree(directory, ignore_errors=True)
    del params
    torch.cuda.empty_cache()


# ViT-S/16 (DeiT-S's geometry: 384 wide, 12 layers, 6 heads, MLP 1536,
# 224 px, patch 16) at tp 4, whose 6 heads do not split over 4 ranks: the
# attention weights are gathered over tp, the MLP and classes tp-local.
P22B_VIT = dict(image_size=224, patch_size=16, hidden_size=384,
                intermediate_size=1536, num_layers=12, num_heads=6,
                num_classes=1000, dtype="bfloat16")
P22B_VIT_BATCH = 128
P22B_VIT_WARMUP, P22B_VIT_STEPS = 1, 3
# Its losses against one card's, absolute: the tp ranks' bf16 partial MLP
# outputs are summed (another rounding), as phase 14b's dp sums are.
P22B_VIT_TOL = 2e-2


def _p22b_vit(rank, world, counters, res) -> None:
    """ViT-S/16 at tp = world (6 heads: not a multiple), the global b128
    whole on every rank: one card's run (rank 0, mesh=None), then the tp
    mesh under the default rules, from the same params."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train import adamw_lowmem, make_vit_train_step

    cfg = vit.ViTConfig(**P22B_VIT)
    rng = np.random.default_rng(SEED + 22)
    images = rng.uniform(0, 1, (P22B_VIT_BATCH, cfg.image_size,
                                cfg.image_size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, P22B_VIT_BATCH)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = vit.init_params(cfg, generator=SEED, device=dev)

    def run(mesh):
        torch.cuda.empty_cache()
        step, init, shard = make_vit_train_step(
            cfg, mesh, optimizer=adamw_lowmem(3e-4, weight_decay=0.1),
            seed=SEED, device=dev)
        return timed_steps(step, init, params, shard(images),
                           shard(labels), P22B_VIT_WARMUP, P22B_VIT_STEPS,
                           counters)

    if rank == 0:
        res["vit_one_card"] = run(None)
    dist.barrier()
    r = run(build_mesh(MeshSpec(tp=world)))
    peaks = [None] * world
    dist.all_gather_object(peaks, r["peak_gib"])
    losses = [None] * world
    dist.all_gather_object(losses, r["losses"])
    r.update(per_rank_peak_gib=peaks, rank_losses=losses)
    res[f"vit_tp{world}"] = r
    del params
    torch.cuda.empty_cache()


def _rank_layouts(rank: int, world: int, store: str, out_path: str,
                  port: int, part: str) -> None:
    """One rank of one part of ``phase_layouts_ranks`` on card ``rank``;
    rank 0 writes the readings."""
    import torch.distributed as dist
    from ray_tpu_torch.train.backend import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, device="cuda")
    res: dict = {}
    if part == "checkpoint":
        _p22b_checkpoint(rank, world, res)
    else:
        {"llama": _p22b_llama, "mixtral": _p22b_mixtral,
         "vit": _p22b_vit}[part](rank, world, _counters(), res)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


P22B_PARTS = ("llama", "mixtral", "checkpoint", "vit")


def phase_layouts_ranks(world: int, parts=P22B_PARTS) -> dict:
    """Phase 22b (four cards, one a rank): context parallelism under FSDP
    and TP (fsdp2 x sp2, tp2 x sp2) at the Llama-3-8B width, P22B_LAYERS
    layers, global b2 s8192, losses step by step and the first grad norm
    against one card's run of the same batch; Mixtral (P22B_MOE_LAYERS,
    phase 15b's global batch) dp2 x ep2 with the batch over (dp, ep) and
    sp2 x ep2 (the ring), each beside dp2 x ep2 as phase 15b runs it and
    held against one card's training run under adamw and under SGD; an
    FSDP + zero1 state saved
    at fsdp2 x dp2 and restored at tp2 x dp2; ViT-S/16 at tp 4 (6 heads,
    gathered) against one card's run. Every gate is read before the
    phase fails. ``parts`` runs those alone."""
    import tempfile

    from ray_tpu_torch._spawn import run_ranks
    from ray_tpu_torch.train.backend import free_port

    _phase(f"mesh layouts over {world} ranks, one card each: CP under "
           f"FSDP/TP, Mixtral's batch over ep and sp, FSDP + zero1 across "
           f"meshes")
    t_phase = time.perf_counter()
    res: dict = {}
    # Each part in fresh processes: the NCCL communicators of the earlier
    # parts' meshes would keep their card memory (an out-of-memory in
    # the first run that held all three in one process).
    for part in parts:
        with tempfile.TemporaryDirectory() as tmp:
            out_path = os.path.join(tmp, "rank0.json")
            run_ranks(_rank_layouts, world, tmp,
                      (out_path, free_port(), part), LAYOUTS_TIMEOUT_S)
            with open(out_path) as f:
                res.update(json.load(f))
    failures = []  # every gate is read and printed before any fails

    def gate(name, r, one, tol, norm_rtol, gated=None):
        """``r``'s losses (the first ``gated``; all by default) and first
        grad norm against one card's ``one``."""
        r["loss_gaps"] = [abs(a - b) for a, b in zip(r["losses"],
                                                     one["losses"])]
        r["norm_gap"] = abs(r["norms"][0] - one["norms"][0]) / \
            one["norms"][0]
        which = "each" if gated is None else \
            "the first" if gated == 1 else f"the first {gated}"
        print(f"{name}: losses off one card's by "
              + ", ".join(f"{d:.3e}" for d in r["loss_gaps"])
              + f" ({which} limited to {tol}); grad_norm "
              + " ".join(f"{x:.4f}" for x in r["norms"]) + " (one card's "
              + " ".join(f"{x:.4f}" for x in one["norms"])
              + f"), the first {r['norm_gap']:.3e} off (relative, limit "
              f"{norm_rtol})")
        if not all(math.isfinite(x) for x in r["losses"] + r["norms"]) \
                or max(r["loss_gaps"][:gated]) > tol \
                or r["norm_gap"] > norm_rtol:
            failures.append(f"{name}: losses {r['losses']} norms "
                            f"{r['norms']} against one card's "
                            f"{one['losses']} {one['norms']}")

    def falls(name, losses):
        if not all(b < a for a, b in zip(losses, losses[1:])):
            failures.append(f"{name}: the one-card losses {losses} do not "
                            f"fall step by step")

    launches: dict = {}
    if "vit" in parts:
        _p22b_vit_gates(res, world, failures, launches)
    if "llama" not in parts:  # a partial run: the parts it ran
        if failures:
            raise AssertionError("phase 22b: " + "; ".join(failures))
        res["launches"] = launches
        res["seconds"] = time.perf_counter() - t_phase
        return res
    one = res["one_card"]
    cfg = cfg_8b(P22B_LAYERS)
    print(f"one card, mesh=None, global b{P22B_BATCH} s{P22B_SEQ}, "
          f"{cfg.num_layers} layers, lr {P22B_LR}: {one['step_ms']:.2f} ms "
          f"a step, peak {one['peak_gib']:.3f} GiB; loss "
          + " ".join(f"{x:.6f}" for x in one["losses"]) + "; grad_norm "
          + " ".join(f"{x:.4f}" for x in one["norms"]))
    falls("Llama", one["losses"])
    cp_want = predicted_launches("attn+", cfg.num_layers, ring=2)
    for name in P22B_CP:
        r = res[name]
        steps = len(r["losses"])
        per_step = {k: n / steps for k, n in r["launches"].items()}
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        rows = P22B_BATCH * P22B_SEQ / world  # a card's share of tokens
        r["tokens_per_s_per_card"] = rows / (r["step_ms"] / 1e3)
        print(f"{name}: {r['step_ms']:.2f} ms a step on rank 0's host "
              f"clock, {r['tokens_per_s_per_card']:.1f} tokens/s per card; "
              f"peak GiB per rank "
              f"{[round(p, 3) for p in r['per_rank_peak_gib']]}; loss "
              + " ".join(f"{x:.6f}" for x in r["losses"])
              + "; launches a rank a step " + ", ".join(
                  f"{k} {v:g}" for k, v in per_step.items() if v))
        if per_step != {k: float(v) for k, v in cp_want.items()}:
            failures.append(f"{name}: launches per step {per_step} != the "
                            f"prediction {cp_want}")
        gate(name, r, one, P22B_TOL, P22B_NORM_RTOL)
    a, b = (res[n]["losses"] for n in P22B_CP)
    print("fsdp2sp2 against tp2sp2, step by step: "
          + ", ".join(f"{abs(x - y):.3e}" for x, y in zip(a, b)))
    mcfg = cfg_mixtral(P22B_MOE_LAYERS)
    moe_names = [n for n, _, _ in P22B_MOE_LAYOUTS]
    for opt in P22B_MOE_OPTS:
        mone = res[f"moe_one_card_{opt}"]
        lr = P22B_MOE_SGD_LR if opt == "sgd" else P22B_MOE_LR
        print(f"Mixtral one card, mesh=None, {mcfg.num_layers} layers, "
              f"{opt} lr {lr}: {mone['step_ms']:.2f} ms a step, peak "
              f"{mone['peak_gib']:.3f} GiB; loss "
              + " ".join(f"{x:.6f}" for x in mone["losses"])
              + "; grad_norm " + " ".join(f"{x:.4f}" for x in mone["norms"]))
        falls(f"Mixtral {opt}", mone["losses"])
        for name in moe_names:
            key = f"{name}_{opt}"
            r = res[key]
            steps = len(r["losses"])
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
            per_step = {k: n / steps for k, n in r["launches"].items()}
            r["tokens_per_s_per_card"], r["mfu"] = _mixtral_rates(
                mcfg, P15_BATCH / world, r["step_ms"])
            ring = 2 if name == "moe_sp2ep2" else 0
            want = predicted_launches("full", mcfg.num_layers, ring=ring)
            print(f"{key}: {r['step_ms']:.2f} ms a step on rank 0's host "
                  f"clock, {r['tokens_per_s_per_card']:.1f} tokens/s per "
                  f"card, MFU {100 * r['mfu']:.2f}%; peak GiB per rank "
                  f"{[round(p, 3) for p in r['per_rank_peak_gib']]}; loss "
                  + " ".join(f"{x:.6f}" for x in r["losses"])
                  + "; launches a rank a step " + ", ".join(
                      f"{k} {v:g}" for k, v in per_step.items() if v))
            if per_step != {k: float(v) for k, v in want.items()}:
                failures.append(f"{key}: launches per step {per_step} != "
                                f"the prediction {want}")
            # adamw: the loss before the first update only (see the
            # notes at P22B_MOE_LR); SGD: every step.
            gate(key, r, mone, P22B_MOE_TOL, P22B_MOE_NORM_RTOL,
                 1 if opt == "adamw" else None)
    base = res["moe_dp2ep2_adamw"]["tokens_per_s_per_card"]
    for name in moe_names[1:]:
        r = res[f"{name}_adamw"]
        r["over_dp2ep2"] = r["tokens_per_s_per_card"] / base
        print(f"{name}: {r['over_dp2ep2']:.3f}x the tokens/s per card of "
              f"dp2 x ep2 with the ep ranks on the same rows ({base:.1f}, "
              f"phase 15b's layout, in this phase, adamw)")
    ck = res["checkpoint"]
    diff = abs(ck["resumed"] - ck["losses"][1])
    print(f"FSDP + zero1 at {ck['layers']} layers saved at fsdp2 x dp2 after "
          f"step 1 ({ck['bytes'] / 1e9:.3f} GB in {ck['save_s']:.2f} s), "
          f"restored at tp2 x dp2 in {ck['restore_s']:.2f} s: step 2's loss "
          f"{ck['resumed']:.6f} against the uninterrupted {ck['losses'][1]:.6f}"
          f" ({diff:.3e}, limit {P13B_TOL})")
    if ck["step"] != 2 or diff > P13B_TOL:
        failures.append(f"checkpoint: {ck}")
    if failures:
        raise AssertionError("phase 22b: " + "; ".join(failures))
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    print(f"phase 22b took {res['seconds']:.1f} s")
    return res


def _p22b_vit_gates(res, world, failures, launches) -> None:
    """ViT-S/16 at tp = world against one card: each step's loss within
    P22B_VIT_TOL, every rank the same losses, launches a rank a step as
    predicted; images/s per card and per-rank peak."""
    one, r = res["vit_one_card"], res[f"vit_tp{world}"]
    cfg_layers = P22B_VIT["num_layers"]
    steps = len(r["losses"])
    per_step = {k: n / steps for k, n in r["launches"].items()}
    for k, n in r["launches"].items():
        launches[k] = launches.get(k, 0) + n
    want = predicted_launches(False, cfg_layers)
    r["images_per_s_per_card"] = P22B_VIT_BATCH / (r["step_ms"] / 1e3) \
        / world
    one["images_per_s"] = P22B_VIT_BATCH / (one["step_ms"] / 1e3)
    gaps = [abs(a - b) for a, b in zip(r["losses"], one["losses"])]
    r["loss_gaps"] = gaps
    print(f"ViT-S/16 one card, mesh=None, b{P22B_VIT_BATCH}: "
          f"{one['step_ms']:.2f} ms a step, {one['images_per_s']:.1f} "
          f"images/s, peak {one['peak_gib']:.3f} GiB; loss "
          + " ".join(f"{x:.6f}" for x in one["losses"]))
    print(f"ViT-S/16 tp{world} (6 heads gathered over tp): "
          f"{r['step_ms']:.2f} ms a step on rank 0's host clock, "
          f"{r['images_per_s_per_card']:.1f} images/s per card; peak GiB "
          f"per rank {[round(p, 3) for p in r['per_rank_peak_gib']]}; loss "
          + " ".join(f"{x:.6f}" for x in r["losses"]) + "; off one card's "
          + ", ".join(f"{d:.3e}" for d in gaps)
          + f" (limit {P22B_VIT_TOL}); launches a rank a step "
          + ", ".join(f"{k} {v:g}" for k, v in per_step.items() if v))
    if not all(math.isfinite(x) for x in r["losses"]) \
            or max(gaps) > P22B_VIT_TOL:
        failures.append(f"vit_tp{world}: losses {r['losses']} against one "
                        f"card's {one['losses']}")
    if any(x != r["rank_losses"][0] for x in r["rank_losses"]):
        failures.append(f"vit_tp{world}: the ranks' losses differ "
                        f"{r['rank_losses']}")
    if per_step != {k: float(v) for k, v in want.items()}:
        failures.append(f"vit_tp{world}: launches per step {per_step} != "
                        f"the prediction {want}")


P23_SEQ = 2048            # max_seq_len: 2.15 GB of bf16 KV at 8 slots
P23_SLOTS = 8             # phase 7's slots; the block pool runs twice as many
P23_BLOCKS = P23_SLOTS * P23_SEQ // REST_BLOCK  # the dense lines' KV bytes
P23_SPEC_LAYERS = 2       # the seeded draft's depth (8B widths)
P23_PD_LENGTHS = REST_PD_LENGTHS
P23_BURST = 16
# A tp engine's first-chunk logits may move from tp 1's by this many times
# tp 1's own move when the chunk is padded (the first four-card run read
# 0.99x at tp 2 and 1.03x at tp 4); a wrong split moves them far more.
P23B_LOGIT_FACTOR = 1.5
P23B_FAIL_S = 60.0   # (f): a killed follower's requests fail within this
P23B_STOP_S = 30.0   # (f): shutdown() returns within this (10 s kill wait)


def p23_config(**kw):
    """Phase 23's engine: Llama-3-8B at all 32 layers, bf16, seeded random
    weights (the same on every run and at every tp: rank 0 initialises the
    whole tree on cuda:0), phase 7's slots and burst."""
    from ray_tpu_torch.llm import LLMConfig

    base = dict(model="llama3_8b", dtype="bfloat16", max_num_seqs=P23_SLOTS,
                max_seq_len=P23_SEQ, decode_burst=P23_BURST, seed=SEED)
    base.update(kw)
    return LLMConfig(**base)


def p23_logits(eng, seq, slot: int = 0, pad: int = 0):
    """f32 logits after ``seq`` from one prefill chunk into ``slot`` (a
    line no request holds: before the first request, or after the last),
    through the engine's own device call on every rank; ``pad`` more
    masked positions change every product's shape, not its inputs."""
    import numpy as np

    s = -(-len(seq) // 64) * 64 + pad
    toks = np.zeros((s,), np.int64)
    toks[:len(seq)] = seq
    return eng._call("prefill", toks, 0, len(seq), slot, None).float().cpu()


def p23_tie(eng, prompt, ref: list, got: list, noise: float) -> dict:
    """Where ``got`` first leaves ``ref``: the two tokens' f32 logits with
    ``ref`` teacher-forced through ``eng`` (a dense engine), against the
    larger of SPEC_TIE_ULPS bf16 steps at the row's scale (phase 17's
    rule) and 2 x ``noise``, the most a logit may move between the two
    arithmetics (two logits that each move by up to ``noise`` swap order
    only within 2 x ``noise`` of a tie). ``noise`` is fixed by tp 1 alone
    (p23b_logit_bound), never read from the engine under test."""
    i = _first_diff(ref, got)
    if i is None:
        return {"differs": False}
    if i >= min(len(ref), len(got)):
        raise AssertionError(f"stream ended apart at {i} ({len(got)} vs "
                             f"{len(ref)} tokens)")
    logits = p23_logits(eng, list(prompt) + list(ref[:i]))
    gap = abs(float(logits[ref[i]]) - float(logits[got[i]]))
    ulps = SPEC_TIE_ULPS * 2.0 ** -8 * float(logits.abs().max())
    return {"differs": True, "at": i, "gap": gap, "ulps_margin": ulps,
            "margin": max(ulps, 2 * noise), "within_ulps": gap <= ulps,
            "tie": gap <= max(ulps, 2 * noise)}


def p23_against(label: str, eng, prompts, ref: dict, got: dict,
                noise: float) -> dict:
    """Streams equal to ``ref``'s, and each divergence a near-tie under
    ``eng``'s own logits (p23_tie)."""
    same = sum(got[i] == ref[i] for i in ref)
    ties = {i: p23_tie(eng, prompts[i], ref[i], got[i], noise)
            for i in ref if got[i] != ref[i]}
    firsts = sorted(t["at"] for t in ties.values())
    in_ulps = sum(t["within_ulps"] for t in ties.values())
    print(f"{label}: {same}/{len(ref)} streams equal; first divergences at "
          f"tokens {firsts}; {in_ulps}/{len(ties)} within {SPEC_TIE_ULPS} "
          f"bf16 steps, gap over 2 x {noise:.4g} "
          f"{[round(t['gap'] / (2 * noise), 3) for t in ties.values()]}")
    bad = {i: t for i, t in ties.items() if not t["tie"]}
    if bad:
        raise AssertionError(f"{label}: not a near-tie: {bad}")
    return {"equal": same, "of": len(ref), "within_ulps": in_ulps,
            "ties": ties}


def p23_wave(eng, prompts, sampling, concurrency: int = 8) -> dict:
    done, wave_s, ttft, out_toks = run_wave(eng, prompts, sampling,
                                            concurrency)
    return {"streams": _streams(done), "tok_per_s": out_toks / wave_s,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "texts": {i: eng._result(r).text for i, r in done}}


def phase_tp_serving() -> dict:
    """Phase 23: Llama-3-8B at full depth through the engine at tp 1,
    phase 7's wave (16 greedy prompts, concurrency 8, 64 out): tok/s, TTFT
    p50, peak memory, K1's launches over the wave; the streams and the
    first prefill chunk's logits are 23b's reference. Then a
    tensor_parallel_size above the visible cards raises ValueError before
    any process starts."""
    import numpy as np
    import torch
    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.ops import norms

    _phase("tensor-parallel serving (23): Llama-3-8B, 32 layers, bf16, "
           "seeded random weights, tp 1 on one card")
    gib = 2.0 ** 30
    torch.cuda.empty_cache()
    mem0 = p20_allocated()[0]
    t0 = time.perf_counter()
    eng = LLMEngine(p23_config(), device="cuda")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    short, wave = _wave_prompts(rng)
    greedy64 = SamplingParams(max_tokens=64, temperature=0.0)
    try:
        logits0 = p23_logits(eng, wave[0])
        shape_noise = float((p23_logits(eng, wave[0], pad=64)
                             - logits0).abs().max())
        eng.generate(short, greedy64)  # warm-up (cuBLAS handles, shapes)
        torch.cuda.reset_peak_memory_stats()
        norms.rms_norm.launches = 0
        res = p23_wave(eng, wave, greedy64)
        launches = norms.rms_norm.launches
        peak = torch.cuda.max_memory_allocated() / gib
        busy_ms, wall_ms = p23_burst_ms(eng)
    finally:
        eng.shutdown()
    del eng
    gap = (p20_allocated()[0] - mem0) / 2 ** 20
    mc = p23_config().model_config()
    if launches < 1:
        raise AssertionError("rms_norm never launched on phase 23's wave")
    if abs(gap) > P20_MEM_SLACK / 2 ** 20:
        raise AssertionError(f"allocated after shutdown {gap:+.1f} MiB, "
                             f"over {P20_MEM_SLACK // 2 ** 20} MiB")
    print(f"engine up in {up_s:.2f} s ({mc.num_params() / 1e9:.3f}B "
          f"params); wave of {len(wave)} greedy requests at concurrency 8, "
          f"64 out: {res['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{res['ttft_p50_ms']:.1f} ms, peak {peak:.3f} GiB; K1 launches "
          f"over the wave {launches} (65 a forward); allocated after "
          f"shutdown {gap:+.1f} MiB; the first chunk's logits padded 64 "
          f"more positions move by up to {shape_noise:.4g}; a 16-step "
          f"burst: device busy {busy_ms:.3f} of {wall_ms:.3f} ms a step")
    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    try:
        LLMEngine(p23_config(tensor_parallel_size=n + 1), device="cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"tensor_parallel_size={n + 1} on {n} cards "
                             "did not raise")
    refuse_s = time.perf_counter() - t0
    if refuse_s > 5:
        raise AssertionError(f"the refusal took {refuse_s:.2f} s")
    print(f"tensor_parallel_size={n + 1} on {n} visible card(s): "
          f"ValueError in {refuse_s * 1e3:.1f} ms ({refusal})")
    return {"wave": wave, "short": short, "streams": res["streams"],
            "logits0": logits0, "shape_noise": shape_noise,
            "busy_ms_per_step": busy_ms, "wall_ms_per_step": wall_ms,
            "tok_per_s": res["tok_per_s"],
            "ttft_p50_ms": res["ttft_p50_ms"], "peak_gib": peak,
            "launches": launches, "up_s": up_s, "refusal": refusal}


def p23_cards(tp: int) -> list:
    """(rank 0's allocated bytes on cuda:0, free bytes on cards 1..tp-1):
    the readings each shutdown must return to."""
    import torch

    return [p20_allocated()[0]] + [torch.cuda.mem_get_info(r)[0]
                                   for r in range(1, tp)]


def p23_followers() -> list:
    """Pids of this process's live children that run a tp follower
    (``python -m ray_tpu_torch.llm.tp``), read from /proc."""
    me, out = os.getpid(), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if (int(ppid) == me and state != "Z"
                and b"ray_tpu_torch.llm.tp" in cmd):
            out.append(int(pid))
    return out


def p23_memory_back(label: str, before: list, followers) -> list:
    """After ``shutdown()``: none of ``followers`` (processes) alive, no
    child of this process running a follower, and every card within
    P20_MEM_SLACK of ``before`` (a follower's memory returns when it
    exits: up to 15 s)."""
    if any(p.poll() is None for p in followers):
        raise AssertionError(f"{label}: a follower outlived shutdown()")
    deadline = time.perf_counter() + 15
    while True:
        now = p23_cards(len(before))
        gaps = [now[0] - before[0]] + [b - a for a, b in
                                       zip(before[1:], now[1:])]
        alive = p23_followers()
        if not alive and all(abs(g) <= P20_MEM_SLACK for g in gaps):
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"{label}: after shutdown() followers "
                                 f"{alive} alive, card memory "
                                 f"{[g / 2 ** 20 for g in gaps]} MiB off")
        time.sleep(0.2)
    print(f"{label}: after shutdown() no follower alive; cards' memory "
          f"back within {P20_MEM_SLACK // 2 ** 20} MiB "
          f"({[round(g / 2 ** 20, 2) for g in gaps]} MiB)")
    return [g / 2 ** 20 for g in gaps]


def p23_burst_args(eng) -> tuple:
    """A 16-step greedy burst over every slot at positions 1000.. (a
    line's tail no request reads before it writes)."""
    import numpy as np

    b = eng.max_slots
    return (np.arange(b, dtype=np.int64), np.full(b, 1000, np.int64),
            np.ones(b, bool), np.zeros(b, np.float32),
            np.ones(b, np.float32), P23_BURST, False, None)


def p23_burst_ms(eng) -> tuple:
    """(device-busy ms, wall ms) a decode step over a 16-step burst."""
    args = p23_burst_args(eng)
    busy, _ = _busy_ms(lambda: eng._call("burst", *args))
    wall = _host_ms(lambda: eng._call("burst", *args), reps=3)
    return busy / P23_BURST, wall / P23_BURST


def p23_step_costs(eng) -> dict:
    """One 16-step burst over every slot: collectives a step against the
    code's 2 x layers + 2 (one embedding all-reduce, two a layer, the
    head's all-gather), the NCCL kernels' device ms (rank 0's profiler),
    the burst's wall, the header's host us a burst call, and rank 0's
    host us issuing each collective over those bursts."""
    args = p23_burst_args(eng)
    b = eng.max_slots
    c0 = eng._comm.collectives
    eng._call("burst", *args)
    per_step = (eng._comm.collectives - c0) / P23_BURST
    predicted = 2 * eng.model_cfg.num_layers + 2
    busy, by_name = _busy_ms(lambda: eng._call("burst", *args))
    nccl = sum(ms for k, ms in by_name.items() if "nccl" in k.lower())
    tp, comm = eng._tp, eng._comm
    h0, s0 = tp.headers, tp.header_s
    n0, cs0 = comm.collectives, comm.collective_s
    wall = _host_ms(lambda: eng._call("burst", *args), reps=3)
    header_us = (tp.header_s - s0) / (tp.headers - h0) * 1e6
    coll_us = (comm.collective_s - cs0) / (comm.collectives - n0) * 1e6
    st = eng.stats()["tp"]
    if per_step != predicted:
        raise AssertionError(f"{per_step} collectives a decode step, the "
                             f"code predicts {predicted}")
    out = {"collectives_per_step": per_step, "predicted": predicted,
           "nccl_ms_per_step": nccl / P23_BURST,
           "nccl_us_per_call": nccl / P23_BURST / predicted * 1e3,
           "busy_ms_per_step": busy / P23_BURST,
           "wall_ms_per_step": wall / P23_BURST,
           "header_us": header_us, "header_us_engine_mean": st["header_us"],
           "headers": st["headers"], "collective_host_us": coll_us}
    print(f"decode step (16-step burst, {b} slots): {per_step:.0f} "
          f"collectives (predicted {predicted}); NCCL "
          f"{out['nccl_ms_per_step']:.3f} ms a step = "
          f"{out['nccl_us_per_call']:.1f} us a call (rank 0's profiler); "
          f"device busy {out['busy_ms_per_step']:.3f} of "
          f"{out['wall_ms_per_step']:.3f} ms a step; header {header_us:.1f} "
          f"us a burst call ({st['header_us']:.1f} over the engine's "
          f"{st['headers']} calls); rank 0's host {coll_us:.1f} us "
          f"issuing a collective ({coll_us * per_step / 1e3:.3f} ms a "
          f"step)")
    return out


def p23b_logit_bound(one: dict) -> float:
    """The most a tp engine's logits may move from tp 1's on one input:
    P23B_LOGIT_FACTOR x tp 1's own move when its first chunk is padded
    (phase 23's ``shape_noise``). Also each near-tie's noise (p23_tie)."""
    return P23B_LOGIT_FACTOR * one["shape_noise"]


def p23b_dense(tp: int, eng, one: dict) -> dict:
    """(a) on a dense tp engine: its first prefill chunk's logits within
    p23b_logit_bound of tp 1's, the greedy wave against 23's streams,
    tok/s, TTFT, per-rank peak and K1's launches, a sampled wave every rank
    agrees on, the step's costs. The result keeps the wave's streams and
    texts."""
    from ray_tpu_torch.llm import SamplingParams

    gib = 2.0 ** 30
    wave, short = one["wave"], one["short"]
    greedy64 = SamplingParams(max_tokens=64, temperature=0.0)
    noise = p23b_logit_bound(one)
    d = float((p23_logits(eng, wave[0]) - one["logits0"]).abs().max())
    print(f"(a) first chunk's logits max |tp {tp} - tp 1| {d:.4g} "
          f"({d / one['shape_noise']:.3f}x one card's own move when padded, "
          f"{one['shape_noise']:.4g}; limit {P23B_LOGIT_FACTOR}x)")
    if d > noise:
        raise AssertionError(f"tp {tp}'s logits move {d:.4g} from tp 1's, "
                             f"over {noise:.4g}")
    eng.generate(short, greedy64)
    eng.tp_query("reset_peak")
    k0 = eng.tp_query("rms_norm_launches")
    a = p23_wave(eng, wave, greedy64)
    k1 = eng.tp_query("rms_norm_launches")
    peaks = [p / gib for p in eng.tp_query("peak_bytes")]
    launches = [y - x for x, y in zip(k0, k1)]
    if min(launches) < 1 or len(set(launches)) != 1:
        raise AssertionError(f"K1 launches by rank {launches}")
    print(f"(a) wave {a['tok_per_s']:.1f} tok/s (tp 1 "
          f"{one['tok_per_s']:.1f}), TTFT p50 {a['ttft_p50_ms']:.1f} ms (tp 1 "
          f"{one['ttft_p50_ms']:.1f}); peak by rank "
          f"{[round(p, 3) for p in peaks]} GiB (tp 1 {one['peak_gib']:.3f});"
          f" K1 launches by rank {launches}")
    out = {"logits_max_abs": d, "tok_per_s": a["tok_per_s"],
           "ttft_p50_ms": a["ttft_p50_ms"], "peak_gib": peaks,
           "launches": launches[0], "texts": a["texts"],
           "streams": a["streams"],
           "vs_tp1": p23_against("(a) greedy vs tp 1", eng, wave,
                                 one["streams"], a["streams"], noise)}
    eng.tp_query("record")
    p23_wave(eng, wave, SamplingParams(max_tokens=64, temperature=0.8,
                                       top_p=0.9))
    drawn = eng.tp_query("sampled")
    if not drawn[0] or any(x != drawn[0] for x in drawn):
        raise AssertionError("ranks sampled different tokens")
    print(f"(a) temperature 0.8, top-p 0.9 wave: every rank drew the "
          f"same {len(drawn[0])} tokens")
    out["sampled_equal_ranks"] = len(drawn[0])
    out["costs"] = p23_step_costs(eng)
    return out


def p23b_one(tp: int, one: dict) -> dict:
    """23b at one tp: (a) p23b_dense; (b) the block pool at 16 slots and
    (c) speculation against (a)'s streams; (d) at tp 2 the P/D hand-off;
    memory back after each shutdown."""
    from dataclasses import replace

    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig

    wave, short = one["wave"], one["short"]
    greedy64 = SamplingParams(max_tokens=64, temperature=0.0)
    noise = p23b_logit_bound(one)
    out: dict = {}
    blocked = spec = dec = None
    _phase(f"tensor-parallel serving (23b): tp {tp}, one card a rank "
           f"(NCCL), phase 23's weights")
    before = p23_cards(tp)
    t0 = time.perf_counter()
    eng = LLMEngine(p23_config(tensor_parallel_size=tp), device="cuda")
    out["up_s"] = time.perf_counter() - t0
    print(f"(a) up in {out['up_s']:.2f} s")
    engines = [eng]
    try:
        out["a"] = p23b_dense(tp, eng, one)
        out["costs"] = out["a"].pop("costs")
        dense = out["a"].pop("streams")

        blocked = LLMEngine(p23_config(
            tensor_parallel_size=tp, max_num_seqs=2 * P23_SLOTS,
            kv_block_size=REST_BLOCK, kv_num_blocks=P23_BLOCKS),
            device="cuda")
        engines.append(blocked)
        blocked.generate(short, greedy64)
        b = p23_wave(blocked, wave, greedy64, concurrency=2 * P23_SLOTS)
        print(f"(b) block pool, {2 * P23_SLOTS} slots on {P23_BLOCKS} "
              f"blocks: {b['tok_per_s']:.1f} tok/s, TTFT p50 "
              f"{b['ttft_p50_ms']:.1f} ms, preemptions "
              f"{blocked.stats()['preemptions']}")
        out["b"] = {"tok_per_s": b["tok_per_s"],
                    "ttft_p50_ms": b["ttft_p50_ms"],
                    "vs_dense": p23_against("(b) blocked vs dense", eng,
                                            wave, dense, b["streams"],
                                            noise)}
        blocked.shutdown()

        draft = replace(LlamaConfig.llama3_8b(), num_layers=P23_SPEC_LAYERS)
        spec = LLMEngine(p23_config(
            tensor_parallel_size=tp, speculative_model=draft,
            speculative_tokens=REST_SPEC_K), device="cuda")
        engines.append(spec)
        spec.generate(short, greedy64)
        c = p23_wave(spec, wave, greedy64)
        st = spec.stats()
        if st["spec_ticks"] < 1:
            raise AssertionError("no speculative tick ran")
        print(f"(c) speculation (k {REST_SPEC_K}, {P23_SPEC_LAYERS}-layer "
              f"seeded draft): {c['tok_per_s']:.1f} tok/s, acceptance "
              f"{st['spec_acceptance']}, {st['spec_ticks']} ticks")
        out["c"] = {"tok_per_s": c["tok_per_s"],
                    "acceptance": st["spec_acceptance"],
                    "vs_plain": p23_against("(c) speculative vs plain", eng,
                                            wave, dense, c["streams"],
                                            noise)}
        spec.shutdown()

        if tp == 2:
            dec = LLMEngine(p23_config(tensor_parallel_size=tp),
                            device="cuda")
            engines.append(dec)
            rng = __import__("numpy").random.default_rng(SEED + 23)
            pd = []
            for n in P23_PD_LENGTHS:
                # The decode engine's own stream first: a prefill engine
                # that served the prompt would re-prefill only its last
                # token from the cached line (another product shape).
                prompt = [int(t) for t in rng.integers(0, 256, n)]
                want = dec.generate(prompt, greedy64).token_ids
                t1 = time.perf_counter()
                payload = eng.prefill_only(prompt)
                export_ms = (time.perf_counter() - t1) * 1e3
                got = dec._result(_pd_continue(dec, payload, greedy64))
                if got.token_ids != want:
                    raise AssertionError(f"P/D at {n} tokens: tokens differ")
                pd.append({"prompt": n, "export_ms": export_ms,
                           "kv_bytes": 2 * payload["kv_k"].numel()
                           * payload["kv_k"].element_size()})
            print(f"(d) P/D tp {tp} -> tp {tp}: tokens equal to the decode "
                  f"engine's own at {list(P23_PD_LENGTHS)} prompt tokens; "
                  f"export ms {[round(x['export_ms'], 2) for x in pd]}")
            out["d"] = pd
            dec.shutdown()
    finally:
        for e in engines:
            e.shutdown()
        e = None
    followers = [p for x in engines for p in x._tp.procs]
    eng = blocked = spec = dec = x = None
    engines.clear()
    out["mem_gap_mib"] = p23_memory_back(f"tp {tp}", before, followers)
    return out


def _pd_continue(dec, payload, sampling):
    req = dec.submit_prefilled(payload, sampling)
    if not req.done.wait(300) or req.error:
        raise AssertionError(f"P/D decode failed: {req.error}")
    return req


def p23b_http(tp: int, texts: dict, wave) -> dict:
    """(e) build_openai_app at tp: one wave over HTTP by eight clients,
    each completion's text equal to the direct engine's."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    _phase(f"tensor-parallel serving (23b e): build_openai_app at tp {tp}")
    before = p23_cards(tp)
    ray_tpu_torch.init()
    try:
        serve.run(build_openai_app(p23_config(tensor_parallel_size=tp),
                                   device="cuda"), route_prefix="/",
                  http=True, _blocking_timeout=600)
        port = serve.http_port()
        running = p23_followers()
        if len(running) != tp - 1:
            raise AssertionError(f"the replica runs {len(running)} "
                                 f"followers, not {tp - 1}")
        got, wall, _ = p20_loop(wave, lambda p: p20_post(
            port, "/v1/completions",
            {"prompt": p, "max_tokens": 64, "temperature": 0.0}))
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    bad = [i for i in texts if got[i]["choices"][0]["text"] != texts[i]]
    if bad:
        raise AssertionError(f"HTTP texts differ from the engine's: {bad}")
    toks = sum(got[i]["usage"]["completion_tokens"] for i in got)
    print(f"(e) {len(got)} completions over HTTP at tp {tp}: every text "
          f"equal to the direct engine's; {toks / wall:.1f} tok/s; the "
          f"replica ran followers {running}")
    return {"tok_per_s": toks / wall,
            "mem_gap_mib": p23_memory_back(f"HTTP tp {tp}", before, [])}


def p23b_kill(tp: int, one: dict) -> dict:
    """(f) a follower killed mid-burst: every slotted request fails with
    the engine's error within P23B_FAIL_S, a later request fails too,
    ``shutdown()`` returns within P23B_STOP_S, no follower is left and
    every card's memory comes back. Runs last in 23b: the engine's NCCL
    communicator is aborted."""
    from ray_tpu_torch.llm import LLMEngine, SamplingParams

    _phase(f"tensor-parallel serving (23b f): a follower killed mid-burst "
           f"at tp {tp}")
    before = p23_cards(tp)
    eng = LLMEngine(p23_config(tensor_parallel_size=tp), device="cuda")
    procs = list(eng._tp.procs)
    try:
        reqs = [eng.submit(p, SamplingParams(max_tokens=512,
                                             temperature=0.0))
                for p in one["wave"][:P23_SLOTS]]
        deadline = time.perf_counter() + 120
        while eng.decode_bursts < 2 and time.perf_counter() < deadline:
            time.sleep(0.01)
        if eng.decode_bursts < 2:
            raise AssertionError("no decode burst within 120 s")
        decoded = sum(len(r.out_tokens) for r in reqs)
        t0 = time.perf_counter()
        procs[-1].kill()
        for r in reqs:
            if not r.done.wait(max(0.0, t0 + P23B_FAIL_S
                                   - time.perf_counter())):
                raise AssertionError(f"a request still runs {P23B_FAIL_S} s"
                                     f" after rank {tp - 1} was killed")
        fail_s = time.perf_counter() - t0
        if not all(r.error for r in reqs) or eng.error is None:
            raise AssertionError(f"errors {[r.error for r in reqs]}, engine "
                                 f"{eng.error}")
        late = eng.submit(one["short"], SamplingParams(max_tokens=4))
        if not late.done.wait(P23B_FAIL_S) or not late.error:
            raise AssertionError("a request after the failure did not fail")
    finally:
        t1 = time.perf_counter()
        eng.shutdown()
        stop_s = time.perf_counter() - t1
    error = eng.error
    eng = None
    print(f"(f) rank {tp - 1} killed after {decoded} tokens: "
          f"{len(reqs)} requests failed in {fail_s:.2f} s (limit "
          f"{P23B_FAIL_S:.0f}), a later one too; shutdown() in {stop_s:.2f} "
          f"s (limit {P23B_STOP_S:.0f}); error: {error.splitlines()[0]}")
    if stop_s > P23B_STOP_S:
        raise AssertionError(f"shutdown() took {stop_s:.2f} s")
    return {"fail_s": fail_s, "shutdown_s": stop_s,
            "mem_gap_mib": p23_memory_back(f"(f) tp {tp}", before, procs)}


def phase_tp_serving_ranks(world: int, one: dict) -> dict:
    """Phase 23b: phase 23's weights at tp 2 and, with four cards, tp 4;
    (e) HTTP and (f) a killed follower at the largest."""
    out = {}
    sizes = [t for t in (2, 4) if t <= world]
    for tp in sizes:
        out[tp] = p23b_one(tp, one)
    out["e"] = p23b_http(sizes[-1], out[sizes[-1]]["a"].pop("texts"),
                         one["wave"])
    for tp in sizes[:-1]:
        out[tp]["a"].pop("texts")
    out["f"] = p23b_kill(sizes[-1], one)
    return out


# Phase 24: Ray Data on the port's runtime. (a) batch inference through
# build_llm_processor at phase 7's engine, (b) TorchTrainer(datasets=) at
# phase 8's 1.1B geometry, (c) ingest over two workers.
P24_PROMPTS = 256
P24_PROMPT_BYTES = (128, 512)   # seeded printable ASCII, the byte tokenizer
P24_BATCH = 64                  # ProcessorConfig(batch_size=64)
# The pool's engine runs a block's 64 prompts in 64 slots (phase 7's
# engine otherwise); at phase 7's 8 the first run read 217.7 tok/s, 75 s.
P24_SLOTS = 64
P24_MAX_TOKENS = 64
P24_BUSY_WINDOW_S = 1.0         # the profiler's window in mid-run
P24_ROWS, P24_BLOCKS = 4096, 64  # (b): 4096 rows x 2049 int32, 64 blocks
P24_STEPS = 5
P24_INGEST_ROWS = 65536          # (c): range(65536) over two workers
P24_TIMEOUT_S = 600


def p24_prompts(n: int, lo: int, hi: int, seed: int = SEED + 24) -> list:
    """``n`` seeded printable-ASCII strings of ``lo``-``hi`` bytes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return ["".join(chr(c) for c in rng.integers(32, 127, int(k)))
            for k in rng.integers(lo, hi + 1, n)]


def p24_direct(eng, prompts: list, sampling, batch: int) -> list:
    """Each prompt's greedy token ids from ``eng``, submitted ``batch`` at a
    time as the pool's stage submits them."""
    out = []
    for i in range(0, len(prompts), batch):
        reqs = [eng.submit(p, sampling) for p in prompts[i:i + batch]]
        for r in reqs:
            if not r.done.wait(600) or r.error:
                raise AssertionError(f"direct request: {r.error}")
            out.append(list(eng._result(r).token_ids))
    return out


def p24_batch_inference(llm_cfg, device: str, prompts: list,
                        sampling: dict, batch: int, num_gpus: float,
                        busy_window_s: float) -> dict:
    """(a): the prompts through build_llm_processor (one pool actor holding
    an LLMEngine); the rows as they come back, wall time, K1's launches
    (reset right before, read right after), the device's busy share over
    a profiler window once the first block is back (None on the CPU)."""
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.data.llm import ProcessorConfig, build_llm_processor
    from ray_tpu_torch.ops import norms

    proc = build_llm_processor(
        llm_cfg, device=device, num_gpus=num_gpus,
        config=ProcessorConfig(batch_size=batch, concurrency=1,
                               sampling=sampling, include_token_ids=True))
    ds = proc(rdata.from_items([{"id": i, "prompt": p}
                                for i, p in enumerate(prompts)]))
    rows, busy = [], None
    norms.rms_norm.launches = 0
    t0 = time.perf_counter()
    for b in ds.iter_batches(batch_size=None):
        rows.extend({k: b[k][j] for k in b} for j in range(len(b["id"])))
        if busy is None and device != "cpu":
            busy = _busy_share(busy_window_s)
    wall = time.perf_counter() - t0
    return {"rows": rows, "wall_s": wall,
            "launches": norms.rms_norm.launches, "busy": busy}


def _busy_share(window_s: float) -> float:
    """The card's busy share over ``window_s`` of wall time: the summed
    durations of the kernels the profiler saw in the window (every thread
    of the process) over the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        time.sleep(window_s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    return kern / wall


def p24_rows(n: int, width: int, blocks: int, vocab: int):
    """(b)'s data: ``n`` seeded int32 rows of ``width`` token ids (tokens
    and the targets' last one) as ``blocks`` blocks."""
    import numpy as np

    rows = np.random.default_rng(SEED + 24).integers(
        0, vocab, (n, width), dtype=np.int32)
    return rows, [{"row": b} for b in np.split(rows, blocks)]


def p24_split(batch):
    return {"tokens": batch["row"][:, :-1], "targets": batch["row"][:, 1:]}


def p24_train_fn(make_step, steps: int, batch: int, prefetch: int):
    """(b)'s train function: the step fed by get_dataset_shard("train")
    through the device-prefetching iterator; each step's loss, its time
    (the loss read back) and the host time it waited for its batch."""
    def train_fn(config):
        import ray_tpu_torch.train as train

        dev = train.get_context().get_device()
        step, init, _ = make_step(dev)
        state = init()
        it = iter(train.get_dataset_shard("train").iter_torch_batches(
            batch_size=batch, device=dev, prefetch=prefetch))
        for i in range(steps):
            t0 = time.perf_counter()
            b = next(it)
            t1 = time.perf_counter()
            state, m = step(state, b["tokens"], b["targets"])
            loss = float(m["loss"])
            train.report({"step": i, "loss": loss,
                          "wait_s": t1 - t0,
                          "step_s": time.perf_counter() - t1})
        it.close()
    return train_fn


def p24_direct_steps(make_step, rows, steps: int, batch: int,
                     device) -> dict:
    """(b)'s reference: the same step fed the same batches directly."""
    step, init, shard = make_step(device)
    state = init()
    losses, secs = [], []
    for i in range(steps):
        r = rows[i * batch:(i + 1) * batch]
        t0 = time.perf_counter()
        state, m = step(state, shard(r[:, :-1]), shard(r[:, 1:]))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": secs}


def p24_ingest_fn(batch: int):
    """(c)'s train function: read this worker's split whole."""
    def train_fn(config):
        import numpy as np
        import ray_tpu_torch.train as train

        t0 = time.perf_counter()
        ids = [b["id"] for b in train.get_dataset_shard("train")
               .iter_batches(batch_size=batch)]
        ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        train.report({"rank": train.get_context().get_world_rank(),
                      "n": int(len(ids)), "sum": int(ids.sum()),
                      "ids": ids.tolist(),
                      "read_s": time.perf_counter() - t0})
    return train_fn


def p24_ingest(n: int, workers: int, batch: int, device: str,
               storage: str) -> dict:
    """(c): range(n) through streaming_split(workers, equal=True) under a
    TorchTrainer of ``workers`` workers; every row once, equal splits."""
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TorchBackendConfig, TorchTrainer)

    res = _fit_in_time(TorchTrainer(
        p24_ingest_fn(batch), datasets={"train": rdata.range(n)},
        scaling_config=ScalingConfig(num_workers=workers),
        backend_config=TorchBackendConfig(device=device),
        run_config=RunConfig(name="p24-ingest", storage_path=storage)),
        P24_TIMEOUT_S)
    if not res.ok:
        raise AssertionError(f"ingest fit failed: {res.error}")
    per = sorted(res.metrics_history, key=lambda m: m["rank"])
    seen = sorted(i for m in per for i in m["ids"])
    if seen != list(range(n)):
        raise AssertionError(f"ingest: {len(seen)} rows seen, not each of "
                             f"range({n}) once")
    counts = [m["n"] for m in per]
    if len(set(counts)) != 1:
        raise AssertionError(f"ingest: unequal splits {counts}")
    read_s = max(m["read_s"] for m in per)
    return {"counts": counts, "read_s": read_s, "rows_per_s": n / read_s}


def phase_data(engine: dict | None = None) -> dict:
    """Phase 24: Ray Data on the port's runtime. (a) batch inference at
    phase 7's engine through build_llm_processor, one pool actor on the
    card; (b) TorchTrainer(datasets=) at phase 8's 1.1B geometry through
    get_dataset_shard and the device-prefetching iterator; (c) ingest of
    range(65536) over two workers."""
    import gc
    import shutil

    import torch
    import ray_tpu_torch
    import ray_tpu_torch.data as rdata
    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchTrainer)

    t_phase = time.perf_counter()
    out: dict = {}
    root = os.path.dirname(os.path.abspath(__file__))
    storage = os.path.join(root, "ray_tpu_torch", "_native", "_build",
                           "phase24")
    shutil.rmtree(storage, ignore_errors=True)
    os.makedirs(storage)

    _phase(f"Ray Data (a): batch inference, build_llm_processor at "
           f"llama3_1b width (bf16, phase 7's seeded weights), "
           f"{P24_PROMPTS} prompts of {P24_PROMPT_BYTES[0]}-"
           f"{P24_PROMPT_BYTES[1]} bytes, batch_size {P24_BATCH}, one pool "
           f"actor with num_gpus=1 ({P24_SLOTS} slots), greedy, max_tokens "
           f"{P24_MAX_TOKENS}")
    llm_cfg = LLMConfig(model="llama3_1b", dtype="bfloat16",
                        max_num_seqs=P24_SLOTS, max_seq_len=1024,
                        decode_burst=16, seed=SEED)
    prompts = p24_prompts(P24_PROMPTS, *P24_PROMPT_BYTES)
    sampling = {"max_tokens": P24_MAX_TOKENS, "temperature": 0.0}
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = p20_allocated()[0]
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    try:
        a = p24_batch_inference(llm_cfg, "cuda", prompts, sampling,
                                P24_BATCH, 1, P24_BUSY_WINDOW_S)
        gpu_back = ray_tpu_torch.available_resources()["GPU"]
    finally:
        ray_tpu_torch.shutdown()
    if gpu_back != 1.0:
        raise AssertionError(f"the pool's GPU not back: {gpu_back}")
    gap_mib = p20_memory_back(mem0, 2, "the pool's shutdown",
                              "the processor")
    ids = sorted(int(r["id"]) for r in a["rows"])
    if ids != list(range(P24_PROMPTS)):
        raise AssertionError(f"{len(ids)} rows back, not each prompt once")
    if a["launches"] < 1:
        raise AssertionError("rms_norm never launched on the pool actor's "
                             "engine")
    eng = LLMEngine(llm_cfg, device="cuda")
    try:
        want = p24_direct(eng, prompts, SamplingParams(**sampling),
                          P24_BATCH)
    finally:
        eng.shutdown()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    got = {int(r["id"]): list(r["generated_token_ids"]) for r in a["rows"]}
    bad = [i for i in range(P24_PROMPTS) if got[i] != want[i]]
    if bad:
        raise AssertionError(f"{len(bad)} generations differ from the direct"
                             f" engine's (first: prompt {bad[0]})")
    out_toks = sum(len(v) for v in got.values())
    a_res = {"rows_per_s": P24_PROMPTS / a["wall_s"],
             "tok_per_s": out_toks / a["wall_s"], "wall_s": a["wall_s"],
             "output_tokens": out_toks, "launches": a["launches"],
             "busy_share": a["busy"], "memory_gap_mib": gap_mib,
             "phase7_tok_per_s": (engine or {}).get("tok_per_s")}
    out["batch_inference"] = a_res
    p7 = a_res["phase7_tok_per_s"]
    print(f"{P24_PROMPTS} rows back once each in {a['wall_s']:.2f} s: "
          f"{a_res['rows_per_s']:.1f} rows/s, {out_toks} output tokens = "
          f"{a_res['tok_per_s']:.1f} tok/s (phase 7's direct waves "
          + (f"{p7:.1f} tok/s" if p7 else "not run") + "); device busy "
          f"{100 * a['busy']:.1f}% of a {P24_BUSY_WINDOW_S:.1f} s profiler "
          f"window in mid-run; every generation equal to the direct "
          f"engine's token ids; rms_norm launches on the pool's engine "
          f"{a['launches']}; GPU resource back, card memory "
          f"{gap_mib:+.2f} MiB from before")

    _phase(f"Ray Data (b): TorchTrainer(datasets=) at the 1.1B geometry, "
           f"b4 s2048, attn+, adamw_lowmem, one worker on the card; "
           f"{P24_ROWS} rows x 2049 int32 in {P24_BLOCKS} blocks, "
           f"{P24_STEPS} steps through get_dataset_shard and "
           f"iter_torch_batches(prefetch=2)")
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    rows, blocks = p24_rows(P24_ROWS, 2049, P24_BLOCKS, cfg.vocab_size)
    print(f"dataset {rows.nbytes / 1e6:.1f} MB")
    direct = p24_direct_steps(lambda d: _p19_step(cfg, d), rows, P24_STEPS,
                              4, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    counters = _counters()
    for c in counters.values():
        c.launches = 0  # count the trainer's run only
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": 1})
    try:
        ds = rdata.from_blocks(blocks).map_batches(p24_split)
        res = _fit_in_time(TorchTrainer(
            p24_train_fn(lambda d: _p19_step(cfg, d), P24_STEPS, 4, 2),
            datasets={"train": ds},
            scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
            run_config=RunConfig(name="p24-train", storage_path=storage)),
            P24_TIMEOUT_S)
    finally:
        ray_tpu_torch.shutdown()
    launches = {k: c.launches for k, c in counters.items()}
    if not res.ok:
        raise AssertionError(f"fit failed: {res.error}")
    hist = res.metrics_history
    losses = [m["loss"] for m in hist]
    if losses != direct["losses"]:
        raise AssertionError(f"losses under datasets= {losses} != the "
                             f"direct step's {direct['losses']} (bit for "
                             f"bit)")
    want_launch = {k: v * P24_STEPS for k, v in
                   predicted_launches("attn+", cfg.num_layers).items()}
    for k in ("rms_norm", "flash_fwd", "flash_bwd"):
        if launches[k] != want_launch[k]:
            raise AssertionError(f"{k} launched {launches[k]} times under "
                                 f"datasets=, not {want_launch[k]}")
    ds_ms = 1e3 * statistics.median(m["step_s"] for m in hist[1:])
    direct_ms = 1e3 * statistics.median(direct["step_s"][1:])
    waits = [1e3 * m["wait_s"] for m in hist]
    out["trainer"] = {"losses": losses, "step_ms": ds_ms,
                      "direct_step_ms": direct_ms, "wait_ms": waits,
                      "launches": launches}
    print(f"losses " + " ".join(f"{x:.6f}" for x in losses) + " bit-equal "
          f"to the direct step's; median step {ds_ms:.2f} ms under "
          f"datasets= against {direct_ms:.2f} ms direct (steps 1-"
          f"{P24_STEPS - 1}); host ms each step waited for its batch "
          + " ".join(f"{w:.3f}" for w in waits) + "; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v))

    _phase(f"Ray Data (c): range({P24_INGEST_ROWS}) over two workers "
           f"through streaming_split(2, equal=True)")
    ray_tpu_torch.init(num_cpus=8)
    try:
        c_res = p24_ingest(P24_INGEST_ROWS, 2, 1024, "cpu", storage)
    finally:
        ray_tpu_torch.shutdown()
    out["ingest"] = c_res
    print(f"every row seen once, splits {c_res['counts']}; "
          f"{c_res['rows_per_s']:.1f} rows/s (the slower worker's read "
          f"{c_res['read_s']:.3f} s)")
    shutil.rmtree(storage, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 24 took {out['seconds']:.1f} s")
    return out


# Phase 25: tracing, profiling and the goodput ledger on the card.
P25_STEPS = 14  # 25a's steps under one worker
P25_CAPTURE_AFTER = 3  # steps reported before profile_cluster starts
P25_CAPTURE_S = 2.0  # profile_cluster's window, mid-fit
P25_GATE_S = 120.0  # the most the fit waits for the capture's device session
P25_MEM_AT = 2  # the step after which device_memory() is read
P25_DDP_STEPS = 24  # 25a two workers: the host collective's quadratic
P25_DDP_MATMUL = 4096  # and one bf16 square matmul a step on the card
# Each rank's goodput snapshot: classified + open tail against the elapsed
# monotonic clock (the residual), and against its wall clock (t0 and ts
# are time.time() stamps, the ledger's own clock is monotonic).
P25_UNATTRIBUTED_S = 1e-6
P25_WALL_SLACK_S = 5e-3
P25_WAVE = 16  # 25b: prompts a wave, phase 7's lengths, 64 tokens out
P25_PAIRS = 1  # tracing off/on waves: off, on, on, off, repeated
P25_DEADLINE_S = 0.05  # 25b at rate 0.0: a request ended by its deadline
P25_DEADLINE_TOKENS = 256  # it asks for more than its deadline allows
P25_KEPT_WAIT_S = 0.5  # before the buffers are read
P25C_WARMUP = 2
P25C_CAPTURE_S = 2.0  # 25c: each rank's capture over the same steps
# 25c's depth: phase 13b's 8 layers under flat ran out of memory on a
# rank with the capture on (68.33 GiB allocated in the update's f32
# transients; NVIDIA H100 80GB HBM3), so four layers of its width.
P25C_LAYERS = 4
P25C_TIMEOUT_S = 600
# 25c's split of a rank's device time by kernel name (demangled, lower
# case): attention = the flash kernels, NCCL, GEMM (cuBLAS's nvjet and
# sm90 xmma kernels, CUTLASS), elementwise = every other kernel (K1
# with them), memcpy/memset apart.
P25_CLASSES = (("attention", ("flash_fwd_kernel", "flash_bwd_kernel",
                              "flash_bwd_dq", "flash_bwd_dkv",
                              "flash_chunk")),
               ("nccl", ("nccl",)),
               ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas",
                         "matmul")))
K_NAMES = {"rms_norm": "rms_norm_", "flash_fwd": "flash_fwd_kernel",
           "flash_bwd": "flash_bwd_kernel"}


def p25_snapshot_ok(label: str, gp: dict, live: bool) -> dict:
    """One rank's goodput snapshot: the residual at most
    P25_UNATTRIBUTED_S, and (live) classified + open tail within
    P25_WALL_SLACK_S of its wall clock; returns its shares."""
    total = sum(gp["phase_s"].values()) + gp["open_s"]
    if gp["unattributed_s"] > P25_UNATTRIBUTED_S:
        raise AssertionError(f"{label}: unattributed {gp['unattributed_s']}"
                             f" s > {P25_UNATTRIBUTED_S}")
    wall = gp["ts"] - gp["t0"]
    if live and abs(total - wall) > P25_WALL_SLACK_S:
        raise AssertionError(f"{label}: phases + open tail {total:.6f} s "
                             f"against a wall clock of {wall:.6f} s")
    return {"total_s": total, "wall_s": wall,
            "unattributed_s": gp["unattributed_s"],
            "step_compute_share": gp["phase_s"].get("step_compute", 0.0)
            / total if total else 0.0,
            "self_cost": gp["spent_s"] / total if total else 0.0,
            "phase_s": gp["phase_s"]}


def p25_train_fn(cfg, batch: int, seq: int, marks: dict):
    """25a's train function: phase 19's step (the 1.1B geometry), each
    step reported with its tokens, FLOPs and compute seconds; after step
    P25_MEM_AT it reads device_memory() between two memory_allocated()
    readings on this (the only allocating) thread; step P25_CAPTURE_AFTER
    waits for the capture's device session to begin."""

    def train_fn(config):
        import torch
        from ray_tpu_torch.accelerators.flops import llama_train_flops
        from ray_tpu_torch.train import get_context, report
        from ray_tpu_torch.util import state as ustate

        ctx = get_context()
        dev = ctx.get_device()
        step, init, shard = _p19_step(cfg, dev)
        state = init()
        flops = llama_train_flops(cfg, batch, seq)
        for i in range(P25_STEPS):
            if i == P25_CAPTURE_AFTER and dev.type == "cuda":
                # Hold the step until the capture's device session is up:
                # a session starts slowly while another thread launches,
                # and its window must meet the steps after this one.
                t_wait = time.monotonic()
                while not torch.autograd.profiler._is_profiler_enabled:
                    if time.monotonic() - t_wait > P25_GATE_S:
                        raise AssertionError("no device session began in "
                                             f"{P25_GATE_S} s")
                    time.sleep(0.001)
                marks["gate_s"] = time.monotonic() - t_wait
            tok, tgt = _p19_batch(i, cfg.vocab_size, batch, seq)
            w0 = time.time()
            t0 = time.perf_counter()
            state, m = step(state, shard(tok), shard(tgt))
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
            marks.setdefault("steps", []).append((w0, w0 + dt))
            if i == P25_MEM_AT and dev.type == "cuda":
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                snap = ustate.device_memory()
                after = torch.cuda.memory_allocated()
                marks["memory"] = (before, snap, after)
            report({"step": i, "loss": loss, "tokens": batch * seq,
                    "flops": flops, "compute_time_s": dt})
            marks["reported"] = i + 1

    return train_fn


def p25_ddp_fn(matmul: int, steps: int, marks: dict, gate):
    """25a's two workers: phase 19 (b)'s quadratic through the host
    collective, plus one matmul a step on the worker's device; each step
    reports its compute and collective seconds. Half-way, each rank marks
    its step and waits on ``gate`` (the main thread reads the live
    ledgers meanwhile)."""

    def train_fn(config):
        import torch
        import ray_tpu_torch.collective as col
        from ray_tpu_torch.train import get_context, report

        ctx = get_context()
        rank, world, dev = ctx.get_world_rank(), ctx.get_world_size(), \
            ctx.get_device()
        g = col.init_collective_group(world_size=world, rank=rank,
                                      backend="host", group_name="p25-ddp")
        a = torch.randn(matmul, matmul, device=dev,
                        dtype=torch.bfloat16 if dev.type == "cuda"
                        else torch.float32,
                        generator=torch.Generator(dev).manual_seed(
                            SEED + rank))
        w = torch.zeros(4, dtype=torch.float32, device=dev)
        for step in range(steps):
            if step == steps // 2:
                marks[rank] = step
                if not gate.wait(60):
                    raise AssertionError("the live ledgers were not read")
            t0 = time.perf_counter()
            float((a @ a).float().mean())
            target = torch.full((4,), 3.0 + 0.1 * rank, dtype=torch.float32,
                                device=dev)
            grad = 2 * (w - target)
            t1 = time.perf_counter()
            grad = g.allreduce(grad) / world
            t2 = time.perf_counter()
            w -= 0.3 * grad
            report({"step": step, "rank": rank, "compute_time_s": t1 - t0,
                    "sync_time_s": t2 - t1})

    return train_fn


def p25_kernel_rows(trace: dict) -> list:
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"
            and str(e.get("pid", "")).startswith("device ")]


def p25_trainer(cfg, batch: int, seq: int, device: str, storage: str,
                out_dir: str) -> dict:
    """25a: phase 19's trainer, traced, under one worker with
    profile_cluster mid-fit, then two workers on the host collective."""
    import torch
    import torch.distributed as dist
    import ray_tpu_torch
    from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                     TorchBackendConfig, TorchTrainer,
                                     session)
    from ray_tpu_torch.util import state as ustate
    from ray_tpu_torch.util import tracing

    cuda = device == "cuda"
    out: dict = {}
    _phase("tracing (25a): TorchTrainer traced, one worker, a capture "
           "mid-fit")
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    marks: dict = {}
    tracing.clear()
    tracing.enable_tracing()
    ray_tpu_torch.init(num_cpus=8,
                       resources={"GPU": torch.cuda.device_count()}
                       if cuda else None)
    result: dict = {}
    try:
        trainer = TorchTrainer(
            p25_train_fn(cfg, batch, seq, marks),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=cuda),
            backend_config=TorchBackendConfig(
                device=device, distributed=cuda),
            run_config=RunConfig(name="p25-one", storage_path=storage))
        fit = threading.Thread(target=lambda: result.update(
            res=trainer.fit()), daemon=True, name="p25-fit")
        t_fit = time.perf_counter()
        fit.start()
        while marks.get("reported", 0) < P25_CAPTURE_AFTER:
            if not fit.is_alive():
                raise AssertionError(f"fit() ended early: {result}")
            time.sleep(0.01)
        live = session.collect_train_stats()
        prof = ustate.profile_cluster(P25_CAPTURE_S,
                                      out_dir=os.path.join(out_dir, "p25a"))
        fit.join(P19_FIT_DEADLINE_S)
        if fit.is_alive():
            raise AssertionError(f"fit() did not end in {P19_FIT_DEADLINE_S}"
                                 " s")
        fit_s = time.perf_counter() - t_fit
        final = session.collect_train_stats()
    finally:
        tracing.disable_tracing()
        ray_tpu_torch.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()
    res = result["res"]
    if not res.ok:
        raise AssertionError(f"25a fit failed: {res.error}")
    launches = {k: c.launches for k, c in counters.items()}
    if live["0"]["goodput"]["finished"]:
        raise AssertionError("25a: the mid-fit ledger had finished")
    live_gp = p25_snapshot_ok("25a rank 0 (mid-fit)",
                              live["0"]["goodput"], True)
    final_gp = p25_snapshot_ok("25a rank 0 (final)", final["0"]["goodput"],
                               False)
    trace = prof["chrome_trace"]
    events = trace["traceEvents"]
    pids = {e.get("pid") for e in events}
    lanes = {"goodput": [e["name"] for e in events
                         if e.get("pid") == "goodput" and e.get("ph") == "X"],
             "spans": [e["name"] for e in events
                       if e.get("pid") == "spans" and e.get("ph") == "X"]}
    if not any(n.startswith("goodput.") for n in lanes["goodput"]):
        raise AssertionError("the merged trace has no goodput.* lane")
    if "poll" not in lanes["spans"]:
        raise AssertionError(f"no worker's task span in the merged trace: "
                             f"{sorted(set(lanes['spans']))[:20]}")
    cap = prof["captures"][0] if prof["captures"] else {}
    dev_trace = {k: v for k, v in (cap.get("xla_trace") or {}).items()
                 if k != "events"}
    kernel_ms = {}
    if cuda:
        if dev_trace.get("status") != "captured":
            raise AssertionError(f"25a device trace: {dev_trace}")
        rows = p25_kernel_rows(trace)
        for k, pat in K_NAMES.items():
            hits = [e for e in rows if pat in e["name"]]
            if not hits:
                lo_ = min((e["ts"] for e in rows), default=0.0) / 1e6
                hi_ = max((e["ts"] + e["dur"] for e in rows),
                          default=0.0) / 1e6
                top = collections.Counter(e["name"][:48] for e in rows)
                raise AssertionError(
                    f"{k} ({pat}) not in the merged trace's {len(rows)} "
                    f"device rows: device trace {dev_trace}; rows "
                    f"{lo_:.3f}..{hi_:.3f} s, capture "
                    f"{cap.get('started_at')}..{cap.get('ended_at')}, "
                    f"steps {marks.get('steps')}, gate "
                    f"{marks.get('gate_s')} s; top {top.most_common(8)}")
            kernel_ms[k] = (len(hits), sum(e["dur"] for e in hits) / 1e3)
        before, snap, after = marks["memory"]
        dev_bytes = snap["nodes"]["local"]["daemon"]["device"]["devices"][
            "cuda:0"]["bytes"]
        if not before == dev_bytes == after:
            raise AssertionError(f"device_memory() {dev_bytes} bytes against"
                                 f" memory_allocated {before} / {after}")
        out["device_memory_bytes"] = dev_bytes
        for k in K_NAMES:
            if launches[k] <= 0:
                raise AssertionError(f"{k} did not launch in 25a's fit()")
    steps = list(res.metrics_history)
    print(f"25a: {len(steps)} steps in fit() {fit_s:.2f} s; launches "
          + ", ".join(f"{k} {launches[k]}" for k in K_NAMES)
          + f"; capture {cap.get('duration_s', 0):.3f} s, "
          f"{cap.get('samples', 0)} stack samples, device trace "
          f"{dev_trace.get('status')} ({dev_trace.get('kernels')} kernels"
          f" of {dev_trace.get('launches')} launches, "
          f"{dev_trace.get('missing')} missing; the fit waited "
          f"{marks.get('gate_s') or 0.0:.3f} s for it), "
          + ", ".join(f"{k} {n} kernels {ms:.2f} ms"
                      for k, (n, ms) in kernel_ms.items())
          + f"; merged trace {len(events)} events, lanes "
          f"{sorted(str(p) for p in pids)[:6]}, goodput spans "
          f"{len(lanes['goodput'])}, task spans {len(lanes['spans'])}")
    # Each step against the capture window: before it, overlapping it,
    # after it (the first step, which builds, left out).
    lo, hi = cap.get("started_at", 0.0), cap.get("ended_at", 0.0)
    by_window = {"before": [], "during": [], "after": []}
    for a, b in marks["steps"][1:]:
        key = "before" if b <= lo else "after" if a >= hi else "during"
        by_window[key].append(1e3 * (b - a))
    print("25a step ms (host, to the loss on the host) against the capture "
          "window: " + "; ".join(
              f"{k} " + " ".join(f"{x:.1f}" for x in v)
              for k, v in by_window.items()))
    for label, gp in (("mid-fit", live_gp), ("final", final_gp)):
        print(f"25a rank 0 goodput ({label}): phases + open "
              f"{gp['total_s']:.6f} s, wall {gp['wall_s']:.6f} s, "
              f"unattributed {gp['unattributed_s']:.3e} s, step_compute "
              f"share {100 * gp['step_compute_share']:.2f}%, ledger "
              f"self-cost {100 * gp['self_cost']:.4f}% of the wall; "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          sorted(gp["phase_s"].items())))
    if cuda:
        print(f"25a device_memory(): cuda:0 {out['device_memory_bytes']} "
              f"bytes = torch.cuda.memory_allocated at the same moment")
    out["one"] = {"launches": launches, "fit_s": fit_s, "live": live_gp,
                  "step_ms_by_window": by_window,
                  "final": final_gp, "kernels_in_trace": kernel_ms,
                  "trace_events": len(events),
                  "capture_s": cap.get("duration_s"),
                  "samples": cap.get("samples"), "paths": prof.get("paths")}

    _phase("tracing (25a): two workers, the host collective, traced")
    cards = torch.cuda.device_count() if cuda else 0
    ddp_marks: dict = {}
    gate = threading.Event()
    tracing.clear()
    tracing.enable_tracing()
    ray_tpu_torch.init(num_cpus=8, resources={"GPU": cards} if cuda else None)
    result = {}
    try:
        use_gpu = cards >= 2
        trainer = TorchTrainer(
            p25_ddp_fn(P25_DDP_MATMUL if cuda else 64, P25_DDP_STEPS,
                       ddp_marks, gate),
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=use_gpu,
                resources_per_worker={} if use_gpu else {"CPU": 1}),
            run_config=RunConfig(name="p25-ddp", storage_path=storage),
            backend_config=TorchBackendConfig(device=device))
        fit = threading.Thread(target=lambda: result.update(
            res=trainer.fit()), daemon=True, name="p25-ddp-fit")
        fit.start()
        while len(ddp_marks) < 2:
            if not fit.is_alive():
                raise AssertionError(f"fit() ended early: {result}")
            time.sleep(0.005)
        live = session.collect_train_stats()
        gate.set()
        fit.join(P19_FIT_DEADLINE_S)
        if fit.is_alive():
            raise AssertionError("the two-worker fit() did not end")
        final = session.collect_train_stats()
        strag = ustate.stragglers()
    finally:
        gate.set()
        tracing.disable_tracing()
        tracing.clear()
        ray_tpu_torch.shutdown()
    if not result["res"].ok:
        raise AssertionError(f"25a two workers: {result['res'].error}")
    ranked = sorted(w["rank"] for w in strag["workers"])
    if ranked != [0, 1]:
        raise AssertionError(f"stragglers() ranked {ranked}, not [0, 1]")
    ddp = {"ranks": {}}
    for r in ("0", "1"):
        lg = p25_snapshot_ok(f"25a rank {r} (mid-fit)", live[r]["goodput"],
                             True)
        fg = p25_snapshot_ok(f"25a rank {r} (final)", final[r]["goodput"],
                             False)
        ddp["ranks"][r] = {"live": lg, "final": fg}
        print(f"25a two workers, rank {r}: mid-fit phases + open "
              f"{lg['total_s']:.6f} s vs wall {lg['wall_s']:.6f} s, "
              f"unattributed {lg['unattributed_s']:.3e} s; final "
              f"step_compute share {100 * fg['step_compute_share']:.2f}%, "
              f"collective_wait {fg['phase_s'].get('collective_wait', 0):.4f}"
              f" s, ledger self-cost {100 * fg['self_cost']:.4f}%")
    print("25a stragglers(): " + "; ".join(
        f"rank {w['rank']} median {w['median_step_s'] * 1e3:.2f} ms "
        f"x{w['vs_fleet']:.3f} {w['cause']}" for w in strag["workers"]))
    ddp["stragglers"] = [{k: w[k] for k in ("rank", "median_step_s",
                                            "vs_fleet", "cause")}
                         for w in strag["workers"]]
    out["two"] = ddp
    return out


def _p25_server_cls():
    """Phase 20's LLMServer with one more method, ``timed``: a greedy
    completion of token ids that returns the tokens made and the
    engine's own TTFT (submit to first token)."""
    from ray_tpu_torch.llm import LLMServer, SamplingParams

    class P25Server(LLMServer):
        def timed(self, prompt_ids, max_tokens: int = 64) -> dict:
            req = self.engine.submit(
                [int(t) for t in prompt_ids],
                SamplingParams(max_tokens=max_tokens, temperature=0.0))
            if not req.done.wait(300):
                raise TimeoutError("no answer in 300 s")
            if req.error:
                raise RuntimeError(req.error)
            return {"tokens": len(req.out_tokens),
                    "ttft_s": req.first_token_ts - req.submit_ts}

    return P25Server


def p25_request_traces(spans: list, dep: str) -> dict:
    """{trace id: names of its spans} for the requests of ``dep``: each
    must run root -> attempt -> the replica's span -> the engine's
    queue, prefill and decode spans, parent by parent."""
    by_id = {s["span_id"]: s for s in spans}
    out = {}
    for root in (s for s in spans if s["name"] == f"serve.request.{dep}"):
        tid = root["trace_id"]
        mine = [s for s in spans if s["trace_id"] == tid]
        chain = {}
        for s in mine:
            chain.setdefault(s["name"], []).append(s)
        att = chain.get(f"serve.attempt.{dep}", [])
        rep = chain.get("handle_request", [])
        eng = [chain.get(n, []) for n in ("engine.queue", "engine.prefill",
                                           "engine.decode")]
        ok = (len(att) == 1 and att[0]["parent_id"] == root["span_id"]
              and len(rep) == 1 and rep[0]["parent_id"] == att[0]["span_id"]
              and all(len(e) == 1 and e[0]["parent_id"] == rep[0]["span_id"]
                      for e in eng))
        if not ok:
            raise AssertionError(
                f"trace {tid[:8]}: " + ", ".join(
                    f"{s['name']}<-{by_id.get(s['parent_id'], {}).get('name')}"
                    for s in mine))
        out[tid] = sorted(chain)
    return out


def p25_serve(model: str = "llama3_1b", dtype: str = "bfloat16",
              device: str = "cuda", wave: int = P25_WAVE,
              max_tokens: int = 64,
              deadline_s: float = P25_DEADLINE_S) -> dict:
    """25b: phase 20's OpenAI app behind Serve, traced: at rate 1.0 every
    request one whole trace; at 0.0 the main buffer without any request
    span, but a request ended by its deadline kept by the tail; tok/s and
    TTFT p50 with tracing off and on over the same waves, in turns."""
    import numpy as np
    import torch
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.serve import resilience
    from ray_tpu_torch.util import tracing

    cuda = device == "cuda"
    _phase("tracing (25b): Serve at Llama-3.2-1B width, traced")
    cfg = LLMConfig(model=model, dtype=dtype, max_num_seqs=8,
                    max_seq_len=1024, decode_burst=16, prefill_chunk=512,
                    seed=SEED)
    rng = np.random.default_rng(SEED + 25)
    prompts = [[int(t) for t in rng.integers(1, 256, int(n))]
               for n in rng.integers(32, 201, wave)]
    server = _p25_server_cls()
    out: dict = {}
    counters = _counters()
    ray_tpu_torch.init(num_cpus=8)
    tracing.clear()
    try:
        apps = {}
        for name, rate in (("p25on", 1.0), ("p25off", 0.0)):
            dep = serve.deployment(
                name=name, max_ongoing_requests=8,
                trace_sample_rate=rate)(server)
            apps[name] = serve.run(dep.bind(cfg, device=device), name=name,
                                   route_prefix=None, _blocking_timeout=300)

        def wave_of(h):
            res, wall, _ = p20_loop(prompts, lambda p: h.timed.remote(
                p, max_tokens).result(timeout=300))
            toks = sum(r["tokens"] for r in res.values())
            ttft = [r["ttft_s"] * 1e3 for r in res.values()]
            return toks / wall, statistics.median(ttft)

        wave_of(apps["p25on"])  # warm-up, untraced
        wave_of(apps["p25off"])
        rates = {"off": [], "on": []}
        ttfts = {"off": [], "on": []}
        norms_before = counters["rms_norm"].launches
        for _ in range(P25_PAIRS):
            for mode in ("off", "on", "on", "off"):
                if mode == "on":
                    tracing.enable_tracing()
                r, t = wave_of(apps["p25on"])
                tracing.disable_tracing()
                rates[mode].append(r)
                ttfts[mode].append(t)
        launches = counters["rms_norm"].launches - norms_before
        spans = tracing.export()
        traces = p25_request_traces(spans, "p25on")
        want = P25_PAIRS * 2 * wave
        if len(traces) != want:
            raise AssertionError(f"{len(traces)} whole traces at rate 1.0, "
                                 f"not {want}")
        med = {m: statistics.median(v) for m, v in rates.items()}
        med_t = {m: statistics.median(v) for m, v in ttfts.items()}
        print(f"25b rate 1.0: {len(traces)} requests, each one trace "
              f"serve.request -> serve.attempt -> handle_request -> "
              f"engine.queue/prefill/decode ({len(spans)} spans in all); "
              f"K1 {launches} launches in the waves")
        print(f"25b tok/s tracing off {_spread(rates['off'])}, on "
              f"{_spread(rates['on'])} (medians {med['off']:.1f} / "
              f"{med['on']:.1f}, on/off {med['on'] / med['off']:.4f}); TTFT "
              f"p50 off {med_t['off']:.1f} ms, on {med_t['on']:.1f} ms "
              f"({wave} prompts a wave, concurrency 8, {max_tokens} out, "
              f"waves in turns off, on, on, off)")
        out["rate1"] = {"requests": len(traces), "spans": len(spans),
                        "tok_s": rates, "ttft_p50_ms": ttfts,
                        "tok_s_median": med, "ttft_p50_ms_median": med_t,
                        "launches": launches}

        tracing.clear()
        tracing.enable_tracing()
        h = apps["p25off"]
        unsampled = prompts[:8]
        res, _, _ = p20_loop(unsampled, lambda p: h.timed.remote(
            p, max_tokens).result(timeout=300))
        try:
            h.options(method_name="timed", timeout_s=deadline_s).remote(
                prompts[0], P25_DEADLINE_TOKENS).result(timeout=300)
            raise AssertionError("the deadline request answered")
        except Exception as e:  # noqa: BLE001 - its kind is checked
            # Expired in the handle's wait, or dropped by the replica
            # before it ran: either way the request ended by its deadline.
            if resilience.classify(e) != "expired":
                raise
        time.sleep(P25_KEPT_WAIT_S)  # the kept request's engine ends
        keeps = tracing.drain_keeps()
        tail = tracing.tail_stats()
        tracing.disable_tracing()
        kept = {k["trace_id"] for k in keeps}
        main = [s for s in tracing.export()
                if s["name"].startswith(("serve.", "engine.",
                                         "handle_request"))]
        stray = [s["name"] for s in main if s["trace_id"] not in kept]
        if stray or len(kept) != 1 or [k["reason"] for k in keeps] != \
                ["expired"]:
            raise AssertionError(f"rate 0.0: main buffer {stray}, keeps "
                                 f"{keeps}")
        kept_names = sorted(s["name"] for s in main)
        print(f"25b rate 0.0: {len(unsampled)} requests, none in the main "
              f"buffer (tail "
              f"{tail['traces']} traces, {tail['spans']} spans); the "
              f"request ended by its {deadline_s} s deadline kept "
              f"({keeps[0]['reason']}): {kept_names}")
        out["rate0"] = {"tail": tail, "kept": kept_names}
    finally:
        tracing.disable_tracing()
        tracing.clear()
        serve.shutdown()
        ray_tpu_torch.shutdown()
        if cuda:
            torch.cuda.empty_cache()
    return out


def p25_split(cap: dict, window: tuple) -> dict:
    """One rank's device time over its capture: ms by class
    (P25_CLASSES, else elementwise; memcpy/memset apart), the idle share
    of the capture window (1 - the union of its kernels' intervals over
    the window) and the top host frames (the stack sampler's leaves of
    the main thread)."""
    from ray_tpu_torch.profiling.merge import device_events

    rows = [e for e in device_events(cap, "d") if e.get("ph") == "X"]
    ms = {"gemm": 0.0, "attention": 0.0, "elementwise": 0.0, "nccl": 0.0,
          "memcpy": 0.0}
    for e in rows:
        name = e["name"].lower()
        if e["cat"] != "kernel":
            ms["memcpy"] += e["dur"] / 1e3
            continue
        cls = next((c for c, pats in P25_CLASSES
                    if any(p in name for p in pats)), "elementwise")
        ms[cls] += e["dur"] / 1e3
    lo, hi = window
    spans = sorted((max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                   for e in rows if e["ts"] + e["dur"] > lo and e["ts"] < hi)
    busy, end = 0.0, lo
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    leaves: dict = {}
    for line in (cap.get("collapsed") or "").splitlines():
        stack, _, n = line.rpartition(" ")
        if stack.startswith("MainThread;") and n.isdigit():
            leaf = stack.rsplit(";", 1)[-1]
            leaves[leaf] = leaves.get(leaf, 0) + int(n)
    top = sorted(leaves.items(), key=lambda kv: -kv[1])[:3]
    return {"ms": ms, "kernels": len(rows),
            "idle_share": 1.0 - busy / (hi - lo) if hi > lo else None,
            "top_host_frames": top}


def _rank_p25c(rank: int, world: int, store: str, out_dir: str,
               port: int, device: str = "cuda") -> None:
    """One rank of 25c on card ``rank``: phase 13b's step (flat, then
    ZeRO-1), a capture_profile on a side thread over the same steps; each
    rank writes its bundles for the parent to merge. ``device="cpu"`` runs
    the tiny Llama over gloo (a CPU rehearsal: no device trace)."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.llama import LlamaConfig, init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.sharding import ShardingRules
    from ray_tpu_torch.profiling import capture_profile
    from ray_tpu_torch.train import adamw_lowmem, make_llama_train_step
    from ray_tpu_torch.train.backend import init_distributed

    cuda = device == "cuda"
    init_distributed(f"127.0.0.1:{port}", world, rank, device=device)
    cfg = cfg_8b(P25C_LAYERS) if cuda else LlamaConfig.tiny()
    rows, seq = (P13_BATCH, P13_SEQ) if cuda else (world, 32)
    tokens = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (rows, seq), dtype=np.int32)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    params = init_params(cfg, generator=SEED, device=dev)
    for mode, opts in (("flat", {}), ("zero1", {"zero1": True})):
        if cuda:
            torch.cuda.empty_cache()
        step, init, shard = make_llama_train_step(
            cfg, build_mesh(MeshSpec(dp=world)),
            rules=ShardingRules().override(**DDP_RULES),
            optimizer=adamw_lowmem(3e-4, weight_decay=0.1),
            attn_impl="flash", remat="attn+", seed=SEED, device=dev, **opts)
        tok, tgt = shard(tokens), shard(np.roll(tokens, -1, axis=1))
        state = init(params)
        for _ in range(P25C_WARMUP):
            state, m = step(state, tok, tgt)
        float(m["loss"])
        dist.barrier()
        box: dict = {}
        t = threading.Thread(target=lambda: box.update(cap=capture_profile(
            P25C_CAPTURE_S if cuda else 0.3,
            meta={"kind": "rank", "source": f"rank{rank}",
                  "node_id": f"r{rank}"})), name="p25c-cap")
        t.start()
        steps, losses = 0, []
        more = torch.ones(1, device=dev)
        while more.item():
            state, m = step(state, tok, tgt)
            losses.append(float(m["loss"]))
            steps += 1
            # Every rank takes as many steps (their collectives pair up):
            # on while any rank's capture runs.
            more.fill_(float(t.is_alive() or steps < 2))
            dist.all_reduce(more, op=dist.ReduceOp.MAX)
        t.join()
        cap = box["cap"]
        dev_trace = {k: v for k, v in (cap.get("xla_trace") or {}).items()
                     if k != "events"}
        if cap.get("error") or (cuda and dev_trace.get("status")
                                != "captured"):
            raise AssertionError(f"rank {rank} {mode} capture: "
                                 f"{cap.get('error') or dev_trace}")
        cap["steps"] = steps
        cap["losses"] = losses
        with open(os.path.join(out_dir, f"{mode}_rank{rank}.json"), "w") as f:
            json.dump(cap, f, default=str)
        del state, step, init, shard, m
        gc.collect()
        dist.barrier()
    dist.destroy_process_group()


def p25_ranks(world: int, root: str, device: str = "cuda") -> dict:
    """25c: one capture per rank on ``world`` cards, merged into one
    gzipped chrome trace per mode next to the run's output
    (chiprun_out/p25c)."""
    import gzip
    import tempfile

    from ray_tpu_torch._spawn import run_ranks
    from ray_tpu_torch.profiling import merge_chrome_trace
    from ray_tpu_torch.train.backend import free_port

    cuda = device == "cuda"
    layers = P25C_LAYERS if cuda else 2
    _phase(f"tracing (25c): one capture per rank on {world} cards, phase "
           f"13b's step at {layers} layers, flat and ZeRO-1")
    out_dir = os.path.join(root, "chiprun_out", "p25c")
    os.makedirs(out_dir, exist_ok=True)
    res: dict = {"layers": layers}
    from ray_tpu_torch.utils.config import get_config

    with tempfile.TemporaryDirectory(dir=get_config().temp_dir) as tmp:
        run_ranks(_rank_p25c, world, tmp, (tmp, free_port(), device),
                  P25C_TIMEOUT_S)
        for mode in ("flat", "zero1"):
            caps = []
            for r in range(world):
                with open(os.path.join(tmp, f"{mode}_rank{r}.json")) as f:
                    caps.append(json.load(f))
            trace = merge_chrome_trace(caps)
            path = os.path.join(out_dir, f"trace_{mode}.json.gz")
            with gzip.open(path, "wt") as f:
                json.dump(trace, f)
            ranks_seen = sorted({e["pid"] for e in trace["traceEvents"]
                                 if str(e.get("pid", "")).startswith(
                                     "device ") and e.get("ph") == "X"})
            if cuda and len(ranks_seen) != world:
                raise AssertionError(f"{mode}: device rows of {ranks_seen}")
            res[mode] = {"trace": path, "events": len(trace["traceEvents"]),
                         "ranks": {}}
            print(f"25c {mode} ({layers} layers, {P13_BATCH // world if cuda else 1}"
                  f" row a rank): merged trace {path} "
                  f"({len(trace['traceEvents'])} events, "
                  f"{os.path.getsize(path) / 2 ** 20:.1f} MiB gzipped), "
                  f"device rows of {len(ranks_seen)} ranks")
            for r, cap in enumerate(caps):
                window = (cap["started_at"] * 1e6, cap["ended_at"] * 1e6)
                sp = p25_split(cap, window)
                res[mode]["ranks"][r] = {**sp, "steps": cap["steps"],
                                         "duration_s": cap["duration_s"]}
                idle = (f"{100 * sp['idle_share']:.2f}%"
                        if sp["idle_share"] is not None else "n/a")
                print(f"  rank {r}: {cap['steps']} steps in "
                      f"{cap['duration_s']:.3f} s; GEMM "
                      f"{sp['ms']['gemm']:.1f} ms, attention (K2/K3) "
                      f"{sp['ms']['attention']:.1f} ms, elementwise "
                      f"{sp['ms']['elementwise']:.1f} ms, NCCL "
                      f"{sp['ms']['nccl']:.1f} ms, memcpy "
                      f"{sp['ms']['memcpy']:.1f} ms; idle {idle}; top host "
                      f"frames " + "; ".join(f"{n} x{c}" for n, c in
                                             sp["top_host_frames"]))
    return res


@contextlib.contextmanager
def p25_scratch():
    """Phase 25's scratch directory (device traces, rank bundles, trainer
    storage) inside the checkout's build directory: RTPU_TEMP_DIR (for
    spawned ranks) and this process's config point at it for the phase,
    and are restored, the directory removed, after it."""
    import shutil

    from ray_tpu_torch.utils.config import get_config

    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "ray_tpu_torch", "_native", "_build", "p25tmp")
    os.makedirs(path, exist_ok=True)
    cfg = get_config()
    old = cfg.temp_dir, os.environ.get("RTPU_TEMP_DIR")
    os.environ["RTPU_TEMP_DIR"] = cfg.temp_dir = path
    try:
        yield path
    finally:
        cfg.temp_dir = old[0]
        if old[1] is None:
            os.environ.pop("RTPU_TEMP_DIR", None)
        else:
            os.environ["RTPU_TEMP_DIR"] = old[1]
        shutil.rmtree(path, ignore_errors=True)


def phase_tracing() -> dict:
    """Phase 25: tracing, profiling and the goodput ledger on the card.
    (a) phase 19's TorchTrainer traced (one worker with profile_cluster
    mid-fit; two workers on the host collective); (b) Serve traced at
    rates 1.0 and 0.0; (c) with four cards, one capture per rank."""
    import torch
    from ray_tpu_torch.models.llama import LlamaConfig

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = LlamaConfig(**BENCH_GEOMETRY, max_seq_len=2048)
    with p25_scratch() as tmp:
        storage = os.path.join(tmp, "storage")
        os.makedirs(storage)
        out = {"trainer": p25_trainer(cfg, 4, 2048, "cuda", storage,
                                      os.path.join(root, "chiprun_out"))}
        torch.cuda.empty_cache()
        out["serve"] = p25_serve()
        if torch.cuda.device_count() >= 4:
            torch.cuda.empty_cache()
            out["ranks"] = p25_ranks(4, root)
        else:
            _phase("tracing (25c): skipped (fewer than four cards visible)")
            out["ranks"] = None
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 25: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ray_tpu_torch")):
        print("chip_smoke: run from a checkout holding ray_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    kind, smi = phase_device()
    phase_build()
    max_err, times = phase_kernel()
    flash = phase_flash()
    split = phase_split()
    packed, sweep = phase_packed()
    chunk = phase_chunk()
    ring = phase_ring_schedule()
    eng = phase_engine(times[0]["host_us"])
    train = phase_train()
    train_split = phase_train_split(train)
    cp = phase_cp_train()
    vit = phase_vit()
    train8b = phase_train_8b()
    pipe = phase_pipeline()
    moe = phase_mixtral()
    rl = phase_rl()
    rest = phase_serving_rest()
    rl_rest = phase_rl_rest()
    trainer = phase_trainer()
    serve_ = phase_serve()
    tuning = phase_tuning()
    layouts = phase_layouts(train8b, moe)
    tp_one = phase_tp_serving()
    data = phase_data(eng)
    tracing = phase_tracing()
    # The ring over ranks needs a card a rank: all the cards visible, in a
    # power of two (the sequence splits evenly).
    world = 1 << (torch.cuda.device_count().bit_length() - 1)
    if world >= 2:
        torch.cuda.empty_cache()
        ranks = phase_ranks(world)
        train_ranks = phase_train_ranks(world, train8b)
        pipe_ranks = phase_pipeline_ranks(min(world, 4), pipe)
        moe_ranks = phase_mixtral_ranks(min(world, 4))
        rl_ranks = phase_rl_ranks(world)
        tp_ranks = phase_tp_serving_ranks(world, tp_one)
    else:
        _phase("ring over ranks: skipped (one card visible)")
        _phase("data-parallel train over ranks: skipped (one card visible)")
        _phase("pipeline train over ranks: skipped (one card visible)")
        _phase("Mixtral train over ranks: skipped (one card visible)")
        _phase("RL over ranks: skipped (one card visible)")
        _phase("tensor-parallel serving over ranks (23b): skipped (one card "
               "visible)")
        ranks = train_ranks = pipe_ranks = moe_ranks = rl_ranks = None
        tp_ranks = None
    if world >= 4:
        layouts_ranks = phase_layouts_ranks(4)
    else:
        _phase("mesh layouts over four ranks: skipped (fewer than four "
               "cards visible)")
        layouts_ranks = None
    # Launches of the layouts' paths, phase 22 and (four cards) 22b.
    layout_launches = {k: layouts["launches"].get(k, 0) + (
        layouts_ranks["launches"].get(k, 0) if layouts_ranks else 0)
        for k in _counters()}
    phase_cross_device()
    phase_cross_device_train()
    phase_cross_device_vit()
    main_shape = times[0]  # rows 8: the decode step's shape
    kernels = [{
        "name": "rms_norm", "route": "cuda",
        "source": "ray_tpu_torch/csrc/rms_norm.cu",
        "replaces": "ray_tpu/ops/norms.py:27",
        "tpu": "ray_tpu/ops/norms.py:_rms_kernel", "checked": True,
        "launches": train["launches"]["rms_norm"] + rest["launches"],
        "launches_by_path": {"engine": eng["launches"],
                             "serving_rest": rest["launches"],
                             "train": train["launches"]["rms_norm"],
                             "train_split":
                                 train_split["launches"]["rms_norm"],
                             "cp_train": cp["launches"]["rms_norm"],
                             "vit_fused":
                                 vit["fused"]["launches"]["rms_norm"],
                             "vit_split":
                                 vit["split"]["launches"]["rms_norm"],
                             "train_8b": {
                                 k_: train8b["runs"][k_]["launches"][
                                     "rms_norm"] for k_ in P13_MODES},
                             "pipeline": pipe["run"]["launches"]["rms_norm"],
                             "trainer":
                                 trainer["restart"]["launches"]["rms_norm"],
                             "serve": serve_["launches"],
                             "mixtral": {
                                 k_: moe["runs"][k_]["launches"]["rms_norm"]
                                 for k_ in P15_MODES},
                             **{k_: v_["rms_norm"] for k_, v_ in
                                tuning["launches"].items()},
                             "layouts": layout_launches["rms_norm"],
                             "tp_serving": tp_one["launches"],
                             "data_batch_inference":
                                 data["batch_inference"]["launches"],
                             "data_trainer":
                                 data["trainer"]["launches"]["rms_norm"],
                             "tp_serving_ranks": {
                                 tp_: tp_ranks[tp_]["a"]["launches"]
                                 for tp_ in (2, 4) if tp_ranks
                                 and tp_ in tp_ranks},
                             "tracing_trainer": tracing["trainer"]["one"][
                                 "launches"]["rms_norm"],
                             "tracing_serve":
                                 tracing["serve"]["rate1"]["launches"]},
        "max_abs_err": max_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shape": [main_shape["rows"], main_shape["d"]], "dtype": "bfloat16",
        "host_us": main_shape["host_us"],
        "library_host_us": main_shape["library_host_us"],
        "shapes": times,
    }]
    for name, replaces, tpu in (
            ("flash_fwd", "ray_tpu/ops/attention.py:222",
             "_flash_fwd_kernel"),
            ("flash_bwd", "ray_tpu/ops/attention.py:476",
             "_flash_bwd_fused_kernel")):
        row = flash[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "tpu": f"ray_tpu/ops/attention.py:{tpu}",
            "checked": True, "launches": train["launches"][name],
            "launches_by_path": {
                "train": train["launches"][name],
                "train_split": train_split["launches"][name],
                "vit_fused": vit["fused"]["launches"][name],
                "vit_split": vit["split"]["launches"][name],
                "train_8b": {k_: train8b["runs"][k_]["launches"][name]
                             for k_ in P13_MODES},
                "pipeline": pipe["run"]["launches"][name],
                "trainer": trainer["restart"]["launches"][name],
                "mixtral": {k_: moe["runs"][k_]["launches"][name]
                            for k_ in P15_MODES},
                **{k_: v_[name] for k_, v_ in tuning["launches"].items()},
                "layouts": layout_launches[name],
                "data_trainer": data["trainer"]["launches"][name],
                "tracing_trainer": tracing["trainer"]["one"]["launches"][
                    name]},
            "max_abs_err": max(row["max_abs_err"],
                               vit["attention"][name]["max_abs_err"]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            **({"library_bwd_ms": row["library_bwd_ms"]}
               if "library_bwd_ms" in row else {}),
            "shape": [4, 32, 8, 2048, 64], "dtype": "bfloat16",
            "causal": True, "tflops": row["tflops"],
            "design": FLASH_DESIGN[name], "registers": row["registers"],
            **({"dq_dk_dv_bit_identical": row["dq_dk_dv_bit_identical"]}
               if "dq_dk_dv_bit_identical" in row else {}),
            "vit_shape": vit["attention"][name]})
    for name, replaces, tpu in (
            ("flash_bwd_dq", "ray_tpu/ops/attention.py:387",
             "_flash_bwd_dq_kernel"),
            ("flash_bwd_dkv", "ray_tpu/ops/attention.py:431",
             "_flash_bwd_dkv_kernel")):
        row = split[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "tpu": f"ray_tpu/ops/attention.py:{tpu}",
            "checked": True, "launches": train_split["launches"][name],
            "launches_by_path": {"train_split": train_split["launches"][name],
                                 "vit_split": vit["split"]["launches"][name]},
            "max_abs_err": max(row["max_abs_err"],
                               vit["attention"][name]["max_abs_err"]),
            "max_rel_err": row["max_rel_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library_compares": "scaled_dot_product_attention's backward "
                                "alone against split_total_ms (K4 and K5, "
                                "which folds inside, through their "
                                "wrapper)",
            "split_total_ms": row["split_total_ms"],
            "k3_ms": row["k3_ms"], "bit_identical": row["bit_identical"],
            "shape": [4, 32, 8, 2048, 64], "dtype": "bfloat16",
            "causal": True, "tflops": row["tflops"],
            "vit_shape": vit["attention"][name]})
    for name, replaces, tpu in (
            ("flash_chunk_fwd", "ray_tpu/ops/attention.py:735",
             "_flash_chunk_fwd_kernel"),
            ("flash_chunk_bwd", "ray_tpu/ops/attention.py:779",
             "_flash_chunk_bwd_kernel")):
        row = chunk[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "tpu": f"ray_tpu/ops/attention.py:{tpu}",
            "checked": True, "launches": cp["launches"][name],
            "launches_by_path": {"ring_schedule": ring["launches"][name],
                                 "cp_train": cp["launches"][name],
                                 "layouts": layout_launches[name]},
            "max_abs_err": row["max_abs_err"],
            "max_rel_err": row["max_rel_err"],
            "main_shape_errs": row["main_shape_errs"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": [1, 32, 8, CP_SEQ, CP_SEQ, 64], "dtype": "bfloat16",
            "positions": "0..S-1, causal (the CP step's)",
            "tflops": row["tflops"],
            "tflops_full_pass": row["tflops_full_pass"],
            "tile_pairs": row["tile_pairs"], "chunk_4096": row["chunk_4096"]})
    row = chunk["chunk_tile_bounds"]
    kernels.append({
        "name": "chunk_tile_bounds", "route": "cuda",
        "source": "ray_tpu_torch/csrc/chunk_tile_bounds.cu",
        "replaces": "ray_tpu/ops/attention.py:735",
        "tpu": "none: the pre-pass of K6/K7 (ray_tpu/ops/attention.py:735, "
               ":779), whose tile classes the TPU kernels do not have",
        "checked": True, "launches": cp["launches"]["chunk_tile_bounds"],
        "launches_by_path": {
            "ring_schedule": ring["launches"]["chunk_tile_bounds"],
            "cp_train": cp["launches"]["chunk_tile_bounds"],
            "layouts": layout_launches["chunk_tile_bounds"]},
        **row, "shape": [CP_SEQ, CP_SEQ], "dtype": "int32"})
    for name, (sched, line) in PACKED.items():
        row = packed[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_packed_fwd.cu",
            "replaces": f"devbench/prof_flash_pack.py:{line}",
            "tpu": "devbench/prof_flash_pack.py:_packed_fwd"
                   + {"masked": "", "epi": "_epi", "inl": "_inl"}[sched]
                   + "_kernel",
            "checked": True, "launches": row["launches"],
            "launches_by_path": {"prof_flash_pack": row["launches"]},
            **{k_: v_ for k_, v_ in row.items() if k_ != "launches"},
            "shape": [4, 32, 8, 2048, 64], "dtype": "bfloat16",
            "causal": True, "variant": "pack2_bq64_bk64",
            "design": PACKED_DESIGN})
    summary = {k: v for k, v in eng.items() if k != "launches"}
    vit_summary = {k: v for k, v in vit.items() if k != "attention"}
    print(json.dumps({"card": smi, "engine": summary, "train": train,
                      "train_split": train_split, "ring_schedule": ring,
                      "cp_train": cp, "vit": vit_summary,
                      "prof_flash_pack": sweep, "ranks": ranks,
                      "train_8b": train8b, "train_ranks": train_ranks,
                      "pipeline": pipe, "pipeline_ranks": pipe_ranks,
                      "mixtral": moe, "mixtral_ranks": moe_ranks,
                      "rl": rl, "rl_ranks": rl_ranks,
                      "serving_rest": {k: v for k, v in rest.items()
                                       if k != "launches"},
                      "rl_rest": rl_rest, "trainer": trainer,
                      "serve": {k: v for k, v in serve_.items()
                                if k != "launches"},
                      "tuning": tuning,
                      "layouts": {"one_card": layouts,
                                  "four_cards": layouts_ranks},
                      "tp_serving": {k: v for k, v in tp_one.items()
                                     if k not in ("wave", "short", "streams",
                                                  "logits0")},
                      "tp_serving_ranks": tp_ranks, "data": data,
                      "tracing": tracing},
                     default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _end(rc: int) -> None:
    """End the process once its last line is out. A whole run on one card
    (PR 22's proof, NVIDIA H100 80GB HBM3, 700.00 W) wrote its last line
    and then took ~300 s more to exit, a stall in the interpreter's
    teardown that no phase run alone shows. The threads still alive are
    named with their stacks on stderr, as a finding; the child processes
    are stopped; and the process ends without that teardown."""
    import multiprocessing
    import traceback

    frames = sys._current_frames()
    alive = [t for t in threading.enumerate()
             if t is not threading.main_thread() and not t.daemon]
    for t in alive:
        stack = "".join(traceback.format_stack(frames.get(t.ident)))[-1500:] \
            if t.ident in frames else ""
        print(f"chip_smoke: thread {t.name!r} still alive at the end:\n"
              f"{stack}", file=sys.stderr)
    for child in multiprocessing.active_children():
        child.terminate()
        child.join(10)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


if __name__ == "__main__":
    _end(main())
