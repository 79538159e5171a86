#!/usr/bin/env python3
"""Drive the ray_tpu_torch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases (one line each, timed; any failure raises, so the exit code is
nonzero and no result line is printed):

1. env     — torch / CUDA / nvcc versions, the card's name and power limit.
2. build   — nvcc builds every kernel under ray_tpu_torch/ops/csrc/ (one
             process per source, started together); `cuobjdump -sass`
             counts the wgmma (HGMMA) and asynchronous copies (LDGSTS,
             UTMALDG) of each instance of the flash forward and backward
             kernels and of the ragged kernels: a bf16 flash instance
             without HGMMA, a bf16 ragged main kernel (tile or split
             decode) without HGMMA or without asynchronous copies, or an
             f32 instance with HGMMA fails the phase.
3. kernels — each kernel against its plain PyTorch version, in bf16 and
             f32, with times, the card's bound and (flash) the PyTorch
             library yardstick: ragged at the Llama-3-8B shapes of the
             serving path, a mixed tick's batch, a decode step's and a
             decode-only verify tick's (each also bitwise against a second
             run, and against the kernel on q scaled beforehand; where the
             largest error sits, and the device kernels one call runs,
             read from torch.profiler); the flash forward and both flash
             backward kernels at the Llama shape of the dense check (GQA
             32/8, S 931, D 128; the forward causal and not) and at the
             GPT-2 124M shape of the train path (B 8, 12 heads, S 1024,
             D 64), the forward also at the draft model's (S 64) and at
             the dense engine's prefill buckets (S 16, 32, 1024); ragged
             also at a tp = 2 shard's heads (Hq 16, Hkv 4: the mixed and
             decode batches, bf16). Two runs must be bitwise equal; the bare launches are timed
             apart from the wrappers (the forward's on contiguous tensors
             and on the model's transposed views, which it copies; the
             backward's with delta = rowsum(dO * O)).
4. serve   — LLMServer("llama3-8b") at full width and depth on the card,
             random bf16 weights from a seeded torch.Generator, the
             engine's passes captured as CUDA graphs up front (precompile:
             capture time, graph count, memory after capture); 8 greedy
             requests with prompts of 64-900 tokens, 32 new tokens each,
             unprofiled (wall, TTFT, decode rate). A replay passes through
             no kernel wrapper: the engine counts each pass's replays times
             the launches its capture recorded, by kind (decode steps, mixed
             ticks), each kind must occur and no ragged launch may pass
             through the wrapper. A profiled repeat of the 8 requests must
             show torch.profiler's ragged device kernels equal to the
             engine's count for it (the profiler may drop records of graph
             kernels, never add any: up to 3 repeats, each printed, the
             first that equals passes); one request at temperature 1, top-k 50
             (the filtered decode graph) must stay in the vocabulary and
             differ from its greedy twin.
5. check   — the dense forward (flash kernel) over prompt + generated tokens
             of 2 requests: every engine token must score within
             CHECK_MARGIN (0.5, set from the serve path's measured bf16
             tail) of the dense argmax, at least EXACT_SHARE_FLOOR (0.6) of
             the positions must equal it, and the positions over TAIL_GAP
             (0.25) are printed; the later phases' checks hold the same
             rule (overload: the margin alone).
   spec    — speculative decoding and the prefix cache on the serve phase's
             weight tensors (K = 4, verify passes captured as CUDA graphs):
             a replay drill (drafts: the serve phase's greedy tokens;
             prefix cache on) that must run verify rounds and accept
             drafts; 8 prompts sharing a 512-token prefix, of which at
             least 7 must hit the cache (TTFT against the serve engine);
             a self-replay on a second engine (drafts: the drill's own
             tokens); a draft model (a 2-layer cut of the model) that must
             propose and launch the flash kernel. Each run passes the
             dense check; the drill's and the self-replay's ragged
             launches are held against torch.profiler; replay times of the
             serve and verify graphs and of the accept step are printed.
   dense   — LLMServer(engine_config=None) on the serve phase's weight
             tensors builds the dense LLMEngine (8 slots, max_seq 1024, its
             decode step one CUDA graph): the serve phase's 8 greedy
             requests (TTFT, decode rate, wall, capture time and memory);
             flash launches of its eager prefills counted by the engine
             (prefills x layers) and held against the wrapper's count and
             torch.profiler's; every request passes the dense check; one
             decode-graph replay equals eager decode_step bitwise.
   overload — a PagedLLMEngine (4 slots, a pool the 4 long lanes nearly
             fill, graphs captured up front) at Llama-3-8B's width and
             OVERLOAD_LAYERS (8) layers, bf16 weights from SEED (a depth
             cut for the script's time limit): 4
             priority-0 lanes (512-token prompts, 256 new tokens) decode
             when 2 priority-1 requests arrive and preempt lanes, which park
             and resume (preemptions, pages, resumes, stalls, the priority-1
             TTFT against the same run with preemption off, and the pair
             again on an engine with 1 block in flight); then a burst
             of 3 x the queue bound (typed sheds), a tenant over its quota
             (typed sheds with a finite retry_after_s) and requests with
             0.2 s deadlines behind long lanes (typed timeouts at the admit
             pop and mid-decode). Every stream ends with tokens or a typed
             error, the pool returns to full, every finished stream passes
             the dense check, and the ragged launches counted by the engine
             are held against torch.profiler's.
   deploy  — the serving entry point as users call it, on the same weight
             tensors: ray_tpu_torch.init() must show GPU 1.0; a 1 GiB CUDA
             tensor put into the object store is a DEVICE object, got back
             without a copy (the same data_ptr) and freed when its ref
             drops; serve.run(build_llm_app(..., paged=True, max_slots=8))
             (deployment A: the paged engine in a replica actor that holds
             the caller's weights, graphs captured at first use by a
             warm-up request, the rest on the idle engine) serves the 8
             requests as 8 streams through the handle (TTFT, decode rate,
             wall and a profiled repeat's idle share beside the serve
             phase's direct numbers; ragged launches held against
             torch.profiler; the dense check at 0.5, positions over 0.25
             printed); the OpenAI frontend over it
             (/v1/models, a token-array completion plain and SSE, a
             malformed body's error schema); then the default dense app
             with 2 replicas on one card (deployment B, each replica's
             decode graph captured in its own actor thread) serves 16
             streams: both replicas serve, flash launches = prefills x
             layers, the dense check; serve.shutdown() and
             ray_tpu_torch.shutdown() join every thread the phase started
             and free the replicas' caches.
   observe — Serve's observability plane on the serve phase's engine and
             weights: the 8 requests with the request log and tracing on,
             then off, alternated 5 + 5 in on, off, off, on order (wall,
             TTFT p50, decode rate, a profiled repeat's idle share; the
             median of the 5 adjacent pairs' wall ratios on / off held to
             OBSERVE_WALL_BOUND); each request's
             state.request_timeline() in order (submitted, admitted,
             prefill chunks, decode blocks at dispatch, first_token and
             finished at emission) with times that never go back, all in
             list_requests(), one waterfall printed, engine_snapshot() busy
             while they run and the pool free after; the engine gauges in
             /metrics, decode_flops against the decode block's closed form
             (1%), decode_mfu in (0, 1.05] beside the MFU of the block's
             measured replay, tick_seconds beside the replay and dispatch
             times; the user path (ray_tpu_torch.init(num_gpus=1),
             serve.run(build_llm_app(params=..., paged=True)), the 8
             requests streamed through the handle under state.profile():
             device "ok", the capture's ragged device kernels (> 0, at most
             the engine's count for the window) on the wall clock inside
             the capture window +- 50 ms, trace_dump's device tracks, the
             router-started SLO monitor burning at a 1 ms TTFT objective
             and not at 60 s, a postmortem bundle that loads back with the
             requests' engine.request spans, the profile, the burn events
             and the metrics text; goodput.serve_slo_report()); and
             paged.chunk_prefill_step at Llama width bitwise against
             batched_chunk_prefill_step at B 1.
   tp_serve — tensor-parallel serving, tp = 2, both shards on the one card
             (PagedLLMEngine(mesh=build_mesh(MeshSpec(tp=2), ["cuda:0"] * 2)):
             correctness and overhead, not scaling): (t1) the serve phase's
             weights at full depth in bf16, its 8 requests: every pass
             captured (capture time, memory, the shards' own weights and
             pools), each capture recording 2 x the serve engine's ragged
             launches on the same pass, wall, TTFT, decode rate, the
             ragged launches counted by the engine held against
             torch.profiler's in a profiled repeat (idle share), the dense
             check, and the positions equal to the serve phase's tokens
             (printed, not gated); (t2) Llama-3-8B's width at 2 layers in
             f32, tp = 1 against tp = 2: greedy tokens equal, except that
             at a request's first difference tp = 1's dense logits may
             hold a near-tie (top-2 gap under TP_NEAR_TIE), after which
             that request is not compared; (t3) the same model with
             speculation (K = 4) and the prefix cache on the shared-prefix
             prompts: tokens (the same rule), cached tokens, prefix hits
             and copy-on-write copies equal, verify passes replayed, then
             copy_page over the shards' pools (each stripe equal).
   cluster — cluster mode (A6a) once the serve server is freed (the
             allocated bytes of this process logged): `python -m ray_tpu_torch
             start --head --num-gpus 0 --snapshot-path <tmp>/gcs.snap` and
             one agent `start --address ... --num-gpus 1` on the card, both
             in JAX's head-drill environment (heartbeat 0.2 s, staleness
             2.5 s, a snapshot every 0.5 s), and this process joins with no
             GPU (start-up seconds). (a) A task
             pinned to the agent returns a 1 GiB CPU tensor made from SEED,
             pulled here in 4 MiB windows and held bit-equal against this
             process's own (pull GB/s); a second returns a 256 MiB bf16
             CUDA tensor that must land on this process's card bit-equal,
             after one host copy on the agent; a no-op actor's call round
             trip (p50 / p90 us over CLUSTER_CALLS calls). (b) An actor
             with num_gpus=1 (torch_cluster_udfs.ClusterLLM) builds
             LLMServer at Llama-3-8B's width and CLUSTER_LAYERS (8) of its
             32 layers (bf16 from SEED, max_slots 8, precompile; a depth
             cut for the script's time limit) on the agent,
             serves the 8 prompts submitted together (the counts set to 0
             there just before, read just after: ragged launches = graph
             replays x captured + wrapper) and runs the dense check where
             the weights are (the one definition,
             torch_cluster_udfs.dense_check_stats, at CHECK_MARGIN /
             EXACT_SHARE_FLOOR, flash forward launches). (c) health.probe_agent answers True while
             the agent lives. The members and the actor stay up for
             head_restart; a failure prints the members' logs and stops
             them.
   head_restart — Llama-3-8B (8 layers) serving from a node agent through two deaths
             of the head (ROADMAP A6b parts 1-2; JAX's drill,
             bench_cluster.py run_head_outage), on the cluster phase's
             members and its agent's ClusterLLM actor (built once: the
             engine and its graphs are the cluster phase's). A serve loop
             calls serve_once with the serve
             phase's prompts in turn (each call a greedy request and its
             dense check, which launches K1), a KV writer
             (GcsClient(retry_window_s=90)) puts a key every 50 ms, and a
             zombie client stays pinned to the first epoch. (a) SIGKILL to
             the head while a call is in flight, then `--restore` on the
             same port with RAY_TPU_CHAOS="kill_head=1,delay_s=5,
             max_injections=1"; (b) that head dies by chaos (rc 137)
             during traffic, and a third head restores without chaos. Then
             the agent's first capture, a 1 s state.profile(nodes=[agent])
             fanned out from here while the serve loop runs, must hold K5
             and K1 device kernels of the agent, and the agent must stay in
             the head's view throughout (the profiler's stop holds its
             process, heartbeats included, for seconds: it announces the
             quiet) with serve calls finishing after it. Fails
             unless: the agent's and the actor's pid never change, serve
             calls finished inside each outage, no call raised, every
             call's tokens equal the first call's of its prompt, the first
             round's dense check holds (CHECK_MARGIN / EXACT_SHARE_FLOOR)
             and every call's worst gap is within CHECK_MARGIN, no
             acknowledged write is lost and the writer saw no error, the
             zombie gets StaleEpochError, the epoch went up by exactly 2,
             the head's _requests table holds the agent's marks of a
             request served during an outage each once and
             state.request_timeline returns them on the agent's node,
             cluster_prometheus_text() has samples of the agent's node,
             the node table's CUDA block is within 1 % of the actor's
             allocated bytes, the agent's federation lag drains to 0, and
             no head, agent or card process is left once the members are
             stopped (this process leaves, then the agent and the head by
             their shutdown_node RPC). Printed: per restart
             the head's start, recovery_ready_s (death to the first write
             the restored head acknowledged), wal_records_applied and the
             snapshot's and WAL's bytes; serve calls and median decode
             tok/s before, during and between the outages; the launches
             counted in the agent; the phase's time.
6. train   — GPT-2 124M (gpt2-small) at full width and depth, f32 master
             weights from a seeded torch.Generator, bf16 compute:
             the kernel path's gradients against attn_impl="xla" on one
             smaller batch, then TRAIN_STEPS steps of make_train_step on one
             fixed 8 x 1025 batch; the loss must fall by the stated margin
             and each flash kernel must launch once per layer per step.
7. trainer — LMTrainer on gpt2-small at full width and depth (the train
             phase's optimizer: lr 1e-3, warmup 2, 20 steps) fed by
             lm_batch_iterator (pinned copies on a side stream, a prefetch
             window of 2) over a token stream made with numpy from the
             seed: the same 8 x 1025 window every step, as the train
             phase's fixed batch, so its loss margin holds. 20 steps,
             reports every 5, the step log sampling every 5th step,
             asynchronous checkpoints every 10 into a temporary directory.
             Per report: tokens/s, step_time_s, mfu, step_flops,
             step_bytes, roofline_hbm; each sampled step's buckets; the
             device time between consecutive steps' ends (CUDA events, no
             synchronisation); a checkpoint drill (snapshot, write and
             verified restore: seconds and bytes). Checks: the loss below
             LOSS_MARGIN x the first, 12 launches of each flash kernel a
             step, every sampled step's buckets summing to its wall_s,
             0 < mfu < 1 in every report, a second trainer's
             maybe_restore() at 20 with params and moments equal bitwise,
             and a trainer restored at step 10 reproducing steps 11-15's
             losses (bitwise).
8. ingest  — the streaming data plane and the one-process gang feeding
             GPT-2 124M (ray_tpu_torch.init() with GPU 1.0): 48 .npy
             shards of 4096 windows of 1025 int32 tokens drawn from
             [0, 50257) with numpy from the seed (806 MB, in a temporary
             directory removed at the end). Pass A: lm_batch_iterator(
             read_npy(shards)) over the corpus, each batch's int64 sum
             added on the card (no host read per batch); pass B:
             read_npy(shards).map_batches(windows).iter_torch_batches(8,
             drop_last=True); both sums must equal numpy's, bitwise (tokens/s,
             MB/s landed, StreamStats: produced bytes, peak in-flight bytes
             against the 64 MiB budget, stalls; each batch's host time
             pinning and enqueuing its copy). Then Trainer(train_fn,
             ScalingConfig(num_workers=1, use_gpu=True), datasets={"train":
             read_npy(shards)}).fit(): the rank runs LMTrainer (the trainer
             phase's seed and optimizer) for 40 steps, reports every 10
             through session.report, fed by lm_batch_iterator(
             get_dataset_shard("train")); then the same 40 steps directly
             (the same init, a plain iter_blocks() over the shards): every
             loss and the 4 reports must be equal bitwise, the Result must
             carry 4 reports and no error, and each flash kernel must launch
             12 times a step (step medians both ways, data_wait's share of
             the sampled steps' wall, the controller's dominant bucket, the
             idle share of steps 21-30 under torch.profiler, started on the
             main thread while the rank steps). A restart drill
             (FailureConfig(max_failures=1)): attempt 0 checkpoints at step
             10, reports it and raises; attempt 1 restores it and runs to
             step 20: one restart, final step 20, attempt 0's parameters
             gone when attempt 1 starts, allocated bytes between the
             attempts and after fit() within 64 MiB of their value before
             (each reading taken with PyTorch's cuBLAS workspaces dropped).
   process — the process plane feeding GPT-2 124M (ray_tpu_torch.init()
             with cfg.native_store on, the arena sized within half the
             free bytes of /dev/shm, at most PROCESS_ARENA_BYTES; the
             port's libobjstore.so built from native/objstore.cc at first
             use; 6 pooled workers prestarted, their pids none of this
             process's): (a) 8192 synthetic documents (words from a seeded
             vocabulary, ~23 MB of ASCII text in 64 blocks) mapped by
             torch_process_udfs.tokenize_pack (normalise each document in a
             Python loop, ByteTokenizer.encode, pack windows of 1025) with
             executor="thread", then "process", each landed by
             iter_torch_batches(8, device="cuda"): tokens/s landed each
             way, shm_puts and the arena's bytes, /dev/shm's free bytes;
             the sums and hashes (on the card) must be equal, shm_puts > 0,
             and 20 train steps fed each pass's first batches must give
             equal losses, bitwise; (b) a compiled graph, InputNode ->
             Preproc.transform (a process actor: tokenise and pad 8 prompts
             to 1024) -> LM.infer (a thread actor holding GPT-2 124M on the
             card, returning the argmax as a CPU array), executed 32 times
             pipelined over shared-memory edges, must equal the same chain
             of .remote() calls (ms an execute against ms a call); (c) a
             process actor's worker SIGKILLed while idle must be restarted
             by the health manager, with no call in between, within
             health_check_period_s x health_check_failures + 1 s. No worker
             may hold a CUDA context: each says CUDA is not initialised
             (torch.cuda.is_initialized(), read in the worker), none is
             listed by nvidia-smi --query-compute-apps, and the card's
             memory in use grows by less than 256 MiB while the workers
             start; the flash forward kernel must launch in (a) and (b).

9. dp      — data-parallel GPT-2 124M across processes (its width at DP_LAYERS,
             6 of its 12 layers: a depth cut for the script's
             time limit; the gang phase runs the same): a TrainController
             drives a MultihostWorkerGroup of 2 processes on the one card
             over gloo (NCCL refuses two ranks on one device); each rank
             runs LMTrainer(mesh_spec=MeshSpec(dp=2)) fed by
             lm_batch_iterator(sharding=data_sharding(mesh)) over the
             global 8 x 1025 batch made with numpy from the seed (4 rows
             each), 10 steps in each of the modes f32 (the implicit sync),
             int8 with error feedback, f32 + dp_shard_update and int8 +
             dp_shard_update (torch_dp_rank.py), against the same 10 steps
             in this process on the whole batch from the same initial
             state. Per mode and rank: the step median, the sync's seconds
             from CUDA events beside JAX's estimate, the bytes the rank's
             collectives moved beside dp_sync_bytes at the rows layout's
             padded size, the peak allocated bytes; the flash kernels'
             launches come back in the ranks' report files. Checks: step
             0's loss within 1e-3 of the one-process loss in every mode,
             f32 + sharded update within 1e-5 of f32 at every step, each
             int8 run's final loss within DP_INT8_FINAL_ATOL of f32's, every
             stage-1 residual at most half its block's step, the bytes
             equal to dp_sync_bytes, 6 x 10 launches of each flash kernel
             per rank and mode; a rank that hangs past the phase's timeout
             fails it. Two ranks on one card measure correctness and the
             sync's cost over this transport, not scaling.
   gang    — a training gang hosted by the cluster (A6b) that survives a
             preemption and a node kill: this process is the head
             (num_gpus=0), 4 node agents share the card (2 CPUs, 1 GPU and
             {"gang": 1} each, heartbeat 0.2 s, staleness 2 s, a 15 s
             preemption window, each armed with RAY_TPU_CHAOS
             "kill_node=1,name_filter=chaos-kill,max_injections=1"). A
             STRICT_SPREAD group of 2 bundles {CPU 1, GPU 1, gang 1}
             (max_reschedules=2) is shared by the attempts of a
             TrainController over ClusterWorkerGroup(2) (gloo, the
             process-group timeout 120 s, FailureConfig(max_failures=1)),
             each rank a process actor on its bundle's agent running
             torch_cluster_udfs.gang_lm: the dp phase's f32 rank program
             (GPT-2 124M, the same 8 x 1025 batch, 10 steps, its optimizer),
             a checkpoint every 2 steps, a 1 s pause after each step so the
             drills land mid-run. (a) the bundles on two agents, each rank
             a child of its bundle's agent, the time to form the gang;
             (b) after two steps, SIGTERM to rank 1's agent: the head's
             scheduler marks it draining, the controller takes an
             emergency checkpoint inside the window and restarts the gang
             off the node once its bundle has moved (num_preempt_restarts
             1, num_restarts 0), the first resumed step the checkpoint's +
             1; (c) a task named chaos-kill pinned to rank 0's agent kills
             it: the group goes RESCHEDULING, then RESERVED on the last
             spare agent, the gang re-forms and resumes after the latest
             checkpoint (num_restarts 1); (d) step 0 within 1e-3 of the dp
             phase's one-process reference, every step (undisturbed and
             resumed) within 1e-5 of the dp phase's f32 losses, the run
             FINISHED, K1 and K2 launched by both ranks; (e) no agent and
             no member left in the process table or among the card's
             compute apps after Cluster.shutdown(). The time from the
             signal to the resumed first step, from the kill to RESERVED
             and to the resumed first step, and the group's state
             transitions are printed; a failure prints the agents' logs.
10. fsdp_tp — FSDP and tensor-parallel training over gloo ranks that
             share the card (torch_fsdp_tp_rank.py), each mode against the
             same steps in this process on the whole batch from the same
             seeded weights (run and freed before the ranks start): (a)
             GPT-2 124M at f32 compute on 4 ranks, MeshSpec(fsdp=2, tp=2)
             with override_rules(default_rules(), vocab=None) (50257 does
             not divide by 2), make_train_step on each rank's 4 rows, then
             the sharded state checkpointed and restored bitwise; (a2) a
             bare LMTrainer on GPT-2 124M (bf16) in a gang of 2, JAX's
             default mesh fsdp=2, fed the global batch; (b) Llama-3-8B's
             full width at FSDP_TP_LLAMA_LAYERS layers (bf16) on 2 ranks,
             MeshSpec(tp=2), default rules: the vocab-parallel embedding
             and loss and 4 of 8 kv heads per rank. FSDP_TP_STEPS steps a
             mode, a fresh global batch each step drawn from a Zipf law
             (_zipf_tokens); each mode's losses held to the reference's
             at its own tolerance (FSDP_TP_TOL). Before the ranks, the
             flash forward and both backward kernels against their
             plain versions at the tp-local shapes: GPT-2 6 heads x 64
             on 4 rows in bf16 and in f32 (mode (a) runs the f32
             kernels), Llama 16 / 4 heads x 128 in bf16. Per step and
             rank: the wall to a device synchronisation split into
             compute and the
             collectives (CUDA events: fsdp_gather, fsdp_scatter,
             tp_allreduce, fsdp_sync / dp_sync, metrics), peak allocated
             bytes; every mode must launch each flash kernel.
11. a7     — sequence, expert and pipeline parallelism over gloo ranks that
             share the card (torch_a7_rank.py, one gang of 2 running each
             part in turn), then ViT in this process:
             (s) sp = 2 at Llama-3-8B's attention width (B 1, GQA 32/8,
             S 8192, D 128, bf16, causal): ring_attention (fused: its
             blocks through the flash forward kernel, rank r launching it
             exactly r + 1 times) and ulysses_attention, each rank's
             output against the flash forward kernel over the whole
             sequence and against mha_reference in f32 (KERNEL_TOL),
             their gradients (the ring's through its plain body,
             Ulysses' through the backward kernels) against
             flash_attention's over the whole sequence (A7_GRAD_REL,
             relative norm); the first ring call, which pays gloo's
             set-up on the new group, timed apart;
             (e) ep = 2: the MoE model at Mixtral-8x7B's width, 2 layers,
             bf16 compute over f32 weights, batch 2 x 1024: moe_loss and
             its gradient against one process holding all 8 experts (the
             loss; each gradient leaf's norm and dot with its parameter,
             per expert), the expert bytes a rank;
             (p) pp = 2: Llama-3-8B's width at 2 layers (1 a stage),
             f32 masters with bf16 compute, batch 4 x 1024 in 4
             microbatches, 2 steps under GPipe and under 1F1B from the
             same state against one process's make_train_step (relative
             FSDP_TP_TOL["b"]) and against each other (A7_PP_SCHEDULE_ATOL,
             the dry run's bound), each schedule's peak memory;
             (v) ViT-B/16 at batch 32 (S 197, D 64, non-causal): the
             forward and a gradient through the kernels against the plain
             attention path (the train phase's gradient bounds), one
             launch of each flash kernel a layer. The kernels phase holds
             the flash forward and backward at causal=False at ViT's shape
             and at a ring block's.
   capacity — cluster mode's capacity plane, jobs, launcher and DCN on
             GPT-2 124M at full width and depth: (a) JAX's spot-fleet
             capstone with real work: a CapacityAutoscaler over a
             SpotNodeProvider(FakeNodeProvider) with JAX's node types
             spot-train {CPU 1, trainer 1} and spot-serve {CPU 2,
             serve_slot 2}; a deployment of 2 paged bf16 LLMServer
             replicas (resources_per_replica {CPU 1, serve_slot 1}) and a
             TrainController gang of 2 thread ranks ({CPU 1, trainer 1},
             max_failures 0), each rank training on batches made from the
             seed, its rank and the step, rank 0 checkpointing the model
             and optimizer state through train.report(checkpoint=...) every
             CAP_CKPT_EVERY steps; a client calls the deployment one request
             at a time; once rank 0 reported step CAP_PREEMPT_AT,
             preempt_after reclaims a node hosting a gang bundle with a
             CAP_WARNING_S warning. JAX's checks (the fleet exists by demand,
             scale-ups for pg and task; preempt.announced <=
             autoscaler.replace (replace, spot-train, spot) <= node.dead;
             FINISHED with one preemption restart and no failure restart;
             only typed errors; 2 replicas live; goodput sums to the wall
             within 5 %; the autoscaler's series in /metrics), and the
             port's: every call's tokens equal its prompt's first, each
             resumed rank's restored state equals the checkpoint bit for
             bit, finite losses. (b) init(head=True, num_gpus=0) with a
             LocalProcessNodeProvider and node types gpu1 {CPU 1, GPU 1},
             cpu2 {CPU 2}: a num_gpus=1 task brings up a gpu1 agent that
             runs the flash forward kernel (held against the plain
             version), a num_cpus=2 task a cpu2 agent that advertises no GPU
             and holds no CUDA context (nvidia-smi's compute apps); 2
             scale-ups, then both agents reaped once idle, no agent
             process left. (c) DCN inside (b)'s cluster: GPT-2 124M's f32
             train state on the card replicated to the gpu1 agent
             (replicate_async must return in 50 ms), then at once 2
             optimizer steps in place: fetch_replica on the agent returns
             the state at the call bit for bit (leaf digests); an int8
             replica's wire bytes under 0.45 of the raw and every float
             leaf's largest error under 0.005 of its largest magnitude,
             the other leaves exact (JAX's bounds); the push's GB/s and a
             step's time with and without the pushes in flight printed.
             (d) launcher.ClusterLauncher brings up a head (num_gpus 0)
             and a worker (num_gpus 1) from a JSON config with a token and a
             launch tag; jobs.JobManager runs torch_capacity_job.py, which
             joins the cluster and runs the flash forward kernel on the
             worker (SUCCEEDED, its log holds the result), and stops a
             sleeping job (STOPPED); after `down` no process carries the
             tag.

The line before the last lists every kernel with its launches on the main
paths (serve: phases 4-5; spec; dense; overload; deploy; observe; tp_serve: the
tp engines' runs and the checks' dense forwards; cluster: the agent's serve
run and dense check, counted in the agent; head_restart: the agent's serve
calls and dense checks through both head deaths, counted in the agent;
train: phase 6;
trainer: phase 7's 20-step run; ingest: phase 8's gang-fed fit; process:
the process phase's (a) and (b); dp: phase 9's ranks, all modes; gang: the
gang phase's ranks over its three attempts; fsdp_tp: phase 10's ranks, all modes, also
split by mode as fsdp_tp_launches_by_mode: (a) f32, (a2) and (b) bf16;
a7: phase 11's ranks and ViT, also split by part as a7_launches_by_part;
capacity: (a)'s replicas (engine replays + wrapper launches) and ranks,
(b)'s and (d)'s flash forward in the agent and the job's worker (counted
there and returned), (c)'s train steps;
each counted from zero just before it, profiled repeats, first calls
and references left out), its error against the plain version and its
times; the last line is {"ok": true, "device": {...}}. Needs one CUDA
device.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import count_params, forward, get_config, init_params
from ray_tpu_torch.ops import (
    FLASH_BWD_DKV,
    FLASH_BWD_DQ,
    FLASH_FWD,
    KERNELS,
    RAGGED,
    ragged_paged_attention,
)
from ray_tpu_torch.ops._build import build_all, sass_counts
from ray_tpu_torch.ops.attention import (
    _DTYPE_CODES,
    _LOG2E,
    _delta,
    _flash_bwd_cuda,
    _flash_bwd_plain,
    _flash_fwd_cuda,
    _flash_fwd_plain,
    flash_attention_with_lse,
)
from ray_tpu_torch.ops.ragged_paged_attention import (
    LAUNCHES_BY_KIND,
    _ragged_cuda,
    ragged_reference_attention,
)
import ray_tpu_torch
import torch_cluster_udfs as cluster_udfs
import torch_process_udfs as udfs
from ray_tpu_torch import serve
from ray_tpu_torch.core.config import cfg
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.core.exceptions import BackPressureError, RequestTimeoutError
from ray_tpu_torch.models.transformer import decode_step
from ray_tpu_torch.serve import tenancy
from ray_tpu_torch.serve.llm import (
    EngineConfig,
    LLMEngine,
    LLMServer,
    OpenAIFrontend,
    build_llm_app,
    PagedConfig,
    PagedEngineConfig,
    PagedLLMEngine,
)
from ray_tpu_torch.serve.llm.speculative import (
    DraftModelProposer,
    ReplayProposer,
    accept_speculative,
)
from ray_tpu_torch.core import object_store as store_mod
from ray_tpu_torch.core.native_store import build_error, native_available
from ray_tpu_torch.core.worker_pool import get_worker_pool
from ray_tpu_torch.data import DataContext, from_numpy, lm_batch_iterator, read_npy
from ray_tpu_torch.parallel import MeshSpec, build_mesh, dp_sync_bytes
from ray_tpu_torch.serve.llm.paged import copy_page
from ray_tpu_torch.train import (
    CheckpointConfig,
    CheckpointManager,
    LMTrainer,
    create_train_state,
    default_optimizer,
    global_norm,
    loss_and_grads,
    make_train_step,
    steplog,
    tree_leaves,
)

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 FMA
SEED = 0
MODEL = "llama3-8b"
N_REQUESTS = 8
MAX_TOKENS = 32
# The dense check: every engine token within CHECK_MARGIN of the dense
# argmax, and at least EXACT_SHARE_FLOOR of the checked positions equal to
# it; positions over TAIL_GAP are counted and printed. The margin is set
# from the serve path's measured bf16 tail: over 960 positions of the
# untouched serve engine its greedy tokens reach 0.3125 below the dense
# argmax with the ragged kernels, and 0.25 with their plain version, p in
# f32 (torch_check_tail.py); three earlier full runs on the H100 failed
# the former 0.25 margin at 0.28125 of 64 positions with no serve code
# changed. 0.5 is 16 bf16 ulps at |logit| 4-8; a corrupt KV or a wrong
# resume puts tokens whole units below. A tail that grew past it while
# tokens stayed near the argmax would still fail the floor: the recorded
# runs (PERF.md) show 49-51 of 64 positions exact (0.77-0.80), and a
# wrong path matches the argmax at far fewer.
TAIL_GAP = 0.25
CHECK_MARGIN = 2 * TAIL_GAP
EXACT_SHARE_FLOOR = 0.6
# The overload phase checks every position of every stream it finished
# (~5000, lanes of 256 new tokens past 512-token prompts) at the margin
# alone: the records hold no exact share for such lanes.
OVERLOAD_CHECK_MARGIN = CHECK_MARGIN
# The deploy phase's requests arrive through the handle's threads, so the
# engine's batches (and with them the bf16 rounding of each position) vary
# from run to run: one H100 run of three put a checked position of
# deployment A at 0.28125, inside the serve path's own tail above.
DEPLOY_CHECK_MARGIN = CHECK_MARGIN
PROFILED_REPEATS = 3  # serve: profiled repeats to find one without dropped records
SPEC_TOKENS = 4  # drafts per verify round in the spec phase
PREFIX_TOKENS = 512  # the spec phase's shared prefix: 8 pages of 64
DRAFT_LAYERS, DRAFT_WINDOW = 2, 64  # the draft model: a 2-layer cut of the target
DENSE_MAX_SEQ = 1024  # the dense engine's cache per slot: the serve prompts + 32 new fit
OVERLOAD_SLOTS = 4
# the overload drills at Llama-3-8B's width and a quarter of its depth: the
# phase's timings (priority-1 TTFT, sheds, deadlines, preemption) ride the
# pool's pages and the lanes' tokens, not the layers, and a full-depth run
# (139 s on a slow host) held the script near its time limit
OVERLOAD_LAYERS = 8
OVERLOAD_LOW_TOKENS, OVERLOAD_HIGH_TOKENS = 256, 32
# 4 lanes of 512 + 256 tokens hold 12 pages of 64 each at the end: 48 of the
# 50 allocatable; a resumed lane's chunk-aligned re-prefill needs at most 12
OVERLOAD_PAGES = 51
DEADLINE_S = 0.2
DEPLOY_PUT_BYTES = 1 << 30  # the CUDA tensor the deploy phase puts into the store
DEPLOY_HTTP_TOKENS = 16
DEPLOY_B_REQUESTS = 16  # deployment B: 2 dense replicas x 8 slots
CLUSTER_CPU_BYTES = 1 << 30  # the CPU tensor an agent task returns
CLUSTER_CUDA_NUMEL = 128 << 20  # the CUDA tensor it returns: 256 MiB of bf16
CLUSTER_CALLS = 200  # no-op actor calls timed one after another
CLUSTER_LAYERS = 8  # the agent's Llama-3-8B: its width, 8 of 32 layers (a depth cut)
TRAIN_MODEL = "gpt2-small"
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS = 20
TRAIN_WARMUP = 2  # steps left out of the step-time median
TRAIN_LR = 1e-3
# last loss < LOSS_MARGIN x first. The batch is 8192 uniform draws from
# 50257 ids (about 7.6 k distinct), so a model that has learnt only the
# batch's unigram distribution sits at ln(7.6 k) ~ 8.9 = 0.82 x ln(50257);
# going lower means memorizing by position and context, which takes far
# more than TRAIN_STEPS steps (the JAX package's tiny-vocab overfit test
# asks for 0.7x in 30). 0.85 asks for most of the way to that floor.
LOSS_MARGIN = 0.85
GRAD_CHECK_BATCH, GRAD_CHECK_SEQ = 2, 512
TRAINER_CKPT_EVERY = 10
TRAINER_REPORT_EVERY = 5
TRAINER_SAMPLE_EVERY = 5
TRAINER_RESUME_FROM, TRAINER_RESUME_STEPS = 10, 5  # a restored trainer redoes steps 11-15
# kernel path vs attn_impl="xla" gradients in bf16 compute (see _grad_check)
GRAD_TOL_NORM = 0.01  # relative difference of the global norms
GRAD_TOL_DIFF = 0.05  # ||g_kernel - g_xla|| / ||g_xla|| over all leaves
GRAD_TOL_LEAF = 0.10  # the same per leaf, for leaves that hold >= 1e-3 of the norm
LLAMA_HEADS = (32, 8)  # Llama-3-8B's query and kv heads
TP = 2  # the tp_serve phase's shards, both on the one card
TP_LOCAL_HEADS = (LLAMA_HEADS[0] // TP, LLAMA_HEADS[1] // TP)
TP_F32_LAYERS = 2  # (t2), (t3): Llama-3-8B's width at 2 layers in f32
# (t2), (t3): tp = 2's greedy tokens equal tp = 1's; at the first position
# where a request differs, tp = 1's dense f32 logits must have their top two
# within this (a near-tie, which f32 sums split over the shards may flip)
TP_NEAR_TIE = 1e-4
FLASH_SHAPES = {  # (B, Hq, Hkv, S, D)
    "gpt2": (TRAIN_BATCH, 12, 12, TRAIN_SEQ, 64),
    "llama": (1, 32, 8, 931, 128),
    "draft": (1, 32, 8, 64, 128),  # the spec phase's draft-model prefill (window 64)
    # the dense engine's prefill buckets: 16 and 32 rows are under one tile
    "bucket16": (1, 32, 8, 16, 128),
    "bucket32": (1, 32, 8, 32, 128),
    "bucket1024": (1, 32, 8, 1024, 128),
}
REPLACES = {
    "ragged_paged_attention": "ray_tpu/ops/ragged_paged_attention.py:60",
    "flash_attention_fwd": "ray_tpu/ops/attention.py:83",
    "flash_attention_bwd_dkv": "ray_tpu/ops/attention.py:215",
    "flash_attention_bwd_dq": "ray_tpu/ops/attention.py:274",
}
SOURCES = {
    "ragged_paged_attention": "ray_tpu_torch/ops/csrc/ragged_paged_attention.cu",
    "flash_attention_fwd": "ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
    "flash_attention_bwd_dkv": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq": "ray_tpu_torch/ops/csrc/flash_attention_bwd.cu",
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


# ----------------------------------------------------------------- timing


class _Timer:
    """Per-launch CUDA-event timing with the L2 cache flushed before each
    launch (the serving path reads different pages every layer, so a warm
    50 MB L2 would flatter the kernels). A 2 ms device-side sleep before
    the start event lets the host enqueue the whole call while the card is
    still busy, so a call that dispatches many kernels (autograd's
    backward, a plain version) is timed on the device, not on the host."""

    SLEEP_CYCLES = 4_000_000  # about 2 ms at the H100's ~2 GHz

    def __init__(self):
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phases


def phase_env() -> str:
    t0 = time.perf_counter()
    nvcc = _run(["nvcc", "--version"]).splitlines()[-1]
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc} ({time.perf_counter() - t0:.2f} s)")
    print(card.splitlines()[0], flush=True)
    return card.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = build_all(KERNELS)
    for k in KERNELS:
        text = logs.get(k.name, k.build_log)
        regs = [int(w) for line in text.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split("bytes spill stores")[0].split()[-1])
                     for line in text.splitlines() if "bytes spill stores" in line)
        log("build", f"{k.name}: built={k.built} instances={len(regs)} "
            f"max_registers={max(regs) if regs else 'n/a'} spill_store_bytes={spills}")
    log("build", f"done ({time.perf_counter() - t0:.2f} s)")
    _check_sass()


SASS_OPS = ("HGMMA", "LDGSTS", "UTMALDG")


def _kernel_name(fn: str) -> str:
    """flash_fwd_wgmmaILi64E -> flash_fwd_wgmma<64>, ragged_wgmmaILi128ELb1E ->
    ragged_wgmma<128,1> (demangled template arguments, ints and bools). The
    kernel's name is the flash_ / ragged_ identifier whose mangled length
    prefix matches it (the anonymous namespace's own name holds the file's)."""
    for m in re.finditer(r"(\d+)((?:flash|ragged)_[A-Za-z0-9_]+?)I", fn):
        digits, name = m.group(1), m.group(2)
        for k in range(len(digits)):  # the length prefix is the digits' tail
            if int(digits[k:]) == len(name) and digits[k] != "0":
                args = fn[m.end():].split("EEEv", 1)[0]
                vals = re.findall(r"L[a-z](\d+)", args)
                return name + (f"<{','.join(vals)}>" if vals else "")
    return fn


def _check_sass() -> None:
    """wgmma and asynchronous copies in the SASS of each instance of the
    flash forward and backward kernels and of the ragged kernels. The bf16
    instances of the main paths must run their products on wgmma, and the
    bf16 ragged main kernels (the tile kernel and the split decode walk,
    `ragged_wgmma<D,split>`) must also load through asynchronous copies;
    the f32 instances must not use wgmma (TF32). The ragged combine pass
    reads each f32 partial once and has nothing to overlap: its counts are
    printed, not held."""
    wrong = []
    for kernel in (FLASH_FWD, FLASH_BWD_DKV, RAGGED):  # one kernel per source
        for fn, counts in sass_counts(kernel, SASS_OPS).items():
            kind = "bf16" if "bfloat16" in fn else "f32"
            name = _kernel_name(fn)
            log("build", f"sass {name} ({kind}): " + " ".join(f"{op}={n}" for op, n in counts.items()))
            if "combine" in name:
                continue
            copies = counts["LDGSTS"] + counts["UTMALDG"]
            if (kind == "bf16") != (counts["HGMMA"] > 0) or (
                    kind == "bf16" and name.startswith("ragged") and copies == 0):
                wrong.append(name)
    if wrong:
        raise AssertionError("bf16 instances without wgmma (HGMMA) or, ragged, without "
                             f"asynchronous copies; or f32 ones with wgmma: {wrong}")


def _ragged_case(dtype, gen, heads=LLAMA_HEADS):
    """A mixed batch at the serving path's Llama-3-8B shapes: prefill chunks
    (one fresh, one at offset 256, one partial at offset 512), decode lanes
    (one on a page boundary), a verify-shaped region (q_len 4) and an
    inactive lane, against the full 32-layer flat pool with layer 7's page
    offset folded into the tables. Unused table entries are scratch page 0.
    `heads` (Hq, Hkv): a tp shard's are TP_LOCAL_HEADS."""
    chunk_blocks = 256 // 8
    return _ragged_batch(dtype, gen, q_lens=[256, 256, 100, 1, 1, 1, 4, 0],
                         kv_lens=[256, 512, 612, 301, 901, 64, 704, 0],
                         counts=[chunk_blocks] * 3 + [1] * 5, max_q_blocks=chunk_blocks,
                         heads=heads)


def _ragged_decode_case(dtype, gen, heads=LLAMA_HEADS):
    """A decode step of the serve run (89% of its ragged launches): 8 lanes
    of q_len 1 at the serve prompts' lengths + 16 (mid-way through the
    first K = 16 decode block), block_q 8, max_q_blocks 1, as
    `paged_attention` dispatches it."""
    return _ragged_batch(dtype, gen, q_lens=[1] * 8,
                         kv_lens=[80, 199, 318, 438, 557, 677, 796, 916],
                         counts=[1] * 8, max_q_blocks=1, heads=heads)


def _ragged_verify_case(dtype, gen):
    """A decode-only verify tick of the spec phase: bucket 1's inactive
    256-row prefill lane and 8 lanes of q_len 5 (the pending token and 4
    drafts) at the serve prompts' lengths + 16, max_q_blocks 32: the tile
    kernel, as `ragged_mixed_step` dispatches a verify pass."""
    return _ragged_batch(dtype, gen, q_lens=[0] + [5] * 8,
                         kv_lens=[0, 85, 204, 323, 443, 562, 682, 801, 921],
                         counts=[256 // 8] + [1] * 8, max_q_blocks=256 // 8)


def _ragged_batch(dtype, gen, q_lens, kv_lens, counts, max_q_blocks, heads=LLAMA_HEADS):
    """Inputs of one ragged call against the full 32-layer Llama-3-8B pool
    (layer 7's page offset folded into the tables) at `heads` (Hq, Hkv),
    with the bytes it must move (q's real rows, every output row of the
    regions, the pages of each lane's walk, the descriptors; q's padding
    rows are left out, since no output depends on them) and the flops of
    its unmasked (query, key) pairs."""
    (hq, hkv), d, ps, maxp, bq, num_pages, layers = heads, 128, 64, 16, 8, 256, 32
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    t = int(sum(counts)) * bq
    tables = np.zeros((len(q_lens), maxp), np.int32)
    nxt = 1
    for s, kl in enumerate(kv_lens):
        for j in range(-(-kl // ps)):
            tables[s, j] = 7 * num_pages + nxt
            nxt += 1
    pool = (hkv, layers * num_pages, ps, d)
    k_pages = torch.randn(pool, generator=gen, device="cuda", dtype=dtype)
    v_pages = torch.randn(pool, generator=gen, device="cuda", dtype=dtype)
    q = torch.randn((hq, t, d), generator=gen, device="cuda", dtype=dtype)
    as_i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32, device="cuda")  # noqa: E731
    desc = [as_i32(x) for x in (starts, counts, q_lens, kv_lens, tables)]
    es = q.element_size()
    pages_read = sum(-(-kl // ps) for kl in kv_lens)
    q_bytes = sum(q_lens) * hq * d * es
    nbytes = q_bytes + q.numel() * es + 2 * pages_read * hkv * ps * d * es + sum(x.numel() * 4 for x in desc)
    keys = sum(kl - ql + r + 1 for ql, kl in zip(q_lens, kv_lens) for r in range(ql))
    flops = 4.0 * hq * d * keys
    return q, k_pages, v_pages, desc, dict(block_q=bq, max_q_blocks=max_q_blocks), nbytes, flops


# Each kernel against its plain version: (atol, rtol, why).
KERNEL_TOL = {
    torch.bfloat16: (2e-2, 2e-2, "the bf16 kernels round p to bf16 before P.V (the "
                     "flash kernels too), the plain versions keep p in f32: a relative "
                     "error of up to 2^-9 in each weight, which with f32 sums in another "
                     "order moves an output by up to about one bf16 ulp (2^-6 at "
                     "|x| in [2, 4)) against atol + rtol |x|"),
    torch.float32: (1e-4, 1e-4, "f32 sums over up to 1024 keys in another order"),
}


def phase_kernels(timer: _Timer) -> dict:
    """Each kernel against its plain version on the same inputs. Returns the
    bf16 (serving dtype) numbers per kernel for the final line."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol, why = KERNEL_TOL[dtype]
        # ---- ragged paged attention: a mixed tick's batch, a decode
        # step's, a decode-only verify tick's
        ragged = {label: _ragged_checks(timer, dtype, gen, label, make, atol, rtol, why)
                  for label, make in (("mixed", _ragged_case), ("decode", _ragged_decode_case),
                                      ("verify", _ragged_verify_case))}
        if dtype == torch.bfloat16:
            # a tp = 2 shard's heads, as the tp_serve phase launches them
            for label, make in (("mixed", _ragged_case), ("decode", _ragged_decode_case)):
                ragged[f"tp_{label}"] = _ragged_checks(
                    timer, dtype, gen, f"tp_{label} (Hq {TP_LOCAL_HEADS[0]}, Hkv "
                    f"{TP_LOCAL_HEADS[1]})", lambda d, g, m=make: m(d, g, heads=TP_LOCAL_HEADS),
                    atol, rtol, why)
            results["ragged_paged_attention"] = dict(
                ragged["mixed"], **{f"{label}_{k}": v
                                    for label in ("decode", "verify", "tp_mixed", "tp_decode")
                                    for k, v in ragged[label].items()})
        torch.cuda.empty_cache()
        # ---- flash forward and both backward kernels, at the dense check's
        # shape and at the train path's
        fwd = {(label, causal): _fwd_checks(timer, dtype, gen, label, causal, atol, rtol)
               for label, causal in (("llama", True), ("llama", False), ("gpt2", True),
                                     ("draft", True), ("bucket16", True), ("bucket32", True),
                                     ("bucket1024", True))}
        for label in ("gpt2", "llama"):
            bwd = _bwd_checks(timer, dtype, gen, label, FLASH_SHAPES[label], atol, rtol)
            if dtype == torch.bfloat16 and label == "gpt2":
                results.update(bwd)
        if dtype == torch.bfloat16:
            # the a7 phase's non-causal launches: ViT-B/16's encoder and a past
            # ring block at Llama-3-8B's width (GQA repeated before the ring)
            for label in ("vit", "ring_block"):
                fwd[label, False] = _fwd_checks(timer, dtype, gen, label, False, atol, rtol)
                bwd = _bwd_checks(timer, dtype, gen, label, FLASH_SHAPES[label], atol, rtol,
                                  causal=False)
                for name, check in bwd.items():
                    results[name][f"{label}_noncausal_shape"] = check
            results["flash_attention_fwd"] = dict(
                fwd["llama", True], train_shape=fwd["gpt2", True], draft_shape=fwd["draft", True],
                **{f"dense_prefill_{label}": fwd[label, True]
                   for label in ("bucket16", "bucket32", "bucket1024")},
                **{f"{label}_noncausal_shape": fwd[label, False] for label in ("vit", "ring_block")})
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    log("kernels", f"done ({time.perf_counter() - t0:.2f} s)")
    return results


def _ragged_checks(timer, dtype, gen, label, make, atol, rtol, why) -> dict:
    """The ragged kernels on one batch against ragged_reference_attention
    (on q scaled and rounded beforehand, as the dispatcher does for the
    plain version), with where the largest error sits (`_ragged_worst`),
    against their own second run (bitwise: each output row has one owner,
    the split partials combine in a fixed order) and against the kernels
    on the pre-scaled q with scale 1 (bitwise: the kernels' own scaling of
    q rounds exactly as the dispatcher's); times of the wrapper
    (`_ragged_cuda`: the zeroed output, the workspace, the kernels) and of
    the plain version; the ragged device kernels one call runs, read from
    the profiler."""
    q, kp, vp, desc, kw, nbytes, flops = make(dtype, gen)
    sm_scale = 1.0 / np.sqrt(q.shape[-1])
    q_scaled = (q.float() * sm_scale).to(dtype)
    out = ragged_paged_attention(q, kp, vp, *desc, **kw)
    again = _ragged_cuda(q, kp, vp, *desc, sm_scale=sm_scale, **kw)
    prescaled = _ragged_cuda(q_scaled, kp, vp, *desc, sm_scale=1.0, **kw)
    ref = ragged_reference_attention(q_scaled, kp, vp, *desc, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(out).all())
    worst = _ragged_worst(out, ref, desc, kw["block_q"], atol, rtol)
    deterministic, same_scaling = torch.equal(out, again), torch.equal(out, prescaled)
    del again, prescaled, ref
    ms = timer.ms(lambda: _ragged_cuda(q, kp, vp, *desc, sm_scale=sm_scale, **kw), 20)
    plain_ms = timer.ms(lambda: ragged_reference_attention(q_scaled, kp, vp, *desc, **kw), 3)
    bound, bound_by = _bound_ms(nbytes, flops, dtype)
    per_call = _device_kernels(lambda: _ragged_cuda(q, kp, vp, *desc, sm_scale=sm_scale, **kw))
    name = str(dtype).replace("torch.", "")
    log("kernels", f"ragged_paged_attention {name} {label} (S={desc[0].numel()} "
        f"max_q_blocks={kw['max_q_blocks']}; device kernels a call: {', '.join(per_call)}): "
        f"max_abs_err={err:.3e} atol={atol} rtol={rtol} ({why}) kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.4f} ({bound_by}, {nbytes} bytes) library_ms=null "
        f"deterministic={deterministic} scaled_in_kernel_bitwise={same_scaling}")
    log("kernels", f"ragged_paged_attention {name} {label} largest errors: {worst}")
    if not ok:
        raise AssertionError(f"ragged kernels disagree with their plain version ({name} {label})")
    if not deterministic:
        raise AssertionError(f"ragged kernels: two runs differ ({name} {label})")
    if not same_scaling:
        raise AssertionError(f"ragged kernels: q scaled in the kernel differs from q scaled "
                             f"beforehand ({name} {label})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=None, device_kernels_per_call=len(per_call))


def _ragged_worst(out, ref, desc, block_q, atol, rtol) -> str:
    """The largest error over the real rows and over the padding rows of
    the regions: its place (head, lane, region row, column), |ref| there,
    and the largest ratio of error to allclose's allowance atol + rtol
    |ref| (1 would fail)."""
    starts, counts, q_lens = (x.tolist() for x in desc[:3])
    t = out.shape[1]
    lane_of = np.full(t, -1)
    row_of = np.zeros(t, np.int64)
    for s, (st, ct) in enumerate(zip(starts, counts)):
        lane_of[st * block_q:(st + ct) * block_q] = s
        row_of[st * block_q:(st + ct) * block_q] = np.arange(ct * block_q)
    real = torch.tensor((lane_of >= 0) & (row_of < np.array(q_lens)[lane_of]), device=out.device)
    pad = torch.tensor(lane_of >= 0, device=out.device) & ~real
    diff = (out.float() - ref.float()).abs()
    ratio = diff / (atol + rtol * ref.float().abs())
    parts = []
    for kind, rows in (("real rows", real), ("padding rows", pad)):
        if not bool(rows.any()):
            continue
        masked = torch.where(rows[None, :, None], diff, -1.0)
        h, tok, col = np.unravel_index(int(masked.argmax()), tuple(diff.shape))
        parts.append(f"{kind} {diff[h, tok, col].item():.3e} at head {h} lane {lane_of[tok]} row "
                     f"{row_of[tok]} column {col}, |ref| {ref[h, tok, col].float().abs().item():.4f}, "
                     f"largest error / allowance "
                     f"{torch.where(rows[None, :, None], ratio, 0.0).max().item():.3f}")
    return "; ".join(parts)


def _device_kernels(fn) -> list:
    """Names of the ragged device kernels that one call of `fn` runs, in
    order, from a profile of that call alone."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA and "ragged" in e.name]
    return [_ragged_name(e.name) for e in sorted(kernels, key=lambda e: e.time_range.start)]


def _device_events(prof) -> list:
    """A profile's raw Kineto events on the card (kernels and copies)."""
    return [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]


def _ragged_name(name: str) -> str:
    """`ragged_wgmma<128,true>` from a profiler event's kernel name,
    demangled or mangled."""
    plain = re.search(r"ragged_[a-z_]+<[^>]*>", name)
    return plain.group(0).replace(" ", "") if plain else _kernel_name(name)


def _sdpa(q, k, v, causal):
    """One PyTorch call computing the flash function: the library yardstick,
    timed here and never called by the port."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    kx = torch.repeat_interleave(k, q.shape[1] // k.shape[1], dim=1)
    vx = torch.repeat_interleave(v, q.shape[1] // v.shape[1], dim=1)
    return F.scaled_dot_product_attention(q, kx, vx, is_causal=causal)


def _qkv(dtype, gen, shape):
    b, hq, hkv, s, d = shape
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda", dtype=dtype)
    return q, k, v


def _qkv_do(dtype, gen, shape):
    q, k, v = _qkv(dtype, gen, shape)
    return q, k, v, torch.randn(q.shape, generator=gen, device="cuda", dtype=dtype)


def _fwd_launcher(q, k, v, causal, scale, launch=FLASH_FWD.launch):
    """The forward kernel alone on the wrapper's inputs (for its own time);
    `launch` takes the C launch function's arguments. The second item is
    (out, lse), which the launch fills."""
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s, 1), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _DTYPE_CODES[q.dtype], d, b, hq, k.shape[1], s, k.shape[2], int(causal),
            float(scale * _LOG2E), torch.cuda.current_stream().cuda_stream)
    return (lambda: launch(*args)), (out, lse)


def _fwd_checks(timer, dtype, gen, label, causal, atol, rtol) -> dict:
    """The flash forward kernel against _flash_fwd_plain (out and lse) and
    against its own second run (bitwise: one owner block per output row,
    one summing order); times of the bare launch, of the wrapper on
    contiguous tensors and on transposed views as the model's head split
    hands them (the wrapper copies those), of the plain version and of
    SDPA."""
    shape = FLASH_SHAPES[label]
    b, hq, hkv, s, d = shape
    q, k, v = _qkv(dtype, gen, shape)
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = _flash_fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
          and torch.allclose(lse, ref_lse, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(out).all()))
    out2, lse2 = flash_attention_with_lse(q, k, v, causal=causal)
    deterministic = torch.equal(out, out2) and torch.equal(lse, lse2)
    del out2, lse2, ref, ref_lse
    launch, keep = _fwd_launcher(q, k, v, causal, scale)
    ms = timer.ms(launch, 20)
    del keep
    wrapper_ms = timer.ms(lambda: _flash_fwd_cuda(q, k, v, causal, scale), 10)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]  # (B, S, H, D) in memory
    views_ms = timer.ms(lambda: _flash_fwd_cuda(*views, causal, scale), 10)
    del views
    plain_ms = timer.ms(lambda: _flash_fwd_plain(q, k, v, causal, scale), 3)
    lib_ms = timer.ms(lambda: _sdpa(q, k, v, causal), 10)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + b * hq * s * 4
    pairs = s * (s + 1) / 2 if causal else s * s
    bound, bound_by = _bound_ms(nbytes, 4.0 * b * hq * d * pairs, dtype)
    name = str(dtype).replace("torch.", "")
    log("kernels", f"flash_attention_fwd {name} causal={causal} {label} B={b} GQA {hq}/{hkv} S={s} D={d}: "
        f"max_abs_err={err:.3e} lse_err={lse_err:.3e} atol={atol} rtol={rtol} "
        f"(lse 1e-4: f32 on both sides) kernel_ms={ms:.4f} wrapper_ms={wrapper_ms:.4f} "
        f"wrapper_on_views_ms={views_ms:.4f} (three copies) plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.4f} ({bound_by}) library_ms={lib_ms:.4f} (SDPA) deterministic={deterministic}")
    if not ok:
        raise AssertionError(f"flash forward disagrees with its plain version ({name} {label} causal={causal})")
    if not deterministic:
        raise AssertionError(f"flash forward: two runs differ ({name} {label} causal={causal})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms, wrapper_ms=wrapper_ms, wrapper_on_views_ms=views_ms)


def _bwd_costs(shape, es, causal: bool = True) -> dict:
    """(bytes, flops) of the backward: each kernel's own function (dK, dV
    need the S, dP, dV and dK products; dQ needs S, dP and dQ) and the
    whole function (5 products of 2 * D flops per unmasked pair; q, k, v,
    o, dO, dq, dk, dv, lse and delta each moved once)."""
    b, hq, hkv, s, d = shape
    pairs = b * hq * (s * (s + 1) / 2 if causal else s * s)
    q_bytes, kv_bytes, row_bytes = b * hq * s * d * es, b * hkv * s * d * es, b * hq * s * 4
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes  # q, dO, k, v, lse, delta
    return {
        "dkv": (reads + 2 * kv_bytes, 4 * 2.0 * d * pairs),
        "dq": (reads + q_bytes, 3 * 2.0 * d * pairs),
        "both": (reads + 2 * q_bytes + 2 * kv_bytes, 5 * 2.0 * d * pairs),
    }


def _bwd_launchers(q, k, v, out, lse, do, scale, dkv=FLASH_BWD_DKV.launch, dq=FLASH_BWD_DQ.launch,
                   causal: bool = True):
    """Each backward kernel alone on the wrapper's inputs (for its own
    time); `dkv` and `dq` take the C launch functions' arguments. The last
    item keeps delta and the outputs (dq, dk, dv) alive."""
    b, hq, s, d = q.shape
    delta = _delta(do, out)
    dq_out, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    tail = (_DTYPE_CODES[q.dtype], d, b, hq, k.shape[1], s, s, int(causal), float(scale * _LOG2E),
            float(scale), torch.cuda.current_stream().cuda_stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    keep = (delta, dq_out, dk, dv)
    return (lambda: dkv(*ins, dk.data_ptr(), dv.data_ptr(), *tail),
            lambda: dq(*ins, dq_out.data_ptr(), *tail), keep)


def _bwd_checks(timer, dtype, gen, label, shape, atol, rtol, causal: bool = True) -> dict:
    """Both backward kernels against _flash_bwd_plain on the forward
    kernel's own out and lse, and against their own second run (bitwise:
    one owner block per output, no atomics); times of each kernel, of
    delta alone, of the whole wrapper (delta + both launches), of the
    plain version and of SDPA's backward through torch.autograd.grad."""
    b, hq, hkv, s, d = shape
    q, k, v, do = _qkv_do(dtype, gen, shape)
    scale = 1.0 / np.sqrt(d)
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    grads = _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    ref = _flash_bwd_plain(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    errs = {n: (g.float() - r.float()).abs().max().item() for n, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    ok = all(torch.allclose(g.float(), r.float(), atol=atol, rtol=rtol) and bool(torch.isfinite(g).all())
             for g, r in zip(grads, ref))
    again = _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale)
    deterministic = all(torch.equal(a, g) for a, g in zip(again, grads))
    del grads, ref, again
    dkv_fn, dq_fn, keep = _bwd_launchers(q, k, v, out, lse, do, scale, causal=causal)
    ms_dkv = timer.ms(dkv_fn, 10)
    ms_dq = timer.ms(dq_fn, 10)
    ms_all = timer.ms(lambda: _flash_bwd_cuda(q, k, v, out, lse, do, causal, scale), 10)
    ms_delta = timer.ms(lambda: _delta(do, out), 10)
    plain_ms = timer.ms(lambda: _flash_bwd_plain(q, k, v, out, lse, do, causal, scale), 3)
    del keep
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o = _sdpa(qr, kr, vr, causal)
    lib_ms = timer.ms(lambda: torch.autograd.grad(o, (qr, kr, vr), do, retain_graph=True), 10)
    del o, qr, kr, vr
    bounds = {n: _bound_ms(nb, fl, dtype)
              for n, (nb, fl) in _bwd_costs(shape, q.element_size(), causal).items()}
    name = str(dtype).replace("torch.", "")
    log("kernels", f"flash_attention_bwd {name} causal={causal} {label} B={b} GQA {hq}/{hkv} S={s} D={d}: "
        f"max_abs_err dq={errs['dq']:.3e} dk={errs['dk']:.3e} dv={errs['dv']:.3e} "
        f"atol={atol} rtol={rtol} (P and dS rounded to the input dtype at the same places on "
        f"both sides; exp2 and f32 sums may differ in the last bit, which can move one bf16 "
        f"rounding by an ulp) dkv_ms={ms_dkv:.4f} (bound {bounds['dkv'][0]:.4f} "
        f"{bounds['dkv'][1]}) dq_ms={ms_dq:.4f} (bound {bounds['dq'][0]:.4f} {bounds['dq'][1]}) "
        f"wrapper_ms={ms_all:.4f} (bound {bounds['both'][0]:.4f} {bounds['both'][1]}) "
        f"delta_ms={ms_delta:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA backward) "
        f"deterministic={deterministic}")
    if not ok:
        raise AssertionError(f"flash backward kernels disagree with their plain version ({name} "
                             f"{label} causal={causal})")
    if not deterministic:
        raise AssertionError(f"flash backward kernels: two runs differ ({name} {label} "
                             f"causal={causal})")
    common = dict(plain_ms=plain_ms, library_ms=lib_ms, wrapper_ms=ms_all, delta_ms=ms_delta)
    return {
        "flash_attention_bwd_dkv": dict(max_abs_err=max(errs["dk"], errs["dv"]), ms=ms_dkv,
                                        bound_ms=bounds["dkv"][0], bound_by=bounds["dkv"][1], **common),
        "flash_attention_bwd_dq": dict(max_abs_err=errs["dq"], ms=ms_dq, bound_ms=bounds["dq"][0],
                                       bound_by=bounds["dq"][1], **common),
    }


def _serve_run(engine, prompts):
    """Submit every greedy request at once and consume each stream on a
    thread of its own; returns (wall seconds, start time, [(time, token),
    ...] per request, the streams)."""
    stamps = [[] for _ in prompts]
    errors = [None] * len(prompts)
    t_start = time.perf_counter()
    streams = [engine.submit(p, max_tokens=MAX_TOKENS) for p in prompts]
    _join(_consume(streams, stamps, errors))
    if any(errors):
        raise AssertionError(f"a request failed: {errors}")
    return time.perf_counter() - t_start, t_start, stamps, streams


def _consume(streams, outs, errors, firsts=None):
    """One thread per stream: its tokens into outs[i] (time, token), a typed
    error into errors[i]; firsts[i] is set at its first token. Returns the
    threads, started."""
    def consume(i):
        try:
            for token in streams[i]:
                outs[i].append((time.perf_counter(), token))
                if firsts is not None:
                    firsts[i].set()
        except (BackPressureError, RequestTimeoutError) as exc:
            errors[i] = exc
        finally:
            if firsts is not None:
                firsts[i].set()

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(streams))]
    for th in threads:
        th.start()
    return threads


def _join(threads, timeout=600):
    for th in threads:
        th.join(timeout=timeout)
        if th.is_alive():
            raise RuntimeError(f"a request did not finish within {timeout} s")


def _add_launches(path: dict, stats: dict) -> None:
    """Add an engine's `launches.<kernel>` counts (replays x captured) of
    one run to the path's totals."""
    for key, n in stats.items():
        if key.startswith("launches."):
            path[key[len("launches."):]] = path.get(key[len("launches."):], 0) + int(n)


def _stats_delta(engine, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in engine.stats().items()}


def _profiled_ragged_kernels(engine, run) -> tuple:
    """The ragged device kernels of one more run of the same requests, by
    name, read from torch.profiler, the engine's own count for that run
    (replays x captured launches, from `engine.stats()`), and the run's
    wall, device busy time (kernels and copies on the card, as
    torch_serve_profile.py sums them) and sort kernels' time (in a greedy
    run only the accept step sorts)."""
    before = engine.stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = _stats_delta(engine, before)
    seen: dict = {}
    busy_ns = sort_ns = 0
    # the raw Kineto events, one per kernel or copy (key_averages() first
    # parses them all into FunctionEvents, seconds for a run's tens of
    # thousands of graph kernels)
    for e in _device_events(prof):
        busy_ns += e.duration_ns()
        name = e.name()
        if "sort" in name.lower():
            sort_ns += e.duration_ns()
        if "ragged" in name:
            name = _ragged_name(name)
            seen[name] = seen.get(name, 0) + 1
    return seen, counted, dict(wall_s=wall, busy_s=busy_ns / 1e9, sort_s=sort_ns / 1e9)


def _hold_ragged_against_profiler(phase, engine, prompts, run=None, times_out=None) -> dict:
    """Run the requests again under torch.profiler and hold its ragged
    device kernels against the engine's count for that run (replays x
    captured, by kind). The profiler can miss kernel records of a replayed
    graph (one repeat of the H100 runs saw 966 of 1024 decode walks and
    combines) but never sees more than ran: up to PROFILED_REPEATS repeats,
    each printed, and the first whose counts equal the engine's ends the
    check. `run` replaces the run of `prompts` on the engine. Returns the
    profiler's counts of that repeat; `times_out`, when given, receives its
    wall, device busy time and idle share."""
    run = run or (lambda: _serve_run(engine, prompts))
    for attempt in range(1, PROFILED_REPEATS + 1):
        seen, counted, times = _profiled_ragged_kernels(engine, run)
        want = {
            "ragged_wgmma<128,true>": int(counted.get("launches.ragged.decode", 0)),
            "ragged_combine<128>": int(counted.get("launches.ragged.decode", 0)),
            "ragged_wgmma<128,false>": int(counted.get("launches.ragged.mixed", 0)),
        }
        log(phase, f"profiled repeat {attempt}: ragged device kernels from torch.profiler "
            f"{seen}; the engine's count (replays x captured) {want}; wall "
            f"{times['wall_s']:.4f} s, device busy {times['busy_s']:.4f} s, idle share "
            f"{1 - times['busy_s'] / times['wall_s']:.4f}, sort kernels {times['sort_s']:.4f} s, "
            f"verify / decode passes {counted.get('decode_steps', 0):.0f}")
        if set(seen) - set(want) or any(seen.get(k, 0) > n for k, n in want.items()):
            raise AssertionError(f"the profiler saw ragged kernels the engine did not count: {seen}")
        if {k: seen.get(k, 0) for k in want} == want:
            if times_out is not None:
                times_out.update(times, idle_share=1 - times["busy_s"] / times["wall_s"])
            return seen
    raise AssertionError(f"profiled ragged kernels {seen} differ from the engine's count {want} "
                         f"in {PROFILED_REPEATS} repeats")


def phase_serve():
    """Llama-3-8B served through the pipelined engine with every pass
    captured as a CUDA graph up front (precompile). The 8 greedy requests
    run unprofiled (wall, TTFT, decode rate; the main path's launches,
    counted by the engine as replays x the launches each capture
    recorded), then again under torch.profiler, whose ragged device
    kernels must equal the engine's count for that run; then one request
    at temperature 1 with top-k 50 (the filtered decode graph) must stay
    in the vocabulary and differ from its greedy twin."""
    t0 = time.perf_counter()
    config = get_config(MODEL).replace(param_dtype=torch.bfloat16)
    server = LLMServer(
        config, engine_config=PagedEngineConfig(max_slots=N_REQUESTS, precompile=True,
                                                paged=PagedConfig()),
        seed=SEED, device="cuda",
    )
    engine = server.engine
    torch.cuda.synchronize()
    log("serve", f"{MODEL}: {config.n_layers} layers d_model {config.d_model} "
        f"heads {config.n_heads}/{config.kv_heads} vocab {config.vocab_size}, bf16 "
        f"weights from seed {SEED} ({time.perf_counter() - t0:.2f} s)")
    passes = engine.passes()
    log("serve", f"precompile: {len(passes)} CUDA graphs captured in {engine.capture_s:.3f} s ("
        + ", ".join(f"{p.name} {p.capture_s:.3f} s" for p in passes)
        + f"); after capture {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    log("serve", "launches each capture recorded: "
        + "; ".join(f"{p.name} {p.captured}" for p in passes))
    if not all(p.is_captured for p in passes):
        raise AssertionError("precompile left a pass without its graph")
    rng = np.random.default_rng(SEED)
    # one short request first: the eager sampling and the pinned host allocator
    server.generate({"prompt_tokens": [1] * 64, "max_tokens": 2})
    lengths = np.linspace(64, 900, N_REQUESTS).astype(int)
    prompts = [rng.integers(0, config.vocab_size, n).tolist() for n in lengths]
    stats0, drains0 = engine.stats(), len(engine.drain_log)
    for kernel in KERNELS:
        kernel.launches = 0
    for kind in LAUNCHES_BY_KIND:
        LAUNCHES_BY_KIND[kind] = 0
    wall, t_start, stamps, _ = _serve_run(engine, prompts)
    stats = _stats_delta(engine, stats0)
    wrappers = {k.name: k.launches for k in KERNELS}
    outs = [[tok for _, tok in st] for st in stamps]
    for out in outs:
        if len(out) != MAX_TOKENS or not all(0 <= t < config.vocab_size for t in out):
            raise AssertionError(f"bad completion: {len(out)} tokens")
    # the main path's launches: through a wrapper (none: every pass replays
    # a graph) plus the graphs' replays x captured
    serve_counts = {name: n + int(stats.get(f"launches.{name}", 0)) for name, n in wrappers.items()}
    split = {kind: int(stats.get(f"launches.ragged.{kind}", 0)) for kind in LAUNCHES_BY_KIND}
    ttft = [st[0][0] - t_start for st in stamps]
    first_all = min(st[0][0] for st in stamps)
    last_all = max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    runs = {p.name: int(stats[f"passes.{p.name}"]) for p in passes}
    log("serve", f"{N_REQUESTS} requests, prompts {lengths.min()}-{lengths.max()} tokens, "
        f"{MAX_TOKENS} new each: wall {wall:.3f} s, TTFT p50 {statistics.median(ttft):.3f} s "
        f"max {max(ttft):.3f} s, decode {decode_tokens / (last_all - first_all):.1f} tok/s "
        f"(tokens after each request's first, over first-token-to-last-token), "
        f"output {N_REQUESTS * MAX_TOKENS / wall:.1f} tok/s over the wall, mixed ticks "
        f"{stats['mixed_ticks']:.0f}, decode blocks {stats['decode_blocks']:.0f}; graph replays "
        f"{runs}; ragged launches {serve_counts[RAGGED.name]} (mixed ticks {split['mixed']}, "
        f"decode steps {split['decode']}; through the wrapper {wrappers[RAGGED.name]})")
    drains = engine.drain_log[drains0:]
    log("serve", f"drain thread: {len(drains)} reads of {sum(n for n, _ in drains)} entries, "
        f"{sum(t for _, t in drains):.3f} s waiting on the card")
    if wrappers[RAGGED.name]:
        raise AssertionError("a serve pass launched the ragged kernels outside its graph")
    direct = dict(wall_s=wall, ttft_p50_s=statistics.median(ttft), ttft_max_s=max(ttft),
                  decode_tok_s=decode_tokens / (last_all - first_all),
                  output_tok_s=N_REQUESTS * MAX_TOKENS / wall)
    profiled_times: dict = {}
    seen = _hold_ragged_against_profiler("serve", engine, prompts, times_out=profiled_times)
    direct["idle_share"] = profiled_times["idle_share"]
    filtered_before = engine.stats()["passes.decode.filtered"]
    hot = engine.generate(prompts[0], MAX_TOKENS, 1.0, top_k=50)
    differs = sum(a != b for a, b in zip(hot, outs[0]))
    log("serve", f"temperature 1, top-k 50: {len(hot)} tokens, {differs} differ from the greedy "
        f"twin's; filtered decode replays {engine.stats()['passes.decode.filtered'] - filtered_before:.0f}")
    if len(hot) != MAX_TOKENS or not all(0 <= t < config.vocab_size for t in hot) or not differs:
        raise AssertionError("temperature sampling left the vocabulary or repeated the greedy tokens")
    if engine.stats()["passes.decode.filtered"] == filtered_before:
        raise AssertionError("the top-k request never replayed the filtered decode graph")
    return server, config, prompts, outs, split, serve_counts, seen, direct


def phase_check(server, config, prompts, outs) -> tuple:
    """Teacher-forced dense forward (flash kernel) over prompt + generated
    tokens: the engine's token at each generated position must score within
    CHECK_MARGIN of the dense argmax, and at least EXACT_SHARE_FLOOR of the
    positions must equal it. Both paths compute in bf16 but round at
    different places (attention over pages, split at decode, against
    attention over the whole sequence; products of other shapes sum in
    other orders), so near-ties may flip; the margin is set from the
    measured tail of that drift through 32 layers (see CHECK_MARGIN).
    Returns (exact, total, worst gap)."""
    log("check", f"margin {CHECK_MARGIN}, exact share at least {EXACT_SHARE_FLOOR}: bf16 "
        f"logits; paged (split at decode) and dense attention and other product shapes "
        f"round differently")
    return _dense_check("check", server.engine.params, config, prompts, outs)


def _dense_check(phase, params, config, prompts, outs, picks=None, labels=None,
                 margin=CHECK_MARGIN, exact_floor=EXACT_SHARE_FLOOR) -> tuple:
    """phase_check's test on the requests `picks` (default: the first and
    the last), every token within `margin` of the dense argmax and at least
    `exact_floor` of them equal to it; the positions whose gap exceeds
    TAIL_GAP are counted; `labels` (one per request) groups the worst gaps
    in the log, each with the row's largest dense logit and its positions
    over TAIL_GAP. Returns (exact, total, worst gap)."""
    t0 = time.perf_counter()
    before = FLASH_FWD.launches
    picks = picks or [0, len(prompts) - 1]
    stats = cluster_udfs.dense_check_stats(params, config, prompts, outs, picks, TAIL_GAP)
    # label -> [worst gap, (request, generated position), its row's max logit,
    #           positions over TAIL_GAP]
    groups: dict = {}
    if labels is not None:
        for i in picks:
            gap, at, top, over = stats["per"][i]
            g = groups.setdefault(labels[i], [0.0, None, 0.0, 0])
            if gap > g[0]:
                g[0], g[1], g[2] = gap, (i, at), top
            g[3] += over
    return _dense_verdict(phase, stats, FLASH_FWD.launches - before, margin, exact_floor,
                          groups, time.perf_counter() - t0)


def _dense_verdict(phase, stats, launched, margin, exact_floor, groups=None, seconds=0.0):
    """Log a dense check (`torch_cluster_udfs.dense_check_stats`, run here
    or in a node agent) and hold it: flash forward launched, the worst gap
    within `margin`, at least `exact_floor` of the positions exact.
    Returns (exact, total, worst gap)."""
    worst, exact, total = stats["worst"], stats["exact"], stats["total"]
    log(phase, f"dense check (margin {margin}, exact share floor {exact_floor}), "
        f"{len(stats['per'])} requests, {total} generated positions: engine token == dense "
        f"argmax at {exact} (share {exact / total:.4f}), worst gap {worst:.4f}, positions over "
        f"{TAIL_GAP}: {stats['over_tail']}, flash launches {launched} ({seconds:.2f} s)")
    if groups:
        log(phase, "worst gap by group (gap, (request, generated position), the row's max dense "
            f"logit, positions over {TAIL_GAP}): "
            + "; ".join(f"{k} {v[0]:.4f} {v[1]} {v[2]:.3f} {v[3]}" for k, v in groups.items()))
    if launched == 0:
        raise AssertionError("the dense check never launched the flash kernel")
    if worst > margin:
        raise AssertionError(f"engine token scores {worst:.4f} below the dense argmax")
    if exact < exact_floor * total:
        raise AssertionError(f"engine tokens equal the dense argmax at {exact} of {total} "
                             f"positions, under the floor of {exact_floor}")
    return exact, total, worst


def _prefix_prompts(config) -> list:
    """N_REQUESTS prompts that share one PREFIX_TOKENS-token prefix (8
    pages of 64), each with a tail of its own of 64-448 tokens."""
    rng = np.random.default_rng(SEED + 2)
    prefix = rng.integers(0, config.vocab_size, PREFIX_TOKENS).tolist()
    tails = np.linspace(64, 448, N_REQUESTS).astype(int)
    return [prefix + rng.integers(0, config.vocab_size, n).tolist() for n in tails]


def _prefix_run(engine, prompts) -> dict:
    """The first request alone to completion (so that it registers the
    prefix where a cache is on), then the others at once; each request's
    tokens, TTFT and prompt tokens taken from the prefix cache."""
    first = engine.submit(prompts[0], max_tokens=MAX_TOKENS)
    out0 = first.result(timeout=600)
    wall, t_start, stamps, streams = _serve_run(engine, prompts[1:])
    return dict(outs=[out0] + [[tok for _, tok in st] for st in stamps],
                ttft=[first.ttft_s] + [st[0][0] - t_start for st in stamps],
                cached=[first.cached_tokens] + [st.cached_tokens for st in streams], wall=wall)


def _replay_ms(p, iters: int = 20) -> float:
    """Median device time of one replay of pass `p`'s graph over all-zero
    (inactive) inputs, whose writes land in the scratch page; CUDA events
    around each replay. The engine must be idle."""
    for t in p._static.values():
        t.zero_()
    p._graph.replay()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        p._graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _accept_ms(config, iters: int = 20) -> float:
    """Median device time of the accept step alone on one verify round's
    logits (max_slots x (K+1) rows of the vocabulary, bf16), every lane
    active with K drafts, greedy; CUDA events."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    w = SPEC_TOKENS + 1
    logits = torch.randn((N_REQUESTS, w, config.vocab_size), generator=gen, device="cuda",
                         dtype=config.dtype)
    tokens = torch.randint(0, config.vocab_size, (N_REQUESTS, w), generator=gen, device="cuda")
    counts = torch.full((N_REQUESTS,), w, device="cuda")
    lane = [torch.zeros((N_REQUESTS,), device="cuda"), torch.zeros((N_REQUESTS,), dtype=torch.long,
                                                                  device="cuda"),
            torch.ones((N_REQUESTS,), device="cuda")]
    fn = lambda: accept_speculative(logits, tokens, counts, gen, *lane)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


class _Switch:
    """A proposer whose drafts come from `inner`, which the script switches
    between runs (an engine keeps the proposer it was built with)."""

    def __init__(self, inner):
        self.inner = inner

    def propose(self, context, k):
        return self.inner.propose(context, k)


def _spec_engine(label, config, params, proposer, prefix_cache: bool):
    t0 = time.perf_counter()
    engine = PagedLLMEngine(config, params, PagedEngineConfig(
        max_slots=N_REQUESTS, speculative_tokens=SPEC_TOKENS, speculative_proposer=proposer,
        precompile=True, paged=PagedConfig(prefix_cache=prefix_cache)), device="cuda")
    passes = engine.passes()
    log("spec", f"{label} engine: precompile: {len(passes)} CUDA graphs "
        f"captured in {engine.capture_s:.3f} s ("
        + ", ".join(f"{p.name} {p.capture_s:.3f} s" for p in passes)
        + f"); after capture {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; launches each capture "
        f"recorded: " + "; ".join(f"{p.name} {p.captured}" for p in passes)
        + f" ({time.perf_counter() - t0:.2f} s)")
    if not all(p.is_captured for p in passes) or engine._decode:
        raise AssertionError("the spec engine must capture its verify passes and no decode block")
    # the eager sampling of a first token and the pinned host allocator
    engine.generate([1, 2], max_tokens=2)
    return engine


def _spec_report(label, engine, before, wall, t_start, stamps) -> dict:
    """One spec run's numbers, printed: wall, TTFT, decode rate, the spec
    counters of the run and verify passes per generated token."""
    stats = _stats_delta(engine, before)
    ttft = [st[0][0] - t_start for st in stamps]
    first_all = min(st[0][0] for st in stamps)
    last_all = max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    proposed, accepted = stats["spec_proposed"], stats["spec_accepted"]
    rate = accepted / proposed if proposed else 0.0
    runs = {p.name: int(stats[f"passes.{p.name}"]) for p in engine.passes()}
    log("spec", f"{label}: {len(stamps)} requests, {MAX_TOKENS} new each: wall {wall:.3f} s, "
        f"TTFT p50 {statistics.median(ttft):.3f} s max {max(ttft):.3f} s, decode "
        f"{decode_tokens / (last_all - first_all):.1f} tok/s, output "
        f"{len(stamps) * MAX_TOKENS / wall:.1f} tok/s over the wall; spec_proposed "
        f"{proposed:.0f} spec_accepted {accepted:.0f} spec_acceptance_rate {rate:.4f} "
        f"spec_rollback_pages {stats['spec_rollback_pages']:.0f}; verify rounds "
        f"(decode_steps) {stats['decode_steps']:.0f} for {stats['decode_tokens']:.0f} decode "
        f"tokens: {stats['decode_steps'] / max(1.0, stats['decode_tokens']):.4f} verify passes "
        f"per generated token; mixed ticks {stats['mixed_ticks']:.0f}; graph replays {runs}; "
        f"ragged launches {int(stats.get('launches.ragged_paged_attention', 0))}")
    return dict(stats=stats, rate=rate)


def phase_spec(server, config, prompts, outs) -> dict:
    """Speculative decoding and the prefix cache on Llama-3-8B, sharing the
    serve phase's weight tensors: the replay drill (a ReplayProposer of the
    serve phase's greedy outputs), a run of 8 prompts sharing a 512-token
    prefix, a self-replay (a second engine, no prefix cache, replaying the
    drill's own tokens: the rate where drafts match), and a run drafted by
    a 2-layer cut of the model on that second engine. Returns each
    kernel's launches on this path (counted from zero just before it, the
    profiled repeat left out)."""
    t0 = time.perf_counter()
    params = server.engine.params
    pprompts = _prefix_prompts(config)
    base = _prefix_run(server.engine, pprompts)
    log("spec", f"prefix prompts ({PREFIX_TOKENS}-token shared prefix, tails "
        f"{len(pprompts[0]) - PREFIX_TOKENS}-{len(pprompts[-1]) - PREFIX_TOKENS}) on the serve "
        f"phase's engine (no cache, no speculation): TTFT first {base['ttft'][0]:.3f} s, the "
        f"other {N_REQUESTS - 1} p50 {statistics.median(base['ttft'][1:]):.3f} s max "
        f"{max(base['ttft'][1:]):.3f} s, wall of the {N_REQUESTS - 1} {base['wall']:.3f} s")
    replay = ReplayProposer({tuple(p): o for p, o in zip(prompts + pprompts, outs + base["outs"])})
    engine = _spec_engine("replay", config, params, replay, prefix_cache=True)
    draft_config = config.replace(n_layers=DRAFT_LAYERS)
    draft_params = {"wte": params["wte"], "lnf_scale": params["lnf_scale"],
                    "lm_head": params["lm_head"],
                    "blocks": {k: v[:DRAFT_LAYERS] for k, v in params["blocks"].items()}}
    draft = DraftModelProposer(draft_config, draft_params, window=DRAFT_WINDOW)
    switch = _Switch(draft)
    engine2 = _spec_engine("self-replay / draft-model", config, params, switch, prefix_cache=False)
    for kernel in KERNELS:
        kernel.launches = 0
    for kind in LAUNCHES_BY_KIND:
        LAUNCHES_BY_KIND[kind] = 0
    path = {}  # engine launches (replays x captured) on this path, summed

    # ---- replay drill
    before = engine.stats()
    wall, t_start, stamps, _ = _serve_run(engine, prompts)
    drill = _spec_report("replay drill", engine, before, wall, t_start, stamps)
    _add_launches(path, drill["stats"])
    spec_outs = [[tok for _, tok in st] for st in stamps]
    same = sum(a == b for a, b in zip(spec_outs, outs))
    log("spec", f"replay drill: {same} of {N_REQUESTS} token lists equal the serve phase's")
    if any(len(o) != MAX_TOKENS for o in spec_outs):
        raise AssertionError("a spec request returned the wrong number of tokens")
    if drill["stats"]["decode_steps"] == 0 or drill["rate"] == 0.0:
        raise AssertionError("the replay drill ran no verify round or accepted no draft")
    _dense_check("spec", params, config, prompts, spec_outs)
    profiled = _hold_ragged_against_profiler("spec", engine, prompts)
    # ---- prefix run
    before = engine.stats()
    run = _prefix_run(engine, pprompts)
    stats = _stats_delta(engine, before)
    _add_launches(path, stats)
    hit = sum(c > 0 for c in run["cached"])
    prompt_tokens = sum(len(p) for p in pprompts)
    log("spec", f"prefix run (prefix cache on, replay drafts of the serve engine's greedy "
        f"tokens): prefix_cache_hits {stats['prefix_cache_hits']:.0f} prefix_cache_misses "
        f"{stats['prefix_cache_misses']:.0f}, cached_tokens per request {run['cached']} "
        f"({hit} of {N_REQUESTS} hit), prefill tokens {stats['prefill_tokens']:.0f} of "
        f"{prompt_tokens} ({prompt_tokens - stats['prefill_tokens']:.0f} saved); TTFT first "
        f"{run['ttft'][0]:.3f} s (serve engine {base['ttft'][0]:.3f}), the other "
        f"{N_REQUESTS - 1} p50 {statistics.median(run['ttft'][1:]):.3f} s max "
        f"{max(run['ttft'][1:]):.3f} s (serve engine {statistics.median(base['ttft'][1:]):.3f} / "
        f"{max(base['ttft'][1:]):.3f}), wall of the {N_REQUESTS - 1} {run['wall']:.3f} s "
        f"(serve engine {base['wall']:.3f}); spec_proposed {stats['spec_proposed']:.0f} "
        f"spec_accepted {stats['spec_accepted']:.0f}; copy-on-write copies "
        f"{stats['prefix_cache_cow']:.0f}; {sum(a == b for a, b in zip(run['outs'], base['outs']))} "
        f"of {N_REQUESTS} token lists equal the serve engine's")
    if hit < N_REQUESTS - 1:
        raise AssertionError(f"only {hit} of {N_REQUESTS} prefix requests hit the cache")
    _dense_check("spec", params, config, pprompts, run["outs"], picks=[1, N_REQUESTS - 1])
    # ---- self-replay on the second engine
    switch.inner = ReplayProposer({tuple(p): o for p, o in zip(prompts, spec_outs)})
    before = engine2.stats()
    wall, t_start, stamps, _ = _serve_run(engine2, prompts)
    report = _spec_report("self-replay (drafts: the replay drill's own tokens; no prefix cache)",
                          engine2, before, wall, t_start, stamps)
    _add_launches(path, report["stats"])
    self_outs = [[tok for _, tok in st] for st in stamps]
    log("spec", f"self-replay: {sum(a == b for a, b in zip(self_outs, spec_outs))} of "
        f"{N_REQUESTS} token lists equal the replay drill's")
    _dense_check("spec", params, config, prompts, self_outs)
    _hold_ragged_against_profiler("spec self-replay", engine2, prompts)
    # ---- draft-model run
    switch.inner = draft
    flash0 = FLASH_FWD.launches
    before = engine2.stats()
    wall, t_start, stamps, _ = _serve_run(engine2, prompts[:2])
    flash_draft = FLASH_FWD.launches - flash0
    report = _spec_report(f"draft model ({DRAFT_LAYERS}-layer cut, window {DRAFT_WINDOW})",
                          engine2, before, wall, t_start, stamps)
    _add_launches(path, report["stats"])
    log("spec", f"draft model: flash forward launches on the draft path {flash_draft}")
    if report["stats"]["spec_proposed"] == 0 or flash_draft == 0:
        raise AssertionError("the draft model proposed nothing or never launched the flash kernel")
    _dense_check("spec", params, config, prompts[:2], [[t for _, t in st] for st in stamps])
    launches = {k.name: k.launches + path.get(k.name, 0) for k in KERNELS}
    if RAGGED.launches:
        raise AssertionError("a verify pass launched the ragged kernels outside its graph")
    # ---- pass and step times on idle engines (scratch-page writes only)
    times = {
        "serve decode.plain (16 steps)": _replay_ms(server.engine._decode["plain"]),
        "serve mixed.1": _replay_ms(server.engine._mixed[1]),
        "verify.1": _replay_ms(engine._mixed[1]),
        "verify.8": _replay_ms(engine._mixed[N_REQUESTS]),
        "accept step alone": _accept_ms(config),
    }
    log("spec", "device time of one replay over inactive inputs, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    for e in (engine, engine2):
        e.shutdown()
    log("spec", f"launches on the spec path {launches}, ragged by kind "
        f"{ {k: path.get(f'ragged.{k}', 0) for k in LAUNCHES_BY_KIND} } "
        f"({time.perf_counter() - t0:.2f} s)")
    return dict(launches=launches, profiled=profiled)


def phase_dense(server, config, prompts, serve_outs) -> dict:
    """LLMServer(engine_config=None) on the serve phase's weight tensors:
    the dense LLMEngine, its decode step one CUDA graph, its prefill eager
    (one flash launch per layer at B 1, S = the prompt's bucket). The serve
    phase's 8 greedy requests, unprofiled; the flash launches counted by
    the engine (prefills x layers), by the wrapper and by torch.profiler
    (a profiled repeat); the dense check on every request; one replay of
    the decode graph against eager decode_step, bitwise. Returns each
    kernel's launches on this path (the unprofiled run and the check)."""
    t0 = time.perf_counter()
    params = server.engine.params
    dense_server = LLMServer(config, params, EngineConfig(max_slots=N_REQUESTS,
                                                          max_seq=DENSE_MAX_SEQ), device="cuda")
    engine = dense_server.engine
    if type(engine) is not LLMEngine or not engine._decode.is_captured:
        raise AssertionError(f"engine_config=None built {type(engine).__name__}, or its decode "
                             "graph was not captured")
    torch.cuda.synchronize()
    log("dense", f"LLMServer(engine_config=EngineConfig(...)) built {type(engine).__name__}, "
        f"the engine engine_config=None builds: {N_REQUESTS} "
        f"slots, max_seq {engine.max_seq}, cache {engine.cache['k'].numel() * 2 * 2 / 2**30:.2f} "
        f"GiB; decode graph captured in {engine.capture_s:.3f} s (launches it recorded "
        f"{engine._decode.captured}); after capture {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    # one short request first: the eager prefill's cuBLAS handles and the pinned allocator
    dense_server.generate({"prompt_tokens": [1] * 64, "max_tokens": 2})
    for kernel in KERNELS:
        kernel.launches = 0
    stats0 = engine.stats()
    wall, t_start, stamps, _ = _serve_run(engine, prompts)
    stats = _stats_delta(engine, stats0)
    outs = [[tok for _, tok in st] for st in stamps]
    if any(len(o) != MAX_TOKENS for o in outs):
        raise AssertionError("a dense request returned the wrong number of tokens")
    launches = {k.name: k.launches for k in KERNELS}
    flash = FLASH_FWD.launches
    counted = int(stats["prefills"]) * config.n_layers
    ttft = [st[0][0] - t_start for st in stamps]
    first_all, last_all = min(st[0][0] for st in stamps), max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    # the 8 prefills run one after another before the first decode step:
    # the rate once every lane decodes, from the last first token on
    last_first = max(st[0][0] for st in stamps)
    steady = sum(1 for st in stamps for t, _ in st if t > last_first)
    log("dense", f"{N_REQUESTS} requests, {MAX_TOKENS} new each: wall {wall:.3f} s, TTFT p50 "
        f"{statistics.median(ttft):.3f} s max {max(ttft):.3f} s, decode "
        f"{decode_tokens / (last_all - first_all):.1f} tok/s ({steady / (last_all - last_first):.1f} "
        f"tok/s after the last first token), prefill span {last_first - first_all:.3f} s, output "
        f"{N_REQUESTS * MAX_TOKENS / wall:.1f} tok/s over the wall; decode graph replays "
        f"{stats['passes.decode']:.0f} (decode steps {stats['decode_steps']:.0f}); prefills "
        f"{stats['prefills']:.0f}; flash forward launches counted by the engine (prefills x "
        f"layers) {counted}, through the wrapper {flash}; {sum(a == b for a, b in zip(outs, serve_outs))} "
        f"of {N_REQUESTS} token lists equal the paged serve phase's")
    if flash != counted or flash == 0:
        raise AssertionError(f"flash launches {flash} differ from prefills x layers {counted}")
    # a profiled repeat: torch.profiler's flash kernels against the engine's count
    before = engine.stats()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        _serve_run(engine, prompts)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - tp
    prof_stats = _stats_delta(engine, before)
    seen = sum("flash_fwd" in e.name() for e in _device_events(prof))
    busy = _busy_s(prof)
    want = int(prof_stats["prefills"]) * config.n_layers
    log("dense", f"profiled repeat: flash forward device kernels from torch.profiler {seen}, "
        f"the engine's count (prefills x layers) {want}; wall {pwall:.4f} s, device busy "
        f"{busy:.4f} s, idle share {1 - busy / pwall:.4f}")
    if seen != want:
        raise AssertionError(f"torch.profiler saw {seen} flash kernels, the engine counted {want}")
    before_flash = FLASH_FWD.launches
    _dense_check("dense", params, config, prompts, outs, picks=list(range(N_REQUESTS)))
    launches[FLASH_FWD.name] += FLASH_FWD.launches - before_flash
    # one replay of the decode graph against eager decode_step, on the idle
    # engine: the 8 lanes continue their streams at their own positions
    tokens = np.array([o[-1] for o in outs], np.int64)
    positions = np.array([len(p) + MAX_TOKENS - 1 for p in prompts], np.int64)
    saved = {k: v.clone() for k, v in engine.cache.items()}
    with torch.no_grad():
        graphed = engine._decode(tokens=tokens, positions=positions,
                                 temps=np.zeros(N_REQUESTS, np.float32)).clone()
        after = {k: v.clone() for k, v in engine.cache.items()}
        for k, v in saved.items():
            engine.cache[k].copy_(v)
        logits, _ = decode_step(params, engine.cache, torch.from_numpy(tokens).cuda(),
                                torch.from_numpy(positions).cuda(), config)
        eager = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    same = torch.equal(graphed, eager) and all(torch.equal(after[k], engine.cache[k]) for k in after)
    step_ms = _replay_ms(engine._decode)
    log("dense", f"decode graph replay vs eager decode_step: tokens and cache bitwise equal "
        f"{same}; one replay {step_ms:.4f} ms ({time.perf_counter() - t0:.2f} s)")
    del saved, after
    dense_server.shutdown()
    if not same:
        raise AssertionError("the dense decode graph differs from eager decode_step")
    return launches


def _overload_prompts(config, rng, n, lo, hi):
    return [rng.integers(0, config.vocab_size, int(k)).tolist()
            for k in np.linspace(lo, hi, n).astype(int)]


def _overload_run(engine, lows, highs) -> dict:
    """The 4 priority-0 lanes, then, once each has its first token, the 2
    priority-1 requests; every stream to its end. Returns the tokens, the
    priority-1 TTFTs (from their submit) and the engine counters of the
    run."""
    before = engine.stats()
    streams = [engine.submit(p, max_tokens=OVERLOAD_LOW_TOKENS, tenant="bulk", priority=0)
               for p in lows]
    outs = [[] for _ in range(len(lows) + len(highs))]
    errors = [None] * len(outs)
    firsts = [threading.Event() for _ in lows]
    threads = _consume(streams, outs, errors, firsts)
    for ev in firsts:
        ev.wait(timeout=600)
    t_high = time.perf_counter()
    hstreams = [engine.submit(p, max_tokens=OVERLOAD_HIGH_TOKENS, tenant="paid", priority=1)
                for p in highs]
    threads += _consume(hstreams, outs[len(lows):], errors[len(lows):])
    _join(threads)
    if any(errors):
        raise AssertionError(f"an overload stream failed: {errors}")
    stats = _stats_delta(engine, before)
    # a resumed lane was charged its parked wait at re-admission
    victims = [i for i, st in enumerate(streams) if st._request.preempt_wait_s > 0]
    return dict(outs=[[t for _, t in o] for o in outs], stats=stats, victims=victims,
                high_ttft=[o[0][0] - t_high for o in outs[len(lows):]])


def _overload_pair(engine, lows, highs, label, finished, path) -> dict:
    """The overload run with preemption on, then off, on one engine; each
    run's numbers printed, its streams added to `finished` (prompt, tokens,
    group) and its launches to `path`. Returns both runs."""
    runs = {}
    for preempt in (True, False):
        cfg.set(serve_lane_preemption=preempt)
        try:
            run = _overload_run(engine, lows, highs)
        finally:
            cfg.reset()
        _add_launches(path, run["stats"])
        st = run["stats"]
        runs[preempt] = run
        group = f"{label}, preemption {'on' if preempt else 'off'}"
        finished += [(p, o, f"{group}, " + ("priority 1" if i >= len(lows) else
                                             "resumed" if i in run["victims"] else "priority 0"))
                     for i, (p, o) in enumerate(zip(lows + highs, run["outs"]))]
        log("overload", f"{group}: 4 x priority 0 ({len(lows[0])} tokens, "
            f"{OVERLOAD_LOW_TOKENS} new) then 2 x priority 1 ({len(highs[0])} tokens, "
            f"{OVERLOAD_HIGH_TOKENS} new): priority-1 TTFT "
            + ", ".join(f"{t:.3f}" for t in run["high_ttft"]) + " s; lane_preemptions "
            f"{st['lane_preemptions']:.0f} preempted_pages {st['preempted_pages']:.0f} "
            f"lane_resumes {st['lane_resumes']:.0f} page_stalls {st['page_stalls']:.0f}; "
            f"resumed lanes {run['victims']}; ragged launches "
            f"{int(st.get('launches.ragged_paged_attention', 0))}")
        if any(len(o) != n for o, n in zip(run["outs"], [OVERLOAD_LOW_TOKENS] * len(lows)
                                           + [OVERLOAD_HIGH_TOKENS] * len(highs))):
            raise AssertionError(f"{group}: a stream ended short")
    on, off = runs[True], runs[False]
    same = [next((j for j, (a, b) in enumerate(zip(on["outs"][i], off["outs"][i])) if a != b),
                 OVERLOAD_LOW_TOKENS) for i in on["victims"]]
    log("overload", f"{label}: each resumed lane's tokens equal the same prompt's unpreempted "
        f"tokens (preemption off) for the first {same} of {OVERLOAD_LOW_TOKENS}")
    if off["stats"]["lane_preemptions"] != 0:
        raise AssertionError("a lane was preempted with serve_lane_preemption=False")
    if on["stats"]["lane_resumes"] != on["stats"]["lane_preemptions"]:
        raise AssertionError("fewer lanes resumed than were parked")
    return runs


def phase_overload(config) -> dict:
    """Overload handling of the paged engine at Llama-3-8B's width and
    OVERLOAD_LAYERS layers (bf16 weights from SEED): lane preemption
    (against the same run with preemption off), then the
    queue-bound burst, a tenant over its quota and 0.2 s deadlines behind
    long lanes, then the preemption pair on a second engine with 1 block
    in flight (a marked victim parks once its in-flight blocks drain).
    Returns each kernel's launches on this path (the unprofiled runs,
    drills and dense checks)."""
    t0 = time.perf_counter()
    config = config.replace(n_layers=OVERLOAD_LAYERS)
    params = init_params(config, SEED, device="cuda")
    engine = PagedLLMEngine(config, params, PagedEngineConfig(
        max_slots=OVERLOAD_SLOTS, precompile=True,
        paged=PagedConfig(num_pages=OVERLOAD_PAGES)), device="cuda")
    pc = engine.paged
    passes = engine.passes()
    log("overload", f"engine: {MODEL}'s width at {config.n_layers} layers, {OVERLOAD_SLOTS} "
        f"slots, {pc.num_pages - 1} allocatable pages of "
        f"{pc.page_size}, queue bound {engine.config.max_queued_requests or 8 * OVERLOAD_SLOTS}; "
        f"{len(passes)} CUDA graphs captured in {engine.capture_s:.3f} s; after capture "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    engine.generate([1, 2], max_tokens=2)
    # the same pair on a shallow pipeline: a marked victim drains 1 block
    # (built here: a capture's warm-up runs through the kernel wrappers)
    shallow = PagedLLMEngine(config, params, PagedEngineConfig(
        max_slots=OVERLOAD_SLOTS, max_inflight_blocks=1, precompile=True,
        paged=PagedConfig(num_pages=OVERLOAD_PAGES)), device="cuda")
    shallow.generate([1, 2], max_tokens=2)
    rng = np.random.default_rng(SEED + 3)
    lows = _overload_prompts(config, rng, OVERLOAD_SLOTS, 512, 512)
    highs = _overload_prompts(config, rng, 2, 128, 128)
    for kernel in KERNELS:
        kernel.launches = 0
    path: dict = {}  # engine launches (replays x captured) on this path, summed

    finished = []  # (prompt, tokens, group) of every stream that ended with tokens
    runs = _overload_pair(engine, lows, highs, f"{engine.config.max_inflight_blocks} blocks in "
                          "flight", finished, path)
    if runs[True]["stats"]["lane_preemptions"] < 1:
        raise AssertionError("the overload run preempted no lane")
    # ---- burst past the queue bound
    before = engine.stats()
    burst_prompts = _overload_prompts(config, rng, 3 * 8 * OVERLOAD_SLOTS, 16, 48)
    accepted, shed = [], 0
    for p in burst_prompts:
        try:
            accepted.append((p, engine.submit(p, max_tokens=4, tenant="burst")))
        except BackPressureError as exc:
            shed += 1
            if exc.retry_after_s is not None:
                raise AssertionError("a queue-bound shed carried a retry estimate")
    outs = [[] for _ in accepted]
    errors = [None] * len(accepted)
    _join(_consume([s for _, s in accepted], outs, errors))
    ok = sum(len(o) == 4 for o in outs)
    finished += [(p, [t for _, t in o], "burst") for (p, _), o in zip(accepted, outs)]
    st = _stats_delta(engine, before)
    _add_launches(path, st)
    log("overload", f"burst of {len(burst_prompts)} submits (queue bound "
        f"{8 * OVERLOAD_SLOTS}): {len(accepted)} accepted, all ended with 4 tokens: "
        f"{ok == len(accepted)}; {shed} BackPressureError (shed counter {st['shed']:.0f})")
    if shed == 0 or ok != len(accepted) or st["shed"] != shed:
        raise AssertionError("the burst shed nothing, or an accepted request did not end")
    # ---- a tenant over its quota
    tenancy.set_tenant("metered", quota_rps=1.0)
    before = engine.stats()
    q_ok, retry = [], []
    for p in burst_prompts[:5]:
        try:
            q_ok.append((p, engine.submit(p, max_tokens=4, tenant="metered")))
        except BackPressureError as exc:
            retry.append(exc.retry_after_s)
    outs = [[] for _ in q_ok]
    errors = [None] * len(q_ok)
    _join(_consume([s for _, s in q_ok], outs, errors))
    finished += [(p, [t for _, t in o], "quota") for (p, _), o in zip(q_ok, outs)]
    _add_launches(path, _stats_delta(engine, before))
    tenancy.reset()
    log("overload", f"tenant at quota_rps 1 (burst 2), 5 submits: {len(q_ok)} accepted, "
        f"{len(retry)} BackPressureError with retry_after_s "
        + ", ".join(f"{r:.3f}" for r in retry))
    if not retry or not all(r is not None and 0 < r < 10 for r in retry) or any(errors):
        raise AssertionError("the quota shed nothing or gave no finite retry_after_s")
    # ---- deadlines behind long lanes
    before = engine.stats()
    longs = [engine.submit(p, max_tokens=OVERLOAD_LOW_TOKENS, tenant="bulk")
             for p in lows[:OVERLOAD_SLOTS - 1]]
    deadline = time.time() + DEADLINE_S
    doomed = [engine.submit(p, max_tokens=OVERLOAD_LOW_TOKENS, tenant="late",
                            deadline_ts=deadline) for p in [lows[-1]] + highs]
    streams = longs + doomed
    outs = [[] for _ in streams]
    errors = [None] * len(streams)
    _join(_consume(streams, outs, errors))
    st = _stats_delta(engine, before)
    _add_launches(path, st)
    finished += [(p, [t for _, t in o], "deadline drill, long lane")
                 for p, o in zip(lows, outs[:len(longs)])]
    timed = [(len(o), type(e).__name__) for o, e in zip(outs[len(longs):], errors[len(longs):])]
    log("overload", f"{len(doomed)} requests with {DEADLINE_S} s deadlines behind "
        f"{len(longs)} long lanes: (tokens before the error, error) {timed}; timeouts counter "
        f"{st['timeouts']:.0f}; the long lanes ended with "
        f"{[len(o) for o in outs[:len(longs)]]} tokens")
    if any(not isinstance(e, RequestTimeoutError) for e in errors[len(longs):]) or any(
            errors[:len(longs)]) or st["timeouts"] != len(doomed):
        raise AssertionError("a deadline request did not end with RequestTimeoutError")
    deadline_wait = time.time() + 30
    while time.time() < deadline_wait:
        free = engine.stats()["pages_free"]
        if free == pc.num_pages - 1:
            break
        time.sleep(0.01)
    log("overload", f"after the drills: pages_free {free:.0f} of {pc.num_pages - 1}")
    if free != pc.num_pages - 1:
        raise AssertionError("the page pool did not return to full")
    # ---- the preemption pair on the shallow pipeline
    _overload_pair(shallow, lows, highs, "1 block in flight", finished, path)
    if shallow.stats()["pages_free"] != pc.num_pages - 1:
        raise AssertionError("the shallow engine's page pool did not return to full")
    shallow.shutdown()
    launches = {k.name: k.launches + path.get(k.name, 0) for k in KERNELS}
    if RAGGED.launches:
        raise AssertionError("an overload pass launched the ragged kernels outside its graph")
    # ---- the teacher-forced check on every finished stream (resumed victims included)
    prompts_f, outs_f = [p for p, _, _ in finished], [o for _, o, _ in finished]
    before_flash = FLASH_FWD.launches
    _dense_check("overload", params, config, prompts_f, outs_f, picks=list(range(len(finished))),
                 labels=[g for _, _, g in finished], margin=OVERLOAD_CHECK_MARGIN,
                 exact_floor=0.0)
    launches[FLASH_FWD.name] += FLASH_FWD.launches - before_flash
    # ---- ragged launches of a preempting run, held against torch.profiler
    cfg.set(serve_lane_preemption=True)
    try:
        counts = {}

        def profiled():
            counts.update(_overload_run(engine, lows, highs)["stats"])

        profiled_seen = _hold_ragged_against_profiler("overload", engine, lows, run=profiled)
    finally:
        cfg.reset()
    log("overload", f"profiled preempting run: lane_preemptions {counts['lane_preemptions']:.0f}, "
        f"lane_resumes {counts['lane_resumes']:.0f}; launches on the overload path "
        f"{launches}, ragged by kind { {k: path.get(f'ragged.{k}', 0) for k in LAUNCHES_BY_KIND} } "
        f"({time.perf_counter() - t0:.2f} s)")
    engine.shutdown()
    return dict(launches=launches, profiled=profiled_seen)

def _handle_run(handle, prompts, max_tokens=MAX_TOKENS):
    """Every greedy request at once through the handle's streaming path
    (`stream_generate`, one stream per request, each consumed on a thread
    of its own): (wall seconds, start time, [(time, token), ...] per
    request, each stream's final item)."""
    stamps = [[] for _ in prompts]
    finals = [None] * len(prompts)
    errors = [None] * len(prompts)
    caller = handle.options(stream=True)
    t_start = time.perf_counter()
    streams = [caller.stream_generate.remote({"prompt_tokens": p, "max_tokens": max_tokens,
                                              "temperature": 0.0}) for p in prompts]

    def consume(i):
        try:
            for ref in streams[i]:
                item = ray_tpu_torch.get(ref, timeout=600)
                if "token" in item:
                    stamps[i].append((time.perf_counter(), item["token"]))
                else:
                    finals[i] = item
        except Exception as exc:  # noqa: BLE001 - reported below
            errors[i] = exc

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(prompts))]
    for th in threads:
        th.start()
    _join(threads)
    if any(errors):
        raise AssertionError(f"a request through the handle failed: {errors}")
    return time.perf_counter() - t_start, t_start, stamps, finals


def _rates(wall, t_start, stamps, n_tokens) -> dict:
    """TTFT p50 / max, decode tok/s (tokens after each request's first,
    over first-token-to-last-token), output tok/s over the wall."""
    ttft = [st[0][0] - t_start for st in stamps]
    first_all, last_all = min(st[0][0] for st in stamps), max(st[-1][0] for st in stamps)
    decode_tokens = sum(len(st) - 1 for st in stamps)
    return dict(wall_s=wall, ttft_p50_s=statistics.median(ttft), ttft_max_s=max(ttft),
                decode_tok_s=decode_tokens / (last_all - first_all),
                output_tok_s=n_tokens / wall)


def _replica_engines(handle):
    """The engine of each replica of a deployment, read inside its actor."""
    return [ray_tpu_torch.get(r.__ray_apply__.remote(lambda wrapper: wrapper._instance.engine),
                              timeout=600) for r in handle._set.replicas()]


def _wait_routable(name: str, n: int, timeout: float = 120.0) -> float:
    """Seconds until the controller has seen `n` replicas of deployment
    `name` answer a health probe: once one has, it routes only to those
    that have (JAX's readiness rule), so a burst sent earlier lands on the
    first replica alone."""
    from ray_tpu_torch.serve import api as serve_api

    t0 = time.perf_counter()
    state = serve_api._controller._states[name]
    while len(state.ready_at) < n or len(state.replica_set.replicas()) < n:
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{name}: fewer than {n} replicas became routable")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _gib(n: float) -> str:
    return f"{n / 2**30:.2f} GiB"


def _http(port, method, path, body=None, raw=None):
    """(status, headers, body bytes, seconds to the first SSE data line
    or None) of one request to the frontend."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    t0 = time.perf_counter()
    conn.request(method, path, body=data, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    first = None
    if resp.getheader("Content-Type", "").startswith("text/event-stream"):
        lines = []
        for line in resp:
            if first is None and line.startswith(b"data: "):
                first = time.perf_counter() - t0
            lines.append(line)
        payload = b"".join(lines)
    else:
        payload = resp.read()
    conn.close()
    return resp.status, dict(resp.getheaders()), payload, first


def _deploy_http(port, prompt) -> None:
    """The OpenAI frontend over deployment A: /v1/models; /v1/completions
    with a token-array prompt, plain and SSE (the byte tokenizer drops
    Llama's ids >= 256 from the text, so usage and finish_reason are
    checked, not text); a malformed body answered with JAX's error schema."""
    req = {"model": MODEL, "prompt": prompt, "max_tokens": DEPLOY_HTTP_TOKENS, "temperature": 0.0}
    code, _, body, _ = _http(port, "GET", "/v1/models")
    models = json.loads(body)
    if code != 200 or [m["id"] for m in models["data"]] != [MODEL]:
        raise AssertionError(f"/v1/models answered {code}: {models}")
    t0 = time.perf_counter()
    code, _, body, _ = _http(port, "POST", "/v1/completions", req)
    plain_s = time.perf_counter() - t0
    out = json.loads(body)
    usage, choice = out["usage"], out["choices"][0]
    if (code != 200 or usage["prompt_tokens"] != len(prompt)
            or usage["completion_tokens"] != DEPLOY_HTTP_TOKENS
            or choice["finish_reason"] != "length" or out["object"] != "text_completion"):
        raise AssertionError(f"/v1/completions answered {code}: {out}")
    t0 = time.perf_counter()
    code, headers, body, first = _http(port, "POST", "/v1/completions", {**req, "stream": True})
    sse_s = time.perf_counter() - t0
    frames = [line[len(b"data: "):].decode().strip() for line in body.splitlines()
              if line.startswith(b"data: ")]
    chunks = [json.loads(f) for f in frames[:-1]]
    if (code != 200 or frames[-1] != "[DONE]" or not chunks
            or chunks[-1]["usage"]["completion_tokens"] != DEPLOY_HTTP_TOKENS
            or chunks[-1]["choices"][0]["finish_reason"] != "length"):
        raise AssertionError(f"SSE /v1/completions answered {code}: {frames[-3:]}")
    code, _, body, _ = _http(port, "POST", "/v1/completions", raw=b"{not json")
    err = json.loads(body).get("error", {})
    if code != 400 or err.get("type") != "invalid_request_error" or not {
            "message", "type", "param", "code"} <= set(err):
        raise AssertionError(f"a malformed body was answered {code}: {err}")
    log("deploy", f"HTTP: /v1/models {[m['id'] for m in models['data']]}; /v1/completions "
        f"(token-array prompt of {len(prompt)}, {DEPLOY_HTTP_TOKENS} new) {plain_s:.3f} s, usage "
        f"{usage}, finish_reason {choice['finish_reason']}; SSE {len(chunks)} chunks + [DONE] in "
        f"{sse_s:.3f} s, first data line {first:.3f} s after the POST (ids >= 256 have no "
        f"text: the first chunk may be the final one); malformed body: {code} "
        f"{err.get('type')}")


class _Ticker:
    """A deployment whose generator method yields small dicts, as
    `LLMServer.stream_generate` does, with no engine behind it."""

    def tick(self, n):
        for i in range(n):
            yield {"token": i}


def _stream_cost(rt, n=2000, streams=8) -> None:
    """Host cost of one streamed item through the handle's streaming path
    (actor generator → store item → failover feeder → consumer `get`), on
    this machine's host: one stream alone, then `streams` at once."""
    handle = serve.run(serve.deployment(_Ticker, name="ticker",
                                        max_ongoing_requests=2 * streams).bind())
    caller = handle.options(stream=True)
    for width in (1, streams):
        counts = [0] * width

        def consume(i):
            for ref in caller.tick.remote(n):
                rt.get(ref, timeout=600)
                counts[i] += 1

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(width)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        _join(threads)
        wall = time.perf_counter() - t0
        if counts != [n] * width:
            raise AssertionError(f"a ticker stream lost items: {counts}")
        log("deploy", f"streaming path alone ({width} stream(s) of {n} items, no engine): "
            f"{wall / (n * width) * 1e6:.1f} us of wall per item, {n * width / wall:.0f} items/s")
    serve.delete("ticker")


def phase_deploy(server, config, prompts, serve_outs, direct) -> dict:
    """The serving entry point as users call it, on the serve phase's
    weight tensors: `ray_tpu_torch.init()` (the card as `GPU`), a CUDA
    tensor through the object store, `serve.run(build_llm_app(...,
    paged=True))` (deployment A: the paged engine in a replica actor, its
    graphs captured at first use) driven by 8 streams through the handle
    and by the OpenAI frontend, then the default dense app with 2 replicas
    (deployment B), then serve and the runtime shut down with their threads
    joined and the replicas' KV memory freed. Returns each kernel's
    launches on this path (the unprofiled runs, HTTP and the dense
    checks) and the profiled repeat's ragged device kernels."""
    t_phase = time.perf_counter()
    params = server.engine.params
    threads_before = {t.ident for t in threading.enumerate()}
    launches = {k.name: 0 for k in KERNELS}
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ray_tpu_torch.init(num_cpus=8)
    try:
        resources = ray_tpu_torch.cluster_resources()
        log("deploy", f"init: cluster_resources GPU {resources.get('GPU')}, CPU {resources['CPU']}")
        if resources.get("GPU") != 1.0:
            raise AssertionError(f"the runtime does not show the card as GPU 1.0: {resources}")
        # ---- a CUDA tensor through the object store
        store = get_runtime().object_store
        big = torch.ones(DEPLOY_PUT_BYTES // 2, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        dev0, alloc0 = store.usage()["device_bytes"], torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(big)
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = ray_tpu_torch.get(ref)
        get_s = time.perf_counter() - t0
        tier, dev1 = store.entry(ref.object_id).tier.value, store.usage()["device_bytes"]
        same = got is big and got.data_ptr() == big.data_ptr()
        if tier != "device" or dev1 - dev0 != big.nbytes or not same:
            raise AssertionError(f"the store copied or mis-tiered a CUDA tensor: tier {tier}, "
                                 f"device_bytes +{dev1 - dev0}, same tensor {same}")
        if torch.cuda.memory_allocated() != alloc0:
            raise AssertionError("put/get of a CUDA tensor allocated on the card")
        oid = ref.object_id
        del ref, got
        freed_entry = store.entry(oid) is None and store.usage()["device_bytes"] == dev0
        del big
        freed_mem = alloc0 - torch.cuda.memory_allocated()
        log("deploy", f"store: put of a {_gib(DEPLOY_PUT_BYTES)} bf16 CUDA tensor {put_s * 1e6:.1f} "
            f"us, get {get_s * 1e6:.1f} us; tier {tier}, device_bytes +{dev1 - dev0}, the same "
            f"tensor back (data_ptr equal), no allocation on the card; ref dropped: entry gone "
            f"{freed_entry}, {_gib(freed_mem)} freed with the tensor")
        if not freed_entry or freed_mem != DEPLOY_PUT_BYTES:
            raise AssertionError("the store kept the CUDA tensor after its ref dropped")
        _stream_cost(ray_tpu_torch)
        # ---- deployment A: the paged app
        t0 = time.perf_counter()
        handle = serve.run(build_llm_app(config, params=params, paged=True, max_slots=N_REQUESTS))
        ray_tpu_torch.get(handle.metrics.remote(), timeout=600)
        deploy_a_s = time.perf_counter() - t0
        (engine,) = _replica_engines(handle)
        if type(engine) is not PagedLLMEngine or engine.params is not params:
            raise AssertionError(f"deployment A built {type(engine).__name__} on weights of its own")
        alloc_a = torch.cuda.memory_allocated()
        log("deploy", f"A: serve.run(build_llm_app({MODEL}, params=..., paged=True, max_slots="
            f"{N_REQUESTS})) answered in {deploy_a_s:.3f} s; the replica's engine holds the "
            f"caller's weight tensors; allocated +{_gib(alloc_a - base)} over the serve phase's "
            f"{_gib(base)} (its KV pool {_gib(sum(v.nbytes for v in engine.cache.values()))})")
        # warm-up: one request pays the lazy captures of the passes it runs
        wall, t_start, stamps, _ = _handle_run(handle, prompts[:1])
        lazy = {p.name: round(p.capture_s, 3) for p in engine.passes() if p.is_captured}
        stream = torch.cuda.Stream()
        t0 = time.perf_counter()
        rest = [p for p in engine.passes() if not p.is_captured]
        for p in rest:
            p.capture(stream)
        torch.cuda.synchronize()
        log("deploy", f"A warm-up request: TTFT {stamps[0][0][0] - t_start:.3f} s, wall "
            f"{wall:.3f} s; graphs captured at first use in the engine's loop thread (s) {lazy}; "
            f"the other {len(rest)} captured on the idle engine in {time.perf_counter() - t0:.3f} "
            f"s, so the runs below replay graphs only, as the serve phase's do")
        for k in KERNELS:
            k.launches = 0
        stats0 = engine.stats()
        wall, t_start, stamps, finals = _handle_run(handle, prompts)
        stats = _stats_delta(engine, stats0)
        outs = [[tok for _, tok in st] for st in stamps]
        if (any(len(o) != MAX_TOKENS for o in outs)
                or any(f["usage"]["completion_tokens"] != MAX_TOKENS for f in finals)):
            raise AssertionError("a stream through the handle returned the wrong number of tokens")
        a = _rates(wall, t_start, stamps, N_REQUESTS * MAX_TOKENS)
        path: dict = {}
        _add_launches(path, stats)
        for k in KERNELS:
            launches[k.name] += k.launches + path.get(k.name, 0)
        log("deploy", f"A: {N_REQUESTS} streams through the handle, {MAX_TOKENS} new each: wall "
            f"{a['wall_s']:.3f} s, TTFT p50 {a['ttft_p50_s']:.3f} s max {a['ttft_max_s']:.3f} s, "
            f"decode {a['decode_tok_s']:.1f} tok/s, output {a['output_tok_s']:.1f} tok/s over the "
            f"wall; ragged launches {path.get(RAGGED.name, 0)} (replays x captured: mixed "
            f"{path.get('ragged.mixed', 0)}, decode {path.get('ragged.decode', 0)}; through the "
            f"wrapper {RAGGED.launches}); {sum(o == w for o, w in zip(outs, serve_outs))} of "
            f"{N_REQUESTS} token lists equal the serve phase's")
        times: dict = {}
        profiled = _hold_ragged_against_profiler(
            "deploy", engine, prompts, run=lambda: _handle_run(handle, prompts), times_out=times)
        a["idle_share"] = times["idle_share"]
        log("deploy", "A through the handle vs the serve phase's direct LLMServer, same call "
            "(wall s, TTFT p50 s, TTFT max s, decode tok/s, output tok/s, idle share of the "
            "profiled repeat): " + "; ".join(
                f"{k} {a[k]:.4f} vs {direct[k]:.4f}"
                for k in ("wall_s", "ttft_p50_s", "ttft_max_s", "decode_tok_s", "output_tok_s",
                          "idle_share")))
        before_flash = FLASH_FWD.launches
        _dense_check("deploy", params, config, prompts, outs,
                     labels=[f"A{i}" for i in range(len(prompts))], margin=DEPLOY_CHECK_MARGIN)
        launches[FLASH_FWD.name] += FLASH_FWD.launches - before_flash
        # ---- HTTP over deployment A
        frontend = OpenAIFrontend({MODEL: "llm"})
        before = {k.name: k.launches for k in KERNELS}
        stats0 = engine.stats()
        try:
            _deploy_http(frontend.port, prompts[0][:64])
        finally:
            frontend.stop()
        path = {}
        _add_launches(path, _stats_delta(engine, stats0))
        for k in KERNELS:
            launches[k.name] += k.launches - before[k.name] + path.get(k.name, 0)
        del engine
        serve.delete("llm")
        # ---- deployment B: the default dense app, 2 replicas on one card
        t0 = time.perf_counter()
        handle_b = serve.run(build_llm_app(config, params=params, num_replicas=2,
                                           max_slots=N_REQUESTS, name="llm-dense"))
        engines = _replica_engines(handle_b)
        deploy_b_s = time.perf_counter() - t0
        routable_s = deploy_b_s + _wait_routable("llm-dense", 2)
        if (len(engines) != 2 or any(type(e) is not LLMEngine or e.params is not params
                                     or not e._decode.is_captured for e in engines)):
            raise AssertionError("deployment B did not build 2 dense engines on the shared "
                                 "weights with their decode graphs")
        alloc_b = torch.cuda.memory_allocated()
        kv_b = sum(v.nbytes for e in engines for v in e.cache.values())
        log("deploy", f"B: serve.run(build_llm_app({MODEL}, params=..., num_replicas=2, "
            f"max_slots={N_REQUESTS}, name='llm-dense')): 2 dense replicas built at once (each "
            f"captured its decode graph in its own actor thread, one capture at a time) in "
            f"{deploy_b_s:.3f} s, both routable (health probes answered) at {routable_s:.3f} s; caches "
            f"{_gib(kv_b)} ({engines[0].max_seq} positions per slot); allocated "
            f"{_gib(alloc_b)} (+{_gib(alloc_b - base)} over the serve phase's)")
        rng = np.random.default_rng(SEED + 5)
        lengths = np.linspace(64, 900, DEPLOY_B_REQUESTS).astype(int)
        prompts_b = [rng.integers(0, config.vocab_size, n).tolist() for n in lengths]
        for k in KERNELS:
            k.launches = 0
        stats0 = [e.stats() for e in engines]
        wall, t_start, stamps, _ = _handle_run(handle_b, prompts_b)
        split = [int(_stats_delta(e, s0)["prefills"]) for e, s0 in zip(engines, stats0)]
        outs_b = [[tok for _, tok in st] for st in stamps]
        if any(len(o) != MAX_TOKENS for o in outs_b):
            raise AssertionError("a dense stream returned the wrong number of tokens")
        b = _rates(wall, t_start, stamps, DEPLOY_B_REQUESTS * MAX_TOKENS)
        flash = FLASH_FWD.launches
        log("deploy", f"B: {DEPLOY_B_REQUESTS} streams, prompts {lengths.min()}-{lengths.max()}, "
            f"{MAX_TOKENS} new each: requests per replica {split}; wall {b['wall_s']:.3f} s, TTFT "
            f"p50 {b['ttft_p50_s']:.3f} s max {b['ttft_max_s']:.3f} s, aggregate decode "
            f"{b['decode_tok_s']:.1f} tok/s, output {b['output_tok_s']:.1f} tok/s over the wall; "
            f"flash forward launches {flash} (prefills x layers {sum(split) * config.n_layers})")
        if min(split) == 0 or sum(split) != DEPLOY_B_REQUESTS:
            raise AssertionError(f"a dense replica served none of the requests: {split}")
        if flash != sum(split) * config.n_layers:
            raise AssertionError(f"flash launches {flash} differ from prefills x layers")
        for k in KERNELS:
            launches[k.name] += k.launches
        before_flash = FLASH_FWD.launches
        _dense_check("deploy", params, config, prompts_b, outs_b,
                     labels=[f"B{i}" for i in range(len(prompts_b))], margin=DEPLOY_CHECK_MARGIN)
        launches[FLASH_FWD.name] += FLASH_FWD.launches - before_flash
        del engines, handle, handle_b
        gc.collect()
        alloc_before = torch.cuda.memory_allocated()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    gc.collect()
    alloc_after = torch.cuda.memory_allocated()
    left = [t.name for t in threading.enumerate() if t.ident not in threads_before and t.is_alive()]
    log("deploy", f"serve.shutdown() and ray_tpu_torch.shutdown(): allocated {_gib(alloc_before)} "
        f"before, {_gib(alloc_after)} after ({_gib(alloc_before - alloc_after)} freed; deployment "
        f"B's caches {_gib(kv_b)}; {_gib(base)} before the phase); threads the phase started "
        f"still alive: {left}; launches on the deploy path {launches} "
        f"({time.perf_counter() - t_phase:.2f} s)")
    if left:
        raise AssertionError(f"threads of the deploy phase outlived the shutdown: {left}")
    if alloc_before - alloc_after < kv_b:
        raise AssertionError("the replicas' KV memory was not freed at shutdown")
    if not launches[RAGGED.name] or not launches[FLASH_FWD.name]:
        raise AssertionError(f"the deploy path never launched a kernel it runs: {launches}")
    return dict(launches=launches, profiled=profiled)


# --------------------------------------------------------------- observe

OBSERVE_RUNS = 5  # marks on / off runs each, in on, off, off, on order: 5 adjacent
# (on, off) pairs, so a drift of the host's speed across the runs moves both runs of a
# pair, and a run's random ~0.15 s start stall distorts only the pairs it falls in
OBSERVE_WALL_BOUND = 1.05  # median over the pairs of the wall with marks over without
OBSERVE_TIGHT_SLO_S = 0.001  # the TTFT objective every request violates
OBSERVE_LOOSE_SLO_S = 60.0  # the one no request violates
OBSERVE_CHECK_PERIOD_S = 0.2  # the SLO monitor's check period in the phase
OBSERVE_CAPTURE_S = 1.5  # the profile capture around the streamed requests
OBSERVE_ALIGN_S = 0.05  # device events lie in the capture window +- this


def _marks_on(on: bool) -> None:
    """The request log and tracing both on (the defaults) or both off."""
    cfg.set(serve_request_log=on, trace_sample_ratio=1.0 if on else 0.0)


def _timeline_order_ok(phases) -> bool:
    """submitted, admitted, prefill chunks, then the decode blocks (made at
    dispatch: the first carries the first token in its row 0, so its mark
    precedes first_token, made at emission), first_token once, finished
    last."""
    return re.fullmatch(
        r"S A( P)+ (D )*F( D)* E",
        " ".join({"engine.submitted": "S", "engine.admitted": "A", "engine.prefill_chunk": "P",
                  "engine.decode_block": "D", "engine.first_token": "F",
                  "engine.finished": "E"}.get(p, "?") for p in phases)) is not None \
        and "engine.decode_block" in phases


def _decode_closed_form(config, engine) -> float:
    """FLOPs of one K-step plain decode block at its fixed shapes: the
    products' 2 x weights x rows per step, plus K5's formula per layer
    (4 x Hq x T x kv span x D: the decode call's T = max_slots x 8 region
    rows, each against its table's pages x page size)."""
    e, f, hd = config.d_model, config.d_ff, config.head_dim
    weights = config.n_layers * (2 * e * config.n_heads * hd + 2 * e * config.kv_heads * hd
                                 + 3 * e * f) + e * config.vocab_size
    rows = engine.config.max_slots
    pc = engine.paged
    ragged = 4.0 * config.n_heads * rows * 8 * pc.max_pages_per_slot * pc.page_size * hd
    return engine.config.decode_block_steps * (2.0 * weights * rows + config.n_layers * ragged)


def _dispatch_ms(p, iters: int = 20) -> float:
    """Median host time of enqueuing one replay of pass `p`'s graph (no
    synchronisation inside the timed region): the dispatch side of a loop
    iteration. The engine must be idle."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        p._graph.replay()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def _burns(slo: str) -> float:
    from ray_tpu_torch.util.metrics import registry

    metric = registry().get("raytpu_serve_slo_burn_total")
    return sum(v for tags, v in (metric.collect() if metric else []) if tags.get("slo") == slo)


def _idle_share_of_repeat(run) -> dict:
    """One more run under torch.profiler (CUDA activity): its wall and the
    device busy time, the sum of the card's kernel and copy durations as
    `_profiled_ragged_kernels` sums them, read from the raw Kineto events
    (the parse into FunctionEvents that key_averages() needs takes seconds
    for a run's ~80 000 graph kernels)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = _busy_s(prof)
    return dict(wall_s=wall, busy_s=busy, idle_share=1 - busy / wall)


def _observe_marks_cost(engine, prompts, path) -> None:
    """The serve phase's 8 requests on the serve engine with the request
    log and tracing on, then off, OBSERVE_RUNS each in on, off, off, on
    order: per run wall, TTFT p50, decode tok/s and a profiled repeat's
    idle share; each adjacent pair's wall ratio of on over off, and their
    median held to OBSERVE_WALL_BOUND."""
    walls = {True: [], False: []}
    runs = []  # (on, wall) in run order
    for i in range(2 * OBSERVE_RUNS):
        on = i % 4 in (0, 3)
        _marks_on(on)
        # a full collection between runs, so no run pays for the garbage of
        # the last repeat's ~80 000 profiler records
        gc.collect()
        stats0 = engine.stats()
        wall, t_start, stamps, _ = _serve_run(engine, prompts)
        _add_launches(path, _stats_delta(engine, stats0))
        r = _rates(wall, t_start, stamps, N_REQUESTS * MAX_TOKENS)
        gc.collect()
        times = _idle_share_of_repeat(lambda: _serve_run(engine, prompts))
        walls[on].append(wall)
        runs.append((on, wall))
        log("observe", f"marks {'on ' if on else 'off'}: wall {wall:.4f} s, TTFT p50 "
            f"{r['ttft_p50_s']:.4f} s, decode {r['decode_tok_s']:.1f} tok/s; profiled repeat: "
            f"wall {times['wall_s']:.4f} s, busy {times['busy_s']:.4f} s, idle share "
            f"{times['idle_share']:.4f}")
    _marks_on(True)
    pairs = [dict(runs[i:i + 2]) for i in range(0, len(runs), 2)]
    ratios = [p[True] / p[False] for p in pairs]
    ratio = statistics.median(ratios)
    log("observe", f"wall ratio with marks over without, by adjacent pair "
        + ", ".join(f"{r:.4f}" for r in ratios) + f": median {ratio:.4f} (bound "
        f"{OBSERVE_WALL_BOUND}); median wall with marks {statistics.median(walls[True]):.4f} s, "
        f"without {statistics.median(walls[False]):.4f} s; spread on "
        f"{min(walls[True]):.4f}-{max(walls[True]):.4f}, off "
        f"{min(walls[False]):.4f}-{max(walls[False]):.4f}")
    if ratio > OBSERVE_WALL_BOUND:
        raise AssertionError(f"the marks cost {ratio:.4f} of the wall, over {OBSERVE_WALL_BOUND}")


def _observe_timelines(engine, prompts, config, path) -> None:
    """8 requests with marks on, engine_snapshot() polled while they run:
    every request's timeline in order with times that never go back, all 8
    in list_requests(), one waterfall printed, busy lanes and pages while
    they run and the pool free after."""
    from ray_tpu_torch.serve import reqlog
    from ray_tpu_torch.util import state

    label = engine.metrics_label
    box = {}
    stats0 = engine.stats()
    runner = threading.Thread(target=lambda: box.update(run=_serve_run(engine, prompts)))
    runner.start()
    busy = None
    while runner.is_alive() and busy is None:
        snap = state.engine_snapshot()[label]
        lanes = [lane for lane in snap["lanes"] if not lane["free"]]
        if lanes and snap["pages"]["in_use"] > 0:
            busy = (len(lanes), snap["pages"]["in_use"], snap["inflight_blocks"])
        time.sleep(0.002)
    _join([runner])
    _add_launches(path, _stats_delta(engine, stats0))
    idle = state.engine_snapshot()[label]
    _, _, stamps, streams = box["run"]
    if any(len(st) != MAX_TOKENS for st in stamps):
        raise AssertionError("a request of the timeline run returned the wrong number of tokens")
    ids = [s.request_id for s in streams]
    summaries = {s["request_id"]: s for s in state.list_requests(limit=0)}
    for rid in ids:
        timeline = state.request_timeline(rid)
        phases = [m["phase"] for m in timeline]
        monos = [m["mono"] for m in timeline]
        if not _timeline_order_ok(phases) or monos != sorted(monos):
            raise AssertionError(f"request {rid}'s timeline is out of order: {phases}")
        if summaries.get(rid, {}).get("terminal") != "engine.finished":
            raise AssertionError(f"list_requests() lacks request {rid}")
    chunks = [sum(m["phase"] == "engine.prefill_chunk" for m in state.request_timeline(r))
              for r in ids]
    log("observe", f"timelines: {len(ids)} requests in order (submitted, admitted, prefill "
        f"chunks {chunks}, decode blocks at dispatch, first_token and finished at emission), "
        f"all in list_requests(); engine_snapshot() while running: busy lanes, pages in use, "
        f"blocks in flight {busy}; after: pages free {idle['pages']['free']} of "
        f"{idle['pages']['total']}, busy lanes {sum(not lane['free'] for lane in idle['lanes'])}")
    if busy is None or idle["pages"]["free"] != idle["pages"]["total"] or any(
            not lane["free"] for lane in idle["lanes"]):
        raise AssertionError(f"engine_snapshot() never showed the run, or the pool is not free: "
                             f"{busy}, {idle['pages']}")
    print(reqlog.render_waterfall(state.request_timeline(ids[-1])), flush=True)


def _observe_gauges(engine, config) -> dict:
    """The engine's gauges in /metrics; decode_flops against the closed
    form; decode_mfu beside the MFU of the decode block's measured replay
    time, and tick_seconds beside the replay and dispatch times."""
    from ray_tpu_torch.util.metrics import registry

    label = engine.metrics_label
    text = registry().prometheus_text()
    missing = [g for g in ("raytpu_engine_batch_fill", "raytpu_engine_tick_seconds",
                           "raytpu_engine_decode_mfu", "raytpu_engine_token_mix")
               if f'{g}{{engine="{label}"' not in text]
    if missing:
        raise AssertionError(f"/metrics lacks {missing} for engine {label}")
    m = engine.metrics
    closed = _decode_closed_form(config, engine)
    block = engine._decode["plain"]
    replay_ms = _replay_ms(block, iters=5)
    dispatch_ms = _dispatch_ms(block, iters=5)
    replay_mfu = m["decode_flops"] / (replay_ms / 1e3 * PEAK_FLOPS[torch.bfloat16])
    tick_ms = m["tick_seconds"] * 1e3
    to_replay, to_dispatch = tick_ms / replay_ms, tick_ms / dispatch_ms
    follows = ("the block's replay (device) time" if abs(math.log(to_replay))
               < abs(math.log(to_dispatch)) else "the dispatch (host) time")
    log("observe", f"gauges of {label}: batch_fill {m['batch_fill']:.3f}, tick_seconds "
        f"{m['tick_seconds']:.6f}, decode_mfu {m['decode_mfu']:.6f}, decode_flops "
        f"{m['decode_flops']:.6e} (closed form {closed:.6e}, ratio "
        f"{m['decode_flops'] / closed:.6f}); one decode block replay {replay_ms:.3f} ms -> MFU "
        f"{replay_mfu:.6f}; dispatch (host enqueue of the replay) {dispatch_ms:.4f} ms; "
        f"tick_seconds {tick_ms:.3f} ms is {to_replay:.3f} x the replay and "
        f"{to_dispatch:.3f} x the dispatch: nearer {follows}")
    if abs(m["decode_flops"] / closed - 1) > 0.01:
        raise AssertionError("decode_flops is not the decode block's closed form within 1%")
    if not 0 < m["decode_mfu"] <= 1.05:
        raise AssertionError(f"decode_mfu {m['decode_mfu']} outside (0, 1.05]")
    return dict(replay_ms=replay_ms, dispatch_ms=dispatch_ms, tick_ms=tick_ms)


def _observe_user_path(config, params, prompts, path) -> dict:
    """init + serve.run(build_llm_app(...)) with a 1 ms TTFT objective: the
    8 requests streamed through the handle under state.profile(); the
    capture's device kernels, their wall-clock placement, trace_dump's
    merge, the router-started monitor's burn, a repeat at a 60 s objective
    without burn, a postmortem bundle and the serve SLO report."""
    from ray_tpu_torch.util import goodput, postmortem, profiling, state

    cfg.set(serve_slo_ttft_p99_s=OBSERVE_TIGHT_SLO_S,
            serve_slo_check_period_s=OBSERVE_CHECK_PERIOD_S)
    ray_tpu_torch.init(num_gpus=1)
    try:
        t0 = time.perf_counter()
        handle = serve.run(build_llm_app(config, params=params, paged=True, max_slots=N_REQUESTS))
        (engine,) = _replica_engines(handle)
        _handle_run(handle, prompts[:1])  # warm-up: the lazy captures of its passes
        stream = torch.cuda.Stream()
        for p in engine.passes():
            if not p.is_captured:
                p.capture(stream)
        torch.cuda.synchronize()
        log("observe", f"user path: deployed, warmed up and captured in "
            f"{time.perf_counter() - t0:.2f} s")
        from ray_tpu_torch.util.watchdog import serve_slo_monitor

        monitor = serve_slo_monitor()
        if monitor._thread is None:
            raise AssertionError("the router did not start the serve SLO monitor")
        # the capture on this thread (where the earlier phases ran the
        # profiler), the streams on another, started once it runs
        box = {}

        def streams():
            time.sleep(0.3)
            box["run"] = _handle_run(handle, prompts)

        stats0 = engine.stats()
        runner = threading.Thread(target=streams)
        runner.start()
        t0 = time.perf_counter()
        record = state.profile(duration_s=OBSERVE_CAPTURE_S)
        capture_s = time.perf_counter() - t0
        _join([runner])
        wall, t_start, stamps, finals = box["run"]
        stats = _stats_delta(engine, stats0)
        _add_launches(path, stats)
        counted = {"decode": int(stats.get("launches.ragged.decode", 0)),
                   "mixed": int(stats.get("launches.ragged.mixed", 0))}
        (node_hex, meta), = [(nh, m) for nh, m in record["nodes"].items()
                             if not m.get("artifacts_at")]
        if meta["device"] != "ok":
            raise AssertionError(f"the capture's device trace did not run: {meta['device']}")
        artifacts = {name.split("/", 1)[1]: data for name, data in
                     get_runtime().profiles.artifacts_for(record["profile_id"]).items()}
        events = profiling.load_device_trace_events(artifacts, started_at=meta["started_at"],
                                                    max_events=10**7)
        kernels: dict = {}
        for e in events:
            if e["cat"] == "device" and "ragged" in e["name"]:
                kernels[_ragged_name(e["name"])] = kernels.get(_ragged_name(e["name"]), 0) + 1
        lo = meta["started_at"] - OBSERVE_ALIGN_S
        hi = meta["started_at"] + meta["duration_s"] + OBSERVE_ALIGN_S
        device = [e for e in events if e["cat"] == "device"]
        if not device:
            raise AssertionError("the capture holds no device events")
        outside = [e for e in device if not lo <= e["ts"] / 1e6 <= hi]
        main = sum(n for k, n in kernels.items() if "combine" not in k)
        log("observe", f"user path: 8 streams in {wall:.3f} s under state.profile("
            f"duration_s={OBSERVE_CAPTURE_S}), which returned in {capture_s:.2f} s -> profile "
            f"{record['profile_id']}, device "
            f"{meta['device']}, {meta['bytes']} bytes; ragged device kernels {kernels} against "
            f"the engine's {counted} in the window; {len(device)} device events, "
            f"{len(outside)} outside the window +- {OBSERVE_ALIGN_S} s (first "
            f"{(min(e['ts'] for e in device) / 1e6 - meta['started_at']):.4f} s, last "
            f"{(max(e['ts'] for e in device) / 1e6 - meta['started_at']):.4f} s after its start)")
        if not 0 < main <= sum(counted.values()) or outside:
            raise AssertionError(f"the capture's ragged kernels {kernels} or their placement "
                                 f"disagree with the engine's {counted}")
        merged = json.loads(state.trace_dump(profile_id=record["profile_id"]))["traceEvents"]
        merged_device = sum(str(e.get("pid", "")).startswith("device:") for e in merged)
        if not merged_device:
            raise AssertionError("trace_dump merged no device tracks")
        # the router-started monitor burns on the 1 ms objective
        deadline = time.monotonic() + 10
        while _burns("ttft_p99") == 0:
            if time.monotonic() > deadline:
                raise AssertionError("the serve SLO monitor never burned at a 1 ms objective")
            time.sleep(0.05)
        burn_events = state.events(kind="watchdog.slo_burn")
        dominant = [e["extra"].get("dominant_bucket") for e in burn_events
                    if e["extra"].get("dominant_bucket")]
        log("observe", f"trace_dump: {len(merged)} events, {merged_device} on device tracks; "
            f"burn ttft_p99 {_burns('ttft_p99'):.0f}, ttft_p99:default "
            f"{_burns('ttft_p99:default'):.0f}; dominant TTFT bucket of the burns {dominant[-3:]}")
        # the same streams at a 60 s objective: no new burn
        cfg.set(serve_slo_ttft_p99_s=OBSERVE_LOOSE_SLO_S)
        time.sleep(3 * OBSERVE_CHECK_PERIOD_S)
        before = (_burns("ttft_p99"), _burns("ttft_p99:default"))
        stats0 = engine.stats()
        _handle_run(handle, prompts)
        _add_launches(path, _stats_delta(engine, stats0))
        time.sleep(3 * OBSERVE_CHECK_PERIOD_S)
        after = (_burns("ttft_p99"), _burns("ttft_p99:default"))
        log("observe", f"at a {OBSERVE_LOOSE_SLO_S:.0f} s objective: burns {before} before the "
            f"8 streams, {after} after")
        if after != before:
            raise AssertionError("the monitor burned at a 60 s objective")
        ids = [f["request_id"] for f in finals]
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "postmortem.tgz")
            manifest = state.postmortem(out, note="observe phase")
            bundle = postmortem.load_bundle(out)
        request_spans = {s["attrs"].get("request_id") for s in bundle["spans.jsonl"]
                         if s["name"] == "engine.request"}
        profiles = [p["profile_id"] for p in bundle["profiles.json"]]
        kinds = {e.get("kind") for e in bundle["events.jsonl"]}
        log("observe", f"postmortem: counts {manifest['counts']}, errors {manifest['errors']}; "
            f"the 8 requests' engine.request spans {sum(r in request_spans for r in ids)}, "
            f"profile {record['profile_id'] in profiles}, burn events "
            f"{'watchdog.slo_burn' in kinds}, decode_mfu in the metrics text "
            f"{'raytpu_engine_decode_mfu' in bundle['metrics_cluster.prom']}")
        if (not all(r in request_spans for r in ids) or record["profile_id"] not in profiles
                or "watchdog.slo_burn" not in kinds
                or "raytpu_engine_decode_mfu" not in bundle["metrics_cluster.prom"]
                or manifest["errors"]):
            raise AssertionError("the postmortem bundle misses a plane")
        log("observe", f"goodput.serve_slo_report(): {goodput.serve_slo_report()}")
        del engine, handle
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        from ray_tpu_torch.util.watchdog import serve_slo_monitor

        serve_slo_monitor().stop()
        cfg.reset("serve_slo_ttft_p99_s")
        cfg.reset("serve_slo_check_period_s")
    return dict(kernels=kernels, counted=counted)


def _observe_chunk_prefill(config, params) -> None:
    """paged.chunk_prefill_step at Llama width, bitwise against
    batched_chunk_prefill_step at B 1 on the same inputs."""
    from ray_tpu_torch.serve.llm import paged as tpaged

    pc = PagedConfig(num_pages=9, max_pages_per_slot=8)
    rng = np.random.default_rng(SEED + 7)
    n = pc.chunk_tokens - 21
    tokens = torch.zeros((1, pc.chunk_tokens), dtype=torch.int64, device="cuda")
    tokens[0, :n] = torch.from_numpy(rng.integers(0, config.vocab_size, n))
    row = torch.tensor([1, 2, 3, 4, 0, 0, 0, 0], dtype=torch.int32, device="cuda")
    chunk_ids = row[:pc.chunk_pages].long()
    outs = []
    with torch.no_grad():
        for batched in (False, True):
            cache = tpaged.init_paged_cache(config, pc, "cuda")
            if batched:
                logits, cache = tpaged.batched_chunk_prefill_step(
                    params, cache, row[None], chunk_ids[None], tokens,
                    torch.tensor([0], device="cuda"), torch.tensor([n], device="cuda"), config,
                    page_size=pc.page_size)
            else:
                logits, cache = tpaged.chunk_prefill_step(
                    params, cache, row, chunk_ids, tokens, torch.tensor(0, device="cuda"),
                    torch.tensor(n, device="cuda"), config, page_size=pc.page_size)
            outs.append((logits, cache))
    (a, ca), (b, cb) = outs
    same = torch.equal(a, b) and all(torch.equal(ca[k], cb[k]) for k in ca)
    log("observe", f"chunk_prefill_step at {MODEL} width ({n} tokens of a {pc.chunk_tokens}-token "
        f"chunk): logits {tuple(a.shape)} finite {bool(torch.isfinite(a).all())}, bitwise equal to "
        f"batched_chunk_prefill_step at B 1 (logits and pool): {same}")
    if not same or not torch.isfinite(a).all():
        raise AssertionError("chunk_prefill_step differs from batched_chunk_prefill_step at B 1")


def phase_observe(server, config, prompts) -> dict:
    """Serve's observability plane on the card, on the serve phase's
    engine and weights: the marks' cost (on / off), the request timelines
    and engine_snapshot(), the engine gauges with decode_mfu, the user path
    (init, serve.run, streams through the handle under state.profile(), the
    SLO monitor's burn at a tight objective and none at a loose one, a
    postmortem bundle, the serve SLO report) and chunk_prefill_step.
    Returns each kernel's launches on this path (every run but the
    profiled repeats) and the capture's ragged device kernels."""
    t_phase = time.perf_counter()
    engine = server.engine
    path: dict = {}
    for k in KERNELS:
        k.launches = 0
    steps = {}
    t0 = time.perf_counter()
    _observe_marks_cost(engine, prompts, path)
    steps["marks on / off"], t0 = time.perf_counter() - t0, time.perf_counter()
    _observe_timelines(engine, prompts, config, path)
    steps["timelines"], t0 = time.perf_counter() - t0, time.perf_counter()
    gauges = _observe_gauges(engine, config)
    steps["gauges"], t0 = time.perf_counter() - t0, time.perf_counter()
    user = _observe_user_path(config, engine.params, prompts, path)
    steps["user path"], t0 = time.perf_counter() - t0, time.perf_counter()
    _observe_chunk_prefill(config, engine.params)
    steps["chunk prefill"] = time.perf_counter() - t0
    launches = {k.name: k.launches + path.get(k.name, 0) for k in KERNELS}
    log("observe", f"launches on the observe path {launches}; seconds by step "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
        + f" ({time.perf_counter() - t_phase:.2f} s)")
    if not launches[RAGGED.name]:
        raise AssertionError("the observe path never launched the ragged kernels")
    return dict(launches=launches, profiled=user["kernels"], gauges=gauges)


# ------------------------------------------------------------------ cluster


def _cuda_pids_left(pid: int, timeout: float = 30.0) -> tuple:
    """(in the process table, among nvidia-smi's compute apps) for `pid`,
    waiting up to `timeout` for both to clear."""
    deadline = time.monotonic() + timeout
    while True:
        alive = os.path.exists(f"/proc/{pid}")
        on_card = pid in udfs.compute_app_pids()
        if not (alive or on_card) or time.monotonic() > deadline:
            return alive, on_card
        time.sleep(0.25)


class _Members:
    """The cluster phase's cluster, which the head_restart phase goes on
    with: a CLI head that persists its GCS (snapshots at <tmp>/gcs.snap,
    the WAL beside them), one CLI agent with the card, both in JAX's drill
    environment (HEAD_DRILL_ENV), and this process joined with no GPU."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
        self.snap = os.path.join(self.tmp, "gcs.snap")
        self.address = f"127.0.0.1:{_free_port()}"
        self.root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, **HEAD_DRILL_ENV)
        env.pop("RAY_TPU_CHAOS", None)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (self.root, env.get("PYTHONPATH")) if p)
        self.env = env
        self.head_cmd = [sys.executable, "-m", "ray_tpu_torch", "start", "--head", "--num-cpus",
                         "1", "--num-gpus", "0", "--port", self.address.rsplit(":", 1)[1],
                         "--snapshot-path", self.snap]
        self.logs = {name: os.path.join(self.tmp, f"{name}.log")
                     for name in ("head0", "head1", "head2", "agent")}
        self.head_log = "head0"  # the current head's
        self.procs: dict = {}
        self.saved = {k: getattr(cfg, k) for k in ("node_heartbeat_s", "node_stale_s")}
        self.joined = False

    def spawn(self, cmd, name, extra=None):
        with open(self.logs[name], "w") as f:
            return subprocess.Popen(cmd, env=dict(self.env, **(extra or {})), stdout=f,
                                    stderr=subprocess.STDOUT, text=True, cwd=self.root)

    def start(self):
        """Head, agent, this process joined; returns the agent's node."""
        cfg.set(node_heartbeat_s=0.2, node_stale_s=2.5)  # the drill's, in this process too
        self.procs["head"] = self.spawn(self.head_cmd, "head0")
        _wait_log(self.logs["head0"], "head up", self.procs["head"])
        self.procs["agent"] = self.spawn(
            [sys.executable, "-m", "ray_tpu_torch", "start", "--address", self.address,
             "--num-cpus", "2", "--num-gpus", "1"], "agent")
        _wait_log(self.logs["agent"], " joined ", self.procs["agent"])
        self.up_s = time.perf_counter() - self.t0
        ray_tpu_torch.init(address=self.address, num_cpus=1, num_gpus=0)
        self.joined = True
        deadline = time.monotonic() + 60
        while True:
            agent = next((n for n in get_runtime().scheduler.nodes()
                          if n.is_remote and n.resources.total.get("GPU", 0) >= 1), None)
            if agent is not None:
                return agent
            if time.monotonic() > deadline:
                raise AssertionError("this process never saw the agent's GPU")
            time.sleep(0.1)

    def restart_head(self, chaos: bool) -> float:
        """Restore the head on the same port (armed with chaos's kill_head
        when `chaos`); returns when its log says it is up."""
        name = "head1" if chaos else "head2"
        self.head_log = name
        extra = ({"RAY_TPU_CHAOS": f"kill_head=1,delay_s={HEAD_CHAOS_DELAY_S},max_injections=1"}
                 if chaos else None)
        self.procs["head"] = self.spawn(self.head_cmd + ["--restore"], name, extra)
        return _wait_log(self.logs[name], "head up", self.procs["head"])

    def dump(self, phase: str) -> None:
        """Every member's log tail, this process's membership events and the
        nodes' captured logs: a failure's diagnostics."""
        for name, path in self.logs.items():
            if os.path.exists(path):
                with open(path) as f:
                    log(phase, f"{name} log's tail:\n{f.read()[-3000:]}")
        _head_drill_diagnostics(self.t0_wall, self.joined)

    def stop(self) -> dict:
        """This process leaves, then the agent and the head (the head writes
        its final snapshot); returns, by member, (in the process table,
        among the card's compute apps) once they are gone."""
        if self.joined:
            ray_tpu_torch.shutdown()
            self.joined = False
        if "agent" in self.procs:
            _stop_member(self.procs["agent"], self.logs["agent"])
        if "head" in self.procs:
            _stop_member(self.procs["head"], self.logs[self.head_log])
        cfg.set(**self.saved)
        left = {name: _cuda_pids_left(proc.pid) for name, proc in self.procs.items()}
        shutil.rmtree(self.tmp, ignore_errors=True)
        return left


def phase_cluster(card, config, prompts) -> tuple:
    """Cluster mode on the card: a CLI head, one node agent hosting the
    work on the card, this process a member (see the module docstring,
    `cluster`). Returns the phase's numbers (the agent's launches by
    kernel among them), the live members, the agent's LLM actor and the
    agent's node, which the head_restart phase goes on with."""
    from ray_tpu_torch.core.health import probe_agent
    from ray_tpu_torch.core.object_store import Tier
    from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy

    log("cluster", f"{card}: the driver holds {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, before the cluster")
    ray_tpu_torch.shutdown()
    t0 = time.perf_counter()
    members = _Members()
    out: dict = {}
    try:
        agent = members.start()
        agent_pid = members.procs["agent"].pid
        out["agent_start_s"] = members.up_s
        on = NodeAffinitySchedulingStrategy(agent.node_id)
        with open(members.logs["agent"]) as f:
            joined = next((ln.strip() for ln in f if " joined " in ln), "")
        log("cluster", f"{card}: head pid {members.procs['head'].pid} at {members.address} "
            f"(snapshots at {members.snap}), agent pid {agent_pid} at {agent.agent_addr} with "
            f"{agent.resources.total.get('GPU', 0)} GPU, up {out['agent_start_s']:.2f} s after the "
            f"head's spawn (head + agent start-up); the agent's log: {joined!r}")

        # (a) objects across nodes
        ref = ray_tpu_torch.remote(cluster_udfs.seeded_bytes).options(
            scheduling_strategy=on).remote(SEED, CLUSTER_CPU_BYTES)
        mine = cluster_udfs.seeded_bytes(SEED, CLUSTER_CPU_BYTES)
        ray_tpu_torch.wait([ref], timeout=300)
        entry = get_runtime().object_store.entry(ref.object_id)
        if entry.tier != Tier.REMOTE:
            raise AssertionError(f"the 1 GiB result arrived as {entry.tier}, not a placeholder")
        t = time.perf_counter()
        got = ray_tpu_torch.get(ref, timeout=300)
        pull_s = time.perf_counter() - t
        if got.dtype != torch.uint8 or got.numel() != CLUSTER_CPU_BYTES or not torch.equal(got, mine):
            raise AssertionError("the 1 GiB CPU tensor pulled from the agent differs")
        out["pull_gb_s"] = CLUSTER_CPU_BYTES / pull_s / 1e9
        del got, mine, ref, entry
        copies0 = ray_tpu_torch.get(ray_tpu_torch.remote(cluster_udfs.wire_stats).options(
            scheduling_strategy=on).remote(), timeout=120)["cuda_host_copies"]
        ref = ray_tpu_torch.remote(num_gpus=1)(cluster_udfs.seeded_cuda_bf16).options(
            scheduling_strategy=on).remote(SEED, CLUSTER_CUDA_NUMEL)
        ray_tpu_torch.wait([ref], timeout=300)
        t = time.perf_counter()
        got = ray_tpu_torch.get(ref, timeout=300)
        cuda_s = time.perf_counter() - t
        want = cluster_udfs.seeded_cuda_bf16(SEED, CLUSTER_CUDA_NUMEL)
        copies = ray_tpu_torch.get(ray_tpu_torch.remote(cluster_udfs.wire_stats).options(
            scheduling_strategy=on).remote(), timeout=120)["cuda_host_copies"] - copies0
        if got.device != torch.device("cuda", torch.cuda.current_device()) \
                or not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"the 256 MiB CUDA tensor landed on {got.device} or differs")
        if copies != 1:
            raise AssertionError(f"the agent made {copies} host copies of the CUDA tensor, not 1")
        out["cuda_pull_gb_s"] = got.nbytes / cuda_s / 1e9
        del got, want, ref
        torch.cuda.empty_cache()
        noop = ray_tpu_torch.remote(cluster_udfs.Noop).options(scheduling_strategy=on).remote()
        ray_tpu_torch.get(noop.ping.remote(), timeout=120)
        times = []
        for _ in range(CLUSTER_CALLS):
            t = time.perf_counter()
            ray_tpu_torch.get(noop.ping.remote(), timeout=60)
            times.append((time.perf_counter() - t) * 1e6)
        ray_tpu_torch.kill(noop)
        times.sort()
        out["call_p50_us"] = statistics.median(times)
        out["call_p90_us"] = times[int(0.9 * len(times))]
        log("cluster", f"{card}: (a) 1 GiB CPU tensor pulled in {pull_s:.3f} s = "
            f"{out['pull_gb_s']:.3f} GB/s, bit-equal; 256 MiB bf16 CUDA tensor on "
            f"cuda:{torch.cuda.current_device()} in {cuda_s:.3f} s = {out['cuda_pull_gb_s']:.3f} "
            f"GB/s, bit-equal, {copies} host copy on the agent; no-op actor call round trip p50 "
            f"{out['call_p50_us']:.1f} us p90 {out['call_p90_us']:.1f} us over {CLUSTER_CALLS}")

        # (b) serving from the agent
        t = time.perf_counter()
        llm = ray_tpu_torch.remote(num_cpus=1, num_gpus=1)(cluster_udfs.ClusterLLM).options(
            scheduling_strategy=on).remote(MODEL, SEED, N_REQUESTS, CLUSTER_LAYERS)
        info = ray_tpu_torch.get(llm.info.remote(), timeout=900)
        if info["pid"] != agent_pid:
            raise AssertionError(f"the LLM actor runs in pid {info['pid']}, not the agent's")
        log("cluster", f"{card}: agent LLMServer({MODEL}, {CLUSTER_LAYERS} layers) built in "
            f"{info['build_s']:.2f} s "
            f"({time.perf_counter() - t:.2f} s from the call), {info['captures']} CUDA graphs, "
            f"{info['allocated'] / 2**30:.2f} GiB allocated on the agent's {info['device']}")
        res = ray_tpu_torch.get(llm.serve.remote(prompts, MAX_TOKENS, TAIL_GAP,
                                                 [0, len(prompts) - 1]), timeout=900)
        for o in res["outs"]:
            if len(o) != MAX_TOKENS or not all(0 <= tok < config.vocab_size for tok in o):
                raise AssertionError(f"bad completion from the agent: {len(o)} tokens")
        out["decode_tok_s"] = res["decode_tok_s"]
        out["launches"] = {k.name: int(res["launches"].get(k.name, 0)) for k in KERNELS}
        log("cluster", f"{card}: (b) {N_REQUESTS} requests on the agent: wall {res['wall_s']:.3f} s, "
            f"decode {res['decode_tok_s']:.1f} tok/s; launches counted in the agent "
            f"{out['launches']}")
        _dense_verdict("cluster", res["check"], res["launches"][FLASH_FWD.name], CHECK_MARGIN,
                       EXACT_SHARE_FLOOR, seconds=res["check_s"])
        if out["launches"][RAGGED.name] <= 0 or out["launches"][FLASH_FWD.name] <= 0:
            raise AssertionError(f"the agent's path launched no ragged or flash kernel: "
                                 f"{out['launches']}")

        # (c) the agent answers its probe; the members stay for head_restart
        if not probe_agent(agent):
            raise AssertionError("probe_agent found the live agent down")
    except BaseException:
        members.dump("cluster")
        members.stop()
        raise
    log("cluster", f"{card}: phase {time.perf_counter() - t0:.1f} s (the members stay up for "
        f"head_restart)")
    return out, members, llm, agent


# ------------------------------------------------------------- head_restart

HEAD_DRILL_ENV = {"RAY_TPU_NODE_HEARTBEAT_S": "0.2", "RAY_TPU_NODE_STALE_S": "2.5",
                  "RAY_TPU_GCS_SNAPSHOT_INTERVAL_S": "0.5"}  # JAX's drill (bench_cluster.py)
HEAD_CHAOS_DELAY_S = 5.0  # the restored head dies by chaos this long after it arms
# the agent's profile capture under traffic after the second restore: its
# stop holds the agent ~8 s a second of window (PERF.md, Head restart)
HEAD_CAPTURE_S = 1.0
HEAD_STALE_S = float(HEAD_DRILL_ENV["RAY_TPU_NODE_STALE_S"])
HEAD_MEMORY_TOL = 0.01  # the node table's CUDA memory against the actor's own reading


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_log(path: str, needle: str, proc, timeout: float = 180.0) -> float:
    """Wait until `needle` shows in the log at `path`; returns when."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(path) as f:
            if needle in f.read():
                return time.perf_counter()
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    with open(path) as f:
        raise AssertionError(f"never saw {needle!r} (rc {proc.poll()}) in {path}:\n{f.read()[-4000:]}")


def _stop_member(proc, log_path: str) -> None:
    """Ask a CLI member to leave (the shutdown_node RPC at the node address
    its log names: the head writes a final snapshot), then wait for it;
    kill it if it does not leave."""
    from ray_tpu_torch.core.rpc import RpcClient

    if proc.poll() is not None:
        return
    with open(log_path) as f:
        address = next((ln.split("agent at ", 1)[1].split()[0] for ln in f
                        if "agent at " in ln), None)
    if address is None:
        proc.kill()
        proc.wait(timeout=30)
    else:
        client = RpcClient(address, timeout=10.0, retries=0)
        try:
            client.call("shutdown_node")
        except Exception:  # noqa: BLE001 - killed below if it does not leave
            pass
        finally:
            client.close()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _agent_kernels(record: dict, agent_hex: str) -> dict:
    """K5's and K1's device kernels in the agent's part of a capture."""
    from ray_tpu_torch.util import profiling

    meta = record["nodes"][agent_hex]
    artifacts = {name.split("/", 1)[1]: data for name, data in
                 get_runtime().profiles.artifacts_for(record["profile_id"],
                                                      node_hex=agent_hex).items()}
    events = profiling.load_device_trace_events(artifacts, started_at=meta["started_at"],
                                                max_events=10**7)
    out = {RAGGED.name: 0, FLASH_FWD.name: 0}
    for e in events:
        if e["cat"] != "device":
            continue
        if "ragged" in e["name"] and "combine" not in e["name"]:
            out[RAGGED.name] += 1
        elif "flash_fwd" in e["name"]:
            out[FLASH_FWD.name] += 1
    return out


def _head_drill_diagnostics(t0_wall: float, joined: bool) -> None:
    """On a failed drill: this process's membership events and the
    agent's captured log tail (its node_logs RPC), times from the phase's
    start."""
    from ray_tpu_torch.util.events import events

    kinds = ("head.unreachable", "head.reconnected", "node.dead", "node.discovered",
             "node.purged", "gcs.restored", "head.reconciled")
    lines = [f"{e['ts'] - t0_wall:8.3f} {e['kind']} {e['message']}"
             for e in events().list(limit=2000) if e.get("kind") in kinds and e["ts"] >= t0_wall]
    log("head_restart", "this process's membership events:\n" + "\n".join(lines[-80:]))
    if not joined:
        return
    try:
        tails = get_runtime().cluster.fanout_nodes("node_logs", 150,
                                                   placeholder=lambda e: [repr(e)])
        for node_hex, tail in tails.items():
            log("head_restart", f"node {node_hex[:12]}'s captured log:\n" + "\n".join(tail[-150:]))
    except Exception as exc:  # noqa: BLE001 - diagnostics of a failure already raising
        log("head_restart", f"the nodes' logs: {exc!r}")


def phase_head_restart(card, prompts, members, llm, agent) -> dict:
    """Llama-3-8B serving from the cluster phase's node agent through two
    deaths of the head (see the module docstring, `head_restart`); stops
    the members at its end. Returns the agent's launches by kernel and the
    phase's numbers."""
    from ray_tpu_torch.core.cluster import NODE_NS, REQLOG_NS
    from ray_tpu_torch.core.exceptions import StaleEpochError
    from ray_tpu_torch.core.gcs_service import GcsClient
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.metrics import cluster_prometheus_text

    t0 = time.perf_counter()
    agent_hex = agent.node_id.hex()
    out: dict = {"restarts": []}
    calls: list = []  # (t_done, index, result) of every serve call, in order
    errors: list = []  # (where, exception)
    acks: list = []  # (t_ack, i) of every acknowledged write
    stop = threading.Event()
    in_flight = threading.Event()
    try:
        first = GcsClient(members.address, retry_window_s=30.0)
        epoch0 = first.adopt_epoch()
        zombie = GcsClient(members.address, retry_window_s=30.0)
        zombie.pin_epoch(zombie.adopt_epoch())
        ray_tpu_torch.get(llm.reset_counts.remote(), timeout=60)

        def serve_loop():
            i = 0
            while not stop.is_set():
                in_flight.set()
                try:
                    res = ray_tpu_torch.get(llm.serve_once.remote(
                        prompts[i % len(prompts)], MAX_TOKENS, TAIL_GAP), timeout=300)
                    calls.append((time.perf_counter(), i, res))
                except BaseException as exc:  # noqa: BLE001 - the phase's verdict
                    errors.append(("serve", exc))
                    time.sleep(0.5)
                finally:
                    in_flight.clear()
                i += 1

        def writer():
            c = GcsClient(members.address, retry_window_s=90.0)
            c.adopt_epoch()
            i = 0
            while not stop.is_set():
                try:
                    if c.kv_put(f"w{i}", {"i": i}, namespace="drill"):
                        acks.append((time.perf_counter(), i))
                except BaseException as exc:  # noqa: BLE001 - the phase's verdict
                    errors.append(("writer", exc))
                i += 1
                time.sleep(0.05)
            c.close()

        threads = [threading.Thread(target=serve_loop, name="head-serve", daemon=True),
                   threading.Thread(target=writer, name="head-writer", daemon=True)]
        for th in threads:
            th.start()
        deadline = time.monotonic() + 300
        while len(calls) < len(prompts) + 2:  # a whole round, and more, before the kill
            if errors or time.monotonic() > deadline:
                raise AssertionError(f"the serve loop before the outages: {errors}")
            time.sleep(0.05)

        def restart(label, death_t, chaos):
            """Restore the head on the same port; returns the restart's
            record once the restored head acknowledged a write."""
            rec = {"label": label, "snapshot_bytes": os.path.getsize(members.snap)
                   if os.path.exists(members.snap) else 0,
                   "wal_bytes": os.path.getsize(members.snap + ".wal")
                   if os.path.exists(members.snap + ".wal") else 0}
            rec["up_t"] = members.restart_head(chaos)
            deadline = time.monotonic() + 90
            while not any(t_ack > death_t for t_ack, _ in list(acks)):
                if errors or time.monotonic() > deadline:
                    raise AssertionError(f"no write acknowledged after the restart: {errors}")
                time.sleep(0.02)
            rec["recovery_ready_s"] = min(t_ack for t_ack, _ in acks if t_ack > death_t) - death_t
            rec["head_up_s"] = rec["up_t"] - death_t
            probe = GcsClient(members.address, retry_window_s=30.0)
            head = probe.head_info()
            probe.close()
            rec["epoch"] = head["epoch"]
            rec["wal_records_applied"] = head["restore"].get("wal_records_applied")
            rec["wal_quarantined_bytes"] = head["restore"].get("wal_quarantined_bytes")
            return rec

        # (a) SIGKILL while a serve call is in flight
        in_flight.wait(60)
        n_before = len(calls)
        death_a = time.perf_counter()
        members.procs["head"].send_signal(signal.SIGKILL)
        members.procs["head"].wait(timeout=60)
        rec_a = restart("(a) SIGKILL", death_a, chaos=True)
        rec_a.update(death_t=death_a, calls_before=n_before)
        out["restarts"].append(rec_a)
        # (b) the restored head dies by chaos (kill_head) during traffic
        members.procs["head"].wait(timeout=HEAD_CHAOS_DELAY_S + 120)
        death_b = time.perf_counter()
        if members.procs["head"].returncode != 137:
            raise AssertionError(f"the chaos-armed head exited {members.procs['head'].returncode}, not 137")
        rec_b = restart("(b) chaos kill_head", death_b, chaos=False)
        rec_b.update(death_t=death_b, calls_before=len([c for c in calls if c[0] < death_b]))
        out["restarts"].append(rec_b)
        n_after = len(calls)
        deadline = time.monotonic() + 120
        while len(calls) < n_after + 2:  # traffic after the second restore too
            if errors or time.monotonic() > deadline:
                raise AssertionError(f"the serve loop after the restores: {errors}")
            time.sleep(0.05)

        # the agent's first capture, fanned out from here while the serve
        # loop runs: the profiler's stop holds the agent's process (its
        # heartbeats stop), and the agent must stay live meanwhile; the
        # head's view of the agent's report age is sampled throughout
        ages: list = []
        sampling = threading.Event()

        def sample_age():
            c = GcsClient(members.address, retry_window_s=30.0)
            while not sampling.is_set():
                node = c.cluster_view()["nodes"].get(agent_hex)
                ages.append(node["age_s"] if node else None)
                sampling.wait(0.1)
            c.close()

        sampler = threading.Thread(target=sample_age, name="head-age", daemon=True)
        sampler.start()
        t = time.perf_counter()
        n_at_capture = len(calls)
        record = state.profile(nodes=[agent_hex[:12]], duration_s=HEAD_CAPTURE_S)
        capture_s = time.perf_counter() - t
        sampling.set()
        sampler.join(timeout=60)
        meta = record["nodes"].get(agent_hex, {})
        if meta.get("device") != "ok":
            raise AssertionError(f"the agent's capture did not trace the card: {meta}")
        captured = _agent_kernels(record, agent_hex)
        if None in ages:
            raise AssertionError(f"the agent left the head's view during its capture: ages {ages}")
        from ray_tpu_torch.util.events import events

        if any(e.get("kind") == "node.dead" and e.get("node") == agent_hex
               for e in events().list(limit=5000)):
            raise AssertionError("this process declared the agent dead during the drill")
        deadline = time.monotonic() + 120
        while len(calls) < n_at_capture + 2:  # traffic after the capture too
            if errors or time.monotonic() > deadline:
                raise AssertionError(f"the serve loop after the capture: {errors}")
            time.sleep(0.05)
        out["capture"] = dict(kernels=captured, bytes=meta.get("bytes"), pid=meta.get("pid"),
                              seconds=capture_s, max_age_s=max(ages),
                              calls=len(calls) - n_at_capture)

        stop.set()
        for th in threads:
            th.join(timeout=360)
        if any(th.is_alive() for th in threads):
            raise AssertionError("the serve loop or the writer did not stop")
        stopped_ts = time.time()

        # verdicts on the traffic
        if errors:
            raise AssertionError(f"calls raised during the drill: {errors[:5]}")
        first_tokens = {}
        for _, i, res in calls:
            first_tokens.setdefault(i % len(prompts), res["tokens"])
        bad = [(i, p) for _, i, res in calls
               for p in [next((k for k, (a, b) in enumerate(zip(res["tokens"],
                                                              first_tokens[i % len(prompts)]))
                               if a != b), None)]
               if res["tokens"] != first_tokens[i % len(prompts)]]
        if bad:
            raise AssertionError(f"calls whose tokens differ from the first call's of their "
                                 f"prompt (call, first position): {bad[:10]}")
        pids = {res["pid"] for _, _, res in calls}
        if pids != {members.procs["agent"].pid}:
            raise AssertionError(f"the actor ran in {pids}, not only the agent {members.procs['agent'].pid}")
        joint = dict(worst=0.0, exact=0, total=0, over_tail=0, per={})
        for _, i, res in calls[:len(prompts)]:
            ck = res["check"]
            joint["worst"] = max(joint["worst"], ck["worst"])
            for key in ("exact", "total", "over_tail"):
                joint[key] += ck[key]
            joint["per"][i] = ck["per"][0]
        worst_all = max(res["check"]["worst"] for _, _, res in calls)
        if worst_all > CHECK_MARGIN:
            raise AssertionError(f"a call's engine token scores {worst_all:.4f} below the dense argmax")
        kernel_stats = ray_tpu_torch.get(llm.stats.remote(), timeout=120)
        out["launches"] = {k.name: int(kernel_stats["launches"].get(k.name, 0)) for k in KERNELS}
        _dense_verdict("head_restart", joint, out["launches"][FLASH_FWD.name], CHECK_MARGIN,
                       EXACT_SHARE_FLOOR,
                       seconds=sum(res["check_s"] for _, _, res in calls[:len(prompts)]))
        windows = [("before (a)", 0.0, death_a), ("outage (a)", death_a, rec_a["up_t"]),
                   ("between", rec_a["up_t"], death_b), ("outage (b)", death_b, rec_b["up_t"]),
                   ("after (b)", rec_b["up_t"], float("inf"))]
        out["windows"] = {}
        for label, lo, hi in windows:
            inside = [res for t_done, _, res in calls if lo <= t_done < hi]
            out["windows"][label] = dict(
                calls=len(inside),
                decode_tok_s=(statistics.median(r["decode_tok_s"] for r in inside)
                              if inside else 0.0))
        for label in ("outage (a)", "outage (b)"):
            if out["windows"][label]["calls"] <= 0:
                raise AssertionError(f"no serve call finished inside {label}")
        if out["launches"][RAGGED.name] <= 0 or out["launches"][FLASH_FWD.name] <= 0:
            raise AssertionError(f"the agent's path launched no ragged or flash kernel: "
                                 f"{out['launches']}")
        if not all(captured.values()):
            raise AssertionError(f"the agent's capture holds no K5 or K1 launch: {captured}")

        # the writes, the epoch, the zombie
        probe = GcsClient(members.address, retry_window_s=30.0)
        missing = [i for _, i in acks if probe.kv_get(f"w{i}", namespace="drill") is None]
        if missing:
            raise AssertionError(f"acknowledged writes lost: {missing[:10]} of {len(acks)}")
        epoch = probe.head_info()["epoch"]
        if epoch != epoch0 + 2:
            raise AssertionError(f"the epoch went from {epoch0} to {epoch}, not up by 2")
        try:
            zombie.kv_put("zombie-write", 1, namespace="drill")
            raise AssertionError("the zombie writer pinned to the first epoch was not fenced")
        except StaleEpochError:
            pass

        # federation after the second restore
        outage_rids = [res["rid"] for t_done, _, res in calls
                       if death_a <= t_done < rec_a["up_t"] or death_b <= t_done < rec_b["up_t"]]
        rid = outage_rids[-1]
        deadline = time.monotonic() + 30
        while True:
            table = probe.kv_get(agent_hex, namespace=REQLOG_NS) or []
            mine = [m for m in table if m.get("rid") == rid]
            info_rec = probe.kv_get(agent_hex, namespace=NODE_NS) or {}
            lag = info_rec.get("federation_lag") or {}
            if (mine and lag and not any(lag.values())
                    and (info_rec.get("stats") or {}).get("ts", 0) > stopped_ts):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"the agent's federation did not drain: lag {lag}, "
                                     f"{len(mine)} marks of {rid}")
            time.sleep(0.1)
        phases = [m["phase"] for m in mine]
        seqs = [m["seq"] for m in mine]
        if len(seqs) != len(set(seqs)) or any(
                phases.count(p) != 1 for p in ("engine.submitted", "engine.first_token",
                                               "engine.finished")):
            raise AssertionError(f"the _requests table's marks of {rid}: {phases} seqs {seqs}")
        timeline = state.request_timeline(rid)
        if [m["phase"] for m in timeline] != phases or {m["node"] for m in timeline} != {agent_hex}:
            raise AssertionError(f"request_timeline({rid}) from this process: "
                                 f"{[(m['phase'], m['node'][:12]) for m in timeline]}")
        prom = cluster_prometheus_text()
        agent_samples = sum(f'node_id="{agent_hex}"' in ln for ln in prom.splitlines())
        if not agent_samples:
            raise AssertionError("cluster_prometheus_text() has no sample of the agent's node")
        cuda_rec = (info_rec["stats"].get("cuda") or [{}])[0]
        held = ray_tpu_torch.get(llm.stats.remote(), timeout=60)["allocated"]
        table_bytes = cuda_rec.get("memory_allocated_bytes", 0)
        if abs(table_bytes - held) > HEAD_MEMORY_TOL * held:
            raise AssertionError(f"the node table's CUDA memory {table_bytes} is not within "
                                 f"{HEAD_MEMORY_TOL:.0%} of the actor's {held}")
        probe.close()
        first.close()
        zombie.close()
        log("head_restart", f"{card}: federation after the second restore: request {rid} "
            f"(served during an outage) has {phases} in the head's _requests table, each mark "
            f"once (seqs {seqs}); request_timeline from this process: the same marks on the agent's "
            f"node; {agent_samples} Prometheus samples labelled with the agent's node; the node "
            f"table's CUDA block {cuda_rec.get('kind')}: {table_bytes / 2**30:.3f} GiB allocated "
            f"against the actor's {held / 2**30:.3f} GiB; federation lag {lag}; the agent's "
            f"first capture, under the serve loop ({HEAD_CAPTURE_S} s window): returned in "
            f"{out['capture']['seconds']:.2f} s, {out['capture']['bytes']} bytes, pid "
            f"{out['capture']['pid']}, {captured}; the agent live in the head's view throughout, "
            f"its report age there up to {out['capture']['max_age_s']:.3f} s (node_stale_s "
            f"{HEAD_STALE_S}); {out['capture']['calls']} serve calls finished from its start "
            f"to the drill's end")
        for rec in out["restarts"]:
            log("head_restart", f"{card}: restart {rec['label']}: head up {rec['head_up_s']:.3f} s "
                f"after the death, recovery_ready_s {rec['recovery_ready_s']:.3f} (death to the "
                f"first write the restored head acknowledged), epoch {rec['epoch']}, "
                f"wal_records_applied {rec['wal_records_applied']}, quarantined "
                f"{rec['wal_quarantined_bytes']} bytes; at the restart the snapshot held "
                f"{rec['snapshot_bytes']} bytes and the WAL {rec['wal_bytes']}")
        log("head_restart", f"{card}: serve calls and median decode tok/s by window: "
            + "; ".join(f"{k} {v['calls']} calls {v['decode_tok_s']:.1f} tok/s"
                        for k, v in out["windows"].items())
            + f"; {len(calls)} calls, {len(acks)} writes acknowledged, none lost; epoch "
            f"{epoch0} -> {epoch}; the zombie fenced (StaleEpochError); launches counted in the "
            f"agent {out['launches']}")
        ray_tpu_torch.get(llm.shutdown.remote(), timeout=300)
        ray_tpu_torch.kill(llm)
        llm = None
    except BaseException:
        stop.set()
        members.dump("head_restart")
        raise
    finally:
        stop.set()
        left = members.stop()
    out["seconds"] = time.perf_counter() - t0
    log("head_restart", f"{card}: after the drill (in the process table, among the card's "
        f"compute apps): {left}; phase {out['seconds']:.1f} s")
    if any(a or b for a, b in left.values()):
        raise AssertionError(f"a member outlived the drill: {left}")
    return out


# ------------------------------------------------------------------ tp_serve


def _tp_mesh():
    """A tp = TP mesh whose shards share the one card."""
    return build_mesh(MeshSpec(tp=TP), devices=["cuda:0"] * TP)


def _wrapper_launches(path: dict, fn):
    """fn(), its launches through the kernel wrappers added to `path`."""
    before = {k.name: k.launches for k in KERNELS}
    out = fn()
    for k in KERNELS:
        path[k.name] = path.get(k.name, 0) + k.launches - before[k.name]
    return out


def _tp_run(label, engine, prompts, path=None) -> dict:
    """The requests at once on an engine (after a warm-up request): wall,
    TTFT, decode rate, tokens; the run's engine-counted launches are added
    to `path` (the tp engines' runs)."""
    engine.generate([1] * 64, max_tokens=2)
    before = engine.stats()
    wall, t_start, stamps, _ = _serve_run(engine, prompts)
    stats = _stats_delta(engine, before)
    if path is not None:
        _add_launches(path, stats)
    outs = [[tok for _, tok in st] for st in stamps]
    ttft = [st[0][0] - t_start for st in stamps]
    decode = sum(len(st) - 1 for st in stamps) / (max(st[-1][0] for st in stamps)
                                                   - min(st[0][0] for st in stamps))
    runs = {p.name: int(stats[f"passes.{p.name}"]) for p in engine.passes()}
    log("tp_serve", f"{label}: wall {wall:.3f} s, TTFT p50 {statistics.median(ttft):.3f} s max "
        f"{max(ttft):.3f} s, decode {decode:.1f} tok/s; graph replays {runs}; ragged launches "
        f"(replays x captured) {int(stats.get(f'launches.{RAGGED.name}', 0))} (mixed ticks "
        f"{int(stats.get('launches.ragged.mixed', 0))}, decode steps "
        f"{int(stats.get('launches.ragged.decode', 0))})")
    return dict(outs=outs, stats=stats, wall_s=wall, ttft_p50_s=statistics.median(ttft),
                ttft_max_s=max(ttft), decode_tok_s=decode)


def _tp_capture_log(label, engine, base=None) -> None:
    """The engine's captures (time, memory) and the ragged launches each
    recorded; with `base`, each must be TP times the tp = 1 engine's for
    the same pass (each shard launches once a layer and step)."""
    passes = engine.passes()
    caps = {p.name: p.captured.get(RAGGED.name, 0) for p in passes}
    log("tp_serve", f"{label}: precompile: {len(passes)} CUDA graphs captured in "
        f"{engine.capture_s:.3f} s (" + ", ".join(f"{p.name} {p.capture_s:.3f} s" for p in passes)
        + f"); after capture {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; ragged launches each capture "
        f"recorded {caps}")
    if not all(p.is_captured for p in passes) or not all(caps.values()):
        raise AssertionError(f"{label}: a pass without its graph or without the ragged kernels")
    if base is not None:
        want = {p.name: TP * p.captured.get(RAGGED.name, 0) for p in base.passes()}
        if caps != want:
            raise AssertionError(f"{label}: ragged launches captured {caps}, not {TP} x the "
                                 f"tp = 1 engine's {want}")


def _tp_compare(label, config, params, prompts, ref, got, path) -> int:
    """tp = TP's greedy tokens against tp = 1's, request by request. At
    the first position where a request differs, tp = 1's dense f32 logits
    (the flash forward over the prompt and tp = 1's tokens before it) must
    have their top two within TP_NEAR_TIE; nothing after it is compared.
    Returns the positions compared equal."""
    equal = 0
    for i, (a, b) in enumerate(zip(ref, got)):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None and len(a) == len(b):
            equal += len(a)
            continue
        if j is None:
            raise AssertionError(f"{label}: request {i} has {len(b)} tokens, not {len(a)}")
        equal += j
        tokens = torch.tensor([prompts[i] + a[:j]], device="cuda")
        with torch.no_grad():
            row = _wrapper_launches(path, lambda: forward(params, tokens, config))[0, -1].float()
        top = row.topk(2).values
        gap = (top[0] - top[1]).item()
        log("tp_serve", f"{label}: request {i} first differs at generated position {j} "
            f"(tp = 1 {a[j]}, tp = {TP} {b[j]}); tp = 1's dense logits' top-2 gap there "
            f"{gap:.3e} (allowed under {TP_NEAR_TIE})")
        if gap >= TP_NEAR_TIE:
            raise AssertionError(f"{label}: request {i} differs at position {j}, not a near-tie "
                                 f"({gap:.3e})")
    return equal


def _tp_copy_page_drill(engine) -> None:
    """copy_page over every shard's pool on the idle tp engine: a page the
    prefix cache pins (real KV) copied to a free page, each layer's stripe
    equal in every shard's pool, bitwise, then the page returned."""
    src = next(row["page"] for row in engine.prefix_cache.chain_heads())
    dst = engine.allocator.alloc(1)[0]
    copy_page(engine.cache, src, dst, n_layers=engine.model_config.n_layers, mesh=engine.mesh)
    num_pages = engine.paged.num_pages
    stripes = [i * num_pages for i in range(engine.model_config.n_layers)]
    same = all(torch.equal(pool[n][:, [dst + s for s in stripes]], pool[n][:, [src + s for s in stripes]])
               for pool in engine.cache for n in ("k", "v"))
    engine.allocator.free([dst])
    log("tp_serve", f"(t3) copy_page drill: page {src} -> {dst} in {len(engine.cache)} shard "
        f"pools, every stripe equal: {same}")
    if not same:
        raise AssertionError("copy_page left a shard's stripe unequal")


def phase_tp_serve(server, config, prompts, serve_outs) -> dict:
    """Tensor-parallel serving on the card, tp = TP, both shards on the one
    card (ranks share one card: correctness and overhead, not scaling).
    (t1) the serve phase's weights and 8 requests on
    PagedLLMEngine(mesh=) at full depth in bf16: captures, wall, TTFT,
    decode rate, K5 launches (TP x the tp = 1 engine's per pass, counted
    by the engine and held against torch.profiler's), the idle share, the
    dense check, and the positions equal to the serve phase's tokens (not
    gated). (t2) Llama-3-8B's width at TP_F32_LAYERS layers in f32, tp = 1
    against tp = TP: greedy tokens equal under the near-tie rule
    (`_tp_compare`). (t3) the same model with speculation (K = 4) and the
    prefix cache on the shared-prefix prompts: tokens, prefix hits and
    copy-on-write copies equal, then copy_page over the shards' pools.
    Returns each kernel's launches on this path: the tp engines' runs and
    the checks' dense forwards (the tp = 1 references and the profiled
    repeat left out)."""
    t_phase = time.perf_counter()
    path: dict = {}
    gc.collect()
    torch.cuda.empty_cache()
    # (t1)
    t0 = time.perf_counter()
    engine = PagedLLMEngine(config, server.engine.params, PagedEngineConfig(
        max_slots=N_REQUESTS, precompile=True, paged=PagedConfig()), mesh=_tp_mesh())
    log("tp_serve", f"(t1) {MODEL} bf16, {config.n_layers} layers, tp = {TP} on one card: "
        f"shards hold {engine.cache[0]['k'].shape[0]} of {config.kv_heads} kv heads and "
        f"{engine.params[0]['blocks']['wq'].shape[2]} of {config.n_heads} heads; the shards' "
        f"own weights {_own_bytes(engine) / 2**30:.2f} GiB, their pools "
        f"{sum(t.numel() * t.element_size() for pool in engine.cache for t in pool.values()) / 2**30:.2f} "
        f"GiB ({time.perf_counter() - t0:.2f} s)")
    _tp_capture_log("(t1)", engine, base=server.engine)
    wrapped = RAGGED.launches
    t1 = _tp_run("(t1) 8 requests", engine, prompts, path)
    if RAGGED.launches != wrapped:
        raise AssertionError("a tp pass launched the ragged kernels outside its graph")
    times: dict = {}
    _hold_ragged_against_profiler("tp_serve", engine, prompts, times_out=times)
    t1["idle_share"] = times["idle_share"]
    # one replay's device time and its host enqueue time, tp = 1 (the serve
    # engine, idle) against tp = TP, over all-inactive inputs
    base = {p.name: p for p in server.engine.passes()}
    t1["replay_ms"] = {p.name: dict(tp1=_replay_ms(base[p.name], 5), tp=_replay_ms(p, 5),
                                    tp1_dispatch=_dispatch_ms(base[p.name], 5),
                                    tp_dispatch=_dispatch_ms(p, 5))
                       for p in engine.passes() if p.name in ("mixed.8", "decode.plain")}
    log("tp_serve", "(t1) one replay, device ms and host enqueue ms, tp = 1 against tp = "
        f"{TP}: " + "; ".join(f"{name} {r['tp1']:.3f} / {r['tp']:.3f} ms, enqueue "
                              f"{r['tp1_dispatch']:.3f} / {r['tp_dispatch']:.3f} ms"
                              for name, r in t1["replay_ms"].items()))
    same = sum(x == y for a, b in zip(t1["outs"], serve_outs) for x, y in zip(a, b))
    log("tp_serve", f"(t1) positions equal to the serve phase's tp = 1 tokens: {same} of "
        f"{N_REQUESTS * MAX_TOKENS} (not gated: bf16 partial sums round before they are added)")
    _wrapper_launches(path, lambda: _dense_check("tp_serve", server.engine.params, config,
                                                 prompts, t1["outs"]))
    engine.shutdown()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # (t2), (t3): f32 at TP_F32_LAYERS layers
    small = get_config(MODEL).replace(n_layers=TP_F32_LAYERS, dtype=torch.float32,
                                      param_dtype=torch.float32)
    params = init_params(small, SEED, device="cuda")
    pprompts = _prefix_prompts(small)
    runs = {}
    for tp in (1, TP):
        mesh = _tp_mesh() if tp > 1 else None
        for mode, kw in (("t2", {}), ("t3", dict(speculative_tokens=SPEC_TOKENS))):
            engine = PagedLLMEngine(small, params, PagedEngineConfig(
                max_slots=N_REQUESTS, precompile=True,
                paged=PagedConfig(prefix_cache=mode == "t3"), **kw),
                mesh=mesh, device=None if mesh else "cuda")
            label = f"({mode}) f32 {TP_F32_LAYERS} layers tp = {tp}"
            _tp_capture_log(label, engine)
            if mode == "t2":
                runs[mode, tp] = _tp_run(label, engine, prompts, path if tp > 1 else None)
            else:
                engine.generate([1, 2], max_tokens=2)
                before = engine.stats()
                run = _prefix_run(engine, pprompts)
                stats = _stats_delta(engine, before)
                if tp > 1:
                    _add_launches(path, stats)
                    _tp_copy_page_drill(engine)
                runs[mode, tp] = dict(run, stats=stats, counts={
                    k: stats[k] for k in ("prefix_cache_hits", "prefix_cache_cow",
                                          "spec_proposed", "spec_accepted")})
                log("tp_serve", f"{label}: wall {run['wall']:.3f} s, cached prompt tokens "
                    f"{run['cached']}, {runs[mode, tp]['counts']}, verify passes "
                    f"{ {p.name: int(stats[f'passes.{p.name}']) for p in engine.passes()} }")
            engine.shutdown()
            del engine
    equal = _tp_compare("(t2)", small, params, prompts, runs["t2", 1]["outs"],
                        runs["t2", TP]["outs"], path)
    log("tp_serve", f"(t2) tp = {TP} against tp = 1: {equal} of {N_REQUESTS * MAX_TOKENS} "
        f"positions compared equal")
    ref, got = runs["t3", 1], runs["t3", TP]
    equal3 = _tp_compare("(t3)", small, params, pprompts, ref["outs"], got["outs"], path)
    if got["cached"] != ref["cached"] or \
            {k: got["counts"][k] for k in ("prefix_cache_hits", "prefix_cache_cow")} != \
            {k: ref["counts"][k] for k in ("prefix_cache_hits", "prefix_cache_cow")}:
        raise AssertionError(f"(t3) prefix hits or copies differ: {got['counts']} against "
                             f"{ref['counts']}")
    if not ref["counts"]["prefix_cache_hits"] or not got["stats"].get("passes.verify.1"):
        raise AssertionError("(t3) no prefix hit, or no verify pass replayed")
    log("tp_serve", f"(t3) tp = {TP} against tp = 1: {equal3} positions compared equal, "
        f"prefix hits and copies equal ({got['counts']})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("tp_serve", f"launches on the tp_serve path {path} "
        f"({time.perf_counter() - t_phase:.2f} s)")
    if not path.get(RAGGED.name) or not path.get(FLASH_FWD.name):
        raise AssertionError(f"the tp_serve path never launched K5 or K1: {path}")
    return dict(launches={k.name: path.get(k.name, 0) for k in KERNELS}, t1=t1)


def _own_bytes(engine) -> int:
    """Bytes of the shards' own weight blocks (the split leaves' copies;
    the whole leaves are the caller's tensors, shared)."""
    def leaves(tree):
        for value in tree.values():
            yield from leaves(value) if isinstance(value, dict) else (value,)

    shared = {t.data_ptr() for t in leaves(engine.params[0])} & \
        {t.data_ptr() for t in leaves(engine.params[1])}
    return sum(t.numel() * t.element_size() for shard in engine.params for t in leaves(shard)
               if t.data_ptr() not in shared)


def _leaf_names(tree, prefix=""):
    """Names of the leaves in `tree_leaves` order."""
    names = []
    for key, value in tree.items():
        if isinstance(value, dict):
            names.extend(_leaf_names(value, f"{prefix}{key}."))
        else:
            names.append(prefix + key)
    return names


def _grad_check(config, params, tokens) -> None:
    """The kernel path's gradients against attn_impl="xla" (mha_reference
    under torch autograd) on the card, same params and tokens, bf16
    compute. Tolerances (GRAD_TOL_*): the two paths round differently — the
    kernels keep P in f32 until the bf16 cast before P.V and sum every
    product in f32, while the reference's attention products run as bf16
    cuBLAS calls with bf16 outputs, forward and backward — so each
    attention output and gradient differs by up to a bf16 ulp (2^-8
    relative), and that passes through 12 layers of the backward. Leaves
    that hold under 1e-3 of the global norm (bk, whose exact gradient is 0:
    a per-row constant shift of the scores) are held only through the
    global difference."""
    t0 = time.perf_counter()
    loss_k, _, g_k = loss_and_grads(config, params, tokens, loss_chunk=0)
    before = FLASH_BWD_DQ.launches
    loss_x, _, g_x = loss_and_grads(config.replace(attn_impl="xla"), params, tokens, loss_chunk=0)
    if FLASH_BWD_DQ.launches != before:
        raise AssertionError("the xla reference path launched a flash kernel")
    norm_k, norm_x = global_norm(g_k).item(), global_norm(g_x).item()
    diff = global_norm([a - b for a, b in zip(g_k, g_x)]).item() / norm_x
    leaf = []
    for name, a, b in zip(_leaf_names(params), g_k, g_x):
        nb = b.float().norm().item()
        if nb >= 1e-3 * norm_x:
            leaf.append(((a - b).float().norm().item() / nb, name))
    worst, worst_name = max(leaf)
    rel_norm = abs(norm_k - norm_x) / norm_x
    log("train", f"grad check, batch {tokens.shape[0]} x {tokens.shape[1] - 1}: loss kernel "
        f"{loss_k.item():.6f} xla {loss_x.item():.6f}; global norm kernel {norm_k:.6f} xla "
        f"{norm_x:.6f} (rel {rel_norm:.3e}, tol {GRAD_TOL_NORM}); ||g_kernel - g_xla|| / ||g_xla|| "
        f"{diff:.3e} (tol {GRAD_TOL_DIFF}); worst leaf {worst_name} {worst:.3e} (tol "
        f"{GRAD_TOL_LEAF}, {len(leaf)} of {len(g_k)} leaves hold >= 1e-3 of the norm) "
        f"({time.perf_counter() - t0:.2f} s)")
    log("train", "per-leaf relative difference: " + ", ".join(f"{n} {e:.2e}" for e, n in sorted(leaf, reverse=True)))
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    if not finite or rel_norm > GRAD_TOL_NORM or diff > GRAD_TOL_DIFF or worst > GRAD_TOL_LEAF:
        raise AssertionError("kernel-path gradients disagree with the xla reference path")


def phase_train() -> dict:
    """GPT-2 124M through make_train_step on the card; returns each
    kernel's launches over the timed steps (counted from zero just before
    them)."""
    t0 = time.perf_counter()
    config = get_config(TRAIN_MODEL)
    opt = default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS)
    state = create_train_state(config, opt, SEED, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    tokens = torch.randint(0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen,
                           device="cuda")
    log("train", f"{TRAIN_MODEL}: {count_params(state.params)} params (f32 masters), "
        f"{config.n_layers} layers d_model {config.d_model} heads {config.n_heads} vocab "
        f"{config.vocab_size}, compute {str(config.dtype).replace('torch.', '')}, remat "
        f"{config.remat}, seed {SEED} ({time.perf_counter() - t0:.2f} s)")
    _grad_check(config, state.params, tokens[:GRAD_CHECK_BATCH, :GRAD_CHECK_SEQ + 1])
    step = make_train_step(config, opt, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS:
        kernel.launches = 0
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append(m)
    launches = {k.name: k.launches for k in KERNELS}
    losses = [m["loss"].item() for m in metrics]
    gnorms = [m["grad_norm"].item() for m in metrics]
    step_s = statistics.median(times[TRAIN_WARMUP:])
    ntok = TRAIN_BATCH * TRAIN_SEQ
    log("train", f"{TRAIN_STEPS} steps on one fixed {TRAIN_BATCH} x {TRAIN_SEQ + 1} batch, "
        f"lr {TRAIN_LR} (warmup 2, cosine to 0.1x): step median {step_s * 1e3:.2f} ms "
        f"(min {min(times[TRAIN_WARMUP:]) * 1e3:.2f}, max {max(times[TRAIN_WARMUP:]) * 1e3:.2f}; "
        f"first {times[0] * 1e3:.2f}) over steps {TRAIN_WARMUP + 1}-{TRAIN_STEPS}, "
        f"{ntok / step_s:.1f} tokens/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("train", "loss " + " ".join(f"{x:.4f}" for x in losses))
    log("train", "grad_norm " + " ".join(f"{x:.4f}" for x in gnorms))
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    log("train", f"launches per step {per_step} (each flash kernel must show "
        f"{config.n_layers}: one per layer) ({time.perf_counter() - t0:.2f} s)")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    if not losses[-1] < LOSS_MARGIN * losses[0]:
        raise AssertionError(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}: not below "
                             f"{LOSS_MARGIN} x the first")
    for kernel in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
        if launches[kernel.name] != config.n_layers * TRAIN_STEPS:
            raise AssertionError(f"{kernel.name}: {launches[kernel.name]} launches in "
                                 f"{TRAIN_STEPS} steps, want {config.n_layers} per step")
    return launches


class _TokenStream:
    """A token stream made with numpy from a seed, as blocks for
    lm_batch_iterator: the same TRAIN_BATCH x (TRAIN_SEQ + 1) window of
    uniform draws, flattened, once per step (the train phase's regime of
    one fixed batch, which LOSS_MARGIN is set for)."""

    def __init__(self, vocab: int, seed: int, steps: int):
        rng = np.random.default_rng(seed)
        self.window = rng.integers(0, vocab, TRAIN_BATCH * (TRAIN_SEQ + 1), dtype=np.int32)
        self.steps = steps

    def iter_blocks(self):
        for _ in range(self.steps):
            yield {"tokens": self.window}


def _lm_trainer(config, ckpt_dir: str, ckpt_every: int) -> LMTrainer:
    """LMTrainer on the card with the train phase's optimizer (lr 1e-3,
    warmup 2, cosine over TRAIN_STEPS) and asynchronous checkpoints."""
    return LMTrainer(
        config, optimizer=default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS),
        learning_rate=TRAIN_LR, total_steps=TRAIN_STEPS, seed=SEED, device="cuda",
        checkpoint_config=CheckpointConfig(checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                                           async_save=True))


def _record_steps(trainer: LMTrainer):
    """Keep each step's loss tensor and a CUDA event recorded after the
    step, through the trainer's step_fn: nothing is read back, so the
    queue keeps running ahead. Returns (losses, ends)."""
    losses, ends = [], []
    step = trainer.step_fn

    def recording(state, batch):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        ends.append(end)
        return state, metrics

    trainer.step_fn = recording
    return losses, ends


def _step_flops_closed_form(config) -> float:
    """FLOPs of the step's products: each matrix product three times (the
    forward, dX and dW), and attention's 2 + 5 products of 2 * D per causal
    pair (the flash kernels' function)."""
    b, s, e, f, v, h, d, n = (TRAIN_BATCH, TRAIN_SEQ, config.d_model, config.d_ff, config.vocab_size,
                              config.n_heads, config.head_dim, config.n_layers)
    products = 2.0 * b * s * (4 * e * e + 2 * e * f) * n + 2.0 * b * s * e * v
    return 3 * products + 14.0 * b * h * d * s * (s + 1) / 2 * n


def _checkpoint_drill(state, directory: str) -> dict:
    """Seconds and bytes of two saves of the trained state (the first one
    allocates the pinned buffer, the second reuses it): the snapshot the
    caller waits for, then the write on the thread (file, sha256 manifest,
    COMMIT); then a verified restore onto the card."""
    mgr = CheckpointManager(directory, async_save=True)
    out = {}
    for label, step in (("first", state.step), ("second", state.step + 1)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save(step, state)
        out[f"{label}_snapshot_s"] = time.perf_counter() - t
        mgr.wait_until_finished()
        out[f"{label}_write_s"] = time.perf_counter() - t - out[f"{label}_snapshot_s"]
    out["bytes"] = os.path.getsize(os.path.join(directory, str(state.step), "state.bin"))
    t = time.perf_counter()
    back = mgr.restore(state, device=state.params["wte"].device)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params), tree_leaves(state.params)))
    mgr.close()
    if not same:
        raise AssertionError("checkpoint drill: restored params differ from the saved ones")
    return out


def phase_trainer() -> dict:
    """LMTrainer on GPT-2 124M through lm_batch_iterator, with checkpoints,
    the step log and step MFU; returns each kernel's launches over the
    20-step run (counted from zero just before it)."""
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    cfg.set(step_log_sample_every=TRAINER_SAMPLE_EVERY)
    try:
        return _trainer_run(get_config(TRAIN_MODEL), ckpt_dir)
    finally:
        cfg.reset("step_log_sample_every")
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _trainer_run(config, ckpt_dir: str) -> dict:
    t0 = time.perf_counter()
    run = "chip_smoke"
    trainer = _lm_trainer(config, ckpt_dir, TRAINER_CKPT_EVERY)
    # the cost count, ahead of the run so that no report window carries it
    probe = {"tokens": torch.zeros((TRAIN_BATCH, TRAIN_SEQ + 1), dtype=torch.int32,
                                   device=trainer.device)}
    t = time.perf_counter()
    cost = trainer.step_cost(probe)
    cost_s = time.perf_counter() - t
    closed = _step_flops_closed_form(config)
    log("trainer", f"{TRAIN_MODEL}: {trainer.num_params} params, device {trainer.device}; step cost "
        f"counted on meta tensors in {cost_s:.3f} s: {cost.flops:.6e} FLOPs ({cost.flops / closed:.6f} "
        f"of the products' closed form {closed:.6e}), {cost.bytes_accessed:.6e} bytes, peaks "
        f"{cost.peak_flops:.3e} FLOP/s {cost.peak_hbm_bps:.3e} B/s ({cost.device_kind}: "
        f"{'nominal fallback' if cost.estimated_peaks else 'published'} peaks); largest: "
        + ", ".join(f"{k} {v:.3e}" for k, v in cost.top_buckets(8)))
    losses, ends = _record_steps(trainer)
    reports = []
    stream = _TokenStream(config.vocab_size, SEED + 2, TRAIN_STEPS)
    torch.cuda.synchronize()
    for kernel in KERNELS:
        kernel.launches = 0
    t = time.perf_counter()
    trainer.train(lm_batch_iterator(stream, TRAIN_SEQ, TRAIN_BATCH, device="cuda"),
                  num_steps=TRAIN_STEPS, report_every=TRAINER_REPORT_EVERY,
                  report_fn=reports.append, run_name=run)
    run_s = time.perf_counter() - t
    launches = {k.name: k.launches for k in KERNELS}
    loss = [x.item() for x in losses]
    # device time between consecutive steps' ends (step n = ends[n-1] - ends[n-2]);
    # a step right after a host synchronisation (a sampled step, a report's
    # read-back, a checkpoint's snapshot) starts on an empty queue
    gaps = {n: ends[n - 2].elapsed_time(ends[n - 1]) for n in range(2, TRAIN_STEPS + 1)}
    synced = set()
    for r in reports:
        synced.add(r["step"])
        synced.update(rec["step"] for rec in r.get("_steplog", []))
    synced.update(range(TRAINER_CKPT_EVERY, TRAIN_STEPS + 1, TRAINER_CKPT_EVERY))
    queued = [gaps[n] for n in gaps if n - 1 not in synced]
    step_ms = statistics.median(queued)
    ntok = TRAIN_BATCH * TRAIN_SEQ
    log("trainer", f"{TRAIN_STEPS} steps in {run_s:.3f} s (first step's set-up included), "
        f"{ntok * TRAIN_STEPS / run_s:.1f} tokens/s over the run; device time a step, steps whose "
        f"predecessor ended on a queue (no sync): median {step_ms:.3f} ms (min {min(queued):.3f}, "
        f"max {max(queued):.3f}, {len(queued)} steps) = {ntok / step_ms * 1e3:.1f} tokens/s; every "
        f"step: " + " ".join(f"{n}:{gaps[n]:.2f}" for n in sorted(gaps)))
    log("trainer", "loss " + " ".join(f"{x:.4f}" for x in loss))
    sampled = []
    for r in reports:
        log("trainer", f"report at step {r['step']}: tokens_per_sec {r['tokens_per_sec']:.1f} "
            f"step_time_s {r.get('step_time_s', float('nan')):.6f} mfu {r.get('mfu', float('nan')):.6f} "
            f"step_flops {r.get('step_flops', float('nan')):.6e} step_bytes "
            f"{r.get('step_bytes', float('nan')):.6e} roofline_hbm {r.get('roofline_hbm', float('nan')):.6f} "
            f"({r.get('roofline_bound')}) input_wait_s {r['input_wait_s']} ckpt_save_s {r['ckpt_save_s']} "
            f"dp_sync_s {r['dp_sync_s']} ({r.get('dp_sync_mode')}, {r.get('dp_sync_bytes')} bytes) "
            f"loss {r['loss']:.4f}")
        for rec in r.get("_steplog", []):
            sampled.append(rec)
            log("trainer", f"  sampled step {rec['step']}: wall_s {rec['wall_s']:.6f} = "
                + " + ".join(f"{k} {v:.6f}" for k, v in rec["buckets"].items())
                + f" (sum {sum(rec['buckets'].values()):.6f})")
    log("trainer", "\n" + steplog.render_waterfall(steplog.log().steps(run=run)))
    per_step = {n: c / TRAIN_STEPS for n, c in launches.items()}
    log("trainer", f"launches per step {per_step} (each flash kernel must show {config.n_layers})")
    drill = _checkpoint_drill(trainer.state, os.path.join(ckpt_dir, "drill"))
    log("trainer", f"checkpoint drill: {drill['bytes']} bytes of state.bin; first save: snapshot "
        f"{drill['first_snapshot_s']:.3f} s (pinned buffer allocated) + write "
        f"{drill['first_write_s']:.3f} s; second save: snapshot {drill['second_snapshot_s']:.3f} s "
        f"+ write {drill['second_write_s']:.3f} s; verified restore {drill['restore_s']:.3f} s")
    # checks
    if not all(np.isfinite(loss)):
        raise AssertionError("trainer: non-finite training loss")
    if not loss[-1] < LOSS_MARGIN * loss[0]:
        raise AssertionError(f"trainer: loss {loss[0]:.4f} -> {loss[-1]:.4f}: not below "
                             f"{LOSS_MARGIN} x the first")
    for kernel in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
        if launches[kernel.name] != config.n_layers * TRAIN_STEPS:
            raise AssertionError(f"trainer: {kernel.name}: {launches[kernel.name]} launches in "
                                 f"{TRAIN_STEPS} steps, want {config.n_layers} per step")
    want_sampled = len(range(0, TRAIN_STEPS, TRAINER_SAMPLE_EVERY))
    if len(sampled) != want_sampled:
        raise AssertionError(f"trainer: {len(sampled)} sampled steps reported, want {want_sampled}")
    for rec in sampled:
        total = sum(rec["buckets"].values())
        if abs(total - rec["wall_s"]) > 1e-9 * rec["wall_s"]:
            raise AssertionError(f"trainer: sampled step {rec['step']}: buckets sum to {total!r}, "
                                 f"wall_s {rec['wall_s']!r}")
    for r in reports:
        if not 0.0 < r.get("mfu", float("nan")) < 1.0:
            raise AssertionError(f"trainer: report at step {r['step']}: mfu {r.get('mfu')} not in (0, 1)")
    second = _lm_trainer(config, ckpt_dir, TRAINER_CKPT_EVERY)
    t = time.perf_counter()
    restored = second.maybe_restore()
    restore_s = time.perf_counter() - t
    trees = [(second.state.params, trainer.state.params),
             (second.state.opt_state.mu, trainer.state.opt_state.mu),
             (second.state.opt_state.nu, trainer.state.opt_state.nu)]
    bitwise = all(torch.equal(a, b) for x, y in trees for a, b in zip(tree_leaves(x), tree_leaves(y)))
    count_ok = second.state.opt_state.count == trainer.state.opt_state.count == TRAIN_STEPS
    log("trainer", f"second trainer: maybe_restore() = {restored} in {restore_s:.3f} s; params and "
        f"moments bitwise equal: {bitwise}; count {second.state.opt_state.count}")
    del second
    if restored != TRAIN_STEPS or not bitwise or not count_ok:
        raise AssertionError("trainer: the second trainer did not restore step 20 bitwise")
    resumed = _lm_trainer(config, ckpt_dir, 0)
    if resumed.restore(TRAINER_RESUME_FROM) != TRAINER_RESUME_FROM:
        raise AssertionError(f"trainer: restore({TRAINER_RESUME_FROM}) returned another step")
    again, _ = _record_steps(resumed)
    resumed.train(lm_batch_iterator(_TokenStream(config.vocab_size, SEED + 2, TRAINER_RESUME_STEPS),
                                    TRAIN_SEQ, TRAIN_BATCH, device="cuda"),
                  num_steps=TRAINER_RESUME_STEPS, report_every=TRAINER_REPORT_EVERY,
                  run_name=run + "-resume")
    redo = [x.item() for x in again]
    first = loss[TRAINER_RESUME_FROM:TRAINER_RESUME_FROM + TRAINER_RESUME_STEPS]
    gap = max(abs(a - b) for a, b in zip(redo, first))
    log("trainer", f"restored at step {TRAINER_RESUME_FROM}, steps {TRAINER_RESUME_FROM + 1}-"
        f"{TRAINER_RESUME_FROM + TRAINER_RESUME_STEPS}: loss " + " ".join(f"{x!r}" for x in redo)
        + f"; first run " + " ".join(f"{x!r}" for x in first) + f"; bitwise {redo == first}, "
        f"largest gap {gap!r} ({time.perf_counter() - t0:.2f} s)")
    del resumed
    if redo != first:
        raise AssertionError("trainer: the resumed run's losses differ from the first run's "
                             "(no kernel of the port uses atomics: the steps should repeat bitwise)")
    return dict(launches=launches, step_ms=step_ms)


# ----------------------------------------------------------------- ingest

INGEST_SHARDS = 48
INGEST_WINDOWS = 4096  # windows of TRAIN_SEQ + 1 tokens a shard: 4 198 400 int32, 16.0 MiB
INGEST_STEPS = 40
INGEST_REPORT_EVERY = 10
INGEST_SAMPLE_EVERY = 5  # the step log's sampled steps (each synchronises the device)
INGEST_PROFILE = (20, 30)  # the profiled window: after step 20's dispatch to after step 30's
INGEST_RESTART_AT, INGEST_RESTART_TO = 10, 20  # the drill's checkpoint step and final step
INGEST_MEM_SLACK = 64 << 20  # allocated bytes a finished fit() may leave over its start


def _ingest_corpus(directory: str, vocab: int) -> tuple:
    """The token shards, drawn from [0, vocab) with numpy from the seed,
    and numpy's int64 sum of every packed window (each shard packs exactly
    INGEST_WINDOWS windows of TRAIN_SEQ + 1 tokens)."""
    rng = np.random.default_rng(SEED + 3)
    paths, total = [], 0
    for i in range(INGEST_SHARDS):
        tokens = rng.integers(0, vocab, INGEST_WINDOWS * (TRAIN_SEQ + 1), dtype=np.int32)
        total += int(tokens.reshape(INGEST_WINDOWS, TRAIN_SEQ + 1).sum(dtype=np.int64))
        paths.append(os.path.join(directory, f"shard{i:03d}.npy"))
        np.save(paths[-1], tokens)
    return paths, total


class _Shards:
    """The direct feed: the shards' blocks in order through a plain
    iter_blocks(), no runtime, no gang."""

    def __init__(self, paths):
        self.paths = paths

    def iter_blocks(self):
        for path in self.paths:
            yield {"tokens": np.load(path)}


def _ingest_pass(batches) -> dict:
    """Land every batch on the device and add its int64 sum to a device
    accumulator (no host read per batch); one read at the end. The host
    seconds each batch spent pinning and enqueuing its copy are summed."""
    acc = torch.zeros((), dtype=torch.int64, device="cuda")
    n, pin, enqueue = 0, 0.0, 0.0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for batch in batches:
        acc += batch["tokens"].sum(dtype=torch.int64)
        pin += batch.pin_s
        enqueue += batch.enqueue_s
        n += 1
    total = acc.item()
    return dict(sum=total, batches=n, wall_s=time.perf_counter() - t, pin_s=pin,
                enqueue_s=enqueue)


def _log_pass(label: str, card: str, p: dict) -> None:
    tokens = p["batches"] * TRAIN_BATCH * (TRAIN_SEQ + 1)
    per = p["wall_s"] / max(p["batches"], 1)
    log("ingest", f"{label}: {p['batches']} batches of {TRAIN_BATCH} x {TRAIN_SEQ + 1} in "
        f"{p['wall_s']:.3f} s: {tokens / p['wall_s'] / 1e6:.2f} M tokens/s, "
        f"{tokens * 4 / p['wall_s'] / 1e6:.1f} MB/s landed ({card}); a batch's host time "
        f"{per * 1e6:.1f} us, of it pinning {p['pin_s'] / max(p['batches'], 1) * 1e6:.1f} us "
        f"({p['pin_s'] / p['wall_s']:.3f} of the pass) and enqueuing the copy "
        f"{p['enqueue_s'] / max(p['batches'], 1) * 1e6:.1f} us; device sum {p['sum']}")


def _ingest_trainer(config, checkpoint_config=None) -> LMTrainer:
    return LMTrainer(
        config, optimizer=default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=INGEST_STEPS),
        learning_rate=TRAIN_LR, total_steps=INGEST_STEPS, seed=SEED, device="cuda",
        checkpoint_config=checkpoint_config)


class _StepWatch:
    """Each step of a trainer, through its step_fn: the loss tensor, a CUDA
    event after the step (nothing is read back), the host clock after its
    dispatch, and `hook(step)` (1-based) after the step."""

    def __init__(self, trainer: LMTrainer, hook=None):
        self.losses, self.ends, self.host = [], [], []
        step = trainer.step_fn

        def watched(state, batch):
            state, metrics = step(state, batch)
            self.losses.append(metrics["loss"])
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.ends.append(end)
            self.host.append(time.perf_counter())
            if hook is not None:
                hook(len(self.losses))
            return state, metrics

        trainer.step_fn = watched

    def medians(self, synced, skip) -> dict:
        """Median step time over steps n whose own dispatch and whose
        predecessor ran on a queue no synchronisation had drained (n and
        n - 1 not in `synced`) and that lie outside `skip`: the device time
        between consecutive steps' ends (CUDA events), and the host's."""
        steps = [n for n in range(2, len(self.losses) + 1)
                 if n not in synced and n - 1 not in synced and n not in skip]
        return dict(steps=len(steps), host_ms=statistics.median(
            (self.host[n - 1] - self.host[n - 2]) * 1e3 for n in steps),
            device_ms=statistics.median(
                self.ends[n - 2].elapsed_time(self.ends[n - 1]) for n in steps))


def _data_wait_share(run: str) -> tuple:
    """data_wait over wall_s summed over one run's sampled steps."""
    steps = [s for s in steplog.log().steps(run=run) if s.get("sealed")]
    wait = sum(s["buckets"].get("data_wait", 0.0) for s in steps)
    return wait / sum(s["wall_s"] for s in steps), len(steps)


def _busy_s(prof) -> float:
    return sum(e.duration_ns() for e in _device_events(prof)) / 1e9


def phase_ingest(card: str) -> dict:
    """The data plane and the one-process gang feeding GPT-2 124M: passes A
    and B over the corpus, the gang-fed run against the direct one, the
    restart drill. Returns each kernel's launches over the gang-fed run
    (counted from zero just before it)."""
    t0 = time.perf_counter()
    config = get_config(TRAIN_MODEL)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ingest_")
    cfg.set(step_log_sample_every=INGEST_SAMPLE_EVERY)
    rt = ray_tpu_torch.init()
    try:
        log("ingest", f"runtime: {rt.cluster_resources()}")
        paths, total = _ingest_corpus(tmp, config.vocab_size)
        nbytes = sum(os.path.getsize(p) for p in paths)
        log("ingest", f"corpus: {INGEST_SHARDS} shards x {INGEST_WINDOWS * (TRAIN_SEQ + 1)} int32 tokens "
            f"({nbytes} bytes on disk) in {time.perf_counter() - t0:.2f} s; numpy sum of every "
            f"packed window {total}")
        out = _ingest_feeds(card, paths, total)
        out.update(_ingest_gang(card, config, paths, tmp))
        _ingest_drill(card, config, paths, tmp)
    finally:
        ray_tpu_torch.shutdown()
        cfg.reset("step_log_sample_every")
        shutil.rmtree(tmp, ignore_errors=True)
    log("ingest", f"phase {time.perf_counter() - t0:.2f} s ({card})")
    return out


def _ingest_feeds(card: str, paths, total: int) -> dict:
    """Pass A (lm_batch_iterator over read_npy) and pass B (the dataset's
    own iter_torch_batches over windows made by map_batches): both sums
    against numpy's, bitwise."""
    ds = read_npy(paths)
    a = _ingest_pass(lm_batch_iterator(ds, TRAIN_SEQ, TRAIN_BATCH, device="cuda"))
    _log_pass("pass A, lm_batch_iterator(read_npy(shards))", card, a)
    stats = ds.stats()
    log("ingest", f"pass A StreamStats: produced {stats['blocks_produced']} blocks / "
        f"{stats['bytes_produced']} bytes, consumed {stats['blocks_consumed']} / "
        f"{stats['bytes_consumed']}, peak in-flight {stats['max_inflight_bytes']} bytes against "
        f"the budget {stats['byte_budget']}, backpressure stalls {stats['backpressure_stall_s']} s "
        f"(store pressure, the only stall reason; the byte window's yields are not stalls), "
        f"spilled {stats['spilled_bytes']} bytes ({card})")
    windowed = read_npy(paths).map_batches(
        lambda b: {"tokens": b["tokens"].reshape(-1, TRAIN_SEQ + 1)})
    b = _ingest_pass(windowed.iter_torch_batches(TRAIN_BATCH, device="cuda", drop_last=True))
    _log_pass("pass B, read_npy(shards).map_batches(windows).iter_torch_batches", card, b)
    if not a["sum"] == b["sum"] == total:
        raise AssertionError(f"ingest: device sums A {a['sum']} B {b['sum']}, numpy {total}")
    if stats["max_inflight_bytes"] > stats["byte_budget"]:
        raise AssertionError("ingest: the in-flight window passed its byte budget")
    return dict(pass_a=a, pass_b=b)


def _profiled_run(name: str, target, marks) -> dict:
    """Run `target` on a thread of its own and profile, from this (the
    main) thread, the window between its two step marks: torch.profiler
    starts on the main thread only (Kineto refuses another), and the two
    feeds are measured alike. Returns the target's value, the run's wall,
    and the window's wall and device busy time."""
    done = {}

    def run():
        try:
            done["value"] = target()
        except BaseException as exc:  # noqa: BLE001 - raised again below, on this thread
            done["error"] = exc

    def wait(mark) -> None:
        while not mark.wait(0.1):
            if not thread.is_alive():
                raise done.get("error") or AssertionError(f"ingest: {name} ended before its window")

    thread = threading.Thread(target=run, name=name)
    t = time.perf_counter()
    thread.start()
    wait(marks[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        wait(marks[1])
        window = time.perf_counter() - w0
    thread.join(600)
    if thread.is_alive():
        raise AssertionError(f"ingest: {name} did not end")
    if "error" in done:
        raise done["error"]
    return dict(value=done["value"], wall_s=time.perf_counter() - t, window_s=window,
                busy_s=_busy_s(prof), t0=t)


def _ingest_gang(card: str, config, paths, tmp: str) -> dict:
    """Trainer.fit() with one GPU rank fed by get_dataset_shard, then the
    same steps directly; the losses must be equal bitwise."""
    from ray_tpu_torch.train import RunConfig, ScalingConfig, Trainer, get_dataset_shard

    watch, built, marks = {}, {}, {}

    def trained(label, feed, **kw):
        trainer = _ingest_trainer(config)
        built[label] = time.perf_counter()
        watch[label] = _StepWatch(trainer, lambda n: n in INGEST_PROFILE and
                                  marks[label][INGEST_PROFILE.index(n)].set())
        trainer.train(lm_batch_iterator(feed(), TRAIN_SEQ, TRAIN_BATCH, device="cuda"),
                      num_steps=INGEST_STEPS, report_every=INGEST_REPORT_EVERY, **kw)

    marks["gang"] = [threading.Event() for _ in INGEST_PROFILE]
    gang = Trainer(lambda: trained("gang", lambda: get_dataset_shard("train")),
                   scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                   run_config=RunConfig(name="ingest-gang", storage_path=os.path.join(tmp, "gang")),
                   datasets={"train": read_npy(paths)})
    for kernel in KERNELS:
        kernel.launches = 0
    runs = {"gang": _profiled_run("ingest-gang-fit", gang.fit, marks["gang"])}
    launches = {k.name: k.launches for k in KERNELS}
    result = runs["gang"]["value"]
    log("ingest", f"gang-fed fit: status {result.status.value}, error {result.error}, "
        f"{len(result.metrics_history)} reports, restarts {result.num_restarts}, world sizes "
        f"{gang.controller.world_sizes}; goodput {result.goodput['buckets']}")
    direct_reports = []
    marks["direct"] = [threading.Event() for _ in INGEST_PROFILE]
    runs["direct"] = _profiled_run("ingest-direct", lambda: trained(
        "direct", lambda: _Shards(paths), report_fn=direct_reports.append,
        run_name="ingest-direct"), marks["direct"])

    gang_losses = [x.item() for x in watch["gang"].losses]
    direct_losses = [x.item() for x in watch["direct"].losses]
    reported = [r["loss"] for r in result.metrics_history]
    direct_reported = [r["loss"] for r in direct_reports]
    synced = set(range(1, INGEST_STEPS + 1, INGEST_SAMPLE_EVERY))
    synced.update(range(INGEST_REPORT_EVERY, INGEST_STEPS + 1, INGEST_REPORT_EVERY))
    skip = set(range(INGEST_PROFILE[0] + 1, INGEST_PROFILE[1] + 2))
    medians = {k: watch[k].medians(synced, skip) for k in ("gang", "direct")}
    shares = {"gang": _data_wait_share("ingest-gang"), "direct": _data_wait_share("ingest-direct")}
    dominant = gang.controller.stall_watchdog.dominant_bucket(0)
    for label, s in (("gang-fed", "gang"), ("direct", "direct")):
        r, m, w = runs[s], medians[s], watch[s]
        log("ingest", f"{label}: {r['wall_s']:.2f} s: trainer built at "
            f"{built[s] - r['t0']:.2f} s, first step dispatched at {w.host[0] - r['t0']:.2f} s, "
            f"step {INGEST_STEPS} at {w.host[-1] - r['t0']:.2f} s; step median device "
            f"{m['device_ms']:.3f} ms, host {m['host_ms']:.3f} ms over "
            f"{m['steps']} queued steps ({card}); data_wait {shares[s][0]:.4f} of the wall of "
            f"{shares[s][1]} sampled steps; profiled steps {INGEST_PROFILE[0] + 1}-"
            f"{INGEST_PROFILE[1]}: wall {r['window_s']:.4f} s, device busy {r['busy_s']:.4f} s, "
            f"idle share {1 - r['busy_s'] / r['window_s']:.4f}")
    log("ingest", f"the controller's dominant bucket {dominant}")
    log("ingest", "gang-fed reported losses " + " ".join(repr(x) for x in reported)
        + "; direct " + " ".join(repr(x) for x in direct_reported))
    if result.status.value != "FINISHED" or result.error is not None:
        raise AssertionError(f"ingest: the gang-fed fit ended {result.status.value}: {result.error}")
    if len(reported) != INGEST_STEPS // INGEST_REPORT_EVERY:
        raise AssertionError(f"ingest: the Result carries {len(reported)} reports")
    if reported != direct_reported or gang_losses != direct_losses:
        raise AssertionError("ingest: the gang-fed losses differ from the direct run's")
    for kernel in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
        if launches[kernel.name] != config.n_layers * INGEST_STEPS:
            raise AssertionError(f"ingest: {kernel.name}: {launches[kernel.name]} launches in "
                                 f"{INGEST_STEPS} steps, want {config.n_layers} per step")
    return dict(launches=launches, medians=medians)


def _ingest_drill(card: str, config, paths, tmp: str) -> None:
    """FailureConfig(max_failures=1): attempt 0 checkpoints at step 10,
    reports it and raises; attempt 1 restores it and runs to step 20. The
    failed attempt's parameters must be gone when attempt 1 starts, and the
    allocated bytes between the attempts and after fit() within
    INGEST_MEM_SLACK of their value before fit()."""
    import weakref

    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, Trainer, get_checkpoint, get_dataset_shard,
        report,
    )

    ckpt_dir = os.path.join(tmp, "drill-ckpt")
    seen = {}

    def allocated() -> int:
        # PyTorch keeps a 32 MiB cuBLAS workspace for each (handle, stream)
        # it has used, one more for each new rank thread's handle: each
        # reading drops them, so that it sees what the attempts left behind
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        return torch.cuda.memory_allocated()

    def train_fn(config_=None):
        feed = lm_batch_iterator(get_dataset_shard("train"), TRAIN_SEQ, TRAIN_BATCH, device="cuda")
        if "first" not in seen:
            trainer = _ingest_trainer(config, CheckpointConfig(
                checkpoint_dir=ckpt_dir, checkpoint_every=INGEST_RESTART_AT))
            seen["first"] = weakref.ref(trainer.state.params["wte"])
            trainer.train(feed, num_steps=INGEST_RESTART_AT, report_every=INGEST_RESTART_AT)
            report({"step": int(trainer.state.step)},
                   checkpoint={"step": int(trainer.state.step), "dir": ckpt_dir})
            raise RuntimeError(f"attempt 0 dies after its step-{INGEST_RESTART_AT} checkpoint")
        seen["first_alive"] = seen["first"]() is not None
        seen["between"] = allocated()
        ck = get_checkpoint()
        trainer = _ingest_trainer(config, CheckpointConfig(checkpoint_dir=ck["dir"]))
        trainer.restore(ck["step"])
        trainer.train(feed, num_steps=INGEST_RESTART_TO - ck["step"],
                      report_every=INGEST_RESTART_TO - ck["step"])

    before = allocated()
    t = time.perf_counter()
    result = Trainer(
        train_fn, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(name="ingest-drill", storage_path=os.path.join(tmp, "drill"),
                             failure=FailureConfig(max_failures=1)),
        datasets={"train": read_npy(paths)}).fit()
    fit_s = time.perf_counter() - t
    after = allocated()
    log("ingest", f"restart drill: status {result.status.value}, restarts {result.num_restarts}, "
        f"final step {result.metrics.get('step')}, checkpoint step {result.checkpoint_step}, "
        f"{fit_s:.2f} s ({card}); allocated without cuBLAS workspaces: before fit() {before} "
        f"bytes, between the attempts {seen.get('between')}, after fit() {after} (slack "
        f"{INGEST_MEM_SLACK}); attempt 0's parameters alive when attempt 1 started: "
        f"{seen.get('first_alive')}")
    if result.status.value != "FINISHED" or result.num_restarts != 1:
        raise AssertionError(f"ingest: the drill ended {result.status.value} after "
                             f"{result.num_restarts} restarts: {result.error}")
    if result.metrics.get("step") != INGEST_RESTART_TO:
        raise AssertionError(f"ingest: the drill's final step {result.metrics.get('step')}")
    if seen.get("first_alive") is not False:
        raise AssertionError("ingest: attempt 0's parameters outlived it")
    for label, value in (("between the attempts", seen["between"]), ("after fit()", after)):
        if abs(value - before) > INGEST_MEM_SLACK:
            raise AssertionError(f"ingest: allocated {label} {value}, before fit() {before}")


# ---------------------------------------------------------------- process

PROCESS_DOCS = 8192  # synthetic documents, 2-10-letter words from a seeded vocabulary
PROCESS_DOC_BYTES = 4096  # a document's row in the corpus (ASCII, zero-padded)
PROCESS_VOCAB = 8192  # the corpus's distinct words
PROCESS_BLOCKS = 64  # 128 documents (512 KiB of text) a block: each block enters the arena
PROCESS_WORKERS = 6  # pooled worker processes (the card's host has 8 cores)
PROCESS_ARENA_BYTES = 2 << 30  # the arena's size, at most half the free bytes of /dev/shm
PROCESS_TRAIN_STEPS = 20
PROCESS_PROMPTS = 8  # prompts an execute of the compiled graph
PROCESS_EXECUTES = 32
PROCESS_HEALTH_SLACK_S = 1.0  # the drill's bound: period x failures + this
PROCESS_CONTEXT_SLACK = 256 << 20  # the card's memory may not grow more while workers start


def _process_corpus() -> tuple:
    """PROCESS_DOCS documents of 200-600 words drawn with numpy from the
    seed, from a vocabulary of lower-case words, a tenth capitalised, a
    twentieth numbers, an eighth with trailing punctuation: a uint8 matrix
    of ASCII rows and the rows' lengths."""
    rng = np.random.default_rng(SEED + 11)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = []
    for n in rng.integers(2, 11, PROCESS_VOCAB):
        w = letters[rng.integers(0, 26, n)].tobytes()
        r = rng.random()
        if r < 0.1:
            w = w.capitalize()
        elif r < 0.15:
            w = str(int(rng.integers(0, 100000))).encode()
        if rng.random() < 0.125:
            w += b".,;:!?"[int(rng.integers(0, 6))].to_bytes(1, "little")
        words.append(w)
    words = np.array(words, dtype=object)
    text = np.zeros((PROCESS_DOCS, PROCESS_DOC_BYTES), np.uint8)
    lens = np.zeros(PROCESS_DOCS, np.int32)
    for d, n in enumerate(rng.integers(200, 600, PROCESS_DOCS)):
        doc = b" ".join(words[rng.integers(0, PROCESS_VOCAB, n)])[:PROCESS_DOC_BYTES]
        text[d, :len(doc)] = np.frombuffer(doc, np.uint8)
        lens[d] = len(doc)
    return text, lens


def _maps_libcuda(pid: int) -> bool:
    """Whether a process has the CUDA driver library mapped (it may be, by
    torch's import, without a context)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return False


def _card_used_bytes() -> int:
    out = _run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"])
    return int(out.split()[0]) << 20


def _no_cuda_context(label: str, states) -> None:
    """No worker may hold a CUDA context: each (pid, torch imported, CUDA
    initialised) state, read inside the worker, must say CUDA is not
    initialised, and no worker pid may be listed by nvidia-smi
    --query-compute-apps (printed with whether this process, which holds
    a context, is listed: in a container the list may use other pid
    numbers, which leaves it blind) and whether libcuda is mapped."""
    apps = udfs.compute_app_pids()
    pids = sorted(p for p, _, _ in states)
    log("process", f"{label}: CUDA initialised in workers "
        f"{ {p: c for p, _, c in states} }; nvidia-smi --query-compute-apps pids {apps}, this "
        f"process {os.getpid()} {'listed' if os.getpid() in apps else 'not listed'}; libcuda "
        f"mapped in this process {_maps_libcuda(os.getpid())}, in workers "
        f"{[p for p in pids if _maps_libcuda(p)]}")
    if any(c for _, _, c in states) or set(pids) & set(apps):
        raise AssertionError(f"process: a worker holds a CUDA context ({label}): {states}, "
                             f"compute apps {apps}")


def _pool_cuda_states() -> list:
    """Every pooled worker's cuda_state(): one overlapping task a worker."""
    pool = get_worker_pool()
    want = set(pool.pids())
    task = ray_tpu_torch.remote(udfs.cuda_state_after).options(executor="process")
    states = ray_tpu_torch.get([task.remote(0.5) for _ in want], timeout=300)
    if {p for p, _, _ in states} != want:
        raise AssertionError(f"process: the probes reached {sorted(p for p, _, _ in states)}, "
                             f"the pool holds {sorted(want)}")
    return states


def phase_process(card: str) -> dict:
    """The process plane feeding GPT-2 124M: (a) the corpus tokenised by a
    map stage on pooled worker processes against the same stage on
    threads, both landed on the card by iter_torch_batches (tokens equal
    bitwise; 20 train steps fed each way, losses equal bitwise); (b) a
    compiled graph over a process actor (tokenise, pad) and a thread actor
    holding GPT-2 on the card (the argmax) against the same chain of
    .remote() calls; (c) a process actor's worker SIGKILLed while idle and
    restarted by the health manager with no call in between. Returns each
    kernel's launches over (a) and (b) (counted from zero before them)."""
    t0 = time.perf_counter()
    ok = native_available()
    log("process", f"libobjstore.so for the port built or found: {ok} "
        f"({time.perf_counter() - t0:.2f} s){'' if ok else ': ' + str(build_error())}")
    if not ok:
        raise AssertionError("process: the native arena library did not build")
    directory = store_mod.shm_dir()
    free = store_mod.free_bytes(directory)
    arena = min(PROCESS_ARENA_BYTES, free // 2)
    cfg.set(native_store=True, object_store_capacity_bytes=arena,
            max_process_workers=PROCESS_WORKERS)
    ctx = DataContext.get_current()
    saved_prefetch = ctx.prefetch_blocks
    ctx.prefetch_blocks = 2 * PROCESS_WORKERS
    rt = ray_tpu_torch.init()
    try:
        store = rt.object_store
        log("process", f"runtime {rt.cluster_resources()}; {directory}: {free} bytes free; the "
            f"arena {store.arena.capacity if store.arena else None} bytes at "
            f"{store.arena.path if store.arena else store.arena_error}")
        if store.arena is None:
            raise AssertionError(f"process: the store has no arena: {store.arena_error}")
        used0 = _card_used_bytes()
        t = time.perf_counter()
        pids = get_worker_pool().prestart(PROCESS_WORKERS)
        log("process", f"prestarted {len(pids)} workers in {time.perf_counter() - t:.2f} s: pids "
            f"{pids}, this process {os.getpid()}")
        if len(set(pids)) != PROCESS_WORKERS or os.getpid() in pids:
            raise AssertionError(f"process: worker pids {pids}")
        t = time.perf_counter()
        text, lens = _process_corpus()
        log("process", f"corpus: {PROCESS_DOCS} documents, {int(lens.sum())} bytes of text "
            f"({text.nbytes} in rows of {PROCESS_DOC_BYTES}), {PROCESS_BLOCKS} blocks, made in "
            f"{time.perf_counter() - t:.2f} s")
        for kernel in KERNELS:
            kernel.launches = 0
        out = _process_ingest(card, store, text, lens, used0)
        out.update(_process_graph(card, text, lens))
        out["launches"] = {k.name: k.launches for k in KERNELS}
        log("process", f"launches in (a) and (b): {out['launches']}")
        if out["launches"][FLASH_FWD.name] == 0:
            raise AssertionError("process: the flash forward kernel never launched")
        out.update(_process_health(card))
    finally:
        ctx.prefetch_blocks = saved_prefetch
        ray_tpu_torch.shutdown()
        for flag in ("native_store", "object_store_capacity_bytes", "max_process_workers"):
            cfg.reset(flag)
    log("process", f"/dev/shm after shutdown: {store_mod.free_bytes(directory)} bytes free; "
        f"phase {time.perf_counter() - t0:.2f} s ({card})")
    return out


def _process_ingest(card: str, store, text, lens, used0: int) -> dict:
    """(a): the corpus through map_batches(tokenize_pack) on threads, then
    on the process pool, each landed by iter_torch_batches on the card:
    the token streams' sums and hashes (on the card) equal, then
    PROCESS_TRAIN_STEPS steps of GPT-2 fed each stream's first batches:
    losses equal bitwise."""
    # warm-up: each worker imports what the UDF imports before the timed pass
    t = time.perf_counter()
    warm = from_numpy({"text": text[:4 * PROCESS_WORKERS], "len": lens[:4 * PROCESS_WORKERS]},
                      num_blocks=2 * PROCESS_WORKERS)
    list(warm.map_batches(udfs.tokenize_pack, executor="process").iter_blocks())
    used1 = _card_used_bytes()
    log("process", f"warm-up pass over {2 * PROCESS_WORKERS} small blocks: "
        f"{time.perf_counter() - t:.2f} s; the card's memory in use {used0} bytes before the "
        f"workers started, {used1} after they ran the warm-up (a CUDA context costs hundreds "
        f"of MiB a process)")
    if used1 - used0 > PROCESS_CONTEXT_SLACK:
        raise AssertionError(f"process: the card's memory grew by {used1 - used0} bytes while "
                             f"the workers started")
    weights = (torch.arange(1, TRAIN_BATCH * udfs.WINDOW + 1, device="cuda", dtype=torch.int64)
               .reshape(TRAIN_BATCH, udfs.WINDOW) * 2654435761)
    runs = {}
    for executor in ("thread", "process"):
        puts = store.stats["shm_puts"]
        ds = from_numpy({"text": text, "len": lens}, num_blocks=PROCESS_BLOCKS).map_batches(
            udfs.tokenize_pack, executor=executor)
        total = torch.zeros((), dtype=torch.int64, device="cuda")
        digest = torch.zeros((), dtype=torch.int64, device="cuda")
        batches, n = [], 0
        t = time.perf_counter()
        for batch in ds.iter_torch_batches(TRAIN_BATCH, device="cuda", drop_last=True):
            tok = batch["tokens"]
            total += tok.sum(dtype=torch.int64)
            digest.mul_(1000003).add_((tok.to(torch.int64) * weights).sum())
            if len(batches) < PROCESS_TRAIN_STEPS:
                batches.append(tok.to(torch.int64))
            n += tok.numel()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        runs[executor] = dict(sum=int(total), hash=int(digest), tokens=n, wall_s=wall,
                              shm_puts=store.stats["shm_puts"] - puts, batches=batches)
        log("process", f"{executor} pass: {n} tokens in {wall:.3f} s, {n / wall:.1f} tokens/s "
            f"landed; sum {runs[executor]['sum']} hash {runs[executor]['hash']}; shm_puts "
            f"{runs[executor]['shm_puts']}; arena {store.arena.used} of {store.arena.capacity} "
            f"bytes in use ({card})")
    a, b = runs["thread"], runs["process"]
    log("process", f"process / thread tokens/s: {a['wall_s'] / b['wall_s']:.3f} with "
        f"{PROCESS_WORKERS} workers; store shm_puts {store.stats['shm_puts']}, shm_evictions "
        f"{store.stats['shm_evictions']}; {store_mod.shm_dir()}: "
        f"{store_mod.free_bytes(store_mod.shm_dir())} bytes free")
    if (a["sum"], a["hash"], a["tokens"]) != (b["sum"], b["hash"], b["tokens"]) or not a["tokens"]:
        raise AssertionError(f"process: token streams differ: thread {a['sum']} {a['hash']} "
                             f"{a['tokens']}, process {b['sum']} {b['hash']} {b['tokens']}")
    if store.stats["shm_puts"] == 0 or b["shm_puts"] == 0:
        raise AssertionError("process: nothing entered the arena (shm_puts == 0)")
    pids = get_worker_pool().pids()
    if len(pids) != PROCESS_WORKERS or os.getpid() in pids:
        raise AssertionError(f"process: pool pids {pids}")
    _no_cuda_context("after the passes", _pool_cuda_states())
    config = get_config(TRAIN_MODEL)
    opt = default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=PROCESS_TRAIN_STEPS)
    step = make_train_step(config, opt, device="cuda")
    losses = {}
    for executor, run in runs.items():
        state = create_train_state(config, opt, SEED, device="cuda")
        metrics = []
        for tok in run["batches"]:
            state, m = step(state, {"tokens": tok})
            metrics.append(m["loss"])
        losses[executor] = [x.item() for x in metrics]
        del state
    log("process", f"{PROCESS_TRAIN_STEPS} steps fed by the thread pass, losses "
        + " ".join(repr(x) for x in losses["thread"]) + "; by the process pass "
        + " ".join(repr(x) for x in losses["process"]))
    if losses["thread"] != losses["process"] or len(losses["thread"]) != PROCESS_TRAIN_STEPS:
        raise AssertionError("process: the losses fed each way differ")
    return dict(tokens_per_s={k: r["tokens"] / r["wall_s"] for k, r in runs.items()},
                shm_puts=store.stats["shm_puts"], losses=losses["process"])


def _process_graph(card: str, text, lens) -> dict:
    """(b): InputNode -> Preproc.transform (a process actor: tokenise, pad
    to 1024) -> LM.infer (a thread actor holding GPT-2 124M on the card:
    the argmax), compiled and executed PROCESS_EXECUTES times, pipelined,
    against the same chain of .remote() calls."""
    from ray_tpu_torch.experimental import InputNode

    prompts = [[text[k, :min(int(lens[k]), TRAIN_SEQ)].tobytes().decode("ascii")
                for k in range(e * PROCESS_PROMPTS, (e + 1) * PROCESS_PROMPTS)]
               for e in range(PROCESS_EXECUTES)]
    t = time.perf_counter()
    pre = ray_tpu_torch.remote(udfs.Preproc).options(executor="process").remote(TRAIN_SEQ)
    lm = ray_tpu_torch.remote(udfs.LM).options(num_gpus=1).remote(TRAIN_MODEL, SEED)
    pre_pid = ray_tpu_torch.get(pre.__ray_pid__.remote(), timeout=300)
    ray_tpu_torch.get(lm.__ray_ready__.remote(), timeout=300)
    log("process", f"actors up in {time.perf_counter() - t:.2f} s: Preproc in worker {pre_pid}, "
        f"LM (GPT-2 124M) on the card in this process")
    ray_tpu_torch.get(lm.infer.remote(pre.transform.remote(prompts[0])), timeout=300)  # warm-up
    t = time.perf_counter()
    refs = [lm.infer.remote(pre.transform.remote(p)) for p in prompts]
    chain = ray_tpu_torch.get(refs, timeout=600)
    chain_s = time.perf_counter() - t
    with InputNode() as inp:
        out = lm.infer.bind(pre.transform.bind(inp))
    t = time.perf_counter()
    dag = out.experimental_compile()
    compile_s = time.perf_counter() - t
    try:
        dag.execute(prompts[0]).get(timeout=300)  # warm-up
        t = time.perf_counter()
        futs = [dag.execute(p, timeout=300) for p in prompts]
        graph = [f.get(timeout=600) for f in futs]
        graph_s = time.perf_counter() - t
    finally:
        dag.teardown()
    log("process", f"compiled graph ({'shared-memory' if dag._use_shm else 'in-process'} "
        f"edges, compiled in {compile_s:.3f} s): {PROCESS_EXECUTES} executes of "
        f"{PROCESS_PROMPTS} prompts x {TRAIN_SEQ} in {graph_s:.3f} s, "
        f"{graph_s / PROCESS_EXECUTES * 1e3:.2f} ms an execute; the .remote() chain "
        f"{chain_s:.3f} s, {chain_s / PROCESS_EXECUTES * 1e3:.2f} ms a call ({card})")
    equal = all(np.array_equal(x, y) for x, y in zip(chain, graph)) and len(graph) == len(chain)
    if not dag._use_shm or not equal:
        raise AssertionError(f"process: the compiled graph's outputs differ from the chain's "
                             f"(shared-memory edges {dag._use_shm})")
    if graph[0].shape != (PROCESS_PROMPTS, TRAIN_SEQ):
        raise AssertionError(f"process: argmax shape {graph[0].shape}")
    _no_cuda_context("the graph's process actor",
                     [ray_tpu_torch.get(pre.__ray_apply__.remote(udfs.instance_cuda_state),
                                        timeout=60)])
    for handle in (pre, lm):
        ray_tpu_torch.kill(handle)
    return dict(execute_ms=graph_s / PROCESS_EXECUTES * 1e3,
                chain_ms=chain_s / PROCESS_EXECUTES * 1e3)


def _process_health(card: str) -> dict:
    """(c): SIGKILL the worker of an idle process actor (max_restarts=1); the
    health manager must restart it, with no method call in between, within
    health_check_period_s x health_check_failures + PROCESS_HEALTH_SLACK_S."""
    svc = ray_tpu_torch.remote(udfs.Counter).options(executor="process", max_restarts=1).remote(0)
    if ray_tpu_torch.get(svc.incr.remote(), timeout=300) != 1:
        raise AssertionError("process: the drill's actor did not count")
    pid = ray_tpu_torch.get(svc.__ray_pid__.remote(), timeout=60)
    bound = cfg.health_check_period_s * cfg.health_check_failures + PROCESS_HEALTH_SLACK_S
    aid = svc._actor_id.hex()

    def restarts() -> int:  # the actor table: no method call
        return next(a["restarts"] for a in ray_tpu_torch.list_actors() if a["actor_id"] == aid)

    t = time.perf_counter()
    os.kill(pid, signal.SIGKILL)
    while restarts() == 0 and time.perf_counter() - t < 30:
        time.sleep(0.005)
    detect_s = time.perf_counter() - t
    new_pid = ray_tpu_torch.get(svc.__ray_pid__.remote(), timeout=300)
    fresh = ray_tpu_torch.get(svc.incr.remote(), timeout=60)
    log("process", f"health drill: worker {pid} SIGKILLed while idle; restart {restarts()} "
        f"recorded after {detect_s:.3f} s with no call (bound {bound:.2f} s: period "
        f"{cfg.health_check_period_s} s x {cfg.health_check_failures} failures + "
        f"{PROCESS_HEALTH_SLACK_S} s); new worker {new_pid}, its count {fresh}")
    if restarts() != 1 or detect_s > bound or new_pid == pid or fresh != 1:
        raise AssertionError(f"process: the health drill failed (restarts {restarts()}, "
                             f"{detect_s:.3f} s against {bound:.2f} s, pid {pid} -> {new_pid})")
    _no_cuda_context("after the drill", _pool_cuda_states() + [ray_tpu_torch.get(
        svc.__ray_apply__.remote(udfs.instance_cuda_state), timeout=60)])
    ray_tpu_torch.kill(svc)
    return dict(health_detect_s=detect_s)


# --------------------------------------------------------------------- dp

DP_RANKS = 2  # two processes on the one card, over gloo (NCCL refuses two ranks on a device)
DP_STEPS = 10
DP_LAYERS = 6  # GPT-2 124M's width at 6 of its 12 layers, dp's and the gang's (a depth cut)
DP_MODES = ("f32", "int8", "f32+shard", "int8+shard")
DP_TIMEOUT_S = 240  # every collective of the gang, and its start-up
DP_PHASE_TIMEOUT_S = 420  # the whole gang run: a hung rank fails the phase
DP_FIRST_LOSS_RTOL = 1e-3  # step 0 against the one-process step on the whole batch
DP_SHARD_RTOL = 1e-5  # f32 + sharded update against f32, every step
DP_INT8_FINAL_ATOL = 0.1  # int8 final loss against f32's (the bound PERF.md's prediction states)
# a stage-1 residual is at most half its block's step, plus the rounding of
# x / scale (|x / scale| <= 127: at most 127 x 2^-24 of a step)
DP_EF_BOUND = 1.0 + 2.0 ** -16


def phase_dp(card: str) -> dict:
    """Data-parallel GPT-2 124M (DP_LAYERS of its layers) over two processes on the card: a
    TrainController drives a MultihostWorkerGroup of DP_RANKS gloo ranks,
    each running LMTrainer(mesh_spec=MeshSpec(dp=2)) fed by
    lm_batch_iterator(sharding=) (torch_dp_rank.dp_rank) in every sync
    mode, against the same steps in this process on the whole batch.
    Returns each kernel's launches summed over the ranks and modes."""
    from ray_tpu_torch.train import FailureConfig, RunConfig, ScalingConfig, TrainController
    from ray_tpu_torch.train.multihost import MultihostWorkerGroup

    t0 = time.perf_counter()
    config = get_config(TRAIN_MODEL).replace(n_layers=DP_LAYERS)
    rng = np.random.default_rng(SEED + 3)
    tokens = rng.integers(0, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), dtype=np.int32)
    opt_kw = dict(warmup_steps=2, total_steps=DP_STEPS)
    # the reference: the same steps in this process on the whole batch
    opt = default_optimizer(TRAIN_LR, **opt_kw)
    state = create_train_state(config, opt, SEED, device="cuda")
    step = make_train_step(config, opt, device="cuda")
    batch = {"tokens": torch.from_numpy(tokens).cuda()}
    ref = [step(state, batch)[1]["loss"].item() for _ in range(DP_STEPS)]
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    log("dp", f"one-process reference: {DP_STEPS} steps on the whole {TRAIN_BATCH} x "
        f"{TRAIN_SEQ + 1} batch: loss " + " ".join(f"{x:.4f}" for x in ref))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    groups = []

    def group():
        groups.append(MultihostWorkerGroup(DP_RANKS, run_name="chip-smoke-dp", report_dir=tmp,
                                           backend="gloo", timeout_s=DP_TIMEOUT_S))
        return groups[-1]

    rank_config = dict(model=TRAIN_MODEL, model_overrides={"n_layers": DP_LAYERS}, tokens=tokens,
                       steps=DP_STEPS, modes=DP_MODES, lr=TRAIN_LR, seed=SEED, **opt_kw)
    import torch_dp_rank

    controller = TrainController(
        torch_dp_rank.dp_rank, ScalingConfig(num_workers=DP_RANKS),
        RunConfig(name="chip-smoke-dp", failure=FailureConfig(max_failures=0)), rank_config,
        group_factory=group)
    outcome = {}
    runner = threading.Thread(target=lambda: outcome.update(result=controller.run()),
                              name="chip-smoke-dp", daemon=True)
    t = time.perf_counter()
    runner.start()
    runner.join(DP_PHASE_TIMEOUT_S)
    try:
        if runner.is_alive():
            for g in groups:
                g.shutdown()
            raise AssertionError(f"dp: the gang did not finish in {DP_PHASE_TIMEOUT_S} s")
        result = outcome["result"]
        if result.status.value != "FINISHED" or result.error is not None:
            raise AssertionError(f"dp: the gang ended {result.status.value}: {result.error}")
        gang_s = time.perf_counter() - t
        runs = {}
        for rank in range(DP_RANKS):
            with open(os.path.join(tmp, f"reports_rank{rank}.jsonl")) as f:
                for line in f:
                    rec = json.loads(line)["metrics"]
                    if "mode" in rec:
                        runs[(rec["mode"], rec["rank"])] = rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("dp", f"gang of {DP_RANKS} processes ({runs[(DP_MODES[0], 0)]['backend']}, both on "
        f"{runs[(DP_MODES[0], 0)]['device']}): {gang_s:.2f} s for {len(DP_MODES)} modes x "
        f"{DP_STEPS} steps, start-up included")
    launches = {k.name: 0 for k in KERNELS}
    finals = {}
    for mode in DP_MODES:
        _dp_mode(mode, runs, ref, launches, config, finals, card)
    # checks across modes
    for mode in DP_MODES:
        gap = abs(finals[mode] - finals["f32"])
        log("dp", f"{mode}: final loss {finals[mode]:.6f}, f32 {finals['f32']:.6f}, gap {gap:.6f}")
        if "int8" in mode and not gap <= DP_INT8_FINAL_ATOL:
            raise AssertionError(f"dp: {mode}: final loss {finals[mode]} is {gap} from f32's, "
                                 f"over {DP_INT8_FINAL_ATOL}")
    log("dp", f"phase {time.perf_counter() - t0:.2f} s ({card})")
    return dict(launches=launches, ref=ref, f32=runs[("f32", 0)]["losses"], tokens=tokens,
                opt_kw=opt_kw)


def _dp_mode(mode, runs, ref, launches, config, finals, card) -> None:
    """Print one mode's numbers and hold its checks."""
    recs = [runs[(mode, r)] for r in range(DP_RANKS)]
    losses = recs[0]["losses"]
    for r in recs[1:]:
        if r["losses"] != losses:
            raise AssertionError(f"dp: {mode}: the ranks' losses differ")
    finals[mode] = losses[-1]
    int8, shard = "int8" in mode, "shard" in mode
    n_params = recs[0]["n_params"]
    block = recs[0]["quant_block"]
    padded = recs[0]["rows_elements"]  # the rows layout: every leaf padded to n x k
    want = (dp_sync_bytes(padded, DP_RANKS, mode="int8" if int8 else "f32", shard_update=shard,
                          block=block)
            if (int8 or shard) else dp_sync_bytes(n_params, DP_RANKS))
    for r in recs:
        wire = r["wire"]
        moved = wire["dp_sync"]["bytes"] + wire.get("dp_gather", {}).get("bytes", 0)
        sync_s = wire["dp_sync"]["seconds"] + wire.get("dp_gather", {}).get("seconds", 0.0)
        med = statistics.median(r["step_s"][1:])
        log("dp", f"{mode} rank {r['rank']}: step median {med * 1e3:.2f} ms (first "
            f"{r['step_s'][0] * 1e3:.2f}; min {min(r['step_s'][1:]) * 1e3:.2f}, max "
            f"{max(r['step_s'][1:]) * 1e3:.2f}); sync measured {sync_s / DP_STEPS * 1e3:.3f} ms a "
            f"step (CUDA events around the gradient sync and the gather) beside JAX's estimate "
            f"{r['dp_sync_est_s'] * 1e3:.3f} ms ({r['dp_sync_bytes']} bytes / "
            f"steplog_dp_bandwidth_gbs); bytes moved {moved / DP_STEPS:.0f} a step beside "
            f"dp_sync_bytes {want} at {padded if (int8 or shard) else n_params} elements "
            f"({n_params} params, rows padding {padded - n_params}); by label "
            + ", ".join(f"{k} {v['bytes']} B {v['calls']} calls {v['seconds'] * 1e3:.2f} ms"
                        for k, v in sorted(wire.items()))
            + f"; peak allocated {r['peak_bytes'] / 2**30:.3f} GiB; report mfu "
            f"{r['report'].get('mfu')} dp_sync_s {r['report'].get('dp_sync_s')} "
            f"({r['dp_sync_mode']}, {card})")
        if moved != want * DP_STEPS:
            raise AssertionError(f"dp: {mode} rank {r['rank']}: {moved} bytes moved in {DP_STEPS} "
                                 f"steps, dp_sync_bytes gives {want} a step")
        if int8:
            ratio = r["ef_max_over_half_step"]
            log("dp", f"{mode} rank {r['rank']}: stage-1 residual max |e| / (step / 2) {ratio:.6f} "
                f"over {r['ef_elements']} elements")
            if not ratio <= DP_EF_BOUND:
                raise AssertionError(f"dp: {mode}: a stage-1 residual exceeds half its block's step")
        for kernel in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
            n = r["launches"][kernel.name]
            if n != config.n_layers * DP_STEPS:
                raise AssertionError(f"dp: {mode} rank {r['rank']}: {kernel.name} launched {n} "
                                     f"times, want {config.n_layers} x {DP_STEPS}")
        for k in launches:
            launches[k] += r["launches"][k]
    log("dp", f"{mode}: loss " + " ".join(f"{x:.6f}" for x in losses))
    gap0 = abs(losses[0] - ref[0]) / abs(ref[0])
    if not gap0 <= DP_FIRST_LOSS_RTOL:
        raise AssertionError(f"dp: {mode}: step 0 loss {losses[0]} vs one-process {ref[0]}")
    if mode == "f32+shard":
        f32 = runs[("f32", 0)]["losses"]
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, f32))
        log("dp", f"f32+shard against f32: largest relative gap {worst:.3e}")
        if not worst <= DP_SHARD_RTOL:
            raise AssertionError(f"dp: f32+shard departs from f32 by {worst} relative")


# ------------------------------------------------------------------- gang

GANG_AGENTS = 4  # node agents sharing the card: 2 for the gang, 1 spare a drill
GANG_CKPT_EVERY = 2  # steps between the gang's checkpoints
GANG_WARNING_S = 15.0  # the preemption window a SIGTERM'd agent announces
GANG_PAUSE_S = 1.0  # each rank's pause after a step: the drills land mid-run
GANG_TIMEOUT_S = 120  # the gang's process-group timeout (every collective)
GANG_PHASE_TIMEOUT_S = 300  # the whole phase: a hung gang fails it
GANG_HEAD_SYSTEM = {"node_stale_s": 2.0, "node_heartbeat_s": 0.2, "pg_reschedule_backoff_s": 0.2}
GANG_AGENT_SYSTEM = {"node_stale_s": 2.0, "node_heartbeat_s": 0.2,
                     "preempt_warning_s": GANG_WARNING_S}
GANG_CHAOS = {"RAY_TPU_CHAOS": "kill_node=1,name_filter=chaos-kill,max_injections=1"}


def _pg_states(pg) -> list:
    from ray_tpu_torch.util.events import events

    return [(e["ts"], e["extra"]["state"])
            for e in events().list(source="placement_groups", limit=100000)
            if e.get("extra", {}).get("pg") == pg.id.hex() and e["extra"].get("state")]


def _gang_wait(cond, deadline: float, what: str, runner, outcome: dict) -> None:
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"gang: timed out waiting for {what}")
        if not runner.is_alive() and not cond():
            result = outcome.get("result")
            raise AssertionError(
                f"gang: the controller ended while waiting for {what}: "
                f"{result.status.value if result else None} {result.error if result else ''}")
        time.sleep(0.05)


def phase_gang(card: str, dp: dict) -> dict:
    """A training gang hosted by the cluster that survives a preemption and
    a node kill (see the module docstring, `gang`): this process is the
    head, GANG_AGENTS node agents share the card, and a TrainController
    drives ClusterWorkerGroup(2) in a STRICT_SPREAD group shared across
    its attempts, each rank `torch_cluster_udfs.gang_lm` (the dp phase's
    f32 rank program, checkpointing every GANG_CKPT_EVERY steps). Returns
    the ranks' launches by kernel."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.train import (ClusterWorkerGroup, FailureConfig, RunConfig, ScalingConfig,
                                     TrainController)
    from ray_tpu_torch.util.events import events

    ray_tpu_torch.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    log("gang", f"{card}: this process holds {torch.cuda.memory_allocated()} bytes allocated, "
        f"{torch.cuda.memory_reserved()} reserved, before the cluster")
    t0 = time.perf_counter()
    deadline = time.monotonic() + GANG_PHASE_TIMEOUT_S
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    cluster = Cluster(head_node_args={"num_cpus": 1, "num_gpus": 0,
                                      "_system_config": GANG_HEAD_SYSTEM})
    handles, groups, member_pids = [], [], set()
    try:
        for _ in range(GANG_AGENTS):
            handles.append(cluster.add_node(num_cpus=2, num_gpus=1, resources={"gang": 1},
                                            system_config=GANG_AGENT_SYSTEM, env=GANG_CHAOS))
        cluster.wait_for_nodes(1 + GANG_AGENTS, timeout=180)
        agents_s = time.perf_counter() - t0
        pid_of = {rec["node_id"]: rec["pid"] for rec in cluster.runtime.cluster.nodes()
                  if not rec["is_head"]}
        events().clear()
        pg = ray_tpu_torch.placement_group([{"CPU": 1, "GPU": 1, "gang": 1}] * 2,
                                           strategy="STRICT_SPREAD", max_reschedules=2,
                                           name="chip-smoke-gang")
        if not pg.ready(timeout=60):
            raise AssertionError("gang: the placement group never reserved")
        log("gang", f"{card}: {GANG_AGENTS} agents up {agents_s:.2f} s after the spawn; the group "
            f"reserved bundles on agents {[pid_of[b.node.node_id.hex()] for b in pg.bundles]}")
        made = []

        def factory():
            groups.append(ClusterWorkerGroup(
                DP_RANKS, resources_per_worker={"CPU": 1, "GPU": 1, "gang": 1},
                run_name="chip-smoke-gang", pg=pg, pg_wait_s=120, backend="gloo",
                timeout_s=GANG_TIMEOUT_S))
            made.append(time.monotonic())
            return groups[-1]

        config = dict(model=TRAIN_MODEL, model_overrides={"n_layers": DP_LAYERS},
                      tokens=dp["tokens"], steps=DP_STEPS, lr=TRAIN_LR,
                      seed=SEED, device="cuda", ckpt_dir=ckpt_dir, ckpt_every=GANG_CKPT_EVERY,
                      step_pause_s=GANG_PAUSE_S, **dp["opt_kw"])
        controller = TrainController(
            cluster_udfs.gang_lm, ScalingConfig(num_workers=DP_RANKS),
            RunConfig(name="chip-smoke-gang", failure=FailureConfig(max_failures=1)), config,
            group_factory=factory, restart_backoff_s=0.5)
        outcome = {}
        runner = threading.Thread(target=lambda: outcome.update(result=controller.run()),
                                  name="chip-smoke-gang", daemon=True)
        hist = controller.metrics_history
        runner.start()

        # (a) the gang
        _gang_wait(lambda: len(hist) >= 1, deadline, "the first step", runner, outcome)
        form_s = time.monotonic() - made[0]
        first = groups[0]
        where = first.where()
        member_pids.update(w["pid"] for w in where)
        hosts = [b.node.node_id.hex() for b in pg.bundles]
        if len(set(hosts)) != DP_RANKS:
            raise AssertionError(f"gang: the bundles share a node: {hosts}")
        for rank, (host, w) in enumerate(zip(hosts, where)):
            if w["ppid"] != pid_of[host]:
                raise AssertionError(f"gang: rank {rank} runs in pid {w['pid']} under "
                                     f"{w['ppid']}, not under its bundle's agent {pid_of[host]}")
        log("gang", f"{card}: (a) gang formed {form_s:.2f} s after the group was built: rank "
            f"pids {[w['pid'] for w in where]}, children of agents "
            f"{[w['ppid'] for w in where]} (bundle hosts)")

        # (b) an announced preemption of rank 1's host
        _gang_wait(lambda: len(hist) >= 2, deadline, "two reported steps", runner, outcome)
        victim = pg.bundles[1].node
        victim_pid = pid_of[victim.node_id.hex()]
        t_sig = time.monotonic()
        os.kill(victim_pid, signal.SIGTERM)
        _gang_wait(lambda: victim.draining, deadline, "the head to mark the node draining",
                   runner, outcome)
        drained_s = time.monotonic() - t_sig
        _gang_wait(lambda: len(groups) >= 2, deadline, "the gang's restart", runner, outcome)
        if controller.num_preempt_restarts != 1 or controller.num_restarts != 0:
            raise AssertionError(f"gang: after the preemption {controller.num_preempt_restarts} "
                                 f"preempt restarts and {controller.num_restarts} restarts")
        resume_b = controller.train_config["resume_from_step"]
        emergency = [e["extra"]["step"] for e in events().list(kind="ckpt.saved", limit=100000)
                     if e["extra"].get("emergency")]
        if resume_b is None or resume_b not in emergency:
            raise AssertionError(f"gang: the restart resumes from {resume_b}, not an emergency "
                                 f"checkpoint {emergency}")
        n_b = len(hist)
        _gang_wait(lambda: len(hist) > n_b, deadline, "the resumed first step", runner, outcome)
        resumed_b = hist[n_b]
        resumed_b_s = time.monotonic() - t_sig
        if resumed_b["step"] != resume_b + 1 or resumed_b["start"] != resume_b + 1:
            raise AssertionError(f"gang: the first resumed step is {resumed_b['step']}, want "
                                 f"the emergency checkpoint's {resume_b} + 1")
        if victim.node_id.hex() in [b.node.node_id.hex() for b in pg.bundles]:
            raise AssertionError("gang: the restarted gang sits on the preempted node")
        states_b = [st for _, st in _pg_states(pg)]
        member_pids.update(w["pid"] for w in groups[1].where())
        log("gang", f"{card}: (b) SIGTERM to agent {victim_pid} (rank 1's host): draining in the "
            f"head's scheduler after {drained_s:.3f} s, window {GANG_WARNING_S} s; emergency "
            f"checkpoint at step {resume_b}; first resumed step {resumed_b['step']} "
            f"{resumed_b_s:.2f} s after the signal; group states {states_b}")

        # (c) an unannounced loss of rank 0's host
        _gang_wait(lambda: len(hist) > n_b + 1, deadline, "a second resumed step", runner, outcome)
        doomed = pg.bundles[0].node
        doomed_pid = pid_of[doomed.node_id.hex()]
        spare = set(pid_of) - {victim.node_id.hex(), doomed.node_id.hex(),
                               pg.bundles[1].node.node_id.hex()}
        t_kill = time.monotonic()
        ray_tpu_torch.remote(cluster_udfs.const).options(
            name="chaos-kill", num_cpus=0,
            scheduling_strategy=NodeAffinitySchedulingStrategy(doomed.node_id)).remote("x")
        _gang_wait(lambda: any(st == "RESCHEDULING" for _, st in _pg_states(pg)[len(states_b):]),
                   deadline, "the group to reschedule", runner, outcome)
        _gang_wait(lambda: pg.state == "RESERVED" and pg.bundles[0].node is not None
                   and pg.bundles[0].node.node_id.hex() in spare, deadline,
                   "the group to re-reserve on the spare agent", runner, outcome)
        reserved_s = time.monotonic() - t_kill
        _gang_wait(lambda: len(groups) >= 3, deadline, "the gang's second restart", runner, outcome)
        resume_c = controller.train_config["resume_from_step"]
        n_c = len(hist)
        _gang_wait(lambda: len(hist) > n_c, deadline, "the second resumed first step", runner, outcome)
        resumed_c_s = time.monotonic() - t_kill
        if hist[n_c]["step"] != resume_c + 1:
            raise AssertionError(f"gang: after the kill the first step is {hist[n_c]['step']}, "
                                 f"want the latest checkpoint's {resume_c} + 1")
        member_pids.update(w["pid"] for w in groups[2].where())
        log("gang", f"{card}: (c) chaos kill_node on agent {doomed_pid} (rank 0's host): group "
            f"RESERVED on the spare agent {pid_of[pg.bundles[0].node.node_id.hex()]} "
            f"{reserved_s:.2f} s after the kill, first resumed step {hist[n_c]['step']} (latest "
            f"checkpoint {resume_c}) {resumed_c_s:.2f} s after it; group states "
            f"{[st for _, st in _pg_states(pg)]}")

        # (d) what holds across the drills
        runner.join(max(1.0, deadline - time.monotonic()))
        if runner.is_alive():
            raise AssertionError(f"gang: the run did not finish in {GANG_PHASE_TIMEOUT_S} s")
        result = outcome["result"]
        if result.status.value != "FINISHED" or result.error is not None:
            raise AssertionError(f"gang: the run ended {result.status.value}: {result.error}")
        if (result.num_preempt_restarts, result.num_restarts) != (1, 1):
            raise AssertionError(f"gang: {result.num_preempt_restarts} preempt restarts and "
                                 f"{result.num_restarts} restarts, want 1 and 1")
        ref, f32 = dp["ref"], dp["f32"]
        gap0 = abs(hist[0]["loss"] - ref[0]) / abs(ref[0])
        if hist[0]["step"] != 0 or not gap0 <= DP_FIRST_LOSS_RTOL:
            raise AssertionError(f"gang: step 0 loss {hist[0]['loss']} vs one-process {ref[0]}")
        worst = {"undisturbed": 0.0, "resumed": 0.0}
        for i, m in enumerate(hist):
            gap = abs(m["loss"] - f32[m["step"]]) / abs(f32[m["step"]])
            key = "undisturbed" if i < n_b else "resumed"
            worst[key] = max(worst[key], gap)
        if not max(worst.values()) <= DP_SHARD_RTOL:
            raise AssertionError(f"gang: losses depart from the dp phase's f32 run: {worst}")
        if hist[-1]["step"] != DP_STEPS - 1:
            raise AssertionError(f"gang: the run ended at step {hist[-1]['step']}")
        launches = {k.name: 0 for k in KERNELS}
        per_rank = [[0, 0, 0] for _ in range(DP_RANKS)]
        last_of = {}
        for i, m in enumerate(hist):
            last_of[(m["start"], i < n_b, i < n_c)] = m["launches"]
        for counts in last_of.values():
            for r, row in enumerate(counts):
                for j, n in enumerate(row):
                    per_rank[r][j] += n
        for j, k in enumerate((FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ)):
            launches[k.name] = sum(per_rank[r][j] for r in range(DP_RANKS))
        if any(n <= 0 for row in per_rank for n in row):
            raise AssertionError(f"gang: a rank launched no K1 or K2: {per_rank}")
        steps_s = [m["step_s"] for m in hist[1:]]
        log("gang", f"{card}: (d) {len(hist)} rank-0 steps over 3 attempts, FINISHED with 1 "
            f"preempt restart and 1 restart; step 0 loss {hist[0]['loss']:.6f} vs one-process "
            f"{ref[0]:.6f} (gap {gap0:.3e}); largest relative gap to the dp phase's f32 losses "
            f"undisturbed {worst['undisturbed']:.3e}, resumed {worst['resumed']:.3e}; step median "
            f"{statistics.median(steps_s) * 1e3:.2f} ms (device-synchronised, pause excluded); "
            f"launches by rank (K1, K2 dkv, K2 dq) {per_rank}")
    except BaseException:
        for h in handles:
            log("gang", f"agent pid {h.pid} log's tail:\n{h.tail()}")
        raise
    finally:
        for g in groups:
            g.shutdown()
        cluster.shutdown()
        cfg.reset()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (e) leaving
    left = {}
    for pid in [h.pid for h in handles] + sorted(member_pids):
        alive, on_card = _cuda_pids_left(pid)
        if alive or on_card:
            left[pid] = (alive, on_card)
    log("gang", f"{card}: after Cluster.shutdown() agents {[h.pid for h in handles]} and members "
        f"{sorted(member_pids)}: left in the process table or among the card's compute apps: "
        f"{left or 'none'}; phase {time.perf_counter() - t0:.1f} s")
    if left:
        raise AssertionError(f"gang: processes outlived Cluster.shutdown(): {left}")
    return dict(launches=launches)


FSDP_TP_STEPS = 4
FSDP_TP_WARMUP = 2  # the schedule's warmup: step 0 moves nothing
FSDP_TP_LLAMA_LAYERS = 2  # Llama-3-8B width: 1.49 B params, 24 GB of f32 state in one process
FSDP_TP_LLAMA_BATCH, FSDP_TP_LLAMA_SEQ = 2, 1024
FSDP_TP_TIMEOUT_S = 300  # every collective of a gang, and its start-up
# Each step's loss against one process's, relative: |loss - ref| <= rtol |ref|.
# Every step takes a fresh batch from a Zipf law (_zipf_tokens): each
# update moves the loss by nats (GPT-2 10.96 -> 9.85 -> 9.22; Llama-3's
# width overshoots at this learning rate, 12.55 -> 34.1 -> 19.3) and keeps
# it far from 0, where a relative bound keeps its meaning. Each bound is
# about 10x the largest gap that mode measured on the card (PERF.md §6,
# run G), far under what one update moves the loss:
# - (a) f32 compute: the sharded step sums the same f32 products in
#   another order (the tp all-reduce of partial products, the fsdp
#   reduce-scatter of the gradients): 1.0e-7 measured;
# - (a2) bf16 compute, fsdp only: cuBLAS tiles a rank's rows otherwise,
#   bf16 roundings (2^-9) through 12 layers and 4 Adam steps: 3.3e-5;
# - (b) bf16, tp: a rank also rounds its partial product to bf16 before
#   the all-reduce sums it: 1.9e-4.
FSDP_TP_TOL = {"a": 1e-6, "a2": 4e-4, "b": 2e-3}

FLASH_SHAPES["gpt2_tp2"] = (TRAIN_BATCH // 2, 6, 6, TRAIN_SEQ, 64)  # a fsdp=2 x tp=2 rank
FLASH_SHAPES["llama_tp2"] = (FSDP_TP_LLAMA_BATCH, 16, 4, FSDP_TP_LLAMA_SEQ, 128)  # a tp=2 rank


def _zipf_tokens(rng, vocab: int, shape: tuple) -> np.ndarray:
    """Tokens from a Zipf law over a shuffled vocabulary (p ∝ 1 / rank, as
    word frequencies in text): an update learns the unigram, so the loss
    falls from about ln V toward the law's entropy (7.57 nats over GPT-2's
    vocabulary, 8.11 over Llama-3's) and no fixed batch is memorised."""
    p = 1.0 / np.arange(1, vocab + 1)
    ids = rng.permutation(vocab).astype(np.int32)
    return ids[rng.choice(vocab, size=shape, p=p / p.sum())]


def _reference_losses(model, tokens: np.ndarray, opt_kw: dict) -> list:
    """A step of make_train_step in this process on each whole batch of
    `tokens` (steps, batch, seq + 1) from init_params(model, SEED), the
    state freed after."""
    opt = default_optimizer(TRAIN_LR, **opt_kw)
    state = create_train_state(model, opt, SEED, device="cuda")
    step = make_train_step(model, opt, device="cuda")
    losses = [step(state, {"tokens": torch.from_numpy(t).cuda()})[1]["loss"].item()
              for t in tokens]
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses


def _gang_run(n: int, configs: list) -> list:
    """Each config run by a fresh MultihostWorkerGroup of n gloo ranks on
    the card, one after another; returns the ranks' outputs by config."""
    from ray_tpu_torch.train.multihost import MultihostWorkerGroup
    import torch_fsdp_tp_rank

    group = MultihostWorkerGroup(n, run_name=f"chip-smoke-fsdp-tp-{n}", backend="gloo",
                                 timeout_s=FSDP_TP_TIMEOUT_S)
    try:
        group.start()
        outs = []
        for config in configs:
            outs.append(group.finish(group.run_async(torch_fsdp_tp_rank.fsdp_tp_rank, config),
                                     timeout=2 * FSDP_TP_TIMEOUT_S))
        return outs
    finally:
        group.shutdown()


def _fsdp_tp_mode(label, ranks, ref, rtol, card) -> dict:
    """Print one mode's numbers per rank and step; hold its checks."""
    from torch_fsdp_tp_rank import LABELS

    losses = ranks[0]["losses"]
    for r in ranks[1:]:
        if r["losses"] != losses:
            raise AssertionError(f"fsdp_tp: {label}: the ranks' losses differ: "
                                 f"{[x['losses'] for x in ranks]}")
    gaps = [abs(a - b) for a, b in zip(losses, ref)]
    rel = [g / abs(b) for g, b in zip(gaps, ref)]
    log("fsdp_tp", f"{label} ({ranks[0]['mesh']}, {ranks[0]['backend']}, {len(ranks)} ranks on "
        f"{ranks[0]['device']}; split groups {ranks[0]['split_group']}): loss "
        + " ".join(f"{x:.6f}" for x in losses) + " against one process "
        + " ".join(f"{x:.6f}" for x in ref) + f": largest gap {max(gaps):.3e}, largest "
        f"relative gap {max(rel):.3e} (tolerance {rtol} relative); step moves "
        + " ".join(f"{b - a:+.6f}" for a, b in zip(ref, ref[1:])) + " nats")
    out = {"losses": losses, "reference": ref, "largest_gap": max(gaps),
           "largest_rel_gap": max(rel), "rtol": rtol, "ranks": [],
           "launches": {k.name: sum(r["launches"][k.name] for r in ranks) for k in KERNELS}}
    for r in ranks:
        rows = []
        for i, (wall, split) in enumerate(zip(r["step_s"], r["splits"])):
            coll = {k: split[k]["seconds"] for k in LABELS if k in split}
            compute = wall - sum(coll.values())
            rows.append(dict(step=i, wall_s=wall, compute_s=compute, **coll,
                             bytes={k: split[k]["bytes"] for k in split},
                             calls={k: split[k]["calls"] for k in split}))
            log("fsdp_tp", f"{label} rank {r['rank']} step {i}: wall {wall * 1e3:.2f} ms = compute "
                f"{compute * 1e3:.2f} ms + " + " + ".join(
                    f"{k} {v * 1e3:.2f} ms ({split[k]['calls']} calls, {split[k]['bytes']} B)"
                    for k, v in coll.items()) + f" ({card})")
        later = rows[1:] or rows
        med = {k: statistics.median(x.get(k, 0.0) for x in later)
               for k in ("wall_s", "compute_s") + LABELS}
        log("fsdp_tp", f"{label} rank {r['rank']}: median over steps 1-{len(rows) - 1}: wall "
            f"{med['wall_s'] * 1e3:.2f} ms, compute {med['compute_s'] * 1e3:.2f} ms ("
            + ", ".join(f"{k} {med[k] / med['wall_s']:.3f}" for k in LABELS if med[k])
            + f" of the step); peak allocated {r['peak_bytes'] / 2**30:.3f} GiB; launches "
            + ", ".join(f"{k} {v}" for k, v in r["launches"].items()))
        out["ranks"].append(dict(rank=r["rank"], median=med, steps=rows, peak_bytes=r["peak_bytes"]))
        for kernel in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
            if r["launches"][kernel.name] == 0:
                raise AssertionError(f"fsdp_tp: {label} rank {r['rank']}: {kernel.name} never "
                                     f"launched")
    if not all(g <= rtol * abs(b) for g, b in zip(gaps, ref)):
        raise AssertionError(f"fsdp_tp: {label}: losses {losses} depart from the one-process "
                             f"{ref} by more than {rtol} relative")
    return out


def phase_fsdp_tp(card: str) -> dict:
    """FSDP and tensor-parallel training over gloo ranks on the card: the
    kernels at the tp-local shapes, then modes (a), (a2) and (b) of the
    module docstring, each against its one-process reference. Returns the
    flash kernels' launches summed over the ranks and modes, and the
    kernel checks."""
    t0 = time.perf_counter()
    timer = _Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    checks = {}
    for label, dtype in (("gpt2_tp2", torch.bfloat16), ("gpt2_tp2", torch.float32),
                         ("llama_tp2", torch.bfloat16)):
        atol, rtol, _ = KERNEL_TOL[dtype]
        key = label if dtype == torch.bfloat16 else f"{label}_f32"
        checks[key] = dict(forward=_fwd_checks(timer, dtype, gen, label, True, atol, rtol),
                           **_bwd_checks(timer, dtype, gen, label, FLASH_SHAPES[label], atol,
                                         rtol))
    del timer
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 4)
    gpt2 = get_config(TRAIN_MODEL)
    llama = get_config(MODEL).replace(n_layers=FSDP_TP_LLAMA_LAYERS)
    gpt2_tokens = _zipf_tokens(rng, gpt2.vocab_size, (FSDP_TP_STEPS, TRAIN_BATCH, TRAIN_SEQ + 1))
    llama_tokens = _zipf_tokens(rng, llama.vocab_size,
                                (FSDP_TP_STEPS, FSDP_TP_LLAMA_BATCH, FSDP_TP_LLAMA_SEQ + 1))
    opt_kw = dict(warmup_steps=FSDP_TP_WARMUP, total_steps=FSDP_TP_STEPS)
    t = time.perf_counter()
    refs = {"a": _reference_losses(gpt2.replace(dtype=torch.float32), gpt2_tokens, opt_kw),
            "a2": _reference_losses(gpt2, gpt2_tokens, opt_kw),
            "b": _reference_losses(llama, llama_tokens, opt_kw)}
    log("fsdp_tp", f"one-process references ({time.perf_counter() - t:.2f} s): " + "; ".join(
        f"{k} " + " ".join(f"{x:.6f}" for x in v) for k, v in refs.items()))
    common = dict(lr=TRAIN_LR, seed=SEED, **opt_kw)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_tp_")
    try:
        t = time.perf_counter()
        (a,) = _gang_run(4, [dict(common, mode="gpt2_fsdp2_tp2", model=TRAIN_MODEL, f32=True,
                                  mesh=dict(fsdp=2, tp=2), vocab_whole=True, tokens=gpt2_tokens,
                                  checkpoint=tmp)])
        gang4_s = time.perf_counter() - t
        t = time.perf_counter()
        a2, b = _gang_run(2, [
            dict(common, mode="gpt2_lmtrainer", model=TRAIN_MODEL, tokens=gpt2_tokens),
            dict(common, mode="llama_tp2", model=MODEL, n_layers=FSDP_TP_LLAMA_LAYERS,
                 mesh=dict(tp=2), tokens=llama_tokens)])
        gang2_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("fsdp_tp", f"gang of 4: {gang4_s:.2f} s, gang of 2: {gang2_s:.2f} s, start-up included")
    modes = {
        "a": _fsdp_tp_mode("(a) gpt2-small f32 fsdp=2 x tp=2, vocab whole", a, refs["a"],
                           FSDP_TP_TOL["a"], card),
        "a2": _fsdp_tp_mode("(a2) gpt2-small bf16 LMTrainer default mesh", a2, refs["a2"],
                            FSDP_TP_TOL["a2"], card),
        "b": _fsdp_tp_mode(f"(b) llama3-8b width, {FSDP_TP_LLAMA_LAYERS} layers, bf16 tp=2", b,
                           refs["b"], FSDP_TP_TOL["b"], card),
    }
    for r in a2:
        if r["mesh"] != "fsdp=2" or r["report"]["num_tokens"] != TRAIN_BATCH * TRAIN_SEQ:
            raise AssertionError(f"fsdp_tp: (a2) rank {r['rank']}: mesh {r['mesh']}, report "
                                 f"{r['report']}")
    for r in a:
        ckpt = r["checkpoint"]
        log("fsdp_tp", f"(a) rank {r['rank']}: checkpoint of {ckpt['bytes']} state bytes saved in "
            f"{ckpt['save_s']:.2f} s (every rank's blocks, one step dir), restored bitwise "
            f"{ckpt['bitwise']} at step {ckpt['step']}")
        if not ckpt["bitwise"] or ckpt["step"] != FSDP_TP_STEPS:
            raise AssertionError(f"fsdp_tp: (a) rank {r['rank']}: the restored state differs")
    log("fsdp_tp", f"phase {time.perf_counter() - t0:.2f} s ({card})")
    launches = {k.name: sum(m["launches"][k.name] for m in modes.values()) for k in KERNELS}
    return dict(launches=launches, checks=checks, modes=modes)


A7_TIMEOUT_S = 300  # every collective of a gang, and its start-up
A7_SP_SHAPE = (1, LLAMA_HEADS[0], LLAMA_HEADS[1], 8192, 128)  # Llama-3-8B attention, sp = 2
# sp: the ranks' outputs against the flash forward kernel over the whole
# sequence and against mha_reference in f32 at KERNEL_TOL[bf16]; their
# gradients (the ring's through its plain f32 body, Ulysses' through the
# backward kernels) against flash_attention's gradient over the whole
# sequence by relative norm: the two sides round P and dS to bf16 at
# different places (2^-9 each) over 8192 keys.
A7_GRAD_REL = 2e-2
A7_EP_LAYERS, A7_EP_BATCH, A7_EP_SEQ = 2, 2, 1024  # Mixtral-8x7B width, ep = 2
# ep: the loss, relative, and per gradient leaf (per expert for the expert
# stacks) the norm, relative, and the dot with the parameter, relative to
# |g| |w|: the ep ranks sum their experts' bf16 partial outputs over ep
# (an extra bf16 rounding) where one process sums all 8 in one product.
A7_EP_LOSS_RTOL = 1e-3  # ~12x the measured 8.3e-5
A7_EP_GRAD_RTOL = 1e-2  # ~13x the worst measured, 7.8e-4 (PERF.md §6)
# Llama width. 2 layers, 1 a stage: at 4 the two stages' states (each
# with the replicated 128256-row embedding and head: 1.49 B f32 params,
# Adam's moments, the gradients and the update's three temporaries, 42 GB
# a rank) do not fit beside each other on the card
A7_PP_LAYERS, A7_PP_BATCH, A7_PP_SEQ, A7_PP_MB, A7_PP_STEPS = 2, 4, 1024, 4, 2
# pp: each step's loss against one process's make_train_step at
# FSDP_TP_TOL["b"] (bf16: the pipeline's microbatches of 1 row tile the
# products otherwise), GPipe against 1F1B at JAX's dry-run bound
A7_PP_SCHEDULE_ATOL = 1e-4
A7_VIT_BATCH = 32

FLASH_SHAPES["vit"] = (A7_VIT_BATCH, 12, 12, 197, 64)  # ViT-B/16's encoder, non-causal
FLASH_SHAPES["ring_block"] = (1, LLAMA_HEADS[0], LLAMA_HEADS[0], A7_SP_SHAPE[3] // 2, 128)


def _a7_gang(n: int, parts: list) -> list:
    """Each (config, check) part run by one MultihostWorkerGroup of n gloo
    ranks on the card, one after another, its check called on the ranks'
    outputs as soon as they are back; returns the outputs by part."""
    from ray_tpu_torch.train.multihost import MultihostWorkerGroup
    import torch_a7_rank

    group = MultihostWorkerGroup(n, run_name=f"chip-smoke-a7-{n}", backend="gloo",
                                 timeout_s=A7_TIMEOUT_S)
    outs = []
    try:
        group.start()
        for config, check in parts:
            t = time.perf_counter()
            outs.append(group.finish(group.run_async(torch_a7_rank.a7_rank, config),
                                     timeout=2 * A7_TIMEOUT_S))
            log("a7", f"({config['mode']}) ranks back in {time.perf_counter() - t:.2f} s")
            check(outs[-1])
        return outs
    finally:
        group.shutdown()


def _a7_sp(ranks, card) -> None:
    atol, rtol, _ = KERNEL_TOL[torch.bfloat16]
    b, hq, hkv, s, d = A7_SP_SHAPE
    for r in ranks:
        log("a7", f"(s) sp=2 rank {r['rank']} (B {b}, GQA {hq}/{hkv}, S {s} = 2 x {s // 2}, D {d}, "
            f"bf16, causal): ring first call {r['ring_first_call_s'] * 1e3:.2f} ms (gloo's "
            f"connection set-up on the sp group), then fused forward {r['ring_fwd_s'] * 1e3:.2f} ms "
            f"launching "
            f"flash_attention_fwd {r['ring_fwd_k1']} times (rank + 1 blocks), Ulysses forward "
            f"{r['ulysses_fwd_s'] * 1e3:.2f} ms; max |out - K1 whole sequence| ring "
            f"{r['ring_vs_k1']:.3e} Ulysses {r['ulysses_vs_k1']:.3e}, max |out - mha_reference "
            f"f32| ring {r['ring_vs_ref32']:.3e} Ulysses {r['ulysses_vs_ref32']:.3e} (atol {atol} "
            f"rtol {rtol}); gradients: ring (plain body) {r['ring_grad_s'] * 1e3:.2f} ms, peak "
            f"{r['ring_grad_peak_bytes'] / 2**30:.3f} GiB over its inputs, rel "
            + " ".join(f"{k} {v:.3e}" for k, v in r["ring_grad_rel"].items())
            + f"; Ulysses (K2) {r['ulysses_grad_s'] * 1e3:.2f} ms, peak "
            f"{r['ulysses_grad_peak_bytes'] / 2**30:.3f} GiB, rel "
            + " ".join(f"{k} {v:.3e}" for k, v in r["ulysses_grad_rel"].items())
            + f" (tol {A7_GRAD_REL}); max abs ring "
            + " ".join(f"{k} {v:.3e}" for k, v in r["ring_grad_max_abs"].items())
            + " Ulysses " + " ".join(f"{k} {v:.3e}" for k, v in r["ulysses_grad_max_abs"].items())
            + f"; bytes shipped forward {r['fwd_bytes']}, in all {r['bytes']}; launches "
            f"{r['launches']} ({card})")
        if r["ring_fwd_k1"] != r["rank"] + 1:
            raise AssertionError(f"a7 (s): rank {r['rank']}'s ring launched the flash forward "
                                 f"{r['ring_fwd_k1']} times, not {r['rank'] + 1}")
        if not r["outputs_ok"]:
            raise AssertionError(f"a7 (s): rank {r['rank']}'s outputs disagree")
        worst = max(list(r["ring_grad_rel"].values()) + list(r["ulysses_grad_rel"].values()))
        if not worst <= A7_GRAD_REL:
            raise AssertionError(f"a7 (s): rank {r['rank']}'s gradients depart by {worst:.3e}")


def _a7_ep(ranks, ref, card) -> None:
    log("a7", f"(e) one process, all 8 experts: loss {ref['loss']:.6f} (ce {ref['ce']:.6f}, aux "
        f"{ref['aux']:.6f}) in {ref['wall_s'] * 1e3:.2f} ms, peak {ref['peak_bytes'] / 2**30:.3f} "
        f"GiB ({card})")
    worst = 0.0
    for r in ranks:
        rel = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        for path, rows in r["stats"].items():
            want = {e: row for e, *row in ref["stats"][path]}
            for e, norm, dot, wnorm in rows:
                rn, rd, _ = want[e]
                worst = max(worst, abs(norm - rn) / max(rn, 1e-30),
                            abs(dot - rd) / max(rn * wnorm, 1e-30))
        log("a7", f"(e) ep=2 rank {r['rank']} (experts {r['expert_range']}, split groups "
            f"{r['split']}): loss {r['loss']:.6f} (ce {r['ce']:.6f}, aux {r['aux']:.6f}), rel "
            f"{rel:.3e} (tol {A7_EP_LOSS_RTOL}); loss + gradient {r['wall_s'] * 1e3:.2f} ms; expert "
            f"bytes {r['expert_bytes'] / 2**30:.3f} GiB of {r['param_bytes'] / 2**30:.3f} GiB "
            f"params; peak {r['peak_bytes'] / 2**30:.3f} GiB; collectives "
            + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B {v['seconds'] * 1e3:.2f} ms"
                        for k, v in r["collectives"].items())
            + f"; launches {r['launches']} ({card})")
        if not rel <= A7_EP_LOSS_RTOL:
            raise AssertionError(f"a7 (e): rank {r['rank']}'s loss {r['loss']} departs from "
                                 f"{ref['loss']}")
    log("a7", f"(e) gradients against one process: worst relative difference {worst:.3e} over "
        f"every leaf's norm and dot with its parameter, per expert (tol {A7_EP_GRAD_RTOL})")
    if not worst <= A7_EP_GRAD_RTOL:
        raise AssertionError(f"a7 (e): gradients depart by {worst:.3e}")


def _a7_pp(ranks, ref, card) -> None:
    rtol = FSDP_TP_TOL["b"]
    sched = {name: ranks[0]["schedules"][name]["losses"] for name in ("gpipe", "1f1b")}
    for r in ranks:
        for name, run in r["schedules"].items():
            log("a7", f"(p) pp=2 stage {r['stage']} {name}: losses "
                + " ".join(f"{x:.6f}" for x in run["losses"]) + " step "
                + " ".join(f"{x * 1e3:.2f}" for x in run["step_s"]) + " ms, state "
                f"{run['state_bytes'] / 2**30:.3f} GiB; peak over the state: forward + backward "
                f"{run['fwd_bwd_peak_bytes'] / 2**30:.3f} GiB, steps "
                + " ".join(f"{x / 2**30:.3f}" for x in run["step_peak_bytes"]) + " GiB; pp wire "
                + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B {v['seconds'] * 1e3:.2f} ms"
                            for k, v in sorted(run["wire"].items())) + f" ({card})")
            if run["losses"] != sched[name]:
                raise AssertionError(f"a7 (p): the stages' {name} losses differ")
        log("a7", f"(p) stage {r['stage']} launches {r['launches']}")
    log("a7", "(p) one process make_train_step: " + " ".join(f"{x:.6f}" for x in ref)
        + "; gpipe - 1f1b " + " ".join(f"{a - b:+.3e}" for a, b in zip(*sched.values()))
        + f" (tol {A7_PP_SCHEDULE_ATOL}); relative to one process "
        + ", ".join(f"{k} " + " ".join(f"{abs(a - b) / abs(b):.3e}" for a, b in zip(v, ref))
                    for k, v in sched.items()) + f" (tol {rtol})")
    for name, losses in sched.items():
        if not all(abs(a - b) <= rtol * abs(b) for a, b in zip(losses, ref)):
            raise AssertionError(f"a7 (p): {name} losses {losses} depart from {ref}")
    if not all(abs(a - b) <= A7_PP_SCHEDULE_ATOL for a, b in zip(*sched.values())):
        raise AssertionError(f"a7 (p): GPipe {sched['gpipe']} and 1F1B {sched['1f1b']} differ")


class _PlainAttentionViT:
    """A ViT config whose encoder runs attn_impl="xla" (mha_reference under
    autograd): the plain attention path the kernels are held against."""

    def __init__(self, config):
        self.config = config

    def __getattr__(self, name):
        return getattr(self.config, name)

    @property
    def encoder_config(self):
        return self.config.encoder_config.replace(attn_impl="xla")


def _a7_vit(card) -> dict:
    """ViT-B/16 in this process, batch A7_VIT_BATCH, bf16: the forward and
    the gradient of a fixed linear function of the logits through the
    kernels, against the plain attention path on the same weights."""
    from ray_tpu_torch.models import vit

    config = vit.vit_b16()
    params = vit.init_params(config, SEED, device="cuda")
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    images = torch.randn((A7_VIT_BATCH, 224, 224, 3), generator=gen, device="cuda")
    probe = torch.randn((A7_VIT_BATCH, config.out_dim), generator=gen, device="cuda")
    def run():
        out = vit.forward(params, images, config)
        return out, torch.autograd.grad((out.float() * probe).sum(), leaves)

    run()  # the first call, which sets up cuBLAS's handles and workspaces: not timed
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out, grads = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k.name: k.launches for k in KERNELS}
    out_x = vit.forward(params, images, _PlainAttentionViT(config))
    grads_x = torch.autograd.grad((out_x.float() * probe).sum(), leaves)
    if FLASH_FWD.launches != launches[FLASH_FWD.name]:
        raise AssertionError("a7 (v): the plain attention path launched a flash kernel")
    out_rel = ((out.float() - out_x.float()).norm() / out_x.float().norm()).item()
    norm_k, norm_x = global_norm(list(grads)).item(), global_norm(list(grads_x)).item()
    diff = global_norm([a - b for a, b in zip(grads, grads_x)]).item() / norm_x
    leaf = [((a - b).float().norm().item() / b.float().norm().item(), name)
            for name, a, b in zip(_leaf_names(params), grads, grads_x)
            if b.float().norm().item() >= 1e-3 * norm_x]
    worst, worst_name = max(leaf)
    rel_norm = abs(norm_k - norm_x) / norm_x
    log("a7", f"(v) vit-b16 B {A7_VIT_BATCH} x 224 x 224 (S 197, 12 heads x 64, bf16, non-causal): "
        f"forward + gradient {wall * 1e3:.2f} ms; |out - plain| / |plain| {out_rel:.3e}; global "
        f"norm rel {rel_norm:.3e} (tol {GRAD_TOL_NORM}), ||g - g_plain|| / ||g_plain|| {diff:.3e} "
        f"(tol {GRAD_TOL_DIFF}), worst leaf {worst_name} {worst:.3e} (tol {GRAD_TOL_LEAF}); "
        f"launches {launches} ({card})")
    if not (out_rel <= GRAD_TOL_DIFF and rel_norm <= GRAD_TOL_NORM and diff <= GRAD_TOL_DIFF
            and worst <= GRAD_TOL_LEAF and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise AssertionError("a7 (v): the kernel path departs from the plain attention path")
    for k in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
        if launches[k.name] != config.n_layers:
            raise AssertionError(f"a7 (v): {k.name} launched {launches[k.name]} times, not once "
                                 f"a layer")
    return launches


def phase_a7(card: str) -> dict:
    """Sequence, expert and pipeline parallelism over gloo ranks that share
    the card, then ViT-B/16 in this process: (s) ring attention and
    Ulysses at sp = 2, (e) the MoE model at ep = 2, (p) GPipe and 1F1B at
    pp = 2, each against one process; (v) ViT's kernels against the plain
    attention path. Returns each kernel's launches summed over the ranks
    and parts."""
    import torch_a7_rank
    from ray_tpu_torch.models import moe

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 6)
    # (e) and (p): the one-process references first, freed before the ranks
    moe_cfg = moe.mixtral_8x7b().replace(n_layers=A7_EP_LAYERS)
    moe_tokens = _zipf_tokens(rng, moe_cfg.vocab_size, (A7_EP_BATCH, A7_EP_SEQ + 1))
    torch.cuda.reset_peak_memory_stats()
    params = moe.init_params(moe_cfg, SEED, device="cuda")
    for t in tree_leaves(params):
        t.requires_grad_()
    ep_ref = torch_a7_rank.moe_grad_stats(params, torch.from_numpy(moe_tokens).cuda(), moe_cfg)
    ep_ref["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    llama = get_config(MODEL).replace(n_layers=A7_PP_LAYERS)
    pp_tokens = _zipf_tokens(rng, llama.vocab_size, (A7_PP_STEPS, A7_PP_BATCH, A7_PP_SEQ + 1))
    opt_kw = dict(warmup_steps=0, total_steps=A7_PP_STEPS)
    pp_ref = _reference_losses(llama, pp_tokens, opt_kw)
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    sp, ep, pp = _a7_gang(2, [
        (dict(mode="sp", shape=A7_SP_SHAPE, seed=SEED + 8, atol=KERNEL_TOL[torch.bfloat16][0],
              rtol=KERNEL_TOL[torch.bfloat16][1]), lambda ranks: _a7_sp(ranks, card)),
        (dict(mode="ep", n_layers=A7_EP_LAYERS, seed=SEED, tokens=moe_tokens),
         lambda ranks: _a7_ep(ranks, ep_ref, card)),
        (dict(mode="pp", model=MODEL, n_layers=A7_PP_LAYERS, seed=SEED, tokens=pp_tokens,
              microbatches=A7_PP_MB, lr=TRAIN_LR, **opt_kw),
         lambda ranks: _a7_pp(ranks, pp_ref, card))])
    log("a7", f"gang of 2: {time.perf_counter() - t:.2f} s for (s), (e) and (p), start-up included")
    gc.collect()
    torch.cuda.empty_cache()
    vit_launches = _a7_vit(card)
    by_part = {"s": sp, "e": ep, "p": pp}
    launches = {k.name: vit_launches[k.name] + sum(r["launches"][k.name] for rs in by_part.values()
                                                    for r in rs) for k in KERNELS}
    for part, rs in by_part.items():
        for k in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
            if sum(r["launches"][k.name] for r in rs) == 0:
                raise AssertionError(f"a7 ({part}): {k.name} never launched")
    log("a7", f"phase {time.perf_counter() - t0:.2f} s ({card})")
    return dict(launches=launches, by_part={
        **{p: {k.name: sum(r["launches"][k.name] for r in rs) for k in KERNELS}
           for p, rs in by_part.items()}, "v": vit_launches})


# --------------------------------------------------------------- capacity

CAP_WARNING_S = 3.0  # the spot reclaim's warning window (JAX's capstone)
CAP_TRAIN_STEPS = 16  # each rank's steps over the run
CAP_CKPT_EVERY = 6  # steps between rank 0's checkpoints (plus the emergency one)
CAP_PREEMPT_AT = 3  # rank 0's reported step that arms the reclaim
CAP_SERVE_SLOTS = 4
CAP_SERVE_PROMPTS = 4  # the client cycles through these prompts
CAP_SERVE_TOKENS = 16
CAP_FLASH_SHAPE = (TRAIN_BATCH, 12, TRAIN_SEQ, 64)  # GPT-2 124M's attention in training
CAP_DCN_REL = 0.005  # an int8 replica's largest error over its leaf's largest magnitude (JAX)
CAP_DCN_WIRE = 0.45  # the int8 wire bytes over the raw bytes (JAX)
CAP_LAUNCH_DRAIN = {"RAY_TPU_PREEMPT_WARNING_S": "1.0"}  # launched nodes: SIGTERM drains 1 s
CAP_TIMEOUT_S = 300
_CAP_RANKS: list = []  # each attempt's rank outcomes (the ranks are threads of this process)


def _cap_rank(config: dict):
    """One rank of part (a)'s gang (a thread actor of this process): GPT-2
    124M's train step on batches made from the seed, the rank and the step,
    rank 0 checkpointing the model and optimizer state through
    train.report(checkpoint=...) every CAP_CKPT_EVERY steps and on the
    controller's emergency request; a resumed attempt restores the
    checkpoint and checks the restored state against it bit for bit. The
    loop is JAX's capstone's: rank 0 leaves after its emergency
    checkpoint, the others when the run is preempted."""
    from ray_tpu_torch import train

    rank = train.get_context().world_rank
    model = get_config(TRAIN_MODEL)
    opt = default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=CAP_TRAIN_STEPS)
    state = create_train_state(model, opt, SEED, device="cuda")
    leaves = lambda s: (tree_leaves(s.params) + tree_leaves(s.opt_state.mu)  # noqa: E731
                        + tree_leaves(s.opt_state.nu))
    ckpt = train.get_checkpoint()
    start, restored = 0, None
    if ckpt is not None:
        with torch.no_grad():
            for t, a in zip(leaves(state), ckpt["leaves"]):
                t.copy_(torch.from_numpy(a))
        state.step, state.opt_state.count = ckpt["state_step"], ckpt["count"]
        restored = all(torch.equal(t.cpu(), torch.from_numpy(a))
                       for t, a in zip(leaves(state), ckpt["leaves"]))
        start = ckpt["step"] + 1
    step_fn = make_train_step(model, opt, device="cuda")
    gen = torch.Generator(device="cuda")
    out = dict(rank=rank, start=start, restored=restored, losses=[], left="done")
    _CAP_RANKS.append(out)

    def snapshot(step):
        return {"step": step, "state_step": state.step, "count": state.opt_state.count,
                "leaves": [t.detach().cpu().numpy() for t in leaves(state)]}

    for step in range(start, CAP_TRAIN_STEPS):
        gen.manual_seed(SEED + 7919 * (rank + 1) + step)
        tokens = torch.randint(0, model.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=gen,
                               device="cuda")
        state, m = step_fn(state, {"tokens": tokens})
        out["losses"].append(m["loss"].item())
        if rank != 0:
            if train.is_preempted():
                out["left"] = "preempted"
                return out
            continue
        metrics = {"step": step, "loss": out["losses"][-1]}
        if train.should_checkpoint() or (step + 1) % CAP_CKPT_EVERY == 0:
            train.report(metrics, checkpoint=snapshot(step), checkpoint_step=step)
        elif train.is_preempted():
            out["left"] = "preempted"
            return out
        else:
            train.report(metrics)
    return out


def _cap_fleet(card: str, tmp: str) -> dict:
    """Part (a): JAX's spot-fleet capstone with GPT-2 124M's serving and
    training on the card. Returns the kernels' launches."""
    from ray_tpu_torch.core.capacity import (CapacityAutoscaler, FakeNodeProvider, NodeType,
                                             SpotNodeProvider)
    from ray_tpu_torch.core.exceptions import RayTpuError
    from ray_tpu_torch.train import (FailureConfig, RunConfig, RunStatus, ScalingConfig,
                                     TrainController)
    from ray_tpu_torch.util import state as st
    from ray_tpu_torch.util.events import events
    from ray_tpu_torch.util.metrics import registry

    t0 = time.perf_counter()
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0)
    scaler = None
    launches = {k.name: 0 for k in KERNELS}
    try:
        events().clear()
        provider = SpotNodeProvider(FakeNodeProvider(rt.scheduler), warning_s=CAP_WARNING_S)
        scaler = CapacityAutoscaler(
            rt.scheduler, provider,
            [NodeType("spot-train", {"CPU": 1.0, "trainer": 1.0}, capacity_class="spot"),
             NodeType("spot-serve", {"CPU": 2.0, "serve_slot": 2.0}, capacity_class="spot")],
            poll_interval_s=0.05, idle_timeout_s=600.0, runtime=rt)
        scaler.start()
        for k in KERNELS:
            k.launches = 0
        config = get_config(TRAIN_MODEL).replace(param_dtype=torch.bfloat16)
        params = init_params(config, SEED, device="cuda")
        dep = serve.deployment(LLMServer, name="fleet-llm", num_replicas=2,
                               max_ongoing_requests=2 * CAP_SERVE_SLOTS,
                               resources_per_replica={"CPU": 1.0, "serve_slot": 1.0})
        handle = serve.run(dep.bind(config, params, PagedEngineConfig(max_slots=CAP_SERVE_SLOTS),
                                    SEED, 1, device="cuda"), name="fleet-llm")
        rng = np.random.default_rng(SEED + 21)
        prompts = [rng.integers(0, config.vocab_size, int(n)).tolist()
                   for n in rng.integers(16, 200, CAP_SERVE_PROMPTS)]
        first = ray_tpu_torch.get(handle.generate.remote(
            {"prompt_tokens": prompts[0], "max_tokens": CAP_SERVE_TOKENS}), timeout=300)
        serve_s = time.perf_counter() - t0
        _CAP_RANKS.clear()
        controller = TrainController(
            _cap_rank, ScalingConfig(num_workers=2,
                                     resources_per_worker={"CPU": 1.0, "trainer": 1.0}),
            RunConfig(name="spot-fleet", storage_path=os.path.join(tmp, "trial"),
                      failure=FailureConfig(max_failures=0)),
            train_config={}, restart_backoff_s=0.0)
        box = {}
        runner = threading.Thread(target=lambda: box.update(result=controller.run()),
                                  daemon=True)
        runner.start()
        calls, errors, stop = [], [], threading.Event()
        seen = {0: first["tokens"]}

        def client():
            i = 1
            while not stop.is_set():
                p = i % CAP_SERVE_PROMPTS
                try:
                    out = ray_tpu_torch.get(handle.generate.remote(
                        {"prompt_tokens": prompts[p], "max_tokens": CAP_SERVE_TOKENS}), timeout=60)
                    calls.append((p, out["tokens"]))
                except Exception as exc:  # noqa: BLE001 - each must be a typed error (below)
                    errors.append(exc)
                i += 1

        caller = threading.Thread(target=client, daemon=True)
        caller.start()
        deadline = time.monotonic() + CAP_TIMEOUT_S
        while (not any(m.get("step", -1) >= CAP_PREEMPT_AT for m in controller.metrics_history)
               and time.monotonic() < deadline and runner.is_alive()):
            time.sleep(0.05)
        if not controller.metrics_history:
            raise AssertionError(f"capacity (a): the gang never reported ({box})")
        ups_before = scaler.stats["scale_ups"]
        victim = next(n for n in rt.scheduler.nodes()
                      if n.labels.get("node_type") == "spot-train"
                      and rt.scheduler.resident_bundles(n.node_id.hex()))
        preempt_at = time.perf_counter()
        provider.preempt_after(victim, 0.01, warning_s=CAP_WARNING_S)
        runner.join(timeout=CAP_TIMEOUT_S)
        stop.set()
        caller.join(timeout=120)
        if runner.is_alive():
            raise AssertionError("capacity (a): the controller never finished")
        result = box["result"]
        train_s = time.perf_counter() - preempt_at
        deadline = time.monotonic() + 30
        while victim.alive and time.monotonic() < deadline:
            time.sleep(0.05)
        evs = st.list_events(limit=100000)
        vh = victim.node_id.hex()

        def first_event(kind, **match):
            for e in evs:
                if e.get("kind") == kind and all((e.get("extra") or {}).get(k) == v
                                                 for k, v in match.items()):
                    return e
            raise AssertionError(f"capacity (a): no {kind} event matching {match}")

        announced = first_event("preempt.announced")
        replace = first_event("autoscaler.replace", replaces=vh)
        dead = first_event("node.dead")
        origins = sorted({(e.get("extra") or {}).get("origin") for e in evs
                          if e.get("kind") == "autoscaler.scale_up"})
        for r in _replica_engines(handle):
            launches[RAGGED.name] += int(r.stats().get(f"launches.{RAGGED.name}", 0))
        live = serve.status()["fleet-llm"]["live_replicas"]
        goodput = result.goodput
        text = registry().prometheus_text()
        for k in KERNELS:
            launches[k.name] += k.launches
        by_prompt = {}
        for p, toks in [(0, first["tokens"])] + calls:
            by_prompt.setdefault(p, toks)
        mismatched = sum(1 for p, toks in calls if toks != by_prompt[p])
        untyped = [e for e in errors if not isinstance(e, RayTpuError)]
        resumed = [r for r in _CAP_RANKS if r["start"] > 0]
        log("capacity", f"{card}: (a) fleet: the first call {serve_s:.2f} s after the start "
            f"(2 replicas, graphs captured at first use); {scaler.stats['scale_ups']} scale-ups "
            f"({ups_before} before the reclaim; origins {origins}), {scaler.stats['replacements']} "
            f"replacement(s); run {result.status.value} {train_s:.2f} s after the reclaim, "
            f"num_preempt_restarts {result.num_preempt_restarts}, num_restarts "
            f"{result.num_restarts}; announced {announced['ts']:.3f} <= replace "
            f"{replace['ts']:.3f} <= dead {dead['ts']:.3f}; {len(calls)} calls "
            f"({mismatched} with tokens unlike their prompt's first), {len(errors)} errors "
            f"({[type(e).__name__ for e in errors]}), {live} replicas live")
        for r in _CAP_RANKS:
            log("capacity", f"  rank {r['rank']} from step {r['start']} ({r['left']}; restored "
                f"bitwise {r['restored']}): loss " + " ".join(f"{x:.4f}" for x in r["losses"]))
        log("capacity", f"  goodput {goodput['wall_time_s']:.3f} s: "
            + ", ".join(f"{b} {s:.3f}" for b, s in goodput["buckets"].items() if s))
        checks = [
            (result.status == RunStatus.FINISHED, f"the run ended {result.status} {result.error}"),
            (result.num_preempt_restarts == 1 and result.num_restarts == 0,
             f"restarts {result.num_preempt_restarts} / {result.num_restarts}"),
            (provider.num_preemptions() == 1 and scaler.stats["replacements"] >= 1,
             "one reclaim and a replacement"),
            (not victim.alive, "the preempted node never died"),
            (announced["node"] == vh and dead["node"] == vh
             and announced["ts"] <= replace["ts"] <= dead["ts"],
             "preempt.announced <= autoscaler.replace <= node.dead"),
            ((replace["extra"]["origin"], replace["extra"]["node_type"],
              replace["extra"]["capacity_class"]) == ("replace", "spot-train", "spot"),
             f"the replacement's tags {replace['extra']}"),
            ("pg" in origins and "task" in origins, f"scale-up origins {origins}"),
            (ups_before >= 3, f"{ups_before} scale-ups before the reclaim"),
            (not untyped and live == 2, f"untyped errors {untyped}, {live} replicas"),
            (mismatched == 0 and len(calls) > 0, f"{mismatched} calls unlike their prompt's first"),
            (abs(sum(goodput["buckets"].values()) - goodput["wall_time_s"])
             <= 0.05 * goodput["wall_time_s"], "the goodput buckets do not sum to the wall"),
            (all(name in text for name in ("raytpu_autoscaler_managed_nodes",
                                           'raytpu_autoscaler_scale_total{direction="up"}',
                                           "raytpu_autoscaler_preempt_replacements_total")),
             "the autoscaler's series are missing from the metrics text"),
            (len(resumed) == 2 and all(r["restored"] for r in resumed),
             f"resumed ranks {[(r['rank'], r['start'], r['restored']) for r in resumed]}"),
            (all(np.isfinite(r["losses"]).all() for r in _CAP_RANKS), "a non-finite loss"),
            (all(launches[k.name] for k in KERNELS), f"a kernel never launched: {launches}"),
        ]
        failed = [msg for ok, msg in checks if not ok]
        if failed:
            raise AssertionError(f"capacity (a): {failed}")
        serve.shutdown()
    finally:
        if scaler is not None:
            scaler.stop()
        ray_tpu_torch.shutdown()
    log("capacity", f"{card}: (a) {time.perf_counter() - t0:.2f} s, launches {launches}")
    return launches


def _cap_agents_dcn(card: str, wait_jobs) -> dict:
    """Parts (b) and (c): node agents that demand alone brought up (a GPU
    agent running the flash forward kernel; GPT-2 124M's train state
    replicated to it while two optimizer steps write the state in place;
    then a CPU agent without a CUDA context, started while the GPU agent
    checks the replicas), both reaped once idle. `wait_jobs()` joins part
    (d), whose cluster holds CUDA contexts of its own, before the card's
    contexts are counted. Returns the kernels' launches (this process's and
    the agent's)."""
    from ray_tpu_torch.core.capacity import (CapacityAutoscaler, LocalProcessNodeProvider,
                                             NodeType)
    from ray_tpu_torch.core.scheduler import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.parallel import CrossSliceReplicator

    t0 = time.perf_counter()
    before = udfs.live_children()
    rt = ray_tpu_torch.init(num_cpus=1, num_gpus=0, head=True,
                            _system_config={"node_heartbeat_s": 0.2})
    provider = LocalProcessNodeProvider(rt, startup_timeout_s=120.0)
    launches = {k.name: 0 for k in KERNELS}
    try:
        scaler = CapacityAutoscaler(
            rt.scheduler, provider,
            [NodeType("gpu1", {"CPU": 1.0, "GPU": 1.0}), NodeType("cpu2", {"CPU": 2.0})],
            poll_interval_s=0.1, idle_timeout_s=600.0, drain_grace_s=0.5, runtime=rt)
        scaler.start()
        check = ray_tpu_torch.get(ray_tpu_torch.remote(num_gpus=1)(
            cluster_udfs.flash_fwd_check).remote(SEED + 31, CAP_FLASH_SHAPE), timeout=CAP_TIMEOUT_S)
        gpu_s = time.perf_counter() - t0
        launches[FLASH_FWD.name] += check["launches"]
        atol, rtol, _ = KERNEL_TOL[torch.bfloat16]
        peer = next(n for n in rt.scheduler.nodes() if n.is_remote)
        log("capacity", f"{card}: (b) gpu1 agent pid {check['pid']} up and its flash forward "
            f"run {gpu_s:.2f} s after the start: max |err| {check['max_abs_err']:.3e} against the "
            f"plain version, {check['launches']} launch")
        if not (check["pid"] != os.getpid() and check["finite"] and check["launches"] == 1
                and check["max_abs_err"] <= atol + rtol
                and peer.labels.get("node_type") == "gpu1"
                and peer.resources.total.get("GPU") == 1.0):
            raise AssertionError(f"capacity (b): the gpu1 agent's kernel {check}, {peer.labels}")

        # (c) DCN: the train state at the call reaches the GPU agent bit for bit
        t1 = time.perf_counter()
        model = get_config(TRAIN_MODEL)
        opt = default_optimizer(TRAIN_LR, warmup_steps=2, total_steps=10)
        state = create_train_state(model, opt, SEED, device="cuda")
        step_fn = make_train_step(model, opt, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
        batches = [{"tokens": torch.randint(0, model.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                                            generator=gen, device="cuda")} for _ in range(6)]
        for k in KERNELS:
            k.launches = 0

        def timed_step(batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            nonlocal state
            state, m = step_fn(state, batch)
            m["loss"].item()
            torch.cuda.synchronize()
            return time.perf_counter() - t

        timed_step(batches[0])  # the first step pays its set-up
        alone = [timed_step(batches[1]), timed_step(batches[2])]
        expected = cluster_udfs.leaf_digests(state)
        exact = CrossSliceReplicator(peer.agent_addr)
        q8 = CrossSliceReplicator(peer.agent_addr, quantize="int8")
        try:
            t = time.perf_counter()
            exact.replicate_async("gpt2-state", state)
            submit_s = time.perf_counter() - t
            q8.replicate_async("gpt2-state-q8", state)
            t_push = time.perf_counter()
            in_flight = [timed_step(batches[3]), timed_step(batches[4])]
            exact.wait(timeout=CAP_TIMEOUT_S)
            push_s = time.perf_counter() - t_push
            q8.wait(timeout=CAP_TIMEOUT_S)
            after = timed_step(batches[5])
        finally:
            exact.close()
            q8.close()
        for k in KERNELS:
            launches[k.name] += k.launches
        # (b), the CPU agent: it boots while the GPU agent checks the replicas.
        # nvidia-smi lists the card's contexts under pids of another namespace
        # here: count them (this process's and the gpu1 agent's) before the
        # cpu2 agent joins and after it ran
        wait_jobs()
        apps_before = udfs.compute_app_pids()
        cpu_ref = ray_tpu_torch.remote(num_cpus=2)(udfs.cuda_state).remote()
        on_peer = lambda fn, *a: ray_tpu_torch.get(  # noqa: E731
            ray_tpu_torch.remote(num_cpus=1)(fn).options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(peer.node_id)).remote(*a),
            timeout=CAP_TIMEOUT_S)
        got = on_peer(cluster_udfs.replica_digests, "gpt2-state")
        errs = on_peer(cluster_udfs.replica_q8_errors, "gpt2-state", "gpt2-state-q8")
        moved = cluster_udfs.leaf_digests(state) != expected
        raw = exact.stats["raw_bytes"]
        log("capacity", f"{card}: (c) DCN: {raw / 1e9:.3f} GB of f32 train state "
            f"({len(expected)} leaves) to the gpu1 agent: replicate_async returned in "
            f"{submit_s * 1e3:.2f} ms, the exact push done {push_s:.2f} s after it "
            f"({raw / push_s / 1e9:.3f} GB/s, beside an int8 push of "
            f"{q8.stats['bytes'] / 1e9:.3f} GB = {q8.stats['bytes'] / q8.stats['raw_bytes']:.4f} "
            f"of its raw bytes); a step {statistics.median(alone) * 1e3:.2f} ms alone, "
            f"{' / '.join(f'{x * 1e3:.2f}' for x in in_flight)} ms with the pushes in flight, "
            f"{after * 1e3:.2f} ms after; the replica equals the state at the call bit for bit: "
            f"{got['digests'] == expected} (on {got['devices']}); int8 worst relative error "
            f"{errs['worst_rel']:.5f} over {errs['float_leaves']} float leaves, the rest exact "
            f"{errs['others_exact']} ({time.perf_counter() - t1:.2f} s)")
        checks = [
            (got["digests"] == expected and got["devices"] == ["cpu"] and moved,
             "the replica is not the state at the call"),
            (submit_s < 0.05, f"replicate_async took {submit_s:.3f} s"),
            (q8.stats["bytes"] < CAP_DCN_WIRE * q8.stats["raw_bytes"], "int8 wire bytes"),
            (errs["worst_rel"] < CAP_DCN_REL and errs["others_exact"], f"int8 errors {errs}"),
        ]
        failed = [msg for ok, msg in checks if not ok]
        if failed:
            raise AssertionError(f"capacity (c): {failed}")
        del state, batches, step_fn
        pid, _, has_cuda = ray_tpu_torch.get(cpu_ref, timeout=CAP_TIMEOUT_S)
        apps = udfs.compute_app_pids()
        deadline = time.monotonic() + 30  # a task can finish before its launch is counted
        while scaler.stats["scale_ups"] < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        types = {n.labels.get("node_type"): n for n in rt.scheduler.nodes() if n.is_remote}
        log("capacity", f"{card}: (b) cpu2 agent pid {pid}: CUDA context {has_cuda}, GPU "
            f"{types['cpu2'].resources.total.get('GPU', 0.0)}; the card's compute apps "
            f"{apps_before} before it, {apps} after; scale-ups {scaler.stats['scale_ups']}")
        checks = [
            (len(apps_before) == 2, f"compute apps {apps_before}: want this process and gpu1's"),
            (not has_cuda and pid not in apps and len(apps) == len(apps_before),
             "the cpu2 agent holds a CUDA context"),
            (types["cpu2"].resources.total.get("GPU", 0.0) == 0.0, "the cpu2 agent's GPU"),
            (scaler.stats["scale_ups"] == 2, f"{scaler.stats['scale_ups']} scale-ups"),
        ]
        failed = [msg for ok, msg in checks if not ok]
        if failed:
            raise AssertionError(f"capacity (b): {failed}")
        gc.collect()
        torch.cuda.empty_cache()

        scaler.idle_timeout_s = 0.5  # now both agents may go
        deadline = time.monotonic() + CAP_TIMEOUT_S
        while scaler.stats["scale_downs"] < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        if scaler.stats["scale_downs"] != 2 or provider.pids():
            raise AssertionError(f"capacity (b): scale-downs {scaler.stats}, agents left "
                                 f"{provider.pids()}")
        scaler.stop()
    finally:
        provider.shutdown()
        ray_tpu_torch.shutdown()
        cfg.reset()
    left = udfs.wait_no_children(before, timeout=30)
    if left:
        raise AssertionError(f"capacity (b): agent processes left {left}")
    log("capacity", f"{card}: (b) + (c) {time.perf_counter() - t0:.2f} s, both agents reaped "
        f"once idle; launches {launches}")
    return launches


def _cap_jobs(card: str, tmp: str) -> dict:
    """Part (d): `launcher` brings up a head without a GPU and a worker with
    one from a JSON config; a job (`torch_capacity_job.py`) joins it and
    runs the flash forward kernel on the worker; a sleeping job is
    stopped; `down` leaves no process with the launch tag. Returns the
    kernels' launches (the job's, read from its log)."""
    import re
    import socket

    from ray_tpu_torch.jobs import JobManager
    from ray_tpu_torch.launcher import ClusterLauncher, down_pattern, load_config

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = os.path.join(tmp, "cluster.json")
    with open(path, "w") as f:
        json.dump({"head": {"port": port, "num_cpus": 1, "num_gpus": 0},
                   "workers": [{"host": "localhost", "num_cpus": 1, "num_gpus": 1}],
                   "provider": "local", "token": "chip-smoke-capacity"}, f)
    launcher = ClusterLauncher(load_config(path))
    saved = {k: os.environ.get(k) for k in CAP_LAUNCH_DRAIN}
    os.environ.update(CAP_LAUNCH_DRAIN)  # the launched nodes inherit it
    launches = {k.name: 0 for k in KERNELS}
    try:
        info = launcher.up(wait_s=CAP_TIMEOUT_S)
        up_s = time.perf_counter() - t0
        mgr = JobManager(log_dir=os.path.join(tmp, "jobs"))
        job = mgr.submit(f"{sys.executable} torch_capacity_job.py --address {info['address']} "
                         f"--token chip-smoke-capacity --seed {SEED + 51}")
        sleeper = mgr.submit(f"{sys.executable} -c 'import time; time.sleep(600)'")
        status = mgr.wait(job, timeout=CAP_TIMEOUT_S)
        job_s = time.perf_counter() - t0 - up_s
        stopped = mgr.stop(sleeper)
        sleeper_status = mgr.wait(sleeper, timeout=60)
        logs = mgr.logs(job)
    finally:
        launcher.down()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    tag = launcher.config["_launch_tag"]
    pattern = re.compile(down_pattern(tag))

    def tagged():
        out = []
        for name in os.listdir("/proc"):
            if name.isdigit():
                try:
                    with open(f"/proc/{name}/cmdline", "rb") as f:
                        line = f.read().replace(b"\0", b" ").decode(errors="replace")
                except OSError:
                    continue
                if pattern.search(line):
                    out.append(int(name))
        return out

    deadline = time.monotonic() + 60
    while tagged() and time.monotonic() < deadline:
        time.sleep(0.2)
    lines = [ln for ln in logs.splitlines() if ln.startswith("capacity-job ")]
    result = json.loads(lines[-1].split(" ", 1)[1]) if lines else {}
    launches[FLASH_FWD.name] += result.get("launches", 0)
    atol, rtol, _ = KERNEL_TOL[torch.bfloat16]
    log("capacity", f"{card}: (d) `up` {len(info['nodes'])} nodes in {up_s:.2f} s (tag {tag}); "
        f"the job {status.value} {job_s:.2f} s later: {result}; the sleeping job stopped "
        f"{stopped} -> {sleeper_status.value}; processes with the tag after `down`: {tagged()} "
        f"({time.perf_counter() - t0:.2f} s)")
    checks = [
        (status.value == "SUCCEEDED" and result, f"the job: {status.value}\n{logs[-3000:]}"),
        (result.get("launches") == 1 and result.get("finite")
         and result.get("max_abs_err", 1.0) <= atol + rtol, f"the job's kernel {result}"),
        (stopped and sleeper_status.value == "STOPPED", "the sleeping job did not stop"),
        (not tagged(), f"processes with the tag after down: {tagged()}"),
    ]
    failed = [msg for ok, msg in checks if not ok]
    if failed:
        raise AssertionError(f"capacity (d): {failed}")
    return launches


def phase_capacity(card: str) -> dict:
    """Cluster mode's capacity plane, jobs, launcher and DCN on GPT-2 124M
    (see the module docstring, `capacity`): (a) the spot fleet, (b) agents
    from demand, (c) DCN, (d) jobs and the launcher, on a thread beside (a)
    and (b). Returns each kernel's launches summed over the parts and their
    processes."""
    t0 = time.perf_counter()
    ray_tpu_torch.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_capacity_")
    # (d) touches nothing of this process's runtime (its cluster and jobs are
    # processes of their own): it runs on a thread beside (a) and (b)
    jobs: dict = {}

    def run_jobs():
        try:
            jobs["launches"] = _cap_jobs(card, tmp)
        except BaseException as exc:  # noqa: BLE001 - raised again by wait_jobs
            jobs["error"] = exc

    jobs_thread = threading.Thread(target=run_jobs, name="chip-smoke-capacity-d", daemon=True)

    def wait_jobs():
        jobs_thread.join(CAP_TIMEOUT_S)
        if jobs_thread.is_alive():
            raise AssertionError("capacity (d): the launched cluster's part did not finish")
        if "error" in jobs:
            raise jobs["error"]

    jobs_thread.start()
    try:
        parts = {"a": _cap_fleet(card, tmp)}
        gc.collect()
        torch.cuda.empty_cache()
        parts["bc"] = _cap_agents_dcn(card, wait_jobs)
        wait_jobs()
        parts["d"] = jobs["launches"]
    finally:
        jobs_thread.join(CAP_TIMEOUT_S)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k.name: sum(p[k.name] for p in parts.values()) for k in KERNELS}
    log("capacity", f"phase {time.perf_counter() - t0:.2f} s ({card}); launches {launches}")
    return dict(launches=launches, by_part=parts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_run = time.perf_counter()
    card = phase_env()
    phase_build()
    timer = _Timer()
    results = phase_kernels(timer)
    del timer
    torch.cuda.empty_cache()
    server, config, prompts, outs, ragged_split, serve_launches, profiled, direct = phase_serve()
    if min(ragged_split.values()) == 0:
        raise AssertionError(f"the serving path never launched the ragged kernels of one kind: "
                             f"{ragged_split}")
    before = {k.name: k.launches for k in KERNELS}
    try:
        phase_check(server, config, prompts, outs)
        for k in KERNELS:
            serve_launches[k.name] += k.launches - before[k.name]
        spec = phase_spec(server, config, prompts, outs)
        dense_launches = phase_dense(server, config, prompts, outs)
        overload = phase_overload(config)
        deploy = phase_deploy(server, config, prompts, outs, direct)
        observe = phase_observe(server, config, prompts)
        tp_serve = phase_tp_serve(server, config, prompts, outs)
    finally:
        server.shutdown()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    cluster, members, llm, agent = phase_cluster(card, config, prompts)
    head_restart = phase_head_restart(card, prompts, members, llm, agent)
    del llm, agent, members
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = phase_train()
    gc.collect()
    torch.cuda.empty_cache()
    trainer = phase_trainer()
    gc.collect()
    ingest = phase_ingest(card)
    gc.collect()
    torch.cuda.empty_cache()
    process = phase_process(card)
    gc.collect()
    torch.cuda.empty_cache()
    dp = phase_dp(card)
    gc.collect()
    torch.cuda.empty_cache()
    gang = phase_gang(card, dp)
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_tp = phase_fsdp_tp(card)
    gc.collect()
    torch.cuda.empty_cache()
    a7 = phase_a7(card)
    gc.collect()
    torch.cuda.empty_cache()
    capacity = phase_capacity(card)
    for label, check in fsdp_tp["checks"].items():
        results["flash_attention_fwd"][f"{label}_shape"] = check["forward"]
        for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
            results[name][f"{label}_shape"] = check[name]
    by_mode = {f"({m}) {'f32' if m == 'a' else 'bf16'}": fsdp_tp["modes"][m]["launches"]
               for m in ("a", "a2", "b")}
    kernels = []
    for k in KERNELS:
        by_path = {"serve": serve_launches[k.name], "spec": spec["launches"][k.name],
                   "dense": dense_launches[k.name], "overload": overload["launches"][k.name],
                   "deploy": deploy["launches"][k.name], "observe": observe["launches"][k.name],
                   "tp_serve": tp_serve["launches"][k.name], "cluster": cluster["launches"][k.name],
                   "head_restart": head_restart["launches"][k.name],
                   "train": train_launches[k.name], "trainer": trainer["launches"][k.name],
                   "ingest": ingest["launches"][k.name], "process": process["launches"][k.name],
                   "dp": dp["launches"][k.name], "gang": gang["launches"][k.name],
                   "fsdp_tp": fsdp_tp["launches"][k.name], "a7": a7["launches"][k.name],
                   "capacity": capacity["launches"][k.name]}
        kernels.append(dict(
            name=k.name, route="cuda", source=SOURCES[k.name], replaces=REPLACES[k.name],
            launches=sum(by_path.values()), launches_by_path=by_path, **results[k.name]))
        if k in (FLASH_FWD, FLASH_BWD_DKV, FLASH_BWD_DQ):
            kernels[-1]["fsdp_tp_launches_by_mode"] = {m: n[k.name] for m, n in by_mode.items()}
            kernels[-1]["a7_launches_by_part"] = {p: n[k.name] for p, n in a7["by_part"].items()}
        if k is RAGGED:
            kernels[-1]["serve_launches_by_kind"] = ragged_split
            kernels[-1]["serve_device_kernels_profiled_repeat"] = profiled
            kernels[-1]["spec_device_kernels_profiled_repeat"] = spec["profiled"]
            kernels[-1]["overload_device_kernels_profiled_repeat"] = overload["profiled"]
            kernels[-1]["deploy_device_kernels_profiled_repeat"] = deploy["profiled"]
            kernels[-1]["observe_device_kernels_profiled_capture"] = observe["profiled"]
    log("total", f"{time.perf_counter() - t_run:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
