#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``kubeflow_tpu_torch``): the quickest
proof that the port still starts, serves, decodes and trains through its
own kernels on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure exits nonzero; no phase catches its own failure):

1. probe   — card name and power limit, torch/CUDA/nvcc versions, and the
             build of every kernel from csrc/ (one nvcc per source, all
             started together), with its seconds; per kernel body its
             registers and spills (ptxas). Disassembles the three flash
             libraries (cuobjdump -sass, beside nvcc) and fails unless
             their bf16 bodies (forward, dQ, dK/dV; names ending _sm90)
             hold HGMMA (wgmma, the tensor cores).
2. parity  — each kernel against its plain PyTorch version on the card,
             at the serving shape (B=8, H=32, KV_H=8, D=128, bs=64) with
             ragged kv_len (0, 1, a block crossing, ~1000), bf16 and f32;
             then at the lengths where the kernel's split of a slot's
             walk over thread blocks turns (0, 1, one split's rows - 1,
             + 0, + 1, a full table row; ops/paged_attention.split_plan).
             The paged kernel's grid is (split, KV head, slot), each
             split walking its share of the slot's live blocks, and a
             second pass merges the splits (flash-decoding).
3. timing  — CUDA-event median per launch (L2 flushed between launches)
             of the kernel (both passes) and its plain version, beside
             the kernel's bound (bytes of q, out, the tables and the K/V
             rows below kv_len over 3.35 TB/s).
3q. quant parity — the fused-dequant kernel (int8 and fp8-e4m3 pools with
             per-block per-KV-head scales) against its plain version at
             the serving shape, q in bf16 and f32; in f32 also bitwise
             against the unquantized kernel over the f32 dequant view;
             zeros for the idle slot.
3t. quant timing — as phase 3 for the fused-dequant kernel, int8 and
             fp8, beside its bound (one byte per K/V element plus the
             scale words of the live blocks).
3s. sharded kernel — ``paged_decode_attention_sharded`` (the JAX
             package's shard_map of the kernel over KV heads) at the
             serving shape split over tensor=4: each rank's contiguous
             slice through the kernels, the outputs concatenated, BITWISE
             equal to the unsharded launch in bf16 and f32, unquantized
             and int8/fp8 (each head's arithmetic is the same, so any
             difference is a slicing fault). CUDA-event medians of one
             rank's launch (KV_H 2, H 8) and its plain version, beside
             its bound and SDPA over the rank's dense view.
4. serving — llama3_8b at its published widths, all 32 layers, random
             bf16 weights from a seeded CUDA generator, behind the port's
             LLMModel + ModelServer on 127.0.0.1:0: four concurrent V2
             predict requests over HTTP (greedy, 32 tokens; prompts of
             ~100 and ~300 tokens, one longer than the largest prefill
             bucket, one sharing a block-aligned prefix). Checks the
             token counts, that decode ran through the kernel (launch
             count == n_layers x decode device steps), that it replayed
             the decode program LLMModel.load captured as a CUDA graph,
             prefix hits, and one stream against the full forward's
             teacher-forced argmax within the bf16 tie tolerance. Phases
             4q, 5s (its decode fallbacks) and 5d (the decode tier)
             serve through load()'s captured program the same way.
4q. quantized serving — the same weights behind LLMModel(quant=int8 KV +
             int8 weights), the same four requests: 32 tokens each, the
             fused-dequant kernel's launches == n_layers x decode device
             steps with the unquantized kernel's count at 0, prefix hits,
             chunked prefill, the active quant tag, no downgrade. Prints
             pool and weight bytes and the decode step beside phase 4's.
4tp. tensor-parallel serving — the same llama3_8b weights on 4 ranks
             (each rank draws only its shard from the same seed):
             ``LLMModel(mesh=TensorMesh(4, ...))`` behind ModelServer,
             one card per rank over NCCL where the machine has 4, else
             all ranks on card 0 over gloo (no tensor-parallel speedup
             then; the line before the phase says which). The four
             requests of phase 4, TP_TOKENS = 16 greedy tokens each
             (phase 4 serves 32): token counts,
             the paged kernel's launches ON EVERY RANK == n_layers x
             decode device steps (local KV_H 2), prefix hits, chunked
             prefill, every rank's sampling bodies and token digest
             equal (every token sampled alike on every rank), one
             stream against the unsharded full forward within the bf16
             tie tolerance, and the teacher-forced logits of two seeded
             streams against the one-card engine's under an rms limit
             set against planted faults (tools/tp_quality.py). Then the
             same with int8 KV + int8 weights (the fused-dequant kernel
             on every rank, row 1 at 0; compared with the one-card int8
             engine). Prints the decode step as served (batch 8, one
             dispatch per decode_chunk steps) beside a one-card model's
             timed the same way, and the dispatch round trip alone.
             Everything is freed before phase 5s.
4qq. quant quality — the JAX package's gate (bench.py
             _quant_teacher_forced) at full width: the bf16 engine
             free-runs greedy through paged_decode_step (kernel path) on
             two prompts, each quantized configuration (int8 KV + int8
             weights, fp8 KV + int8 weights) replays that stream
             teacher-forced. Holds the JAX budgets (agreement >= 0.85,
             max logit drift <= 1.0) in the JAX gate's own configuration
             (llama_tiny f32); at full width the drift budget and an rms
             logit error limit per KV dtype set against planted faults.
             The model is freed after.
4g. decode graph — llama3_8b at its published widths, the first
             GRAPH_LAYERS = 8 of phase 4's 32 layers, max_batch 8,
             max_seq 1024, block 64, decode_chunk 8, bf16 and int8
             KV + int8 weights: an eager LLMEngine and one whose decode
             program precompile() captured as a CUDA
             graph, on the same weights. (a) Phase 4's four prompts, 32
             greedy tokens each, pipelined, through both: token for token
             equal streams and bitwise equal logprobs (the largest
             difference printed); (d) a fifth request admitted
             mid-stream, so that replays run with fresh host tokens and
             a new table row: its stream equal too; the paged kernel's
             launches over both runs == n_layers x their device steps.
             (b) torch.profiler over one replay counts n_layers x
             decode_chunk launches of each of the paged kernel's two
             passes. (c) Capture seconds and the graph's pool bytes;
             eager against replay, eight 300-token streams decoding
             (tools/decode_profile.dispatch_readings): wall ms per step,
             device busy ms, idle share, API launches per step.
5s. speculative decoding — (a) llama_tiny in f32 (at head_dim 64, the
             paged kernel's smallest) on the card: speculative streams
             token-identical to plain ones. Then llama3_8b at full width
             (phase 4's weights and geometry, spec_k 3, verify width 4):
             phase 4's four prompts and two whose second half repeats
             the first, 64 greedy V2 tokens each over HTTP, first with
             the drafter off, then on (prefix cache cleared between):
             drafted, accepted and committed tokens, tokens per verify
             dispatch, the undrafted rounds that fell back to decode and
             their row 1 launches (== n_layers x those device steps);
             (b) teacher-forced, 4 verify dispatches against 16 decode
             steps over the same tokens and pool, rms error over rms
             under a limit between the sound reading and a planted fault
             (the query offset one too far), both printed; (c) the first
             index where each speculative stream leaves the plain one,
             passing only where the decode program's top-2 gap there is
             under 2 x (b)'s largest error; the verify and decode steps
             timed and profiled (batch 8, 300-token contexts). The same
             with int8 KV + int8 weights (row 2). Then tensor=4 as phase
             4tp runs it: three prompts, 12 tokens, rank digests equal,
             row 3 on every rank for the fallbacks, (c) against the
             one-card plain streams with phase 4tp's drift allowed.
5d. disaggregated serving — a prefill tier and a decode tier, each an
             LLMModel with its own copy of llama3_8b's weights (its
             widths, DISAGG_LAYERS = 8 of its 32 layers, seed 0) behind
             its own ModelServer, attached as the runtime attaches
             KFT_TIER replicas: phase 4's 100-, 300- and 700-token
             prompts migrated one at a time through
             /v2/models/{m}/disagg/prefill and /collect
             (DISAGG_TOKENS = 16), each equal token for token to the same prompt served
             co-located; per request the migrated blocks and bytes,
             prefill/export/transfer and inject-to-first-commit seconds
             and the host round trip's GB/s; the decode tier's row 1
             launches (== n_layers x its decode device steps) over
             blocks it did not write; a duplicate kv frame injects once
             and a release frame frees the decode side's blocks; no
             migration failure. Then the same with int8 KV (row 2).
5dt. disaggregated tiers on a mesh — inside 5d, for each KV dtype, while
             5d's one-card tiers are up: 5d's llama3_8b cut as a
             ``LLMModel(mesh=)`` of KFT_MESH=tensor=DISAGG_TP
             (each rank drawing its shard of 5d's seeded weights; two
             ranks on card 0 over gloo, or a card a rank over NCCL where
             two cards are present, as the line before the phase says),
             playing both tiers through a prefill and a decode
             TierRuntime over its engine: 5d's three prompts (100, 300,
             700 tokens) migrated mesh -> 5d's one-card decode tier and
             5d's one-card prefill tier -> mesh, DISAGG_TP_TOKENS greedy
             tokens each. Per request: token counts, migrated blocks and
             frame bytes, the decode side's launches over blocks it did
             not write (row 1 or 2 on one card, row 3 on every rank ==
             n_layers x its decode device steps), the stream against the
             unsharded full forward's teacher-forced argmax within the
             bf16 tie tolerance, and the mesh's payload (every KV head,
             its ranks' slices joined in tensor order) against the
             one-card payload for the same prompt: rms error over rms
             under DISAGG_TP_PAYLOAD_MAX, with the planted fault (the
             head slices joined in reverse) read beside it and required
             above it. Prints export, transfer and inject-to-first-commit
             seconds beside 5d's, checks the ranks' digests agree and no
             block stays in use on any rank.
5m. MoE serving — Mixtral-8x7B at its published widths (the literal
             config.json through hf_llama.config_from_hf), 16 of its 32
             layers (46.97 GB in bf16; all 32 would not fit the card),
             random bf16 weights from a seeded CUDA generator, dropless
             routing (moe_capacity_factor 0), phase 4's geometry. Starts
             after phase 5d's model is freed and logs the memory still
             allocated. (a) Phase 4's four requests over HTTP V2 to an
             LLMModel whose load() captured the decode program, 32 greedy
             tokens each: token counts, row 1 launches == n_layers x
             decode device steps, replays, prefix hits, chunked prefill.
             (b) An eager LLMEngine and a precompiled one on the same
             weights, driven as phase 4g drives them: equal streams and
             bitwise equal logprobs. (c) One served stream teacher-forced
             through the serving path (chunked prefill, then decode
             steps through row 1) against llama.forward on the capacity
             path with capacity = the token count (no drops: the same
             function through other code) and the serving path's
             routing, the rms of the logit error over the forward's rms
             under a limit set between the sound reading and a planted
             fault (tools/moe_quality.py); prints the same against the
             free forward and the routing decisions that differ.
             (e) Eight 300-token streams, eager against replay
             (tools/decode_profile.dispatch_readings), beside the step's
             weight-read bound (every expert runs on the dropless path).
             (d) KFT_QUANT_KV=int8 + KFT_QUANT_WEIGHTS=int8 (the runtime's
             env parsing): the weights downgrade with the JAX package's
             reason, the four requests run through row 2 alone. Keeps
             phase 5n's reference: two seeded streams (16-token prompts,
             32 greedy tokens) teacher-forced through the one-card
             engine.
5n. MoE tensor-parallel serving — after phase 5m's weights are freed,
             the same Mixtral cut (16 of 32 layers, dropless, seed 0)
             under KFT_MESH=tensor=MOE_TP through the runtime's env
             parsing (mesh_from_topology_env): each rank draws the mlp
             slice of every expert (and the router whole), routes as
             every rank does and all-reduces the MoE output beside the
             attention's; two ranks on card 0 over gloo on one card (no
             tensor-parallel speedup), a card a rank over NCCL where
             the machine has two. Phase 4's four requests over HTTP V2,
             32 greedy tokens each: every rank's row 3 launches ==
             n_layers x decode device steps, every rank's sampling
             bodies and token digest equal; phase 5m's two streams
             teacher-forced through the mesh against 5m's one-card
             logits, the rms logit error under MOE_TP_RMS_MAX (set
             between the sound reading and a planted fault, the MoE
             all-reduce dropped: tools/moe_quality.py --tensor); the
             decode step as served.
5e. MoE over an expert axis — after phase 5n's mesh is freed, the same
             Mixtral cut under KFT_MESH=expert=MOE_EP,tensor=MOE_EP_TP
             through the runtime's env parsing: four ranks (on card 0
             over gloo, or a card a rank over NCCL where four cards are
             present), each drawing its 4 experts' mlp slice and the
             router whole, routing every token as one card does; the
             MoE output summed over the whole mesh, attention's over
             tensor. Phase 4's four requests over HTTP V2, 32 greedy
             tokens each: every rank's row 3 launches == n_layers x
             decode device steps, every rank's sampling bodies and
             digest equal, each rank at its (expert, tensor) index
             holding its experts; phase 5m's two streams teacher-forced
             through the mesh against 5m's one-card logits, the rms
             logit error under MOE_EP_RMS_MAX (set between the sound
             reading and a planted fault, the MoE output summed over
             tensor only: tools/moe_quality.py --expert 2 --tensor 2);
             the decode step as served beside phase 5n's.
5x. Mixtral-8x7B at all 32 layers (93.4 GB bf16, which no one card
             holds) under tensor=MOE_TP_FULL, then under
             expert=MOE_EP,tensor=MOE_EP_TP, one card a rank over NCCL,
             eager (no capture under a mesh): the four requests, rank
             digests equal, row 3's launches on every rank, the decode
             step as served. Runs only on a machine with four cards or
             more, and says it was skipped otherwise.
5. flash parity — the three flash-attention kernels (forward, dQ, dK/dV)
             against their plain versions on the card: the training
             shape (B=2, S=2048, H=16, KV_H=8, D=128, causal), an
             unaligned non-causal S=1000 with G=4, and D=64; bf16 and f32.
             The bf16 kernels round P (forward, against the running max
             of its 64-wide KV blocks; dK/dV) and dS (dQ, dK/dV) to bf16
             on the tensor cores and are held two ways
             (tools/flash_parity.py): (a) within one ulp plus a near-tie
             allowance of the plain version that rounds at the same
             points, and (b) under an rms limit against the float32
             plain version (the JAX function); a float64-ordered control
             must meet (a) too; the forward's lse within 1e-4 of the
             plain lse. float32: within 1e-4 of the plain version.
6. flash timing — CUDA-event medians (L2 flushed) of each flash kernel
             and its plain version at the training shape in bf16, beside
             its bound and SDPA's forward / backward time (a yardstick
             only; the port never calls SDPA).
7. training — llama_1b at full width (vocab 32768, dim 2048, 16 layers,
             16/8 heads, mlp 5632, tied embeddings; random f32 weights
             from a seeded CUDA generator) as the JAX package's bench
             trains it: remat="dots", attn_impl="pallas", adafactor,
             lr 3e-4, warmup 10, global batch 32 x seq 2048, grad_accum
             16, as the JAX pod runs it: init_state, then
             Trainer.precompile(first batch), which captures the step as
             two CUDA graphs (the micro batch's forward and backward; the
             optimizer), then fit over synthetic_lm_batches, which
             replays them: one warm-up step and two timed steps. Logs the
             precompile outcome, capture seconds and graph pool bytes,
             the replayed step's wall time, tokens/s and MFU, and peak
             memory. Checks finite losses, step 0's loss near ln(vocab)
             + 1/2, the flash launch counts added by the replays (per
             micro batch 2 x n_layers forward, n_layers dQ and dK/dV),
             an eager trainer from the same seed over the same batches
             bitwise equal to the replayed one (losses, grad norms,
             parameters), and one micro batch's loss and gradients
             through the kernels against attn_impl="xla" (plain einsum
             attention) from the same parameters.
7m. MoE training — llama_1b's widths with 8 experts (top-2, capacity
             1.25), MOE_TRAIN_LAYERS = 2 of its 16 layers, trained
             as phase 7 trains: an eager trainer takes 3 steps (its
             losses, grad norms, moe_aux and parameters kept on the
             host) and is freed, then one from the same seed runs
             init_state, precompile and fit over the same batches,
             replayed. Checks finite losses, step 0's loss near ln(vocab)
             + 1/2 + moe_aux, replayed bitwise equal to eager, the flash
             launch counts of both runs; logs capture seconds, pool
             bytes, the step, tokens/s, MFU (active top-k FLOPs) and peak
             memory.

8. training pod and resume — (a) the port's pod entry, ``python -m
             kubeflow_tpu_torch.rendezvous.worker_check``, as a subprocess
             on the card under the env the controller stamps
             (KFT_TRAIN_STEPS=6, KFT_CHECKPOINT_EVERY=2, KFT_DEPOT a
             temporary directory, KFT_PHASES_PATH, KFT_METRICS_PATH,
             KFT_HEARTBEAT_FILE): the reference's llama_tiny f32 trainer,
             restored, then precompile()d (captured), then fit. One
             uninterrupted run (profiled over step 1) and, beside it, a
             victim paced by KFT_STEP_SLEEP, SIGKILLed once step 2's
             checkpoint directory exists; a restart with the same env.
             Checks the
             restart's resumed_from_step >= 2 and restore_done, the depot
             counters (compiles and serialize_failures 1: a CUDA graph
             cannot leave its process) and outcome "compiled", every
             stamp the reference writes, and the losses of every step
             after the resume bitwise the uninterrupted run's. (b)
             llama_1b in phase 7's configuration, cut to RESUME_LAYERS =
             2 of its 16 layers, fed by a TokenDataset
             (two shards of 1<<22 tokens, ids < 32768, from a numpy
             stream seeded 0, written by write_token_shards), three
             trainers one at a time: A init_state, precompile, fit to
             step 4 with checkpoint_every 2 (losses, grad norms and final
             parameters kept on the host); B the same into a fresh
             directory, stopped at step 2; C init_state, precompile
             FIRST, then fit on B's directory, which restores step 2
             into the captured tensors, to step 4. C's losses, grad
             norms and final parameters must be bitwise A's, the restore
             must leave every state tensor at its address, C's step
             graphs must replay, and the flash launches of each fit
             must be per micro batch 2 x n_layers forward, n_layers dQ
             and dK/dV. Logs the checkpoint bytes, the blocking seconds
             of save (the device-to-host copy) beside the replayed
             step's, the background write's seconds and GB/s, restore
             seconds, peak memory and free disk before and after; the
             scratch directory is removed at the end. (c) A serving
             replica under KFT_DEPOT: LLMModel.load() on llama_tiny f32
             (head_dim 64) captures the decode program as without the
             depot, reports depot_outcome "compiled" with compiles and
             serialize_failures 1 in stats()["depot"], never touches the
             depot directory, and serves the same greedy tokens as a
             replica loaded without it, both through replays.

9. training across processes — (a) the phase 8 pod as a two-process
             world (KFT_NUM_PROCESSES=2, a free localhost port), with
             KFT_MESH=data=2, with the default (fsdp=2) and with
             KFT_MESH=tensor=2 (both processes feed the same rows), side
             by side: an uninterrupted world, a victim paced by
             KFT_STEP_SLEEP and SIGKILLed (both processes) once step 2's
             checkpoint exists, and its restart, started at once beside
             the uninterrupted world. Checks the restart's
             resumed_from_step >= 2 and its losses after the resume
             bitwise the uninterrupted world's, and logs the backend each
             world chose and why (the default world's fsdp is ZeRO-3). (b)
             llama_1b in phase 7's configuration, cut to WORLD_LAYERS = 4
             of its 16 layers (remat dots, attn_impl
             pallas, adafactor, global batch 32 x 2048 in 16 micro
             batches of 2 rows) over two processes (tools/world_train),
             each feeding its own 16 rows (ragged loss masks whose
             density differs by rank) in 8 micro batches, as data=2 and
             as fsdp=2 (ZeRO-3: each layer gathered inside the micro
             bodies and its gradients reduce-scattered) in one world.
             data=2: an eager run of 3 steps, then a fresh trainer
             precompile()d and replayed 3 steps, every rank's replayed
             losses, grad norms and parameters bitwise its eager run's.
             fsdp=2: one run of WORLD_FSDP_STEPS steps after precompile(),
             which under gloo captures neither body (micro_mode and
             finish_mode "eager": a gloo collective cannot sit in a
             graph), so the run's steps are eager. Per layout both
             ranks' metrics equal, and the flash launches per rank 8
             micro batches x (2 x 4 forward, 4 dQ, 4 dK/dV) a step.
             After the world exits, a one-process trainer from the same
             seed (grad_accum 16) replays 3 steps on the concatenated
             batches; each layout's losses and grad norms must be within
             WORLD_LOSS_RTOL / WORLD_NORM_RTOL of its steps (limits
             between the sound reading and planted faults). Logs per
             rank the step's seconds, its host-staged collectives
             (device-to-host, gloo, host-to-device seconds and bytes),
             fsdp's per-layer gathers and reduce-scatters (count, bytes,
             seconds), peak memory, the memory still allocated after the
             steps, and each layout's state kept per rank
             (Trainer.state_bytes). Checks after every run that
             state_bytes counts every tensor the trainer reaches and all
             but WORLD_UNCOUNTED_MAX of the memory the run added, that
             an fsdp rank keeps half a data rank's parameters and
             gradients and at most WORLD_STATE_SHARE_MAX of its state.
             Two cards or more give each rank its own card and NCCL; one
             card, gloo. (c) llama3_8b at its published widths (32
             layers, 8.03 B parameters, random weights from seed 0),
             remat dots, attn_impl pallas, adamw, fsdp=4 with one card a
             rank over NCCL, each rank 2 micro batches of 2 x 2048 a
             step: an eager run of 3 steps, then a fresh trainer
             precompile()d (both bodies captured with their NCCL
             collectives) and replayed 3 steps, each run's last step
             traced (device busy, NCCL busy, idle share). Checks every
             rank's replayed losses, grad norms and parameter parts
             bitwise its eager run's and rank 0's, finite losses, the
             flash launches, and that a rank keeps exactly its quarter
             of the parameters, gradients and adamw moments (32.1 GB).
             Logs the step, tokens/s a card, MFU, peak memory, the eager
             steps' per-layer gathers and reduce-scatters. Runs only on
             a machine with four cards or more, and says it was skipped
             otherwise.
             (t) phase 9b's llama_1b under tensor=2
             (Megatron's cuts: each rank its half of the heads, the MLP
             and the vocab, joined by all-reduces in the forward after
             each row-parallel product and in the backward before each
             column-parallel one, the logits all-gathered): two ranks on
             one card over gloo (the world 9m's, 9r's, 9rm's and 9p's
             plans run in after it, card_pair_world; its readings follow
             that world), each feeding the same 32 rows (phase
             9b's global batch, its two places merged) in 16 micro
             batches, TENSOR_STEPS steps after precompile(), which under
             gloo captures neither body (a tensor all-reduce sits in
             every block). Checks both ranks' metrics equal, the losses
             and grad norms against phase 9b's one-process reference on
             the same rows within TENSOR_LOSS_RTOL / TENSOR_NORM_RTOL
             (limits between the sound reading and planted faults), the
             flash launches per rank 16 micro batches x (2 x 4 forward
             on the rank's 8 query and 4 KV heads, 4 dQ, 4 dK/dV) a
             step, and that a rank keeps exactly its slices: half of
             every cut leaf and the whole norms, of the parameters and
             of the gradients. Logs per rank the step's seconds, its
             tensor collectives (count, bytes, seconds) and peak memory.
             (d) llama3_8b at its published widths under fsdp=2 x
             tensor=2, one card a rank over NCCL, remat dots, adamw,
             phase 9c's global batch (each place in the batch axes 4
             micro batches of 2 x 2048): 3 eager steps, then a fresh
             trainer precompile()d (both bodies captured with their
             gathers, reduce-scatters and tensor all-reduces) and
             replayed 3 steps, each run's last step traced. Checks every
             rank's replay bitwise its eager run, tensor peers' metrics
             equal, the flash launches (16 query, 4 KV heads a rank),
             and that a rank keeps exactly its share of the parameters,
             gradients and adamw moments (a quarter of every leaf cut
             on both axes, half of the norms). Logs the step, tokens/s
             a card, MFU, NCCL busy share beside phase 9c's. Runs only
             on a machine with four cards or more, and says it was
             skipped otherwise.

9m. MoE across processes — llama_moe_8x(llama_1b()) at full width (8
             experts, top-2, capacity 1.25, remat dots, attn_impl pallas,
             adafactor) cut to MOE_WORLD_LAYERS = 2 of 16 layers, two
             ranks on one card over gloo, in the world 9r's, 9rm's and
             9p's plans then run in (card_pair_world): data=2 (each
             place 16 rows with ragged masks in 16 micro batches of one)
             and expert=2 (each rank 4 of the 8 experts, both the same
             32 rows in 16 micro batches of two, the data=2 places'
             micro batches in turn). Per layout: (i) one MoE layer at
             full width in float32 (a global micro batch of 4096
             tokens, the router's columns scaled so capacity 1.25 drops
             choices) through world_train.moe_layer_rank against one
             process on the same inputs: output, gradients, aux and the
             dropped fraction (> 0) within MOE_LAYER_RTOL; (ii)
             MOE_WORLD_STEPS eager steps (an MoE micro body holds gloo
             calls) against one process on the same global micro batches
             (grad_accum 16, world_train.global_batch grouped): losses,
             moe_aux and grad norms within MOE_WORLD_RTOL (limits
             between the sound readings and planted faults: local
             statistics, local capacity, local slots, an identity
             backward on the statistics' all-reduce, no copy on the
             combine weights), both ranks' metrics equal, the flash
             launches, and a rank's kept parameters and gradients
             exactly its share (expert=2: half of every expert leaf, the
             rest whole). Logs per rank the step's seconds, its gloo
             share, the MoE collectives (calls, bytes, seconds) and
             peak memory.
9x. the uncut MoE model (16 layers, which one card does not hold with
             its state) over data=2 x expert=2, one card a rank over
             NCCL, each place 16 rows in 8 micro batches of 2: 3 eager
             steps, then a fresh trainer precompile()d (both bodies
             captured with their routing all-gathers and all-reduces)
             and 3 replayed steps, the last traced. Checks every rank's
             replay bitwise its eager run, every rank's metrics rank
             0's (expert peers equal), the flash launches, and that a
             rank keeps exactly its half of the expert leaves and the
             whole dense part. Logs tokens/s a card, MFU (active top-k
             FLOPs), the NCCL busy share and peak memory. Runs only on
             a machine with four cards or more, and says it was skipped
             otherwise.

9r. context parallelism — llama_1b's widths at max_seq 8192, cut to
             CONTEXT_LAYERS = 8 of its 16 layers (remat dots, adafactor,
             bf16), two ranks on one card over gloo under context=2 (a
             check, no speed-up), in one world: (i) the ring layer alone
             at full width (B=1, S=8192, H=16, KV=8, D=128, causal),
             output and input gradients, against the one-process flash
             call and against the same ring through the kernels' plain
             versions on the card, with the layer's flash launches (rank
             0 one call a kernel, rank 1 two: the block before its own
             and its own); (ii) 4 rows of 8192 + 1 tokens (ragged masks)
             a step in 4 micro batches, CONTEXT_STEPS eager steps with
             attn_impl ring, then ulysses, each rank staging its chunk of
             every row; after the world exits one process with
             attn_impl flash on the same rows: losses and grad norms
             within CONTEXT_RTOL (limits between the sound reading and
             planted faults), both ranks' metrics equal, the flash
             launches against the reckoned count (per layer and micro
             batch rank c makes c + 1 ring calls, its forward twice under
             remat dots), the ring_shift and all_to_all calls, bytes and
             seconds, and peak memory a rank against the one process.
9r4. llama_1b uncut (16 layers) at max_seq 16384 over data=2 x context=2,
             one card a rank over NCCL, attn_impl ring: 3 eager steps,
             then a fresh trainer precompile()d (both bodies captured
             with the ring's NCCL sends and receives) and 3 replayed
             steps, the last traced. Checks every rank's replay bitwise
             its eager run and rank 0's metrics, the flash launches; logs
             tokens/s a card, MFU (flops_per_token(16384)) and the NCCL
             busy share. Runs only on a machine with four cards or more,
             and says it was skipped otherwise.

9rm. an MoE model under context parallelism — llama_moe_8x(llama_1b())
             (8 experts, top-2, capacity 1.25, remat dots, adafactor,
             bf16 compute) at max_seq 8192, cut to MOE_CONTEXT_LAYERS = 2
             of its 16 layers, its router's columns scaled 1 to 2.75 so
             capacity binds (9m (i)'s imbalance), two ranks on one card
             over gloo under context=2 in 9r's world: (i) one MoE layer at
             full width in float32 on one micro batch (2 rows of 8192,
             each rank its chunk of both: the layer's statistics,
             capacity and slots over the tokens group, a rank's pairs
             between the other's row by row) against one process:
             output, gradients, aux and the dropped fraction (> 0) within
             MOE_CONTEXT_LAYER_RTOL; (ii) 4 rows of 8192 + 1 tokens
             (ragged masks) a step in 2 micro batches, MOE_CONTEXT_STEPS
             eager steps with attn_impl ring, then ulysses; after the
             world exits one process with attn_impl flash on the same
             rows: losses, moe_aux and grad norms within MOE_CONTEXT_RTOL
             (limits between the sound reading and planted slot faults),
             both ranks' metrics equal, the flash launches against the
             reckoned count (9r's), the MoE and context collectives'
             calls, bytes and seconds, and peak memory a rank against
             the one process.
9rx4. the uncut MoE model (16 layers) at max_seq 8192 over expert=2 x
             context=2, one card a rank over NCCL, attn_impl ring, 9rm's
             router skew, rows and micro batches: 3 eager steps, then a
             fresh trainer precompile()d (both bodies captured with the
             ring's sends and receives and the MoE layers' all-gathers
             and all-reduces) and 3 replayed steps, the last traced.
             Checks every rank's replay bitwise its eager run and rank
             0's metrics (expert and context peers equal), the flash
             launches and a rank's half of the expert leaves; logs
             tokens/s a card, MFU (active top-k FLOPs) and the NCCL busy
             share. Runs only on a machine with four cards or more, and
             says it was skipped otherwise.
9p. pipeline parallelism — llama_1b's widths in phase 7's configuration
             (remat dots, adafactor, bf16 compute) with attn_impl flash,
             cut to PIPELINE_LAYERS = 8 of its 16 layers, two ranks on one
             card over gloo under pipeline=2 (a check, no speed-up; one
             world of two ranks runs 9m's, 9r's and 9rm's plans, then
             9p's), 4 layers a
             stage: 8 rows of 2048 + 1 tokens (ragged masks) a
             step as one trainer micro batch of 4 pipeline micro batches
             (GPipe fill-drain, parallel/pipeline.py: the activations
             passed round the ring, the last stage's outputs broadcast),
             PIPELINE_STEPS eager steps; after the world exits one
             process with the plain forward (flash) on the same rows:
             losses (before and after the first update reaches them)
             and grad norms within PIPELINE_RTOL (limits between the
             sound readings and planted faults), both ranks' metrics
             equal, the flash launches against the reckoned count (per
             layer of the stage and pipeline micro batch two forward
             under remat dots, one dQ, one dK/dV), that a rank keeps its
             stage and the whole rest of the parameters, and logs per
             rank the step's seconds, the pipeline collectives (calls,
             bytes, seconds), the bubble share (S - 1) / (M + S - 1)
             beside the traced last step's idle share, and peak memory
             against the one process.

Phase order: 1, 2, 3, 3q, 3t, 3s, 4, 4q, 4qq, 4g, 4tp, 5s, 5d, 5m, 5n,
5x, 5, 6, 7, 7m, 8, 9 (a, b, c, d), then one world of two ranks for
9t, 9m, 9r, 9rm and 9p, whose readings follow in that order with 9x
after 9m, then 9r4 and 9rx4.

Prints the kernel JSON line (the fused-dequant kernel's entry carries
its numbers per pool dtype under "by_kv_dtype"; every row its launches
per phase under "launches_by_phase"), the nvidia-smi line,
and last
``{"ok": true, "device": {...}}``. Exits nonzero (printing no result)
without a CUDA device or outside the repository.
"""

from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
# parity limits against the plain version on the same inputs. f32: the
# two sum ~1000-term dot products in another order (the kernel also
# merges its splits' partials). bf16: both finish in f32 and round once
# to bf16, so an element may differ by one bf16 ulp of the plain
# version's value and no more
F32_TOL = 2e-5
BF16_ULPS = 1.0
# GPU cycles of the spin that holds a timed call's start event back until
# the host has enqueued the call (~0.1 ms at the H100's 1.98 GHz)
SPIN_CYCLES = 200_000
KV_LEN = [0, 1, 65, 1000, 513, 129, 37, 300]   # idle, fresh, crossing, long
SHAPE = dict(B=8, H=32, KVH=8, D=128, bs=64, max_blocks=16)
# flash parity limits. f32: both sides sum up to S = 2048 products in
# float32 in another order (blockwise online softmax against one dense
# softmax), ~1e-6 relative on values of magnitude up to ~10; 1e-4 leaves
# that a 10x margin. bf16 (forward, dQ, dK/dV): tools/flash_parity.py's
# limits (a) and (b); the shapes are its SHAPES
FLASH_F32_TOL = 1e-4
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
# training phase (bench.py:74-94 on the card)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 32, 2048, 16
TRAIN_STEPS = 3                # one warm-up step, two timed
# kernel path against attn_impl="xla" on one micro batch at full width:
# both run the model in bf16 and differ only in where attention rounds
# (the kernels round P, and the backward dS, to bf16 for their
# tensor-core products and O and the gradients once; the einsum path
# keeps P in float32 and rounds q.k^T and P.V in its own order), over 16
# layers. Measured agreement with the forward in float32 FMAs (P float32):
# loss up to 2.2e-5 relative, worst cosine 0.99974 (1 - cos = 2.6e-4),
# norms up to 1.8e-4 share, with the backward in float32 FMAs and with
# it on the tensor cores alike (there loss 1.3e-5, 1 - cos 2.6e-4, norms
# 1.1e-4 share); with the forward on the tensor cores too (P bf16): loss
# 1.3e-5, worst cosine 0.99961 (1 - cos = 3.9e-4), norms 3.1e-5 share.
# Planted faults read: dK/dV summing one of the G heads, cosine 0.505 and
# norms 0.27 share; dQ skipping KV block 0 for the last query block,
# cosine 0.99932 (1 - cos = 6.8e-4). Loss sees only forward faults; the
# cosine limit (1 - cos = 5e-4) sits between the sound readings (up to
# 3.9e-4) and 6.8e-4 (see PERF.md)
TRAIN_LOSS_RTOL = 1e-3
TRAIN_COS_MIN = 0.9995
TRAIN_NORM_SHARE = 5e-3
# greedy tokens of the bf16 engine must be within this many logits of the
# teacher-forced maximum: bf16 rounds activations to 8 mantissa bits, and
# the decode path (paged kernel, incremental KV) and the full forward
# (dense einsum attention) round at different places over 32 layers
TIE_TOL = 0.25
STEP_CONTEXT = 300              # tokens per slot in the timed decode step
# the quantized kernel's pool dtypes and their symmetric clip points. A
# copy of serving.quant.KV_QMAX on purpose: the parity phase makes its
# input pools with its own quantizer (quantize_pool), independent of the
# port's write path that it does not test
KV_QMAX = {"int8": 127.0, "fp8_e4m3": 448.0}
# the JAX package's quantized-serving quality gate: its budgets
# (bench.py:1057-1058), its method (_quant_teacher_forced, KV block 16;
# tools/quant_quality.teacher_forced) and its own configuration
# (llama_tiny in f32, weights from seed 3, four prompts of 8 tokens, 24
# generated, the gather path). At full width the same method runs
# through the kernel path on two prompts; there the agreement budget is
# not held (see PERF.md: random weights put the top two of 128,256
# unit-variance logits ~0.2 apart, so greedy agreement there measures
# near-ties; the run prints bf16 against f32 compute beside it). What is
# held there: the drift budget, and the rms logit error per KV dtype.
# Sound readings 0.0664 (int8) and 0.1064 (fp8); planted faults read
# (tools/quant_quality.py on copies with one fault each): weights
# truncated instead of rounded 0.0934 / 0.1224 (drift 0.48 / 0.66, under
# the budget), the kernel reading the previous block's scales 0.1994 /
# 0.2125, resident rows not requantized on scale growth 0.3546 / 0.3614.
# Each limit sits midway between the sound reading and the nearest fault
QUALITY_AGREEMENT_MIN = 0.85
QUALITY_DRIFT_MAX = 1.0
QUALITY_RMS_MAX = {"int8": 0.080, "fp8_e4m3": 0.114}
GATE_TINY = dict(n_prompts=4, prompt_len=8, gen=24, kernel="gather")
GATE_FULL = dict(n_prompts=2, prompt_len=16, gen=32, kernel="auto")
# tensor-parallel ranks of phases 3s and 4tp (llama3_8b: 8 KV heads, 2 a
# rank). Phase 4tp's rms logit error limit against the one-card engine,
# per weight type, read with tools/tp_quality.py (the same check) on one
# card, 4 ranks over gloo: sound 0.02212 (bf16) and 0.02784 (int8 KV +
# int8 W); planted faults: layer 1's two all-reduces skipped 1.0636,
# each rank's queries paired with its other KV head 1.4181 (bf16), the
# row-parallel int8 scales from each rank's own amax 0.04793 (int8).
# Each limit is the geometric mean of the sound reading and the nearest
# fault: the same ratio of headroom on both sides (see PERF.md)
TP = 4
TP_RMS_MAX = {"bf16": 0.153, "int8": 0.0365}
# phase 4tp: greedy tokens a request (phase 4's 32 until phase 9r needed
# the room: all ranks on one card over gloo take ~0.5 s a decode step),
# and the decode dispatches the served step is timed over (the mesh's
# and the one-card model's alike; 2 until phases 5dt and 5e needed the
# room)
TP_TOKENS = 16
TP_STEP_CHUNKS = 1
# phase 5s: draft tokens a verify (the verify width is SPEC_K + 1 = 4),
# greedy tokens a request at full width, and under tensor=4 (fewer there:
# gloo on one card takes ~0.5 s a decode step; 24 until phases 5dt and 5e
# needed the room)
SPEC_K = 3
SPEC_TOKENS = 64
SPEC_TP_TOKENS = 12
# phase 5s (b): rms of the verify step's logit error against sequential
# decode over the same tokens, over the decode logits' rms, per weight
# type. Verify and decode are different programs (dense attention over
# the gathered view and [B*4, .] products against the paged kernel and
# [B, .] products), so bf16 rounds differently in each. Read on one H100
# (verify_vs_decode, 128 positions): sound 0.01586 (bf16) and 0.01812
# (int8 KV + int8 W); planted fault, the query offset one too far (each
# row sees the next row's KV): 0.09631 / 0.08501. Each limit is the
# geometric mean of the two (see PERF.md)
SPEC_RMS_MAX = {"bf16": 0.0391, "int8": 0.0393}
# phase 5d: greedy tokens of each migrated request (32 until phases 5dt
# and 5e needed the room; its checks are exact)
DISAGG_TOKENS = 16
# phases 5d and 5dt serve llama3_8b's widths at DISAGG_LAYERS of its 32
# layers, drawn from seed 0 at that depth (all 32 until phase 5dt needed
# the room; 5d's checks are exact at any depth, PERF.md §4)
DISAGG_LAYERS = 8
# phase 5dt: disaggregated tiers on a mesh: llama3_8b under
# tensor=DISAGG_TP (5d's seeded weights, each rank drawing its shard; two
# ranks on one card over gloo, or a card a rank over NCCL) as the
# prefill tier into 5d's one-card decode tier and as the decode tier of
# 5d's one-card prefill tier, DISAGG_TP_TOKENS greedy tokens a request.
# DISAGG_TP_PAYLOAD_MAX bounds the rms of the mesh's payload (K and V
# over the prompt's rows, dequantized) minus the one-card payload for
# the same prompt, over the one-card payload's rms, per KV dtype; each
# run also reads the planted fault (the ranks' head slices joined in
# reverse order), which must read above it. Read on one H100 (700 W),
# two ranks over gloo, the largest of the three prompts: sound 0.01627
# (bf16: the layers past the first add the ranks' partial sums in
# bf16) and 0.02189 (int8); the fault 1.41274 (unrelated heads: ~√2).
# Each limit is the geometric mean of the two (see PERF.md)
DISAGG_TP = 2
DISAGG_TP_TOKENS = 8
DISAGG_TP_PAYLOAD_MAX = {"bf16": 0.152, "int8": 0.176}
# phase 4g: greedy tokens a stream in (a)/(d); dispatches timed per
# engine in (c), and the budget of (c)'s eight streams (enough that none
# finishes inside the warm-up, timed and profiled dispatches)
GRAPH_TOKENS = 32
# phase 4g runs on the first GRAPH_LAYERS of phase 4's 32 layers (all 32
# until phases 5dt and 5e needed the room; its checks are bitwise, eager
# against replay, and exact launch counts, at any depth, PERF.md §4)
GRAPH_LAYERS = 8
# (c)'s and phase 5m (e)'s timed dispatches (4 until phases 5dt and 5e
# needed the room)
GRAPH_DISPATCHES = 2
GRAPH_FILL_TOKENS = 8 * (GRAPH_DISPATCHES + 6)
# phase 5m (c): rms of the MoE serving path's logit error against the
# full forward's with the serving path's routing (tools/moe_quality.
# readings), over the forward logits' rms. Both run the 16-layer Mixtral
# cut in bf16 and round in different places (paged kernel and [1, .]
# products against dense attention and the einsum dispatch). Read with
# tools/moe_quality.py on one H100: sound 0.01391 (float32 at 2 layers:
# 4.2e-6); planted fault, the dropless path's gates not renormalised:
# 0.4958. The limit is their geometric mean (see PERF.md). Free routing
# is printed beside it and not held: a near tie at the k-th expert sends
# a token elsewhere on one side, and with random weights that reads
# 0.06-0.16 from the sound code
MOE_RMS_MAX = 0.083
MOE_RMS_FAULT = 0.4958
# phase 8 (a): the training pod's steps (the reference's configuration),
# the victim's pacing (seconds slept after each step, so the kill lands
# between checkpoints), and each pod run's time limit
POD_STEPS = 6
POD_STEP_SLEEP_S = 0.5
POD_TIMEOUT_S = 300
# phase 7m: train_profile's MoE llama_1b (8 experts) cut to this many of
# its 16 layers (8 until phase 9p, 4 until phases 5dt and 5e needed the
# room; the check is bitwise, replayed against eager, at any depth)
MOE_TRAIN_LAYERS = 2
# phase 8 (b): llama_1b cut to this many of its 16 layers (16 until
# phase 9r, 8 until phases 5dt and 5e needed the room; the resume is
# bitwise at any depth, PERF.md §4)
RESUME_LAYERS = 2
# phase 9: two training processes, each with half the global batch in
# phase 7's micro batches (so WORLD_ACCUM a rank, TRAIN_ACCUM in all).
# Phase 9 (b)'s limits on the largest relative difference of the world's
# losses and grad norms (3 steps, every rank) from the one-process
# trainer on the concatenated batches. Both sides run the same micro
# batches through the same kernels; they differ in the order of the f32
# sums (per rank, then across ranks; under fsdp the norm's squares per
# part). Read on one H100, two ranks over gloo: sound 8.74e-8 (loss, one
# f32 ulp of 10.9) and 2.56e-6 (grad norm, fsdp); planted faults (data):
# rank 1's gradients dropped 6.73e-6 / 0.360, micro batches averaged
# without token weights 1.84e-4 / 0.0844. Each limit is the geometric
# mean of the sound reading and the nearest fault (see PERF.md). At
# WORLD_LAYERS = 4 (phases 9b, 9t): sound 8.74e-8 / 9.34e-8, the faults
# 5.33e-6 / 0.361 and 1.88e-4 / 0.0908, so both limits still lie
# between them
WORLD = 2
WORLD_ACCUM = TRAIN_ACCUM // WORLD
# phases 9b and 9t run llama_1b cut to this many of its 16 layers: their
# gloo-bound steps (fsdp=2's gathers, 93.7 s; tensor=2's all-reduces, 9t
# 75.8 s) took a sixth of the smoke at 16 layers (F14c, PERF.md); phases
# 9m and 5n needed the room under the 1,200 s limit (8 layers, F15), and
# phase 9r and the context pod of 9a (4 layers: 9b's fsdp=2 steps took
# 16.9 and 18.5 s at 8 layers, 9t's 15.7 and 10.2 s, F15)
WORLD_LAYERS = 4
WORLD_LOSS_RTOL = 7.7e-7
WORLD_NORM_RTOL = 4.6e-4
# phase 9 (b): after a rank's steps, the device memory the run added
# (allocated after the steps less allocated before its trainer was made)
# may exceed what Trainer.state_bytes counts by at most this much:
# buffers the libraries keep, not the trainer. Read on one H100, two
# ranks over gloo: 64 MiB after a process's first eager run and 128 MiB
# after its first capture (a cuBLAS workspace for each new stream that
# ran a GEMM, it seems), 0-64 MiB after later runs. The smallest buffer
# of the step that must not stay, a parameter part under fsdp=2, is
# 1.64 GB.
WORLD_UNCOUNTED_MAX = 256 << 20
# phase 9 (b): fsdp=2 is ZeRO-3, so a rank keeps half the parameters and
# gradients of a data=2 rank: the batch and the outputs, whole on both,
# and adafactor's whole factored moments put the share a little above
# 0.50 (0.5001 reckoned for llama_1b). Its micro bodies gather and
# reduce-scatter every layer over gloo, eagerly (~54 s a step on one
# H100, PERF.md), so its one run ("replayed": precompile, which captures
# nothing under gloo, then steps) takes WORLD_FSDP_STEPS steps of the
# reference's TRAIN_STEPS: two, so that the second holds the optimizer's
# update on the parts to the reference
WORLD_STATE_SHARE_MAX = 0.51
WORLD_FSDP_STEPS = 2
# phase 9 (c): llama3_8b under fsdp=4, one card a rank over NCCL; a rank
# ZERO3_ACCUM micro batches of ZERO3_ROWS rows a step (the collectives of
# a micro batch move ~69 GB a rank whatever its rows, PERF.md)
ZERO3_WORLD = 4
ZERO3_ROWS, ZERO3_ACCUM, ZERO3_STEPS = 2, 2, 3
# phase 9 (t): llama_1b under tensor=2, two ranks on one card over gloo,
# each feeding the same 32 rows (the rows of phase 9b's two places, so
# phase 9b's one-process reference serves) in TRAIN_ACCUM micro batches,
# TENSOR_STEPS of the reference's TRAIN_STEPS steps (every block's
# products all-reduced over gloo, eagerly). Limits on the largest
# relative difference of the losses and grad norms from the reference:
# the row-parallel products' partial sums are rounded to bf16 and added
# across the ranks in bf16, where one GEMM accumulates in f32 and rounds
# once. Read on one H100 (700 W): sound 6.30e-6 (loss) and 1.06e-4 (grad
# norm) over 2 steps; planted faults, one step each: the logits'
# vocab halves gathered in the wrong order 1.53e-4 / 8.3e-5, the
# embedding's mask dropped 9.61e-4 / 0.188, the row-parallel
# all-reduce dropped 5.69e-4 / NaN, a tensor peer's tokens counted
# twice (the sums reduced over the world) 3.8e-6 / 0.500 and `tokens`
# doubled, the copy's backward all-reduce dropped 3.8e-6 / 0.669 with
# the ranks' metrics unequal. Each limit is the geometric mean of the
# sound reading and the nearest fault it sees (see PERF.md). At
# WORLD_LAYERS = 4: sound 8.22e-6 / 1.99e-5, the vocab halves swapped
# 7.60e-4 / 5.17e-4, the embedding's mask dropped 6.56e-4 / 0.197: both
# limits still between the sound reading and the nearest fault
TENSOR_WORLD = 2
TENSOR_STEPS = 2
TENSOR_LOSS_RTOL = 3.1e-5
TENSOR_NORM_RTOL = 4.5e-3
# phase 9 (d): llama3_8b under fsdp=2 x tensor=2, one card a rank over
# NCCL; each of the two places in the batch axes TENSOR3_ACCUM micro
# batches of ZERO3_ROWS rows a step: phase 9c's global batch of 16 rows
TENSOR3_FSDP = TENSOR3_TENSOR = 2
TENSOR3_ACCUM = 4
# phase 5n: phase 5m's Mixtral cut served under KFT_MESH=tensor=MOE_TP
# (each rank the mlp slice of every expert; two ranks on one card over
# gloo, or a card a rank over NCCL), and its rms logit error against
# phase 5m's one-card engine on the same teacher-forced streams
# (tools/moe_quality.tp_readings). Read with tools/moe_quality.py
# --tensor 2 on one H100 (700 W), two ranks over gloo: sound 0.1309
# (bf16 partial sums added across the ranks, and with random weights a
# near tie at the k-th expert routes a token elsewhere: greedy agreement
# 0.879); planted fault, the MoE output's all-reduce dropped, 0.6175.
# The limit is their geometric mean (see PERF.md)
MOE_TP = 2
MOE_TP_RMS_MAX = 0.284
# phase 5x: Mixtral-8x7B at all 32 layers under tensor=MOE_TP_FULL, one
# card a rank over NCCL (four cards or more), then under
# expert=MOE_EP,tensor=MOE_EP_TP
MOE_TP_FULL = 4
# phase 5e: phase 5m's Mixtral cut served under KFT_MESH=expert=MOE_EP,
# tensor=MOE_EP_TP (each rank MOE_EP's share of the experts and its mlp
# slice of each, the router whole; four ranks on one card over gloo, or a
# card a rank over NCCL), its rms logit error against phase 5m's
# one-card engine on the same teacher-forced streams
# (tools/moe_quality.tp_readings) under MOE_EP_RMS_MAX, set between the
# sound reading and a planted fault (the MoE output summed over tensor
# only): tools/moe_quality.py --expert 2 --tensor 2. Read on one H100
# (700 W), four ranks over gloo: sound 0.1407 (bf16 partial sums over
# the ranks, near ties at the k-th expert: greedy agreement 0.803); the
# fault 0.6185. The limit is their geometric mean (see PERF.md)
MOE_EP = 2
MOE_EP_TP = 2
MOE_EP_RMS_MAX = 0.295
# phase 9m: llama_moe_8x(llama_1b()) at full width cut to
# MOE_WORLD_LAYERS of its 16 layers (two ranks and their state on one
# card; 4 layers until phase 9r needed the room, PERF.md §4), phase 7's
# configuration, over two processes on one card (gloo): data=2 (each place 16 rows in 16 micro batches of one) and
# expert=2 (each rank 4 of the 8 experts, both the same 32 rows in 16
# micro batches of two, micro batch by micro batch as data=2's), each
# MOE_WORLD_STEPS steps, against one process on the same global micro
# batches. Limits on the largest relative difference of the world's
# losses, moe_aux and grad norms from it (MOE_WORLD_RTOL), and on the MoE
# layer at full width in float32 (MOE_LAYER_RTOL: its output and
# gradients, relative to the reference's largest magnitude; the aux
# losses relative; the dropped fraction absolute). Read on one H100 (700
# W), two ranks over gloo, the larger of data=2 and expert=2: sound,
# the layer 1.12e-6 (output), 2.31e-6 (gradients), 0.0 (aux), 0.0
# (dropped); the steps 1.10e-5 (loss), 4.19e-5 (moe_aux), 1.18e-4 (grad
# norm). Planted faults, each the nearest one a reading sees: the
# statistics' sums local 0.0105 (layer aux) and 0.0212 (dropped), the
# slots local 0.488 / 0.460 (layer output / gradients) and 1.52e-4 /
# 2.72e-3 (loss / moe_aux), the statistics' all-reduce backward an
# identity 2.37e-3 (grad norm; the layer's gradients are the output's
# almost alone there), no copy on the combine weights 0.792 (layer
# gradients) and 0.0669 (grad norm, with the peers' metrics unequal).
# Each limit is the geometric mean of the sound reading (a float32 ulp,
# 1.2e-7, or one choice of 8192, 1.22e-4, where it read 0.0) and the
# nearest fault (see PERF.md); those readings were at 4 layers. At
# MOE_WORLD_LAYERS = 2 the steps read 2.65e-5 (loss), 1.12e-5 (moe_aux)
# and 7.79e-5 (grad norm) sound, and the slots local 3.26e-4 / 5.21e-4
# (loss / moe_aux), the statistics' backward an identity 5.47e-4 (grad
# norm): the moe_aux and grad norm limits are those readings' geometric
# means, the loss limit stays (theirs, 9.3e-5, would loosen it)
MOE_WORLD_LAYERS = 2
MOE_WORLD_STEPS = 2
MOE_WORLD_RTOL = {"loss": 4.1e-5, "moe_aux": 7.6e-5, "grad_norm": 2.1e-4}
MOE_LAYER_SEED = 11
MOE_LAYER_RTOL = {"y": 7.4e-4, "grads": 1.0e-3, "aux": 3.5e-5,
                  "dropped": 1.6e-3}
# phase 9x: the uncut model (16 layers) over data=2 x expert=2, one card
# a rank over NCCL (four cards or more): MOE_NCCL_STEPS eager steps,
# then as many replayed
MOE_NCCL_STEPS = 3
# phase 5m (d): the JAX package's reason for keeping MoE weights unquantized
# (kubeflow_tpu/serving/quant.py:96-101)
MOE_INT8_REASON = ("MoE expert weights keep full precision (the routed "
                   "expert einsums are not int8-lowered)")
# phase 9r: llama_1b's widths at max_seq CONTEXT_SEQ, cut to
# CONTEXT_LAYERS of its 16 layers, over context=CONTEXT (two ranks on one
# card over gloo: a check, no speed-up): CONTEXT_ROWS rows of CONTEXT_SEQ + 1
# tokens a step in CONTEXT_ACCUM micro batches, CONTEXT_STEPS eager steps
# with attn_impl "ring", then "ulysses", against one process with
# attn_impl "flash" on the same rows. CONTEXT_RTOL: limits on the largest
# relative difference of the world's losses and grad norms from it;
# CONTEXT_LAYER_ERR: on the ring layer at full width (B=1, S=CONTEXT_SEQ,
# H=16, KV=8, D=128, causal, bf16), its output and input gradients'
# largest relative error over windows of CONTEXT_WINDOW positions
# (windowed_error: late rows, whose values are ~0.03 where the early ones
# are ~4, are held to their own size), against the one-process flash call
# ("flash", Ulysses too) and against the same ring through the kernels'
# plain versions on the card ("plain"). Read on one H100 (700 W), two
# ranks over gloo: sound, the steps 8.13e-6 / 1.16e-4 (ring: each ring
# step rounds its output to bf16 before the float32 merge) and 8.74e-8 /
# 5.13e-6 (Ulysses: a rank's heads see the whole sequence, the one
# process's attention arithmetic), the layer 3.04e-3 (flash; Ulysses
# 0.0) and 3.17e-3 (plain). Planted faults, each in a tree copy: local
# RoPE positions 5.10e-4 / 6.08e-3 (Ulysses 5.10e-4 / 6.05e-3), no
# context in the gradient sum 8.1e-6 / 0.454 with the ranks' metrics
# unequal, dK/dV left on the neighbour 8.1e-6 / 0.0711 (layer 13.4),
# causal on every block 8.12e-4 / 5.93e-3 (layer 6.67), the kernels'
# diagonal forward unmasked 5.84e-5 / 0.217; on the layer alone, the
# merge's weights swapped 8.25, the block before the diagonal skipped
# 12.9, the backward given the last block's lse for the merged one 0.982
# (flash; the nearest), the forward kernel's causal mask one key late
# 0.367 against the plain ring (the nearest it sees; the flash call
# shares the kernel). Each limit is the geometric mean of the sound
# reading and the nearest fault it sees (see PERF.md)
CONTEXT = 2
CONTEXT_SEQ, CONTEXT_LAYERS = 8192, 8
CONTEXT_ROWS, CONTEXT_ACCUM, CONTEXT_STEPS = 4, 4, 2
CONTEXT_LAYER = dict(B=1, H=16, KVH=8, D=128)
CONTEXT_LAYER_SEED = 13
CONTEXT_WINDOW = 256
CONTEXT_RTOL = {"ring": {"loss": 2.2e-5, "grad_norm": 8.3e-4},
                "ulysses": {"loss": 6.7e-6, "grad_norm": 1.8e-4}}
CONTEXT_LAYER_ERR = {"flash": 0.055, "plain": 0.034}
# phase 9r4: llama_1b uncut (16 layers) at max_seq CONTEXT4_SEQ over
# data=2 x context=2, one card a rank over NCCL (four cards or more):
# each place CONTEXT4_ROWS rows in CONTEXT4_ACCUM micro batches,
# CONTEXT4_STEPS eager steps, then as many replayed
CONTEXT4_SEQ = 16384
CONTEXT4_ROWS, CONTEXT4_ACCUM, CONTEXT4_STEPS = 4, 4, 3
# phase 9rm: llama_moe_8x(llama_1b()) (8 experts, top-2, capacity 1.25,
# remat dots, adafactor, bf16 compute) at max_seq MOE_CONTEXT_SEQ, cut to
# MOE_CONTEXT_LAYERS of its 16 layers, over context=CONTEXT in 9r's world
# (two ranks on one card over gloo: a check, no speed-up): MOE_CONTEXT_ROWS
# rows of MOE_CONTEXT_SEQ + 1 tokens (ragged masks) a step in
# MOE_CONTEXT_ACCUM micro batches (two rows each, so a context rank holds
# chunks of several rows of one micro batch; two micro batches, so the one
# process weights its micro batches' losses as the ranks do: unweighted,
# its bf16 backward put its grad norm 1.35e-3 from Ulysses'), every
# router column scaled by MOE_ROUTER_SCALE (phase 9m (i)'s
# imbalance, so capacity 1.25 drops choices), MOE_CONTEXT_STEPS eager
# steps with attn_impl ring, then ulysses, against one process with
# attn_impl flash on the same rows; and the layer alone (i) on one such
# micro batch in float32 against one process. MOE_CONTEXT_RTOL: limits on
# the largest relative difference of the world's losses, moe_aux and grad
# norms from the one process; MOE_CONTEXT_LAYER_RTOL: on the layer's, as
# phase 9m (i) reads them. Read on one H100 (700 W), two ranks over gloo:
# sound, ring 4.44e-5 / 5.92e-5 / 8.40e-4 (loss / moe_aux / grad norm: each
# ring step rounds its output to bf16), Ulysses 1.74e-7 / 1.23e-7 /
# 6.24e-6, the layer 8.14e-8 (output), 5.07e-6 (gradients), aux and
# dropped fraction exact. Planted faults, each in a tree copy: the
# batch-only slot rule (counts gathered over batch, one rank here) ring
# 5.02e-4 / 1.66e-3 / 0.0514, Ulysses 4.65e-4 / 1.68e-3 / 0.0518, the
# layer 0.459 / 0.419, its dropped fraction off by 8.64e-3 (all of it);
# the ranks taken as blocks (each rank's chunk of every row ahead of the
# next rank's) ring 6.12e-5 / 7.12e-4 / 7.03e-4, Ulysses 4.61e-6 /
# 7.59e-4 / 6.59e-4, the layer unmoved (the same pairs drop in either
# order on its inputs). Each limit is the geometric mean of the sound
# reading and the nearest fault it sees (ring loss and grad norm: the
# batch-only rule's; a reading of 0, the layer's dropped fraction,
# counts as one choice of the 2 x 2 x 8192, 3.05e-5); the layer's aux,
# which no slot fault moves, keeps phase 9m (i)'s limit (see PERF.md)
MOE_CONTEXT_SEQ, MOE_CONTEXT_LAYERS = 8192, 2
MOE_CONTEXT_ROWS, MOE_CONTEXT_ACCUM, MOE_CONTEXT_STEPS = 4, 2, 2
MOE_ROUTER_SCALE = tuple(1.0 + 1.75 * i / 7 for i in range(8))
MOE_CONTEXT_RTOL = {"ring": {"loss": 1.5e-4, "moe_aux": 2.1e-4,
                             "grad_norm": 6.6e-3},
                    "ulysses": {"loss": 9.0e-7, "moe_aux": 9.7e-6,
                                "grad_norm": 6.4e-5}}
MOE_CONTEXT_LAYER_RTOL = {"y": 1.9e-4, "grads": 1.5e-3, "aux": 3.5e-5,
                          "dropped": 5.1e-4}
# phase 9rx4: the uncut MoE model (16 layers) at max_seq MOE_CONTEXT_SEQ
# over expert=2 x context=2, one card a rank over NCCL (four cards or
# more), attn_impl ring, 9rm's router skew, rows and micro batches:
# MOE_NCCL_STEPS eager steps, then as many replayed
# phase 9p: llama_1b's widths in phase 7's configuration (bf16 compute,
# remat dots, adafactor) with attn_impl flash, cut to PIPELINE_LAYERS of
# its 16 layers, over pipeline=PIPELINE (two ranks on one card over gloo:
# a check, no speed-up), PIPELINE_LAYERS / PIPELINE layers a stage:
# PIPELINE_ROWS rows of TRAIN_SEQ + 1 tokens (ragged masks) a step in one
# trainer micro batch of PIPELINE_MICRO pipeline micro batches,
# PIPELINE_STEPS eager steps, against one process with the plain forward
# (flash) on the same rows. The schedule warms up from 0, so step 0's
# update is zero and the first loss that reads an update (step 1's) is
# that of step PIPELINE_UPDATED. PIPELINE_RTOL: limits on the largest
# relative difference from it of the world's losses before that step
# ("loss"), from it on ("updated_loss"), and of its grad norms at every
# step (see PERF.md for the sound readings and the planted faults they
# sit between)
PIPELINE = 2
PIPELINE_LAYERS = 8
PIPELINE_ROWS, PIPELINE_MICRO, PIPELINE_STEPS = 8, 4, 3
PIPELINE_UPDATED = 2
PIPELINE_RTOL = {"loss": 1.2e-5, "updated_loss": 4.1e-5,
                 "grad_norm": 2.7e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def probe(torch, cuda_build) -> dict:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {nvidia_smi_line()}")
    ver = subprocess.run([cuda_build.nvcc_path(), "--version"],
                         capture_output=True, text=True, check=True).stdout
    log(f"nvcc: {ver.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    from kubeflow_tpu_torch.ops.flash_attention import KERNELS

    built = cuda_build.build(["paged_decode_attention", *KERNELS],
                             verbose=True)
    for name, info in built.items():
        log(f"build {name}: {info['seconds']:.3f} s (built={info['built']})")
        for fn, rep in ptxas_report(info["log"]).items():
            log(f"  ptxas {kernel_label(fn)}: {rep}")
    log(f"build total {time.perf_counter() - t0:.3f} s")
    tensor_core_check(cuda_build)
    return built


def ptxas_report(text: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output (empty when the library was not rebuilt)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def kernel_label(mangled: str) -> str:
    """The kernel's name and template arguments out of its mangled name
    (flash_dq_kernel_sm90ILi128E: the bf16 body at D = 128)."""
    m = re.search(r"\d((?:flash|paged)_\w+?I\w+?E)Ev", mangled)
    return m.group(1) if m else mangled


def sass_counts(cuda_build, name: str) -> dict:
    """{kernel label: {"HGMMA": n, "STL": n, "LDL": n}}: tensor-core
    products and local-memory stores and loads (spills) in the built
    library of csrc/<name>.cu, disassembled by cuobjdump from the toolkit
    beside nvcc."""
    tool = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(cuda_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return {kernel_label(part.split(None, 1)[0]):
            {op: len(re.findall(rf"\b{op}\b", part))
             for op in ("HGMMA", "STL", "LDL")}
            for part in re.split(r"\n\s*Function : ", sass)[1:]}


def tensor_core_check(cuda_build) -> None:
    """Fail unless the bf16 bodies of the flash kernels (their names end
    in _sm90) are on the tensor cores: HGMMA in their SASS. Prints every
    flash body's SASS counts."""
    from kubeflow_tpu_torch.ops.flash_attention import KERNELS

    for name in KERNELS:
        counts = sass_counts(cuda_build, name)
        log(f"  sass {name}: {counts}")
        bf16 = [c["HGMMA"] for fn, c in counts.items() if "_sm90" in fn]
        if not bf16 or not all(bf16):
            raise SystemExit(f"{name}: the bf16 body's SASS holds no HGMMA "
                             f"({counts}): it is not on the tensor cores")


def split_lengths(pa) -> list:
    """Eight slots' lengths where the kernel's split of a walk turns: 0,
    1, one split's rows - 1, + 0, + 1, a full table row, and two more
    crossings, at the serving shape."""
    rows = pa.split_plan(SHAPE["max_blocks"], SHAPE["bs"]).blocks_per_split \
        * SHAPE["bs"]
    return [0, 1, rows - 1, rows, rows + 1, SHAPE["max_blocks"] * SHAPE["bs"],
            2 * rows - 1, 2 * rows + 1]


def paged_case(torch, dtype, seed=0, kv_lens=None):
    """q, pools, tables, kv_len at the serving decode shape (kv_len
    KV_LEN unless given)."""
    s = SHAPE
    kv_lens = KV_LEN if kv_lens is None else kv_lens
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = s["B"] * s["max_blocks"] + 1
    q = torch.randn((s["B"], s["H"], s["D"]), generator=g, device="cuda")
    kp = torch.randn((nb, s["bs"], s["KVH"], s["D"]), generator=g,
                     device="cuda")
    vp = torch.randn((nb, s["bs"], s["KVH"], s["D"]), generator=g,
                     device="cuda")
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros((s["B"], s["max_blocks"]), dtype=torch.int32,
                         device="cuda")
    i = 0
    for b, n in enumerate(kv_lens):
        live = -(-n // s["bs"])
        tables[b, :live] = perm[i:i + live].to(torch.int32)
        i += live
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    return (q.to(dtype), kp.to(dtype), vp.to(dtype), tables, kv_len)


def bf16_ulp(torch, x):
    """One bf16 ulp at |x| (8 significant bits): 2^(e-8) for
    |x| in [2^(e-1), 2^e)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def parity(torch, pa) -> dict:
    """The kernel against its plain version at KV_LEN and at the split
    lengths; returns the max abs errors per dtype at KV_LEN."""
    errs = {}
    cases = [(dtype, lens) for lens in (KV_LEN, split_lengths(pa))
             for dtype in (torch.bfloat16, torch.float32)]
    for dtype, lens in cases:
        case = paged_case(torch, dtype, kv_lens=lens)
        out = pa.paged_decode_attention(*case)
        torch.cuda.synchronize()
        ref = pa.paged_decode_attention_reference(*case)
        name = str(dtype).split(".")[-1]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        idle = out[0].float().abs().max().item()
        if lens is KV_LEN:
            errs[name] = err
        if dtype == torch.bfloat16:
            ulps = (diff / bf16_ulp(torch, ref)).max().item()
            ok = ulps <= BF16_ULPS
            limit = (f"{ulps!r} bf16 ulps of the plain value, limit "
                     f"{BF16_ULPS}")
        else:
            ok = err <= F32_TOL
            limit = f"limit {F32_TOL}"
        log(f"parity paged_decode_attention {name}, kv_len {lens}: "
            f"max_abs_err {err!r} ({limit}), idle-slot max {idle!r}")
        if not ok or idle != 0.0 or not torch.isfinite(out).all():
            raise SystemExit(f"paged_decode_attention {name} disagrees with "
                             "its plain version")
    return errs


def time_ms(torch, fn, reps=50) -> float:
    """Median per-call time in ms by CUDA events, L2 flushed before each
    call (the decode step finds the KV cold: each layer streams ~0.5 GB
    of weights between two attention calls). A spin on the card after the
    flush holds the start event back until the host has enqueued the
    call, so the interval is the call's device work and not the host
    work of its wrapper (which exceeds the flush's ~0.04 ms for the paged
    kernel's wrapper)."""
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timing(torch, pa) -> dict:
    import torch.nn.functional as F

    s = SHAPE
    case = paged_case(torch, torch.bfloat16, seed=1)
    q, kp, vp, tables, kv_len = case
    kernel_ms = time_ms(torch, lambda: pa.paged_decode_attention(*case))
    plain_ms = time_ms(torch,
                       lambda: pa.paged_decode_attention_reference(*case))
    item = q.element_size()
    # K and V rows below kv_len: a head's row is its own 2*D-byte piece
    # of the [NB, bs, KV_H, D] pool, so no dead-tail row must be read
    kv_bytes = 2 * sum(KV_LEN) * s["KVH"] * s["D"] * item
    io_bytes = (2 * q.numel() * item + tables.numel() * 4
                + kv_len.numel() * 4 + kv_bytes)
    flops = 4 * s["H"] * s["D"] * sum(KV_LEN)      # QK^T and PV, f32 FMAs
    bound_ms = max(io_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    bound_by = ("bytes" if io_bytes / HBM_BYTES_PER_S
                >= flops / F32_FLOPS else "operations")
    # labelled yardstick only (the port never calls it): SDPA over the
    # pre-gathered dense view; no single PyTorch call reads a paged pool
    idx = tables.long()
    g = s["H"] // s["KVH"]
    kd = kp[idx].reshape(s["B"], -1, s["KVH"], s["D"]).transpose(1, 2) \
        .repeat_interleave(g, dim=1).contiguous()
    vd = vp[idx].reshape(s["B"], -1, s["KVH"], s["D"]).transpose(1, 2) \
        .repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    qd = q[:, :, None, :]
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    log(f"timing paged_decode_attention bf16 (B=8 H=32 KV_H=8 D=128 bs=64, "
        f"kv_len {KV_LEN}): kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, "
        f"bound {bound_ms!r} ms ({bound_by}: {io_bytes} B, {flops} FLOP), "
        f"roofline share {bound_ms / kernel_ms!r}")
    log(f"reference only, not a port path: SDPA over the pre-gathered "
        f"dense view {sdpa_ms!r} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def quantize_pool(torch, pool, kv: str):
    """Per-block per-KV-head symmetric quantization of a [NB, bs, KV_H, D]
    pool -> (stored pool, f32 scales [NB, KV_H])."""
    from kubeflow_tpu_torch.serving.quant import kv_store_dtype

    qmax = KV_QMAX[kv]
    p32 = pool.float()
    scale = (p32.abs().amax(dim=(1, 3)) / qmax).clamp(min=1e-30)
    q = p32 / scale[:, None, :, None]
    if kv == "int8":
        q = q.round().clamp(-qmax, qmax)
    return q.to(kv_store_dtype(kv)).contiguous(), scale.contiguous()


def quant_case(torch, dtype, kv: str, seed=0, kv_lens=None):
    """q (in ``dtype``), quantized pools, scales, tables, kv_len at the
    serving decode shape."""
    q, kp, vp, tables, kv_len = paged_case(torch, torch.float32, seed,
                                           kv_lens)
    kq, ks = quantize_pool(torch, kp, kv)
    vq, vs = quantize_pool(torch, vp, kv)
    return q.to(dtype), kq, vq, tables, kv_len, ks, vs


def quant_parity(torch, pa) -> dict:
    """The fused-dequant kernel against its plain version at KV_LEN and at
    the split lengths; returns the max abs errors per pool dtype and q
    dtype at KV_LEN."""
    errs: dict = {}
    for kv, lens in ((kv, lens) for lens in (KV_LEN, split_lengths(pa))
                     for kv in KV_QMAX):
        for dtype in (torch.bfloat16, torch.float32):
            q, kq, vq, tables, kv_len, ks, vs = quant_case(torch, dtype, kv,
                                                           kv_lens=lens)
            out = pa.paged_decode_attention(q, kq, vq, tables, kv_len,
                                            k_scale=ks, v_scale=vs)
            torch.cuda.synchronize()
            ref = pa.paged_decode_attention_reference(
                q, kq, vq, tables, kv_len, k_scale=ks, v_scale=vs)
            name = str(dtype).split(".")[-1]
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            idle = out[0].float().abs().max().item()
            if lens is KV_LEN:
                errs.setdefault(kv, {})[name] = err
            if dtype == torch.bfloat16:
                ulps = (diff / bf16_ulp(torch, ref)).max().item()
                ok = ulps <= BF16_ULPS
                limit = (f"{ulps!r} bf16 ulps of the plain value, limit "
                         f"{BF16_ULPS}")
            else:
                # over an f32 q the fused dequant is the unquantized
                # kernel's arithmetic on the f32 dequant view, bit for bit
                kd = (kq.float() * ks[:, None, :, None]).contiguous()
                vd = (vq.float() * vs[:, None, :, None]).contiguous()
                row1 = pa.paged_decode_attention(q, kd, vd, tables, kv_len)
                torch.cuda.synchronize()
                bitwise = torch.equal(out, row1)
                ok = err <= F32_TOL and bitwise
                limit = (f"limit {F32_TOL}; bitwise equal to the unquantized "
                         f"kernel over the f32 dequant view: {bitwise}")
            log(f"parity paged_decode_attention_quant {kv} pool, q {name}, "
                f"kv_len {lens}: max_abs_err {err!r} ({limit}), idle-slot "
                f"max {idle!r}")
            if not ok or idle != 0.0 or not torch.isfinite(out).all():
                raise SystemExit(f"paged_decode_attention_quant {kv} {name} "
                                 "disagrees with its plain version")
    return errs


def quant_timing(torch, pa) -> dict:
    """CUDA-event medians of the fused-dequant kernel and its plain version
    per pool dtype (q bf16), beside its bound; SDPA over the pre-
    dequantized dense bf16 view as a yardstick only."""
    import torch.nn.functional as F

    s = SHAPE
    out = {}
    for kv in KV_QMAX:
        q, kq, vq, tables, kv_len, ks, vs = quant_case(torch, torch.bfloat16,
                                                       kv, seed=1)
        args = (q, kq, vq, tables, kv_len)
        kernel_ms = time_ms(torch, lambda: pa.paged_decode_attention(
            *args, k_scale=ks, v_scale=vs))
        plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_reference(
            *args, k_scale=ks, v_scale=vs))
        item = q.element_size()
        live_blocks = sum(-(-n // s["bs"]) for n in KV_LEN)
        # K and V rows below kv_len at one byte an element, the two scale
        # words of each live block and KV head, q, out, tables, kv_len
        kv_bytes = 2 * sum(KV_LEN) * s["KVH"] * s["D"] * kq.element_size()
        scale_bytes = 2 * live_blocks * s["KVH"] * 4
        io_bytes = (2 * q.numel() * item + tables.numel() * 4
                    + kv_len.numel() * 4 + kv_bytes + scale_bytes)
        # QK^T and PV FMAs plus one dequant multiply per K/V element, f32
        flops = (4 * s["H"] * s["D"] * sum(KV_LEN)
                 + 2 * s["KVH"] * s["D"] * sum(KV_LEN))
        t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        idx = tables.long()
        g = s["H"] // s["KVH"]

        def dense(pool, scale):
            d = (pool.float() * scale[:, None, :, None]).to(torch.bfloat16)
            return d[idx].reshape(s["B"], -1, s["KVH"], s["D"]) \
                .transpose(1, 2).repeat_interleave(g, dim=1).contiguous()

        kd, vd = dense(kq, ks), dense(vq, vs)
        mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
                < kv_len[:, None])[:, None, None, :]
        qd = q[:, :, None, :]
        sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        log(f"timing paged_decode_attention_quant {kv} pool, q bf16 (B=8 "
            f"H=32 KV_H=8 D=128 bs=64, kv_len {KV_LEN}): kernel "
            f"{kernel_ms!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
            f"({bound_by}: {io_bytes} B, {flops} FLOP), roofline share "
            f"{bound_ms / kernel_ms!r}")
        log(f"reference only, not a port path: SDPA over the pre-"
            f"dequantized dense bf16 view {sdpa_ms!r} ms")
        out[kv] = {"ms": kernel_ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": io_bytes, "sdpa_dense_view_ms": sdpa_ms}
        del kd, vd, args
    torch.cuda.empty_cache()
    return out


def sharded_kernel(torch, pa) -> dict:
    """Phase 3s: row 3 (the sharded call) against the unsharded launch,
    bitwise, then one rank's launch timed."""
    import torch.nn.functional as F

    from kubeflow_tpu_torch.parallel import TensorMesh

    s = SHAPE
    mesh = TensorMesh(TP, ["cuda:0"] * TP)    # a description: no processes
    cases = [(str(dt).split(".")[-1], "none", paged_case(torch, dt), {})
             for dt in (torch.bfloat16, torch.float32)]
    for kv in KV_QMAX:
        for dt in (torch.bfloat16, torch.float32):
            q, kq, vq, tables, kv_len, ks, vs = quant_case(torch, dt, kv)
            cases.append((str(dt).split(".")[-1], kv,
                          (q, kq, vq, tables, kv_len),
                          {"k_scale": ks, "v_scale": vs}))
    for name, kv, case, sc in cases:
        whole = pa.paged_decode_attention(*case, **sc)
        parts = pa.paged_decode_attention_sharded(*case, mesh=mesh, **sc)
        torch.cuda.synchronize()
        same = torch.equal(whole, parts)
        log(f"parity paged_decode_attention_sharded tensor={TP}, {kv} pool, "
            f"q {name}: bitwise equal to the unsharded launch: {same} "
            f"(max abs diff {(whole.float() - parts.float()).abs().max().item()!r})")
        if not same:
            raise SystemExit("the sharded paged attention differs from the "
                             "unsharded launch")
    # one rank's launch: rank 0's contiguous slice, as a rank holds it
    qh, kh = s["H"] // TP, s["KVH"] // TP
    q, kp, vp, tables, kv_len = paged_case(torch, torch.bfloat16, seed=1)
    q0 = q[:, :qh].contiguous()
    k0, v0 = kp[:, :, :kh].contiguous(), vp[:, :, :kh].contiguous()
    out = pa.paged_decode_attention_shard(q0, k0, v0, tables, kv_len,
                                          mesh=mesh, n_kv_heads=s["KVH"])
    ref = pa.paged_decode_attention_reference(q0, k0, v0, tables, kv_len)
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    ulps = (diff / bf16_ulp(torch, ref)).max().item()
    if ulps > BF16_ULPS or not torch.isfinite(out).all():
        raise SystemExit("one rank's paged attention disagrees with its "
                         "plain version")
    kernel_ms = time_ms(torch, lambda: pa.paged_decode_attention_shard(
        q0, k0, v0, tables, kv_len, mesh=mesh, n_kv_heads=s["KVH"]))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_attention_reference(
        q0, k0, v0, tables, kv_len))
    item = q0.element_size()
    kv_bytes = 2 * sum(KV_LEN) * kh * s["D"] * item
    io_bytes = (2 * q0.numel() * item + tables.numel() * 4
                + kv_len.numel() * 4 + kv_bytes)
    flops = 4 * qh * s["D"] * sum(KV_LEN)
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    idx = tables.long()
    g = qh // kh

    def dense(pool):
        return pool[idx].reshape(s["B"], -1, kh, s["D"]).transpose(1, 2) \
            .repeat_interleave(g, dim=1).contiguous()

    kd, vd = dense(k0), dense(v0)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q0[:, :, None, :], kd, vd, attn_mask=mask))
    log(f"timing paged_decode_attention_sharded, one rank of tensor={TP} "
        f"(B=8 H={qh} KV_H={kh} D=128 bs=64, kv_len {KV_LEN}, bf16): kernel "
        f"{kernel_ms!r} ms, plain {plain_ms!r} ms, bound {bound_ms!r} ms "
        f"({bound_by}: {io_bytes} B, {flops} FLOP), roofline share "
        f"{bound_ms / kernel_ms!r}; max_abs_err {err!r} ({ulps!r} bf16 ulps "
        f"of the plain value)")
    log(f"reference only, not a port path: SDPA over the rank's "
        f"pre-gathered dense view {sdpa_ms!r} ms")
    del kd, vd
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "sdpa_dense_view_ms": sdpa_ms}


def post_json(url: str, payload: dict, timeout: float = 600.0) -> dict:
    from urllib import request as urlrequest

    req = urlrequest.Request(url, data=json.dumps(payload).encode(),
                             headers={"Content-Type": "application/json"},
                             method="POST")
    with urlrequest.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def decode_step_ms(torch, eng, steps: int = 20) -> float:
    """Host clock per ``paged_decode_step`` on the served engine's params
    and pool with every slot live at STEP_CONTEXT tokens, ending in a
    synchronize, after three warm-up steps."""
    from kubeflow_tpu_torch.serving.paged_kv import paged_decode_step

    pk = eng.paged
    for slot in range(pk.max_batch):
        pk.release(slot)
        if pk.reserve(slot, STEP_CONTEXT, 32) is None:
            raise SystemExit("pool too small for the timed decode batch")
    tables = torch.tensor(pk.tables, device=eng.device)
    tok = torch.ones((pk.max_batch,), dtype=torch.int32, device=eng.device)

    def run(n):
        for _ in range(n):
            eng.cache["len"].fill_(STEP_CONTEXT)
            paged_decode_step(eng.params, tok, eng.cfg, eng.cache, tables,
                              kernel=eng.kernel)

    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def llama3_8b(torch, n_layers: int = 32):
    """llama3_8b at its published widths (``n_layers`` of its 32
    layers), random bf16 weights from seed 0 on the card."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"llama3_8b ({n_layers} of 32 layers): {tree_numel(params)} "
        f"params bf16 "
        f"({tree_bytes(params) / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def _tensors(tree):
    if isinstance(tree, dict):
        for val in tree.values():
            yield from _tensors(val)
    else:
        yield tree


def tree_numel(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def pool_bytes(cache) -> int:
    """Payload plus scale tables of a paged pool."""
    return sum(cache[k].numel() * cache[k].element_size()
               for k in ("k", "v", "k_scale", "v_scale") if k in cache)


def four_prompts(torch, cfg) -> dict:
    """Phase 4's four prompts, from seed 1: ~100 and ~300 tokens, one
    longer than the largest prefill bucket, one sharing mid_300's four
    block-aligned 64-token blocks."""
    rng = torch.Generator().manual_seed(1)
    rand = lambda n: torch.randint(1, cfg.vocab_size, (n,),
                                   generator=rng).tolist()
    shared = rand(256)                       # 4 full 64-token blocks
    return {
        "short_100": rand(100),
        "mid_300": shared + rand(44),
        "chunked_700": rand(700),            # > largest bucket (512)
        "prefix_300": shared + rand(52),     # shares mid_300's 4 blocks
    }


def serve_prompts(torch, pa, model, cfg, prompts: dict,
                  max_tokens: int) -> dict:
    """Concurrent greedy V2 requests over HTTP against ``model`` behind a
    fresh ModelServer, ``max_tokens`` each. Every launch count is set to
    0 just before and read just after (on every rank under a mesh)."""
    from kubeflow_tpu_torch.serving import ModelRepository, ModelServer

    repo = ModelRepository()
    repo.register(model)
    srv = ModelServer(repo).start()
    results: dict = {}
    errors: list = []

    def run(tag, prompt):
        try:
            body = {"inputs": [{"name": "ids", "shape": [1, len(prompt)],
                                "datatype": "INT32", "data": prompt}],
                    "parameters": {"max_tokens": max_tokens,
                                   "temperature": 0.0}}
            out = post_json(f"{srv.url}/v2/models/{model.name}/infer", body)
            tensors = {t["name"]: t for t in out["outputs"]}
            results[tag] = tensors["tokens"]["data"][
                :tensors["lengths"]["data"][0]]
        except Exception as e:           # surfaced below, never swallowed
            errors.append((tag, repr(e)))

    eng = model.engine
    steps0 = eng.sched.decode_device_steps
    try:
        if eng.mesh is not None:                    # the main path's counts
            eng.tp_status(reset_launches=True)      # on every rank
        else:
            pa.paged_decode_attention.launches = 0
            pa.paged_decode_attention_quant.launches = 0
        t_start = time.perf_counter()
        threads = [threading.Thread(target=run, args=kv)
                   for kv in prompts.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        if eng.mesh is not None:
            launches = [st["launches"] for st in eng.tp_status()]
        else:
            launches = {
                "paged_decode_attention": pa.paged_decode_attention.launches,
                "paged_decode_attention_quant":
                    pa.paged_decode_attention_quant.launches}
        stats = model.stats()
    finally:
        srv.stop()
    if errors:
        model.unload()
        raise SystemExit(f"{model.name}: serving requests failed: {errors}")
    sched = stats["sched"]
    device_steps = sched["decode_device_steps_total"] - steps0  # this run's
    n_tokens = sum(len(v) for v in results.values())
    log(f"{model.name}: {len(results)} requests, {n_tokens} tokens in "
        f"{wall!r} s -> {n_tokens / wall!r} generated tok/s; "
        f"decode dispatches {sched['decode_dispatches_total']}, device "
        f"steps {device_steps}, prefill chunks "
        f"{sched['prefill_chunks_total']}, prefix hit blocks "
        f"{sched['prefix_hit_blocks_total']}, ttft p50 (bucket-resolved) "
        f"{stats['request_histograms']['ttft']['p50']!r} s")
    log(f"{model.name}: kernel launches on the main path: {launches} "
        f"(n_layers x device steps = {cfg.n_layers * device_steps})")
    for tag, toks in results.items():
        if len(toks) != max_tokens:
            raise SystemExit(f"{tag}: {len(toks)} tokens, want {max_tokens}")
    return {"prompts": prompts, "results": results, "wall": wall,
            "tok_s": n_tokens / wall, "launches": launches, "stats": stats,
            "device_steps": device_steps}


def serve_four(torch, pa, model, cfg, max_tokens: int = 32) -> dict:
    """Phase 4's four concurrent greedy requests (``max_tokens`` each),
    with the prefix-sharing and chunked-prefill checks."""
    run = serve_prompts(torch, pa, model, cfg, four_prompts(torch, cfg),
                        max_tokens)
    sched = run["stats"]["sched"]
    if sched["prefix_hit_blocks_total"] < 4:
        raise SystemExit("the shared-prefix request did not share blocks")
    if sched["prefill_chunks_total"] < 2:
        raise SystemExit("the long prompt did not stream through chunks")
    return run


def captured(model) -> int:
    """Log the decode program ``model.load()`` captured; returns its
    replays so far. Fails when nothing was captured."""
    g = model.engine.decode_graph
    if g is None:
        raise SystemExit(f"{model.name}: load() captured no decode program")
    log(f"{model.name}: decode program captured at load "
        f"({model.precompile_seconds!r} s of load; capture "
        f"{g.capture_seconds!r} s, graph pool {g.pool_bytes} B, kernel "
        f"launches a replay {g.launches})")
    return g.replays


def replayed(model, replays0: int, what: str) -> int:
    """The captured program's replays since ``replays0``; fails when
    none ran."""
    n = model.engine.decode_graph.replays - replays0
    log(f"{model.name}: {what}: {n} decode dispatches replayed the captured "
        f"program")
    if n <= 0:
        raise SystemExit(f"{model.name}: {what} replayed no decode program")
    return n


def serving(torch, pa, cfg, params) -> dict:
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import LLMModel

    model = LLMModel("llama3-8b", params, cfg, max_batch=8, max_seq=1024,
                     device="cuda")
    model.load()
    eng = model.engine
    log(f"engine: kernel={eng.kernel} block_size={eng.paged.block_size} "
        f"num_blocks={eng.paged.num_blocks} pool "
        f"{pool_bytes(eng.cache) / 1e9:.3f} GB "
        f"buckets={eng.buckets}")
    replays0 = captured(model)
    run = serve_four(torch, pa, model, cfg)
    replayed(model, replays0, "phase 4")
    launches = run["launches"]["paged_decode_attention"]
    if launches != cfg.n_layers * run["device_steps"] or launches == 0 \
            or run["launches"]["paged_decode_attention_quant"] != 0:
        raise SystemExit("decode did not run through the paged kernel")

    # one stream against the full forward's teacher-forced argmax
    prompt, gen_toks = run["prompts"]["mid_300"], run["results"]["mid_300"]
    with torch.no_grad():
        seq = torch.tensor([prompt + gen_toks], device="cuda")
        ref = llama.forward(model.engine.params, seq, cfg)[0]
    rows = ref[len(prompt) - 1:len(prompt) - 1 + len(gen_toks)]
    margin = (rows.max(-1).values
              - rows[torch.arange(len(gen_toks)), torch.tensor(gen_toks)])
    worst = margin.max().item()
    exact = int((margin == 0).sum().item())
    log(f"teacher-forced check mid_300: {exact}/{len(gen_toks)} tokens are "
        f"the exact argmax, worst margin {worst!r} (tolerance {TIE_TOL})")
    if worst > TIE_TOL:
        raise SystemExit("served stream disagrees with the full forward")
    del ref, rows

    step_ms = decode_step_ms(torch, model.engine)
    log(f"decode step (batch 8, {cfg.n_layers} layers, paged kernel, "
        f"{STEP_CONTEXT}-token contexts): {step_ms!r} ms")
    out = {"launches": launches, "tok_s": run["tok_s"],
           "decode_ms_per_step": step_ms,
           "pool_bytes": pool_bytes(eng.cache),
           "weight_bytes": tree_bytes(eng.params)}
    model.unload()
    return out


def quant_serving(torch, pa, cfg, params, base: dict) -> dict:
    """Phase 4q: the same weights and requests through the quantized
    engine (int8 KV + int8 weights). Returns its numbers and the int8
    tree for the quality gate."""
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.serving.quant import is_weight_quantized
    from kubeflow_tpu_torch.serving.scheduler import QuantConfig

    t0 = time.perf_counter()
    model = LLMModel("llama3-8b-int8", params, cfg, max_batch=8,
                     max_seq=1024, device="cuda",
                     quant=QuantConfig(kv_dtype="int8", weight_dtype="int8"))
    model.load()
    torch.cuda.synchronize()
    eng = model.engine
    log(f"quantized engine built (weights quantized once) in "
        f"{time.perf_counter() - t0:.1f} s: kernel={eng.kernel} pool dtype "
        f"{eng.cache['k'].dtype}, weights int8: "
        f"{is_weight_quantized(eng.params)}")
    replays0 = captured(model)
    run = serve_four(torch, pa, model, cfg)
    replayed(model, replays0, "phase 4q")
    launches = run["launches"]
    stats = run["stats"]
    want = cfg.n_layers * run["device_steps"]
    log(f"quantized serving: fused-dequant kernel launches "
        f"{launches['paged_decode_attention_quant']} (want n_layers x "
        f"device steps = {want}), unquantized kernel launches "
        f"{launches['paged_decode_attention']} (want 0); quant "
        f"{stats['quant']}, quant downgrades "
        f"{stats['quant_downgrades_total']}")
    if launches["paged_decode_attention_quant"] != want or want == 0 \
            or launches["paged_decode_attention"] != 0:
        raise SystemExit("quantized decode did not run through the "
                         "fused-dequant kernel alone")
    if stats["quant"]["active"] != "quant=kv:int8,w:int8" \
            or stats["quant_downgrades_total"] != 0 \
            or not is_weight_quantized(eng.params):
        raise SystemExit("the engine is not serving int8 KV + int8 weights")
    step_ms = decode_step_ms(torch, eng)
    qpool, qweights = pool_bytes(eng.cache), tree_bytes(eng.params)
    log(f"pool bytes (payload + scales): int8 {qpool} vs bf16 "
        f"{base['pool_bytes']} ({qpool / base['pool_bytes']!r}x); weight "
        f"bytes: int8 tree {qweights} vs bf16 {base['weight_bytes']} "
        f"({qweights / base['weight_bytes']!r}x)")
    log(f"decode step (batch 8, {cfg.n_layers} layers, fused-dequant "
        f"kernel, int8 weights, {STEP_CONTEXT}-token contexts): "
        f"{step_ms!r} ms (bf16 engine {base['decode_ms_per_step']!r} ms); "
        f"{run['tok_s']!r} generated tok/s (bf16 {base['tok_s']!r})")
    qparams = eng.params
    model.unload()
    return {"launches": launches["paged_decode_attention_quant"],
            "tok_s": run["tok_s"], "decode_ms_per_step": step_ms,
            "pool_bytes": qpool, "weight_bytes": qweights,
            "qparams": qparams}


def _report(tag: str, res: dict) -> str:
    return (f"{tag}: positions {res['positions']}, greedy-token agreement "
            f"{res['greedy_token_agreement']!r}, max logit drift "
            f"{res['max_logit_drift']!r}, rms logit error "
            f"{res['rms_logit_error']!r}")


def quant_quality(torch, cfg, params, qparams) -> dict:
    """Phase 4qq: the JAX package's quality gate in its own configuration,
    then the same method at full width (int8 and fp8 KV, int8 weights)
    beside bf16 against f32 compute on the same weights."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.quant import (
        is_weight_quantized, quantize_weights,
    )
    from kubeflow_tpu_torch.tools.quant_quality import (
        float32_copy, teacher_forced,
    )

    if not is_weight_quantized(qparams):
        raise SystemExit("quality gate needs the int8 tree")
    t0 = time.perf_counter()
    tcfg = llama.llama_tiny(dtype=torch.float32)
    tparams = llama.init_params(torch.Generator(device="cuda").manual_seed(3),
                                tcfg, device="cuda")
    tq = quantize_weights(tparams, tcfg)
    tiny = teacher_forced(tcfg, tparams,
                          {kv: (tcfg, tq, kv) for kv in KV_QMAX}, **GATE_TINY)
    for kv, res in tiny.items():
        log(_report(f"quant quality, the JAX gate's configuration (llama_tiny "
                    f"f32, {GATE_TINY}), {kv} KV + int8 weights vs f32", res)
            + f" (budgets >= {QUALITY_AGREEMENT_MIN}, <= {QUALITY_DRIFT_MAX})")
        if res["greedy_token_agreement"] < QUALITY_AGREEMENT_MIN \
                or res["max_logit_drift"] > QUALITY_DRIFT_MAX:
            raise SystemExit(f"quantized serving ({kv} KV) fails the JAX "
                             "package's quality gate")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    torch.cuda.empty_cache()
    replays = {kv: (cfg, qparams, kv) for kv in KV_QMAX}
    replays["bf16 weights, f32 compute"] = (cfg32, float32_copy(params),
                                            "none")
    full = teacher_forced(cfg, params, replays, **GATE_FULL)
    del replays
    torch.cuda.empty_cache()
    for name, res in full.items():
        what = (f"{name} KV + int8 weights" if name in KV_QMAX else name)
        log(_report(f"quant quality at full width (llama3_8b bf16, "
                    f"{GATE_FULL}), {what} vs bf16", res)
            + (f" (limits: drift <= {QUALITY_DRIFT_MAX}, rms <= "
               f"{QUALITY_RMS_MAX[name]})" if name in KV_QMAX
               else " (bf16's own distance from f32)"))
        if name in KV_QMAX and (
                res["max_logit_drift"] > QUALITY_DRIFT_MAX
                or res["rms_logit_error"] > QUALITY_RMS_MAX[name]):
            raise SystemExit(f"quantized serving ({name} KV) errs past its "
                             "limits at full width")
    log(f"quant quality: {time.perf_counter() - t0:.1f} s")
    return {"gate": tiny, "full_width": full}

def graph_streams(eng, prompts: dict) -> tuple:
    """Phase 4g (a) and (d) on one engine: phase 4's prompts, pipelined
    greedy, then after two steps a fifth request. -> ({tag: (tokens,
    logprobs)}, the decode program's replays while the fifth request was
    in the batch; 0 without a program)."""
    from kubeflow_tpu_torch.serving.llm import SamplingParams

    reqs = {tag: eng.add_request(p, SamplingParams(max_tokens=GRAPH_TOKENS))
            for tag, p in prompts.items() if tag != "fifth"}
    for _ in range(2):
        eng.step()
    reqs["fifth"] = eng.add_request(prompts["fifth"],
                                    SamplingParams(max_tokens=GRAPH_TOKENS))
    g, seen = eng.decode_graph, None
    while eng.has_work():
        eng.step()
        if seen is None and reqs["fifth"].slot is not None and g is not None:
            seen = g.replays
    with_fifth = 0 if g is None or seen is None else g.replays - seen
    return {t: (r.generated, r.logprobs) for t, r in reqs.items()}, \
        with_fifth


def graph_phase(torch, pa, cfg, params) -> dict:
    """Phase 4g: the captured decode program against the eager body, bf16
    and int8 KV + int8 weights, on the first GRAPH_LAYERS layers of
    phase 4's weights (module docstring)."""
    import dataclasses

    from kubeflow_tpu_torch.serving.llm import LLMEngine
    from kubeflow_tpu_torch.serving.quant import quantize_weights
    from kubeflow_tpu_torch.serving.scheduler import QuantConfig
    from kubeflow_tpu_torch.tools.decode_profile import (
        PAGED_COMBINE, PAGED_KERNEL, dispatch_readings, fill_batch,
    )

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_layers=GRAPH_LAYERS)
    params = dict(params, layers={k: v[:GRAPH_LAYERS]
                                  for k, v in params["layers"].items()})
    prompts = dict(four_prompts(torch, cfg))
    rng = torch.Generator().manual_seed(4)
    prompts["fifth"] = torch.randint(1, cfg.vocab_size, (150,),
                                     generator=rng).tolist()
    out = {}
    for tag, quant in (("bf16", None),
                       ("int8", QuantConfig(kv_dtype="int8",
                                            weight_dtype="int8"))):
        kern, off = (("paged_decode_attention_quant",
                      "paged_decode_attention") if quant is not None else
                     ("paged_decode_attention",
                      "paged_decode_attention_quant"))
        p = params if quant is None else quantize_weights(params, cfg)
        kw = dict(max_batch=8, max_seq=1024, kv_block_size=64,
                  decode_chunk=8, device="cuda", quant=quant)
        eager, graph = LLMEngine(p, cfg, **kw), LLMEngine(p, cfg, **kw)
        outcome = graph.precompile()
        g = graph.decode_graph
        log(f"phase 4g {tag}: precompile() -> {outcome!r}: capture "
            f"{g.capture_seconds!r} s (two warm-up chunks and the capture), "
            f"graph pool {g.pool_bytes} B, kernel launches a replay "
            f"{g.launches}")
        if outcome != "no_depot" or g.launches[kern] != \
                cfg.n_layers * graph.decode_chunk or g.launches[off] != 0:
            raise SystemExit(f"phase 4g {tag}: the captured program does not "
                             f"hold n_layers x decode_chunk {kern} launches")
        # (a) + (d): the main path's run, counts from 0
        steps0 = {n: e.sched.decode_device_steps
                  for n, e in (("eager", eager), ("graph", graph))}
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_attention_quant.launches = 0
        res, fifth = {}, {}
        for name, eng in (("eager", eager), ("graph", graph)):
            res[name], fifth[name] = graph_streams(eng, prompts)
        launches = {k.__name__: k.launches for k in (
            pa.paged_decode_attention, pa.paged_decode_attention_quant)}
        steps = sum(e.sched.decode_device_steps - steps0[n]
                    for n, e in (("eager", eager), ("graph", graph)))
        same = all(res["eager"][t][0] == res["graph"][t][0] for t in prompts)
        lp_diff = max(abs(a - b) for t in prompts for a, b in zip(
            res["eager"][t][1], res["graph"][t][1]))
        log(f"phase 4g {tag} (a): {len(prompts)} streams of {GRAPH_TOKENS} "
            f"greedy tokens, eager against {g.replays} replays: token for "
            f"token equal {same}, largest logprob difference {lp_diff!r} "
            f"(want 0.0: the same kernels on the same inputs)")
        log(f"phase 4g {tag} (d): the fifth request, admitted mid-stream, "
            f"rode {fifth['graph']} replays; its stream equal "
            f"{res['eager']['fifth'][0] == res['graph']['fifth'][0]}; "
            f"launches {launches} (want {kern} == n_layers x device steps "
            f"= {cfg.n_layers * steps}, {off} == 0)")
        if not same or lp_diff != 0.0 or fifth["graph"] <= 0:
            raise SystemExit(f"phase 4g {tag}: replayed streams differ from "
                             "eager ones, or no replay saw the fifth request")
        if launches[kern] != cfg.n_layers * steps or launches[off] != 0:
            raise SystemExit(f"phase 4g {tag}: launch counts do not match "
                             "the device steps")
        # (c) and (b): eight 300-token streams decoding, eager then replay
        readings = {}
        for name, eng in (("eager", eager), ("graph", graph)):
            fill_batch(eng, STEP_CONTEXT, GRAPH_FILL_TOKENS)
            r = readings[name] = dispatch_readings(eng, GRAPH_DISPATCHES)
            log(f"phase 4g {tag} (c) {name}: {r['wall_ms_per_step']!r} ms "
                f"per step wall, {r['device_busy_ms_per_step']!r} ms device "
                f"busy, idle share {r['device_idle_share']!r}, API launches "
                f"per step {r['api_launches_per_step']!r} "
                f"{r['api_launches_by_name_per_step']}; the profiled "
                f"dispatch {r['profiled_wall_ms_per_step']!r} ms per step")
            for req in list(eng._active.values()):
                eng.abort([req])
            while eng.has_work():
                eng.step()
        r = readings["graph"]
        want = cfg.n_layers * graph.decode_chunk
        log(f"phase 4g {tag} (b): one replay under torch.profiler: "
            f"{r['paged_kernel_per_dispatch']!r} {PAGED_KERNEL} and "
            f"{r['paged_combine_per_dispatch']!r} {PAGED_COMBINE} launches "
            f"(want n_layers x decode_chunk = {want} each)")
        if r["paged_kernel_per_dispatch"] != want \
                or r["paged_combine_per_dispatch"] != want:
            raise SystemExit(f"phase 4g {tag}: the profiled replay did not "
                             "run the paged kernels n_layers x decode_chunk "
                             "times")
        out[tag] = {"launches": launches[kern], "readings": readings,
                    "capture_seconds": g.capture_seconds,
                    "pool_bytes": g.pool_bytes, "lp_diff": lp_diff}
        del eager, graph, p, g
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 4g: {time.perf_counter() - t_phase:.1f} s")
    return out


def served_step_ms(torch, model, chunks: int = 2) -> float:
    """Host clock per decode step of a loaded LLMModel (tensor-parallel
    or one card) as it serves: eight greedy requests with STEP_CONTEXT-
    token prompts go in through ``generate_stream`` and the model's own
    stepping loop runs them (admission, then pipelined decode dispatches
    of ``decode_chunk`` steps, one dispatch per chunk). Once every slot
    is live, the clock runs from one commit of the first stream's tokens
    to the commit ``chunks`` dispatches later, over the tokens between;
    the streams are closed (aborted) after: each is started first, since
    closing a stream that never ran aborts nothing."""
    eng = model.engine
    rng = torch.Generator().manual_seed(5)
    streams = [model.generate_stream(
        torch.randint(1, eng.cfg.vocab_size, (STEP_CONTEXT,),
                      generator=rng).tolist(), {"max_tokens": 200})
        for _ in range(eng.max_batch)]
    t0, n0 = None, 0
    try:
        first = [next(it) for it in streams]
        n = len(first[0].get("tokens", ()))
        for ev in streams[0]:
            n += len(ev.get("tokens", ()))
            full = (len(eng._active) == eng.max_batch and not eng._waiting
                    and not eng._chunked)
            if t0 is None and full:
                t0, n0 = time.perf_counter(), n
            elif t0 is not None and n - n0 >= chunks * eng.decode_chunk:
                ms = (time.perf_counter() - t0) * 1e3 / (n - n0)
                break
        else:
            raise SystemExit("the timed requests ended before the clock")
    finally:
        for it in streams:
            it.close()
    while eng.has_work():
        time.sleep(0.01)
    return ms


def dispatch_round_trip_ms(eng, n: int = 50) -> float:
    """Median host time of an empty command to every rank and back
    (``serving.tp.Workers.ping``): what each device body's dispatch
    adds under a mesh."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng.tp.ping()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_ranks_agree(eng, sampled=None) -> None:
    """Every rank ran the same sampling bodies (``sampled`` of them,
    when given) and sampled the same tokens: equal running digests
    (``serving.tp.status``)."""
    ranks = eng.tp_status()
    seen = {(r["samples"], r["token_digest"]) for r in ranks}
    log(f"{len(ranks)} ranks: per-rank (sampling bodies, token digest) "
        f"{seen}"
        + (f", sampling dispatches {sampled}" if sampled is not None else ""))
    if len(seen) != 1 or (sampled is not None
                          and ranks[0]["samples"] != sampled):
        raise SystemExit("tensor-parallel ranks sampled different tokens")


def tp_serve_one(torch, pa, cfg, params, mesh, tag, quant, streams,
                 ref, one_ms) -> dict:
    """Phase 4tp for one weight type: serve the four requests on the
    mesh and check them (module docstring)."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.tools.tp_quality import TP_KW, logit_errors

    t0 = time.perf_counter()
    model = LLMModel(f"llama3-8b-tp{TP}-{tag}",
                     llama.SeededParams(0, torch.bfloat16), cfg,
                     quant=quant, mesh=mesh, **TP_KW)
    model.load()
    eng = model.engine
    ranks = eng.tp_status()
    log(f"tensor={TP} {tag} engine up in {time.perf_counter() - t0:.1f} s "
        f"(spawn, rendezvous, each rank drawing its shard): kernel="
        f"{eng.kernel}, ranks (rank, device, local KV heads) "
        f"{[(r['rank'], r['device'], r['kv_heads']) for r in ranks]}, "
        f"rank 0's pool {pool_bytes(eng.cache)} B, weights "
        f"{tree_bytes(eng.params)} B")
    if any(r["kv_heads"] != cfg.n_kv_heads // TP for r in ranks):
        raise SystemExit("a rank does not hold n_kv_heads / tensor heads")
    run = serve_four(torch, pa, model, cfg, TP_TOKENS)
    stats, sched = run["stats"], run["stats"]["sched"]
    want = cfg.n_layers * run["device_steps"]
    kern, off = (("paged_decode_attention_quant", "paged_decode_attention")
                 if quant is not None else
                 ("paged_decode_attention", "paged_decode_attention_quant"))
    log(f"tensor={TP} {tag}: launches per rank {run['launches']} (want "
        f"{kern} == n_layers x device steps = {want}, {off} == 0 on every "
        f"rank); mesh {stats['mesh']}")
    if want == 0 or any(r[kern] != want or r[off] != 0
                        for r in run["launches"]):
        raise SystemExit(f"tensor-parallel decode ({tag}) did not run "
                         f"through {kern} on every rank")
    sampled = (sched["decode_dispatches_total"]
               + stats["prefill_dispatches_total"]
               + sched["chunked_admitted_total"])
    check_ranks_agree(eng, sampled)
    if quant is None:
        # one stream against the unsharded full forward
        prompt, toks = run["prompts"]["mid_300"], run["results"]["mid_300"]
        with torch.no_grad():
            seq = torch.tensor([prompt + toks], device="cuda")
            rows = llama.forward(params, seq, cfg)[0][
                len(prompt) - 1:len(prompt) - 1 + len(toks)]
        margin = (rows.max(-1).values
                  - rows[torch.arange(len(toks)), torch.tensor(toks)])
        worst = margin.max().item()
        log(f"tensor={TP} teacher-forced check mid_300 against the unsharded "
            f"forward: {int((margin == 0).sum())}/{len(toks)} exact argmax, "
            f"worst margin {worst!r} (tolerance {TIE_TOL})")
        if worst > TIE_TOL:
            raise SystemExit("the tensor-parallel stream disagrees with the "
                             "unsharded forward")
        del rows, margin
    err = logit_errors(ref, eng.teacher_forced_logits(streams).cpu())
    log(f"tensor={TP} {tag} vs one card, teacher-forced ({len(streams)} "
        f"streams, {err['positions']} positions): greedy-token agreement "
        f"{err['greedy_token_agreement']!r}, max logit drift "
        f"{err['max_logit_drift']!r}, rms logit error "
        f"{err['rms_logit_error']!r} (limit {TP_RMS_MAX[tag]})")
    if err["rms_logit_error"] > TP_RMS_MAX[tag]:
        raise SystemExit(f"tensor-parallel logits ({tag}) err past the limit")
    step_ms = served_step_ms(torch, model, TP_STEP_CHUNKS)
    rt_ms = dispatch_round_trip_ms(eng)
    check_ranks_agree(eng)
    log(f"tensor={TP} {tag} decode step as served (batch 8, "
        f"{cfg.n_layers} layers, ~{STEP_CONTEXT}-token contexts, one "
        f"dispatch per {eng.decode_chunk} steps, {mesh.backend}"
        f"{', all ranks on one card' if mesh.shared else ''}): "
        f"{step_ms!r} ms against one card's {one_ms!r} ms (same method); "
        f"dispatch round trip alone {rt_ms!r} ms; "
        f"{run['tok_s']!r} generated tok/s over HTTP")
    model.unload()
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_per_rank": [r[kern] for r in run["launches"]],
            "tok_s": run["tok_s"], "decode_ms_per_step": step_ms,
            "one_card_ms_per_step": one_ms, "round_trip_ms": rt_ms,
            "errors": err}


def tp_serving(torch, pa, cfg, params) -> dict:
    """Phase 4tp: the one-card references (teacher-forced logits, and the
    decode step at phase 4's geometry), then the bf16 and int8 runs on
    the mesh."""
    from kubeflow_tpu_torch.parallel import TensorMesh
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.serving.llm import LLMEngine
    from kubeflow_tpu_torch.serving.scheduler import QuantConfig
    from kubeflow_tpu_torch.tools.tp_quality import (
        REF_KW, TP_KW, reference_streams, tp_devices,
    )

    mesh = TensorMesh(TP, tp_devices(TP))
    log(f"phase 4tp: tensor={TP} over {[str(d) for d in mesh.devices]}, "
        f"device collectives over {mesh.backend}: "
        + ("all ranks share one card (the times are no tensor-parallel "
           "speedup)" if mesh.shared else "one card per rank"))
    int8 = QuantConfig(kv_dtype="int8", weight_dtype="int8")
    kinds = (("bf16", None), ("int8", int8))
    t0 = time.perf_counter()
    streams, refs, one_ms = None, {}, {}
    for tag, quant in kinds:
        one = LLMEngine(params, cfg, device="cuda", quant=quant, **REF_KW)
        if streams is None:
            streams = reference_streams(one, cfg.vocab_size)
        refs[tag] = one.teacher_forced_logits(streams).cpu()
        del one
        one = LLMModel(f"llama3-8b-one-{tag}", params, cfg, device="cuda",
                       quant=quant, **TP_KW)
        one.load()
        one_ms[tag] = served_step_ms(torch, one, TP_STEP_CHUNKS)
        one.unload()
        del one
        gc.collect()
        torch.cuda.empty_cache()
    log(f"one-card references (bf16, int8): {time.perf_counter() - t0:.1f} "
        f"s; decode step as served at batch 8, one card: {one_ms}")
    return {tag: tp_serve_one(torch, pa, cfg, params, mesh, tag, quant,
                              streams, refs[tag], one_ms[tag])
            for tag, quant in kinds}

# ---------------------------------------------------------------------------
# Speculative decoding (phase 5s) and disaggregated serving (phase 5d)
# ---------------------------------------------------------------------------

def spec_prompts(torch, cfg) -> dict:
    """Phase 4's four prompts and two whose second half repeats the first
    (seed 2): the n-gram drafter finds matches in those."""
    prompts = dict(four_prompts(torch, cfg))
    rng = torch.Generator().manual_seed(2)
    for n in (48, 96):
        half = torch.randint(1, cfg.vocab_size, (n,), generator=rng).tolist()
        prompts[f"repeat_{2 * n}"] = half + half
    return prompts


def clear_prefix_cache(eng) -> None:
    """Evict every unpinned cached block of an idle engine, so the next
    run admits its prompts from scratch (no radix hits)."""
    pk = eng.paged
    pk.allocator.free(pk.radix.evict_lru(pk.num_blocks, pk._ref))


def step_profile(torch, run, steps: int = 5) -> dict:
    """Host clock per call of ``run`` over ``steps`` calls (ending in a
    synchronize, after three warm-up calls), then one profiled call: its
    device busy ms and kernel launches, and 1 - busy / the unprofiled
    wall as the idle share (one call: the profiler's event processing
    grows with the ~2,600 launches a call and takes tens of seconds over
    ten)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / wall),   # unprofiled wall
            "launches": len(kernels)}


def verify_and_decode_steps(torch, eng) -> dict:
    """``step_profile`` of one verify dispatch (width SPEC_K + 1) and of
    one decode step over the engine's params and pool, every slot live
    at STEP_CONTEXT tokens (the engine must be idle; it is left with
    every slot reserved, ready to unload)."""
    from kubeflow_tpu_torch.serving.paged_kv import (
        paged_decode_step, paged_verify_step,
    )

    pk = eng.paged
    for slot in range(pk.max_batch):
        pk.release(slot)
        if pk.reserve(slot, STEP_CONTEXT, 32) is None:
            raise SystemExit("pool too small for the timed steps")
    tables = torch.tensor(pk.tables, device=eng.device)
    b = pk.max_batch
    tok = torch.ones((b,), dtype=torch.int32, device=eng.device)
    cand = torch.ones((b, SPEC_K + 1), dtype=torch.int32, device=eng.device)
    limit = torch.full((b,), STEP_CONTEXT + 32, dtype=torch.int32,
                       device=eng.device)

    def decode():
        eng.cache["len"].fill_(STEP_CONTEXT)
        paged_decode_step(eng.params, tok, eng.cfg, eng.cache, tables,
                          kernel=eng.kernel)

    def verify():
        eng.cache["len"].fill_(STEP_CONTEXT)
        paged_verify_step(eng.params, cand, eng.cfg, eng.cache, tables,
                          limit)

    with torch.no_grad():
        return {"decode": step_profile(torch, decode),
                "verify": step_profile(torch, verify)}


def _filled_pool(torch, eng, n_slots: int, prompt_len: int, extra: int,
                 seed: int):
    """A fresh pool of the engine's geometry and KV dtype with
    ``n_slots`` seeded prompts prefilled (``llama.prefill`` at batch
    ``n_slots``, inserted as the engine inserts), room for ``extra``
    more tokens each. -> (cache, tables [max_batch, width])."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.paged_kv import (
        blocks_for, init_paged_cache, paged_insert_batch,
    )

    cfg, dev, bs = eng.cfg, eng.device, eng.paged.block_size
    nb = blocks_for(prompt_len + extra, bs)
    nbp = blocks_for(prompt_len, bs)
    cache = init_paged_cache(cfg, eng.max_batch, eng.max_seq, bs,
                             n_slots * nb + 1, device=dev,
                             quant_kv=eng.quant.kv_dtype)
    tables = torch.zeros((eng.max_batch, eng.max_seq // bs),
                         dtype=torch.int32, device=dev)
    tables[:n_slots, :nb] = torch.arange(
        1, n_slots * nb + 1, dtype=torch.int32, device=dev).reshape(
            n_slots, nb)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.zeros((n_slots, nbp * bs), dtype=torch.int32)
    toks[:, :prompt_len] = torch.randint(1, cfg.vocab_size,
                                         (n_slots, prompt_len), generator=gen)
    lengths = torch.full((n_slots,), prompt_len, dtype=torch.int32,
                         device=dev)
    scratch = llama.init_cache(cfg, n_slots, nbp * bs, device=dev)
    _, filled = llama.prefill(eng.params, toks.to(dev), cfg, scratch,
                              lengths=lengths)
    paged_insert_batch(cache, filled["k"], filled["v"],
                       tables[:n_slots, :nbp], lengths,
                       torch.arange(n_slots, dtype=torch.int32, device=dev))
    return cache, tables


def verify_vs_decode(torch, eng, rounds: int = 4) -> dict:
    """Phase 5s (b): teacher-forced logits of ``rounds`` verify
    dispatches of width SPEC_K + 1 against ``rounds * (SPEC_K + 1)``
    decode steps (the paged kernel) over the same seeded tokens, from
    the same pool (8 slots, 100-token prompts): the rms error over the
    decode logits' rms, and the largest error. Then the same verify with
    a planted fault: the attention's query offset one too far (each row
    sees the next row's KV)."""
    from kubeflow_tpu_torch.serving import paged_kv
    from kubeflow_tpu_torch.serving.paged_kv import (
        paged_decode_step, paged_verify_step,
    )

    w, b, dev = SPEC_K + 1, eng.max_batch, eng.device
    n = rounds * w
    base, tables = _filled_pool(torch, eng, b, 100, n, seed=11)
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(1, eng.cfg.vocab_size, (b, n),
                         generator=gen).to(dev, torch.int32)
    limit = torch.full((b,), 100 + n, dtype=torch.int32, device=dev)
    clone = lambda c: {k: v.clone() for k, v in c.items()}

    def verify_logits():
        cache, rows = clone(base), []
        for r in range(rounds):
            lg, cache = paged_verify_step(
                eng.params, toks[:, r * w:(r + 1) * w], eng.cfg, cache,
                tables, limit)
            rows.append(lg)
            cache["len"] = cache["len"] + w
        return torch.cat(rows, dim=1)

    with torch.no_grad():
        cache, rows = clone(base), []
        for t in range(n):
            lg, cache = paged_decode_step(eng.params, toks[:, t], eng.cfg,
                                          cache, tables, kernel=eng.kernel)
            rows.append(lg)
        dec = torch.stack(rows, dim=1)
        del cache, rows
        sound = verify_logits()
        orig = paged_kv._xla_attention
        paged_kv._xla_attention = (
            lambda q, k, v, *, causal, q_offset=0, bias=None: orig(
                q, k, v, causal=causal, q_offset=q_offset + 1, bias=bias))
        try:
            fault = verify_logits()
        finally:
            paged_kv._xla_attention = orig
    ref_rms = dec.double().pow(2).mean().sqrt().item()
    err = lambda x: (x - dec).double().pow(2).mean().sqrt().item() / ref_rms
    out = {"rms": err(sound), "fault_rms": err(fault),
           "max_abs": (sound - dec).abs().max().item(),
           "positions": b * n}
    del base, dec, sound, fault
    torch.cuda.empty_cache()
    return out


def decode_path_gaps(torch, eng, cases: dict) -> dict:
    """Top-1 minus top-2 logit of the decode program predicting token i
    of each stream, ``cases``: tag -> (prompt, tokens, i). A replica of
    the engine's program at its batch width, one stream a slot: each
    prompt through ``llama.prefill`` into a fresh pool of the engine's
    geometry and KV dtype, then its tokens[:i] one ``paged_decode_step``
    each through the engine's kernel (a slot past its i keeps stepping
    into its own blocks)."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.paged_kv import (
        blocks_for, init_paged_cache, paged_decode_step, paged_insert_batch,
    )

    if not cases:
        return {}
    cfg, dev, bs = eng.cfg, eng.device, eng.paged.block_size
    tags = list(cases)[:eng.max_batch]
    steps = max(cases[t][2] for t in tags)
    nb = {t: blocks_for(len(cases[t][0]) + steps + 1, bs) for t in tags}
    cache = init_paged_cache(cfg, eng.max_batch, eng.max_seq, bs,
                             sum(nb.values()) + 1, device=dev,
                             quant_kv=eng.quant.kv_dtype)
    tables = torch.zeros((eng.max_batch, eng.max_seq // bs),
                         dtype=torch.int32, device=dev)
    gaps, first = {}, 1
    gap = lambda row: (lambda top: (top[0] - top[1]).item())(
        row.float().topk(2).values)
    with torch.no_grad():
        for slot, t in enumerate(tags):
            prompt = cases[t][0]
            n, nbp = len(prompt), blocks_for(len(prompt), bs)
            tables[slot, :nb[t]] = torch.arange(
                first, first + nb[t], dtype=torch.int32, device=dev)
            first += nb[t]
            toks = torch.zeros((1, nbp * bs), dtype=torch.int32, device=dev)
            toks[0, :n] = torch.tensor(prompt, dtype=torch.int32)
            lengths = torch.tensor([n], dtype=torch.int32, device=dev)
            logits, filled = llama.prefill(
                eng.params, toks, cfg,
                llama.init_cache(cfg, 1, nbp * bs, device=dev),
                lengths=lengths)
            paged_insert_batch(cache, filled["k"], filled["v"],
                               tables[slot:slot + 1, :nbp], lengths,
                               torch.tensor([slot], dtype=torch.int32,
                                            device=dev))
            if cases[t][2] == 0:
                gaps[t] = gap(logits[0])
        live = torch.zeros((eng.max_batch,), dtype=torch.bool, device=dev)
        live[:len(tags)] = True
        for step in range(steps):
            tok = torch.zeros((eng.max_batch,), dtype=torch.int32)
            for slot, t in enumerate(tags):
                toks_t = cases[t][1]
                tok[slot] = toks_t[min(step, len(toks_t) - 1)]
            logits, cache = paged_decode_step(eng.params, tok.to(dev), cfg,
                                              cache, tables,
                                              kernel=eng.kernel)
            cache["len"] = torch.where(live, cache["len"], 0)
            for slot, t in enumerate(tags):
                if cases[t][2] == step + 1:
                    gaps[t] = gap(logits[slot])
    del cache
    return gaps


def first_divergences(torch, eng, prompts, spec, plain, threshold,
                      what: str) -> dict:
    """Phase 5s (c): the first index where each speculative stream leaves
    the plain one, and there the decode program's top-2 gap
    (``decode_path_gaps``); fails unless every such gap is under
    ``threshold``."""
    cases = {}
    for tag, prompt in prompts.items():
        a, b = spec[tag], plain[tag][:len(spec[tag])]
        i = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is not None:
            cases[tag] = (prompt, b, i)
    gaps = decode_path_gaps(torch, eng, cases)
    out = {tag: ({"index": cases[tag][2], "gap": gaps[tag]}
                 if tag in cases else None) for tag in prompts}
    log(f"{what}: first divergence of each speculative stream from the plain "
        f"one (index, decode top-2 gap there; threshold {threshold!r}): "
        f"{out}")
    for tag, gap in gaps.items():
        if gap > threshold:
            raise SystemExit(
                f"{what} {tag}: speculative stream leaves the plain one at "
                f"token {cases[tag][2]} where the decode program's top-2 gap "
                f"is {gap!r}, over the near-tie threshold {threshold!r}")
    return out


def spec_tiny_f32(torch) -> None:
    """Phase 5s (a): llama_tiny in float32 on the card (widened to head_dim
    64, the paged kernel's smallest): speculative streams token-identical
    to the plain engine's."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving.llm import LLMEngine, SamplingParams
    from kubeflow_tpu_torch.serving.scheduler import SchedulerConfig

    cfg = dataclasses.replace(llama.llama_tiny(dtype=torch.float32), dim=256,
                              mlp_dim=512)
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    kw = dict(max_batch=4, max_seq=128, prefill_buckets=(16, 32),
              decode_chunk=4, device="cuda")
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [3] * 12,
               [1, 2, 3, 1, 2, 3, 1, 2], [42, 17] * 5,
               [(7 * i) % 250 + 1 for i in range(40)]]
    streams = {}
    for name, sched in (("plain", None), ("spec", SchedulerConfig(
            spec_decode=True, spec_k=SPEC_K))):
        eng = LLMEngine(params, cfg, scheduler=sched, **kw)
        reqs = eng.generate(prompts, SamplingParams(max_tokens=24))
        streams[name] = [r.generated for r in reqs]
        if name == "spec":
            st = eng.scheduler_stats()
    same = streams["spec"] == streams["plain"]
    log(f"phase 5s (a) llama_tiny f32 on the card: speculative streams "
        f"token-identical to plain: {same} ({len(prompts)} streams x 24; "
        f"verify dispatches {st['spec_dispatches_total']}, drafted "
        f"{st['spec_draft_tokens_total']}, accepted "
        f"{st['spec_accepted_draft_tokens_total']})")
    if not same or st["spec_dispatches_total"] == 0:
        raise SystemExit("f32 speculative streams differ from plain decode "
                         "(or nothing was verified)")


def spec_one(torch, pa, cfg, params, tag, quant) -> dict:
    """Phase 5s at full width for one weight type: the plain run, then
    the speculative run of the same engine (the prefix cache cleared
    between them), the verify-vs-decode readings (b), the streams'
    first divergences (c), and the verify and decode steps timed."""
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.serving.scheduler import SchedulerConfig

    model = LLMModel(f"llama3-8b-spec-{tag}", params, cfg, max_batch=8,
                     max_seq=1024, device="cuda", quant=quant,
                     scheduler=SchedulerConfig(spec_decode=True,
                                               spec_k=SPEC_K))
    model.load()
    eng = model.engine
    drafter, eng.spec = eng.spec, None
    prompts = spec_prompts(torch, cfg)
    replays0 = captured(model)
    plain = serve_prompts(torch, pa, model, cfg, prompts, SPEC_TOKENS)
    replays0 += replayed(model, replays0, f"phase 5s {tag} plain run")
    clear_prefix_cache(eng)
    eng.spec = drafter
    run = serve_prompts(torch, pa, model, cfg, prompts, SPEC_TOKENS)
    log(f"phase 5s {tag}: {eng.decode_graph.replays - replays0} of the "
        f"speculative run's decode fallbacks replayed the captured program")
    st = run["stats"]["sched"]
    kern, off = (("paged_decode_attention_quant", "paged_decode_attention")
                 if quant is not None else
                 ("paged_decode_attention", "paged_decode_attention_quant"))
    want = cfg.n_layers * run["device_steps"]
    n_tok = sum(len(v) for v in run["results"].values())
    per_dispatch = st["spec_committed_tokens_total"] / max(
        1, st["spec_dispatches_total"])
    log(f"phase 5s {tag}: drafted {st['spec_draft_tokens_total']}, accepted "
        f"{st['spec_accepted_draft_tokens_total']}, committed by verifies "
        f"{st['spec_committed_tokens_total']} over "
        f"{st['spec_dispatches_total']} verify dispatches ({per_dispatch!r} "
        f"tokens per dispatch, {st['accepted_tokens_per_step']!r} per "
        f"stream and dispatch); undrafted rounds that fell back to decode "
        f"{st['spec_undrafted_steps_total']} ({run['device_steps']} decode "
        f"device steps), non-greedy fallbacks {st['spec_fallbacks_total']}; "
        f"their {kern} launches {run['launches'][kern]} (want n_layers x "
        f"device steps = {want}), {off} {run['launches'][off]} (want 0)")
    if st["spec_dispatches_total"] == 0 or st["spec_fallbacks_total"] \
            or run["launches"][kern] != want or want == 0 \
            or run["launches"][off] != 0:
        raise SystemExit(f"speculative serving ({tag}) did not verify, or "
                         f"its decode fallbacks did not run through {kern}")
    log(f"phase 5s {tag}: {n_tok} tokens in {run['wall']!r} s speculative "
        f"({run['wall'] * 1e3 / n_tok!r} ms per committed token over "
        f"HTTP) against {plain['wall']!r} s plain "
        f"({plain['wall'] * 1e3 / n_tok!r} ms per token), the same six "
        f"prompts, batch 8, {SPEC_TOKENS} greedy tokens each")
    b = verify_vs_decode(torch, eng)
    log(f"phase 5s (b) {tag}: verify vs sequential decode, teacher-forced "
        f"({b['positions']} positions): rms error / rms {b['rms']!r} (limit "
        f"{SPEC_RMS_MAX[tag]}), max abs {b['max_abs']!r}; planted fault "
        f"(query offset + 1) {b['fault_rms']!r}")
    if not b["rms"] <= SPEC_RMS_MAX[tag] < b["fault_rms"]:
        raise SystemExit(f"verify logits ({tag}) err past the limit, or the "
                         "planted fault does not")
    threshold = 2 * b["max_abs"]
    first_divergences(torch, eng, prompts, run["results"], plain["results"],
                      threshold, f"phase 5s (c) {tag}")
    steps = verify_and_decode_steps(torch, eng)
    v, d = steps["verify"], steps["decode"]
    log(f"phase 5s {tag} steps (batch 8, {STEP_CONTEXT}-token contexts): "
        f"verify (width {SPEC_K + 1}) {v['wall_ms']!r} ms, device busy "
        f"{v['device_busy_ms']!r} ms, idle share {v['idle_share']!r}, "
        f"{v['launches']!r} device launches; decode {d['wall_ms']!r} ms, "
        f"busy {d['device_busy_ms']!r} ms, idle {d['idle_share']!r}, "
        f"{d['launches']!r} launches; at {st['accepted_tokens_per_step']!r} "
        f"tokens per stream and verify: "
        f"{v['wall_ms'] / st['accepted_tokens_per_step']!r} ms per "
        f"committed token against decode's {d['wall_ms']!r}")
    model.unload()
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": run["launches"][kern], "b": b,
            "plain": plain["results"], "prompts": prompts}


def spec_tp(torch, pa, cfg, one: dict, tp_drift: float) -> dict:
    """Phase 5s under tensor=4 (phase 4tp's mesh): three of the prompts
    served speculatively, rank digests equal, row 3's kernels on every
    rank for the decode fallbacks. Its streams are held against the
    one-card plain streams of the same prompts (phase 5s bf16) by the
    caller, with phase 4tp's measured drift in the threshold."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel import TensorMesh
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.serving.scheduler import SchedulerConfig
    from kubeflow_tpu_torch.tools.tp_quality import TP_KW, tp_devices

    t0 = time.perf_counter()
    model = LLMModel(f"llama3-8b-tp{TP}-spec",
                     llama.SeededParams(0, torch.bfloat16), cfg,
                     mesh=TensorMesh(TP, tp_devices(TP)),
                     scheduler=SchedulerConfig(spec_decode=True,
                                               spec_k=SPEC_K), **TP_KW)
    model.load()
    eng = model.engine
    log(f"tensor={TP} speculative engine up in "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = {k: one["prompts"][k]
               for k in ("short_100", "repeat_96", "repeat_192")}
    run = serve_prompts(torch, pa, model, cfg, prompts, SPEC_TP_TOKENS)
    st = run["stats"]["sched"]
    want = cfg.n_layers * run["device_steps"]
    log(f"tensor={TP} speculative: verify dispatches "
        f"{st['spec_dispatches_total']}, drafted "
        f"{st['spec_draft_tokens_total']}, accepted "
        f"{st['spec_accepted_draft_tokens_total']}, committed "
        f"{st['spec_committed_tokens_total']}; undrafted "
        f"{st['spec_undrafted_steps_total']}; launches per rank "
        f"{run['launches']} (want paged_decode_attention == n_layers x "
        f"device steps = {want} on every rank); {run['wall']!r} s")
    if st["spec_dispatches_total"] == 0 or want == 0 or any(
            r["paged_decode_attention"] != want
            or r["paged_decode_attention_quant"] != 0
            for r in run["launches"]):
        raise SystemExit("tensor-parallel speculative serving did not "
                         "verify, or its fallbacks missed row 3's kernels")
    check_ranks_agree(eng, st["decode_dispatches_total"]
                      + run["stats"]["prefill_dispatches_total"]
                      + st["chunked_admitted_total"]
                      + st["spec_dispatches_total"])
    model.unload()
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_per_rank": [r["paged_decode_attention"]
                                  for r in run["launches"]],
            "results": run["results"],
            "plain": {k: one["plain"][k] for k in prompts},
            "prompts": prompts, "threshold": 2 * (one["b"]["max_abs"]
                                                  + tp_drift)}


def spec_phase(torch, pa, cfg, params, tp: dict) -> dict:
    """Phase 5s: (a) on llama_tiny f32, then bf16, int8 KV + int8
    weights, and tensor=4 at full width."""
    from kubeflow_tpu_torch.serving.llm import LLMEngine
    from kubeflow_tpu_torch.serving.scheduler import QuantConfig

    t0 = time.perf_counter()
    spec_tiny_f32(torch)
    out = {"bf16": spec_one(torch, pa, cfg, params, "bf16", None),
           "int8": spec_one(torch, pa, cfg, params, "int8",
                            QuantConfig(kv_dtype="int8",
                                        weight_dtype="int8"))}
    tpr = spec_tp(torch, pa, cfg, out["bf16"],
                  tp["bf16"]["errors"]["max_logit_drift"])
    # (c) under the mesh: against the one-card plain streams, the gaps
    # read on one card's decode program
    ref = LLMEngine(params, cfg, max_batch=8, max_seq=1024, device="cuda")
    first_divergences(torch, ref, tpr["prompts"], tpr["results"],
                      tpr["plain"], tpr["threshold"],
                      f"phase 5s (c) tensor={TP}")
    del ref
    out["tp"] = tpr
    log(f"phase 5s: {time.perf_counter() - t0:.1f} s")
    return out


def held_payload(torch, model, prompt, max_tokens: int, rt=None) -> dict:
    """A prefill tier's migration payload for ``prompt``, made as
    ``TierRuntime.prefill_and_migrate`` makes it (hold, export, release
    on the engine's thread, through ``rt``, by default the model's),
    without sending it."""
    from kubeflow_tpu_torch.serving.llm import SamplingParams

    rt, eng = rt or model.disagg, model.engine
    req = eng.add_request(prompt, SamplingParams(max_tokens=max_tokens),
                          hold_after_prefill=True)
    model.kick()
    deadline = time.monotonic() + 120
    while req.t_first_token == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    payload = rt.run_on_engine(lambda: eng.export_held_kv(req))
    rt.run_on_engine(lambda: eng.release_held(req))
    if payload is None:
        raise SystemExit("no held request to export")
    return payload


def wait_for(pred, timeout: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def disagg_run(torch, pa, cfg, params, params2, tag, quant) -> dict:
    """Phase 5d for one KV dtype: a prefill tier (``params``) and a decode
    tier (``params2``, its own copy), each an LLMModel behind its own
    ModelServer, attached as the runtime attaches KFT_TIER replicas;
    phase 4's 100-, 300- and 700-token prompts migrated one at a time
    through /disagg/prefill and /disagg/collect, then served co-located
    one at a time on the prefill tier's engine: token for token equal."""
    from kubeflow_tpu_torch.serving import (
        LLMModel, ModelRepository, ModelServer,
    )
    from kubeflow_tpu_torch.serving.runtime import attach_tier

    models, servers = {}, {}
    for tier, p in (("prefill", params), ("decode", params2)):
        m = LLMModel(f"llama3-8b-{tier}-{tag}", p, cfg, max_batch=8,
                     max_seq=1024, device="cuda", quant=quant, tier=tier)
        repo = ModelRepository()
        repo.register(m)
        attach_tier(m, {"KFT_TIER": tier, "KFT_KV_BIND": "127.0.0.1:0"})
        models[tier], servers[tier] = m, ModelServer(repo).start()
    pre, dec = models["prefill"], models["decode"]
    kv_addr = list(dec.disagg.kv_addr)
    url = {t: f"{servers[t].url}/v2/models/{models[t].name}/disagg/"
           for t in models}
    four = four_prompts(torch, cfg)
    prompts = {k: four[k] for k in ("short_100", "mid_300", "chunked_700")}
    cache = dec.engine.cache
    block_bytes = sum(cache[k][:, 0].numel() * cache[k].element_size()
                      for k in ("k", "v", "k_scale", "v_scale")
                      if k in cache)
    kern, off = (("paged_decode_attention_quant", "paged_decode_attention")
                 if quant is not None else
                 ("paged_decode_attention", "paged_decode_attention_quant"))
    rows, migrated = {}, {}
    try:
        if pre.engine.decode_graph is not None:
            raise SystemExit("phase 5d: the prefill tier captured a decode "
                             "program")
        replays0 = captured(dec)
        steps0 = dec.stats()["sched"]["decode_device_steps_total"]
        pa.paged_decode_attention.launches = 0
        pa.paged_decode_attention_quant.launches = 0
        for name, prompt in prompts.items():
            sent0 = pre.disagg.stats.get("bytes_sent_total")
            hid = f"{tag}-{name}"
            out = post_json(url["prefill"] + "prefill",
                        {"inputs": prompt, "decode_addr": kv_addr,
                         "handoff_id": hid,
                         "parameters": {"max_tokens": DISAGG_TOKENS}})
            if out.get("status") != "migrated":
                raise SystemExit(f"phase 5d {tag} {name}: {out}")
            res = post_json(url["decode"] + "collect", {"handoff_id": hid})
            migrated[name] = res["tokens"]
            t = out["timings"]
            nbytes = out["migrated_blocks"] * block_bytes
            rt_s = t["export_s"] + t["transfer_s"]
            rows[name] = {
                "blocks": out["migrated_blocks"], "bytes": nbytes,
                "frame_bytes": pre.disagg.stats.get("bytes_sent_total")
                - sent0,
                "prefill_s": t["prefill_s"], "export_s": t["export_s"],
                "transfer_s": t["transfer_s"],
                "inject_to_first_commit_s":
                    res["timings"].get("inject_to_first_commit_s"),
                "host_round_trip_gb_s": nbytes / rt_s / 1e9}
            log(f"phase 5d {tag} {name}: {rows[name]}")
        launches = {"paged_decode_attention":
                    pa.paged_decode_attention.launches,
                    "paged_decode_attention_quant":
                    pa.paged_decode_attention_quant.launches}
        steps = dec.stats()["sched"]["decode_device_steps_total"] - steps0
        replayed(dec, replays0, f"phase 5d {tag} decode tier")
        want = cfg.n_layers * steps
        log(f"phase 5d {tag}: decode tier launches {launches} (want {kern} "
            f"== n_layers x its decode device steps = {want}, {off} == 0)")
        if launches[kern] != want or want == 0 or launches[off] != 0:
            raise SystemExit(f"phase 5d {tag}: the decode tier's steps did "
                             f"not run through {kern} over migrated blocks")
        for name, prompt in prompts.items():
            body = {"inputs": [{"name": "ids", "shape": [1, len(prompt)],
                                "datatype": "INT32", "data": prompt}],
                    "parameters": {"max_tokens": DISAGG_TOKENS}}
            o = post_json(f"{servers['prefill'].url}/v2/models/"
                          f"{pre.name}/infer", body)
            toks = {t["name"]: t for t in o["outputs"]}["tokens"]["data"]
            same = toks[:DISAGG_TOKENS] == migrated[name]
            log(f"phase 5d {tag} {name}: migrated stream equals the "
                f"co-located one token for token: {same}")
            if not same:
                raise SystemExit(f"phase 5d {tag} {name}: migrated stream "
                                 "differs from the co-located stream")
        if tag == "bf16":
            disagg_races(torch, pre, dec)
        mesh_run = disagg_mesh(torch, pa, cfg, params, tag, quant, pre, dec,
                               prompts, rows)
        labelled = 'tier="prefill"' in servers["prefill"]._render_metrics()
        fails = pre.stats()["disagg"].get("migration_failures_total", 0)
        log(f"phase 5d {tag}: kft_disagg_migration_failures_total {fails}; "
            f"tier label on the prefill tier's /metrics: {labelled}")
        if fails or not labelled:
            raise SystemExit(f"phase 5d {tag}: migration failures, or no "
                             "tier label")
    finally:
        for srv in servers.values():
            srv.stop()
        dec.disagg.receiver.close()
        for m in models.values():
            m.unload()
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches[kern], "mesh": mesh_run}


def tie_margin(torch, params, cfg, prompt, toks) -> tuple:
    """``toks`` (a greedy stream after ``prompt``) teacher-forced through
    the unsharded full forward: how many are its exact argmax, and the
    largest gap between a row's max logit and the chosen token's."""
    from kubeflow_tpu_torch.models import llama

    with torch.no_grad():
        seq = torch.tensor([prompt + toks], device="cuda")
        rows = llama.forward(params, seq, cfg)[0][
            len(prompt) - 1:len(prompt) - 1 + len(toks)]
    margin = (rows.max(-1).values
              - rows[torch.arange(len(toks)), torch.tensor(toks)])
    return int((margin == 0).sum()), margin.max().item()


def payload_values(torch, payload, n: int) -> dict:
    """A payload's K and V over the prompt's ``n`` rows as float32
    [L, n, KV, D] (bf16 from its bit pattern, int8 and fp8 times their
    per-block scales)."""
    import numpy as np

    from kubeflow_tpu_torch.serving.quant import kv_store_dtype

    blocks, dtype = payload["blocks"], payload["kv_dtype"]
    out = {}
    for key in ("k", "v"):
        arr = blocks[key]
        if dtype == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        elif dtype == "float8_e4m3fn":
            t = torch.from_numpy(arr).view(kv_store_dtype("fp8_e4m3"))
        else:
            t = torch.from_numpy(arr)
        t = t.float()
        if key + "_scale" in blocks:
            t = t * torch.from_numpy(blocks[key + "_scale"])[:, :, None, :,
                                                            None]
        out[key] = t.reshape(t.shape[0], -1, *t.shape[3:])[:, :n]
    return out


def payload_error(torch, mine, ref, n: int) -> float:
    """rms of ``mine``'s K and V minus ``ref``'s over the prompt's ``n``
    rows, over ``ref``'s rms."""
    a, b = payload_values(torch, mine, n), payload_values(torch, ref, n)
    err = sum((a[k] - b[k]).double().pow(2).sum().item() for k in a)
    return (err / sum(b[k].double().pow(2).sum().item() for k in b)) ** 0.5


def disagg_mesh(torch, pa, cfg, params, tag, quant, pre, dec, prompts,
                one_rows) -> dict:
    """Phase 5dt for one KV dtype (module docstring): a tensor=DISAGG_TP
    LLMModel of llama3_8b plays the prefill tier into phase 5d's one-card
    decode tier (``dec``) and the decode tier of its one-card prefill
    tier (``pre``), through a prefill and a decode ``TierRuntime`` over
    its engine; phase 5d's three prompts both ways."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.serving.disagg import TierRuntime
    from kubeflow_tpu_torch.serving.llm import SamplingParams
    from kubeflow_tpu_torch.serving.paged_kv import (
        blocks_for, join_heads, payload_heads,
    )
    from kubeflow_tpu_torch.tools.tp_quality import TP_KW, tp_devices

    t_phase = time.perf_counter()
    mesh = mesh_from_topology_env({"KFT_MESH": f"tensor={DISAGG_TP}"},
                                  devices=tp_devices(DISAGG_TP))
    log(f"phase 5dt {tag}: tensor={DISAGG_TP} over "
        f"{[str(d) for d in mesh.devices]} ({mesh.backend}"
        + (", the ranks share one card: no tensor-parallel speedup"
           if mesh.shared else ", a card a rank") + ")")
    model = LLMModel(f"llama3-8b-tp{DISAGG_TP}-tiers-{tag}",
                     llama.SeededParams(0, torch.bfloat16), cfg, mesh=mesh,
                     quant=quant, **TP_KW)
    model.load()
    eng = model.engine
    kern, off = (("paged_decode_attention_quant", "paged_decode_attention")
                 if quant is not None else
                 ("paged_decode_attention", "paged_decode_attention_quant"))
    mesh_pre = TierRuntime(eng, "prefill", model=model)
    mesh_dec = TierRuntime(eng, "decode", model=model)
    mesh_dec.attach_receiver()
    sampling = SamplingParams(max_tokens=DISAGG_TP_TOKENS)
    out = {}
    try:
        log(f"phase 5dt {tag}: mesh up in {time.perf_counter() - t_phase:.1f}"
            f" s; ranks {[(r['rank'], r['kv_heads']) for r in eng.tp_status()]}")
        for name, prompt in prompts.items():
            n = len(prompt)
            want_blocks = blocks_for(n, eng.paged.block_size)
            row = out[name] = {}
            # the payloads: the mesh's (its ranks' head slices joined)
            # against the one-card prefill tier's, and the planted fault
            mine = held_payload(torch, model, prompt, DISAGG_TP_TOKENS,
                                rt=mesh_pre)
            ref = held_payload(torch, pre, prompt, DISAGG_TP_TOKENS)
            rev = dict(mine, blocks=join_heads([
                payload_heads(mine["blocks"], r, DISAGG_TP)
                for r in reversed(range(DISAGG_TP))]))
            row["payload_err"] = payload_error(torch, mine, ref, n)
            row["payload_err_fault"] = payload_error(torch, rev, ref, n)
            for direction, src, dst in (("mesh->one", mesh_pre, dec.disagg),
                                        ("one->mesh", pre.disagg, mesh_dec)):
                d_eng = dst.engine
                steps0 = d_eng.sched.decode_device_steps
                if d_eng is eng:
                    eng.tp_status(reset_launches=True)
                else:
                    pa.paged_decode_attention.launches = 0
                    pa.paged_decode_attention_quant.launches = 0
                hid = f"5dt-{tag}-{name}-{direction}"
                sent0 = src.stats.get("bytes_sent_total")
                res = src.prefill_and_migrate(prompt, sampling, dst.kv_addr,
                                              hid)
                if res.get("status") != "migrated":
                    raise SystemExit(f"phase 5dt {tag} {name} {direction}: "
                                     f"{res}")
                got = dst.collect(hid)
                steps = d_eng.sched.decode_device_steps - steps0
                if d_eng is eng:
                    launches = [r["launches"] for r in eng.tp_status()]
                else:
                    launches = [{"paged_decode_attention":
                                 pa.paged_decode_attention.launches,
                                 "paged_decode_attention_quant":
                                 pa.paged_decode_attention_quant.launches}]
                exact, worst = tie_margin(torch, params, cfg, prompt,
                                          got["tokens"])
                t = res["timings"]
                row[direction] = {
                    "blocks": res["migrated_blocks"],
                    "frame_bytes": src.stats.get("bytes_sent_total")
                    - sent0,
                    "export_s": t["export_s"], "transfer_s": t["transfer_s"],
                    "inject_to_first_commit_s":
                        got["timings"].get("inject_to_first_commit_s"),
                    "decode_steps": steps,
                    "launches": [x[kern] for x in launches],
                    "exact_argmax": exact, "worst_margin": worst}
                log(f"phase 5dt {tag} {name} {direction}: {row[direction]}")
                want = cfg.n_layers * steps
                if (len(got["tokens"]) != DISAGG_TP_TOKENS
                        or res["migrated_blocks"] != want_blocks):
                    raise SystemExit(f"phase 5dt {tag} {name} {direction}: "
                                     "token count or migrated blocks wrong")
                if want == 0 or any(x[kern] != want or x[off] != 0
                                    for x in launches):
                    raise SystemExit(f"phase 5dt {tag} {name} {direction}: "
                                     f"the decode side did not run {kern} "
                                     f"n_layers x {steps} times (on every "
                                     "rank)")
                if worst > TIE_TOL:
                    raise SystemExit(f"phase 5dt {tag} {name} {direction}: "
                                     "the stream disagrees with the "
                                     "unsharded forward")
            log(f"phase 5dt {tag} {name}: payload rms error against the "
                f"one-card payload {row['payload_err']!r} (limit "
                f"{DISAGG_TP_PAYLOAD_MAX[tag]}); the planted fault (head "
                f"slices "
                f"joined in reverse) {row['payload_err_fault']!r}; 5d's "
                f"one-card export / transfer / inject-to-first-commit "
                f"{one_rows[name]['export_s']!r} / "
                f"{one_rows[name]['transfer_s']!r} / "
                f"{one_rows[name]['inject_to_first_commit_s']!r} s")
            if not (row["payload_err"] <= DISAGG_TP_PAYLOAD_MAX[tag]
                    < row["payload_err_fault"]):
                raise SystemExit(f"phase 5dt {tag} {name}: the mesh's "
                                 "payload is off the one-card payload, or "
                                 "the limit cannot see the planted fault")
        check_ranks_agree(eng)
        idle = [r["blocks_in_use"] for r in eng.tp_status()]
        if any(idle):
            raise SystemExit(f"phase 5dt {tag}: blocks still in use on the "
                             f"ranks after every hand-off: {idle}")
    finally:
        mesh_dec.receiver.close()
        model.unload()
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 5dt {tag}: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_one": sum(out[n]["mesh->one"]["launches"][0]
                                for n in prompts),
            "launches_per_rank": [sum(out[n]["one->mesh"]["launches"][r]
                                      for n in prompts)
                                  for r in range(DISAGG_TP)],
            "rows": out}


def disagg_races(torch, pre, dec) -> None:
    """Phase 5d's wire cases: a duplicate ``kv`` frame injects once, and a
    ``release`` frame frees the decode side's blocks."""
    from kubeflow_tpu_torch.serving.disagg import KVMigrator, MigrationStats

    rd, eng = dec.disagg, dec.engine
    prompt = list(range(1, 200))
    payload = held_payload(torch, pre, prompt, 8)
    mig = KVMigrator(MigrationStats())
    inj0 = rd.stats.get("handoffs_injected_total")
    dup0 = rd.stats.get("duplicate_deliveries_total")
    ok = [mig.send(rd.kv_addr, "dup-1", payload)[0] for _ in range(2)]
    res = rd.collect("dup-1")
    dup_ok = (all(ok) and rd.stats.get("handoffs_injected_total") == inj0 + 1
              and rd.stats.get("duplicate_deliveries_total") == dup0 + 1
              and len(res.get("tokens", ())) == 8)
    payload = held_payload(torch, pre, prompt, 400)
    rel0 = rd.stats.get("releases_total")
    sent = mig.send(rd.kv_addr, "rel-1", payload)[0]
    released = mig.release(rd.kv_addr, "rel-1")
    freed = wait_for(lambda: rd.stats.get("releases_total") == rel0 + 1
                     and not eng.has_work())
    free_ok = (sent and released and freed and not eng._active
               and eng.paged.reclaimable_blocks == eng.paged.num_blocks - 1)
    log(f"phase 5d: duplicate kv frame injected once: {dup_ok}; release "
        f"frame freed the decode side's blocks: {free_ok} (reclaimable "
        f"{eng.paged.reclaimable_blocks} of {eng.paged.num_blocks - 1})")
    if not (dup_ok and free_ok):
        raise SystemExit("phase 5d: duplicate delivery or release failed")


def disagg_phase(torch, pa) -> dict:
    """Phase 5d: bf16, then int8 KV, over the same two weight copies of
    llama3_8b's widths at DISAGG_LAYERS layers (seed 0)."""
    from kubeflow_tpu_torch.serving.scheduler import QuantConfig

    t0 = time.perf_counter()
    cfg, params = llama3_8b(torch, DISAGG_LAYERS)
    params2 = tree_clone(params)        # the decode tier's own weights
    out = {"bf16": disagg_run(torch, pa, cfg, params, params2, "bf16", None),
           "int8": disagg_run(torch, pa, cfg, params, params2, "int8",
                              QuantConfig(kv_dtype="int8"))}
    del params, params2
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 5d: {time.perf_counter() - t0:.1f} s")
    return out


def free_card(torch) -> None:
    """Hand the memory of everything no longer referenced back."""
    gc.collect()
    torch.cuda.empty_cache()


def moe_serving(torch, pa) -> dict:
    """Phase 5m: MoE serving at Mixtral-8x7B's published widths, 16 of
    its 32 layers (module docstring)."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.serving.llm import LLMEngine
    from kubeflow_tpu_torch.serving.quant import resolve_quant
    from kubeflow_tpu_torch.serving.runtime import quant_from_env
    from kubeflow_tpu_torch.tools.decode_profile import (
        dispatch_readings, fill_batch,
    )
    from kubeflow_tpu_torch.tools.moe_quality import (
        ENGINE_KW, SEED, mixtral_8x7b, readings,
    )
    from kubeflow_tpu_torch.tools.tp_quality import reference_streams

    t_phase = time.perf_counter()
    log(f"phase 5m: {torch.cuda.memory_allocated()} B allocated at its "
        f"start")
    cfg = mixtral_8x7b()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = llama.init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_bytes = tree_bytes(params)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"phase 5m: Mixtral-8x7B widths, {cfg.n_layers} of 32 layers, "
        f"{cfg.n_experts} experts top-{cfg.moe_top_k}, dropless: "
        f"{tree_numel(params)} params bf16 ({n_bytes} B), init "
        f"{time.perf_counter() - t_phase:.1f} s; a decode step reads every "
        f"weight: bound {bound_ms!r} ms at 3.35 TB/s")

    # (a) the four requests over HTTP, through load()'s captured program
    model = LLMModel("mixtral-8x7b", params, cfg, max_batch=8,
                     max_seq=1024, device="cuda")
    model.load()
    replays0 = captured(model)
    run = serve_four(torch, pa, model, cfg)
    replayed(model, replays0, "phase 5m (a)")
    row1 = run["launches"]["paged_decode_attention"]
    if row1 != cfg.n_layers * run["device_steps"] or row1 == 0 \
            or run["launches"]["paged_decode_attention_quant"] != 0:
        raise SystemExit("phase 5m: decode did not run through the paged "
                         "kernel")
    model.unload()

    # (b) an eager engine against a captured one, the same drive
    prompts = dict(four_prompts(torch, cfg))
    rng = torch.Generator().manual_seed(4)
    prompts["fifth"] = torch.randint(1, cfg.vocab_size, (150,),
                                     generator=rng).tolist()
    eager = LLMEngine(params, cfg, device="cuda", **ENGINE_KW)
    graph = LLMEngine(params, cfg, device="cuda", **ENGINE_KW)
    graph.precompile()
    steps0 = eager.sched.decode_device_steps + graph.sched.decode_device_steps
    pa.paged_decode_attention.launches = 0
    res = {name: graph_streams(eng, prompts)[0]
           for name, eng in (("eager", eager), ("graph", graph))}
    b_launches = pa.paged_decode_attention.launches
    b_steps = (eager.sched.decode_device_steps
               + graph.sched.decode_device_steps - steps0)
    same = all(res["eager"][t][0] == res["graph"][t][0] for t in prompts)
    lp_diff = max(abs(a - b) for t in prompts for a, b in zip(
        res["eager"][t][1], res["graph"][t][1]))
    log(f"phase 5m (b): {len(prompts)} streams of {GRAPH_TOKENS} greedy "
        f"tokens, eager against {graph.decode_graph.replays} replays: token "
        f"for token equal {same}, largest logprob difference {lp_diff!r} "
        f"(want 0.0); row 1 launches {b_launches} (n_layers x device steps "
        f"= {cfg.n_layers * b_steps})")
    if not same or lp_diff != 0.0 or graph.decode_graph.replays == 0 \
            or b_launches != cfg.n_layers * b_steps:
        raise SystemExit("phase 5m (b): the replayed MoE decode differs "
                         "from the eager one")

    # (c) one served stream teacher-forced against the full forward
    tag = "short_100"
    q = readings(eager, run["prompts"][tag], run["results"][tag])
    log(f"phase 5m (c): {tag} and its {len(run['results'][tag])} served "
        f"tokens, the "
        f"serving path against llama.forward (capacity path, no drops) "
        f"with the serving path's routing: rms/rms {q['rms_over_rms']!r} "
        f"(limit {MOE_RMS_MAX}; the planted fault, gates not renormalised "
        f"on the dropless path, read {MOE_RMS_FAULT}), max logit "
        f"difference {q['max_logit_diff']!r}; free routing: rms/rms "
        f"{q['free_rms_over_rms']!r}, greedy agreement "
        f"{q['greedy_agreement']!r}, routing decisions differing "
        f"{q['routing_flips']} of {q['routing_decisions']}")
    if not q["rms_over_rms"] <= MOE_RMS_MAX:
        raise SystemExit("phase 5m (c): the MoE decode path's logits are "
                         "off the full forward's")
    # phase 5n's reference: two seeded streams teacher-forced through this
    # one-card engine (tools/moe_quality.tp_readings' method)
    tp_streams = reference_streams(eager, cfg.vocab_size)
    tp_base = eager.teacher_forced_logits(tp_streams).cpu()

    # (e) eight 300-token streams decoding, eager then replay
    dispatch = {}
    for name, eng in (("eager", eager), ("graph", graph)):
        fill_batch(eng, STEP_CONTEXT, GRAPH_FILL_TOKENS)
        r = dispatch[name] = dispatch_readings(eng, GRAPH_DISPATCHES)
        log(f"phase 5m (e) {name}: {r['wall_ms_per_step']!r} ms per step "
            f"wall, {r['device_busy_ms_per_step']!r} ms device busy, idle "
            f"share {r['device_idle_share']!r}, API launches per step "
            f"{r['api_launches_per_step']!r} "
            f"{r['api_launches_by_name_per_step']}; weight-read bound "
            f"{bound_ms!r} ms ({r['wall_ms_per_step'] / bound_ms!r} x)")
        for req in list(eng._active.values()):
            eng.abort([req])
        while eng.has_work():
            eng.step()
    capture = (graph.decode_graph.capture_seconds,
               graph.decode_graph.pool_bytes)
    del eager, graph
    free_card(torch)

    # (d) int8 KV + int8 weights from the env: the weights downgrade
    quant = quant_from_env({"KFT_QUANT_KV": "int8",
                            "KFT_QUANT_WEIGHTS": "int8"})
    _, downgrades = resolve_quant(quant, cfg=cfg)
    model = LLMModel("mixtral-8x7b-int8kv", params, cfg, max_batch=8,
                     max_seq=1024, device="cuda", quant=quant)
    model.load()
    replays0 = captured(model)
    qrun = serve_four(torch, pa, model, cfg)
    replayed(model, replays0, "phase 5m (d)")
    stats, launches = qrun["stats"], qrun["launches"]
    want = cfg.n_layers * qrun["device_steps"]
    log(f"phase 5m (d): KFT_QUANT_KV=int8 KFT_QUANT_WEIGHTS=int8 -> active "
        f"{stats['quant']['active']} (requested "
        f"{stats['quant']['requested']}), downgrades {downgrades}; row 2 "
        f"launches {launches['paged_decode_attention_quant']} (want "
        f"{want}), row 1 {launches['paged_decode_attention']} (want 0)")
    if downgrades != [("weight_dtype=int8", MOE_INT8_REASON)] \
            or stats["quant_downgrades_total"] != 1 \
            or stats["quant"]["active"] != "quant=kv:int8,w:none":
        raise SystemExit("phase 5m (d): the MoE weights were not downgraded "
                         "with the JAX reason")
    if launches["paged_decode_attention_quant"] != want or want == 0 \
            or launches["paged_decode_attention"] != 0:
        raise SystemExit("phase 5m (d): int8 KV decode did not run through "
                         "the fused-dequant kernel alone")
    model.unload()
    del model, params
    free_card(torch)
    log(f"phase 5m: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": row1 + b_launches,
            "int8_launches": launches["paged_decode_attention_quant"],
            "quality": q, "dispatch": dispatch, "bound_ms": bound_ms,
            "capture": capture, "weight_bytes": n_bytes,
            "tp_streams": tp_streams, "tp_base": tp_base}


def moe_tp_one(torch, pa, cfg, mesh, tag: str) -> dict:
    """Serve phase 4's four requests over HTTP from an LLMModel of
    ``cfg`` (phase 5m's seeded bf16 weights, each rank drawing its shard)
    under ``mesh``: 32 greedy tokens each, every rank's row 3 launches
    (the paged kernel on its own KV heads) == n_layers x decode device
    steps, every rank's sampling bodies and token digest equal. Returns
    the model (loaded) with the run."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import LLMModel
    from kubeflow_tpu_torch.tools.moe_quality import SEED
    from kubeflow_tpu_torch.tools.tp_quality import TP_KW

    t0 = time.perf_counter()
    model = LLMModel(f"mixtral-8x7b-{tag}",
                     llama.SeededParams(SEED, torch.bfloat16), cfg,
                     mesh=mesh, **TP_KW)
    model.load()
    eng = model.engine
    ranks = eng.tp_status()
    log(f"{tag}: engine up in {time.perf_counter() - t0:.1f} s (spawn, "
        f"rendezvous, each rank drawing its shard): ranks (rank, device, "
        f"local KV heads) "
        f"{[(r['rank'], r['device'], r['kv_heads']) for r in ranks]}, "
        f"rank 0's weights {tree_bytes(eng.params)} B (w_gate "
        f"{tuple(eng.params['layers']['w_gate'].shape)}), pool "
        f"{pool_bytes(eng.cache)} B")
    run = serve_four(torch, pa, model, cfg)
    stats, sched = run["stats"], run["stats"]["sched"]
    want = cfg.n_layers * run["device_steps"]
    log(f"{tag}: launches per rank {run['launches']} (want "
        f"paged_decode_attention == n_layers x device steps = {want} on "
        f"every rank); mesh {stats['mesh']}")
    if want == 0 or any(r["paged_decode_attention"] != want
                        or r["paged_decode_attention_quant"] != 0
                        for r in run["launches"]):
        raise SystemExit(f"{tag}: the MoE decode did not run through row 3 "
                         "on every rank")
    check_ranks_agree(eng, sched["decode_dispatches_total"]
                      + stats["prefill_dispatches_total"]
                      + sched["chunked_admitted_total"])
    return model, run


def moe_tp_serving(torch, pa, ref: dict) -> dict:
    """Phase 5n: phase 5m's Mixtral cut under KFT_MESH=tensor=MOE_TP
    (module docstring), after phase 5m's weights are freed."""
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env
    from kubeflow_tpu_torch.tools.moe_quality import (
        mixtral_8x7b, tp_readings,
    )
    from kubeflow_tpu_torch.tools.tp_quality import tp_devices

    t_phase = time.perf_counter()
    free_card(torch)
    cfg = mixtral_8x7b()
    mesh = mesh_from_topology_env({"KFT_MESH": f"tensor={MOE_TP}"},
                                  devices=tp_devices(MOE_TP))
    shared = (", both ranks on one card: no tensor-parallel speedup"
              if mesh.shared else "")
    log(f"phase 5n: Mixtral-8x7B widths, {cfg.n_layers} of 32 layers, "
        f"dropless, KFT_MESH=tensor={MOE_TP} over "
        f"{[str(d) for d in mesh.devices]} ({mesh.backend}{shared}); "
        f"{torch.cuda.memory_allocated()} B allocated at its start")
    model, run = moe_tp_one(torch, pa, cfg, mesh, f"tp{MOE_TP}")
    eng = model.engine
    err = tp_readings(eng, ref["tp_streams"], ref["tp_base"])
    log(f"phase 5n: tensor={MOE_TP} against phase 5m's one-card engine, "
        f"teacher-forced ({len(ref['tp_streams'])} streams, "
        f"{err['positions']} positions): greedy-token agreement "
        f"{err['greedy_token_agreement']!r}, max logit drift "
        f"{err['max_logit_drift']!r}, rms logit error "
        f"{err['rms_logit_error']!r} (limit {MOE_TP_RMS_MAX})")
    step_ms = served_step_ms(torch, model)
    check_ranks_agree(eng)
    log(f"phase 5n: decode step as served (batch 8, {cfg.n_layers} layers, "
        f"~{STEP_CONTEXT}-token contexts, one dispatch per "
        f"{eng.decode_chunk} steps, {mesh.backend}): {step_ms!r} ms "
        f"({nvidia_smi_line()}); {run['tok_s']!r} generated tok/s over "
        f"HTTP; {time.perf_counter() - t_phase:.1f} s")
    model.unload()
    del model, eng
    free_card(torch)
    if not err["rms_logit_error"] <= MOE_TP_RMS_MAX:
        raise SystemExit("phase 5n: the tensor-parallel MoE logits err past "
                         "the limit")
    return {"launches_per_rank": [r["paged_decode_attention"]
                                  for r in run["launches"]],
            "errors": err, "decode_ms_per_step": step_ms,
            "tok_s": run["tok_s"]}


def moe_ep_serving(torch, pa, ref: dict, tp_ms: float) -> dict:
    """Phase 5e: phase 5m's Mixtral cut under KFT_MESH=expert=MOE_EP,
    tensor=MOE_EP_TP (module docstring), after phase 5n's mesh is
    freed."""
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env
    from kubeflow_tpu_torch.tools.moe_quality import (
        mixtral_8x7b, tp_readings,
    )
    from kubeflow_tpu_torch.tools.tp_quality import tp_devices

    t_phase = time.perf_counter()
    free_card(torch)
    cfg = mixtral_8x7b()
    n = MOE_EP * MOE_EP_TP
    layout = f"expert={MOE_EP},tensor={MOE_EP_TP}"
    mesh = mesh_from_topology_env({"KFT_MESH": layout},
                                  devices=tp_devices(n))
    log(f"phase 5e: Mixtral-8x7B widths, {cfg.n_layers} of 32 layers, "
        f"dropless, KFT_MESH={layout} over {[str(d) for d in mesh.devices]}"
        f" ({mesh.backend}"
        + (", all ranks on one card: no speedup" if mesh.shared else "")
        + f"); {torch.cuda.memory_allocated()} B allocated at its start")
    model, run = moe_tp_one(torch, pa, cfg, mesh, f"ep{MOE_EP}tp{MOE_EP_TP}")
    eng = model.engine
    ranks = eng.tp_status()
    coords = [(r["expert_index"], r["tensor_index"]) for r in ranks]
    w_gate = tuple(eng.params["layers"]["w_gate"].shape)
    log(f"phase 5e: (expert, tensor) index per rank {coords}; rank 0's "
        f"w_gate {w_gate} ({cfg.n_experts // MOE_EP} experts, mlp "
        f"{cfg.mlp_dim // MOE_EP_TP})")
    if coords != [(r // MOE_EP_TP, r % MOE_EP_TP) for r in range(n)] \
            or w_gate[1:] != (cfg.n_experts // MOE_EP, cfg.dim,
                              cfg.mlp_dim // MOE_EP_TP):
        raise SystemExit("phase 5e: the ranks do not hold their experts")
    err = tp_readings(eng, ref["tp_streams"], ref["tp_base"])
    log(f"phase 5e: {layout} against phase 5m's one-card engine, "
        f"teacher-forced ({len(ref['tp_streams'])} streams, "
        f"{err['positions']} positions): greedy-token agreement "
        f"{err['greedy_token_agreement']!r}, max logit drift "
        f"{err['max_logit_drift']!r}, rms logit error "
        f"{err['rms_logit_error']!r} (limit {MOE_EP_RMS_MAX})")
    step_ms = served_step_ms(torch, model)
    check_ranks_agree(eng)
    log(f"phase 5e: decode step as served (batch 8, {cfg.n_layers} layers, "
        f"~{STEP_CONTEXT}-token contexts, one dispatch per "
        f"{eng.decode_chunk} steps, {mesh.backend}): {step_ms!r} ms against "
        f"phase 5n's tensor={MOE_TP} {tp_ms!r} ms ({nvidia_smi_line()}); "
        f"{run['tok_s']!r} generated tok/s over HTTP; "
        f"{time.perf_counter() - t_phase:.1f} s")
    model.unload()
    del model, eng
    free_card(torch)
    if not err["rms_logit_error"] <= MOE_EP_RMS_MAX:
        raise SystemExit("phase 5e: the expert x tensor MoE logits err past "
                         "the limit")
    return {"launches_per_rank": [r["paged_decode_attention"]
                                  for r in run["launches"]],
            "errors": err, "decode_ms_per_step": step_ms,
            "tok_s": run["tok_s"]}


def moe_tp_full(torch, pa) -> dict:
    """Phase 5x: Mixtral-8x7B at all 32 layers under
    tensor=MOE_TP_FULL, then expert=MOE_EP,tensor=MOE_EP_TP, one card a
    rank over NCCL (module docstring). Skipped, and said so, on a machine
    with fewer cards."""
    from kubeflow_tpu_torch.parallel.mesh import mesh_from_topology_env
    from kubeflow_tpu_torch.tools.moe_quality import mixtral_8x7b

    n = torch.cuda.device_count()
    if n < MOE_TP_FULL:
        log(f"phase 5x: skipped: Mixtral-8x7B at 32 layers under tensor="
            f"{MOE_TP_FULL} needs {MOE_TP_FULL} cards, one a rank; this "
            f"machine has {n}")
        return {"skipped": f"{n} card(s)", "launches_per_rank": []}
    t_phase = time.perf_counter()
    free_card(torch)
    cfg = mixtral_8x7b(32)
    log(f"phase 5x: Mixtral-8x7B at all {cfg.n_layers} layers (93.4 GB "
        f"bf16), dropless, tensor={MOE_TP_FULL}, then expert={MOE_EP},"
        f"tensor={MOE_EP_TP}, a card a rank")
    out = {"launches_per_rank": []}
    for layout in (f"tensor={MOE_TP_FULL}",
                   f"expert={MOE_EP},tensor={MOE_EP_TP}"):
        mesh = mesh_from_topology_env({"KFT_MESH": layout})
        log(f"phase 5x {layout}: over {[str(d) for d in mesh.devices]} "
            f"({mesh.backend}), eager")
        model, run = moe_tp_one(torch, pa, cfg, mesh, f"5x-{layout}")
        step_ms = served_step_ms(torch, model)
        check_ranks_agree(model.engine)
        log(f"phase 5x {layout}: decode step as served (batch 8, all "
            f"{cfg.n_layers} layers, ~{STEP_CONTEXT}-token contexts): "
            f"{step_ms!r} ms; {run['tok_s']!r} generated tok/s over HTTP; "
            f"{time.perf_counter() - t_phase:.1f} s ({nvidia_smi_line()})")
        model.unload()
        del model
        free_card(torch)
        out["launches_per_rank"] += [r["paged_decode_attention"]
                                     for r in run["launches"]]
        out[layout] = {"decode_ms_per_step": step_ms, "tok_s": run["tok_s"]}
    return out


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    return tree.clone()


# ---------------------------------------------------------------------------
# Flash attention (training slice)
# ---------------------------------------------------------------------------

def flash_err(torch, out, ref) -> tuple:
    """(max abs error, within the limit) of a float32 kernel output."""
    err = (out.float() - ref.float()).abs().max().item()
    return err, bool(torch.isfinite(out).all()) and err <= FLASH_F32_TOL


def flash_parity(torch) -> dict:
    """Each flash kernel against its plain version; returns the max abs
    errors at the training shape in bf16, against the plain version that
    rounds P and dS where the kernel does."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.tools import flash_parity as fp

    train_errs = {}
    for name, b, s, h, kvh, d, causal in fp.SHAPES:
        shape = (f"{name} (B={b} S={s} H={h} KV_H={kvh} D={d} "
                 f"causal={causal})")
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype).split(".")[-1]
            case = fp.flash_case(b, s, h, kvh, d, causal, dtype)
            checks = {}
            if dtype == torch.float32:
                q, k, v = case[:3]
                got = fa.flash_attention_fwd(q, k, v, causal)
                torch.cuda.synchronize()
                # (O, plain O) and (lse, plain lse)
                checks["flash_attention_fwd"] = list(zip(
                    got, fa.flash_attention_fwd_reference(q, k, v, causal)))
                dq = fa.flash_attention_dq(*case, causal)
                dk, dv = fa.flash_attention_dkv(*case, causal)
                torch.cuda.synchronize()
                ref_dk, ref_dv = fa.flash_attention_dkv_reference(*case,
                                                                  causal)
                checks["flash_attention_dq"] = [
                    (dq, fa.flash_attention_dq_reference(*case, causal))]
                checks["flash_attention_dkv"] = [(dk, ref_dk), (dv, ref_dv)]
            for kernel, pairs in checks.items():
                results = [flash_err(torch, out, ref) for out, ref in pairs]
                err = max(e for e, _ in results)
                log(f"parity {kernel} {shape} {tag}: max_abs_err {err!r} "
                    f"(f32 limit {FLASH_F32_TOL!r})")
                if not all(good for _, good in results):
                    raise SystemExit(f"{kernel} {name} {tag} disagrees with "
                                     "its plain version")
            if dtype == torch.bfloat16:
                readings = {**fp.forward_readings(case, causal),
                            **fp.backward_readings(case, causal)}
                for kernel, r in readings.items():
                    log(f"parity {kernel} {shape} {tag}: {fp.describe(r)}")
                    if not fp.passes(r):
                        raise SystemExit(f"{kernel} {name} {tag} is outside "
                                         "limit (a) or (b)")
                    if name == "train":
                        train_errs[kernel] = r["max_abs_err"]
            del case, checks
            torch.cuda.empty_cache()
    return train_errs


def flash_bounds(b, s, h, kvh, d, causal) -> dict:
    """Least time of each flash kernel at this shape in bf16: the larger
    of its FLOPs over the bf16 tensor-core peak and its bytes over
    3.35 TB/s (``flash_attention.kernel_work`` counts both)."""
    from kubeflow_tpu_torch.ops.flash_attention import kernel_work

    out = {}
    for name, (flops, nbytes) in kernel_work(b, s, h, kvh, d,
                                             causal).items():
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        out[name] = {"flops": flops, "bytes": nbytes,
                     "bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"}
    return out


def flash_timing(torch) -> dict:
    import torch.nn.functional as F

    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.tools import flash_parity as fp

    name, b, s, h, kvh, d, causal = fp.SHAPES[0]
    q, k, v, do, lse, delta = fp.flash_case(b, s, h, kvh, d, causal,
                                            torch.bfloat16, seed=1)
    calls = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal),
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal)),
        "flash_attention_dq": (
            lambda: fa.flash_attention_dq(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_attention_dq_reference(q, k, v, do, lse, delta,
                                                    causal)),
        "flash_attention_dkv": (
            lambda: fa.flash_attention_dkv(q, k, v, do, lse, delta, causal),
            lambda: fa.flash_attention_dkv_reference(q, k, v, do, lse,
                                                     delta, causal)),
    }
    # yardstick only, never called by the port: SDPA over [B, H, S, D]
    # copies, forward, and backward (which computes dQ, dK and dV at once)
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    out_s = sdpa()
    sdpa_bwd = lambda: torch.autograd.grad(out_s, (qs, ks, vs), dos,
                                           retain_graph=True)
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(torch, sdpa, reps=20)
    sdpa_bwd_ms = time_ms(torch, sdpa_bwd, reps=20)
    bounds = flash_bounds(b, s, h, kvh, d, causal)
    out = {}
    for kernel, (run, plain) in calls.items():
        kernel_ms = time_ms(torch, run, reps=20)
        plain_ms = time_ms(torch, plain, reps=5)
        bd = bounds[kernel]
        library_ms = sdpa_fwd_ms if kernel.endswith("fwd") else sdpa_bwd_ms
        log(f"timing {kernel} bf16 (B={b} S={s} H={h} KV_H={kvh} D={d} "
            f"causal): kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, "
            f"bound {bd['bound_ms']!r} ms ({bd['bound_by']}: {bd['flops']} "
            f"FLOP, {bd['bytes']} B), roofline share "
            f"{bd['bound_ms'] / kernel_ms!r}; SDPA "
            f"{'forward' if kernel.endswith('fwd') else 'backward (dQ+dK+dV)'}"
            f" {library_ms!r} ms (yardstick only)")
        out[kernel] = {"ms": kernel_ms, "plain_ms": plain_ms,
                       "bound_ms": bd["bound_ms"],
                       "bound_by": bd["bound_by"],
                       "library_ms": library_ms}
    del q, k, v, do, lse, delta, qs, ks, vs, dos, out_s
    torch.cuda.empty_cache()
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def kernel_vs_plain(torch, llama, params, cfg, batch) -> None:
    """One micro batch's loss and gradients through the flash kernels and
    through attn_impl="xla" (plain einsum attention), same parameters."""
    import dataclasses

    from kubeflow_tpu_torch.training import lm_loss_fn

    names, leaves = zip(*_leaves(params))
    res = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        loss, _ = lm_loss_fn(llama.forward, c)(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        res[impl] = (loss.item(), grads)
        del loss
    (l_k, g_k), (l_p, g_p) = res["pallas"], res["xla"]
    worst_cos, worst_name = 1.0, ""
    for name, a, b in zip(names, g_k, g_p):
        cos = torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0).item()
        if cos < worst_cos:
            worst_cos, worst_name = cos, name
    norm_k = torch.sqrt(sum((g.double() ** 2).sum() for g in g_k)).item()
    norm_p = torch.sqrt(sum((g.double() ** 2).sum() for g in g_p)).item()
    log(f"kernel vs plain (one micro batch, full width): loss {l_k!r} vs "
        f"{l_p!r} (rel {abs(l_k - l_p) / abs(l_p)!r}, limit "
        f"{TRAIN_LOSS_RTOL}); worst gradient cosine {worst_cos!r} "
        f"({worst_name}, limit > {TRAIN_COS_MIN}); global norms "
        f"{norm_k!r} vs {norm_p!r} (limit {TRAIN_NORM_SHARE} share)")
    if abs(l_k - l_p) > TRAIN_LOSS_RTOL * abs(l_p) \
            or worst_cos <= TRAIN_COS_MIN \
            or abs(norm_k - norm_p) > TRAIN_NORM_SHARE * norm_p:
        raise SystemExit("the flash kernels' training step disagrees with "
                         "plain attention")


def train_run(torch, trainer, cfg, steps, precompile, batches=None,
              tag=None, **fit_kw) -> dict:
    """Train ``trainer`` through ``fit`` up to step ``steps`` over
    ``batches`` (a ``start_step -> iterator`` callable; default
    synthetic_lm_batches), after ``precompile(first batch)`` when asked;
    ``fit_kw`` go to ``fit`` (its checkpoint arguments). Per step the
    host seconds (each ending in a synchronize), loss and grad norm; peak
    memory; the flash launches the steps made (the counts set to 0 just
    before ``fit``); ``fit``'s ``resumed_from``."""
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training import synthetic_lm_batches
    from kubeflow_tpu_torch.training.loop import fit

    if batches is None:
        def batches(start):
            return synthetic_lm_batches(cfg.vocab_size, TRAIN_BATCH,
                                        TRAIN_SEQ, start_step=start)

    tag = tag or ("replayed" if precompile else "eager")
    out: dict = {"marks": [], "losses": [], "grad_norms": [],
                 "moe_aux": []}
    if precompile:
        outcome = trainer.precompile(next(batches(0)))
        g = trainer.step_graph
        log(f"precompile() -> {outcome!r}: capture {g.capture_seconds!r} s "
            f"(two warm-up steps' bodies, undone, and two captures), graph "
            f"pool {g.pool_bytes} B, kernel launches a replayed step "
            f"{g.launches}")
        if outcome != "no_depot":
            raise SystemExit(f"precompile returned {outcome!r}")
        out.update(outcome=outcome, capture_seconds=g.capture_seconds,
                   pool_bytes=g.pool_bytes)

    def on_step(step, metrics):
        torch.cuda.synchronize()
        out["marks"].append(time.perf_counter())
        out["losses"].append(metrics["loss"])
        out["grad_norms"].append(metrics["grad_norm"])
        if "moe_aux" in metrics:
            out["moe_aux"].append(metrics["moe_aux"])
        log(f"{tag} step {step}: loss {metrics['loss']!r} grad_norm "
            f"{metrics['grad_norm']!r} tokens {metrics['tokens']!r} "
            f"({out['marks'][-1] - out['marks'][-2]!r} s)")

    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq,
               fa.flash_attention_dkv)
    for kernel in kernels:
        kernel.launches = 0                     # the main path's count
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    out["marks"].append(time.perf_counter())
    res = fit(trainer, batches, max_steps=steps, on_step=on_step, **fit_kw)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - out["marks"][0]
    out["resumed_from"] = res.resumed_from
    out["launches"] = {k.__name__: k.launches for k in kernels}
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
    times = [b - a for a, b in zip(out["marks"], out["marks"][1:])]
    out["times"] = times
    out["step_s"] = statistics.median(times[1:] or times)
    out["tok_s"] = TRAIN_BATCH * TRAIN_SEQ / out["step_s"]
    out["mfu"] = out["tok_s"] * cfg.flops_per_token(TRAIN_SEQ) / BF16_FLOPS
    log(f"training, {tag}: step {out['step_s']!r} s (timed steps "
        f"{times[1:]!r}, warm-up {times[0]!r}), {out['tok_s']!r} tok/s, MFU "
        f"{out['mfu']!r} against 989 TFLOP/s bf16 ({nvidia_smi_line()}), "
        f"peak memory {out['peak_bytes']} B allocated "
        f"({out['peak_bytes'] / 2 ** 30:.2f} GiB), "
        f"{out['peak_reserved_bytes']} B reserved, losses {out['losses']!r}")
    return out


def training(torch) -> dict:
    import math

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.training import (
        Trainer, TrainerConfig, lm_loss_fn, synthetic_lm_batches, to_device,
    )

    cfg = llama.llama_1b(remat="dots", attn_impl="pallas")
    config = TrainerConfig(learning_rate=3e-4, warmup_steps=10,
                           total_steps=1000, grad_accum=TRAIN_ACCUM,
                           optimizer="adafactor")

    def make_trainer():
        trainer = Trainer(lambda g: llama.init_params(g, cfg, device="cuda"),
                          lm_loss_fn(llama.forward, cfg), config,
                          device="cuda")
        trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
        return trainer

    t0 = time.perf_counter()
    trainer = make_trainer()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in _leaves(trainer.params))
    log(f"llama_1b: {n_params} params f32, bf16 compute, remat=dots, "
        f"attn_impl=pallas, adafactor; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"grad_accum {TRAIN_ACCUM}; init {time.perf_counter() - t0:.1f} s")
    run = train_run(torch, trainer, cfg, TRAIN_STEPS, precompile=True)
    launches, losses = run["launches"], run["losses"]
    micro = TRAIN_ACCUM * TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * cfg.n_layers * micro,
            "flash_attention_dq": cfg.n_layers * micro,
            "flash_attention_dkv": cfg.n_layers * micro}
    log(f"flash launches on the main path (the replays): {launches} "
        f"(expected per micro batch 2 x n_layers / n_layers / n_layers: "
        f"{want}); {trainer.step_graph.replays} replayed steps")
    if launches != want or trainer.step_graph.replays != TRAIN_STEPS:
        raise SystemExit("the training step did not replay the flash "
                         "kernels as expected")
    expect0 = math.log(cfg.vocab_size) + 0.5
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - expect0) > 0.5:
        raise SystemExit(f"losses {losses} not finite or step 0 not within "
                         f"0.5 of ln(vocab) + 1/2 = {expect0}")

    # the same steps eagerly, from the same seed: bitwise the replayed ones
    eager = make_trainer()
    ref = train_run(torch, eager, cfg, TRAIN_STEPS, precompile=False)
    differ = [name for (name, a), b in zip(
        _leaves(trainer.params), (t for _, t in _leaves(eager.params)))
        if not torch.equal(a, b)]
    log(f"replayed vs eager over {TRAIN_STEPS} steps: losses "
        f"{run['losses']!r} vs {ref['losses']!r}, grad norms "
        f"{run['grad_norms']!r} vs {ref['grad_norms']!r}; parameters "
        f"differing: {differ}; eager step {ref['step_s']!r} s against "
        f"replayed {run['step_s']!r} s")
    if run["losses"] != ref["losses"] or differ \
            or run["grad_norms"] != ref["grad_norms"] \
            or ref["launches"] != want:
        raise SystemExit("the replayed training step is not bitwise the "
                         "eager one")
    del eager
    gc.collect()
    torch.cuda.empty_cache()

    batch = to_device(next(synthetic_lm_batches(
        cfg.vocab_size, TRAIN_BATCH // TRAIN_ACCUM, TRAIN_SEQ, seed=1)),
        "cuda")
    kernel_vs_plain(torch, llama, trainer.params, cfg, batch)
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_s": run["step_s"],
            "tok_s": run["tok_s"], "mfu": run["mfu"],
            "peak_bytes": run["peak_bytes"], "losses": losses,
            "eager_step_s": ref["step_s"], "eager_peak_bytes":
            ref["peak_bytes"], "capture_seconds": run["capture_seconds"],
            "pool_bytes": run["pool_bytes"]}


def moe_training(torch) -> dict:
    """Phase 7m: llama_1b with 8 experts (top-2, capacity 1.25),
    MOE_TRAIN_LAYERS of its 16 layers, trained as phase 7 trains
    llama_1b (module docstring)."""
    import dataclasses
    import math

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools.train_profile import model_config
    from kubeflow_tpu_torch.training import (
        Trainer, TrainerConfig, lm_loss_fn,
    )

    t_phase = time.perf_counter()
    log(f"phase 7m: {torch.cuda.memory_allocated()} B allocated at its "
        f"start")
    cfg = dataclasses.replace(model_config(moe=True),
                              n_layers=MOE_TRAIN_LAYERS)
    config = TrainerConfig(learning_rate=3e-4, warmup_steps=10,
                           total_steps=1000, grad_accum=TRAIN_ACCUM,
                           optimizer="adafactor")

    def make_trainer():
        trainer = Trainer(lambda g: llama.init_params(g, cfg, device="cuda"),
                          lm_loss_fn(llama.forward, cfg), config,
                          device="cuda")
        trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
        return trainer

    # eager first; its results kept on the host, then freed, so the two
    # trainers are never resident together
    eager = make_trainer()
    n_params = sum(t.numel() for _, t in _leaves(eager.params))
    log(f"phase 7m: llama_1b widths with {cfg.n_experts} experts "
        f"(top-{cfg.moe_top_k}, capacity {cfg.moe_capacity_factor}), "
        f"{cfg.n_layers} of 16 layers: {n_params} params f32, remat=dots, "
        f"attn_impl=pallas, adafactor; batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
        f"grad_accum {TRAIN_ACCUM}")
    ref = train_run(torch, eager, cfg, TRAIN_STEPS, precompile=False)
    digest = {name: t.detach().cpu() for name, t in _leaves(eager.params)}
    del eager
    free_card(torch)

    trainer = make_trainer()
    run = train_run(torch, trainer, cfg, TRAIN_STEPS, precompile=True)
    launches, losses, aux = run["launches"], run["losses"], run["moe_aux"]
    micro = TRAIN_ACCUM * TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * cfg.n_layers * micro,
            "flash_attention_dq": cfg.n_layers * micro,
            "flash_attention_dkv": cfg.n_layers * micro}
    log(f"phase 7m: flash launches on the main path (the replays): "
        f"{launches} (expected {want}), eager {ref['launches']}; "
        f"{trainer.step_graph.replays} replayed steps")
    if launches != want or ref["launches"] != want \
            or trainer.step_graph.replays != TRAIN_STEPS:
        raise SystemExit("phase 7m: the MoE training step did not run the "
                         "flash kernels as expected")
    expect0 = math.log(cfg.vocab_size) + 0.5 + aux[0]
    log(f"phase 7m: step 0 loss {losses[0]!r} against ln(vocab) + 1/2 + "
        f"moe_aux = {expect0!r}; moe_aux per step {aux!r}")
    if not all(math.isfinite(x) for x in losses + aux) \
            or abs(losses[0] - expect0) > 0.5:
        raise SystemExit(f"phase 7m: losses {losses} not finite or step 0 "
                         f"not within 0.5 of {expect0}")
    differ = [name for name, t in _leaves(trainer.params)
              if not torch.equal(t.detach().cpu(), digest[name])]
    log(f"phase 7m: replayed vs eager over {TRAIN_STEPS} steps: losses "
        f"{losses!r} vs {ref['losses']!r}, grad norms {run['grad_norms']!r} "
        f"vs {ref['grad_norms']!r}, moe_aux {aux!r} vs {ref['moe_aux']!r}; "
        f"parameters differing: {differ}; eager step {ref['step_s']!r} s "
        f"against replayed {run['step_s']!r} s")
    if losses != ref["losses"] or run["grad_norms"] != ref["grad_norms"] \
            or aux != ref["moe_aux"] or differ:
        raise SystemExit("phase 7m: the replayed MoE training step is not "
                         "bitwise the eager one")
    del trainer, digest
    free_card(torch)
    log(f"phase 7m: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "step_s": run["step_s"],
            "tok_s": run["tok_s"], "mfu": run["mfu"],
            "peak_bytes": run["peak_bytes"], "losses": losses,
            "moe_aux": aux, "eager_step_s": ref["step_s"],
            "capture_seconds": run["capture_seconds"],
            "pool_bytes": run["pool_bytes"]}


def free_disk(path) -> int:
    import shutil

    return shutil.disk_usage(path).free


def pod_env(tmp: Path, tag: str, **extra) -> dict:
    """The env the controller stamps on a one-worker training pod (its
    checkpoint, depot, phase, metrics and heartbeat paths under
    ``tmp``), with the repository on PYTHONPATH; the pod runs on the
    card (no KFT_FORCE_PLATFORM)."""
    import os

    d = tmp / tag
    d.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_")}
    env.update({
        "PYTHONPATH": str(Path(__file__).resolve().parent) + os.pathsep
        + env.get("PYTHONPATH", ""),
        "KFT_TRAIN_STEPS": str(POD_STEPS), "KFT_CHECKPOINT_EVERY": "2",
        "KFT_CHECKPOINT_DIR": str(d / "ckpt"), "KFT_DEPOT": str(tmp / "depot"),
        "KFT_PHASES_PATH": str(d / "phases"),
        "KFT_METRICS_PATH": str(d / "metrics.jsonl"),
        "KFT_HEARTBEAT_FILE": str(d / "heartbeat"), **extra})
    return env


def pod_losses(tmp: Path, tag: str) -> dict:
    """step -> loss from the pod's metrics file (the last record of each
    step: a restart's records follow the killed run's)."""
    out = {}
    for line in (tmp / tag / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if "loss" in rec:
            out[rec["step"]] = rec["loss"]
    return out


def pod_phase(torch, tmp: Path) -> dict:
    """Phase 8 (a): the port's training pod on the card, three runs of
    ``python -m kubeflow_tpu_torch.rendezvous.worker_check`` (module
    docstring)."""
    import signal

    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.rendezvous.worker_check"]
    t0 = time.perf_counter()
    # the uninterrupted pod and the victim run side by side
    ref = subprocess.Popen(cmd, env=pod_env(
        tmp, "ref", KFT_PROFILE_DIR=str(tmp / "ref" / "profile"),
        KFT_PROFILE_STEPS="1:2"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ckpt = tmp / "victim" / "ckpt"
    victim = subprocess.Popen(cmd, env=pod_env(
        tmp, "victim", KFT_STEP_SLEEP=str(POD_STEP_SLEEP_S)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.time() + POD_TIMEOUT_S
    while not (ckpt / "2").is_dir():
        if victim.poll() is not None or time.time() > deadline:
            victim.kill()
            ref.kill()
            raise SystemExit("phase 8a: the victim pod ended or stalled "
                             f"before step 2's checkpoint:\n"
                             f"{victim.communicate()[1][-4000:]}")
        time.sleep(0.02)
    victim.send_signal(signal.SIGKILL)
    victim.communicate(timeout=60)
    killed_at = max(pod_losses(tmp, "victim"))
    log(f"phase 8a: victim SIGKILLed after step {killed_at} (rc "
        f"{victim.returncode}), checkpoints {sorted(p.name for p in ckpt.iterdir())}")
    try:
        ref_out, ref_err = ref.communicate(
            timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        ref.kill()
        raise SystemExit("phase 8a: the uninterrupted pod stalled:\n"
                         f"{ref.communicate()[1][-4000:]}")
    log(f"phase 8a: uninterrupted pod rc {ref.returncode} "
        f"({time.perf_counter() - t0:.1f} s, beside the victim): "
        f"{ref_out.strip()!r}")
    if ref.returncode != 0:
        raise SystemExit(f"phase 8a: the pod failed:\n{ref_err[-4000:]}")

    t0 = time.perf_counter()
    restart = subprocess.run(cmd, env=pod_env(
        tmp, "victim", KFT_STEP_SLEEP=str(POD_STEP_SLEEP_S)),
        capture_output=True, text=True, timeout=POD_TIMEOUT_S)
    log(f"phase 8a: restarted pod rc {restart.returncode} "
        f"({time.perf_counter() - t0:.1f} s): {restart.stdout.strip()!r}")
    if restart.returncode != 0:
        raise SystemExit(f"phase 8a: the restart failed:\n"
                         f"{restart.stderr[-4000:]}")
    phases = json.loads((tmp / "victim" / "phases.0").read_text())
    ref_phases = json.loads((tmp / "ref" / "phases.0").read_text())
    depot = json.loads((tmp / "victim" / "phases.depot.0").read_text())
    resumed = int(phases.get("resumed_from_step", -1))
    stamps = ("proc_start", "imports_done", "rendezvous_done",
              "state_init_done", "depot_hit", "compile_done",
              "first_step_done")
    missing = ([k for k in stamps + ("resumed_from_step", "restore_done")
                if k not in phases]
               + [f"ref:{k}" for k in stamps + (
                   "profile_dir", "profile_start", "profile_done")
                  if k not in ref_phases])
    want, got = pod_losses(tmp, "ref"), pod_losses(tmp, "victim")
    after = {s: (got.get(s), want.get(s))
             for s in range(resumed + 1, POD_STEPS + 1)}
    log(f"phase 8a: resumed_from_step {resumed}, depot {depot}, losses "
        f"after the resume (restart, uninterrupted) {after!r}; stamps "
        f"{sorted(phases)}; restart phases (s from proc_start) "
        f"{ {k: round(v - phases['proc_start'], 3) for k, v in phases.items() if k.endswith('_done')} }; "
        f"missing {missing}")
    if not 2 <= resumed <= killed_at or missing \
            or depot != {"compiles": 1, "serialize_failures": 1} \
            or "depot=compiled" not in restart.stdout \
            or f"resumed_from={resumed}" not in restart.stdout \
            or any(a != b or a is None for a, b in after.values()):
        raise SystemExit("phase 8a: the pod did not resume step-exact "
                         "through its captured step")
    return {"resumed_from": resumed, "depot": depot,
            "losses_after_resume": after}


def depot_serving(torch, tmp: Path) -> dict:
    """Phase 8 (c): a serving replica under KFT_DEPOT on the card
    (module docstring)."""
    import dataclasses
    import os

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.serving import (
        InferRequest, InferTensor, LLMModel,
    )

    cfg = dataclasses.replace(llama.llama_tiny(dtype=torch.float32), dim=256,
                              mlp_dim=512)
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    prompt = [5, 6, 7, 8, 9, 10, 11, 12]
    runs = {}
    for tag, depot in (("plain", None), ("depot", tmp / "serving-depot")):
        if depot is not None:
            os.environ["KFT_DEPOT"] = str(depot)
        try:
            model = LLMModel("tiny", params, cfg, max_batch=4, max_seq=128,
                             prefill_buckets=(16,), device="cuda")
            model.load()
        finally:
            os.environ.pop("KFT_DEPOT", None)
        try:
            res = model.predict(InferRequest("tiny", [InferTensor(
                "ids", [1, len(prompt)], "INT32", prompt)],
                parameters={"max_tokens": 24, "temperature": 0.0}))
            st = model.stats()
        finally:
            model.unload()
        runs[tag] = {"tokens": res.as_numpy("tokens")[0].tolist(),
                     "outcome": st["depot_outcome"],
                     "depot": st.get("depot"),
                     "replays": st["decode_graph"]["replays_total"]}
    log(f"phase 8c: a replica loaded under KFT_DEPOT and one without: "
        f"{runs!r}; the depot directory exists: "
        f"{(tmp / 'serving-depot').exists()}")
    plain, dep = runs["plain"], runs["depot"]
    if dep["outcome"] != "compiled" or plain["outcome"] != "no_depot" \
            or dep["depot"] != {"compiles": 1, "serialize_failures": 1} \
            or plain["depot"] is not None or dep["tokens"] != plain["tokens"] \
            or not (dep["replays"] and plain["replays"]) \
            or (tmp / "serving-depot").exists():
        raise SystemExit("phase 8c: a replica under KFT_DEPOT did not load, "
                         "capture and serve as one without it")
    del params
    free_card(torch)
    return runs


def resume_phase(torch) -> dict:
    """Phase 8: the training pod on the card (a) and llama_1b at full
    width resumed into already-captured step graphs (b); module
    docstring."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.training import (
        Trainer, TrainerConfig, TokenDataset, lm_loss_fn, loop,
        write_token_shards,
    )

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="kft-phase8-"))
    disk0 = free_disk(tmp)
    log(f"phase 8: {torch.cuda.memory_allocated()} B allocated at its "
        f"start; scratch {tmp}, {disk0} B free")
    try:
        pod = pod_phase(torch, tmp)

        # (b) the corpus: two shards of 1<<22 tokens, ids < 32768, seed 0
        t0 = time.perf_counter()
        rng = np.random.default_rng(0)
        write_token_shards(str(tmp / "corpus"), (
            rng.integers(0, 32768, 1 << 20, dtype=np.int32)
            for _ in range(8)), shard_tokens=1 << 22, vocab_size=32768)
        ds = TokenDataset(str(tmp / "corpus"), TRAIN_SEQ, seed=0)
        log(f"phase 8b: corpus of {ds.n_windows} windows of "
            f"{TRAIN_SEQ + 1} tokens in "
            f"{sorted(p.name for p in (tmp / 'corpus').iterdir())} "
            f"({time.perf_counter() - t0:.2f} s)")

        def batches(start):
            return ds.batches(TRAIN_BATCH, start_step=start)

        cfg = dataclasses.replace(
            llama.llama_1b(remat="dots", attn_impl="pallas"),
            n_layers=RESUME_LAYERS)
        config = TrainerConfig(learning_rate=3e-4, warmup_steps=10,
                               total_steps=1000, grad_accum=TRAIN_ACCUM,
                               optimizer="adafactor")

        def make_trainer():
            trainer = Trainer(
                lambda g: llama.init_params(g, cfg, device="cuda"),
                lm_loss_fn(llama.forward, cfg), config, device="cuda")
            trainer.init_state(torch.Generator(device="cuda").manual_seed(0))
            return trainer

        # fit's checkpoint managers and restores, recorded for the log
        managers, restores = [], []
        real_mgr, real_restore = loop.CheckpointManager, loop.restore_latest

        class Recorded(real_mgr):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                managers.append(self)

        def timed_restore(trainer, mgr):
            t0 = time.perf_counter()
            step = real_restore(trainer, mgr)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t0)
            return step

        loop.CheckpointManager, loop.restore_latest = Recorded, timed_restore
        try:
            a = make_trainer()
            run_a = train_run(torch, a, cfg, 4, precompile=True,
                              batches=batches, tag="8b A",
                              checkpoint_dir=str(tmp / "a"),
                              checkpoint_every=2)
            final_a = {n: t.detach().cpu() for n, t in _leaves(a.params)}
            mgr_a = managers[-1]
            ckpt_bytes = mgr_a.write_bytes[-1]
            del a
            free_card(torch)
            shutil.rmtree(tmp / "a")

            b = make_trainer()
            run_b = train_run(torch, b, cfg, 2, precompile=True,
                              batches=batches, tag="8b B",
                              checkpoint_dir=str(tmp / "b"),
                              checkpoint_every=2)
            del b
            free_card(torch)

            c = make_trainer()
            c.precompile(next(batches(0)))
            before = {k: t.data_ptr() for k, t in c._state_tensors().items()}
            run_c = train_run(torch, c, cfg, 4, precompile=False,
                              batches=batches, tag="8b C (restored)",
                              checkpoint_dir=str(tmp / "b"),
                              checkpoint_every=2)
            after = {k: t.data_ptr() for k, t in c._state_tensors().items()}
            replays = c.step_graph.replays
            differ = [n for n, t in _leaves(c.params)
                      if not torch.equal(t.detach().cpu(), final_a[n])]
            del c
            free_card(torch)
        finally:
            loop.CheckpointManager, loop.restore_latest = real_mgr, \
                real_restore
        micro = TRAIN_ACCUM
        per_step = {"flash_attention_fwd": 2 * cfg.n_layers * micro,
                    "flash_attention_dq": cfg.n_layers * micro,
                    "flash_attention_dkv": cfg.n_layers * micro}
        want = {run: {k: n * v for k, v in per_step.items()}
                for run, n in (("a", 4), ("b", 2), ("c", 2))}
        launches = {"a": run_a["launches"], "b": run_b["launches"],
                    "c": run_c["launches"]}
        moved = sorted(k for k in before if before[k] != after.get(k))
        log(f"phase 8b: A losses {run_a['losses']!r} grad norms "
            f"{run_a['grad_norms']!r}; C (restored from B's step 2 into "
            f"its captured graphs, resumed_from {run_c['resumed_from']}) "
            f"losses {run_c['losses']!r} grad norms "
            f"{run_c['grad_norms']!r}; parameters differing from A: "
            f"{differ}; state tensors moved by the restore: {moved}; C's "
            f"replays {replays}; flash launches {launches} (expected "
            f"{want})")
        if run_c["resumed_from"] != 2 or replays != 2 or moved or differ \
                or run_c["losses"] != run_a["losses"][2:] \
                or run_c["grad_norms"] != run_a["grad_norms"][2:] \
                or launches != want:
            raise SystemExit("phase 8b: the restored, replayed run is not "
                             "bitwise the uninterrupted one")
        served = depot_serving(torch, tmp)
        saves = [s for m in managers for s in m.save_seconds]
        writes = [(w, n) for m in managers
                  for w, n in zip(m.write_seconds, m.write_bytes)]
        out = {
            "launches": {k: sum(launches[r][k] for r in launches)
                         for k in per_step},
            "ckpt_bytes": ckpt_bytes, "save_s": saves,
            "write_s": [w for w, _ in writes],
            "write_gb_s": [n / w / 1e9 for w, n in writes],
            "restore_s": restores, "step_s": run_a["step_s"],
            "step_times_a": run_a["times"],
            "peak_bytes": max(r["peak_bytes"] for r in (run_a, run_b, run_c)),
            "peak_reserved_bytes": max(r["peak_reserved_bytes"]
                                       for r in (run_a, run_b, run_c)),
            "pod": pod, "served": served,
        }
        log(f"phase 8b: checkpoint {ckpt_bytes} B; save (blocking "
            f"device-to-host copy) {saves!r} s against the replayed step "
            f"{run_a['step_s']!r} s (A's step times {run_a['times']!r}, "
            f"saves after steps 2 and 4); background write {out['write_s']!r} "
            f"s, {out['write_gb_s']!r} GB/s; restore {restores!r} s; peak "
            f"memory {out['peak_bytes']} B allocated, "
            f"{out['peak_reserved_bytes']} B reserved ({nvidia_smi_line()})")
    finally:
        disk1 = free_disk(tmp)
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"phase 8: free disk {disk0} B before, {disk1} B at the end "
            f"(before removing {tmp}), {free_disk(tmp.parent)} B after")
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    return out


def world_devices(torch, n: int) -> list:
    """One card a rank where the machine has ``n``; else every rank on
    card 0 (the ranks then talk over gloo: NCCL refuses two ranks on one
    card)."""
    if torch.cuda.device_count() >= n:
        return [f"cuda:{r}" for r in range(n)]
    return ["cuda:0"] * n


def free_ports(n: int) -> list:
    """``n`` distinct localhost ports that were free a moment ago (all
    held open together while they are chosen)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def world_pod_start(tmp: Path, tag: str, layout: str, port: int,
                    **extra) -> list:
    """The two processes of one training pod world (a JAXJob's env for
    KFT_NUM_PROCESSES=2, its coordinator at localhost:``port``,
    KFT_MESH=``layout`` when set), each with its own heartbeat file; the
    metrics file and the checkpoints are the coordinator's. Python's
    faulthandler is on, so a process that hangs dumps its threads' stacks
    when ``world_pod_wait`` aborts it."""
    cmd = [sys.executable, "-X", "faulthandler", "-m",
           "kubeflow_tpu_torch.rendezvous.worker_check"]
    procs = []
    for rank in range(WORLD):
        env = pod_env(tmp, tag, **extra)
        env.update(KFT_COORDINATOR=f"127.0.0.1:{port}",
                   KFT_NUM_PROCESSES=str(WORLD), KFT_PROCESS_ID=str(rank),
                   KFT_HEARTBEAT_FILE=str(tmp / tag / f"heartbeat.{rank}"))
        if layout:
            env["KFT_MESH"] = layout
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def world_pod_wait(procs: list, what: str) -> list:
    """Every process's stdout once all have ended with rc 0; a process
    still running after POD_TIMEOUT_S is aborted (its stacks are in the
    error)."""
    import signal

    deadline = time.time() + POD_TIMEOUT_S
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(deadline - time.time(), 1)))
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.send_signal(signal.SIGABRT)
            errs = [q.communicate(timeout=60)[1][-6000:] for q in procs]
            raise SystemExit(f"phase 9a: {what} hung; stacks:\n"
                             + "\n---\n".join(errs))
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"phase 9a: {what} rank {rank} rc "
                             f"{p.returncode}:\n{err[-4000:]}")
    return [out for out, _ in outs]


def world_pod(torch, tmp: Path) -> dict:
    """Phase 9 (a): the reference pod's training over two processes,
    under KFT_MESH=data=2, the default (fsdp=2) and KFT_MESH=tensor=2,
    killed after its step-2 checkpoint and restarted (module docstring).
    The layouts, and each one's uninterrupted world, victim and restart,
    run side by side; no process outlives the phase."""
    started: list = []
    try:
        return _world_pod(tmp, started)
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _world_pod(tmp: Path, started: list) -> dict:
    """``world_pod``'s body; every process it starts goes into
    ``started``."""
    import signal

    def start(tag, layout, **extra):
        procs = world_pod_start(tmp, tag, layout, next(ports), **extra)
        started.extend(procs)
        return procs

    layouts = {"data": "data=2", "fsdp": "", "tensor": "tensor=2"}
    ports = iter(free_ports(3 * len(layouts)))
    t0 = time.perf_counter()
    refs = {k: start(f"world-{k}-ref", v) for k, v in layouts.items()}
    victims = {k: start(f"world-{k}-victim", v,
                        KFT_STEP_SLEEP=str(POD_STEP_SLEEP_S))
               for k, v in layouts.items()}
    deadline = time.time() + POD_TIMEOUT_S
    killed, restarts = {}, {}
    while len(killed) < len(victims):
        for k, procs in victims.items():
            ckpt = tmp / f"world-{k}-victim" / "ckpt"
            if k not in killed and (ckpt / "2").is_dir():
                for p in procs:
                    p.send_signal(signal.SIGKILL)
                for p in procs:
                    p.communicate(timeout=60)
                killed[k] = max(pod_losses(tmp, f"world-{k}-victim"))
                # the restart runs beside the uninterrupted worlds
                restarts[k] = start(f"world-{k}-victim", layouts[k],
                                    KFT_STEP_SLEEP=str(POD_STEP_SLEEP_S))
            elif k not in killed and (any(p.poll() is not None
                                          for p in procs)
                                      or time.time() > deadline):
                for p in procs:
                    p.kill()
                raise SystemExit(
                    f"phase 9a: the {k} victim ended or stalled before step "
                    f"2's checkpoint:\n{procs[0].communicate()[1][-4000:]}")
        time.sleep(0.02)
    log(f"phase 9a: victims SIGKILLed after steps {killed} "
        f"({time.perf_counter() - t0:.1f} s), each restarted")
    outs = {k: world_pod_wait(p, f"{k} uninterrupted")
            for k, p in refs.items()}
    log(f"phase 9a: uninterrupted worlds ({time.perf_counter() - t0:.1f} s): "
        f"{ {k: [o.strip() for o in v] for k, v in outs.items()} }")
    outs = {k: world_pod_wait(p, f"{k} restart")
            for k, p in restarts.items()}
    out = {"wall_s": time.perf_counter() - t0}
    for k in layouts:
        phases = json.loads((tmp / f"world-{k}-victim" / "phases.0")
                            .read_text())
        resumed = int(phases.get("resumed_from_step", -1))
        want = pod_losses(tmp, f"world-{k}-ref")
        got = pod_losses(tmp, f"world-{k}-victim")
        after = {s: (got.get(s), want.get(s))
                 for s in range(resumed + 1, POD_STEPS + 1)}
        backend = re.search(r"mesh=(\{[^}]*\}), backend=(\w+) \(([^)]*)\)",
                            outs[k][0])
        log(f"phase 9a {k}: restart (all ended {out['wall_s']:.1f} s "
            f"into the phase) resumed from step {resumed} (killed after {killed[k]}); mesh "
            f"{backend and backend.group(1)}, backend "
            f"{backend and backend.group(2)} ({backend and backend.group(3)});"
            f" losses after the resume (restart, uninterrupted) {after!r}")
        if not 2 <= resumed <= killed[k] or backend is None \
                or any(a != b or a is None for a, b in after.values()) \
                or not all(f"resumed_from={resumed}" in o for o in outs[k]):
            raise SystemExit(f"phase 9a: the {k} world did not resume "
                             "step-exact")
        out[k] = {"resumed_from": resumed, "backend": backend.group(2),
                  "losses_after_resume": after}
    log(f"phase 9a: {out['wall_s']:.1f} s")
    return out


def world_readings(world: list, ref: dict) -> dict:
    """Largest relative difference of the world's losses and grad norms
    (every rank) from the one-process trainer's, over the steps."""
    import math

    keys = ("loss", "grad_norm") + (("moe_aux",) if "moe_aux" in
                                     ref["metrics"][0] else ())
    out = {"tokens_equal": True, **dict.fromkeys(keys, 0.0)}
    for rank in world:
        for m, r in zip(rank, ref["metrics"]):
            for k in keys:
                d = abs(m[k] - r[k]) / abs(r[k])
                # a NaN reads as infinitely far, never as 0
                out[k] = max(out[k], d if math.isfinite(d) else math.inf)
            out["tokens_equal"] &= m["tokens"] == r["tokens"]
    return out


def world_reference(torch, job, grouped: int = 1) -> dict:
    """The one-process trainer (phase 7's, grad_accum 16) from the same
    seed on the concatenation of both ranks' rows, replayed; with
    ``grouped``, their micro batches of ``grouped`` micro batches a rank
    in turn (``world_train.global_batch``: the world's global micro
    batches)."""
    import dataclasses

    from kubeflow_tpu_torch.tools import world_train as wt

    one = dataclasses.replace(
        job, trainer={**job.trainer, "grad_accum": TRAIN_ACCUM})
    trainer = wt.make_trainer(one, torch.device("cuda"))
    trainer.precompile(wt.global_batch(job, WORLD, 0, grouped))
    metrics = []
    for step in range(job.steps):
        m = trainer.train_step(wt.global_batch(job, WORLD, step, grouped))
        metrics.append({k: float(v) for k, v in m.items()})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"metrics": metrics}


def world_job():
    """Phase 9 (b)'s job: llama_1b in phase 7's configuration cut to
    WORLD_LAYERS of its 16 layers, each of WORLD places in the batch axes
    TRAIN_BATCH / WORLD rows with ragged masks in WORLD_ACCUM micro
    batches."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    cfg = dataclasses.replace(llama.llama_1b(remat="dots",
                                             attn_impl="pallas"),
                              n_layers=WORLD_LAYERS)
    return wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                            total_steps=1000, grad_accum=WORLD_ACCUM,
                            optimizer="adafactor"),
                  local_batch=TRAIN_BATCH // WORLD, seq=TRAIN_SEQ,
                  steps=TRAIN_STEPS, mask=True, runs=("eager", "replayed"))


def world_training(torch) -> dict:
    """Phase 9 (b): llama_1b at full width in phase 7's configuration
    over two processes, as data=2 and as fsdp=2 in one world (module
    docstring)."""
    import dataclasses
    import tempfile

    from kubeflow_tpu_torch.tools import world_train as wt

    job = world_job()
    cfg = job.config
    # (data, fsdp, the layout's job): fsdp's micro bodies gather and
    # reduce-scatter every layer over gloo, eagerly, so its one run takes
    # WORLD_FSDP_STEPS steps
    layouts = {"data": (WORLD, 1, job),
               "fsdp": (1, WORLD, dataclasses.replace(
                   job, steps=WORLD_FSDP_STEPS, runs=("replayed",)))}
    devices = world_devices(torch, WORLD)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9b: llama_1b, remat=dots, attn_impl=pallas, adafactor, "
        f"global batch {TRAIN_BATCH} x {TRAIN_SEQ} with ragged masks, "
        f"{WORLD} processes on {devices}, each {TRAIN_BATCH // WORLD} rows "
        f"in {WORLD_ACCUM} micro batches; data=2 runs {job.runs} of "
        f"{job.steps} steps, fsdp=2 (ZeRO-3) runs ('replayed',) of "
        f"{WORLD_FSDP_STEPS}; {torch.cuda.memory_allocated()} B allocated "
        f"in this process")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kft-phase9-") as rundir:
        results = wt.run(wt.plans_rank, ([
            (d, f, wt.train_rank, (j,)) for d, f, j in layouts.values()],),
            1, WORLD, devices, rundir)
    world_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ref = world_reference(torch, job)
    ref_s = time.perf_counter() - t1
    out = {"world_s": world_s, "reference_s": ref_s, "launches": {},
           "ref_metrics": ref["metrics"]}
    per_micro = {"flash_attention_fwd": 2 * cfg.n_layers,
                 "flash_attention_dq": cfg.n_layers,
                 "flash_attention_dkv": cfg.n_layers}
    failed = []
    for i, (name, (_, _, lj)) in enumerate(layouts.items()):
        ranks = [r[i] for r in results]
        want_launch = {k: v * WORLD_ACCUM * lj.steps
                       for k, v in per_micro.items()}
        b = ranks[0]["backend"]
        log(f"phase 9b {name}: backend {b['backend']} ({b['reason']}); "
            f"micro body {ranks[0].get('micro_mode')}, finish body "
            f"{ranks[0].get('finish_mode')}")
        for r, res in enumerate(ranks):
            for run, steps in res["runs"].items():
                log(f"phase 9b {name} rank {r} {run}: step s "
                    f"{steps['seconds']!r}; collectives per step "
                    f"{steps['collectives']!r}; per-layer gathers and "
                    f"reduce-scatters per step "
                    f"{steps['layer_collectives']!r}; peak "
                    f"{steps.get('peak_allocated')} B allocated, "
                    f"{steps.get('peak_reserved')} B reserved; after the "
                    f"steps {steps.get('allocated_after')} B allocated "
                    f"({steps.get('allocated_base')} B before the "
                    f"trainer); state kept {steps['state_bytes']} "
                    f"(reachable {steps['held_bytes']} B); flash launches "
                    f"{steps['launches']}; losses "
                    f"{[m['loss'] for m in steps['metrics']]!r} grad norms "
                    f"{[m['grad_norm'] for m in steps['metrics']]!r}")
                if steps["launches"] != want_launch:
                    failed.append(f"{name} rank {r} {run}: flash launches "
                                  f"{steps['launches']}, expected "
                                  f"{want_launch}")
        world = [res["runs"]["replayed"]["metrics"] for res in ranks]
        read = world_readings(world, ref)
        log(f"phase 9b {name}: replayed world against the one-process "
            f"trainer on the concatenated batches ({lj.steps} steps): loss "
            f"{read['loss']!r} (limit {WORLD_LOSS_RTOL}), grad norm "
            f"{read['grad_norm']!r} (limit {WORLD_NORM_RTOL}) relative; "
            f"tokens equal {read['tokens_equal']}; reference losses "
            f"{[m['loss'] for m in ref['metrics']]!r}")
        out[name] = {"readings": read, "backend": b,
                     "micro_mode": ranks[0].get("micro_mode"),
                     "finish_mode": ranks[0].get("finish_mode"),
                     "ranks": [{run: {k: s.get(k) for k in (
                         "seconds", "collectives", "layer_collectives",
                         "peak_allocated", "peak_reserved", "allocated_base",
                         "allocated_after", "state_bytes")}
                         for run, s in res["runs"].items()}
                         for res in ranks]}
        if "eager" in lj.runs:
            bitwise = all(res["differ"] == [] and [
                (m["loss"], m["grad_norm"])
                for m in res["runs"]["replayed"]["metrics"]] == [
                (m["loss"], m["grad_norm"])
                for m in res["runs"]["eager"]["metrics"]] for res in ranks)
            log(f"phase 9b {name}: replayed bitwise the eager run on every "
                f"rank: {bitwise} (parameters differing: "
                f"{[res['differ'] for res in ranks]})")
            if not bitwise:
                failed.append(f"{name}: the replayed world step is not "
                              "bitwise the eager one")
        out["launches"][name] = {
            k: sum(res["runs"]["replayed"]["launches"][k] for res in ranks)
            for k in want_launch}
        if world[0] != world[1] or not read["tokens_equal"] \
                or read["loss"] > WORLD_LOSS_RTOL \
                or read["grad_norm"] > WORLD_NORM_RTOL:
            failed.append(f"{name}: the world's steps are not the "
                          "one-process trainer's on the global batch")
        for r, res in enumerate(ranks):
            for run, s in res["runs"].items():
                total, after = s["state_bytes"]["total"], s["allocated_after"]
                added = after - s["allocated_base"]
                if s["held_bytes"] != total or after < total \
                        or added - total > WORLD_UNCOUNTED_MAX:
                    failed.append(
                        f"{name} rank {r} {run}: state_bytes {total} B, "
                        f"reachable {s['held_bytes']} B, allocated {after} "
                        f"B, {added} B of it added by the run")
    if out["fsdp"]["micro_mode"] != "eager" \
            or out["data"]["micro_mode"] != "graph":
        failed.append("under gloo, fsdp's micro bodies must run eagerly "
                      "and data's replay")
    kept = {k: out[k]["ranks"][0]["replayed"]["state_bytes"]
            for k in layouts}
    after = {k: [rank["replayed"]["allocated_after"]
                 - rank["replayed"]["allocated_base"]
                 for rank in out[k]["ranks"]] for k in layouts}
    out["state_share"] = kept["fsdp"]["total"] / kept["data"]["total"]
    out["kind_shares"] = {k: kept["fsdp"][k] / kept["data"][k]
                          for k in ("params", "grads", "opt_state")}
    log(f"phase 9b: state kept per rank, data {kept['data']} against fsdp "
        f"{kept['fsdp']}: fsdp/data {out['state_share']!r} in all (limit "
        f"{WORLD_STATE_SHARE_MAX}), by kind {out['kind_shares']!r}; "
        f"allocated by the replayed run, per rank, data {after['data']} B, "
        f"fsdp {after['fsdp']} B; world {world_s:.1f} s, reference "
        f"{ref_s:.1f} s ({nvidia_smi_line()})")
    if out["state_share"] > WORLD_STATE_SHARE_MAX \
            or 2 * kept["fsdp"]["params"] != kept["data"]["params"] \
            or 2 * kept["fsdp"]["grads"] != kept["data"]["grads"]:
        failed.append("an fsdp rank does not keep half of a data rank's "
                      "parameters and gradients")
    if failed:
        raise SystemExit(f"phase 9b: {failed}")
    return out


def zero3_phase(torch) -> dict:
    """Phase 9 (c): llama3_8b at its published widths under fsdp=4, one
    card a rank over NCCL, eager then replayed (module docstring).
    Skipped, and said so, on a machine with fewer than ZERO3_WORLD
    cards."""
    import math
    import tempfile

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    n = torch.cuda.device_count()
    if n < ZERO3_WORLD:
        log(f"phase 9c: skipped: llama3_8b under fsdp={ZERO3_WORLD} needs "
            f"{ZERO3_WORLD} cards, one a rank; this machine has {n}")
        return {"skipped": f"{n} card(s)",
                "launches": dict.fromkeys(("flash_attention_fwd",
                                           "flash_attention_dq",
                                           "flash_attention_dkv"), 0)}
    cfg = llama.llama3_8b(remat="dots", attn_impl="pallas")
    job = wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                           total_steps=1000, grad_accum=ZERO3_ACCUM,
                           optimizer="adamw"),
                 local_batch=ZERO3_ROWS * ZERO3_ACCUM, seq=TRAIN_SEQ,
                 steps=ZERO3_STEPS, runs=("eager", "replayed"),
                 profile=True)
    devices = [f"cuda:{r}" for r in range(ZERO3_WORLD)]
    log(f"phase 9c: llama3_8b (32 layers, untied, random weights from "
        f"seed 0), remat=dots, attn_impl=pallas, adamw, fsdp={ZERO3_WORLD} "
        f"on {devices}; a rank {ZERO3_ACCUM} micro batches of {ZERO3_ROWS} "
        f"x {TRAIN_SEQ}; runs {job.runs} of {ZERO3_STEPS} steps")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kft-phase9c-") as rundir:
        ranks = wt.run(wt.train_rank, (job,), 1, ZERO3_WORLD, devices,
                       rundir)
    wall_s = time.perf_counter() - t0
    per_micro = {"flash_attention_fwd": 2 * cfg.n_layers,
                 "flash_attention_dq": cfg.n_layers,
                 "flash_attention_dkv": cfg.n_layers}
    want_launch = {k: v * ZERO3_ACCUM * ZERO3_STEPS
                   for k, v in per_micro.items()}
    tokens = ZERO3_ROWS * ZERO3_ACCUM * TRAIN_SEQ
    # a rank's f32 parts of the parameters, their gradients and adamw's
    # two moments (16 B a parameter, over the ranks), and its two 0-d
    # int32 counts
    shapes = llama.param_shapes(cfg)
    n_params = sum(math.prod(s) for s in (*shapes.pop("layers").values(),
                                          *shapes.values()))
    want_kept = 16 * n_params // ZERO3_WORLD + 2 * 4
    failed = []
    out = {"wall_s": wall_s, "ranks": [], "n_params": n_params,
           "kept_bytes": want_kept}
    for r, res in enumerate(ranks):
        rep, eag = res["runs"]["replayed"], res["runs"]["eager"]
        step_s = statistics.median(rep["seconds"][1:] or rep["seconds"])
        tok_s = tokens / step_s
        mfu = tok_s * cfg.flops_per_token(TRAIN_SEQ) / BF16_FLOPS
        metrics = [(m["loss"], m["grad_norm"]) for m in rep["metrics"]]
        bitwise = res["differ"] == [] and metrics == [
            (m["loss"], m["grad_norm"]) for m in eag["metrics"]]
        kept = rep["state_bytes"]
        log(f"phase 9c rank {r}: backend {res['backend']['backend']}, micro "
            f"body {res.get('micro_mode')}, finish body "
            f"{res.get('finish_mode')}, capture "
            f"{res.get('capture_seconds')!r} s, graph pool "
            f"{res.get('pool_bytes')} B; eager step s "
            f"{eag['seconds']!r}, replayed step s {rep['seconds']!r} "
            f"({tok_s!r} tok/s a card, MFU {mfu!r} against 989 TFLOP/s); "
            f"kept {kept} (reachable {rep['held_bytes']} B); peak "
            f"{rep.get('peak_allocated')} B allocated, "
            f"{rep.get('peak_reserved')} B reserved; eager per-layer "
            f"collectives per step {eag['layer_collectives']!r}; traced "
            f"last step: eager {eag.get('profile')!r}, replayed "
            f"{rep.get('profile')!r}; flash launches (replayed) "
            f"{rep['launches']}; losses {[m[0] for m in metrics]!r} grad "
            f"norms {[m[1] for m in metrics]!r}; replayed bitwise eager "
            f"{bitwise} (parameters differing {res['differ']})")
        out["ranks"].append({"step_s": step_s, "tok_s_per_card": tok_s,
                             "mfu": mfu, "state_bytes": kept,
                             "peak_allocated": rep.get("peak_allocated"),
                             "peak_reserved": rep.get("peak_reserved"),
                             "pool_bytes": res.get("pool_bytes"),
                             "eager_seconds": eag["seconds"],
                             "replayed_seconds": rep["seconds"],
                             "layer_collectives":
                                 eag["layer_collectives"],
                             "profile": {"eager": eag.get("profile"),
                                         "replayed": rep.get("profile")},
                             "bitwise": bitwise})
        if not bitwise:
            failed.append(f"rank {r}: the replayed steps are not bitwise "
                          "the eager ones")
        if res["backend"]["backend"] != "nccl" \
                or res.get("micro_mode") != "graph" \
                or res.get("finish_mode") != "graph":
            failed.append(f"rank {r}: not both bodies captured over NCCL")
        if rep["held_bytes"] != kept["total"]:
            failed.append(f"rank {r}: state_bytes {kept['total']} B, "
                          f"reachable {rep['held_bytes']} B")
        if rep["launches"] != want_launch or eag["launches"] != want_launch:
            failed.append(f"rank {r}: flash launches {rep['launches']} / "
                          f"{eag['launches']}, expected {want_launch}")
        if not all(math.isfinite(m[0]) for m in metrics) \
                or metrics != [(m["loss"], m["grad_norm"]) for m in
                               ranks[0]["runs"]["replayed"]["metrics"]]:
            failed.append(f"rank {r}: losses not finite or not rank 0's")
        if kept["params"] + kept["grads"] + kept["opt_state"] != want_kept:
            failed.append(f"rank {r}: keeps {kept}, expected {want_kept} B "
                          "of parameters, gradients and adamw moments")
    out["launches"] = {k: ZERO3_WORLD * want_launch[k] for k in want_launch}
    log(f"phase 9c: {wall_s:.1f} s ({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9c: {failed}")
    return out


def kept_share(cfg, cuts: dict) -> dict:
    """Parameters a rank keeps of each leaf of ``cfg``'s tree, whose
    logical axes ``cuts`` (axis -> parts) divide: the exact count, the
    whole count and their ratio."""
    import math

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.parallel import sharding

    shapes, axes = llama.param_shapes(cfg), llama.param_logical_axes(cfg)
    pairs = [(shapes["layers"][k], axes["layers"][k])
             for k in shapes["layers"]]
    pairs += [(shapes[k], axes[k]) for k in shapes if k != "layers"]
    whole = kept = 0
    for shape, names in pairs:
        n = math.prod(shape)
        whole += n
        for axis, parts in cuts.items():
            if sharding.axis_dim(names, axis) is not None:
                n //= parts
        kept += n
    return {"kept": kept, "whole": whole, "share": kept / whole}


def tensor_plan() -> tuple:
    """Phase 9 (t)'s plan (``world_train.plans_rank``), run in the world
    of two ranks on one card that 9m's, 9r's, 9rm's and 9p's run in
    (``card_pair_world``): phase 9b's global batch on both ranks under
    tensor=TENSOR_WORLD, replayed after ``precompile``."""
    import dataclasses

    from kubeflow_tpu_torch.tools import world_train as wt

    base = world_job()
    job = dataclasses.replace(
        base, trainer={**base.trainer, "grad_accum": TRAIN_ACCUM},
        steps=TENSOR_STEPS, runs=("replayed",), merge_places=WORLD)
    return (1, 1, TENSOR_WORLD, wt.train_rank, (job,))


def tensor_training(torch, ref_metrics: list, ranks: list) -> dict:
    """Phase 9 (t): llama_1b at full width in phase 7's configuration
    under tensor=2, two ranks on one card over gloo (module docstring).
    ``ranks``: per rank, the result of ``tensor_plan``
    (``card_pair_world``)."""
    cfg = world_job().config
    devices = ["cuda:0"] * TENSOR_WORLD
    log(f"phase 9t: llama_1b, remat=dots, attn_impl=pallas, adafactor, "
        f"tensor={TENSOR_WORLD} on {devices} (gloo, 9r's world), both "
        f"ranks the same {TRAIN_BATCH} x {TRAIN_SEQ} rows (phase 9b's "
        f"global batch) in {TRAIN_ACCUM} micro batches, {TENSOR_STEPS} "
        f"steps after precompile()")
    per_micro = {"flash_attention_fwd": 2 * cfg.n_layers,
                 "flash_attention_dq": cfg.n_layers,
                 "flash_attention_dkv": cfg.n_layers}
    want_launch = {k: v * TRAIN_ACCUM * TENSOR_STEPS
                   for k, v in per_micro.items()}
    share = kept_share(cfg, {"tensor": TENSOR_WORLD})
    want_kept = 4 * share["kept"]
    failed = []
    out = {"ranks": [], "kept_params": share}
    for r, res in enumerate(ranks):
        run = res["runs"]["replayed"]
        tensor_calls = [{k: c[k] for k in ("tensor_calls", "tensor_bytes",
                                           "tensor_s", "gloo_s")}
                        for c in run["collectives"]]
        log(f"phase 9t rank {r}: backend {res['backend']['backend']} "
            f"({res['backend']['reason']}); micro body "
            f"{res.get('micro_mode')}, finish body {res.get('finish_mode')}"
            f"; step s {run['seconds']!r}; tensor collectives per step "
            f"{tensor_calls!r}; all collectives per step "
            f"{run['collectives']!r}; peak {run.get('peak_allocated')} B "
            f"allocated, {run.get('peak_reserved')} B reserved; state kept "
            f"{run['state_bytes']} (reachable {run['held_bytes']} B); flash "
            f"launches {run['launches']}; losses "
            f"{[m['loss'] for m in run['metrics']]!r} grad norms "
            f"{[m['grad_norm'] for m in run['metrics']]!r}")
        out["ranks"].append({k: run.get(k) for k in (
            "seconds", "collectives", "peak_allocated", "peak_reserved",
            "state_bytes", "launches")})
        if run["launches"] != want_launch:
            failed.append(f"rank {r}: flash launches {run['launches']}, "
                          f"expected {want_launch}")
        kept = run["state_bytes"]
        if kept["params"] != want_kept or kept["grads"] != want_kept \
                or run["held_bytes"] != kept["total"]:
            failed.append(f"rank {r}: keeps {kept} (reachable "
                          f"{run['held_bytes']} B), expected {want_kept} B "
                          "of parameters and of gradients")
        if res.get("micro_mode") != "eager" \
                or res.get("finish_mode") != "eager":
            failed.append(f"rank {r}: under gloo both bodies run eagerly")
    world = [res["runs"]["replayed"]["metrics"] for res in ranks]
    read = world_readings(world, {"metrics": ref_metrics[:TENSOR_STEPS]})
    out.update(readings=read, launches={
        k: sum(res["runs"]["replayed"]["launches"][k] for res in ranks)
        for k in want_launch})
    log(f"phase 9t: tensor=2 against the one-process trainer on the same "
        f"rows (phase 9b's reference, {TENSOR_STEPS} steps): loss "
        f"{read['loss']!r} (limit {TENSOR_LOSS_RTOL}), grad norm "
        f"{read['grad_norm']!r} (limit {TENSOR_NORM_RTOL}) relative; "
        f"tokens equal {read['tokens_equal']}; ranks' metrics equal "
        f"{world[0] == world[1]}; a rank keeps {share['kept']} of "
        f"{share['whole']} parameters ({share['share']!r}) "
        f"({nvidia_smi_line()})")
    if world[0] != world[1] or not read["tokens_equal"] \
            or read["loss"] > TENSOR_LOSS_RTOL \
            or read["grad_norm"] > TENSOR_NORM_RTOL:
        failed.append("the tensor=2 steps are not the one-process "
                      "trainer's on the same rows")
    if failed:
        raise SystemExit(f"phase 9t: {failed}")
    return out


def tensor_zero3_phase(torch, zero3: dict) -> dict:
    """Phase 9 (d): llama3_8b at its published widths under fsdp=2 x
    tensor=2, one card a rank over NCCL, eager then replayed (module
    docstring), beside phase 9c. Skipped, and said so, on a machine with
    fewer than four cards."""
    import math
    import tempfile

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    n_ranks = TENSOR3_FSDP * TENSOR3_TENSOR
    n = torch.cuda.device_count()
    if n < n_ranks:
        log(f"phase 9d: skipped: llama3_8b under fsdp={TENSOR3_FSDP} x "
            f"tensor={TENSOR3_TENSOR} needs {n_ranks} cards, one a rank; "
            f"this machine has {n}")
        return {"skipped": f"{n} card(s)",
                "launches": dict.fromkeys(("flash_attention_fwd",
                                           "flash_attention_dq",
                                           "flash_attention_dkv"), 0)}
    cfg = llama.llama3_8b(remat="dots", attn_impl="pallas")
    job = wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                           total_steps=1000, grad_accum=TENSOR3_ACCUM,
                           optimizer="adamw"),
                 local_batch=ZERO3_ROWS * TENSOR3_ACCUM, seq=TRAIN_SEQ,
                 steps=ZERO3_STEPS, runs=("eager", "replayed"),
                 profile=True)
    devices = [f"cuda:{r}" for r in range(n_ranks)]
    log(f"phase 9d: llama3_8b (32 layers, untied, random weights from "
        f"seed 0), remat=dots, attn_impl=pallas, adamw, fsdp={TENSOR3_FSDP}"
        f" x tensor={TENSOR3_TENSOR} on {devices}; each place in the batch "
        f"axes {TENSOR3_ACCUM} micro batches of {ZERO3_ROWS} x {TRAIN_SEQ} "
        f"(heads a rank: {cfg.n_heads // TENSOR3_TENSOR} query, "
        f"{cfg.n_kv_heads // TENSOR3_TENSOR} KV); runs {job.runs} of "
        f"{ZERO3_STEPS} steps")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kft-phase9d-") as rundir:
        ranks = wt.run(wt.train_rank, (job,), 1, TENSOR3_FSDP, devices,
                       rundir, tensor=TENSOR3_TENSOR)
    wall_s = time.perf_counter() - t0
    per_micro = {"flash_attention_fwd": 2 * cfg.n_layers,
                 "flash_attention_dq": cfg.n_layers,
                 "flash_attention_dkv": cfg.n_layers}
    want_launch = {k: v * TENSOR3_ACCUM * ZERO3_STEPS
                   for k, v in per_micro.items()}
    # a card's share of the global batch's tokens a step
    tokens = ZERO3_ROWS * TENSOR3_ACCUM * TRAIN_SEQ * TENSOR3_FSDP / n_ranks
    share = kept_share(cfg, {"fsdp": TENSOR3_FSDP,
                             "tensor": TENSOR3_TENSOR})
    # f32 parameters, gradients and adamw's two moments (16 B a kept
    # parameter), and adamw's two 0-d int32 counts
    want_kept = 16 * share["kept"] + 2 * 4
    failed = []
    out = {"wall_s": wall_s, "ranks": [], "kept_params": share,
           "kept_bytes": want_kept}
    for r, res in enumerate(ranks):
        rep, eag = res["runs"]["replayed"], res["runs"]["eager"]
        step_s = statistics.median(rep["seconds"][1:] or rep["seconds"])
        tok_s = tokens / step_s
        mfu = tok_s * cfg.flops_per_token(TRAIN_SEQ) / BF16_FLOPS
        metrics = [(m["loss"], m["grad_norm"]) for m in rep["metrics"]]
        bitwise = res["differ"] == [] and metrics == [
            (m["loss"], m["grad_norm"]) for m in eag["metrics"]]
        kept = rep["state_bytes"]
        prof = rep.get("profile") or {}
        nccl_share = prof.get("nccl_busy_ms", 0.0) / prof.get("wall_ms", 1)
        log(f"phase 9d rank {r}: backend {res['backend']['backend']}, micro "
            f"body {res.get('micro_mode')}, finish body "
            f"{res.get('finish_mode')}, capture "
            f"{res.get('capture_seconds')!r} s, graph pool "
            f"{res.get('pool_bytes')} B; eager step s {eag['seconds']!r}, "
            f"replayed step s {rep['seconds']!r} ({tok_s!r} tok/s a card, "
            f"MFU {mfu!r} against 989 TFLOP/s, NCCL busy {nccl_share!r} of "
            f"the traced step); kept {kept} (reachable "
            f"{rep['held_bytes']} B); peak {rep.get('peak_allocated')} B "
            f"allocated, {rep.get('peak_reserved')} B reserved; eager "
            f"collectives per step {eag['collectives']!r}, per-layer "
            f"{eag['layer_collectives']!r}; traced last step: eager "
            f"{eag.get('profile')!r}, replayed {rep.get('profile')!r}; flash "
            f"launches (replayed) {rep['launches']}; losses "
            f"{[m[0] for m in metrics]!r} grad norms "
            f"{[m[1] for m in metrics]!r}; replayed bitwise eager {bitwise} "
            f"(parameters differing {res['differ']})")
        out["ranks"].append({"step_s": step_s, "tok_s_per_card": tok_s,
                             "mfu": mfu, "nccl_share": nccl_share,
                             "state_bytes": kept,
                             "peak_allocated": rep.get("peak_allocated"),
                             "peak_reserved": rep.get("peak_reserved"),
                             "pool_bytes": res.get("pool_bytes"),
                             "eager_seconds": eag["seconds"],
                             "replayed_seconds": rep["seconds"],
                             "collectives": eag["collectives"],
                             "profile": {"eager": eag.get("profile"),
                                         "replayed": rep.get("profile")},
                             "bitwise": bitwise})
        if not bitwise:
            failed.append(f"rank {r}: the replayed steps are not bitwise "
                          "the eager ones")
        if res["backend"]["backend"] != "nccl" \
                or res.get("micro_mode") != "graph" \
                or res.get("finish_mode") != "graph":
            failed.append(f"rank {r}: not both bodies captured over NCCL")
        if rep["held_bytes"] != kept["total"]:
            failed.append(f"rank {r}: state_bytes {kept['total']} B, "
                          f"reachable {rep['held_bytes']} B")
        if rep["launches"] != want_launch or eag["launches"] != want_launch:
            failed.append(f"rank {r}: flash launches {rep['launches']} / "
                          f"{eag['launches']}, expected {want_launch}")
        peer = ranks[r - r % TENSOR3_TENSOR]["runs"]["replayed"]["metrics"]
        if not all(math.isfinite(m[0]) for m in metrics) \
                or rep["metrics"] != peer:
            failed.append(f"rank {r}: losses not finite or not its tensor "
                          "peer's")
        if kept["params"] + kept["grads"] + kept["opt_state"] != want_kept:
            failed.append(f"rank {r}: keeps {kept}, expected {want_kept} B "
                          "of parameters, gradients and adamw moments")
    out["launches"] = {k: n_ranks * want_launch[k] for k in want_launch}
    if "ranks" in zero3:
        log(f"phase 9d beside 9c (fsdp={ZERO3_WORLD}): tok/s a card "
            f"{[x['tok_s_per_card'] for x in out['ranks']]!r} against "
            f"{[x['tok_s_per_card'] for x in zero3['ranks']]!r}, MFU "
            f"{[x['mfu'] for x in out['ranks']]!r} against "
            f"{[x['mfu'] for x in zero3['ranks']]!r}")
    log(f"phase 9d: {wall_s:.1f} s ({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9d: {failed}")
    return out


def world_phase(torch) -> dict:
    """Phase 9: training across processes (module docstring)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="kft-phase9-"))
    try:
        pod = world_pod(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = world_training(torch)
    out["pod"] = pod
    out["zero3"] = zero3_phase(torch)
    out["tensor_zero3"] = tensor_zero3_phase(torch, out["zero3"])
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return out


def moe_layer_inputs(seq: int = TRAIN_SEQ) -> dict:
    """Phase 9m (i)'s whole inputs on the current card, float32 from
    seed MOE_LAYER_SEED: one global micro batch of the 9m model (2 x
    ``seq`` tokens of width 2048; 9rm (i): its own rows' length), its
    router and 8 experts of mlp 5632 at
    N(0, 1/fan_in), the router's columns scaled 1 to 2.75 (an expert
    whose column is wider wins more tokens, so capacity 1.25 drops some,
    as a trained router's imbalance does), every token real, and each
    output element's weight in the loss."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(MOE_LAYER_SEED)
    d, m, e = 2048, 5632, 8

    def draw(*shape, fan=1):
        return torch.randn(shape, generator=gen, device="cuda") * fan ** -0.5

    scale = torch.linspace(1.0, 2.75, e, device="cuda")
    return {"x": draw(2, seq, d),
            "params": {"router": draw(d, e, fan=d) * scale,
                       "w_gate": draw(e, d, m, fan=d),
                       "w_up": draw(e, d, m, fan=d),
                       "w_down": draw(e, m, d, fan=m)},
            "mask": torch.ones((2, seq), dtype=torch.bool, device="cuda"),
            "weights": draw(2, seq, d)}


# phase 9m (i)'s case: the training configuration's capacity path
MOE_LAYER_CASES = [("capacity-1.25", 1.25, 2, False)]


def moe_layer_readings(ranks: list, ref: dict) -> dict:
    """Phases 9m (i) and 9rm (i): the world's layer against one process's
    on the same whole inputs: each rank's part (its rows, its chunk of
    their tokens) of the output and of the input's gradient and the
    weights' gradients (summed over the tokens ranks, each expert rank's
    experts), as the largest difference over the reference's largest
    magnitude; the aux losses relative; the dropped fractions."""
    want, out = ref["cases"][0], {"y": 0.0, "grads": 0.0, "aux": 0.0,
                                  "dropped": 0.0}
    summed: dict = {}
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    for r in ranks:
        (i, n), (ix, nx) = r["batch"], r["expert"]
        ic, nc = r["context"]
        got = r["cases"][0]
        b, s = want["y"].shape[:2]
        part = (slice(i * b // n, (i + 1) * b // n),
                slice(ic * s // nc, (ic + 1) * s // nc))
        out["y"] = max(out["y"], rel(got["y"], want["y"][part]))
        out["grads"] = max(out["grads"], rel(got["x"], want["x"][part]))
        for k in ("moe_load_balance", "moe_router_z"):
            out["aux"] = max(out["aux"], abs(got["aux"][k] - want["aux"][k])
                             / abs(want["aux"][k]))
        out["dropped"] = max(out["dropped"], abs(
            got["aux"]["moe_dropped_fraction"]
            - want["aux"]["moe_dropped_fraction"]))
        for k, g in got["grads"].items():
            summed.setdefault((k, ix, nx), []).append(g)
    for (k, ix, nx), parts in summed.items():
        whole = want["grads"][k]
        if k != "router":
            e = whole.shape[0] // nx
            whole = whole[ix * e:(ix + 1) * e]
        out["grads"] = max(out["grads"], rel(sum(parts), whole))
    out["dropped_fraction"] = want["aux"]["moe_dropped_fraction"]
    return out


def moe_world_job():
    """Phase 9m's data=2 job: the MoE model in phase 7's configuration,
    each of WORLD places in the batch axes TRAIN_BATCH / WORLD rows with
    ragged masks in TRAIN_ACCUM micro batches of one row (the world's
    global micro batch: phase 7's two rows)."""
    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    cfg = llama.llama_moe_8x(llama.llama_1b(remat="dots",
                                            attn_impl="pallas"),
                             n_layers=MOE_WORLD_LAYERS)
    return wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                            total_steps=1000, grad_accum=TRAIN_ACCUM,
                            optimizer="adafactor"),
                  local_batch=TRAIN_BATCH // WORLD, seq=TRAIN_SEQ,
                  steps=MOE_WORLD_STEPS, mask=True)


def moe_world_layouts() -> dict:
    """Phase 9m's layouts: (data, fsdp, tensor, expert, the layout's
    job); expert peers feed the same rows, the data=2 places' micro
    batches in turn."""
    import dataclasses

    job = moe_world_job()
    return {"data": (WORLD, 1, 1, 1, job),
            "expert": (1, 1, 1, WORLD, dataclasses.replace(
                job, merge_places=WORLD, interleave=True))}


def moe_world_plans() -> list:
    """Phase 9m's plans (``world_train.plans_rank``), run in the world of
    two ranks on one card that 9r's, 9rm's and 9p's run in
    (``card_pair_world``): per layout the layer, then the trainer."""
    from kubeflow_tpu_torch.tools import world_train as wt

    plans = []
    for d, f, t, x, lj in moe_world_layouts().values():
        plans += [(d, f, t, x, wt.moe_layer_rank,
                   (moe_layer_inputs, MOE_LAYER_CASES)),
                  (d, f, t, x, wt.train_rank, (lj,))]
    return plans


def moe_world_phase(torch, results: list) -> dict:
    """Phase 9m: MoE across two processes on one card (module
    docstring). ``results``: per rank, those of ``moe_world_plans``
    (``card_pair_world``)."""
    from kubeflow_tpu_torch.tools import world_train as wt

    t_phase = time.perf_counter()
    job = moe_world_job()
    cfg = job.config
    layouts = moe_world_layouts()
    log(f"phase 9m: llama_1b widths with {cfg.n_experts} experts "
        f"(top-{cfg.moe_top_k}, capacity {cfg.moe_capacity_factor}), "
        f"{cfg.n_layers} of 16 layers, remat=dots, attn_impl=pallas, "
        f"adafactor, global batch {TRAIN_BATCH} x {TRAIN_SEQ} with ragged "
        f"masks in {TRAIN_ACCUM} micro batches, {WORLD} processes on "
        f"{['cuda:0'] * WORLD} (9r's world): data=2 and expert=2, "
        f"{job.steps} eager steps each")
    t1 = time.perf_counter()
    layer_ref = wt.moe_layer_rank(None, moe_layer_inputs, MOE_LAYER_CASES,
                                  device="cuda")
    free_card(torch)
    ref = world_reference(torch, job, TRAIN_ACCUM)
    ref_s = time.perf_counter() - t1
    per_micro = {"flash_attention_fwd": 2 * cfg.n_layers,
                 "flash_attention_dq": cfg.n_layers,
                 "flash_attention_dkv": cfg.n_layers}
    want_launch = {k: v * TRAIN_ACCUM * job.steps
                   for k, v in per_micro.items()}
    out = {"reference_s": ref_s, "launches": {},
           "reference": ref["metrics"]}
    failed = []
    for i, (name, (d, f, t, x, lj)) in enumerate(layouts.items()):
        layer = moe_layer_readings([r[2 * i] for r in results], layer_ref)
        ranks = [r[2 * i + 1] for r in results]
        b = ranks[0]["backend"]
        log(f"phase 9m {name} (i): the MoE layer at full width in float32 "
            f"(one global micro batch of 4096 tokens, capacity 1.25) "
            f"against one process: output {layer['y']!r}, gradients "
            f"{layer['grads']!r} of the largest magnitude, aux "
            f"{layer['aux']!r} relative, dropped fraction "
            f"{layer['dropped_fraction']!r} (the world's off by "
            f"{layer['dropped']!r}); limits {MOE_LAYER_RTOL}")
        for r, res in enumerate(ranks):
            run = res["runs"]["eager"]
            gloo = [c["gloo_s"] / s for c, s in zip(run["collectives"],
                                                    run["seconds"])]
            moe = [{k: c[k] for k in ("moe_calls", "moe_bytes", "moe_s")}
                   for c in run["collectives"]]
            log(f"phase 9m {name} rank {r}: backend {b['backend']} "
                f"({b['reason']}); step s {run['seconds']!r}, gloo share "
                f"{gloo!r}; MoE collectives per step {moe!r}; all "
                f"collectives per step {run['collectives']!r}; peak "
                f"{run.get('peak_allocated')} B allocated, "
                f"{run.get('peak_reserved')} B reserved; state kept "
                f"{run['state_bytes']} (reachable {run['held_bytes']} B); "
                f"flash launches {run['launches']}; losses "
                f"{[m['loss'] for m in run['metrics']]!r} moe_aux "
                f"{[m['moe_aux'] for m in run['metrics']]!r} grad norms "
                f"{[m['grad_norm'] for m in run['metrics']]!r}")
            if run["launches"] != want_launch:
                failed.append(f"{name} rank {r}: flash launches "
                              f"{run['launches']}, expected {want_launch}")
            if run["held_bytes"] != run["state_bytes"]["total"]:
                failed.append(f"{name} rank {r}: state_bytes "
                              f"{run['state_bytes']['total']} B, reachable "
                              f"{run['held_bytes']} B")
        world = [res["runs"]["eager"]["metrics"] for res in ranks]
        read = world_readings(world, ref)
        share = kept_share(cfg, {"expert": x} if x > 1 else {})
        kept = ranks[0]["runs"]["eager"]["state_bytes"]
        log(f"phase 9m {name}: against one process on the same global micro "
            f"batches ({job.steps} steps): loss {read['loss']!r}, moe_aux "
            f"{read['moe_aux']!r}, grad norm {read['grad_norm']!r} relative "
            f"(limits {MOE_WORLD_RTOL}); tokens equal "
            f"{read['tokens_equal']}; ranks' metrics equal "
            f"{world[0] == world[1]}; a rank keeps {share['kept']} of "
            f"{share['whole']} parameters ({share['share']!r}); reference "
            f"losses {[m['loss'] for m in ref['metrics']]!r}")
        out[name] = {"layer": layer, "readings": read, "share": share,
                     "ranks": [{k: res["runs"]["eager"].get(k) for k in (
                         "seconds", "collectives", "peak_allocated",
                         "peak_reserved", "state_bytes")} for res in ranks]}
        out["launches"][name] = {
            k: sum(res["runs"]["eager"]["launches"][k] for res in ranks)
            for k in want_launch}
        if any(layer[k] > MOE_LAYER_RTOL[k] for k in MOE_LAYER_RTOL) \
                or not layer["dropped_fraction"] > 0:
            failed.append(f"{name}: the MoE layer over the world is not one "
                          f"process's ({layer})")
        if world[0] != world[1] or not read["tokens_equal"] \
                or any(read[k] > MOE_WORLD_RTOL[k] for k in MOE_WORLD_RTOL):
            failed.append(f"{name}: the world's steps are not one process's "
                          "on the same global micro batches")
        if kept["params"] != 4 * share["kept"] \
                or kept["grads"] != 4 * share["kept"]:
            failed.append(f"{name}: a rank keeps {kept}, expected "
                          f"{4 * share['kept']} B of parameters and of "
                          "gradients")
    log(f"phase 9m: references {ref_s:.1f} s; "
        f"{time.perf_counter() - t_phase:.1f} s after the world "
        f"({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9m: {failed}")
    return out


def moe_world_nccl(torch) -> dict:
    """Phase 9x: the uncut MoE model over data=2 x expert=2, one card a
    rank over NCCL, eager then replayed (module docstring). Skipped, and
    said so, on a machine with fewer than four cards."""
    import math
    import tempfile

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    zeros = dict.fromkeys(("flash_attention_fwd", "flash_attention_dq",
                           "flash_attention_dkv"), 0)
    n = torch.cuda.device_count()
    if n < 2 * WORLD:
        log(f"phase 9x: skipped: the uncut MoE model over data={WORLD} x "
            f"expert={WORLD} needs {2 * WORLD} cards, one a rank; this "
            f"machine has {n}")
        return {"skipped": f"{n} card(s)", "launches": zeros}
    t_phase = time.perf_counter()
    free_card(torch)
    cfg = llama.llama_moe_8x(llama.llama_1b(remat="dots",
                                            attn_impl="pallas"))
    job = wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                           total_steps=1000, grad_accum=WORLD_ACCUM,
                           optimizer="adafactor"),
                 local_batch=TRAIN_BATCH // WORLD, seq=TRAIN_SEQ,
                 steps=MOE_NCCL_STEPS, mask=True,
                 runs=("eager", "replayed"), profile=True)
    devices = [f"cuda:{r}" for r in range(2 * WORLD)]
    log(f"phase 9x: llama_1b widths with {cfg.n_experts} experts, all "
        f"{cfg.n_layers} layers, data={WORLD} x expert={WORLD} on "
        f"{devices}; each place {TRAIN_BATCH // WORLD} rows in "
        f"{WORLD_ACCUM} micro batches; runs {job.runs} of {job.steps} steps")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kft-phase9x-") as rundir:
        ranks = wt.run(wt.train_rank, (job,), WORLD, 1, devices, rundir,
                       expert=WORLD)
    wall_s = time.perf_counter() - t0
    want_launch = {k: v * WORLD_ACCUM * job.steps for k, v in {
        "flash_attention_fwd": 2 * cfg.n_layers,
        "flash_attention_dq": cfg.n_layers,
        "flash_attention_dkv": cfg.n_layers}.items()}
    share = kept_share(cfg, {"expert": WORLD})
    tokens = TRAIN_BATCH * TRAIN_SEQ / (2 * WORLD)      # a card's share
    failed, out = [], {"wall_s": wall_s, "ranks": [], "share": share}
    for r, res in enumerate(ranks):
        rep, eag = res["runs"]["replayed"], res["runs"]["eager"]
        step_s = statistics.median(rep["seconds"][1:] or rep["seconds"])
        tok_s = tokens / step_s
        mfu = tok_s * cfg.flops_per_token(TRAIN_SEQ) / BF16_FLOPS
        metrics = [(m["loss"], m["moe_aux"], m["grad_norm"])
                   for m in rep["metrics"]]
        bitwise = res["differ"] == [] and metrics == [
            (m["loss"], m["moe_aux"], m["grad_norm"]) for m in eag["metrics"]]
        prof = rep.get("profile") or {}
        nccl_share = prof.get("nccl_busy_ms", 0) / max(prof.get("wall_ms", 1),
                                                       1e-9)
        kept = rep["state_bytes"]
        log(f"phase 9x rank {r}: backend {res['backend']['backend']}, micro "
            f"body {res.get('micro_mode')}, finish body "
            f"{res.get('finish_mode')}, capture "
            f"{res.get('capture_seconds')!r} s, pool {res.get('pool_bytes')} "
            f"B; eager step s {eag['seconds']!r}, replayed {rep['seconds']!r} "
            f"({tok_s!r} tok/s a card, MFU {mfu!r} on the active top-k "
            f"FLOPs); NCCL busy share {nccl_share!r} of the traced step "
            f"{prof!r}; kept {kept} (reachable "
            f"{rep['held_bytes']} B); peak {rep.get('peak_allocated')} B "
            f"allocated, {rep.get('peak_reserved')} B reserved; losses "
            f"{[m[0] for m in metrics]!r}, moe_aux {[m[1] for m in metrics]!r}"
            f", grad norms {[m[2] for m in metrics]!r}; replayed bitwise "
            f"eager {bitwise} (differing {res['differ']})")
        out["ranks"].append({"step_s": step_s, "tok_s_per_card": tok_s,
                             "mfu": mfu, "state_bytes": kept,
                             "profile": prof, "bitwise": bitwise,
                             "peak_allocated": rep.get("peak_allocated"),
                             "peak_reserved": rep.get("peak_reserved")})
        if not bitwise:
            failed.append(f"rank {r}: the replayed steps are not bitwise "
                          "the eager ones")
        if res["backend"]["backend"] != "nccl" \
                or res.get("micro_mode") != "graph" \
                or res.get("finish_mode") != "graph":
            failed.append(f"rank {r}: not both bodies captured over NCCL")
        if rep["launches"] != want_launch or eag["launches"] != want_launch:
            failed.append(f"rank {r}: flash launches {rep['launches']}, "
                          f"expected {want_launch}")
        if kept["params"] != 4 * share["kept"] \
                or kept["grads"] != 4 * share["kept"] \
                or rep["held_bytes"] != kept["total"]:
            failed.append(f"rank {r}: keeps {kept}, expected "
                          f"{4 * share['kept']} B of parameters and of "
                          "gradients")
        if not all(math.isfinite(m[0]) for m in metrics) or metrics != [
                (m["loss"], m["moe_aux"], m["grad_norm"])
                for m in ranks[0]["runs"]["replayed"]["metrics"]]:
            failed.append(f"rank {r}: losses not finite or not rank 0's")
    out["launches"] = {k: 2 * WORLD * v for k, v in want_launch.items()}
    log(f"phase 9x: {time.perf_counter() - t_phase:.1f} s "
        f"({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9x: {failed}")
    return out


def context_layer_inputs(device) -> dict:
    """Phase 9r's ring layer at full width: q [B, S, H, D], k/v [B, S,
    KV, D] and the loss weights, bf16, N(0, 1) from a generator on
    ``device`` seeded CONTEXT_LAYER_SEED (every rank draws the same)."""
    import torch

    g = torch.Generator(device=device).manual_seed(CONTEXT_LAYER_SEED)
    b, h, kvh, d = (CONTEXT_LAYER[k] for k in ("B", "H", "KVH", "D"))

    def draw(*shape):
        return torch.randn(shape, generator=g, device=device).bfloat16()

    return {"q": draw(b, CONTEXT_SEQ, h, d), "k": draw(b, CONTEXT_SEQ, kvh, d),
            "v": draw(b, CONTEXT_SEQ, kvh, d), "w": draw(b, CONTEXT_SEQ, h, d)}


def windowed_error(got, want, window: int = CONTEXT_WINDOW) -> float:
    """The largest relative error of ``got`` against ``want`` (both [B,
    S, ...]) over windows of ``window`` positions: max over windows of
    ||got - want|| / ||want||, each norm over the window's elements. Each
    stretch of the sequence is held to its own magnitude, so rows whose
    values are small (late queries average thousands of keys) count as
    much as the large early ones. A NaN reads as infinitely far."""
    b, s = want.shape[:2]
    diff = (got - want).reshape(b, s // window, -1)
    want = want.reshape(b, s // window, -1)
    d = float((diff.norm(dim=-1) / want.norm(dim=-1)).max())
    return d if d == d else float("inf")


def context_layer_readings(ranks: list, impl: str, ref: dict) -> dict:
    """The world's output and input gradients of ``impl`` (each rank's
    chunk of the sequence, put back together) against ``ref`` (whole):
    per tensor its ``windowed_error``, and the largest of them
    ("max")."""
    import torch

    out = {}
    for key in "oqkv":
        got = torch.cat([r["impls"][impl][key] for r in sorted(
            ranks, key=lambda r: r["tokens"])], dim=1)
        out[key] = windowed_error(got, ref[key])
    out["max"] = max(out.values())
    return out


def context_job(impl: str, steps: int = CONTEXT_STEPS):
    """Phase 9r's job: llama_1b's widths at max_seq CONTEXT_SEQ cut to
    CONTEXT_LAYERS layers, remat dots, adafactor, ``impl`` attention;
    CONTEXT_ROWS rows of CONTEXT_SEQ with ragged masks a step in
    CONTEXT_ACCUM micro batches (one place in the batch axes)."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    cfg = dataclasses.replace(llama.llama_1b(remat="dots", attn_impl=impl),
                              max_seq=CONTEXT_SEQ, n_layers=CONTEXT_LAYERS)
    return wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                            total_steps=1000, grad_accum=CONTEXT_ACCUM,
                            optimizer="adafactor"),
                  local_batch=CONTEXT_ROWS, seq=CONTEXT_SEQ, steps=steps,
                  mask=True)


def context_launches(cfg, index: int, impl: str, micro: int) -> dict:
    """The flash launches a context rank of index ``index`` makes over
    ``micro`` micro batches: per layer and micro batch the ring runs its
    diagonal block and the ``index`` blocks before it (Ulysses one call
    over the whole sequence), its forward twice under remat dots (the
    recompute) and its backward once."""
    calls = index + 1 if impl == "ring" else 1
    per = cfg.n_layers * micro * calls
    return {"flash_attention_fwd": 2 * per, "flash_attention_dq": per,
            "flash_attention_dkv": per}


def context_reference(torch, job) -> dict:
    """The one process of phases 9r and 9p: ``job`` with attn_impl
    "flash" and the plain forward, eager, on the rows of the world's one
    place in the batch axes: its metrics, step seconds and peak
    memory."""
    import dataclasses

    from kubeflow_tpu_torch.tools import world_train as wt

    one = dataclasses.replace(job, config=dataclasses.replace(
        job.config, attn_impl="flash"))
    free_card(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = wt.make_trainer(one, torch.device("cuda"))
    metrics, seconds = [], []
    for step in range(job.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(wt.batch_for(job, step, 0))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated() - base
    del trainer
    free_card(torch)
    return {"metrics": metrics, "seconds": seconds, "peak_allocated": peak}


def card_pair_world(torch, phases: dict) -> dict:
    """The world of phases 9t, 9m, 9r, 9rm and 9p: two ranks on one card
    over gloo, spawned once for all (a rank's start, its first steps'
    warm-up and its kernels' builds are paid once), running each phase's
    plans (``world_train.plans_rank``) in turn. ``phases``: {phase: its
    plans}; returns {phase: per rank, the results of its plans}."""
    import tempfile

    from kubeflow_tpu_torch.tools import world_train as wt

    plans = [p for own in phases.values() for p in own]
    free_card(torch)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kft-phase9-pair-") as rundir:
        results = wt.run(wt.plans_rank, (plans,), 1, 1,
                         ["cuda:0"] * CONTEXT, rundir, context=CONTEXT)
    log(f"phases {', '.join(phases)}: their world of two ranks on one "
        f"card (gloo) took {time.perf_counter() - t0:.1f} s")
    out, at = {}, 0
    for name, own in phases.items():
        out[name] = [r[at:at + len(own)] for r in results]
        at += len(own)
    return out


def context_plans() -> list:
    """Phase 9r's plans (``world_train.plans_rank``): the ring layer, then
    the ring and the Ulysses trainers, each over context=CONTEXT."""
    from kubeflow_tpu_torch.tools import world_train as wt

    plans = [(1, 1, 1, 1, CONTEXT, wt.attention_layer_rank,
              (context_layer_inputs, ("ring", "ring_plain", "ulysses")))]
    return plans + [(1, 1, 1, 1, CONTEXT, wt.train_rank,
                     (context_job(impl),)) for impl in ("ring", "ulysses")]


def context_world_phase(torch, results: list) -> dict:
    """Phase 9r: context parallelism, two ranks on one card over gloo
    (module docstring). ``results``: per rank, those of
    ``context_plans`` (``card_pair_world``)."""
    import math

    from kubeflow_tpu_torch.tools import world_train as wt

    t_phase = time.perf_counter()
    jobs = {impl: context_job(impl) for impl in ("ring", "ulysses")}
    cfg = jobs["ring"].config
    log(f"phase 9r: llama_1b widths at max_seq {CONTEXT_SEQ}, "
        f"{cfg.n_layers} of 16 layers, remat=dots, adafactor, "
        f"{CONTEXT_ROWS} rows of {CONTEXT_SEQ} + 1 tokens with ragged masks "
        f"a step in {CONTEXT_ACCUM} micro batches, context={CONTEXT} on "
        f"{['cuda:0'] * CONTEXT} (gloo): ring then ulysses, {CONTEXT_STEPS} "
        f"eager steps each; the ring layer at B={CONTEXT_LAYER['B']} "
        f"S={CONTEXT_SEQ} H={CONTEXT_LAYER['H']} KV={CONTEXT_LAYER['KVH']} "
        f"D={CONTEXT_LAYER['D']} causal bf16")
    layer_ref = wt.attention_layer_rank(None, context_layer_inputs,
                                        ("flash",), device="cuda")
    ref = context_reference(torch, jobs["ring"])
    ref_s = time.perf_counter() - t_phase
    failed = []
    out = {"reference_s": ref_s, "launches": {}, "reference": ref}
    # (i) the ring layer alone
    layers = [r[0] for r in results]
    one = layer_ref["impls"]["flash"]
    plain = {k: torch.cat([r["impls"]["ring_plain"][k] for r in sorted(
        layers, key=lambda r: r["tokens"])], dim=1) for k in "oqkv"}
    read = {"ring_vs_flash": context_layer_readings(layers, "ring", one),
            "ring_vs_plain": context_layer_readings(layers, "ring", plain),
            "plain_vs_flash": context_layer_readings(layers, "ring_plain",
                                                     one),
            "ulysses_vs_flash": context_layer_readings(layers, "ulysses",
                                                       one)}
    out["layer"] = read
    for r, lay in enumerate(layers):
        c = r % CONTEXT
        calls = {impl: lay["impls"][impl]["launches"] for impl in
                 ("ring", "ring_plain", "ulysses")}
        want = {"ring": dict.fromkeys(calls["ring"], c + 1),
                "ring_plain": dict.fromkeys(calls["ring"], 0),
                "ulysses": dict.fromkeys(calls["ring"], 1)}
        ctx = {k: lay["timings"][k]
               for k in ("context_calls", "context_bytes", "context_s")}
        log(f"phase 9r (i) rank {r}: the layer's flash launches {calls} "
            f"(reckoned {want}); context collectives {ctx}")
        if calls != want:
            failed.append(f"layer rank {r}: launches {calls}, expected {want}")
    log(f"phase 9r (i): the ring layer at full width, largest relative "
        f"error over {CONTEXT_WINDOW}-position windows (o, dq, dk, dv): "
        f"ring vs one-process flash {read['ring_vs_flash']!r} (limit "
        f"{CONTEXT_LAYER_ERR['flash']}); ring vs the plain ring "
        f"{read['ring_vs_plain']!r} (limit {CONTEXT_LAYER_ERR['plain']}); "
        f"plain ring vs flash {read['plain_vs_flash']!r}; ulysses vs flash "
        f"{read['ulysses_vs_flash']!r} (limit {CONTEXT_LAYER_ERR['flash']})")
    if read["ring_vs_flash"]["max"] > CONTEXT_LAYER_ERR["flash"] \
            or read["ulysses_vs_flash"]["max"] > CONTEXT_LAYER_ERR["flash"] \
            or read["ring_vs_plain"]["max"] > CONTEXT_LAYER_ERR["plain"]:
        failed.append(f"the layer over context={CONTEXT} is not one "
                      f"process's ({read})")
    # (ii) the steps
    for i, (impl, job) in enumerate(jobs.items()):
        ranks = [r[1 + i] for r in results]
        for r, res in enumerate(ranks):
            run = res["runs"]["eager"]
            want = context_launches(cfg, r % CONTEXT, impl,
                                    CONTEXT_ACCUM * job.steps)
            ctx = [{k: c[k] for k in ("context_calls", "context_bytes",
                                      "context_s", "gloo_s")}
                   for c in run["collectives"]]
            log(f"phase 9r {impl} rank {r}: backend "
                f"{res['backend']['backend']} ({res['backend']['reason']}); "
                f"step s {run['seconds']!r}; context collectives per step "
                f"{ctx!r}; all collectives per step {run['collectives']!r}; "
                f"peak {run.get('peak_allocated')} B allocated, "
                f"{run.get('peak_reserved')} B reserved (one process "
                f"{ref['peak_allocated']} B); state kept "
                f"{run['state_bytes']} (reachable {run['held_bytes']} B); "
                f"flash launches {run['launches']} (reckoned {want}); losses "
                f"{[m['loss'] for m in run['metrics']]!r} grad norms "
                f"{[m['grad_norm'] for m in run['metrics']]!r}")
            if run["launches"] != want:
                failed.append(f"{impl} rank {r}: flash launches "
                              f"{run['launches']}, expected {want}")
            if run["held_bytes"] != run["state_bytes"]["total"]:
                failed.append(f"{impl} rank {r}: state_bytes "
                              f"{run['state_bytes']['total']} B, reachable "
                              f"{run['held_bytes']} B")
        world = [res["runs"]["eager"]["metrics"] for res in ranks]
        rd = world_readings(world, ref)
        log(f"phase 9r {impl}: against one process with attn_impl=flash on "
            f"the same rows ({job.steps} steps): loss {rd['loss']!r} (limit "
            f"{CONTEXT_RTOL[impl]['loss']}), grad norm {rd['grad_norm']!r} "
            f"(limit {CONTEXT_RTOL[impl]['grad_norm']}) relative; tokens "
            f"equal {rd['tokens_equal']}; ranks' metrics equal "
            f"{world[0] == world[1]}; one process's losses "
            f"{[m['loss'] for m in ref['metrics']]!r}, grad norms "
            f"{[m['grad_norm'] for m in ref['metrics']]!r}, step s "
            f"{ref['seconds']!r}")
        out[impl] = {"readings": rd, "ranks": [
            {k: res["runs"]["eager"].get(k) for k in (
                "seconds", "collectives", "peak_allocated", "peak_reserved",
                "state_bytes", "launches")} for res in ranks]}
        out["launches"][impl] = {
            k: sum(res["runs"]["eager"]["launches"][k] for res in ranks)
            for k in ranks[0]["runs"]["eager"]["launches"]}
        if world[0] != world[1] or not rd["tokens_equal"] \
                or not all(math.isfinite(m["loss"]) for m in world[0]) \
                or any(rd[k] > v for k, v in CONTEXT_RTOL[impl].items()):
            failed.append(f"{impl}: the context={CONTEXT} steps are not one "
                          "process's on the same rows")
    log(f"phase 9r: references {ref_s:.1f} s; "
        f"{time.perf_counter() - t_phase:.1f} s after the world "
        f"({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9r: {failed}")
    return out


def context_world_nccl(torch) -> dict:
    """Phase 9r4: llama_1b uncut at max_seq CONTEXT4_SEQ over data=2 x
    context=2, one card a rank over NCCL, eager then replayed (module
    docstring). Skipped, and said so, on a machine with fewer than four
    cards."""
    import dataclasses
    import math
    import tempfile

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    zeros = dict.fromkeys(("flash_attention_fwd", "flash_attention_dq",
                           "flash_attention_dkv"), 0)
    n = torch.cuda.device_count()
    if n < 2 * CONTEXT:
        log(f"phase 9r4: skipped: llama_1b over data=2 x context={CONTEXT} "
            f"needs {2 * CONTEXT} cards, one a rank; this machine has {n}")
        return {"skipped": f"{n} card(s)", "launches": zeros}
    t_phase = time.perf_counter()
    free_card(torch)
    cfg = dataclasses.replace(llama.llama_1b(remat="dots", attn_impl="ring"),
                              max_seq=CONTEXT4_SEQ)
    job = wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                           total_steps=1000, grad_accum=CONTEXT4_ACCUM,
                           optimizer="adafactor"),
                 local_batch=CONTEXT4_ROWS, seq=CONTEXT4_SEQ,
                 steps=CONTEXT4_STEPS, mask=True,
                 runs=("eager", "replayed"), profile=True)
    devices = [f"cuda:{r}" for r in range(2 * CONTEXT)]
    log(f"phase 9r4: llama_1b, all {cfg.n_layers} layers, max_seq "
        f"{CONTEXT4_SEQ}, attn_impl=ring, remat=dots, adafactor, data=2 x "
        f"context={CONTEXT} on {devices}; each place {CONTEXT4_ROWS} rows of "
        f"{CONTEXT4_SEQ} in {CONTEXT4_ACCUM} micro batches; runs {job.runs} "
        f"of {job.steps} steps")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kft-phase9r4-") as rundir:
        ranks = wt.run(wt.train_rank, (job,), 2, 1, devices, rundir,
                       context=CONTEXT)
    wall_s = time.perf_counter() - t0
    tokens = 2 * CONTEXT4_ROWS * CONTEXT4_SEQ / len(devices)   # a card's
    failed, out = [], {"wall_s": wall_s, "ranks": []}
    launches = dict(zeros)
    for r, res in enumerate(ranks):
        rep, eag = res["runs"]["replayed"], res["runs"]["eager"]
        want = context_launches(cfg, r % CONTEXT, "ring",
                                CONTEXT4_ACCUM * job.steps)
        step_s = statistics.median(rep["seconds"][1:] or rep["seconds"])
        tok_s = tokens / step_s
        mfu = tok_s * cfg.flops_per_token(CONTEXT4_SEQ) / BF16_FLOPS
        metrics = [(m["loss"], m["grad_norm"]) for m in rep["metrics"]]
        bitwise = res["differ"] == [] and metrics == [
            (m["loss"], m["grad_norm"]) for m in eag["metrics"]]
        prof = rep.get("profile") or {}
        nccl_share = prof.get("nccl_busy_ms", 0) / max(prof.get("wall_ms", 1),
                                                       1e-9)
        ctx = [{k: c[k] for k in ("context_calls", "context_bytes",
                                  "context_s")} for c in eag["collectives"]]
        log(f"phase 9r4 rank {r}: backend {res['backend']['backend']}, micro "
            f"body {res.get('micro_mode')}, finish body "
            f"{res.get('finish_mode')}, capture "
            f"{res.get('capture_seconds')!r} s, pool {res.get('pool_bytes')} "
            f"B; eager step s {eag['seconds']!r}, replayed {rep['seconds']!r} "
            f"({tok_s!r} tok/s a card, MFU {mfu!r} at "
            f"flops_per_token({CONTEXT4_SEQ})); NCCL busy share "
            f"{nccl_share!r} of the traced step {prof!r}; eager context "
            f"collectives per step {ctx!r} (enqueue seconds); peak "
            f"{rep.get('peak_allocated')} B allocated, "
            f"{rep.get('peak_reserved')} B reserved; kept "
            f"{rep['state_bytes']}; flash launches eager {eag['launches']}, "
            f"replayed {rep['launches']} (reckoned {want}); losses "
            f"{[m[0] for m in metrics]!r}, grad norms "
            f"{[m[1] for m in metrics]!r}; replayed bitwise eager {bitwise} "
            f"(differing {res['differ']})")
        out["ranks"].append({"step_s": step_s, "tok_s_per_card": tok_s,
                             "mfu": mfu, "profile": prof, "bitwise": bitwise,
                             "nccl_share": nccl_share,
                             "peak_allocated": rep.get("peak_allocated")})
        for k in launches:
            launches[k] += rep["launches"][k]
        if not bitwise:
            failed.append(f"rank {r}: the replayed steps are not bitwise "
                          "the eager ones")
        if res["backend"]["backend"] != "nccl" \
                or res.get("micro_mode") != "graph" \
                or res.get("finish_mode") != "graph":
            failed.append(f"rank {r}: not both bodies captured over NCCL")
        if rep["launches"] != want or eag["launches"] != want:
            failed.append(f"rank {r}: flash launches {rep['launches']}, "
                          f"expected {want}")
        if not all(math.isfinite(m[0]) for m in metrics) or metrics != [
                (m["loss"], m["grad_norm"])
                for m in ranks[0]["runs"]["replayed"]["metrics"]]:
            failed.append(f"rank {r}: losses not finite or not rank 0's")
    out["launches"] = launches
    log(f"phase 9r4: {time.perf_counter() - t_phase:.1f} s "
        f"({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9r4: {failed}")
    return out


def moe_context_job(impl: str):
    """Phase 9rm's job: the MoE model (module docstring) with ``impl``
    attention; MOE_CONTEXT_ROWS rows of MOE_CONTEXT_SEQ with ragged masks
    a step in MOE_CONTEXT_ACCUM micro batches (one place in the batch
    axes)."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    cfg = dataclasses.replace(
        llama.llama_moe_8x(llama.llama_1b(remat="dots", attn_impl=impl)),
        max_seq=MOE_CONTEXT_SEQ, n_layers=MOE_CONTEXT_LAYERS)
    return wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                            total_steps=1000, grad_accum=MOE_CONTEXT_ACCUM,
                            optimizer="adafactor"),
                  local_batch=MOE_CONTEXT_ROWS, seq=MOE_CONTEXT_SEQ,
                  steps=MOE_CONTEXT_STEPS, mask=True,
                  router_scale=MOE_ROUTER_SCALE)


def moe_context_plans() -> list:
    """Phase 9rm's plans (``world_train.plans_rank``): the MoE layer on
    one of its micro batches, then the ring and the Ulysses trainers,
    each over context=CONTEXT."""
    import functools

    from kubeflow_tpu_torch.tools import world_train as wt

    layer = (functools.partial(moe_layer_inputs, MOE_CONTEXT_SEQ),
             MOE_LAYER_CASES)
    plans = [(1, 1, 1, 1, CONTEXT, wt.moe_layer_rank, layer)]
    return plans + [(1, 1, 1, 1, CONTEXT, wt.train_rank,
                     (moe_context_job(impl),)) for impl in ("ring", "ulysses")]


def moe_context_phase(torch, results: list) -> dict:
    """Phase 9rm: an MoE model under context parallelism, two ranks on
    one card over gloo (module docstring). ``results``: per rank, those
    of ``moe_context_plans`` (``card_pair_world``)."""
    import functools
    import math

    from kubeflow_tpu_torch.tools import world_train as wt

    t_phase = time.perf_counter()
    jobs = {impl: moe_context_job(impl) for impl in ("ring", "ulysses")}
    cfg = jobs["ring"].config
    log(f"phase 9rm: llama_1b widths with {cfg.n_experts} experts "
        f"(top-{cfg.moe_top_k}, capacity {cfg.moe_capacity_factor}, router "
        f"columns scaled 1 to 2.75) at max_seq {MOE_CONTEXT_SEQ}, "
        f"{cfg.n_layers} of 16 layers, remat=dots, adafactor, "
        f"{MOE_CONTEXT_ROWS} rows of {MOE_CONTEXT_SEQ} + 1 tokens with "
        f"ragged masks a step in {MOE_CONTEXT_ACCUM} micro batches, "
        f"context={CONTEXT} on "
        f"{['cuda:0'] * CONTEXT} (gloo, 9r's world): ring then ulysses, "
        f"{MOE_CONTEXT_STEPS} eager steps each; the layer alone on one "
        f"micro batch in float32")
    free_card(torch)
    layer_ref = wt.moe_layer_rank(
        None, functools.partial(moe_layer_inputs, MOE_CONTEXT_SEQ),
        MOE_LAYER_CASES, device="cuda")
    free_card(torch)
    ref = context_reference(torch, jobs["ring"])
    ref_s = time.perf_counter() - t_phase
    failed = []
    out = {"reference_s": ref_s, "launches": {}, "reference": ref}
    # (i) the layer alone
    layers = [r[0] for r in results]
    layer = moe_layer_readings(layers, layer_ref)
    del layer_ref
    out["layer"] = layer
    for r, lay in enumerate(layers):
        moe = {k: lay["timings"][k] for k in ("moe_calls", "moe_bytes",
                                              "moe_s")}
        log(f"phase 9rm (i) rank {r}: context {lay['context']}; MoE "
            f"collectives {moe}")
    log(f"phase 9rm (i): the MoE layer at full width in float32 (one micro "
        f"batch of 2 x {MOE_CONTEXT_SEQ} tokens, capacity "
        f"1.25, each rank its chunk of both rows) against one process: "
        f"output {layer['y']!r}, gradients {layer['grads']!r} of the largest "
        f"magnitude, aux {layer['aux']!r} relative, dropped fraction "
        f"{layer['dropped_fraction']!r} (the world's off by "
        f"{layer['dropped']!r}); limits {MOE_CONTEXT_LAYER_RTOL}")
    if any(layer[k] > MOE_CONTEXT_LAYER_RTOL[k]
           for k in MOE_CONTEXT_LAYER_RTOL) \
            or not layer["dropped_fraction"] > 0:
        failed.append(f"the MoE layer over context={CONTEXT} is not one "
                      f"process's ({layer})")
    # (ii) the steps
    for i, (impl, job) in enumerate(jobs.items()):
        ranks = [r[1 + i] for r in results]
        for r, res in enumerate(ranks):
            run = res["runs"]["eager"]
            want = context_launches(cfg, r % CONTEXT, impl,
                                    MOE_CONTEXT_ACCUM * job.steps)
            coll = [{k: c[k] for k in ("moe_calls", "moe_bytes", "moe_s",
                                       "context_calls", "context_bytes",
                                       "context_s", "gloo_s")}
                    for c in run["collectives"]]
            log(f"phase 9rm {impl} rank {r}: backend "
                f"{res['backend']['backend']} ({res['backend']['reason']}); "
                f"step s {run['seconds']!r}; MoE and context collectives "
                f"per step {coll!r}; peak {run.get('peak_allocated')} B "
                f"allocated, {run.get('peak_reserved')} B reserved (one "
                f"process {ref['peak_allocated']} B); state kept "
                f"{run['state_bytes']} (reachable {run['held_bytes']} B); "
                f"flash launches {run['launches']} (reckoned {want}); losses "
                f"{[m['loss'] for m in run['metrics']]!r} moe_aux "
                f"{[m['moe_aux'] for m in run['metrics']]!r} grad norms "
                f"{[m['grad_norm'] for m in run['metrics']]!r}")
            if run["launches"] != want:
                failed.append(f"{impl} rank {r}: flash launches "
                              f"{run['launches']}, expected {want}")
            if run["held_bytes"] != run["state_bytes"]["total"]:
                failed.append(f"{impl} rank {r}: state_bytes "
                              f"{run['state_bytes']['total']} B, reachable "
                              f"{run['held_bytes']} B")
        world = [res["runs"]["eager"]["metrics"] for res in ranks]
        rd = world_readings(world, ref)
        log(f"phase 9rm {impl}: against one process with attn_impl=flash "
            f"on the same rows ({job.steps} steps): loss {rd['loss']!r}, "
            f"moe_aux {rd['moe_aux']!r}, grad norm {rd['grad_norm']!r} "
            f"relative (limits {MOE_CONTEXT_RTOL[impl]}); tokens equal "
            f"{rd['tokens_equal']}; ranks' metrics equal "
            f"{world[0] == world[1]}; one process's losses "
            f"{[m['loss'] for m in ref['metrics']]!r}, moe_aux "
            f"{[m['moe_aux'] for m in ref['metrics']]!r}, grad norms "
            f"{[m['grad_norm'] for m in ref['metrics']]!r}, step s "
            f"{ref['seconds']!r}")
        out[impl] = {"readings": rd, "ranks": [
            {k: res["runs"]["eager"].get(k) for k in (
                "seconds", "collectives", "peak_allocated", "peak_reserved",
                "state_bytes", "launches")} for res in ranks]}
        out["launches"][impl] = {
            k: sum(res["runs"]["eager"]["launches"][k] for res in ranks)
            for k in ranks[0]["runs"]["eager"]["launches"]}
        if world[0] != world[1] or not rd["tokens_equal"] \
                or not all(math.isfinite(m["loss"]) for m in world[0]) \
                or any(rd[k] > v for k, v in MOE_CONTEXT_RTOL[impl].items()):
            failed.append(f"{impl}: the MoE model's context={CONTEXT} steps "
                          "are not one process's on the same rows")
    log(f"phase 9rm: references {ref_s:.1f} s; "
        f"{time.perf_counter() - t_phase:.1f} s after the world "
        f"({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9rm: {failed}")
    return out


def moe_context_nccl(torch) -> dict:
    """Phase 9rx4: the uncut MoE model over expert=2 x context=2, one card
    a rank over NCCL, eager then replayed (module docstring). Skipped,
    and said so, on a machine with fewer than four cards."""
    import dataclasses
    import math
    import tempfile

    from kubeflow_tpu_torch.tools import world_train as wt

    zeros = dict.fromkeys(("flash_attention_fwd", "flash_attention_dq",
                           "flash_attention_dkv"), 0)
    n = torch.cuda.device_count()
    if n < 2 * CONTEXT:
        log(f"phase 9rx4: skipped: the uncut MoE model over expert=2 x "
            f"context={CONTEXT} needs {2 * CONTEXT} cards, one a rank; this "
            f"machine has {n}")
        return {"skipped": f"{n} card(s)", "launches": zeros}
    t_phase = time.perf_counter()
    free_card(torch)
    base = moe_context_job("ring")
    cfg = dataclasses.replace(base.config, n_layers=16)
    job = dataclasses.replace(base, config=cfg, steps=MOE_NCCL_STEPS,
                              runs=("eager", "replayed"), profile=True)
    devices = [f"cuda:{r}" for r in range(2 * CONTEXT)]
    log(f"phase 9rx4: llama_1b widths with {cfg.n_experts} experts, all "
        f"{cfg.n_layers} layers, max_seq {MOE_CONTEXT_SEQ}, attn_impl=ring, "
        f"expert=2 x context={CONTEXT} on {devices}; {MOE_CONTEXT_ROWS} rows "
        f"of {MOE_CONTEXT_SEQ} in {MOE_CONTEXT_ACCUM} micro batches; runs "
        f"{job.runs} of {job.steps} steps")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kft-phase9rx4-") as rundir:
        ranks = wt.run(wt.train_rank, (job,), 1, 1, devices, rundir,
                       expert=2, context=CONTEXT)
    wall_s = time.perf_counter() - t0
    share = kept_share(cfg, {"expert": 2})
    tokens = MOE_CONTEXT_ROWS * MOE_CONTEXT_SEQ / len(devices)  # a card's
    failed, out = [], {"wall_s": wall_s, "ranks": [], "share": share}
    launches = dict(zeros)
    for r, res in enumerate(ranks):
        rep, eag = res["runs"]["replayed"], res["runs"]["eager"]
        want = context_launches(cfg, r % CONTEXT, "ring",
                                MOE_CONTEXT_ACCUM * job.steps)
        step_s = statistics.median(rep["seconds"][1:] or rep["seconds"])
        tok_s = tokens / step_s
        mfu = tok_s * cfg.flops_per_token(MOE_CONTEXT_SEQ) / BF16_FLOPS
        metrics = [(m["loss"], m["moe_aux"], m["grad_norm"])
                   for m in rep["metrics"]]
        bitwise = res["differ"] == [] and metrics == [
            (m["loss"], m["moe_aux"], m["grad_norm"]) for m in eag["metrics"]]
        prof = rep.get("profile") or {}
        nccl_share = prof.get("nccl_busy_ms", 0) / max(prof.get("wall_ms", 1),
                                                       1e-9)
        kept = rep["state_bytes"]
        coll = [{k: c[k] for k in ("moe_calls", "moe_bytes", "context_calls",
                                   "context_bytes")}
                for c in eag["collectives"]]
        log(f"phase 9rx4 rank {r}: backend {res['backend']['backend']}, "
            f"micro body {res.get('micro_mode')}, finish body "
            f"{res.get('finish_mode')}, capture "
            f"{res.get('capture_seconds')!r} s, pool {res.get('pool_bytes')} "
            f"B; eager step s {eag['seconds']!r}, replayed {rep['seconds']!r} "
            f"({tok_s!r} tok/s a card, MFU {mfu!r} at "
            f"flops_per_token({MOE_CONTEXT_SEQ}), active top-k); NCCL busy "
            f"share {nccl_share!r} of the traced step {prof!r}; eager MoE "
            f"and context collectives per step {coll!r} (enqueue); peak "
            f"{rep.get('peak_allocated')} B allocated, "
            f"{rep.get('peak_reserved')} B reserved; kept {kept}; flash "
            f"launches eager {eag['launches']}, replayed {rep['launches']} "
            f"(reckoned {want}); losses, moe_aux, grad norms {metrics!r}; "
            f"replayed bitwise eager {bitwise} (differing {res['differ']})")
        out["ranks"].append({"step_s": step_s, "tok_s_per_card": tok_s,
                             "mfu": mfu, "profile": prof, "bitwise": bitwise,
                             "nccl_share": nccl_share,
                             "peak_allocated": rep.get("peak_allocated")})
        for k in launches:
            launches[k] += rep["launches"][k]
        if not bitwise:
            failed.append(f"rank {r}: the replayed steps are not bitwise "
                          "the eager ones")
        if res["backend"]["backend"] != "nccl" \
                or res.get("micro_mode") != "graph" \
                or res.get("finish_mode") != "graph":
            failed.append(f"rank {r}: not both bodies captured over NCCL")
        if rep["launches"] != want or eag["launches"] != want:
            failed.append(f"rank {r}: flash launches {rep['launches']}, "
                          f"expected {want}")
        if kept["params"] != 4 * share["kept"]:
            failed.append(f"rank {r}: keeps {kept}, expected "
                          f"{4 * share['kept']} B of parameters")
        if not all(math.isfinite(m[0]) for m in metrics) or metrics != [
                (m["loss"], m["moe_aux"], m["grad_norm"])
                for m in ranks[0]["runs"]["replayed"]["metrics"]]:
            failed.append(f"rank {r}: metrics not finite or not rank 0's")
    out["launches"] = launches
    log(f"phase 9rx4: {time.perf_counter() - t_phase:.1f} s "
        f"({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9rx4: {failed}")
    return out


def pipeline_job(cfg, steps: int, **fields):
    """Phase 9p's job on ``cfg``: adafactor (phase 7's optimizer and
    schedule), PIPELINE_ROWS rows of TRAIN_SEQ + 1 tokens with ragged
    masks a step in one trainer micro batch, PIPELINE_MICRO pipeline
    micro batches (one place in the batch axes)."""
    from kubeflow_tpu_torch.tools import world_train as wt

    return wt.Job(cfg, dict(learning_rate=3e-4, warmup_steps=10,
                            total_steps=1000, grad_accum=1,
                            optimizer="adafactor"),
                  local_batch=PIPELINE_ROWS, seq=TRAIN_SEQ, steps=steps,
                  mask=True, microbatches=PIPELINE_MICRO, **fields)


def pipeline_launches(layers: int, micro: int) -> dict:
    """The flash launches a stage of ``layers`` layers makes over
    ``micro`` pipeline micro batches: per layer and micro batch its
    forward twice under remat dots (the recompute), dQ and dK/dV once."""
    per = layers * micro
    return {"flash_attention_fwd": 2 * per, "flash_attention_dq": per,
            "flash_attention_dkv": per}


def pipeline_stage_bytes(cfg) -> int:
    """The float32 bytes of the parameters a stage rank keeps: its
    stage's share of every layer and the whole rest (the embedding, the
    final norm; an untied head)."""
    import math

    from kubeflow_tpu_torch.models import llama

    shapes = llama.param_shapes(cfg)
    layers = shapes.pop("layers")
    per_layer = sum(math.prod(s[1:]) for s in layers.values())
    rest = sum(math.prod(s) for s in shapes.values())
    return 4 * (per_layer * cfg.n_layers // PIPELINE + rest)


def pipeline_plan() -> tuple:
    """Phase 9p's plan (``world_train.plans_rank``): its job over
    pipeline=PIPELINE (two ranks), run after phase 9r's plans in their
    world (``card_pair_world``: its ranks are already up and warm)."""
    import dataclasses

    from kubeflow_tpu_torch.models import llama
    from kubeflow_tpu_torch.tools import world_train as wt

    cfg = dataclasses.replace(llama.llama_1b(remat="dots", attn_impl="flash"),
                              n_layers=PIPELINE_LAYERS)
    job = pipeline_job(cfg, PIPELINE_STEPS, profile=True)
    return (1, 1, 1, 1, 1, PIPELINE, wt.train_rank, (job,))


def pipeline_world_phase(torch, ranks: list) -> dict:
    """Phase 9p: the GPipe pipeline, two ranks on one card over gloo
    (module docstring). ``ranks``: per rank, the result of
    ``pipeline_plan`` (``card_pair_world``)."""
    import dataclasses
    import math

    t_phase = time.perf_counter()
    job = pipeline_plan()[-1][0]
    cfg = job.config
    devices = ["cuda:0"] * PIPELINE
    stage_layers = cfg.n_layers // PIPELINE
    bubble = (PIPELINE - 1) / (PIPELINE_MICRO + PIPELINE - 1)
    free_card(torch)
    log(f"phase 9p: llama_1b widths, {cfg.n_layers} of 16 layers "
        f"({stage_layers} a stage), remat=dots, attn_impl=flash, adafactor, "
        f"{PIPELINE_ROWS} rows of {TRAIN_SEQ} + 1 tokens with ragged masks a "
        f"step in {PIPELINE_MICRO} pipeline micro batches, pipeline="
        f"{PIPELINE} on {devices} (gloo, in the world it shares with phase "
        f"9r), "
        f"{PIPELINE_STEPS} eager steps")
    t1 = time.perf_counter()
    ref = context_reference(torch, dataclasses.replace(
        job, trainer={**job.trainer, "grad_accum": PIPELINE_MICRO}))
    ref_s = time.perf_counter() - t1
    want = pipeline_launches(stage_layers, PIPELINE_MICRO * job.steps)
    kept = pipeline_stage_bytes(cfg)
    failed = []
    out = {"reference_s": ref_s, "reference": ref, "bubble_share": bubble,
           "ranks": []}
    for r, res in enumerate(ranks):
        run = res["runs"]["eager"]
        pipe = [{k: c[k] for k in ("pipeline_calls", "pipeline_bytes",
                                   "pipeline_s", "gloo_s")}
                for c in run["collectives"]]
        prof = run.get("profile") or {}
        log(f"phase 9p rank {r} (stage {r}): backend "
            f"{res['backend']['backend']} ({res['backend']['reason']}); step "
            f"s {run['seconds']!r}; pipeline collectives per step {pipe!r}; "
            f"bubble share {bubble!r} against the traced last step's idle "
            f"share {prof.get('idle_share')!r} ({prof!r}); peak "
            f"{run.get('peak_allocated')} B allocated, "
            f"{run.get('peak_reserved')} B reserved (one process "
            f"{ref['peak_allocated']} B); state kept {run['state_bytes']} "
            f"(reachable {run['held_bytes']} B; parameters reckoned {kept} "
            f"B: the stage and the whole rest); flash launches "
            f"{run['launches']} (reckoned {want}); losses "
            f"{[m['loss'] for m in run['metrics']]!r} grad norms "
            f"{[m['grad_norm'] for m in run['metrics']]!r}")
        out["ranks"].append({k: run.get(k) for k in (
            "seconds", "collectives", "peak_allocated", "peak_reserved",
            "state_bytes", "launches", "profile")})
        if run["launches"] != want:
            failed.append(f"rank {r}: flash launches {run['launches']}, "
                          f"expected {want}")
        if run["held_bytes"] != run["state_bytes"]["total"] \
                or run["state_bytes"]["params"] != kept:
            failed.append(f"rank {r}: state_bytes {run['state_bytes']}, "
                          f"reachable {run['held_bytes']} B, parameters "
                          f"reckoned {kept} B")
    world = [res["runs"]["eager"]["metrics"] for res in ranks]
    rd = world_readings(world, ref)
    cut = PIPELINE_UPDATED
    rd["loss"] = world_readings([w[:cut] for w in world],
                                {"metrics": ref["metrics"][:cut]})["loss"]
    rd["updated_loss"] = world_readings(
        [w[cut:] for w in world], {"metrics": ref["metrics"][cut:]})["loss"]
    out["readings"] = rd
    out["launches"] = {k: sum(res["runs"]["eager"]["launches"][k]
                              for res in ranks) for k in want}
    log(f"phase 9p: against one process with the plain forward (flash) on "
        f"the same rows ({job.steps} steps): loss {rd['loss']!r} before step "
        f"{cut} (limit {PIPELINE_RTOL['loss']}), {rd['updated_loss']!r} "
        f"from it on (limit {PIPELINE_RTOL['updated_loss']}), grad norm "
        f"{rd['grad_norm']!r} (limit {PIPELINE_RTOL['grad_norm']}) "
        f"relative; tokens equal "
        f"{rd['tokens_equal']}; ranks' metrics equal {world[0] == world[1]}; "
        f"one process's losses {[m['loss'] for m in ref['metrics']]!r}, "
        f"grad norms {[m['grad_norm'] for m in ref['metrics']]!r}, step s "
        f"{ref['seconds']!r}")
    if world[0] != world[1] or not rd["tokens_equal"] \
            or not all(math.isfinite(m["loss"]) for m in world[0]) \
            or any(rd[k] > v for k, v in PIPELINE_RTOL.items()):
        failed.append(f"the pipeline={PIPELINE} steps are not one "
                      "process's on the same rows")
    steps_s = [sum(r["seconds"]) for r in out["ranks"]]
    log(f"phase 9p: steps per rank {steps_s!r} s, reference {ref_s:.1f} s; "
        f"{time.perf_counter() - t_phase:.1f} s after the world "
        f"({nvidia_smi_line()})")
    if failed:
        raise SystemExit(f"phase 9p: {failed}")
    return out


def row3(sharded: dict, tp: dict, spec_tp: dict, disagg: dict,
         moe_tp: dict, moe_ep: dict, moe_tp_all: dict) -> dict:
    """The kernel line's entry of the sharded call: one rank's launch
    timed (phase 3s); launches summed over the ranks of phase 4tp's bf16
    run, phase 5s's tensor=4 run, phase 5dt's mesh decode tier (bf16 and
    int8 KV) and phases 5n's, 5e's and 5x's MoE runs (per rank beside
    them, and phase 4tp's int8 run's)."""
    by_phase = {"4tp": sum(tp["bf16"]["launches_per_rank"]),
                "5s": sum(spec_tp["launches_per_rank"]),
                "5dt": sum(sum(disagg[k]["mesh"]["launches_per_rank"])
                           for k in ("bf16", "int8")),
                "5n": sum(moe_tp["launches_per_rank"]),
                "5e": sum(moe_ep["launches_per_rank"]),
                "5x": sum(moe_tp_all["launches_per_rank"])}
    return {
        "name": "paged_decode_attention_sharded", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "kubeflow_tpu/ops/pallas_paged_attention.py:257",
        "launches": sum(by_phase.values()),
        "launches_by_phase": by_phase,
        "launches_per_rank": tp["bf16"]["launches_per_rank"],
        "launches_per_rank_5s": spec_tp["launches_per_rank"],
        "launches_per_rank_5n": moe_tp["launches_per_rank"],
        "launches_per_rank_5dt": {
            k: disagg[k]["mesh"]["launches_per_rank"]
            for k in ("bf16", "int8")},
        "launches_per_rank_5e": moe_ep["launches_per_rank"],
        "launches_per_rank_int8": tp["int8"]["launches_per_rank"],
        **{k: sharded[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")},
        # no PyTorch call reads a paged pool: SDPA over the rank's dense
        # view is a yardstick only
        "library_ms": None, "sdpa_dense_view_ms": sharded["sdpa_dense_view_ms"],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from kubeflow_tpu_torch.ops import cuda_build
        from kubeflow_tpu_torch.ops import paged_attention as pa
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe(torch, cuda_build)
    errs = parity(torch, pa)
    t = timing(torch, pa)
    q_errs = quant_parity(torch, pa)
    q_t = quant_timing(torch, pa)
    sharded = sharded_kernel(torch, pa)
    cfg, params = llama3_8b(torch)
    served = serving(torch, pa, cfg, params)
    q_served = quant_serving(torch, pa, cfg, params, served)
    quant_quality(torch, cfg, params, q_served.pop("qparams"))
    graphed = graph_phase(torch, pa, cfg, params)
    tp = tp_serving(torch, pa, cfg, params)
    for tag, one in (("bf16", served), ("int8", q_served)):
        log(f"decode step, batch 8, {tag}: as served, one card "
            f"{tp[tag]['one_card_ms_per_step']!r} ms and tensor={TP} "
            f"{tp[tag]['decode_ms_per_step']!r} ms; paged_decode_step "
            f"alone on one card (phase 4/4q) {one['decode_ms_per_step']!r} "
            f"ms")
    spec = spec_phase(torch, pa, cfg, params, tp)
    disagg = disagg_phase(torch, pa)
    del params
    free_card(torch)
    moe_served = moe_serving(torch, pa)
    moe_tp = moe_tp_serving(torch, pa, moe_served)
    moe_ep = moe_ep_serving(torch, pa, moe_served,
                            moe_tp["decode_ms_per_step"])
    moe_tp_all = moe_tp_full(torch, pa)
    flash_errs = flash_parity(torch)
    flash_t = flash_timing(torch)
    trained = training(torch)
    moe_trained = moe_training(torch)
    resumed = resume_phase(torch)
    world = world_phase(torch)
    pair = card_pair_world(torch, {"9t": [tensor_plan()],
                                   "9m": moe_world_plans(),
                                   "9r": context_plans(),
                                   "9rm": moe_context_plans(),
                                   "9p": [pipeline_plan()]})
    world["tensor"] = tensor_training(torch, world["ref_metrics"],
                                      [r[0] for r in pair["9t"]])
    moe_world = moe_world_phase(torch, pair["9m"])
    moe_nccl = moe_world_nccl(torch)
    context = context_world_phase(torch, pair["9r"])
    moe_context = moe_context_phase(torch, pair["9rm"])
    pipeline = pipeline_world_phase(torch, [r[0] for r in pair["9p"]])
    context_nccl = context_world_nccl(torch)
    moe_context_x4 = moe_context_nccl(torch)
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "kubeflow_tpu/ops/pallas_paged_attention.py:65",
        "launches": (served["launches"] + graphed["bf16"]["launches"]
                     + spec["bf16"]["launches"]
                     + disagg["bf16"]["launches"]
                     + disagg["bf16"]["mesh"]["launches_one"]
                     + moe_served["launches"]),
        "launches_by_phase": {"4": served["launches"],
                              "4g": graphed["bf16"]["launches"],
                              "5s": spec["bf16"]["launches"],
                              "5d": disagg["bf16"]["launches"],
                              "5dt": disagg["bf16"]["mesh"]["launches_one"],
                              "5m": moe_served["launches"]},
        "max_abs_err": errs["bfloat16"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
    }, {
        "name": "paged_decode_attention_quant", "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "kubeflow_tpu/ops/pallas_paged_attention.py:68",
        "launches": (q_served["launches"] + graphed["int8"]["launches"]
                     + spec["int8"]["launches"]
                     + disagg["int8"]["launches"]
                     + disagg["int8"]["mesh"]["launches_one"]
                     + moe_served["int8_launches"]),
        "launches_by_phase": {"4q": q_served["launches"],
                              "4g": graphed["int8"]["launches"],
                              "5s": spec["int8"]["launches"],
                              "5d": disagg["int8"]["launches"],
                              "5dt": disagg["int8"]["mesh"]["launches_one"],
                              "5m": moe_served["int8_launches"]},
        # the served pool's dtype (int8) in the top-level numbers; both
        # pool dtypes under by_kv_dtype. No PyTorch call reads a
        # quantized paged pool: SDPA over the dequantized dense view is
        # a yardstick only (sdpa_dense_view_ms)
        "max_abs_err": max(e["bfloat16"] for e in q_errs.values()),
        **{k: q_t["int8"][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")},
        "library_ms": None,
        "by_kv_dtype": {kv: {"max_abs_err": q_errs[kv], **q_t[kv]}
                        for kv in KV_QMAX},
    }, row3(sharded, tp, spec["tp"], disagg, moe_tp, moe_ep, moe_tp_all)]
    for name, line in (("flash_attention_fwd", 54),
                       ("flash_attention_dq", 135),
                       ("flash_attention_dkv", 170)):
        by_phase = {"7": trained["launches"][name],
                    "7m": moe_trained["launches"][name],
                    "8": resumed["launches"][name],
                    "9": sum(w[name] for w in world["launches"].values()),
                    "9t": world["tensor"]["launches"][name],
                    "9c": world["zero3"]["launches"][name],
                    "9d": world["tensor_zero3"]["launches"][name],
                    "9m": sum(w[name] for w in
                              moe_world["launches"].values()),
                    "9x": moe_nccl["launches"][name],
                    "9r": sum(w[name] for w in context["launches"].values()),
                    "9rm": sum(w[name] for w in
                               moe_context["launches"].values()),
                    "9r4": context_nccl["launches"][name],
                    "9rx4": moe_context_x4["launches"][name],
                    "9p": pipeline["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/{name}.cu",
            "replaces": f"kubeflow_tpu/ops/pallas_attention.py:{line}",
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": flash_errs[name], **flash_t[name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
