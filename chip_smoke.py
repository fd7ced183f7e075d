#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA GPU (built for the H100, sm_90a).

    python3 chip_smoke.py

Phases (any failed check exits non-zero; they run in the order 1, 2, 4, 5,
8, 6, 7, 9, 10, 11, 12, 13, 14, 3, 15, so that phase 3 can replay what
phases 2, 4, 5, 6, 7 and 13 handed the kernels, phase 8's graphs are
freed before phase 6 loads its model, and each LM's weights before the
next LM's; phase 15's dry runs run in subprocesses on the host's CPU
while phase 3 times the kernels from CUDA graphs):

1. Probe and build: the card's name and power limit, TF32 off for the dense
   oracles, the CUDA kernels (B1-B10 and B10's backward) built from
   src/repro_torch/csrc.
2. VGG16 at 224x224, full widths, batch 4 (four requests), f32 events.
   He weights from a seeded torch.Generator with weight sparsity 0.5,
   inputs relu(normal).  Every kernel's launch counter is set to 0 just
   before the chained forward and read just after; the kernels of the path
   (B1-B4) must have launched, as the route plan says, the int8 ones not.
   Each wrapper's ``capture`` list collects the inputs of its launches.
   Each layer's launches, in forward order, are those of the launch
   accounting (``check_layer_plans``: a strip conv one B3 launch with
   ``fused_conv_plan``'s subtaps and grid, a per-tap conv k x k B2
   launches, a pool one B4a / B4b launch over ``pool_window_plan`` /
   ``pool_plan``'s grid, an FC one B2 launch).
   The trace must hold no fallback_decode, the plan no densify point;
   chained == round-trip bitwise; logits within 5e-3 of the dense oracle
   and within 1e-4 of its largest magnitude.  Prints the warm forward time
   (median of 3) and a device profile (busy, idle share, ms by kernel).
   Then the main path: the same forward as one CUDA graph
   (``models.cnn.make_cnn_pipeline``), counts set to 0 just before its
   first call (warm-up, capture, one replay) and read just after: the
   launches the capture saw, times the replays, are the route plan's (the
   kernels line reports them), the trace records the capture saw pass the
   same checks, the replay is bitwise the eager forward, and a replay on
   a second input (made under set_sync_debug_mode("error")) is bitwise
   the eager forward on it.  Prints the warm replay time (median of 5)
   and its profile.
4. The same VGG16@224 batch 4 with int8 event values
   (FireConfig(quantize_to_int8=True)): counts as in phase 2, the path is
   B3 (conv1_1, f32 input), B6, B5 (per-tap convs and FCs) and B4; the
   int8 chain == its fake-quant round-trip twin bitwise; zero
   fallback_decode and densify.  The twin layer by layer against plain
   torch (teacher_forced: every conv/FC within 1e-4 of max|plain| on the
   twin's own input, every fired map the int8 fake quant of its
   accumulator, every code the plain product's except at a rounding tie),
   and the logits against the free-running dense int8 oracle, whose codes
   rounding ties move (allclose 5e-3; the ratio printed beside how far
   noise of 1e-7 of each input value moves the oracle itself).  Prints
   the gap to the f32 logits, the warm forward time and a profile; then
   its pipeline, checked and timed as in phase 2.
5. LeNet-300-100 (784-300-100-10) at batch 128, weight sparsity 0.5,
   seeded non-negative inputs with a fifth of them non-zero, in f32 and in
   int8: launch counts per mode (f32: B2 x3, B1 x2; int8: B2 x1 for the
   dense head, B5 x2), chained == round trip bitwise, the f32 logits
   within 2e-4 of the dense oracle, the int8 ones checked as in phase 4;
   warm forward times; each mode's pipeline checked and timed as in phase
   2 (``models.mlp.make_mlp_pipeline``).
8. The serving tier (``repro_torch.serving.ServeEngine``), VGG16@224 f32
   with phase 2's weights and LeNet-300-100 with phase 5's, each through
   the default buckets (1, 8, 32, 128), one CUDA graph a bucket captured
   at startup.  Requests relu(normal) from a seed, arriving (1, 3, 0, 8,
   20, 33, 200) a tick: every bucket, an idle tick, 33 padded into 128, a
   tick larger than the largest bucket.  Counts set to 0 just before the
   engine is built and read just after the last tick: the path's kernels
   launched and none off it, and each bucket's capture saw the route plan
   (the kernels line reports the traffic's launches captured x replayed,
   the warm-up's replays not counted, as ``serve_launches``).  4 captures
   after the warm-up, flat over every tick; every request served FIFO in
   the tick it arrived, through the batches ``plan_tick`` names; zero
   fallback_decodes and densify points in every bucket's boundary report
   (LeNet: no re-tile either); within every bucket, n real rows plus zeros
   bitwise the rows of a bucket full of real requests; every served
   request's logits bitwise its own bucket-1 replay; every served batch,
   in every bucket, within 5e-3 and 1e-4 of max|dense| of the dense oracle
   on the same rows.  VGG16: the eager forward of the first full bucket
   of 128 bitwise its served rows, its heaviest launch of B1, B2 (FC1),
   B3 and both pools kept for phase 3.  Prints requests/s,
   p50/p99 overall and per bucket, time to first response, warm-up and
   capture seconds and graph memory per bucket, per full bucket the host
   staging, the host-to-device copy, the replay and the whole forward,
   and a profile of the bucket-128 replay.  ``run_with_stats`` on the
   first VGG16 request and ``run_mlp_with_stats`` on the first LeNet one:
   logits bitwise the eager forward's, per-layer event and dense MACs.
6. RWKV6-7B served at its published widths (32 layers, d_model 4096,
   64x64 heads, d_ff 14336, vocab 65536; random f32 weights from seed 0
   plus their bf16 copy, ~45 GB) through the port's serve driver
   (``launch.serve.run_lm``: prefill, then the greedy decode loop), batch
   4, prompt 32, 16 tokens.  The main path is the config as published:
   MNF on at θ = 0, bf16.  B7 must launch 32 x 16 times in each gated
   decode and never in the ungated one, B1-B6 and B8-B10 never, nor in the
   prefill; every recurrent_step
   record chained on route "event", no fallback_decode; every B7 launch
   of the main path and of a θ > 0 run replayed against the plain version
   (S' bitwise, o within 1e-4 of max|plain|); that θ, picked as the 0.4
   quantile of the main path's block max|k|, kills at least a quarter of
   the (row, K-block) pairs; the main-path launch with the most dead pairs
   replayed on the all-live drive of the same values (encode at threshold
   -1): o and S' bitwise (DESIGN.md §13's within-backend contract); in f32
   the gated decode, teacher-forced on the ungated decode's inputs, within
   1e-4 of max|logits| at every step.
   Prints prefill ms, decode tokens/s (gated θ=0, gated θ>0, ungated,
   bf16), events per token, how many greedy tokens the gated and ungated
   decodes share, and a profile line.  The per-launch checks run on eager
   serves (``run_lm(graph=False)``); the main path is the graphed serve
   (``run_lm``: the prefill and the decode step as CUDA graphs sharing a
   pool), counts set to 0 just before and read just after: B7 counts 32
   at capture x 16 replays = 512, the kernels line reports that; the
   graphed serves at θ = 0, θ > 0 and ungated each give their eager
   serve's tokens, events, prefill and step logits and final cache
   bitwise, with no host sync in the decode loop (``run_lm`` holds it
   under set_sync_debug_mode("error")).  Prints prefill ms and tokens/s
   eager and graphed (2 runs each, in turns), the warm-up and capture
   seconds, the graphs' peak memory above the model, and the gated /
   ungated tokens/s ratio on graphs.  The prefill runs the chunked WKV6
   form (plain torch); the exact recurrence B9/B9' runs as an op on what
   it computes: the (r, k, v, w, u) that the prefill hands
   ``ssm.wkv6_chunked`` at every layer at prompt 32, and at layer 0 of one
   prefill at prompt 2000, are recorded, and B9' runs once on each as
   they lie (33 launches: bf16 r, k, v and f32 w, (B, H, T, D) views of
   (B, T, H, D), w not clamped), S bitwise and o within 1e-4 of
   max|plain| against the plain version; B9 once on each head of layer 0
   at prompt 32 (64 launches, the head's strided rows), bitwise B9''s
   slice.  The gap of B9' to the chunked output (which clamps w) is
   printed, not held.  The roofline of one eager gated decode step
   (``launch.roofline.count_cost`` after a prompt-32 prefill: the aten
   ops by PyTorch's FLOP counter and the byte counter, B7's 32 calls by
   its formula): one B7 call a layer counted, t_memory at least the
   bf16 weights' bytes over 3.35 TB/s; printed beside PERF.md section
   5's byte floor (4.5 ms) and measured busy time (13.70 ms).
7. Hymba-1.5B served at its published widths (32 layers, d_model 1600, 25
   query and 5 KV heads of 64, sliding window 1024 but in layers 0, 15 and
   31, Mamba heads of state 16 over DI 1600, d_ff 5504, vocab 32001;
   random f32 weights from seed 0 plus their bf16 copies, ~1.4 G params),
   after phase 6's model is freed, with the same driver, batch, prompt,
   tokens and checks as phase 6, for B8: 32 x 16 launches per gated
   decode, none in the prefill or the ungated decode, B1-B7, B9 and B9'
   none; every B8 launch replayed (h' bitwise, y within 1e-4 of
   max|plain|), one on its all-live drive (h' and y bitwise); a θ > 0
   run (the 0.4 quantile of block max|g|) with at least a quarter of the
   (row, DI-block) pairs dead; f32 gated vs
   ungated within 1e-4 at every step; prefill ms, tokens/s, profile line;
   the graphed serves checked and timed as in phase 6 (B8 32 x 16 = 512
   and B10's 32 counted at capture).
   The prefill's selective scan is B10's fused entry (dt, x, A, B, C in,
   the streams formed in registers), one launch a layer and scan chunk
   (32 per prefill at prompt 32, in every served run; B10's streams entry
   none); every B10 launch of the main path replayed (h bitwise, y within
   1e-4 of max|plain|; h and y bitwise the streams entry run on the
   streams torch builds from the same inputs).  One prefill at prompt
   2000 (the sliding window of 1024 binds): 128 B10 launches (4 chunks a
   layer, h carried across), layer 0's 4 replayed alike, finite logits,
   its time (best of 3).  In phases 6 and 7 the prompt-2000 prefill also
   runs as a CUDA graph (``launch.steps.make_prefill_step``): logits and
   cache bitwise the eager prefill's, its time (best of 3).
9. The attention decoder stack, after phase 7's model is freed and the
   allocator's cache emptied: DeepSeek-V2-Lite-16B (MLA, 64 routed
   experts top-6 plus 2 shared, a dense first layer; ~31 GB) and
   Gemma-2-27B (softcaps, alternating windows of 4096, post-block norms,
   a tied 256k vocabulary; ~54 GB) at full width, their weights random
   from seed 0 and built one layer at a time in bf16 (the norms and the
   MoE router in f32: ``transformer.init_compute_params``), batch 4,
   prompt 32, 16 greedy tokens through ``run_lm``.  No B1-B10 kernel is
   on this path (the MNF fire here is ``engine.sparsify``, plain torch):
   every count is set to 0 before each serve and must read 0 after.  MNF
   on at θ = 0 bitwise ungated (tokens, prefill and step logits); the
   graphed serve bitwise the eager one, gated and ungated (tokens, every
   step's logits, the final cache); each decode step's logits against an
   uncached forward over the prompt and the tokens so far (its MoE at a
   capacity that cannot bind, and dropping nothing): Gemma-2 within 3e-2
   of max|logit|; DeepSeek-V2's absorbed MLA decode against the expanded
   form in f32 within 1e-4 (a second build of ~59 GiB of f32 weights,
   teacher-forced on the bf16 run's inputs), and in bf16 no further from
   that f32 forward (worst step) than 3e-2 or the bf16 forward is;
   DeepSeek: no assignment dropped in any decode step, the expert loads
   summing to tokens x top_k.  Prints parameters and active parameters,
   weight GiB, peak memory, the graphed serve's memory above the weights,
   prefill ms and tokens/s eager and graphed, gated and ungated (best of 2
   warm runs in turns), capture seconds, and a graphed decode step's
   profile (idle share, top kernels).  Then qwen2-0.5b, qwen2-1.5b (QKV
   biases set to seeded values), minitron-8b and deepseek-moe-16b at their
   published widths with num_layers cut to 2: a prefill and 4 decode
   steps, graphed bitwise eager.  Prints the phase's seconds.
10. Whisper-base and phi-3-vision-4.2b, after phase 9's models are freed
   and the allocator's cache emptied, at full width (weights random from
   seed 0, ``init_compute_params``), batch 4, 16 greedy tokens through
   ``run_lm``: whisper at prompt 32 with 1500 audio frames, phi-3-vision
   at prompt 160 (144 patch positions, 16 text tokens), the frames and
   patch embeddings normal x 0.02 from seed 0 (``serve.make_lm_inputs``).
   Checked and reported as phase 9's models (counts 0, θ = 0 bitwise
   ungated, graphed bitwise eager with the cross K/V leaves, each decode
   step within 3e-2 of max|logit| of an uncached bf16 forward with the
   same audio or vision input), and beyond: whisper's encoder ran once in
   the eager serve (its prefill) and never in a decode step, and the
   cross K/V of an eager prefill and of the serve's final cache are
   bitwise ``_cross_kv`` of a separate ``_encode_audio`` run (the encoder
   timed on its own line); phi-3's prefill logits move with a second
   vision input while the embeddings past position 144 stay bitwise.
11. The ``scalar`` backend (the paper's Algorithms 2 and 1, plain torch)
   on the card: ``engine.linear`` on LeNet-300-100's FC1 at batch 2 and
   ``engine.conv2d`` on the MINI CNN's first layer at batch 1 (strides 1
   and 2, paddings 0 and 1), each within 1e-4 of max|ref| of torch.matmul
   / F.conv2d in f32 (TF32 off), no B1-B10 launch.
12. AlexNet at 224 (stock: conv1 k11 s4 p2, pools k3 s2, FC 9216 -> 4096
   -> 4096 -> 1000, 62.4 M parameters), the paper's other network, through
   ``examples/torch_serve_cnn_events.serve_cnn_events``: buckets (1, 4,
   8), weight sparsity 0.5, 336 ``data.cnn_batch`` requests at activation
   sparsity 0.6 in 60 ticks (``ALEX_ARRIVALS``: 30, 78 and 228 requests
   in buckets 1, 4 and 8), counts set to 0 just before the engine is
   built and read after.  3 captures, flat; each bucket's capture saw the
   route plan (B1 x10, B2 x176: conv1 on the dense input and every conv
   per tap, B4b x3); the boundary reports' routes
   ``chain_boundary_summary``'s, no fallback_decode or densify point;
   every request FIFO in its tick, within 5e-3 and 1e-4·max|dense| of the
   dense oracle and bitwise its bucket-1 replay; the eager forward of the
   full bucket of 8 bitwise its served rows, with the plan's launches
   layer by layer (``check_layer_plans``), and one launch of each of its
   distinct B1, B2 and B4b shapes kept for phase 3.  ``run_with_stats`` on the
   card: kind, dense_macs, in_elems and c_out ``analytic_network_stats``'
   exactly, in_events and event_macs the same function's on CPU tensors
   (a difference only up to the values within 1e-6 of the threshold).
   Prints the cost model of the paper's 200 MHz ASIC (``table4_row``,
   ``network_cycles`` of MNF and the four baselines) on these stats and
   on the paper's profile, beside Table 4 and Fig. 8 (model numbers, not
   times on the card); requests/s, p50/p99 and warm-up and capture
   seconds per bucket, the bucket-8 replay beside the dense oracle's graph
   on the same frames, and a profile of it.  Then served twice more
   under ``route="adaptive"`` at occupancy hints 0.3 and 0.9 with
   BENCH_engine.json's crossover table installed: every routed trace
   record's route the cheaper side of its own fields (the table's ratio
   where the table covers the record, else its recorded cost estimates),
   ``route_conflicts`` empty, rows within 5e-3 and 1e-4·max|dense| of the
   oracle; prints the boundaries whose route differs from auto; the table
   cleared after.  AlexNet's launches per bucket go on a JSON line of
   their own; the phase frees its engines.
13. Training (``train_phase``): Qwen2-0.5B at full width (24 layers, d
   896, vocab 151,936; f32 params, bf16 compute, MNF at θ = 0), batch 8 x
   128, 60 steps of AdamW under warmup_cosine(3e-4, 20, 60) on the Markov
   corpus through ``launch.train`` (the prefetching loader, the
   resilient loop) and its graphed train step (one CUDA graph a step,
   the params and moments updated in place), every launch count set to
   0 just before and read just after: the path reaches no kernel, all
   stay 0.  Checks: every loss finite, the mean of the last 5 below the
   mean of the first 5 by 0.2 (the JAX system test's criterion); one
   replay a step; the counted step's FLOPs between 6·N·D and twice it;
   accum_steps 2 against 1 on one batch with the eager step (loss within
   1e-5 and grad_norm within 1e-2 relative, each leaf's first moments
   within 2e-2 of its own largest, the key bias's of the tree's); the
   graphed step against the eager one over 3 steps from the same state
   and batches, at accum_steps 1 and 2: every param, moment and count
   and every step's loss, grad_norm and lr bitwise, the caller's state
   left as it was, replays 2 and 3 under set_sync_debug_mode("error");
   a run through the graphed step stopped by SIGTERM through the loop's
   preemption path writes its checkpoint, restored bitwise into new
   tensors, which the same graph copies in, and a resumed run starts at
   that step with losses within 5e-3 of the uninterrupted run's.
   Prints the losses, the graphed step's median ms, tokens/s, peak
   memory, warm-up and capture s, graph pool GiB and the idle share over
   3 replays, ``launch.train``'s figures with the step forced eager
   (median ms, tokens/s, peak memory, idle share over 3 steps), and the
   roofline row of the eager step (counted GFLOP and GB, t_compute,
   t_memory, the bottleneck, model GFLOP, useful_ratio, roofline_frac)
   with the measured share beside it.  Then Hymba-1.5B trained at full
   width (32 layers, d 1600, Mamba state 16; f32 params, bf16 compute),
   batch 8 x 1024 (two B10 chunks of 512 a layer: the final state's
   gradient crosses a chunk boundary), 30 steps of AdamW under
   warmup_cosine(1e-3, 5, 30) through ``launch.train`` and the graphed
   step, counts set to 0 just before and read just after: B10's forward
   (``mamba_scan_fused``) and backward (``mamba_scan_fused_bwd``)
   launches at the capture equal the plan of one step (32 layers x 2
   chunks, the forward twice under remat "full"), every other kernel 0,
   the graph replayed 30 times, the wrappers' counts the warm-up's, the
   capture's and the counted eager step's; the loss falls by 0.2 as
   Qwen2's must; the counted FLOPs at least 6·N·D; the graphed peak
   memory at most 2 GiB above the eager run's; its first two backward
   launches (the counted eager step's, before the loop) kept for phase
   3.  The graphed step bitwise the eager one over 3 steps on the
   2-layer full-width cut (bf16, batch 8 x 1024), B10's launches at the
   capture that cut's plan.  One f32
   step of the 2-layer cut (batch 2 x 1024) through B10's kernels
   against the same step with B10's plain forward and backward called
   explicitly: the loss within 1e-4 relative, each leaf's gradient
   within 1e-4 of its own max|plain|.  Prints Hymba's graphed and eager
   figures as Qwen2's and its counted roofline.
14. Parallel and runtime (``parallel_phase``) over a one-rank NCCL mesh
   (one H100: NCCL takes no two ranks on one device; multi-rank numerics
   are the CPU tests' over gloo): ``checked_mesh((1, 1))`` starts the
   group and (2, 1) raises ``MeshCapacityError``; Qwen2-0.5B at full
   width, 3 steps of the mesh train step (DTensor params and moments
   under the placements ``logical_to_pspec`` resolves) against the
   unsharded eager step from the same params and batches ([13]'s batch 8 x
   128): losses within 1e-5 relative, each leaf's update within 2e-2 of
   the unsharded update's largest, both steps' ms; DeepSeek-V2-Lite-16B's
   MoE layer at full width (64 experts, top-6, batch 4 x 32, f32,
   capacity factor 64) through ``moe_apply_ep`` against ``moe_apply``
   within 1e-5 of max|y|, one all-reduce issued (``CommDebugMode``);
   ``quantized_psum`` (round(x / scale) x scale exactly) and
   ``event_psum`` (fired + residual bitwise g + old residual, the fired
   share at most 5% plus ties) over NCCL on a 151,936 x 896 f32
   gradient, timed; VGG16@224 batch 8 through ``make_cnn_serve_step(...,
   mesh=...)``: B1-B4 launched at capture as the route plan says, logits
   bitwise the mesh-less plan's; ``pipeline_apply`` with one stage
   bitwise the stage function.  Every main path with the launch counts
   set to 0 just before and read just after; the group destroyed at
   the end.
15. The dry run (``repro_torch.launch.dryrun``) of two production cells
   on this machine's torch, qwen2-1.5b and hymba-1.5b ``train_4k`` at
   16x16 (a fake world of 256 ranks on the meta device: counts, no card
   time), started in two subprocesses before phase 3 and read after it:
   each exits 0 and writes a record of status "ok" with a positive
   collective term; Hymba's record counts B10's forward and backward by
   their formulas as the plan says (32 layers x 8 chunks, the forward
   twice).  Prints each record's ``format_row``, its memory, its
   collectives by kind and by the shapes moved, and its FLOPs by aten
   op.
3. Kernel checks: each kernel against its plain PyTorch version on the
   inputs the forwards handed it (B1, B2 and B5 at the shapes of both
   VGG16 and LeNet-300-100), plus the strip convs at stride 4 and 2
   (ALEXNET_FF@256 conv1 and a k3s2 layer; B6 on their int8 codes).  Pools
   and fire must agree exactly; the matmuls and strip convs within
   max|d| <= 1e-4 * max|plain| (the kernel accumulates with fmaf, the plain
   version with a separate multiply and add: one rounding fewer per step),
   and B5/B6 bitwise B2/B3 fed the dequantized tiles.  The forwards'
   matmuls, strip convs and pools are also held against torch.matmul,
   F.conv2d and F.max_pool2d on the decoded (dequantized) maps (the same
   tolerance; pools exact).  B2 and B5 timed at every VGG16 launch shape
   (graph-timed ms times launches: the sum a forward) and reported at two:
   FC1 (bytes bound) and the per-tap conv shape with the largest summed
   ms (operations bound).  B3 and B6 graph-timed at each VGG16 strip
   layer they ran (B3 x7 in f32, B6 x6 in int8) and summed a forward
   (``per_forward_ms`` in their JSON entries, which report the heaviest
   layer).  B1 and both pools likewise graph-timed at every launch of
   the f32 VGG16 forward (B1 x20, B4a x2, B4b x3) and summed
   (``per_forward_ms``; the entry's own numbers stay at the heaviest
   launch).  Strip == per-tap on the card: conv3_1's input
   map encoded as strips and as pixels, engine.conv2d through B3 (x1) and
   through B2 (x9), bitwise equal.  B7 and B8 (and their wrappers) at the
   main path's shapes of phases 6 and 7, B9, B9' and both B10 entries at
   prompt 32 (the streams entry on torch's streams of the fused entry's
   inputs, bitwise it), B9' also with its inputs cold in L2 and with its
   wrapper, B9' and both B10 entries also at prompt 2000 (one
   layer, beside the eager building of the streams that the fused entry
   removes); B10's backward at the two launches phase 13's Hymba step
   handed it first (the last layer's chunks: h0 given and gh None, h0
   None and gh carried; bf16 dt, x, B, C) against
   ``mamba_scan_fused_bwd_ref`` on the same values in f32, every
   gradient within 1e-4 of max|plain|, two launches bitwise, its scratch
   bytes beside the 0.84 GB of a design that stores every state and
   lambda of the chunk, timed from a
   CUDA graph beside its formula's bound and beside B10's forward fused
   entry on the same inputs (the backward over the forward printed), with
   its launches on phase 13's main path and per step; no single PyTorch
   call computes a recurrent step or scan
   or its gradient: their library columns are null.  B1, B2, B3 and both pools also at
   phase 8's bucket-128 launches (B2 at FC1), against the plain version
   as above, timed beside their bound (``serve128`` in their JSON
   entries).  B1, B2 and B4b also at each distinct launch shape of phase
   12's eager AlexNet@224 bucket-8 forward (B2: conv1's per-tap K of 3,
   conv2's k5 on 27x27, conv3-5, FC1's K of 9216; B4b: the k3 s2 pools at
   C 96 and 256), against the plain version as above (B2 also against
   torch.matmul on the decoded map), timed beside their bound and summed
   over a forward's launches (``alexnet224`` in their JSON entries).
   Prints each kernel's
   time, the plain version's, one PyTorch library call's on the same
   function, and the bound.

The last lines are the card line, a JSON line of per-kernel numbers, and
the result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and f32
#: FLOP/s outside the tensor cores — the kernels here are f32 CUDA-core code
#: (B5/B6 dequantize int8 codes to f32 at load).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

KERNELS = {  # name: (source, TPU kernel it replaces)
    "fire_compact": ("src/repro_torch/csrc/fire_compact.cu",
                     "src/repro/kernels/fire_compact/kernel.py:54"),
    "event_matmul": ("src/repro_torch/csrc/event_matmul.cu",
                     "src/repro/kernels/event_matmul/kernel.py:163"),
    "event_conv": ("src/repro_torch/csrc/event_conv.cu",
                   "src/repro/kernels/event_conv/kernel.py:213"),
    "event_pool_window": ("src/repro_torch/csrc/event_pool.cu",
                          "src/repro/kernels/event_pool/kernel.py:200"),
    "event_pool": ("src/repro_torch/csrc/event_pool.cu",
                   "src/repro/kernels/event_pool/kernel.py:106"),
    "event_matmul_int8": ("src/repro_torch/csrc/event_matmul.cu",
                          "src/repro/kernels/event_matmul/kernel.py:126"),
    # B2/B5 again at their per-tap conv shape (phase 3 times both shapes)
    "event_matmul_per_tap": ("src/repro_torch/csrc/event_matmul.cu",
                             "src/repro/kernels/event_matmul/kernel.py:163"),
    "event_matmul_int8_per_tap": (
        "src/repro_torch/csrc/event_matmul.cu",
        "src/repro/kernels/event_matmul/kernel.py:126"),
    "event_conv_int8": ("src/repro_torch/csrc/event_conv.cu",
                        "src/repro/kernels/event_conv/kernel.py:268"),
    "wkv6_step": ("src/repro_torch/csrc/wkv6_step.cu",
                  "src/repro/kernels/wkv6/step.py:150"),
    "mamba_step": ("src/repro_torch/csrc/mamba_step.cu",
                   "src/repro/kernels/mamba_scan/step.py:124"),
    "wkv6_single": ("src/repro_torch/csrc/wkv6.cu",
                    "src/repro/kernels/wkv6/kernel.py:70"),
    "wkv6": ("src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/ops.py:42"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/kernel.py:70"),
    # B10's fused entry (dt, x, A, B, C in, the streams formed in registers)
    "mamba_scan_fused": ("src/repro_torch/csrc/mamba_scan.cu",
                         "src/repro/kernels/mamba_scan/kernel.py:70"),
    # B10's backward: no TPU kernel; it takes the place of XLA's gradient
    # of the scan the JAX train step differentiates
    "mamba_scan_fused_bwd": ("src/repro_torch/csrc/mamba_scan.cu",
                             "src/repro/models/ssm.py:364"),
}

#: Launches per chained forward that the route plan gives (the JAX
#: package's routes): phases 2, 4 and 5.  A kernel listed with 0 is off
#: that path and must not launch.
PLAN_F32_VGG = dict(fire_compact=20, event_matmul=57, event_conv=7,
                    event_pool_window=2, event_pool=3, event_matmul_int8=0,
                    event_conv_int8=0, wkv6_step=0, mamba_step=0,
                    wkv6_single=0, wkv6=0, mamba_scan=0,
                    mamba_scan_fused=0, mamba_scan_fused_bwd=0)
PLAN_INT8_VGG = dict(fire_compact=0, event_matmul=0, event_conv=1,
                     event_pool_window=2, event_pool=3, event_matmul_int8=57,
                     event_conv_int8=6, wkv6_step=0, mamba_step=0,
                     wkv6_single=0, wkv6=0, mamba_scan=0,
                     mamba_scan_fused=0, mamba_scan_fused_bwd=0)
PLAN_F32_MLP = dict(fire_compact=2, event_matmul=3, event_conv=0,
                    event_pool_window=0, event_pool=0, event_matmul_int8=0,
                    event_conv_int8=0, wkv6_step=0, mamba_step=0,
                    wkv6_single=0, wkv6=0, mamba_scan=0,
                    mamba_scan_fused=0, mamba_scan_fused_bwd=0)
PLAN_INT8_MLP = dict(fire_compact=0, event_matmul=1, event_conv=0,
                     event_pool_window=0, event_pool=0, event_matmul_int8=2,
                     event_conv_int8=0, wkv6_step=0, mamba_step=0,
                     wkv6_single=0, wkv6=0, mamba_scan=0,
                     mamba_scan_fused=0, mamba_scan_fused_bwd=0)


#: Phase 12: AlexNet@224 served through the JAX example's buckets, and the
#: launches a bucket's capture sees: conv1 (on the dense input) and every
#: conv run per tap on B2 (121 + 25 + 3 x 9), the FCs on B2 (3), the three
#: k3 s2 pools on B4b, a fire (B1) after each conv, pool and hidden FC.
ALEX_BUCKETS = (1, 4, 8)
#: Requests arriving at each tick, six rounds of ten ticks.  A tick of n
#: runs batches of min(n, 8) padded up to the smallest bucket, so a round
#: serves bucket 1 five times (ticks 1, 1, 9, 17, 1), bucket 4 four times
#: (3, 12, 2, 4: 13 requests) and bucket 8 six times (38 requests): in all
#: 336 requests, 30 in bucket 1, 78 in bucket 4 and 228 in bucket 8.
ALEX_ARRIVALS = (1, 1, 3, 9, 12, 6, 2, 17, 1, 4) * 6
#: Occupancy hints of the adaptive serves.
ALEX_OCCUPANCY = (0.3, 0.9)
#: The crossover table's boundary of each routed op.
BOUNDARY = {"conv2d": "conv", "maxpool2d": "pool", "linear": "linear"}
PLAN_F32_ALEX = dict(fire_compact=10, event_matmul=176, event_conv=0,
                     event_pool_window=0, event_pool=3, event_matmul_int8=0,
                     event_conv_int8=0, wkv6_step=0, mamba_step=0,
                     wkv6_single=0, wkv6=0, mamba_scan=0,
                     mamba_scan_fused=0, mamba_scan_fused_bwd=0)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device ms per call over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, reps: int = 3) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events.  The host's launch
    pace does not enter: a launch from Python costs tens of microseconds on
    the card's host, more than a small kernel runs, so events around eager
    launches time the host (about 0.063 ms a call there)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm: handles, allocations
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    return ms


def host_ms(torch, fn, reps: int = 3) -> tuple[float, list]:
    """Median host-clock ms of ``reps`` calls, each ending in a sync."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def profile(torch, fn, label: str, steps: int = 3, top: int = 0,
            host_ops: bool = True) -> dict:
    """Print the device busy time, idle share and ms by kernel of ``fn``
    (warm, ``steps`` calls under torch.profiler, per-call averages): the
    MNF kernels by name and the rest as "other", or with ``top`` the
    ``top`` kernels that take most device time, whatever their names.
    ``host_ops`` False records the device's activity alone (no host op
    events to gather: seconds less for an eager train step's ~7,000
    ops).  Returns host ms, device busy ms and the idle share."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if host_ops else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = e.device_time_total if hasattr(e, "device_time_total") \
            else e.cuda_time_total
        name = e.name.split("(")[0].replace("void ", "")
        if not top and not name.startswith("mnf_"):
            name = "other"
        rec = by_name.setdefault(name[:64], [0.0, 0])
        rec[0] += dur / 1e3 / steps
        rec[1] += 1
    busy = sum(v[0] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    parts = ", ".join(f"{n} {ms:.4f} ms x{c // steps}" for n, (ms, c) in
                      (ranked[:top] if top else ranked))
    idle = max(0.0, 1 - busy / wall)
    print(f"{label} profile ({steps} warm calls): host {wall:.3f} ms/call "
          f"under the profiler, device busy {busy:.3f} ms (idle share "
          f"{idle:.3f}); {f'top {top} kernels: ' if top else ''}{parts}",
          flush=True)
    return dict(host_ms=wall, busy_ms=busy, idle=idle)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def drive_counted(torch, engine, wrappers, fn, capture=True):
    """Run ``fn`` once with every launch count set to 0 just before and read
    just after; with ``capture`` each wrapper collects its launches' inputs
    (kernels.note_launch) for a later replay.  Returns (result, trace
    records, launches, captures, seconds)."""
    for w in wrappers.values():
        w.launches = 0
        w.capture = [] if capture else None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with engine.trace_dispatch() as recs:
            y = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
    finally:
        captured = {name: w.capture or [] for name, w in wrappers.items()}
        for w in wrappers.values():
            w.capture = None
    check(not capture or all(len(captured[n]) == launches[n]
                             for n in wrappers),
          "a wrapper's capture list disagrees with its launch count")
    return y, recs, launches, captured, secs


def check_plan(tag, launches, plan):
    """Every kernel of the path launched, none off it; say whether the
    counts are the route plan's."""
    missing = [n for n, want in plan.items() if want and not launches[n]]
    stray = [n for n, want in plan.items() if not want and launches[n]]
    check(not missing, f"{tag}: kernels of the path never launched: "
          f"{missing} ({launches})")
    check(not stray, f"{tag}: kernels off the path launched: {stray} "
          f"({launches})")
    diff = {n: (launches[n], want) for n, want in plan.items()
            if launches[n] != want}
    print(f"{tag} launches per kernel: {launches}; route plan "
          f"{'confirmed' if not diff else f'differs (got, plan): {diff}'}",
          flush=True)


def check_layer_plans(tag, cnn, spec, batch, recs, captured) -> list:
    """Each layer's counted launches, in forward order, against the launch
    accounting of the JAX package (``fused_conv_plan``, ``pool_plan``,
    ``pool_window_plan``): a strip conv one B3 launch
    (``launches_fused``) whose plan has ``subtaps`` subtaps over
    ``grid_fused``'s output strips; a per-tap conv (a pixel stream, or a
    dense chain head, which records nothing) ``launches_per_tap`` B2
    launches on its (padded) tap weights; a pool one B4a or B4b launch
    (``launches``) over its plan's grid; an FC one B2 launch.  ``recs``
    are the forward's trace records and ``captured`` each wrapper's
    launches in order, all of which the layers must use up.  Returns one
    "layer kernel xN" string a layer."""
    from repro_torch.kernels.event_conv.ops import fused_conv_plan
    from repro_torch.kernels.event_pool.ops import pool_plan, pool_window_plan

    queues = {n: list(captured[n]) for n in ("event_conv", "event_matmul",
                                             "event_pool",
                                             "event_pool_window")}
    ops = {cnn.ConvSpec: "conv2d", cnn.PoolSpec: "maxpool2d",
           cnn.FCSpec: "linear"}
    recs = [r for r in recs if r.get("op") in ops.values()]
    out = []

    def take(name, n, what):
        check(len(queues[name]) >= n, f"{tag} {what}: {n} {name} launches "
              f"planned, {len(queues[name])} left")
        calls, queues[name][:] = queues[name][:n], queues[name][n:]
        return calls

    for i, (layer, shape) in enumerate(layer_inputs(cnn, spec, batch)):
        rec = recs.pop(0) if recs and recs[0]["op"] == ops[type(layer)] \
            else None
        what = f"layer {i} {type(layer).__name__} {shape}"
        if isinstance(layer, cnn.ConvSpec):
            k, p, st, co = layer.k, layer.padding, layer.stride, layer.out_ch
            if rec is not None and rec.get("strip"):
                (args, kw), = take("event_conv", 1, what)
                plan = fused_conv_plan(shape, k, p, nkb=kw["nkb"], stride=st)
                check(plan["launches_fused"] == 1
                      and args[2].numel() == plan["subtaps"]
                      and tuple(args[4].shape) == plan["grid_fused"][:2]
                      and kw["row_stride"] == st,
                      f"{tag} {what}: B3 took tap {tuple(args[2].shape)}, "
                      f"src {tuple(args[4].shape)}; plan {plan}")
                out.append(f"{i} B3 x1 ({plan['subtaps']} subtaps)")
            else:
                plan = fused_conv_plan(shape, k, p, nkb=1, stride=st)
                n = plan["launches_per_tap"]
                for args, _ in take("event_matmul", n, what):
                    bk = args[0].shape[3]
                    check(tuple(args[3].shape) == (-(-shape[3] // bk) * bk,
                                                   co),
                          f"{tag} {what}: a tap's weight "
                          f"{tuple(args[3].shape)}, want ({shape[3]}, {co}) "
                          f"padded to {bk}")
                out.append(f"{i} B2 x{n}")
        elif isinstance(layer, cnn.PoolSpec):
            if rec is None or not rec.get("pool_events"):
                out.append(f"{i} dense")
                continue
            window = rec["route"] == "window"
            name = "event_pool_window" if window else "event_pool"
            (args, kw), = take(name, 1, what)
            plan = (pool_window_plan if window else pool_plan)(
                shape, layer.k, layer.stride, nkb=kw["nkb"])
            check(plan["launches"] == 1
                  and tuple(args[3].shape) == plan["grid"][:2],
                  f"{tag} {what}: {name} took src {tuple(args[3].shape)}; "
                  f"plan {plan}")
            out.append(f"{i} {'B4a' if window else 'B4b'} x1 (grid "
                       f"{plan['grid']})")
        else:
            (args, _), = take("event_matmul", 1, what)
            b, h, w, c = shape
            bk = args[0].shape[3]
            check(tuple(args[3].shape) == (-(-(h * w * c) // bk) * bk,
                                           layer.out),
                  f"{tag} {what}: FC weight {tuple(args[3].shape)}")
            out.append(f"{i} B2 x1")
    left = {n: len(q) for n, q in queues.items() if q}
    check(not left and not recs, f"{tag}: launches no layer planned {left}, "
          f"records left {recs}")
    return out


def strided_conv_inputs(torch, gen, int8: bool) -> list:
    """The strip convs at stride 4 and 2: ALEXNET_FF@256's conv1 (k11 s4)
    and conv2 (k3 s2, on a (4, 64, 64, 96) map), on relu(normal) inputs
    with half the values zeroed and He weights from ``gen``.  Returns
    [(layer, input shape, args, kw)], B6's args on the int8 codes."""
    from repro_torch import engine
    from repro_torch.core import quantize as qz
    from repro_torch.kernels.event_conv import ops as conv_ops
    from repro_torch.models import cnn
    ff = cnn.ALEXNET_FF
    dev = gen.device
    out = []
    for layer, shape in ((ff.layers[0], (4, ff.input_size, ff.input_size,
                                         ff.in_ch)),
                         (ff.layers[1], (4, 64, 64, ff.layers[0].out_ch))):
        k, s, p, co = layer.k, layer.stride, layer.padding, layer.out_ch
        xin = torch.relu(torch.randn(shape, generator=gen, device=dev))
        xin = xin * (torch.rand(shape, generator=gen, device=dev) > 0.5)
        wk = torch.randn((k, k, shape[3], co), generator=gen,
                         device=dev) * (2.0 / (k * k * shape[3])) ** 0.5
        qp = qz.calibrate(xin)
        st = engine.EventStream.encode_nhwc(
            qz.quantize(xin, qp) if int8 else xin,
            blk_k=min(8, shape[3]), blk_m=8, keep_dense=False)
        args, nkb = conv_ops.strip_conv_inputs(st, wk, stride=s, padding=p)
        if int8:
            args = (*args[:6], qp.scale, qp.zero_point, args[6])
        out.append((layer, shape, args, dict(nkb=nkb, row_stride=s)))
    return out


def layer_inputs(cnn, spec, batch: int) -> list:
    """(layer, (B, H, W, C) map it takes) for each layer of ``spec``."""
    h = w = spec.input_size
    c = spec.in_ch
    out = []
    for layer in spec.layers:
        out.append((layer, (batch, h, w, c)))
        if isinstance(layer, cnn.ConvSpec):
            h = (h + 2 * layer.padding - layer.k) // layer.stride + 1
            w = (w + 2 * layer.padding - layer.k) // layer.stride + 1
            c = layer.out_ch
        elif isinstance(layer, cnn.PoolSpec):
            h = (h - layer.k) // layer.stride + 1
            w = (w - layer.k) // layer.stride + 1
        else:
            h, w, c = 1, 1, layer.out
    return out


# ---------------------------------------------------------------------------
# The int8 forwards against plain torch, layer by layer.  A free-running
# dense int8 forward can pick a different code wherever a value sits at a
# rounding tie (half a step between two codes): the two sums differ in the
# order of their f32 additions, and so may the scales calibrated over them;
# one flipped code then moves every later layer, and the flips cascade
# (on VGG16@224 the free-running int8 oracle ends as far from the chain as
# the f32 logits are).  So each layer of the fake-quant twin (bitwise the
# chain) is held against F.conv2d / torch.matmul on the twin's own input,
# and every fired code against an independent fake quant of that product
# under its own scale; a code may differ only where the two values
# straddle a half step.
# ---------------------------------------------------------------------------

def record_fires(models, fn):
    """Run ``fn`` with the models' dense ``fire`` (the round-trip twin's and
    the dense oracle's) recording (accumulator, fired map) per call."""
    orig = models[0].fire
    seen = []

    def rec(acc, cfg, out_qp=None):
        out = orig(acc, cfg, out_qp)
        seen.append((acc, out))
        return out

    for m in models:
        m.fire = rec
    try:
        y = fn()
    finally:
        for m in models:
            m.fire = orig
    return y, seen


def teacher_forced(torch, F, cnn, layers, params, x, fires, logits):
    """Replay the int8 fake-quant forward whose fires are ``fires`` with
    plain torch: each conv/FC on the twin's input within 1e-4 of max|plain|,
    each fired map bitwise a symmetric int8 fake quant of the twin's
    accumulator (scale max/127, round half to even), each code of the plain
    product (under the scale calibrated over it) equal to the twin's except
    at a rounding tie, pools by F.max_pool2d.  Returns (worst ratio, codes
    at ties)."""
    cur, fi, worst, ties = x, 0, 0.0, 0
    for i, (layer, w) in enumerate(zip(layers, params)):
        if isinstance(layer, cnn.PoolSpec):
            cur = F.max_pool2d(cur.permute(0, 3, 1, 2), layer.k,
                               layer.stride).permute(0, 2, 3, 1)
            continue
        if isinstance(layer, cnn.ConvSpec):
            acc = F.conv2d(cur.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                           stride=layer.stride,
                           padding=layer.padding).permute(0, 2, 3, 1)
        else:
            acc = cur.reshape(cur.shape[0], -1) @ w
        twin = logits if i == len(layers) - 1 else fires[fi][0]
        d = float((twin.reshape(acc.shape) - acc).abs().max())
        ratio = d / max(float(acc.abs().max()), 1e-30)
        check(ratio <= 1e-4, f"layer {i} ({layer}): max|twin - plain| "
              f"{ratio:.3e} of max|plain| (limit 1e-4)")
        worst = max(worst, ratio)
        if i == len(layers) - 1:
            break
        acc_t, out_t = fires[fi]
        fi += 1
        ft, fo = torch.relu(acc_t), torch.relu(acc.reshape(acc_t.shape))
        s = ft.abs().max().clamp(min=1e-8) / 127
        so = fo.abs().max().clamp(min=1e-8) / 127
        qt = torch.round(ft / s).clamp(-128, 127)
        check(torch.equal(out_t, qt * s), f"layer {i}: the fired map is not "
              f"the int8 fake quant of its accumulator")
        qo = torch.round(fo / so).clamp(-128, 127)
        diff = qo != qt
        if bool(diff.any()):
            a, b = (ft / s)[diff], (fo / so)[diff]
            half = torch.minimum(qt, qo)[diff] + 0.5
            at_tie = ((qt - qo).abs()[diff] == 1) \
                & (torch.minimum(a, b) <= half) & (half <= torch.maximum(a, b))
            check(bool(at_tie.all()), f"layer {i}: {int((~at_tie).sum())} "
                  f"codes differ from the plain product's away from a "
                  f"rounding tie")
            ties += int(diff.sum())
        cur = out_t
    check(fi == len(fires), f"{len(fires)} fires recorded, {fi} replayed")
    return worst, ties


# ---------------------------------------------------------------------------
# Phase 8: the serving tier (repro_torch.serving): VGG16@224 and
# LeNet-300-100 continuously batched through one CUDA graph a bucket.
# ---------------------------------------------------------------------------

#: Requests arriving at each tick of phase 8: buckets 1, 8 (3 padded to 8,
#: then 8 full), an idle tick, 32 (20 padded), 128 (33 padded), and a tick
#: larger than the largest bucket (128 + 72 padded to 128).
SERVE_ARRIVALS = (1, 3, 0, 8, 20, 33, 200)


def bits_equal(torch, a, b) -> bool:
    """Bitwise equality of two f32 tensors (a signed zero differs)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


class Heaviest(list):
    """A wrapper's capture list that keeps only the launch with the largest
    ``score(args, kwargs)`` (the rest are counted, not kept)."""

    def __init__(self, score):
        super().__init__()
        self.score, self.best = score, None

    def append(self, item):
        s = self.score(*item)
        if self.best is None or s > self.best:
            self[:] = [item]
            self.best = s


#: Phase 8's bucket-128 launches that phase 3 replays: for each kernel of
#: the f32 VGG16 path, the launch of an eager forward of a full bucket of
#: 128 that scores largest (B2: the largest weight, FC1's).
SERVE_KEEP = {
    "fire_compact": lambda a, kw: a[0].numel(),
    "event_matmul": lambda a, kw: a[3].numel(),
    "event_conv": lambda a, kw: a[0].numel() * a[6].shape[1],
    "event_pool_window": lambda a, kw: a[0].numel(),
    "event_pool": lambda a, kw: a[0].numel(),
}

#: Phase 12's kernels, and the score of a launch among those of its shape
#: that phase 3 replays: the one with the most live events (B2: its event
#: counts, B4b: its window counts; B1's launches of a shape are alike).
ALEX_KEEP = {
    "fire_compact": lambda a: 0,
    "event_matmul": lambda a: int(a[2].sum()),
    "event_pool": lambda a: int(a[4].sum()),
}


def call_shape(torch, args, kw) -> tuple:
    """A launch's shape: its tensors' shapes, its other arguments."""
    return tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                 for a in args) + tuple(sorted(kw.items()))


def keep_by_shape(torch, captured) -> dict:
    """{kernel: [(args on the host, kw, launches of that shape)]}: for each
    ``ALEX_KEEP`` kernel, its launch that scores largest among those of
    each distinct shape in ``captured``, in order of first launch."""
    out = {}
    for name, score in ALEX_KEEP.items():
        best = {}               # shape: [launches, best score, (args, kw)]
        for args, kw in captured[name]:
            slot = best.setdefault(call_shape(torch, args, kw),
                                   [0, None, None])
            slot[0] += 1
            s = score(args)
            if slot[1] is None or s > slot[1]:
                slot[1:] = [s, (args, kw)]
        out[name] = [(tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                            for a in args), kw, n)
                     for n, _, (args, kw) in best.values()]
    return out


def serve_net(torch, drive, wrappers, tag, spec, params, plan, dense, seed,
              eager=None):
    """Phase 8 for one net: a ``serving.ServeEngine`` on the card with the
    default buckets (1, 8, 32, 128), warmed (one capture a bucket) and fed
    ``SERVE_ARRIVALS`` requests (``launch.serve.make_requests`` from
    ``seed``, made ahead of the loop) through ``launch.serve.
    serve_arrivals``, every launch count set to 0 just before the engine
    is built and read just after the last tick.  Checks: the kernels of
    the path launched and none off it; each bucket's capture saw the route
    plan ``plan``; 4 captures after the warm-up and no more after any
    tick; every request served in the tick it arrived, FIFO, through the
    batches ``plan_tick`` names; zero fallback_decodes and densify points
    (no re-tile either for an MLP) in every bucket's boundary report;
    within every bucket, n real rows plus zero rows bitwise the same rows
    of a bucket full of real requests; every served request's logits
    bitwise its own bucket-1 replay; every served batch, in every bucket,
    within 5e-3 and 1e-4·max|dense| of the dense oracle ``dense`` on the
    same rows.  With ``eager``, the eager forward of the first full
    bucket of 128 is bitwise its served rows, and its heaviest launch of
    each ``SERVE_KEEP`` kernel is kept (on the host) for phase 3.  Prints
    requests/s, p50/p99 overall and per bucket, time to first response,
    warm-up and capture seconds and graph memory per bucket, and per full
    bucket the host staging, the host-to-device copy, the replay and the
    whole forward; profiles the bucket-128 replay.  Keeps no reference to
    the engine, so its graphs and their pools go when it returns.
    Returns the numbers and the launches captured x replayed by the
    traffic (the warm-up's replays not counted)."""
    from repro_torch import serving
    from repro_torch.launch.serve import make_requests, serve_arrivals
    from repro_torch.models import mlp

    dev = torch.device("cuda")
    is_mlp = isinstance(spec, mlp.MLPSpec)
    n_req = sum(SERVE_ARRIVALS)
    images = make_requests(spec, n_req, seed)
    buckets = serving.DEFAULT_BUCKETS
    batches = []                # (bucket, requests) as served
    warm_replays = {}

    def serve():
        eng = serving.ServeEngine(spec, params)
        check(eng.recompiles == len(buckets), f"{tag}: {eng.recompiles} "
              f"captures at the warm-up, not {len(buckets)}")
        warm_replays.update({b: eng.plans[b].fn.graph.replays
                             for b in buckets})

        def on_tick(n, done):
            check(eng.recompiles == len(buckets), f"{tag}: a tick of {n} "
                  f"requests captured ({eng.recompiles} captures)")
            # each tick drains the queue: its batches are the plan for n
            want = serving.ContinuousBatcher(buckets).plan_tick(n)
            check(len(done) == n, f"{tag}: a tick of {n} served "
                  f"{len(done)}")
            i = 0
            for bucket, take in want:
                reqs = done[i:i + take]
                check(all(r.bucket == bucket for r in reqs), f"{tag}: a "
                      f"tick of {n} served {[r.bucket for r in reqs]}, "
                      f"the plan says {want}")
                batches.append((bucket, reqs))
                i += take

        serve_arrivals(eng, images, SERVE_ARRIVALS, on_tick)
        return eng

    eng, _, raw, _, serve_s = drive(serve, capture=False)
    launches = {n: 0 for n in wrappers}
    for b in buckets:
        g = eng.plans[b].fn.graph
        got = {n: g.launches.get(w, 0) for n, w in wrappers.items()}
        check_plan(f"{tag} bucket {b} capture", got, plan)
        check(got == plan, f"{tag} bucket {b}: the capture saw {got}, not "
              f"the route plan {plan}")
        for n in wrappers:
            launches[n] += got[n] * (g.replays - warm_replays[b])
    missing = [n for n, want in plan.items() if want and not raw[n]]
    stray = [n for n, want in plan.items() if not want and raw[n]]
    check(not missing and not stray, f"{tag}: kernels of the path never "
          f"launched {missing}, off it launched {stray}")
    done = eng.completed
    check([r.rid for r in done] == list(range(n_req))
          and all(r.completion_tick == r.arrival_tick for r in done),
          f"{tag}: not every request served FIFO in its own tick")
    for b in buckets:
        rep = eng.boundary_report(b)
        check(rep["fallback_decodes"] == 0
              and rep["boundaries"]["densify"] == 0
              and not (is_mlp and rep["boundaries"]["retile"]),
              f"{tag} bucket {b}: boundary report {rep}")
    print(f"{tag} {spec.name}: {n_req} requests in ticks of "
          f"{list(SERVE_ARRIVALS)} served FIFO as batches (bucket, real "
          f"rows) {[(b, len(r)) for b, r in batches]} in {serve_s:.3f} s "
          f"(warm-up included); captures {eng.recompiles}, flat over every "
          f"tick; each bucket's capture saw the route plan; zero "
          f"fallback_decodes and densify points"
          f"{', retiles' if is_mlp else ''}; launches captured x replayed "
          f"by the traffic {launches}", flush=True)

    # padding within a bucket, and against each request's bucket-1 replay
    for b in buckets:
        full = eng.forward(b, list(images[:b]))
        for n in sorted({1, b // 2 + 1} - {b}):
            check(bits_equal(torch, eng.forward(b, list(images[:n])),
                             full[:n]),
                  f"{tag} bucket {b}: {n} real rows plus zeros not bitwise "
                  f"the rows of a full bucket")
    off = [r.rid for r in done
           if not bits_equal(torch, eng.forward(1, [r.image])[0], r.result)]
    check(not off, f"{tag}: {len(off)} served logits not bitwise their "
          f"bucket-1 replay (first {off[:8]})")
    # every served batch against the dense oracle on the same rows
    worst = {}
    for b, reqs in batches:
        got = torch.stack([r.result for r in reqs]).to(dev)
        y_dense = dense(torch.stack([r.image for r in reqs]).to(dev))
        d = float((got - y_dense).abs().max())
        ratio = d / max(float(y_dense.abs().max()), 1e-30)
        check(bool(torch.allclose(got, y_dense, atol=5e-3, rtol=5e-3))
              and ratio <= 1e-4, f"{tag}: a batch of {len(reqs)} in "
              f"bucket {b} off the dense oracle by {d:.3e} (ratio "
              f"{ratio:.3e})")
        worst[b] = max(worst.get(b, (0.0, 0.0)), (ratio, d))
    del got, y_dense
    print(f"{tag} padding: within every bucket n real rows plus zeros "
          f"bitwise a full bucket's rows; all {n_req} served logits bitwise "
          f"their own bucket-1 replay; every served batch vs the dense "
          f"oracle, worst by bucket (ratio to max|dense|, max|d|): "
          + ", ".join(f"{b}: {r:.3e}, {d:.3e}"
                      for b, (r, d) in sorted(worst.items()))
          + " (limits 1e-4, 5e-3)", flush=True)

    kept = None
    if eager is not None:
        # the eager forward of the first full bucket of 128, its heaviest
        # launch of each kernel kept for phase 3
        reqs = next(r for b, r in batches
                    if b == buckets[-1] and len(r) == b)
        lists = {n: Heaviest(score) for n, score in SERVE_KEEP.items()}
        for n, lst in lists.items():
            wrappers[n].capture = lst
        try:
            y128 = eager(torch.stack([r.image for r in reqs]).to(dev))
        finally:
            for n in lists:
                wrappers[n].capture = None
        check(bits_equal(torch, y128.cpu(),
                         torch.stack([r.result for r in reqs])),
              f"{tag}: the eager forward of a full bucket of 128 is not "
              f"bitwise its served rows")
        kept = {n: (tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                          for a in lst[0][0]), lst[0][1])
                for n, lst in lists.items()}
        del y128, lists
        print(f"{tag} the eager forward of a full bucket of 128 (requests "
              f"{reqs[0].rid}-{reqs[-1].rid}) is bitwise its served rows; "
              f"kept for phase 3 the launches "
              + ", ".join(f"{n} {tuple(a[0].shape)}"
                          for n, (a, _) in kept.items()), flush=True)

    stats = eng.stats()
    per_bucket = {}
    for b in buckets:
        g = eng.plans[b].fn.graph
        buf = eng.stage(b, list(images[:b]))
        stage_ms, _ = host_ms(torch, lambda: eng.stage(b, list(images[:b])))
        copy_ms = cuda_ms(torch, lambda: g.static[1].copy_(
            buf, non_blocking=True), 5)
        # the replay alone and the whole forward, in turns
        turns = [(host_ms(torch, g.replay, reps=1)[0],
                  host_ms(torch, lambda: eng.forward(b, list(images[:b])),
                          reps=1)[0]) for _ in range(5)]
        replay_ms = statistics.median(t[0] for t in turns)
        fwd_ms = statistics.median(t[1] for t in turns)
        per_bucket[b] = dict(
            **stats["per_bucket"][b], **eng.warmup_s[b], **eng.graph_gib[b],
            stage_ms=stage_ms, copy_ms=copy_ms, replay_ms=replay_ms,
            forward_ms=fwd_ms, full_requests_s=b / fwd_ms * 1e3)
        print(f"{tag} bucket {b}: {per_bucket[b]['requests']} requests, "
              f"p50 {per_bucket[b]['p50_ms']:.3f} ms, p99 "
              f"{per_bucket[b]['p99_ms']:.3f} ms; warm-up "
              f"{eng.warmup_s[b]['warmup_s']:.3f} s, capture "
              f"{eng.warmup_s[b]['capture_s']:.3f} s, graph pool "
              f"{eng.graph_gib[b]['pool_gib']:.3f} GiB (peak "
              f"{eng.graph_gib[b]['peak_gib']:.3f} GiB at warm-up and "
              f"capture); a full bucket: host staging {stage_ms:.3f} ms, "
              f"host-to-device copy {copy_ms:.3f} ms "
              f"({buf.numel() * 4 / 1e6:.1f} MB), replay {replay_ms:.3f} "
              f"ms, forward (staging, copy, replay, logits read) "
              f"{fwd_ms:.3f} ms = {b / fwd_ms * 1e3:.1f} requests/s "
              f"(host clock; staging median of 3, replay and forward "
              f"medians of 5 in turns)", flush=True)
    print(f"{tag} served: {stats['requests']} requests, "
          f"{stats['requests_s']} requests/s, p50 {stats['p50_ms']} ms, "
          f"p99 {stats['p99_ms']} ms, time to first response "
          f"{stats['ttfr_s']} s (warm-up of 4 buckets included)",
          flush=True)
    profile(torch, eng.plans[buckets[-1]].fn.graph.replay,
            f"{tag} bucket {buckets[-1]} graphed")
    out = dict(stats=stats, per_bucket=per_bucket, launches=launches,
               first=done[0].image, bucket128=kept, oracle=worst)
    # the graphs and their pools go with the engine
    del eng, done, g, buf
    return out


def serve_stats(torch, tag, run, params, x, eager):
    """``run_with_stats`` (or ``run_mlp_with_stats``) on one request on the
    card: its logits bitwise the eager forward's; prints each compute
    layer's event and dense MACs and the whole net's ratio."""
    y, st = run(params, x)
    check(bits_equal(torch, y, eager(x)), f"{tag}: run_with_stats logits "
          f"not bitwise the eager forward's")
    ev_macs = sum(d["event_macs"] for d in st)
    dn_macs = sum(d["dense_macs"] for d in st)
    print(f"{tag} run_with_stats on the first request: logits bitwise the "
          f"eager forward's; per layer event/dense MACs "
          + ", ".join(f"{d['kind']}{i} {d['event_macs']:.0f}/"
                      f"{d['dense_macs']:.0f}" for i, d in enumerate(st))
          + f"; the net {ev_macs:.0f}/{dn_macs:.0f} = "
          f"{ev_macs / dn_macs:.4f}", flush=True)
    return dict(event_macs=ev_macs, dense_macs=dn_macs,
                ratio=ev_macs / dn_macs)


# ---------------------------------------------------------------------------
# Phases 6 and 7: RWKV6-7B and Hymba-1.5B served at their published widths
# through the port's serve driver (prefill, then the greedy decode loop).
# ---------------------------------------------------------------------------

#: The serve driver's defaults (``repro_torch.launch.serve``).
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16

#: The long prompt of one prefill-only run per model: past Hymba's
#: sliding window of 1024, and 4 of Hymba's scan chunks of 512.
LM_LONG = 2000

#: Share of the (row, K-block) pairs of the main path's increment drive
#: that the θ > 0 run's threshold is set to kill (its quantile of block
#: max|drive|).
DEAD_TARGET = 0.4

#: Per served model: its phase, the gated step's kernel (wrapper name),
#: the prefill's kernel (or None: RWKV6's prefill scan is plain torch),
#: and the names its output lines use for the kernel, the state, the
#: readout and the drive.
LM_PHASES = {
    "rwkv6-7b": dict(tag="[6]", kernel="wkv6_step", label="B7", scan=None,
                     state="S'", readout="o", drive="k"),
    "hymba-1.5b": dict(tag="[7]", kernel="mamba_step", label="B8",
                       scan="mamba_scan_fused", state="h'", readout="y",
                       drive="g"),
}


class FirstCalls(list):
    """A wrapper's capture list that keeps only its first ``n`` launches
    (the rest are counted, not kept)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n

    def append(self, item):
        if len(self) < self.n:
            super().append(item)


def record_wkv(limit=None):
    """Patch ``models.ssm.wkv6_chunked`` to record, for its first ``limit``
    calls (all when None), ((r, k, v, w, u), o): what the RWKV6 prefill
    hands the chunked WKV at each layer and what it returns.  Returns
    (records, undo)."""
    from repro_torch.models import ssm
    orig, records = ssm.wkv6_chunked, []

    def recording(r, k, v, w, u, s0=None, *, chunk=32):
        o, s = orig(r, k, v, w, u, s0, chunk=chunk)
        check(s0 is None, "the prefill handed the chunked WKV a state")
        if limit is None or len(records) < limit:
            records.append(((r, k, v, w, u), o))
        return o, s

    ssm.wkv6_chunked = recording
    return records, lambda: setattr(ssm, "wkv6_chunked", orig)


def wkv_ops(torch, engine, wrappers, layers, long) -> dict:
    """Phase 6's B9/B9' ops on the RWKV6-7B prefill's own inputs, as the
    prefill hands them (bf16 r, k, v and f32 w, each a (B, H, T, D) view
    of (B, T, H, D)): B9' once on each recorded layer (``layers`` at
    prompt 32, ``long`` layer 0 at prompt 2000), B9 once on each head of
    layer 0 at prompt 32.  Checks: the counts; B9' S bitwise and o within
    1e-4 of max|plain| against the plain version; B9 bitwise B9''s slices.
    Prints B9''s gap to the chunked output per layer (not held: the
    chunked form clamps w at exp(WKV_LOG_DECAY_MIN), and is exact in
    exact arithmetic only)."""
    from repro_torch.kernels.wkv6.ref import wkv6_multihead_ref
    from repro_torch.models import ssm
    w_min = torch.exp(torch.tensor(ssm.WKV_LOG_DECAY_MIN,
                                   dtype=torch.float32)).item()
    recs = layers + long
    inputs = [a for a, _ in recs]
    clamped = sum(int((w.float() < w_min).sum()) for (_, _, _, w, _), _
                  in recs) / sum(w.numel() for (_, _, _, w, _), _ in recs)
    b9, b9p = wrappers["wkv6_single"], wrappers["wkv6"]
    r, k, v, w, u = inputs[0]
    heads = r.shape[1]

    def run_ops():
        return ([b9p(*a) for a in inputs],
                [b9(r[:, h], k[:, h], v[:, h], w[:, h], u[h])
                 for h in range(heads)])

    (outs, per_head), _, launches, _, _ = drive_counted(
        torch, engine, wrappers, run_ops, capture=False)
    plan = {n: 0 for n in wrappers} | {"wkv6": len(inputs),
                                       "wkv6_single": heads}
    check_plan("[6] B9/B9' ops", launches, plan)
    check(launches["wkv6"] == len(inputs)
          and launches["wkv6_single"] == heads,
          f"[6] B9/B9' ops: launches {launches}, want {plan}")
    worst, gaps = 0.0, []
    for a, (o, s), (_, o_chunk) in zip(inputs, outs, recs):
        o2, s2 = wkv6_multihead_ref(*a)
        check(torch.equal(s, s2), f"[6] B9' at {tuple(a[0].shape)}: S is "
              f"not bitwise the plain version's")
        ratio = float((o - o2).abs().max()) / max(float(o2.abs().max()),
                                                  1e-30)
        check(ratio <= 1e-4, f"[6] B9' at {tuple(a[0].shape)}: o off the "
              f"plain version by {ratio:.3e} of max|plain|")
        worst = max(worst, ratio)
        gaps.append(float((o - o_chunk).abs().max())
                    / max(float(o_chunk.abs().max()), 1e-30))
    o0, s0 = outs[0]
    for h, (oh, sh) in enumerate(per_head):
        check(torch.equal(oh, o0[:, h]) and torch.equal(sh, s0[:, h]),
              f"[6] B9 on head {h} is not bitwise B9''s slice")
    print(f"[6] B9' on the prefill's WKV inputs as they lie (r, k, v "
          f"{r.dtype}, w {w.dtype}, r's strides {r.stride()}; "
          f"{clamped:.2e} of the w values lie below the chunked form's "
          f"clamp {w_min:.6f}): {len(layers)} layers at prompt "
          f"{LM_PROMPT} {tuple(layers[0][0][0].shape)} and layer 0 at "
          f"prompt {LM_LONG} {tuple(long[0][0][0].shape)}: {launches['wkv6']}"
          f" launches, S bitwise the plain version's, o worst {worst:.3e} "
          f"of max|plain| (limit 1e-4); B9 on each of the {heads} heads "
          f"of layer 0: {launches['wkv6_single']} launches, bitwise B9''s "
          f"slices", flush=True)
    print(f"[6] B9' (exact recurrence) vs the model's chunked WKV output, "
          f"max|d o| / max|o| per layer (printed, not held): prompt "
          f"{LM_PROMPT} worst {max(gaps[:-1]):.3e} "
          f"{[f'{g:.1e}' for g in gaps[:-1]]}; prompt {LM_LONG} layer 0 "
          f"{gaps[-1]:.3e}", flush=True)
    return dict(wkv_main=inputs[0], wkv_long=inputs[-1],
                wkv6_launches=launches["wkv6"],
                wkv6_single_launches=launches["wkv6_single"])


def describe(cfg) -> str:
    ssm = (f", Mamba state {cfg.ssm.state_dim} x DI {cfg.d_model}"
           if cfg.ssm is not None else "")
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads ({cfg.num_kv_heads} KV) x "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}{ssm}")


def serve_lm(torch, engine, wrappers, arch, ref, cfg=None,
             device: str = "cuda") -> dict:
    """Phase 6 (RWKV6-7B, B7) or 7 (Hymba-1.5B, B8): the model at full
    width (f32 weights from seed 0 plus the compute-dtype copies of the
    leaves its blocks cast), batch 4, prompt 32, 16 greedy tokens through
    ``launch.serve.run_lm``.  Checks: the prefill launches the prefill's
    kernel (B10 for Hymba: L x ceil(prompt / scan chunk) times) and no
    other; the gated step's kernel launches L x 16 times in each gated
    decode and none in the ungated one, no other kernel launches; every
    recurrent_step record chained on route "event", no fallback_decode;
    each launch of the main path and of the θ > 0 run replayed against
    the plain version ``ref`` (the state bitwise, the readout within 1e-4
    of max), and each B10 launch of the main path against its plain
    version alike; the θ > 0 run kills at least a quarter of the (row,
    K-block) pairs; in f32, the gated decode (teacher-forced on the
    ungated one's inputs) within 1e-4 of max|logits| at every step.  A
    prefill at prompt 2000: the launches, finite logits, its time; for
    Hymba layer 0's B10 launches replayed, for RWKV6 the B9/B9' ops
    (``wkv_ops``) on what it and the prompt-32 prefill hand the chunked
    WKV.  Returns the numbers and the main path's last captures for
    phase 3."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import events as ev
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                    mamba_scan_streams)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models.param_utils import tree_leaves
    from repro_torch.models import transformer as tfm

    spec = LM_PHASES[arch]
    tag, name, label = spec["tag"], spec["kernel"], spec["label"]
    st, ro, dr = spec["state"], spec["readout"], spec["drive"]
    kern, scan = wrappers[name], spec["scan"]
    cfg = get_config(arch) if cfg is None else cfg
    check(cfg.mnf.enabled and cfg.mnf.threshold == 0.0
          and cfg.compute_dtype == "bfloat16", f"unexpected config {cfg}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    master = tfm.init_params(0, cfg, device)       # f32, the param dtype
    params = tfm.compute_params(master, cfg)       # + bf16 copies
    torch.cuda.synchronize()
    leaves, stack = [], [master]
    while stack:
        for v in stack.pop().values():
            (stack if isinstance(v, dict) else leaves).append(v)
    n_params = sum(t.numel() for t in leaves)
    print(f"{tag} {cfg.name}: {describe(cfg)}: {n_params / 1e9:.3f} G "
          f"params (f32) + bf16 copies of the leaves the blocks cast, made "
          f"from seed 0 in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card",
          flush=True)
    prompts = serve.make_prompts(cfg, LM_BATCH, LM_PROMPT, 0, device)

    def mnf(c, **kw):
        return dataclasses.replace(c, mnf=dataclasses.replace(c.mnf, **kw))

    def prefill_plan(plen):
        """Launches of a prefill of ``plen`` tokens: B10 once a layer and
        scan chunk (Hymba), no kernel for RWKV6 (its scan is the chunked
        form in plain torch); the fire-gated step runs only in decodes."""
        plan = {n: 0 for n in wrappers}
        if scan:
            plan[scan] = cfg.num_layers * -(-plen // cfg.ssm.scan_chunk)
        return plan

    def prefill_only(ptag, plen, toks, fn=None):
        """One prefill of ``toks`` (``fn`` runs first, inside the count):
        its launches as planned, no recurrent_step, finite logits."""
        plan = prefill_plan(plen)
        max_len = max(plen, LM_PROMPT + LM_GEN)

        def go():
            if fn is not None:
                fn()
            return tfm.prefill(params, toks, cfg, max_len=max_len)
        (logits, _), recs, launches, _, _ = drive_counted(
            torch, engine, wrappers, go, capture=False)
        check_plan(ptag, launches, plan)
        check(launches == plan, f"{ptag}: launches {launches}, want {plan}")
        check(not any(r.get("op") == "recurrent_step" for r in recs),
              f"{ptag} ran a recurrent_step")
        check(logits.shape == (LM_BATCH, 1, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"{ptag}: logits {tuple(logits.shape)} not finite")

    def replay_scan(rtag, caps):
        """Each captured launch of B10's fused entry against the plain
        version: h bitwise, y within 1e-4 of max|plain|; and against the
        streams entry run on the streams torch builds from the same dt, x,
        A, B and C (as the prefill built them before the fused entry): h
        and y bitwise.  Returns (worst y ratio, the replayed final
        states)."""
        worst, hs = 0.0, []
        for args, _ in caps:
            y, h = wrappers[scan](*args)
            y2, h2 = mamba_scan_fused_ref(*args)
            check(torch.equal(h, h2), f"{rtag}: B10's h is not bitwise the "
                  f"plain version's")
            ratio = float((y - y2).abs().max()) / max(
                float(y2.abs().max()), 1e-30)
            check(ratio <= 1e-4, f"{rtag}: B10's y off the plain version "
                  f"by {ratio:.3e} of max|plain|")
            y3, h3 = wrappers["mamba_scan"](*mamba_scan_streams(*args[:5]),
                                            args[5])
            check(torch.equal(h, h3) and torch.equal(y, y3),
                  f"{rtag}: B10's fused entry is not bitwise its streams "
                  f"entry on torch's streams (max|d h| "
                  f"{float((h - h3).abs().max()):.3e}, max|d y| "
                  f"{float((y - y3).abs().max()):.3e})")
            worst = max(worst, ratio)
            hs.append(h)
            del y2, h2, y3, h3
        return worst, hs

    per_decode = cfg.num_layers * LM_GEN
    dense_plan = prefill_plan(LM_PROMPT)
    gated_plan = dense_plan | {name: per_decode}

    # The prefill alone; RWKV6 records what it hands the chunked WKV at
    # every layer, for the B9/B9' ops.
    if scan is None:
        wkv_in, undo = record_wkv()
    try:
        prefill_only(f"{tag} prefill", LM_PROMPT, prompts)
    finally:
        if scan is None:
            undo()

    def served(stag, c, p, plan, capture=False, **kw):
        run, recs, launches, caps, _ = drive_counted(
            torch, engine, wrappers,
            lambda: serve.run_lm(p, c, prompts, LM_GEN, graph=False, **kw),
            capture)
        check_plan(stag, launches, plan)
        check(all(launches[n] == plan[n] for n in (name, scan) if n),
              f"{stag}: launches {launches}, want {plan}")
        steps = [r for r in recs if r.get("op") == "recurrent_step"]
        check(len(steps) == launches[name] and all(
            r.get("chained") and r.get("route") == "event"
            and r.get("backend") == engine.EngineConfig().resolve_backend(
                prompts) for r in steps),
              f"{stag}: recurrent_step records not all chained on route "
              f"'event': {steps[:2]}")
        check(not any(r.get("fallback_decode") or r.get("decode")
                      for r in recs), f"{stag}: fallback_decode")
        check(run["tokens"].shape == (LM_BATCH, LM_GEN)
              and int(run["tokens"].min()) >= 0
              and int(run["tokens"].max()) < cfg.vocab_size,
              f"{stag}: tokens {tuple(run['tokens'].shape)} out of range")
        if run["logits"] is not None:
            check(run["logits"].shape == (LM_GEN, LM_BATCH, cfg.vocab_size)
                  and bool(torch.isfinite(run["logits"]).all()),
                  f"{stag}: logits not finite of the expected shape")
        run["launches"] = launches
        return run, caps

    def replay(rtag, caps):
        """Each captured launch against the plain version: the state
        bitwise, the readout within 1e-4 of max|plain|.  Returns (worst
        readout ratio, dead share of the (row, K-block) pairs)."""
        worst, dead, pairs = 0.0, 0, 0
        for args, kw in caps:
            out, state = kern(*args, **kw)
            out2, state2 = ref(*args, **kw)
            check(torch.equal(state, state2), f"{rtag}: {label}'s {st} is "
                  f"not bitwise the plain version's")
            ratio = float((out - out2).abs().max()) / max(
                float(out2.abs().max()), 1e-30)
            check(ratio <= 1e-4, f"{rtag}: {label}'s {ro} off the plain "
                  f"version by {ratio:.3e} of max|plain|")
            worst = max(worst, ratio)
            live = ev.live_block_mask(args[0])
            dead += int((~live).sum())
            pairs += live.numel()
        return worst, dead / pairs

    def all_live(rtag, caps):
        """DESIGN.md §13's within-backend contract: the captured launch
        with the most dead (row, K-block) pairs, replayed on the all-live
        drive of the same values (encode at threshold -1), gives the same
        readout and state bitwise.  Returns (dead pairs, pairs)."""
        dead = [int((~ev.live_block_mask(a[0])).sum()) for a, _ in caps]
        args, kw = caps[dead.index(max(dead))]
        bev = args[0]
        g, _, _, bk = bev.values.shape
        drive = ev.decode_block_events(bev, blk_m=1, blk_k=bk, m=g,
                                       k=bev.num_k_blocks * bk)
        twin = ev.encode_block_events(drive, blk_m=1, blk_k=bk,
                                      threshold=-1.0)
        check(int(twin.counts.sum()) == g * bev.num_k_blocks,
              f"{rtag}: the threshold -1 encode left a block dead")
        (out, state), (out2, state2) = (kern(*args, **kw),
                                        kern(twin, *args[1:], **kw))
        check(torch.equal(out, out2) and torch.equal(state, state2),
              f"{rtag}: {label} on the θ=0 drive is not bitwise {label} on "
              f"its all-live drive")
        return max(dead), g * bev.num_k_blocks

    def graphed(gtag, c, ref, plan):
        """The graphed serve of config ``c`` (``run_lm`` on CUDA graphs of
        the prefill and the decode step, one memory pool) against its eager
        run ``ref``, every launch count set to 0 just before and read just
        after: the kernels of the path launched (at the warm-ups and
        captures) and none off it; the launches the captures saw, times
        their replays, are ``plan``'s; tokens, inputs, events, the
        prefill's and every step's logits and every leaf of the final
        cache bitwise ``ref``'s.  ``run_lm`` runs the decode loop under
        set_sync_debug_mode("error"): it made no host sync.  Returns (the
        run, its launches captured x replayed)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run, _, raw, _, _ = drive_counted(
            torch, engine, wrappers,
            lambda: serve.run_lm(params, c, prompts, LM_GEN,
                                 keep_logits=True), capture=False)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        got = {n: run["launches"].get(w, 0) for n, w in wrappers.items()}
        missing = [n for n, want in plan.items() if want and not raw[n]]
        stray = [n for n, want in plan.items() if not want and raw[n]]
        check(not missing and not stray, f"{gtag}: kernels of the path "
              f"never launched {missing}, off it launched {stray}")
        check_plan(f"{gtag} (captured x replayed)", got, plan)
        check(got == plan, f"{gtag}: launches captured x replayed {got}, "
              f"want {plan}")
        for key in ("tokens", "inputs", "prefill_logits", "logits",
                    "events"):
            same = run[key] is None and ref[key] is None or torch.equal(
                run[key], ref[key])
            check(same, f"{gtag}: {key} not bitwise the eager serve's")
        mine, theirs = tree_leaves(run["cache"]), tree_leaves(ref["cache"])
        check(len(mine) == len(theirs) and all(
            torch.equal(a, b) for a, b in zip(mine, theirs)),
              f"{gtag}: the final cache is not bitwise the eager serve's")
        print(f"{gtag}: tokens, events, the prefill's and every step's "
              f"logits and all {len(mine)} cache leaves bitwise the eager "
              f"serve's; no host sync in the decode loop (run_lm holds it "
              f"under set_sync_debug_mode('error')); warm-ups and captures "
              f"{run['capture_s']:.3f} s, peak memory above the model "
              f"{peak:.3f} GiB; prefill {run['prefill_s'] * 1e3:.3f} ms, "
              f"decode {LM_GEN * LM_BATCH / run['decode_s']:.1f} tokens/s",
              flush=True)
        return run, got

    # The main path: the config as published, MNF on at θ = 0, bf16.
    run_a, caps_a = served(f"{tag} gated θ=0 bf16", cfg, params, gated_plan,
                           capture=True, keep_logits=True)
    worst_a, dead_a = replay(f"{tag} gated θ=0", caps_a[name])
    dead_n, pairs = all_live(f"{tag} gated θ=0", caps_a[name])
    print(f"{tag} within-backend (DESIGN.md §13): the main-path {label} "
          f"launch with the most dead (row, K-block) pairs ({dead_n} of "
          f"{pairs}) replayed on its all-live drive (threshold -1 encode): "
          f"{ro} and {st} bitwise equal", flush=True)
    if scan:
        worst_s, _ = replay_scan(f"{tag} gated θ=0", caps_a[scan])
        print(f"{tag} main path: every B10 launch of the prefill (the fused "
              f"entry) replayed ({len(caps_a[scan])}, at dt "
              f"{tuple(caps_a[scan][0][0][0].shape)} "
              f"{caps_a[scan][0][0][0].dtype}): h bitwise the plain "
              f"version's, y worst {worst_s:.3e} of max|plain|; h and y "
              f"bitwise the streams entry on torch's streams", flush=True)
    ev_a = run_a["events"].sum(1)
    run_b, _ = served(f"{tag} ungated bf16", mnf(cfg, enabled=False), params,
                      dense_plan, keep_logits=True)
    agree = int((run_a["tokens"] == run_b["tokens"]).sum())
    # θ > 0: the DEAD_TARGET quantile of block max|drive| over the main
    # path's drive
    blockmax = torch.cat([args[0].values.abs().amax(dim=(2, 3)).flatten()
                          for args, _ in caps_a[name]])
    theta = float(f"{float(torch.quantile(blockmax, DEAD_TARGET)):.3g}")
    cfg_th = mnf(cfg, threshold=theta)
    run_c, caps_c = served(f"{tag} gated θ={theta} bf16", cfg_th, params,
                           gated_plan, capture=True, keep_logits=True)
    worst_c, dead_c = replay(f"{tag} gated θ={theta}", caps_c[name])
    del caps_c
    ev_c = run_c["events"].sum(1)
    print(f"{tag} main path (θ=0, bf16): every {label} launch replayed: "
          f"{st} bitwise, {ro} worst {worst_a:.3e} of max|plain|, dead "
          f"share {dead_a:.4f}; events per token {float(ev_a.mean()):.1f} "
          f"(min {float(ev_a.min()):.1f}, max {float(ev_a.max()):.1f}); "
          f"greedy tokens equal to the ungated decode's: {agree} of "
          f"{LM_BATCH * LM_GEN}", flush=True)
    print(f"{tag} θ={theta} (the {DEAD_TARGET} quantile of block "
          f"max|{dr}| on the main path): dead share of (row, K-block) pairs "
          f"{dead_c:.4f} (limit >= 0.25), every {label} launch replayed: "
          f"{st} bitwise, {ro} worst {worst_c:.3e}; events per token "
          f"{float(ev_c.mean()):.1f} (min {float(ev_c.min()):.1f}, max "
          f"{float(ev_c.max()):.1f})", flush=True)
    check(dead_c >= 0.25, f"θ={theta}: dead share {dead_c:.4f} < 0.25")

    # The same three decodes on CUDA graphs, the main path (θ = 0) first,
    # each held bitwise against its eager run above.
    _, got_a = graphed(f"{tag} graphed gated θ=0 bf16", cfg, run_a,
                       gated_plan)
    graphed(f"{tag} graphed ungated bf16", mnf(cfg, enabled=False), run_b,
            dense_plan)
    graphed(f"{tag} graphed gated θ={theta} bf16", cfg_th, run_c, gated_plan)

    # f32: the gated decode against the ungated one, teacher-forced on the
    # ungated run's inputs, step by step.
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = tfm.compute_params(master, cfg32)       # the f32 tensors as they are
    ref32, _ = served(f"{tag} ungated f32", mnf(cfg32, enabled=False), p32,
                      dense_plan, keep_logits=True)
    gated32, _ = served(f"{tag} gated θ=0 f32", cfg32, p32, gated_plan,
                        keep_logits=True, teacher=ref32["inputs"])
    ratios = [float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
              for g, r in zip(gated32["logits"], ref32["logits"])]
    print(f"{tag} f32, gated θ=0 vs ungated, teacher-forced: max|d logits| "
          f"/ max|logits| per step worst {max(ratios):.3e} (limit 1e-4; "
          f"steps {[f'{x:.1e}' for x in ratios]})", flush=True)
    check(max(ratios) <= 1e-4, f"{tag} f32 gated vs ungated logits ratio "
          f"{max(ratios):.3e}")
    del p32, ref32, gated32

    # Warm timings, bf16, eager and graphed in turns.
    cells = (("gated θ=0", cfg), (f"gated θ={theta}", cfg_th),
             ("ungated", mnf(cfg, enabled=False)))
    times = {(cname, g): [] for cname, _ in cells for g in (False, True)}
    for _ in range(2):
        for cname, c in cells:
            for g in (False, True):
                run = serve.run_lm(params, c, prompts, LM_GEN, graph=g)
                times[(cname, g)].append((
                    run["prefill_s"] * 1e3,
                    LM_GEN * LM_BATCH / run["decode_s"], run["capture_s"]))
    tok_s, tok_s_graph = ({n: max(t[1] for t in times[(n, g)])
                           for n, _ in cells} for g in (False, True))
    prefill_ms, prefill_ms_graph = (
        min(t[0] for (_, g2), ts in times.items() if g2 == g for t in ts)
        for g in (False, True))
    for g, label_ in ((False, "eager"), (True, "graphed")):
        print(f"{tag} warm, bf16, batch {LM_BATCH}, prompt {LM_PROMPT}, "
              f"{LM_GEN} tokens, {label_} (2 runs each, eager and graphed in "
              f"turns): prefill "
              f"{prefill_ms_graph if g else prefill_ms:.3f} ms (best; all "
              f"{[round(t[0], 3) for (_, g2), ts in times.items() if g2 == g for t in ts]}); "
              f"decode tokens/s " + "; ".join(
                  f"{n} {max(t[1] for t in times[(n, g)]):.1f} "
                  f"({[round(t[1], 1) for t in times[(n, g)]]})"
                  for n, _ in cells)
              + ("; warm-ups and captures s "
                 f"{[round(t[2], 3) for (_, g2), ts in times.items() if g2 for t in ts]}"
                 if g else ""), flush=True)
    print(f"{tag} on graphs, gated θ=0 / ungated decode tokens/s: "
          f"{tok_s_graph['gated θ=0'] / tok_s_graph['ungated']:.3f} "
          f"(eager {tok_s['gated θ=0'] / tok_s['ungated']:.3f})", flush=True)
    profile(torch, lambda: serve.run_lm(params, cfg, prompts, LM_GEN,
                                        graph=False),
            f"{tag} gated θ=0 bf16 serve (prefill + {LM_GEN} decode steps)",
            steps=1)
    # the main path's counts: the graphed serve's, captured x replayed
    main = got_a
    out = dict(caps=caps_a[name][-1:], launches=main[name], theta=theta,
               dead=dead_c, tok_s=tok_s, tok_s_graph=tok_s_graph,
               prefill_ms=prefill_ms, prefill_ms_graph=prefill_ms_graph,
               events=float(ev_a.mean()), agree=agree,
               f32_ratio=max(ratios))
    if scan:
        out.update(scan_caps=caps_a[scan][-1:], scan_launches=main[scan],
                   streams_launches=main["mamba_scan"])
    del caps_a

    if scan is None:
        out["roofline"] = decode_roofline(torch, tag, arch, params, cfg,
                                          prompts, kern)

    # One prefill at prompt 2000: Hymba keeps layer 0's B10 launches (4
    # chunks; da and dbx are ~1.6 GB a layer at this length) and replays
    # them; RWKV6 records layer 0's chunked-WKV inputs.
    long = serve.make_prompts(cfg, LM_BATCH, LM_LONG, 0, device)
    ltag = f"{tag} prefill at prompt {LM_LONG}"
    if scan:
        keep = FirstCalls(-(-LM_LONG // cfg.ssm.scan_chunk))
        prefill_only(ltag, LM_LONG, long,
                     lambda: setattr(wrappers[scan], "capture", keep))
        worst_l, hs = replay_scan(ltag, keep)
        check(keep[0][0][-1] is None and all(
            torch.equal(h, args[-1]) for h, (args, _) in zip(hs, keep[1:])),
              f"{ltag}: layer 0's B10 launches do not carry h")
        out.update(scan_long=list(keep))
        detail = (f"B10 x{prefill_plan(LM_LONG)[scan]}; layer 0's "
                  f"{len(keep)} launches (T {[a[0].shape[1] for a, _ in keep]}"
                  f", h carried) replayed: h bitwise, y worst {worst_l:.3e} "
                  f"of max|plain|, both bitwise the streams entry's")
    else:
        wkv_long, undo = record_wkv(limit=1)
        try:
            prefill_only(ltag, LM_LONG, long)
        finally:
            undo()
        detail = "no kernel"
    _, times = host_ms(torch, lambda: tfm.prefill(params, long, cfg,
                                                  max_len=LM_LONG))
    out["long_ms"] = min(times)
    print(f"{ltag}, batch {LM_BATCH}, bf16: {detail}; finite logits; "
          f"{out['long_ms']:.3f} ms (best of 3: "
          f"{[round(t, 3) for t in times]})", flush=True)
    # the same prefill as a CUDA graph: bitwise the eager prefill, timed
    pre = lm_steps.make_prefill_step(
        cfg, ShapeConfig("pf", LM_LONG, LM_BATCH, "prefill"))
    g = pre.fn.capture(params, long)
    want = tfm.prefill(params, long, cfg, max_len=LM_LONG)
    got = pre.fn(params, dict(tokens=long))
    mine, theirs = tree_leaves(got), tree_leaves(want)
    check(len(mine) == len(theirs) and all(
        torch.equal(a, b) for a, b in zip(mine, theirs)),
          f"{ltag}: the graph's logits or cache not bitwise the eager "
          f"prefill's")
    del want, got, mine, theirs
    _, times = host_ms(torch, lambda: pre.fn(params, dict(tokens=long)))
    out["long_ms_graph"] = min(times)
    print(f"{ltag}, graphed: warm-up {g.warmup_s:.3f} s and capture "
          f"{g.capture_s:.3f} s, "
          f"logits and cache bitwise the eager prefill's; "
          f"{out['long_ms_graph']:.3f} ms (best of 3: "
          f"{[round(t, 3) for t in times]})", flush=True)
    del pre, g
    torch.cuda.empty_cache()
    if scan is None:
        out.update(wkv_ops(torch, engine, wrappers, wkv_in, wkv_long))
    return out


#: RWKV6-7B's gated decode step as PERF.md section 5 records it (batch
#: 4, graphed): the byte floor reckoned by hand, and the measured device
#: busy time, in ms.
RWKV_DECODE_FLOOR_MS, RWKV_DECODE_BUSY_MS = 4.5, 13.70


def decode_roofline(torch, tag, arch, params, cfg, prompts, kern) -> dict:
    """Phase 6: the roofline of one eager gated decode step (θ = 0, bf16)
    after a prefill of the prompts, counted by ``launch.roofline
    .count_cost``: the aten ops by PyTorch's FLOP counter and the byte
    counter, the L launches of B7 (``kern``) by its formula.  Checks:
    one B7 call a layer counted, and the memory term at least the bytes
    of the step's bf16 weights over the HBM rate (the weights set the
    floor; the counter adds copies on top, never less).  Prints the row
    beside PERF.md section 5's hand-reckoned byte floor and measured busy
    time."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    from repro_torch.models.param_utils import tree_leaves
    from repro_torch.models import transformer as tfm

    _, cache = tfm.prefill(params, prompts, cfg, max_len=LM_PROMPT + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, cost = roofline.count_cost(tfm.decode_step, params, cache,
                                  prompts[:, -1:], LM_PROMPT, cfg)
    torch.cuda.synchronize()
    calls, kbytes, kops = cost.kernels.get(kern.__name__, [0, 0, 0.0])
    check(calls == cfg.num_layers and set(cost.kernels) == {kern.__name__},
          f"{tag} roofline: kernels counted {cost.kernels}, want "
          f"{cfg.num_layers} {kern.__name__} calls")
    rep = roofline.analyze(arch, cfg, ShapeConfig("decode", LM_PROMPT + 1,
                                                  LM_BATCH, "decode"),
                           "1", 1, cost, torch.cuda.max_memory_allocated())
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                  if t.dtype == torch.bfloat16)
    floor_ms = weights / roofline.HW().hbm_bw * 1e3
    check(rep.t_memory * 1e3 >= floor_ms, f"{tag} roofline: t_memory "
          f"{rep.t_memory * 1e3:.3f} ms below the bf16 weights' "
          f"{floor_ms:.3f} ms")
    print(f"{tag} roofline of one gated decode step (θ=0, bf16, batch "
          f"{LM_BATCH}, eager, counted): {rep.hlo_gflops:.3f} GFLOP, "
          f"{rep.hlo_gbytes:.3f} GB (aten ops {rep.xla_raw_gbytes:.3f} GB; "
          f"B7 x{calls} by its formula {kbytes / 1e9:.4f} GB, "
          f"{kops / 1e9:.4f} GFLOP); t_compute {rep.t_compute * 1e3:.4f} ms,"
          f" t_memory {rep.t_memory * 1e3:.3f} ms [{rep.bottleneck}] "
          f"beside PERF.md section 5's hand-reckoned byte floor "
          f"{RWKV_DECODE_FLOOR_MS} ms and measured busy "
          f"{RWKV_DECODE_BUSY_MS:.2f} ms; the bf16 weights alone "
          f"{weights / 1e9:.3f} GB = {floor_ms:.3f} ms (gate: t_memory >= "
          f"it); model {rep.model_gflops:.3f} GFLOP, useful_ratio "
          f"{rep.useful_ratio:.3f}, roofline_frac {rep.roofline_frac:.4f} "
          f"(card {card_line()})", flush=True)
    print(roofline.format_row(rep), flush=True)
    del cache
    return dict(rep.to_json(), weights_ms=floor_ms)


def wkv_kernels(torch, rwkv, report, close) -> dict:
    """Phase 3 for B9' (wkv6) and B9 (wkv6_single) on layer 0's inputs of
    phase 6's prefill at prompt 32 as the prefill hands them (bf16 r, k, v
    and f32 w, (B, H, T, D) views of (B, T, H, D); every launch there was
    held against the plain version): B9' warm, with its inputs cold in L2
    and through its wrapper, B9 on head 0's rows, B9' at prompt 2000.
    Returns the prompt-2000 time (ms)."""
    from repro_torch.kernels.wkv6 import ops as wkv_scan_ops
    from repro_torch.kernels.wkv6.kernel import wkv6_cuda
    from repro_torch.kernels.wkv6.ops import wkv6_scan_work
    from repro_torch.kernels.wkv6.ref import wkv6_multihead_ref, wkv6_ref

    def wkv_args(a):
        """The launcher's arguments: r, k, v, w as they lie, u f32."""
        r_, k_, v_, w_, u_ = a
        return r_, k_, v_, w_, u_.float().contiguous(), None

    main = rwkv["wkv_main"]
    kargs = wkv_args(main)
    o, s_new = wkv6_cuda(*kargs)
    o2, s2 = wkv6_multihead_ref(*main)
    check(torch.equal(s_new, s2), "wkv6: S != plain bitwise")
    err = close(o, o2, "wkv6 o")
    b, heads, t, d = kargs[0].shape
    ms = graph_ms(torch, lambda: wkv6_cuda(*kargs), 20)
    wrapper_ms = graph_ms(torch, lambda: wkv_scan_ops.wkv6(*main), 20)
    # Inputs cold in L2: 16 copies (~84 MB of r, k, v, w at prompt 32,
    # past the H100's 50 MB L2) taken in turn, so each launch reads its
    # inputs from DRAM, as the byte bound counts them; the graph of 20
    # launches above replays on inputs that stay in L2.
    rot, turn = [tuple(x.clone() for x in kargs[:4]) + kargs[4:]
                 for _ in range(16)], [0]

    def rotated():
        turn[0] += 1
        return wkv6_cuda(*rot[turn[0] % len(rot)])
    cold_ms = graph_ms(torch, rotated, 20)
    check(all(x.stride() == y.stride() for x, y in zip(rot[0], kargs[:4])),
          "wkv6: the L2-cold copies do not keep the inputs' strides")
    del rot
    long = rwkv["wkv_long"]
    kargs_l = wkv_args(long)
    g_l, t_l = kargs_l[0].shape[0] * kargs_l[0].shape[1], kargs_l[0].shape[2]
    ms_l = graph_ms(torch, lambda: wkv6_cuda(*kargs_l), 3)
    plain_l = cuda_ms(torch, lambda: wkv6_multihead_ref(*long), 1)
    b_l = bound_ms(*wkv6_scan_work(*kargs_l))
    report("wkv6", err, ms, cuda_ms(torch, lambda: wkv6_multihead_ref(*main),
                                    1),
           None, bound_ms(*wkv6_scan_work(*kargs)),
           f" at RWKV6-7B layer 0's prefill rows ({b * heads}, {t}, {d}) = "
           f"batch {b} x {heads} heads, prompt {LM_PROMPT}, r, k, v "
           f"{kargs[0].dtype} and w {kargs[3].dtype} as they lie (r's "
           f"strides {kargs[0].stride()}); its wrapper {wrapper_ms:.4f} ms; "
           f"{cold_ms:.4f} ms with its inputs cold in L2 (16 copies in "
           f"turn); an op: {rwkv['wkv6_launches']} launches on phase 6's "
           f"recorded inputs, none on the model path",
           wrapper_ms=wrapper_ms, l2_cold_ms=cold_ms, prompt_2000_ms=ms_l,
           prompt_2000_bound_ms=b_l[0])
    print(f"[3] wkv6 at prompt {LM_LONG} (RWKV6-7B layer 0, rows "
          f"{(g_l, t_l, d)}, as they lie): {ms_l:.4f} ms, plain "
          f"{plain_l:.3f} ms, bound {b_l[0]:.4f} ms ({b_l[1]})", flush=True)
    # head 0's rows: the (B, T, D) views r[:, 0], ..., bonus row u[0]
    one = tuple(x[:, 0] for x in kargs[:4]) + (kargs[4][0], None)
    o1, s1 = wkv6_cuda(*one)
    check(torch.equal(o1, o[:, 0]) and torch.equal(s1, s_new[:, 0]),
          "wkv6_single: != B9''s head 0 bitwise")
    o2, s2 = wkv6_ref(*one[:5])
    check(torch.equal(s1, s2), "wkv6_single: S != plain bitwise")
    err = close(o1, o2, "wkv6_single o")
    report("wkv6_single", err, graph_ms(torch, lambda: wkv6_cuda(*one), 50),
           cuda_ms(torch, lambda: wkv6_ref(*one[:5]), 2), None,
           bound_ms(*wkv6_scan_work(*one)),
           f" at head 0's rows ({b}, {t}, {d}) as they lie, bitwise B9''s "
           f"slice; an op: {rwkv['wkv6_single_launches']} launches, one "
           f"per head of layer 0, none on the model path")
    del rwkv["wkv_main"], rwkv["wkv_long"]
    return dict(wkv_long_ms=ms_l)


def lm_kernels(torch, rwkv, hymba, report, close) -> dict:
    """Phase 3 for the LM kernels, each at its main-path shape against its
    plain version: B7 and B8 at the last launch of phases 6 and 7's main
    paths, B9' and B9 on layer 0's recorded prefill inputs of phase 6,
    B10's fused entry at the last B10 launch of phase 7's main path and
    its streams entry on torch's streams of the same inputs; B9' and both
    B10 entries also at prompt 2000 (one layer).  Every launch of the
    phases was held against the plain version there.  Returns the
    prompt-2000 times (ms)."""
    from repro_torch.kernels.mamba_scan.kernel import (mamba_scan_cuda,
                                                       mamba_scan_fused_cuda)
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan_fused_work,
                                                    mamba_scan_work)
    from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                    mamba_scan_ref,
                                                    mamba_scan_streams)
    from repro_torch.kernels.mamba_step import ops as mamba_ops
    from repro_torch.kernels.mamba_step.kernel import mamba_step_cuda
    from repro_torch.kernels.mamba_step.ops import mamba_work
    from repro_torch.kernels.mamba_step.ref import mamba_step_events_ref
    from repro_torch.kernels.wkv6_step import ops as wkv6_ops
    from repro_torch.kernels.wkv6_step.kernel import wkv6_step_cuda
    from repro_torch.kernels.wkv6_step.ops import wkv6_work
    from repro_torch.kernels.wkv6_step.ref import wkv6_step_events_ref

    # B7 wkv6_step: the main path's last launch (RWKV6-7B, batch 4, θ=0);
    # every launch of phase 6 was held against the plain version there
    (args, kw), = rwkv["caps"]
    bev, r_, v_, w_, u_, s_ = args
    kargs = (bev.values, bev.block_idx, bev.counts, r_, v_, w_, u_, s_)
    o, s_new = wkv6_step_cuda(*kargs, nkb=bev.num_k_blocks)
    o2, s2 = wkv6_step_events_ref(*args, **kw)
    check(torch.equal(s_new, s2), "wkv6_step: S' != plain bitwise")
    err = close(o, o2, "wkv6_step o")
    wrapper_ms = graph_ms(torch, lambda: wkv6_ops.wkv6_step_events(*args,
                                                                   **kw), 50)
    report("wkv6_step", err,
           graph_ms(torch, lambda: wkv6_step_cuda(
               *kargs, nkb=bev.num_k_blocks), 50),
           cuda_ms(torch, lambda: wkv6_step_events_ref(*args, **kw), 5),
           None, bound_ms(*wkv6_work(bev, r_)),
           f" at rows {tuple(r_.shape)}, state {tuple(s_.shape)}, events "
           f"{tuple(bev.values.shape)}; the wrapper (no live mask: the "
           f"kernel derives it) {wrapper_ms:.4f} ms; "
           f"{rwkv['launches'] // LM_GEN} launches per token",
           wrapper_ms=wrapper_ms)
    del rwkv["caps"], args, kargs

    # B8 mamba_step: the main path's last launch (Hymba-1.5B, batch 4,
    # θ=0); every launch of phase 7 was held against the plain version there
    (args, kw), = hymba["caps"]
    bev, da_, bm_, cm_, h_ = args
    kargs = (bev.values, bev.block_idx, bev.counts, da_, bm_, cm_, h_)
    y, h_new = mamba_step_cuda(*kargs, nkb=bev.num_k_blocks)
    y2, h2 = mamba_step_events_ref(*args, **kw)
    check(torch.equal(h_new, h2), "mamba_step: h' != plain bitwise")
    err = close(y, y2, "mamba_step y")
    wrapper_ms = graph_ms(torch, lambda: mamba_ops.mamba_step_events(
        *args, **kw), 50)
    report("mamba_step", err, graph_ms(torch, lambda: mamba_step_cuda(
               *kargs, nkb=bev.num_k_blocks), 50),
           cuda_ms(torch, lambda: mamba_step_events_ref(*args, **kw), 5),
           None, bound_ms(*mamba_work(bev, h_)),
           f" at state {tuple(h_.shape)}, B/C {tuple(bm_.shape)}, events "
           f"{tuple(bev.values.shape)}; the wrapper (no live mask: the "
           f"kernel derives it) {wrapper_ms:.4f} ms; "
           f"{hymba['launches'] // LM_GEN} launches per token",
           wrapper_ms=wrapper_ms)
    del hymba["caps"], args, kargs

    out = wkv_kernels(torch, rwkv, report, close)

    # B10: the main path's last launch of the fused entry (Hymba-1.5B,
    # batch 4, prompt 32; every launch of phase 7's main path was held
    # against the plain version and the streams entry there), and the
    # streams entry on the streams torch builds from the same inputs; then
    # layer 0 at prompt 2000 (4 launches, h carried) through both entries,
    # and the eager stream building that the fused entry removes
    def fused_args(a):
        """The fused launcher's arguments, as its wrapper hands them."""
        dt_, x_, a_, b_, c_, h0_ = a
        return (dt_, x_, a_.float().contiguous(), b_, c_,
                None if h0_ is None else h0_.float().contiguous())

    def stream_args(a):
        """The streams entry's arguments: torch's streams of ``a``."""
        return tuple(x.contiguous() for x in mamba_scan_streams(*a[:5])) \
            + (None if a[5] is None else a[5].float().contiguous(),)

    (args, _), = hymba["scan_caps"]
    fargs, sargs = fused_args(args), stream_args(args)
    y, h_new = mamba_scan_fused_cuda(*fargs)
    y2, h2 = mamba_scan_fused_ref(*args)
    check(torch.equal(h_new, h2), "mamba_scan_fused: h != plain bitwise")
    err = close(y, y2, "mamba_scan_fused y")
    ys, hs = mamba_scan_cuda(*sargs)
    y2, h2 = mamba_scan_ref(*sargs)
    check(torch.equal(hs, h2), "mamba_scan: h != plain bitwise")
    err_s = close(ys, y2, "mamba_scan y")
    check(torch.equal(hs, h_new) and torch.equal(ys, y),
          "mamba_scan_fused != mamba_scan on torch's streams bitwise")
    largs = [a for a, _ in hymba["scan_long"]]
    lf = [fused_args(a) for a in largs]
    ls = [stream_args(a) for a in largs]

    def scan_layer(launch, inputs, carry):
        h = None
        for a in inputs:
            _, h = launch(*a[:carry], h)
        return h

    long = {
        "fused": (graph_ms(torch, lambda: scan_layer(
                      mamba_scan_fused_cuda, lf, 5), 3),
                  cuda_ms(torch, lambda: scan_layer(
                      mamba_scan_fused_ref, largs, 5), 1),
                  bound_ms(*map(sum, zip(*(
                      mamba_scan_fused_work(*a[:5], a[5] if i else None)
                      for i, a in enumerate(lf)))))),
        "streams": (graph_ms(torch, lambda: scan_layer(
                        mamba_scan_cuda, ls, 3), 3),
                    cuda_ms(torch, lambda: scan_layer(
                        mamba_scan_ref, ls, 3), 1),
                    bound_ms(*map(sum, zip(*(
                        mamba_scan_work(*a[:3], a[3] if i else None)
                        for i, a in enumerate(ls))))))}
    build_ms = graph_ms(torch, lambda: [mamba_scan_streams(*a[:5])
                                        for a in largs], 1)
    t_long = [a[0].shape[1] for a in largs]
    report("mamba_scan_fused", err, graph_ms(
               torch, lambda: mamba_scan_fused_cuda(*fargs), 20),
           cuda_ms(torch, lambda: mamba_scan_fused_ref(*args), 2), None,
           bound_ms(*mamba_scan_fused_work(*fargs[:6])),
           f" at dt/x {tuple(fargs[0].shape)} {fargs[0].dtype}, A "
           f"{tuple(fargs[2].shape)}, B/C {tuple(fargs[3].shape)}, h0 "
           f"{'None' if fargs[5] is None else 'given'}; bitwise the streams "
           f"entry on torch's streams; {hymba['scan_launches']} launches "
           f"per prefill (one a layer)",
           prompt_2000_ms=long["fused"][0],
           prompt_2000_bound_ms=long["fused"][2][0])
    # The streams entry with its inputs cold in L2: 4 copies (~112 MB, past
    # the H100's 50 MB L2) taken in turn, so each launch reads its streams
    # from DRAM, as the byte bound counts them; the graph of 20 launches
    # above replays on inputs that stay in L2.
    rot, turn = [tuple(None if x is None else x.clone() for x in sargs)
                 for _ in range(4)], [0]

    def rotated():
        turn[0] += 1
        return mamba_scan_cuda(*rot[turn[0] % len(rot)])
    cold_ms = graph_ms(torch, rotated, 20)
    del rot
    report("mamba_scan", err_s, graph_ms(
               torch, lambda: mamba_scan_cuda(*sargs), 20),
           cuda_ms(torch, lambda: mamba_scan_ref(*sargs), 2), None,
           bound_ms(*mamba_scan_work(*sargs[:4])),
           f" at da/dbx {tuple(sargs[0].shape)}, c {tuple(sargs[2].shape)}"
           f", h0 {'None' if sargs[3] is None else 'given'} (torch's "
           f"streams of the fused entry's inputs); the model calls the fused "
           f"entry: {hymba['streams_launches']} launches on the main path; "
           f"{cold_ms:.4f} ms with "
           f"its inputs cold in L2 (4 copies in turn)",
           l2_cold_ms=cold_ms, prompt_2000_ms=long["streams"][0],
           prompt_2000_bound_ms=long["streams"][2][0],
           stream_build_ms=build_ms)
    for name, (ms_l, plain_l, b_l) in long.items():
        print(f"[3] mamba_scan ({name} entry) at prompt {LM_LONG} "
              f"(Hymba-1.5B layer 0: {len(largs)} launches, T {t_long}, h "
              f"carried): {ms_l:.4f} ms a layer, plain {plain_l:.3f} ms, "
              f"bound {b_l[0]:.4f} ms ({b_l[1]})", flush=True)
    print(f"[3] the eager building of layer 0's streams at prompt {LM_LONG} "
          f"(what the fused entry removes; {len(largs)} chunks, "
          f"graph-timed): "
          f"{build_ms:.4f} ms; streams entry + building "
          f"{long['streams'][0] + build_ms:.4f} ms against the fused entry "
          f"{long['fused'][0]:.4f} ms", flush=True)
    out["scan_long_ms"] = long["fused"][0]
    out["scan_streams_long_ms"] = long["streams"][0]
    del hymba["scan_caps"], hymba["scan_long"], args, fargs, sargs, largs, \
        lf, ls
    return out



def scan_bwd_kernel(torch, hymba, report, close) -> None:
    """Phase 3 for B10's backward: the two launches phase 13's Hymba step
    handed it first (the last layer's chunk 1, h0 given and gh None, and
    chunk 0, h0 None and gh carried back from chunk 1; bf16 dt, x, B and
    C as the model hands them) through the launcher against
    ``mamba_scan_fused_bwd_ref`` on the same values in f32, every
    gradient within 1e-4 of its max|plain|, and against a second launch
    bitwise; each timed from a CUDA graph beside its formula's bound and
    beside the forward fused entry on the same inputs; its scratch
    beside that of a design that stores every state and lambda (two
    (B, T, DI, N) f32 arrays and 16 slices of partials); the entry reports chunk 1's, and a step's sum (each kind x
    the layers)."""
    from repro_torch.kernels.mamba_scan.kernel import (
        mamba_scan_fused_bwd_cuda, mamba_scan_fused_bwd_scratch,
        mamba_scan_fused_cuda)
    from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused_bwd_work
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_bwd_ref

    f32 = lambda t: None if t is None else t.float().contiguous()
    names = ("dt", "x", "A", "B", "C", "h0")
    rows = []
    for args, _ in hymba["bwd_caps"]:
        dt, x, a, bm, cm, h0, gy, gh = args
        kargs = (dt, x, f32(a), bm, cm, f32(h0), f32(gy), f32(gh))
        got = mamba_scan_fused_bwd_cuda(*kargs)
        again = mamba_scan_fused_bwd_cuda(*kargs)
        check(all(u is None or torch.equal(u, v) for u, v in
                  zip(got, again)),
              "mamba_scan_fused_bwd: two launches differ")
        want = mamba_scan_fused_bwd_ref(dt.float(), x.float(), a, bm.float(),
                                        cm.float(), h0, gy, gh)
        errs = {n: close(g, w, f"mamba_scan_fused_bwd d{n}")
                for n, g, w in zip(names, got, want) if w is not None}
        check(all((g is None) == (w is None) for g, w in zip(got, want)),
              "mamba_scan_fused_bwd: dh0 given where h0 is None or missing")
        b, t, di = dt.shape
        n = a.shape[-1]
        fwd = kargs[:6]
        rows.append(dict(
            err=max(errs.values()), errs=errs,
            ms=graph_ms(torch, lambda: mamba_scan_fused_bwd_cuda(*kargs),
                        10),
            fwd_ms=graph_ms(torch, lambda: mamba_scan_fused_cuda(*fwd), 10),
            plain_ms=cuda_ms(torch, lambda: mamba_scan_fused_bwd_ref(
                dt, x, a, bm, cm, h0, gy, gh), 1),
            bound=bound_ms(*mamba_scan_fused_bwd_work(*args)),
            scratch=mamba_scan_fused_bwd_scratch(b, t, di, n) * 4,
            scratch_pr29=(2 * b * t * di * n + b * di * n
                          + 2 * 16 * b * t * n) * 4,
            what=f"dt/x {tuple(dt.shape)} {dt.dtype}, B/C "
                 f"{tuple(bm.shape)}, h0 {'None' if h0 is None else 'given'}"
                 f", gh {'None' if gh is None else 'given'}"))
        del got, again, want
    layers = hymba["per_step"]["mamba_scan_fused_bwd"] // 2
    step_ms = layers * sum(r["ms"] for r in rows)
    first, second = rows
    for r in rows:
        print(f"[3] mamba_scan_fused_bwd at {r['what']}: max|d| by "
              f"gradient {({n: f'{e:.2e}' for n, e in r['errs'].items()})}, "
              f"two launches bitwise, {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}); the forward fused entry on the same "
              f"inputs {r['fwd_ms']:.4f} ms, backward / forward "
              f"{r['ms'] / r['fwd_ms']:.2f}; scratch "
              f"{r['scratch'] / 1e9:.4f} GB (storing every state and lambda: "
              f"{r['scratch_pr29'] / 1e9:.4f} GB)", flush=True)
    report("mamba_scan_fused_bwd", max(first["err"], second["err"]),
           first["ms"], first["plain_ms"], None, first["bound"],
           f" at {first['what']} (phase 13's Hymba-1.5B step, the last "
           f"layer's second chunk); the first chunk's {second['ms']:.4f} ms"
           f" (bound {second['bound'][0]:.4f} ms); "
           f"{hymba['per_step']['mamba_scan_fused_bwd']} launches a step, "
           f"{step_ms:.3f} ms a step; the forward fused entry "
           f"{first['fwd_ms']:.4f} ms on the same inputs",
           chunk0_ms=second["ms"], chunk0_bound_ms=second["bound"][0],
           per_step_launches=hymba["per_step"]["mamba_scan_fused_bwd"],
           per_step_ms=step_ms, fwd_ms=first["fwd_ms"],
           chunk0_fwd_ms=second["fwd_ms"], scratch_bytes=first["scratch"])


# ---------------------------------------------------------------------------
# Phase 9: the attention decoder stack (GQA with QKV biases, Gemma-2's
# softcaps and windows, MLA, the sort-dispatched MoE) through the same
# serve driver.  No B1-B10 kernel is on this path: the MNF fire inside
# these blocks is engine.sparsify, plain torch, as in the JAX package.
# ---------------------------------------------------------------------------

#: Served at full width (batch 4, prompt 32, 16 greedy tokens).
STACK_FULL = ("deepseek-v2-lite-16b", "gemma2-27b")
#: Served at their published widths with num_layers cut to 2 (a prefill
#: and STACK_CUT_GEN decode steps), so that every config's widths,
#: biases and activation run on the card.
STACK_CUT = ("qwen2-0.5b", "qwen2-1.5b", "minitron-8b", "deepseek-moe-16b")
STACK_CUT_GEN = 4
#: Each decode step's logits against the uncached forward: the CPU bf16
#: test's tolerance (tests/test_torch_lm_stack.py), of max|logit|.
STACK_TOL = 3e-2
#: The same in f32 for MLA (whose absorbed decode and expanded forward
#: round differently in bf16): the CPU f32 tests' tolerance.
STACK_TOL_F32 = 1e-4


def stack_describe(cfg) -> str:
    out = describe(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        out += (f", MLA (kv_lora {m.kv_lora_rank}, rope {m.qk_rope_dim}, "
                f"nope {m.qk_nope_dim}, v {m.v_head_dim})")
    if cfg.moe is not None:
        m = cfg.moe
        out += (f", MoE {m.num_experts} routed top-{m.top_k} + "
                f"{m.num_shared} shared of {m.expert_ff}, "
                f"{m.first_dense_layers} dense layer of {m.dense_ff}")
    if cfg.final_logit_softcap:
        out += (f", softcaps {cfg.attn_logit_softcap}/"
                f"{cfg.final_logit_softcap}, windows "
                f"{cfg.sliding_window}/global alternating, post-block "
                f"norms")
    if cfg.qkv_bias:
        out += ", QKV biases"
    if cfg.encoder_decoder:
        out += (f", an encoder of {cfg.enc_layers} layers over "
                f"{cfg.enc_frames} audio frames, cross-attention in each "
                f"decoder layer")
    if cfg.vision_tokens:
        out += f", {cfg.vision_tokens} vision tokens"
    return out + (", tied embeddings" if cfg.tie_embeddings else "")


def stack_weights(torch, cfg, device):
    """The served weights, built one layer at a time on the card
    (``init_compute_params``: drawn in f32 from seed 0, the leaves the
    blocks cast cast to bf16, the f32 freed): with QKV biases, those set
    to seeded normal values (the init makes them zeros, which would
    leave the bias adds unexercised).  Returns (params, GiB)."""
    from repro_torch.models import transformer as tfm
    params = tfm.init_compute_params(0, cfg, device)
    if cfg.qkv_bias:
        gen = torch.Generator(device=device).manual_seed(1)
        mix = params["layers"]["mix"]
        for name in ("bq", "bk", "bv"):
            mix[name].copy_(0.5 * torch.randn(
                mix[name].shape, generator=gen, device=device))
    torch.cuda.synchronize()
    leaves, stack = [], [params]
    while stack:
        for v in stack.pop().values():
            (stack if isinstance(v, dict) else leaves).append(v)
    return params, sum(t.numel() * t.element_size() for t in leaves) / 2**30


def record_moe():
    """Keep each ``moe.moe_apply`` call's input, router and aux (the calls
    a run makes eagerly; a graph's replays make none).  Returns (records,
    undo)."""
    from repro_torch.models import moe
    orig, rec = moe.moe_apply, []

    def spy(p, x, cfg, **kw):
        y, aux = orig(p, x, cfg, **kw)
        rec.append((x, p["router"], aux))
        return y, aux
    moe.moe_apply = spy
    return rec, lambda: setattr(moe, "moe_apply", orig)


def record_encoder():
    """Count ``transformer._encode_audio``'s calls (the eager ones; a
    graph's replays make none).  Returns (calls, undo)."""
    from repro_torch.models import transformer as tfm
    orig, rec = tfm._encode_audio, []

    def spy(*args, **kw):
        rec.append(1)
        return orig(*args, **kw)
    tfm._encode_audio = spy
    return rec, lambda: setattr(tfm, "_encode_audio", orig)


def same_run(torch, a, b) -> bool:
    """Tokens, inputs, the prefill's and every step's logits and every
    cache leaf bitwise equal."""
    from repro_torch.models.param_utils import tree_leaves
    la, lb = tree_leaves(a["cache"]), tree_leaves(b["cache"])
    return all(torch.equal(a[k], b[k]) for k in (
        "tokens", "inputs", "prefill_logits", "logits")) \
        and len(la) == len(lb) and all(torch.equal(x, y)
                                       for x, y in zip(la, lb))


def serve_stack(torch, engine, wrappers, arch, device="cuda", *,
                tag="[9]", prompt=LM_PROMPT, card="") -> dict:
    """Phase 9 (or 10) at full width: ``arch``'s weights from seed 0 (bf16
    where the blocks cast, ~31 GB for DeepSeek-V2-Lite, ~54 GB for
    Gemma-2-27B), batch 4, ``prompt`` tokens (with whisper's audio frames
    or phi-3-vision's patch embeddings, ``serve.make_lm_inputs``), 16
    greedy tokens through ``run_lm``, every count set to 0 before each
    serve and read after (no B1-B10 kernel on this path).  Checks: MNF on at θ = 0 bitwise ungated (tokens, logits); the
    graphed serve bitwise the eager one (tokens, every step's logits, the
    final cache), gated and ungated; each decode step's logits within
    STACK_TOL of max|logit| of an uncached forward over the prompt and
    the tokens so far — for MLA (the absorbed decode against the expanded
    form) in f32 within STACK_TOL_F32, and in bf16 no further from that
    f32 forward than the bf16 forward is; for an MoE no assignment
    dropped in any decode step and the expert loads summing to tokens x
    top_k; for whisper and phi-3-vision ``encdec_vlm_checks``.  Prints
    parameters, weight GiB, peak memory, prefill ms and tokens/s eager and
    graphed (best of 2 warm runs in turns), capture s, a graphed step's
    profile."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models.param_utils import tree_leaves
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    cfg = get_config(arch)
    check(cfg.mnf.enabled and cfg.mnf.threshold == 0.0
          and cfg.compute_dtype == "bfloat16", f"unexpected config {cfg}")
    off = dataclasses.replace(cfg, mnf=dataclasses.replace(cfg.mnf,
                                                           enabled=False))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, gib = stack_weights(torch, cfg, device)
    n_params, n_active = tfm.count_params(cfg), tfm.active_params(cfg)
    print(f"{tag} {cfg.name}: {stack_describe(cfg)}: {n_params / 1e9:.3f} "
          f"G params, {n_active / 1e9:.3f} G active a token; weights "
          f"{gib:.2f} GiB on the card (bf16 but the norms"
          f"{' and routers' if cfg.moe else ''}), built layer by layer from "
          f"seed 0 in {time.perf_counter() - t0:.2f} s"
          + (f"; card {card}" if card else ""), flush=True)
    prompts = serve.make_prompts(cfg, LM_BATCH, prompt, 0, device)
    extra = serve.make_lm_inputs(cfg, LM_BATCH, 0, device)
    zero = {n: 0 for n in wrappers}

    def served(stag, c, graph):
        run, recs, launches, _, _ = drive_counted(
            torch, engine, wrappers, lambda: serve.run_lm(
                params, c, prompts, LM_GEN, keep_logits=True, graph=graph,
                **extra), capture=False)
        check(launches == zero, f"{stag}: B1-B10 launched {launches}")
        check(not any(r.get("op") == "recurrent_step" for r in recs),
              f"{stag} ran a recurrent_step")
        check(run["tokens"].shape == (LM_BATCH, LM_GEN)
              and run["logits"].shape == (LM_GEN, LM_BATCH, cfg.vocab_size)
              and bool(torch.isfinite(run["logits"]).all())
              and run["events"] is None,
              f"{stag}: tokens or logits not of the expected shape, or "
              f"not finite")
        return run

    # the main path, eager: MNF on at θ = 0, bf16 (an MoE's calls and the
    # encoder's runs kept)
    moe_rec, undo = record_moe()
    enc_rec, undo_enc = record_encoder()
    try:
        run_a = served(f"{tag} {arch} eager gated θ=0", cfg, False)
    finally:
        undo()
        undo_enc()
    if cfg.encoder_decoder:
        check(len(enc_rec) == 1, f"{tag} {arch}: the encoder ran "
              f"{len(enc_rec)} times in a prefill and {LM_GEN} decode "
              f"steps, want once (in the prefill)")
        print(f"{tag} {arch}: the encoder ran once in the eager serve (its "
              f"prefill) and 0 times in its {LM_GEN} decode steps", flush=True)
    run_b = served(f"{tag} {arch} eager ungated", off, False)
    check(all(torch.equal(run_a[k], run_b[k]) for k in (
        "tokens", "prefill_logits", "logits")),
          f"{tag} {arch}: θ = 0 not bitwise the ungated serve")
    if cfg.moe is not None:
        n_moe = cfg.num_layers - cfg.moe.first_dense_layers
        steps_ = [(x, r, a) for x, r, a in moe_rec if x.shape[1] == 1]
        check(len(steps_) == n_moe * LM_GEN, f"{tag} {arch}: "
              f"{len(steps_)} MoE calls in the decode steps, want "
              f"{n_moe * LM_GEN}")
        drops = torch.stack([a["drop_fraction"] for _, _, a in steps_])
        loads = torch.stack([torch.zeros(cfg.moe.num_experts,
                                         device=device).scatter_add_(
            0, moe.route(r, x, cfg)[2].reshape(-1),
            torch.ones(x.shape[0] * cfg.moe.top_k, device=device))
            for x, r, _ in steps_])
        check(bool((drops == 0).all()), f"{tag} {arch}: a decode step "
              f"dropped assignments: {drops.max().item()}")
        check(bool((loads.sum(1) == LM_BATCH * cfg.moe.top_k).all()),
              f"{tag} {arch}: expert loads do not sum to tokens x top_k")
        pre = [a["drop_fraction"] for x, _, a in moe_rec if x.shape[1] > 1]
        print(f"{tag} {arch} MoE: {len(steps_)} decode-step calls, "
              f"drop_fraction 0 in each, expert loads summing to "
              f"{LM_BATCH} x {cfg.moe.top_k} in each (busiest expert "
              f"{int(loads.max())} of {LM_BATCH} tokens); prefill "
              f"drop_fraction max {float(torch.stack(pre).max()):.4f} over "
              f"{len(pre)} calls", flush=True)
        del moe_rec, steps_, loads

    # the main path on CUDA graphs, gated and ungated, each bitwise its
    # eager serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run_g = served(f"{tag} {arch} graphed gated θ=0", cfg, True)
    pool_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(not run_g["launches"], f"{tag}: the graphs captured "
          f"{run_g['launches']}")
    check(same_run(torch, run_g, run_a), f"{tag} {arch}: the graphed serve "
          f"is not bitwise the eager serve")
    run_gb = served(f"{tag} {arch} graphed ungated", off, True)
    check(same_run(torch, run_gb, run_b), f"{tag} {arch}: the graphed "
          f"ungated serve is not bitwise the eager one")
    print(f"{tag} {arch}: B1-B10 launched 0 times in every serve (none is "
          f"on this path); θ=0 bitwise ungated (tokens, prefill and step "
          f"logits); graphed bitwise eager, gated and ungated (tokens, "
          f"every step's logits, all {len(tree_leaves(run_g['cache']))} "
          f"cache leaves), no host sync in the decode loop; warm-up and "
          f"capture {run_g['capture_s']:.3f} s; the graphed serve's peak "
          f"{pool_gib:.3f} GiB above the weights", flush=True)
    del run_b, run_gb

    # each decode step against one uncached forward over the prompt and
    # the tokens so far, at the same position (MLA: the absorbed decode
    # against the expanded form)
    inputs, steps_bf16 = run_a["inputs"], run_a["logits"]
    want_bf16 = uncached_logits(torch, params, cfg, prompts, inputs, extra)
    ratios = [rel_gap(a, b) for a, b in zip(steps_bf16, want_bf16)]
    print(f"{tag} {arch}, bf16: each decode step's logits against an "
          f"uncached forward over the prompt and the tokens so far (no "
          f"capacity drop there): max|d| / max|logit| worst "
          f"{max(ratios):.3e} (steps {[f'{x:.1e}' for x in ratios]})",
          flush=True)
    if cfg.mla is None:
        check(max(ratios) <= STACK_TOL, f"{tag} {arch}: decode vs uncached "
              f"forward {max(ratios):.3e} (limit {STACK_TOL})")
    extra_out = {}
    if cfg.encoder_decoder or cfg.vision_tokens:
        extra_out = encdec_vlm_checks(torch, params, cfg, prompts, extra,
                                      run_a, tag, card)
    del run_a, run_g

    # warm timings: eager and graphed in turns, 2 runs each
    gc.collect()
    torch.cuda.empty_cache()
    times = {(n, g): [] for n in ("gated θ=0", "ungated")
             for g in (False, True)}
    for _ in range(2):
        for n, c in (("gated θ=0", cfg), ("ungated", off)):
            for g in (False, True):
                run = serve.run_lm(params, c, prompts, LM_GEN, graph=g,
                                   **extra)
                times[(n, g)].append((run["prefill_s"] * 1e3,
                                      LM_GEN * LM_BATCH / run["decode_s"],
                                      run["capture_s"]))
                del run
    best = {key: (min(t[0] for t in ts), max(t[1] for t in ts))
            for key, ts in times.items()}
    for (n, g), ts in times.items():
        print(f"{tag} {arch} warm, bf16, batch {LM_BATCH}, prompt "
              f"{prompt}, {LM_GEN} tokens, {n}, "
              f"{'graphed' if g else 'eager'}: prefill {best[(n, g)][0]:.3f}"
              f" ms (best of {[round(t[0], 3) for t in ts]}), decode "
              f"{best[(n, g)][1]:.1f} tokens/s (best of "
              f"{[round(t[1], 1) for t in ts]})"
              + (f", warm-up and capture s {[round(t[2], 3) for t in ts]}"
                 if g else ""), flush=True)

    # a graphed decode step's profile (position reset before each replay)
    srv = lm_steps.make_serve_step(
        cfg, ShapeConfig("serve", prompt + LM_GEN, LM_BATCH, "decode"))
    g = srv.fn.capture(params, torch.device(device))
    pos = srv.fn.position
    prof = profile(torch, lambda: (pos.fill_(prompt), g.replay()),
                   f"{tag} {arch} graphed decode step", top=6)
    del srv, g, pos
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} {arch}: peak memory {peak:.2f} GiB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
          f" GiB", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(params=n_params, active=n_active, gib=gib, peak=peak,
               pool_gib=pool_gib, uncached=max(ratios), best=best,
               step_busy_ms=prof["busy_ms"], step_idle=prof["idle"],
               **extra_out)
    if cfg.mla is not None:
        # MLA's absorbed decode and expanded forward round differently in
        # bf16 (ROADMAP C.m3).  In f32 (all leaves f32, ~59 GiB), teacher-
        # forced on the bf16 run's inputs: the absorbed decode against the
        # expanded uncached forward within 1e-4, as the CPU f32 tests hold
        # the algorithm.  In bf16 both forms lie ~3e-2 from the f32 model
        # at this depth, so a step's bf16 decode and uncached forward lie
        # up to their sum apart: the bf16 decode's worst step must lie no
        # further from the f32 forward than 3e-2 or than the bf16
        # uncached forward's worst step — the cached path no less
        # accurate than the uncached one.
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        p32, gib32 = stack_weights(torch, cfg32, device)
        run32 = serve.run_lm(p32, cfg32, prompts, LM_GEN, teacher=inputs,
                             keep_logits=True, graph=False)
        want32 = uncached_logits(torch, p32, cfg32, prompts, inputs)
        r32 = [rel_gap(a, b) for a, b in zip(run32["logits"], want32)]
        noise = [rel_gap(a, b) for a, b in zip(want_bf16, want32)]
        err = [rel_gap(a, b) for a, b in zip(steps_bf16, want32)]
        limit = max(STACK_TOL, max(noise))
        print(f"{tag} {arch}, f32 ({gib32:.2f} GiB of weights), on the bf16 "
              f"run's inputs: each absorbed decode step's logits against the "
              f"expanded uncached forward: max|d| / max|logit| worst "
              f"{max(r32):.3e} (limit {STACK_TOL_F32}; steps "
              f"{[f'{x:.1e}' for x in r32]}); from that f32 forward, the "
              f"bf16 decode lies {[f'{x:.1e}' for x in err]} and the bf16 "
              f"uncached forward {[f'{x:.1e}' for x in noise]}: worst "
              f"{max(err):.3e} and {max(noise):.3e} (the decode's limit "
              f"{limit:.3e})", flush=True)
        check(max(r32) <= STACK_TOL_F32, f"{tag} {arch} f32: decode vs "
              f"uncached forward {max(r32):.3e}")
        check(max(err) <= limit, f"{tag} {arch} bf16: the decode lies "
              f"{max(err):.3e} from the f32 forward, beyond {limit:.3e}")
        out.update(uncached_f32=max(r32), bf16_noise=max(noise),
                   bf16_err=max(err))
        del p32, run32, want32
        gc.collect()
        torch.cuda.empty_cache()
    return out


def encdec_vlm_checks(torch, params, cfg, prompts, extra, run_a, tag,
                      card) -> dict:
    """Phase 10's checks beyond phase 9's.  Whisper: an eager prefill's
    cross K/V, and those the eager serve ended with, bitwise ``_cross_kv``
    of a separate ``_encode_audio`` run on the same frames; the encoder
    and cross K/V timed warm (CUDA events).  Phi-3-vision: a second
    vision input changes the prefill's logits and leaves the embeddings
    past the vision tokens bitwise unchanged."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm

    out = {}
    if cfg.encoder_decoder:
        frames = extra["audio_frames"]

        def encode():
            return tfm._cross_kv(params, tfm._encode_audio(params, frames,
                                                           cfg), cfg)
        want_k, want_v = encode()
        _, cache = tfm.prefill(params, prompts, cfg,
                               max_len=prompts.shape[1] + LM_GEN,
                               audio_frames=frames)
        for name, c in (("an eager prefill", cache["scan"]),
                        ("the serve's final cache", run_a["cache"]["scan"])):
            check(torch.equal(c["cross_k"], want_k)
                  and torch.equal(c["cross_v"], want_v),
                  f"{tag} {cfg.name}: the cross K/V of {name} are not "
                  f"bitwise _cross_kv of a separate encoder run")
        enc_ms = cuda_ms(torch, encode, iters=5)
        print(f"{tag} {cfg.name}: the cross K/V ({tuple(want_k.shape)}, "
              f"{want_k.dtype}) of an eager prefill and of the serve's final "
              f"cache bitwise _cross_kv of a separate _encode_audio run; "
              f"encoder ({cfg.enc_layers} layers over {cfg.enc_frames} "
              f"frames, batch {LM_BATCH}) and cross K/V, warm, eager: "
              f"{enc_ms:.3f} ms a prefill (mean of 5, CUDA events; card "
              f"{card})", flush=True)
        out["encoder_ms"] = enc_ms
        del cache
    if cfg.vision_tokens:
        nv = cfg.vision_tokens
        v1 = extra["vision_embeds"]
        v2 = serve.make_lm_inputs(cfg, LM_BATCH, 1, prompts.device)[
            "vision_embeds"]
        e1 = tfm._embed(params, prompts, cfg, v1)
        e2 = tfm._embed(params, prompts, cfg, v2)
        check(torch.equal(e1[:, :nv], v1) and torch.equal(e2[:, :nv], v2)
              and torch.equal(e1[:, nv:], e2[:, nv:]),
              f"{tag} {cfg.name}: the patch embeddings do not fill exactly "
              f"the first {nv} positions")
        l1, _ = tfm.prefill(params, prompts, cfg, vision_embeds=v1)
        l2, _ = tfm.prefill(params, prompts, cfg, vision_embeds=v2)
        gap = rel_gap(l2, l1)
        check(gap > 0, f"{tag} {cfg.name}: a second vision input left the "
              f"prefill's logits unchanged")
        print(f"{tag} {cfg.name}: a second vision input moves the prefill's "
              f"logits by {gap:.3e} of max|logit| and leaves the "
              f"{prompts.shape[1] - nv} embeddings past position {nv} "
              f"bitwise unchanged", flush=True)
        out["vision_gap"] = gap
    return out


def rel_gap(a, b) -> float:
    """max|a - b| / max|b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def uncached_logits(torch, params, cfg, prompts, inputs, extra=None) -> list:
    """For each column i of ``inputs`` (B, G), the last-position logits
    (B, V) of one uncached forward over ``prompts`` and ``inputs[:, :i +
    1]`` (with the serve's audio frames or patch embeddings ``extra``):
    what a decode step fed inputs[:, i] computes.  An MoE's capacity
    binds in such a forward (a dispatch group of tens of tokens, 8 slots
    an expert) and never in a decode step (one token a group), and a
    dropped assignment is a different function, not a rounding: the
    forward runs at a capacity factor of the expert count, where an
    expert has a slot for every assignment of its group (the reduced
    configs raise theirs for the same consistency), and must drop
    nothing (ROADMAP C.m2)."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    seq = torch.cat([prompts, inputs], 1)
    out = []
    rec, undo = record_moe()
    try:
        for i in range(inputs.shape[1]):
            h, _ = tfm.forward(params, seq[:, :prompts.shape[1] + i + 1],
                               cfg, **(extra or {}))
            out.append(tfm.unembed_logits(params, h[:, -1:], cfg)[:, 0])
            del h
    finally:
        undo()
    check(all(float(a["drop_fraction"]) == 0.0 for _, _, a in rec),
          "the uncached forward dropped MoE assignments")
    return out


def serve_stack_cut(torch, engine, wrappers, arch, device="cuda") -> dict:
    """Phase 9 for a config at its published widths with num_layers cut
    to 2: a prefill and STACK_CUT_GEN decode steps, eager and graphed,
    bitwise; no B1-B10 kernel launched."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    params, gib = stack_weights(torch, cfg, device)
    prompts = serve.make_prompts(cfg, LM_BATCH, LM_PROMPT, 0, device)
    runs = []
    for graph in (False, True):
        run, _, launches, _, secs = drive_counted(
            torch, engine, wrappers, lambda: serve.run_lm(
                params, cfg, prompts, STACK_CUT_GEN, keep_logits=True,
                graph=graph), capture=False)
        check(not any(launches.values()), f"[9] {arch}: B1-B10 launched "
              f"{launches}")
        check(bool(torch.isfinite(run["logits"]).all()),
              f"[9] {arch}: logits not finite")
        runs.append(run)
    check(same_run(torch, runs[1], runs[0]), f"[9] {arch} (2 layers): the "
          f"graphed serve is not bitwise the eager one")
    print(f"[9] {arch} at its published widths, 2 layers "
          f"({stack_describe(cfg)}; {gib:.2f} GiB): a prefill and "
          f"{STACK_CUT_GEN} decode steps, graphed bitwise eager, B1-B10 "
          f"launched 0 times; eager {runs[0]['decode_s'] * 1e3:.1f} ms, "
          f"graphed {runs[1]['decode_s'] * 1e3:.1f} ms for the "
          f"{STACK_CUT_GEN} steps", flush=True)
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(gib=gib)


def stack_phase(torch, engine, wrappers, device="cuda") -> dict:
    """Phase 9: DeepSeek-V2-Lite-16B and Gemma-2-27B at full width, then
    the other four configs of the stack at 2 layers."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[9] before the phase: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated on the card", flush=True)
    out = {arch: serve_stack(torch, engine, wrappers, arch, device)
           for arch in STACK_FULL}
    for arch in STACK_CUT:
        out[arch] = serve_stack_cut(torch, engine, wrappers, arch, device)
    out["seconds"] = time.perf_counter() - t0
    print(f"[9] phase 9 took {out['seconds']:.1f} s", flush=True)
    return out


#: Phase 10: each model with its prompt length — whisper-base's decoder
#: prompt beside its 1500 audio frames; phi-3-vision's 144 patch positions
#: and 16 text tokens.
ENCDEC = (("whisper-base", 32), ("phi-3-vision-4.2b", 160))


def encdec_phase(torch, engine, wrappers, card, device="cuda") -> dict:
    """Phase 10: whisper-base and phi-3-vision-4.2b at full width, served
    and checked as phase 9's models, with ``encdec_vlm_checks``."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[10] before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated on "
          f"the card", flush=True)
    out = {arch: serve_stack(torch, engine, wrappers, arch, device,
                             tag="[10]", prompt=prompt, card=card)
           for arch, prompt in ENCDEC}
    out["seconds"] = time.perf_counter() - t0
    print(f"[10] phase 10 took {out['seconds']:.1f} s", flush=True)
    return out


#: The scalar oracle's tolerance against torch.matmul / F.conv2d in f32,
#: of max|ref|.
SCALAR_TOL = 1e-4


def scalar_phase(torch, engine, wrappers, card, device="cuda") -> dict:
    """Phase 11: the ``scalar`` backend (the paper's Algorithms 2 and 1,
    plain torch ops) on the card: ``engine.linear`` on LeNet-300-100's FC1
    at batch 2 and ``engine.conv2d`` on the MINI CNN's first layer at
    batch 1, strides 1 and 2, paddings 0 and 1, each against torch.matmul
    / F.conv2d in f32 within SCALAR_TOL of max|ref|; no B1-B10 launch."""
    import torch.nn.functional as F

    from repro_torch.models import cnn, mlp

    gen = torch.Generator(device=device).manual_seed(0)
    cfg = engine.EngineConfig(backend="scalar")
    check(cfg.resolve_backend(torch.device(device)) == "scalar",
          "[11] backend 'scalar' does not resolve on the card")
    w_fc = mlp.init_mlp_params(mlp.LENET_300_100, gen)[0]
    x_fc = torch.relu(torch.randn((2, w_fc.shape[0]), generator=gen,
                                  device=device))
    w_cv = cnn.init_cnn_params(cnn.MINI, gen)[0]
    x_cv = torch.relu(torch.randn((1, cnn.MINI.input_size,
                                   cnn.MINI.input_size, w_cv.shape[2]),
                                  generator=gen, device=device))
    cases = [(f"linear, LeNet-300-100 FC1 {tuple(x_fc.shape)} x "
              f"{tuple(w_fc.shape)}",
              lambda: engine.linear(x_fc, w_fc, cfg=cfg),
              lambda: torch.matmul(x_fc, w_fc))]
    for s in (1, 2):
        for p in (0, 1):
            cases.append((
                f"conv2d, MINI conv1 {tuple(x_cv.shape)} * "
                f"{tuple(w_cv.shape)} stride {s} padding {p}",
                lambda s=s, p=p: engine.conv2d(x_cv, w_cv, cfg=cfg, stride=s,
                                               padding=p),
                lambda s=s, p=p: F.conv2d(
                    x_cv.permute(0, 3, 1, 2), w_cv.permute(3, 2, 0, 1),
                    stride=s, padding=p).permute(0, 2, 3, 1)))
    out = {}
    for what, fn, ref_fn in cases:
        y, recs, launches, _, _ = drive_counted(torch, engine, wrappers, fn,
                                                capture=False)
        ref = ref_fn()
        check(not any(launches.values()),
              f"[11] scalar {what}: B1-B10 launched {launches}")
        check(y.shape == ref.shape and bool(torch.isfinite(y).all()),
              f"[11] scalar {what}: shape {tuple(y.shape)}, want "
              f"{tuple(ref.shape)}, or not finite")
        err = rel_gap(y, ref)
        check(err <= SCALAR_TOL, f"[11] scalar {what}: max|d| / max|ref| "
              f"{err:.3e} (limit {SCALAR_TOL})")
        ms, ref_ms = cuda_ms(torch, fn, 5), cuda_ms(torch, ref_fn, 5)
        print(f"[11] scalar {what}: max|d| / max|ref| {err:.3e} against the "
              f"f32 library call (limit {SCALAR_TOL}); B1-B10 launched 0 "
              f"times; {ms:.3f} ms eager against the library's {ref_ms:.3f} "
              f"ms (mean of 5, CUDA events; card {card})", flush=True)
        out[what] = dict(err=err, ms=ms, ref_ms=ref_ms)
    return out


# ---------------------------------------------------------------------------
# Phase 12: AlexNet@224, the paper's other network, served through the JAX
# example's buckets (examples/torch_serve_cnn_events.py), its measured
# events priced on the paper's ASIC model, and served again under adaptive
# routing with BENCH_engine.json's crossover table installed.
# ---------------------------------------------------------------------------

def adaptive_route(xover, table, rec, flavor) -> tuple:
    """(route, source) that an adaptive trace record ``rec`` must carry,
    read from its own fields: the cheaper side by ``table``'s ratio at the
    record's occupancy, backend, shape class and event ``flavor`` (the
    route auto takes there) where the table covers it, else by the
    record's cost estimates; dense where auto has no event route."""
    if flavor not in xover.EVENT_ROUTES:
        return "dense", "geometry"
    t_ratio = table.ratio(BOUNDARY[rec["op"]], rec["occupancy"],
                          backend=rec["backend"],
                          shape_class=rec["shape_class"], flavor=flavor)
    if t_ratio is not None:
        return ("dense" if t_ratio > 1.0 else flavor), "table"
    ratio = rec["est_event_cost"] / max(rec["est_dense_cost"], 1e-12)
    return ("dense" if ratio > 1.0 else flavor), "model"


def dense_preacts(torch, F, cnn, params, x, spec) -> list:
    """Each compute layer's pre-activation on the dense path (f32, the
    device of ``x``): what a fire thresholds."""
    out = []
    for layer, w in zip(spec.layers, params):
        if isinstance(layer, cnn.ConvSpec):
            x = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                         stride=layer.stride,
                         padding=layer.padding).permute(0, 2, 3, 1)
        elif isinstance(layer, cnn.PoolSpec):
            x = F.max_pool2d(x.permute(0, 3, 1, 2), layer.k,
                             layer.stride).permute(0, 2, 3, 1)
            continue
        else:
            x = x.reshape(x.shape[0], -1) @ w
        out.append(x)
        x = torch.relu(x)
    return out


def alexnet_phase(torch, engine, wrappers, drive, card) -> dict:
    """Phase 12: stock AlexNet at 224 (conv1 k11 s4 p2; pools k3 s2; FC
    9216 -> 4096 -> 4096 -> 1000) served through
    ``examples/torch_serve_cnn_events.serve_cnn_events``: buckets (1, 4,
    8), weight sparsity 0.5, requests ``data.cnn_batch`` frames at
    activation sparsity 0.6 arriving ``ALEX_ARRIVALS`` a tick, counts set
    to 0 just before and read just after.  Checks: 3 captures, flat; each
    bucket's capture saw ``PLAN_F32_ALEX``; every boundary report's routes
    ``chain_boundary_summary``'s, no fallback_decode or densify point;
    every request served FIFO in its tick, within 5e-3 and
    1e-4·max|dense| of the dense oracle and bitwise its bucket-1 replay;
    the eager forward of the full bucket of 8 bitwise its served rows, its
    launches the plan's and each layer's those of ``check_layer_plans``;
    one launch of each distinct B1, B2 and B4b shape of that forward kept
    (on the host, ``kept``) for phase 3.  ``run_with_stats`` on the
    first frame on the card: its shape fields ``analytic_network_stats``'s
    exactly, its counts the same function's on the CPU (any difference no
    larger than the values within 1e-6 of the threshold); the paper's
    ASIC priced on them and on the paper's profile.  Then two adaptive
    serves (occupancy hints ``ALEX_OCCUPANCY``) with BENCH_engine.json's
    table installed: every routed record's route the cheaper side of its
    own fields (the table's ratio at its occupancy, backend, shape class
    and event flavour where the table covers it, else its recorded cost
    estimates), no ``route_conflicts``, rows within 5e-3 and
    1e-4·max|dense| of the oracle; the table cleared after.  Frees every
    engine before it returns."""
    import importlib.util

    import torch.nn.functional as F

    from repro_torch.costmodel import PAPER_TABLE4, network_cycles, table4_row
    from repro_torch.costmodel import crossover as xover
    from repro_torch.costmodel.table4 import (ALEXNET_DENSITY_PROFILE,
                                              ALEXNET_W_DENSITY,
                                              PAPER_RATIOS)
    from repro_torch.costmodel.workloads import analytic_network_stats
    from repro_torch.models import cnn

    t_phase = time.perf_counter()
    mod = importlib.util.spec_from_file_location(
        "torch_serve_cnn_events",
        ROOT / "examples" / "torch_serve_cnn_events.py")
    ex = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(ex)
    dev = torch.device("cuda")
    spec = cnn.ALEXNET
    params = cnn.init_cnn_params(
        spec, torch.Generator(device=dev).manual_seed(12),
        weight_sparsity=0.5)
    n_params = sum(p.numel() for p in params if p is not None)
    n_req = sum(ALEX_ARRIVALS)

    def serve(engine_cfg=None):
        return ex.serve_cnn_events(
            "alexnet", 224, buckets=ALEX_BUCKETS, weight_sparsity=0.5,
            act_sparsity=0.6, device=dev, params=params,
            arrivals=ALEX_ARRIVALS, engine_cfg=engine_cfg)

    print(f"[12] {spec.name}@224: {n_params} parameters "
          f"({n_params * 4 / 1e6:.1f} MB f32), buckets {ALEX_BUCKETS}, "
          f"{n_req} requests in ticks of {list(ALEX_ARRIVALS)}", flush=True)
    run, _, raw, _, serve_s = drive(serve, capture=False)
    eng = run["engine"]
    check(eng.recompiles == len(ALEX_BUCKETS), f"[12]: {eng.recompiles} "
          f"captures, not {len(ALEX_BUCKETS)}")
    missing = [n for n, want in PLAN_F32_ALEX.items() if want and not raw[n]]
    stray = [n for n, want in PLAN_F32_ALEX.items() if not want and raw[n]]
    check(not missing and not stray, f"[12]: kernels of the path never "
          f"launched {missing}, off it launched {stray}")
    per_bucket = {}
    for b in ALEX_BUCKETS:
        g = eng.plans[b].fn.graph
        got = {n: g.launches.get(w, 0) for n, w in wrappers.items()}
        check_plan(f"[12] bucket {b} capture", got, PLAN_F32_ALEX)
        check(got == PLAN_F32_ALEX, f"[12] bucket {b}: the capture saw "
              f"{got}, not the route plan {PLAN_F32_ALEX}")
        rep = eng.boundary_report(b)
        summary = cnn.chain_boundary_summary(spec, batch=b, device=dev)
        want = [(r["op"], r["route"], r["shape_class"])
                for r in summary["routes"]]
        check(rep["fallback_decodes"] == 0 and rep["boundaries"]["densify"]
              == 0 and [(r["op"], r["route"], r["shape_class"])
                        for r in rep["routes"]] == want,
              f"[12] bucket {b}: boundary report {rep}, routes want {want}")
        per_bucket[b] = dict(launches=got)
    done = eng.completed
    check([r.rid for r in done] == list(range(n_req))
          and all(r.completion_tick == r.arrival_tick for r in done),
          "[12]: not every request served FIFO in its own tick")
    oracle = run["oracle"]
    got_rows = torch.stack([r.result for r in done])
    d = float((got_rows - oracle).abs().max())
    ratio = d / max(float(oracle.abs().max()), 1e-30)
    check(bool(torch.allclose(got_rows, oracle, atol=5e-3, rtol=5e-3))
          and ratio <= 1e-4, f"[12]: served rows off the dense oracle by "
          f"{d:.3e} (ratio to max|dense| {ratio:.3e})")
    off = [r.rid for r in done
           if not bits_equal(torch, eng.forward(1, [r.image])[0], r.result)]
    check(not off, f"[12]: {len(off)} served rows not bitwise their bucket-1 "
          f"replay (first {off[:8]})")
    routes = sorted({(r["op"], r["route"]) for r in
                     eng.boundary_report(8)["routes"]})
    print(f"[12] served FIFO in {serve_s:.3f} s (warm-up, traffic, oracle and "
          f"run_with_stats); captures {eng.recompiles}, flat; each bucket's "
          f"capture saw the route plan; routes {routes} as "
          f"chain_boundary_summary says, densify 0, fallback_decode 0; "
          f"all {n_req} served rows within 5e-3 and 1e-4·max|dense| of the "
          f"dense oracle (max|d| {d:.3e}, ratio to max|dense| "
          f"{ratio:.3e}) and bitwise their bucket-1 replays", flush=True)

    # the full bucket of 8, eagerly: bitwise its served rows, its launches
    # the plan's layer by layer
    reqs = [r for r in done if r.bucket == 8][:8]
    x8 = torch.stack([r.image for r in reqs]).to(dev)
    with torch.inference_mode():
        y8, recs8, launches8, captured8, _ = drive(
            lambda: cnn.cnn_forward(eng.params, x8, spec))
    check(bits_equal(torch, y8.cpu(), torch.stack([r.result for r in reqs])),
          "[12]: the eager forward of a full bucket of 8 is not bitwise its "
          "served rows")
    check(launches8 == PLAN_F32_ALEX, f"[12] eager bucket 8: launches "
          f"{launches8}, plan {PLAN_F32_ALEX}")
    layers = check_layer_plans("[12] eager bucket 8", cnn, spec, 8, recs8,
                               captured8)
    kept = keep_by_shape(torch, captured8)
    del captured8
    print(f"[12] the eager forward of the full bucket of 8 is bitwise its "
          f"served rows; launches by layer as fused_conv_plan / pool_plan "
          f"say: {layers}; kept for phase 3 one launch of each shape: "
          + ", ".join(f"{n} x{len(k)}" for n, k in kept.items()), flush=True)

    # times: per bucket p50 / p99, warm-up, capture; the bucket-8 replay
    # beside the dense oracle's graph on the same 8 frames
    stats = run["stats"]
    g8 = eng.plans[8].fn.graph
    eng.plans[8].fn.graph.static[1].copy_(x8)
    replay_ms, _ = host_ms(torch, g8.replay, reps=5)
    dpipe = cnn.make_cnn_pipeline(spec, batch=8, mnf=False, device=dev)
    dpipe(eng.params, x8)
    dense_ms, _ = host_ms(torch, lambda: dpipe(eng.params, x8), reps=5)
    del dpipe
    for b in ALEX_BUCKETS:
        per_bucket[b].update(stats["per_bucket"][b], **eng.warmup_s[b])
        print(f"[12] bucket {b}: {per_bucket[b]['requests']} requests, p50 "
              f"{per_bucket[b]['p50_ms']:.3f} ms, p99 "
              f"{per_bucket[b]['p99_ms']:.3f} ms; warm-up "
              f"{eng.warmup_s[b]['warmup_s']:.3f} s, capture "
              f"{eng.warmup_s[b]['capture_s']:.3f} s; launches a forward "
              f"B1 {per_bucket[b]['launches']['fire_compact']}, B2 "
              f"{per_bucket[b]['launches']['event_matmul']}, B4b "
              f"{per_bucket[b]['launches']['event_pool']} (card {card})",
              flush=True)
    print(f"[12] served {stats['requests']} requests at "
          f"{stats['requests_s']} requests/s, p50 {stats['p50_ms']} ms, p99 "
          f"{stats['p99_ms']} ms; the bucket-8 replay {replay_ms:.3f} ms "
          f"against the dense oracle's graph on the same 8 frames "
          f"{dense_ms:.3f} ms (host clock, medians of 5; card {card})",
          flush=True)
    profile(torch, g8.replay, "[12] bucket 8 graphed")

    # run_with_stats on the first frame: shape fields analytic, counts the
    # CPU's; then the paper's ASIC priced on them
    st = run["layer_stats"]
    an = analytic_network_stats(spec, ALEXNET_DENSITY_PROFILE)
    shape_keys = ("kind", "dense_macs", "in_elems", "c_out")
    check(len(st) == len(an) and all(
        all(a[k] == m[k] for k in shape_keys) for a, m in zip(an, st)),
        f"[12]: run_with_stats' shape fields differ from "
        f"analytic_network_stats': {[{k: m[k] for k in shape_keys} for m in st]}")
    cpu_params = [None if p is None else p.cpu() for p in eng.params]
    _, st_cpu = cnn.run_with_stats(cpu_params, run["frames"][:1], spec,
                                   device="cpu")
    diff = [i for i, (m, c) in enumerate(zip(st, st_cpu))
            if (m["in_events"], m["event_macs"])
            != (c["in_events"], c["event_macs"])]
    if diff:
        pre = dense_preacts(torch, F, cnn, cpu_params, run["frames"][:1],
                            spec)
        ties = [0] + [int((p.abs() <= 1e-6).sum()) for p in pre]
        for i in diff:
            dev_ev = abs(st[i]["in_events"] - st_cpu[i]["in_events"])
            print(f"[12] layer {i}: in_events card {st[i]['in_events']} cpu "
                  f"{st_cpu[i]['in_events']}, event_macs card "
                  f"{st[i]['event_macs']} cpu {st_cpu[i]['event_macs']}; "
                  f"{ties[i]} values of the layer before within 1e-6 of "
                  f"the threshold", flush=True)
            check(dev_ev <= ties[i], f"[12] layer {i}: the event counts of "
                  f"card and CPU differ by {dev_ev}, more than the "
                  f"{ties[i]} ties")
    ev_macs = sum(m["event_macs"] for m in st)
    dn_macs = sum(m["dense_macs"] for m in st)
    print(f"[12] run_with_stats on the first frame on the card: kind, "
          f"dense_macs, in_elems, c_out analytic_network_stats' exactly; "
          f"in_events and event_macs the CPU's "
          f"{'exactly' if not diff else f'but at layers {diff} (ties)'}; "
          f"event/dense MACs {ev_macs:.0f}/{dn_macs:.0f} = "
          f"{ev_macs / dn_macs:.4f}", flush=True)
    priced = {}
    for what, stats_, wd in (("measured (weight density 0.5)", st, 0.5),
                             ("paper profile", an, ALEXNET_W_DENSITY)):
        row = table4_row(stats_, w_density=wd)
        mnf = network_cycles(stats_, "mnf", d_w=wd)
        cyc = {dsg: network_cycles(stats_, dsg, d_w=wd)
               for dsg in ("scnn_dense", "scnn", "sparten", "gospa")}
        priced[what] = dict(row=row, mnf_cycles=mnf, cycles=cyc)
        print(f"[12] the cost model of the paper's 200 MHz ASIC (Table 3; "
              f"model numbers, not times on the card), AlexNet@224, "
              f"{what}: {row['frames_s']:.1f} frames/s, "
              f"{row['power_mw']:.1f} mW, {row['frames_j']:.1f} frames/J "
              f"(paper {PAPER_TABLE4['alexnet']['frames_s']}, "
              f"{PAPER_TABLE4['alexnet']['power_mw']}, "
              f"{PAPER_TABLE4['alexnet']['frames_j']}); MNF {mnf:,.0f} "
              f"cycles/frame; baselines / MNF: "
              + ", ".join(f"{dsg} {c / mnf:.2f}x (paper "
                          f"{PAPER_RATIOS['alexnet'][dsg]}x)"
                          for dsg, c in cyc.items()), flush=True)
    warm = {b: eng.warmup_s[b] for b in ALEX_BUCKETS}
    del run, eng, done, reqs, g8, y8, x8, got_rows
    gc.collect()
    torch.cuda.empty_cache()

    # adaptive routing with BENCH_engine.json's table installed
    table = xover.load_crossover_table(str(ROOT / "BENCH_engine.json"))
    check(table.entries > 0, "[12]: BENCH_engine.json gave no crossover "
          "entries")
    auto_routes = {b: [(r["op"], r["route"]) for r in
                       cnn.chain_boundary_summary(spec, batch=b,
                                                  device=dev)["routes"]]
                   for b in ALEX_BUCKETS}
    adaptive = {}
    prev = xover.set_active_table(table)
    try:
        for occ in ALEX_OCCUPANCY:
            cfg = engine.EngineConfig(route="adaptive", occupancy_hint=occ)
            run_a = serve(cfg)
            eng_a = run_a["engine"]
            flips = set()
            n_rec = 0
            for b in ALEX_BUCKETS:
                recs = [r for r in eng_a.plans[b].fn.graph.records
                        if r.get("route") is not None]
                check([r["op"] for r in recs] == [r[0] for r in
                                                  auto_routes[b]],
                      f"[12] adaptive {occ} bucket {b}: routed records "
                      f"{[r['op'] for r in recs]}, auto {auto_routes[b]}")
                for rec, (op, flavor) in zip(recs, auto_routes[b]):
                    want = adaptive_route(xover, table, rec, flavor)
                    check((rec["route"], rec["route_source"]) == want,
                          f"[12] adaptive {occ} bucket {b}: record {rec}, "
                          f"its own fields give {want}")
                    if rec["route"] != flavor:
                        flips.add((op, rec["shape_class"], flavor,
                                   rec["route"]))
                    n_rec += 1
                conflicts = xover.route_conflicts(recs, table)
                check(conflicts == [], f"[12] adaptive {occ} bucket {b}: "
                      f"route conflicts {conflicts}")
                rep = eng_a.boundary_report(b)
                check(rep["fallback_decodes"] == 0, f"[12] adaptive {occ} "
                      f"bucket {b}: {rep}")
            rows = torch.stack([r.result for r in eng_a.completed])
            da = float((rows - run_a["oracle"]).abs().max())
            ra = da / max(float(run_a["oracle"].abs().max()), 1e-30)
            check(bool(torch.allclose(rows, run_a["oracle"], atol=5e-3,
                                      rtol=5e-3)) and ra <= 1e-4,
                  f"[12] adaptive {occ}: served rows off the oracle by "
                  f"{da:.3e} (ratio to max|dense| {ra:.3e})")
            adaptive[occ] = dict(flips=sorted(flips),
                                 requests_s=run_a["stats"]["requests_s"],
                                 max_abs_err=da, ratio=ra)
            print(f"[12] adaptive at occupancy {occ} (BENCH_engine.json: "
                  f"device {table.device!r}, {table.entries} entries, "
                  f"{len(table)} curves): {n_rec} routed records over the "
                  f"buckets, each routed to the cheaper side its own fields "
                  f"give; route_conflicts empty; rows within 5e-3 and "
                  f"1e-4·max|dense| of the oracle (max|d| {da:.3e}, ratio "
                  f"{ra:.3e}); boundaries off auto "
                  f"(op, shape class, auto, adaptive): {sorted(flips)}; "
                  f"{run_a['stats']['requests_s']} requests/s (card {card})",
                  flush=True)
            del run_a, eng_a, rows
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        xover.set_active_table(prev)
    check(xover.active_table() is None, "[12]: the table was not cleared")
    seconds = time.perf_counter() - t_phase
    print(f"[12] phase 12 took {seconds:.1f} s", flush=True)
    return dict(stats=stats, per_bucket=per_bucket, warm=warm,
                replay8_ms=replay_ms, dense8_ms=dense_ms, priced=priced,
                adaptive=adaptive, seconds=seconds, kept=kept)


# ---------------------------------------------------------------------------

#: Phase 13: Qwen2-0.5B trained at full width through launch/train.py,
#: with the JAX example's batch and sequence, AdamW under
#: warmup_cosine(3e-4, 20, TRAIN_STEPS) on the Markov corpus.
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "qwen2-0.5b", 60, 8, 128
#: The loss criterion of the JAX system test: the mean of the last 5
#: losses below the mean of the first 5 by at least this much.
TRAIN_DROP = 0.2
#: The preempted run stops after step TRAIN_PREEMPT_AT (its checkpoint is
#: step TRAIN_PREEMPT_AT + 1); the resumed run goes on to TRAIN_RESUME_TO.
TRAIN_PREEMPT_AT, TRAIN_RESUME_TO = 3, 8
#: The resumed run's losses against the uninterrupted run's, relative: the
#: backward of the embedding gather adds with atomics, so the two runs'
#: states differ in their last bits (bf16 compute).
RESUME_TOL = 5e-3
#: accum_steps=2 against 1 on one batch (bf16 compute, microbatches of 4
#: rows against one of 8), from a fresh optimizer state with no clipping,
#: so that the first moments are 0.1 x the averaged gradient itself (a
#: clip to norm 1 would scale a missing 1/accum_steps away): the loss and
#: the gradient's global norm, relative (a missing average reads 2x; half
#: the batch left out moves both by far more, as the run shows beside
#: them), and each leaf's first moments within ACCUM_MU_TOL of the leaf's
#: own largest.  The key bias (ACCUM_ZERO_GRAD) has an exact gradient of
#: 0 (softmax is shift-invariant along the keys): what it holds is
#: rounding, so its floor is the tree's largest first moment.  The params
#: are not gated: a first Adam step moves each element by lr times its
#: normalized gradient (+-1) and its weight decay term, so any two
#: gradients give params within 2 lr of each other.
ACCUM_LR, ACCUM_LOSS_TOL, ACCUM_GN_TOL, ACCUM_MU_TOL = 1e-4, 1e-5, 1e-2, 2e-2
ACCUM_ZERO_GRAD = ("layers/mix/bk",)


#: Phase 13's Hymba-1.5B, trained at full width through launch/train.py:
#: batch 8 x 1024 (two B10 chunks of 512 a layer, so the final state's
#: gradient crosses a chunk boundary), AdamW under
#: warmup_cosine(HYMBA_LR, 5, HYMBA_STEPS) on the Markov corpus; the loss
#: criterion is TRAIN_DROP's.  At this rate batch 2 and 4 fall by 0.097
#: and 0.191 in 30 steps, batch 8 by 0.273, and at 3e-3 batch 2 rises
#: (on the card, a shell loop over ``launch.train``: ``for b in 2 4 8; do
#: python -m repro_torch.launch.train --arch hymba-1.5b --steps 30 --lr
#: 1e-3 --warmup 5 --batch $b --seq 1024 --log-every 1; done``).
HYMBA_STEPS, HYMBA_BATCH, HYMBA_SEQ, HYMBA_LR = 30, 8, 1024, 1e-3
#: The f32 check: a 2-layer Hymba at full width, batch HYMBA_F32_BATCH x
#: HYMBA_SEQ, one step's loss and gradients through B10's kernels against
#: the same step with B10's plain forward and backward called explicitly,
#: each leaf's gradient within this share of its own max|plain| (the
#: kernels sum in other orders than the plain versions; the leaves only
#: B10's backward feeds, as a_log and dt_bias, have gradients orders of
#: magnitude below the tree's largest).
HYMBA_F32_BATCH, HYMBA_GRAD_TOL = 2, 1e-4


def _leaf_names(tree, path=()) -> list:
    """The '/'-joined key paths of a param tree's tensors, in the order of
    ``param_utils.tree_leaves``."""
    import torch
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, path + (str(i),))]
    return ["/".join(path)] if isinstance(tree, torch.Tensor) else []


def hymba_step_counts(cfg, seq: int, steps: int) -> dict:
    """B10's launches over ``steps`` train steps of batch rows of ``seq``
    tokens: each layer runs ceil(seq / scan_chunk) chunks, each one
    forward launch (again under remat, which recomputes the layer in the
    backward) and one backward launch."""
    chunks = cfg.num_layers * -(-seq // cfg.ssm.scan_chunk)
    again = 1 if cfg.remat == "none" else 2
    return dict(mamba_scan_fused=steps * chunks * again,
                mamba_scan_fused_bwd=steps * chunks)


class _PlainScan:
    """Inside the block, B10's Function runs its plain forward and plain
    backward (``mamba_scan_fused_ref``, ``mamba_scan_fused_bwd_ref``)
    called explicitly, on the card's tensors: the reference of the f32
    check."""

    def __init__(self, ops, ref):
        self.ops, self.ref = ops, ref

    def __enter__(self):
        self.orig = (self.ops._fused_forward, self.ops.mamba_scan_fused_bwd)
        self.ops._fused_forward = self.ref.mamba_scan_fused_ref
        self.ops.mamba_scan_fused_bwd = self.ref.mamba_scan_fused_bwd_ref
        return self

    def __exit__(self, *exc):
        self.ops._fused_forward, self.ops.mamba_scan_fused_bwd = self.orig


class _SkippedSaves:
    """Stands in for ``checkpoint.save`` inside the block: records the
    steps the loop asks to save and writes nothing (a checkpoint that
    nothing reads is 5.5 GiB of disk time)."""

    def __init__(self, ckpt):
        self.ckpt, self.steps = ckpt, []

    def __enter__(self):
        self.orig = self.ckpt.save
        self.ckpt.save = lambda tree, d, step: self.steps.append(step)
        return self

    def __exit__(self, *exc):
        self.ckpt.save = self.orig


#: The eager step's figures beside the graphed one's: a short run of
#: ``launch.train`` with the step forced eager (``_EagerSteps``), its
#: median after the first step (from the third step on it holds what the
#: long run holds at its peak: the caller's first state, the step's
#: input and its output).
TRAIN_EAGER_STEPS, HYMBA_EAGER_STEPS = 8, 5
#: The graphed step against the eager one, bitwise, from the same params
#: and batches: Qwen2-0.5B at full width, accum_steps 1 and 2; Hymba's
#: 2-layer full-width cut in the main path's bf16 at its batch.
BITWISE_STEPS = 3
#: Hymba's graphed run may hold at most this much more device memory at
#: its peak than ``launch.train``'s eager run (GiB).
HYMBA_PEAK_SLACK_GIB = 2.0


class _EagerSteps:
    """Inside the block, ``launch.train`` builds the eager step
    (``make_train_step(graph=False)``) where it takes the graphed one."""

    def __init__(self, train):
        self.train = train

    def __enter__(self):
        import functools
        self.orig = self.train.make_train_step
        self.train.make_train_step = functools.partial(self.orig,
                                                       graph=False)
        return self

    def __exit__(self, *exc):
        self.train.make_train_step = self.orig


def graph_figures(torch, run, tag, batch, seq, card) -> dict:
    """The graphed run's figures (``launch.train``'s result): the step's
    median ms, tokens/s, peak memory, capture s and graph pool GiB, and
    the idle share of the graph's replays over 3 steps."""
    g = run["graph"]
    prof = profile(torch, g.replay, f"{tag} graphed train step", steps=3,
                   top=6, host_ops=False)
    out = dict(step_ms=run["step_ms"],
               tok_s=batch * seq / (run["step_ms"] / 1e3),
               peak_gib=run["peak_bytes"] / 2**30, idle=prof["idle"],
               busy_ms=prof["busy_ms"], warmup_s=g.warmup_s,
               capture_s=g.capture_s, pool_gib=g.pool_bytes / 2**30)
    print(f"{tag} graphed step {out['step_ms']:.3f} ms (median of steps "
          f"1-{len(run['log']) - 1}), {out['tok_s']:.1f} tokens/s, peak "
          f"memory {out['peak_gib']:.3f} GiB, idle share {out['idle']:.3f}, "
          f"warm-up {g.warmup_s:.3f} s + capture {g.capture_s:.3f} s, graph "
          f"pool {out['pool_gib']:.3f} GiB (card {card})", flush=True)
    return out


def eager_figures(torch, train, argv, cfg, shape, opt, batch, seq,
                  card, tag) -> dict:
    """``launch.train``'s run with the eager step (``_EagerSteps``): the
    step's median ms, tokens/s and peak memory, and the idle share of the
    eager step over 3 steps."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.data import TokenStreamConfig, markov_lm_batch
    from repro_torch.launch.steps import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    with _EagerSteps(train), _SkippedSaves(ckpt):
        run = train.train(train.parse_args(argv))
    check(run["graph"] is None, f"{tag} the eager run took a graph")
    state = run["state"]
    del run["state"]
    b = markov_lm_batch(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch), 0,
        device="cuda")
    fn = make_train_step(cfg, shape, opt=opt, graph=False).fn
    prof = profile(torch, lambda: fn(*state, b), f"{tag} eager train step",
                   steps=3, top=6, host_ops=False)
    out = dict(step_ms=run["step_ms"],
               tok_s=batch * seq / (run["step_ms"] / 1e3),
               peak_gib=run["peak_bytes"] / 2**30, idle=prof["idle"],
               busy_ms=prof["busy_ms"])
    print(f"{tag} eager step {out['step_ms']:.3f} ms (median of steps 1-"
          f"{len(run['log']) - 1} of launch/train.py, the step forced "
          f"eager), {out['tok_s']:.1f} tokens/s, peak memory "
          f"{out['peak_gib']:.3f} GiB, idle share {out['idle']:.3f} (card "
          f"{card})", flush=True)
    del state, fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def graph_vs_eager(torch, wrappers, tag, cfg, shape, opt, batches,
                   accum, plan) -> dict:
    """The eager step twice, then the graphed step, over ``batches`` from
    the same params (seed 0) and a fresh optimizer state: the second
    eager run bitwise the first (the eager step's own spread, which the
    graph is held to: none), and the graphed run too: every param,
    moment and count and every step's loss, grad_norm and lr; each run's
    first state left as it was; the replays after the first under
    set_sync_debug_mode("error") (no host sync); the launches the
    capture saw == ``plan`` a step (the warm-up and the capture counted
    by the wrappers, the replays by the graph)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param_utils import tree_leaves
    from repro_torch.optim import adamw_init

    def leaves(p, o):
        return tree_leaves((p, o.mu, o.nu, o.count))

    p0 = tfm.init_params(0, cfg, "cuda")
    runs = {}
    for run_i, graph in enumerate((False, False, True)):
        fn = make_train_step(cfg, shape, opt=opt, accum_steps=accum,
                             graph=graph).fn
        state, trail = (p0, adamw_init(p0)), []
        init = [t.clone() for t in leaves(*state)]
        kept = leaves(*state)
        before = {n: w.launches for n, w in wrappers.items()}
        for i, b in enumerate(batches):
            if graph and i:
                torch.cuda.set_sync_debug_mode("error")
            try:
                p, o, m = fn(*state, b)
                trail.append([m[k].clone() for k in ("loss", "grad_norm",
                                                     "lr")]
                             + [o.count.clone()])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            state = (p, o)
        counted = {n: w.launches - before[n] for n, w in wrappers.items()}
        runs[run_i] = dict(leaves=[t.clone() for t in leaves(*state)],
                           trail=trail, counted=counted,
                           graph=fn.graph if graph else None,
                           kept=all(torch.equal(a, b)
                                    for a, b in zip(kept, init)))
        del fn, state, p, o, init, kept
        gc.collect()
        torch.cuda.empty_cache()
    e, e2, g = runs[0], runs[1], runs[2]

    def bitwise(a, b):
        return ([torch.equal(x, y) for x, y in zip(a["leaves"], b["leaves"])],
                all(torch.equal(x, y) for sa, sb in zip(a["trail"],
                                                        b["trail"])
                    for x, y in zip(sa, sb)))
    # the eager step against itself first: the spread the graph is held to
    e_same, e_trail = bitwise(e2, e)
    same, trail_same = bitwise(g, e)
    graph = g["graph"]
    per_step = {n: graph.launches.get(w, 0) for n, w in wrappers.items()}
    print(f"{tag} eager step vs itself (accum_steps {accum}), "
          f"{len(batches)} steps from the same state: {sum(e_same)} of "
          f"{len(e_same)} leaves bitwise, metrics bitwise {e_trail}",
          flush=True)
    check(all(e_same) and e_trail, f"{tag} the eager step is not bitwise "
          f"from run to run (accum_steps {accum}): "
          f"{len(e_same) - sum(e_same)} leaves differ, metrics same "
          f"{e_trail}")
    print(f"{tag} graphed step vs eager (accum_steps {accum}), "
          f"{len(batches)} steps from the same state: losses "
          f"{[round(float(s[0]), 6) for s in g['trail']]} vs "
          f"{[round(float(s[0]), 6) for s in e['trail']]}; {sum(same)} of "
          f"{len(same)} leaves (params, moments, count) bitwise, metrics "
          f"bitwise {trail_same}; launches a step at capture {per_step} "
          f"(plan {plan}), replays {graph.replays}; replays 2-"
          f"{len(batches)} made no host sync", flush=True)
    check(all(same) and trail_same, f"{tag} the graphed step is not "
          f"bitwise the eager one (accum_steps {accum}): "
          f"{len(same) - sum(same)} leaves differ, metrics same "
          f"{trail_same}")
    check(g["kept"] and e["kept"] and e2["kept"]
          and int(g["trail"][0][3]) == 1,
          f"{tag} the warm-up or a copy wrote the caller's first state")
    check(per_step == plan and graph.replays == len(batches)
          and g["counted"] == {n: 2 * c for n, c in plan.items()}
          and e["counted"] == {n: len(batches) * c for n, c in plan.items()},
          f"{tag} launches: at capture {per_step}, the graphed run's "
          f"warm-up and capture {g['counted']}, the eager run "
          f"{e['counted']}, want {plan} a step")
    return dict(accum=accum, leaves=len(same), replays=graph.replays,
                per_step=per_step)


def train_phase(torch, engine, wrappers, card) -> dict:
    """Phase 13: training on the card.

    The main path: ``launch.train.train`` on Qwen2-0.5B at full width
    (24 layers, d 896, vocab 151,936; f32 params, bf16 compute, MNF at
    its θ = 0) through the graphed train step (one CUDA graph a step,
    the params and moments updated in place), every launch count set to
    0 just before and read just after (the path reaches none of B1-B10:
    all stay 0).  Checks: every loss finite, the mean of the last 5
    below the mean of the first 5 by ``TRAIN_DROP``; the counted step's
    FLOPs between 6·N·D and twice it; the graph replayed once a step.
    Prints the step's median ms, tokens/s, peak memory, capture s, graph
    pool GiB, the idle share over 3 replays, and the roofline row with
    the measured share (model FLOPs over the median step at the bf16
    peak); then ``launch.train`` with the step forced eager
    (``TRAIN_EAGER_STEPS`` steps): its ms, tokens/s, peak memory and
    idle share.  Then: ``accum_steps`` 2 against 1 on one batch with the
    eager step (loss, grad norm and each leaf's first moments; half the
    batch shown to fail the gates); the graphed step bitwise the eager
    one over ``BITWISE_STEPS`` steps at accum_steps 1 and 2
    (:func:`graph_vs_eager`); a run through the graphed step stopped by
    the loop's preemption path (SIGTERM) writes its checkpoint, which a
    resumed run through the same graph restores bitwise and copies in,
    and whose losses match the uninterrupted run's.  Then Hymba-1.5B at
    full width (32 layers, d 1600, Mamba state 16) through
    ``launch.train``, batch 8 x 1024 (two B10 chunks a layer),
    ``HYMBA_STEPS`` steps, counts set to 0 just before and read just
    after: B10's
    forward and backward launches at the capture a step as planned
    (``hymba_step_counts``), the wrappers' counts the warm-up's, the
    capture's and the counted eager step's, the main path's launches
    the capture's times the replays plus the counted step's; the loss
    falling by ``TRAIN_DROP``, the counted FLOPs at least 6·N·D; the
    graphed and the eager figures as Qwen2's, the graphed peak at most
    ``HYMBA_PEAK_SLACK_GIB`` above the eager one; its first two backward
    launches (the counted eager step's) kept for phase 3; the graphed
    step bitwise the eager one on the 2-layer full-width cut; and one
    f32 step of the 2-layer cut through B10's kernels against B10's
    plain forward and backward called explicitly (:class:`_PlainScan`):
    the loss
    within ``HYMBA_GRAD_TOL`` relative, each leaf's gradient within it
    of its own max|plain|.  The main and the resumed runs' final
    checkpoints, which nothing reads, are asked for and not written
    (:class:`_SkippedSaves`); the preempted run's goes to
    build/smoke_train, removed at the end."""
    import dataclasses
    import os
    import shutil
    import signal

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenStreamConfig, markov_lm_batch
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.launch import roofline, train
    from repro_torch.models.param_utils import tree_leaves, tree_map
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import (AdamWConfig, adamw_init, warmup_cosine)
    from repro_torch.runtime import LoopConfig, ResilientLoop

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = ROOT / "build" / "smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--lr", "3e-4", "--warmup", "20",
            "--ckpt-every", str(TRAIN_STEPS + 1), "--log-every", "5"]
    args = train.parse_args(argv + ["--steps", str(TRAIN_STEPS),
                                    "--ckpt-dir", str(root / "main")])
    cfg, shape, plan = train.build(args)
    check((cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.param_dtype,
           cfg.compute_dtype, cfg.mnf.enabled, cfg.mnf.threshold)
          == (24, 896, 151936, "float32", "bfloat16", True, 0.0),
          f"[13] unexpected config {cfg}")
    opt = AdamWConfig(schedule=warmup_cosine(3e-4, 20, TRAIN_STEPS))

    # -- the main path: launch/train.py through the graphed step, counts 0
    # before, read after; its final checkpoint is asked for and not
    # written (nothing reads it)
    with _SkippedSaves(ckpt) as skipped:
        run, _, launches, _, secs = drive_counted(
            torch, engine, wrappers, lambda: train.train(args),
            capture=False)
    check_plan("[13] train", launches, {n: 0 for n in wrappers})
    check(run["graph"] is not None
          and run["graph"].replays == TRAIN_STEPS,
          f"[13] launch/train.py did not replay one graph a step: "
          f"{run['graph']}")
    n_params = sum(t.numel() for t in tree_leaves(run["state"][0]))
    check(skipped.steps == [TRAIN_STEPS], f"[13] the loop asked to save "
          f"steps {skipped.steps}, not its final step {TRAIN_STEPS} alone")
    log = run["log"]
    losses = [m["loss"] for m in log]
    keys = ("final_step", "preempted", "wall_s", "first_loss", "last_loss",
            "stragglers_flagged", "tokens_per_s")
    print(f"[13] {cfg.name} at full width ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e6:.1f} M "
          f"params f32, bf16 compute, MNF θ=0), batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps through launch/train.py (the "
          f"graphed step) in {secs:.1f} s: "
          + json.dumps({k: run[k] for k in keys}), flush=True)
    print(f"[13] losses {[round(x, 4) for x in losses]}", flush=True)
    check(run["final_step"] == TRAIN_STEPS and not run["preempted"],
          f"[13] the run ended at {run['final_step']}")
    check(all(math.isfinite(x) for x in losses), "[13] a loss not finite")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last5 < first5 - TRAIN_DROP, f"[13] the loss fell from "
          f"{first5:.4f} to {last5:.4f} (mean of the first and last 5): "
          f"less than {TRAIN_DROP}")
    rep = run["report"]
    six_nd = 6.0 * n_params * TRAIN_BATCH * TRAIN_SEQ
    check(six_nd <= rep.hlo_gflops * 1e9 <= 2 * six_nd,
          f"[13] counted {rep.hlo_gflops:.1f} GFLOP outside [6ND, 12ND] = "
          f"[{six_nd / 1e9:.1f}, {2 * six_nd / 1e9:.1f}]")
    print(f"[13] all step ms "
          f"{[round(m['step_time_s'] * 1e3, 2) for m in log]}; mean loss "
          f"of the first 5 steps {first5:.4f}, of the last 5 {last5:.4f} "
          f"(a drop of {first5 - last5:.4f}, limit >= {TRAIN_DROP})",
          flush=True)
    print(f"[13] roofline of the train step (counted on the eager step: "
          f"FlopCounterMode and the byte counter, nothing fused): "
          f"{rep.hlo_gflops:.1f} GFLOP, {rep.hlo_gbytes:.2f} GB; t_compute "
          f"{rep.t_compute * 1e3:.3f} ms, t_memory {rep.t_memory * 1e3:.3f} "
          f"ms [{rep.bottleneck}]; model (6·N·D) {rep.model_gflops:.1f} GFLOP,"
          f" useful_ratio {rep.useful_ratio:.4f}, roofline_frac "
          f"{rep.roofline_frac:.4f}; measured share (model FLOPs over the "
          f"median graphed step at {roofline.HW().peak_flops / 1e12:.0f} "
          f"TFLOP/s) {run['measured_frac']:.4f} (card {card})", flush=True)
    print(roofline.format_row(rep), flush=True)
    marks = [("", t_phase), ("main run", time.perf_counter())]
    params = run["state"][0]
    measured = run["measured_frac"]
    ds = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH)
    batch = markov_lm_batch(ds, TRAIN_STEPS, device="cuda")

    # -- accum_steps 2 against 1 with the eager step, one batch, a fresh
    # optimizer state, no clipping, from the params after TRAIN_STEPS
    # steps (before the graph's profile replays step them on); half the
    # batch alone shows what the gates would see
    aopt = AdamWConfig(lr=ACCUM_LR, grad_clip=math.inf)
    fresh = adamw_init(params)
    outs = [make_train_step(cfg, shape, opt=aopt, accum_steps=a,
                            graph=False).fn(params, fresh, batch)
            for a in (1, 2)]
    (p1, s1, m1), (p2, s2, m2) = outs
    half_shape = ShapeConfig("half", TRAIN_SEQ, TRAIN_BATCH // 2, "train")
    m_half = make_train_step(cfg, half_shape, opt=aopt, graph=False).fn(
        params, fresh, {k: v[:TRAIN_BATCH // 2]
                        for k, v in batch.items()})[2]

    def rel(m, key):
        return abs(float(m[key]) - float(m1[key])) / abs(float(m1[key]))
    loss_d, gn_d = rel(m2, "loss"), rel(m2, "grad_norm")
    flat = ckpt.checkpointer._flatten_with_path
    mu_max = max(float(b.abs().max()) for _, b in flat(s1.mu))
    per_leaf = sorted(((float((a - b).abs().max()) / max(
        float(b.abs().max()), mu_max if "/".join(pa) in ACCUM_ZERO_GRAD
        else 0.0, 1e-30), "/".join(pa))
        for (pa, a), (_, b) in zip(flat(s2.mu), flat(s1.mu))), reverse=True)
    mu_d = per_leaf[0][0]
    p_d = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(p2), tree_leaves(p1)))
    print(f"[13] accum_steps 2 vs 1 on one batch (no clipping): loss "
          f"{float(m2['loss']):.6f} vs {float(m1['loss']):.6f} (relative "
          f"{loss_d:.3e}, limit {ACCUM_LOSS_TOL}; half the batch "
          f"{rel(m_half, 'loss'):.3e}), grad_norm {float(m2['grad_norm']):.6f}"
          f" vs {float(m1['grad_norm']):.6f} (relative {gn_d:.3e}, limit "
          f"{ACCUM_GN_TOL}; half the batch {rel(m_half, 'grad_norm'):.3e}); "
          f"first moments, each leaf against its own max (the key bias "
          f"against the tree's {mu_max:.3e}), worst "
          f"{[(n, f'{r:.2e}') for r, n in per_leaf[:3]]} (limit "
          f"{ACCUM_MU_TOL}); params worst |d| {p_d / ACCUM_LR:.4f} lr (not "
          f"gated: at most 2 lr for any two gradients)", flush=True)
    check(rel(m_half, "loss") > ACCUM_LOSS_TOL
          and rel(m_half, "grad_norm") > ACCUM_GN_TOL,
          "[13] half the batch passes the accum gates: they test nothing")
    check(loss_d <= ACCUM_LOSS_TOL and gn_d <= ACCUM_GN_TOL
          and mu_d <= ACCUM_MU_TOL, "[13] accum_steps 2 != 1")
    del outs, p1, p2, s1, s2, fresh, m_half, params
    graphed = graph_figures(torch, run, "[13]", TRAIN_BATCH, TRAIN_SEQ,
                            card)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("accum and profile", time.perf_counter()))

    # -- the eager step's figures: launch/train.py, the step forced eager
    eager = eager_figures(
        torch, train, argv + ["--steps", str(TRAIN_EAGER_STEPS),
                              "--ckpt-dir", str(root / "eager")],
        cfg, shape, opt, TRAIN_BATCH, TRAIN_SEQ, card, "[13]")
    marks.append(("eager run", time.perf_counter()))

    # -- the graphed step bitwise the eager one, accum_steps 1 and 2
    batches = [markov_lm_batch(ds, i, device="cuda")
               for i in range(BITWISE_STEPS)]
    bitwise = [graph_vs_eager(torch, wrappers, "[13]", cfg, shape, opt,
                              batches, a, {n: 0 for n in wrappers})
               for a in (1, 2)]
    del batches
    marks.append(("graph vs eager", time.perf_counter()))

    # -- preemption through the graphed step: a run stopped by SIGTERM
    # checkpoints; a resumed run restores it (held bitwise against the
    # stopped run's state) and the same graph copies it in, starts at that
    # step and tracks the uninterrupted run's losses; its own final
    # checkpoint is asked for and not written
    def loop(total, kill_at=None, first=None):
        def batch_fn(step):
            if step == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return markov_lm_batch(ds, step, device="cuda")

        def step_fn(state, b):
            if first is not None and not first:
                first.append((time.perf_counter(), state))
            p, o, m = plan.fn(*state, b)
            return (p, o), m
        fresh_p = tfm.init_params(0, cfg, "cuda")
        return ResilientLoop(LoopConfig(total_steps=total,
                                        ckpt_dir=str(root / "pre"),
                                        ckpt_every=TRAIN_STEPS + 1),
                             step_fn, batch_fn), (fresh_p,
                                                  adamw_init(fresh_p))

    t0 = time.perf_counter()
    lp, init = loop(TRAIN_STEPS, kill_at=TRAIN_PREEMPT_AT)
    state_b, final_b, pre_b = lp.run(init)
    save_s = time.perf_counter() - t0
    check(pre_b and final_b == TRAIN_PREEMPT_AT + 1
          and ckpt.latest_step(str(root / "pre")) == final_b,
          f"[13] preempted run: final {final_b}, preempted {pre_b}, latest "
          f"{ckpt.latest_step(str(root / 'pre'))}")
    # the graph's own buffers: the resumed run rewrites them
    state_b = tree_map(lambda t: t.clone(), dict(
        p=state_b[0], mu=state_b[1].mu, nu=state_b[1].nu,
        count=state_b[1].count))
    pre_gib = lp_bytes(root / "pre", final_b) / 2**30
    del init, lp
    first = []
    lc, init = loop(TRAIN_RESUME_TO, first=first)
    t0 = time.perf_counter()
    with _SkippedSaves(ckpt) as skipped:
        _, final_c, pre_c = lc.run(init)
    check(len(first) == 1, "[13] the resumed run took no step")
    restore_s = first[0][0] - t0
    restored = dict(p=first[0][1][0], mu=first[0][1][1].mu,
                    nu=first[0][1][1].nu, count=first[0][1][1].count)
    same = [(pa, torch.equal(a, b)) for (pa, a), (pb, b) in zip(
        flat(restored), flat(state_b)) if pa == pb]
    same = len(same) == len(flat(state_b)) and all(e for _, e in same)
    check(same, "[13] the restored leaves are not bitwise the saved ones")
    check(all(a is not b for a, b in zip(tree_leaves(restored),
                                         tree_leaves(plan.fn.state))),
          "[13] the restore handed the graph its own buffers")
    del restored, state_b, first
    resumed = [m["loss"] for m in lc.metrics_log]
    steps_c = [int(m["step"]) for m in lc.metrics_log]
    check(steps_c == list(range(TRAIN_PREEMPT_AT + 1, TRAIN_RESUME_TO))
          and final_c == TRAIN_RESUME_TO and not pre_c
          and skipped.steps == [TRAIN_RESUME_TO],
          f"[13] the resumed run ran steps {steps_c}, asked to save "
          f"{skipped.steps}")
    want = losses[TRAIN_PREEMPT_AT + 1:TRAIN_RESUME_TO]
    res_d = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
    print(f"[13] preempted by SIGTERM before the end of step "
          f"{TRAIN_PREEMPT_AT} (the graphed step): checkpoint of step "
          f"{final_b} written ({pre_gib:.2f} GiB on disk; the run and its "
          f"save {save_s:.1f} s); the resumed run restored it bitwise and "
          f"the same graph copied it in (restore and first batch "
          f"{restore_s:.1f} s), ran steps {steps_c}, losses "
          f"{[round(x, 4) for x in resumed]} against the uninterrupted "
          f"run's {[round(x, 4) for x in want]} (worst relative {res_d:.2e},"
          f" limit {RESUME_TOL})", flush=True)
    check(res_d <= RESUME_TOL, f"[13] resumed losses off by {res_d:.2e}")
    del lc, init, plan
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    marks.append(("preemption and resume", time.perf_counter()))

    # -- Hymba-1.5B at full width through launch/train.py and the graphed
    # step: B10's forward and backward kernels on the main path, counts 0
    # before, read after; the first two backward launches (the counted
    # eager step's: the last layer's chunks 1 and 0) kept for phase 3
    hargv = ["--arch", "hymba-1.5b", "--batch", str(HYMBA_BATCH), "--seq",
             str(HYMBA_SEQ), "--lr", str(HYMBA_LR), "--warmup", "5",
             "--ckpt-every", str(HYMBA_STEPS + 1), "--log-every", "5"]
    hargs = train.parse_args(hargv + ["--steps", str(HYMBA_STEPS),
                                      "--ckpt-dir", str(root / "hymba")])
    hcfg, hshape, hplan = train.build(hargs)
    del hplan
    check((hcfg.num_layers, hcfg.d_model, hcfg.ssm.state_dim,
           hcfg.ssm.scan_chunk, hcfg.param_dtype, hcfg.compute_dtype)
          == (32, 1600, 16, 512, "float32", "bfloat16"),
          f"[13] unexpected Hymba config {hcfg}")
    hopt = AdamWConfig(schedule=warmup_cosine(HYMBA_LR, 5, HYMBA_STEPS))
    bwd = wrappers["mamba_scan_fused_bwd"]

    def hymba_run():
        bwd.capture = FirstCalls(2)
        return train.train(hargs)
    with _SkippedSaves(ckpt) as skipped:
        hrun, _, hl, hcaps, hsecs = drive_counted(
            torch, engine, wrappers, hymba_run, capture=False)
    hg = hrun["graph"]
    per_step = {n: 0 for n in wrappers} | hymba_step_counts(
        hcfg, HYMBA_SEQ, 1)
    captured = {n: hg.launches.get(w, 0) for n, w in wrappers.items()}
    # the wrappers count the graph's warm-up, its capture and the counted
    # eager step; the main path's launches are the capture's times the
    # replays, and the counted step's
    main_path = {n: c * hg.replays + c for n, c in captured.items()}
    check_plan("[13] Hymba train, one step at capture", captured, per_step)
    check(captured == per_step and hg.replays == HYMBA_STEPS
          and hl == {n: 3 * c for n, c in per_step.items()},
          f"[13] Hymba: B10 launches at capture {captured} (plan "
          f"{per_step}) over {hg.replays} replays; the wrappers counted "
          f"{hl}, want 3 steps' (warm-up, capture, counted step)")
    check(skipped.steps == [HYMBA_STEPS], f"[13] Hymba: the loop asked to "
          f"save steps {skipped.steps}")
    hlosses = [m["loss"] for m in hrun["log"]]
    h_params = sum(t.numel() for t in tree_leaves(hrun["state"][0]))
    print(f"[13] {hcfg.name} at full width ({hcfg.num_layers} layers, d "
          f"{hcfg.d_model}, Mamba state {hcfg.ssm.state_dim}, "
          f"{h_params / 1e6:.1f} M params f32, bf16 compute, MNF θ=0), "
          f"batch {HYMBA_BATCH} x {HYMBA_SEQ} (B10 chunks of "
          f"{hcfg.ssm.scan_chunk}), {HYMBA_STEPS} steps through "
          f"launch/train.py (the graphed step) in {hsecs:.1f} s: B10 "
          f"forward {captured['mamba_scan_fused']} and backward "
          f"{captured['mamba_scan_fused_bwd']} launches at capture, as "
          f"planned ({hcfg.num_layers} layers x "
          f"{-(-HYMBA_SEQ // hcfg.ssm.scan_chunk)} chunks, the forward again "
          f"under remat '{hcfg.remat}'), x {hg.replays} replays + the "
          f"counted eager step = {main_path['mamba_scan_fused']} and "
          f"{main_path['mamba_scan_fused_bwd']} on the main path (the "
          f"wrappers counted {hl['mamba_scan_fused']} and "
          f"{hl['mamba_scan_fused_bwd']}: the warm-up, the capture, the "
          f"counted step)", flush=True)
    print(f"[13] Hymba losses {[round(x, 4) for x in hlosses]}", flush=True)
    check(hrun["final_step"] == HYMBA_STEPS and not hrun["preempted"],
          f"[13] the Hymba run ended at {hrun['final_step']}")
    check(all(math.isfinite(x) for x in hlosses), "[13] a Hymba loss not "
          "finite")
    h5, hl5 = statistics.mean(hlosses[:5]), statistics.mean(hlosses[-5:])
    check(hl5 < h5 - TRAIN_DROP, f"[13] Hymba's loss fell from {h5:.4f} to "
          f"{hl5:.4f} (mean of the first and last 5): less than "
          f"{TRAIN_DROP}")
    hrep = hrun["report"]
    h6nd = 6.0 * h_params * HYMBA_BATCH * HYMBA_SEQ
    check(hrep.hlo_gflops * 1e9 >= h6nd, f"[13] Hymba: counted "
          f"{hrep.hlo_gflops:.1f} GFLOP below 6ND {h6nd / 1e9:.1f}")
    print(f"[13] Hymba all step ms "
          f"{[round(m['step_time_s'] * 1e3, 2) for m in hrun['log']]}; mean "
          f"loss of the first 5 steps {h5:.4f}, of the last 5 {hl5:.4f} (a "
          f"drop of {h5 - hl5:.4f}, limit >= {TRAIN_DROP})", flush=True)
    hgraphed = graph_figures(torch, hrun, "[13] Hymba", HYMBA_BATCH,
                             HYMBA_SEQ, card)
    print(f"[13] roofline of Hymba's train step (counted on the eager step;"
          f" B10's launches by their formulas {hrun['cost'].kernels}): "
          f"{hrep.hlo_gflops:.1f} GFLOP ({hrep.hlo_gflops * 1e9 / h6nd:.2f}"
          f" x 6ND), {hrep.hlo_gbytes:.2f} GB; t_compute "
          f"{hrep.t_compute * 1e3:.3f} ms, t_memory "
          f"{hrep.t_memory * 1e3:.3f} ms [{hrep.bottleneck}]; useful_ratio "
          f"{hrep.useful_ratio:.4f}, roofline_frac {hrep.roofline_frac:.4f};"
          f" measured share {hrun['measured_frac']:.4f} (card {card})",
          flush=True)
    print(roofline.format_row(hrep), flush=True)
    hymba = dict(hgraphed, first5=h5, last5=hl5, report=hrep.to_json(),
                 measured_frac=hrun["measured_frac"],
                 fwd_launches=main_path["mamba_scan_fused"],
                 bwd_launches=main_path["mamba_scan_fused_bwd"],
                 per_step=hymba_step_counts(hcfg, HYMBA_SEQ, 1),
                 bwd_caps=list(hcaps["mamba_scan_fused_bwd"]),
                 kernels=hrun["cost"].kernels)
    check(len(hymba["bwd_caps"]) == 2, "[13] the backward's first launches "
          "were not kept")
    del hrun, hg
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("Hymba main run", time.perf_counter()))

    # -- Hymba's eager figures, then the graphed step bitwise the eager one
    # on the 2-layer full-width cut, in the main path's bf16
    heager = eager_figures(
        torch, train, hargv + ["--steps", str(HYMBA_EAGER_STEPS),
                               "--ckpt-dir", str(root / "hymba_eager")],
        hcfg, hshape, hopt, HYMBA_BATCH, HYMBA_SEQ, card, "[13] Hymba")
    hymba["eager"] = heager
    print(f"[13] Hymba graphed against eager: step {hgraphed['step_ms']:.3f}"
          f" vs {heager['step_ms']:.3f} ms, peak memory "
          f"{hgraphed['peak_gib']:.3f} vs {heager['peak_gib']:.3f} GiB "
          f"(limit: at most {HYMBA_PEAK_SLACK_GIB} GiB above)", flush=True)
    check(hgraphed["peak_gib"] <= heager["peak_gib"] + HYMBA_PEAK_SLACK_GIB,
          f"[13] Hymba's graphed run peaks at {hgraphed['peak_gib']:.3f} "
          f"GiB, more than {HYMBA_PEAK_SLACK_GIB} GiB above the eager "
          f"run's {heager['peak_gib']:.3f}")
    ccfg = dataclasses.replace(hcfg, num_layers=2, global_layer_ids=(0,))
    cshape = ShapeConfig("cut", HYMBA_SEQ, HYMBA_BATCH, "train")
    cds = TokenStreamConfig(vocab_size=ccfg.vocab_size, seq_len=HYMBA_SEQ,
                            global_batch=HYMBA_BATCH)
    hymba["bitwise"] = graph_vs_eager(
        torch, wrappers, "[13] Hymba 2-layer cut", ccfg, cshape, hopt,
        [markov_lm_batch(cds, i, device="cuda")
         for i in range(BITWISE_STEPS)], 1,
        {n: 0 for n in wrappers} | hymba_step_counts(ccfg, HYMBA_SEQ, 1))
    marks.append(("Hymba eager run and graph vs eager",
                  time.perf_counter()))

    # -- the f32 check: a 2-layer Hymba at full width, one step's loss and
    # gradients through B10's kernels against B10's plain forward and
    # backward called explicitly
    fcfg = dataclasses.replace(ccfg, compute_dtype="float32")
    fparams = tfm.init_params(0, fcfg, "cuda")
    fbatch = markov_lm_batch(TokenStreamConfig(
        vocab_size=fcfg.vocab_size, seq_len=HYMBA_SEQ,
        global_batch=HYMBA_F32_BATCH), 0, device="cuda")

    def grads():
        p = tree_map(lambda t: t.detach().requires_grad_(), fparams)
        loss = tfm.lm_loss(p, fbatch, fcfg)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(p),
                                                  allow_unused=True)
    before = {n: w.launches for n, w in wrappers.items()}
    loss_k, g_k = grads()
    got = {n: w.launches - before[n] for n, w in wrappers.items()}
    want = {n: 0 for n in wrappers} | hymba_step_counts(fcfg, HYMBA_SEQ, 1)
    check(got == want, f"[13] f32 check: launches {got}, want {want}")
    with _PlainScan(scan_ops, scan_ref):
        loss_p, g_p = grads()
    check(all(w.launches - before[n] == got[n]
              for n, w in wrappers.items()),
          "[13] the plain step launched a kernel")
    names = _leaf_names(fparams)
    check(len(names) == len(g_k), "[13] f32 check: leaf names misaligned")
    trios = [(n, a, b) for n, a, b in zip(names, g_k, g_p) if b is not None]
    check(all(a is not None for _, a, _ in trios), "[13] f32 check: a "
          "leaf the plain step reaches has no gradient through the kernels")
    tree_max = max(float(b.abs().max()) for _, _, b in trios)
    # each leaf against its own max|plain|; a leaf whose plain gradient is
    # 0 against the tree's largest
    per_leaf = sorted(((float((a - b).abs().max())
                        / (float(b.abs().max()) or tree_max), n)
                       for n, a, b in trios), reverse=True)
    worst, worst_leaf = per_leaf[0]
    loss_d = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    print(f"[13] f32 2-layer Hymba at full width, batch {HYMBA_F32_BATCH} x "
          f"{HYMBA_SEQ}: one step through B10's kernels "
          f"({got['mamba_scan_fused']} forward, "
          f"{got['mamba_scan_fused_bwd']} backward launches) against B10's "
          f"plain forward and backward: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} (relative "
          f"{loss_d:.3e}), gradients of {len(trios)} leaves, each max|d| "
          f"against its own max|plain| (the tree's {tree_max:.3e}): worst "
          f"{[(n, f'{r:.3e}') for r, n in per_leaf[:3]]} (limit "
          f"{HYMBA_GRAD_TOL})", flush=True)
    check(worst <= HYMBA_GRAD_TOL and loss_d <= HYMBA_GRAD_TOL,
          f"[13] f32 Hymba step through B10's kernels off the plain one "
          f"(worst leaf {worst_leaf})")
    hymba.update(f32_grad_ratio=worst, f32_grad_leaf=worst_leaf,
                 f32_loss_rel=loss_d)
    del fparams, fbatch, g_k, g_p, trios
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("Hymba f32 check", time.perf_counter()))
    seconds = marks[-1][1] - t_phase
    print(f"[13] phase 13 took {seconds:.1f} s: " + ", ".join(
        f"{name} {t1 - t0:.1f} s" for (_, t0), (name, t1) in zip(
            marks, marks[1:])), flush=True)
    return dict(graphed, first5=first5, last5=last5, report=rep.to_json(),
                measured_frac=measured, seconds=seconds, eager=eager,
                bitwise=bitwise, hymba=hymba)


# ---------------------------------------------------------------------------
# Phase 14: parallel and runtime on the card: the mesh paths of
# launch.steps, moe_apply_ep, the compressed all-reduces, the batch-parallel
# serve plan and the pipeline, over a one-rank NCCL mesh (one H100: NCCL
# takes no two ranks on one device, so multi-rank numerics are the CPU
# tests' over gloo).
# ---------------------------------------------------------------------------

#: The sharded train step against the unsharded one from the same params
#: and batches: PAR_STEPS steps of [13]'s model, batch and sequence; the
#: loss each step within PAR_LOSS_TOL relative, each leaf's update each
#: step within PAR_UPD_TOL of the unsharded update's largest ([13]'s accum
#: gate).
PAR_STEPS, PAR_LOSS_TOL, PAR_UPD_TOL = 3, 1e-5, 2e-2
#: DeepSeek-V2-Lite-16B's MoE layer at full width (64 experts, top-6, f32)
#: on [9]'s batch and prompt; y of moe_apply_ep within PAR_MOE_TOL of
#: max|y| of moe_apply's.  The two sum an expert's slots in batched
#: products of different slot counts (capacity per rank against per
#: dispatch group), so they round apart.
PAR_MOE_ARCH, PAR_MOE_BATCH, PAR_MOE_PROMPT, PAR_MOE_TOL = (
    "deepseek-v2-lite-16b", 4, 32, 1e-5)
#: The compressed all-reduces on Qwen2-0.5B's embedding-sized gradient.
PAR_GRAD_SHAPE, PAR_K_FRAC = (151936, 896), 0.05


def parallel_phase(torch, engine, wrappers, drive, card, vgg_spec,
                   vgg_params) -> dict:
    """Phase 14: the parallel layer on one card, over a one-rank NCCL
    mesh — the real DTensor placements, collectives and code paths.

    ``checked_mesh((1, 1))`` starts the one-rank NCCL group; a (2, 1)
    shape raises ``MeshCapacityError``.  Then, each main path with every
    launch count set to 0 just before and read just after:

    - Qwen2-0.5B at full width (24 layers, d 896, vocab 151,936; [13]'s
      batch 8 x 128): ``PAR_STEPS`` steps of the mesh train step
      (``launch.steps.make_train_step(mesh=...)``) against the unsharded
      step from the same params and batches: the loss each step within
      ``PAR_LOSS_TOL`` relative, each leaf's update within ``PAR_UPD_TOL``
      of the unsharded update's largest, every param and moment a DTensor
      under the placements ``logical_to_pspec`` resolves; both steps' ms
      (no kernel launches: the counts stay 0);
    - DeepSeek-V2-Lite-16B's MoE layer at full width with ``moe_ep``:
      ``moe_apply_ep`` on the mesh against ``moe_apply``, one all-reduce
      issued (the ep sum; ``CommDebugMode``);
    - ``quantized_psum`` and ``event_psum`` over NCCL on a gradient the
      size of Qwen2-0.5B's embedding: the quantized sum is round(x /
      scale) x scale exactly, fired + the new residual is g + the old
      residual bitwise, and the fired share is at most ``PAR_K_FRAC`` plus
      ties;
    - VGG16@224 through ``make_cnn_serve_step(spec, 8, mesh=...)``: the
      logits bitwise the mesh-less plan's, B1-B4 launched at capture as
      the route plan says;
    - ``pipeline_apply`` with one stage, bitwise the stage function.

    The group is destroyed at the end."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenStreamConfig, markov_lm_batch
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param_utils import tree_leaves
    from repro_torch.optim import (AdamWConfig, adamw_init, event_psum,
                                   quantized_psum, warmup_cosine)
    from repro_torch.parallel import pipeline_apply
    from repro_torch.parallel import sharding as sh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "[14] a process group before the phase")
    mesh = lmesh.checked_mesh((1, 1), ("data", "model"))
    check(dist.is_initialized() and dist.get_world_size() == 1
          and dist.get_backend() == "nccl" and mesh.device_type == "cuda",
          f"[14] the one-rank group: backend {dist.get_backend()}")
    try:
        lmesh.checked_mesh((2, 1), ("data", "model"))
        refused = None
    except lmesh.MeshCapacityError as exc:
        refused = str(exc)
    check(refused is not None and "only 1 exist" in refused,
          f"[14] checked_mesh((2, 1)) on one rank did not refuse: {refused}")
    print(f"[14] one-rank NCCL group started by checked_mesh((1, 1)); "
          f"(2, 1) refused: {refused}", flush=True)
    marks = [("", t_phase)]

    # -- Qwen2-0.5B: the mesh train step against the unsharded one --------
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("par", TRAIN_SEQ, TRAIN_BATCH, "train")
    opt = AdamWConfig(schedule=warmup_cosine(3e-4, 20, TRAIN_STEPS))
    ref = steps.make_train_step(cfg, shape, opt=opt, graph=False)
    plan = steps.make_train_step(cfg, shape, opt=opt, mesh=mesh)
    ds = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH)
    batches = [markov_lm_batch(ds, i, device="cuda")
               for i in range(PAR_STEPS)]
    p0 = tfm.init_params(0, cfg, "cuda")
    runs = {}
    for tag, fn in (("unsharded", ref.fn), ("mesh", plan.fn)):
        state = (p0, adamw_init(p0))
        trail, times = [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if tag == "mesh" and i == 0:
                new, _, launches, _, _ = drive(
                    lambda: fn(*state, b), capture=False)
                check_plan("[14] mesh train step", launches,
                           {n: 0 for n in wrappers})
            else:
                new = fn(*state, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            p_old = [t.full_tensor() if isinstance(t, DTensor) else t
                     for t in tree_leaves(state[0])]
            p_new = [t.full_tensor() if isinstance(t, DTensor) else t
                     for t in tree_leaves(new[0])]
            trail.append(dict(loss=float(new[2]["loss"]),
                              upd=[(a - b_).float() for a, b_ in
                                   zip(p_new, p_old)]))
            state = (new[0], new[1])
        runs[tag] = dict(trail=trail, times=times, state=state)
    m_state = runs["mesh"]["state"]
    want_pl = [tuple(pl) for pl in _leaf_lists(plan.param_placements)]
    got_pl = [tuple(t.placements) for t in tree_leaves(m_state[0])]
    check(all(isinstance(t, DTensor) for t in tree_leaves(m_state[0])
              + tree_leaves(m_state[1].mu) + tree_leaves(m_state[1].nu)),
          "[14] a param or moment of the mesh step is not a DTensor")
    check(got_pl == want_pl and [tuple(t.placements) for t in
                                 tree_leaves(m_state[1].mu)] == want_pl,
          "[14] the mesh step's leaves left their placements")
    loss_d, upd_d = [], []
    for a, b_ in zip(runs["mesh"]["trail"], runs["unsharded"]["trail"]):
        loss_d.append(abs(a["loss"] - b_["loss"]) / abs(b_["loss"]))
        upd_d.append(max(float((u - v).abs().max()) / max(
            float(v.abs().max()), 1e-30) for u, v in zip(a["upd"],
                                                          b_["upd"])))
    ms_mesh = statistics.median(runs["mesh"]["times"][1:])
    ms_ref = statistics.median(runs["unsharded"]["times"][1:])
    print(f"[14] {cfg.name} at full width, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, {PAR_STEPS} steps on the (1, 1) mesh against the "
          f"unsharded step: losses "
          f"{[round(t['loss'], 6) for t in runs['mesh']['trail']]} vs "
          f"{[round(t['loss'], 6) for t in runs['unsharded']['trail']]} "
          f"(relative {[f'{d:.2e}' for d in loss_d]}, limit {PAR_LOSS_TOL});"
          f" worst leaf update off by {[f'{d:.2e}' for d in upd_d]} of its "
          f"largest (limit {PAR_UPD_TOL}); {len(got_pl)} params and their "
          f"moments DTensors under the resolved placements (distinct: "
          f"{sorted(set(map(str, got_pl)))}); step ms mesh "
          f"{[round(t, 2) for t in runs['mesh']['times']]} (median of steps "
          f"2-{PAR_STEPS} {ms_mesh:.3f}), unsharded "
          f"{[round(t, 2) for t in runs['unsharded']['times']]} (median "
          f"{ms_ref:.3f}) (card {card})", flush=True)
    check(max(loss_d) <= PAR_LOSS_TOL and max(upd_d) <= PAR_UPD_TOL,
          "[14] the mesh train step is off the unsharded step")
    del runs, m_state, p0, batches, ref, plan
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("train", time.perf_counter()))

    # -- DeepSeek-V2-Lite's MoE layer with moe_ep ---------------------------
    mcfg = get_config(PAR_MOE_ARCH)
    mcfg = dataclasses.replace(mcfg, moe_ep=True, compute_dtype="float32",
                               moe=dataclasses.replace(
                                   mcfg.moe, capacity_factor=float(
                                       mcfg.moe.num_experts)))
    mp, maxes = moe.moe_init(0, mcfg, "cuda", with_axes=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    xm = torch.randn((PAR_MOE_BATCH, PAR_MOE_PROMPT, mcfg.d_model),
                     generator=gen, device="cuda")
    y_ref, aux_ref = moe.moe_apply(mp, xm, mcfg)
    rules = sh.make_rules(mesh)
    dmp = sh.distribute_tree(mp, maxes, mesh, rules)
    xd = distribute_tensor(xm, mesh, sh.to_placements(sh.logical_to_pspec(
        ("batch", "seq", None), tuple(xm.shape), mesh, rules), mesh),
        src_data_rank=None)

    def ep():
        with CommDebugMode() as comm, implicit_replication():
            y, aux = moe.moe_apply_ep(dmp, xd, mcfg,
                                      sc=sh.make_sharder(mesh, rules))
        return y, aux, comm
    (y_ep, aux_ep, comm), _, launches, _, ep_s = drive(ep, capture=False)
    check_plan("[14] moe_apply_ep", launches, {n: 0 for n in wrappers})
    n_ar = comm.get_comm_counts().get(torch.ops.c10d.allreduce_, 0)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    y_ep = y_ep.full_tensor()
    moe_d = float((y_ep - y_ref).abs().max()) / float(y_ref.abs().max())
    lb_d = abs(float(aux_ep["load_balance_loss"].full_tensor())
               - float(aux_ref["load_balance_loss"]))
    print(f"[14] {PAR_MOE_ARCH} MoE layer at full width ("
          f"{mcfg.moe.num_experts} experts, top-{mcfg.moe.top_k}, f32, "
          f"capacity factor {mcfg.moe.capacity_factor}), batch "
          f"{PAR_MOE_BATCH} x {PAR_MOE_PROMPT}: moe_apply_ep on the mesh "
          f"{ep_s * 1e3:.2f} ms (first call) vs moe_apply: max|d| "
          f"{moe_d:.3e} of max|y| (limit {PAR_MOE_TOL}), load-balance loss "
          f"off by {lb_d:.2e}; collectives issued {counts}", flush=True)
    check(moe_d <= PAR_MOE_TOL and lb_d <= 1e-6,
          "[14] moe_apply_ep is off moe_apply")
    check(n_ar == 1, f"[14] the ep path issued {n_ar} all-reduces, not 1")
    del mp, dmp, xm, xd, y_ref, y_ep
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("moe_ep", time.perf_counter()))

    # -- the compressed all-reduces over NCCL -------------------------------
    g = torch.randn(PAR_GRAD_SHAPE, generator=gen, device="cuda")
    res = 0.01 * torch.randn(PAR_GRAD_SHAPE, generator=gen, device="cuda")
    (q, fired, new_res), _, launches, _, comp_s = drive(
        lambda: (quantized_psum(g),) + event_psum(g, res,
                                                  k_frac=PAR_K_FRAC),
        capture=False)
    check_plan("[14] compression", launches, {n: 0 for n in wrappers})
    scale = g.abs().max() / 127.0
    check(torch.equal(q, torch.round(g / scale) * scale),
          "[14] quantized_psum is not round(x / scale) x scale")
    acc = g + res
    check(torch.equal(fired + new_res, acc),
          "[14] fired + new residual is not g + old residual bitwise")
    k = int(acc.numel() * PAR_K_FRAC)
    theta = torch.topk(acc.abs().reshape(-1), k).values[-1]
    n_fired = int((fired != 0).sum())
    ties = int((acc.abs() == theta).sum())
    check(n_fired <= k + ties - 1, f"[14] {n_fired} fired of {k} + {ties} "
          f"ties")
    q_ms = cuda_ms(torch, lambda: quantized_psum(g), 5)
    e_ms = cuda_ms(torch, lambda: event_psum(g, res, k_frac=PAR_K_FRAC), 5)
    print(f"[14] compression over NCCL on a {PAR_GRAD_SHAPE} f32 gradient: "
          f"quantized_psum == round(x / scale) x scale exactly, "
          f"{q_ms:.3f} ms; event_psum fired {n_fired} of {acc.numel()} "
          f"({n_fired / acc.numel():.4f}; k {k}, {ties} at the threshold), "
          f"fired + residual == g + old residual bitwise, {e_ms:.3f} ms "
          f"(one rank: the all-reduces move nothing) (card {card})",
          flush=True)
    del g, res, q, fired, new_res, acc
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("compression", time.perf_counter()))

    # -- VGG16@224 batch-parallel serve plan --------------------------------
    x8 = torch.relu(torch.randn((8, vgg_spec.input_size, vgg_spec.input_size,
                                 vgg_spec.in_ch), generator=gen,
                                device="cuda"))
    plan_m = steps.make_cnn_serve_step(vgg_spec, 8, mesh=mesh)
    plan_0 = steps.make_cnn_serve_step(vgg_spec, 8)
    y_m, _, raw, _, first_s = drive(
        lambda: plan_m.fn(vgg_params, x8).clone(), capture=False)
    pipe = plan_m.fn
    got = {n: pipe.graph.launches.get(w, 0) * pipe.graph.replays
           for n, w in wrappers.items()}
    check_plan("[14] vgg16@224 serve plan on the mesh (captured x "
               "replayed)", got, PLAN_F32_VGG)
    check(got == PLAN_F32_VGG, f"[14] launches {got} are not the route "
          f"plan's")
    y_0 = plan_0.fn(vgg_params, x8).clone()
    check(torch.equal(y_m, y_0), "[14] the mesh serve plan's logits are "
          "not bitwise the mesh-less plan's")
    check(plan_m.mesh is mesh and plan_m.data_shards == 1
          and str(plan_m.input_sharding) == "[Replicate(), Replicate()]",
          f"[14] serve plan on the mesh: shards {plan_m.data_shards}, input "
          f"{plan_m.input_sharding}")
    serve_ms, _ = host_ms(torch, lambda: plan_m.fn(vgg_params, x8), reps=5)
    print(f"[14] {vgg_spec.name}@{vgg_spec.input_size} batch 8 through "
          f"make_cnn_serve_step(mesh=(1, 1)): data_shards "
          f"{plan_m.data_shards}, input {plan_m.input_sharding}, logits "
          f"bitwise the mesh-less plan's; first call {first_s:.3f} s, warm "
          f"replay {serve_ms:.3f} ms (card {card})", flush=True)
    del plan_m, plan_0, pipe, y_m, y_0, x8
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("serve plan", time.perf_counter()))

    # -- pipeline_apply with one stage --------------------------------------
    pmesh = lmesh.checked_mesh((1,), ("pipe",))
    ws = 0.3 * torch.randn((1, 256, 256), generator=gen, device="cuda")
    xs = torch.randn((6, 4, 256), generator=gen, device="cuda")
    stage = lambda w, mb: torch.tanh(mb @ w)
    yp = pipeline_apply(stage, ws, xs, mesh=pmesh, axis="pipe")
    seq = torch.stack([stage(ws[0], mb) for mb in xs])
    check(torch.equal(yp, seq), "[14] pipeline_apply with one stage is not "
          "bitwise the stage function")
    print(f"[14] pipeline_apply with one stage over {tuple(xs.shape)}: "
          f"bitwise the stage function", flush=True)
    dist.destroy_process_group()
    marks.append(("pipeline", time.perf_counter()))
    seconds = marks[-1][1] - t_phase
    print(f"[14] phase 14 took {seconds:.1f} s: " + ", ".join(
        f"{name} {t1 - t0:.1f} s" for (_, t0), (name, t1) in zip(
            marks, marks[1:])), flush=True)
    return dict(seconds=seconds, step_ms=ms_mesh, ref_step_ms=ms_ref,
                loss_d=max(loss_d), upd_d=max(upd_d), moe_d=moe_d,
                q_ms=q_ms, e_ms=e_ms, serve_ms=serve_ms)


def _leaf_lists(tree) -> list:
    """The leaves of a dict tree whose leaves are lists, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_lists(v)]
    return [tree]


def lp_bytes(d, step) -> int:
    """Bytes of checkpoint ``step`` in directory ``d``."""
    sd = pathlib.Path(d) / f"step_{step:08d}"
    return sum(f.stat().st_size for f in sd.iterdir())


# ---------------------------------------------------------------------------
# Phase 15: the dry run of two production cells on this machine's torch,
# each in a subprocess started before phase 2 (on the host's CPU, the
# meta device and a fake world of 256 ranks: it needs no card).
# ---------------------------------------------------------------------------

#: The production cells (arch, shape) of phase 15, at 16x16.
DRY_CELLS = (("qwen2-1.5b", "train_4k"), ("hymba-1.5b", "train_4k"))
DRY_DIR = ROOT / "build" / "smoke_dryrun"
#: Seconds phase 15 waits for a dry run that has not ended by then.
DRY_TIMEOUT = 300


#: Phase 15's processes, which :func:`main` stops if they still run when
#: the script ends.
DRY_PROCS: list = []


def start_dryruns() -> list:
    """Start phase 15's dry runs: one ``python -m repro_torch.launch.dryrun``
    a cell, its output to ``DRY_DIR/<arch>.log``, with no card in sight
    (``CUDA_VISIBLE_DEVICES`` empty) and one thread.  Returns the
    processes."""
    import os
    import shutil
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    DRY_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    for arch, shape in DRY_CELLS:
        with open(DRY_DIR / f"{arch}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--out-dir", str(DRY_DIR)],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def dry_phase(procs, card) -> dict:
    """Phase 15, after phase 3: wait for the dry runs and check their
    records: exit 0,
    status "ok", 256 chips, a positive collective term; Hymba's B10
    calls as the plan says (``hymba_step_counts`` at 4096 tokens a row,
    one step).  Prints each record's ``format_row``, memory, collectives
    by kind and kernels, its FLOPs by aten op and its largest collectives
    by the shapes they move.  Its numbers are counts of one device's
    share, not times on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import RooflineReport, format_row

    t0 = time.perf_counter()
    out = {}
    for (arch, shape), proc in zip(DRY_CELLS, procs):
        try:
            rc = proc.wait(timeout=DRY_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at the time limit"
        log = (DRY_DIR / f"{arch}.log").read_text()
        check(rc == 0, f"[15] the dry run of {arch} {shape} exited {rc}: "
              f"{log[-3000:]}")
        rec = json.loads((DRY_DIR / f"{arch}__{shape}__16x16.json")
                         .read_text())
        check(rec["status"] == "ok", f"[15] {arch} {shape}: "
              f"{rec.get('error')} {rec.get('traceback', '')[-3000:]}")
        r = rec["roofline"]
        check(r["chips"] == 256 and r["t_collective"] > 0
              and r["hlo_gflops"] > 0, f"[15] {arch} {shape}: {r}")
        print(f"[15] {format_row(RooflineReport(**r))}", flush=True)
        print(f"[15] {arch} {shape} at 16x16 (the meta device, a fake world "
              f"of 256 ranks; counts of one device's share, not times on "
              f"the card): traced in {rec['lower_s']} s; memory "
              f"{rec['memory']}; collective bytes by kind "
              f"{rec['collectives']}; kernels by formula {rec['kernels']}",
              flush=True)
        top = sorted(rec["collective_shapes"].items(),
                     key=lambda kv: -kv[1][1])[:8]
        print(f"[15] {arch} {shape}: FLOPs by aten op "
              f"{rec['flops_by_op']}; model FLOPs a device "
              f"{r['model_gflops'] / r['chips']:.3f} GFLOP; the largest "
              f"collectives by the shapes moved [calls, bytes]: {top}",
              flush=True)
        out[arch] = rec
    want = hymba_step_counts(get_config("hymba-1.5b"), SHAPE_SEQ, 1)
    got = {n: out["hymba-1.5b"]["kernels"][n][0] for n in want}
    check(got == want, f"[15] Hymba's dry run counted B10 {got}, want "
          f"{want}")
    seconds = time.perf_counter() - t0
    print(f"[15] phase 15 waited {seconds:.1f} s for its dry runs (started "
          f"before phase 3; card {card})", flush=True)
    return dict(records=out, seconds=seconds)


#: ``train_4k``'s tokens a row.
SHAPE_SEQ = 4096


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is missing ({exc})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch from {ROOT / 'src'} "
              f"({exc}); run from a checkout of the repository",
              file=sys.stderr)
        return 2
    try:
        return run(torch)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        for proc in DRY_PROCS:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run(torch) -> int:
    import torch.nn.functional as F

    from repro_torch import engine
    from repro_torch.core import events as ev
    from repro_torch.core import quantize as qz
    from repro_torch.core.fire import FireConfig
    from repro_torch.kernels import build
    from repro_torch.kernels.event_conv import ops as conv_ops
    from repro_torch.kernels.event_conv.ops import conv_work
    from repro_torch.kernels.event_conv.ref import (event_conv_int8_ref,
                                                    event_conv_ref)
    from repro_torch.kernels.event_matmul import ops as mm_ops
    from repro_torch.kernels.event_matmul.ops import matmul_work
    from repro_torch.kernels.event_matmul.ref import (event_matmul_int8_ref,
                                                      event_matmul_ref)
    from repro_torch.kernels.event_pool import ops as pool_ops
    from repro_torch.kernels.event_pool.ops import pool_work
    from repro_torch.kernels.event_pool.ref import (event_pool_ref,
                                                    event_pool_window_ref)
    from repro_torch.kernels.fire_compact import ops as fire_ops
    from repro_torch.kernels.fire_compact.ops import fire_work
    from repro_torch.kernels.fire_compact.ref import fire_compact_ref
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_step import ops as mamba_ops
    from repro_torch.kernels.mamba_step.ref import mamba_step_events_ref
    from repro_torch.kernels.wkv6 import ops as wkv_scan_ops
    from repro_torch.kernels.wkv6_step import ops as wkv6_ops
    from repro_torch.kernels.wkv6_step.ref import wkv6_step_events_ref
    from repro_torch.models import cnn, mlp

    t_start = time.perf_counter()
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"-> {lib.relative_to(ROOT)}", flush=True)

    wrappers = {"fire_compact": fire_ops.fire_compact,
                "event_matmul": mm_ops.event_matmul,
                "event_conv": conv_ops.event_conv,
                "event_pool_window": pool_ops.event_pool_window,
                "event_pool": pool_ops.event_pool,
                "event_matmul_int8": mm_ops.event_matmul_dequant,
                "event_conv_int8": conv_ops.event_conv_dequant,
                "wkv6_step": wkv6_ops.wkv6_step_events,
                "mamba_step": mamba_ops.mamba_step_events,
                "wkv6_single": wkv_scan_ops.wkv6_single,
                "wkv6": wkv_scan_ops.wkv6,
                "mamba_scan": scan_ops.mamba_scan,
                "mamba_scan_fused": scan_ops.mamba_scan_fused,
                "mamba_scan_fused_bwd": scan_ops.mamba_scan_fused_bwd}

    def drive(fn, capture=True):
        return drive_counted(torch, engine, wrappers, fn, capture)

    def check_trace(tag, spec, recs, launches, summary):
        check(len(recs) == len(spec.layers),
              f"{tag}: {len(recs)} trace records for {len(spec.layers)} "
              f"layers")
        geometry = layer_inputs(cnn, spec, batch=4)
        strips = [(layer, shape) for (layer, shape), r in zip(geometry, recs)
                  if r["op"] == "conv2d" and r.get("strip")]
        pools = {route: [(layer, shape) for (layer, shape), r in
                         zip(geometry, recs)
                         if r["op"] == "maxpool2d" and r.get("pool_events")
                         and (r["route"] == "window") == (route == "window")]
                 for route in ("window", "event")}
        check(len(strips) == launches["event_conv"]
              + launches["event_conv_int8"]
              and len(pools["window"]) == launches["event_pool_window"]
              and len(pools["event"]) == launches["event_pool"],
              f"{tag}: trace routes disagree with the launches {launches}")
        fallbacks = [r for r in recs if r.get("fallback_decode")
                     or r.get("decode")]
        check(not fallbacks, f"{tag}: fallback_decode on the chain: "
              f"{fallbacks}")
        check(summary["densify"] == 0,
              f"{tag}: densify points: {summary['densify']}")
        routes = [(r["op"], r["route"]) for r in recs]
        print(f"{tag} trace: {len(recs)} records, routes "
              f"{sorted(set(routes))}, densify {summary['densify']}, "
              f"pool_events {summary['pool_events']}, retile "
              f"{summary['retile']}", flush=True)
        return strips, pools

    def check_int8_oracle(tag, layers, params_, x_, fires, y, oracle):
        """The int8 chain (bitwise its twin, whose fires are ``fires``)
        layer by layer against plain torch (teacher_forced: the tight
        check), then end to end against the free-running dense int8 oracle
        ``oracle(x)`` (F.conv2d / torch.matmul on its own fake-quant maps),
        which rounding ties move off the chain: printed beside how far
        noise of 1e-7 of each input value moves the oracle itself, and
        held at the 5e-3 of the CPU tests against the JAX package."""
        worst, ties = teacher_forced(torch, F, cnn, layers, params_, x_,
                                     fires, y)
        y_dense = oracle(x_)
        scale = max(float(y_dense.abs().max()), 1e-30)
        d = float((y - y_dense).abs().max())
        ratio = d / scale
        noise = torch.randn(x_.shape, device=x_.device,
                            generator=torch.Generator(
                                device=x_.device).manual_seed(1))
        moved = float((oracle(x_ * (1 + 1e-7 * noise)) - y_dense).abs().max())
        print(f"{tag}: layer by layer vs plain torch: worst {worst:.3e} of "
              f"max|plain| (limit 1e-4), every fired map the fake quant of "
              f"its accumulator, {ties} codes differ from the plain "
              f"product's (each at a rounding tie); end to end vs the "
              f"free-running dense int8 oracle: max|d| {d:.3e}, ratio "
              f"{ratio:.3e} (allclose 5e-3); noise of 1e-7 of each input "
              f"value moves that oracle by ratio {moved / scale:.3e}",
              flush=True)
        check(bool(torch.allclose(y, y_dense, atol=5e-3, rtol=5e-3)),
              f"{tag}: int8 logits off the dense int8 oracle by {d:.3e}")

    def graphed_forward(tag, pipe, p, x, y_eager, x2, eager, plan,
                        trace=None):
        """The main path: ``pipe``'s first call on ``x`` (warm-up, capture,
        one replay), every launch count set to 0 just before it and read
        just after.  Checks: the kernels of the path launched (at warm-up
        and capture) and none off it; the launches the capture saw, times
        the replays, are the route plan's; the trace records the capture
        saw (``trace``: (spec, boundary summary)); the replay is bitwise
        the eager forward ``y_eager``; a replay on a second input ``x2``
        is bitwise ``eager(x2)``, with no host sync.  Prints the capture
        seconds and the warm replay's host ms, then a profile of it.
        Returns (launches captured × replayed, warm replay ms)."""
        y, _, raw, _, first_s = drive(lambda: pipe(p, x).clone(),
                                      capture=False)
        g = pipe.graph
        got = {n: g.launches.get(w, 0) * g.replays
               for n, w in wrappers.items()}
        missing = [n for n, want in plan.items() if want and not raw[n]]
        stray = [n for n, want in plan.items() if not want and raw[n]]
        check(not missing and not stray, f"{tag} graphed: kernels of the "
              f"path never launched {missing}, off it launched {stray}")
        check_plan(f"{tag} graphed (captured x replayed)", got, plan)
        check(got == plan, f"{tag} graphed: launches at capture {got} are "
              f"not the route plan's {plan}")
        if trace is not None:
            check_trace(f"{tag} capture", trace[0], g.records, got, trace[1])
        check(torch.equal(y, y_eager), f"{tag}: the graph's replay is not "
              f"bitwise the eager forward (max|d| "
              f"{float((y - y_eager).abs().max()):.3e})")
        torch.cuda.set_sync_debug_mode("error")
        try:
            y2 = pipe(p, x2).clone()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        y2_eager = eager(x2)
        check(torch.equal(y2, y2_eager) and not torch.equal(y2, y),
              f"{tag}: the replay on a second input is not bitwise the "
              f"eager forward on it")
        ms, times = host_ms(torch, lambda: pipe(p, x), reps=5)
        print(f"{tag} pipeline (one CUDA graph): first call {first_s:.3f} s "
              f"(warm-up {g.warmup_s:.3f} s and capture {g.capture_s:.3f} "
              f"s); the replay "
              f"bitwise the eager forward on two inputs (the second with "
              f"no host sync: set_sync_debug_mode('error')); warm replay "
              f"median {ms:.3f} ms of {[round(t, 3) for t in times]} (host "
              f"clock, synchronized)", flush=True)
        profile(torch, lambda: pipe(p, x), f"{tag} graphed")
        return got, ms

    # -- 2. VGG16@224, batch 4, f32 events -----------------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    spec = cnn.VGG16
    params = cnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
    x = torch.relu(torch.randn((4, spec.input_size, spec.input_size,
                                spec.in_ch), generator=gen, device=dev))

    y_chain, recs, launches, captured, first_s = drive(
        lambda: cnn.cnn_forward(params, x, spec))
    print(f"[2] {spec.name}@{spec.input_size} batch 4 chained forward "
          f"(first, plans built): {first_s:.3f} s", flush=True)
    check_plan("[2]", launches, PLAN_F32_VGG)
    strip_convs, pools = check_trace(
        "[2]", spec, recs, launches,
        cnn.chain_boundary_summary(spec, batch=4, device=dev))
    layers = check_layer_plans("[2]", cnn, spec, 4, recs, captured)
    print(f"[2] launches by layer as fused_conv_plan / pool_plan / "
          f"pool_window_plan say: {layers}", flush=True)
    check(y_chain.shape == (4, spec.num_classes)
          and bool(torch.isfinite(y_chain).all()),
          f"logits {tuple(y_chain.shape)} not finite (4, {spec.num_classes})")
    y_rt = cnn.cnn_forward(params, x, spec, chain=False)
    bitwise = bool(torch.equal(y_chain, y_rt))
    y_dense = cnn.cnn_forward(params, x, spec, mnf=False)
    torch.cuda.synchronize()
    d_dense = float((y_chain - y_dense).abs().max())
    scale = float(y_dense.abs().max())
    ratio = d_dense / max(scale, 1e-30)
    print(f"[2] chained == round-trip bitwise: {bitwise}; max|chained - "
          f"dense| = {d_dense:.3e} (max|dense| {scale:.3e}, "
          f"ratio {ratio:.3e}, limit 1e-4)", flush=True)
    check(bitwise, "chained != round-trip bitwise")
    check(bool(torch.allclose(y_chain, y_dense, atol=5e-3, rtol=5e-3)),
          f"logits off the dense oracle by {d_dense}")
    # The 5e-3 allclose is loose against logits of ~4e-2; summation order
    # alone moves them by ~1e-7 of their scale, so a dropped or misplaced
    # event shows here.
    check(ratio <= 1e-4, f"logits off the dense oracle by {ratio:.3e} of "
          f"max|dense| (limit 1e-4)")
    fwd_ms, times = host_ms(torch, lambda: cnn.cnn_forward(params, x, spec))
    print(f"[2] warm chained forward: median {fwd_ms:.3f} ms of "
          f"{[round(t, 3) for t in times]} (host clock, synchronized)",
          flush=True)
    dense_ms = cuda_ms(torch, lambda: cnn.cnn_forward(params, x, spec,
                                                      mnf=False), 3)
    print(f"[2] dense oracle forward (F.conv2d/torch.matmul, f32): "
          f"{dense_ms:.3f} ms", flush=True)
    profile(torch, lambda: cnn.cnn_forward(params, x, spec), "[2]")
    del y_rt, y_dense
    x2 = torch.relu(torch.randn(x.shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(1)))
    pipe = cnn.make_cnn_pipeline(spec, batch=4, device=dev)
    launches_g, fwd_g_ms = graphed_forward(
        "[2]", pipe, params, x, y_chain, x2,
        lambda xin: cnn.cnn_forward(params, xin, spec), PLAN_F32_VGG,
        trace=(spec, cnn.chain_boundary_summary(spec, batch=4, device=dev)))
    del pipe

    # -- 4. VGG16@224, batch 4, int8 events -----------------------------------
    q8 = FireConfig(quantize_to_int8=True)
    y8, recs8, launches8, captured8, first_s = drive(
        lambda: cnn.cnn_forward(params, x, spec, fire_cfg=q8))
    print(f"[4] {spec.name}@{spec.input_size} batch 4 int8 chained forward "
          f"(first): {first_s:.3f} s", flush=True)
    check_plan("[4]", launches8, PLAN_INT8_VGG)
    strip_convs8, _ = check_trace(
        "[4]", spec, recs8, launches8,
        cnn.chain_boundary_summary(spec, batch=4, fire_cfg=q8, device=dev))
    check(y8.shape == (4, spec.num_classes)
          and bool(torch.isfinite(y8).all()),
          f"int8 logits {tuple(y8.shape)} not finite")
    y8_rt, fires8 = record_fires((cnn, mlp), lambda: cnn.cnn_forward(
        params, x, spec, fire_cfg=q8, chain=False))
    bitwise8 = bool(torch.equal(y8, y8_rt))
    print(f"[4] int8 chained == fake-quant round trip bitwise: {bitwise8}",
          flush=True)
    check(bitwise8, "int8 chained != fake-quant round trip bitwise")
    check_int8_oracle("[4] int8", spec.layers, params, x, fires8, y8,
                      lambda xin: cnn.cnn_forward(params, xin, spec,
                                                  fire_cfg=q8, mnf=False))
    del y8_rt, fires8
    gap = float((y8 - y_chain).abs().max())
    f32_max = float(y_chain.abs().max())
    print(f"[4] max|int8 - f32 chained| = {gap:.3e} (max|f32| "
          f"{f32_max:.3e}, ratio {gap / max(f32_max, 1e-30):.3e})",
          flush=True)
    fwd8_ms, times = host_ms(
        torch, lambda: cnn.cnn_forward(params, x, spec, fire_cfg=q8))
    print(f"[4] warm int8 chained forward: median {fwd8_ms:.3f} ms of "
          f"{[round(t, 3) for t in times]}; f32 chained {fwd_ms:.3f} ms, "
          f"dense {dense_ms:.3f} ms", flush=True)
    profile(torch, lambda: cnn.cnn_forward(params, x, spec, fire_cfg=q8),
            "[4]")
    pipe = cnn.make_cnn_pipeline(spec, batch=4, fire_cfg=q8, device=dev)
    launches8_g, fwd8_g_ms = graphed_forward(
        "[4]", pipe, params, x, y8, x2,
        lambda xin: cnn.cnn_forward(params, xin, spec, fire_cfg=q8),
        PLAN_INT8_VGG, trace=(spec, cnn.chain_boundary_summary(
            spec, batch=4, fire_cfg=q8, device=dev)))
    del pipe

    # -- 5. LeNet-300-100, batch 128, f32 and int8 ----------------------------
    lenet = mlp.LENET_300_100
    mparams = mlp.init_mlp_params(lenet, gen, weight_sparsity=0.5)
    xm = torch.randn((128, lenet.in_features), generator=gen,
                     device=dev).abs()
    xm = xm * (torch.rand(xm.shape, generator=gen, device=dev) > 0.8)
    gen2 = torch.Generator(device=dev).manual_seed(1)
    xm2 = torch.randn(xm.shape, generator=gen2, device=dev).abs() \
        * (torch.rand(xm.shape, generator=gen2, device=dev) > 0.8)
    ym_dense = mlp.mlp_forward(mparams, xm, lenet, mnf=False)
    ym = {}
    captured_mlp = {name: [] for name in wrappers}
    for mode, fire_cfg, plan in (("f32", FireConfig(), PLAN_F32_MLP),
                                 ("int8", q8, PLAN_INT8_MLP)):
        tag = f"[5] {mode}"
        y, recs_m, launches_m, caps, _ = drive(
            lambda: mlp.mlp_forward(mparams, xm, lenet, fire_cfg=fire_cfg))
        for name, calls in caps.items():
            captured_mlp[name] += calls
        check_plan(tag, launches_m, plan)
        check(not any(r.get("fallback_decode") or r.get("decode")
                      for r in recs_m), f"{tag}: fallback on the chain")
        check(y.shape == (128, 10) and bool(torch.isfinite(y).all()),
              f"{tag}: logits {tuple(y.shape)} not finite")
        y_rt, fires_m = record_fires((cnn, mlp), lambda: mlp.mlp_forward(
            mparams, xm, lenet, fire_cfg=fire_cfg, chain=False))
        check(torch.equal(y, y_rt), f"{tag}: chained != round trip bitwise")
        d = float((y - ym_dense).abs().max())
        if mode == "f32":
            check(bool(torch.allclose(y, ym_dense, atol=2e-4, rtol=2e-4)),
                  f"{tag}: logits off the dense oracle by {d:.3e}")
        else:
            check_int8_oracle(tag, [cnn.FCSpec(n) for n in lenet.widths],
                              mparams, xm, fires_m, y,
                              lambda xin: mlp.mlp_forward(
                                  mparams, xin, lenet, fire_cfg=q8,
                                  mnf=False))
        ms, _ = host_ms(torch, lambda: mlp.mlp_forward(
            mparams, xm, lenet, fire_cfg=fire_cfg), reps=5)
        print(f"{tag}: {lenet.name} batch 128 chained == round trip "
              f"bitwise: True; max|chained - f32 dense| {d:.3e} (max|dense| "
              f"{float(ym_dense.abs().max()):.3e}); warm forward median "
              f"{ms:.3f} ms", flush=True)
        pipe = mlp.make_mlp_pipeline(lenet, batch=128, fire_cfg=fire_cfg,
                                     device=dev)
        _, ms_g = graphed_forward(
            tag, pipe, mparams, xm, y, xm2,
            lambda xin: mlp.mlp_forward(mparams, xin, lenet,
                                        fire_cfg=fire_cfg), plan)
        ym[mode] = (y, ms, ms_g)
        del pipe
    mlp_dense_ms, _ = host_ms(torch, lambda: mlp.mlp_forward(
        mparams, xm, lenet, mnf=False), reps=5)
    print(f"[5] dense oracle forward {mlp_dense_ms:.3f} ms; max|int8 - f32 "
          f"chained| {float((ym['int8'][0] - ym['f32'][0]).abs().max()):.3e}",
          flush=True)
    profile(torch, lambda: mlp.mlp_forward(mparams, xm, lenet,
                                           fire_cfg=q8), "[5] int8")

    # -- 8. the serving tier: VGG16@224 and LeNet-300-100 --------------------
    served = dict(
        vgg16=serve_net(torch, drive, wrappers, "[8] vgg16@224", spec, params,
                        PLAN_F32_VGG, lambda xin: cnn.cnn_forward(
                            params, xin, spec, mnf=False), seed=8,
                        eager=lambda xin: cnn.cnn_forward(params, xin, spec)),
        lenet=serve_net(torch, drive, wrappers, "[8] lenet", lenet, mparams,
                        PLAN_F32_MLP, lambda xin: mlp.mlp_forward(
                            mparams, xin, lenet, mnf=False), seed=9))
    served["vgg16"]["run_stats"] = serve_stats(
        torch, "[8] vgg16@224",
        lambda p, xin: cnn.run_with_stats(p, xin, spec), params,
        served["vgg16"]["first"][None].to(dev),
        lambda xin: cnn.cnn_forward(params, xin, spec))
    served["lenet"]["run_stats"] = serve_stats(
        torch, "[8] lenet",
        lambda p, xin: mlp.run_mlp_with_stats(p, xin, lenet), mparams,
        served["lenet"]["first"][None].to(dev),
        lambda xin: mlp.mlp_forward(mparams, xin, lenet))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[8] engines freed: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
          f"reserved on the card", flush=True)

    # -- 6. RWKV6-7B at full width, served ----------------------------------
    rwkv = serve_lm(torch, engine, wrappers, "rwkv6-7b", wkv6_step_events_ref)

    # -- 7. Hymba-1.5B at full width, served (RWKV6-7B's weights freed) ------
    hymba = serve_lm(torch, engine, wrappers, "hymba-1.5b",
                     mamba_step_events_ref)

    # -- 9. the attention decoder stack (Hymba-1.5B's weights freed) ---------
    stack = stack_phase(torch, engine, wrappers)

    # -- 10. whisper-base and phi-3-vision (phase 9's weights freed) ---------
    encdec = encdec_phase(torch, engine, wrappers, card)

    # -- 11. the scalar oracle (the paper's Algorithms 1 and 2) ---------------
    scalar = scalar_phase(torch, engine, wrappers, card)

    # -- 12. AlexNet@224 served, priced, and routed adaptively ----------------
    alex = alexnet_phase(torch, engine, wrappers, drive, card)
    print(json.dumps({"alexnet_launches": {
        "per_bucket": {b: v["launches"] for b, v in
                       alex["per_bucket"].items()}}}), flush=True)

    # -- 13. training Qwen2-0.5B at full width, and its roofline -----------
    trained = train_phase(torch, engine, wrappers, card)

    # -- 14. parallel and runtime over a one-rank NCCL mesh -----------------
    par = parallel_phase(torch, engine, wrappers, drive, card, spec, params)

    # -- 15. the dry run of two production cells, on the host's CPU while
    # phase 3 times the kernels from CUDA graphs; read after phase 3 -------
    DRY_PROCS.extend(start_dryruns())

    # -- 3. kernel checks on the captured inputs ------------------------------
    results = []
    # the main paths' counts: captured x replayed (the graphed forwards'
    # first calls; phases 6 and 7's graphed serves)
    launched = {**{n: launches_g[n] for n in wrappers},
                "event_matmul_int8": launches8_g["event_matmul_int8"],
                "event_conv_int8": launches8_g["event_conv_int8"],
                "wkv6_step": rwkv["launches"],
                "mamba_step": hymba["launches"],
                "wkv6_single": rwkv["wkv6_single_launches"],
                "wkv6": rwkv["wkv6_launches"],
                "mamba_scan": hymba["streams_launches"],
                "mamba_scan_fused": hymba["scan_launches"],
                "mamba_scan_fused_bwd": trained["hymba"]["bwd_launches"]}

    def unique(calls):
        """The first captured call of each distinct shape."""
        seen = {}
        for args, kw in calls:
            seen.setdefault(call_shape(torch, args, kw), (args, kw))
        return list(seen.values())

    def heaviest(items, work):
        """(bound, item) of the item with the largest bound."""
        return max(((bound_ms(*work(item)), item) for item in items),
                   key=lambda t: t[0][0])

    def close(y, ref, what):
        d = float((y - ref).abs().max())
        check(d <= 1e-4 * max(float(ref.abs().max()), 1e-30),
              f"{what}: max|d| {d:.3e} over 1e-4 * max|ref|")
        return d

    def dense_nchw(a_vals, a_idx, nkb, shape):
        """The NCHW map an event tensor holds; padding slots hold zeros, so
        every slot decodes."""
        g, e, bm, bk = a_vals.shape
        full = torch.full((g,), e, dtype=torch.int32, device=a_vals.device)
        rows = ev.decode_block_events(ev.BlockEvents(a_vals, a_idx, full, nkb),
                                      blk_m=bm, blk_k=bk, m=g * bm,
                                      k=nkb * bk)
        b_, h, w_, c = shape
        check(rows.shape[0] == b_ * h * w_, f"{rows.shape[0]} event rows "
              f"for a {shape} map")
        return rows[:, :c].reshape(shape).permute(0, 3, 1, 2).contiguous()

    def report(name, err, ms, plain_ms, lib_ms, b, extra="", launches=None,
               shape=None, **keys):
        src, replaces = KERNELS[name]
        results.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launched[name] if launches is None else launches,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b[0],
            bound_by=b[1], library_ms=lib_ms,
            **({} if shape is None else {"shape": shape}), **keys))
        lib = "none (no single PyTorch call computes it)" if lib_ms is None \
            else f"{lib_ms:.4f} ms"
        print(f"[3] {name}: max_abs_err {err:.3e}, {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, library {lib}, bound "
              f"{b[0]:.4f} ms ({b[1]}){extra}", flush=True)

    def dq(a_vals, scale, zero_point):
        return qz.dequantize(a_vals, qz.QParams(scale, zero_point))

    def per_launch_ms(name, kern, calls, label):
        """Graph-time ``kern`` at every launch of one f32 VGG16 forward;
        print ms a launch shape and the sum a forward."""
        by_shape: dict[str, list] = {}
        for args, kw in calls:
            ms = graph_ms(torch, lambda: kern(*args, **kw), 20)
            by_shape.setdefault(label(args, kw), []).append(ms)
        for key, times in by_shape.items():
            print(f"[3] {name} at {key}: x{len(times)}, "
                  + ", ".join(f"{t:.4f}" for t in times) + " ms",
                  flush=True)
        total = sum(sum(t) for t in by_shape.values())
        print(f"[3] {name}: {total:.4f} ms a VGG16 forward, summed over "
              f"its {len(calls)} launches (graph-timed)", flush=True)
        return total

    # B1 fire_compact: fired and occupancy exact, every launch of VGG16 and
    # LeNet-300-100
    fires = captured["fire_compact"] + captured_mlp["fire_compact"]
    for (acc,), kw in fires:
        f1, o1 = fire_ops.fire_compact(acc, **kw)
        f2, o2 = fire_compact_ref(acc, **kw)
        check(torch.equal(f1, f2) and torch.equal(o1, o2),
              f"fire_compact != plain at {tuple(acc.shape)} {kw}")
    fire_forward_ms = per_launch_ms(
        "fire_compact", fire_ops.fire_compact, captured["fire_compact"],
        lambda args, kw: f"acc {tuple(args[0].shape)} tile "
        f"({kw['blk_m']}, {kw['blk_k']})")
    b, ((acc,), kw) = heaviest(
        fires,
        lambda c: (c[0][0].numel() * 8 + c[0][0].numel()
                   // (c[1]["blk_m"] * c[1]["blk_k"]) * 4,
                   float(c[0][0].numel())))
    report("fire_compact", 0.0,
           graph_ms(torch, lambda: fire_ops.fire_compact(acc, **kw), 20),
           cuda_ms(torch, lambda: fire_compact_ref(acc, **kw), 3),
           graph_ms(torch, lambda: torch.relu(acc), 20), b,
           f" at acc {tuple(acc.shape)}, "
           f"{len(captured['fire_compact'])} VGG16 + "
           f"{len(captured_mlp['fire_compact'])} LeNet launches checked "
           f"exact; {fire_forward_ms:.4f} ms a forward",
           per_forward_ms=fire_forward_ms)

    # B2 event_matmul and B5 event_matmul_int8, at every shape VGG16 and
    # LeNet-300-100 gave them (LeNet's N = 10 head is narrower than one
    # CTA's columns): against the plain version and against torch.matmul
    # on the decoded (dequantized) map, each within 1e-4 * max|ref|; B5
    # also bitwise B2 on the dequantized tiles.  Then each at two shapes:
    # FC1 (the heaviest by its byte bound) and the per-tap conv shape with
    # the largest summed time a forward (every VGG16 shape graph-timed,
    # times its launches).
    def decoded(a_vals, a_idx, counts, w):
        g, e, bm, bk = a_vals.shape
        return ev.decode_block_events(
            ev.BlockEvents(a_vals, a_idx, counts, w.shape[0] // bk),
            blk_m=bm, blk_k=bk, m=g * bm, k=w.shape[0])

    def by_shape(calls, trace_recs):
        """The forward's B2/B5 launches grouped by shape: {shape: [route,
        launches, args]}, route "per-tap" or "fc" from the trace record
        each launch belongs to (a per-tap conv launches k*k, an FC one)."""
        groups, it = {}, iter(calls)
        for r in trace_recs:
            if r["op"] == "conv2d" and r.get("chained") \
                    and not r.get("strip"):
                route, n = "per-tap", r["launches"]
            elif r["op"] == "linear":
                route, n = "fc", 1
            else:
                continue
            for _ in range(n):
                args, kw = next(it)
                key = (tuple(args[0].shape), tuple(args[-1].shape))
                groups.setdefault(key, [route, 0, args])[1] += 1
        check(next(it, None) is None, "B2/B5 launches the trace does not "
              "account for")
        return groups

    def shape_str(args):
        return f"a_vals {tuple(args[0].shape)} x W {tuple(args[-1].shape)}"

    def matmul_shapes(name, kern, groups, work):
        """Graph-time ``kern`` at each shape of ``groups``; print ms, ms x
        launches, the bound and their sum a forward; return the per-tap
        shape with the largest summed ms (its launches, its inputs)."""
        rows, total = [], 0.0
        for key, (route, n, args) in groups.items():
            ms = graph_ms(torch, lambda: kern(*args), 10)
            total += ms * n
            rows.append((ms * n, route, n, ms, args))
            b = bound_ms(*work(args))
            print(f"[3] {name} at {shape_str(args)} ({route}, x{n} a "
                  f"forward): {ms:.4f} ms, x{n} = {ms * n:.4f} ms, bound "
                  f"{b[0]:.4f} ms ({b[1]})", flush=True)
        print(f"[3] {name}: {total:.4f} ms a VGG16 forward, summed over its "
              f"{sum(r[2] for r in rows)} launches (graph-timed)",
              flush=True)
        _, _, n, _, args = max((r for r in rows if r[1] == "per-tap"),
                               key=lambda r: r[0])
        return n, args

    worst = 0.0
    mm_calls = unique(captured["event_matmul"])
    mm_mlp = unique(captured_mlp["event_matmul"])
    mm_calls += mm_mlp
    for args, _ in mm_calls:
        what = f"event_matmul at {tuple(args[0].shape)}x{tuple(args[3].shape)}"
        y = mm_ops.event_matmul(*args)
        worst = max(worst, close(y, event_matmul_ref(*args), what))
        close(y.reshape(-1, y.shape[-1]), decoded(*args) @ args[3],
              what + " vs torch.matmul")
    f32_work = lambda a: matmul_work(*a)  # noqa: E731
    n_tap, tap_args = matmul_shapes(
        "event_matmul", mm_ops.event_matmul,
        by_shape(captured["event_matmul"], recs), f32_work)
    args = heaviest(mm_calls, lambda c: f32_work(c[0]))[1][0]
    for name, a, n in (("event_matmul", args, None),
                       ("event_matmul_per_tap", tap_args, n_tap)):
        dense_a = decoded(*a)
        report(name, worst,
               graph_ms(torch, lambda: mm_ops.event_matmul(*a), 10),
               cuda_ms(torch, lambda: event_matmul_ref(*a), 1),
               graph_ms(torch, lambda: torch.matmul(dense_a, a[3]), 10),
               bound_ms(*f32_work(a)),
               f" at {shape_str(a)}, {len(mm_calls) - len(mm_mlp)} VGG16 + "
               f"{len(mm_mlp)} LeNet shapes checked", launches=n,
               shape=shape_str(a))
        del dense_a

    worst = 0.0
    mm8_calls = unique(captured8["event_matmul_int8"])
    mm8_mlp = unique(captured_mlp["event_matmul_int8"])
    mm8_calls += mm8_mlp
    for args, _ in mm8_calls:
        a_vals, a_idx, counts, sc, zp, w = args
        what = (f"event_matmul_int8 at {tuple(a_vals.shape)}x"
                f"{tuple(w.shape)}")
        y = mm_ops.event_matmul_dequant(*args)
        worst = max(worst, close(y, event_matmul_int8_ref(*args), what))
        check(torch.equal(y, mm_ops.event_matmul(dq(a_vals, sc, zp), a_idx,
                                                 counts, w)),
              what + ": != event_matmul on the dequantized tiles")
        close(y.reshape(-1, y.shape[-1]),
              decoded(dq(a_vals, sc, zp), a_idx, counts, w) @ w,
              what + " vs torch.matmul")
    int8_work = lambda a: matmul_work(*a[:3], a[5], qbytes=8)  # noqa
    n_tap8, tap8_args = matmul_shapes(
        "event_matmul_int8", mm_ops.event_matmul_dequant,
        by_shape(captured8["event_matmul_int8"], recs8), int8_work)
    args = heaviest(mm8_calls, lambda c: int8_work(c[0]))[1][0]
    for name, a, n in (("event_matmul_int8", args, None),
                       ("event_matmul_int8_per_tap", tap8_args, n_tap8)):
        dense_a = decoded(dq(*a[:1], *a[3:5]), *a[1:3], a[5])
        report(name, worst,
               graph_ms(torch, lambda: mm_ops.event_matmul_dequant(*a), 10),
               cuda_ms(torch, lambda: event_matmul_int8_ref(*a), 1),
               graph_ms(torch, lambda: torch.matmul(dense_a, a[5]), 10),
               bound_ms(*int8_work(a)),
               f" at codes {tuple(a[0].shape)} x W {tuple(a[5].shape)}, "
               f"{len(mm8_calls) - len(mm8_mlp)} VGG16 + {len(mm8_mlp)} "
               f"LeNet shapes checked", launches=n, shape=shape_str(a))
        del dense_a

    # B3 event_conv and B6 event_conv_int8: the strip layers against the
    # plain version and F.conv2d, then stride 4 and stride 2
    def conv_oihw(ws, k, ci):
        return ws.reshape(k, k, ws.shape[0] // (k * k), -1)[:, :, :ci] \
            .permute(3, 2, 0, 1).contiguous()

    def check_convs(name, kern, ref, layers, calls):
        """Each captured strip conv against its plain version and F.conv2d
        (on the dequantized map for B6); returns (worst, checked)."""
        worst = 0.0
        checked = list(zip(layers, calls))
        for (layer, shape), (args, kw) in checked:
            check(kw["row_stride"] == layer.stride, f"{layer} ran at {kw}")
            what = f"{name} at {shape} k{layer.k}s{layer.stride}"
            y = kern(*args, **kw)
            worst = max(worst, close(y, ref(*args, **kw), what))
            if name == "event_conv_int8":
                a32 = dq(args[0], *args[6:8])
                args = (a32, *args[1:6], args[8])
                check(torch.equal(y, conv_ops.event_conv(*args, **kw)),
                      what + ": != event_conv on the dequantized tiles")
            ref2 = F.conv2d(dense_nchw(args[0], args[1], kw["nkb"], shape),
                            conv_oihw(args[6], layer.k, shape[3]),
                            stride=layer.stride, padding=layer.padding)
            co = ref2.shape[1]
            close(y.reshape(-1, co)[:ref2.numel() // co],
                  ref2.permute(0, 2, 3, 1).reshape(-1, co),
                  what + " vs F.conv2d")
        return worst, checked

    def other_strides(name, int8):
        if int8:
            kern, ref = conv_ops.event_conv_dequant, event_conv_int8_ref
        else:
            kern, ref = conv_ops.event_conv, event_conv_ref
        for layer, shape, args, kw in strided_conv_inputs(
                torch, gen, int8):
            k, s = layer.k, layer.stride
            d = close(kern(*args, **kw), ref(*args, **kw),
                      f"{name} at {shape} k{k}s{s}")
            ms = graph_ms(torch, lambda: kern(*args, **kw), 5)
            print(f"[3] {name} stride {s} (k{k}, input {shape}): "
                  f"max_abs_err {d:.3e}, {ms:.4f} ms", flush=True)

    def conv_layers(name, kern, checked, work):
        """Graph-time ``kern`` at each strip layer of a forward; print ms
        and the bound a layer and their sum a forward."""
        total = 0.0
        for (layer, shape), (args, kw) in checked:
            ms = graph_ms(torch, lambda: kern(*args, **kw), 10)
            total += ms
            b = bound_ms(*work(args, layer.stride))
            print(f"[3] {name} at {shape} k{layer.k}s{layer.stride} -> "
                  f"{layer.out_ch}: {ms:.4f} ms, bound {b[0]:.4f} ms "
                  f"({b[1]})", flush=True)
        print(f"[3] {name}: {total:.4f} ms a VGG16 forward, summed over "
              f"its {len(checked)} launches (graph-timed)", flush=True)
        return total

    worst, convs = check_convs("event_conv", conv_ops.event_conv,
                               event_conv_ref, strip_convs,
                               captured["event_conv"])
    other_strides("event_conv", False)
    conv_forward_ms = conv_layers(
        "event_conv", conv_ops.event_conv, convs,
        lambda a, s: conv_work(a, s))
    b, ((layer, shape), (args, kw)) = heaviest(
        convs, lambda c: conv_work(c[1][0], c[0][0].stride))
    x_nchw = dense_nchw(args[0], args[1], kw["nkb"], shape)
    w_oihw = conv_oihw(args[6], layer.k, shape[3])
    report("event_conv", worst,
           graph_ms(torch, lambda: conv_ops.event_conv(*args, **kw), 10),
           cuda_ms(torch, lambda: event_conv_ref(*args, **kw), 1),
           graph_ms(torch, lambda: F.conv2d(x_nchw, w_oihw,
                                           stride=layer.stride,
                                           padding=layer.padding), 10), b,
           f" at {shape} -> {layer.out_ch} ch, {len(convs)} layers "
           f"checked; {conv_forward_ms:.4f} ms a forward",
           shape=f"{shape} -> {layer.out_ch}",
           per_forward_ms=conv_forward_ms)
    del x_nchw

    # strip == per-tap on the card (DESIGN.md §6): conv3_1's input map, as
    # the forward handed it to B3, encoded as strips and as pixels; the
    # strip route (B3 x 1) and the per-tap route (B2 x 9) must agree bitwise
    geometry = layer_inputs(cnn, spec, batch=4)
    (layer, shape), (args, kw) = next(c for c in convs
                                      if c[0][1] == (4, 56, 56, 128))
    x_map = dense_nchw(args[0], args[1], kw["nkb"], shape).permute(0, 2, 3, 1)
    w_layer = params[geometry.index((layer, shape))]
    streams = [engine.EventStream.encode_nhwc(x_map.contiguous(), blk_k=8,
                                              blk_m=bm, keep_dense=False)
               for bm in (ev.STRIP_W, 1)]
    counts0 = (conv_ops.event_conv.launches, mm_ops.event_matmul.launches)
    ys, yp = (engine.conv2d(st, w_layer, cfg=engine.EngineConfig(blk_k=8),
                            stride=layer.stride, padding=layer.padding)
              for st in streams)
    ran = (conv_ops.event_conv.launches - counts0[0],
           mm_ops.event_matmul.launches - counts0[1])
    check(ran == (1, layer.k ** 2), f"strip vs per-tap launched {ran}")
    check(torch.equal(ys, yp), f"strip != per-tap on conv3_1's input "
          f"{shape}: max|d| {float((ys - yp).abs().max()):.3e}")
    print(f"[3] strip == per-tap on conv3_1's input {shape} -> "
          f"{layer.out_ch} ch: B3 x1 and B2 x{layer.k ** 2} bitwise equal",
          flush=True)
    del x_map, streams, ys, yp

    # B6: the int8 forward's strip convs past conv1_1 (which takes the f32
    # input through B3)
    worst, convs8 = check_convs("event_conv_int8", conv_ops.event_conv_dequant,
                                event_conv_int8_ref, strip_convs8[1:],
                                captured8["event_conv_int8"])
    other_strides("event_conv_int8", True)
    conv8_forward_ms = conv_layers(
        "event_conv_int8", conv_ops.event_conv_dequant, convs8,
        lambda a, s: conv_work((*a[:6], a[8]), s, qbytes=8))
    b, ((layer, shape), (args, kw)) = heaviest(
        convs8, lambda c: conv_work(
            (*c[1][0][:6], c[1][0][8]), c[0][0].stride, qbytes=8))
    x_nchw = dense_nchw(dq(args[0], *args[6:8]), args[1], kw["nkb"], shape)
    w_oihw = conv_oihw(args[8], layer.k, shape[3])
    report("event_conv_int8", worst,
           graph_ms(torch, lambda: conv_ops.event_conv_dequant(*args, **kw),
                   10),
           cuda_ms(torch, lambda: event_conv_int8_ref(*args, **kw), 1),
           graph_ms(torch, lambda: F.conv2d(x_nchw, w_oihw,
                                           stride=layer.stride,
                                           padding=layer.padding), 10), b,
           f" at {shape} -> {layer.out_ch} ch, {len(convs8)} layers "
           f"checked; {conv8_forward_ms:.4f} ms a forward",
           shape=f"{shape} -> {layer.out_ch}",
           per_forward_ms=conv8_forward_ms)
    del x_nchw

    # B4 pools: exact against the plain version and F.max_pool2d
    for name, route, kern, ref in (
            ("event_pool_window", "window", pool_ops.event_pool_window,
             event_pool_window_ref),
            ("event_pool", "event", pool_ops.event_pool, event_pool_ref)):
        items = []
        for (layer, shape), (args, kw) in zip(pools[route], captured[name]):
            y = kern(*args, **kw)
            items.append(((layer, shape), (args, kw), y.numel()))
            check(torch.equal(y, ref(*args, **kw)),
                  f"{name} != plain at {shape}")
            pooled = F.max_pool2d(dense_nchw(args[0], args[1], kw["nkb"],
                                             shape), layer.k, layer.stride)
            c = shape[3]
            check(torch.equal(y.reshape(-1, y.shape[-2] * y.shape[-1])[:, :c],
                              pooled.permute(0, 2, 3, 1).reshape(-1, c)),
                  f"{name} != F.max_pool2d at {shape}")
        pool_forward_ms = per_launch_ms(
            name, kern, captured[name],
            lambda args, kw: f"events {tuple(args[0].shape)} plan "
            f"{tuple(args[3].shape)}")
        b, ((layer, shape), (args, kw), _) = heaviest(
            items, lambda c: pool_work(c[1][0][0], c[1][0][4], c[2]))
        x_nchw = dense_nchw(args[0], args[1], kw["nkb"], shape)
        report(name, 0.0,
               graph_ms(torch, lambda: kern(*args, **kw), 20),
               cuda_ms(torch, lambda: ref(*args, **kw), 2),
               graph_ms(torch, lambda: F.max_pool2d(x_nchw, layer.k,
                                                   layer.stride), 20), b,
               f" at {shape}, {len(items)} layers checked exact; "
               f"{pool_forward_ms:.4f} ms a forward",
               per_forward_ms=pool_forward_ms)
        del x_nchw

    # phase 8's bucket-128 launches (served VGG16@224, a full bucket of
    # 128) and phase 12's (AlexNet@224, the eager bucket-8 forward): each
    # kernel of the path against its plain version, timed beside its bound
    replays = {
        "fire_compact": (fire_ops.fire_compact, fire_compact_ref, True,
                         lambda a, kw, y: fire_work(a[0], **kw)),
        "event_matmul": (mm_ops.event_matmul, event_matmul_ref, False,
                         lambda a, kw, y: matmul_work(*a)),
        "event_conv": (conv_ops.event_conv, event_conv_ref, False,
                       lambda a, kw, y: conv_work(a, kw["row_stride"])),
        "event_pool_window": (pool_ops.event_pool_window,
                              event_pool_window_ref, True,
                              lambda a, kw, y: pool_work(a[0], a[4],
                                                         y.numel())),
        "event_pool": (pool_ops.event_pool, event_pool_ref, True,
                       lambda a, kw, y: pool_work(a[0], a[4], y.numel())),
    }

    def replay(name, args, kw, what):
        """One kept launch against its plain version (exact, or within
        1e-4 * max|plain|), graph-timed beside its bound and the plain
        version's time."""
        kern, ref, exact, work = replays[name]
        args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                     for a in args)
        y, want = kern(*args, **kw), ref(*args, **kw)
        if exact:
            check(all(torch.equal(u, v) for u, v in zip(
                y if isinstance(y, tuple) else (y,),
                want if isinstance(want, tuple) else (want,))),
                  f"{what}: != plain")
            err = 0.0
        else:
            err = close(y, want, what)
        if name == "event_matmul":
            close(y.reshape(-1, y.shape[-1]), decoded(*args) @ args[3],
                  what + " vs torch.matmul")
        b = bound_ms(*work(args, kw, y[0] if isinstance(y, tuple) else y))
        shape = shape_str(args) if name == "event_matmul" \
            else str(tuple(args[0].shape))
        return dict(shape=shape, max_abs_err=err,
                    ms=graph_ms(torch, lambda: kern(*args, **kw), 10),
                    plain_ms=cuda_ms(torch, lambda: ref(*args, **kw), 1),
                    bound_ms=b[0], bound_by=b[1])

    for name in replays:
        args, kw = served["vgg16"]["bucket128"][name]
        what = f"{name} at bucket 128, {tuple(args[0].shape)}"
        r = replay(name, args, kw, what)
        entry = next(e for e in results if e["name"] == name)
        entry["serve128"] = r
        print(f"[3] {what} (phase 8's full bucket of 128, its heaviest "
              f"launch): max_abs_err {r['max_abs_err']:.3e}"
              f"{' (exact)' if replays[name][2] else ''}, {r['ms']:.4f} "
              f"ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

    for name, kept in alex["kept"].items():
        rows, total = [], 0.0
        for args, kw, n in kept:
            what = f"{name} at AlexNet@224 bucket 8, {tuple(args[0].shape)}"
            r = replay(name, args, kw, what)
            rows.append(dict(r, launches=n))
            total += r["ms"] * n
            print(f"[3] {what} (phase 12, x{n} a forward): max_abs_err "
                  f"{r['max_abs_err']:.3e}"
                  f"{' (exact)' if replays[name][2] else ''}, {r['ms']:.4f} "
                  f"ms, x{n} = {r['ms'] * n:.4f} ms, plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})", flush=True)
        print(f"[3] {name}: {total:.4f} ms an AlexNet@224 bucket-8 forward, "
              f"its {sum(r['launches'] for r in rows)} launches at "
              f"{len(rows)} shapes (each shape's kept launch graph-timed, "
              f"times its launches; card {card})", flush=True)
        entry = next(e for e in results if e["name"] == name)
        entry["alexnet224"] = dict(shapes=rows, per_forward_ms=total)

    long_ms = lm_kernels(torch, rwkv, hymba, report, close)
    scan_bwd_kernel(torch, trained["hymba"], report, close)
    entry = next(e for e in results if e["name"] == "mamba_scan_fused")
    entry["train_launches"] = trained["hymba"]["fwd_launches"]
    dry = dry_phase(DRY_PROCS, card)

    print(f"[done] {time.perf_counter() - t_start:.1f} s in all; warm "
          f"forwards eager (graphed): VGG16 f32 {fwd_ms:.3f} ({fwd_g_ms:.3f})"
          f" ms, int8 {fwd8_ms:.3f} ({fwd8_g_ms:.3f}) ms, dense "
          f"{dense_ms:.3f} ms; LeNet-300-100 f32 {ym['f32'][1]:.3f} "
          f"({ym['f32'][2]:.3f}) ms, int8 {ym['int8'][1]:.3f} "
          f"({ym['int8'][2]:.3f}) ms, dense {mlp_dense_ms:.3f} ms; batch "
          f"{LM_BATCH}, eager (graphed): "
          + "; ".join(
              f"{arch} prefill {r['prefill_ms']:.3f} "
              f"({r['prefill_ms_graph']:.3f}) ms, decode tokens/s "
              + ", ".join(f"{n} {t:.1f} ({r['tok_s_graph'][n]:.1f})"
                          for n, t in r["tok_s"].items())
              for arch, r in (("RWKV6-7B", rwkv), ("Hymba-1.5B", hymba)))
          + f"; prefill at prompt {LM_LONG}: RWKV6-7B "
          f"{rwkv['long_ms']:.3f} ({rwkv['long_ms_graph']:.3f}) ms, "
          f"Hymba-1.5B {hymba['long_ms']:.3f} ({hymba['long_ms_graph']:.3f})"
          f" ms; "
          f"one layer's scan at prompt {LM_LONG}: B9' "
          f"{long_ms['wkv_long_ms']:.4f} ms, B10 "
          f"{long_ms['scan_long_ms']:.4f} ms (its streams entry "
          f"{long_ms['scan_streams_long_ms']:.4f} ms); batch {LM_BATCH}, "
          f"eager (graphed) decode tokens/s, gated θ=0: "
          + "; ".join(
              f"{arch} {stack[arch]['best'][('gated θ=0', False)][1]:.1f} "
              f"({stack[arch]['best'][('gated θ=0', True)][1]:.1f}), "
              f"prefill {stack[arch]['best'][('gated θ=0', False)][0]:.3f} "
              f"({stack[arch]['best'][('gated θ=0', True)][0]:.3f}) ms, "
              f"peak {stack[arch]['peak']:.2f} GiB" for arch in STACK_FULL)
          + f" (phase 9: {stack['seconds']:.1f} s); "
          + "; ".join(
              f"{arch} prompt {prompt} "
              f"{encdec[arch]['best'][('gated θ=0', False)][1]:.1f} "
              f"({encdec[arch]['best'][('gated θ=0', True)][1]:.1f}) "
              f"tokens/s, prefill "
              f"{encdec[arch]['best'][('gated θ=0', False)][0]:.3f} "
              f"({encdec[arch]['best'][('gated θ=0', True)][0]:.3f}) ms, "
              f"peak {encdec[arch]['peak']:.2f} GiB"
              for arch, prompt in ENCDEC)
          + f" (phase 10: {encdec['seconds']:.1f} s); the scalar oracle "
          f"(phase 11) worst {max(r['err'] for r in scalar.values()):.1e} "
          f"of max|ref|; AlexNet@224 served (phase 12, "
          f"{alex['seconds']:.1f} s): {alex['stats']['requests_s']} "
          f"requests/s, the bucket-8 replay {alex['replay8_ms']:.3f} ms "
          f"(dense oracle {alex['dense8_ms']:.3f} ms); Qwen2-0.5B trained "
          f"(phase 13, {trained['seconds']:.1f} s): step "
          f"{trained['step_ms']:.3f} ms, {trained['tok_s']:.1f} tokens/s, "
          f"idle share {trained['idle']:.3f}, measured share "
          f"{trained['measured_frac']:.4f}, roofline_frac "
          f"{trained['report']['roofline_frac']:.4f}; Hymba-1.5B trained "
          f"(batch {HYMBA_BATCH} x {HYMBA_SEQ}): step "
          f"{trained['hymba']['step_ms']:.3f} ms, "
          f"{trained['hymba']['tok_s']:.1f} tokens/s, peak "
          f"{trained['hymba']['peak_gib']:.2f} GiB, idle share "
          f"{trained['hymba']['idle']:.3f}; the dry run (phase 15): "
          + ", ".join(f"{a} coll {r['roofline']['t_collective'] * 1e3:.1f} "
                      f"ms, {r['roofline']['bytes_per_device'] / 2**30:.1f} "
                      f"GiB/device" for a, r in dry["records"].items())
          + f"; on a one-rank mesh "
          f"(phase 14, {par['seconds']:.1f} s): the train step "
          f"{par['step_ms']:.3f} ms against {par['ref_step_ms']:.3f} ms "
          f"unsharded; served (phase 8): "
          + "; ".join(
              f"{net} {r['stats']['requests_s']} requests/s, p50 "
              f"{r['stats']['p50_ms']} ms, p99 {r['stats']['p99_ms']} ms, "
              f"a full bucket of 128 {r['per_bucket'][128]['forward_ms']:.3f}"
              f" ms" for net, r in served.items()), flush=True)
    for entry in results:
        # the serving tier's launches (captured x replayed), beside the
        # main paths' of phases 2-7
        name = entry["name"].replace("_per_tap", "")
        entry["serve_launches"] = {net: r["launches"][name]
                                   for net, r in served.items()}
    print(card, flush=True)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
